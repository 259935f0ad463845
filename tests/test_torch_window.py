"""PyTorch port, fixed-point datapaths: CORDIC, window samples, the window
kernel's plain versions and its CPU wrappers, each 0-LSB against the JAX
package and the native C++ oracle (including quadrant seams and pw=31)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import cordic as jcordic
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.kernels.pallas.window_kernel import (
    pallas_window_block,
    window_values as jwindow_values,
)
from blackman_harris_win_tpu.model import native
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.core.config import CordicSpec, WindowSpec
from blackman_harris_win_tpu_torch.kernels import cordic
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.kernels import window_kernel as wk
from blackman_harris_win_tpu_torch.kernels.welchfft_kernel import welch_stage1_fused
from blackman_harris_win_tpu_torch.pipeline.spectral import windowed_power_spectrum
from blackman_harris_win_tpu_torch.windows import catalog


def _seams(pw, half=4):
    """Indices around the quadrant seams 0, N/4, N/2, 3N/4 and the period end."""
    n = 1 << pw
    pts = []
    for base in (0, n // 4, n // 2, 3 * n // 4, n - half):
        pts.extend(range(max(0, base - half), min(n, base + half)))
    return np.array(sorted(set(pts)), np.int64)


def _block_and_seams(pw, seed, nblock=4096):
    n0 = int(np.random.default_rng(seed).integers(0, (1 << pw) - nblock))
    return np.unique(np.concatenate([n0 + np.arange(nblock), _seams(pw)]))


def _jspec(spec):
    return jconfig.WindowSpec(**vars(spec))


def _coeffs(name, w, rounding):
    q = catalog.get(name).quantized(w)
    return kw.rtl_cordic_coeffs(q) if rounding == "rtl" else q


def _port(n, q, spec):
    return kw.window_samples(torch.from_numpy(n), q, spec).numpy()


def _jax(n, q, spec):
    return np.asarray(jkw.window_samples(jnp.asarray(n), q, _jspec(spec))).astype(np.int64)


def _native(n, q, spec):
    if spec.rounding == "rtl":
        return native.win_rtl(n, q, spec.phase_width, spec.data_width, spec.precision)
    return native.win_hls(n, q, spec.phase_width, spec.data_width)


class TestCordic:
    @pytest.mark.parametrize("flavor", ["hls", "dds"])
    @pytest.mark.parametrize("pw,w", [(10, 16), (10, 32), (12, 17), (12, 24), (12, 32)])
    def test_full_period(self, flavor, pw, w):
        ph = np.arange(1 << pw, dtype=np.int64)
        c, s = cordic.cordic_sincos(torch.from_numpy(ph), CordicSpec(pw, w, flavor))
        jc, js = jcordic.cordic_sincos(jnp.asarray(ph), jconfig.CordicSpec(pw, w, flavor))
        nc, ns = (native.cordic_hls(ph, pw, w) if flavor == "hls"
                  else native.cordic_dds(ph, pw, w, 1))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(c.numpy(), nc)
        np.testing.assert_array_equal(s.numpy(), ns)

    @pytest.mark.parametrize("flavor", ["hls", "dds"])
    @pytest.mark.parametrize("pw", [26, 31])
    @pytest.mark.parametrize("w", [17, 24, 32])
    def test_seams(self, flavor, pw, w):
        ph = _seams(pw)
        c, s = cordic.cordic_sincos(torch.from_numpy(ph), CordicSpec(pw, w, flavor))
        jc, js = jcordic.cordic_sincos(jnp.asarray(ph), jconfig.CordicSpec(pw, w, flavor))
        nc, ns = (native.cordic_hls(ph, pw, w) if flavor == "hls"
                  else native.cordic_dds(ph, pw, w, 1))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(c.numpy(), nc)
        np.testing.assert_array_equal(s.numpy(), ns)

    @pytest.mark.parametrize("p", [2, 5])
    def test_dds_precision(self, p):
        ph = np.arange(0, 1 << 14, 7, dtype=np.int64)
        c, _ = cordic.cordic_dds(torch.from_numpy(ph), CordicSpec(14, 24, "dds", p))
        np.testing.assert_array_equal(c.numpy(), native.cordic_dds(ph, 14, 24, p)[0])

    def test_other_flavors_not_ported(self):
        # every flavor is ported now (tests/test_torch_cordic.py holds them);
        # the window kernel's constants still take only hls and dds
        ph = _seams(12)
        for flavor in ("cmodel", "dds48", "scaled"):
            c, s = cordic.cordic_sincos(torch.from_numpy(ph), CordicSpec(12, 17, flavor))
            jc, js = jcordic.cordic_sincos(jnp.asarray(ph), jconfig.CordicSpec(12, 17, flavor))
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            with pytest.raises(ValueError, match="hls and dds"):
                cordic.cordic_constants(CordicSpec(12, 17, flavor))


class TestWindowSamples:
    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    @pytest.mark.parametrize("overflow", ["wrap", "saturate"])
    @pytest.mark.parametrize("name", ["hann", "bh3", "bh4", "bh7"])
    @pytest.mark.parametrize("w", [17, 24, 31, 32])
    def test_block_and_seams(self, rounding, overflow, name, w):
        spec = WindowSpec(16, w, rounding=rounding, overflow=overflow)
        q = _coeffs(name, w, rounding)
        n = _block_and_seams(16, seed=w * 7 + len(q))
        got = _port(n, q, spec)
        np.testing.assert_array_equal(got, _jax(n, q, spec))
        if overflow == "wrap" or rounding == "rtl":  # the oracle wraps
            np.testing.assert_array_equal(got, _native(n, q, spec))

    @pytest.mark.parametrize("name,w,rounding,overflow", [
        ("bh7", 32, "hls", "wrap"),
        ("bh7", 32, "hls", "saturate"),
        ("bh4", 32, "hls", "saturate"),
        ("bh4", 17, "rtl", "wrap"),
        ("bh7", 32, "rtl", "wrap"),
        ("hamming", 31, "rtl", "wrap"),
    ])
    def test_pw31(self, name, w, rounding, overflow):
        spec = WindowSpec(31, w, rounding=rounding, overflow=overflow)
        q = _coeffs(name, w, rounding)
        n = _seams(31, half=8)
        got = _port(n, q, spec)
        np.testing.assert_array_equal(got, _jax(n, q, spec))
        if overflow == "wrap":
            np.testing.assert_array_equal(got, _native(n, q, spec))

    def test_raw_rtl_coefficients(self):
        # the RTL contract with un-halved AA ports (the reference's own wrap)
        spec = WindowSpec(12, 24, rounding="rtl", overflow="wrap")
        q = catalog.get("bh4").quantized(24)
        n = np.arange(1 << 12, dtype=np.int64)
        np.testing.assert_array_equal(_port(n, q, spec), _native(n, q, spec))

    @pytest.mark.parametrize("sin_type,name,w,rounding,overflow", [
        ("taylor", "hann", 17, "hls", "saturate"),
        ("taylor", "blackman", 32, "hls", "wrap"),
        ("taylor", "hamming", 24, "rtl", "wrap"),
        ("taylor2", "bh7", 32, "hls", "wrap"),
        ("taylor2", "bh4", 24, "hls", "saturate"),
    ])
    def test_taylor_sources_match_jax(self, sin_type, name, w, rounding, overflow):
        spec = WindowSpec(16, w, sin_type=sin_type, rounding=rounding, overflow=overflow,
                          lut_size=12 if sin_type == "taylor2" else 10)
        q = catalog.get(name).quantized(w)
        n = _block_and_seams(16, seed=w + len(q))
        np.testing.assert_array_equal(_port(n, q, spec), _jax(n, q, spec))

    def test_products_must_fit_int64(self):
        spec = WindowSpec(12, 40)
        with pytest.raises(ValueError):
            kw.window_samples(torch.arange(4), (1 << 30, 1 << 30), spec)


class TestWindowFunctions:
    @pytest.mark.parametrize("name,w,rounding,overflow", [
        ("hann", 17, "hls", "wrap"),
        ("bh7", 32, "hls", "saturate"),
        ("bh5", 24, "hls", "wrap"),
        ("bh4", 17, "rtl", "saturate"),
    ])
    def test_make_window(self, name, w, rounding, overflow):
        spec = WindowSpec(10, w, rounding=rounding, overflow=overflow)
        q = _coeffs(name, w, rounding)
        got = kw.make_window(name, spec, coeffs=q, device="cpu")
        want = np.asarray(jkw.make_window(name, _jspec(spec), coeffs=q))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("sel", [1, 2, 3, 4, 5, 7, 9])
    def test_win_function(self, sel):
        spec = WindowSpec(10, 17, overflow="wrap")
        n = np.arange(0, 1 << 10, 3)
        got = kw.win_function(sel, torch.from_numpy(n), spec).numpy()
        want = np.asarray(jkw.win_function(sel, jnp.asarray(n), _jspec(spec)))
        np.testing.assert_array_equal(got, want)

    def test_win_function_zeros_on_the_device_of_n(self):
        spec = WindowSpec(10, 17, overflow="wrap")
        n = torch.arange(4, device="meta")
        out = kw.win_function(0, n, spec)  # unknown selector: win_empty
        assert out.device == n.device and out.shape == n.shape

    def test_window_block_matches_jax(self):
        spec = WindowSpec(20, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        n0 = (1 << 20) - 1000  # runs across the period end
        got = kw.window_block(n0, 2048, q, spec, device="cpu")
        want = np.asarray(jkw.window_block(n0, 2048, q, _jspec(spec)))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_rtl_cordic_coeffs(self):
        q = catalog.get("bh7").quantized(32)
        assert kw.rtl_cordic_coeffs(q) == jkw.rtl_cordic_coeffs(q)


class TestWindowKernelPlain:
    """window_values_plain against JAX ``window_values`` — the body the
    Pallas kernel runs (int32 lanes, limb datapaths, overflow tracking)."""

    @pytest.mark.parametrize("name,pw,w,rounding,overflow,p", [
        pytest.param(*c, 1, id="-".join(map(str, c))) for c in [
            ("bh4", 12, 17, "hls", "wrap"),
            ("bh7", 12, 24, "hls", "wrap"),
            ("bh7", 12, 32, "hls", "wrap"),
            ("bh7", 26, 32, "hls", "wrap"),
            ("hann", 10, 24, "hls", "wrap"),
            ("bh5", 11, 20, "hls", "wrap"),
            ("bh4", 12, 32, "hls", "saturate"),  # w=32 overflow tracking
            ("bh3", 14, 32, "hls", "saturate"),
            ("bh4", 20, 17, "hls", "saturate"),  # the analyzer's window
            ("bh7", 26, 32, "rtl", "wrap"),
            ("hann", 12, 32, "rtl", "wrap"),
            ("bh4", 12, 17, "rtl", "wrap"),
            ("bh4", 31, 32, "hls", "wrap"),
        ]
    ] + [  # the kernel's datapath boundaries (window_kernel._datapath)
        ("bh7", 12, 30, "hls", "wrap", 1),  # i32, iw = 32
        ("bh7", 12, 31, "hls", "wrap", 1),  # r2s S=1 (JAX: radix-2^24 limbs)
        ("bh4", 13, 31, "hls", "saturate", 1),
        ("bh5", 12, 32, "hls", "saturate", 1),  # r2s S=2 (JAX: _cos_wide4)
        ("bh7", 12, 31, "rtl", "wrap", 1),  # i32, iw = 32
        ("bh4", 12, 31, "rtl", "wrap", 2),  # r2s S=1
        ("bh7", 13, 31, "rtl", "wrap", 3),  # r2s S=2
        ("bh7", 12, 32, "rtl", "wrap", 1),  # r2s S=1
        ("bh3", 12, 32, "rtl", "wrap", 2),  # r2s S=2
        ("bh7", 13, 32, "rtl", "wrap", 3),  # i64, iw = 35
        ("bh7", 12, 25, "rtl", "wrap", 7),  # i32, iw = 32
    ])
    def test_matches_pallas_body(self, name, pw, w, rounding, overflow, p):
        spec = WindowSpec(pw, w, rounding=rounding, overflow=overflow, precision=p)
        q = _coeffs(name, w, rounding)
        step = max(1, (1 << pw) // 512)
        n = np.unique(np.concatenate([np.arange(0, 1 << pw, step), _seams(pw)]))
        got = wk.window_values_plain(torch.from_numpy(n), q, spec)
        want = np.asarray(jwindow_values(jnp.asarray(n, jnp.int32), q, _jspec(spec)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    @pytest.mark.parametrize("p", range(1, 8))
    @pytest.mark.parametrize("w", range(8, 33))
    def test_datapath(self, w, p, rounding):
        # the CORDIC state's internal width: W+2 (HLS flavor), W+P (dds, RTL)
        iw = w + (2 if rounding == "hls" else p)
        want = "i32" if iw <= 32 else "r2s" if iw in (33, 34) else "i64"
        spec = WindowSpec(12, w, rounding=rounding, precision=p)
        assert wk._datapath(spec) == want
        assert want in wk._DATAPATHS

    def test_datapath_rejects_wide_registers(self):
        with pytest.raises(ValueError, match="data_width <= 32"):
            wk._datapath(WindowSpec(12, 33))
        with pytest.raises(ValueError, match="int32 coefficients"):
            wk.window_block((1 << 31, 5), WindowSpec(12, 17), 0, 8, device="cpu")

    @pytest.mark.parametrize("n0", [0, 4096 - 1024])
    def test_block_matches_pallas_interpret(self, n0):
        spec = WindowSpec(12, 17, overflow="wrap")
        q = catalog.get("bh4").quantized(17)
        want = np.asarray(pallas_window_block(q, _jspec(spec), n0, 1024, rows=8,
                                              interpret=True))
        got = wk.window_block(q, spec, n0, 1024, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    def test_checksum_is_int32_wrap_sum(self, rounding):
        spec = WindowSpec(26, 32, rounding=rounding, overflow="wrap")
        q = _coeffs("bh7", 32, rounding)
        n_start, count, bias = (1 << 26) - (1 << 15), 1 << 16, -7
        n = np.arange(n_start, n_start + count)
        vals = jwindow_values(jnp.asarray(n % (1 << 26), jnp.int32), q, _jspec(spec))
        total = int(np.asarray(vals).astype(np.int64).sum()) + bias
        want = (total + (1 << 31)) % (1 << 32) - (1 << 31)
        got = wk.window_checksum_plain(q, spec, n_start, count, bias, device="cpu")
        assert got.dtype == torch.int32 and int(got) == want
        assert int(wk.window_checksum(q, spec, n_start, count, bias, device="cpu")) == want

    def test_kernel_parameter_checks(self):
        q = catalog.get("bh4").quantized(17)
        with pytest.raises(NotImplementedError):
            wk.window_block(q, WindowSpec(12, 17, sin_type="taylor"), 0, 8, device="cpu")
        with pytest.raises(ValueError):
            wk.window_block(q, WindowSpec(12, 33), 0, 8, device="cpu")
        with pytest.raises(ValueError):
            wk.window_block((1,) * 9, WindowSpec(12, 17), 0, 8, device="cpu")
        with pytest.raises(ValueError):
            wk.window_checksum(q, WindowSpec(12, 17), -1, 8, device="cpu")


class TestCpuGuards:
    """The wrappers' CPU behaviour: plain versions, no launches, and a loud
    error (no fallback) when a CUDA device is asked for but absent."""

    def test_wrappers_raise_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        q = catalog.get("bh4").quantized(17)
        spec = WindowSpec(12, 17)
        with pytest.raises(RuntimeError, match="CUDA"):
            wk.window_block(q, spec, 0, 16, "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            wk.window_checksum(q, spec, 0, 16, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            kw.make_window("bh4", spec, device="cuda")
        with pytest.raises(ValueError):
            wk.window_block(q, spec, 0, 16, "meta")

    def test_launch_counters_stay_zero_on_cpu(self):
        _build.reset_launches()
        spec = WindowSpec(13, 17, overflow="saturate")
        q = catalog.get("bh4").quantized(17)
        wk.window_block(q, spec, 0, 64, device="cpu")
        wk.window_checksum(q, spec, 0, 64, device="cpu")
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=5 * 4096).astype(np.float32))
        welch_stage1_fused(x, torch.ones(1 << 13), 1 << 13)
        windowed_power_spectrum(x, "bh4", spec, fft_mode="mxu")
        assert {"window_block", "window_checksum", "welch_stage1"} <= set(_build.launches)
        assert _build.launches == dict.fromkeys(_build.launches, 0)
