"""PyTorch port, foundations: constants, fixed-point helpers, configs, the
window catalog and the interop helpers, each held equal to the JAX package;
plus the guard that the port never imports jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.core import fixedpoint as jfx
from blackman_harris_win_tpu.core import luts as jluts
from blackman_harris_win_tpu.windows import catalog as jcatalog
from blackman_harris_win_tpu_torch import interop
from blackman_harris_win_tpu_torch.core import config, fixedpoint as fx, luts
from blackman_harris_win_tpu_torch.windows import catalog

PORT_MODULES = [
    "blackman_harris_win_tpu_torch",
    "blackman_harris_win_tpu_torch._build",
    "blackman_harris_win_tpu_torch.interop",
    "blackman_harris_win_tpu_torch.core.config",
    "blackman_harris_win_tpu_torch.core.fixedpoint",
    "blackman_harris_win_tpu_torch.core.luts",
    "blackman_harris_win_tpu_torch.windows.catalog",
    "blackman_harris_win_tpu_torch.kernels.cordic",
    "blackman_harris_win_tpu_torch.kernels.window",
    "blackman_harris_win_tpu_torch.kernels.window_kernel",
    "blackman_harris_win_tpu_torch.kernels.welchfft_kernel",
    "blackman_harris_win_tpu_torch.kernels.outerwin",
    "blackman_harris_win_tpu_torch.kernels.floatwin",
    "blackman_harris_win_tpu_torch.kernels.compwin",
    "blackman_harris_win_tpu_torch.kernels.outerwin_kernel",
    "blackman_harris_win_tpu_torch.kernels.taylor",
    "blackman_harris_win_tpu_torch.kernels.taylor_kernel",
    "blackman_harris_win_tpu_torch.kernels.fastwin",
    "blackman_harris_win_tpu_torch.kernels.barrier",
    "blackman_harris_win_tpu_torch.utils.spectral",
    "blackman_harris_win_tpu_torch.pipeline.spectral",
    "blackman_harris_win_tpu_torch.pipeline.fir",
    "blackman_harris_win_tpu_torch.pipeline.ddc",
    "blackman_harris_win_tpu_torch.pipeline.demod",
    "blackman_harris_win_tpu_torch.pipeline.channelizer",
    "blackman_harris_win_tpu_torch.pipeline.sdr",
    "blackman_harris_win_tpu_torch.pipeline.stft",
    "blackman_harris_win_tpu_torch.windows.metrics",
    "blackman_harris_win_tpu_torch.windows.design",
    "blackman_harris_win_tpu_torch.windows.modes",
    "blackman_harris_win_tpu_torch.windows.selector",
    "blackman_harris_win_tpu_torch.utils.streaming",
    "blackman_harris_win_tpu_torch.utils.io",
    "blackman_harris_win_tpu_torch.__main__",
]


class TestConstants:
    @pytest.mark.parametrize(
        "name", ["LUT_ATAN_PI", "LUT_ATAN_2PI", "CORDIC_GAIN", "GAIN48_HALF",
                 "GAIN48_QUARTER", "SEL_SIZE"])
    def test_equal_to_reference(self, name):
        assert getattr(luts, name) == getattr(jluts, name)

    @pytest.mark.parametrize("turn_div,lut", [(1, "LUT_ATAN_PI"), (2, "LUT_ATAN_2PI")])
    def test_luts_match_formula(self, turn_div, lut):
        # the reference's last few entries round off by one LSB
        regen = luts.regenerate_atan_lut(turn_div)
        assert regen == jluts.regenerate_atan_lut(turn_div)
        for i, v in enumerate(getattr(luts, lut)):
            assert abs(v - regen[i]) <= (0 if i < 44 else 1), i

    @pytest.mark.parametrize("w", range(8, 47))
    def test_hls_atan_lut(self, w):
        assert luts.hls_atan_lut(w) == jluts.hls_atan_lut(w)

    @pytest.mark.parametrize("w", [8, 17, 32])
    def test_scaled_internal_width(self, w):
        assert luts.scaled_internal_width(w) == jluts.scaled_internal_width(w)

    def test_scaled_internal_width_range(self):
        with pytest.raises(ValueError):
            luts.scaled_internal_width(33)


class TestFixedPoint:
    @pytest.mark.parametrize("width", [2, 17, 31, 32, 34, 48, 63])
    def test_wrap_int_and_tensor(self, width):
        rng = np.random.default_rng(width)
        v = rng.integers(-(1 << 62), 1 << 62, size=512, dtype=np.int64)
        want = np.asarray(jfx.wrap(v, width))
        got = fx.wrap(torch.from_numpy(v), width).numpy()
        np.testing.assert_array_equal(got, want)
        for x in v[:32]:
            assert fx.wrap(int(x), width) == jfx.wrap(int(x), width)

    def test_wrap_rejects_other_dtypes(self):
        with pytest.raises(TypeError):
            fx.wrap(torch.zeros(4, dtype=torch.int32), 8)

    def test_rounding_and_saturate(self):
        rng = np.random.default_rng(5)
        v = rng.integers(-(1 << 40), 1 << 40, size=512, dtype=np.int64)
        t = torch.from_numpy(v)
        np.testing.assert_array_equal(fx.round_half_up_bit0(t).numpy(),
                                      jfx.round_half_up_bit0(v))
        np.testing.assert_array_equal(fx.round_half_up_bit1(t).numpy(),
                                      jfx.round_half_up_bit1(v))
        np.testing.assert_array_equal(fx.saturate(t, 33).numpy(), jfx.saturate(v, 33))
        for x in (-(1 << 40), -5, 0, 7, (1 << 35)):
            assert fx.saturate(x, 33) == jfx.saturate(x, 33)

    @pytest.mark.parametrize("width,shift", [(17, 1), (24, 1), (32, 1), (32, 2)])
    def test_quantize(self, width, shift):
        a = (0.35875, 0.48829, 0.14128, 0.01168, 1.0, 0.0)
        assert fx.quantize_coeffs(a, width, shift) == jfx.quantize_coeffs(a, width, shift)


class TestConfig:
    @pytest.mark.parametrize("kw", [
        dict(phase_width=12, data_width=17),
        dict(phase_width=31, data_width=32, flavor="dds", precision=3),
        dict(phase_width=20, data_width=24, flavor="scaled"),
        dict(phase_width=20, data_width=24, flavor="cmodel"),
        dict(phase_width=20, data_width=24, flavor="dds48"),
    ])
    def test_cordic_spec_properties(self, kw):
        a, b = config.CordicSpec(**kw), jconfig.CordicSpec(**kw)
        assert (a.internal_width, a.n) == (b.internal_width, b.n)

    @pytest.mark.parametrize("cls,kw", [
        ("CordicSpec", dict(phase_width=3, data_width=17)),
        ("CordicSpec", dict(phase_width=12, data_width=47)),
        ("CordicSpec", dict(phase_width=12, data_width=17, flavor="x")),
        ("CordicSpec", dict(phase_width=12, data_width=17, flavor="dds", precision=8)),
        ("WindowSpec", dict(phase_width=12, data_width=17, sin_type="x")),
        ("WindowSpec", dict(phase_width=12, data_width=17, rounding="x")),
        ("WindowSpec", dict(phase_width=12, data_width=17, overflow="x")),
    ])
    def test_same_validation(self, cls, kw):
        with pytest.raises(ValueError):
            getattr(jconfig, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(config, cls)(**kw)

    def test_window_spec_cordic_spec(self):
        for rounding in ("hls", "rtl"):
            s = config.WindowSpec(20, 17, rounding=rounding, precision=2)
            j = jconfig.WindowSpec(20, 17, rounding=rounding, precision=2)
            assert vars(s.cordic_spec) == vars(j.cordic_spec)
            assert s.with_(overflow="wrap").overflow == "wrap"


class TestCatalog:
    def test_same_sets(self):
        assert catalog.names() == jcatalog.names()
        assert catalog.HLS_SEL == jcatalog.HLS_SEL
        for name in catalog.names():
            a, b = catalog.get(name), jcatalog.get(name)
            assert (a.coeffs, a.shift, a.sidelobe_db, a.hls_sel, a.n_terms) == (
                b.coeffs, b.shift, b.sidelobe_db, b.hls_sel, b.n_terms)

    @pytest.mark.parametrize("w", [17, 24, 32])
    def test_quantized(self, w):
        for name in catalog.names():
            assert catalog.get(name).quantized(w) == jcatalog.get(name).quantized(w)

    def test_unknown_name(self):
        with pytest.raises(KeyError, match="available"):
            catalog.get("nope")


class TestInterop:
    @pytest.mark.parametrize("kw", [
        dict(phase_width=20, data_width=17, overflow="saturate"),
        dict(phase_width=26, data_width=32, rounding="rtl", overflow="wrap",
             precision=2, lut_size=10),
    ])
    def test_window_spec_round_trip(self, kw):
        j = jconfig.WindowSpec(**kw)
        p = interop.window_spec_from_reference(j)
        assert isinstance(p, config.WindowSpec) and vars(p) == vars(j)

    def test_cordic_spec_round_trip(self):
        j = jconfig.CordicSpec(31, 24, "dds", 3)
        p = interop.window_spec_from_reference(j)
        assert isinstance(p, config.CordicSpec) and vars(p) == vars(j)

    def test_bad_spec(self):
        with pytest.raises(TypeError):
            interop.window_spec_from_reference(object())

    def test_coeffs(self):
        q = jcatalog.get("bh7").quantized(32)
        for src in (q, np.asarray(q, np.int64)):
            t = interop.coeffs_from_reference(src)
            assert t.dtype == torch.int64 and t.tolist() == list(q)
        with pytest.raises(TypeError):
            interop.coeffs_from_reference([0.5, 0.25])


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('blackman_harris_win_tpu.') or m == 'blackman_harris_win_tpu')\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, str(root / "chip_smoke.py")], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout)
    assert "no CUDA device" in r.stderr
