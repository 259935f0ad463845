"""PyTorch port, the TAYLOR source: the indexed generator, the block
functions, the TAYLOR windows (both contracts) and the Taylor checksum's
plain version, each 0-LSB against the JAX package, the exact-int golden
model and the native C++ oracle, on the same numpy inputs.  The Taylor
kernel's CPU wrappers run the plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import taylor as jt
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.kernels.pallas.taylor_kernel import (
    make_checksum_fn_taylor as jmake_checksum_fn_taylor,
)
from blackman_harris_win_tpu.model import golden, native
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import taylor as pt
from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.windows import catalog

REGIMES = [  # (pw, w, ls)
    (10, 16, 8),  # tay1 (PW-LS > 2), W<19 branch
    (11, 16, 9),  # tay1, the reference testbench's configuration
    (10, 16, 9),  # PW-LS < 2: over-wide LUT, top-aligned
    (12, 10, 10),  # PW-LS == 2: exact LUT
    (14, 24, 10),  # tay1, W>=19 branch (product slice + clamp)
    (12, 32, 9),  # widest output
]


def _seams(pw, half=4):
    n = 1 << pw
    pts = []
    for base in (0, n // 4, n // 2, 3 * n // 4, n - half):
        pts.extend(range(max(0, base - half), min(n, base + half)))
    return np.array(sorted(set(pts)), np.int64)


def _jspec(spec):
    return jconfig.WindowSpec(**vars(spec))


def _np(t):
    return np.asarray(t).astype(np.int64)


def _port_cs(n, pw, w, ls):
    c, s = pt.taylor_sincos(torch.from_numpy(np.asarray(n, np.int64)), pw, w, ls)
    return c.numpy(), s.numpy()


@pytest.fixture(scope="module")
def oracle():
    native.build()
    return native


class TestTaylorSincos:
    @pytest.mark.parametrize("pw,w,ls", REGIMES + [(14, 31, 9), (14, 32, 10), (12, 32, 8)])
    def test_full_period_vs_jax_and_native(self, oracle, pw, w, ls):
        n = np.arange(1 << pw)
        c, s = _port_cs(n, pw, w, ls)
        jc, js = jt.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(c, _np(jc))
        np.testing.assert_array_equal(s, _np(js))
        nc, ns = oracle.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(c, nc)
        np.testing.assert_array_equal(s, ns)

    @pytest.mark.parametrize("pw", [26, 31])
    @pytest.mark.parametrize("w,ls", [(16, 10), (24, 12), (32, 12), (32, 9)])
    def test_seams_vs_jax_and_native(self, oracle, pw, w, ls):
        n = _seams(pw, half=8)
        c, s = _port_cs(n, pw, w, ls)
        jc, js = jt.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(c, _np(jc))
        np.testing.assert_array_equal(s, _np(js))
        nc, ns = oracle.taylor_sincos(n, pw, w, ls)
        np.testing.assert_array_equal(c, nc)
        np.testing.assert_array_equal(s, ns)

    @pytest.mark.parametrize("pw,w,ls", REGIMES)
    def test_sampled_vs_golden(self, pw, w, ls):
        rng = np.random.default_rng(pw * 100 + w + ls)
        n = np.unique(np.concatenate([rng.integers(0, 1 << pw, 96), _seams(pw, 2)]))
        c, s = _port_cs(n, pw, w, ls)
        want = np.array([golden.taylor_sincos(int(p), pw, w, ls) for p in n])
        np.testing.assert_array_equal(c, want[:, 0])
        np.testing.assert_array_equal(s, want[:, 1])

    def test_indices_wrap_mod_period(self):
        pw, w, ls = 10, 16, 8
        n = np.arange(1 << pw)
        c0, s0 = _port_cs(n, pw, w, ls)
        c1, s1 = _port_cs(n + 3 * (1 << pw), pw, w, ls)
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(s0, s1)

    def test_rom_equals_jax(self):
        for ls, w in ((9, 16), (12, 32), (10, 24)):
            np.testing.assert_array_equal(pt._rom(ls, w), jt._rom(ls, w))

    @pytest.mark.parametrize("pw,w,ls,match", [
        (10, 16, 10, "LUT_SIZE"),
        (10, 16, 12, "LUT_SIZE"),
        (12, 34, 8, "data_width <= 32"),
    ])
    def test_guards_raise_where_jax_raises(self, pw, w, ls, match):
        with pytest.raises(ValueError, match=match):
            jt.taylor_sincos(np.arange(8), pw, w, ls)
        with pytest.raises(ValueError, match=match):
            pt.taylor_sincos(torch.arange(8), pw, w, ls)
        with pytest.raises(ValueError, match=match):
            pt.taylor_sincos_block(0, 8, pw, w, ls, device="cpu")
        with pytest.raises(ValueError, match=match):
            tk.taylor_checksum_plain(pw, w, ls, device="cpu")


BLOCK_CASES = [  # (pw, w, ls): every regime and both tay1 width branches
    (14, 16, 10), (14, 24, 10), (12, 16, 10), (11, 16, 10), (14, 32, 12),
]


class TestBlocks:
    @pytest.mark.parametrize("pw,w,ls", BLOCK_CASES)
    def test_sincos_block_vs_jax_block_and_indexed(self, pw, w, ls):
        r = 1 << max(pw - ls - 2, 0)
        count = min(64, 1 << ls) * r
        # the start, the N/4 quadrant seam, the period end (JAX-aligned)
        for n0 in (0, ((1 << (pw - 2)) - count // 2) // r * r, (1 << pw) - count):
            c, s = pt.taylor_sincos_block(n0, count, pw, w, ls, device="cpu")
            assert c.dtype == torch.int32 and c.shape == (count,)
            jc, js = jt.taylor_sincos_block(n0, count, pw, w, ls)
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc), err_msg=f"n0={n0}")
            np.testing.assert_array_equal(s.numpy(), np.asarray(js), err_msg=f"n0={n0}")

    @pytest.mark.parametrize("pw,w,ls", BLOCK_CASES)
    def test_unaligned_block_across_the_period_end(self, pw, w, ls):
        # the port indexes every sample, so blocks need no R-alignment
        n0, count = (1 << pw) - 37, 101
        c, s = pt.taylor_sincos_block(n0, count, pw, w, ls, device="cpu")
        jc, js = jt.taylor_sincos(np.arange(n0, n0 + count), pw, w, ls)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    @pytest.mark.parametrize("name,w,overflow", [
        ("hamming", 16, "wrap"), ("blackman", 24, "wrap"), ("bh3_hls", 32, "wrap"),
        ("hann", 16, "saturate"), ("blackman", 32, "saturate"),
    ])
    def test_window_block_vs_jax(self, name, w, overflow):
        pw, ls = 14, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, overflow=overflow)
        q = catalog.get(name).quantized(w)
        r1 = 1 << (pw - ls - 2)
        count = 32 * r1
        for n0 in (0, ((1 << (pw - 2)) - count // 2) // r1 * r1, (1 << pw) - count):
            got = pt.taylor_window_block(n0, count, q, spec, device="cpu")
            assert got.dtype == torch.int32
            want = jt.taylor_window_block(n0, count, q, _jspec(spec))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"n0={n0}")
            idx = jkw.window_samples(n0 + np.arange(count), q, _jspec(spec))
            np.testing.assert_array_equal(got.numpy(), _np(idx), err_msg=f"n0={n0}")

    def test_w32_saturate_with_an_overflowing_set(self):
        pw, ls = 12, 9
        q = (900_000_000, 900_000_000, 500_000_000)  # peak q0+q1+q2 > 2^31-1
        r1 = 1 << (pw - ls - 2)
        n0, count = (1 << (pw - 1)) - 32 * r1, 64 * r1  # spans the peak
        outs = {}
        for overflow in ("saturate", "wrap"):
            spec = WindowSpec(pw, 32, sin_type="taylor", lut_size=ls, overflow=overflow)
            got = pt.taylor_window_block(n0, count, q, spec, device="cpu").numpy()
            want = jt.taylor_window_block(n0, count, q, _jspec(spec))
            np.testing.assert_array_equal(got, np.asarray(want))
            idx = jkw.window_samples(n0 + np.arange(count), q, _jspec(spec))
            np.testing.assert_array_equal(got, _np(idx))
            outs[overflow] = got
        assert (outs["saturate"] != outs["wrap"]).any()  # saturation was exercised
        assert outs["saturate"].max() == (1 << 31) - 1

    def test_window_range_vs_jax(self):
        pw, w, ls = 13, 16, 10
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, overflow="wrap")
        q = catalog.get("blackman").quantized(w)
        count = 1 << (pw - 1)  # wider than one JAX chunk (2^(pw-3))
        got = pt.taylor_window_range(1 << (pw - 2), count, q, spec, device="cpu")
        want = jt.taylor_window_range(1 << (pw - 2), count, q, _jspec(spec))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_window_guards_raise_where_jax_raises(self):
        spec = WindowSpec(12, 16, sin_type="taylor", lut_size=10)
        q4 = catalog.get("bh4").quantized(16)
        with pytest.raises(ValueError, match="2/3-term"):
            jt.taylor_window_block(0, 64, q4, _jspec(spec))
        with pytest.raises(ValueError, match="2/3-term"):
            pt.taylor_window_block(0, 64, q4, spec, device="cpu")
        with pytest.raises(ValueError, match="2/3-term"):
            kw.make_window("bh4", spec, device="cpu")
        with pytest.raises(ValueError, match="2/3-term"):
            jkw.make_window("bh4", _jspec(spec))
        # k=2 runs at PW-1: LS must stay below it
        narrow = WindowSpec(11, 16, sin_type="taylor", lut_size=10)
        qb = catalog.get("blackman").quantized(16)
        with pytest.raises(ValueError, match="LUT_SIZE"):
            jt.taylor_window_block(0, 64, qb, _jspec(narrow))
        with pytest.raises(ValueError, match="LUT_SIZE"):
            pt.taylor_window_block(0, 64, qb, narrow, device="cpu")
        wide = WindowSpec(12, 33, sin_type="taylor", lut_size=8)
        with pytest.raises(ValueError, match="data_width <= 32"):
            pt.taylor_window_block(0, 64, (1, 1), wide, device="cpu")


WINDOW_CASES = [  # (name, pw, w, ls, rounding, overflow)
    ("hamming", 12, 16, 10, "hls", "wrap"),
    ("blackman", 14, 24, 10, "hls", "saturate"),
    ("hann", 11, 16, 10, "hls", "wrap"),  # k=1 over-wide LUT
    ("blackman", 12, 16, 10, "hls", "wrap"),  # k=1 exact, k=2 over-wide
    ("bh3_hls", 13, 16, 10, "hls", "wrap"),  # k=1 tay1, k=2 exact
    ("bh3_hls", 12, 32, 9, "hls", "saturate"),
    ("hamming", 12, 16, 10, "rtl", "saturate"),
    ("blackman", 12, 24, 9, "rtl", "wrap"),
    ("blackman", 12, 32, 10, "rtl", "wrap"),
    ("hamming", 4, 16, 1, "hls", "wrap"),  # below the JAX block path's pw >= 5
]


class TestTaylorWindows:
    @pytest.mark.parametrize("name,pw,w,ls,rounding,overflow", WINDOW_CASES)
    def test_make_window_vs_jax(self, name, pw, w, ls, rounding, overflow):
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, rounding=rounding,
                          overflow=overflow)
        got = kw.make_window(name, spec, device="cpu")
        assert got.dtype == torch.int32
        want = jkw.make_window(name, _jspec(spec))
        np.testing.assert_array_equal(got.numpy(), _np(want))

    @pytest.mark.parametrize("name,pw,w,ls,rounding,overflow",
                             [WINDOW_CASES[i] for i in (0, 3, 5, 6, 8)])
    def test_window_block_across_the_period_end(self, name, pw, w, ls, rounding, overflow):
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, rounding=rounding,
                          overflow=overflow)
        q = catalog.get(name).quantized(w)
        n0 = (1 << pw) - 300
        got = kw.window_block(n0, 600, q, spec, device="cpu")
        want = jkw.window_block(n0, 600, q, _jspec(spec))
        np.testing.assert_array_equal(got.numpy(), _np(want))

    @pytest.mark.parametrize("pw,w,rounding,overflow", [
        (26, 32, "hls", "wrap"), (26, 16, "hls", "saturate"), (31, 32, "hls", "saturate"),
        (31, 24, "rtl", "wrap"), (26, 32, "rtl", "wrap"),
    ])
    def test_window_samples_seams(self, oracle, pw, w, rounding, overflow):
        spec = WindowSpec(pw, w, sin_type="taylor", lut_size=10, rounding=rounding,
                          overflow=overflow)
        q = catalog.get("blackman").quantized(w)
        n = _seams(pw, half=8)
        got = kw.window_samples(torch.from_numpy(n), q, spec).numpy()
        np.testing.assert_array_equal(got, _np(jkw.window_samples(n, q, _jspec(spec))))
        if rounding == "hls":  # the kernel's plain version, on the same samples
            plain = tk.taylor_window_plain(torch.from_numpy(n), q, spec)
            np.testing.assert_array_equal(plain.numpy(), got)

    @pytest.mark.parametrize("name,pw,w,ls", [
        ("hamming", 26, 16, 10), ("blackman", 26, 32, 12), ("blackman", 31, 24, 10),
        ("hann", 31, 32, 9), ("blackman", 12, 8, 9), ("hamming", 4, 16, 1),
        ("blackman", 14, 31, 2), ("hamming", 20, 32, 14),
    ])
    def test_window_rtl_plain_seams(self, name, pw, w, ls):
        # the RTL Taylor kernel's plain version at the seams, 0 LSB against
        # JAX window_samples; its output register is W bits, so both
        # overflow modes give the same window, and n is taken mod 2^pw
        q = catalog.get(name).quantized(w)
        n = _seams(pw, half=8)
        want = _np(jkw.window_samples(n, q, _jspec(WindowSpec(
            pw, w, sin_type="taylor", rounding="rtl", lut_size=ls))))
        for overflow in ("wrap", "saturate"):
            spec = WindowSpec(pw, w, sin_type="taylor", rounding="rtl", lut_size=ls,
                              overflow=overflow)
            plain = tk.taylor_window_rtl_plain(torch.from_numpy(n), q, spec)
            assert plain.dtype == torch.int32
            np.testing.assert_array_equal(plain.numpy(), want)
            past = tk.taylor_window_rtl_plain(torch.from_numpy(n + (7 << 32)), q, spec)
            np.testing.assert_array_equal(past.numpy(), want)
        # the wrapper on the CPU runs the plain version, n0 taken mod 2^pw
        n0 = (1 << pw) - 5 + (3 << 32)
        got = tk.window_rtl_block(q, spec, n0, 11, device="cpu")
        idx = np.arange(n0, n0 + 11)
        np.testing.assert_array_equal(
            got.numpy(), _np(jkw.window_samples(idx, q, _jspec(spec))))

    def test_4term_raises_in_both_contracts(self):
        q = catalog.get("bh4").quantized(16)
        for rounding in ("hls", "rtl"):
            spec = WindowSpec(12, 16, sin_type="taylor", rounding=rounding)
            with pytest.raises(ValueError, match="2/3-term"):
                kw.window_samples(torch.arange(4), q, spec)
            with pytest.raises(ValueError, match="2/3-term"):
                jkw.window_samples(np.arange(4), q, _jspec(spec))


class TestChecksum:
    def test_plain_vs_pallas_interpret(self):
        pw, w, ls, rows = 14, 16, 10, 8
        jfn = jmake_checksum_fn_taylor(pw, w, ls, rows=rows, interpret=True)
        fn = tk.make_checksum_fn_taylor(pw, w, ls, rows=rows, device="cpu")
        shifted = rows << (pw - ls - 2)
        for n0, bias in ((0, 0), (0, 7), (shifted, 0), (shifted, 7)):
            want = int(jfn(jnp.int32(n0), jnp.int32(bias)))
            got = tk.taylor_checksum_plain(pw, w, ls, n0, bias, device="cpu")
            assert got.dtype == torch.int32 and int(got) == want, (n0, bias)
            assert int(fn(n0, bias)) == want

    @pytest.mark.parametrize("pw,w,ls", [(12, 32, 8), (13, 24, 9)])
    def test_plain_is_the_int32_wrap_sum(self, pw, w, ls):
        c, s = jt.taylor_sincos(np.arange(1 << pw), pw, w, ls)
        total = int(_np(c).sum() + _np(s).sum()) - (1 << 31)
        want = ((total + (1 << 31)) % (1 << 32)) - (1 << 31)
        assert int(tk.taylor_checksum_plain(pw, w, ls, 0, -(1 << 31), device="cpu")) == want

    @pytest.mark.parametrize("n0,count", [(0, 1000), (5000, 1 << 14), ((1 << 14) - 7, 29)])
    def test_range_is_the_int32_wrap_sum(self, n0, count):
        # ranges other than whole periods, where the quadrants do not cancel
        pw, w, ls = 14, 32, 10
        n = np.arange(n0, n0 + count)
        c, s = jt.taylor_sincos(n, pw, w, ls)
        total = int(_np(c).sum() + _np(s).sum()) + 5
        want = ((total + (1 << 31)) % (1 << 32)) - (1 << 31)
        got = tk.checksum_range(n0, count, pw, w, ls, 5, device="cpu")
        assert got.dtype == torch.int32 and int(got) == want

    def test_guards_raise_where_jax_raises(self):
        for args, kw_, match in (((12, 16, 10), {}, "tay1 regime"),
                                 ((14, 16, 10), {"rows": 24}, "divide"),
                                 ((14, 34, 10), {}, "data_width <= 32")):
            with pytest.raises(ValueError, match=match):
                jmake_checksum_fn_taylor(*args, **kw_)
            with pytest.raises(ValueError, match=match):
                tk.make_checksum_fn_taylor(*args, **kw_)
        fn = tk.make_checksum_fn_taylor(14, 16, 10, rows=8, device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            fn(4, 0)


class TestCpuWrappers:
    def test_raise_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        spec = WindowSpec(12, 16, sin_type="taylor", lut_size=8)
        q = catalog.get("hamming").quantized(16)
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.sincos_block(0, 16, 12, 16, 8, "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.window_block(q, spec, 0, 16, "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.make_checksum_fn_taylor(12, 16, 8, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            kw.make_window("hamming", spec.with_(rounding="rtl"), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            tk.window_rtl_block(q, spec.with_(rounding="rtl"), 0, 16, "cuda")
        with pytest.raises(ValueError):
            tk.sincos_block(0, 16, 12, 16, 8, "meta")

    def test_launch_counters_stay_zero_on_cpu(self):
        _build.reset_launches()
        spec = WindowSpec(12, 16, sin_type="taylor", lut_size=8)
        pt.taylor_sincos_block(0, 64, 12, 16, 8, device="cpu")
        kw.make_window("hamming", spec, device="cpu")
        kw.make_window("blackman", spec.with_(rounding="rtl"), device="cpu")
        tk.make_checksum_fn_taylor(12, 16, 8, rows=8, device="cpu")(0, 1)
        assert {"taylor_sincos_block", "taylor_window_block", "taylor_window_rtl",
                "taylor_checksum"} <= set(_build.launches)
        assert _build.launches == dict.fromkeys(_build.launches, 0)


# --- the Taylor kernel's run walk (csrc/taylor_kernel.cu), emulated in numpy ---

M32 = np.uint64(0xFFFFFFFF)


def _kg(vec):
    """Samples per lane per tile (csrc/taylor_kernel.cu kG): 8 in the
    write-outs, 16 in the checksum."""
    return 8 if vec else 16


def _lane_steps(vec):
    """Offsets of a lane's samples from its first: the write-out layout (4
    consecutive, then the next 4 a warp's 128 samples on) or kG in a row."""
    return np.array([128 * (k // 4) + k % 4 if vec else k for k in range(_kg(vec))], np.int64)


def _lane_firsts(vec):
    return np.arange(32, dtype=np.int64) * (4 if vec else _kg(vec))


def _gen_consts(pw, w, ls):
    d = pw - ls
    ramb = pt.ramb_pi(d - 3) if d > 2 else 0
    reg = "lut" if d <= 2 or ramb == 0 else ("narrow" if w < 19 else "wide")
    xs = 19 + ls
    sc, rs = max(32 - xs, 0), max(xs - 32, 0)
    return dict(reg=reg, pmask=(1 << pw) - 1, qmask=(1 << (pw - 2)) - 1, qshift=pw - 2,
                shr=max(d - 2, 0), shl=max(2 - d, 0),
                rmask=0 if reg == "lut" else (1 << (d - 2)) - 1, ramb=ramb, xs=xs,
                ws=32 - w, top=(1 << (w - 1)) - 1, rom=pt._rom(ls, w).astype(np.int64),
                sc=sc, rs=rs, rambs=ramb << sc, off=(1 << (32 + rs)) - 1,
                walk=reg != "lut" and ls >= 1)


def _u64(x):
    return np.asarray(x, np.int64).view(np.uint64)


def _wrapw(v, ws):
    """The kernel's wrapw on a uint32 word held in uint64: (int)(v << ws) >> ws."""
    return (((v << np.uint64(ws)) & M32).astype(np.uint32).view(np.int32) >> ws).astype(np.int64)


def _form(reg, sin, q, ex, ey):
    ms_form = ((q & 1) != 0) != sin
    sgn = np.where((q >= 2) if sin else ((q == 1) | (q == 2)), -1, 1)
    base = np.where(ms_form, ey, ex)
    if reg == "narrow":
        return base, np.where(ms_form, ex, -ey), np.ones_like(q), sgn
    return base, np.where(ms_form, ex, ey), np.where(ms_form, 1, -1), sgn


def _finish(reg, f, p, g):
    """One output from its form and its int64 product, in uint32 words."""
    base, _, tsgn, sgn = f
    if reg == "lut":
        return sgn * base
    t = _u64(p >> g["xs"]) & M32
    v = (_u64(base) + _u64(tsgn) * t) & M32
    if reg == "narrow":
        return _wrapw((_u64(sgn) * v) & M32, g["ws"])
    m = _wrapw(v, g["ws"])
    return sgn * np.where(m < 0, g["top"], m)


def _walk_form(reg, sin, q, ex, ey, g):
    """The run's form of one output: base, mult, steering sign, offset."""
    ms = ((q & 1) != 0) != sin
    sgn = np.where((q >= 2) if sin else ((q == 1) | (q == 2)), -1, 1)
    base, mult = np.where(ms, ey, ex), np.where(ms, ex, ey)
    off = np.where(ms, 0, g["off"] if reg == "narrow" else 0)
    return ms, sgn, base, mult, off


def _walk_out(reg, form, p, g):
    """One output along a run in the kernel's unsigned form (``walk_out``)
    from its product P = mult * mpi * 2^sc (+ off for the W < 19 cos-like
    form): floor(./2^xs) = hi32(P) >> rs, the W >= 19 clamp as min(v * 2^ws,
    2^31 - 1) >> ws."""
    ms, sgn, base, _, _ = form
    t = (p >> np.uint64(32)) >> np.uint64(g["rs"])
    v = (_u64(base) + np.where(ms, t, (M32 - t + np.uint64(1)) & M32)) & M32
    if reg == "narrow":
        return _wrapw((v * _u64(sgn)) & M32, g["ws"])
    u = np.minimum((v << np.uint64(g["ws"])) & M32, np.uint64(0x7FFFFFFF))
    return sgn * (u >> np.uint64(g["ws"])).astype(np.int64)


def _sample(g, n, sin=True):
    """Each sample on its own (the kernel's ``sample``)."""
    reg = g["reg"]
    cnt = n & g["pmask"]
    q, ph = cnt >> g["qshift"], cnt & g["qmask"]
    e = g["rom"][(ph >> g["shr"]) << g["shl"]]
    mpi = np.zeros_like(ph) if reg == "lut" else g["ramb"] * (ph & g["rmask"])
    fc, fs = _form(reg, False, q, e[..., 0], e[..., 1]), _form(reg, True, q, e[..., 0], e[..., 1])
    return _finish(reg, fc, fc[1] * mpi, g), _finish(reg, fs, fs[1] * mpi, g)


def _gen_values(g, n_a, left, steps, stats):
    """A generator's (c, s) at each lane's samples n_a + steps: the run walk
    where a lane's samples lie in one run, each on its own otherwise."""
    span = int(steps[-1])
    c, s = _sample(g, n_a[:, None] + steps[None, :])
    if g["reg"] == "lut":
        return c, s
    cnt = n_a & g["pmask"]
    ph = cnt & g["qmask"]
    acnt = ph & g["rmask"]
    fast = g["walk"] & (left > span) & (acnt + span <= g["rmask"])
    stats["fast"] += int(fast.sum())
    stats["lanes"] += fast.size
    q = (cnt >> g["qshift"])[fast]
    e = g["rom"][(ph >> g["shr"])[fast]]
    mpi0s = (g["ramb"] * acnt[fast]) << g["sc"]
    assert (mpi0s + int(span) * g["rambs"] < 1 << 32).all()  # the kernel's u32 word
    for col, sin in ((c, False), (s, True)):
        form = _walk_form(g["reg"], sin, q, e[:, 0], e[:, 1], g)
        mult, off = form[3], form[4]
        # the product at each sample, as the kernel forms it: one multiply-
        # add from the run's mpi * 2^sc, advanced by the exact step J *
        # ramb_pi * 2^sc; < 2^64, no wrap
        for k in range(len(steps)):
            p = _u64(mult) * _u64(mpi0s + int(steps[k]) * g["rambs"]) + _u64(off)
            col[fast, k] = _walk_out(g["reg"], form, p, g)
    return c, s


def _lanes(n0, count, vec):
    steps = _lane_steps(vec)
    tile = 32 * _kg(vec)
    ntiles = -(-count // tile)
    i0 = (np.arange(ntiles, dtype=np.int64)[:, None] * tile + _lane_firsts(vec)[None, :]).ravel()
    i0 = i0[i0 < count]
    left = count - i0
    return i0, n0 + i0, left, steps, steps[None, :] < left[:, None]


def emulate_sincos(n0, count, pw, w, ls, stats):
    i0, n_a, left, steps, valid = _lanes(n0, count, True)
    c, s = _gen_values(_gen_consts(pw, w, ls), n_a, left, steps, stats)
    idx = (i0[:, None] + steps[None, :])[valid]
    out_c, out_s = np.zeros(count, np.int64), np.zeros(count, np.int64)
    out_c[idx], out_s[idx] = c[valid], s[valid]
    return out_c, out_s


def emulate_checksum(n0, count, pw, w, ls, bias, stats):
    # the walk starts lead = n0 mod kG samples early (groups aligned in n)
    # and leaves those out of the sum
    lead = n0 % _kg(False)
    i0, n_a, left, steps, valid = _lanes(n0 - lead, count + lead, False)
    c, s = _gen_values(_gen_consts(pw, w, ls), n_a, left, steps, stats)
    valid &= (i0[:, None] + steps[None, :]) >= lead
    total = int((_u64(c[valid]) + _u64(s[valid])).sum(dtype=np.uint64) & M32) + bias
    return ((total + (1 << 31)) % (1 << 32)) - (1 << 31)


def emulate_window(n0, count, coeffs, pw, w, ls, saturate, stats):
    i0, n_a, left, steps, valid = _lanes(n0, count, True)
    c1, _ = _gen_values(_gen_consts(pw, w, ls), n_a, left, steps, stats)
    # m_k: the funnel shift of the int64 product's two words by W-1
    m1 = ((_u64(coeffs[1] * c1) >> np.uint64(w - 1)) & M32).astype(np.uint32).view(np.int32)
    m2 = np.zeros_like(m1)
    if len(coeffs) == 3:  # harmonic 2: the generator one phase bit narrower
        c2, _ = _gen_values(_gen_consts(pw - 1, w, ls), n_a, left, steps, stats)
        m2 = ((_u64(coeffs[2] * c2) >> np.uint64(w - 1)) & M32).astype(np.uint32).view(np.int32)
    if saturate:
        acc = coeffs[0] - m1.astype(np.int64) + m2
        v = np.clip(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    else:  # the sum mod 2^32, wrapped to W bits
        v = _wrapw((_u64(coeffs[0]) - _u64(m1) + _u64(m2)) & M32, 32 - w)
    out = np.zeros(count, np.int64)
    out[(i0[:, None] + steps[None, :])[valid]] = v[valid]
    return out


def _wrap(v, bits):
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    return ((v + (1 << (bits - 1))) % (1 << bits)) - (1 << (bits - 1))


def rtl_tree(a0, words, w):
    """``taylor_window_rtl_kernel``'s tree on uint64 arrays of the terms'
    funnel words g_k (bits [W-1, W+30] of a_k * cos_k + 2^(W-2)): the
    output's bits [s, s+W-1] of a0 + 2^(s-1) - b1 (+ b2), sign-extended, in
    32-bit words at the fields' scale 2^(32-W).  Each term enters as an
    unsigned word, its scale IMAD g_k * (+-2^(32-W)) + bias: n1 = beta - f1,
    u2 = f2 + 2^31 (f_k = b_k * 2^(32-W) as an int32).  3 terms: the low
    word (C_lo + n1 + u2) mod 2^32 and the high word C_hi plus the two
    carries out of it (the carry chain), C = A + 1 - 2^32, funnel-shifted by
    2; 2 terms: (C - 1) / 2 + n1 - (n1 >> 1), C = A - beta odd.  Returns
    (output, n1's value beta - f1 as an exact integer)."""
    s, ws = len(words), 32 - w
    pw2 = 1 << ws
    a = (a0 + (1 << (s - 1))) * pw2
    beta = 0x7FFFFFFF + (a & 1) if s == 1 else 0x7FFFFFFF
    n1 = (words[0] * np.uint64((1 << 32) - pw2) + np.uint64(beta)) & M32
    f1 = ((words[0] << np.uint64(ws)) & M32).astype(np.uint32).view(np.int32).astype(np.int64)
    if s == 1:
        t = (np.uint64(((a - beta - 1) >> 1) & 0xFFFFFFFF) + n1 - (n1 >> np.uint64(1))) & M32
    else:
        u2 = (words[1] * np.uint64(pw2) + np.uint64(1 << 31)) & M32
        c = (a + 1 - (1 << 32)) % (1 << 64)
        s1 = n1 + u2  # < 2^33: no uint64 wrap
        s2 = (s1 & M32) + np.uint64(c & 0xFFFFFFFF)
        hi = (np.uint64(c >> 32) + (s1 >> np.uint64(32)) + (s2 >> np.uint64(32))) & M32
        t = ((s2 & M32) >> np.uint64(2)) | ((hi << np.uint64(30)) & M32)
    v = (t.astype(np.uint32).view(np.int32) >> np.int32(ws)).astype(np.int64)
    return v, beta - f1


def emulate_window_rtl(n0, count, coeffs, pw, w, ls, stats):
    """The RTL Taylor window as ``taylor_window_rtl_kernel`` computes it:
    each term's funnel word, the funnel shift of the int64 multiply-add
    a_k * cos_k + 2^(W-2) by W-1, then ``rtl_tree``.  ``stats`` counts the
    lanes, the trees past 32 bits (W + s > 32), the samples whose n1 bias
    is 2^31 (2 terms, W = 32, A odd) and the reference's wraps that fire:
    the W+1-bit slice of a product, the W-bit round of a term and the
    W+s-bit tree.  Asserts that n1 lies in [0, 2^32) as an exact integer."""
    i0, n_a, left, steps, valid = _lanes(n0, count, True)
    cs = [_gen_values(_gen_consts(pw, w, ls), n_a, left, steps, stats)[0]]
    if len(coeffs) == 3:  # harmonic 2: the generator one phase bit narrower
        cs.append(_gen_values(_gen_consts(pw - 1, w, ls), n_a, left, steps, stats)[0])
    s, ws = len(coeffs) - 1, 32 - w
    words, bs = [], []
    for a, c in zip(coeffs[1:], cs):
        p = a * c + (1 << (w - 2))  # |a * c| < 2^62: exact in int64
        words.append((_u64(p) >> np.uint64(w - 1)) & M32)
        bs.append(((words[-1] << np.uint64(ws)) & M32).astype(np.uint32).view(np.int32)
                  .astype(np.int64) >> ws)
        # the reference's two wraps of the term, on the same samples
        t = (a * c) >> (w - 2)
        r = _wrap(t, w + 1)
        stats["slice_wraps"] += int((r != t)[valid].sum())
        rhu = (r >> 1) + (r & 1)
        stats["round_wraps"] += int((rhu != _wrap(rhu, w))[valid].sum())
    v, n1 = rtl_tree(coeffs[0], words, w)
    assert ((n1 >= 0) & (n1 < 1 << 32))[valid].all()
    stats["past32"] += int(w + s > 32)
    stats["beta_odd"] += int(s == 1 and (coeffs[0] + 1) * (1 << ws) % 2 == 1)
    tree = coeffs[0] - bs[0] + (bs[1] if s == 2 else 0)
    stats["tree_wraps"] += int((tree != _wrap(tree, w + s))[valid].sum())
    out = np.zeros(count, np.int64)
    out[(i0[:, None] + steps[None, :])[valid]] = v[valid]
    return out


RUN_WALK_CONFIGS = [  # (pw, ls): PW-LS 1..24, every regime
    (11, 10), (12, 10),  # over-wide and exact LUT
    (13, 10), (14, 10),  # tay1, PW-LS 3 and 4 (R = 2, 4: below a lane's span)
    (16, 10), (20, 8), (26, 12),  # R = 16, 4096, 4096
    (29, 7), (30, 7), (31, 7),  # PW-LS 22 (ramb_pi 1), 23 and 24 (ramb_pi 0: LUT)
]


def _ranges(pw, rng):
    """Unaligned ranges across the quadrant seams (0, N/4, N/2, 3N/4, and the
    period end), across run boundaries and at random."""
    n = 1 << pw
    out = [((s - 301) % n, 603) for s in (0, n // 4, n // 2, 3 * n // 4)]
    out.append((n - 1000, 2013))  # wraps mod 2^pw
    out.append((int(rng.integers(0, n)), 3001))
    out.append((int(rng.integers(0, max(n >> 12, 1))) << 12, 4096 + 5))  # aligned start
    return out


class TestRunWalkEmulation:
    """The kernel's arithmetic, emulated: run walk, incremental products,
    32-bit words, lane layouts and tails, 0 LSB against the plain version
    and JAX (the card sweep, ``test_torch_gpu.py -k sweep``, holds the kernel
    itself to the same)."""

    @pytest.mark.parametrize("w", range(8, 33))
    def test_sincos_and_checksum(self, w):
        stats = {"fast": 0, "lanes": 0}
        for pw, ls in RUN_WALK_CONFIGS:
            rng = np.random.default_rng(pw * 100 + w)
            for n0, count in _ranges(pw, rng):
                n = n0 + np.arange(count, dtype=np.int64)
                c, s = emulate_sincos(n0, count, pw, w, ls, stats)
                pc, ps = tk.taylor_sincos_plain(torch.from_numpy(n), pw, w, ls)
                np.testing.assert_array_equal(c, pc.numpy(), err_msg=f"c {pw} {ls} {n0}")
                np.testing.assert_array_equal(s, ps.numpy(), err_msg=f"s {pw} {ls} {n0}")
                jc, js = jt.taylor_sincos(n, pw, w, ls)
                np.testing.assert_array_equal(c, _np(jc))
                np.testing.assert_array_equal(s, _np(js))
                got = emulate_checksum(n0, count, pw, w, ls, -77, stats)
                want = tk.checksum_range(n0, count, pw, w, ls, -77, device="cpu")
                assert got == int(want), (pw, ls, n0, count)
        assert 0 < stats["fast"] < stats["lanes"]  # both paths were taken

    @pytest.mark.parametrize("w", range(8, 33))
    def test_window(self, w):
        stats = {"fast": 0, "lanes": 0}
        cases = [("blackman", 26, 12, "wrap"), ("hamming", 26, 10, "saturate"),
                 ("blackman", 14, 10, "saturate"), ("blackman", 13, 10, "wrap"),
                 ("blackman", 12, 9, "wrap"), ("blackman", 30, 7, "saturate"),
                 ("hann", 29, 7, "wrap")]
        for name, pw, ls, overflow in cases:
            spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, overflow=overflow)
            q = catalog.get(name).quantized(w)
            rng = np.random.default_rng(pw * 10 + w)
            for n0, count in _ranges(pw, rng):
                got = emulate_window(n0, count, q, pw, w, ls, overflow == "saturate", stats)
                n = n0 + np.arange(count, dtype=np.int64)
                want = tk.taylor_window_plain(torch.from_numpy(n), q, spec)
                np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{name} {pw} {n0}")
                np.testing.assert_array_equal(got, _np(jkw.window_samples(n, q, _jspec(spec))))
        assert 0 < stats["fast"] < stats["lanes"]

    @pytest.mark.parametrize("w", range(8, 33))
    def test_window_rtl(self, w):
        # the RTL kernel's accumulate over the run walk, 0 LSB against the
        # plain version and JAX: 2-term (hamming, hann) and 3-term (blackman)
        # sets and random |a_k| < 2^31 ones (where the reference's wraps
        # fire), every regime (LS 1..14, PW-LS 1..24, pw 4..31), unaligned
        # and ragged ranges across the seams and the period end, n0 past 2^32
        stats = dict.fromkeys(("fast", "lanes", "past32", "beta_odd", "slice_wraps",
                               "round_wraps", "tree_wraps"), 0)
        rng = np.random.default_rng(1000 + w)

        def big(k):  # |a_0| in [3 * 2^29, 2^31): the tree overflows its W+s bits
            a0 = int(rng.integers(3 << 29, 1 << 31)) * int(rng.choice((-1, 1)))
            return (a0, *(int(a) for a in rng.integers(1 - (1 << 31), 1 << 31, k - 1)))

        cases = [("hamming", 26, 10), ("blackman", 26, 12), ("hann", 4, 1),
                 ("blackman", 13, 10), ("hamming", 11, 10), ("blackman", 12, 9),
                 ("blackman", 30, 7), ("hann", 31, 7), ("blackman", 28, 14),
                 ("blackman", 14, 2), (3, 20, 8), (2, 16, 10), (3, 29, 7)]
        for name, pw, ls in cases:
            q = big(name) if isinstance(name, int) else catalog.get(name).quantized(w)
            spec = WindowSpec(pw, w, sin_type="taylor", rounding="rtl", lut_size=ls)
            n = 1 << pw
            ranges = [(a % n, c) for a, c in _ranges(pw, rng)[:5]]
            ranges.append((int(rng.integers(0, n)) + (5 << 32), 1001))  # past 2^32
            for n0, count in ranges:
                got = emulate_window_rtl(n0, count, q, pw, w, ls, stats)
                idx = n0 + np.arange(count, dtype=np.int64)
                want = tk.taylor_window_rtl_plain(torch.from_numpy(idx), q, spec)
                np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{name} {pw} {n0}")
                np.testing.assert_array_equal(got, _np(jkw.window_samples(idx, q, _jspec(spec))))
        assert 0 < stats["fast"] < stats["lanes"]  # the run walk and sample by sample
        # trees past 32 bits (3 terms at W = 31, 2 and 3 at W = 32) on the same
        # code; at W = 32 a 2-term set with a0 even biases n1 by 2^31
        assert (stats["past32"] > 0) == (w >= 31)
        assert (stats["beta_odd"] > 0) == (w == 32)
        if w <= 31:  # the random sets make the slice's and the tree's wraps fire
            assert stats["slice_wraps"] > 0 and stats["tree_wraps"] > 0, stats
        else:  # |a_k|, |cos_k| < 2^31 keep a W=32 slice in 33 bits and the tree
            # in 33-34: the tree's words are needed for the width, not a wrap
            assert stats["slice_wraps"] == stats["tree_wraps"] == 0, stats


class TestRtlTree:
    """``rtl_tree``, the RTL kernel's tree in 32-bit words, against the
    int64 tree it replaces: bits [s, s+W-1] of a0 + 2^(s-1) - b1 (+ b2),
    b_k = wrap(floor((a_k * cos_k + 2^(W-2)) / 2^(W-1)), W), over random
    and extreme terms (|a_k| up to 2^31 - 1, cos_k over the whole W-bit
    range), a0 of both parities."""

    @pytest.mark.parametrize("terms", [2, 3])
    @pytest.mark.parametrize("w", [2, 8, 16, 24, 29, 30, 31, 32])
    def test_words_equal_the_int64_tree(self, w, terms):
        rng = np.random.default_rng(100 * w + terms)
        amax, cmax, n = (1 << 31) - 1, 1 << (w - 1), 4096
        a = rng.integers(-amax, amax + 1, (terms - 1, n))
        c = rng.integers(-cmax, cmax, (terms - 1, n))
        ext_a = np.array([amax, -amax, amax - 1, 1 - amax, 0, 1, -1, 1 << 30])
        ext_c = np.array([-cmax, cmax - 1, 1 - cmax, 0, 1, -1])
        pick = rng.random(a.shape) < 0.25
        a[pick] = rng.choice(ext_a, int(pick.sum()))
        pick = rng.random(c.shape) < 0.25
        c[pick] = rng.choice(ext_c, int(pick.sum()))
        s = terms - 1
        words, b = [], []
        for k in range(s):
            p = a[k] * c[k] + (1 << (w - 2))  # |a * c| < 2^62: exact in int64
            words.append((_u64(p) >> np.uint64(w - 1)) & M32)
            b.append(_wrap(p >> (w - 1), w))
        a0s = [amax, -amax, amax - 1, 1 - amax, 0, -1, 1, 2, -2]
        a0s += [int(v) for v in rng.integers(-amax, amax + 1, 23)]
        for a0 in a0s:
            got, n1 = rtl_tree(a0, words, w)
            assert ((n1 >= 0) & (n1 < 1 << 32)).all(), a0  # n1 fits its word
            tree = a0 + (1 << (s - 1)) - b[0] + (b[1] if s == 2 else 0)  # < 2^34: exact
            np.testing.assert_array_equal(got, _wrap(tree >> s, w), err_msg=f"a0={a0}")
