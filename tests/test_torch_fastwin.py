"""PyTorch port, the taylor2 fast mode (``kernels/fastwin.py``):
``cos_sin_taylor2`` and ``window_values_fast`` 0-LSB against the JAX package
on the same numpy inputs (int32 limb products there, int64 here), the
W=32 saturate no-op kept, and the BH-7 W=32 floor."""

import math

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import fastwin as jf
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import fastwin as pf
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
from blackman_harris_win_tpu_torch.windows import catalog


def _jspec(spec):
    return jconfig.WindowSpec(**vars(spec))


def _seams(pw):
    n = 1 << pw
    return np.array([(b + d) % n for b in (0, n // 4, n // 2, 3 * n // 4)
                     for d in range(-3, 4)], np.int64)


def _both(p, pw, w, ls):
    c, s = pf.cos_sin_taylor2(torch.from_numpy(p), pw, w, ls)
    jc, js = jf.cos_sin_taylor2(p, pw, w, ls)
    return (c.numpy(), s.numpy()), (np.asarray(jc, np.int64), np.asarray(js, np.int64))


class TestCosSinTaylor2:
    @pytest.mark.parametrize("w", [20, 24, 32])
    def test_sweep_vs_jax(self, w):
        p = np.arange(0, 1 << 16, 3, dtype=np.int64)
        (c, s), (jc, js) = _both(p, 16, w, 12)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        # and the accuracy the JAX package pins (<= 3 LSB of ideal rounding)
        amp = 2.0 ** (w - 2) - 1
        ang = p * (2 * math.pi / (1 << 16))
        assert np.abs(c - np.floor(amp * np.cos(ang) + 0.5)).max() <= 3

    @pytest.mark.parametrize("w", [20, 24, 32])
    @pytest.mark.parametrize("pw,ls", [(20, 12), (31, 12), (31, 14)])
    def test_seams_vs_jax(self, w, pw, ls):
        p = _seams(pw)
        (c, s), (jc, js) = _both(p, pw, w, ls)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)

    @pytest.mark.parametrize("pw,ls", [(12, 12), (12, 10), (14, 12)])  # rb < 0, rb == 0
    def test_pure_lut_regime_vs_jax(self, pw, ls):
        p = np.arange(1 << pw, dtype=np.int64)
        (c, s), (jc, js) = _both(p, pw, 24, ls)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)

    def test_tables_equal_jax(self):
        np.testing.assert_array_equal(pf._rom_q(12, 32), jf._rom_q(12, 32))
        for pw, ls in ((16, 12), (26, 12), (31, 9), (46, 2)):  # p_lo on and off
            assert pf._phase_consts(pw, ls) == jf._phase_consts(pw, ls)

    def test_guards_raise_where_jax_raises(self):
        for args, match in (((12, 34, 12), "data_width <= 32"), ((20, 32, 15), "lut_size")):
            with pytest.raises(ValueError, match=match):
                jf.cos_sin_taylor2(np.arange(4), *args)
            with pytest.raises(ValueError, match=match):
                pf.cos_sin_taylor2(torch.arange(4), *args)


class TestWindowValuesFast:
    @pytest.mark.parametrize("w", [20, 24, 32])
    @pytest.mark.parametrize("overflow", ["wrap", "saturate"])
    @pytest.mark.parametrize("name", ["bh7", "bh3"])
    def test_full_period_vs_jax(self, w, overflow, name):
        spec = WindowSpec(14, w, sin_type="taylor2", lut_size=12, overflow=overflow)
        q = catalog.get(name).quantized(w)
        n = np.arange(1 << 14, dtype=np.int64)
        got = pf.window_values_fast(torch.from_numpy(n), q, spec).numpy()
        np.testing.assert_array_equal(got, np.asarray(jf.window_values_fast(n, q, _jspec(spec))))

    @pytest.mark.parametrize("w", [20, 32])
    def test_dispatch_and_blocks_vs_jax(self, w):
        # window_samples / make_window / window_block route taylor2 to torch ops
        spec = WindowSpec(12, w, sin_type="taylor2", lut_size=12, overflow="wrap")
        q = catalog.get("bh7").quantized(w)
        n = np.arange(1 << 12, dtype=np.int64)
        got = kw.window_samples(torch.from_numpy(n), q, spec).numpy()
        np.testing.assert_array_equal(got, np.asarray(jkw.window_samples(n, q, _jspec(spec))))
        win = kw.make_window("bh7", spec, device="cpu")
        assert win.dtype == torch.int32
        np.testing.assert_array_equal(win.numpy(), np.asarray(jkw.make_window("bh7", _jspec(spec))))
        n0 = (1 << 12) - 100  # across the period end
        blk = kw.window_block(n0, 300, q, spec, device="cpu")
        np.testing.assert_array_equal(blk.numpy(),
                                      np.asarray(jkw.window_block(n0, 300, q, _jspec(spec))))

    def test_w32_saturate_is_a_no_op(self):
        # the JAX function's int32 accumulator is its output at W=32, so
        # "saturate" cannot clamp there (kept; ROADMAP section 3)
        q = ((1 << 30) - 1,) * 3  # peak ~3 * 2^30: overflows int32
        n = np.arange(1 << 12, dtype=np.int64)
        outs = []
        for overflow in ("saturate", "wrap"):
            spec = WindowSpec(12, 32, sin_type="taylor2", lut_size=10, overflow=overflow)
            got = pf.window_values_fast(torch.from_numpy(n), q, spec).numpy()
            want = jf.window_values_fast(n, q, _jspec(spec))
            np.testing.assert_array_equal(got, np.asarray(want))
            outs.append(got)
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0].min() < 0  # the peak wrapped: nothing clamped it

    def test_bh7_w32_floor(self):
        spec = WindowSpec(16, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        win = kw.make_window("bh7", spec, device="cpu").numpy().astype(np.float64)
        assert window_sidelobe_db(win, oversample=4, guard_bins=16 * 7) <= -180.0

    def test_guards_raise_where_jax_raises(self):
        q = catalog.get("bh4").quantized(24)
        rtl = WindowSpec(12, 24, sin_type="taylor2", rounding="rtl")
        with pytest.raises(NotImplementedError):
            jf.window_values_fast(np.arange(4), q, _jspec(rtl))
        with pytest.raises(NotImplementedError):
            pf.window_values_fast(torch.arange(4), q, rtl)
        big = WindowSpec(12, 32, sin_type="taylor2")
        with pytest.raises(ValueError, match="2\\^30"):
            jf.window_values_fast(np.arange(4), (1 << 30, 1), _jspec(big))
        with pytest.raises(ValueError, match="2\\^30"):
            pf.window_values_fast(torch.arange(4), (1 << 30, 1), big)
