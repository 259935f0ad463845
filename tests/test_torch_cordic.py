"""PyTorch port, the CORDIC flavors beyond hls/dds: cmodel, dds48, scaled
and the vectoring-mode atan2 (``cordic_atan2``, ``atan2_fixed``), each
0-LSB against the JAX package and the C++ oracle (``model/native.py``:
dds48, scaled, cordic_atan2) or the exact-int golden model (cmodel), over
full periods, the quadrant seams and the pw=31 ceiling."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import cordic as jcordic
from blackman_harris_win_tpu.model import golden, native
from blackman_harris_win_tpu_torch.core.config import CordicSpec
from blackman_harris_win_tpu_torch.kernels import cordic

NATIVE = {"dds48": native.cordic_dds48, "scaled": native.cordic_scaled}


@pytest.fixture(scope="module")
def oracle():
    native.build()
    return native


def _seams(pw, half=3):
    """0, N/4, N/2, 3N/4 and the period end, each +-half (so +-1 and more)."""
    n = 1 << pw
    pts = []
    for base in (0, n // 4, n // 2, 3 * n // 4, n):
        pts.extend(p % n for p in range(base - half, base + half + 1))
    return np.array(sorted(set(pts)), np.int64)


def _port(flavor, ph, pw, w):
    c, s = cordic.cordic_sincos(torch.from_numpy(ph), CordicSpec(pw, w, flavor))
    assert c.dtype == s.dtype == torch.int64
    return c.numpy(), s.numpy()


def _jax(flavor, ph, pw, w):
    c, s = jcordic.cordic_sincos(jnp.asarray(ph), jconfig.CordicSpec(pw, w, flavor))
    return np.asarray(c).astype(np.int64), np.asarray(s).astype(np.int64)


class TestPrerotated:
    @pytest.mark.parametrize("flavor", ["dds48", "scaled"])
    @pytest.mark.parametrize("pw,w", [(10, 16), (12, 12), (11, 24), (12, 32), (8, 8)])
    def test_full_period_vs_jax_and_native(self, oracle, flavor, pw, w):
        ph = np.arange(1 << pw, dtype=np.int64)
        c, s = _port(flavor, ph, pw, w)
        jc, js = _jax(flavor, ph, pw, w)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        nc, ns = NATIVE[flavor](ph, pw, w)
        np.testing.assert_array_equal(c, nc)
        np.testing.assert_array_equal(s, ns)

    @pytest.mark.parametrize("flavor", ["dds48", "scaled"])
    @pytest.mark.parametrize("pw", [20, 26, 31])
    @pytest.mark.parametrize("w", [16, 24, 32])
    def test_seams_vs_jax_and_native(self, oracle, flavor, pw, w):
        ph = _seams(pw)
        c, s = _port(flavor, ph, pw, w)
        jc, js = _jax(flavor, ph, pw, w)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        nc, ns = NATIVE[flavor](ph, pw, w)
        np.testing.assert_array_equal(c, nc)
        np.testing.assert_array_equal(s, ns)

    @pytest.mark.parametrize("flavor", ["dds48", "scaled"])
    def test_sin_axis_carries_minus_sin(self, flavor):
        # the reference's axis quirk (PARITY.md): DT_SIN is -sin
        pw, w = 12, 16
        ph = np.arange(1 << pw, dtype=np.int64)
        c, ns = _port(flavor, ph, pw, w)
        th = 2 * np.pi * ph / (1 << pw)
        amp = 2.0 ** (w - 2)
        assert np.max(np.abs(c - amp * np.cos(th))) < 8
        assert np.max(np.abs(ns + amp * np.sin(th))) < 8

    def test_phase_taken_mod_period(self):
        ph = np.arange(256, dtype=np.int64)
        for flavor in ("dds48", "scaled", "cmodel"):
            a = _port(flavor, ph, 8, 16)
            b = _port(flavor, ph + 5 * 256, 8, 16)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    def test_scaled_width_guard(self):
        with pytest.raises(ValueError, match="8..32"):
            cordic.cordic_sincos(torch.arange(4), CordicSpec(12, 33, "scaled"))


class TestCmodel:
    @pytest.mark.parametrize("pw,w,p", [(10, 16, 1), (9, 24, 1), (10, 12, 3), (8, 32, 1)])
    def test_full_period_vs_jax_and_golden(self, pw, w, p):
        ph = np.arange(1 << pw, dtype=np.int64)
        c, s = cordic.cordic_cmodel(torch.from_numpy(ph), CordicSpec(pw, w, "cmodel", p))
        jc, js = jcordic.cordic_cmodel(jnp.asarray(ph), jconfig.CordicSpec(pw, w, "cmodel", p))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        want = np.array([golden.cordic_cmodel(int(v), pw, w, p) for v in ph])
        np.testing.assert_array_equal(c.numpy(), want[:, 0])
        np.testing.assert_array_equal(s.numpy(), want[:, 1])

    @pytest.mark.parametrize("pw", [26, 31])
    @pytest.mark.parametrize("w", [16, 32])
    def test_seams_vs_jax_and_golden(self, pw, w):
        ph = _seams(pw)
        c, s = _port("cmodel", ph, pw, w)
        jc, js = _jax("cmodel", ph, pw, w)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        want = np.array([golden.cordic_cmodel(int(v), pw, w) for v in ph])
        np.testing.assert_array_equal(c, want[:, 0])
        np.testing.assert_array_equal(s, want[:, 1])

    def test_ones_complement_quadrant_fix(self):
        # quadrant 2 negates by ~v = -v - 1: cos(pi) comes out one below -cos(0)
        pw, w = 12, 16
        c, _ = _port("cmodel", np.array([0, 1 << (pw - 1)], np.int64), pw, w)
        assert c[1] == ~c[0]


def _atan_grid(iw, count=1500, seed=0):
    """Axes, quadrant edges (|x| == |y|), the extremes of the input width
    (-2^(iw-1) included: the one's-complement abs edge) and random vectors."""
    top = (1 << (iw - 1)) - 1
    vals = np.array([-top - 1, -top, -1000, -2, -1, 0, 1, 2, 1000, top], np.int64)
    gx, gy = np.meshgrid(vals, vals)
    rng = np.random.default_rng(seed)
    r = rng.integers(-top - 1, top + 1, size=(2, count))
    d = rng.integers(-top, top + 1, size=64)
    x = np.concatenate([gx.ravel(), r[0], d, d, -d])
    y = np.concatenate([gy.ravel(), r[1], d, -d, d])
    return y, x


ATAN_CASES = [(16, 16, 1), (20, 24, 1), (16, 18, 3), (17, 20, 1), (24, 24, 2), (12, 31, 1)]


def _fixed_from_reference(ref, y, x, iw, aw):
    """atan2_fixed's value, derived from the reference ``cordic_atan2`` word:
    invert its quadrant fix (vhd:204-219) to the core angle dat_phi, then
    apply the standard reconstruction."""
    q = (((x >> (iw - 1)) & 1) << 1) | ((y >> (iw - 1)) & 1)
    phi_pi, pi_u, full = 1 << (aw - 2), 1 << (aw - 1), 1 << aw
    dat = np.where(q == 0, ref, np.where(q == 1, ref - phi_pi,
                                         np.where(q == 2, -ref, ref + phi_pi)))
    base = -dat
    out = np.where(q == 0, base, np.where(q == 1, -base,
                                          np.where(q == 2, pi_u - base, base - pi_u)))
    out = out % full
    return np.where(out >= pi_u, out - full, out)


class TestAtan2:
    @pytest.mark.parametrize("iw,aw,p", ATAN_CASES)
    def test_cordic_atan2_vs_jax_and_native(self, oracle, iw, aw, p):
        y, x = _atan_grid(iw, seed=iw + aw)
        got = cordic.cordic_atan2(torch.from_numpy(y), torch.from_numpy(x), iw, aw, p).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcordic.cordic_atan2(y, x, iw, aw, p)))
        np.testing.assert_array_equal(got, oracle.cordic_atan2(y, x, iw, aw, p))

    @pytest.mark.parametrize("iw,aw,p", ATAN_CASES)
    def test_atan2_fixed_vs_jax_and_native(self, oracle, iw, aw, p):
        y, x = _atan_grid(iw, seed=3 * iw + aw)
        got = cordic.atan2_fixed(torch.from_numpy(y), torch.from_numpy(x), iw, aw, p).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcordic.atan2_fixed(y, x, iw, aw, p)))
        ref = oracle.cordic_atan2(y, x, iw, aw, p)
        np.testing.assert_array_equal(got, _fixed_from_reference(ref, y, x, iw, aw))

    def test_scalar_model_axes(self):
        iw = aw = 16
        for x, y in [(1000, 0), (0, 1000), (-1000, 0), (0, -1000), (1, 1), (-1, -1)]:
            got = int(cordic.cordic_atan2(torch.tensor([y]), torch.tensor([x]), iw, aw)[0])
            assert got == golden.cordic_atan2(y, x, iw, aw), (x, y)

    def test_fixed_is_standard_atan2(self):
        aw, iw = 20, 20
        th = np.linspace(-math.pi + 0.01, math.pi - 0.01, 500)
        x = np.round(200000 * np.cos(th)).astype(np.int64)
        y = np.round(200000 * np.sin(th)).astype(np.int64)
        got = cordic.atan2_fixed(torch.from_numpy(y), torch.from_numpy(x), iw, aw).numpy()
        want = np.arctan2(y, x) * 2.0 ** (aw - 1) / math.pi
        assert np.max(np.abs(got - want)) < 64
