"""PyTorch port, the atan2 / FM-discriminator kernel (``csrc/demod_kernel.cu``)
on the CPU.

The kernel runs only on a card; here a numpy emulation of its datapath,
lane by lane, is held 0 LSB against the JAX package (``kernels/cordic.py:
cordic_atan2`` / ``atan2_fixed``, ``pipeline/demod.py:fm_demod_conj`` /
``fm_demod_phase``, run on the CPU with x64) and the exact-int model
``model/golden.py:cordic_atan2``, on seeded numpy inputs:

- the state at the top of a 32-bit word while AW+P <= 32, else of a 64-bit
  one, so that every add wraps at AW+P bits by itself, with the fraction
  bits of each shifted operand cleared; steering by d = +-1 (32-bit) or a
  xor-and-subtract negation (64-bit); z unwrapped (its bound asserted);
- the conjugate products in wrapping uint32 arithmetic on the inputs
  re-quantized by >> drop; the phase differences wrapped in uint64;
- the I/Q front end's f32 quantizer, rint(f32(re) * f32(iq_scale)).

The seam inputs are x or y in {0, +-1}, inputs whose masked abs is
2^(AW-1)-1, and inputs with bit input_width-1 set, at AW 16/20/24/31 with
P=1 and AW 30 with P=2 (32-bit words), AW 31 with P=2 and AW 40 (64-bit
words), in both conventions.  One case proves that the AW+P bit wrap fires:
the emulation with the state at the bottom of a 64-bit word (no wrap)
differs from JAX there.  The kernel against its plain version on the card
is ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.kernels import cordic as jcordic
from blackman_harris_win_tpu.model import golden
from blackman_harris_win_tpu.pipeline import demod as jdm
from blackman_harris_win_tpu_torch.kernels import cordic
from blackman_harris_win_tpu_torch.kernels import demod_kernel as dk
from blackman_harris_win_tpu_torch.pipeline import channelizer, demod, sdr

#: (AW, P) of the elementwise cases: 32-bit words, then 64-bit words
WIDTHS = [(16, 1), (20, 1), (24, 1), (31, 1), (30, 2), (31, 2), (40, 1), (40, 3)]
CONVENTIONS = ["cordic", "fixed"]


def _words(aw, p, top=True):
    """(bits, unsigned dtype, signed dtype, shift to the top) of the
    kernel's word; ``top=False`` keeps the state at the bottom of a 64-bit
    word, where no AW+P bit wrap happens."""
    if not top:
        return 64, np.uint64, np.int64, 0
    bits = 32 if aw + p <= 32 else 64
    u, s = (np.uint32, np.int32) if bits == 32 else (np.uint64, np.int64)
    return bits, u, s, bits - (aw + p)


def _atan2_emulation(y, x, input_width, aw, p, convention, top=True, trace=None):
    """``csrc/demod_kernel.cu:atan2_word`` on int64 arrays (the inputs as
    the kernel widens them)."""
    y, x = np.asarray(y, np.int64), np.asarray(x, np.int64)
    bits, u, s, sh = _words(aw, p, top)
    in_sign = min(input_width, 64) - 1
    sx, sy = (x >> in_sign) & 1, (y >> in_sign) & 1
    quadrant = (sx << 1) | sy
    mask_lo = (1 << (aw - 1)) - 1
    keep = u(((1 << bits) - 1) ^ ((1 << sh) - 1))
    xs = ((x ^ -sx) & mask_lo).astype(u) << u(sh)
    ys = ((y ^ -sy) & mask_lo).astype(u) << u(sh)
    z = np.zeros(xs.shape, u)
    lut = dk.atan2_lut(aw, p)
    zmax = 0
    for i in range(aw - 1):
        xi = (xs.view(s) >> s(i)).view(u) & keep
        yi = (ys.view(s) >> s(i)).view(u) & keep
        lk = u(int(lut[i]) & ((1 << bits) - 1))
        if bits == 32:
            d = ((ys.view(s) >> s(bits - 1)) | s(1)).view(u)
            xs, ys, z = xs + d * yi, ys - d * xi, z - d * lk
        else:
            m = (ys.view(s) >> s(bits - 1)).view(u)
            xs, ys, z = xs + ((yi ^ m) - m), ys - ((xi ^ m) - m), z - ((lk ^ m) - m)
        zmax = max(zmax, int(np.abs(z.view(s).astype(np.int64)).max(initial=0)))
        if trace is not None:
            trace.append(max(int(np.abs(xs.view(s).astype(np.int64)).max(initial=0)),
                             int(np.abs(ys.view(s).astype(np.int64)).max(initial=0))))
    # the kernel's note: z needs no wrap
    assert zmax < 0.56 * 2.0 ** (aw + p - 1)
    phi = (z.view(s) >> s(p)).astype(np.int64)
    pi_half, pi_u = 1 << (aw - 2), 1 << (aw - 1)
    if convention == "cordic":
        out = np.where(quadrant == 0, phi, np.where(quadrant == 1, phi + pi_half,
                                                    np.where(quadrant == 2, -phi, phi - pi_half)))
    else:
        out = np.where(quadrant == 0, -phi, np.where(quadrant == 1, phi,
                                                     np.where(quadrant == 2, pi_u + phi,
                                                              -phi - pi_u)))
    return _wrap(out, aw)


def _wrap(v, bits):
    v = np.asarray(v, np.int64).astype(np.uint64) & np.uint64((1 << bits) - 1)
    return np.where(v >> np.uint64(bits - 1), v.astype(np.int64) - (1 << bits), v.astype(np.int64))


def _conj_emulation(i, q, input_width, aw, top=True):
    """``conj_word`` over (..., T) int arrays -> (..., T-1)."""
    drop, shift = dk.conj_shifts(input_width, aw)
    a = (np.asarray(i, np.int64) >> drop).astype(np.uint32)
    b = (np.asarray(q, np.int64) >> drop).astype(np.uint32)
    a0, a1, b0, b1 = a[..., :-1], a[..., 1:], b[..., :-1], b[..., 1:]
    re = (a1 * a0 + b1 * b0).view(np.int32) >> np.int32(shift)
    im = (b1 * a0 - a1 * b0).view(np.int32) >> np.int32(shift)
    return _atan2_emulation(im, re, aw, aw, 1, "fixed", top)


def _phase_emulation(i, q, input_width, aw):
    """``demod_int_kernel``'s phase mode: angles, then wrapped differences."""
    phi = _atan2_emulation(q, i, input_width, aw, 1, "fixed")
    d = (phi[..., 1:] - phi[..., :-1]).astype(np.uint64)
    half, full = 1 << (aw - 1), 1 << aw
    return ((d + np.uint64(half)) & np.uint64(full - 1)).astype(np.int64) - half


def _quantize(v, scale):
    """``__float2int_rn(__fmul_rn(v, scale))``."""
    return np.rint(np.asarray(v, np.float32) * np.float32(scale)).astype(np.int32)


def _seam_inputs(input_width, aw, count, seed):
    return dk.seam_words(input_width, aw, np.random.default_rng(seed), count)


def _jax_atan2(y, x, iw, aw, p, convention):
    fn = jcordic.cordic_atan2 if convention == "cordic" else jcordic.atan2_fixed
    return np.asarray(fn(y, x, iw, aw, p), np.int64)


class TestAtan2Emulation:
    @pytest.mark.parametrize("convention", CONVENTIONS)
    @pytest.mark.parametrize("aw,p", WIDTHS)
    def test_vs_jax_and_plain(self, aw, p, convention):
        for iw in sorted({aw, min(aw + 3, 62), 12}):
            y, x = _seam_inputs(iw, aw, 2000, seed=aw * 7 + p + iw)
            want = _jax_atan2(y, x, iw, aw, p, convention)
            np.testing.assert_array_equal(_atan2_emulation(y, x, iw, aw, p, convention), want)
            plain = cordic.cordic_atan2 if convention == "cordic" else cordic.atan2_fixed
            got = plain(torch.from_numpy(y), torch.from_numpy(x), iw, aw, p)
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("aw,p", WIDTHS)
    def test_vs_golden(self, aw, p):
        y, x = _seam_inputs(aw, aw, 60, seed=aw + 100 * p)
        want = np.array([golden.cordic_atan2(int(b), int(a), aw, aw, p) for b, a in zip(y, x)])
        np.testing.assert_array_equal(_atan2_emulation(y, x, aw, aw, p, "cordic"), want)

    @pytest.mark.parametrize("aw", [2, 3, 8])
    def test_narrow_angles(self, aw):
        y, x = _seam_inputs(10, aw, 300, seed=aw)
        for conv in CONVENTIONS:
            np.testing.assert_array_equal(_atan2_emulation(y, x, 10, aw, 1, conv),
                                          _jax_atan2(y, x, 10, aw, 1, conv))

    @pytest.mark.parametrize("aw,p", [(20, 1), (31, 1), (40, 1)])
    def test_the_state_wrap_fires(self, aw, p):
        # |x| == |y| at the top of the range: the state grows past 2^(iw-1)
        # (1.16 * 2^(iw-1) at P=1: the gain 1.647 times sqrt 2), so the
        # reference's per-add wrap changes the result; the emulation that
        # keeps the state unwrapped differs from JAX there
        top = (1 << (aw - 1)) - 1
        y = np.array([top, top, -top - 1, top - 3], np.int64)
        x = np.array([top, -top - 1, top, top - 1], np.int64)
        want = _jax_atan2(y, x, aw, aw, p, "fixed")
        trace = []
        np.testing.assert_array_equal(_atan2_emulation(y, x, aw, aw, p, "fixed", trace=trace),
                                      want)
        unwrapped = []
        got = _atan2_emulation(y, x, aw, aw, p, "fixed", top=False, trace=unwrapped)
        assert max(unwrapped) >= 1 << (aw + p - 1)
        assert not np.array_equal(got, want)


class TestDemodEmulation:
    @pytest.mark.parametrize("iw,aw", [(16, 20), (17, 20), (20, 24), (15, 16), (16, 31),
                                       (16, 40), (24, 48)])
    def test_conj_vs_jax(self, iw, aw):
        y, x = _seam_inputs(iw, aw, 3000, seed=iw * aw)
        i, q = x.reshape(-1), y.reshape(-1)
        want = np.asarray(jdm.fm_demod_conj(i, q, iw, aw), np.int64)
        np.testing.assert_array_equal(_conj_emulation(i, q, iw, aw), want)
        np.testing.assert_array_equal(demod.fm_demod_conj(i, q, iw, aw, device="cpu").numpy(),
                                      want)

    @pytest.mark.parametrize("iw,aw", [(16, 20), (17, 20), (20, 24), (15, 16), (16, 31),
                                       (30, 40)])
    def test_phase_vs_jax(self, iw, aw):
        y, x = _seam_inputs(iw, aw, 3000, seed=iw + aw)
        i, q = x.reshape(-1), y.reshape(-1)
        want = np.asarray(jdm.fm_demod_phase(i, q, iw, aw), np.int64)
        np.testing.assert_array_equal(_phase_emulation(i, q, iw, aw), want)
        np.testing.assert_array_equal(demod.fm_demod_phase(i, q, iw, aw, device="cpu").numpy(),
                                      want)

    @pytest.mark.parametrize("fn", ["conj", "phase"])
    def test_int32_input_and_rows(self, fn):
        # the kernel reads int32 I/Q in place, (rows, T) at any strides: the
        # transposed (C, nf) view of an (nf, C) array, as sdr_chain's plain
        # path passes it
        rng = np.random.default_rng(5)
        iq = rng.integers(-(1 << 15), 1 << 15, size=(2, 300, 4)).astype(np.int32)
        i, q = iq[0].T, iq[1].T
        emu = _conj_emulation if fn == "conj" else _phase_emulation
        want = np.asarray(getattr(jdm, f"fm_demod_{fn}")(i, q, 16, 20), np.int64)
        np.testing.assert_array_equal(emu(i, q, 16, 20), want)
        got = getattr(demod, f"fm_demod_{fn}")(torch.from_numpy(i), torch.from_numpy(q), 16, 20)
        np.testing.assert_array_equal(got.numpy(), want)


class TestIqFrontEnd:
    def _chain(self, seed=11):
        c, tpb = 4, 6
        proto = channelizer.design_prototype(c, tpb)
        t = c * 1024
        n = np.arange(t)
        rng = np.random.default_rng(seed)
        x = (np.cos(2 * np.pi * (1 / c + 0.005) * n) + 0.3 * rng.normal(size=t)).astype(np.float32)
        return x, proto, c

    def test_fused_front_end_equals_the_plain_chain(self):
        x, proto, c = self._chain()
        y = channelizer.polyphase_channelize(x, proto, c, device="cpu").numpy()
        want = sdr.sdr_chain(x, proto, c, device="cpu").numpy()
        i, q = _quantize(y.real, 2.0**14), _quantize(y.imag, 2.0**14)
        got = _conj_emulation(i.T, q.T, sdr.IQ_WIDTH, 20).T
        assert got.shape == want.shape == (y.shape[0] - 1, c)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jdm.fm_demod_conj(i.T, q.T, 16, 20)).T)
        np.testing.assert_array_equal(
            sdr.discriminate_plain(torch.from_numpy(y)).numpy(), want)

    @pytest.mark.parametrize("scale", [2.0**14, 1000.0, 3.0e4])
    def test_quantizer_rounds_half_to_even(self, scale):
        # channel values whose f32 product with the scale is exactly k + 1/2:
        # torch.round then .to(int32) and rintf (the kernel) take the even one
        k = np.arange(-30000, 30000, 37, dtype=np.float64)
        cand = np.float32((k + 0.5) / scale)
        cand = np.concatenate([np.nextafter(cand, np.float32(-2)), cand,
                               np.nextafter(cand, np.float32(2))])
        prod = cand * np.float32(scale)
        v = cand[prod == np.floor(prod) + 0.5]
        assert len(v) > 100
        want = torch.round(torch.from_numpy(v) * scale).to(torch.int32).numpy()
        np.testing.assert_array_equal(_quantize(v, scale), want)
        assert np.all(want % 2 == 0)

    def test_exact_halves_through_the_discriminator(self):
        # a channel output on exact halves of the 2^-14 grid: the plain
        # chain's discriminator and the emulation's fused quantizer agree
        rng = np.random.default_rng(3)
        k = rng.integers(-20000, 20000, size=(64, 3)) + 0.5
        m = rng.integers(-20000, 20000, size=(64, 3))
        y = (k / 2.0**14 + 1j * m / 2.0**14).astype(np.complex64)
        want = sdr.discriminate_plain(torch.from_numpy(y)).numpy()
        i, q = _quantize(y.real, 2.0**14), _quantize(y.imag, 2.0**14)
        np.testing.assert_array_equal(_conj_emulation(i.T, q.T, 16, 20).T, want)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a kernel wrapper was called for a CPU tensor")

        for name in ("atan2", "fm_demod", "iq_demod"):
            monkeypatch.setattr(dk, name, refuse)
        y, x = _seam_inputs(16, 20, 50, seed=1)
        yt, xt = torch.from_numpy(y), torch.from_numpy(x)
        np.testing.assert_array_equal(cordic.atan2_fixed(yt, xt, 16, 20).numpy(),
                                      cordic.atan2_fixed_plain(yt, xt, 16, 20).numpy())
        np.testing.assert_array_equal(cordic.cordic_atan2(yt, xt, 16, 20).numpy(),
                                      cordic.cordic_atan2_plain(yt, xt, 16, 20).numpy())
        assert demod.fm_demod_conj(xt, yt, 16, 20).shape == (len(x) - 1,)
        assert demod.fm_demod_phase(xt, yt, 16, 20).shape == (len(x) - 1,)
        x_sig, proto, c = self._chain_input()
        assert sdr.sdr_chain(torch.from_numpy(x_sig), proto, c).shape == (256 - 6, 4)

    @staticmethod
    def _chain_input():
        c = 4
        x = np.random.default_rng(0).normal(size=c * 256).astype(np.float32)
        return x, channelizer.design_prototype(c, 6), c

    def test_wrappers_refuse_cpu_tensors(self):
        z = torch.zeros(8, dtype=torch.int64)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.atan2(z, z, 16, 20)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.fm_demod(z, z, 16, 20)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.iq_demod(torch.zeros((4, 2), dtype=torch.complex64))
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.atan2(np.zeros(8), z, 16, 20)

    def test_array_input_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA device"):
            demod.fm_demod_conj(np.arange(8), np.arange(8), 16, 20)

    def test_lut_and_shifts(self):
        # the z steps the kernel takes are the plain version's, and fit the
        # word the host picks
        for aw, p in WIDTHS + [(2, 0), (48, 1), (49, 0)]:
            lut = dk.atan2_lut(aw, p)
            assert len(lut) == aw - 1
            want = [jcordic.LUT_ATAN_PI[i] >> (49 - aw - p) for i in range(aw - 1)]
            np.testing.assert_array_equal(lut, np.asarray(want, np.int64))
            if aw + p <= 32:
                assert int(lut.max(initial=0)) < 1 << 31
        assert dk.conj_shifts(16, 20) == (1, 11)
        assert dk.conj_shifts(12, 24) == (0, 1)
        assert dk.conj_shifts(17, 31) == (2, 0)
