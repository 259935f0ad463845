"""PyTorch port, the SDR chain's modules: ``phase_wrap`` and both FM
discriminators 0-LSB against the JAX package on the same int I/Q, the
polyphase channelizer (real and complex input) within a derived f32 budget,
and ``sdr_chain`` against JAX: exact wherever the two sides quantize the
channel envelopes to the same ints."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.pipeline import channelizer as jch
from blackman_harris_win_tpu.pipeline import demod as jdm
from blackman_harris_win_tpu.pipeline import sdr as jsdr
from blackman_harris_win_tpu_torch.pipeline import channelizer, demod, sdr

_U = 2.0**-24


def _gamma(k):
    return k * _U / (1 - k * _U)


def _iq(iw, count, seed):
    """Random I/Q words of width iw, plus the axes and the extremes."""
    top = (1 << (iw - 1)) - 1
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, top, -top - 1, 0, top, 0, -top - 1, 1], np.int64)
    i = np.concatenate([rng.integers(-top - 1, top + 1, count), edge])
    q = np.concatenate([rng.integers(-top - 1, top + 1, count), edge[::-1]])
    return i, q


class TestDemod:
    @pytest.mark.parametrize("aw", [16, 20, 24])
    def test_phase_wrap(self, aw):
        half = 1 << (aw - 1)
        d = np.concatenate([np.arange(-3 * half, 3 * half, half // 7 + 1),
                            [half, half - 1, -half, -half - 1, 0, 2 * half, -2 * half]])
        got = demod.phase_wrap(torch.from_numpy(d), aw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jdm.phase_wrap(jnp.asarray(d), aw)))
        assert got.min() >= -half and got.max() < half
        assert demod.phase_wrap(half, aw) == -half

    @pytest.mark.parametrize("fn", ["fm_demod_phase", "fm_demod_conj"])
    @pytest.mark.parametrize("iw,aw", [(16, 20), (17, 20), (20, 24), (15, 16), (16, 24)])
    def test_demods_vs_jax(self, fn, iw, aw):
        i, q = _iq(iw, 3000, seed=iw * aw)
        got = getattr(demod, fn)(i, q, iw, aw, device="cpu")
        want = np.asarray(getattr(jdm, fn)(i, q, iw, aw))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("fn", ["fm_demod_phase", "fm_demod_conj"])
    def test_batched_channels_vs_jax(self, fn):
        i, q = _iq(16, 4 * 500 - 10, seed=7)
        i, q = i.reshape(4, 500), q.reshape(4, 500)
        got = getattr(demod, fn)(torch.from_numpy(i), torch.from_numpy(q), 16, 20)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jdm, fn)(i, q, 16, 20)))

    @pytest.mark.parametrize("fn", ["fm_demod_phase", "fm_demod_conj"])
    def test_fm_tone_recovery(self, fn):
        aw, n = 20, np.arange(4096)
        inst_f = 0.1 + 0.02 * np.sin(2 * math.pi * 0.003 * n)
        ph = 2 * math.pi * np.cumsum(inst_f)
        i = np.round(30000 * np.cos(ph)).astype(np.int64)
        q = np.round(30000 * np.sin(ph)).astype(np.int64)
        f_est = getattr(demod, fn)(i, q, 17, aw, device="cpu").numpy() / (1 << aw)
        assert np.abs(f_est - inst_f[1:]).mean() < 5e-4


def _chan_budget(x, proto, c):
    """Per output: each branch FIR is an f32 dot product of tpb terms, so
    the two sides' branch outputs differ by at most 2 gamma(tpb) B with
    B = sum|h| max|x| (>= every |branch output|); the C-point DFT passes
    that on with gain <= C, and its own roundings (each output at most
    3 log2 C + 2 deep, over terms <= B) add 2 gamma(3 log2 C + 2) C B."""
    tpb = len(proto) // c
    b = np.abs(np.asarray(proto, np.float32)).sum() * np.abs(x).max()
    return c * b * (2 * _gamma(tpb) + 2 * _gamma(3 * math.log2(c) + 2))


class TestChannelizer:
    def test_prototype_bit_equal(self):
        for c, tpb, win in ((4, 6, "bh4"), (8, 12, "bh4"), (16, 8, "bh7")):
            np.testing.assert_array_equal(channelizer.design_prototype(c, tpb, window=win),
                                          jch.design_prototype(c, tpb, window=win))

    @pytest.mark.parametrize("kind", ["real", "complex"])
    @pytest.mark.parametrize("c,tpb", [(4, 6), (8, 12), (16, 8)])
    def test_vs_jax_within_f32_budget(self, kind, c, tpb):
        proto = channelizer.design_prototype(c, tpb)
        rng = np.random.default_rng(c * tpb)
        t = c * 256
        x = rng.normal(size=t).astype(np.float32)
        if kind == "complex":
            x = (x + 1j * rng.normal(size=t)).astype(np.complex64)
        got = channelizer.polyphase_channelize(x, proto, c, device="cpu")
        want = np.asarray(jch.polyphase_channelize(x, proto, c))
        assert got.dtype == torch.complex64 and got.shape == want.shape == (256 - tpb + 1, c)
        assert np.abs(got.numpy() - want).max() <= _chan_budget(np.abs(x), proto, c)

    def test_float64_input_vs_jax(self):
        c, tpb = 8, 12
        proto = channelizer.design_prototype(c, tpb)
        x = np.exp(2j * math.pi * 3 * np.arange(c * 64) / c)
        got = channelizer.polyphase_channelize(x, proto, c, device="cpu")
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), np.asarray(jch.polyphase_channelize(x, proto, c)),
                                   rtol=0, atol=1e-12)

    def test_tone_lands_in_its_channel(self):
        c, tpb = 8, 12
        proto = channelizer.design_prototype(c, tpb)
        n = np.arange(c * 256)
        for k0 in (0, 1, 3, 7):
            y = channelizer.polyphase_channelize(np.exp(2j * math.pi * k0 * n / c), proto, c,
                                                 device="cpu").numpy()
            p = np.mean(np.abs(y) ** 2, axis=0)
            p = p / p.max()
            assert p.argmax() == k0
            assert 10 * np.log10(np.delete(p, k0).max() + 1e-30) < -60

    def test_bad_lengths(self):
        proto = channelizer.design_prototype(4, 8)
        with pytest.raises(ValueError, match="input length"):
            channelizer.polyphase_channelize(np.zeros(33), proto, 4, device="cpu")
        with pytest.raises(ValueError, match="prototype length"):
            channelizer.polyphase_channelize(np.zeros(32), proto[:-1], 4, device="cpu")


class TestSdrChain:
    @pytest.mark.parametrize("c,tpb,offset,t", [(4, 6, 0.005, 4 * 2048), (8, 8, 0.002, 8 * 1024),
                                                (4, 8, 0.01, 4 * 512)])
    def test_vs_jax(self, c, tpb, offset, t):
        proto = channelizer.design_prototype(c, tpb)
        n = np.arange(t)
        x = (np.cos(2 * math.pi * (1 / c + offset) * n)
             + 0.3 * np.random.default_rng(t).normal(size=t)).astype(np.float32)
        got = sdr.sdr_chain(x, proto, c, device="cpu").numpy()
        want = np.asarray(jsdr.sdr_chain(x, proto, c))
        assert got.shape == want.shape == (t // c - tpb, c)
        # the I/Q ints of both sides: an f32 rounding difference in the
        # channelizer can move round(y * 2^14) by one LSB where y * 2^14 sits
        # within the budget of a half-integer
        y = channelizer.polyphase_channelize(x, proto, c, device="cpu").numpy()
        jy = np.asarray(jch.polyphase_channelize(x, proto, c))
        agree = ((np.round(y.real * 2.0**14) == np.round(jy.real * 2.0**14))
                 & (np.round(y.imag * 2.0**14) == np.round(jy.imag * 2.0**14)))
        assert 1 - agree.mean() <= 0.02
        both = agree[1:] & agree[:-1]  # output n reads frames n-1 and n
        np.testing.assert_array_equal(got[both], want[both])

    def test_channel_offset_recovered(self):
        # dryrun stage 4's configuration: 4 channels, 6 taps/branch, AW=20
        c, tpb, offset = 4, 6, 0.005
        n = np.arange(c * 256)
        x = np.cos(2 * np.pi * (1 / c + offset) * n).astype(np.float32)
        out = sdr.sdr_chain(x, channelizer.design_prototype(c, tpb), c, angle_width=20,
                            device="cpu")
        f1 = float(out[:, 1].double().mean()) / (1 << 20)
        assert abs(f1 - offset * c) < 2e-3
