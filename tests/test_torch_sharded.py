"""PyTorch port, the sharded steps against the JAX package's sharded makers
on the conftest's 8-device virtual CPU mesh (the port on
``make_mesh(..., devices=["cpu"] * n)``), on the same seeded inputs:

- ``make_sharded_welch`` in every win_mode and fft_mode at (channels,
  blocks) in {(2, 4), (1, 8), (4, 2)}: per bin within the derived f32
  budget ``32 * 2^-24 * sqrt(nfft)`` of JAX and of a float64 reference on
  the circularly extended input;
- ``make_sharded_decimating_fir``: within 2 gamma(n_taps) sum|h| max|x| of
  JAX and of the float64 circular reference;
- ``make_sharded_ddc`` with each NCO flavour passed explicitly: the mixer
  integers 0 LSB against JAX's at the wrapped global indices, the output
  within the FIR bound of JAX's sharded DDC and of the port's ``ddc``;
- ``make_sharded_sdr_chain``: 0 LSB against the port's ``sdr_chain`` of
  the circularly extended input, and against JAX wherever the two sides
  quantize the channel envelopes to the same ints;
- ``make_sharded_stft``: bit-equal to the port's ``stft`` of the circularly
  extended input, within the f32 budget of JAX; ``make_sharded_istft``:
  the exact round trip (< 2e-5 at every sample), within the budget of JAX's
  inverse, and ``hop`` not dividing ``nfft`` raising.
"""

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.dist import mesh as jmesh
from blackman_harris_win_tpu.pipeline import ddc as jddc
from blackman_harris_win_tpu.pipeline import fir as jfir
from blackman_harris_win_tpu.pipeline import sdr as jsdr
from blackman_harris_win_tpu.pipeline import spectral as jsp
from blackman_harris_win_tpu.pipeline import stft as jstft
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.dist.halo import with_left_halo
from blackman_harris_win_tpu_torch.dist.mesh import make_mesh, shard, unshard
from blackman_harris_win_tpu_torch.kernels.window import window_samples
from blackman_harris_win_tpu_torch.pipeline import channelizer, ddc, fir, sdr, spectral, stft
from blackman_harris_win_tpu_torch.windows import catalog

MESHES = [(2, 4), (1, 8), (4, 2)]  # (channels, blocks)
_U = 2.0**-24


def _gamma(k):
    return k * _U / (1 - k * _U)


def _pmesh(channels, blocks):
    return make_mesh(blocks=blocks, channels=channels, devices=["cpu"] * (channels * blocks))


def _jrun(make, spec, x, channels=1, blocks=8):
    """A JAX sharded maker's step on x placed by ``spec`` over a (channels,
    blocks) virtual mesh, as numpy."""
    m = jmesh.make_mesh(blocks=blocks, channels=channels)
    return np.asarray(jax.jit(make(m))(jax.device_put(jnp.asarray(x), NamedSharding(m, spec))))


def _budget(nfft):
    return 32 * _U * math.sqrt(nfft)


# --- Welch --------------------------------------------------------------------

WSPEC = WindowSpec(8, 17)  # nfft = 256, the smallest mxu size
NFFT, HOP = 256, 128
BH4 = catalog.get("bh4")
WIN_MODES = ["quantized", "float", "comp"]
FFT_MODES = ["rfft", "packed", "mxu"]


def _welch_x():
    # 4 channels split over 1, 2 or 4; 8 * 512 samples over 2, 4 or 8 blocks
    return np.random.default_rng(42).normal(size=(4, 8 * 512)).astype(np.float32)


def _welch_coeffs(win_mode):
    return BH4.quantized(17) if win_mode == "quantized" else "bh4"


@lru_cache(maxsize=None)
def _jax_welch(win_mode, fft_mode):
    jspec = jconfig.WindowSpec(8, 17)
    return _jrun(lambda m: jsp.make_sharded_welch(m, jspec, _welch_coeffs(win_mode), BH4.shift,
                                                  NFFT, HOP, win_mode=win_mode,
                                                  fft_mode=fft_mode),
                 P("channels", "blocks"), _welch_x(), channels=2, blocks=4)


@lru_cache(maxsize=None)
def _f64_welch_ref(win_mode):
    x = _welch_x()
    if win_mode == "quantized":
        win = window_samples(torch.arange(NFFT), BH4.quantized(17), WSPEC).double().numpy()
        win = win * spectral.window_scale(WSPEC, BH4.shift)
    else:
        win = catalog.float_window_value("bh4", np.arange(NFFT), NFFT)
    xe = np.concatenate([x, x[:, :NFFT - HOP]], axis=1).astype(np.float64)
    frames = np.stack([xe[:, m * HOP:m * HOP + NFFT] for m in range(x.shape[1] // HOP)], axis=1)
    return (np.abs(np.fft.rfft(frames * win, axis=-1)) ** 2).mean(axis=1)


class TestShardedWelch:
    @pytest.mark.parametrize("channels,blocks", MESHES)
    @pytest.mark.parametrize("win_mode", WIN_MODES)
    @pytest.mark.parametrize("fft_mode", FFT_MODES)
    def test_within_budget_of_jax_and_f64(self, channels, blocks, win_mode, fft_mode):
        step = spectral.make_sharded_welch(_pmesh(channels, blocks), WSPEC,
                                           _welch_coeffs(win_mode), BH4.shift, NFFT, HOP,
                                           win_mode=win_mode, fft_mode=fft_mode)
        out = step(_welch_x())
        assert out.spec == ("channels", None)
        got = unshard(out).numpy().astype(np.float64)
        assert got.shape == (4, NFFT // 2 + 1)
        for want in (_f64_welch_ref(win_mode), _jax_welch(win_mode, fft_mode)):
            rel = np.max(np.abs(got - want) / np.abs(want))
            assert rel < _budget(NFFT), rel
        # every block shard holds the same mean
        for c in range(channels):
            for b in range(blocks):
                assert torch.equal(out.shards[c][b], out.shards[c][0])

    @pytest.mark.parametrize("win_mode", WIN_MODES)
    def test_matches_the_single_device_analyzer(self, win_mode):
        """One block: the sharded step is the single-device analyzer on the
        circularly extended input (the same frames, one pmean term)."""
        x = _welch_x()
        got = unshard(spectral.make_sharded_welch(
            _pmesh(1, 1), WSPEC, _welch_coeffs(win_mode), BH4.shift, NFFT, HOP,
            win_mode=win_mode)(x))
        xe = torch.from_numpy(np.concatenate([x, x[:, :NFFT - HOP]], axis=1))
        want = spectral.windowed_power_spectrum(xe, _welch_coeffs(win_mode), WSPEC, hop=HOP,
                                                win_mode=win_mode)
        assert torch.equal(got, want)

    def test_bad_arguments_raise(self):
        m = _pmesh(1, 8)
        with pytest.raises(ValueError, match="multiple of hop"):
            spectral.make_sharded_welch(m, WSPEC, BH4.quantized(17), BH4.shift, NFFT, 96)(
                _welch_x())
        with pytest.raises(ValueError, match="win_mode must be"):
            spectral.make_sharded_welch(m, WSPEC, "bh4", 1, NFFT, HOP, win_mode="exact")
        with pytest.raises(ValueError, match="nfft == 2"):
            spectral.make_sharded_welch(m, WSPEC, "bh4", 1, 128, 64, win_mode="float")
        with pytest.raises(ValueError, match="window name or float"):
            spectral.make_sharded_welch(m, WSPEC, BH4.quantized(17), 1, NFFT, HOP,
                                        win_mode="comp")


# --- decimating FIR -------------------------------------------------------------


class TestShardedFir:
    @pytest.mark.parametrize("channels,blocks", MESHES)
    @pytest.mark.parametrize("n_taps,decim", [(16, 4), (33, 3), (8, 8), (64, 4)])
    def test_matches_jax_and_the_circular_reference(self, channels, blocks, n_taps, decim):
        h = fir.design_lowpass(n_taps, 0.8 / decim).astype(np.float32)
        t = 8 * 24 * decim
        x = np.random.default_rng(n_taps).normal(size=(4, t)).astype(np.float32)
        out = fir.make_sharded_decimating_fir(_pmesh(channels, blocks), h, decim)(x)
        assert out.spec == ("channels", "blocks")
        got = unshard(out).numpy().astype(np.float64)
        want = _jrun(lambda m: jfir.make_sharded_decimating_fir(m, h, decim),
                     P("channels", "blocks"), x, channels=2, blocks=4)
        halo = n_taps - decim
        idx = (np.arange(t // decim)[:, None] * decim - halo + np.arange(n_taps)) % t
        ref = (x.astype(np.float64)[:, idx] * h.astype(np.float64)).sum(-1)
        # each side's f32 dot product of n_taps terms lies within
        # gamma(n_taps) sum|h| max|x| of the exact sum
        bound = 2 * _gamma(n_taps) * np.abs(h).sum() * np.abs(x).max()
        assert got.shape == want.shape == (4, t // decim)
        assert np.abs(got - want).max() <= bound
        assert np.abs(got - ref).max() <= bound

    def test_bad_arguments_raise(self):
        m = _pmesh(1, 4)
        with pytest.raises(ValueError, match="decimation larger than filter"):
            fir.make_sharded_decimating_fir(m, np.ones(3), 4)
        with pytest.raises(ValueError, match="multiple of decim"):
            fir.make_sharded_decimating_fir(m, np.ones(8), 4)(np.zeros((1, 4 * 6)))


# --- DDC ----------------------------------------------------------------------------

DDC_FLAVORS = ["dds48", "scaled"]


def _ddc_x(t, seed):
    n = np.arange(t)
    return (0.7 * np.cos(2 * np.pi * (1 / 8 + 0.004) * n)
            + 0.2 * np.random.default_rng(seed).normal(size=t)).astype(np.float32)


def _ddc_bound(h, x, flavor, pw=20, w=16):
    """Phase 7's bound on each side against the float64 FIR of the exact
    mixer ints m, gamma(n_taps + 4) sum|h| max|m|, doubled: both sides are
    such f32 results."""
    amp_in = float((1 << ddc.MIX_IN_BITS) - 1)
    xq = torch.round(torch.from_numpy(x) * amp_in).to(torch.int32)
    mi, mq = ddc.mix_iq_int(xq, torch.arange(len(x)), ddc.freq_word(1 / 8, pw), pw, w, flavor)
    max_m = max(mi.abs().max(), mq.abs().max()).item() / (amp_in * (1 << (w - 2)))
    return 2 * _gamma(len(h) + 4) * np.abs(h).sum() * max_m


class TestShardedDdc:
    @pytest.mark.parametrize("flavor", DDC_FLAVORS)
    @pytest.mark.parametrize("blocks,n_taps,decim", [(4, 64, 4), (8, 16, 4), (2, 33, 3),
                                                     (4, 8, 8), (1, 64, 4)])
    def test_matches_jax_and_single_device(self, flavor, blocks, n_taps, decim):
        t = blocks * 64 * decim
        x = _ddc_x(t, blocks * n_taps)
        h = fir.design_lowpass(n_taps, 0.8 / decim)
        out = ddc.make_sharded_ddc(make_mesh(blocks=blocks, devices=["cpu"] * blocks), 20, 16,
                                   1 / 8, decim, taps=h, flavor=flavor)(x)
        assert out.spec == (None, "blocks")
        got = unshard(out).numpy().astype(np.float64)
        want = _jrun(lambda m: jddc.make_sharded_ddc(m, 20, 16, 1 / 8, decim, taps=h,
                                                     flavor=flavor),
                     P("blocks"), x, blocks=blocks)
        single = ddc.ddc(torch.from_numpy(x), 1 / 8, decim, taps=h, flavor=flavor).numpy()
        bound = _ddc_bound(h, x, flavor)
        assert got.shape == want.shape == single.shape == (2, t // decim)
        assert np.abs(got - want).max() <= bound
        assert np.abs(got - single).max() <= bound

    @pytest.mark.parametrize("flavor", DDC_FLAVORS)
    @pytest.mark.parametrize("blocks", [2, 4, 8])
    def test_mixer_ints_at_the_wrapped_indices(self, flavor, blocks):
        """Each shard's mixer ints over its halo-extended chunk equal JAX's
        single-device mixer at the circularly wrapped global indices."""
        t, halo = blocks * 256, 60
        x = _ddc_x(t, blocks)
        fw = ddc.freq_word(1 / 8 + 0.0123, 20)
        row = shard(x, make_mesh(blocks=blocks, devices=["cpu"] * blocks), ("blocks",)).row()
        xq = np.round(x * float((1 << ddc.MIX_IN_BITS) - 1)).astype(np.int32)
        for i, xh in enumerate(with_left_halo(row, halo, circular=True)):
            b = t // blocks
            mi, mq = ddc.shard_mixer_ints(xh, i * b - halo, t, fw, 20, 16, flavor)
            n = np.arange(i * b - halo, (i + 1) * b) % t
            ji, jq = jddc.mix_iq_int(xq[n], n.astype(np.int32), fw, 20, 16, flavor)
            np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(mq.numpy(), np.asarray(jq))

    def test_indices_past_2_31_are_masked_as_the_nco_does(self):
        fw, t = ddc.freq_word(0.2371, 20), 1 << 33
        x = torch.full((64,), 0.5)
        for n_first in ((1 << 31) - 32, (1 << 32) - 16, -32):
            mi, mq = ddc.shard_mixer_ints(x, n_first, t, fw, 20, 16)
            n = torch.arange(n_first, n_first + 64)
            n = torch.where(n < 0, n + t, n)
            xq = torch.full((64,), round(0.5 * ((1 << ddc.MIX_IN_BITS) - 1)), dtype=torch.int32)
            wi, wq = ddc.mix_iq_int(xq, n, fw, 20, 16)
            assert torch.equal(mi, wi) and torch.equal(mq, wq)

    def test_defaults_and_guards(self):
        import inspect

        assert inspect.signature(ddc.make_sharded_ddc).parameters["flavor"].default == "dds48"
        assert inspect.signature(ddc.ddc).parameters["flavor"].default == "dds48"
        m = make_mesh(blocks=2, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="decimation larger than filter"):
            ddc.make_sharded_ddc(m, 20, 16, 0.1, 8, taps=np.ones(4))
        with pytest.raises(ValueError, match="multiple of decim"):
            ddc.make_sharded_ddc(m, 20, 16, 0.1, 4, taps=16)(np.zeros(2 * 6, np.float32))


# --- SDR chain ------------------------------------------------------------------------


class TestShardedSdr:
    @pytest.mark.parametrize("channels,blocks", [(1, 4), (2, 4), (1, 8), (1, 1)])
    @pytest.mark.parametrize("c,tpb", [(4, 6), (8, 8)])
    def test_equals_the_circular_single_device_chain(self, channels, blocks, c, tpb):
        t = blocks * c * 32
        n = np.arange(t)
        x = (np.cos(2 * math.pi * (1 / c + 0.005) * n)
             + 0.5 * np.cos(2 * math.pi * 0.07 * n)).astype(np.float32)
        out = sdr.make_sharded_sdr_chain(_pmesh(channels, blocks), c, tpb, angle_width=20)(x)
        assert out.spec == ("blocks",)
        got = unshard(out)
        assert got.shape == (t // c, c)
        halo = c * tpb
        proto = channelizer.design_prototype(c, tpb)
        want = sdr.sdr_chain(torch.from_numpy(np.concatenate([x[-halo:], x])), proto, c)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("blocks", [4, 8])
    def test_matches_jax_where_the_iq_ints_agree(self, blocks):
        c, tpb = 4, 6
        t = blocks * c * 64
        n = np.arange(t)
        x = (np.cos(2 * math.pi * (1 / c + 0.005) * n)
             + 0.3 * np.random.default_rng(blocks).normal(size=t)).astype(np.float32)
        got = unshard(sdr.make_sharded_sdr_chain(make_mesh(blocks=blocks,
                                                           devices=["cpu"] * blocks), c, tpb)(x))
        want = _jrun(lambda m: jsdr.make_sharded_sdr_chain(m, c, tpb), P("blocks"), x,
                     blocks=blocks)
        assert got.shape == want.shape == (t // c, c)
        # the circular chain's channelizer frames, both sides: an f32
        # rounding difference can move round(y * 2^14) by one LSB where
        # y * 2^14 sits within the budget of a half-integer
        proto = channelizer.design_prototype(c, tpb)
        xe = np.concatenate([x[-c * tpb:], x])
        y = channelizer.polyphase_channelize(xe, proto, c, device="cpu").numpy()
        jy = np.asarray(jsdr.polyphase_channelize(xe, proto, c))
        agree = ((np.round(y.real * 2.0**14) == np.round(jy.real * 2.0**14))
                 & (np.round(y.imag * 2.0**14) == np.round(jy.imag * 2.0**14)))
        assert 1 - agree.mean() <= 0.02
        both = agree[1:] & agree[:-1]  # output n reads frames n and n + 1
        np.testing.assert_array_equal(got.numpy()[both], want[both])

    def test_tone_offset_recovered(self):
        # dryrun stage 4: 4 channels, 6 taps a branch, AW=20, 256 frames
        c, tpb, offset = 4, 6, 0.005
        x = np.cos(2 * np.pi * (1 / c + offset) * np.arange(c * 256)).astype(np.float32)
        out = unshard(sdr.make_sharded_sdr_chain(_pmesh(2, 4), c, tpb)(x))
        assert abs(float(out[:, 1].double().mean()) / (1 << 20) - offset * c) < 2e-3


# --- STFT / WOLA -----------------------------------------------------------------------------


def _stft_win(name, spec):
    d = catalog.get(name)
    return d.quantized(spec.data_width), d.shift


class TestShardedStft:
    @pytest.mark.parametrize("channels,blocks", [(2, 4), (1, 8), (2, 2)])
    @pytest.mark.parametrize("div", [2, 4])
    def test_frames_equal_single_device_circular_and_jax(self, channels, blocks, div):
        spec = WindowSpec(6, 17)
        nfft, hop = spec.n, spec.n // div
        q, shift = _stft_win("bh4", spec)
        t = blocks * 4 * hop
        x = np.random.default_rng(10).normal(size=(channels, t)).astype(np.float32)
        out = stft.make_sharded_stft(_pmesh(channels, blocks), spec, q, shift, nfft, hop)(x)
        assert out.spec == ("channels", "blocks", None)
        got = unshard(out)
        assert got.shape == (channels, t // hop, nfft // 2 + 1) and got.dtype == torch.complex64
        win = window_samples(torch.arange(nfft), q, spec).to(torch.float32) * float(
            np.float32(spectral.window_scale(spec, shift)))
        xe = torch.from_numpy(np.concatenate([x, x[:, :nfft - hop]], axis=-1))
        assert torch.equal(got, stft.stft(xe, win, nfft, hop))
        jspec = jconfig.WindowSpec(6, 17)
        want = _jrun(lambda m: jstft.make_sharded_stft(m, jspec, q, shift, nfft, hop),
                     P("channels", "blocks"), x, channels=channels, blocks=blocks)
        assert np.abs(got.numpy() - want).max() <= _budget(nfft) * np.abs(want).max()

    def test_frames_stay_on_the_shard_that_owns_their_first_sample(self):
        spec = WindowSpec(5, 17)
        nfft, hop = spec.n, spec.n // 2
        q, shift = _stft_win("hann", spec)
        x = torch.arange(2 * 4 * 2 * hop, dtype=torch.float32).reshape(2, -1)
        out = stft.make_sharded_stft(_pmesh(2, 4), spec, q, shift, nfft, hop)(x)
        for c in range(2):
            for b in range(4):
                assert out.shards[c][b].shape == (1, 2, nfft // 2 + 1)

    def test_bad_hop_raises(self):
        spec = WindowSpec(5, 17)
        q, shift = _stft_win("hann", spec)
        step = stft.make_sharded_stft(make_mesh(blocks=4, devices=["cpu"] * 4), spec, q, shift,
                                      spec.n, 12)  # 12 does not divide the 8-sample shards
        with pytest.raises(ValueError, match="multiple of hop"):
            step(np.zeros((1, 32), np.float32))


class TestShardedIstft:
    @pytest.mark.parametrize("name", ["hann", "bh4", "bh7"])
    @pytest.mark.parametrize("div", [2, 4])
    @pytest.mark.parametrize("synthesis", [True, False])
    def test_round_trip_exact_everywhere_and_jax(self, name, div, synthesis):
        spec = WindowSpec(6, 17)
        nfft, hop = spec.n, spec.n // div
        q, shift = _stft_win(name, spec)
        m = _pmesh(2, 4)
        t = 4 * 4 * hop
        x = np.random.default_rng(11).normal(size=(2, t)).astype(np.float32)
        s = stft.make_sharded_stft(m, spec, q, shift, nfft, hop)(x)
        out = stft.make_sharded_istft(m, spec, q, shift, nfft, hop, synthesis=synthesis)(s)
        assert out.spec == ("channels", "blocks")
        y = unshard(out).numpy()
        assert y.shape == x.shape
        if synthesis:
            assert np.abs(y - x).max() < 2e-5
        jspec = jconfig.WindowSpec(6, 17)
        want = _jrun(lambda mm: jstft.make_sharded_istft(mm, jspec, q, shift, nfft, hop,
                                                         synthesis=synthesis),
                     P("channels", "blocks", None), unshard(s).numpy(), channels=2, blocks=4)
        assert np.abs(y - want).max() <= _budget(nfft) * np.abs(want).max()

    def test_hop_must_divide_nfft(self):
        spec = WindowSpec(5, 17)
        q, shift = _stft_win("hann", spec)
        with pytest.raises(ValueError, match="hop"):
            stft.make_sharded_istft(make_mesh(blocks=2, devices=["cpu"] * 2), spec, q, shift,
                                    spec.n, 12)
