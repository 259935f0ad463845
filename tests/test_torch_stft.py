"""PyTorch port, STFT / WOLA: ``stft`` against the JAX package within the
f32 budget, ``overlap_add`` on both branches (the shifted-add path in the
JAX package's order, bit-equal; the ``index_add_`` scatter within
rounding), and ``istft`` round trips through the three window pairs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.pipeline import stft as jstft
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.pipeline import stft
from blackman_harris_win_tpu_torch.windows import catalog


def _budget(nfft):
    """f32 budget per bin, relative to the largest bin: ~nfft f32 ops,
    eps 2^-24, coherence sqrt(nfft), x32 margin (``__graft_entry__.py:148-152``)."""
    return 32 * 2.0**-24 * np.sqrt(nfft)


def _naive_ola(frames, hop, length=None):
    *lead, nf, nfft = frames.shape
    out = np.zeros(tuple(lead) + (length or (nf - 1) * hop + nfft,), frames.dtype)
    for m in range(nf):
        out[..., m * hop:m * hop + nfft] += frames[..., m, :]
    return out


def _win(name, nfft):
    return catalog.float_window_value(name, np.arange(nfft), nfft).astype(np.float32)


class TestStft:
    @pytest.mark.parametrize("nfft,hop", [(256, 128), (256, 64), (1024, 256), (16, 6), (64, 64)])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_vs_jax_within_budget(self, nfft, hop, dtype):
        t = nfft + 9 * hop
        x = np.random.default_rng(nfft + hop).normal(size=(2, t)).astype(dtype)
        win = _win("bh4", nfft)
        got = stft.stft(x, win, nfft, hop, device="cpu")
        want = np.asarray(jstft.stft(x, win, nfft, hop))
        assert got.shape == want.shape == (2, 10, nfft // 2 + 1)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < _budget(nfft)


class TestOverlapAdd:
    @pytest.mark.parametrize("hop", [2, 4, 8])  # hop | nfft: shifted adds
    def test_shifted_add_path_vs_jax(self, hop):
        fr = np.random.default_rng(hop).normal(size=(5, 6, 8)).astype(np.float32)
        got = stft.overlap_add(torch.from_numpy(fr), hop).numpy()
        # each sample sums r = nfft/hop pieces; XLA may fuse them in another
        # order, so two f32 orders differ by at most 2 gamma(r) r max|piece|
        r = 8 // hop
        bound = 2 * r * 2.0**-24 / (1 - r * 2.0**-24) * r * np.abs(fr).max()
        assert np.abs(got - np.asarray(jstft.overlap_add(jnp.asarray(fr), hop))).max() <= bound
        assert np.abs(got - _naive_ola(fr.astype(np.float64), hop)).max() <= bound

    @pytest.mark.parametrize("hop", [3, 5, 7])  # hop does not divide nfft: index_add_
    def test_scatter_path_vs_jax(self, hop):
        fr = np.random.default_rng(hop).normal(size=(2, 6, 8))
        got = stft.overlap_add(torch.from_numpy(fr), hop)
        want = np.asarray(jstft.overlap_add(jnp.asarray(fr), hop))
        # at most nfft/hop + 1 overlapping terms per sample, each add rounded
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * 2.0**-52 * 8)
        np.testing.assert_allclose(got.numpy(), _naive_ola(fr, hop), rtol=0, atol=1e-13)

    @pytest.mark.parametrize("hop,length", [(4, 20), (4, 23), (3, 30)])
    def test_explicit_length(self, hop, length):
        fr = np.ones((2, 8), np.float32)
        got = stft.overlap_add(torch.from_numpy(fr), hop, length=length)
        assert got.shape == (length,)
        np.testing.assert_array_equal(got.numpy(), _naive_ola(fr, hop, length))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jstft.overlap_add(jnp.asarray(fr), hop, length=length)))

    def test_length_too_short_raises(self):
        with pytest.raises(ValueError, match="overlap-add extent"):
            stft.overlap_add(torch.ones(2, 8), 4, length=10)


class TestRoundTrip:
    @pytest.mark.parametrize("name", ["hann", "bh4", "bh7"])
    @pytest.mark.parametrize("div", [2, 4])
    def test_quantized_pair(self, name, div):
        spec = WindowSpec(8, 17)
        nfft, hop = spec.n, spec.n // div
        fwd, inv, win = stft.quantized_stft_pair(name, spec, hop, device="cpu")
        _, _, jwin = jstft.quantized_stft_pair(name, jconfig.WindowSpec(8, 17), hop)
        np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
        x = np.random.default_rng(4).normal(size=nfft + 13 * hop).astype(np.float32)
        y = inv(fwd(x)).numpy()
        assert np.abs(y - x)[nfft - hop:-(nfft - hop)].max() < 2e-5

    @pytest.mark.parametrize("name", ["bh4", "bh7"])
    def test_float_pair(self, name):
        pw = 9
        nfft, hop = 1 << pw, 1 << (pw - 1)
        fwd, inv, win = stft.float_stft_pair(name, pw, device="cpu")
        assert win.dtype == torch.float32 and win.shape == (nfft,)
        x = np.random.default_rng(5).normal(size=nfft + 11 * hop).astype(np.float32)
        y = inv(fwd(torch.from_numpy(x))).numpy()
        assert np.abs(y - x)[nfft - hop:-(nfft - hop)].max() < 2e-5
        jfwd, jinv, _ = jstft.float_stft_pair(name, pw)
        inner = slice(nfft - hop, -(nfft - hop))  # the edges are ill-conditioned
        np.testing.assert_allclose(y[inner], np.asarray(jinv(jfwd(x)))[inner], rtol=0, atol=4e-5)

    @pytest.mark.parametrize("name", ["bh4", "bh7"])
    def test_comp_pair(self, name):
        pw = 9
        nfft, hop = 1 << pw, 1 << (pw - 2)
        fwd, inv, (whi, wlo) = stft.comp_stft_pair(name, pw, hop, device="cpu")
        _, _, (jhi, jlo) = jstft.comp_stft_pair(name, pw, hop)
        np.testing.assert_array_equal(whi.numpy(), np.asarray(jhi))
        x = np.random.default_rng(6).normal(size=nfft + 11 * hop).astype(np.float32)
        y = inv(fwd(x)).numpy()
        assert np.abs(y - x)[nfft - hop:-(nfft - hop)].max() < 2e-5

    def test_scatter_round_trip(self):
        nfft, hop = 16, 6
        win = catalog.float_window_value("bh4", np.arange(nfft), nfft)
        x = np.random.default_rng(5).normal(size=nfft + 5 * hop)
        y = stft.istft(stft.stft(x, win, nfft, hop, device="cpu"), win, hop).numpy()
        np.testing.assert_allclose(y[nfft:-nfft], x[nfft:-nfft], rtol=0, atol=1e-9)

    def test_separate_synthesis_window(self):
        nfft, hop = 16, 8
        win = catalog.float_window_value("hamming", np.arange(nfft), nfft)
        x = np.random.default_rng(6).normal(size=nfft + 7 * hop)
        s = stft.stft(x, win, nfft, hop, device="cpu")
        y = stft.istft(s, win, hop, synthesis_win=np.ones(nfft)).numpy()
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-9)
        want = np.asarray(jstft.istft(jstft.stft(x, win, nfft, hop), win, hop,
                                      synthesis_win=jnp.ones(nfft)))
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-12)

    def test_f32_input_keeps_f32_with_a_float64_window(self):
        # the window takes x's dtype (and s's real dtype), as the JAX
        # package's output does with x64 off
        nfft, hop = 1024, 512
        x = np.random.default_rng(8).normal(size=nfft + 6 * hop).astype(np.float32)
        s = stft.stft(x, np.hanning(nfft), nfft, hop, device="cpu")
        assert s.dtype == torch.complex64
        y = stft.istft(s, np.hanning(nfft), hop)
        assert y.dtype == torch.float32
        want = np.asarray(jstft.stft(x, np.hanning(nfft), nfft, hop))
        assert np.abs(s.numpy() - want).max() / np.abs(want).max() < _budget(nfft)
        inner = slice(nfft - hop, -(nfft - hop))
        assert np.abs(y.numpy() - x)[inner].max() < 2e-5

    def test_istft_takes_numpy_input(self):
        nfft, hop = 256, 64
        win = _win("bh4", nfft)
        x = np.random.default_rng(9).normal(size=nfft + 9 * hop).astype(np.float32)
        s = np.array(jstft.stft(x, win, nfft, hop))
        got = stft.istft(s, win, hop, device="cpu")
        assert got.device.type == "cpu" and got.shape == x.shape
        want = np.asarray(jstft.istft(jnp.asarray(s), win, hop))
        inner = slice(nfft - hop, -(nfft - hop))
        np.testing.assert_allclose(got.numpy()[inner], want[inner], rtol=0, atol=2e-5)

    def test_batched_channels(self):
        nfft, hop = 16, 8
        win = catalog.float_window_value("hann", np.arange(nfft), nfft)
        x = np.random.default_rng(7).normal(size=(3, nfft + 5 * hop))
        y = stft.istft(stft.stft(x, win, nfft, hop, device="cpu"), win, hop).numpy()
        assert y.shape == x.shape
        np.testing.assert_allclose(y[:, nfft:-nfft], x[:, nfft:-nfft], rtol=0, atol=1e-9)
