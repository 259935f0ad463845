"""PyTorch port, FIR design and the decimating FIR: ``design_lowpass``
bit-equal to the JAX package; ``decimating_fir`` on its three branches
(frames, bulk with the materialization barrier, general conv) against JAX
and a float64 reference within a derived f32 bound."""

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.pipeline import fir as jfir
from blackman_harris_win_tpu_torch.pipeline import fir

_U = 2.0**-24


def _gamma(k):
    return k * _U / (1 - k * _U)


def _f64_fir(x, h, decim):
    """y[m] = sum_t h[t] x[m*decim + t] in float64 (valid region)."""
    x, h = np.asarray(x, np.float64), np.asarray(h, np.float64)
    n = len(h)
    m = (x.shape[-1] - n) // decim + 1
    idx = np.arange(m)[:, None] * decim + np.arange(n)[None, :]
    return x[..., idx] @ h


def _bound(x, h):
    """Two f32 evaluations of one n-tap dot product differ by at most
    2 gamma(n) sum|h_t x_t| <= 2 gamma(n) sum|h| max|x| (taps rounded to
    f32 on both sides)."""
    h32 = np.asarray(h, np.float32).astype(np.float64)
    return 2 * _gamma(len(h)) * np.abs(h32).sum() * np.abs(np.asarray(x, np.float64)).max()


class TestDesignLowpass:
    @pytest.mark.parametrize("window,data_width", [("bh4", 24), ("hann", 24), ("bh7", 30),
                                                   ("bh4", 17), ("hamming", 24)])
    @pytest.mark.parametrize("num_taps,cutoff", [(64, 0.2), (127, 0.25), (33, 0.4), (255, 0.2)])
    def test_bit_equal_to_jax(self, window, data_width, num_taps, cutoff):
        got = fir.design_lowpass(num_taps, cutoff, window=window, data_width=data_width)
        want = jfir.design_lowpass(num_taps, cutoff, window=window, data_width=data_width)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)

    def test_bad_cutoff(self):
        for c in (0.0, 1.0, 1.5):
            with pytest.raises(ValueError, match="cutoff"):
                fir.design_lowpass(64, c)


class TestDecimatingFir:
    @pytest.mark.parametrize("t,n_taps,decim", [
        (4096, 64, 4),  # frames: m_total * n_taps = 1009 * 64 <= 2^25
        (300, 33, 1),  # frames (decim 1 divides every length)
        (1 << 22, 64, 4),  # bulk: (2^20 - 15) * 64 > 2^25 -> barrier + conv
        (300, 33, 2),  # general conv (n_taps % decim != 0)
        (301, 32, 4),  # general conv (T % decim != 0)
    ])
    def test_branches_vs_jax_and_f64(self, monkeypatch, t, n_taps, decim):
        calls = []
        monkeypatch.setattr(fir, "materialize", lambda v: calls.append(v.shape) or v.clone())
        x = np.random.default_rng(t + n_taps).normal(size=t).astype(np.float32)
        h = fir.design_lowpass(n_taps, 0.4)
        got = fir.decimating_fir(x, h, decim, device="cpu")
        want = np.asarray(jfir.decimating_fir(x, h, decim))
        assert got.dtype == torch.float32 and got.shape == want.shape
        bound = _bound(x, h)
        assert np.abs(got.numpy() - want).max() <= bound
        assert np.abs(got.numpy() - _f64_fir(x, h, decim)).max() <= bound
        bulk = n_taps % decim == 0 and t % decim == 0 and (
            ((t - n_taps) // decim + 1) * n_taps > fir.FRAMES_MAX)
        assert calls == ([x.shape] if bulk else [])

    def test_batched(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 256)).astype(np.float32)
        h = fir.design_lowpass(17, 0.3)
        y = fir.decimating_fir(torch.from_numpy(x), h, 2)
        assert y.shape == (3, (256 - 17) // 2 + 1)
        want = np.asarray(jfir.decimating_fir(x, h, 2))
        assert np.abs(y.numpy() - want).max() <= _bound(x, h)
        for c in range(3):
            torch.testing.assert_close(y[c], fir.decimating_fir(torch.from_numpy(x[c]), h, 2),
                                       rtol=0, atol=_bound(x, h))

    def test_batched_frames_path(self):
        x = np.random.default_rng(2).normal(size=(2, 5, 1024)).astype(np.float32)
        h = fir.design_lowpass(16, 0.2)
        y = fir.decimating_fir(torch.from_numpy(x), h, 4)
        want = np.asarray(jfir.decimating_fir(x, h, 4))
        assert y.shape == want.shape == (2, 5, (1024 - 16) // 4 + 1)
        assert np.abs(y.numpy() - want).max() <= _bound(x, h)

    def test_float64_input_stays_float64(self):
        x = np.random.default_rng(3).normal(size=512)
        h = fir.design_lowpass(32, 0.3)
        y = fir.decimating_fir(x, h, 4, device="cpu")
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), np.asarray(jfir.decimating_fir(x, h, 4)),
                                   rtol=0, atol=1e-12)

    def test_tensor_input_runs_where_it_lies(self):
        x = torch.randn(64)
        assert fir.decimating_fir(x, np.ones(8) / 8, 4).device == x.device
