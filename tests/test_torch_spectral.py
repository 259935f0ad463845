"""PyTorch port, Welch analyzer: DFT tables equal to the JAX package's, the
stage-1 plain version and the fused tail against JAX (interpret mode), and
every fft_mode within the derived f32 budget of a float64 reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.kernels.pallas import welchfft_kernel as jwk
from blackman_harris_win_tpu.pipeline import spectral as jsp
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import welchfft_kernel as wk
from blackman_harris_win_tpu_torch.pipeline import spectral as sp
from blackman_harris_win_tpu_torch.windows import catalog


def _budget(nfft):
    """f32-arithmetic budget per bin: ~nfft f32 ops, eps 2^-24, coherence
    sqrt(nfft), x32 margin (``__graft_entry__.py:148-152``)."""
    return 32 * 2.0**-24 * np.sqrt(nfft)


def _f64_welch(x, win, nfft, hop):
    x = np.asarray(x, np.float64)
    nf = (x.shape[-1] - nfft) // hop + 1
    fr = np.stack([x[..., m * hop:m * hop + nfft] for m in range(nf)], axis=-2)
    return (np.abs(np.fft.rfft(fr * np.asarray(win, np.float64), axis=-1)) ** 2).mean(-2)


def _max_rel(got, want, per_bin=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.abs(want) if per_bin else np.abs(want).max()
    return float(np.max(np.abs(got - want) / den))


def _signal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class TestTables:
    @pytest.mark.parametrize("nfft", [1 << 8, 1 << 12, 1 << 13, 1 << 14, 1 << 19,
                                      1 << 20, 1 << 21])
    def test_dft_tables_equal(self, nfft):
        radices, mats, tws = sp._dft_tables(nfft)
        jr, jmats, jtws = jsp._dft_tables(nfft)
        assert radices == jr
        for a, b in zip(mats + tws, jmats + jtws):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    @pytest.mark.parametrize("nfft", [1 << 13, 1 << 20])
    def test_stage1_tables_equal(self, nfft):
        for a, b in zip(sum(wk._tables(nfft, 128), ()), sum(jwk._tables(nfft, 128), ())):
            np.testing.assert_array_equal(a, b)

    def test_radices_and_gate(self):
        for k in range(7, 24):
            nfft = 1 << k
            assert sp._fused_ok(nfft) == jsp._fused_ok(nfft)
            if nfft >= 256:
                assert sp._mxu_radices(nfft) == jsp._mxu_radices(nfft)
        with pytest.raises(ValueError):
            sp._mxu_radices(384)


class TestFrames:
    @pytest.mark.parametrize("nfft,hop", [(64, 32), (64, 16), (64, 24)])
    def test_frames_view(self, nfft, hop):
        x = _signal((2, nfft + 5 * hop), 1)
        got = sp.frames_view(torch.from_numpy(x), nfft, hop).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsp.frames_view(jnp.asarray(x), nfft, hop)))


class TestStage1:
    @pytest.mark.parametrize("nframes", [4, 5])
    def test_plain_matches_pallas_interpret(self, nframes):
        nfft = 1 << 13
        hop = nfft // 2
        x = _signal(hop * nframes + hop, nframes)
        win = np.hanning(nfft).astype(np.float32)
        gr, gi, nf = wk.welch_stage1_fused(torch.from_numpy(x), torch.from_numpy(win), nfft)
        jr, ji, jnf = jwk.welch_stage1_fused(jnp.asarray(x), jnp.asarray(win), nfft,
                                              interpret=True)
        assert nf == jnf == nframes
        scale = max(np.abs(np.asarray(jr)).max(), np.abs(np.asarray(ji)).max())
        for a, b in ((gr, jr), (gi, ji)):
            assert np.abs(a.numpy() - np.asarray(b)).max() / scale < 1e-5

    @pytest.mark.parametrize("nframes", [4, 5])
    def test_fused_mean_power_matches_jax(self, nframes):
        nfft = 1 << 13
        hop = nfft // 2
        x = _signal(hop * nframes + hop, 10 + nframes)
        win = np.hanning(nfft).astype(np.float32)
        got = sp._mxu_fused_mean_power(torch.from_numpy(x), torch.from_numpy(win), nfft)
        want = jsp._mxu_fused_mean_power(jnp.asarray(x), jnp.asarray(win), nfft,
                                         interpret=True)
        assert _max_rel(got.numpy(), want, per_bin=False) < 1e-5

    @pytest.mark.parametrize("nframes", [3, 4])
    def test_fused_three_stage_tail(self, nframes):
        # nfft = 2^19: radices (128, 64, 64), so the tail applies a twiddle
        nfft = 1 << 19
        hop = nfft // 2
        x = _signal(hop * nframes + hop, 20 + nframes)
        win = np.hanning(nfft).astype(np.float32)
        got = sp._mxu_fused_mean_power(torch.from_numpy(x), torch.from_numpy(win), nfft)
        want = jsp.welch_power(x, win, nfft, hop, "rfft")
        assert _max_rel(got.numpy(), want, per_bin=False) < 1e-5

    def test_geometry_checks(self):
        with pytest.raises(ValueError):
            wk.welch_stage1_plain(torch.zeros(3000), torch.ones(1024), 1024)
        with pytest.raises(ValueError):
            wk.welch_stage1_plain(torch.zeros(2, 2048), torch.ones(1024), 1024)


class TestAnalyzer:
    @pytest.mark.parametrize("fft_mode", ["rfft", "packed", "mxu"])
    @pytest.mark.parametrize("pw", [8, 12])
    @pytest.mark.parametrize("nframes", [7, 8])
    def test_windowed_power_spectrum(self, fft_mode, pw, nframes):
        spec = WindowSpec(pw, 17, overflow="saturate")
        nfft = spec.n
        hop = nfft // 2
        x = _signal(hop * nframes + hop, pw * 10 + nframes)
        got = sp.windowed_power_spectrum(torch.from_numpy(x), "bh4", spec,
                                         fft_mode=fft_mode).numpy()
        jspec = jconfig.WindowSpec(**vars(spec))
        want_jax = np.asarray(jsp.windowed_power_spectrum(jnp.asarray(x), "bh4", jspec,
                                                          fft_mode=fft_mode))
        wq = np.asarray(jkw.window_samples(np.arange(nfft), catalog.get("bh4").quantized(17),
                                           jspec), np.float64)
        ref = _f64_welch(x, wq * sp.window_scale(spec, 1), nfft, hop)
        assert got.shape == (nfft // 2 + 1,)
        assert _max_rel(got, ref) < _budget(nfft)
        assert _max_rel(got, want_jax) < _budget(nfft)

    def test_batched_frames_and_coeff_tuple(self):
        spec = WindowSpec(8, 17, overflow="saturate")
        x = _signal((3, 256 * 6), 4)
        q = catalog.get("bh4").quantized(17)
        by_name = sp.windowed_power_spectrum(torch.from_numpy(x), "bh4", spec, hop=64,
                                             fft_mode="mxu")
        by_coeffs = sp.windowed_power_spectrum(torch.from_numpy(x), q, spec, hop=64,
                                               fft_mode="packed")
        wq = np.asarray(jkw.window_samples(np.arange(256), q,
                                           jconfig.WindowSpec(**vars(spec))), np.float64)
        ref = _f64_welch(x, wq * sp.window_scale(spec, 1), 256, 64)
        assert by_name.shape == (3, 129)
        assert _max_rel(by_name.numpy(), ref) < _budget(256)
        assert _max_rel(by_coeffs.numpy(), ref) < _budget(256)

    def test_mxu_cfft(self):
        rng = np.random.default_rng(9)
        for m in (256, 1024):
            z = (rng.normal(size=(2, m)) + 1j * rng.normal(size=(2, m))).astype(np.complex64)
            xr, xi = sp.mxu_cfft(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()))
            got = xr.numpy().astype(np.float64) + 1j * xi.numpy()
            ref = np.fft.fft(z.astype(np.complex128), axis=-1)
            assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-6

    def test_tf32_is_turned_off(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        sp.welch_power(torch.zeros(1024), torch.ones(256), 256, 128, "mxu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    def test_modes_not_ported_or_unknown(self):
        # every win_mode of the JAX package is ported now; unknown modes raise
        spec = WindowSpec(8, 17)
        x = torch.zeros(1024)
        for mode in ("float", "comp"):
            ps = sp.windowed_power_spectrum(x, "bh4", spec, win_mode=mode)
            assert ps.shape == (129,) and not bool(ps.any())
        with pytest.raises(ValueError):
            sp.windowed_power_spectrum(x, "bh4", spec, win_mode="nope")
        with pytest.raises(ValueError):
            sp.frame_mean_power(torch.zeros(2, 256), "nope")
