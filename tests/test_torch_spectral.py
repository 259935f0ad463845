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


def _radix2(re, im, wr, wi):
    """The kernel's in-register radix-2 DFT (``dft<N>``) on the rows of
    (N, cols) float32 arrays: bit reversal, then log2 N butterfly stages with
    the roots W_len^k = W128^(k*128/len); W^0 is not multiplied."""
    n = re.shape[0]
    bits = n.bit_length() - 1
    rev = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)]
    re, im = re[rev].copy(), im[rev].copy()
    length = 2
    while length <= n:
        for s0 in range(0, n, length):
            for k in range(length // 2):
                a, b = s0 + k, s0 + k + length // 2
                vr, vi = re[b], im[b]
                if k:
                    c, sn = wr[k * 128 // length], wi[k * 128 // length]
                    vr, vi = re[b] * c - im[b] * sn, re[b] * sn + im[b] * c
                re[b], im[b], re[a], im[a] = re[a] - vr, im[a] - vi, re[a] + vr, im[a] + vi
        length *= 2
    return re, im


def _fft128_emulated(zr, zi):
    """The kernel's FFT-128 in float32: n0 = n1 + 16 n2, an 8-point DFT over
    n2 for each n1, the twiddle W128^(n1 k2), a 16-point DFT over n1 for
    each k2; output row k0 = k2 + 8 k1."""
    wr, wi = wk._fft128_roots()
    ar = np.empty((16, 8) + zr.shape[1:], np.float32)
    ai = np.empty_like(ar)
    for n1 in range(16):
        r, i = _radix2(zr[n1::16], zi[n1::16], wr, wi)
        for k2 in range(8):
            m = n1 * k2
            sg = np.float32(-1.0 if m >= 64 else 1.0)
            c, sn = sg * wr[m & 63], sg * wi[m & 63]
            ar[n1, k2], ai[n1, k2] = r[k2] * c - i[k2] * sn, r[k2] * sn + i[k2] * c
    yr, yi = np.empty_like(zr), np.empty_like(zi)
    for k2 in range(8):
        yr[k2::8], yi[k2::8] = _radix2(ar[:, k2], ai[:, k2], wr, wi)
    return yr, yi


def _fft128_bound(nstages=8):
    """Normwise f32 bound of a radix-2 FFT (Higham, Thm 24.2): per stage eta
    < 7u with roots accurate to u; log2(128) = 7 butterfly stages plus the
    inter-pass twiddle, counted as an eighth."""
    u = 2.0**-24
    return nstages * 7 * u / (1 - nstages * 7 * u)


def _stage1_emulated(x, win, nfft):
    """The kernel's stage 1 on numpy float32, with its own indexing: x as
    half-blocks of hop samples (64 rows of rest; past the end, zeros), pair b
    reading half-blocks 2b, 2b+1, 2b+2, the odd pad frame masked, the
    FFT-128 above, then the stage-1 twiddle."""
    hop, rest = nfft // 2, nfft // 128
    nf = (x.size - nfft) // hop + 1
    npair = (nf + 1) // 2
    nhalf = x.size // hop
    half = lambda h: (x[h * hop:(h + 1) * hop].reshape(64, rest) if h < nhalf
                      else np.zeros((64, rest), np.float32))  # noqa: E731
    w = win.reshape(128, rest)
    t1r, t1i = wk._tables(nfft, 128)[1]
    out_r = np.empty((npair, 128, rest), np.float32)
    out_i = np.empty_like(out_r)
    for b in range(npair):
        s0, s1, s2 = half(2 * b), half(2 * b + 1), half(2 * b + 2)
        zr = np.concatenate([s0, s1]) * w
        zi = np.concatenate([s1, s2]) * w
        if nf % 2 and b == npair - 1:
            zi[:] = 0
        yr, yi = _fft128_emulated(zr, zi)
        out_r[b], out_i[b] = yr * t1r - yi * t1i, yr * t1i + yi * t1r
    return out_r, out_i, nf


class TestFFT128:
    """The stage-1 kernel's FFT-128: its host root table and its digit order,
    emulated in float32, against np.fft.fft and the direct DFT matrix."""

    def test_roots_are_the_dft_matrix_row(self):
        wr, wi = wk._fft128_roots()
        (m0r, m0i), _ = wk._tables(1 << 13, 128)
        np.testing.assert_array_equal(wr, m0r[1, :64])
        np.testing.assert_array_equal(wi, m0i[1, :64])
        exact = np.exp(-2j * np.pi * np.arange(64) / 128)
        assert np.abs(wr - exact.real).max() <= 2.0**-25
        assert np.abs(wi - exact.imag).max() <= 2.0**-25

    @pytest.mark.parametrize("k", [0, 1, 5, 8, 17, 63, 64, 100, 127])
    def test_digit_order_is_natural(self, k):
        # a tone at bin k lands at output row k
        n = np.arange(128)
        z = np.exp(2j * np.pi * k * n / 128)[:, None] * np.ones((1, 4))
        yr, yi = _fft128_emulated(z.real.astype(np.float32), z.imag.astype(np.float32))
        mag = np.hypot(yr[:, 0], yi[:, 0])
        assert int(np.argmax(mag)) == k and abs(mag[k] - 128) < 1e-3

    @pytest.mark.parametrize("seed", [0, 1])
    def test_vs_numpy_and_the_direct_matrix(self, seed):
        rng = np.random.default_rng(seed)
        zr = rng.normal(size=(128, 64)).astype(np.float32)
        zi = rng.normal(size=(128, 64)).astype(np.float32)
        yr, yi = _fft128_emulated(zr, zi)
        got = yr.astype(np.float64) + 1j * yi
        z = zr.astype(np.float64) + 1j * zi
        exact = np.fft.fft(z, axis=0)
        norm_y = np.linalg.norm(exact, axis=0)
        err = np.linalg.norm(got - exact, axis=0)
        assert (err <= _fft128_bound() * norm_y).all(), (err / norm_y).max()
        (m0r, m0i), _ = wk._tables(1 << 13, 128)
        direct = (m0r.astype(np.float64) + 1j * m0i) @ z
        # the matrix's f32 entries are within 2^-25 of exact in each part
        slack = np.sqrt(2 * 128 * 128) * 2.0**-25 * np.linalg.norm(z, axis=0)
        err_m = np.linalg.norm(got - direct, axis=0)
        assert (err_m <= _fft128_bound() * norm_y + slack).all()

    @pytest.mark.parametrize("nfft,nframes", [(1 << 13, 4), (1 << 13, 5), (1 << 14, 3)])
    def test_stage1_layout_matches_plain(self, nfft, nframes):
        hop = nfft // 2
        x = _signal(hop * nframes + hop, nfft + nframes)
        win = np.hanning(nfft).astype(np.float32)
        er, ei, nf = _stage1_emulated(x, win, nfft)
        pr, pi_, pnf = wk.welch_stage1_plain(torch.from_numpy(x), torch.from_numpy(win), nfft)
        assert nf == pnf == nframes
        scale = max(np.abs(pr.numpy()).max(), np.abs(pi_.numpy()).max())
        err = max(np.abs(er - pr.numpy()).max(), np.abs(ei - pi_.numpy()).max())
        assert err / scale < 1e-5, err / scale


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

    @pytest.mark.parametrize("call", ["welch_power", "frame_mean_power", "mxu_cfft",
                                      "fused_mean_power", "decimating_fir"])
    def test_tf32_is_turned_off(self, monkeypatch, call):
        # TF32 is off inside each call (the JAX package pins
        # Precision.HIGHEST per operation), both flags are as the caller set
        # them after it, and the results stay within their f32 budgets
        seen = []

        def spy(fn):
            def wrapped(*a, **k):
                seen.append((torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32))
                return fn(*a, **k)
            return wrapped

        for mod, name in ((torch, "tensordot"), (torch, "matmul"), (torch.fft, "rfft"),
                          (torch.fft, "fft"), (torch.nn.functional, "conv1d")):
            monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        nfft, hop = 1 << 13, 1 << 12
        x = _signal(hop * 5, 31)
        win = np.hanning(nfft).astype(np.float32)
        ref = _f64_welch(x, win, nfft, hop)
        if call == "welch_power":
            got = sp.welch_power(torch.from_numpy(x), torch.from_numpy(win), nfft, hop, "mxu")
            err, tol = _max_rel(got.numpy(), ref), _budget(nfft)
        elif call == "frame_mean_power":
            fr = sp.frames_view(torch.from_numpy(x), nfft, hop) * torch.from_numpy(win)
            err, tol = _max_rel(sp.frame_mean_power(fr, "rfft").numpy(), ref), _budget(nfft)
        elif call == "mxu_cfft":
            z = x[:nfft] + 1j * x[nfft:2 * nfft]
            gr, gi = sp.mxu_cfft(torch.from_numpy(x[:nfft]), torch.from_numpy(x[nfft:2 * nfft]))
            want = np.fft.fft(z.astype(np.complex128))
            err = np.abs(gr.numpy() + 1j * gi.numpy() - want).max() / np.abs(want).max()
            tol = 2e-6
        elif call == "fused_mean_power":
            got = sp._mxu_fused_mean_power(torch.from_numpy(x), torch.from_numpy(win), nfft)
            err, tol = _max_rel(got.numpy(), ref, per_bin=False), 1e-5
        else:
            from blackman_harris_win_tpu_torch.pipeline import fir

            h = np.hanning(7) / np.hanning(7).sum()  # 7 taps, decim 2: the conv1d branch
            got = fir.decimating_fir(torch.from_numpy(x), h, 2).numpy()
            want = np.convolve(x.astype(np.float64), h[::-1], "valid")[::2]
            u = 2.0**-24
            err, tol = np.abs(got - want).max(), 9 * u / (1 - 9 * u) * np.abs(x).max()
        assert seen and all(f == (False, False) for f in seen), seen
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert err < tol, (err, tol)

    def test_numpy_input_matches_jax(self):
        # array-like x goes to ``device`` (here the CPU), as the JAX package
        # takes array-likes
        spec = WindowSpec(10, 17, overflow="saturate")
        nfft, hop = spec.n, spec.n // 2
        x = _signal(hop * 7, 41)
        win = np.hanning(nfft)
        got = sp.welch_power(x, win, nfft, hop, "mxu", device="cpu")
        assert got.dtype == torch.float32 and got.shape == (nfft // 2 + 1,)
        want = np.asarray(jsp.welch_power(x, win, nfft, hop, "mxu"))
        assert _max_rel(got.numpy(), want) < _budget(nfft)
        got = sp.windowed_power_spectrum(x, "bh4", spec, fft_mode="packed", device="cpu")
        want = np.asarray(jsp.windowed_power_spectrum(x, "bh4", jconfig.WindowSpec(**vars(spec)),
                                                      fft_mode="packed"))
        assert got.shape == want.shape == (nfft // 2 + 1,)
        assert _max_rel(got.numpy(), want) < _budget(nfft)

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


class TestNonCordicWindows:
    """The quantized analyzer with the TAYLOR source (HLS and RTL) and
    taylor2: the window comes from ``kernels.window.window_block``, the same
    values as JAX's ``window_samples``."""

    CASES = [("taylor", "hls", "hann"), ("taylor", "hls", "blackman"),
             ("taylor", "rtl", "hann"), ("taylor", "rtl", "blackman"),
             ("taylor2", "hls", "hann"), ("taylor2", "hls", "blackman"),
             ("taylor2", "hls", "bh4"), ("taylor2", "hls", "bh7")]

    @pytest.mark.parametrize("sin_type,rounding,name", CASES)
    @pytest.mark.parametrize("fft_mode", ["rfft", "mxu"])
    def test_matches_jax_and_f64(self, sin_type, rounding, name, fft_mode):
        spec = WindowSpec(12, 16, sin_type=sin_type, rounding=rounding)
        nfft, hop = spec.n, spec.n // 2
        x = _signal(hop * 7, 53)
        got = sp.windowed_power_spectrum(torch.from_numpy(x), name, spec,
                                         fft_mode=fft_mode).numpy()
        jspec = jconfig.WindowSpec(**vars(spec))
        want_jax = np.asarray(jsp.windowed_power_spectrum(jnp.asarray(x), name, jspec,
                                                          fft_mode=fft_mode))
        d = catalog.get(name)
        wq = np.asarray(jkw.window_samples(np.arange(nfft), d.quantized(16), jspec), np.float64)
        ref = _f64_welch(x, wq * sp.window_scale(spec, d.shift), nfft, hop)
        assert got.shape == (nfft // 2 + 1,)
        assert _max_rel(got, ref) < _budget(nfft)
        assert _max_rel(got, want_jax) < _budget(nfft)

    @pytest.mark.parametrize("sin_type,rounding,name", [("taylor", "hls", "bh4"),
                                                        ("taylor2", "rtl", "hann")])
    def test_what_jax_refuses_the_port_refuses(self, sin_type, rounding, name):
        spec = WindowSpec(12, 16, sin_type=sin_type, rounding=rounding)
        x = _signal(4096 * 2, 54)
        with pytest.raises((ValueError, NotImplementedError)):
            jsp.windowed_power_spectrum(jnp.asarray(x), name, jconfig.WindowSpec(**vars(spec)))
        with pytest.raises((ValueError, NotImplementedError)):
            sp.windowed_power_spectrum(torch.from_numpy(x), name, spec)


class TestRfftPowerSplit:
    """The twin of ``tests/test_spectral.py``'s ``rfft_power_split`` cases,
    against float64 and the JAX function."""

    @pytest.mark.parametrize("n", [128, 4096])
    def test_matches_rfft_power(self, n):
        x = np.random.default_rng(11).normal(size=(3, n)).astype(np.float32)
        got = sp.rfft_power_split(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (3, n // 2 + 1)
        ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
        assert _max_rel(got.numpy(), ref, per_bin=False) < 2e-6
        want = np.asarray(jsp.rfft_power_split(jnp.asarray(x)))
        assert _max_rel(got.numpy(), want, per_bin=False) < 2e-6

    def test_mxu(self):
        x = np.random.default_rng(10).normal(size=(2, 2048)).astype(np.float32)
        got = sp.rfft_power_split(x, "mxu", device="cpu").numpy()
        ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1)) ** 2
        assert _max_rel(got, ref, per_bin=False) < 2e-6
        want = np.asarray(jsp.rfft_power_split(jnp.asarray(x), "mxu"))
        assert _max_rel(got, want, per_bin=False) < 2e-6

    def test_odd_length_rejected(self):
        with pytest.raises(ValueError, match="even"):
            sp.rfft_power_split(np.zeros(127, np.float32), device="cpu")

    def test_tf32_is_turned_off(self, monkeypatch):
        seen = []
        mm = torch.tensordot

        def spy(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return mm(*a, **k)

        monkeypatch.setattr(torch, "tensordot", spy)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        sp.rfft_power_split(torch.ones(1024), "mxu")
        assert seen and all(f == (False, False) for f in seen)
        assert torch.backends.cuda.matmul.allow_tf32
