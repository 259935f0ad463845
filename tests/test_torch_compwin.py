"""PyTorch port, compensated-f32 mode: tables and packing bitwise equal to the
JAX package's, s bit-equal to JAX's s, e within the derived bound of JAX's
e, the pair under 5e-9 of the float64 golden, ``normalize_pair`` exact,
the comp checksum's plain version against the Pallas kernel in interpret
mode (with and without plain harmonics), the -180 dB pair floor, and the
analyzer's ``win_mode="comp"`` against JAX per bin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import compwin as jc
from blackman_harris_win_tpu.kernels.pallas import outerwin_kernel as jk
from blackman_harris_win_tpu.pipeline import spectral as jsp
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import compwin as pc
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as pk
from blackman_harris_win_tpu_torch.pipeline import spectral as sp
from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
from blackman_harris_win_tpu_torch.windows.catalog import float_window_value, names

_U = 2.0**-24
_RANDOM = tuple(float(v) for v in (lambda a: a / a.sum())(
    np.random.default_rng(4).uniform(0.01, 1.0, 5)))


def _pair64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


class TestTables:
    @pytest.mark.parametrize("coeffs,pw,m,thresh", [
        ("bh7", 14, 11, pc.DEFAULT_THRESH),
        ("bh4", 12, 7, pc.DEFAULT_THRESH),
        ("hamming", 11, 6, pc.DEFAULT_THRESH),  # no plain harmonics (P = 0)
        ("bh4", 12, 7, 1.1),  # no compensated harmonics (C = 0)
        (_RANDOM, 12, 5, pc.DEFAULT_THRESH),
    ])
    def test_tables_and_packing_bitwise_equal(self, coeffs, pw, m, thresh):
        c = pc._resolve_coeffs(coeffs)
        got = pc._tables_comp(c, pw, m, pc.GRID_BITS, thresh)
        want = jc._tables_comp(c, pw, m, jc.GRID_BITS, thresh)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pc.pack_tables(*got[:4]), jc.pack_tables(*want[:4])):
            np.testing.assert_array_equal(a, b)

    def test_constants(self):
        assert pc.DEFAULT_THRESH == jc.DEFAULT_THRESH and pc.GRID_BITS == jc.GRID_BITS
        assert pc.comp_window_flops(10, "bh7") == jc.comp_window_flops(10, "bh7") == 620
        assert pc.comp_window_flops(4, (0.5, 0.5)) == 72


class TestPair:
    @pytest.mark.parametrize("name", names())
    def test_s_bit_equal_e_bounded_pair_accurate(self, name):
        pw = 12
        s, e = pc.comp_window_pair(name, pw, device="cpu")
        js, je = jc.comp_window_pair(name, pw)
        assert s.dtype == e.dtype == torch.float32 and s.shape == (1 << pw,)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))  # exact grid products
        assert np.abs(e.numpy() - np.asarray(je)).max() <= pk.comp_e_bound(name)
        gold = float_window_value(name, np.arange(1 << pw), 1 << pw)
        assert np.abs(_pair64(s, e) - gold).max() < 5e-9

    @pytest.mark.parametrize("name", ["bh7", "bh4"])
    def test_seam_blocks(self, name):
        pw, m, rows = 14, 6, 4
        n = 1 << pw
        for n0 in (n // 4 - 128, n // 2 - 128, 3 * n // 4 - 128, n - rows * 64):
            s, e = pc.comp_window_block(n0, rows, name, pw, m=m, device="cpu")
            js, je = jc.comp_window_block(n0, rows, name, pw, m=m)
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            assert np.abs(e.numpy() - np.asarray(je)).max() <= pk.comp_e_bound(name)
            gold = float_window_value(name, n0 + np.arange(rows << m), n)
            assert np.abs(_pair64(s, e) - gold).max() < 5e-9

    def test_all_plain_threshold(self):
        pw = 12
        s, e = pc.comp_window_pair("bh4", pw, thresh=1.1, device="cpu")
        js, je = jc.comp_window_pair("bh4", pw, thresh=1.1)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert np.abs(e.numpy() - np.asarray(je)).max() <= pk.comp_e_bound("bh4", thresh=1.1)

    def test_normalize_pair_exact_and_equal_to_jax(self):
        s, e = pc.comp_window_pair("bh7", 14, device="cpu")
        hi, lo = pc.normalize_pair(s, e)
        jhi, jlo = jc.normalize_pair(s.numpy(), e.numpy())
        np.testing.assert_array_equal(hi, jhi)
        np.testing.assert_array_equal(lo, jlo)
        # exact: hi + lo == s + e (every f32 sum is exact in float64)
        np.testing.assert_array_equal(_pair64(hi, lo), _pair64(s, e))
        # non-overlapping: hi == f32(hi + lo)
        np.testing.assert_array_equal(_pair64(hi, lo).astype(np.float32), hi)

    def test_comp_window_folded_and_pair(self):
        pw = 14
        hi, lo = pc.comp_window("bh7", pw, pair=True, device="cpu")
        jhi, jlo = jc.comp_window("bh7", pw, pair=True)
        gold = float_window_value("bh7", np.arange(1 << pw), 1 << pw)
        assert np.abs(_pair64(hi, lo) - gold).max() < 5e-9
        assert np.abs(_pair64(hi, lo) - _pair64(jhi, jlo)).max() < 5e-9
        folded = pc.comp_window("bh7", pw, device="cpu")
        assert torch.equal(folded, hi)

    @pytest.mark.parametrize("pw,m", [(1, None), (4, 0)])
    def test_host_f64_branch(self, pw, m):
        s, e = pc.comp_window_pair("bh7", pw, m=m, device="cpu")
        js, je = jc.comp_window_pair("bh7", pw, m=m)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))

    def test_guards(self):
        with pytest.raises(ValueError, match="1.9"):
            pc.comp_window((0.9, 0.9, 0.9), 12, device="cpu")
        with pytest.raises(ValueError, match="split"):
            pc.comp_window_block(0, 1, "hann", 10, m=10, device="cpu")


class TestSpectralFloors:
    def test_bh7_pair_holds_180_at_pw16(self):
        s, e = pc.comp_window_pair("bh7", 16, device="cpu")
        assert window_sidelobe_db(_pair64(s, e), n_terms=7) <= -180.0

    @pytest.mark.parametrize("name,bound", [("hamming", -43.0), ("bh4", -92.0), ("bh5", -124.0)])
    def test_published_floors_held_folded(self, name, bound):
        assert window_sidelobe_db(pc.comp_window(name, 16, device="cpu").numpy()) <= bound


class TestCompChecksum:
    @pytest.mark.parametrize("name,pw,m", [("bh7", 12, 7), ("hamming", 11, 6)])
    def test_plain_matches_pallas_interpret(self, name, pw, m):
        rows = 8
        fn = pk.make_checksum_fn_comp(name, pw, m=m, rows=rows, device="cpu")
        jfn = jk.make_checksum_fn_comp(name, pw, m=m, rows=rows, interpret=True)
        n = 1 << pw
        s, e = pc.comp_window_pair(name, pw, m=m, device="cpu")
        sum_abs = float(np.abs(s.numpy()).sum() + np.abs(e.numpy()).sum())
        # two f32 sums of the same 2n terms (plus the bias) in two orders,
        # each within 2n * 2^-24 * (sum|terms| + |bias|) of the exact sum; the
        # s terms are equal, the e terms differ by at most comp_e_bound
        for bias in (0, 5):
            got = fn(bias)
            assert got.dtype == torch.float32 and got.shape == ()
            want = float(jfn(jnp.int32(bias)))
            bound = 2 * 2 * n * _U * (sum_abs + bias) + n * pk.comp_e_bound(name)
            assert abs(float(got) - want) <= bound, (float(got), want, bound)

    @pytest.mark.parametrize("name,pw,m,rows", [("bh7", 12, 7, 8), ("hamming", 11, 6, 4)])
    def test_plain_within_its_derived_bound(self, name, pw, m, rows):
        # the plain sum (pairwise trees over s and e per tile, s + e, running
        # sum over tiles) of the plain pair's terms, against their float64 sum
        s, e = (v.double() for v in pk.outer_block_comp_plain(
            name, pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, 0, 1 << (pw - m), device="cpu"))
        depth = pk.checksum_plain_depth(1 << (pw - m), 1 << m, rows, comp=True)
        exact, sum_abs = float(s.sum() + e.sum()), float(s.abs().sum() + e.abs().sum())
        for bias in (0, 123457):
            got = float(pk.checksum_plain_comp(name, pw, m, rows, bias, device="cpu"))
            bound = pk.sum_bound(depth, sum_abs + bias)
            assert abs(got - (exact + bias)) <= bound, (got, bound)

    def test_all_below_threshold_raises(self):
        with pytest.raises(ValueError, match="compensation threshold") as ours:
            pk.make_checksum_fn_comp((0.9, 1e-7, 1e-7), 12, m=7, rows=8, device="cpu")
        with pytest.raises(ValueError, match="compensation threshold") as theirs:
            jk.make_checksum_fn_comp((0.9, 1e-7, 1e-7), 12, m=7, rows=8, interpret=True)
        assert str(ours.value) == str(theirs.value)

    def test_rows_must_divide(self):
        with pytest.raises(ValueError, match="divisible"):
            pk.make_checksum_fn_comp("bh7", 12, m=7, rows=24, device="cpu")


def _ffma(a, b, c):
    """An FFMA emulated: the product of two f32 values is exact in float64,
    the sum with c rounds once there and once more to f32.  That double
    rounding can miss the correctly rounded f32 by at most 2^-53 |a b + c|
    on top of the f32 rounding's 2^-24 |a b + c|."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def emulate_comp_row(t, h: int):
    """The comp kernels' (s, e) of h row ``h`` at every lo lane, in their
    evaluation order: FFMA chains, s = fma(-sh_hi, sl_hi, fma(ch_hi, cl_hi,
    s)) and e through the four corrections of each compensated harmonic
    (ch_hi cl_lo, ch_lo cl_f, -sh_hi sl_lo, -sh_lo sl_f), then two FFMAs per
    plain harmonic.  ``t``: the tables as the kernel takes them
    (``outerwin_kernel._comp_tiles``)."""
    hi, lo = t.hi[h].numpy(), t.lo.numpy()
    nl = lo.shape[1]
    s = np.full(nl, np.float32(t.a0), np.float32)
    e = np.full(nl, np.float32(t.a0lo), np.float32)
    for k in range(t.nk):
        chh, chl, shh, shl = hi[4 * k:4 * k + 4]
        cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f = lo[6 * k:6 * k + 6]
        s = _ffma(chh, cl_hi, s)
        s = _ffma(-shh, sl_hi, s)
        e = _ffma(chh, cl_lo, e)
        e = _ffma(chl, cl_f, e)
        e = _ffma(-shh, sl_lo, e)
        e = _ffma(-shl, sl_f, e)
    for k in range(t.npl):
        ch, sh = hi[4 * t.nk + 2 * k:4 * t.nk + 2 * k + 2]
        e = _ffma(ch, lo[6 * t.nk + 2 * k], e)
        e = _ffma(-sh, lo[6 * t.nk + 2 * k + 1], e)
    return s, e


def _seam_rows(nh: int) -> list[int]:
    return sorted({0, nh // 4 - 1, nh // 4, nh // 4 + 1, nh // 2, 3 * nh // 4, nh - 1})


class TestKernelOrderEmulation:
    """The comp kernels' FFMA chains, emulated in numpy: s bit-equal to the
    plain version (``comp_tile``) and to the JAX package's comp tiles, e
    within ``comp_e_bound`` of both (the chains round 4C + 2P times, the
    plain version 8C + 4P; with the emulation's double-rounding slack of
    2^-53 per rounding the sum stays under the bound's 2 (8C + 4P) E u), at
    the seam rows.  Against JAX at the small pw its own tests use; at pw=24
    against the port's plain version."""

    NAMES = ["bh7", "bh4", "bh5", "hamming", "flattop2"]

    @pytest.mark.parametrize("name", NAMES)
    def test_matches_plain_and_jax(self, name):
        pw, m = 14, 7
        t = pk._comp_tiles(pc._resolve_coeffs(name), pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH,
                           torch.device("cpu"))
        bound = pk.comp_e_bound(name)
        for h in _seam_rows(1 << (pw - m)):
            s, e = emulate_comp_row(t, h)
            ps, pe = pk.outer_block_comp_plain(name, pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, h, 1,
                                               device="cpu")
            js, je = (np.asarray(v) for v in jc.comp_window_block(h << m, 1, name, pw, m=m))
            np.testing.assert_array_equal(s, ps.numpy())
            np.testing.assert_array_equal(s, js)
            assert np.abs(e - pe.numpy()).max() <= bound
            assert np.abs(e - je).max() <= bound

    @pytest.mark.parametrize("name", NAMES)
    def test_pw24_matches_plain(self, name):
        pw, m = 24, 11
        t = pk._comp_tiles(pc._resolve_coeffs(name), pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH,
                           torch.device("cpu"))
        gold_n = np.concatenate([(h << m) + np.arange(1 << m) for h in _seam_rows(1 << (pw - m))])
        got_s, got_e = [], []
        for h in _seam_rows(1 << (pw - m)):
            s, e = emulate_comp_row(t, h)
            ps, pe = pk.outer_block_comp_plain(name, pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, h, 1,
                                               device="cpu")
            np.testing.assert_array_equal(s, ps.numpy())
            assert np.abs(e - pe.numpy()).max() <= pk.comp_e_bound(name)
            got_s.append(s)
            got_e.append(e)
        gold = float_window_value(name, gold_n, 1 << pw)
        assert np.abs(_pair64(np.concatenate(got_s), np.concatenate(got_e)) - gold).max() < 5e-9


class TestAnalyzerCompMode:
    @pytest.mark.parametrize("fft_mode", ["rfft", "packed", "mxu"])
    def test_matches_jax_per_bin(self, fft_mode):
        spec = WindowSpec(8, 17)
        nfft = spec.n
        x = np.random.default_rng(7).normal(size=(2, 1024)).astype(np.float32)
        got = sp.windowed_power_spectrum(torch.from_numpy(x), "bh7", spec,
                                         win_mode="comp", fft_mode=fft_mode).numpy()
        want = np.asarray(jsp.windowed_power_spectrum(
            jnp.asarray(x), "bh7", jconfig.WindowSpec(**vars(spec)), win_mode="comp",
            fft_mode=fft_mode))
        fr = np.stack([x[:, i * 128:i * 128 + nfft] for i in range(7)], axis=-2)
        ref = (np.abs(np.fft.rfft(fr.astype(np.float64)
                                  * float_window_value("bh7", np.arange(nfft), nfft),
                                  axis=-1)) ** 2).mean(-2)
        budget = 32 * _U * np.sqrt(nfft)  # the derived per-bin f32 budget
        assert got.shape == (2, nfft // 2 + 1)
        assert float(np.max(np.abs(got - want) / np.abs(want))) < budget
        assert float(np.max(np.abs(got - ref) / np.abs(ref))) < budget

    def test_rejects_quantized_tuple(self):
        with pytest.raises(ValueError, match="quantized integer"):
            sp.windowed_power_spectrum(torch.zeros(1, 1024), (40000, 30000), WindowSpec(8, 17),
                                       win_mode="comp")
