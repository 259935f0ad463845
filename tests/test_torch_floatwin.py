"""PyTorch port, float32 outer-product mode: tables bitwise equal to the JAX
package's, ``float_window``/``float_window_block`` within the derived f32
bound of JAX and under 1.5e-6 of the float64 golden, the spectral floors,
the f32 checksum's plain version against the Pallas kernel in interpret
mode, and the analyzer's ``win_mode="float"`` against JAX per bin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import floatwin as jf
from blackman_harris_win_tpu.kernels.pallas import outerwin_kernel as jk
from blackman_harris_win_tpu.pipeline import spectral as jsp
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import floatwin as pf
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as pk
from blackman_harris_win_tpu_torch.pipeline import spectral as sp
from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
from blackman_harris_win_tpu_torch.windows.catalog import float_window_value, get, names

_U = 2.0**-24


def _f64_welch(x, win, nfft, hop):
    x = np.asarray(x, np.float64)
    nf = (x.shape[-1] - nfft) // hop + 1
    fr = np.stack([x[..., m * hop:m * hop + nfft] for m in range(nf)], axis=-2)
    return (np.abs(np.fft.rfft(fr * np.asarray(win, np.float64), axis=-1)) ** 2).mean(-2)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


class TestTables:
    @pytest.mark.parametrize("name,pw,m", [("bh7", 16, 11), ("bh4", 12, 7), ("hann", 10, 3),
                                           ("flattop2", 14, 9)])
    def test_tables_bitwise_equal(self, name, pw, m):
        c = pf._resolve_coeffs(name)
        assert c == jf._resolve_coeffs(name)
        hi, lo = pf._tables_f32(c, pw, m)
        jhi, jlo = jf._tables_f32(c, pw, m)
        assert hi.dtype == np.float32
        np.testing.assert_array_equal(hi, jhi)
        np.testing.assert_array_equal(lo, jlo)

    def test_bf16_tables_equal_jax_widened(self):
        c = pf._resolve_coeffs("bh4")
        t = pk._f32_tiles(c, 12, 7, torch.device("cpu"), torch.bfloat16)
        hi, lo = jf._tables_f32(c, 12, 7)
        widen = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(t.hi[:, :3].numpy(), widen(hi[:, :, 0].T))
        np.testing.assert_array_equal(t.lo[3:].numpy(), widen(lo[:, :, 1]))


class TestSampleAccuracy:
    @pytest.mark.parametrize("name", names())
    def test_matches_jax_and_f64_golden(self, name):
        pw = 12
        got = pf.float_window(name, pw, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (1 << pw,)
        want = np.asarray(jf.float_window(name, pw))
        # two f32 evaluations differ by at most the op-count bound
        assert np.abs(got.numpy() - want).max() <= pk.f32_pair_bound(name)
        gold = float_window_value(name, np.arange(1 << pw), 1 << pw)
        assert np.abs(got.numpy().astype(np.float64) - gold).max() < 1.5e-6

    def test_explicit_coefficients(self):
        w = pf.float_window((0.5, 0.5), 10, device="cpu").numpy().astype(np.float64)
        n = np.arange(1024)
        assert np.max(np.abs(w - (0.5 - 0.5 * np.cos(2 * np.pi * n / 1024)))) < 1e-6

    @pytest.mark.parametrize("pw,m", [(1, None), (4, 0), (6, -1)])
    def test_host_f64_branch(self, pw, m):
        got = pf.float_window("hann", pw, m=m, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.asarray(jf.float_window("hann", pw, m=m)))

    def test_flops_model(self):
        assert pf.float_window_flops(10, 7) == jf.float_window_flops(10, 7) == 240


class TestBlocks:
    def test_blocks_tile_the_window(self):
        pw, m, rows = 14, 8, 4
        full = pf.float_window("bh5", pw, m=m, device="cpu")
        step = rows << m
        blocks = [pf.float_window_block(n0, rows, "bh5", pw, m=m, device="cpu") for n0 in range(0, 1 << pw, step)]
        assert torch.equal(torch.cat(blocks), full)

    @pytest.mark.parametrize("name", ["bh4", "bh7"])
    def test_seam_blocks_match_jax(self, name):
        pw, m, rows = 14, 6, 4
        n = 1 << pw
        for n0 in (n // 4 - 128, n // 2 - 128, 3 * n // 4 - 128, n - rows * 64):
            got = pf.float_window_block(n0, rows, name, pw, m=m, device="cpu").numpy()
            want = np.asarray(jf.float_window_block(n0, rows, name, pw, m=m))
            assert np.abs(got - want).max() <= pk.f32_pair_bound(name)

    def test_split_bounds(self):
        with pytest.raises(ValueError, match="split"):
            pf.float_window_block(0, 1, "hann", 10, m=10, device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            pf.float_window_block(5, 1, "hann", 10, m=4, device="cpu")


class TestSpectralFloors:
    @pytest.mark.parametrize("name,bound", [
        ("hamming", -43.0),
        ("hann", -31.5),
        ("blackman", -58.0),
        ("bh3", -71.0),
        ("bh4", -92.0),
        ("nuttall", -93.0),
        ("blackman_nuttall", -98.0),
        ("bh5", -124.0),
    ])
    def test_published_floor_held(self, name, bound):
        assert window_sidelobe_db(pf.float_window(name, 16, device="cpu").numpy()) <= bound

    def test_bh7_floor_pinned(self):
        fl = window_sidelobe_db(pf.float_window("bh7", 16, device="cpu").numpy())
        assert -180.0 < fl <= -160.0


class TestF32Checksum:
    @pytest.mark.parametrize("name,table_dtype", [("bh4", None), ("bh7", None),
                                                  ("bh4", "bf16")])
    def test_plain_matches_pallas_interpret(self, name, table_dtype):
        pw, m, rows = 12, 7, 8
        tdt = torch.bfloat16 if table_dtype else None
        jdt = jnp.bfloat16 if table_dtype else None
        fn = pk.make_checksum_fn_f32(name, pw, m=m, rows=rows, table_dtype=tdt, device="cpu")
        jfn = jk.make_checksum_fn_f32(name, pw, m=m, rows=rows, interpret=True,
                                      table_dtype=jdt)
        n = 1 << pw
        w = pk.outer_block_f32_plain(name, pw, m, 0, n >> m, table_dtype=tdt, device="cpu").numpy()
        sum_abs = float(np.abs(w.astype(np.float64)).sum())
        # both are f32 sums of the same n terms (plus the bias) in two orders:
        # each is within n * 2^-24 * (sum|w| + |bias|) of the exact sum, and
        # each term differs between the two by at most f32_pair_bound
        for bias in (0, 5):
            got = fn(bias)
            assert got.dtype == torch.float32 and got.shape == ()
            want = float(jfn(jnp.int32(bias)))
            bound = 2 * n * _U * (sum_abs + bias) + n * pk.f32_pair_bound(name)
            assert abs(float(got) - want) <= bound, (float(got), want, bound)
        # the bias only enters the running sum: its order changes by one term
        # per tile, each rounding at most 2^-24 * (sum|w| + bias)
        ntiles = (n >> m) // rows
        assert abs(float(fn(5)) - (float(fn(0)) + 5)) <= 2 * ntiles * _U * (sum_abs + 5)

    @pytest.mark.parametrize("name,pw,m,rows", [("bh7", 12, 7, 8), ("bh4", 13, 5, 32)])
    def test_plain_within_its_derived_bound(self, name, pw, m, rows):
        # the plain sum (pairwise tree per tile, running sum over tiles) of
        # the plain write-out's terms, against their float64 sum
        w = pk.outer_block_f32_plain(name, pw, m, 0, 1 << (pw - m), device="cpu").double()
        depth = pk.checksum_plain_depth(1 << (pw - m), 1 << m, rows)
        for bias in (0, 123457):
            got = float(pk.checksum_plain_f32(name, pw, m, rows, bias, device="cpu"))
            bound = pk.sum_bound(depth, float(w.abs().sum()) + bias)
            assert abs(got - (float(w.sum()) + bias)) <= bound, (got, bound)

    def test_rows_must_divide(self):
        with pytest.raises(ValueError, match="divisible") as ours:
            pk.make_checksum_fn_f32("bh4", 12, m=7, rows=24, device="cpu")
        with pytest.raises(ValueError, match="divisible") as theirs:
            jk.make_checksum_fn_f32("bh4", 12, m=7, rows=24)
        assert str(ours.value) == str(theirs.value)


def _ffma(a, b, c):
    """An FFMA emulated: the product of two f32 values is exact in float64,
    the sum with c rounds once there and once more to f32 (at most 2^-53
    |a b + c| beyond the f32 rounding's 2^-24 |a b + c|)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def emulate_f32_row(t, h: int):
    """The f32 kernels' samples of h row ``h`` at every lo lane, in their
    evaluation order: acc = fma(-sh, sl, fma(ch, cl, acc)) per harmonic from
    a0.  ``t``: the tables as the kernel takes them
    (``outerwin_kernel._f32_tiles``)."""
    hi, lo = t.hi[h].numpy(), t.lo.numpy()
    acc = np.full(lo.shape[1], np.float32(t.a0), np.float32)
    for k in range(t.nk):
        acc = _ffma(hi[k], lo[k], acc)
        acc = _ffma(-hi[t.nk + k], lo[t.nk + k], acc)
    return acc


def _seam_rows(nh: int) -> list[int]:
    return sorted({0, nh // 4 - 1, nh // 4, nh // 4 + 1, nh // 2, 3 * nh // 4, nh - 1})


class TestKernelOrderEmulation:
    """The f32 kernels' FFMA order, emulated in numpy, within
    ``f32_pair_bound`` of the plain version and of the JAX package's blocks
    at the seam rows (the kernel rounds 2(K-1) times, the plain version
    4(K-1), the bound allows 8(K-1); the emulation's double rounding adds at
    most 2^-53 per rounding); against JAX at the small pw its own tests use,
    at pw=24 against the port's plain version."""

    NAMES = ["bh7", "bh4", "bh5", "hamming", "flattop2"]

    @pytest.mark.parametrize("name", NAMES)
    def test_matches_plain_and_jax(self, name):
        pw, m = 14, 7
        t = pk._f32_tiles(pf._resolve_coeffs(name), pw, m, torch.device("cpu"))
        bound = pk.f32_pair_bound(name)
        gold = float_window_value(name, np.arange(1 << pw), 1 << pw)
        for h in _seam_rows(1 << (pw - m)):
            got = emulate_f32_row(t, h)
            plain = pk.outer_block_f32_plain(name, pw, m, h, 1, device="cpu").numpy()
            jax_blk = np.asarray(jf.float_window_block(h << m, 1, name, pw, m=m))
            assert np.abs(got - plain).max() <= bound
            assert np.abs(got - jax_blk).max() <= bound
            assert np.abs(got - gold[h << m:(h + 1) << m]).max() < 1.5e-6

    @pytest.mark.parametrize("name", NAMES)
    def test_pw24_matches_plain(self, name):
        pw, m = 24, 11
        t = pk._f32_tiles(pf._resolve_coeffs(name), pw, m, torch.device("cpu"))
        for h in _seam_rows(1 << (pw - m)):
            got = emulate_f32_row(t, h)
            plain = pk.outer_block_f32_plain(name, pw, m, h, 1, device="cpu").numpy()
            assert np.abs(got - plain).max() <= pk.f32_pair_bound(name)
            gold = float_window_value(name, (h << m) + np.arange(1 << m), 1 << pw)
            assert np.abs(got - gold).max() < 1.5e-6


class TestAnalyzerFloatMode:
    @pytest.mark.parametrize("fft_mode", ["rfft", "packed", "mxu"])
    def test_matches_jax_per_bin(self, fft_mode):
        spec = WindowSpec(8, 17)
        nfft = spec.n
        x = np.random.default_rng(3).normal(size=(2, 1024)).astype(np.float32)
        got = sp.windowed_power_spectrum(torch.from_numpy(x), "bh4", spec,
                                         win_mode="float", fft_mode=fft_mode).numpy()
        want = np.asarray(jsp.windowed_power_spectrum(
            jnp.asarray(x), "bh4", jconfig.WindowSpec(**vars(spec)), win_mode="float",
            fft_mode=fft_mode))
        ref = _f64_welch(x, float_window_value("bh4", np.arange(nfft), nfft), nfft, nfft // 2)
        budget = 32 * _U * np.sqrt(nfft)  # the derived per-bin f32 budget
        assert got.shape == (2, nfft // 2 + 1)
        assert _max_rel(got, want) < budget
        assert _max_rel(got, ref) < budget

    def test_rejects_quantized_tuple(self):
        spec = WindowSpec(8, 17)
        q = get("bh4").quantized(17)
        x = torch.zeros(1, 1024)
        with pytest.raises(ValueError, match="quantized integer"):
            sp.windowed_power_spectrum(x, q, spec, win_mode="float")
        with pytest.raises(ValueError, match="quantized integer"):
            sp._check_float_window_arg(())
        assert sp._check_float_window_arg((0.5, 0.5)) == jsp._check_float_window_arg((0.5, 0.5))
        assert sp.windowed_power_spectrum(x, (0.5, 0.5), spec, win_mode="float").shape == (1, 129)
