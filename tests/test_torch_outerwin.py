"""PyTorch port, int outer-product fast mode: host tables bitwise equal to the
JAX package's, ``mulsub_shift30`` exact, ``window_block_outer`` /
``tile_window`` 0 LSB against JAX (quadrant seams, n0 != 0, the W=32
saturate no-op), the int checksum's plain version bit-equal to the Pallas
kernel in interpret mode, the spectral floors, and the ported catalog and
spectral helpers equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import outerwin as jo
from blackman_harris_win_tpu.kernels.pallas import limb as jlimb
from blackman_harris_win_tpu.kernels.pallas import outerwin_kernel as jk
from blackman_harris_win_tpu.utils import spectral as jspectral
from blackman_harris_win_tpu.windows import catalog as jcatalog
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.core.fixedpoint import mulsub_shift30
from blackman_harris_win_tpu_torch.kernels import outerwin as po
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as pk
from blackman_harris_win_tpu_torch.utils import spectral
from blackman_harris_win_tpu_torch.windows import catalog

CASES = [  # (window, W, overflow)
    ("bh7", 32, "wrap"),
    ("bh7", 32, "saturate"),  # saturate is a no-op at W = 32 in this mode
    ("bh4", 18, "saturate"),
    ("hann", 17, "wrap"),
    ("bh4", 32, "wrap"),  # |a_k| >= 2^29: guard 0, shift 30
    ("bh3", 32, "saturate"),  # K = 3, guard 0, the W = 32 no-op
    ("bh5", 24, "saturate"),  # K = 5
]

# lo axes narrower than the kernel's 4 lanes a thread (m <= 1), and m = 2
NARROW_CASES = [  # (window, W, overflow, pw, m)
    ("nuttall", 32, "wrap", 12, 2),
    ("hann", 17, "wrap", 9, 1),
    ("bh7", 18, "saturate", 8, 0),
]


def _jspec(spec):
    return jconfig.WindowSpec(**vars(spec))


def _int32_sum(a):
    v = int(np.asarray(a, np.int64).sum()) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


class TestTables:
    @pytest.mark.parametrize("name,w,pw,m", [
        ("bh7", 32, 16, 11), ("bh4", 18, 13, 7), ("hann", 17, 12, 5), ("bh5", 24, 15, 8),
    ])
    def test_tables_bitwise_equal(self, name, w, pw, m):
        q = catalog.get(name).quantized(w)
        hi, lo, guard = po._tables(q, pw, m)
        jhi, jlo, jguard = jo._tables(q, pw, m)
        assert guard == jguard
        assert hi.dtype == jhi.dtype == np.int32
        np.testing.assert_array_equal(hi, jhi)
        np.testing.assert_array_equal(lo, jlo)

    def test_device_packing_is_the_jax_layout(self):
        spec = WindowSpec(12, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        t = pk._int_tiles(q, spec, 7, torch.device("cpu"))
        hi, lo, _ = jo._tables(q, 12, 7)
        np.testing.assert_array_equal(t.hi[:, :6].numpy(), hi[:, :, 0].T)
        np.testing.assert_array_equal(t.hi[:, 6:].numpy(), hi[:, :, 1].T)
        np.testing.assert_array_equal(t.lo[:6].numpy(), lo[:, :, 0])
        np.testing.assert_array_equal(t.lo[6:].numpy(), lo[:, :, 1])


class TestMulsubShift30:
    @pytest.mark.parametrize("shift", [30, 31])
    @pytest.mark.parametrize("round_", [False, True])
    def test_random_and_edges_equal_jax(self, shift, round_):
        rng = np.random.default_rng(7 + shift + 2 * round_)
        top = (1 << 30) - 1
        edges = np.array([top, -top, 0, 1, -1, top - 1, -top + 1], np.int64)
        cols = [np.concatenate([rng.integers(-top, top + 1, size=4096), edges,
                                np.roll(edges, j)]) for j in range(4)]
        a, c, b, d = (np.resize(x, len(cols[0])) for x in cols)
        got = mulsub_shift30(*(torch.from_numpy(x) for x in (a, c, b, d)),
                             round=round_, shift=shift).numpy()
        want = np.asarray(jlimb.mulsub_shift30(
            *(jnp.asarray(x.astype(np.int32)) for x in (a, c, b, d)),
            round=round_, shift=shift)).astype(np.int64)
        exact = np.array([((int(p) * int(q) - int(r) * int(s))
                           + ((1 << (shift - 1)) if round_ else 0)) >> shift
                          for p, q, r, s in zip(a, c, b, d)], np.int64)
        np.testing.assert_array_equal(got, exact)
        # the JAX limb version returns int32: equal where the result fits
        ok = np.abs(exact) < 1 << 31
        np.testing.assert_array_equal(got[ok], want[ok])

    def test_python_ints_and_guards(self):
        top = (1 << 30) - 1
        assert mulsub_shift30(top, top, -top, top, round=True, shift=31) == (
            (2 * top * top + (1 << 30)) >> 31)
        with pytest.raises(ValueError, match="shift"):
            mulsub_shift30(1, 1, 1, 1, shift=32)
        with pytest.raises(ValueError, match="2\\^30"):
            mulsub_shift30(1 << 30, 1, 1, 1)
        with pytest.raises(ValueError, match="2\\^30"):
            mulsub_shift30(torch.tensor([1, -(1 << 30)]), 1, 1, 1)


def _folded(ch, cl, sh, sl, shift):
    """csrc/outerwin_kernel.cu's per-harmonic term in numpy: the low 32 bits
    of (ch*cl + 2^(s-1) + sh*(-sl)) shifted right logically by s, from an
    int64 d (|d| < 2^62), as uint64 values below 2^32."""
    d = ch * cl + (1 << (shift - 1)) + sh * -sl
    assert np.abs(d).max() < 1 << 62
    return (d.view(np.uint64) >> np.uint64(shift)) & np.uint64(0xFFFFFFFF)


def _kernel_tile(ch, sh, cl, sl, a0, shift, spec):
    """The int kernel's tile in numpy, in its order: the uint32 accumulate of
    a0 and the folded terms, then its W-step (sign extension from 32 - sw
    bits, then a clamp to [lo, hi]; skipped at W = 32)."""
    acc = np.full((ch.shape[0], cl.shape[1]), a0 & 0xFFFFFFFF, np.uint64)
    for k in range(ch.shape[1]):
        acc = (acc + _folded(ch[:, k:k + 1], cl[k], sh[:, k:k + 1], sl[k], shift)) \
            & np.uint64(0xFFFFFFFF)
    x = acc.astype(np.uint32)
    w, sat = spec.data_width, spec.overflow == "saturate"
    if w >= 32:
        return x.view(np.int32)
    sw = 0 if sat else 32 - w
    hi = (1 << (w - 1)) - 1 if sat else (1 << 31) - 1
    e = (x << np.uint32(sw)).view(np.int32) >> np.int32(sw)
    return np.clip(e, -hi - 1, hi).astype(np.int32)


class TestKernelArithmetic:
    """The int kernel's arithmetic, emulated on the CPU: its folded
    per-harmonic term against JAX ``mulsub_shift30`` mod 2^32, and its tile
    (uint32 accumulate and W-step) against JAX ``tile_window``."""

    @pytest.mark.parametrize("shift", [30, 31])
    def test_folded_term_equals_jax_mulsub_shift30(self, shift):
        rng = np.random.default_rng(40 + shift)
        top = (1 << 30) - 1
        a, c, b, d = (rng.integers(-top, top + 1, size=50000) for _ in range(4))
        # products whose difference has remainder exactly 2^(s-1) mod 2^s: the
        # rounding tie; d = 1 and b chosen from a*c, kept below 2^30
        ta, tc = rng.integers(-top, top + 1, size=(2, 4096))
        tb = (ta * tc - (1 << (shift - 1))) % (1 << shift)
        tb = np.where(tb > top, tb - (1 << shift), tb)
        keep = np.abs(tb) <= top
        edges = np.array([top, -top, 0, 1, -1, 1 << 29, -(1 << 29)], np.int64)
        grid = np.array(np.meshgrid(edges, edges, edges, edges)).reshape(4, -1)
        a, c, b, d = (np.concatenate(v) for v in zip(
            (a, c, b, d), (ta[keep], tc[keep], tb[keep], np.ones(keep.sum(), np.int64)),
            grid))
        tie = (a * c - b * d) % (1 << shift) == 1 << (shift - 1)
        assert tie.sum() > 4000
        got = _folded(a, c, b, d, shift)
        want = np.asarray(jlimb.mulsub_shift30(
            *(jnp.asarray(x.astype(np.int32)) for x in (a, c, b, d)),
            round=True, shift=shift)).astype(np.int64)
        np.testing.assert_array_equal(got, want.astype(np.uint64) & np.uint64(0xFFFFFFFF))

    @pytest.mark.parametrize("name,w,overflow,pw,m",
                             [(*c, 12, 6) for c in CASES] + NARROW_CASES)
    def test_kernel_tile_equals_jax_tile_window(self, name, w, overflow, pw, m):
        spec = WindowSpec(pw, w, overflow=overflow)
        q = catalog.get(name).quantized(w)
        hi, lo, guard = po._tables(q, pw, m)
        parts = [hi[:, :, 0].T.copy(), hi[:, :, 1].T.copy(), lo[:, :, 0].copy(),
                 lo[:, :, 1].copy()]
        got = _kernel_tile(*(x.astype(np.int64) for x in parts), q[0], 30 + guard, spec)
        want = np.asarray(jk.tile_window(*(jnp.asarray(x) for x in parts), q[0], guard,
                                         _jspec(spec)))
        np.testing.assert_array_equal(got, want)


class TestWindowBlockOuter:
    @pytest.mark.parametrize("name,w,overflow", CASES)
    def test_full_period_0_lsb(self, name, w, overflow):
        pw, m = 14, 7
        spec = WindowSpec(pw, w, overflow=overflow)
        q = catalog.get(name).quantized(w)
        got = po.window_block_outer(0, 1 << (pw - m), q, spec, m=m, device="cpu")
        want = np.asarray(jo.window_block_outer(0, 1 << (pw - m), q, _jspec(spec), m=m))
        assert got.dtype == torch.int32 and got.shape == (1 << pw,)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("name,w,overflow", CASES)
    def test_seam_blocks_0_lsb(self, name, w, overflow):
        pw, m, rows = 15, 6, 4
        n = 1 << pw
        spec = WindowSpec(pw, w, overflow=overflow)
        q = catalog.get(name).quantized(w)
        for seam in (n // 4, n // 2, 3 * n // 4):
            n0 = seam - 2 * (1 << m)  # the block straddles the seam
            got = po.window_block_outer(n0, rows, q, spec, m=m, device="cpu").numpy()
            want = np.asarray(jo.window_block_outer(n0, rows, q, _jspec(spec), m=m))
            np.testing.assert_array_equal(got, want)
        last = n - rows * (1 << m)  # the block that ends the period
        np.testing.assert_array_equal(
            po.window_block_outer(last, rows, q, spec, m=m, device="cpu").numpy(),
            np.asarray(jo.window_block_outer(last, rows, q, _jspec(spec), m=m)))

    @pytest.mark.parametrize("name,w,overflow,pw,m", NARROW_CASES)
    def test_narrow_lo_full_period_0_lsb(self, name, w, overflow, pw, m):
        spec = WindowSpec(pw, w, overflow=overflow)
        q = catalog.get(name).quantized(w)
        got = po.window_block_outer(0, 1 << (pw - m), q, spec, m=m, device="cpu")
        want = np.asarray(jo.window_block_outer(0, 1 << (pw - m), q, _jspec(spec), m=m))
        assert got.dtype == torch.int32 and got.shape == (1 << pw,)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_w32_saturate_is_a_no_op(self):
        pw, m = 13, 6
        q = catalog.get("bh7").quantized(32)
        sat = po.window_block_outer(0, 1 << (pw - m), q, WindowSpec(pw, 32, overflow="saturate"), m=m, device="cpu")
        wrp = po.window_block_outer(0, 1 << (pw - m), q, WindowSpec(pw, 32, overflow="wrap"), m=m, device="cpu")
        assert torch.equal(sat, wrp)

    @pytest.mark.parametrize("name,w,overflow", CASES)
    def test_tile_window_equals_jax(self, name, w, overflow):
        pw, m = 12, 6
        spec = WindowSpec(pw, w, overflow=overflow)
        q = catalog.get(name).quantized(w)
        hi, lo, guard = po._tables(q, pw, m)
        parts = [hi[:, :, 0].T.copy(), hi[:, :, 1].T.copy(), lo[:, :, 0].copy(), lo[:, :, 1].copy()]
        got = pk.tile_window(*(torch.from_numpy(p) for p in parts), q[0], guard, spec)
        want = np.asarray(jk.tile_window(*(jnp.asarray(p) for p in parts), q[0], guard,
                                         _jspec(spec)))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_matches_ideal_within_lsb(self):
        pw, w = 16, 32
        q = catalog.get("bh7").quantized(w)
        win = po.window_block_outer(0, 1 << (pw - 11), q, WindowSpec(pw, w, overflow="wrap"), device="cpu")
        a = np.array(q, np.float64)
        n = np.arange(1 << pw)
        ideal = a[0] + sum((-1) ** k * a[k] * np.cos(2 * np.pi * k * n / (1 << pw))
                           for k in range(1, len(a)))
        err = win.numpy().astype(np.float64) - ideal
        assert np.abs(err).max() <= 6  # the JAX package's bound
        assert abs(err.mean()) < 0.1

    def test_preconditions(self):
        spec = WindowSpec(12, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        with pytest.raises(ValueError, match="split"):
            po.window_block_outer(0, 1, q, spec, m=12, device="cpu")
        with pytest.raises(ValueError, match="2\\^30"):
            po.window_block_outer(0, 1, (1 << 30, 5), spec, m=6, device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            po.window_block_outer(3, 1, q, spec, m=6, device="cpu")
        with pytest.raises(ValueError, match="period"):
            po.window_block_outer(1 << 11, 64, q, spec, m=6, device="cpu")

    def test_cpu_runs_no_kernel_and_cuda_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CUDA path is tested in test_torch_gpu.py")
        spec = WindowSpec(12, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        _build.reset_launches()
        po.window_block_outer(0, 4, q, spec, m=6, device="cpu")
        pk.make_checksum_fn(q, spec, m=6, rows=8, device="cpu")(0)
        assert not any(_build.launches.values())
        with pytest.raises(RuntimeError, match="CUDA"):
            po.window_block_outer(0, 4, q, spec, m=6, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            pk.make_checksum_fn(q, spec, m=6, rows=8, device="cuda")


def _check_checksum_against_pallas(name, w, overflow, pw, m):
    spec = WindowSpec(pw, w, overflow=overflow)
    q = catalog.get(name).quantized(w)
    fn = pk.make_checksum_fn(q, spec, m=m, rows=32, device="cpu")
    jfn = jk.make_checksum_fn(q, _jspec(spec), m=m, rows=32, interpret=True)
    ref = _int32_sum(po.window_block_outer(0, 1 << (pw - m), q, spec, m=m, device="cpu").numpy())
    for bias in (0, 9):
        got = fn(bias)
        assert got.dtype == torch.int32 and got.shape == ()
        want = ((ref + bias + (1 << 31)) % (1 << 32)) - (1 << 31)
        assert int(got) == int(jfn(jnp.int32(bias))) == want


class TestIntChecksum:
    @pytest.mark.parametrize("name,w,overflow", [
        ("bh7", 32, "wrap"), ("bh4", 18, "saturate"),
        ("bh4", 32, "wrap"), ("bh3", 32, "saturate"), ("bh5", 24, "saturate"),
    ])
    def test_plain_bit_equal_to_pallas_interpret(self, name, w, overflow):
        _check_checksum_against_pallas(name, w, overflow, 14, 7)

    @pytest.mark.parametrize("name,w,overflow,pw,m", NARROW_CASES)
    def test_narrow_lo_plain_bit_equal_to_pallas_interpret(self, name, w, overflow, pw, m):
        _check_checksum_against_pallas(name, w, overflow, pw, m)

    def test_int32_wrap_of_bias(self):
        spec = WindowSpec(12, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        fn = pk.make_checksum_fn(q, spec, m=6, rows=8, device="cpu")
        base = int(fn(0))
        big = (1 << 31) - 1
        want = ((base + big + (1 << 31)) % (1 << 32)) - (1 << 31)
        assert int(fn(big)) == want

    def test_rows_must_divide_htable(self):
        spec = WindowSpec(14, 32, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        with pytest.raises(ValueError, match="divisible") as ours:
            pk.make_checksum_fn(q, spec, m=7, rows=48, device="cpu")
        with pytest.raises(ValueError, match="divisible") as theirs:
            jk.make_checksum_fn(q, _jspec(spec), m=7, rows=48)
        assert str(ours.value) == str(theirs.value)


def _sidelobe_db(win, n_terms):
    """test_fastwin.py's measurement: 4x oversampled FFT, 16 * n_terms
    guard bins, through the ported ``window_sidelobe_db``."""
    return spectral.window_sidelobe_db(win, oversample=4, guard_bins=16 * n_terms)


class TestSpectralFloors:
    def test_bh7_holds_published_floor(self):
        pw, w = 16, 32
        q = catalog.get("bh7").quantized(w)
        win = po.window_block_outer(0, 1 << (pw - 11), q, WindowSpec(pw, w, overflow="wrap"), device="cpu")
        assert _sidelobe_db(win.numpy(), 7) <= -180.0

    @pytest.mark.parametrize("name,w,bound", [
        ("bh4", 18, -91.0),
        ("bh5", 24, -123.0),
        ("hann", 17, -31.0),
    ])
    def test_other_windows_hold_published_floor(self, name, w, bound):
        pw = 13
        q = catalog.get(name).quantized(w)
        win = po.window_block_outer(0, 1 << (pw - 11), q, WindowSpec(pw, w, overflow="saturate"), device="cpu")
        assert _sidelobe_db(win.numpy(), catalog.get(name).n_terms) <= bound


class TestHostHelpers:
    @pytest.mark.parametrize("name", ["hann", "bh4", "bh7"])
    def test_catalog_float_and_golden_equal_jax(self, name):
        n = np.arange(4096)
        np.testing.assert_array_equal(catalog.float_window_value(name, n, 4096),
                                      jcatalog.float_window_value(name, n, 4096))
        np.testing.assert_array_equal(catalog.golden_quantized_window(name, n, 4096, 24),
                                      jcatalog.golden_quantized_window(name, n, 4096, 24))

    def test_spectral_helpers_equal_jax(self):
        rng = np.random.default_rng(5)
        n = np.arange(2048)
        tone = np.round(2**20 * np.cos(2 * np.pi * 37 * n / 2048)) + rng.integers(-2, 3, 2048)
        np.testing.assert_array_equal(spectral.power_spectrum_db(tone),
                                      jspectral.power_spectrum_db(tone))
        assert spectral.tone_spectral_floor_db(tone, 2) == jspectral.tone_spectral_floor_db(tone, 2)
        win = catalog.float_window_value("bh4", n, 2048)
        for kw in ({}, {"oversample": 4, "guard_bins": 40}, {"n_terms": 7}):
            assert spectral.window_sidelobe_db(win, **kw) == jspectral.window_sidelobe_db(win, **kw)
        for db in (-32.0, -92.0, -180.0):
            assert (spectral.required_width_for_sidelobe(db)
                    == jspectral.required_width_for_sidelobe(db))
