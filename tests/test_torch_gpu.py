"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where torch sees no CUDA device
(the decision is made in a fixture, at run time).  On a machine with a card
(``--noconftest``: the suite's conftest imports jax, which this file does
not need):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import compwin as pc
from blackman_harris_win_tpu_torch.kernels.barrier import materialize, materialize_plain
from blackman_harris_win_tpu_torch.kernels import outerwin as po
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.kernels import window_kernel as wk
from blackman_harris_win_tpu_torch.kernels.welchfft_kernel import (
    welch_stage1_fused,
    welch_stage1_plain,
)
from blackman_harris_win_tpu_torch.pipeline import ddc as pddc
from blackman_harris_win_tpu_torch.pipeline import fir as pfir
from blackman_harris_win_tpu_torch.pipeline import spectral as sp
from blackman_harris_win_tpu_torch.windows import catalog

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", torch.cuda.current_device())


def _spots(pw, rng, nblock=2048):
    """A random block plus +-3 around the quadrant seams and the period end."""
    n = 1 << pw
    pts = [np.arange(nblock) + int(rng.integers(0, n - nblock))]
    for base in (0, n // 4, n // 2, 3 * n // 4, n - 4):
        pts.append(np.arange(max(0, base - 3), min(n, base + 4)))
    return np.unique(np.concatenate(pts))


WINDOW_CASES = [
    ("bh7", 26, 32, "hls", "wrap"),
    ("bh7", 26, 32, "hls", "saturate"),
    ("bh4", 20, 17, "hls", "saturate"),
    ("bh4", 31, 32, "hls", "saturate"),
    ("hann", 12, 24, "hls", "wrap"),
    ("bh5", 31, 24, "hls", "wrap"),
    ("bh7", 26, 32, "rtl", "wrap"),
    ("bh4", 31, 17, "rtl", "wrap"),
    ("hamming", 16, 32, "rtl", "wrap"),
    ("bh3", 14, 31, "rtl", "saturate"),
]


def _coeffs(name, w, rounding):
    q = catalog.get(name).quantized(w)
    return kw.rtl_cordic_coeffs(q) if rounding == "rtl" else q


@pytest.mark.parametrize("name,pw,w,rounding,overflow", WINDOW_CASES)
def test_window_block_kernel_matches_plain(cuda, name, pw, w, rounding, overflow):
    spec = WindowSpec(pw, w, rounding=rounding, overflow=overflow)
    q = _coeffs(name, w, rounding)
    n = _spots(pw, np.random.default_rng(pw * 100 + w))
    # contiguous runs: launch one block per run, compare with the CPU plain
    runs = np.split(n, np.nonzero(np.diff(n) != 1)[0] + 1)
    for run in runs:
        got = wk.window_block(q, spec, int(run[0]), len(run), cuda).cpu()
        want = wk.window_values_plain(torch.from_numpy(run), q, spec)
        assert torch.equal(got, want), (name, pw, w, rounding, int(run[0]))


@pytest.mark.parametrize("name,pw,w,rounding,overflow", WINDOW_CASES[:4] + WINDOW_CASES[6:8])
def test_window_checksum_kernel_matches_plain(cuda, name, pw, w, rounding, overflow):
    spec = WindowSpec(pw, w, rounding=rounding, overflow=overflow)
    q = _coeffs(name, w, rounding)
    n_start, count = (1 << pw) - 70000, 200003  # crosses the period end
    got = wk.window_checksum(q, spec, n_start, count, bias=12345, device=cuda)
    want = wk.window_checksum_plain(q, spec, n_start, count, bias=12345, device="cpu")
    assert int(got) == int(want)


def _sweep_case(w, rounding):
    """The card sweep's configuration at width w: a BH-7 prefix of 2..7
    terms (cycling with w) and, for the RTL contract, P = 1 + w mod 7, so
    every datapath of ``window_kernel._datapath`` is reached."""
    nterms = 2 + (w + (rounding == "rtl")) % 6
    q = catalog.get("bh7").quantized(w)[:nterms]
    p = 1 + w % 7 if rounding == "rtl" else 1
    return (kw.rtl_cordic_coeffs(q) if rounding == "rtl" else q), p


@pytest.mark.parametrize("overflow", ["wrap", "saturate"])
@pytest.mark.parametrize("rounding", ["hls", "rtl"])
@pytest.mark.parametrize("w", range(8, 33))
def test_window_block_sweep_every_width(cuda, w, rounding, overflow):
    # a full period at pw=12 and +-3 around the quadrant seams at pw=31,
    # 0 LSB against the CPU plain version
    q, p = _sweep_case(w, rounding)
    full = WindowSpec(12, w, rounding=rounding, overflow=overflow, precision=p)
    _build.reset_launches()
    got = wk.window_block(q, full, 0, 1 << 12, cuda).cpu()
    assert torch.equal(got, wk.window_values_plain(torch.arange(1 << 12), q, full)), (
        w, rounding, overflow, p, wk._datapath(full))
    seam = full.with_(phase_width=31)
    n = 1 << 31
    for base in (0, n // 4, n // 2, 3 * n // 4, n):
        run = np.arange(base - 3, base + 4) % n
        got = wk.window_block(q, seam, int(run[0]), 7, cuda).cpu()
        want = wk.window_values_plain(torch.from_numpy(np.arange(run[0], run[0] + 7)), q, seam)
        assert torch.equal(got, want), (w, rounding, overflow, p, int(base))
    assert _build.launches["window_block"] == 6


@pytest.mark.parametrize("name,w,rounding,p,datapath", [
    ("bh4", 17, "hls", 1, "i32"),
    ("bh4", 31, "hls", 1, "r2s"),
    ("bh7", 32, "hls", 1, "r2s"),
    ("bh7", 32, "rtl", 1, "r2s"),
    ("bh7", 32, "rtl", 5, "i64"),
])
def test_window_checksum_each_datapath(cuda, name, w, rounding, p, datapath):
    spec = WindowSpec(20, w, rounding=rounding, overflow="wrap", precision=p)
    assert wk._datapath(spec) == datapath
    q = _coeffs(name, w, rounding)
    n_start, count = (1 << 20) - 50000, 150001  # crosses the period end
    _build.reset_launches()
    got = wk.window_checksum(q, spec, n_start, count, bias=-99, device=cuda)
    assert _build.launches["window_checksum"] == 1
    want = wk.window_checksum_plain(q, spec, n_start, count, bias=-99, device="cpu")
    assert int(got) == int(want)


@pytest.mark.parametrize("nfft,nframes", [(1 << 13, 5), (1 << 13, 4),
                                          (1 << 14, 7), (1 << 19, 3),
                                          (1 << 20, 3), (1 << 20, 4),
                                          (1 << 21, 3), (1 << 21, 4)])
def test_welch_stage1_kernel_matches_plain(cuda, nfft, nframes):
    hop = nfft // 2
    rng = np.random.default_rng(nfft + nframes)
    x = torch.from_numpy(rng.normal(size=hop * nframes + hop).astype(np.float32)).to(cuda)
    win = torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(cuda)
    gr, gi, nf = welch_stage1_fused(x, win, nfft)
    wr, wi, nf_plain = welch_stage1_plain(x, win, nfft)
    assert nf == nf_plain == nframes
    scale = float(torch.maximum(wr.abs().max(), wi.abs().max()))
    err = float(torch.maximum((gr - wr).abs().max(), (gi - wi).abs().max()))
    assert err / scale < 1e-5, err / scale


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_welch_stage1_kernel_unaligned_x(cuda, offset):
    # x off 16-byte alignment takes the 4-byte copies; many frame pairs, so
    # every block walks a range of pairs through the whole slot ring
    nfft, nframes = 1 << 13, 41
    hop = nfft // 2
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.normal(size=hop * (nframes + 1) + offset).astype(np.float32))
    x = base.to(cuda)[offset:]
    win = torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(cuda)
    _build.reset_launches()
    gr, gi, nf = welch_stage1_fused(x, win, nfft)
    assert _build.launches["welch_stage1"] == 1
    wr, wi, _ = welch_stage1_plain(x, win, nfft)
    scale = float(torch.maximum(wr.abs().max(), wi.abs().max()))
    err = float(torch.maximum((gr - wr).abs().max(), (gi - wi).abs().max()))
    assert nf == nframes and err / scale < 1e-5, err / scale


@pytest.mark.parametrize("pw", [13, 19])
def test_analyzer_runs_the_kernels_and_matches_rfft(cuda, pw):
    spec = WindowSpec(pw, 17, overflow="saturate")
    nfft = spec.n
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=nfft * 9).astype(np.float32)).to(cuda)
    _build.reset_launches()
    got = sp.windowed_power_spectrum(x, "bh4", spec, fft_mode="mxu")
    assert _build.launches["window_block"] == 1
    assert _build.launches["welch_stage1"] == 1
    want = sp.windowed_power_spectrum(x, "bh4", spec, fft_mode="rfft")
    rel = float(((got - want).abs() / want.abs()).max())
    assert rel < 32 * 2.0**-24 * np.sqrt(nfft), rel


def test_wrappers_reject_bad_tensors(cuda):
    nfft = 1 << 13
    x = torch.zeros(nfft * 2, device=cuda)
    win = torch.zeros(nfft, device=cuda)
    with pytest.raises(ValueError):
        welch_stage1_fused(x.double(), win, nfft)
    with pytest.raises(ValueError):
        welch_stage1_fused(x, win[: nfft // 2], nfft)
    with pytest.raises(ValueError):
        welch_stage1_fused(x[::2], win, nfft)
    with pytest.raises(ValueError):
        wk.window_block(catalog.get("bh4").quantized(17), WindowSpec(12, 17), -1, 8, cuda)


# --- outer-product fast modes (csrc/outerwin_kernel.cu) ---

OUTER_INT_CASES = [  # (window, W, overflow, pw, m)
    ("bh7", 32, "wrap", 16, 11),
    ("bh7", 32, "saturate", 16, 11),
    ("bh4", 18, "saturate", 15, 6),
    ("hann", 17, "wrap", 13, 5),  # 32 lanes: fewer than a block's 256
]


@pytest.mark.parametrize("name,w,overflow,pw,m", OUTER_INT_CASES)
def test_outer_int_block_kernel_matches_plain(cuda, name, w, overflow, pw, m):
    spec = WindowSpec(pw, w, overflow=overflow)
    q = catalog.get(name).quantized(w)
    n = 1 << pw
    _build.reset_launches()
    got = po.window_block_outer(0, n >> m, q, spec, m=m, device=cuda)
    assert _build.launches["outer_block"] == 1
    want = po.window_block_outer(0, n >> m, q, spec, m=m, device="cpu")  # CPU plain version
    assert torch.equal(got.cpu(), want)
    plain = ok.outer_block_int_plain(q, spec, m, 0, n >> m, device=cuda)
    assert torch.equal(got, plain)
    for n0 in (n // 4 - (2 << m), 3 * n // 4 - (2 << m)):  # blocks across seams
        blk = po.window_block_outer(n0, 4, q, spec, m=m, device=cuda).cpu()
        assert torch.equal(blk, want[n0:n0 + (4 << m)])


@pytest.mark.parametrize("name,w,overflow,pw,m", OUTER_INT_CASES)
def test_outer_int_checksum_kernel_matches_plain(cuda, name, w, overflow, pw, m):
    spec = WindowSpec(pw, w, overflow=overflow)
    q = catalog.get(name).quantized(w)
    fn = ok.make_checksum_fn(q, spec, m=m, rows=8, device=cuda)
    plain = ok.make_checksum_fn(q, spec, m=m, rows=8, device="cpu")
    win = po.window_block_outer(0, (1 << pw) >> m, q, spec, m=m, device="cpu")
    base = int(win.sum(dtype=torch.int64))
    for bias in (0, 9, -(1 << 31)):
        want = ((base + bias + (1 << 31)) % (1 << 32)) - (1 << 31)
        got = fn(bias)
        assert got.dtype == torch.int32 and got.device == cuda
        assert int(got) == int(plain(bias)) == want


def _check_checksum_against_plain(depth_k, n, m, got, win_k, win_p, plain, comp=False):
    """f32/comp checksum kernel results ``got`` (at bias 0 and 5) against the
    float64 sum of its terms (the write-out ``win_k``: the checksum kernel
    computes each sample with the write-out's device code) within its
    derived bound (``depth_k``, the kernel's addition depth), and against
    its plain version within that bound plus sum |w_k - w_p| plus the plain
    sum's own bound (rows = 8)."""
    depth_p = ok.checksum_plain_depth(n >> m, 1 << m, 8, comp=comp)
    exact = sum(float(w.double().sum()) for w in win_k)
    abs_k = sum(float(w.double().abs().sum()) for w in win_k)
    abs_p = sum(float(w.double().abs().sum()) for w in win_p)
    diff = sum(float((a.double() - b.double()).abs().sum()) for a, b in zip(win_k, win_p))
    for bias, c in zip((0, 5), got):
        bound_k = ok.sum_bound(depth_k, abs_k + bias)
        assert abs(float(c) - (exact + bias)) <= bound_k, (float(c), exact + bias, bound_k)
        tol = bound_k + diff + ok.sum_bound(depth_p, abs_p + bias)
        want = float(plain(bias))
        assert abs(float(c) - want) <= tol, (float(c), want, tol)


@pytest.mark.parametrize("name,pw,m,bf16", [("bh7", 16, 11, False), ("bh4", 14, 5, False),
                                            ("bh4", 14, 7, True)])
def test_outer_f32_block_and_checksum_kernels(cuda, name, pw, m, bf16):
    n = 1 << pw
    tdt = torch.bfloat16 if bf16 else None
    got = ok.outer_block_f32(name, pw, m, 0, n >> m, device=cuda, table_dtype=tdt)
    plain = ok.outer_block_f32_plain(name, pw, m, 0, n >> m, device=cuda, table_dtype=tdt)
    # two f32 evaluation orders: bounded by the op count
    assert float((got - plain).abs().max()) <= ok.f32_pair_bound(name)
    fn = ok.make_checksum_fn_f32(name, pw, m=m, rows=8, table_dtype=tdt, device=cuda)
    c0, c0b, c5 = fn(0), fn(0), fn(5)
    assert torch.equal(c0, c0b)  # deterministic: no float atomics
    assert float(c5) == float(np.float32(float(c0) + 5.0))  # bias added last
    _check_checksum_against_plain(
        ok.checksum_depth(name, pw, m, device=cuda), n, m, (c0, c5), (got,), (plain,),
        lambda b: ok.checksum_plain_f32(name, pw, m, 8, b, table_dtype=tdt, device=cuda))


@pytest.mark.parametrize("name,pw,m,thresh", [("bh7", 16, 11, pc.DEFAULT_THRESH),
                                              ("hamming", 13, 6, pc.DEFAULT_THRESH),
                                              ("bh4", 13, 7, 1.1)])
def test_outer_comp_block_kernel_matches_plain(cuda, name, pw, m, thresh):
    n = 1 << pw
    s, e = ok.outer_block_comp(name, pw, m, pc.GRID_BITS, thresh, 0, n >> m, device=cuda)
    ps, pe = ok.outer_block_comp_plain(name, pw, m, pc.GRID_BITS, thresh, 0, n >> m,
                                       device=cuda)
    assert torch.equal(s, ps)  # exact on the 2^-22 grid under any evaluation
    assert float((e - pe).abs().max()) <= ok.comp_e_bound(name, thresh=thresh)
    gold = torch.from_numpy(catalog.float_window_value(name, np.arange(n), n)).to(cuda)
    # pair accuracy 5e-9; with nothing compensated (thresh above every
    # |a_k|) the pair is plain f32, 3e-7 (tests/test_compwin.py)
    bound = 5e-9 if thresh < 1 else 3e-7
    assert float((s.double() + e.double() - gold).abs().max()) < bound


@pytest.mark.parametrize("name,pw,m", [("bh7", 16, 11), ("hamming", 13, 6)])
def test_outer_comp_checksum_kernel(cuda, name, pw, m):
    n = 1 << pw
    s, e = pc.comp_window_pair(name, pw, m=m, device=cuda)
    ps, pe = ok.outer_block_comp_plain(name, pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, 0, n >> m,
                                       device=cuda)
    fn = ok.make_checksum_fn_comp(name, pw, m=m, rows=8, device=cuda)
    c0, c5 = fn(0), fn(5)
    assert torch.equal(c0, fn(0))
    assert float(c5) == float(np.float32(float(c0) + 5.0))
    _check_checksum_against_plain(
        ok.checksum_depth(name, pw, m, comp=True, device=cuda), n, m, (c0, c5), (s, e),
        (ps, pe), lambda b: ok.checksum_plain_comp(name, pw, m, 8, b, device=cuda), comp=True)


# the float kernels' geometry: V = 4 lanes a thread, a row range a block,
# compile-time (C, P) for the catalog and a runtime-count instantiation
# for the rest

def _comp_counts(coeffs, thresh=pc.DEFAULT_THRESH):
    c = sum(1 for a in pc._resolve_coeffs(coeffs)[1:] if abs(a) >= thresh)
    return c, len(pc._resolve_coeffs(coeffs)) - 1 - c


def _check_float_blocks(cuda, coeffs, pw, m, h0, rows, thresh=pc.DEFAULT_THRESH):
    """The f32 and comp write-outs of rows [h0, h0 + rows) against their
    plain versions on the card: f32 within f32_pair_bound, comp s bit-equal
    and e within comp_e_bound."""
    got = ok.outer_block_f32(coeffs, pw, m, h0, rows, device=cuda)
    want = ok.outer_block_f32_plain(coeffs, pw, m, h0, rows, device=cuda)
    assert got.shape == (rows << m,)
    assert float((got - want).abs().max()) <= ok.f32_pair_bound(coeffs)
    s, e = ok.outer_block_comp(coeffs, pw, m, pc.GRID_BITS, thresh, h0, rows, device=cuda)
    ps, pe = ok.outer_block_comp_plain(coeffs, pw, m, pc.GRID_BITS, thresh, h0, rows,
                                       device=cuda)
    assert torch.equal(s, ps)
    assert float((e - pe).abs().max()) <= ok.comp_e_bound(coeffs, thresh=thresh)


@pytest.mark.parametrize("name", ["bh7", "bh4", "hamming"])
@pytest.mark.parametrize("h0,rows", [(5, 77), (1, 1), (0, 127), (3, 125)])
def test_float_block_kernels_odd_row_ranges(cuda, name, h0, rows):
    # pw=18, m=11: 128 rows; ranges off row 0, of odd length, one row
    _check_float_blocks(cuda, name, 18, 11, h0, rows)


@pytest.mark.parametrize("m", [0, 1, 2, 5, 9])
def test_float_kernels_ragged_lanes(cuda, m):
    # nl = 2^m < 512 lanes a block: the edge is masked (m <= 1: scalar stores)
    pw, n = 12, 1 << 12
    _check_float_blocks(cuda, "bh7", pw, m, 0, n >> m)
    _check_float_blocks(cuda, "bh4", pw, m, 3, (n >> m) - 5)
    for comp in (False, True):
        make = ok.make_checksum_fn_comp if comp else ok.make_checksum_fn_f32
        fn = make("bh7", pw, m=m, rows=1, device=cuda)
        win = (ok.outer_block_comp("bh7", pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, 0, n >> m,
                                   device=cuda) if comp
               else (ok.outer_block_f32("bh7", pw, m, 0, n >> m, device=cuda),))
        exact = sum(float(w.double().sum()) for w in win)
        bound = ok.sum_bound(ok.checksum_depth("bh7", pw, m, comp=comp, device=cuda),
                             sum(float(w.double().abs().sum()) for w in win))
        assert abs(float(fn(0)) - exact) <= bound


@pytest.mark.parametrize("name", catalog.names())
def test_float_kernels_each_catalog_instantiation(cuda, name):
    # every catalog window's (C, P) (hann/hamming (1,0) .. bh7 (4,2)) and
    # K-1: write-out and checksum against plain
    pw, m = 14, 7
    n = 1 << pw
    assert _comp_counts(name) in {(1, 0), (2, 0), (3, 0), (3, 1), (4, 2)}
    _check_float_blocks(cuda, name, pw, m, 0, n >> m)
    f32 = ok.outer_block_f32(name, pw, m, 0, n >> m, device=cuda)
    f32_p = ok.outer_block_f32_plain(name, pw, m, 0, n >> m, device=cuda)
    fn = ok.make_checksum_fn_f32(name, pw, m=m, rows=8, device=cuda)
    _check_checksum_against_plain(
        ok.checksum_depth(name, pw, m, device=cuda), n, m, (fn(0), fn(5)), (f32,), (f32_p,),
        lambda b: ok.checksum_plain_f32(name, pw, m, 8, b, device=cuda))
    s, e = pc.comp_window_pair(name, pw, m=m, device=cuda)
    ps, pe = ok.outer_block_comp_plain(name, pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, 0, n >> m,
                                       device=cuda)
    fc = ok.make_checksum_fn_comp(name, pw, m=m, rows=8, device=cuda)
    _check_checksum_against_plain(
        ok.checksum_depth(name, pw, m, comp=True, device=cuda), n, m, (fc(0), fc(5)), (s, e),
        (ps, pe), lambda b: ok.checksum_plain_comp(name, pw, m, 8, b, device=cuda), comp=True)


@pytest.mark.parametrize("coeffs,thresh", [
    ("bh4", 1.1),  # (0, 3): nothing compensated
    ((0.3, 0.25, 0.2, 0.1, 0.05, 0.04, 0.03, 0.03), pc.DEFAULT_THRESH),  # (7, 0), 8 terms
    ((0.4, 0.3, 0.005, 0.2, 0.004), pc.DEFAULT_THRESH),  # (2, 2), interleaved
])
def test_comp_kernels_runtime_count_instantiation(cuda, coeffs, thresh):
    _check_float_blocks(cuda, coeffs, 14, 7, 2, 101, thresh=thresh)


def test_float_kernels_pw31(cuda):
    # pw = 31 at m = 11: 2^20 rows.  Seam rows against plain; the checksums
    # repeat their bits and hold against the float64 sum of the write-out,
    # taken 2^14 rows at a time
    pw, m = 31, 11
    nh = 1 << (pw - m)
    for h0 in (0, nh // 4 - 1, nh // 2 - 2, 3 * nh // 4 - 1, nh - 4):
        _check_float_blocks(cuda, "bh7", pw, m, h0, 4)
    step = 1 << 14
    for comp in (False, True):
        make = ok.make_checksum_fn_comp if comp else ok.make_checksum_fn_f32
        fn = make("bh7", pw, m=m, rows=256, device=cuda)
        c0 = fn(0)
        assert torch.equal(c0, fn(0))
        exact = sum_abs = 0.0
        for h0 in range(0, nh, step):
            win = (ok.outer_block_comp("bh7", pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, h0, step,
                                       device=cuda) if comp
                   else (ok.outer_block_f32("bh7", pw, m, h0, step, device=cuda),))
            exact += sum(float(w.double().sum()) for w in win)
            sum_abs += sum(float(w.double().abs().sum()) for w in win)
        # the float64 running sum over 2^31-term chunks: 2^-53 per addition
        slack = 4 * (1 << pw) * 2.0**-53 * sum_abs
        bound = ok.sum_bound(ok.checksum_depth("bh7", pw, m, comp=comp, device=cuda), sum_abs)
        assert abs(float(c0) - exact) <= bound + slack, (float(c0), exact, bound)


@pytest.mark.parametrize("name", ["bh7", "bh5", "hann"])
def test_float_checksums_repeat_their_bits(cuda, name):
    for make in (ok.make_checksum_fn_f32, ok.make_checksum_fn_comp):
        fn = make(name, 20, m=11, rows=8, device=cuda)
        first = fn(123457)
        for _ in range(4):
            assert torch.equal(fn(123457), first)


def test_float_write_out_entry_refuses_unaligned_outputs(cuda):
    # the float write-outs store 16 bytes: an output off a 16-byte boundary
    # is refused (cudaErrorInvalidValue), an aligned one accepted
    pw, m, rows = 12, 5, 8
    lib, stream = _build.lib(), _build.stream_of(cuda)
    buf = torch.zeros(2, (rows << m) + 4, device=cuda)
    for comp in (False, True):
        t = (ok._comp_tiles(pc._resolve_coeffs("bh7"), pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH,
                            cuda) if comp
             else ok._f32_tiles(pc._resolve_coeffs("bh7"), pw, m, cuda))

        def block(a, b, t=t):
            return lib.bhw_outer_block(t.mode, a, b, *ok._c_args(t, 0, rows), stream)

        a, b = buf[0].data_ptr(), buf[1].data_ptr()
        assert block(a, b) == 0
        torch.cuda.synchronize()
        for off in (4, 8, 12):
            assert block(a + off, b) == 1
            if comp:
                assert block(a, b + off) == 1
    assert int((buf[:, rows << m:] != 0).sum()) == 0


def test_outer_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="divisible"):
        ok.make_checksum_fn_f32("bh4", 12, m=7, rows=24, device=cuda)
    with pytest.raises(ValueError, match="coefficients"):
        ok.outer_block_f32((0.1,) * 9, 10, 5, 0, 4, device=cuda)
    with pytest.raises(ValueError, match="compensation threshold"):
        ok.make_checksum_fn_comp((0.9, 1e-7, 1e-7), 12, m=7, rows=8, device=cuda)


@pytest.mark.parametrize("win_mode,fft_mode,kernels", [
    ("float", "mxu", ("outer_block_f32", "welch_stage1")),
    ("comp", "rfft", ("outer_block_comp",)),
])
def test_analyzer_float_modes_run_the_kernels(cuda, win_mode, fft_mode, kernels):
    spec = WindowSpec(13, 17)
    nfft = spec.n
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=nfft * 9).astype(np.float32)).to(cuda)
    _build.reset_launches()
    got = sp.windowed_power_spectrum(x, "bh4", spec, win_mode=win_mode, fft_mode=fft_mode)
    for name in kernels:
        assert _build.launches[name] == 1, name
    win64 = torch.from_numpy(catalog.float_window_value("bh4", np.arange(nfft), nfft)).to(cuda)
    fr = x.unfold(0, nfft, nfft // 2).double() * win64
    ref = (torch.fft.rfft(fr, dim=-1).abs() ** 2).mean(dim=0)
    rel = float(((got.double() - ref).abs() / ref).max())
    assert rel < 32 * 2.0**-24 * np.sqrt(nfft), rel


@pytest.mark.parametrize("sin_type,rounding,name,kernel", [
    ("taylor", "hls", "blackman", "taylor_window_block"),
    ("taylor", "rtl", "hann", None),
    ("taylor2", "hls", "bh4", None),
])
def test_analyzer_taylor_sources_on_the_card(cuda, sin_type, rounding, name, kernel):
    """The quantized analyzer's window through ``kernels.window.window_block``:
    TAYLOR HLS launches the Taylor window kernel once, TAYLOR RTL and
    taylor2 run in torch ops; the spectrum matches the CPU plain path."""
    spec = WindowSpec(13, 16, sin_type=sin_type, rounding=rounding, lut_size=10)
    nfft = spec.n
    x = np.random.default_rng(6).normal(size=nfft * 9).astype(np.float32)
    _build.reset_launches()
    got = sp.windowed_power_spectrum(torch.from_numpy(x).to(cuda), name, spec).cpu()
    want = dict.fromkeys(_build.launches, 0)
    if kernel:
        want[kernel] = 1
    assert _build.launches == want
    ref = sp.windowed_power_spectrum(x, name, spec, device="cpu")
    rel = float(((got.double() - ref.double()).abs() / ref.double().abs()).max())
    assert rel < 32 * 2.0**-24 * np.sqrt(nfft), rel


# --- the TAYLOR source (csrc/taylor_kernel.cu) ---

TAYLOR_SINCOS_CASES = [  # (pw, w, ls): ROM in shared memory up to LS=14
    (14, 16, 10),  # tay1, W<19 branch
    (14, 24, 10),  # tay1, W>=19 branch (clamp)
    (12, 16, 10),  # PW-LS == 2: exact LUT
    (11, 16, 10),  # PW-LS < 2: over-wide LUT
    (26, 32, 12),  # the main path's engine size
    (26, 16, 10),
    (31, 32, 9),  # the int32 phase ceiling
    (26, 32, 14),  # 128 KB ROM: the opt-in shared-memory branch
    (20, 24, 15),  # 256 KB ROM: the read-only-cache branch
    (16, 16, 15),  # read-only cache, over-wide LUT
]


@pytest.mark.parametrize("pw,w,ls", TAYLOR_SINCOS_CASES)
def test_taylor_sincos_block_kernel_matches_plain(cuda, pw, w, ls):
    n = _spots(pw, np.random.default_rng(pw * 1000 + w * 10 + ls), min(2048, 1 << (pw - 2)))
    runs = np.split(n, np.nonzero(np.diff(n) != 1)[0] + 1)
    # a block across the period end, taken mod 2^pw
    runs.append(np.arange((1 << pw) - 100, (1 << pw) + 100))
    _build.reset_launches()
    for run in runs:
        c, s = tk.sincos_block(int(run[0]), len(run), pw, w, ls, cuda)
        pc, ps = tk.taylor_sincos_plain(torch.from_numpy(run), pw, w, ls)
        assert torch.equal(c.cpu(), pc) and torch.equal(s.cpu(), ps), (pw, w, ls, int(run[0]))
    assert _build.launches["taylor_sincos_block"] == len(runs)
    if pw <= 16:  # the whole period against the plain version on the card
        c, s = tk.sincos_block(0, 1 << pw, pw, w, ls, cuda)
        pc, ps = tk.taylor_sincos_plain(torch.arange(1 << pw, device=cuda), pw, w, ls)
        assert torch.equal(c, pc) and torch.equal(s, ps)


TAYLOR_WINDOW_CASES = [  # (coeffs or name, pw, w, ls, overflow)
    ("hamming", 12, 16, 10, "wrap"),
    ("hann", 11, 16, 10, "saturate"),  # k=1 over-wide LUT
    ("blackman", 14, 24, 10, "saturate"),
    ("blackman", 12, 16, 10, "wrap"),  # k=1 exact LUT, k=2 over-wide
    ("bh3_hls", 13, 32, 9, "wrap"),
    ("blackman", 26, 32, 12, "wrap"),  # the main path's window
    ("hamming", 26, 16, 10, "saturate"),
    ("blackman", 31, 32, 9, "saturate"),
    ("blackman", 20, 24, 15, "wrap"),  # read-only-cache ROM
    ((900_000_000, 900_000_000, 500_000_000), 12, 32, 9, "saturate"),  # W=32 clamp
    ((900_000_000, 900_000_000, 500_000_000), 12, 32, 9, "wrap"),
]


@pytest.mark.parametrize("win,pw,w,ls,overflow", TAYLOR_WINDOW_CASES)
def test_taylor_window_block_kernel_matches_plain(cuda, win, pw, w, ls, overflow):
    spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, overflow=overflow)
    q = catalog.get(win).quantized(w) if isinstance(win, str) else win
    n = _spots(pw, np.random.default_rng(pw * 100 + w + ls), min(2048, 1 << (pw - 2)))
    runs = np.split(n, np.nonzero(np.diff(n) != 1)[0] + 1)
    _build.reset_launches()
    for run in runs:
        got = tk.window_block(q, spec, int(run[0]), len(run), cuda).cpu()
        want = tk.taylor_window_plain(torch.from_numpy(run), q, spec)
        assert torch.equal(got, want), (win, pw, w, int(run[0]))
    assert _build.launches["taylor_window_block"] == len(runs)
    if pw <= 16:
        got = tk.window_block(q, spec, 0, 1 << pw, cuda)
        assert torch.equal(got, tk.taylor_window_plain(torch.arange(1 << pw, device=cuda),
                                                       q, spec))
        if isinstance(win, str):  # make_window routes through the kernel
            assert torch.equal(kw.make_window(win, spec, device=cuda), got)


#: (pw, ls) of the Taylor card sweep: every regime (over-wide and exact
#: LUT; tay1 with R = 2, 4, 16, 4096, 2^20; PW-LS = 23 and 24, where ramb_pi
#: is 0) at the int32 phase ceiling and below
TAYLOR_SWEEP = [(11, 10), (12, 10), (13, 10), (14, 10), (16, 10), (20, 8), (26, 12),
                (29, 7), (30, 7), (31, 7)]


def _sweep_ranges(pw, rng):
    """Unaligned ranges across each quadrant seam and the period end, one
    across a run boundary, one random, one aligned and a run long."""
    n = 1 << pw
    out = [((s - 301) % n, 603) for s in (0, n // 4, n // 2, 3 * n // 4)]
    out.append((n - 1000, 2013))
    out.append((int(rng.integers(0, n)), 3001))
    out.append((int(rng.integers(0, max(n >> 12, 1))) << 12, 4096 + 5))
    return out


@pytest.mark.parametrize("w", range(8, 33))
def test_taylor_kernels_sweep_every_width(cuda, w):
    # all three Taylor entries at every regime, 0 LSB against the CPU plain
    # versions (the checksum exact) on seam, run-boundary and random ranges
    wrap32 = lambda v: ((v + (1 << 31)) % (1 << 32)) - (1 << 31)  # noqa: E731
    for pw, ls in TAYLOR_SWEEP:
        rng = np.random.default_rng(pw * 100 + w)
        for n0, count in _sweep_ranges(pw, rng):
            n = torch.arange(n0, n0 + count)
            c, s = tk.sincos_block(n0, count, pw, w, ls, cuda)
            pc, ps = tk.taylor_sincos_plain(n, pw, w, ls)
            assert torch.equal(c.cpu(), pc) and torch.equal(s.cpu(), ps), (pw, ls, n0)
            got = tk.checksum_range(n0, count, pw, w, ls, -77, cuda)
            want = wrap32(int(pc.long().sum() + ps.long().sum()) - 77)
            assert int(got) == want, (pw, ls, n0, count)
        for name, overflow in (("blackman", "wrap"), ("hamming", "saturate")):
            spec = WindowSpec(pw, w, sin_type="taylor", lut_size=ls, overflow=overflow)
            if name == "blackman" and ls >= pw - 1:
                continue  # harmonic 2 runs at PW-1: LS must stay below it
            q = catalog.get(name).quantized(w)
            for n0, count in _sweep_ranges(pw, rng)[:5]:
                got = tk.window_block(q, spec, n0, count, cuda).cpu()
                want = tk.taylor_window_plain(torch.arange(n0, n0 + count), q, spec)
                assert torch.equal(got, want), (name, pw, ls, n0)


def test_taylor_window_w32_saturate_clamps(cuda):
    q = (900_000_000, 900_000_000, 500_000_000)
    sat, wrp = (WindowSpec(12, 32, sin_type="taylor", lut_size=9, overflow=o)
                for o in ("saturate", "wrap"))
    a = tk.window_block(q, sat, 0, 1 << 12, cuda)
    b = tk.window_block(q, wrp, 0, 1 << 12, cuda)
    assert int(a.max()) == (1 << 31) - 1 and not torch.equal(a, b)


@pytest.mark.parametrize("pw,w,ls,rows", [
    (14, 16, 10, 8),
    (26, 32, 12, 64),
    (26, 16, 10, 64),
    (24, 32, 14, 64),  # a 2^14-entry ROM
    (20, 24, 15, 64),  # a 2^15-entry ROM
    (31, 32, 12, 64),
])
def test_taylor_checksum_kernel_matches_plain(cuda, pw, w, ls, rows):
    fn = tk.make_checksum_fn_taylor(pw, w, ls, rows=rows, device=cuda)
    c, s = tk.sincos_block(0, 1 << pw, pw, w, ls, cuda)
    cs = c.long() + s.long()
    del c, s
    wrap32 = lambda v: ((v + (1 << 31)) % (1 << 32)) - (1 << 31)  # noqa: E731
    n0 = rows << (pw - ls - 2)
    for start, bias in ((0, 0), (0, 123457), (n0, -(1 << 31))):
        got = fn(start, bias)
        assert got.dtype == torch.int32 and got.device == cuda
        plain = tk.taylor_checksum_plain(pw, w, ls, start, bias, device=cuda)
        assert int(got) == int(plain) == wrap32(int(cs.sum()) + bias), (start, bias)
    # a full period's quadrants cancel: ranges that are not whole periods
    # check the kernel's arithmetic
    rng = np.random.default_rng(pw + w + ls)
    for start, count in ((0, (1 << pw) // 3), (int(rng.integers(1 << pw)), 100003),
                         ((1 << pw) - 5000, 10000)):
        got = tk.checksum_range(start, count, pw, w, ls, 7, cuda)
        plain = tk.taylor_checksum_plain(pw, w, ls, start, 7, device=cuda, count=count)
        idx = torch.arange(start, start + count, device=cuda) % (1 << pw)
        assert int(got) == int(plain) == wrap32(int(cs[idx].sum()) + 7), (start, count)


def test_taylor_write_out_entries_refuse_unaligned_outputs(cuda):
    # the write-outs store int4s: an output pointer off a 16-byte boundary is
    # refused (cudaErrorInvalidValue), an aligned one accepted
    pw, w, ls = 14, 16, 10
    rom, stream = tk._rom_on(ls, w, cuda), _build.stream_of(cuda)
    buf = torch.zeros(2, 4096 + 4, dtype=torch.int32, device=cuda)
    coeffs = np.asarray((1 << 14, 1 << 14), np.int64)
    lib = _build.lib()

    def sincos(c, s):
        return lib.bhw_taylor_sincos_block(c, s, 0, 4096, rom.data_ptr(), pw, w, ls,
                                           tk._ramb(pw, ls), stream)

    def window(out):
        return lib.bhw_taylor_window_block(out, 0, 4096, rom.data_ptr(), pw, w, ls,
                                           coeffs.ctypes.data, 2, tk._ramb(pw, ls), 0, 0, stream)

    a, b = buf[0].data_ptr(), buf[1].data_ptr()
    assert sincos(a, b) == 0 and window(a) == 0
    torch.cuda.synchronize()
    for off in (4, 8, 12):
        assert sincos(a + off, b) == 1 and sincos(a, b + off) == 1 and window(a + off) == 1
    assert int(buf[:, 4096:].abs().sum()) == 0


def test_taylor_torch_op_routes_launch_no_kernel(cuda):
    # TAYLOR RTL and taylor2 run window_samples on the card, as JAX runs them
    # in plain jnp; both land on the requested device
    cases = [("hamming", WindowSpec(12, 16, sin_type="taylor", rounding="rtl", lut_size=10)),
             ("bh7", WindowSpec(12, 32, sin_type="taylor2", lut_size=12, overflow="wrap"))]
    _build.reset_launches()
    for name, spec in cases:
        got = kw.make_window(name, spec, device=cuda)
        assert got.device == cuda
        assert torch.equal(got.cpu(), kw.make_window(name, spec, device="cpu"))
    assert _build.launches == dict.fromkeys(_build.launches, 0)


@pytest.mark.parametrize("sel", [1, 0])  # a known selector, an unknown one
def test_win_function_on_the_card(cuda, sel):
    spec = WindowSpec(10, 17, overflow="wrap")
    n = torch.arange(0, 1 << 10, 3, device=cuda)
    got = kw.win_function(sel, n, spec)
    assert got.device == n.device
    assert torch.equal(got.cpu(), kw.win_function(sel, n.cpu(), spec))


# --- the materialization barrier (kernel 7) and the DDC -------------------

MAT_DTYPES = [torch.int32, torch.float32, torch.float64, torch.float16, torch.int8,
              torch.bool, torch.complex64]
MAT_LENGTHS = [1, 7, 127, 32767, 32769, 100003, (1 << 20) + 3]


def _mat_data(dtype, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=g, device=device).bool()
    if not dtype.is_floating_point and not dtype.is_complex:
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, (n,), generator=g, device=device, dtype=dtype)
    return torch.randn(n, generator=g, device=device, dtype=dtype)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", MAT_DTYPES)
@pytest.mark.parametrize("n", MAT_LENGTHS)
def test_materialize_kernel_matches_plain(cuda, dtype, n):
    x = _mat_data(dtype, n, cuda, seed=n)
    _build.reset_launches()
    got = materialize(x)
    assert _build.launches["materialize"] == 1
    assert got.device == x.device and got.data_ptr() != x.data_ptr()
    torch.cuda.synchronize()
    assert _same_bits(got, materialize_plain(x)) and _same_bits(got, x)


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 3),
                                          (torch.int8, 1), (torch.int8, 5), (torch.int8, 15),
                                          (torch.float16, 1), (torch.float64, 1)])
def test_materialize_unaligned_views(cuda, dtype, offset):
    # a view such as x[1:] starts off 16-byte alignment; the kernel copies
    # the ragged head and tail apart from the vector body
    x = _mat_data(dtype, 100003, cuda, seed=offset)
    for v in (x[offset:], x[offset:-offset], x[offset:offset + 17]):
        _build.reset_launches()
        got = materialize(v)
        assert _build.launches["materialize"] == 1
        assert _same_bits(got, v) and _same_bits(got, materialize_plain(v))


#: the bulk-copy ring's stage size (csrc/barrier_kernel.cu kStageBytes)
STAGE_BYTES = 32768


@pytest.mark.parametrize("dtype", [torch.int8, torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 7])
def test_materialize_around_the_stage_size(cuda, dtype, k):
    # byte sizes k*stage - 17 .. k*stage + 17 at element offsets 0..15:
    # every split into ragged head, bulk body and ragged tail, and the
    # vector path where the offset leaves src off dst's 16-byte phase
    item = torch.empty((), dtype=dtype).element_size()
    x = _mat_data(dtype, (k * STAGE_BYTES + 17) // item + 16, cuda, seed=k)
    sizes = sorted({b // item for b in range(k * STAGE_BYTES - 17, k * STAGE_BYTES + 18)})
    _build.reset_launches()
    calls = 0
    for off in range(16):
        for m in sizes:
            v = x[off:off + m]
            got = materialize(v)
            calls += 1
            assert _same_bits(got, v), (dtype, k, off, m)
    assert _build.launches["materialize"] == calls


@pytest.mark.parametrize("offset", [0, 1, 16])
def test_materialize_ring_wraps(cuda, offset):
    # 64 MB + 17: more stages per block than the ring holds on any card of
    # up to 300 SMs, so every stage is loaded again after its store
    x = _mat_data(torch.int8, (64 << 20) + 17 + offset, cuda, seed=offset)
    v = x[offset:]
    _build.reset_launches()
    got = materialize(v)
    assert _build.launches["materialize"] == 1
    assert _same_bits(got, v)


def test_materialize_strided_input(cuda):
    base = torch.randn(6, 4099, device=cuda)
    for v in (base[:, ::3], base.T, base[1::2, 5:]):
        got = materialize(v)
        assert got.is_contiguous() and torch.equal(got, v)


@pytest.mark.parametrize("shape", [(0,), (3, 0), (0, 5, 2)])
def test_materialize_zero_size_launches_nothing(cuda, shape):
    x = torch.empty(shape, device=cuda)
    _build.reset_launches()
    got = materialize(x)
    assert _build.launches["materialize"] == 0
    assert got.shape == x.shape and got.device == x.device


@pytest.mark.parametrize("flavor", ["dds48", "scaled"])
@pytest.mark.parametrize("freq", [1 / 8, 0.2371])
def test_nco_on_the_card_matches_cpu_plain(cuda, flavor, freq):
    pw = 20
    fw = pddc.freq_word(freq, pw)
    rng = np.random.default_rng(int(freq * 1e4))
    n = np.concatenate([rng.integers(0, 1 << 31, 8192), np.arange(4096),
                        [2**31 - 1, 2**30, (1 << pw) - 1, 1 << pw]]).astype(np.int64)
    got = pddc.nco_iq(torch.from_numpy(n).to(cuda), fw, pw, 16, flavor)
    want = pddc.nco_iq(n, fw, pw, 16, flavor, device="cpu")
    for g, w in zip(got, want):
        assert g.device == cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("flavor", ["dds48", "scaled"])
def test_ddc_on_the_card_matches_cpu_plain(cuda, flavor):
    # T = 2^22: the body FIR takes the bulk branch through the barrier kernel
    t = 1 << 22
    x = np.random.default_rng(4).normal(size=t).astype(np.float32)
    h = pfir.design_lowpass(64, 0.2)
    _build.reset_launches()
    # cuDNN's TF32 default on: the FIR turns it off while it runs and
    # restores it after, and the bound below fails with TF32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = pddc.ddc(torch.from_numpy(x).to(cuda), 1 / 8, 4, taps=h, flavor=flavor)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert _build.launches["materialize"] == 1
    want = pddc.ddc(x, 1 / 8, 4, taps=h, flavor=flavor, device="cpu")
    # same mixer ints (0 LSB), two f32 64-tap FIRs: <= 2 gamma(64) sum|h| max|m|
    u = 2.0**-24
    bound = 2 * 64 * u / (1 - 64 * u) * np.abs(h.astype(np.float32)).sum() * np.abs(x).max()
    assert float((got.cpu() - want).abs().max()) <= bound


# --- the front end: the CLI's gen and WinSelector on the card ---

GEN_CASES = [  # (gen arguments, kernels the card run launches)
    (["bh7", "--phase-width", "16", "--data-width", "32", "--overflow", "wrap"],
     ("window_block",)),
    (["bh4", "--phase-width", "14", "--rounding", "rtl"], ("window_block",)),
    (["hamming", "--phase-width", "16", "--data-width", "16", "--sin-type", "taylor"],
     ("taylor_window_block",)),
    (["bh7", "--phase-width", "16", "--data-width", "32", "--mode", "outer"], ("outer_block",)),
    (["bh7", "--phase-width", "14", "--data-width", "32", "--mode", "taylor2"], ()),
    (["bh7", "--phase-width", "16", "--mode", "float"], ("outer_block_f32",)),
    (["bh7", "--phase-width", "16", "--mode", "comp"], ("outer_block_comp",)),
    (["bh4", "--phase-width", "16", "--mode", "comp-pair"], ("outer_block_comp",)),
]


@pytest.mark.parametrize("args,kernels", GEN_CASES)
def test_cli_gen_on_the_card_matches_cpu_plain(cuda, tmp_path, args, kernels):
    from blackman_harris_win_tpu_torch.__main__ import main

    f_card, f_cpu = tmp_path / "card.npy", tmp_path / "cpu.npy"
    _build.reset_launches()
    assert main(["gen", *args, "--out", str(f_card)]) == 0
    assert all(_build.launches[k] == 1 for k in kernels), _build.launches
    assert main(["gen", *args, "--out", str(f_cpu), "--device", "cpu"]) == 0
    got, want = np.load(f_card), np.load(f_cpu)
    assert got.dtype == want.dtype and got.shape == want.shape
    name = args[0]
    if "float" in args:
        assert np.abs(got.astype(np.float64) - want).max() <= ok.f32_pair_bound(name)
    elif "comp" in args or "comp-pair" in args:
        # s bit-equal, e within comp_e_bound; the folded hi rounds once more
        pair = lambda w: w[0].astype(np.float64) + w[1] if w.ndim == 2 else w  # noqa: E731
        slack = 0.0 if got.ndim == 2 else 2.0**-24
        assert np.abs(pair(got) - pair(want)).max() <= ok.comp_e_bound(name) + slack
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win_type,sin_type,rounding", [
    ("BH7TERM", "CORDIC", "hls"), ("BH4TERM", "CORDIC", "rtl"),
    ("HAMMING", "TAYLOR", "hls"), ("BH3TERM", "TAYLOR", "rtl")])
def test_win_selector_on_the_card(cuda, win_type, sin_type, rounding):
    from blackman_harris_win_tpu_torch.windows.selector import WinSelector

    sel = WinSelector(win_type, 16, 32 if win_type == "BH7TERM" else 17, sin_type=sin_type,
                      rounding=rounding, overflow="wrap")
    _build.reset_launches()
    got = sel()
    kernel = {("CORDIC", "hls"): "window_block", ("CORDIC", "rtl"): "window_block",
              ("TAYLOR", "hls"): "taylor_window_block"}.get((sin_type, rounding))
    assert got.device == cuda and got.dtype == torch.int32
    if kernel:
        assert _build.launches[kernel] == 1
    want = kw.window_samples(torch.arange(1 << 16), sel.coeffs_q, sel.spec)
    assert torch.equal(got.cpu().long(), want)
    idx = torch.tensor([0, 1, 16383, 16384, 16385, 32768, 49151, 65535])
    assert torch.equal(sel(idx.to(cuda)).cpu(), want[idx])


# --- the sharded steps (dist/) on meshes of four shards on the card ---


def _card_mesh(cuda, blocks=4, channels=1):
    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh

    return make_mesh(blocks=blocks, channels=channels, devices=[cuda] * (blocks * channels))


SHARDED_GEN = {  # case -> (window, spec, rtl coefficients, kernel)
    "cordic hls": ("bh7", WindowSpec(16, 32, overflow="wrap"), False, "window_block"),
    "cordic rtl": ("bh7", WindowSpec(16, 32, rounding="rtl", overflow="wrap"), True,
                   "window_block"),
    "taylor hls": ("blackman", WindowSpec(16, 32, sin_type="taylor", lut_size=12,
                                          overflow="wrap"), False, "taylor_window_block"),
}


@pytest.mark.parametrize("case", sorted(SHARDED_GEN))
def test_sharded_generation_on_the_card(cuda, case):
    from blackman_harris_win_tpu_torch.dist.generate import sharded_window
    from blackman_harris_win_tpu_torch.dist.mesh import unshard

    name, spec, rtl, kernel = SHARDED_GEN[case]
    q = _coeffs(name, spec.data_width, "rtl" if rtl else "hls")
    _build.reset_launches()
    s = sharded_window(q, spec, _card_mesh(cuda))
    assert _build.launches[kernel] == 4
    assert all(t.device == cuda for row in s.shards for t in row)
    want = kw.window_samples(torch.arange(spec.n), q, spec)
    assert torch.equal(unshard(s).cpu().long(), want)


def test_sharded_float_and_comp_windows_on_the_card(cuda):
    from blackman_harris_win_tpu_torch.dist.generate import (
        _float_split,
        sharded_comp_window,
        sharded_float_window,
    )
    from blackman_harris_win_tpu_torch.dist.mesh import unshard

    pw = 16
    _, m, _ = _float_split(pw, 4)
    _build.reset_launches()
    f = unshard(sharded_float_window("bh7", pw, _card_mesh(cuda))).cpu()
    s, e = (unshard(v).cpu() for v in sharded_comp_window("bh7", pw, _card_mesh(cuda)))
    assert _build.launches["outer_block_f32"] == 4 and _build.launches["outer_block_comp"] == 4
    fp = ok.outer_block_f32_plain("bh7", pw, m, 0, 1 << (pw - m), device="cpu")
    assert float((f - fp).abs().max()) <= ok.f32_pair_bound("bh7")
    sp, ep = ok.outer_block_comp_plain("bh7", pw, m, pc.GRID_BITS, pc.DEFAULT_THRESH, 0,
                                       1 << (pw - m), device="cpu")
    assert torch.equal(s, sp) and float((e - ep).abs().max()) <= ok.comp_e_bound("bh7")


@pytest.mark.parametrize("win_mode,fft_mode", [("quantized", "rfft"), ("quantized", "mxu"),
                                               ("float", "mxu"), ("comp", "rfft")])
def test_sharded_welch_on_the_card(cuda, win_mode, fft_mode):
    from blackman_harris_win_tpu_torch.dist.mesh import unshard

    spec = WindowSpec(10, 17, overflow="saturate")
    nfft, hop = spec.n, spec.n // 2
    d = catalog.get("bh4")
    coeffs = d.quantized(17) if win_mode == "quantized" else "bh4"
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 16 * nfft)).astype(np.float32))
    _build.reset_launches()
    got = unshard(sp.make_sharded_welch(_card_mesh(cuda, 2, 2), spec, coeffs, d.shift, nfft, hop,
                                        win_mode=win_mode, fft_mode=fft_mode)(x.to(cuda))).cpu()
    kernel = {"quantized": "window_block", "float": "outer_block_f32",
              "comp": "outer_block_comp"}[win_mode]
    assert _build.launches[kernel] == 4 and _build.launches["welch_stage1"] == 0
    xe = torch.cat([x, x[:, :nfft - hop]], dim=-1)
    want = sp.windowed_power_spectrum(xe, coeffs, spec, hop=hop, win_mode=win_mode,
                                      fft_mode=fft_mode, device="cpu")
    budget = 32 * 2.0**-24 * np.sqrt(nfft)
    assert float(((got.double() - want.double()) / want.double()).abs().max()) < budget


@pytest.mark.parametrize("flavor", ["dds48", "scaled"])
def test_sharded_ddc_on_the_card(cuda, flavor):
    from blackman_harris_win_tpu_torch.dist.mesh import unshard

    t = 1 << 16
    x = np.random.default_rng(5).normal(size=t).astype(np.float32)
    h = pfir.design_lowpass(64, 0.2)
    step = pddc.make_sharded_ddc(_card_mesh(cuda), 20, 16, 1 / 8, 4, taps=h, flavor=flavor)
    got = unshard(step(torch.from_numpy(x).to(cuda))).cpu()
    want = pddc.ddc(x, 1 / 8, 4, taps=h, flavor=flavor, device="cpu")
    # the same mixer ints on both sides (the NCO is 0 LSB on the card), two
    # f32 64-tap FIRs: <= 2 gamma(64) sum|h| max|m|
    u = 2.0**-24
    bound = 2 * 64 * u / (1 - 64 * u) * np.abs(h.astype(np.float32)).sum() * np.abs(x).max()
    assert got.shape == want.shape and float((got - want).abs().max()) <= bound
    # each shard's mixer ints at its seam, against the CPU plain NCO
    fw, b, halo = pddc.freq_word(1 / 8, 20), t // 4, 60
    for i in range(4):
        first = i * b - halo - 16
        idx = np.arange(first, first + 64) % t
        gi, gq = pddc.shard_mixer_ints(torch.from_numpy(x[idx]).to(cuda), first, t, fw, 20, 16,
                                       flavor)
        xq = torch.round(torch.from_numpy(x[idx]) * ((1 << pddc.MIX_IN_BITS) - 1)).to(torch.int32)
        wi, wq = pddc.mix_iq_int(xq, torch.from_numpy(idx), fw, 20, 16, flavor, device="cpu")
        assert torch.equal(gi.cpu(), wi) and torch.equal(gq.cpu(), wq)


def test_sharded_steps_over_distinct_cards(cuda):
    """Where torch sees several cards: generation, the Welch halo + pmean,
    the DDC and the WOLA round trip on a mesh over distinct cards, each
    shard on its own card, against the single-device results (halos and
    reductions cross cards by peer copies)."""
    from blackman_harris_win_tpu_torch.dist.generate import sharded_window
    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh, unshard
    from blackman_harris_win_tpu_torch.pipeline import stft as pstft

    ncards = torch.cuda.device_count()
    if ncards < 2:
        pytest.skip(f"needs two or more cards; torch sees {ncards}")
    k = 4 if ncards >= 4 else 2
    mesh = make_mesh(blocks=k)
    cards = [d for row in mesh.devices for d in row]
    assert len(set(cards)) == k and all(d.type == "cuda" for d in cards)
    spec = WindowSpec(16, 32, overflow="wrap")
    q = catalog.get("bh7").quantized(32)
    s = sharded_window(q, spec, mesh)
    assert [t.device for t in s.row()] == cards
    assert torch.equal(unshard(s).cpu().long(), kw.window_samples(torch.arange(spec.n), q, spec))

    wspec = WindowSpec(10, 17, overflow="saturate")
    nfft, hop = wspec.n, wspec.n // 2
    d = catalog.get("bh4")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 8 * k * nfft)).astype(np.float32))
    got = unshard(sp.make_sharded_welch(mesh, wspec, d.quantized(17), d.shift, nfft, hop)(
        x.to(cuda))).cpu()
    want = sp.windowed_power_spectrum(torch.cat([x, x[:, :nfft - hop]], dim=-1), "bh4", wspec,
                                      hop=hop, device="cpu")
    assert float(((got.double() - want.double()) / want.double()).abs().max()) < (
        32 * 2.0**-24 * np.sqrt(nfft))

    fwd = pstft.make_sharded_stft(mesh, wspec, d.quantized(17), d.shift, nfft, hop)
    inv = pstft.make_sharded_istft(mesh, wspec, d.quantized(17), d.shift, nfft, hop)
    frames = fwd(x.to(cuda))
    assert [t.device for t in frames.row()] == cards
    assert float((unshard(inv(frames)).cpu() - x).abs().max()) < 2e-5

    t = k << 14
    xd = np.random.default_rng(9).normal(size=t).astype(np.float32)
    h = pfir.design_lowpass(64, 0.2)
    got = unshard(pddc.make_sharded_ddc(mesh, 20, 16, 1 / 8, 4, taps=h)(
        torch.from_numpy(xd).to(cuda))).cpu()
    want = pddc.ddc(xd, 1 / 8, 4, taps=h, device="cpu")
    u = 2.0**-24
    bound = 2 * 64 * u / (1 - 64 * u) * np.abs(h.astype(np.float32)).sum() * np.abs(xd).max()
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_steps_across_processes_on_cards(cuda, tmp_path, backend):
    """``tests/torch_multiproc_child.py`` on the cards: with gloo, two
    processes on card 0 (card tensors staged through the host); with nccl,
    one process a card (needs two or more).  Every process's shards of
    generation, the Welch analyzer, the STFT/WOLA pair and the channel psum,
    on mesh A (channels=1) and mesh B (channels=2), bit-equal to the same
    steps on a one-process mesh of the same devices."""
    import torch_multiproc_child as child

    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh

    ncards = torch.cuda.device_count()
    if backend == "nccl" and ncards < 2:
        pytest.skip(f"nccl takes one card a process; torch sees {ncards}")
    nprocs = min(ncards, 8) if backend == "nccl" else 2
    while 8 % nprocs:
        nprocs -= 1
    per, device = 8 // nprocs, "own" if backend == "nccl" else "card0"
    results = child.spawn(nprocs, per, tmp_path, backend, device, timeout=300)
    devs = [d for r in range(nprocs) for d in child.local_devices(device, r, per)]
    for label, channels in (("a", 1), ("b", 2)):
        one = child.steps(make_mesh(blocks=8 // channels, channels=channels, devices=devs))
        for r in results:
            for name, s in one.items():
                held = {k: t for k, t in r["tensors"].items()
                        if k.startswith(f"{label}/{name}/")}
                assert len(held) == per
                for key, t in held.items():
                    c, b = (int(v) for v in key.rsplit("/", 1)[1].split(","))
                    assert torch.equal(t, s.shards[c][b].cpu()), key
