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
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.kernels import window_kernel as wk
from blackman_harris_win_tpu_torch.kernels.welchfft_kernel import (
    welch_stage1_fused,
    welch_stage1_plain,
)
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
    want = wk.window_checksum_plain(q, spec, n_start, count, bias=12345)
    assert int(got) == int(want)


@pytest.mark.parametrize("nfft,nframes", [(1 << 13, 5), (1 << 13, 4),
                                          (1 << 14, 7), (1 << 19, 3)])
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
