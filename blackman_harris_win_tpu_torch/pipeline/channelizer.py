"""Polyphase DFT filter-bank channelizer, critically sampled (counterpart
of ``blackman_harris_win_tpu/pipeline/channelizer.py``).

Splits a wideband stream into C uniformly spaced channels, each decimated by
C:

- the polyphase decomposition and the C branch FIRs are
  ``kernels.polyphase_kernel.branch_fir``: on a card one launch of the
  polyphase kernel, which reads the stream in place, on the CPU its plain
  version (a reshape and one grouped ``conv1d``, in full fp32); int8 ADC
  words are taken as float32 on both;
- the cross-branch DFT is ``torch.fft.fft`` along the branch axis; the SDR
  chain takes a real stream's half spectrum (``torch.fft.rfft``,
  :func:`channel_bins`), which its discriminator kernel reads in place;
- on a card, where ``polyphase_kernel.route`` finds that
  ``polyphase_kernel.fuses_dft`` admits the input
  (complex64, C = 128, at most 16 taps a branch), both are one launch,
  ``polyphase_kernel.branch_dft``: the DFT runs inside the branch kernel
  and its bins are the kernel's output.

Channel k of frame m:  Y[m, k] = sum_p e^{-j 2 pi p k / C} *
(sum_t h_p[t] x[(m - t) C + p])  (h_p[t] = h[t C + p]); a tone at +k/C of
fs lands in channel k.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, _trace
from ..kernels.polyphase_kernel import branch_dft, branch_fir, route
from .fir import design_lowpass


def design_prototype(
    n_channels: int,
    taps_per_branch: int,
    window: str = "bh4",
    data_width: int = 24,
    cutoff_scale: float = 1.0,
) -> np.ndarray:
    """Prototype lowpass for a C-channel bank: cutoff 1/C of Nyquist
    (scaled), length C * taps_per_branch, designed with the quantized
    windows."""
    n_taps = n_channels * taps_per_branch
    return design_lowpass(
        n_taps, cutoff_scale / n_channels, window=window, data_width=data_width
    )


def polyphase_channelize(x, prototype, n_channels: int, device=None):
    """x: (..., T) real/complex -> (..., n_frames, n_channels) complex.

    A tensor ``x`` runs on its device; array-like input goes to ``device``
    (default the card).  T must be a multiple of n_channels; n_frames =
    T // C - (taps_per_branch - 1) (valid region).  Output channel k is
    centered at f = k/C * fs.
    """
    # DFT across branches (e^{-j 2 pi p k / C}) so channel k sits at +k/C
    x = _build.as_tensor(x, device=device)
    h, fused = route(x, prototype, n_channels)
    if fused:
        return branch_dft(x, h, n_channels)
    return torch.fft.fft(branch_fir(x, h, n_channels), dim=-1)


def channel_bins(x, prototype, n_channels: int, device=None):
    """The channelizer's output as the SDR chain's discriminator reads it:
    for a real stream the half spectrum ``torch.fft.rfft`` gives, (...,
    n_frames, C//2 + 1), whose channel k > C/2 is the conjugate of bin C - k
    (:func:`full_spectrum`); for a complex stream :func:`polyphase_channelize`'s
    (..., n_frames, C).  The half spectrum spares the full one's conjugate
    fill, which is a pass of its own over the output.

    Under a profiler session its stages are the spans ``bhw.sdr.branches``
    (the commutator and the branch FIRs: on a card one launch of the
    polyphase kernel) and ``bhw.sdr.dft`` (the DFT across the branches)
    (``_trace``); where the card runs both as one launch
    (``polyphase_kernel.branch_dft``), that launch is ``bhw.sdr.branches``
    and there is no ``bhw.sdr.dft``."""
    x = _build.as_tensor(x, device=device)
    h, fused = route(x, prototype, n_channels)
    with _trace.span("bhw.sdr.branches", x.device):
        y = (branch_dft if fused else branch_fir)(x, h, n_channels)
    if fused:
        return y
    with _trace.span("bhw.sdr.dft", x.device):
        return torch.fft.fft(y, dim=-1) if y.is_complex() else torch.fft.rfft(y, dim=-1)


def full_spectrum(y, n_channels: int):
    """The (..., n_frames, C) spectrum of :func:`channel_bins`' output: a
    half spectrum with the conjugates of bins C - k as channels k > C/2,
    the fill ``torch.fft.fft`` of a real input makes; a full one as it is."""
    if y.shape[-1] == n_channels:
        return y
    return torch.cat([y, y[..., 1:(n_channels - 1) // 2 + 1].flip(-1).conj()], dim=-1)
