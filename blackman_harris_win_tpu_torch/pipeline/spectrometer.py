"""The PFB spectrometer of a radio telescope's F-engine: a polyphase filter
bank over each digitizer input, then each channel's power integrated over
many spectra.  The JAX package has no counterpart.

A call takes the ADC streams of many inputs (feeds) at once:

- the branch FIRs, ``kernels.polyphase_kernel.branch_fir``: every feed in
  one launch of the polyphase kernel on a card (int8 ADC words taken as
  float32, exactly), the plain grouped ``conv1d`` on the CPU;
- the DFT across the branches, ``torch.fft.rfft`` for a real stream (the
  half spectrum, C//2 + 1 bins, the Nyquist bin kept), ``torch.fft.fft``
  for a complex one;
- the integration: the bins viewed, with no copy, as (..., n_int, n_acc,
  K), and the mean of |Y|^2 over each integration's n_acc spectra,
  ``kernels.welchpower_kernel.frame_power_mean`` (on a card one launch,
  summing in float64).

Under a profiler session the call is the span ``bhw.pfb``, with the stages
``bhw.pfb.branches``, ``bhw.pfb.dft`` and ``bhw.pfb.power`` (``_trace``;
the plain power mean adds ``bhw.pfb.mean``).  TF32 stays off: the plain
branch FIRs run in full fp32, and nothing else is a matmul.
"""

from __future__ import annotations

import torch

from .. import _build, _trace
from ..kernels.polyphase_kernel import branch_fir, check_prototype
from ..kernels.welchpower_kernel import frame_power_mean


def integrations(n_samples: int, n_channels: int, taps_per_branch: int, n_acc: int) -> int:
    """The integrations in a stream of ``n_samples``: its valid frames,
    n_samples // C - taps_per_branch + 1, over ``n_acc``; raises unless the
    stream is a whole number of frames and its valid frames a positive
    whole number of integrations."""
    if n_acc < 1:
        raise ValueError(f"n_acc must be at least 1, got {n_acc}")
    if n_samples % n_channels:
        raise ValueError("input length must be a multiple of n_channels")
    valid = n_samples // n_channels - taps_per_branch + 1
    if valid < n_acc or valid % n_acc:
        raise ValueError(f"{max(valid, 0)} valid frames are no whole number of integrations "
                         f"of {n_acc} spectra")
    return valid // n_acc


def pfb_power(x, prototype, n_channels: int, n_acc: int, device=None):
    """Integrated channel power: x (..., T) -> (..., n_int, C//2 + 1) float
    for a real stream ((..., n_int, C) for a complex one), the leading dims
    feeds, n_int = (T // C - tpb + 1) // n_acc (:func:`integrations`, which
    raises unless it is whole).  Integration i of bin k is the mean of
    |Y[m, k]|^2 over the valid frames m of i n_acc .. (i + 1) n_acc - 1.

    A tensor ``x`` runs on its device; array-like input goes to ``device``
    (default the card).  int8 ADC words are taken as float32, so the output
    is float32 (float64 for a float64 stream)."""
    x = _build.as_tensor(x, device=device)
    h, tpb = check_prototype(prototype, n_channels)
    n_int = integrations(x.shape[-1], n_channels, tpb, n_acc)
    with _trace.span("bhw.pfb"):
        with _trace.span("bhw.pfb.branches", x.device):
            v = branch_fir(x, h, n_channels)
        with _trace.span("bhw.pfb.dft", x.device):
            y = torch.fft.fft(v, dim=-1) if v.is_complex() else torch.fft.rfft(v, dim=-1)
        spec = y.view(y.shape[:-2] + (n_int, n_acc, y.shape[-1]))
        return frame_power_mean(spec, span="bhw.pfb")
