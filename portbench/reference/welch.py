"""The Welch power spectrum in float64, and its control in TF32.

``welch64``: mean over frames of |rfft(frame * window)|^2, every step in
float64 (after ``chip_smoke.py``'s ``_f64_welch``), frames in blocks so
that it fits beside the captures.

``welch_tf32``: the same in float32 with the windowed frames rounded to
TF32 (10 mantissa bits, round to nearest even), the operands a TF32 matmul
DFT would take: the control, one precision step below the float32 with
TF32 off that the analyzer states.
"""

from __future__ import annotations

import torch


def _frames(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    return x.unfold(-1, nfft, hop)


def welch64(x: torch.Tensor, win64: torch.Tensor, nfft: int, hop: int, block: int = 16):
    fr = _frames(x, nfft, hop)
    acc = torch.zeros(nfft // 2 + 1, dtype=torch.float64, device=x.device)
    for a in range(0, fr.shape[0], block):
        spec = torch.fft.rfft(fr[a:a + block].double() * win64, dim=-1)
        acc += (spec.real ** 2 + spec.imag ** 2).sum(dim=0)
    return acc / fr.shape[0]


def to_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest even."""
    b = v.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def welch_tf32(x: torch.Tensor, win64: torch.Tensor, nfft: int, hop: int, block: int = 16):
    fr = _frames(x, nfft, hop)
    win = win64.to(torch.float32)
    acc = torch.zeros(nfft // 2 + 1, dtype=torch.float32, device=x.device)
    for a in range(0, fr.shape[0], block):
        spec = torch.fft.rfft(to_tf32(fr[a:a + block] * win), dim=-1)
        acc += (spec.abs() ** 2).sum(dim=0)
    return acc / fr.shape[0]
