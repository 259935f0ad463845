"""Fixed-point integer primitives (counterpart of
``blackman_harris_win_tpu/core/fixedpoint.py``), on Python ints and torch
int64 tensors.

- two's-complement wrap to an arbitrary register width (``ap_int<N>``
  assignment, ``hls/windows/win_function.h:60-62``);
- round-half-up off bit 0: ``(v >> 1) + v(0)`` (``src/bh_win_3term.vhd:264-280``);
- round-half-up off bit 1: ``(v >> 2) + v(1)`` (``src/bh_win_3term.vhd:295-306``);
- saturation to the signed range (``src/tay1_order.vhd:601-617``);
- the outer-product mode's exact multiply-subtract-shift ``mulsub_shift30``;
- coefficient quantization ``round(a * (2^(W-shift) - 1))``
  (``hls/windows/win_function.cpp:176-177, 349-355``).

torch's ``>>`` on int64 is an arithmetic shift and ``<<`` wraps mod 2^64,
which is what the sign-extending wrap below relies on.
"""

from __future__ import annotations

import torch


def wrap(v, width: int):
    """Two's-complement wrap of ``v`` to ``width`` bits: a Python int, or an
    int64 tensor whose values become the sign-extended low ``width`` bits."""
    if isinstance(v, int):
        m = v & ((1 << width) - 1)
        return m - (1 << width) if m >> (width - 1) else m
    if v.dtype != torch.int64:
        raise TypeError(f"wrap needs an int64 tensor, got {v.dtype}")
    if width > 64:
        raise ValueError(f"cannot wrap to {width} bits in a 64-bit lane")
    s = 64 - width
    return (v << s) >> s if s else v


def round_half_up_bit0(v):
    """Round off the LSB, half rounds up: ``(v >> 1) + v(0)``."""
    return (v >> 1) + (v & 1)


def round_half_up_bit1(v):
    """Round off the two LSBs keeping bit 1 as the round bit:
    ``(v >> 2) + v(1)``."""
    return (v >> 2) + ((v >> 1) & 1)


def saturate(v, width: int):
    """Clamp to the signed ``width``-bit range."""
    hi = (1 << (width - 1)) - 1
    lo = -(1 << (width - 1))
    if isinstance(v, int):
        return max(lo, min(hi, v))
    return torch.clamp(v, lo, hi)


def mulsub_shift30(a, c, b, d, round: bool = False, shift: int = 30):
    """Exact ``(a*c - b*d) >> shift``, round-half-up with ``round=True``
    (``(v + 2^(shift-1)) >> shift``), for |inputs| < 2^30 and shift in
    {30, 31}: the semantics of the JAX package's ``limb.mulsub_shift30``,
    computed in one int64 lane (|a*c - b*d| < 2^61) instead of its 15-bit
    limbs.  Python ints or integer tensors (taken as int64)."""
    if shift not in (30, 31):
        raise ValueError("mulsub_shift30 supports shift in {30, 31}")
    ops = []
    for v in (a, c, b, d):
        if isinstance(v, torch.Tensor):
            v = v.to(torch.int64)
            big = v.numel() and int(v.abs().max()) >= 1 << 30
        else:
            big = abs(int(v)) >= 1 << 30
        if big:
            raise ValueError("mulsub_shift30 needs |inputs| < 2^30")
        ops.append(v)
    a, c, b, d = ops
    v = a * c - b * d
    if round:
        v = v + (1 << (shift - 1))
    return v >> shift


def quantize_coeff(a: float, width: int, shift: int) -> int:
    """Quantize a float window coefficient: ``round(a * (2^(width-shift) - 1))``
    (``shift=1`` for 2/3/4-term windows, ``shift=2`` for 5/7-term)."""
    return int(round(a * (2.0 ** (width - shift) - 1.0)))


def quantize_coeffs(coeffs, width: int, shift: int) -> tuple[int, ...]:
    return tuple(quantize_coeff(a, width, shift) for a in coeffs)
