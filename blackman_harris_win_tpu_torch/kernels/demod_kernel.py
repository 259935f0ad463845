"""The vectoring CORDIC atan2 and the FM discriminators as CUDA kernels:
binding of ``csrc/demod_kernel.cu``.

One device function computes what ``kernels/cordic.py:_atan2_core`` does,
bit for bit (the quadrant from bit input_width-1, the one's-complement abs
of the low AW-1 bits, AW-1 iterations on an AW+P bit wrapping state, the
z steps ``LUT_ATAN_PI[i] >> (49-AW-P)``, ``wrap(z >> P, AW)``), in 32-bit
words while AW+P <= 32 and in 64-bit words up to AW+P = 49.  Three entry
points use it:

- :func:`atan2`: elementwise ``cordic_atan2`` / ``atan2_fixed`` on int32 or
  int64 (y, x), int64 out (counter ``cordic_atan2``);
- :func:`fm_demod`: ``fm_demod_conj`` / ``fm_demod_phase`` from integer
  I/Q (..., T) to (..., T-1) int64, the inputs read in place at their
  strides, each angle or re-quantized sample computed once, the output in
  the inputs' stride order (:func:`walk_of`; counter ``fm_demod``);
- :func:`iq_demod`: ``sdr_chain``'s discriminator from the complex
  channelizer output (..., nf, C), or its half spectrum (..., nf, C//2 + 1)
  for a real stream: the quantizer ``round(y * iq_scale)`` to int32 and
  ``fm_demod_conj`` in one pass, (..., nf-1, C) int64 out (counter
  ``fm_demod``).

They replace the jnp of ``blackman_harris_win_tpu/kernels/cordic.py:275-360``
and ``pipeline/demod.py:30-57`` (no ``pallas_call``).  Each takes CUDA
tensors only and raises for anything else; the dispatch between a kernel
and its plain version in torch ops is by the device the input lies on, in
``kernels/cordic.py`` (``cordic_atan2``, ``atan2_fixed``),
``pipeline/demod.py`` and ``pipeline/sdr.py:sdr_chain``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..core.luts import LUT_ATAN_PI

#: the quadrant conventions, in the order of their codes in the source
CONVENTIONS = ("cordic", "fixed")
#: the discriminators, in the order of their codes in the source
MODES = ("conj", "phase")
#: the integer discriminator's walks, in the order of their codes in the
#: source: lanes on consecutive samples t, or on consecutive rows
WALKS = ("t", "rows")
#: the widest state the kernel holds: AW + P <= 49 (the LUT's 2^48 scale)
MAX_STATE_WIDTH = 49
#: the width of the quantized channel I/Q ``sdr_chain`` discriminates
IQ_WIDTH = 16


def atan2_lut(angle_width: int, precision: int) -> np.ndarray:
    """The AW-1 z steps of the datapath, LUT_ATAN_PI[i] >> (49 - AW - P)."""
    aw, p = angle_width, precision
    return np.asarray([LUT_ATAN_PI[i] >> (49 - aw - p) for i in range(aw - 1)], np.int64)


def conj_shifts(input_width: int, angle_width: int) -> tuple[int, int]:
    """``fm_demod_conj``'s (drop, shift): the inputs are re-quantized by
    >> drop to at most 15 bits, and the products by >> shift into the
    engine's AW-1 bit range."""
    drop = max(0, input_width - 15)
    return drop, max(0, 2 * (input_width - drop) - (angle_width - 1))


def seam_words(input_width: int, angle_width: int, rng: np.random.Generator,
               count: int) -> tuple[np.ndarray, np.ndarray]:
    """(y, x) int64 inputs that hold the atan2 to its seams: ``count``
    random input_width-bit words, then every pair of x or y in {0, +-1},
    the masked abs 2^(AW-1)-1 (of either sign), and bit input_width-1 set
    over small low parts."""
    lo, hi = -(1 << (input_width - 1)), (1 << (input_width - 1)) - 1
    top = (1 << (angle_width - 1)) - 1
    special = np.array([0, 1, -1, top, -top - 1, ~top, lo, hi, lo + 1, lo + 5, 7, -7], np.int64)
    special = special[(special >= lo) & (special <= hi)]
    yy, xx = np.meshgrid(special, special)
    return (np.concatenate([rng.integers(lo, hi + 1, count), yy.ravel()]),
            np.concatenate([rng.integers(lo, hi + 1, count), xx.ravel()]))


def _check_widths(angle_width: int, precision: int, input_width: int) -> None:
    if angle_width < 2 or precision < 0 or angle_width + precision > MAX_STATE_WIDTH:
        raise ValueError(f"the atan2 kernel takes AW >= 2, P >= 0, AW + P <= {MAX_STATE_WIDTH}")
    if not 1 <= input_width <= 64:
        raise ValueError("the atan2 kernel takes input_width 1..64")


def _card_device(*ts) -> torch.device:
    for t in ts:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("the demod kernels take CUDA tensors")
    if len({t.device for t in ts}) > 1:
        raise ValueError("the demod kernels take tensors on one card")
    return ts[0].device


def _int_pair(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both int32 or both int64, as read in place; anything else to int64
    (the plain versions' conversion)."""
    if a.dtype == b.dtype and a.dtype in (torch.int32, torch.int64):
        return a, b
    return a.to(torch.int64), b.to(torch.int64)


def atan2(y: torch.Tensor, x: torch.Tensor, input_width: int, angle_width: int,
          precision: int = 1, convention: str = "cordic") -> torch.Tensor:
    """``cordic_atan2`` (convention "cordic") or ``atan2_fixed`` ("fixed")
    of CUDA tensors (broadcast together), as int64."""
    dev = _card_device(y, x)
    _check_widths(angle_width, precision, input_width)
    if convention not in CONVENTIONS:
        raise ValueError(f"convention must be one of {CONVENTIONS}")
    y, x = _int_pair(*torch.broadcast_tensors(y, x))
    y, x = y.contiguous(), x.contiguous()
    out = torch.empty(y.shape, dtype=torch.int64, device=dev)
    if out.numel():
        lut = atan2_lut(angle_width, precision)
        _build.launch("cordic_atan2", dev, out.data_ptr(), y.data_ptr(), x.data_ptr(),
                      out.numel(), y.element_size(), lut.ctypes.data, angle_width, precision,
                      input_width, CONVENTIONS.index(convention))
    return out


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(..., T) as (rows, T), a view where the strides allow one."""
    return t.reshape(1, -1) if t.dim() == 1 else t.reshape(-1, t.shape[-1])


def walk_of(rows: int, i_strides: tuple[int, int], q_strides: tuple[int, int]) -> str:
    """The integer discriminator's walk for (rows, T) I/Q at these element
    strides: "rows" (lanes on consecutive rows, the output (T-1, rows) in
    memory) where the row stride is the shorter non-zero one, as in the
    transpose of a (T, C) channel bank; else "t" (lanes on consecutive
    samples, the output (rows, T-1)).  I's strides decide, or Q's where I
    is broadcast across the rows."""
    ir, it = i_strides if i_strides[0] else q_strides
    return "rows" if rows > 1 and 0 < ir < it else "t"


def demod_output(shape: tuple[int, ...], walk: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(memory the kernel writes, the (..., T-1) int64 output): for the
    "rows" walk a contiguous (T-1, rows) and its transpose as ``shape``,
    else one contiguous tensor."""
    if walk == "rows":
        mem = torch.empty((shape[-1], math.prod(shape[:-1])), dtype=torch.int64, device=device)
        return mem, mem.t().view(shape)
    out = torch.empty(shape, dtype=torch.int64, device=device)
    return out, out


def fm_demod(i: torch.Tensor, q: torch.Tensor, input_width: int, angle_width: int = 24,
             mode: str = "conj") -> torch.Tensor:
    """``fm_demod_conj`` (mode "conj") or ``fm_demod_phase`` ("phase") of
    integer I/Q CUDA tensors (..., T), as (..., T-1) int64: contiguous, or
    for I/Q whose rows are the shorter stride (:func:`walk_of`) the
    transpose of a contiguous (T-1, rows), as torch's elementwise ops lay
    out the plain version's."""
    dev = _card_device(i, q)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    _check_widths(angle_width, 1, input_width)
    i, q = _int_pair(*torch.broadcast_tensors(i, q))
    if not i.dim():
        raise ValueError("the demod kernels take I/Q (..., T)")
    t = i.shape[-1]
    shape = (*i.shape[:-1], max(t - 1, 0))
    if not math.prod(shape):
        return torch.empty(shape, dtype=torch.int64, device=dev)
    i2, q2 = _rows(i), _rows(q)
    rows = i2.shape[0]
    walk = walk_of(rows, i2.stride(), q2.stride())
    mem, out = demod_output(shape, walk, dev)
    drop, shift = conj_shifts(input_width, angle_width) if mode == "conj" else (0, 0)
    lut = atan2_lut(angle_width, 1)
    _build.launch("fm_demod", dev, mem.data_ptr(), i2.data_ptr(), q2.data_ptr(), rows, t,
                  *i2.stride(), *q2.stride(), i2.element_size(), MODES.index(mode),
                  lut.ctypes.data, angle_width, input_width, drop, shift, WALKS.index(walk))
    return out


def iq_demod(y: torch.Tensor, angle_width: int = 20, iq_scale: float = 2.0**14,
             n_channels: int | None = None) -> torch.Tensor:
    """``sdr_chain``'s discriminator of a complex64/complex128 CUDA tensor
    (..., nf, bins): I/Q = round(y * iq_scale) as int32, then
    ``fm_demod_conj`` at IQ_WIDTH over the frames of each channel, as
    (..., nf-1, C) int64.  ``bins`` is C (``n_channels``, by default the last
    dimension: the full spectrum) or C // 2 + 1, the half spectrum of a real
    stream (``torch.fft.rfft``), whose channels k > C / 2 the kernel reads as
    the conjugates of bins C - k.  A product past the int32 range has no
    defined plain value (torch's float-to-int32 cast); the kernel saturates
    it."""
    dev = _card_device(y)
    if y.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"the I/Q discriminator takes complex64 or complex128, got {y.dtype}")
    if y.dim() < 2:
        raise ValueError("the I/Q discriminator takes (..., n_frames, n_channels)")
    _check_widths(angle_width, 1, angle_width)
    nf, bins = y.shape[-2], y.shape[-1]
    c = bins if n_channels is None else int(n_channels)
    if bins not in (c, c // 2 + 1):
        raise ValueError(f"{bins} bins a frame is neither the {c} channels nor their half "
                         f"spectrum ({c // 2 + 1})")
    out = torch.empty((*y.shape[:-2], max(nf - 1, 0), c), dtype=torch.int64, device=dev)
    if not out.numel():
        return out
    src = y.resolve_conj().contiguous()
    drop, shift = conj_shifts(IQ_WIDTH, angle_width)
    lut = atan2_lut(angle_width, 1)
    _build.launch("fm_demod", dev, out.data_ptr(), src.data_ptr(), src.numel() // (nf * bins),
                  nf, c, bins, src.element_size(), float(iq_scale), lut.ctypes.data,
                  angle_width, drop, shift, entry="fm_demod_iq")
    return out
