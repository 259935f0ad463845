"""The DDC's front half as one CUDA kernel: binding of ``csrc/ddc_kernel.cu``.

The kernel quantizes an f32 stream (..., T) to MIX_IN_BITS, runs the
pre-rotated CORDIC NCO (dds48 or scaled) at the closed-form phase
((n mod 2^32) * fw) mod 2^PW of each global index n, mixes in int32 and
rescales once to f32, writing the (2, ..., T) mixer output that
``pipeline/fir.py:decimating_fir`` takes; the raw entry writes the int32
(I, Q) products instead.  It replaces the jnp of
``blackman_harris_win_tpu/pipeline/ddc.py:49-80`` (no ``pallas_call``).

:func:`mixer` takes CUDA tensors only and raises for anything else; the
dispatch between it and the plain version (``nco_iq`` / ``mix_iq_int`` in
torch ops) is ``pipeline/ddc.py:mixer``, by the device the input lies on.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.luts import GAIN48_QUARTER, LUT_ATAN_2PI, scaled_internal_width

#: NCO flavors, in the order of their codes in ``csrc/ddc_kernel.cu``
FLAVORS = ("dds48", "scaled")
#: input quantization of the integer mixer (ADC-like front end)
MIX_IN_BITS = 15
#: the phase widths the kernel takes: its phase product is 32-bit
MAX_PHASE_WIDTH = 31


def check_mixer_width(data_width: int) -> None:
    """The mixer's product needs MIX_IN_BITS + (W-2) + 1 bits and must fit
    an int32 lane: data_width <= 17."""
    if MIX_IN_BITS + (data_width - 2) + 1 > 31:
        raise ValueError(
            f"mixer product needs {MIX_IN_BITS + data_width - 1} bits; "
            f"use data_width <= {31 - MIX_IN_BITS + 1} for int32 lanes"
        )


def mixer_scale(data_width: int) -> float:
    """The single rescale of the mixer ints to f32: float32(1 / (amp_in *
    2^(W-2))), amp_in = 2^MIX_IN_BITS - 1."""
    return float(np.float32(1.0 / (((1 << MIX_IN_BITS) - 1) * (1 << (data_width - 2)))))


def mixer_constants(phase_width: int, data_width: int, flavor: str):
    """The flavor's datapath constants at (PW, W), as ``kernels/cordic.py``
    derives them: (z steps lut[0..W-2], seed gain, init_z shift, output
    shift).  dds48: 48-bit x/y/z; scaled: SEL_SIZE-bit x/y, max(SIZE, PW)-bit
    z."""
    pw, w = phase_width, data_width
    if flavor == "dds48":
        return np.asarray(LUT_ATAN_2PI[: w - 1], np.int64), GAIN48_QUARTER, 48 - pw, 48 - w
    if flavor == "scaled":
        size = scaled_internal_width(w)
        dwph = max(size, pw)
        lut = np.asarray([LUT_ATAN_2PI[i] >> (48 - dwph) for i in range(w - 1)], np.int64)
        return lut, GAIN48_QUARTER >> (48 - size), max(size - pw, 0), size - w
    raise ValueError("NCO flavor must be 'dds48' or 'scaled'")


def mixer(x: torch.Tensor, fw: int, phase_width: int, data_width: int, flavor: str = "dds48",
          n0: int = 0, period: int = 0, raw: bool = False) -> torch.Tensor:
    """Launch the kernel on a CUDA float32 tensor ``x`` (..., T): the
    (2, ..., T) mixer output as float32, or with ``raw`` the int32 (I, Q)
    products.  ``n0`` is the global index of x[..., 0]; an index below 0
    takes ``+ period``.  Raises for a tensor that is not on a card and for
    widths the kernel does not take (PW 4..31, W 8..17)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the DDC mixer kernel takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"the DDC mixer kernel takes float32 samples, got {x.dtype}")
    if flavor not in FLAVORS:
        raise ValueError("NCO flavor must be 'dds48' or 'scaled'")
    if not 4 <= phase_width <= MAX_PHASE_WIDTH:
        raise ValueError(f"the DDC mixer kernel takes phase_width 4..{MAX_PHASE_WIDTH}")
    if data_width < 8:
        raise ValueError("the DDC mixer kernel takes data_width 8..17")
    check_mixer_width(data_width)
    if not x.dim():
        raise ValueError("the DDC mixer kernel takes samples (..., T)")
    t = x.shape[-1]
    if period:
        n0 = int(n0)
        if not -(1 << 62) < n0 < 1 << 62 or not 0 < period < 1 << 62:
            raise ValueError("n0 and period must lie within (-2^62, 2^62)")
    else:
        n0 = int(n0) % (1 << 32)  # only n mod 2^32 reaches the phase
    out = torch.empty((2, *x.shape), dtype=torch.int32 if raw else torch.float32,
                      device=x.device)
    if not x.numel():
        return out
    src = x.contiguous()
    lut, gain, zshift, oshift = mixer_constants(phase_width, data_width, flavor)
    with torch.cuda.device(x.device):
        rc = _build.lib().bhw_ddc_mixer(
            out.data_ptr(), src.data_ptr(), src.numel() // t, t, n0, int(period),
            int(fw) % (1 << phase_width), phase_width, data_width, FLAVORS.index(flavor),
            lut.ctypes.data, len(lut), gain, zshift, oshift, mixer_scale(data_width), int(raw),
            _build.stream_of(x.device))
    _build.check("ddc_mixer", rc)
    return out
