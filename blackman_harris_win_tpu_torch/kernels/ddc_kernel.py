"""The DDC's front half as CUDA kernels: binding of ``csrc/ddc_kernel.cu``.

The kernel quantizes an f32 stream (..., T) to MIX_IN_BITS, runs the
pre-rotated CORDIC NCO (dds48 or scaled) at the closed-form phase
((n mod 2^32) * fw) mod 2^PW of each global index n, mixes in int32 and
rescales once to f32, writing the (2, ..., T) mixer output that
``pipeline/fir.py:decimating_fir`` takes; the raw entry writes the int32
(I, Q) products instead.  It replaces the jnp of
``blackman_harris_win_tpu/pipeline/ddc.py:49-80`` (no ``pallas_call``).

The phase repeats with period P = :func:`nco_period` in n.  Where
:func:`table_period` allows it (P <= MAX_TABLE and P * TABLE_REUSE <= T), a
short launch first writes the P (cos, -sin) pairs into a table made for the
call (counter ``ddc_nco_table``) and the mixer pass reads them; otherwise
the mixer pass computes each sample's NCO (counter ``ddc_mixer`` either
way).

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
#: the longest NCO period the mixer reads from a table: 2^20 int32 pairs,
#: 8 MB, which L2 holds while the samples stream past
MAX_TABLE = 1 << 20
#: a table is built only where each entry serves at least this many samples
#: of a row: it costs P NCOs, the compute path T
TABLE_REUSE = 4


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


def nco_period(fw: int, phase_width: int) -> int:
    """The period in n of the NCO phase (n * fw) mod 2^PW: 2^(PW - tz) for
    tz the trailing zero bits of fw mod 2^PW, and 1 for fw = 0.  It divides
    2^PW and so 2^32: the phase of n is the phase of n mod P."""
    f = int(fw) % (1 << phase_width)
    if not f:
        return 1
    return 1 << (phase_width - ((f & -f).bit_length() - 1))


def table_period(fw: int, phase_width: int, t: int) -> int:
    """The table the mixer reads for rows of ``t`` samples: its length P
    (:func:`nco_period`) where P <= MAX_TABLE and P * TABLE_REUSE <= t, else
    0, the compute path."""
    p = nco_period(fw, phase_width)
    return p if p <= MAX_TABLE and p * TABLE_REUSE <= t else 0


def _check_widths(fw: int, phase_width: int, data_width: int, flavor: str) -> tuple:
    """The NCO arguments of both C entries: (fw mod 2^PW, PW, W, flavor
    code, lut, its length, gain, zshift, oshift), and the lut array, which
    must outlive the call.  Raises for what the kernels do not take."""
    if flavor not in FLAVORS:
        raise ValueError("NCO flavor must be 'dds48' or 'scaled'")
    if not 4 <= phase_width <= MAX_PHASE_WIDTH:
        raise ValueError(f"the DDC mixer kernel takes phase_width 4..{MAX_PHASE_WIDTH}")
    if data_width < 8:
        raise ValueError("the DDC mixer kernel takes data_width 8..17")
    check_mixer_width(data_width)
    lut, gain, zshift, oshift = mixer_constants(phase_width, data_width, flavor)
    return (int(fw) % (1 << phase_width), phase_width, data_width, FLAVORS.index(flavor),
            lut.ctypes.data, len(lut), gain, zshift, oshift), lut


def _launch_table(table: torch.Tensor, nco: tuple) -> None:
    with torch.cuda.device(table.device):
        rc = _build.lib().bhw_ddc_nco_table(table.data_ptr(), table.shape[0], *nco,
                                            _build.stream_of(table.device))
    _build.check("ddc_nco_table", rc)


def nco_table(fw: int, phase_width: int, data_width: int, flavor: str = "dds48",
              device=None) -> torch.Tensor:
    """Launch the table kernel alone: the (P, 2) int32 (cos, -sin) pairs at
    the phases (j * fw) mod 2^PW, j < P = :func:`nco_period` (at most
    MAX_TABLE), on a CUDA ``device`` (default the card), which the mixer
    reads at index n mod P."""
    nco, _lut = _check_widths(fw, phase_width, data_width, flavor)
    dev = _build.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the DDC table kernel runs on a CUDA device")
    p = nco_period(fw, phase_width)
    if p > MAX_TABLE:
        raise ValueError(f"the NCO period {p} exceeds the table's {MAX_TABLE}")
    table = torch.empty((p, 2), dtype=torch.int32, device=dev)
    _launch_table(table, nco)
    return table


def mixer(x: torch.Tensor, fw: int, phase_width: int, data_width: int, flavor: str = "dds48",
          n0: int = 0, period: int = 0, raw: bool = False) -> torch.Tensor:
    """Launch the kernel on a CUDA float32 tensor ``x`` (..., T): the
    (2, ..., T) mixer output as float32, or with ``raw`` the int32 (I, Q)
    products.  ``n0`` is the global index of x[..., 0]; an index below 0
    takes ``+ period``.  Where :func:`table_period` gives a table, it is
    built first, in a launch of its own.  Raises for a tensor that is not on
    a card and for widths the kernel does not take (PW 4..31, W 8..17)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the DDC mixer kernel takes a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"the DDC mixer kernel takes float32 samples, got {x.dtype}")
    nco, _lut = _check_widths(fw, phase_width, data_width, flavor)
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
    p = table_period(fw, phase_width, t)
    table = None
    if p:  # made for this call: nothing is cached across calls
        table = torch.empty((p, 2), dtype=torch.int32, device=x.device)
        _launch_table(table, nco)
    with torch.cuda.device(x.device):
        rc = _build.lib().bhw_ddc_mixer(
            out.data_ptr(), src.data_ptr(), src.numel() // t, t, n0, int(period), *nco,
            mixer_scale(data_width), int(raw), table.data_ptr() if p else None, p,
            _build.stream_of(x.device))
    _build.check("ddc_mixer", rc)
    return out
