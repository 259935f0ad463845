"""The yardstick of the roofline metrics: peaks and work models.

A frozen copy of the program's ``utils/profiling.py`` arithmetic
(``bound``, ``cordic_ops``, ``cordic_window_int_ops`` and the data-sheet
peaks), kept here so that no change to the program moves the yardstick,
and the Welch analyzer's work model, which the program does not have.

Peaks: NVIDIA H100 SXM data sheet, at its full 700 W power limit.  The
operation models count what the function needs, one operation per add,
multiply, shift, compare or select whatever its width: the same work
whatever implements it.
"""

from __future__ import annotations

#: device memory bytes/s
HBM_BPS = 3.35e12
#: float32 FLOP/s outside the tensor cores
F32_FLOPS = 67e12
#: int32 operations/s: one instruction per lane per cycle, 128 lanes an SM
INT32_OPS = F32_FLOPS / 2


def bound(nbytes: float, ops: float = 0.0, rate: float = INT32_OPS) -> tuple[float, str]:
    """The least time (s) the card could take: bytes over the memory rate
    or operations over their peak rate, the larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cordic_ops(n_terms: int, iters: int) -> int:
    """Operations per window sample of the CORDIC generators: per harmonic,
    ``iters`` iterations of 2 shifts, 3 adds/subtracts and a sign test, plus
    the phase product and mask, the quadrant fix, a_k * cos, its shift and
    the accumulate (6); per sample the wrap or clamp (4)."""
    return (n_terms - 1) * (6 * iters + 6) + 4


def cordic_window_work(n_samples: int, n_terms: int, data_width: int,
                       rounding: str = "hls") -> dict:
    """Work of ``n_samples`` CORDIC window samples written as int32: W
    iterations under the HLS contract, W - 1 under the RTL one."""
    ops = n_samples * cordic_ops(n_terms, data_width - (rounding == "rtl"))
    return {"model": "cordic_window", "bytes": 4 * n_samples, "ops": ops,
            "rate": INT32_OPS}


def welch_work(n_capture: int, nfft: int, hop: int) -> dict:
    """Work of one Welch spectrum of an ``n_capture``-sample float32
    capture: the capture read once, the window and the spectrum; per frame
    nfft window products, the conventional 2.5 nfft log2(nfft) real-FFT
    flops, 3 a bin for the power and 1 for the mean, in float32."""
    frames = (n_capture - nfft) // hop + 1
    bins = nfft // 2 + 1
    flops = frames * (nfft + 2.5 * nfft * (nfft.bit_length() - 1) + 4 * bins)
    return {"model": "welch", "bytes": 4 * (n_capture + nfft + bins), "ops": flops,
            "rate": F32_FLOPS}
