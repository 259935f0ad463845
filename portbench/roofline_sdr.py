"""The yardstick of the SDR chain's roofline metrics: its work model.

Frozen beside :mod:`portbench.roofline`, whose peaks and ``bound`` it
uses, so that no change to the program moves it.  The operation counts
are what the chain needs, one operation per add, multiply, shift, compare
or select whatever its width (``utils/profiling.py:fm_demod_conj_ops`` of
the program, copied at AW = 20): the same work whatever implements it.

A call of ``pipeline.sdr.sdr_chain`` on a complex capture of T samples,
C channels of ``taps`` taps a branch, n_frames = T / C - taps + 1:

- the branch FIRs: 2 * 2 * taps float32 flops a capture sample (a
  multiply and an add for each of its real and imaginary parts, at each
  of the branch's taps);
- the DFT across the branches: 5 log2(C) float32 flops a channel sample
  (the conventional complex-FFT count), n_frames * C of them;
- the discriminator: :func:`fm_demod_conj_ops` integer operations an
  output, (n_frames - 1) * C outputs; its bytes: the complex64 channels
  read once (8 n_frames C) and the int64 output written once
  (8 (n_frames - 1) C);
- the chain's bytes: the complex64 capture read once (8 T) and the int64
  output written once.
"""

from __future__ import annotations

from portbench import roofline


def atan2_ops(angle_width: int) -> int:
    """Operations per angle of the vectoring CORDIC atan2: the quadrant
    bits (5), the one's-complement abs (4), AW-1 iterations of 2 shifts, 3
    adds or subtracts and a sign test (6 each), z >> P and its AW-bit wrap
    (2) and the quadrant select (3)."""
    return 6 * (angle_width - 1) + 15


def fm_demod_conj_ops(angle_width: int) -> int:
    """Operations per output of the conjugate-product discriminator from
    complex samples, each sample quantized once: the quantizer (4), the
    re-quantizing shifts (2), the conjugate products (6), their shifts (2),
    then one atan2."""
    return 4 + 2 + 6 + 2 + atan2_ops(angle_width)


def sdr_work(n_capture: int, channels: int, taps: int, angle_width: int) -> dict:
    """Work of one chain call (see the module's docstring).  ``bytes`` and
    ``ops`` (the integer operations) are what the harness sums over calls;
    ``flops`` and the ``demod_*`` keys are one call's, to be scaled by the
    calls."""
    frames = n_capture // channels - taps + 1
    outs = (frames - 1) * channels
    demod_ops = outs * fm_demod_conj_ops(angle_width)
    flops = 4 * taps * n_capture + 5 * (channels.bit_length() - 1) * frames * channels
    return {"model": "sdr", "bytes": 8 * n_capture + 8 * outs, "ops": demod_ops,
            "rate": roofline.INT32_OPS, "flops": flops, "flop_rate": roofline.F32_FLOPS,
            "demod_bytes": 8 * frames * channels + 8 * outs, "demod_ops": demod_ops}


def chain_bound(work: dict, calls: int) -> float:
    """The least time (s) ``calls`` chain calls could take: the bytes
    over the memory rate, the float flops over theirs or the integer
    operations over theirs, the largest (they may overlap)."""
    return max(work["bytes"] / roofline.HBM_BPS, work["ops"] / work["rate"],
               calls * work["flops"] / work["flop_rate"])


def demod_bound(work: dict) -> float:
    """The least time (s) one call's discriminator could take."""
    return roofline.bound(work["demod_bytes"], work["demod_ops"], work["rate"])[0]
