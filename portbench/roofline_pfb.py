"""The yardstick of the PFB spectrometer's roofline metric: its work model.

Frozen beside :mod:`portbench.roofline`, whose peaks and ``bound`` it
uses, so that no change to the program moves it.  A call of
``pipeline.spectrometer.pfb_power`` on ``feeds`` int8 streams of T samples,
C channels of ``taps`` taps a branch, n_frames = T / C - taps + 1 valid
frames a feed, integrated over ``n_acc`` spectra (K = C / 2 + 1 bins):

- the branch FIRs: 2 * taps float32 flops a branch sample (a multiply and
  an add at each tap), n_frames * C of them a feed;
- the real DFT across the branches: the conventional 2.5 C log2(C) flops
  a frame (Welch's convention, :func:`roofline.welch_work`);
- the power: 4 flops a bin (a square, a square, an add, the accumulate),
  n_frames * K of them a feed;
- the bytes: the int8 capture read once (1 byte a sample) and the float32
  power written once (4 bytes a bin of each integration).

The chain has no kernel of its own, so no operation is counted twice for
the int8 words' widening or for the spectrum between the FFT and the
power mean: the bound is what any implementation needs.
"""

from __future__ import annotations

from portbench import roofline


def pfb_work(feeds: int, n_samples: int, channels: int, taps: int, n_acc: int) -> dict:
    """Work of one spectrometer call (see the module's docstring): ``bytes``
    and the float32 ``ops`` at ``rate``, summed over calls by the harness."""
    frames = n_samples // channels - taps + 1
    bins = channels // 2 + 1
    n_int = frames // n_acc
    log2c = channels.bit_length() - 1
    flops = feeds * frames * (2 * taps * channels + 2.5 * channels * log2c + 4 * bins)
    return {"model": "pfb", "bytes": feeds * (n_samples + 4 * n_int * bins), "ops": flops,
            "rate": roofline.F32_FLOPS}


def chain_bound(work: dict) -> float:
    """The least time (s) the calls summed in ``work`` could take: the bytes
    over the memory rate or the flops over theirs, the larger."""
    return roofline.bound(work["bytes"], work["ops"], work["rate"])[0]
