"""The PFB spectrometer through ``pipeline.spectrometer.pfb_power``: one
digitizer board's inputs of a radio telescope's F-engine.

A call turns one int8 capture of ``feeds`` inputs on the card into each
input's integrated channel power, (feeds, n_int, C//2 + 1) float32.  The
captures are made here, on the card, from the traffic's ``board``
parameters and the seed, and taken in turn, so no call repeats the input
of the one before.  Each capture is ``samples`` ADC words a feed:

- sky noise: Gaussian at an rms of ``noise_rms_lsb`` LSB, independent per
  feed;
- RFI: ``rfi_carriers`` narrowband carriers common to all feeds, each on a
  distinct bin k drawn from 1 .. C/2 - 1 at a frequency (k + u) / C cycles
  a sample, u drawn from +-``rfi_bin_offset``, with its own level drawn
  from ``rfi_db`` (dB against the noise power) and phase for each feed;
- one faint line at ``line_db`` on another such bin, every feed at that
  level, its phase drawn per feed;
- the sum rounded (half to even) and clipped to +-``full_scale``, as an
  ADC's words, int8.

Each carrier's phase is reduced to one cycle in float64 before its cosine
and sine, and the feeds' sums are one float64 product of their gains with
the carriers' waveforms.  The program's prototype is
``channelizer.design_prototype(C, taps)``, built once.  A kept output is
copied to the host after its call, so that the window's peak memory is the
program's.  The comparison is against the plain reference
(``reference/pfb.py``): the float64 filter bank, real FFT and integration
of the same capture, with taps the reference builds itself
(``reference.pfb.prototype``: the BH-4 cosine sum in float64, rounded to
the configuration's data width), so that a fault in the program's
prototype or window fails the comparison too.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench import roofline_pfb, traffic as gen_traffic
from portbench.reference import pfb as ref

#: capture samples a feed made in one pass on the card
CHUNK = 1 << 21


def _line_params(board: dict, channels: int, r: np.random.Generator) -> dict:
    """The carriers of one capture: frequency (cycles a sample), and a
    (feeds, lines) amplitude and phase; the last line is the faint one."""
    feeds, n_rfi = int(board["feeds"]), int(board["rfi_carriers"])
    bins = r.choice(np.arange(1, channels // 2), size=n_rfi + 1, replace=False)
    u = r.uniform(-board["rfi_bin_offset"], board["rfi_bin_offset"], size=n_rfi + 1)
    db = np.concatenate([r.uniform(*board["rfi_db"], size=(feeds, n_rfi)),
                         np.full((feeds, 1), float(board["line_db"]))], axis=1)
    # a cosine of amplitude a has power a^2 / 2
    amp = np.sqrt(2.0 * 10.0 ** (db / 10.0)) * float(board["noise_rms_lsb"])
    return {"bins": bins, "freq": (bins + u) / channels, "amp": amp,
            "phase": r.uniform(0.0, 2.0 * math.pi, size=amp.shape)}


def board_captures(board: dict, channels: int, seed: int, device) -> tuple[list, list]:
    """The seeded int8 captures, (feeds, samples) each, made on ``device``,
    and the carriers of each (``_line_params``'s arrays)."""
    r = gen_traffic.rng(seed, 13)
    feeds, n = int(board["feeds"]), int(board["samples"])
    rms, full = float(board["noise_rms_lsb"]), float(board["full_scale"])
    out, lines = [], []
    for _ in range(int(board["count"])):
        p = _line_params(board, channels, r)
        g = torch.Generator(device=device)
        g.manual_seed(int(r.integers(1 << 62)))
        f = torch.as_tensor(p["freq"], dtype=torch.float64, device=device)[:, None]
        # a cos(w t + phi) = a cos(phi) cos(w t) - a sin(phi) sin(w t)
        ca = torch.as_tensor(p["amp"] * np.cos(p["phase"]), dtype=torch.float64, device=device)
        sa = torch.as_tensor(-p["amp"] * np.sin(p["phase"]), dtype=torch.float64, device=device)
        x = torch.empty((feeds, n), dtype=torch.int8, device=device)
        for a in range(0, n, CHUNK):
            t = torch.arange(a, min(a + CHUNK, n), device=device, dtype=torch.float64)
            ang = 2.0 * math.pi * torch.remainder(t * f, 1.0)
            s = ca @ torch.cos(ang) + sa @ torch.sin(ang)
            s += torch.randn((feeds, t.numel()), generator=g, device=device,
                             dtype=torch.float32).mul_(rms)
            x[:, a:a + t.numel()] = s.round_().clamp_(-full, full).to(torch.int8)
        out.append(x)
        lines.append(p)
    return out, lines


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from blackman_harris_win_tpu_torch.pipeline import channelizer, spectrometer

        d = config["deployment"]
        self.device, self.limits = device, config["limits"]
        self.c, self.taps, self.n_acc = (int(d["channels"]), int(d["taps_per_branch"]),
                                         int(d["n_acc"]))
        self.prototype = channelizer.design_prototype(self.c, self.taps, window=d["window"],
                                                      data_width=d["data_width"])
        if d["window"] != "bh4":
            raise ValueError(f"the reference builds BH-4 prototypes only, not {d['window']}")
        self.ref_taps = ref.prototype(self.c, self.taps, int(d["data_width"]))
        self._power = spectrometer.pfb_power
        board = traffic["board"]
        self.captures, self.lines = board_captures(board, self.c, seed, device)
        full = int(board["full_scale"])
        clipped = [int((x.abs() >= full).sum()) for x in self.captures]
        print(f"traffic: words at +-{full} (clipped or at full scale) a capture: {clipped} of "
              f"{self.captures[0].numel()}", file=sys.stderr)

    def warm_calls(self) -> list[int]:
        return list(range(len(self.captures)))

    def samples(self, i: int) -> int:
        return self.captures[i % len(self.captures)].numel()

    def work(self, i: int) -> dict:
        feeds, n = self.captures[i % len(self.captures)].shape
        return roofline_pfb.pfb_work(feeds, n, self.c, self.taps, self.n_acc)

    def call(self, i: int) -> torch.Tensor:
        return self._power(self.captures[i % len(self.captures)], self.prototype, self.c,
                           self.n_acc)

    def keep(self, i: int, out: torch.Tensor):
        return (i % len(self.captures), out.cpu())

    def release(self) -> None:
        pass

    def control(self, kept: list) -> list:
        """The reference in the program's place, its branch FIRs' operands
        rounded to TF32, summed in float32, and a float32 FFT."""
        outs = {}
        for cap, _ in kept:
            if cap not in outs:
                outs[cap] = ref.pfb_power_tf32(self.captures[cap], self.ref_taps, self.c,
                                               self.n_acc).cpu()
        return [(cap, outs[cap]) for cap, _ in kept]

    def judge(self, kept: list) -> dict:
        """Of each kept call's integrated power P and the float64
        reference's P64 of the same capture by the reference's own taps,
        |P - P64| / P64 over every bin of every feed's every integration
        (sky noise fills every bin, so P64 > 0): power_rel_p99, its 99th percentile, and power_rel_max,
        the largest, each the worst over the kept calls; a wrong shape or a
        value that is not finite reads inf.  A float32 bank with TF32 off
        and a float64 integration leave some 1e-7 of each bin; the control
        (the taps rounded to TF32) moves the filter's response and every
        bin by some 1e-4."""
        refs, p99, worst = {}, 0.0, 0.0
        for cap, out in kept:
            if cap not in refs:
                refs[cap] = ref.pfb_power(self.captures[cap], self.ref_taps, self.c,
                                          self.n_acc).cpu()
            want = refs[cap]
            if out.shape != want.shape or not bool(out.isfinite().all()):
                p99 = worst = math.inf
                continue
            rel = ((out.double() - want).abs() / want).flatten()
            p99 = max(p99, float(torch.quantile(rel, 0.99)))
            worst = max(worst, float(rel.max()))
        return {"power_rel_p99": (p99, self.limits["power_rel_p99"]),
                "power_rel_max": (worst, self.limits["power_rel_max"])}
