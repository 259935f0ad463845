"""The SDR chain through ``pipeline.sdr.sdr_chain``: an FM broadcast-band
monitor.

A call channelizes one complex64 capture on the card into C channels (a
critically sampled polyphase DFT filter bank) and FM-discriminates each:
(n_frames - 1, C) int64 angle LSBs, the instantaneous frequency of every
channel at the frame rate.  The captures are made here, on the card, from
the traffic's ``fm`` parameters and the seed, and taken in turn, so no
call repeats the input of the one before:

- ``count`` captures of ``samples`` complex samples at ``sample_rate_hz``,
  channel k of C centred at k * sample_rate_hz / C, which must be the
  ``raster_hz`` of the stations;
- in each, ``stations`` FM carriers on distinct raster slots drawn from
  ``slots`` ([lo, hi], offsets from the centre in rasters), each at a
  level drawn from ``level_db`` (dB against amplitude 1, the strongest
  moved to 0 dB), a carrier offset drawn from +-``carrier_offset_hz``, a
  peak deviation drawn from ``deviation_hz`` and ``tones`` audio tones
  with frequencies drawn from ``audio_hz``, amplitudes from [0.1, 1] and
  phases from the seed, their sum scaled by the sum of its amplitudes so
  that its peak reaches 1 and not past it; the phase of each carrier is
  accumulated in float64 and reduced to one cycle before its cosine and
  sine;
- complex white Gaussian noise of power ``noise_db``.

The prototype is ``channelizer.design_prototype(C, taps)``, built once.
A kept output is copied to the host after its call, so that the window's
peak memory is the program's.  The comparison is against the plain
reference (``reference/sdr.py``): its float64 channelizer, the quantizer
and the discriminator written from the contract.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline_sdr, traffic as gen_traffic
from portbench.reference import sdr as ref

#: capture samples made in one pass on the card
CHUNK = 1 << 22


def _station_params(fm: dict, r: np.random.Generator) -> dict:
    lo, hi = fm["slots"]
    k, tones = int(fm["stations"]), int(fm["tones"])
    level = r.uniform(*fm["level_db"], size=k)
    return {"slots": r.choice(np.arange(lo, hi + 1), size=k, replace=False),
            "amp": 10.0 ** ((level - level.max()) / 20.0),
            "offset_hz": r.uniform(-fm["carrier_offset_hz"], fm["carrier_offset_hz"], size=k),
            "deviation_hz": r.uniform(*fm["deviation_hz"], size=k),
            "tone_hz": r.uniform(*fm["audio_hz"], size=(k, tones)),
            "tone_amp": r.uniform(0.1, 1.0, size=(k, tones)),
            "tone_phase": r.uniform(0.0, 2.0 * math.pi, size=(k, tones)),
            "phase": r.uniform(0.0, 1.0, size=k)}


def fm_captures(fm: dict, channels: int, seed: int, device) -> tuple[list, list]:
    """The seeded complex64 captures, made on ``device``, and the stations
    of each (``_station_params``'s arrays)."""
    fs, n = float(fm["sample_rate_hz"]), int(fm["samples"])
    if fs != channels * float(fm["raster_hz"]):
        raise ValueError(f"{channels} channels of {fm['raster_hz']} Hz need a sample rate of "
                         f"{channels * fm['raster_hz']} Hz, not {fs}")
    r = gen_traffic.rng(seed, 11)
    noise = 10.0 ** (fm["noise_db"] / 20.0)
    out, stations = [], []
    for _ in range(int(fm["count"])):
        p = _station_params(fm, r)
        g = torch.Generator(device=device)
        g.manual_seed(int(r.integers(1 << 62)))
        x = torch.randn(n, generator=g, device=device, dtype=torch.complex64).mul_(noise)
        f0 = (p["slots"] * float(fm["raster_hz"]) + p["offset_hz"]) / fs  # cycles a sample
        # each tone's phase deviation in cycles: its share of the peak
        # deviation over its frequency, over 2 pi (the integral of the tone)
        beta = (p["deviation_hz"][:, None] * p["tone_amp"]
                / p["tone_amp"].sum(axis=1, keepdims=True) / p["tone_hz"] / (2.0 * math.pi))
        for a in range(0, n, CHUNK):
            t = torch.arange(a, min(a + CHUNK, n), device=device, dtype=torch.float64)
            re, im = torch.zeros_like(t), torch.zeros_like(t)
            for s in range(len(f0)):
                cyc = torch.remainder(t * f0[s], 1.0) + p["phase"][s]
                for f, b, ph in zip(p["tone_hz"][s] / fs, beta[s], p["tone_phase"][s]):
                    cyc += b * torch.sin(2.0 * math.pi * torch.remainder(t * f, 1.0) + ph)
                ang = 2.0 * math.pi * torch.remainder(cyc, 1.0)
                re += p["amp"][s] * torch.cos(ang)
                im += p["amp"][s] * torch.sin(ang)
            x[a:a + t.numel()] += torch.complex(re, im).to(torch.complex64)
        out.append(x)
        stations.append(p)
    return out, stations


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from blackman_harris_win_tpu_torch.pipeline import channelizer, sdr

        d = config["deployment"]
        self.device, self.limits = device, config["limits"]
        self.c, self.taps = int(d["channels"]), int(d["taps_per_branch"])
        self.aw, self.iq_scale = int(d["angle_width"]), float(d["iq_scale"])
        self.prototype = channelizer.design_prototype(self.c, self.taps, window=d["window"],
                                                      data_width=d["data_width"])
        self._chain = sdr.sdr_chain
        fm = traffic["fm"]
        self.captures, self.stations = fm_captures(fm, self.c, seed, device)
        #: Hz an output LSB: a cycle (2^AW LSBs) a frame, at the frame rate
        self.hz_per_lsb = float(fm["raster_hz"]) / (1 << self.aw)

    def warm_calls(self) -> list[int]:
        return list(range(len(self.captures)))

    def samples(self, i: int) -> int:
        return self.captures[i % len(self.captures)].numel()

    def work(self, i: int) -> dict:
        return roofline_sdr.sdr_work(self.samples(i), self.c, self.taps, self.aw)

    def call(self, i: int) -> torch.Tensor:
        return self._chain(self.captures[i % len(self.captures)], self.prototype, self.c,
                           angle_width=self.aw, iq_scale=self.iq_scale)

    def keep(self, i: int, out: torch.Tensor):
        return (i % len(self.captures), out.cpu())

    def release(self) -> None:
        pass

    def control(self, kept: list) -> list:
        """The reference in the program's place, its channelizer in TF32."""
        outs = {}
        for cap, _ in kept:
            if cap not in outs:
                y = ref.channelize_tf32(self.captures[cap], self.prototype, self.c)
                outs[cap] = ref.discriminate(*ref.quantize(y, self.iq_scale), self.aw).cpu()
        return [(cap, outs[cap]) for cap, _ in kept]

    def _reference(self, cap: int):
        """The reference's output of capture ``cap`` and its I/Q ints."""
        y = ref.channelize(self.captures[cap], self.prototype, self.c)
        i, q = ref.quantize(y, self.iq_scale)
        del y
        return ref.discriminate(i, q, self.aw), i, q

    def _peak_deviation_hz(self, out: torch.Tensor, cap: int) -> torch.Tensor:
        """max |f - mean f| over the block of each occupied channel, Hz."""
        f = out[:, self.stations[cap]["slots"] % self.c].double() * self.hz_per_lsb
        return (f - f.mean(dim=0)).abs().amax(dim=0)

    def judge(self, kept: list) -> dict:
        """angle_over_budget: output samples of the kept calls, over every
        channel, whose gap from the reference's (wrapped to +-2^(AW-1))
        exceeds their budget.  The budget is derived from the contract: a
        float32 channelizer's channels lie some 1e-3 LSB of the quantizer
        from the float64 ones, so each quantized I and Q is the reference's
        or 1 LSB from it; an output reads I and Q at two frames, each of
        the four words re-quantizes (>> drop) to one of two values, and the
        16 quadruples go through the conjugate products, their >> shift
        and the CORDIC of the contract; the budget is the widest gap of
        those 16 outputs from the reference's, plus the CORDIC's own LSB,
        computed from the reference's ints where the gap is not 0
        (``reference.sdr.angle_budget``).  deviation_hz_gap: of each
        occupied channel (a station's slot) and kept call, the peak
        deviation max |f - mean f| over the block in Hz, the program's
        against the reference's, the widest."""
        refs, over, gap = {}, 0, 0.0
        for cap, out in kept:
            if cap not in refs:
                refs[cap] = self._reference(cap)
            want, i, q = refs[cap]
            if out.shape != want.shape:
                over, gap = over + want.numel(), math.inf
                continue
            got = out.to(want.device)
            d = ref.wrap(got - want, self.aw).abs()
            m, k = torch.nonzero(d, as_tuple=True)
            if m.numel():
                over += int((d[m, k] > ref.angle_budget(i, q, self.aw, m, k)).sum())
            dev = self._peak_deviation_hz(got, cap) - self._peak_deviation_hz(want, cap)
            gap = max(gap, float(dev.abs().max()))
        return {"angle_over_budget": (over, self.limits["angle_over_budget"]),
                "deviation_hz_gap": (gap, self.limits["deviation_hz_gap"])}
