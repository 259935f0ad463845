"""The one traffic generator: every mix is a file of parameters it reads.

The loop is closed: one call in flight, the next sent when the last
returned and the device synchronized, as a user waits for each result.
Keys of a traffic file (``traffic/<name>.json``):

- ``block``: the samples a generation call writes, from a first index
  drawn from the seed over the period for each call (the window is
  periodic, so a block of the period's length is the whole table from
  that index on, and no two calls in turn ask for the same samples);
- ``captures``: the inputs of an analyzer call, ``{"count", "samples",
  "tones_db": [...], "noise_db", "band": [lo, hi]}``: ``count`` float32
  captures of ``samples`` each, every one a cosine at each level of
  ``tones_db`` (dB against amplitude 1) with its frequency drawn from
  ``band`` (cycles a sample) and its phase from the seed, plus white
  Gaussian noise of rms ``noise_db``; call i reads capture i mod count;
- ``compare``: how many calls of the window, drawn from the seed, keep
  their output for the comparison (the last call always does).

Every seed gives the same sizes and the same schedule shape; only values,
offsets and the compared calls move with it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: seeds are whole numbers of any size; they fold into 64 bits
_MASK64 = (1 << 64) - 1


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & _MASK64, *salt])


def block_schedule(traffic: dict, seed: int, period: int):
    """i -> (n0, length) of generation call i."""
    length = int(traffic["block"])
    offsets = rng(seed, 2).integers(0, period, size=1 << 16)
    return lambda i: (int(offsets[i % offsets.size]), length)


def captures(traffic: dict, seed: int, device) -> list[torch.Tensor]:
    """The seeded float32 captures, made on ``device`` in a few large calls."""
    p = traffic["captures"]
    n, r = int(p["samples"]), rng(seed, 1)
    noise = 10.0 ** (p["noise_db"] / 20.0)
    out = []
    for _ in range(int(p["count"])):
        g = torch.Generator(device=device)
        g.manual_seed(int(r.integers(1 << 62)))
        x = torch.randn(n, generator=g, device=device, dtype=torch.float32).mul_(noise)
        tones = [(r.uniform(*p["band"]), 10.0 ** (db / 20.0), r.uniform(0.0, 2.0 * math.pi))
                 for db in p["tones_db"]]
        chunk = 1 << 24
        for a in range(0, n, chunk):
            t = torch.arange(a, min(a + chunk, n), device=device, dtype=torch.float64)
            acc = torch.zeros_like(t)
            for f, amp, ph in tones:
                # the phase reduced to one cycle before the cosine
                acc += amp * torch.cos(2.0 * math.pi * torch.remainder(t * f, 1.0) + ph)
            x[a:a + t.numel()] += acc.to(torch.float32)
        out.append(x)
    return out


def compared_calls(traffic: dict, seed: int, expected: int) -> set[int]:
    """The calls whose outputs are kept for the comparison: ``compare`` of
    them drawn from the seed among the first ``expected`` calls."""
    k = int(traffic.get("compare", 1))
    expected = max(expected, k)
    return set(int(i) for i in rng(seed, 3).choice(expected, size=k, replace=False))
