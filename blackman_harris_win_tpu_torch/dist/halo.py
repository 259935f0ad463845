"""Boundary halos over the block (time) axis (counterpart of
``blackman_harris_win_tpu/dist/halo.py``).

The overlap-save and overlap-add stages need samples of the neighbouring
time shard: frames straddle shard boundaries.  Each function takes the
list of one 'blocks' row's shards (the JAX function's operand, per axis
index) and returns a list, by one :func:`~.collectives.ppermute` of the
last or first ``halo`` samples along the last axis.  Where the row spans
processes, a shard of another process is a ``Remote`` placeholder, in and
out.  Window generation needs none of this.
"""

from __future__ import annotations

import torch

from .collectives import axis_size, ppermute
from .mesh import local_map


def left_halo(shards: list, halo: int, circular: bool = False) -> list:
    """The last ``halo`` samples of each shard's left (previous) neighbour;
    shard 0 receives zeros (the stream's start) unless ``circular``."""
    n = axis_size(shards)
    tails = local_map(lambda x: x[..., -halo:], shards)
    # shard i sends its tail to i + 1
    return ppermute(tails, [(i, (i + 1) % n) for i in range(n if circular else n - 1)])


def right_halo(shards: list, halo: int, circular: bool = True) -> list:
    """The first ``halo`` samples of each shard's right (next) neighbour.
    ``circular=True`` wraps the last shard round to shard 0 (a periodic
    stream: the same frame count on every shard for Welch averaging);
    otherwise the last shard receives zeros."""
    n = axis_size(shards)
    heads = local_map(lambda x: x[..., :halo], shards)
    return ppermute(heads, [((i + 1) % n, i) for i in range(n if circular else n - 1)])


def with_right_halo(shards: list, halo: int, circular: bool = True) -> list:
    """Each shard with its right halo appended along the last axis (length
    block + halo): frames that start near a shard's end read into the
    neighbour's head.  ``halo == 0`` returns the shards as they are."""
    if halo == 0:
        return list(shards)
    return local_map(lambda x, h: torch.cat([x, h], dim=-1), shards,
                     right_halo(shards, halo, circular))


def with_left_halo(shards: list, halo: int, circular: bool = False) -> list:
    """Each shard with its left halo prepended along the last axis (length
    halo + block): shard i holds the global stream [i*B - halo, (i+1)*B),
    zeros before sample 0 unless ``circular``.  ``halo == 0`` returns the
    shards as they are."""
    if halo == 0:
        return list(shards)
    return local_map(lambda x, h: torch.cat([h, x], dim=-1), shards,
                     left_halo(shards, halo, circular))
