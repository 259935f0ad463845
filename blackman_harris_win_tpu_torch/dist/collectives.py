"""Collectives over one mesh axis, in explicit SPMD form (the port's
``lax.axis_index``, ``lax.axis_size``, ``lax.ppermute``, ``lax.psum`` and
``lax.pmean``).

Inside a JAX ``shard_map`` a collective names a mesh axis and each device
passes its own operand.  Here a collective takes the list of one mesh
axis's shards (position i is the shard at axis index i) and returns the
list of results, each on its shard's device, so a sharded step reads as
stages: a map over the shards, a collective, another map.  The semantics
are JAX's, so the makers do not change if a later backend runs the lists
over ``torch.distributed``.
"""

from __future__ import annotations

import torch

from .mesh import move


def axis_size(shards: list) -> int:
    """The number of shards along the axis (``lax.axis_size``)."""
    return len(shards)


def axis_index(shards: list) -> range:
    """The axis index of each shard in turn (``lax.axis_index``)."""
    return range(len(shards))


def ppermute(shards: list, perm) -> list:
    """``lax.ppermute``: for each (src, dst) pair of ``perm`` shard dst
    receives shard src's operand, on its own device; a shard that receives
    nothing gets zeros of its operand's shape and dtype.  Each index may
    appear at most once as a source and once as a destination."""
    n = axis_size(shards)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a shard may send and receive at most once, got {perm}")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: index out of range for {n} shards in {perm}")
    out = [None] * n
    for s, d in perm:
        out[d] = move(shards[s], shards[d].device)
    return [torch.zeros_like(shards[i]) if o is None else o for i, o in enumerate(out)]


def _sum_on_first(shards: list) -> torch.Tensor:
    """The shards summed in axis order, shard 0 first, on shard 0's device:
    one fixed order, so the result is the same from run to run."""
    acc = shards[0]
    for t in shards[1:]:
        acc = acc + move(t, acc.device)
    return acc


def psum(shards: list) -> list:
    """``lax.psum``: every shard gets the sum of all of them."""
    total = _sum_on_first(shards)
    return [move(total, t.device) for t in shards]


def pmean(shards: list) -> list:
    """``lax.pmean``: every shard gets the mean of all of them, the sum
    (in :func:`psum`'s fixed order) divided by their number."""
    mean = _sum_on_first(shards) / axis_size(shards)
    return [move(mean, t.device) for t in shards]
