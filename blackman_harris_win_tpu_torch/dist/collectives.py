"""Collectives over one mesh axis, in explicit SPMD form (the port's
``lax.axis_index``, ``lax.axis_size``, ``lax.ppermute``, ``lax.psum`` and
``lax.pmean``).

Inside a JAX ``shard_map`` a collective names a mesh axis and each device
passes its own operand.  Here a collective takes the list of one mesh
axis's shards (position i is the shard at axis index i) and returns the
list of results, each on its shard's device, so a sharded step reads as
stages: a map over the shards (``mesh.local_map``), a collective, another
map.

Where the mesh spans processes, a position another process holds is a
``Remote`` placeholder in the list, in and out: each process passes the
whole list, computes the results of its own positions, and trades operands
with the others by point-to-point calls of the default process group
(``mesh.exchange``; one ``batch_isend_irecv`` a call).  Every process of
the mesh therefore makes the same collectives in the same order, also for
a row of which it holds no shard: such a call has nothing to trade and
returns the placeholders.  The makers are the same in one process and in
several.
"""

from __future__ import annotations

import torch

from .mesh import Remote, exchange, move


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
    appear at most once as a source and once as a destination.  A pair
    whose src lies in another process is a receive into the shape and
    dtype of dst's own operand (an SPMD step gives every shard one shape);
    one whose dst does is a send."""
    n = axis_size(shards)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a shard may send and receive at most once, got {perm}")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: index out of range for {n} shards in {perm}")
    remote = [isinstance(t, Remote) for t in shards]
    out = [None] * n
    sends, recvs, into = [], [], []
    for s, d in perm:
        if not remote[s] and not remote[d]:
            out[d] = move(shards[s], shards[d].device)
        elif not remote[s]:
            sends.append((shards[s], shards[d].rank, s))
        elif not remote[d]:
            recvs.append((shards[d], shards[s].rank, s))
            into.append(d)
    for d, t in zip(into, exchange(sends, recvs)):
        out[d] = t
    return [t if remote[i] else torch.zeros_like(t) if o is None else o
            for i, (t, o) in enumerate(zip(shards, out))]


def _gathered(shards: list):
    """Every operand of the axis, the remote ones received from the
    processes that hold them (each process sends its own to every other
    process of the axis); None where this process holds none."""
    local = [t for t in shards if not isinstance(t, Remote)]
    if not local:
        return None
    peers = sorted({t.rank for t in shards if isinstance(t, Remote)})
    sends = [(t, r, i) for i, t in enumerate(shards) if not isinstance(t, Remote) for r in peers]
    recvs = [(local[0], t.rank, i) for i, t in enumerate(shards) if isinstance(t, Remote)]
    got = iter(exchange(sends, recvs))
    return [next(got) if isinstance(t, Remote) else t for t in shards]


def _sum_on_first(shards: list) -> torch.Tensor:
    """The shards summed in axis order, shard 0 first, on shard 0's device:
    one fixed order, so the result is the same from run to run, and the
    same in one process as across several."""
    acc = shards[0]
    for t in shards[1:]:
        acc = acc + move(t, acc.device)
    return acc


def _reduce(shards: list, scale: int) -> list:
    ops = _gathered(shards)
    if ops is None:
        return list(shards)
    total = _sum_on_first(ops)
    if scale != 1:
        total = total / scale
    return [t if isinstance(t, Remote) else move(total, t.device) for t in shards]


def psum(shards: list) -> list:
    """``lax.psum``: every shard gets the sum of all of them."""
    return _reduce(shards, 1)


def pmean(shards: list) -> list:
    """``lax.pmean``: every shard gets the mean of all of them, the sum
    (in :func:`psum`'s fixed order) divided by their number."""
    return _reduce(shards, axis_size(shards))
