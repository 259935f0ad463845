"""Communication-free sharded window generation (counterpart of
``blackman_harris_win_tpu/dist/generate.py``).

A window sample depends only on its index, ``w[n] = sum_k +-a_k cos(2 pi k
n / 2^PHI)`` with modular phase, so shard i of a mesh axis computes its own
[n0 + i*B, n0 + (i+1)*B) and nothing is communicated.  An integer
shard's block goes through ``kernels.window.window_block``, the router the
single-device path uses, so each source and contract reaches its kernel on
the shard's device (CORDIC kernel 1a, the Taylor HLS or RTL window kernel,
the taylor2 kernel) at any n0 and block; a float32 shard goes through
``float_window_block`` (the f32 outer write-out kernel), a compensated
pair through ``comp_window_block`` (the comp outer write-out).

Every route computes the JAX package's ``window_samples`` values, integer
blocks as int32.  A
result replicated over the other mesh axis is computed on every device
that holds it, as ``shard_map`` does.  Where the mesh spans processes, each
process computes the shards of its own cells only.
"""

from __future__ import annotations

from ..core.config import WindowSpec
from ..kernels.compwin import comp_window_block
from ..kernels.floatwin import float_window_block
from ..kernels.outerwin import DEFAULT_SPLIT
from ..kernels.window import window_block
from .mesh import Mesh, Sharded, local_map


def _range_fn(coeffs_q, spec: WindowSpec, n0: int, block: int):
    """gen(i, device): the int32 block [n0 + i*block, n0 + (i+1)*block)."""
    coeffs_q = tuple(int(c) for c in coeffs_q)
    return lambda i, device: window_block(n0 + i * block, block, coeffs_q, spec, device)


def window_shard_fn(coeffs_q, spec: WindowSpec, block: int):
    """The per-shard generator for use inside a larger sharded step:
    ``gen(i, device)`` returns shard i's block [i*B, (i+1)*B) on ``device``
    (no communication), through the kernel of its source and contract."""
    return _range_fn(coeffs_q, spec, 0, block)


def _generate(mesh: Mesh, axis: str, gen) -> Sharded:
    """Run ``gen(i, device)`` on every mesh cell this process holds, i its
    index along ``axis``: a :class:`Sharded` with spec (axis,)."""
    nb = mesh.shape["blocks"]
    return Sharded(mesh, (axis,), tuple(
        tuple(local_map(gen, [c] * nb if axis == "channels" else range(nb),
                        [mesh.cell(c, b) for b in range(nb)]))
        for c in range(mesh.shape["channels"])))


def sharded_window(coeffs_q, spec: WindowSpec, mesh: Mesh, axis: str = "blocks") -> Sharded:
    """The full 2^phase_width window sharded over ``axis``: shard i holds
    samples [i*B, (i+1)*B).  No communication."""
    nshards = mesh.shape[axis]
    if spec.n % nshards:
        raise ValueError(f"window length {spec.n} not divisible by {nshards} shards")
    block = spec.n // nshards
    return _generate(mesh, axis, window_shard_fn(coeffs_q, spec, block))


def sharded_window_range(coeffs_q, spec: WindowSpec, mesh: Mesh, n0: int, count: int,
                         axis: str = "blocks") -> Sharded:
    """The consecutive sub-range [n0, n0+count) of a window (up to pw = 31,
    whose full period should never materialize), sharded over ``axis``:
    shard i computes [n0 + i*B, n0 + (i+1)*B).  Indices are Python ints and
    int64, so n0 + i*B near 2^31 does not overflow.  No communication."""
    nshards = mesh.shape[axis]
    if count % nshards:
        raise ValueError(f"count {count} not divisible by {nshards} shards")
    return _generate(mesh, axis, _range_fn(coeffs_q, spec, int(n0), count // nshards))


def _float_split(pw: int, nshards: int) -> tuple[int, int, int]:
    """(block, m, rows) of a float window's shards: the largest lo-split
    that still leaves at least one row per shard."""
    n = 1 << pw
    if n % nshards:
        raise ValueError(f"window length {n} not divisible by {nshards} shards")
    block = n // nshards
    m = min(DEFAULT_SPLIT, block.bit_length() - 1)
    return block, m, block >> m


def sharded_float_window(name_or_coeffs, pw: int, mesh: Mesh, axis: str = "blocks") -> Sharded:
    """The full 2^pw float32 window sharded over ``axis``, each shard's block
    by the f32 outer write-out (``kernels/floatwin.py``).  No communication."""
    block, m, rows = _float_split(pw, mesh.shape[axis])
    return _generate(mesh, axis, lambda i, device: float_window_block(
        i * block, rows, name_or_coeffs, pw, m=m, device=device))


def sharded_comp_window(name_or_coeffs, pw: int, mesh: Mesh,
                        axis: str = "blocks") -> tuple[Sharded, Sharded]:
    """The full 2^pw compensated-f32 window sharded over ``axis`` as the raw
    (s, e) pair (``kernels/compwin.py``), each shard's block by the comp
    outer write-out.  No communication."""
    block, m, rows = _float_split(pw, mesh.shape[axis])
    pairs = _generate(mesh, axis, lambda i, device: comp_window_block(
        i * block, rows, name_or_coeffs, pw, m=m, device=device))
    return tuple(Sharded(mesh, pairs.spec, tuple(tuple(local_map(lambda p: p[k], row))
                                                 for row in pairs.shards))
                 for k in (0, 1))
