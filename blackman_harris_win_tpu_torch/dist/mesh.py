"""Device mesh and sharded tensors (counterpart of
``blackman_harris_win_tpu/dist/mesh.py``).

The mesh axes are the JAX package's:

- ``blocks``: time sharding of the sample axis.  Window generation shards
  with no communication, because phases are closed-form ``(k*n) mod 2^PHI``;
  the overlap-save stages need only boundary halos (``halo.py``).
- ``channels``: independent streams.

A :class:`Mesh` is a (channels, blocks) grid of torch devices in this
process; the grid may repeat a device.  A :class:`Sharded` is a global
tensor split over the grid by a spec, the counterpart of a ``jax.Array``
with a ``NamedSharding``: ``spec`` names, per leading dimension of the
global tensor, the mesh axis it is split over (``"channels"``,
``"blocks"``) or ``None``; a mesh axis the spec does not name holds a
replica per index.  :func:`shard` is ``jax.device_put`` and :func:`unshard`
gathers the global tensor on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build

AXES = ("channels", "blocks")


class Mesh:
    """A (channels, blocks) grid of torch devices; ``devices[c][b]`` holds
    the shard at channel index c and block index b."""

    axis_names = AXES

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular (channels, blocks) grid")
        self.devices = grid
        self.shape = {"channels": len(grid), "blocks": len(grid[0])}

    def __repr__(self) -> str:
        return f"Mesh(channels={self.shape['channels']}, blocks={self.shape['blocks']})"


def make_mesh(blocks: int = 1, channels: int = 1, devices=None) -> Mesh:
    """A (channels, blocks) mesh over the first ``channels * blocks`` of
    ``devices``: by default every visible CUDA card (never the CPU).  An
    explicit list may repeat a device: ``["cpu"] * 8`` is the JAX tests'
    virtual 8-device mesh, ``[cuda0] * 4`` puts four shards on one card."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_build.resolve_device(d) for d in devices]
    need = blocks * channels
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[c * blocks:(c + 1) * blocks] for c in range(channels)])


def block_sharding(mesh: Mesh) -> tuple:
    """The spec of a sample axis split over 'blocks' (JAX: ``NamedSharding(
    mesh, P("blocks"))``); ``("channels", "blocks")`` is P('channels',
    'blocks')."""
    return ("blocks",)


@dataclass(frozen=True)
class Sharded:
    """A global tensor split over ``mesh`` by ``spec``: ``shards[c][b]`` is
    the piece at mesh cell (c, b), on ``mesh.devices[c][b]``."""

    mesh: Mesh
    spec: tuple
    shards: tuple

    def row(self, c: int = 0) -> list:
        """The shards of channel index ``c``, one per block index."""
        return list(self.shards[c])


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies, else a copy.  A
    copy between cards is a peer copy; ATen orders it after the work queued
    on both cards' current streams (a two-way event barrier), so the
    producer's kernel finishes first without a host sync.  Copies to the
    host are made blocking, so the result can be read at once."""
    return t.to(device, non_blocking=torch.device(device).type == "cuda")


def _check_spec(spec: tuple, ndim: int) -> None:
    if len(spec) > ndim or any(a not in (*AXES, None) for a in spec):
        raise ValueError(f"spec {spec!r}: at most {ndim} entries, each 'channels', 'blocks' "
                         "or None")
    named = [a for a in spec if a is not None]
    if len(named) != len(set(named)):
        raise ValueError(f"spec {spec!r} names a mesh axis twice")


def shard(x, mesh: Mesh, spec: tuple) -> Sharded:
    """Split the global tensor ``x`` over ``mesh`` by ``spec`` (JAX:
    ``jax.device_put(x, NamedSharding(mesh, P(*spec)))``), each piece on
    its device.  An array-like ``x`` is read to the host first; a tensor is
    split where it lies, and a piece for another card moves by peer copy.
    A :class:`Sharded` with this mesh and spec is returned as it is; with
    another, it is gathered and split again."""
    spec = tuple(spec)
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.spec == spec:
            return x
        x = unshard(x)
    x = torch.as_tensor(x)
    _check_spec(spec, x.ndim)
    for dim, axis in enumerate(spec):
        if axis is not None and x.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split "
                             f"evenly over {mesh.shape[axis]} '{axis}' shards")

    def piece(c: int, b: int) -> torch.Tensor:
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            size = x.shape[dim] // mesh.shape[axis]
            i = c if axis == "channels" else b
            index.append(slice(i * size, (i + 1) * size))
        return move(x[tuple(index)], mesh.devices[c][b])

    grid = tuple(tuple(piece(c, b) for b in range(mesh.shape["blocks"]))
                 for c in range(mesh.shape["channels"]))
    return Sharded(mesh, spec, grid)


def unshard(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``s`` on ``device`` (default: the device of
    shard (0, 0)): the pieces concatenated along the dimensions the spec
    splits, one replica taken along a mesh axis it does not name."""
    device = s.shards[0][0].device if device is None else torch.device(device)
    ci = s.spec.index("channels") if "channels" in s.spec else None
    bi = s.spec.index("blocks") if "blocks" in s.spec else None
    rows = []
    for c in range(s.mesh.shape["channels"] if ci is not None else 1):
        parts = [move(t, device) for t in (s.shards[c] if bi is not None else s.shards[c][:1])]
        rows.append(torch.cat(parts, dim=bi) if bi is not None else parts[0])
    return torch.cat(rows, dim=ci) if ci is not None else rows[0]


def from_rows(mesh: Mesh, spec: tuple, rows) -> Sharded:
    """A :class:`Sharded` from per-channel lists of per-block tensors."""
    return Sharded(mesh, tuple(spec), tuple(tuple(r) for r in rows))
