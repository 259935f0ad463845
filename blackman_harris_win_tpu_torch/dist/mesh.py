"""Device mesh and sharded tensors (counterpart of
``blackman_harris_win_tpu/dist/mesh.py``).

The mesh axes are the JAX package's:

- ``blocks``: time sharding of the sample axis.  Window generation shards
  with no communication, because phases are closed-form ``(k*n) mod 2^PHI``;
  the overlap-save stages need only boundary halos (``halo.py``).
- ``channels``: independent streams.

A :class:`Mesh` is a (channels, blocks) grid of torch devices, each cell
held by one process (``ranks``, the rank of the default
``torch.distributed`` group; by default this process everywhere, so a mesh
of one process needs no process group); the grid may repeat a device.  A
:class:`Sharded` is a global tensor split over the grid by a spec, the
counterpart of a ``jax.Array`` with a ``NamedSharding``: ``spec`` names,
per leading dimension of the global tensor, the mesh axis it is split over
(``"channels"``, ``"blocks"``) or ``None``; a mesh axis the spec does not
name holds a replica per index.  A process holds the tensors of its own
cells only; a cell of another process holds a :class:`Remote` placeholder,
which :func:`local_map` passes by.  :func:`shard` is ``jax.device_put`` and
:func:`unshard` gathers the global tensor on one device of every process.

Transfers between processes (:func:`exchange`) are point-to-point calls of
the default process group.  With the ``gloo`` backend a card tensor is
staged through the host: copied to the CPU, sent, received on the CPU and
copied to its shard's card (gloo's point-to-point calls take host
tensors); the kernels still run on the cards.  With ``nccl`` card tensors
go as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import _build

AXES = ("channels", "blocks")


def process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group (JAX:
    ``jax.process_index()``); 0 when no group is started."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the default group (JAX:
    ``jax.process_count()``); 1 when no group is started."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass(frozen=True)
class Remote:
    """The placeholder of a mesh cell that process ``rank`` holds: it stands
    in a list of shards where another process has the tensor.  It is not a
    tensor, so no tensor operation takes it by mistake."""

    rank: int


class Mesh:
    """A (channels, blocks) grid of torch devices; ``devices[c][b]`` holds
    the shard at channel index c and block index b, in process
    ``ranks[c][b]`` (default: this process for every cell)."""

    axis_names = AXES

    def __init__(self, devices, ranks=None):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular (channels, blocks) grid")
        #: the rank of this process when the mesh was made
        self.rank = process_index()
        if ranks is None:
            ranks = [[self.rank] * len(grid[0])] * len(grid)
        ranks = tuple(tuple(int(r) for r in row) for row in ranks)
        if [len(row) for row in ranks] != [len(row) for row in grid]:
            raise ValueError("the rank grid must have the mesh's shape")
        self.devices = grid
        self.ranks = ranks
        self.shape = {"channels": len(grid), "blocks": len(grid[0])}

    def cell(self, c: int, b: int):
        """The device of cell (c, b) where this process holds it, else the
        cell's :class:`Remote` placeholder."""
        r = self.ranks[c][b]
        return self.devices[c][b] if r == self.rank else Remote(r)

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
    the piece at mesh cell (c, b), on ``mesh.devices[c][b]``, or a
    :class:`Remote` placeholder where another process holds the cell."""

    mesh: Mesh
    spec: tuple
    shards: tuple

    def row(self, c: int = 0) -> list:
        """The shards of channel index ``c``, one per block index.  Raises
        if another process holds one of them: use :meth:`local_shards` or
        :func:`unshard`."""
        ranks = sorted({t.rank for t in self.shards[c] if isinstance(t, Remote)})
        if ranks:
            raise ValueError(f"row {c} holds shards of processes {ranks}; use local_shards() "
                             "or unshard()")
        return list(self.shards[c])

    def local_shards(self) -> dict:
        """(c, b) -> the tensor of every cell this process holds."""
        return {(c, b): t for c, row in enumerate(self.shards) for b, t in enumerate(row)
                if not isinstance(t, Remote)}

    def piece(self) -> torch.Tensor:
        """The first shard this process holds: every piece of a split has its
        shape and dtype."""
        for row in self.shards:
            for t in row:
                if not isinstance(t, Remote):
                    return t
        raise ValueError("this process holds no shard of the mesh")


def local_map(fn, *lists) -> list:
    """``fn`` position by position over lists of one mesh axis's shards (or
    of the values that go with them): position i gets ``fn(a[i], b[i],
    ...)`` where this process holds the shard, and keeps the placeholder
    where an operand is :class:`Remote`.  Every map of a sharded step goes
    through here, so a step runs its kernels on local shards only."""
    out = []
    for args in zip(*lists):
        remote = next((a for a in args if isinstance(a, Remote)), None)
        out.append(fn(*args) if remote is None else remote)
    return out


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies, else a copy.  A
    copy between cards is a peer copy; ATen orders it after the work queued
    on both cards' current streams (a two-way event barrier), so the
    producer's kernel finishes first without a host sync.  Copies to the
    host are made blocking, so the result can be read at once."""
    return t.to(device, non_blocking=torch.device(device).type == "cuda")


def exchange(sends, recvs) -> list:
    """One batch of point-to-point transfers with other processes (one
    ``batch_isend_irecv``): ``sends`` are (tensor, rank, tag), ``recvs``
    (like, rank, tag), each received into a tensor of ``like``'s shape and
    dtype and returned on ``like``'s device.  Both sides list a pair's
    transfers in the same order with the same tags.  Under ``gloo`` a card
    tensor goes through the host (module docstring)."""
    if not sends and not recvs:
        return []
    via_host = dist.get_backend() != "nccl"

    def wire(t):
        return (t.cpu() if via_host else t).contiguous()

    bufs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if via_host else t.device)
            for t, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, wire(t), r, tag=tag) for t, r, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, r, tag=tag) for buf, (_, r, tag) in zip(bufs, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [move(buf, t.device) for buf, (t, _, _) in zip(bufs, recvs)]


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
    its device; only the cells this process holds get a piece, the others
    a :class:`Remote` placeholder.  An array-like ``x`` is read to the host
    first; a tensor is split where it lies, and a piece for another card
    moves by peer copy.  A :class:`Sharded` with this mesh and spec is
    returned as it is; with another, it is gathered (:func:`unshard`, which
    every process of its mesh must call) and split again."""
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

    def piece(c: int, b: int):
        cell = mesh.cell(c, b)
        if isinstance(cell, Remote):
            return cell
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            size = x.shape[dim] // mesh.shape[axis]
            i = c if axis == "channels" else b
            index.append(slice(i * size, (i + 1) * size))
        return move(x[tuple(index)], cell)

    grid = tuple(tuple(piece(c, b) for b in range(mesh.shape["blocks"]))
                 for c in range(mesh.shape["channels"]))
    return Sharded(mesh, spec, grid)


def unshard(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``s`` on ``device`` (default: the device of the
    first shard this process holds), in every process of the mesh, as
    ``jax.device_get`` of a global array gives it: the pieces concatenated
    along the dimensions the spec splits, one replica taken along a mesh
    axis it does not name.  A piece this process holds no replica of comes
    from the process that holds its first replica, so where the mesh spans
    processes every one of them must call this, in the same order as the
    others' collectives."""
    like = s.piece()
    device = like.device if device is None else torch.device(device)
    ci = s.spec.index("channels") if "channels" in s.spec else None
    bi = s.spec.index("blocks") if "blocks" in s.spec else None
    mesh = s.mesh
    nc = mesh.shape["channels"] if ci is not None else 1
    nb = mesh.shape["blocks"] if bi is not None else 1
    ranks = {r for row in mesh.ranks for r in row}
    pieces, sends, recvs, wanted = {}, [], [], []
    for i in range(nc):
        for j in range(nb):
            cells = [(c, b) for c in (range(mesh.shape["channels"]) if ci is None else (i,))
                     for b in (range(mesh.shape["blocks"]) if bi is None else (j,))]
            holders = {mesh.ranks[c][b] for c, b in cells}
            owner = mesh.ranks[cells[0][0]][cells[0][1]]
            here = next((s.shards[c][b] for c, b in cells
                         if not isinstance(s.shards[c][b], Remote)), None)
            if here is None:
                recvs.append((like, owner, i * nb + j))
                wanted.append((i, j))
                continue
            pieces[i, j] = here
            if owner == mesh.rank:
                sends += [(here, r, i * nb + j) for r in sorted(ranks - holders)]
    pieces.update(zip(wanted, exchange(sends, recvs)))
    rows = []
    for i in range(nc):
        parts = [move(pieces[i, j], device) for j in range(nb)]
        rows.append(torch.cat(parts, dim=bi) if bi is not None else parts[0])
    return torch.cat(rows, dim=ci) if ci is not None else rows[0]


def from_rows(mesh: Mesh, spec: tuple, rows) -> Sharded:
    """A :class:`Sharded` from per-channel lists of per-block tensors."""
    return Sharded(mesh, tuple(spec), tuple(tuple(r) for r in rows))
