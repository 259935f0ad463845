"""Multi-process start-up and mesh layout (counterpart of
``blackman_harris_win_tpu/dist/multihost.py``).

``torch.distributed`` brings up the process group; :func:`pod_mesh` lays
'blocks' (time) within a process and 'channels' across processes, so
window generation needs no communication at all, the analyzer's halos stay
within a process where they can, and the channel reductions cross
processes.  Run in every process::

    from blackman_harris_win_tpu_torch.dist import multihost
    multihost.initialize()            # torchrun's environment, or explicit arguments
    mesh = multihost.pod_mesh(channels=...)

Under ``torchrun`` (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE`` in the
environment) no argument is needed; elsewhere pass ``init_method``
(``tcp://host:port``), ``world_size`` and ``rank``.  ``nccl`` (the default
where torch sees a card) wants one card per rank: give each process its own
card in ``local_devices`` (or ``CUDA_VISIBLE_DEVICES``).  Ranks that share
a card use ``backend="gloo"``, which stages card tensors through the host
(``mesh.exchange``).  The sharded steps (``generate.py``, the
``make_sharded_*`` makers) then run unchanged on the mesh: each process
computes its own cells.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from .mesh import Mesh, process_count, process_index

#: how long a start-up or a collective may wait for the other processes
#: before it raises, where the caller names no other limit
DEFAULT_TIMEOUT = timedelta(minutes=5)


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Start the default ``torch.distributed`` process group (idempotent:
    a started group is left as it is).

    With no arguments and no ``MASTER_ADDR`` or ``RANK`` in the environment
    the process stays alone (rank 0 of 1), as JAX's auto-detection does on
    one host.  A failed start-up of more than one process raises: going on
    alone would run every collective on a fraction of the data.
    ``backend`` defaults to ``"nccl"`` where torch sees a card, else
    ``"gloo"``; ``timeout`` bounds the start-up and every collective, so a
    process whose peers never arrive fails instead of hanging."""
    if dist.is_initialized():
        return
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not {"MASTER_ADDR", "RANK"} & os.environ.keys():
        return
    size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        # NCCL's point-to-point calls use the current card: one per rank
        local = os.environ.get("LOCAL_RANK", rank if rank is not None else 0)
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=-1 if world_size is None else world_size,
                                rank=-1 if rank is None else rank, timeout=timeout)
    except (RuntimeError, ValueError):
        if size > 1:
            raise


def pod_mesh(channels: int = 1, blocks: int | None = None, local_devices=None) -> Mesh:
    """The (channels, blocks) mesh over every process's local devices,
    gathered in rank order (``all_gather_object``) and laid out with
    'channels' as the slow axis, so consecutive block shards sit in one
    process and 'channels' spans processes.  ``local_devices`` defaults to
    every card this process sees (never the CPU); a list may repeat a device
    (``["cpu"] * 4`` in the tests, ``[card] * 2`` for two ranks on one card).
    Every process must call this."""
    if local_devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_devices = [torch.device("cuda", i) for i in range(n)]
    local = [_build.resolve_device(d) for d in local_devices]
    if not local:
        raise ValueError("no local devices: torch sees no CUDA card; pass local_devices")
    per_rank = [[str(d) for d in local]]
    if process_count() > 1:
        per_rank = [None] * process_count()
        dist.all_gather_object(per_rank, [str(d) for d in local])
    devs = [torch.device(d) for names in per_rank for d in names]
    ranks = [r for r, names in enumerate(per_rank) for _ in names]
    total = len(devs)
    if blocks is None:
        if total % channels:
            raise ValueError(f"{total} devices not divisible by {channels}")
        blocks = total // channels
    if channels * blocks != total:
        raise ValueError(f"mesh {channels}x{blocks} != {total} global devices")
    return Mesh([devs[c * blocks:(c + 1) * blocks] for c in range(channels)],
                [ranks[c * blocks:(c + 1) * blocks] for c in range(channels)])


def owned_block_cols(process_grid: np.ndarray, pid: int) -> tuple[int, int]:
    """[first, last+1) block columns owned by process ``pid`` given the
    (channels, blocks) grid of ranks.  A process holding cells only on
    non-zero channel rows still feeds the block columns those cells sit at.
    Returns (0, 0) when the process holds no cell of the mesh."""
    cols = sorted({int(j) for _i, j in zip(*np.where(np.asarray(process_grid) == pid))})
    if not cols:
        return (0, 0)
    return (cols[0], cols[-1] + 1)


def process_block_range(n_total: int, mesh: Mesh) -> tuple[int, int]:
    """The [start, end) sample range this process's shards own along
    'blocks', for feeding per-process input pipelines without a global
    gather."""
    nblocks = mesh.shape["blocks"]
    per = n_total // nblocks
    grid = np.asarray(mesh.ranks).reshape(-1, nblocks)
    lo, hi = owned_block_cols(grid, process_index())
    return (lo * per, hi * per)
