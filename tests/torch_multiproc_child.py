"""Worker of ``tests/test_torch_multiprocess.py`` (and of the multi-process
``gpu`` case of ``tests/test_torch_gpu.py``): one of N processes of the
PyTorch port, brought up on localhost through ``dist.multihost.initialize``.
It imports torch and the port only (no JAX).

    python tests/torch_multiproc_child.py PORT RANK NPROCS DEVS_PER_PROC OUT_DIR \
        [BACKEND [DEVICE]]

BACKEND is ``gloo`` (default) or ``nccl``; DEVICE is ``cpu`` (default: each
process's shards on the CPU), ``card0`` (every process on card 0, as ranks
sharing one card do, with gloo) or ``own`` (process r on card r, one card
per rank, as nccl wants).

On two meshes from ``pod_mesh``, mesh A (channels=1: 'blocks' spans the
processes) and mesh B (channels=2: the channel rows span them; with four
processes, processes 2 and 3 hold cells of row 1 only), it runs
:func:`steps` (sharded generation, the Welch analyzer, the STFT and its
WOLA inverse, a ``psum`` over 'channels') and gathers three results with
``unshard``.  It writes every local shard and every gathered tensor to
``OUT_DIR/rank{RANK}.pt`` and prints one last line ``MP_RESULT {json}``
with the mesh layouts and block ownership.  The parent runs :func:`steps`
on a one-process mesh of the same shape and holds the two against each
other and against the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.dist import multihost
from blackman_harris_win_tpu_torch.dist.collectives import psum
from blackman_harris_win_tpu_torch.dist.generate import sharded_window
from blackman_harris_win_tpu_torch.dist.mesh import (
    from_rows,
    process_count,
    process_index,
    shard,
    unshard,
)
from blackman_harris_win_tpu_torch.pipeline.spectral import make_sharded_welch
from blackman_harris_win_tpu_torch.pipeline.stft import make_sharded_istft, make_sharded_stft
from blackman_harris_win_tpu_torch.windows import catalog

GEN_SPEC = WindowSpec(12, 17)
WSPEC = WindowSpec(8, 17)  # nfft = 256
NFFT, HOP = 256, 128
NSAMP = 8 * 512  # 512 samples a shard on 8 blocks
BH4 = catalog.get("bh4")
#: the steps gathered by ``unshard`` in every process
GATHERED = ("gen", "welch", "istft")


def signal() -> np.ndarray:
    """The (2, NSAMP) input: two tones on channel 0, a square wave on 1."""
    n = np.arange(NSAMP)
    return np.stack([
        np.sin(2 * np.pi * 16 / NFFT * n) + 0.25 * np.sin(2 * np.pi * 0.31 * n),
        np.sign(np.sin(2 * np.pi * 5 / NFFT * n)),
    ]).astype(np.float32)


def steps(mesh) -> dict:
    """name -> the ``Sharded`` result of each step on ``mesh``, in the order
    every process of the mesh runs them."""
    q = BH4.quantized(17)
    x = signal()
    out = {"gen": sharded_window(q, GEN_SPEC, mesh),
           "welch": make_sharded_welch(mesh, WSPEC, q, BH4.shift, NFFT, HOP)(x)}
    out["stft"] = make_sharded_stft(mesh, WSPEC, q, BH4.shift, NFFT, HOP)(x)
    out["istft"] = make_sharded_istft(mesh, WSPEC, q, BH4.shift, NFFT, HOP)(out["stft"])
    xs = shard(x, mesh, ("channels", "blocks"))
    nc, nb = mesh.shape["channels"], mesh.shape["blocks"]
    cols = [psum([xs.shards[c][b] for c in range(nc)]) for b in range(nb)]
    out["psum_channels"] = from_rows(mesh, (None, "blocks"),
                                     [[cols[b][c] for b in range(nb)] for c in range(nc)])
    return out


def local_devices(device: str, rank: int, per: int) -> list:
    """Process ``rank``'s ``per`` devices for DEVICE (module docstring)."""
    card = {"cpu": "cpu", "card0": "cuda:0", "own": f"cuda:{rank}"}[device]
    return [torch.device(card)] * per


def local_tensors(label: str, outs: dict) -> dict:
    """'{label}/{step}/{c},{b}' -> every shard of ``outs`` this process
    holds, on the host."""
    return {f"{label}/{name}/{c},{b}": t.cpu() for name, s in outs.items()
            for (c, b), t in s.local_shards().items()}


def spawn(nprocs: int, per: int, out_dir: Path, backend: str = "gloo", device: str = "cpu",
          timeout: float = 120.0) -> list:
    """Run ``nprocs`` of these workers on a free localhost port and wait
    for them, ``timeout`` seconds for all together; a worker still running
    then is killed (a process this function started), pass or fail.
    Returns each worker's MP_RESULT dict with its tensors under
    ``"tensors"``; a worker that failed fails the call."""
    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(repo)] + env.get("PYTHONPATH", "").split(os.pathsep)).rstrip(os.pathsep)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(nprocs), str(per), str(out_dir),
         backend, device],
        # stderr apart from stdout, so a warning never splits the result line
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(repo), env=env)
        for r in range(nprocs)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f"worker {r} failed ({p.returncode}):\n{out}\n{err}")
        line = next(s for s in out.splitlines() if s.startswith("MP_RESULT "))
        res = json.loads(line[len("MP_RESULT "):])
        res["tensors"] = torch.load(out_dir / f"rank{r}.pt", weights_only=True)
        results.append(res)
    return results


def main(argv) -> int:
    port, rank, nprocs, per = (int(a) for a in argv[1:5])
    out_dir = Path(argv[5])
    backend = argv[6] if len(argv) > 6 else "gloo"
    device = argv[7] if len(argv) > 7 else "cpu"
    for _ in range(2):  # the second call leaves the started group as it is
        multihost.initialize(backend=backend, init_method=f"tcp://localhost:{port}",
                             world_size=nprocs, rank=rank, timeout=timedelta(seconds=60))
    assert (process_count(), process_index()) == (nprocs, rank)
    result = {"pid": rank}
    tensors = {}
    for label, channels in (("a", 1), ("b", 2)):
        mesh = multihost.pod_mesh(channels=channels,
                                  local_devices=local_devices(device, rank, per))
        outs = steps(mesh)
        tensors.update(local_tensors(label, outs))
        for name in GATHERED:
            tensors[f"{label}/unshard/{name}"] = unshard(outs[name]).cpu()
        try:
            outs["gen"].row(0)
            row_raises = False
        except ValueError:
            row_raises = True
        result[label] = {
            "ranks": [list(r) for r in mesh.ranks],
            "owned_cols": list(multihost.owned_block_cols(np.asarray(mesh.ranks), rank)),
            "block_range": list(multihost.process_block_range(GEN_SPEC.n, mesh)),
            "row_raises": row_raises,
        }
    torch.save(tensors, out_dir / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("MP_RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
