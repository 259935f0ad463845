"""PyTorch port, the sharded steps across real processes on the CPU (the
twin of ``tests/test_multiprocess.py``).

Starts 2 processes x 4 CPU devices, then 4 x 2, each running
``tests/torch_multiproc_child.py`` (torch and the port only) brought up over
Gloo on localhost through ``dist.multihost.initialize``.  On mesh A
(``pod_mesh(channels=1)``: 'blocks' spans the processes, so the halos and
the Welch ``pmean`` cross them) and mesh B (``pod_mesh(channels=2)``: the
channel rows span them; with four processes, processes 2 and 3 hold row 1
only, the case where a process that skipped a row's collectives would
deadlock), each child's local shards are held against :func:`steps` on the
port's one-process mesh of the same shape, bit for bit, and against the
JAX package (generation 0 LSB against ``window_samples``, the Welch
spectrum within 1e-6 relative of JAX's sharded analyzer on the conftest's
virtual mesh, the WOLA round trip under 2e-5).  Each child has a timeout
and is killed if it outlives it, pass or fail.
"""

import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_multiproc_child as child
from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.dist import mesh as jmesh
from blackman_harris_win_tpu.kernels.window import window_samples as jwindow_samples
from blackman_harris_win_tpu.pipeline import spectral as jsp
from blackman_harris_win_tpu_torch.dist.mesh import make_mesh

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parent
#: seconds every child together may take, start-up included
_TIMEOUT = 120
LAYOUTS = [(2, 4), (4, 2)]  # (processes, devices a process)
MESHES = {"a": 1, "b": 2}  # mesh label -> channels


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
def mp(request, tmp_path_factory):
    nprocs, per = request.param
    return nprocs, per, child.spawn(nprocs, per, tmp_path_factory.mktemp(f"mp{nprocs}"),
                                    timeout=_TIMEOUT)


@lru_cache(maxsize=None)
def _one_process(label: str) -> dict:
    """:func:`child.steps` on the port's one-process mesh of mesh ``label``'s
    shape (8 CPU devices)."""
    channels = MESHES[label]
    mesh = make_mesh(blocks=8 // channels, channels=channels, devices=["cpu"] * 8)
    return child.steps(mesh)


def _local(res: dict, label: str, step: str) -> dict:
    """(c, b) -> the shards of ``step`` on mesh ``label`` that child held."""
    pre = f"{label}/{step}/"
    return {tuple(int(v) for v in k[len(pre):].split(",")): t
            for k, t in res["tensors"].items() if k.startswith(pre)}


def _expected_ranks(nprocs: int, per: int, channels: int) -> list:
    flat = [r for r in range(nprocs) for _ in range(per)]
    blocks = len(flat) // channels
    return [flat[c * blocks:(c + 1) * blocks] for c in range(channels)]


@lru_cache(maxsize=None)
def _jax_welch(channels: int) -> np.ndarray:
    """JAX's sharded analyzer on the same input, on the conftest's virtual
    mesh of the same shape."""
    m = jmesh.make_mesh(blocks=8 // channels, channels=channels)
    step = jsp.make_sharded_welch(m, jconfig.WindowSpec(8, 17), child.BH4.quantized(17),
                                  child.BH4.shift, child.NFFT, child.HOP)
    x = jax.device_put(jnp.asarray(child.signal()), NamedSharding(m, P("channels", "blocks")))
    return np.asarray(jax.jit(step)(x))


def test_children_import_torch_only():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(_HERE)!r})\n"
            "import torch_multiproc_child\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'blackman_harris_win_tpu')\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=str(_REPO))
    assert r.returncode == 0, r.stderr


def test_every_process_reports(mp):
    nprocs, _, results = mp
    assert [r["pid"] for r in results] == list(range(nprocs))


@pytest.mark.parametrize("label", sorted(MESHES))
def test_pod_mesh_layout(mp, label):
    """Ranks gather in rank order, 'channels' the slow axis."""
    nprocs, per, results = mp
    want = _expected_ranks(nprocs, per, MESHES[label])
    for r in results:
        assert r[label]["ranks"] == want


@pytest.mark.parametrize("label", sorted(MESHES))
def test_generation_bit_exact_on_every_local_shard(mp, label):
    _, per, results = mp
    q = child.BH4.quantized(17)
    jspec = jconfig.WindowSpec(12, 17)
    want = np.asarray(jwindow_samples(jnp.arange(child.GEN_SPEC.n, dtype=jnp.int64), q, jspec))
    one = _one_process(label)["gen"]
    for r in results:
        shards = _local(r, label, "gen")
        assert len(shards) == per
        for (c, b), t in shards.items():
            assert torch.equal(t, one.shards[c][b])
            block = t.shape[-1]
            np.testing.assert_array_equal(t.numpy(), want[b * block:(b + 1) * block])


@pytest.mark.parametrize("label", sorted(MESHES))
def test_process_block_range_partitions_the_samples(mp, label):
    nprocs, per, results = mp
    n = child.GEN_SPEC.n
    grid = np.asarray(_expected_ranks(nprocs, per, MESHES[label]))
    per_col = n // grid.shape[1]
    for r in results:
        cols = sorted({int(j) for j in np.where(grid == r["pid"])[1]})
        assert r[label]["owned_cols"] == [cols[0], cols[-1] + 1]
        assert r[label]["block_range"] == [cols[0] * per_col, (cols[-1] + 1) * per_col]
    # the processes of one channel row cover the samples once
    row0 = sorted(r[label]["block_range"] for r in results if r["pid"] in set(grid[0].tolist()))
    assert row0[0][0] == 0 and row0[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(row0, row0[1:]))


@pytest.mark.parametrize("mp", [(4, 2)], indirect=True, ids=["4x2"])
def test_four_process_grid_rows(mp):
    """Processes 2 and 3 hold cells of channel row 1 only, yet feed the block
    columns those cells sit at (JAX: ``tests/multiproc_child4.py``)."""
    _, _, results = mp
    by_pid = {r["pid"]: r["b"] for r in results}
    n = child.GEN_SPEC.n
    assert by_pid[0]["owned_cols"] == [0, 2] == by_pid[2]["owned_cols"]
    assert by_pid[1]["owned_cols"] == [2, 4] == by_pid[3]["owned_cols"]
    assert by_pid[2]["block_range"] == [0, n // 2]
    assert by_pid[3]["block_range"] == [n // 2, n]


@pytest.mark.parametrize("label", sorted(MESHES))
def test_welch_across_processes(mp, label):
    """The halo and ``pmean`` across the process boundary: bit-equal to the
    one-process mesh (the sum keeps axis order), within 1e-6 of JAX."""
    _, per, results = mp
    one = _one_process(label)["welch"]
    jref = _jax_welch(MESHES[label])
    nrow = jref.shape[0] // MESHES[label]
    for r in results:
        shards = _local(r, label, "welch")
        assert len(shards) == per
        for (c, b), t in shards.items():
            assert torch.equal(t, one.shards[c][b])
            want = jref[c * nrow:(c + 1) * nrow]
            rel = np.max(np.abs(t.numpy().astype(np.float64) - want)) / np.abs(want).max()
            assert rel < 1e-6, rel
            assert int(t[0].argmax()) == (16 if c == 0 else 5)


@pytest.mark.parametrize("label", sorted(MESHES))
def test_stft_frames_and_wola_round_trip(mp, label):
    _, _, results = mp
    one = _one_process(label)
    x = child.signal()
    nrow = x.shape[0] // MESHES[label]
    for r in results:
        for step in ("stft", "istft"):
            for (c, b), t in _local(r, label, step).items():
                assert torch.equal(t, one[step].shards[c][b]), (step, c, b)
        for (c, b), t in _local(r, label, "istft").items():
            block = t.shape[-1]
            want = x[c * nrow:(c + 1) * nrow, b * block:(b + 1) * block]
            assert np.abs(t.numpy() - want).max() < 2e-5


@pytest.mark.parametrize("label", sorted(MESHES))
def test_channels_psum(mp, label):
    """On mesh B the 'channels' sum crosses the process boundary."""
    _, _, results = mp
    one = _one_process(label)["psum_channels"]
    x = child.signal()
    nrow = x.shape[0] // MESHES[label]
    total = sum(x[c * nrow:(c + 1) * nrow] for c in range(MESHES[label]))
    for r in results:
        for (c, b), t in _local(r, label, "psum_channels").items():
            assert torch.equal(t, one.shards[c][b])
            block = t.shape[-1]
            np.testing.assert_array_equal(t.numpy(), total[:, b * block:(b + 1) * block])


@pytest.mark.parametrize("label", sorted(MESHES))
def test_unshard_gathers_the_global_tensor_everywhere(mp, label):
    from blackman_harris_win_tpu_torch.dist.mesh import unshard

    _, _, results = mp
    one = _one_process(label)
    for name in child.GATHERED:
        want = unshard(one[name])
        for r in results:
            assert torch.equal(r["tensors"][f"{label}/unshard/{name}"], want), name


@pytest.mark.parametrize("label", sorted(MESHES))
def test_row_refuses_a_row_with_remote_cells(mp, label):
    _, _, results = mp
    for r in results:
        remote = any(rank != r["pid"] for rank in r[label]["ranks"][0])
        assert r[label]["row_raises"] is remote
