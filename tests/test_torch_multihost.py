"""PyTorch port, ``dist/multihost.py`` in one process (the twin of
``tests/test_multihost.py``): ``owned_block_cols`` on the three layouts of
the JAX tests, the degenerate single-process ``process_block_range``,
``initialize`` staying alone without arguments and raising when an
explicit two-process start-up fails, ``pod_mesh`` over explicit devices
(never the CPU unless asked, JAX's divisibility errors), and a mesh whose
cells another process holds: ``shard`` leaves ``Remote`` placeholders,
``local_map`` passes them by and ``row`` refuses them.  The real
multi-process runs are ``tests/test_torch_multiprocess.py``."""

import socket
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from blackman_harris_win_tpu.dist import multihost as jmultihost
from blackman_harris_win_tpu.dist.mesh import make_mesh as jmake_mesh
from blackman_harris_win_tpu_torch.dist import multihost
from blackman_harris_win_tpu_torch.dist.mesh import (
    Mesh,
    Remote,
    local_map,
    make_mesh,
    process_count,
    process_index,
    shard,
)

GRIDS = {
    # 2 channels x 4 blocks; process 0 holds the left half, process 1 the right
    "two processes split blocks": np.array([[0, 0, 1, 1], [0, 0, 1, 1]]),
    # processes 1 and 2 hold cells on channel row 1 only
    "non-zero channel row only": np.array([[0, 0, 0, 0], [1, 1, 2, 2]]),
    # channels span processes (the pod_mesh layout)
    "channels across processes": np.array([[0, 0], [1, 1], [2, 2]]),
}


class TestOwnedBlockCols:
    @pytest.mark.parametrize("layout", sorted(GRIDS))
    def test_matches_jax(self, layout):
        grid = GRIDS[layout]
        for pid in range(4):
            assert multihost.owned_block_cols(grid, pid) == jmultihost.owned_block_cols(grid, pid)

    def test_layouts(self):
        g = GRIDS["two processes split blocks"]
        assert [multihost.owned_block_cols(g, p) for p in (0, 1, 2)] == [(0, 2), (2, 4), (0, 0)]
        g = GRIDS["non-zero channel row only"]
        assert [multihost.owned_block_cols(g, p) for p in (0, 1, 2)] == [(0, 4), (0, 2), (2, 4)]
        g = GRIDS["channels across processes"]
        assert all(multihost.owned_block_cols(g, p) == (0, 2) for p in (0, 1, 2))


class TestSingleProcess:
    def test_degenerate_process_block_range(self):
        mesh = make_mesh(blocks=4, channels=2, devices=["cpu"] * 8)
        assert multihost.process_block_range(4096, mesh) == (0, 4096)
        assert multihost.process_block_range(4096, mesh) == jmultihost.process_block_range(
            4096, jmake_mesh(blocks=4, channels=2))

    def test_initialize_without_arguments_stays_alone(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(k, raising=False)
        multihost.initialize()
        assert not dist.is_initialized()
        assert (process_index(), process_count()) == (0, 1)

    def test_failed_explicit_start_up_raises_within_its_timeout(self):
        with socket.socket() as s:  # a localhost port nobody listens on
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            multihost.initialize(backend="gloo", init_method=f"tcp://localhost:{port}",
                                 world_size=2, rank=1, timeout=timedelta(seconds=2))
        assert time.monotonic() - t0 < 60
        assert not dist.is_initialized()


class TestPodMesh:
    def test_never_the_cpu_unless_asked(self):
        if torch.cuda.is_available():
            m = multihost.pod_mesh()
            assert all(d.type == "cuda" for row in m.devices for d in row)
        else:
            with pytest.raises(ValueError, match="no local devices"):
                multihost.pod_mesh()

    @pytest.mark.parametrize("channels,blocks", [(1, None), (2, None), (4, None), (2, 2)])
    def test_layout_over_explicit_devices(self, channels, blocks):
        m = multihost.pod_mesh(channels=channels, blocks=blocks, local_devices=["cpu"] * 4)
        assert m.shape == {"channels": channels, "blocks": 4 // channels}
        assert m.ranks == ((0,) * (4 // channels),) * channels
        assert all(d == torch.device("cpu") for row in m.devices for d in row)

    def test_divisibility_errors_are_jax_s(self):
        with pytest.raises(ValueError, match="4 devices not divisible by 3"):
            multihost.pod_mesh(channels=3, local_devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="mesh 2x4 != 4 global devices"):
            multihost.pod_mesh(channels=2, blocks=4, local_devices=["cpu"] * 4)


class TestRemoteCells:
    """A mesh whose cells 2 and 3 another process (rank 1) holds."""

    MESH = Mesh([["cpu"] * 4], ranks=[[0, 0, 1, 1]])

    def test_shard_builds_local_pieces_only(self):
        x = torch.arange(16.0).reshape(2, 8)
        s = shard(x, self.MESH, ("channels", "blocks"))
        assert s.shards[0][2] == Remote(1) and s.shards[0][3] == Remote(1)
        assert sorted(s.local_shards()) == [(0, 0), (0, 1)]
        assert torch.equal(s.piece(), x[:, :2])
        assert torch.equal(s.local_shards()[0, 1], x[:, 2:4])

    def test_row_refuses_remote_cells(self):
        s = shard(torch.zeros(8), self.MESH, ("blocks",))
        with pytest.raises(ValueError, match=r"processes \[1\]"):
            s.row(0)

    def test_local_map_keeps_the_placeholders(self):
        s = shard(torch.arange(8.0), self.MESH, ("blocks",))
        out = local_map(lambda i, t: t * i, range(4), s.shards[0])
        assert out[2:] == [Remote(1), Remote(1)]
        assert torch.equal(out[1], torch.tensor([2.0, 3.0]))

    def test_cells(self):
        assert self.MESH.cell(0, 1) == torch.device("cpu")
        assert self.MESH.cell(0, 3) == Remote(1)

    def test_rank_grid_must_match(self):
        with pytest.raises(ValueError, match="rank grid"):
            Mesh([["cpu"] * 4], ranks=[[0, 0]])
