"""PyTorch port, resumable streaming (``utils/streaming.py``): a cursor saved
by either package loads in the other (the same JSON), ``stream_blocks``
visits the same blocks and checkpoints, and a generation resumed after a
crash equals the full window, 0 LSB against the JAX package."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.utils import streaming as js
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels.window import window_block
from blackman_harris_win_tpu_torch.utils import streaming as ps
from blackman_harris_win_tpu_torch.windows import catalog

SPECS = [WindowSpec(12, 17), WindowSpec(10, 32, rounding="rtl", overflow="wrap"),
         WindowSpec(11, 16, sin_type="taylor", lut_size=9)]


def _cursors(spec, next_block=3):
    q = catalog.get("bh4").quantized(spec.data_width)
    return (ps.StreamCursor(spec, q, block_len=256, next_block=next_block),
            js.StreamCursor(jconfig.WindowSpec(**vars(spec)), q, block_len=256,
                            next_block=next_block))


@pytest.mark.parametrize("spec", SPECS)
def test_cursor_crosses_packages(tmp_path, spec):
    cur, jcur = _cursors(spec)
    p, pj = tmp_path / "p.json", tmp_path / "j.json"
    cur.save(p)
    jcur.save(pj)
    assert json.loads(p.read_text()) == json.loads(pj.read_text())
    assert p.read_text() == pj.read_text()
    back, jback = ps.StreamCursor.load(pj), js.StreamCursor.load(p)
    assert back == cur and jback == jcur
    assert (back.next_sample, back.total_blocks, back.done) == \
        (jback.next_sample, jback.total_blocks, jback.done) == (768, spec.n // 256, False)
    assert not list(tmp_path.glob("*.tmp"))  # the atomic write leaves no temp file


def test_advanced_and_done():
    cur, _ = _cursors(WindowSpec(10, 17), next_block=0)
    assert cur.advanced(4).done and not cur.advanced(3).done
    assert cur.advanced(2).next_sample == 512 and cur.next_block == 0


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_stream_blocks_visit_the_same_blocks(tmp_path, with_checkpoint):
    cur, jcur = _cursors(WindowSpec(11, 17), next_block=2)
    p, pj = (tmp_path / "p.json", tmp_path / "j.json") if with_checkpoint else (None, None)

    def visit(blocks, path):  # (block, n0, checkpoint on entry) per block
        return [(c.next_block, n0, path.read_text() if path and path.exists() else None)
                for c, n0 in blocks]

    got, want = visit(ps.stream_blocks(cur, p), p), visit(js.stream_blocks(jcur, pj), pj)
    assert [g[:2] for g in got] == [(b, 256 * b) for b in range(2, 8)]
    assert got == want  # the same blocks, and the same checkpoint before each
    assert (got[-1][2] is not None) == with_checkpoint
    if with_checkpoint:
        assert ps.StreamCursor.load(pj).done and js.StreamCursor.load(p).done


@pytest.mark.parametrize("spec", SPECS)
def test_resume_after_a_crash_equals_the_window(tmp_path, spec):
    q = catalog.get("bh4" if spec.sin_type == "cordic" else "hamming").quantized(spec.data_width)
    blk = 128
    p = tmp_path / "c.json"
    out = np.zeros(spec.n, np.int64)
    it = ps.stream_blocks(ps.StreamCursor(spec, q, block_len=blk), p)
    for _ in range(3):
        _, n0 = next(it)
        out[n0:n0 + blk] = window_block(n0, blk, q, spec, device="cpu").numpy()
    # at-least-once: the checkpoint trails the consumed block by one
    resumed = js.StreamCursor.load(p)  # the other package resumes the run
    assert resumed.next_block == 2
    for _, n0 in ps.stream_blocks(ps.StreamCursor.load(p), p):
        out[n0:n0 + blk] = window_block(n0, blk, q, spec, device="cpu").numpy()
    want = np.asarray(jkw.window_samples(jnp.arange(spec.n), q,
                                         jconfig.WindowSpec(**vars(spec))))
    np.testing.assert_array_equal(out, want)
    assert ps.StreamCursor.load(p).done
