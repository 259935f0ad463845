"""Streaming state: checkpoint / resume of the generation pipeline
(counterpart of ``blackman_harris_win_tpu/utils/streaming.py``; the same
JSON format, so a cursor saved by either package loads in the other).

The reference's entire mutable state is a handful of phase counters
(``src/bh_win_7term.vhd:176-197``); RESET is its only recovery mechanism.
Because phases are computed closed-form, pipeline state reduces to
*(block index, static config, coefficients)*: recovery is "recompute from
the block index", resumable by construction.

``StreamCursor`` is that state as a tiny JSON-serializable record, so a
2^26-point generation (or a long spectral-analysis run) interrupted at any
block restarts exactly where it stopped, on any host, with no tensors to
checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass

from ..core.config import WindowSpec


@dataclass(frozen=True)
class StreamCursor:
    """Resumable position of a block-streamed window generation/apply run."""

    spec: WindowSpec
    coeffs_q: tuple[int, ...]
    block_len: int
    next_block: int = 0

    @property
    def next_sample(self) -> int:
        return self.next_block * self.block_len

    @property
    def total_blocks(self) -> int:
        return self.spec.n // self.block_len

    @property
    def done(self) -> bool:
        return self.next_block >= self.total_blocks

    def advanced(self, blocks: int = 1) -> "StreamCursor":
        return dataclasses.replace(self, next_block=self.next_block + blocks)

    # -- persistence (atomic write; state is O(100) bytes) --

    def save(self, path) -> None:
        path = pathlib.Path(path)
        payload = {
            "spec": dataclasses.asdict(self.spec),
            "coeffs_q": list(self.coeffs_q),
            "block_len": self.block_len,
            "next_block": self.next_block,
        }
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)

    @classmethod
    def load(cls, path) -> "StreamCursor":
        payload = json.loads(pathlib.Path(path).read_text())
        return cls(
            spec=WindowSpec(**payload["spec"]),
            coeffs_q=tuple(payload["coeffs_q"]),
            block_len=payload["block_len"],
            next_block=payload["next_block"],
        )


def stream_blocks(cursor: StreamCursor, checkpoint_path=None):
    """Generator of (cursor, n0) pairs for the remaining blocks; optionally
    persists the advanced cursor when control re-enters the generator.

    Checkpointing is at-least-once: a crash mid-block resumes *at* that
    block, which is safe because generation is deterministic and idempotent
    (closed-form phases — recomputing a block yields identical samples).
    """
    while not cursor.done:
        yield cursor, cursor.next_sample
        cursor = cursor.advanced()
        if checkpoint_path is not None:
            cursor.save(checkpoint_path)
