"""A checkout root in a temporary folder holding the benchmark's own files
with the cells cut to sizes a CPU test holds: the same configurations,
traffic, entries and metrics, the window, its blocks and the captures
shorter."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import harness, layout

REPO = layout.ROOT
GEN, WELCH = "gen_bh7_w32.table64m", "welch_bh4_w17.nfft1m"
#: key -> value replaced in a configuration or traffic file, by file name
CUTS = {
    "configs/gen_bh7_w32.json": {"phase_width": 12},
    "configs/welch_bh4_w17.json": {"phase_width": 10, "hop": 512},
}


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / harness.PROGRAM).symlink_to(REPO / harness.PROGRAM)
    for rel, cut in CUTS.items():
        edit(root / "portbench" / rel, cut)
    edit(root / "portbench/traffic/table64m.json", {"block": 1 << 12})
    edit(root / "portbench/traffic/nfft1m.json", {}, captures={"samples": 1 << 14})
    return root


def edit(path: Path, cut: dict, **nested) -> None:
    d = json.loads(path.read_text())
    d.update(cut)
    for key, sub in nested.items():
        d[key] = dict(d[key], **sub)
    path.write_text(json.dumps(d))


def run(root: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 0.2, trace: int = 0,
        control: bool = False):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    return harness.run(argv, time.perf_counter(), root=root, device="cpu", control=control)
