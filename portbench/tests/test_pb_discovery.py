"""A configuration, a traffic mix, a cell, an entry and metrics dropped in as
new files, with new entries in ``BENCHMARK.json``, run without an edit to
any file the benchmark has."""

import json

from portbench.tests import tiny

ENTRY = '''
from portbench.entries.gen import Entry as Gen


class Entry(Gen):
    """Generation of the window's first half from 0, through ``window_block``."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        half = self.spec.n // 2
        self.blocks = lambda i: (0, half)
'''
E2E_METRIC = '''
UNIT, BETTER, SOURCE = "calls", "higher", "host_clock"


def read(s):
    return float(s["calls"])
'''
LAYER_METRIC = '''
UNIT, BETTER, SOURCE = "s", "lower", "device_trace"
LAYER, MOVES = "device", "calls_done"


def read(s):
    t = s.get("trace")
    return None if not t else t["window_s"]
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/gen_bh7_w32.json").read_text())
    cfg.update(name="gen_bh4_w17", window="bh4", data_width=17, phase_width=11)
    (pb / "configs/gen_bh4_w17.json").write_text(json.dumps(cfg))
    (pb / "traffic/half.json").write_text(json.dumps({"block": 1024, "compare": 2}))
    (pb / "traffic/blocks.json").write_text(
        json.dumps({"block": 300, "compare": 3}))
    (pb / "cells/gen_bh7_w32.blocks.json").write_text(
        json.dumps({"config": "gen_bh7_w32", "traffic": "blocks", "entry": "gen"}))
    (pb / "cells/gen_bh4_w17.half.json").write_text(
        json.dumps({"config": "gen_bh4_w17", "traffic": "half", "entry": "gen_half"}))
    (pb / "entries/gen_half.py").write_text(ENTRY)
    (pb / "metrics/calls_done.py").write_text(E2E_METRIC)
    (pb / "metrics/traced_window_s.py").write_text(LAYER_METRIC)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gen_bh4_w17", "source": "https://example.org/x",
                         "file": "portbench/configs/gen_bh4_w17.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "gen_bh4_w17.half", "config": "gen_bh4_w17",
                           "traffic": "half", "chips": 1, "why": "a test"})
    b["workloads"].append({"name": "gen_bh7_w32.blocks", "config": "gen_bh7_w32",
                           "traffic": "blocks", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["gen_bh4_w17.half"]})
    b["per_layer"].append({"name": "traced_window_s", "unit": "s", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "calls_done", "workloads": ["gen_bh4_w17.half"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    code, out = tiny.run(root, "gen_bh4_w17.half")
    assert code == 0 and out["correct"]
    assert out["metrics"]["calls_done"]["value"] == out["attempted"]
    assert {"msamples_per_s", "call_ms_p95", "setup_s"} <= set(out["metrics"])
    code, out = tiny.run(root, "gen_bh4_w17.half", trace=1)
    assert code == 0 and out["correct"] and "traced_window_s" in out["metrics"]
    code, out = tiny.run(root, "gen_bh7_w32.blocks")
    assert code == 0 and out["correct"] and "calls_done" not in out["metrics"]
    # the cells that were there do not report the new metrics
    code, out = tiny.run(root, tiny.GEN)
    assert code == 0 and "calls_done" not in out["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())
