"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import re

import pytest

from portbench import layout

ROOT = layout.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:  # a file of the repo: under paths
            assert any(word.startswith(p + "/") for p in BENCH["paths"]) and (ROOT / word).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_metric_names_unique_across_kinds():
    assert not set(E2E) & set(PER_LAYER)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(m):
    per_layer = m["name"] in PER_LAYER
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(m) <= keys | {"workloads"}
    assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if per_layer:
        assert _line(m["layer"]) and m["moves"] in E2E
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in m.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_module_declares_the_same(m):
    mod = layout.load_module(ROOT, "metrics", m["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"], m["source"])
    if m["name"] in PER_LAYER:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    assert callable(mod.read)


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
    assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    f = json.loads((ROOT / c["file"]).read_text())
    assert c["file"] == f"portbench/configs/{c['name']}.json" and f["name"] == c["name"]
    assert f["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert all(NAME.fullmatch(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c2["file"] for c2 in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
    cell = layout.load_cell(w["name"])
    assert cell.chips == w["chips"]
    assert (ROOT / "portbench/entries" / f"{cell.entry}.py").is_file()
    names = {m["name"] for m in cell.metrics}
    assert "setup_s" in names and len(names & set(E2E)) >= 2 and names & set(PER_LAYER)
    for m in BENCH["per_layer"]:  # each reports the end-to-end metric it moves
        if m["name"] in names:
            assert m["moves"] in names


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_size():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_bad_names_never_leave_their_folder():
    for bad in ("../BENCHMARK", "a/b", "", ".hidden", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            layout.check_name(bad)
