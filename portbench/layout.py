"""Find a cell's files by name.

A name from ``BENCHMARK.json`` or the command line becomes a file under
``<root>/portbench/<kind>/``; nothing lists the files in code, so a later
change adds a cell, a configuration, a traffic mix, an entry or a metric as
new files and new entries in ``BENCHMARK.json`` alone.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: the root of the checkout that holds this benchmark
ROOT = Path(__file__).resolve().parent.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str) -> str:
    """A name as ``BENCHMARK.json`` allows it (so it never leads out of its
    folder); raises ValueError otherwise."""
    if not NAME.fullmatch(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / "portbench" / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    """``<root>/portbench/<kind>/<name>.py`` as a module of its own."""
    path = root / "portbench" / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module named {name!r} ({path})")
    mod_name = f"_portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: str
    metrics: list  # BENCHMARK.json's metric entries that this cell reports


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell``."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    b = bench(root)
    found = [w for w in b["workloads"] if w["name"] == check_name(name)]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    c = load_json(root, "cells", name)
    for key in ("config", "traffic"):
        if c[key] != w[key]:
            raise ValueError(f"cells/{name}.json names {key} {c[key]!r}, "
                             f"BENCHMARK.json {w[key]!r}")
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in b[kind] if reports(m, name)]
    return Cell(name, int(w["chips"]), load_json(root, "configs", w["config"]),
                load_json(root, "traffic", w["traffic"]), check_name(c["entry"]), metrics)
