"""One run of one cell: set-up, the measured window, the comparison, the
result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. The cell's files are found by name (:mod:`portbench.layout`) and the
   card is looked for: without a CUDA device, or with fewer than the cell
   asks for, the run exits with 2 and prints no result.
2. The program is imported from this checkout; its kernel build lands in
   the checkout's ``build/`` (the program's own ``build/cuda``, and the
   torch-extension and Triton caches the benchmark gives it).
3. The entry makes the inputs on the card from the seed and runs its
   warm-up calls: every shape the window will use.  That, and everything
   before it, is ``setup_s``.
4. The window: a closed loop, one call in flight, each call timed on the
   host clock from its start to the end of the synchronize after it,
   until ``--seconds`` have passed.  With ``--trace 1`` a second window
   follows, inside one profiler session; the per-layer metrics read that
   one, and the host time a call takes from the first.
5. After the window: the JAX check (``jax``, ``jaxlib``, ``flax`` or the
   JAX package loaded exits with 3), the peak memory, then the comparison
   of the kept outputs with the plain reference.
6. The last line of standard output: one JSON object, its last key
   ``checks``, each compared number beside its limit; the same numbers are
   the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench import layout, traffic as gen_traffic, tracing

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "blackman_harris_win_tpu")
PROGRAM = "blackman_harris_win_tpu_torch"


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module names, compared whole
    (``blackman_harris_win_tpu_torch`` is not ``blackman_harris_win_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(code: int, msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def import_program(root: Path):
    """The program's package, from ``root`` and nowhere else."""
    import importlib

    pkg = importlib.import_module(PROGRAM)
    where = Path(pkg.__file__).resolve().parent
    if where != (root / PROGRAM).resolve():
        raise ImportError(f"{PROGRAM} was found at {where}, not in the checkout {root}")
    return pkg


def _power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def measure(entry, seconds: float, sync, kept_calls: set, trace: bool, cuda: bool):
    """The window: returns its record and the kept outputs."""
    from torch.profiler import record_function

    call_s, host_s, kept = [], [], []
    stale, i = 0, 0
    prev = out = None
    with tracing.profiled(trace, cuda) as traced:
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if trace:
                with record_function(tracing.CALL):
                    out = entry.call(i)
                t1 = time.perf_counter()
                with record_function(tracing.SYNC):
                    sync()
            else:
                out = entry.call(i)
                t1 = time.perf_counter()
                sync()
            t2 = time.perf_counter()
            call_s.append(t2 - t0)
            host_s.append(t1 - t0)
            if prev is not None and out.untyped_storage().data_ptr() == \
                    prev.untyped_storage().data_ptr():
                stale += 1
            if i in kept_calls:
                kept.append(entry.keep(i, out))
            prev, i = out, i + 1
            if t2 - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
    if i - 1 not in kept_calls:
        kept.append(entry.keep(i - 1, out))
    works = [entry.work(j) for j in range(i)]
    work = dict(works[0], bytes=sum(w["bytes"] for w in works), ops=sum(w["ops"] for w in works))
    samples = sum(entry.samples(j) for j in range(i))
    return {"calls": i, "samples": samples, "window_s": window_s, "call_s": call_s,
            "host_s": host_s, "stale_calls": stale, "work": work,
            "trace": traced.summary}, kept


def run(argv, t0: float, root: Path = layout.ROOT, device=None, control: bool = False):
    """One run; returns (exit code, result dict or None).  ``device`` given
    skips the look for a card (the CPU tests); ``control`` judges the
    control's outputs in place of the program's (the calibration)."""
    a = _args(argv)
    try:
        cell = layout.load_cell(a.workload, root)
    except (KeyError, ValueError, FileNotFoundError) as e:
        return _fail(2, str(e)), None
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    phases = [("start", t0)]
    import torch

    phases.append(("torch import", time.perf_counter()))

    cuda = device is None
    if cuda:
        if not torch.cuda.is_available():
            return _fail(2, "torch sees no CUDA device; this benchmark runs on the card only"), None
        if torch.cuda.device_count() < cell.chips:
            return _fail(2, f"the cell needs {cell.chips} cards, torch sees "
                            f"{torch.cuda.device_count()}"), None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device)
    torch.empty(1, device=device)
    phases.append(("CUDA context", time.perf_counter()))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        import_program(root)
    except ImportError as e:
        return _fail(4, f"the program cannot be imported from the checkout: {e}"), None
    phases.append(("program import", time.perf_counter()))
    entry = layout.load_module(root, "entries", cell.entry).Entry(
        cell.config, cell.traffic, a.seed, device)
    sync()
    phases.append(("inputs", time.perf_counter()))
    t_warm = 0.0
    for i in entry.warm_calls():
        tw = time.perf_counter()
        entry.call(i)
        sync()
        t_warm = time.perf_counter() - tw
    expected = int(0.8 * a.seconds / max(t_warm, 1e-6))
    kept_calls = gen_traffic.compared_calls(cell.traffic, a.seed, expected)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    phases.append(("warm-up (the kernels' build or load, first calls)", t0 + setup_s))
    print("set-up: " + ", ".join(f"{name} {t - t_before:.3f} s" for (_, t_before), (name, t)
                                 in zip(phases, phases[1:])), file=sys.stderr)

    rec, kept = measure(entry, a.seconds, sync, kept_calls, False, cuda)
    if a.trace:
        # then the traced window; the host time a call takes stays the
        # untraced window's, the profiler's recording being most of it there
        traced, kept_traced = measure(entry, a.seconds, sync, kept_calls, True, cuda)
        rec = dict(traced, host_s=rec["host_s"], untraced_calls=rec["calls"],
                   stale_calls=rec["stale_calls"] + traced["stale_calls"])
        kept += kept_traced

    half = len(rec["call_s"]) // 2
    print("window: {} calls; call ms p5 {:.4f} p50 {:.4f} p95 {:.4f}, first half p50 {:.4f}, "
          "second {:.4f}; host ms p50 {:.4f}".format(
              rec["calls"], *(1e3 * float(v) for v in (
                  np.percentile(rec["call_s"], 5), np.median(rec["call_s"]),
                  np.percentile(rec["call_s"], 95), np.median(rec["call_s"][:half]),
                  np.median(rec["call_s"][half:]), np.median(rec["host_s"])))),
          file=sys.stderr)
    found = forbidden_modules(sys.modules)
    if found:
        return _fail(3, f"the run loaded {', '.join(found)}, which the port may not use"), None
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec.update(setup_s=setup_s, window_peak_bytes=window_peak, entry=cell.entry)
    entry.release()
    if control:
        kept = entry.control(kept)
    checks = dict(entry.judge(kept), stale_calls=(rec["stale_calls"], 0))
    correct = all(v <= lim for v, lim in checks.values())

    kind = "per_layer" if a.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        v = layout.load_module(root, "metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if a.trace and rec["trace"]:
        dev.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
    if cuda:
        dev["power_limit"] = _power_limit()
    out = {"correct": correct, "attempted": rec["calls"] + rec.get("untraced_calls", 0),
           "failed": 0 if correct else len(kept), "metrics": metrics, "device": dev}
    if a.trace and rec["trace"]:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops_top"],
                            "idle_gaps": rec["trace"]["idle_top"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return 0, out


def main(argv, t0: float) -> int:
    code, out = run(argv, t0)
    if out is None:
        return code
    for k, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return code
