"""One ``torch.profiler`` session around the measured window, reduced to the
summary the per-layer metrics read.

The session traces the host and, where there is a card, the device
(CUPTI); its Chrome trace is written to a temporary directory under
``TMPDIR``, read back and deleted.  Only one session runs in a process: a
second one has been seen to lose the kernels launched through ctypes.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

WINDOW = "portbench.window"
CALL = "portbench.call"
SYNC = "portbench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: entries of each breakdown list
TOP = 10


@contextlib.contextmanager
def profiled(on: bool, cuda: bool):
    """Yields a holder whose ``summary`` is set after the block: the trace
    reduced by :func:`summarize` (``None`` when ``on`` is false)."""
    holder = SimpleNamespace(summary=None)
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tmp = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield holder
            if cuda:
                torch.cuda.synchronize()
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        holder.summary = summarize(json.loads(path.read_text())["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _label(events, tid, points) -> list[str]:
    """For each time in ``points``, the innermost host event of thread
    ``tid`` open at it (host events of one thread nest, so a stack sweep)."""
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid),
                  key=lambda h: (h[0], -h[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out, stack, k = [""] * len(points), [], 0
    for j in order:
        t = points[j]
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[j] = stack[-1][2] if stack else "host, outside any recorded operation"
    return out


def summarize(events: list) -> dict:
    """Window span, device busy time, device operations, the device time by
    operation name and the idle time by what the host was doing (seconds;
    the trace's clock is microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1), e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] < w1]
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    busy = _union((a, b) for a, b, _ in dev)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    idle = defaultdict(float)
    labels = _label(events, win[0].get("tid"), [(a + b) / 2 for a, b in gaps])
    for (a, b), name in zip(gaps, labels):
        idle[name] += (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": len(dev), "device_ops_top": top(by_name), "idle_top": top(idle)}
