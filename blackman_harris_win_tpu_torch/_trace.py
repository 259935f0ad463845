"""Spans inside the port, on the profiler's clock.

A span names a stage of a call (``bhw.welch.fft``, ``bhw.launch.<counter>``).
While a ``torch.profiler`` session records (``utils.profiling.trace``, a
benchmark's or an operator's own), each span opens a ``record_function`` of
its name, so it lies on the trace's timeline around the operations and
kernels it launched, and adds to a table kept in this process, keyed by its
path (its parents' names and its own, joined by ``/``):

- ``count``: the spans closed;
- ``host_s``: their host seconds, the profiler's recording of what ran
  inside them and of the span itself included;
- ``self_s``: ``host_s`` less what their child spans cover;
- ``stream_s`` and ``stream_n``: for a span given a CUDA device, the time
  between two events recorded on the device's current stream at its entry
  and exit, summed over the ``stream_n`` pairs resolved so far (a pair is
  resolved once both events have completed, so nothing grows with the
  calls);
- ``nbytes``: the bytes the span's caller states its stage's tensors read
  and write.

With no session recording, :func:`span` returns one shared no-op context
after one check: no ``record_function``, no clock, no table.  A session is
the only switch.  This module imports nothing else from the package at
import time, so ``_build`` and every wrapper can use it.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
#: path -> the sums of the spans closed on it while a session recorded
_table: dict[str, dict] = {}
#: the open spans, innermost last
_stack: list["_Span"] = []
#: (table row, device index, start event, end event) not yet resolved, oldest
#: first
_pending: collections.deque = collections.deque()
#: device index -> timing events free for reuse
_free: dict[int, list] = {}
#: pairs held before the completed ones are resolved (each query of an event
#: is a runtime call the profiler records)
PENDING = 32


def span(name: str, device=None, nbytes: int = 0):
    """A context that records the stage ``name`` while a profiler session
    records, and does nothing otherwise.  ``device``: a CUDA device whose
    current stream the stage runs on, for its stream time (any other
    device, or none, records none).  ``nbytes``: what the stage's tensors
    read and write, from their sizes."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device, nbytes)


class _Span:
    __slots__ = ("name", "device", "nbytes", "key", "child_s", "rf", "stream", "events", "t0")

    def __init__(self, name: str, device, nbytes: int):
        self.name, self.nbytes = name, nbytes
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.key = f"{_stack[-1].key}/{self.name}" if _stack else self.name
        self.child_s = 0.0
        _stack.append(self)
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (_event(self.device), _event(self.device))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        host_s = time.perf_counter() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child_s += host_s
        row = _table.get(self.key)
        if row is None:
            row = _table[self.key] = {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                      "stream_s": 0.0, "stream_n": 0, "nbytes": 0}
        row["count"] += 1
        row["host_s"] += host_s
        row["self_s"] += host_s - self.child_s
        row["nbytes"] += self.nbytes
        if self.events is not None:
            _pending.append((row, self.device.index, *self.events))
            if len(_pending) > PENDING:
                _resolve(wait=False)
        return False


def _event(device: torch.device):
    free = _free.get(device.index)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _resolve(wait: bool) -> None:
    """Add the stream time of each pending pair to its row, oldest first,
    while its end event has completed (``wait``: all of them, waiting)."""
    while _pending:
        row, index, start, end = _pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        row["stream_s"] += start.elapsed_time(end) * 1e-3
        row["stream_n"] += 1
        _free.setdefault(index, []).extend((start, end))


def snapshot() -> dict:
    """``{"spans": path -> sums, "launches": _build.launches}``, each a copy;
    waits for the stream time of spans still running on the device."""
    from ._build import launches

    _resolve(wait=True)
    return {"spans": {k: dict(v) for k, v in _table.items()}, "launches": dict(launches)}


def reset() -> None:
    """Empty the table, once the pending stream times have resolved."""
    _resolve(wait=True)
    _table.clear()
