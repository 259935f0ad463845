"""The program's own spans, for the ``program_span`` metrics.

The port keeps a table of its spans while a profiler session records
(``blackman_harris_win_tpu_torch._trace``): per path of span names, the
count, host seconds and, for its device stages, stream seconds.  A metric
reads it after the traced window, per call: over the count of the root
spans, one a call of an entry.  A program without the table (an older
checkout) and a run without a trace read nothing.
"""

from __future__ import annotations

import importlib

#: the program's root spans: ``kernels.window.window_block`` (the gen
#: entry) and ``pipeline.spectral.windowed_power_spectrum`` (the welch entry)
ROOTS = ("bhw.window_block", "bhw.welch")


def table() -> dict | None:
    """The program's span table (path -> sums), or None where it has none."""
    try:
        trace = importlib.import_module("blackman_harris_win_tpu_torch._trace")
    except ImportError:
        return None
    return trace.snapshot()["spans"]


def per_call(s: dict, field: str, names: tuple[str, ...], roots: bool = False) -> float | None:
    """The sum of ``field`` over the spans named in ``names`` (``roots``:
    only where they are roots), over the count of root spans; None without
    a trace, a root or such a span (for ``stream_s``, one with stream
    time)."""
    if not s.get("trace"):
        return None
    spans = table()
    if not spans:
        return None
    calls = sum(row["count"] for path, row in spans.items() if path in ROOTS)
    rows = [row for path, row in spans.items()
            if (path if roots else path.rsplit("/", 1)[-1]) in names
            and (field != "stream_s" or row["stream_n"])]
    if not calls or not rows:
        return None
    return sum(row[field] for row in rows) / calls
