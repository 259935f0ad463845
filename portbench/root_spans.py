"""Stage stream time a call of a chain whose root span :data:`spans.ROOTS`
does not list (``spans.ROOTS`` is frozen with the benchmark that first
read it): the roots are counted from the program's span table by name."""

from __future__ import annotations

from portbench import spans


def stream_ms_per_call(s: dict, root: str, stages: tuple[str, ...]) -> float | None:
    """The stream time of the spans named in ``stages`` (at any depth, those
    with stream time), summed, over the count of ``root`` root spans, in
    ms; None without a trace, a program table, a root or such a span."""
    if not s.get("trace"):
        return None
    table = spans.table()
    if not table:
        return None
    calls = table.get(root, {}).get("count", 0)
    rows = [row for path, row in table.items()
            if path.rsplit("/", 1)[-1] in stages and row["stream_n"]]
    if not calls or not rows:
        return None
    return sum(row["stream_s"] for row in rows) / calls * 1e3
