"""The median host time from a call's start to its return, before the
synchronize, reported by the ``--trace 1`` run and taken in its first,
untraced window (host clock): the profiler's recording of each host
operation would be most of it in the traced one."""

import statistics

UNIT, BETTER, SOURCE = "us", "lower", "host_clock"
LAYER, MOVES = "dispatch", "msamples_per_s"


def read(s: dict):
    if not s.get("trace"):
        return None
    return statistics.median(s["host_s"]) * 1e6
