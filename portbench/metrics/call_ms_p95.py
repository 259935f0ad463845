"""The 95th percentile of the wall time of every call in the window, from
its start to the end of the synchronize that follows it (host clock)."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(s: dict):
    return float(np.percentile(s["call_s"], 95)) * 1e3
