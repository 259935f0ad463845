"""The share of the traced window in which no device operation runs: one
minus the union of kernel, memcpy and memset intervals over the window's
span."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "msamples_per_s"


def read(s: dict):
    t = s.get("trace")
    if not t or t["window_s"] <= 0 or t["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
