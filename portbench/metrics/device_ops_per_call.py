"""Device operations (kernels, memcpys, memsets) in the traced window over
the calls: a count that fusing launches changes."""

UNIT, BETTER, SOURCE = "ops", "lower", "device_trace"
LAYER, MOVES = "dispatch", "msamples_per_s"


def read(s: dict):
    t = s.get("trace")
    if not t or t["device_ops"] == 0:
        return None
    return t["device_ops"] / s["calls"]
