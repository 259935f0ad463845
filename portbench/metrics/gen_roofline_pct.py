"""The least time the window samples of the traced window need
(``roofline.cordic_window_work``: 4 bytes a sample written, the CORDIC
operations at the int32 issue rate) over the device's busy time in it."""

from portbench import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "msamples_per_s"


def read(s: dict):
    t, w = s.get("trace"), s["work"]
    if not t or t["busy_s"] <= 0 or w["model"] != "cordic_window":
        return None
    return 100.0 * roofline.bound(w["bytes"], w["ops"], w["rate"])[0] / t["busy_s"]
