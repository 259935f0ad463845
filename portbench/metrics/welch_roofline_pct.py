"""The least time the Welch spectra of the traced window need
(``roofline.welch_work``: the capture, window and spectrum bytes; the
window products, real FFTs, power and mean in float32) over the device's
busy time in it."""

from portbench import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "analyzer", "msamples_per_s"


def read(s: dict):
    t, w = s.get("trace"), s["work"]
    if not t or t["busy_s"] <= 0 or w["model"] != "welch":
        return None
    return 100.0 * roofline.bound(w["bytes"], w["ops"], w["rate"])[0] / t["busy_s"]
