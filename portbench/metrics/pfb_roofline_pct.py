"""The least time the PFB spectrometer calls of the traced window need
(``roofline_pfb.pfb_work``: the int8 capture read and the power written
once; the branch FIRs, the real DFT and the power in float32; the larger
of bytes and flops) over the device's busy time in it."""

from portbench import roofline_pfb

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "chain", "msamples_per_s"


def read(s: dict):
    t, w = s.get("trace"), s["work"]
    if not t or t["busy_s"] <= 0 or w["model"] != "pfb":
        return None
    return 100.0 * roofline_pfb.chain_bound(w) / t["busy_s"]
