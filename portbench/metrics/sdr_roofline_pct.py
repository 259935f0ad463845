"""The least time the SDR chain calls of the traced window need
(``roofline_sdr.chain_bound``: the capture read and the output written
once; the branch FIRs and the DFT in float32; the discriminator's integer
operations; the largest of the three) over the device's busy time in it."""

from portbench import roofline_sdr

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "chain", "msamples_per_s"


def read(s: dict):
    t, w = s.get("trace"), s["work"]
    if not t or t["busy_s"] <= 0 or w["model"] != "sdr":
        return None
    return 100.0 * roofline_sdr.chain_bound(w, s["calls"]) / t["busy_s"]
