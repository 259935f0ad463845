"""The least time the SDR chain's discriminator needs a call
(``roofline_sdr.demod_bound``: the complex64 channels read once, the int64
output written once, ``fm_demod_conj_ops`` integer operations an output at
the int32 issue rate; bytes bound it) over the stream time of its stage
``bhw.sdr.demod`` a call, in the traced window: two events on the card's
stream around each stage, each stage one call's."""

from portbench import roofline_sdr, spans

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "kernels", "msamples_per_s"
STAGE = "bhw.sdr.demod"


def read(s: dict):
    w = s["work"]
    if not s.get("trace") or w["model"] != "sdr":
        return None
    table = spans.table()
    if not table:
        return None
    rows = [row for path, row in table.items()
            if path.rsplit("/", 1)[-1] == STAGE and row["stream_n"]]
    stream_s = sum(row["stream_s"] for row in rows)
    if stream_s <= 0:
        return None
    return 100.0 * roofline_sdr.demod_bound(w) * sum(row["stream_n"] for row in rows) / stream_s
