"""The stream time of the SDR chain's channelizer a call of the chain, in
the traced window: ``bhw.sdr.branches`` (the commutator, the branch FIRs
and, for a complex capture, the complex assembly) and ``bhw.sdr.dft`` (the
DFT across the branches), two events on the card's stream around each,
summed, over the count of ``bhw.sdr`` root spans, counted here from the
program's span table (``spans.ROOTS`` does not list them)."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "channelizer", "msamples_per_s"
ROOT, STAGES = "bhw.sdr", ("bhw.sdr.branches", "bhw.sdr.dft")


def read(s: dict):
    if not s.get("trace"):
        return None
    table = spans.table()
    if not table:
        return None
    calls = table.get(ROOT, {}).get("count", 0)
    rows = [row for path, row in table.items()
            if path.rsplit("/", 1)[-1] in STAGES and row["stream_n"]]
    if not calls or not rows:
        return None
    return sum(row["stream_s"] for row in rows) / calls * 1e3
