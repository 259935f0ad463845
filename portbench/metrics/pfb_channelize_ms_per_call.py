"""The stream time of the PFB spectrometer's filter bank a call of the
spectrometer, in the traced window: ``bhw.pfb.branches`` (the int8 words'
widening and the branch FIRs) and ``bhw.pfb.dft`` (the real DFT across the
branches), two events on the card's stream around each, summed, over the
count of ``bhw.pfb`` root spans, counted from the program's span table."""

from portbench import root_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "channelizer", "msamples_per_s"
ROOT, STAGES = "bhw.pfb", ("bhw.pfb.branches", "bhw.pfb.dft")


def read(s: dict):
    return root_spans.stream_ms_per_call(s, ROOT, STAGES)
