"""The stream time of the PFB spectrometer's integration a call of the
spectrometer, in the traced window: ``bhw.pfb.power`` (on a card the power
mean kernel, |Y|^2 summed over each integration's spectra in float64), two
events on the card's stream around it, over the count of ``bhw.pfb`` root
spans, counted from the program's span table."""

from portbench import root_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "integrator", "msamples_per_s"
ROOT, STAGES = "bhw.pfb", ("bhw.pfb.power",)


def read(s: dict):
    return root_spans.stream_ms_per_call(s, ROOT, STAGES)
