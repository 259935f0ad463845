"""The stream time of the analyzer's transform stage (``bhw.welch.fft``:
``torch.fft.rfft``, or the packed or mxu transform) a call of the
analyzer, in the traced window: two events on the card's stream around
the stage, summed, over the count of ``bhw.welch`` spans."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "analyzer", "msamples_per_s"


def read(s: dict):
    v = spans.per_call(s, "stream_s", ("bhw.welch.fft",))
    return None if v is None else v * 1e3
