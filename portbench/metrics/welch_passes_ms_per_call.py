"""The stream time of the analyzer's stages around its transform
(``bhw.welch.window``, ``.apply``, ``.power``, ``.mean``: the window and its
scale, frames x window, the power and the mean over frames) a call of the
analyzer, in the traced window: two events on the card's stream around
each stage, summed, over the count of ``bhw.welch`` spans."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "analyzer", "msamples_per_s"
STAGES = ("bhw.welch.window", "bhw.welch.apply", "bhw.welch.power", "bhw.welch.mean")


def read(s: dict):
    v = spans.per_call(s, "stream_s", STAGES)
    return None if v is None else v * 1e3
