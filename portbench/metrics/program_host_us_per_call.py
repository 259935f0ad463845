"""The host time of the program's root spans (``bhw.window_block``,
``bhw.welch``) over their count, in the traced window: the program's own
time a call on the host, the profiler's recording of the operations inside
it included (the host clock's ``host_us_per_call`` is the untraced
window's, from outside the program)."""

from portbench import spans

UNIT, BETTER, SOURCE = "us", "lower", "program_span"
LAYER, MOVES = "dispatch", "msamples_per_s"


def read(s: dict):
    v = spans.per_call(s, "host_s", spans.ROOTS, roots=True)
    return None if v is None else v * 1e6
