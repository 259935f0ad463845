"""``torch.cuda.max_memory_allocated()`` over the measured window, its
peak statistics reset just before it: the caching allocator's counter,
read by the benchmark on the host after the window (``host_clock`` is the
nearer of the two sources an end-to-end metric may name).  Outputs kept
for the comparison are copied off the card, so the peak is the program's
and the loop's own: a call's output and the one before it."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(s: dict):
    return s["window_peak_bytes"] / 2**30
