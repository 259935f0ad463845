"""All samples of all calls completed in the window over the window's wall
time on the host clock, the window closed by a synchronize.  Samples are
window samples written (generation) or capture samples read (analyzer)."""

UNIT, BETTER, SOURCE = "Msamples/s", "higher", "host_clock"


def read(s: dict):
    return s["samples"] / s["window_s"] / 1e6
