"""From process start to the first timed call: imports, the kernels' build
or cache load, the CUDA context, the inputs from the seed and the warm-up
calls."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(s: dict):
    return s["setup_s"]
