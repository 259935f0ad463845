"""The benchmark of ``blackman_harris_win_tpu_torch`` on an NVIDIA GPU.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is data or a module of its own, found
by name (:mod:`portbench.layout`):

- ``cells/<cell>.json``: the cell's configuration, traffic and entry;
- ``configs/<config>.json``: the configuration as it is run, its source,
  what it assumes and the limits of its comparison;
- ``traffic/<traffic>.json``: the parameters the one generator
  (:mod:`portbench.traffic`) reads;
- ``entries/<entry>.py``: how the inputs are made, the call, what is kept
  for the comparison and the work model of the call;
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``.

The plain reference (``reference/``) imports nothing of the program and
nothing of JAX.  The program is imported from the checkout this file lies
in and nowhere else.
"""
