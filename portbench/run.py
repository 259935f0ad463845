"""Command line of the benchmark (see :mod:`portbench.harness`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the program is imported from that
checkout.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this script's folder, whose module
# names could shadow others
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
