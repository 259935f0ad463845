"""The readings a cell's limits are set from: the program's numbers over
many seeds and the control's over a few, in one process.

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.jsonl>]

Each seed runs as the benchmark runs it (set-up, a window of ``--seconds``
at the cell's own load, the comparison), with the control's outputs judged
in place of the program's for the control seeds.  Prints one JSON line per
run, then the lower reading of each number (the program's largest) and
the upper one (the control's smallest).  Runs on the card only, like the
benchmark; the benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    lower, upper, lines = {}, {}, []
    for side, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            code, out = harness.run(["--workload", a.workload, "--seed", str(seed), "--seconds",
                                     str(a.seconds), "--trace", "0"], t0,
                                    control=side == "control")
            if out is None:
                return code
            line = {"workload": a.workload, "side": side, "seed": seed,
                    "correct": out["correct"], "checks": out["checks"],
                    "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                    "device": out["device"], "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
            for k, c in out["checks"].items():
                if side == "program":
                    lower[k] = max(lower.get(k, c["value"]), c["value"])
                else:
                    upper[k] = min(upper.get(k, c["value"]), c["value"])
    summary = {"workload": a.workload, "lower": lower, "upper": upper,
               "seconds": time.perf_counter() - T0}
    print(json.dumps(summary), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        with a.out.open("a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
