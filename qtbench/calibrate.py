"""The readings that a cell's limits are set from, in one process on the
card: the program's comparison over many seeds (its lower readings) and
the cell's control in the program's place over a few (its upper
readings).  Each run is a short window of the cell's own traffic at its
own size, through the same harness as a measured run.

    python3 qtbench/calibrate.py --workload rc26.api --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

Prints one JSON line per run and then the summary: for each number, the
largest program reading and the smallest control reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qtbench import harness  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("qtbench: the calibration needs a CUDA card", file=sys.stderr)
        return 2
    lower: dict = {}
    upper: dict = {}
    for control, group in ((False, args.seeds), (True, args.control_seeds)):
        for seed in group:
            t0 = time.perf_counter()
            result, readings = harness.run_cell(
                args.workload, seed, args.seconds, False,
                t_start=time.perf_counter(), control=control)
            side = upper if control else lower
            for k, v in readings.items():
                side.setdefault(k, []).append(v)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "readings": readings,
                              "circuits": result["attempted"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(v) for k, v in lower.items()},
        "upper": {k: min(v) for k, v in upper.items()},
        "program_readings": lower, "control_readings": upper,
        "process_seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
