"""Run one cell of the benchmark of quest_tpu_torch once, on the CUDA
card this process sees, and print the result as the last line of
standard output.

    python3 qtbench/run.py --workload rc26.api --seed 7 --seconds 30 \
        --trace 0

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` runs the same window under
``torch.profiler`` and reports its per-layer metrics, the device's busy
seconds and a breakdown.  Exits with a code other than 0, printing no
result, where no CUDA card (or fewer than the cell asks for) is visible,
or where JAX or the JAX package was loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from qtbench import harness  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def cards_visible() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = harness._named(spec["workloads"], args.workload,
                           "workload")["chips"]
    visible = cards_visible()
    if visible < chips:
        print(f"qtbench: the cell needs {chips} CUDA card(s); {visible} "
              "visible", file=sys.stderr)
        return 2
    print(f"qtbench: card {power_limit()}", file=sys.stderr, flush=True)
    result, readings = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"qtbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, value in readings.items():
        if name not in result["checks"]:
            print(f"qtbench reading {name} {value!r} (not compared)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"qtbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
