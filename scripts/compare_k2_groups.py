#!/usr/bin/env python3
"""Time K1 and K2 on bench.py config 2's three megawin groups, and the
bench route, in one checkout of the repository, on one CUDA card.

    python3 scripts/compare_k2_groups.py TREE

TREE is the root of a checkout (this repository, or another commit
unpacked with `git archive` into a git-ignored directory such as
`_proof/parent`); its own `chip_smoke.py` helpers and `quest_tpu_torch`
are imported and its kernels built.  Prints one JSON line: per group the
time through K2 and through K1 pass by pass (chip_smoke.time_k2_group,
K1, K2, K2, K1 in turns), the median bench-route wall of five, and the
registers and spill bytes ptxas gave K1's and K2's kernels.  To compare
two commits on one card, run parent, change, change, parent (twice, for
a spread) in one command, each in a process of its own.
"""

import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quest_tpu_torch import circuit as C  # noqa: E402
from quest_tpu_torch.models import circuits  # noqa: E402
from quest_tpu_torch.ops import build, fused  # noqa: E402


def main() -> int:
    build_s = build.build_kernels()
    n = cs.N_MAIN
    us = circuits.bench_unitaries(n, cs.DEPTH, seed=cs.SEED)
    plan = C.plan_circuit(circuits.bench_gate_list(n, cs.DEPTH, us), n,
                          device="cuda")
    ops = C.plan_to_device(plan, torch.float32, "cuda")
    groups = [op[1] for op in ops if op[0] == "megawin"]
    x = torch.randn((2, 1 << (n - 14), 128, 128), device="cuda")
    x /= torch.sqrt(torch.sum(x * x))
    out = {"tree": sys.argv[1], "card": cs.nvidia_smi_line(),
           "build_s": build_s}
    for label, g in zip("ABC", groups):
        r = cs.time_k2_group(torch, C, fused, x, g, n, "float32")
        out[label] = {"k2_ms": r["ms"], "k1_ms": r["per_pass_k1_ms"],
                      "turns_k1_k2_k2_k1_ms": r["turns_k1_k2_k2_k1_ms"]}

    def bench():
        a = circuits.zero_state_canonical(n, torch.float32, "cuda")
        a = C.execute_plan_chained(a, ops, n)
        return float(circuits.prob_top_zero_canonical(a))

    bench()
    walls = []
    for _ in range(5):
        cs.sync()
        t0 = time.perf_counter()
        bench()
        cs.sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["bench_route_ms"] = sorted(walls)[2]
    out["ptxas"] = {k: v for k, v in build.kernel_resources().items()
                    if "window_pass_kernel" in k or "megawin_kernel" in k}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
