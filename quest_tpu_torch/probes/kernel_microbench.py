"""What each pass flavour costs on the card at 26 qubits (P2).

The counterpart of ``scripts/probes/kernel_microbench.py``.  Its Pallas
kernel, ``apply_offset_cluster`` (pallas_call at kernel_microbench.py:104),
prototyped a cluster pass whose sublane window sits at any bit offset k:
sum_r B_r X A_r^T with A_r on the lane qubits [0, 7) and B_r on [k, k+7),
A+B or B-only.  That is K1's function at offset k (the reference's own K1
docstring, quest_tpu/ops/fused.py:395-401), so its counterpart here is
K1, ``fused.apply_window_stack``, driven at the probe's shapes.  The probe
also timed the cluster pass (K11), the fused segment swap + cluster pass
(K12, m = 3, h = n - 3, b = 7) and the plain segment swap of 7 bits
(``kernels.swap_bit_segments``), all as here.

    python -m quest_tpu_torch.probes.kernel_microbench
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused, kernels
from . import common

N = 26
CHAIN = 8                 # the reference's CHAIN: passes per timed chain
REPS = 5
RANKS = (1, 2, 4)
HEADLINE = (13, 1)        # (k, rank) of the P2 entry: the middle offset


def apply_offset_cluster(amps, mats_a, mats_b, *, num_qubits: int, k: int,
                         apply_a: bool = True):
    """The probe's offset-window cluster pass, through K1: sum_r B_r X
    A_r^T with the window on bits [k, k+7), 7 <= k <= n - 7 (B-only when
    ``apply_a`` is False); SoA (R, 2, 128, 128) sides.  A new tensor."""
    return fused.apply_window_stack(amps, mats_a, mats_b,
                                    num_qubits=num_qubits, k=k,
                                    apply_a=apply_a)


def offsets(n: int) -> tuple:
    """The probe's window offsets at n qubits: 7, 13 and n - 7."""
    return tuple(sorted({7, min(13, n - 7), n - 7}))


def cases(n: int) -> list:
    """(k, rank, apply_a, seed) of the parity cases at n qubits: each
    offset at each rank, A+B, and each offset B-only at rank 1."""
    out = []
    for i, k in enumerate(offsets(n)):
        for rank in RANKS:
            out.append((k, rank, True, 10 * i + rank))
        out.append((k, 1, False, 10 * i + 7))
    return out


def inputs(n: int, case):
    """The case's state and sides, from its seed."""
    _k, rank, _a, seed = case
    rng = np.random.default_rng(seed)
    return (common.random_state(n, seed), common.side_stack(rng, rank),
            common.side_stack(rng, rank))


def check(device, n: int) -> dict:
    """Every case of ``cases(n)``: the probe's pass (on the card K1, on
    the CPU its plain version) against ``fused.window_pass_plain`` on the
    same inputs, within ``common.tolerance``."""
    worst = {}
    for case in cases(n):
        k, rank, apply_a, _seed = case
        x, a, b = (common.on(t, device) for t in inputs(n, case))
        y = apply_offset_cluster(x, a, b, num_qubits=n, k=k,
                                 apply_a=apply_a)
        ref = fused.window_pass_plain(x, a, b, num_qubits=n, k=k,
                                      apply_a=apply_a)
        err = float((y - ref).abs().max())
        tol = common.tolerance(x)
        label = f"k={k} rank{rank}" + ("" if apply_a else " B-only")
        if err > tol:
            raise RuntimeError(f"kernel_microbench: {label} at {n} qubits: "
                               f"|err| {err} > {tol}")
        worst[label] = err
    return {"n": n, "cases": len(worst), "max_abs_err": max(worst.values()),
            "max_abs_err_by_case": worst}


def run(device="cuda") -> dict:
    """Every flavour the reference times at 26 qubits, float32, from
    |0...0>: ms a pass (CUDA events over chains of CHAIN) and GB/s over
    the state's read and write, with each case's launches and bound: the
    cluster pass at rank 1, 2, 4 (K11); the fused swap at m = 3, rank 1
    and 4 (K12); the plain 7-bit segment swap; the offset window at k in
    {7, 13, 19}, rank 1, 2, 4 and B-only (K1).  The headline case (k = 13,
    rank 1) also gets its plain version's ms, the library's and its error
    against the plain version."""
    dev = common.cuda_device(device)
    n = N
    num_amps = 1 << n
    nbytes = common.state_pass_bytes(num_amps)
    out = {"n": n, "chain": CHAIN, "cases": {}}

    def fresh():
        a = torch.zeros((2, num_amps), dtype=torch.float32, device=dev)
        a[0, 0] = 1.0
        return a

    def sides(rank, seed):
        rng = np.random.default_rng(seed)
        a = common.on(common.side_stack(rng, rank), dev)
        b = common.on(common.side_stack(rng, rank), dev)
        return a, b

    def record(label, step, kernel, bound=None):
        before = common.launches()
        med, low, _ = common.chain_ms(step, fresh(), chain=CHAIN, reps=REPS)
        rec = {"ms": med, "min_ms": low, "gbs": common.gbs(nbytes, med),
               "kernel": kernel,
               "launches": common.launched(before).get(kernel, 0)}
        if bound is not None:
            rec.update(bound_ms=bound[0], bound_by=bound[1],
                       fraction_of_bound=bound[0] / med)
        out["cases"][label] = rec
        torch.cuda.empty_cache()

    for rank in RANKS:
        a, b = sides(rank, 1)
        fused.prepare_sides(a, b)
        record(f"cluster rank{rank}",
               lambda s, a=a, b=b: fused.apply_cluster_stack(
                   s, a, b, num_qubits=n), "K11",
               common.window_bound(num_amps, rank, 2, False))
    for rank in (1, 4):
        a, b = sides(rank, 3)
        fused.prepare_sides(a, b)
        record(f"swapfused m=3 rank{rank}",
               lambda s, a=a, b=b: fused.apply_swap_cluster_stack(
                   s, a, b, num_qubits=n, h=n - 3, b=7, m=3), "K12",
               common.window_bound(num_amps, rank, 2, False))
    record("segswap m=7", lambda s: kernels.swap_bit_segments(
        s, num_qubits=n, a=n - 7, b=7, m=7), "none")
    out["cases"]["segswap m=7"]["route"] = "plain (one permute)"
    for k in offsets(n):
        for rank in RANKS:
            a, b = sides(rank, 5)
            fused.prepare_sides(a, b)
            record(f"offset k={k} rank{rank}",
                   lambda s, a=a, b=b, k=k: apply_offset_cluster(
                       s, a, b, num_qubits=n, k=k), "K1",
                   common.window_bound(num_amps, rank, 2, False))
        a, b = sides(1, 7)
        fused.prepare_sides(a, b, apply_a=False)
        record(f"offset k={k} B-only",
               lambda s, a=a, b=b, k=k: apply_offset_cluster(
                   s, a, b, num_qubits=n, k=k, apply_a=False), "K1",
               common.window_bound(num_amps, 1, 1, False))
    out["launches"] = {
        key: sum(c["launches"] for c in out["cases"].values()
                 if c["kernel"] == key) for key in ("K1", "K11", "K12")}
    # the headline: its plain version, the library and the error
    k, rank = HEADLINE
    x = common.device_state(n, 11, dev)
    a, b = sides(rank, 5)
    y = apply_offset_cluster(x, a, b, num_qubits=n, k=k)

    def plain():
        return fused.window_pass_plain(x, a, b, num_qubits=n, k=k)

    err = float((y - plain()).abs().max())
    tol = common.tolerance(x)
    if err > tol:
        raise RuntimeError(f"kernel_microbench: offset k={k} rank{rank} at "
                           f"{n} qubits: |err| {err} > {tol}")
    lib_ms, lib_form, _ = common.library_time(
        y, common.window_library(x, a, b, None, num_qubits=n, k=k,
                                 apply_a=True), tol, "kernel_microbench")
    head = dict(out["cases"][f"offset k={k} rank{rank}"])
    head.update(case=f"offset k={k} rank{rank}", max_abs_err=err,
                plain_ms=common.time_ms(plain, reps=3, warmup=1),
                library_ms=lib_ms, library_form=lib_form)
    out["headline"] = head
    del x, y
    torch.cuda.empty_cache()
    return out


def main() -> int:
    return common.cli(run)


if __name__ == "__main__":
    raise SystemExit(main())
