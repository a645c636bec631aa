"""What rank and the lower matmul precisions cost in the window pass (P4-P7).

The counterpart of ``scripts/probes/profile_rank_kernels.py``.  Its four
Pallas kernels (pallas_calls at profile_rank_kernels.py:106, 156, 206 and
333) were formulations of the rank-R cluster pass sum_r B_r X A_r^T at
k = 7 that cut the cost of the products on a TPU: v1 splits the state
into bf16 halves once per block and takes three bf16 products ("bf16_3x",
hoisted), v2 stacks the ranks' lane sides into one wide product under
HIGHEST, v3 widens both sides under "bf16_3x" and v4 under HIGHEST; v0 is
K1 itself.  The widening and the hoisting are TPU tiling; the functions
are two: K1 at k = 7 under "highest" (v0, v2, v4) or under "bf16_3x"
(v1, v3).  So the counterpart of all four sites is ``rank_pass``, K1
(``fused.apply_window_stack``) under the variant's precision
(``VARIANT_PRECISION``), and the probe times one chain per (precision,
rank).  The reference's ``blocks`` argument was a VMEM tile and has no
counterpart.

    python -m quest_tpu_torch.probes.profile_rank_kernels
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused
from . import common

N = 26
RANKS = (1, 2, 4)
PRECISIONS = ("highest", "bf16_3x")
# the reference's variants, each the rank-R cluster pass under one of them
VARIANT_PRECISION = {"v0": "highest", "v1": "bf16_3x", "v2": "highest",
                     "v3": "bf16_3x", "v4": "highest"}
CHAIN = 8
REPS = 5
ACCURACY_N = 18           # the reference's accuracy(): 18 qubits, rank 4
ACCURACY_RANK = 4
HEADLINE_RANK = 4         # the rank the reference's docstring measured


def rank_pass(amps, mats_a, mats_b, *, num_qubits: int, precision: str):
    """The probe's rank-R cluster pass: K1 at k = 7 under ``precision``,
    SoA (R, 2, 128, 128) sides; a new tensor."""
    return fused.apply_window_stack(amps, mats_a, mats_b,
                                    num_qubits=num_qubits, k=7,
                                    precision=precision)


def cases(n: int) -> list:
    """(precision, rank, seed) of the parity cases: each precision at
    every rank."""
    return [(prec, rank, rank) for rank in RANKS for prec in PRECISIONS]


def inputs(n: int, rank: int, seed: int):
    """A seeded normalised state and two side stacks scaled by 1/rank."""
    rng = np.random.default_rng(seed)
    return (common.random_state(n, 100 + seed), common.side_stack(rng, rank),
            common.side_stack(rng, rank))


def check(device, n: int) -> dict:
    """Every case of ``cases(n)``: the pass (on the card K1 under its
    precision, on the CPU that precision's plain model) against
    ``fused.window_pass_model`` under the same precision, within
    ``common.model_tolerance``; and ``accuracy``, the reference's
    accuracy(): max |bf16_3x - highest| at rank 4 on these inputs."""
    errs = {}
    for prec, rank, seed in cases(n):
        x, a, b = (common.on(t, device) for t in inputs(n, rank, seed))
        y = rank_pass(x, a, b, num_qubits=n, precision=prec)
        ref = fused.window_pass_model(x, a, b, num_qubits=n, k=7,
                                      precision=prec)
        err = float((y - ref).abs().max())
        tol = common.model_tolerance(x, prec)
        if err > tol:
            raise RuntimeError(f"profile_rank_kernels: {prec} rank{rank} at "
                               f"{n} qubits: |err| {err} > {tol}")
        errs[f"{prec} rank{rank}"] = err
    return {"n": n, "cases": len(errs), "max_abs_err": max(errs.values()),
            "max_abs_err_by_case": errs,
            "accuracy": accuracy(device, n, ACCURACY_RANK)}


def accuracy(device, n: int = ACCURACY_N, rank: int = ACCURACY_RANK) -> dict:
    """The reference's accuracy(): a normalised state and unscaled Haar
    sides from np.random.default_rng(3) at n qubits, max |diff| of the
    "bf16_3x" pass (v1, v3) against the "highest" one (v0, v2, v4)."""
    rng = np.random.default_rng(3)
    st = rng.standard_normal((2, 1 << n)).astype(np.float32)
    st /= np.sqrt((st ** 2).sum())

    def stack():
        return np.stack([np.stack([u.real, u.imag]) for u in
                         (common.random_unitary(rng, 128)
                          for _ in range(rank))]).astype(np.float32)

    mas, mbs = stack(), stack()
    x, a, b = (common.on(t, device) for t in (st, mas, mbs))
    ref = rank_pass(x, a, b, num_qubits=n, precision="highest")
    low = rank_pass(x, a, b, num_qubits=n, precision="bf16_3x")
    return {"n": n, "rank": rank,
            "bf16_3x_vs_highest": float((low - ref).abs().max())}


def run(device="cuda") -> dict:
    """K1 at k = 7 at 26 qubits, float32, from |0...0>, under each
    precision at rank 1, 2 and 4: ms a pass (CUDA events over chains of
    CHAIN), GB/s, launches, and the bound at the precision's product
    rate; the reference's accuracy() at 18 qubits, rank 4; per precision
    the headline at rank 4 with its plain model's ms, its error against
    it and, under "highest", the library's ms."""
    dev = common.cuda_device(device)
    n = N
    num_amps = 1 << n
    nbytes = common.state_pass_bytes(num_amps)
    out = {"n": n, "k": 7, "chain": CHAIN,
           "variant_precision": VARIANT_PRECISION, "cases": {}}

    def fresh():
        x = torch.zeros((2, num_amps), dtype=torch.float32, device=dev)
        x[0, 0] = 1.0
        return x

    sides = {}
    for rank in RANKS:
        rng = np.random.default_rng(rank)
        sides[rank] = tuple(common.on(common.side_stack(rng, rank), dev)
                            for _ in range(2))
    for rank in RANKS:
        a, b = sides[rank]
        for prec in PRECISIONS:
            fused.prepare_sides(a, b, precision=prec)
            before = common.launches()
            med, low, _ = common.chain_ms(
                lambda s, prec=prec, a=a, b=b: rank_pass(
                    s, a, b, num_qubits=n, precision=prec),
                fresh(), chain=CHAIN, reps=REPS)
            bound = common.window_bound(num_amps, rank, 2, False, prec)
            out["cases"][f"{prec} rank{rank}"] = {
                "ms": med, "min_ms": low, "gbs": common.gbs(nbytes, med),
                "precision": prec, "bound_ms": bound[0],
                "bound_by": bound[1], "fraction_of_bound": bound[0] / med,
                "kernel": "K1",
                "launches": common.launched(before).get("K1", 0)}
            torch.cuda.empty_cache()
    out["launches_by_precision"] = {
        prec: sum(out["cases"][f"{prec} rank{r}"]["launches"] for r in RANKS)
        for prec in PRECISIONS}
    out["launches"] = {"K1": sum(out["launches_by_precision"].values())}
    before = common.launches()
    out["accuracy"] = accuracy(dev)
    out["accuracy"]["launches"] = common.launched(before).get("K1", 0)
    # per precision, the headline at rank 4
    rank = HEADLINE_RANK
    a, b = sides[rank]
    x = common.device_state(n, 13, dev)
    out["headline"] = {}
    for prec in PRECISIONS:
        y = rank_pass(x, a, b, num_qubits=n, precision=prec)

        def plain(prec=prec):
            return fused.window_pass_model(x, a, b, num_qubits=n, k=7,
                                           precision=prec)

        err = float((y - plain()).abs().max())
        tol = common.model_tolerance(x, prec)
        if err > tol:
            raise RuntimeError(f"profile_rank_kernels: {prec} rank{rank} at "
                               f"{n} qubits: |err| {err} > {tol}")
        head = dict(out["cases"][f"{prec} rank{rank}"])
        head.update(case=f"{prec} rank{rank}", max_abs_err=err,
                    plain_ms=common.time_ms(plain, reps=3, warmup=1),
                    library_ms=None, library_form=None)
        if prec == "highest":
            head["library_ms"], head["library_form"], _ = \
                common.library_time(
                    y, common.window_library(x, a, b, None, num_qubits=n,
                                             k=7, apply_a=True), tol,
                    "profile_rank_kernels")
        else:
            head["library_note"] = ("none: no single PyTorch call takes "
                                    "the bf16_3x products")
        out["headline"][prec] = head
        del y
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return out


def main() -> int:
    return common.cli(run)


if __name__ == "__main__":
    raise SystemExit(main())
