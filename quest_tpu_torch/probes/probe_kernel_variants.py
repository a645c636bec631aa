"""What the window pass costs in the probe's formulations, at k = 14 (P3).

The counterpart of ``scripts/probes/probe_kernel_variants.py``.  Its
Pallas kernel, ``sep_window`` (pallas_call at probe_kernel_variants.py:93),
was a window pass with the real and imaginary channels kept apart: B X A
[(.) mask] on each (hi, mid) slab, or B-only.  It multiplies the lane side
from the right as given, where K1 (``fused.apply_window_stack``, the
probe's V0) multiplies by its transpose, B X A^T: so ``sep_window`` here is
K1 given A^T, the same function, and the probe's seven cases are K1 in its
dual, masked and B-only forms.

The reference probe's own check (``check_AB`` / ``check_mask``: V0
against V1 on the same A) therefore compares two different functions:
with random unitaries it reports a difference of the order of the
amplitudes, and with A^T handed to V1 one at float32 rounding.  That is a
quirk of the reference probe, recorded in ``check``'s and ``run``'s output
(``lane_side``); the reference is not changed.

    python -m quest_tpu_torch.probes.probe_kernel_variants
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused
from . import common

N = 26
K = 14                    # the probe's window offset
CHAIN = 8
REPS = 5
SEED = 0                  # the probe's np.random.default_rng(0)
# the probe's V1 cases: (label, apply_a, with_mask)
SEP_CASES = (("V1 sep A+B", True, False), ("V1 sep A+B+mask", True, True),
             ("V1 sep B-only", False, False), ("V1 sep B+mask", False, True))


def _cached(t, key: str, make):
    """``make(t)``, remembered on tensor ``t`` until ``t`` changes, so the
    stacked sides keep their side images from launch to launch (a NumPy
    ``t`` is made anew each time)."""
    if not torch.is_tensor(t):
        return make(t)
    tag = getattr(t, key, None)
    if tag is None or tag[0] != t._version:
        tag = (t._version, make(t))
        setattr(t, key, tag)
    return tag[1]


def lane_stack(ma):
    """The (1, 2, 128, 128) K1 lane side that multiplies by ``ma``
    (2, 128, 128) as given: its transpose."""
    def make(m):
        if torch.is_tensor(m):
            return m.transpose(-1, -2).contiguous()[None]
        return np.ascontiguousarray(np.swapaxes(m, -1, -2))[None]
    return _cached(ma, "_qt_probe_lane_t", make)


def window_stack(mb):
    """The (1, 2, 128, 128) K1 window side of ``mb`` (2, 128, 128)."""
    return _cached(mb, "_qt_probe_stack", lambda m: m[None])


def sep_window(amps, ma, mb, mask=None, *, num_qubits: int, k: int,
               apply_a: bool = True, apply_b: bool = True,
               with_mask: bool = False):
    """The probe's separate-channel window pass through K1: B X A [(.)
    mask] on each slab of the window [k, k+7), A = ``ma`` multiplying the
    lanes from the right as given (K1 takes A^T), SoA (2, 128, 128) sides;
    a new tensor."""
    return fused.apply_window_stack(
        amps, lane_stack(ma), window_stack(mb),
        mask if with_mask else None, num_qubits=num_qubits, k=k,
        apply_a=apply_a, apply_b=apply_b)


def inputs():
    """The probe's matrices from np.random.default_rng(0): two Haar
    unitaries (A, B) as SoA float32 and its mask of phases 1e-3 w l."""
    rng = np.random.default_rng(SEED)

    def rand_u7():
        u = common.random_unitary(rng, 128)
        return np.stack([u.real, u.imag]).astype(np.float32)

    a, b = rand_u7(), rand_u7()
    ph = np.outer(np.arange(128), np.arange(128)) * 1e-3
    mask = np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)
    return a, b, mask


def offset(n: int) -> int:
    """The probe's k = 14, or the highest window n qubits allow."""
    return min(K, n - 7)


def check(device, n: int) -> dict:
    """Each V1 case on a seeded state at k = ``offset(n)``: the probe's
    pass (on the card K1, on the CPU its plain version) against
    ``fused.window_pass_plain`` given A^T; ``check_AB`` / ``check_mask``
    are the dual and masked cases' errors.  ``lane_side`` records the
    reference probe's quirk on the same state: V0 minus V1 on the same A,
    and with A^T handed to V1."""
    k = offset(n)
    a, b, mask = (common.on(t, device) for t in inputs())
    x = common.on(common.random_state(n, SEED), device)
    errs = {}
    for label, apply_a, with_mask in SEP_CASES:
        y = sep_window(x, a, b, mask, num_qubits=n, k=k, apply_a=apply_a,
                       with_mask=with_mask)
        ref = fused.window_pass_plain(
            x, lane_stack(a), window_stack(b),
            mask if with_mask else None, num_qubits=n, k=k,
            apply_a=apply_a)
        err = float((y - ref).abs().max())
        tol = common.tolerance(x)
        if err > tol:
            raise RuntimeError(f"probe_kernel_variants: {label} at {n} "
                               f"qubits, k={k}: |err| {err} > {tol}")
        errs[label] = err
    v0 = fused.apply_window_stack(x, a[None], b[None], num_qubits=n, k=k)
    lane = {
        "v0_minus_v1_same_a": float(
            (v0 - sep_window(x, a, b, num_qubits=n, k=k)).abs().max()),
        "v0_minus_v1_given_a_t": float(
            (v0 - sep_window(x, a.transpose(-1, -2).contiguous(), b,
                             num_qubits=n, k=k)).abs().max()),
        "max_abs_amplitude": float(v0.abs().max()),
        "note": ("the reference probe's sep_window multiplies the lanes by "
                 "A, K1 by A^T: its check_AB compares two functions"),
    }
    return {"n": n, "k": k, "cases": len(errs),
            "max_abs_err": max(errs.values()), "max_abs_err_by_case": errs,
            "check_AB": errs["V1 sep A+B"],
            "check_mask": errs["V1 sep A+B+mask"], "lane_side": lane}


def run(device="cuda") -> dict:
    """The probe's seven cases at 26 qubits, k = 14, rank 1, float32, from
    |0...0> as the reference starts them: ms a pass (CUDA events over
    chains of CHAIN) and GB/s, launches and bound.  V0 is K1 as the
    circuit path calls it; V1 is ``sep_window`` (K1 given A^T).  The
    headline, V1 A+B, also gets its plain version's ms, the library's and
    its error; ``lane_side`` is the reference probe's check at this size."""
    dev = common.cuda_device(device)
    n, k = N, K
    num_amps = 1 << n
    nbytes = common.state_pass_bytes(num_amps)
    a, b, mask = (common.on(t, dev) for t in inputs())
    a1, b1 = a[None], b[None]
    out = {"n": n, "k": k, "chain": CHAIN, "cases": {}}

    def fresh():
        x = torch.zeros((2, num_amps), dtype=torch.float32, device=dev)
        x[0, 0] = 1.0
        return x

    def v0(apply_a, with_mask):
        return lambda s: fused.apply_window_stack(
            s, a1, b1, mask if with_mask else None, num_qubits=n, k=k,
            apply_a=apply_a)

    def v1(apply_a, with_mask):
        return lambda s: sep_window(s, a, b, mask, num_qubits=n, k=k,
                                    apply_a=apply_a, with_mask=with_mask)

    cases = [("V0 A+B k=14", v0(True, False), True, False),
             ("V1 sep A+B k=14", v1(True, False), True, False),
             ("V0 A+B+mask k=14", v0(True, True), True, True),
             ("V1 sep A+B+mask", v1(True, True), True, True),
             ("V0 B-only k=14", v0(False, False), False, False),
             ("V1 sep B-only", v1(False, False), False, False),
             ("V1 sep B+mask", v1(False, True), False, True)]
    for label, step, apply_a, with_mask in cases:
        before = common.launches()
        med, low, _ = common.chain_ms(step, fresh(), chain=CHAIN, reps=REPS)
        bound = common.window_bound(num_amps, 1, 2 if apply_a else 1,
                                    with_mask)
        out["cases"][label] = {
            "ms": med, "min_ms": low, "gbs": common.gbs(nbytes, med),
            "bound_ms": bound[0], "bound_by": bound[1],
            "fraction_of_bound": bound[0] / med, "kernel": "K1",
            "launches": common.launched(before).get("K1", 0)}
        torch.cuda.empty_cache()
    out["launches"] = {
        "K1": sum(c["launches"] for c in out["cases"].values())}
    # the reference's check_AB on its own state, and the headline
    x = fresh()
    y0 = fused.apply_window_stack(x, a1, b1, num_qubits=n, k=k)
    y1 = sep_window(x, a, b, num_qubits=n, k=k)
    at = a.transpose(-1, -2).contiguous()
    out["lane_side"] = {
        "v0_minus_v1_same_a": float((y0 - y1).abs().max()),
        "v0_minus_v1_given_a_t": float(
            (y0 - sep_window(x, at, b, num_qubits=n, k=k)).abs().max()),
        "max_abs_amplitude": float(y0.abs().max())}
    del y0, y1
    x = common.device_state(n, 12, dev)
    y = sep_window(x, a, b, num_qubits=n, k=k)

    def plain():
        return fused.window_pass_plain(x, lane_stack(a), window_stack(b),
                                       num_qubits=n, k=k)

    err = float((y - plain()).abs().max())
    tol = common.tolerance(x)
    if err > tol:
        raise RuntimeError(f"probe_kernel_variants: V1 A+B at {n} qubits: "
                           f"|err| {err} > {tol}")
    lib_ms, lib_form, _ = common.library_time(
        y, common.window_library(x, lane_stack(a), window_stack(b), None,
                                 num_qubits=n, k=k, apply_a=True), tol,
        "probe_kernel_variants")
    head = dict(out["cases"]["V1 sep A+B k=14"])
    head.update(case="V1 sep A+B k=14", max_abs_err=err,
                plain_ms=common.time_ms(plain, reps=3, warmup=1),
                library_ms=lib_ms,
                library_form=lib_form)
    out["headline"] = head
    del x, y
    torch.cuda.empty_cache()
    return out


def main() -> int:
    return common.cli(run)


if __name__ == "__main__":
    raise SystemExit(main())
