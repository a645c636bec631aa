"""What a fused direct Pauli rotation costs against the gather form (P8).

The counterpart of ``scripts/probes/probe_flip_pallas.py``.  Its Pallas
kernel (pallas_call at probe_flip_pallas.py:109, built by ``build(n)``)
applied one Pauli-string rotation e^{-i theta/2 P} per step of a scan of
16 terms, in one pass per term, the XOR flip of P done by block-index
redirection and two permutation matmuls; the probe timed it against the
reference's "take-take" gather form (``paulis.trotter_scan``).  That
function is the direct rotation the port's K3 computes (``csrc/paulis.cu``
``pauli_rotation_kernel``), so the counterpart here is not a Pallas kernel
of its own but K3, driven at the probe's shapes through
``paulis.trotter_scan`` (one K3 launch a term, in place); the gather form
is K3's plain version, ``paulis.direct_rotation_plain``, a term at a time.

    python -m quest_tpu_torch.probes.probe_flip_pallas
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ..ops import paulis
from . import common

N = 24
TERMS = 16
REPS = 5
MAXDIFF = 1e-6            # the reference probe's assert
SEED = 0


def flip_program(amps, codes, angles, *, num_qubits: int):
    """The probe's program: one direct rotation a term over a (T, n) code
    table and (T,) angles, through K3 on the card (consuming ``amps``) and
    its plain version on the CPU."""
    return paulis.trotter_scan(amps, codes, angles, num_qubits=num_qubits,
                               rep_qubits=num_qubits)


def take_take(amps, codes, angles, *, num_qubits: int):
    """The gather form the probe timed against: each term's rotation by
    ``paulis.direct_rotation_plain`` (a new tensor a term)."""
    for c, ang in zip(np.asarray(codes), np.asarray(angles, np.float64)):
        amps = paulis.direct_rotation_plain(
            amps, paulis.pauli_term(c, dtype=amps.dtype, theta=ang),
            num_qubits=num_qubits)
    return amps


def inputs(n: int, terms: int = TERMS):
    """The probe's draws from np.random.default_rng(0): codes (T, n),
    angles (T,) and a normalised (2, 2^n) float32 state."""
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, size=(terms, n))
    angles = rng.normal(size=terms)
    a0 = rng.standard_normal((2, 1 << n)).astype(np.float32)
    a0 /= np.sqrt((a0 ** 2).sum())
    return codes, angles, a0


def check(device, n: int) -> dict:
    """The probe's correctness part at n qubits: the K3 route (on the CPU
    its plain version) against the gather form on the same draws, max
    |diff| under the probe's 1e-6."""
    codes, angles, a0 = inputs(n)
    x = common.on(a0, device)
    got = flip_program(x.clone(), codes, angles, num_qubits=n)
    ref = take_take(x, codes, angles, num_qubits=n)
    md = float((got - ref).abs().max())
    if md >= MAXDIFF:
        raise RuntimeError(f"probe_flip_pallas: maxdiff {md} at {n} qubits")
    return {"n": n, "terms": len(codes), "maxdiff": md, "max_abs_err": md}


def run(device="cuda") -> dict:
    """The probe at 24 qubits, 16 terms, float32: maxdiff of the K3 route
    against the gather form (under 1e-6, as the reference asserts), and
    the median and least seconds a program of 16 terms takes by each
    route (CUDA events, REPS programs each, in turns), with the K3
    launches and the bound: each term reads and writes the state once."""
    dev = common.cuda_device(device)
    n = N
    codes, angles, a0 = inputs(n)
    x = common.on(a0, dev)
    got = flip_program(x.clone(), codes, angles, num_qubits=n)
    md = float((got - take_take(x, codes, angles, num_qubits=n))
               .abs().max())
    if md >= MAXDIFF:
        raise RuntimeError(f"probe_flip_pallas: maxdiff {md} at {n} qubits")
    del got
    state = {"k3": x.clone(), "take_take": x.clone()}
    route = {"k3": flip_program, "take_take": take_take}
    secs = {"k3": [], "take_take": []}
    before = common.launches()
    for key in ("k3", "take_take"):       # warm-up
        state[key] = route[key](state[key], codes, angles, num_qubits=n)
    torch.cuda.synchronize()
    for _ in range(REPS):
        for key in ("k3", "take_take"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state[key] = route[key](state[key], codes, angles,
                                    num_qubits=n)
            end.record()
            end.synchronize()
            secs[key].append(start.elapsed_time(end) * 1e-3)
    k3_launches = common.launched(before).get("K3", 0)
    bound_s = len(codes) * common.state_pass_bytes(1 << n) \
        / common.HBM_BYTES_PER_S
    res = {"n": n, "terms": len(codes), "maxdiff": md,
           "launches": {"K3": k3_launches}, "bound_s": bound_s,
           "bound_by": "bytes"}
    for key in ("k3", "take_take"):
        res[key] = {"median": statistics.median(secs[key]),
                    "min": min(secs[key])}
    res["headline"] = {
        "ms": res["k3"]["median"] * 1e3, "min_ms": res["k3"]["min"] * 1e3,
        "plain_ms": res["take_take"]["median"] * 1e3,
        "bound_ms": bound_s * 1e3, "bound_by": "bytes",
        "fraction_of_bound": bound_s / res["k3"]["median"],
        "library_ms": None, "max_abs_err": md, "launches": k3_launches,
        "case": f"{len(codes)} terms at {n} qubits"}
    del x, state
    torch.cuda.empty_cache()
    return res


def main() -> int:
    return common.cli(run)


if __name__ == "__main__":
    raise SystemExit(main())
