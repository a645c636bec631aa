#!/usr/bin/env python3
"""Drive quest_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
line:

1. device  - the card's name and power limit; a CUDA device is required.
2. build   - nvcc builds csrc/window.cu (K1, K2) and csrc/paulis.cu (K3,
             K4) into one library, one nvcc process per source.
3. parity  - K1 against its plain PyTorch version at 20 qubits (f32 and
             f64, k in {7, 10, 13}, rank 1 and 4, dual / B-only / A-only,
             with and without a mask); K2 against K1 pass by pass
             (bit-identical) and against its plain version.
4. main    - the bench.py config-2 workload at 26 qubits, depth 20, f32
             (770 gates), by two routes: (a) bench_gate_list -> plan ->
             execute_plan_chained -> prob_top_zero_canonical; (b) the API:
             createQureg, the same gates under gateFusion, then
             calcProbOfOutcome and calcTotalProb.  Both probabilities are
             held against each other and against the same plan run through
             the plain versions in f64; K1's and K2's launch counts must
             equal what the plans contain.
5. timing  - CUDA-event medians of K1 (a dual-side and a B-only rank-1
             pass) and K2 (the bench plan's largest group) at the main
             path's shapes, their plain versions, one-call library
             yardsticks, the least time the card could take, and the wall
             time of both routes.
6. pauli_parity - K3 against its plain version (bit-identical) and K4
             against its plain version at 20 qubits, f32 and f64, over the
             term shapes the kernels treat apart (all-identity, Z-only, X on
             the top bit, #Y = 0..3 mod 4, a density matrix's bra twin); K4
             against two known expectation values.
7. pauli_main - bench.py config 5 at 30 qubits, f32 (an 8 GiB state),
             through the API: createQureg, initPlusState, a 16-term
             PauliHamil (bench_pauli_hamil, seed 7), calcExpecPauliHamil,
             applyTrotterCircuit (order 2, 1 rep: 32 term rotations),
             calcExpecPauliHamil, calcTotalProb.  K3 and K4 must launch 32
             times each; the same workload through the plain versions on
             the card gives the same state bit for bit and energies within
             1e-5 sum|c_t|.  At 26 qubits the workload is held against a
             float64 plain run; at 20 qubits the QASM-recording route
             (per-term multiRotatePauli) against the K3 route.
8. pauli_timing - CUDA-event medians of one K3 and one K4 term at 30
             qubits against their bounds and plain versions, the wall time
             of the three API calls, and the device busy share of the
             Trotter and expectation calls.
9. kernels - one JSON object with every kernel's numbers.

The last two lines are the card's `nvidia-smi` name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_PARITY = 20          # qubits for the kernel parity checks
N_MAIN = 26            # the main path's register
DEPTH = 20
SEED = 7               # bench.py config 2's unitary seed
REPS = 10              # timed launches per kernel
DEVICE = "cuda"
N_PAULI = 30           # config 5's register: an 8 GiB float32 state
N_PAULI_F64 = 26       # the float64 cross-check of the config-5 workload
N_QASM = 20            # the QASM-recording Trotter route
PAULI_TERMS = 16       # bench.py config 5's Hamiltonian: 16 terms, seed 7
PAULI_SEED = 7
TROTTER = (0.1, 2, 1)  # time, order, reps: 32 term rotations

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bandwidth and the highest rate of each type: FP32 on the CUDA cores (the
# tensor cores take no true FP32), FP64 on the tensor cores (DMMA; twice
# the CUDA cores' 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_unitary(rng, dim: int):
    import numpy as np

    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_pass(rng, k: int, rank: int, sides: str, with_mask: bool):
    """("winfused", k, A, B, apply_a, apply_b, mask) with unitary SoA
    sides scaled by 1/rank and a unit-modulus mask, as NumPy arrays."""
    import numpy as np

    def stack():
        return np.stack([np.stack([u.real, u.imag]) / rank for u in
                         (random_unitary(rng, 128) for _ in range(rank))])

    mask = None
    if with_mask:
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
        mask = np.stack([ph.real, ph.imag])
    return ("winfused", k, stack(), stack(), sides != "B", sides != "A", mask)


def flops_of(op, num_amps: int) -> float:
    """Real flops of one window pass: 8 per complex multiply-add, 128 per
    output amplitude per side per rank, plus 6 per amplitude for a mask."""
    rank = int(op[2].shape[0])
    sides = int(bool(op[4])) + int(bool(op[5]))
    f = 8.0 * 128 * rank * sides * num_amps
    if len(op) > 6 and op[6] is not None:
        f += 6.0 * num_amps
    return f


def bound_ms(ops, state_bytes: int, num_amps: int, dtype_name: str):
    """The least time the card could take for a run of passes: one read
    and one write of the state plus each matrix read once, over the
    memory rate, against the flops over the type's peak rate; and which
    of the two bounds it."""
    mat_bytes = sum(op[2].numel() * op[2].element_size()
                    * (int(bool(op[4])) + int(bool(op[5])))
                    + (0 if op[6] is None
                       else op[6].numel() * op[6].element_size())
                    for op in ops)
    t_bytes = (2 * state_bytes + mat_bytes) / HBM_BYTES_PER_S
    t_ops = sum(flops_of(op, num_amps) for op in ops) / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def host_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn`` (work that never touches the card)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def extra_bytes(fn) -> int:
    """Peak device memory that one call of ``fn`` allocates beyond what
    was allocated before it (its output included)."""
    import torch

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = fn()
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    del y
    return peak


def tolerance(x) -> float:
    """How far a kernel may stray from its plain version on state ``x``
    (normalised).  float32: sums of 128-term products of unit-scale
    factors, each rounded at 2^-24 relative, taken in another order than
    the plain version's library einsum -> 1e-5 of the state's largest
    amplitude.  float64: the same at 2^-53 -> 1e-12 absolute."""
    import torch

    if x.dtype == torch.float32:
        return 1e-5 * float(x.abs().max())
    return 1e-12


def phase_parity(torch, np, fused):
    n = N_PARITY
    rng = np.random.default_rng(1234)
    out = {"n": n, "k1_cases": 0, "k1_max_abs_err": {}, "k2": []}
    for dtype in (torch.float32, torch.float64):
        x = rng.standard_normal((2, 1 << n))
        x /= np.sqrt((x ** 2).sum())
        x = torch.as_tensor(x, dtype=dtype, device=DEVICE)
        tol = tolerance(x)
        worst = 0.0
        for k in (7, 10, 13):
            for rank in (1, 4):
                for sides in ("AB", "B", "A"):
                    for with_mask in (False, True):
                        op = random_pass(rng, k, rank, sides, with_mask)
                        y = fused.apply_window_stack(
                            x, op[2], op[3], op[6], num_qubits=n, k=k,
                            apply_a=op[4], apply_b=op[5])
                        yp = fused.window_pass_plain(
                            x, op[2], op[3], op[6], num_qubits=n, k=k,
                            apply_a=op[4], apply_b=op[5])
                        err = float((y - yp).abs().max())
                        check(err <= tol, f"K1 {dtype} k={k} R={rank} "
                              f"{sides} mask={with_mask}: |err| {err} > {tol}")
                        worst = max(worst, err)
                        out["k1_cases"] += 1
        sync()
        out["k1_max_abs_err"][str(dtype).split(".")[-1]] = worst
        # K2: groups with G = 8 (cluster of 8) and G = 1 (cluster of 4)
        for spec in ([(7, 1, "AB", True), (10, 2, "B", False),
                      (8, 4, "A", True), (9, 1, "AB", False),
                      (10, 1, "B", True)],
                     [(7, 1, "AB", False), (7, 4, "B", True),
                      (7, 2, "A", False)]):
            group = [random_pass(rng, k, r, s, m) for k, r, s, m in spec]
            y2 = fused.apply_window_megastack(x, group, num_qubits=n)
            y1 = x
            for op in group:
                y1 = fused.apply_window_stack(
                    y1, op[2], op[3], op[6], num_qubits=n, k=op[1],
                    apply_a=op[4], apply_b=op[5])
            yp = fused.megawin_plain(x, group, num_qubits=n)
            sync()
            check(torch.equal(y2, y1), f"K2 {dtype} {spec}: not "
                  "bit-identical to K1 pass by pass")
            err = float((y2 - yp).abs().max())
            check(err <= len(group) * tol,
                  f"K2 {dtype} {spec}: |err| {err} vs plain")
            out["k2"].append({"dtype": str(dtype).split(".")[-1],
                              "passes": len(group),
                              "kmax": max(s[0] for s in spec),
                              "bit_identical_to_k1": True,
                              "max_abs_err_vs_plain": err})
    return out


def run_plain(torch, fused, a, ops, n):
    """A plan through the kernels' plain versions on the card."""
    for op in ops:
        if op[0] == "winfused":
            a = fused.window_pass_plain(a, op[2], op[3], op[6], num_qubits=n,
                                        k=op[1], apply_a=op[4],
                                        apply_b=op[5])
        elif op[0] == "megawin":
            a = fused.megawin_plain(a, op[1], num_qubits=n)
        else:
            raise RuntimeError(f"unexpected op {op[0]} in the bench plan")
    return a


def op_breakdown(torch, C, ops, n):
    """Device time of each op of ``ops`` (CUDA events around each op, run
    one after another on a fresh state), summed by op kind."""
    from quest_tpu_torch.models import circuits

    a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
    marks = []
    for op in ops:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        a = C.execute_plan(a, [op], n)
        end.record()
        marks.append((op[0], start, end))
    sync()
    out: dict = {}
    for kind, start, end in marks:
        out[kind] = out.get(kind, 0.0) + start.elapsed_time(end)
    return out


def capture_items(qt, us, n):
    """The gate items a gateFusion drain of the bench circuit sees,
    captured on a register that never allocates amplitudes."""
    from quest_tpu_torch import fusion
    from quest_tpu_torch.qureg import Qureg

    shadow = Qureg(n, qt.createQuESTEnv(device="cpu"), False)
    fusion.start_gate_fusion(shadow)
    apply_bench_gates(qt, shadow, us, n)
    return list(shadow._fusion.gates)


def apply_bench_gates(qt, q, us, n):
    for d in range(us.shape[0]):
        for t in range(n):
            qt.unitary(q, t, us[d, t, 0] + 1j * us[d, t, 1])
        for t in range(d % 2, n - 1, 2):
            qt.controlledNot(q, t, t + 1)


# ---------------------------------------------------------------------------
# Pauli terms: K3 (direct rotation) and K4 (term expectation)
# ---------------------------------------------------------------------------


def pauli_tolerance(x) -> float:
    """How far K4 may stray from its plain version on state ``x``: float32
    sums of 2^n products, each rounded at 2^-24 relative, in another order
    (the plain version sums in float32, the kernel in float64) -> 1e-5 of
    the squared norm; float64 -> 1e-12 absolute."""
    import torch

    if x.dtype == torch.float32:
        return 1e-5 * float(torch.sum(x.double() * x.double()))
    return 1e-12


def pauli_cases(rng, n: int):
    """(label, codes, offset, conj) rows covering the term shapes the
    kernels treat apart."""
    import numpy as np

    def with_y(count):
        c = rng.choice([0, 1, 3], n)
        c[rng.choice(n, count, replace=False)] = 2
        return c

    z_only = 3 * rng.integers(0, 2, n)
    z_only[0] = 3
    x_top = np.zeros(n, np.int64)
    x_top[-1] = 1
    rows = [("identity", np.zeros(n, np.int64), 0, False),
            ("z_only", z_only, 0, False), ("x_top", x_top, 0, False)]
    rows += [(f"y{k}", with_y(4 + k), 0, False) for k in range(4)]
    nq = n // 2
    ket = rng.integers(0, 4, nq)
    rows += [("rho_ket", np.concatenate([ket, np.zeros(nq, np.int64)]), 0,
              False),
             ("rho_bra_twin", ket, nq, True)]
    return rows


def known_tolerance(dtype) -> float:
    """How far K4 may stray from an exact expectation of order 1 on a
    normalised state: float32 amplitudes are each rounded at 2^-24
    relative, which moves a quadratic form of unit norm by at most ~2.4e-7
    (the kernel sums in float64) -> 1e-6; float64 -> 1e-12."""
    import torch

    return 1e-6 if dtype == torch.float32 else 1e-12


def anticommuting(rng, p, basis: int, q_codes):
    """A string Q drawn from ``q_codes`` on every qubit that anticommutes
    with ``p`` (a string of ``basis`` and I whose top qubit is ``basis``):
    the qubits where p has ``basis`` and Q another non-identity code must
    be odd in number, so the top qubit's code is changed where they are
    even."""
    q = rng.choice(q_codes, len(p))
    clash = int(sum(1 for a, b in zip(p, q) if a == basis and b not in
                    (0, basis)))
    if clash % 2 == 0:
        q[-1] = 0 if q[-1] not in (0, basis) else min(
            c for c in q_codes if c not in (0, basis))
    return q


def k4_known_answers(torch, paulis, kernels, n, dtype, rng):
    """K4 against expectations of order 1 that are known for any n, and K3
    bit for bit against its plain version on the states it rotates.

    <+|P|+> = 1 for an X/I string P and <0|P|0> = 1 for a Z/I string.
    After e^{-i theta/2 Q} = co - i si Q with Q anticommuting with P, the
    expectation is co^2 - si^2 (cos theta, in the rotation's own scalars),
    since P fixes the start state and <start|Q|start> = 0 (Q holds a Y or Z
    against |+>, an X or Y against |0>).  The rotations take K3's pair walk
    (Q with X or Y) and its one-amplitude walk (a Z-only Q); the measured
    strings take K4's pair walk (X/I) and its one-amplitude walk (Z/I).
    Returns {label: {value, want, err, err_vs_plain}}."""
    tol = known_tolerance(dtype)
    out = {}
    for label, basis, q_codes in (("plus_x", 1, None), ("zero_z", 3, None),
                                  ("plus_x_after_q", 1, (0, 1, 2, 3)),
                                  ("plus_x_after_z_only_q", 1, (0, 3)),
                                  ("zero_z_after_q", 3, (0, 1, 2, 3))):
        p = basis * rng.integers(0, 2, n)
        p[-1] = basis
        start = (kernels.init_plus_state if basis == 1
                 else kernels.init_zero_state)
        x = start(1 << n, dtype, DEVICE)
        want = 1.0
        if q_codes is not None:
            rot = paulis.pauli_term(anticommuting(rng, p, basis, q_codes),
                                    dtype=dtype,
                                    theta=float(rng.uniform(0.2, 1.0)))
            y = paulis.direct_rotation_plain(x, rot, num_qubits=n)
            x = paulis.direct_rotation(x, rot, num_qubits=n)
            check(torch.equal(x, y), f"K3 {label} at {n} qubits: not "
                  "bit-identical to its plain version")
            del y
            want = rot.co ** 2 - rot.si ** 2
        term = paulis.pauli_term(p, dtype=dtype)
        got = float(paulis.expec_term(x, term, num_qubits=n))
        plain = float(paulis.expec_term_plain(x, term, num_qubits=n))
        err = abs(got - want)
        check(err <= tol, f"K4 {label} at {n} qubits: {got} != {want} "
              f"(|err| {err} > {tol})")
        check(abs(got - plain) <= pauli_tolerance(x),
              f"K4 {label} at {n} qubits: {got} vs plain {plain}")
        out[label] = {"value": got, "want": want, "err": err,
                      "err_vs_plain": abs(got - plain)}
        del x
    return out


def phase_pauli_parity(torch, np, paulis, kernels):
    n = N_PARITY
    rng = np.random.default_rng(4321)
    rows = pauli_cases(rng, n)
    out = {"n": n, "cases": [r[0] for r in rows], "k3_bit_identical": 0,
           "k3_max_abs_err": 0.0, "k4_max_abs_err": {}, "k4_known": {}}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        x = rng.standard_normal((2, 1 << n))
        x = torch.as_tensor(x / np.sqrt((x ** 2).sum()), dtype=dtype,
                            device=DEVICE)
        tol = pauli_tolerance(x)
        worst = 0.0
        for label, codes, offset, conj in rows:
            theta = float(rng.uniform(-np.pi, np.pi))
            term = paulis.pauli_term(codes, dtype=dtype, offset=offset,
                                     theta=-theta if conj else theta,
                                     conj=conj)
            y = paulis.direct_rotation(x.clone(), term, num_qubits=n)
            yp = paulis.direct_rotation_plain(x, term, num_qubits=n)
            check(torch.equal(y, yp), f"K3 {dname} {label}: not "
                  "bit-identical to its plain version")
            out["k3_bit_identical"] += 1
            out["k3_max_abs_err"] = max(out["k3_max_abs_err"],
                                        float((y - yp).abs().max()))
            r = float(paulis.expec_term(x, term, num_qubits=n))
            rp = float(paulis.expec_term_plain(x, term, num_qubits=n))
            check(abs(r - rp) <= tol, f"K4 {dname} {label}: {r} vs plain "
                  f"{rp}")
            worst = max(worst, abs(r - rp))
        out["k4_max_abs_err"][dname] = worst
        out["k4_known"][dname] = k4_known_answers(torch, paulis, kernels, n,
                                                  dtype, rng)
    sync()
    return out


def plain_workload(torch, paulis, kernels, api_ops, n, coeffs, codes,
                   dtype):
    """The config-5 workload through the plain versions on the card:
    (E0, E1, final state)."""
    terms = len(coeffs)

    def energy(a):
        return sum(float(c) * float(paulis.expec_term_plain(
            a, paulis.pauli_term(codes[t], dtype=dtype), num_qubits=n))
            for t, c in enumerate(coeffs))

    a = kernels.init_plus_state(1 << n, dtype, DEVICE)
    e0 = energy(a)
    for t, fac in api_ops._trotter_schedule(terms, *TROTTER):
        a = paulis.direct_rotation_plain(
            a, paulis.pauli_term(codes[t], dtype=dtype,
                                 theta=2.0 * fac * float(coeffs[t])),
            num_qubits=n)
    return e0, energy(a), a


def config5(qt, n, coeffs, codes):
    """The config-5 workload through the API: (register, hamil, E0, E1,
    calcTotalProb)."""
    env = qt.createQuESTEnv()
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    h = qt.createPauliHamil(n, len(coeffs))
    qt.initPauliHamil(h, coeffs, codes)
    e0 = qt.calcExpecPauliHamil(q, h)
    qt.applyTrotterCircuit(q, h, *TROTTER)
    e1 = qt.calcExpecPauliHamil(q, h)
    return q, h, e0, e1, qt.calcTotalProb(q)


def phase_pauli_main(torch, np, qt, paulis, kernels, api_ops, hamiltonians):
    n = N_PAULI
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   seed=PAULI_SEED)
    scale = float(np.abs(coeffs).sum())
    qt.set_precision(1)
    sync()
    paulis.reset_launch_counts()
    t0 = time.perf_counter()
    q, h, e0, e1, total = config5(qt, n, coeffs, codes)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(paulis.LAUNCHES)
    rotations = len(api_ops._trotter_schedule(PAULI_TERMS, *TROTTER))
    check(launches == {"K3": rotations, "K4": 2 * PAULI_TERMS},
          f"launches {launches}: want K3 = {rotations}, K4 = "
          f"{2 * PAULI_TERMS}")
    check(q.amps.shape == (2, 1 << n) and bool(torch.isfinite(q.amps).all()),
          "config 5: bad state")
    check(abs(total - 1.0) <= 1e-4, f"config 5: calcTotalProb {total}")
    # the same workload through the plain versions, float32, on the card
    p0, p1, a = plain_workload(torch, paulis, kernels, api_ops, n, coeffs,
                               codes, torch.float32)
    check(torch.equal(q.amps, a), f"config 5 at {n} qubits: the K3 state "
          "is not the plain versions' bit for bit")
    del a
    for got, want in ((e0, p0), (e1, p1)):
        check(abs(got - want) <= 1e-5 * scale,
              f"config 5 energy {got} vs plain {want}")
    out = {"n": n, "terms": PAULI_TERMS, "rotations": rotations,
           "launches": launches, "e0": e0, "e1": e1, "calc_total_prob": total,
           "e0_plain_f32": p0, "e1_plain_f32": p1,
           "state_bit_identical_to_plain": True, "first_wall_s": wall}
    # K3 works in place: nothing beside its input
    term = paulis.pauli_term(codes[0], dtype=torch.float32, theta=0.1)
    k3_mem = extra_bytes(lambda: paulis.direct_rotation(q.amps, term,
                                                        num_qubits=n))
    check(k3_mem <= 1 << 20, f"K3 allocates {k3_mem} bytes beside its input")
    out["k3_extra_mem_bytes"] = k3_mem
    del q
    torch.cuda.empty_cache()
    # E0 and E1 of this workload are ~0 (every term holds a Y or Z on
    # |+>^n, and the evolution keeps the energy), so K4 is also held
    # against values of order 1 at the main path's size
    out["k4_known"] = k4_known_answers(torch, paulis, kernels, n,
                                       torch.float32,
                                       np.random.default_rng(PAULI_SEED))
    torch.cuda.empty_cache()

    # float64 cross-check at 26 qubits (kernels in float32)
    m = N_PAULI_F64
    c26, k26 = hamiltonians.bench_pauli_hamil(m, PAULI_TERMS, seed=PAULI_SEED)
    s26 = float(np.abs(c26).sum())
    q26, _, f0, f1, _ = config5(qt, m, c26, k26)
    r0, r1, a64 = plain_workload(torch, paulis, kernels, api_ops, m, c26, k26,
                                 torch.float64)
    err = float((q26.amps.double() - a64).abs().max())
    tol = 1e-5 * float(a64.abs().max())
    check(err <= tol, f"config 5 at {m} qubits vs float64: |err| {err}")
    for got, want in ((f0, r0), (f1, r1)):
        check(abs(got - want) <= 1e-4 * s26,
              f"config 5 at {m} qubits energy {got} vs float64 {want}")
    out["f64_check"] = {"n": m, "state_max_abs_err": err,
                        "e0": f0, "e0_f64": r0, "e1": f1, "e1_f64": r1}
    del q26, a64

    # the QASM-recording route (per-term multiRotatePauli: basis gates
    # around a parity phase, ~1000 dense gates for 32 rotations) against
    # the K3 route at 20 qubits.  The routes are compared in float64, where
    # rounding cannot hide a disagreement; in float32 the K3 route is held
    # against float64 and the QASM route's drift is reported.
    m = N_QASM
    c20, k20 = hamiltonians.bench_pauli_hamil(m, PAULI_TERMS, seed=PAULI_SEED)
    env = qt.createQuESTEnv()
    h20 = qt.createPauliHamil(m, PAULI_TERMS)
    qt.initPauliHamil(h20, c20, k20)
    states = {}
    for prec in (2, 1):
        qt.set_precision(prec)
        for route in ("scan", "qasm"):
            reg = qt.createQureg(m, env)
            qt.initPlusState(reg)
            if route == "qasm":
                qt.startRecordingQASM(reg)
            qt.applyTrotterCircuit(reg, h20, *TROTTER)
            qt.stopRecordingQASM(reg)
            states[route, prec] = reg.amps.double()
    logged = sum("multiRotatePauli" in ln for ln in reg.qasm_log.lines)
    check(logged == rotations, f"QASM route logged {logged} rotations")
    ref = states["scan", 2]
    tol = 1e-5 * float(ref.abs().max())
    errs = {f"{route}_{'f64' if prec == 2 else 'f32'}_vs_scan_f64":
            float((states[route, prec] - ref).abs().max())
            for route, prec in (("qasm", 2), ("scan", 1), ("qasm", 1))}
    for label in ("qasm_f64_vs_scan_f64", "scan_f32_vs_scan_f64"):
        check(errs[label] <= tol, f"Trotter routes at {m} qubits, {label}: "
              f"|err| {errs[label]} > {tol}")
    out["qasm_route"] = {"n": m, "max_abs_err": errs, "tolerance": tol,
                         "logged_rotations": logged}
    torch.cuda.empty_cache()
    return out, h


def device_busy(torch, call, kernel: str):
    """(device ms, launches of ``kernel``) of one call under torch.profiler:
    the summed time of every kernel and copy the profiler saw on the card,
    and how many of those kernels were named ``kernel``; (None, None) if it
    saw nothing on the card."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        sync()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        return None, None
    return (sum(e.time_range.elapsed_us() for e in on_card) / 1e3,
            sum(1 for e in on_card if kernel in e.name))


def phase_pauli_timing(torch, qt, paulis, api_ops, hamiltonians, h):
    n = N_PAULI
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   seed=PAULI_SEED)
    env = qt.createQuESTEnv()
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    qt.applyTrotterCircuit(q, h, *TROTTER)
    x = q.amps
    state_bytes = x.numel() * x.element_size()
    amps = x.numel() // 2
    term = paulis.pauli_term(codes[0], dtype=torch.float32, theta=0.1)
    # at the main path's shape: K3 bit-identical, K4 within tolerance
    y = paulis.direct_rotation(x.clone(), term, num_qubits=n)
    yp = paulis.direct_rotation_plain(x, term, num_qubits=n)
    check(torch.equal(y, yp),
          f"K3 at {n} qubits: not bit-identical to its plain version")
    k3_err = float((y - yp).abs().max())
    del y, yp
    r = float(paulis.expec_term(x, term, num_qubits=n))
    rp = float(paulis.expec_term_plain(x, term, num_qubits=n))
    check(abs(r - rp) <= pauli_tolerance(x), f"K4 at {n} qubits: {r} vs {rp}")
    torch.cuda.empty_cache()

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["float32"]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                           else "operations")

    # K3: one read and one write of the state, 14 flops an amplitude; K4:
    # one read, 12 flops an amplitude
    k3_bound, k3_by = bound(2 * state_bytes, 14.0 * amps)
    k4_bound, k4_by = bound(state_bytes, 12.0 * amps)
    out = {"device": torch.cuda.get_device_name(0), "n": n,
           "state_bytes_f32": state_bytes, "fm": term.fm, "zm": term.zm,
           "k3": {"max_abs_err": k3_err,
                  "ms": time_ms(lambda: paulis.direct_rotation(
                      x, term, num_qubits=n)),
                  "plain_ms": time_ms(lambda: paulis.direct_rotation_plain(
                      x, term, num_qubits=n), reps=5),
                  "library_ms": None, "bound_ms": k3_bound,
                  "bound_by": k3_by},
           "k4": {"max_abs_err": abs(r - rp),
                  "ms": time_ms(lambda: paulis.expec_term(
                      x, term, num_qubits=n)),
                  "plain_ms": time_ms(lambda: paulis.expec_term_plain(
                      x, term, num_qubits=n), reps=5),
                  "library_ms": None, "bound_ms": k4_bound,
                  "bound_by": k4_by}}
    torch.cuda.empty_cache()
    walls = {}
    for label, fn in (("calc_expec_pauli_hamil_wall_s",
                       lambda: qt.calcExpecPauliHamil(q, h)),
                      ("apply_trotter_circuit_wall_s",
                       lambda: qt.applyTrotterCircuit(q, h, *TROTTER)),
                      ("calc_total_prob_wall_s",
                       lambda: qt.calcTotalProb(q))):
        samples = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append(time.perf_counter() - t0)
        walls[label] = statistics.median(samples)
    out.update(walls)
    rotations = len(api_ops._trotter_schedule(PAULI_TERMS, *TROTTER))
    # the device time of one call of each, over the median wall time above
    for label, kernel, launches, wall, call in (
            ("trotter", "pauli_rotation_kernel", rotations,
             walls["apply_trotter_circuit_wall_s"],
             lambda: qt.applyTrotterCircuit(q, h, *TROTTER)),
            ("expec", "pauli_expec_kernel", PAULI_TERMS,
             walls["calc_expec_pauli_hamil_wall_s"],
             lambda: qt.calcExpecPauliHamil(q, h))):
        dev, seen = device_busy(torch, call, kernel)
        check(seen in (None, launches), f"the profiler saw {seen} launches "
              f"of {kernel} in one call, not {launches}")
        out[f"{label}_busy"] = {
            "wall_ms": wall * 1e3, "device_ms": dev,
            "kernel_launches_seen": seen,
            "device_busy_share": (None if dev is None
                                  else dev / (wall * 1e3))}
    # the workload's least time: its 32 rotations and 2 x 16 term
    # expectations
    out["workload_bound_ms"] = (rotations * k3_bound
                                + 2 * PAULI_TERMS * k4_bound)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import numpy as np

        import quest_tpu_torch as qt
        from quest_tpu_torch import api_ops
        from quest_tpu_torch import circuit as C
        from quest_tpu_torch import fusion
        from quest_tpu_torch.models import circuits, hamiltonians
        from quest_tpu_torch.ops import build, cplx, fused, kernels, paulis
    except ImportError as e:
        print(f"chip_smoke: cannot import quest_tpu_torch ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the plain versions are the reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. device
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    build_s = build.build_kernels()
    emit({"phase": "build", "seconds": build_s,
          "sources": [f"quest_tpu_torch/csrc/{p.name}"
                      for p in build.sources()],
          "ptxas": build.kernel_resources()})

    # 3. parity
    parity = phase_parity(torch, np, fused)
    emit({"phase": "parity", **parity})

    # 4. main path
    n = N_MAIN
    qt.set_precision(1)
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    gates = circuits.bench_gate_list(n, DEPTH, us)
    t0 = time.perf_counter()
    plan = C.plan_circuit(gates, n, device=DEVICE)
    plan_s = time.perf_counter() - t0
    pst = C.stats(plan)
    ops = C.plan_to_device(plan, torch.float32, DEVICE)
    items = capture_items(qt, us, n)
    t0 = time.perf_counter()
    api_program = fusion.plan_items(items, n, device=DEVICE)
    api_plan_s = time.perf_counter() - t0
    ast = fusion.program_stats(api_program)

    fused.reset_launch_counts()
    t0 = time.perf_counter()
    a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
    a = C.execute_plan_chained(a, ops, n)
    p_bench = float(circuits.prob_top_zero_canonical(a))
    sync()
    bench_wall = time.perf_counter() - t0
    check(a.shape == (2, 1 << (n - 14), 128, 128)
          and bool(torch.isfinite(a).all()), "bench route: bad state")
    del a
    env = qt.createQuESTEnv()
    t0 = time.perf_counter()
    q = qt.createQureg(n, env)
    with qt.gateFusion(q):
        apply_bench_gates(qt, q, us, n)
    p_api = qt.calcProbOfOutcome(q, n - 1, 0)
    total = qt.calcTotalProb(q)
    sync()
    api_wall = time.perf_counter() - t0
    check(q.amps.shape == (2, 1 << n) and bool(torch.isfinite(q.amps).all()),
          "API route: bad state")
    launches = dict(fused.LAUNCHES)
    qt.destroyQureg(q, env)
    want = {"K1": pst["winfused"] + ast.get("winfused", 0),
            "K2": pst["megawin"] + ast.get("megawin", 0)}
    check(launches == want, f"launches {launches} != plans' {want}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"a kernel of the main path never launched: {launches}")
    a64 = circuits.zero_state_canonical(n, torch.float64, DEVICE)
    a64 = run_plain(torch, fused, a64,
                    C.plan_to_device(plan, torch.float64, DEVICE), n)
    p_ref = float(circuits.prob_top_zero_canonical(a64))
    del a64
    sync()
    check(abs(p_bench - p_api) <= 1e-5, f"routes disagree: {p_bench} "
          f"vs {p_api}")
    check(abs(p_bench - p_ref) <= 1e-5 and abs(p_api - p_ref) <= 1e-5,
          f"f32 routes vs f64 plain: {p_bench}, {p_api} vs {p_ref}")
    check(abs(total - 1.0) <= 1e-4, f"calcTotalProb {total}")
    emit({"phase": "main", "n": n, "depth": DEPTH, "gates": len(gates),
          "bench_plan": pst, "bench_plan_seconds": plan_s,
          "api_program": ast, "api_plan_seconds": api_plan_s,
          "api_items": len(items),
          "p_top_zero_bench": p_bench, "p_top_zero_api": p_api,
          "p_top_zero_f64_plain": p_ref, "calc_total_prob": total,
          "launches": launches,
          "bench_route_first_wall_s": bench_wall,
          "api_route_first_wall_s": api_wall})

    # 5. timing at the main path's shapes (f32, 26 qubits)
    num_amps = 1 << n
    x = torch.randn((2, 1 << (n - 14), 128, 128), dtype=torch.float32,
                    device=DEVICE)
    x /= torch.sqrt(torch.sum(x * x))
    state_bytes = x.numel() * x.element_size()
    winfused = [op for op in ops if op[0] == "winfused"]
    dual = next(op for op in winfused
                if op[4] and op[5] and op[2].shape[0] == 1)
    bonly = next(op for op in winfused
                 if op[5] and not op[4] and op[2].shape[0] == 1)
    group = max((op[1] for op in ops if op[0] == "megawin"), key=len)

    def k1(op):
        return lambda: fused.apply_window_stack(
            x, op[2], op[3], op[6], num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5])

    def plain1(op):
        return lambda: fused.window_pass_plain(
            x, op[2], op[3], op[6], num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5])

    def library(op):
        """One torch.einsum on the complex views: the same function as
        the pass (a yardstick only; the port never calls it)."""
        hi = 1 << (n - op[1] - 7)
        mid = 1 << (op[1] - 7)
        xc = cplx.to_complex(x.reshape(2, hi, 128, mid, 128))
        ac = torch.complex(op[2][0, 0], op[2][0, 1])
        bc = torch.complex(op[3][0, 0], op[3][0, 1])
        if op[6] is not None:
            mc = torch.complex(op[6][0], op[6][1])
            if op[4]:
                return lambda: torch.einsum("qw,hwml,pl,qp->hqmp", bc, xc,
                                            ac, mc)
            return lambda: torch.einsum("qw,hwml,ql->hqml", bc, xc, mc)
        if op[4]:
            return lambda: torch.einsum("qw,hwml,pl->hqmp", bc, xc, ac)
        return lambda: torch.einsum("qw,hwml->hqml", bc, xc)

    def time_k1(op, dtype_name):
        b_ms, b_by = bound_ms([op], x.numel() * x.element_size(), num_amps,
                              dtype_name)
        # the kernel against its plain version at the main path's shape
        err = float((k1(op)() - plain1(op)()).abs().max())
        check(err <= tolerance(x), f"K1 at {n} qubits, {dtype_name}, "
              f"k={op[1]}: |err| {err}")
        return {"k": op[1], "mask": op[6] is not None, "dtype": dtype_name,
                "max_abs_err": err, "extra_mem_bytes": extra_bytes(k1(op)),
                "ms": time_ms(k1(op)), "plain_ms": time_ms(plain1(op), reps=5),
                "library_ms": time_ms(library(op), reps=5),
                "bound_ms": b_ms, "bound_by": b_by}

    timing = {"k1_dual_rank1": time_k1(dual, "float32"),
              "k1_b_only_rank1": time_k1(bonly, "float32")}
    b_ms, b_by = bound_ms(list(group), state_bytes, num_amps, "float32")
    y2 = fused.apply_window_megastack(x, group, num_qubits=n)
    check(torch.equal(y2, C.execute_plan(x, group, n)),
          f"K2 at {n} qubits: not bit-identical to K1 pass by pass")
    err = float((y2 - fused.megawin_plain(x, group, num_qubits=n))
                .abs().max())
    check(err <= len(group) * tolerance(x), f"K2 at {n} qubits: |err| {err}")
    del y2
    # K2 holds its output and a scratch of one super-block per resident
    # cluster beside its input, never a second full-size buffer
    k2_mem = extra_bytes(lambda: fused.apply_window_megastack(
        x, group, num_qubits=n))
    check(k2_mem < state_bytes + state_bytes // 4,
          f"K2 at {n} qubits allocates {k2_mem} bytes beside a "
          f"{state_bytes}-byte state")
    timing["k2_largest_group"] = {
        "passes": len(group), "kmax": max(op[1] for op in group),
        "max_abs_err": err, "bit_identical_to_k1": True,
        "extra_mem_bytes": k2_mem,
        "ms": time_ms(lambda: fused.apply_window_megastack(
            x, group, num_qubits=n)),
        "plain_ms": time_ms(lambda: fused.megawin_plain(
            x, group, num_qubits=n), reps=5),
        "per_pass_k1_ms": time_ms(lambda: C.execute_plan(x, group, n)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    # the same dual-side pass in float64 (1 GB state), on the FP64 rate
    x = x.double()
    timing["k1_dual_rank1_f64"] = time_k1(
        tuple(t.double() if torch.is_tensor(t) else t for t in dual),
        "float64")
    del x

    def bench_route():
        a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
        a = C.execute_plan_chained(a, ops, n)
        return float(circuits.prob_top_zero_canonical(a))

    def api_route():
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        p = qt.calcProbOfOutcome(q, n - 1, 0)
        qt.destroyQureg(q, env)
        return p

    walls = {}
    for label, fn in (("bench_route_wall_s", bench_route),
                      ("api_route_wall_s", api_route)):
        samples = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append(time.perf_counter() - t0)
        walls[label] = statistics.median(samples)
    api_plan_ops = [op for _kind, part in api_program
                    for op in C.plan_to_device(part, torch.float32, DEVICE)]
    breakdown = {}
    for label, route_ops, wall in (("bench", ops, walls["bench_route_wall_s"]),
                                   ("api", api_plan_ops,
                                    walls["api_route_wall_s"])):
        by_kind = op_breakdown(torch, C, route_ops, n)
        busy = sum(by_kind.values())
        breakdown[label] = {"ms_by_op": by_kind, "device_ms": busy,
                            "device_busy_share": busy / (wall * 1e3)}
    # host work of the API route before its drain reaches the card: the
    # 770 gate calls (validation, QASM record, capture) and the drain's
    # optimizer pass and plan-cache lookup
    breakdown["api"]["host_gate_calls_ms"] = host_ms(
        lambda: capture_items(qt, us, n))
    breakdown["api"]["host_plan_lookup_ms"] = host_ms(
        lambda: fusion.plan_items(items, n, device=DEVICE))
    plan_bound = bound_ms(
        [op for o in ops for op in (o[1] if o[0] == "megawin" else (o,))],
        0, num_amps, "float32")[0]
    emit({"phase": "timing", "device": name, "power": smi,
          "state_bytes_f32": state_bytes, **timing,
          **walls, "breakdown": breakdown,
          "bench_plan_flop_bound_ms": plan_bound})

    del ops, api_plan_ops
    torch.cuda.empty_cache()

    # 6. Pauli kernels against their plain versions
    pparity = phase_pauli_parity(torch, np, paulis, kernels)
    emit({"phase": "pauli_parity", **pparity})

    # 7. the config-5 path at 30 qubits
    pmain, hamil = phase_pauli_main(torch, np, qt, paulis, kernels, api_ops,
                                    hamiltonians)
    launches.update(pmain["launches"])
    emit({"phase": "pauli_main", **pmain})

    # 8. Pauli timing at 30 qubits
    ptiming = phase_pauli_timing(torch, qt, paulis, api_ops, hamiltonians,
                                 hamil)
    emit({"phase": "pauli_timing", "power": smi, **ptiming})

    # 9. kernels
    def entry(kname, replaces, t, err, source="window.cu"):
        return {"name": kname, "route": "cuda",
                "source": f"quest_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[kname[:2]],
                "max_abs_err": err, "max_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    k1e = entry("K1 window pass", "quest_tpu/ops/fused.py:497",
                timing["k1_dual_rank1"],
                max(max(parity["k1_max_abs_err"].values()),
                    *(timing[t]["max_abs_err"] for t in
                      ("k1_dual_rank1", "k1_b_only_rank1",
                       "k1_dual_rank1_f64"))))
    k1e["b_only"] = timing["k1_b_only_rank1"]
    k2e = entry("K2 window megakernel", "quest_tpu/ops/fused.py:799",
                timing["k2_largest_group"],
                max(timing["k2_largest_group"]["max_abs_err"],
                    *(g["max_abs_err_vs_plain"] for g in parity["k2"])))
    k3e = entry("K3 direct Pauli rotation", "quest_tpu/ops/paulis.py:625",
                ptiming["k3"], max(ptiming["k3"]["max_abs_err"],
                                   pparity["k3_max_abs_err"]), "paulis.cu")
    known = [*pmain["k4_known"].values(),
             *(c for by_label in pparity["k4_known"].values()
               for c in by_label.values())]
    k4e = entry("K4 Pauli-term expectation", "quest_tpu/ops/paulis.py:602",
                ptiming["k4"],
                max(ptiming["k4"]["max_abs_err"],
                    *pparity["k4_max_abs_err"].values(),
                    *(c["err_vs_plain"] for c in known)), "paulis.cu")
    # K4 against exact expectations of order 1 (k4_known_answers)
    k4e["known_answer_max_abs_err"] = max(c["err"] for c in known)
    for e in (k3e, k4e):
        e["library_note"] = ("no single PyTorch call computes a Pauli-string "
                             "term")
    emit({"kernels": [k1e, k2e, k3e, k4e]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
