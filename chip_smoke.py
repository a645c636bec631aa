#!/usr/bin/env python3
"""Drive quest_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
line:

1. device  - the card's name and power limit; a CUDA device is required.
2. build   - nvcc builds csrc/window.cu (K1, K2, K11, K12: tensor-core
             products, TF32 split at float32 or the lower modes' bf16 and
             TF32 products, DMMA at float64),
             csrc/paulis.cu (K3, K4), csrc/channels.cu (K5) and
             csrc/qft.cu (K6-K10) into one library, one nvcc process per
             source.
3. parity  - K1 against its plain PyTorch version at 20 qubits (f32 and
             f64, k in {7, 10, 13}, rank 1 and 4, dual / B-only / A-only,
             with and without a mask; mask-only passes; 0/1 permutation
             sides bit for bit); K2 against K1 pass by pass
             (bit-identical) and against its plain version, one group
             holding a mask-only pass, and the shapes of the bench plan's
             groups (G = 1; G = 8, whose 8 super-blocks give fewer items a
             pass than the grid has CTAs), each launched twice with equal
             results (the workspace is reset), f32 and f64.
4. main    - the bench.py config-2 workload at 26 qubits, depth 20, f32
             (770 gates), by two routes: (a) bench_gate_list -> plan ->
             execute_plan_chained -> prob_top_zero_canonical; (b) the API:
             createQureg, the same gates under gateFusion, then
             calcProbOfOutcome and calcTotalProb.  Both probabilities are
             held against each other and against the same plan run through
             the plain versions in f64; K1's and K2's launch counts must
             equal what the plans contain.  A lone controlledPhaseShift
             drained under gateFusion (one mask-only pass) within
             tolerance of the eager route.
5. timing  - CUDA-event medians of K1 (a dual-side and a B-only rank-1
             pass, and the dual pass in f64) and K2 (each of the bench
             plan's three groups, timed in turns with its passes through
             K1, and group C in f64, with the schedule's grid, super-blocks,
             window, slots and workspace bytes; K2 on one dual and one
             B-only pass; nvidia-smi's clock and power while group C runs
             through K1 and through K2) at the main path's shapes,
             their plain versions, the fastest single full-float32
             torch.einsum of K1's function and the kernel's ratio to it,
             the least time the card could take (window products at a
             third of the TF32 rate: WINDOW_FLOPS), nvidia-smi's SM clock
             and power draw while K1 runs back to back, and the wall time
             of both routes.
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
9. qft_parity - at 20 qubits, float32, each bit for bit against its plain
             version: K8 over ten layer chunks (k = 1..5, with H = 1 and
             M = 1 among them), K9, K6 for t = 14..19, K7 for t = 7..13,
             all in both conj values; K10 at (n, g) = (20, 2), (20, 4),
             (28, 7).  K1 on every window pass of the 30-qubit QFT's plan
             at 2^30 amplitudes (bit for bit where the pass is a
             permutation, within 1e-5 max|psi| otherwise).
10. qft_main - bench.py config 3 at 30 qubits, float32: two
             circuit.fused_qft from |0...0> (amp_0 back at 1 within 1e-5;
             launches per QFT as the plan says: K8 4, K9 1, K1 4, K10 1);
             QFT|x> against e^{2 pi i x y / 2^n} / 2^{n/2} at 4096 sampled
             y; applyFullQFT on a random state against torch.fft.ifft
             within 1e-5 max|psi|; the route bit for bit against the same
             route through the plain versions of K6-K10; at 26 qubits
             against a float64 FFT; applyFullQFT on a 15-qubit density
             register (K6 once, K7 seven times) bit for bit against its
             plain route, calcTotalProb within 1e-4 of 1.
11. qft_timing - CUDA-event medians of K8 (each chunk), K9, K6, K7, K10
             and K1's two QFT pass kinds at 2^30 amplitudes against their
             bounds, plain versions and library yardsticks (torch.fft for
             the whole QFT); wall time and busy share of fused_qft and
             applyFullQFT.
12. channel_parity - K5 against its plain version, bit for bit: at 2^20
             amplitudes over its program shapes (lane and sublane ket bits,
             in-block and grid channels in one sweep of rank 7 = two
             launches, the top chunk, both kinds mixed, a channel twice in
             a row, a density layer), and at 2^28 on a config-4 layer (five
             sweeps); launches as sweep_launch_groups says.
13. noise_main - bench.py config 4 (one mixDepolarising per qubit, one
             mixTwoQubitKrausMap on (0, 1), p = 0.05, Kraus seed 5) from
             |+><+|^n, float32.  14 qubits: the plan of four layers holds
             four chansweep parts and four apply ops; one layer under
             gateFusion launches K5 five times, four layers in one drain
             twenty; that drain bit for bit against its plain route (K5's
             plain version) on the card; calcFidelity within 1e-5 of the
             float64 route and of the eager route; calcTotalProb within
             1e-4 of 1; depolarise-only and damping-only layers within
             1e-5 relative of (1 - 2p/3)^n and ((1 + sqrt(1-p)) / 2)^n; a
             depth-2 config-2 gate layer and a noise layer in one drain
             (K1 and K5) within 1e-5 max|rho| of the eager route.  15
             qubits (2^30 amplitudes): one fused layer launches no K5 (the
             per-channel route), within 1e-5 of the eager route, both known
             answers.
14. noise_timing - CUDA-event medians of K5 on each sweep of a 14-qubit
             layer against its bound and plain version, of the Kraus map's
             apply op and of one per-channel pass; the wall time per layer
             (fused and eager at 14 qubits, fused at 15) and its device
             busy share from torch.profiler.
15. paged_parity - at 20 qubits, f32 and f64, rank 1 and 4: K11 bit for
             bit against K1 at k = 7 and against its plain version; K12
             over h in {14, 16, 17}, b in {7, 9, 11}, m in {1, 2, 3}, bit
             for bit against segswap followed by K11 and against its plain
             version (the tolerance K1 has).
16. paged_main - bench.py config 2 at 26 qubits, depth 20, f32 through the
             paged planner (QT_PLANNER=paged for this phase only): (a)
             plan_circuit(planner="paged") -> plan_to_device ->
             execute_plan_chained -> prob_top_zero_canonical; (b) the API
             route under gateFusion.  P(top = 0) of both within 1e-5 of
             the windowed bench route's (phase 4) and of the paged plan
             through the plain versions in f64; calcTotalProb within 1e-4
             of 1; the whole final state of the bench route bit-identical
             to its plan with every swapfused op run as segswap then K11,
             and within 1e-5 max|psi| of the windowed route's, and the API
             route's within 1e-5 max|psi| of the bench route's; K11 and K12
             launch as often as each route's plan holds fused / swapfused
             passes, K1 and K2 never.
17. paged_timing - CUDA-event medians at 2^26 amplitudes, f32, of K11 and
             K12 (m = 3) at rank 1 and 4 against their bounds, plain
             versions and the fastest of four single-einsum yardsticks
             (B.X or X.A first, with or without K1's size-1 axis;
             rank-free at rank 1), and the ratio to it; the segswap op by
             width m;
             both paged routes' wall time, device busy share and device ms
             by op kind.
18. measure_parity - the seeded measurement streams at 20 qubits (state
             vector) and 10 (density, 2^20 amplitudes), float32 and
             float64: the threshold stream uploaded to the card for seeds
             [1234, 5678], shots 0-999, bit for bit against
             ops/threefry.py's host values and its first three against
             the values tests/test_torch_rng.py pins against JAX;
             measureSequence over every qubit against a measureWithStats
             loop on a cloneQureg copy reseeded the same way (the same
             outcomes and probabilities bit for bit, torch.equal states);
             the QT_HOST_MEASURE=1 route and the default route on the card
             against the port on the CPU, same seed and preparation (the
             same outcomes); collapseToOutcome on a zero-probability
             outcome raises.
19. measure_main - config 2's circuit at 26 qubits, depth 20, f32,
             through the API under gateFusion, then measureSequence over
             all 26 qubits in the same block, seed [1234]: |amp[x]| and
             calcTotalProb within 1e-5 of 1 at the index x the outcomes
             spell; each probability within 1e-5 of calcProbOfOutcome on
             a clone collapsed step by step; K1 and K2 launch as the
             plan holds and nothing else launches.  A 13-qubit density
             register (2^26 amplitudes) after one config-4 noise layer,
             measured in full: calcPurity within 1e-5 of 1.
             shot_sampling.py's preparation at 12 qubits, 2000 shots
             through measureSequence: each qubit's frequency of 1 within
             4 sigma of its exact marginal (calcProbOfAllOutcomes).
20. measure_timing - at 26 qubits, f32: wall ms per measured qubit of
             measureSequence, a measureWithStats loop and the
             QT_HOST_MEASURE=1 loop, their device busy share and
             host-device copies per sequence (torch.profiler), the
             probability reduction's and the collapse's device ms, and
             the bound per qubit by bytes.
21. precision_parity - K1, K2, K11 and K12 under the reference's lower
             matmul precisions ("bf16_3x": three bf16 products; "default":
             one TF32 product) at 20 qubits, float32: K1 at k in {7, 10,
             13}, rank 1 and 4, dual / B-only / A-only, with and without a
             mask, against the mode's plain model (fused.window_pass_split)
             within MODE_UNIT max|psi| and the full float32 plain version
             within 4 MODE_UNIT max|psi|; mask-only passes bit for bit
             equal to "highest"; K2 on config 2's group shapes and a mixed
             group bit for bit against its passes through K1 and within
             len * MODE_UNIT of its model; K11 bit for bit against K1 at
             k = 7, K12 against segswap + K11; at float64 every mode bit
             for bit equal to "highest".
22. precision_main - config 2 at 26 qubits under each lower mode: the
             bench route (execute_plan_chained(..., precision=mode)) and
             the API route (set_matmul_precision(mode) around the
             gateFusion drain, "highest" restored after), each with the
             launch counts reset just before it: P(top = 0) within
             MODE_PROB_LIMIT of the "highest" bench route's (1e-4 bf16_3x,
             1e-2 default), the total probability within the same limit,
             the launches the plans hold, the wall per circuit; K1 (dual
             and B-only), K2 (group C), K11 and K12 at 2^26 under the
             mode: ms, bound at the mode's rate (MODE_FLOPS), error
             against the model.
23. diagonal_main - DiagonalOp and the phase functions at 30 qubits,
             float32 (an 8.6 GB state and an 8.6 GB operator; plain
             PyTorch, as the reference's plain XLA):
             initDiagonalOpFromPauliHamil of a weighted MaxCut ring (seed
             7) at 4098 sampled indices, calcExpecDiagonalOp on |+>^30 (0)
             and on a basis state (its ring energy), applyDiagonalOp,
             applyPhaseFuncOverrides on all 30 qubits and
             applyParamNamedPhaseFunc(SCALED_DISTANCE) over two 15-qubit
             registers against the analytic phases at sampled indices; a
             15-qubit density register (2^30 amplitudes): calcExpec-
             DiagonalOp before and after applyDiagonalOp against known
             answers, D rho at sampled elements; the wall per call and the
             peak device memory.
24. quad_main - set_precision(4) (float64 storage, double-double
             reductions): config 2's circuit at 26 qubits through the API;
             calcTotalProb, calcProbOfOutcome, calcInnerProduct against a
             clone and calcExpecPauliHamil (config 5's 16 terms) within
             1e-12 of the precision-2 route on the same register; K4
             launches 0 times at quad and 16 at precision 2; a 2^26
             cancellation state (the reference's _cancel_vec at the scale
             of the quad sum's 256 partials) whose Z expectation the quad
             route keeps exactly; each read-out's wall at both precisions.
25. batch_parity - the bank forms at 20 qubits, B = 4: bank K1 bit for
             bit against four scalar K1 launches (float32 and float64,
             rank 1 and 4, dual / B-only / A-only, with and without a
             mask, shared and per-element sides and masks); a float32
             bank mixing exact (0/1) and inexact sides, each element its
             own split and its scalar bits; bank K2 on config 2's group
             shapes bit for bit against bank K1 pass by pass and
             per-element K2; bank K5 on a config-4 layer over four
             10-qubit density registers bit for bit against per-element
             K5 and its plain version; each one launch.
26. batch_main - (a) randomized compiling of config 2 at 26 qubits x 8
             (each element its own unitaries, seeds 7..14, the CNOTs
             shared; 4 GiB of bank): the bench route (the elements' plans
             stacked, execute_plan on the bank: K1 and K2 bank as often
             as one element's plan holds) and the API route (applyBatchedUnitary
             and controlledNot under the bank's drain: K1 bank), elements
             0 and 7 equal to their scalar routes bit for bit, every
             element's P(top = 0) equal to its scalar drain's, the bank
             drain's wall against eight scalar drains with planning apart
             and device ms by op kind; measureBatched over all 26 qubits
             (elements 0 and 7 against measureWithStats loops seeded the
             same way); K1 and K2 bank at this shape (ms, plain, bound,
             a batched einsum for K1).  (b) EnsembleScheduler: 64
             submissions of config 2's structure at 20 qubits, one bucket;
             four equal their independent runs; wall per circuit against
             a loop of scalar drains.  (c) run_trajectories: 256 at 20
             qubits (depolarising on every qubit, damping on qubit 0)
             with every norm within 1e-5 of 1; 4096 at 8 qubits, the
             Z-sum's mean within 5 SEM of the density-matrix route.  (d) a
             density bank of four 13-qubit registers under one config-4
             noise layer: K5 bank once per sweep group for the bank, each
             element its scalar drain bit for bit; K5 bank's time.
27. models_main - VQE (examples/vqe_train.py's model) at 20 qubits,
             float64: ten Adam steps, the energy falls, the autograd
             gradient within 1e-3 relative of central differences at its
             three largest entries; QAOA (examples/qaoa_maxcut.py's) at
             24 qubits, float32: ten steps, the expected cut rises; wall
             per step and peak memory.
28. kernels - one JSON object with every kernel's numbers (K1, K2, K11
             and K12 with their per-mode times, bounds, launches and
             errors under "modes"; K1, K2 and K5's bank forms).

The last two lines are the card's `nvidia-smi` name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

N_PARITY = 20          # qubits for the kernel parity checks
N_MAIN = 26            # the main path's register
N_MEAS_MAIN = 26       # the measured register (config 2's circuit)
DEPTH = 20
SEED = 7               # bench.py config 2's unitary seed
REPS = 10              # timed launches per kernel
DEVICE = "cuda"
N_PAULI = 30           # config 5's register: an 8 GiB float32 state
N_PAULI_F64 = 26       # the float64 cross-check of the config-5 workload
N_QASM = 20            # the QASM-recording Trotter route
N_QFT = 30             # bench.py config 3: a full QFT at 30 qubits, f32
N_QFT_F64 = 26         # the float64 cross-check of the QFT
N_QFT_RHO = 15         # a density register of 2^30 amplitudes (K6, K7)
SIGMA_PARITY = ((20, 2), (20, 4), (28, 7))   # K10's (n, g) parity cases
N_QFT_KNOWN = 4096     # sampled amplitudes of each QFT known answer
QFT_SEED = 11
PAULI_TERMS = 16       # bench.py config 5's Hamiltonian: 16 terms, seed 7
PAULI_SEED = 7
TROTTER = (0.1, 2, 1)  # time, order, reps: 32 term rotations
N_CHAN_PARITY = 20     # bits of K5's parity checks over program shapes
N_NOISE = 14           # config 4's density register: 2^28 amplitudes, K5
N_NOISE_BIG = 15       # 2^30 amplitudes: the per-channel route, no K5
NOISE_P = 0.05         # bench.py config 4's probability
NOISE_LAYERS = 4       # layers in one drain
NOISE_SEED = 5         # bench.py config 4's Kraus draw
# K12's parity cases (h, b, m) at N_PARITY qubits
PAGED_SWAPS = tuple((h, b, m) for h in (14, 16, 17) for b in (7, 9, 11)
                    for m in (1, 2, 3))

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bandwidth and the highest rate of each type for elementwise work: FP32
# on the CUDA cores, FP64 on the tensor cores (DMMA; twice the CUDA cores'
# 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# The window kernels' matrix products (K1, K2, K11, K12): a float32
# product accurate to float32 costs at least three TF32 tensor-core
# products (the TF32 split of csrc/window.cu), so the least time is the
# flops over a third of the dense TF32 rate, 495 TFLOP/s; float64 runs on
# DMMA at the FP64 tensor-core rate.
WINDOW_FLOPS = {"float32": 495e12 / 3, "float64": 67e12}


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
    sides scaled by 1/rank and a unit-modulus mask, as NumPy arrays;
    ``sides`` is "AB", "A", "B" or "M" (mask-only: neither side)."""
    import numpy as np

    def stack():
        return np.stack([np.stack([u.real, u.imag]) / rank for u in
                         (random_unitary(rng, 128) for _ in range(rank))])

    mask = None
    if with_mask:
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
        mask = np.stack([ph.real, ph.imag])
    return ("winfused", k, stack(), stack(), "A" in sides, "B" in sides,
            mask)


def permutation_pass(rng, k: int, sides: str):
    """A window pass whose used sides are random 0/1 permutation matrices
    (every entry a TF32 value): K1 must equal its plain version bit for
    bit."""
    import numpy as np

    def perm():
        m = np.zeros((1, 2, 128, 128))
        m[0, 0, np.arange(128), rng.permutation(128)] = 1.0
        return m

    return ("winfused", k, perm(), perm(), "A" in sides, "B" in sides, None)


def flops_of(op, num_amps: int) -> float:
    """Real flops of one window pass: 8 per complex multiply-add, 128 per
    output amplitude per side per rank, plus 6 per amplitude for a mask."""
    rank = int(op[2].shape[0])
    sides = int(bool(op[4])) + int(bool(op[5]))
    f = 8.0 * 128 * rank * sides * num_amps
    if len(op) > 6 and op[6] is not None:
        f += 6.0 * num_amps
    return f


def bound_ms(ops, state_bytes: int, num_amps: int, dtype_name: str,
             rate=None):
    """The least time the card could take for a run of window passes: one
    read and one write of the state plus each matrix read once, over the
    memory rate, against the flops over the window products' rate
    (``rate``, by default WINDOW_FLOPS); and which of the two bounds
    it."""
    mat_bytes = sum(op[2].numel() * op[2].element_size()
                    * (int(bool(op[4])) + int(bool(op[5])))
                    + (0 if op[6] is None
                       else op[6].numel() * op[6].element_size())
                    for op in ops)
    t_bytes = (2 * state_bytes + mat_bytes) / HBM_BYTES_PER_S
    t_ops = (sum(flops_of(op, num_amps) for op in ops)
             / (rate or WINDOW_FLOPS[dtype_name]))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def smi_under_load(torch, fn, seconds: float) -> dict:
    """`nvidia-smi` samples of the SM clock and the power draw every
    100 ms while ``fn`` runs back to back for about ``seconds``: the
    median, least and most of each, beside the power limit."""
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    per = max(time.perf_counter() - t0, 1e-4)
    query = "clocks.sm,power.draw,power.limit,temperature.gpu"
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        time.sleep(0.3)
        for _ in range(max(1, int(seconds / per))):
            fn()
        sync()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    rows = []
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            rows.append([float(p) for p in parts[:4]])
        except ValueError:
            continue
    # the samples taken while the kernel ran (the first few precede it)
    rows = rows[3:] or rows
    check(bool(rows), "nvidia-smi gave no samples under load")
    out = {"samples": len(rows), "power_limit_w": rows[-1][2]}
    for i, key in ((0, "clocks_sm_mhz"), (1, "power_draw_w"),
                   (3, "temperature_c")):
        vals = [r[i] for r in rows]
        out[key] = {"median": statistics.median(vals), "min": min(vals),
                    "max": max(vals)}
    return out


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
            # a pass that folded only cross diagonals: mask (.) X
            op = random_pass(rng, k, 1, "M", True)
            y = fused.apply_window_stack(x, op[2], op[3], op[6],
                                         num_qubits=n, k=k, apply_a=False,
                                         apply_b=False)
            yp = fused.window_pass_plain(x, op[2], op[3], op[6],
                                         num_qubits=n, k=k, apply_a=False,
                                         apply_b=False)
            err = float((y - yp).abs().max())
            check(err <= tol, f"K1 {dtype} k={k} mask-only: |err| {err} > "
                  f"{tol}")
            worst = max(worst, err)
            out["k1_mask_only_cases"] = out.get("k1_mask_only_cases", 0) + 1
            # 0/1 permutation sides: the exact products, bit for bit
            for sides in ("AB", "B", "A"):
                op = permutation_pass(rng, k, sides)
                y = fused.apply_window_stack(
                    x, op[2], op[3], None, num_qubits=n, k=k, apply_a=op[4],
                    apply_b=op[5])
                yp = fused.window_pass_plain(
                    x, op[2], op[3], None, num_qubits=n, k=k, apply_a=op[4],
                    apply_b=op[5])
                check(torch.equal(y, yp), f"K1 {dtype} k={k} {sides}: a "
                      "permutation pass is not bit-identical to its plain "
                      "version")
                out["k1_permutation_cases"] = (
                    out.get("k1_permutation_cases", 0) + 1)
        sync()
        out["k1_max_abs_err"][str(dtype).split(".")[-1]] = worst
        # K2: groups with G = 8, G = 1 and G = 4 with a mask-only pass
        # inside, then the shapes of the bench plan's groups (20 qubits:
        # the G = 8 group has 8 super-blocks of 16 items, fewer items a
        # pass than the grid has CTAs; the G = 1 groups 64 of 2)
        for spec in ([(7, 1, "AB", True), (10, 2, "B", False),
                      (8, 4, "A", True), (9, 1, "AB", False),
                      (10, 1, "B", True)],
                     [(7, 1, "AB", False), (7, 4, "B", True),
                      (7, 2, "A", False)],
                     [(8, 1, "AB", True), (9, 1, "M", True),
                      (7, 2, "B", False)],
                     *K2_BENCH_GROUPS.values()):
            group = [random_pass(rng, k, r, s, m) for k, r, s, m in spec]
            out["k2"].append(k2_case(torch, fused, x, group, n, tol, spec))
    return out


# The shapes (k, rank, sides, mask) of bench.py config 2's megawin groups
# at 26 qubits, depth 20: groups A and B (G = 1) and group C (G = 8).
K2_BENCH_GROUPS = {
    "AB": [(7, 1, "B", True), (7, 1, "AB", True)],
    "C": [(7, 1, "B", True), (7, 1, "AB", True), (7, 1, "AB", True),
          (7, 1, "AB", False), (10, 1, "B", False)],
}


def k2_case(torch, fused, x, group, n, tol, spec):
    """K2 on one group: bit-identical to its passes through K1 and to a
    second launch right after it (the workspace is reset), within
    len(group) * tol of its plain version."""
    y2 = fused.apply_window_megastack(x, group, num_qubits=n)
    again = fused.apply_window_megastack(x, group, num_qubits=n)
    y1 = x
    for op in group:
        y1 = fused.apply_window_stack(
            y1, op[2], op[3], op[6], num_qubits=n, k=op[1],
            apply_a=op[4], apply_b=op[5])
    yp = fused.megawin_plain(x, group, num_qubits=n)
    sync()
    dtype = str(x.dtype).split(".")[-1]
    check(torch.equal(y2, y1), f"K2 {dtype} {spec}: not bit-identical to "
          "K1 pass by pass")
    check(torch.equal(y2, again), f"K2 {dtype} {spec}: a second launch "
          "differs from the first")
    err = float((y2 - yp).abs().max())
    check(err <= len(group) * tol, f"K2 {dtype} {spec}: |err| {err} vs "
          "plain")
    kmax = max(op[1] for op in group)
    sched = fused.megawin_schedule(
        n, 1 << (kmax - 7), len(group), x.dtype,
        fused.megawin_ctas(x.device, x.dtype))
    return {"dtype": dtype, "passes": len(group), "kmax": kmax,
            "bit_identical_to_k1": True, "repeat_equal": True,
            "max_abs_err_vs_plain": err,
            **{key: sched[key] for key in ("ctas", "super_blocks",
                                           "window", "slots")}}
    return out


def time_k2_group(torch, C, fused, x, group, n, dtype_name):
    """K2 on one megawin group at the main path's shape: bit-identical to
    its passes through K1 and within len(group) * tolerance of its plain
    version; its memory beside the state below a quarter of it (its
    output aside); then its time and its passes' through K1 in turns
    (K1, K2, K2, K1), the plain version's, its bound and its schedule."""
    state_bytes = x.numel() * x.element_size()
    num_amps = x.numel() // 2

    def k2():
        return fused.apply_window_megastack(x, group, num_qubits=n)

    def k1():
        return C.execute_plan(x, group, n)

    y2 = k2()
    check(torch.equal(y2, k1()), f"K2 {dtype_name} at {n} qubits: not "
          "bit-identical to K1 pass by pass")
    err = float((y2 - fused.megawin_plain(x, group, num_qubits=n))
                .abs().max())
    check(err <= len(group) * tolerance(x),
          f"K2 {dtype_name} at {n} qubits: |err| {err}")
    del y2
    # K2 holds its output, its slots and counters beside its input, never
    # a second full-size buffer
    k2_mem = extra_bytes(k2)
    check(k2_mem < state_bytes + state_bytes // 4,
          f"K2 at {n} qubits allocates {k2_mem} bytes beside a "
          f"{state_bytes}-byte state")
    turns = [time_ms(f) for f in (k1, k2, k2, k1)]
    b_ms, b_by = bound_ms(list(group), state_bytes, num_amps, dtype_name)
    kmax = max(op[1] for op in group)
    sched = fused.megawin_schedule(n, 1 << (kmax - 7), len(group), x.dtype,
                                   fused.megawin_ctas(x.device, x.dtype))
    ms = (turns[1] + turns[2]) / 2
    return {"passes": len(group), "kmax": kmax, "dtype": dtype_name,
            "max_abs_err": err, "bit_identical_to_k1": True,
            "extra_mem_bytes": k2_mem,
            "extra_mem_beside_output_bytes": k2_mem - state_bytes,
            "ms": ms, "per_pass_k1_ms": (turns[0] + turns[3]) / 2,
            "turns_k1_k2_k2_k1_ms": turns,
            "plain_ms": time_ms(lambda: fused.megawin_plain(
                x, group, num_qubits=n), reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "fraction_of_bound": b_ms / ms,
            "grid_ctas": sched["ctas"], "super_blocks": sched["super_blocks"],
            "window": sched["window"], "slots": sched["slots"],
            "tickets": sched["tickets"],
            "workspace_bytes": sched["workspace_bytes"]}


def run_plain(torch, fused, a, ops, n):
    """A plan through the kernels' plain versions on the card (the
    segswap and apply ops are plain PyTorch already)."""
    from quest_tpu_torch.ops import kernels

    for op in ops:
        if op[0] == "winfused":
            a = fused.window_pass_plain(a, op[2], op[3], op[6], num_qubits=n,
                                        k=op[1], apply_a=op[4],
                                        apply_b=op[5])
        elif op[0] == "megawin":
            a = fused.megawin_plain(a, op[1], num_qubits=n)
        elif op[0] == "fused":
            a = fused.cluster_stack_plain(a, op[1], op[2], num_qubits=n)
        elif op[0] == "swapfused":
            a = fused.swap_cluster_stack_plain(a, op[4], op[5], num_qubits=n,
                                               h=op[1], b=op[2], m=op[3])
        elif op[0] == "segswap":
            a = kernels.swap_bit_segments(a, num_qubits=n, a=op[1], b=op[2],
                                          m=op[3])
        elif op[0] == "apply":
            a = kernels.apply_matrix(a, op[2], num_qubits=n,
                                     targets=tuple(op[1]))
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


def mask_only_drain(torch, qt, fused, fusion, n):
    """A lone controlledPhaseShift(q, 1, 8, 0.3) on |+>^n under
    gateFusion: its drain plans one window pass that folds only the cross
    diagonal (a mask, neither side) and runs it through K1 (or K2); held
    within ``tolerance`` of the same gate applied eagerly."""
    from quest_tpu_torch.qureg import Qureg

    shadow = Qureg(n, qt.createQuESTEnv(device="cpu"), False)
    fusion.start_gate_fusion(shadow)
    qt.controlledPhaseShift(shadow, 1, 8, 0.3)
    program = fusion.plan_items(list(shadow._fusion.gates), n, device=DEVICE)
    passes = [op for kind, part in program if kind not in ("chan",
                                                          "chansweep")
              for o in part
              for op in (o[1] if o[0] == "megawin" else (o,))
              if op[0] == "winfused"]
    check(len(passes) == 1 and not passes[0][4] and not passes[0][5],
          f"the drain of one controlledPhaseShift plans {len(passes)} "
          "window passes, not one mask-only pass")
    env = qt.createQuESTEnv()
    fused.reset_launch_counts()
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    with qt.gateFusion(q):
        qt.controlledPhaseShift(q, 1, 8, 0.3)
    sync()
    launches = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
    check(launches["K1"] + launches["K2"] == 1, f"the mask-only drain "
          f"launched {launches}")
    e = qt.createQureg(n, env)
    qt.initPlusState(e)
    qt.controlledPhaseShift(e, 1, 8, 0.3)
    err = float((q.amps - e.amps).abs().max())
    tol = tolerance(e.amps)
    check(err <= tol, f"mask-only drain at {n} qubits: |err| {err} > {tol} "
          "against the eager route")
    qt.destroyQureg(q, env)
    qt.destroyQureg(e, env)
    return {"n": n, "launches": launches, "max_abs_err_vs_eager": err,
            "tolerance": tol}


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
        # a tiny first launch: the tracer may miss the first kernel of a
        # window (one QFT's first K8 launch went unseen without it)
        torch.ones(1, device=DEVICE).add_(1)
        sync()
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


# ---------------------------------------------------------------------------
# The QFT: K6-K9 (ladder layers), K10 (sigma swap), K1 at 2^30 amplitudes
# ---------------------------------------------------------------------------


def max_abs_diff(torch, a, b) -> float:
    """max |a - b| over two same-shape tensors, in 64 slices (a 2^30-
    amplitude difference would take another 8.6 GB at once)."""
    a, b = a.reshape(64, -1), b.reshape(64, -1)
    return max(float((a[i] - b[i]).abs().max()) for i in range(64))


def random_state(torch, n, seed, dtype=None):
    """A normalised random (2, 2^n) state made on the card from a seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((2, 1 << n), generator=gen, device=DEVICE,
                    dtype=dtype or torch.float32)
    return x.div_(torch.linalg.vector_norm(x))


@contextmanager
def plain_qft_kernels(fused, bigstate):
    """The QFT kernels' wrappers (K6-K10) replaced by their plain versions,
    on the card too, for the length of the block: the plain route.  K1 and
    K2 stay kernels (their plain versions sum in another order)."""
    def ladder(amps, *, num_qubits, target, conj=False):
        plain = (fused.qft_ladder_lo_plain if target < 14
                 else fused.qft_ladder_plain)
        return plain(amps, num_qubits=num_qubits, target=target, conj=conj)

    saved = (fused.apply_qft_multi_hi, fused.apply_qft_cluster_multi,
             fused.apply_qft_ladder_pallas, bigstate.apply_sigma_swap)
    fused.apply_qft_multi_hi = fused.qft_multi_hi_plain
    fused.apply_qft_cluster_multi = fused.qft_cluster_multi_plain
    fused.apply_qft_ladder_pallas = ladder
    bigstate.apply_sigma_swap = bigstate.sigma_swap_plain
    try:
        yield
    finally:
        (fused.apply_qft_multi_hi, fused.apply_qft_cluster_multi,
         fused.apply_qft_ladder_pallas, bigstate.apply_sigma_swap) = saved


def qft_launches(fused, bigstate) -> dict:
    return {k: fused.LAUNCHES[k] for k in ("K1", "K2", "K6", "K7", "K8",
                                           "K9")} | dict(bigstate.LAUNCHES)


def reset_qft_counts(fused, bigstate) -> None:
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()


def qft_k1_ops(torch, np, C, n):
    """The K1 passes of one n-qubit QFT on the card: the lane-layer fold
    (the seven lane layers with both low rev7 reversals) and the high
    groups' reversal passes, uploaded."""
    dt = np.float32
    gates = [C.Gate(tuple(range(qq + 1)), C._qft_layer_dense(qq, False, dt))
             for qq in range(6, -1, -1)]
    rev7 = C._rev_perm_mat(7, dt)
    gates += [C.Gate(tuple(range(7)), rev7),
              C.Gate(tuple(range(7, 14)), rev7)]
    ops = C.plan_circuit(gates, n, device=DEVICE)
    ops += C.bit_reversal_ops(n, [(0, n)], dt, skip_low_group=True,
                              device=DEVICE)
    return C.plan_to_device(ops, torch.float32, DEVICE)


def is_permutation_pass(op) -> bool:
    """A window pass whose used sides are 0/1 permutation matrices: its
    products are exact, so K1 equals its plain version bit for bit."""
    mats = [m for m, used in ((op[2], op[4]), (op[3], op[5])) if used]
    return all(bool(((m == 0) | (m == 1)).all()) and bool((m[0, 1] == 0)
               .all()) and bool((m[0, 0].sum(dim=1) == 1).all())
               for m in mats)


def phase_qft_parity(torch, np, fused, bigstate, C):
    n = N_PARITY
    x = random_state(torch, n, 2468)
    out = {"n": n, "k8_cases": [], "k9_cases": 0, "k6_targets": [],
           "k7_targets": [], "k10_cases": [], "max_abs_err": 0.0}

    def same(kernel, plain, label, state=x):
        y = kernel(state.clone())
        yp = plain(state)
        sync()
        check(torch.equal(y, yp), f"{label}: not bit-identical to its plain "
              "version")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((y - yp).abs().max()))

    for conj in (False, True):
        # placements: M = 1 (t_lo = 14), H = 1 (t_hi = n - 1), both, neither
        for t_hi, t_lo in ((14, 14), (19, 19), (15, 14), (19, 18), (16, 14),
                           (18, 16), (17, 14), (19, 16), (18, 14), (19, 15)):
            kw = dict(num_qubits=n, t_hi=t_hi, t_lo=t_lo, conj=conj)
            same(lambda a: fused.apply_qft_multi_hi(a, **kw),
                 lambda a: fused.qft_multi_hi_plain(a, **kw),
                 f"K8 t={t_hi}..{t_lo} conj={conj}")
            out["k8_cases"].append([t_hi, t_lo, conj])
        same(lambda a: fused.apply_qft_cluster_multi(a, num_qubits=n,
                                                     conj=conj),
             lambda a: fused.qft_cluster_multi_plain(a, num_qubits=n,
                                                     conj=conj),
             f"K9 conj={conj}")
        out["k9_cases"] += 1
        for t in range(7, n):
            plain = (fused.qft_ladder_lo_plain if t < 14
                     else fused.qft_ladder_plain)
            same(lambda a: fused.apply_qft_ladder_pallas(
                     a, num_qubits=n, target=t, conj=conj),
                 lambda a: plain(a, num_qubits=n, target=t, conj=conj),
                 f"{'K7' if t < 14 else 'K6'} t={t} conj={conj}")
            out["k7_targets" if t < 14 else "k6_targets"].append(t)
    for m, g in SIGMA_PARITY:
        y = x if m == n else random_state(torch, m, 1357)
        same(lambda a: bigstate.apply_sigma_swap(a, num_qubits=m,
                                                 group_bits=g),
             lambda a: bigstate.sigma_swap_plain(a, num_qubits=m,
                                                 group_bits=g),
             f"K10 n={m} g={g}", state=y)
        out["k10_cases"].append([m, g])
        del y
    torch.cuda.empty_cache()

    # K1 on each pass of the QFT's plan at the main path's size
    m = N_QFT
    x = random_state(torch, m, 97531)
    tol = tolerance(x)
    out["k1"] = []
    for op in qft_k1_ops(torch, np, C, m):
        if op[0] != "winfused":
            continue
        y = fused.apply_window_stack(x, op[2], op[3], op[6], num_qubits=m,
                                     k=op[1], apply_a=op[4], apply_b=op[5])
        yp = fused.window_pass_plain(x, op[2], op[3], op[6], num_qubits=m,
                                     k=op[1], apply_a=op[4], apply_b=op[5])
        sync()
        perm = is_permutation_pass(op)
        err = max_abs_diff(torch, y, yp)
        if perm:
            check(torch.equal(y, yp), f"K1 at {m} qubits, k={op[1]}: a "
                  "permutation pass is not bit-identical to its plain version")
        check(err <= tol, f"K1 at {m} qubits, k={op[1]}: |err| {err} > {tol}")
        out["k1"].append({"n": m, "k": op[1], "sides": [op[4], op[5]],
                          "permutation": perm, "bit_identical": perm,
                          "max_abs_err": err, "tolerance": tol})
        del y, yp
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return out


def qft_want(torch, np, C, n):
    """Launches of one n-qubit state-vector QFT by the multilayer route:
    K8 per chunk of 4 layers above 13, one K9, K1 per window pass of the
    fold and the reversal, K2 per megawin group, one K10."""
    ops = qft_k1_ops(torch, np, C, n)
    st = C.stats(ops)
    return {"K1": st["winfused"], "K2": st["megawin"], "K6": 0, "K7": 0,
            "K8": -(-(n - 14) // 4), "K9": 1, "K10": st["sigma_swap"]}


def phase_qft_main(torch, np, qt, C, fused, bigstate, circuits):
    n = N_QFT
    state_bytes = 2 * 4 << n
    out = {"n": n}
    qt.set_precision(1)
    want = qft_want(torch, np, C, n)
    check(want["K10"] == 1, f"the {n}-qubit plan has no sigma swap")

    # (a) the bench route: two QFTs from |0...0> (bench.py:238-258)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_qft_counts(fused, bigstate)
    t0 = time.perf_counter()
    a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
    a = C.fused_qft(a, n, 0, n)
    sync()
    per_qft = qft_launches(fused, bigstate)
    a = C.fused_qft(a, n, 0, n)
    amp0 = float(circuits.amp00_canonical(a))
    sync()
    wall = time.perf_counter() - t0
    launches = qft_launches(fused, bigstate)
    check(per_qft == want, f"launches per QFT {per_qft} != plan's {want}")
    check(launches == {k: 2 * v for k, v in want.items()},
          f"launches of two QFTs {launches}")
    check(a.shape == (2, 1 << (n - 14), 128, 128)
          and bool(torch.isfinite(a).all()), "bench route: bad state")
    check(abs(amp0 - 1.0) <= 1e-5, f"amp0 after two QFTs {amp0}")
    out["bench_route"] = {"amp0_after_two": amp0, "launches_per_qft": per_qft,
                          "launches": launches, "first_wall_s": wall,
                          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                          "state_bytes": state_bytes}
    del a
    torch.cuda.empty_cache()

    # (b) known answers: QFT|x> = sum_y e^{2 pi i x y / 2^n} |y> / 2^{n/2}
    rng = np.random.default_rng(QFT_SEED)
    ys = np.unique(np.concatenate([[0, (1 << n) - 1],
                                   rng.integers(0, 1 << n, N_QFT_KNOWN)]))
    known = []
    for x_idx in (0, 1, int(rng.integers(0, 1 << n)), (1 << n) - 1):
        a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
        a.view(2, -1)[0, 0] = 0.0
        a.view(2, -1)[0, x_idx] = 1.0
        a = C.fused_qft(a, n, 0, n).view(2, -1)
        got = a[:, torch.as_tensor(ys, device=DEVICE)].double().cpu().numpy()
        ph = 2 * np.pi * ((ys.astype(object) * x_idx) % (1 << n)).astype(
            np.float64) / float(1 << n)
        exact = np.exp(1j * ph) / np.sqrt(float(1 << n))
        err = float(np.abs(got[0] + 1j * got[1] - exact).max())
        tol = 1e-5 * float(np.abs(exact).max())
        check(err <= tol, f"QFT|{x_idx}> at {n} qubits: |err| {err} > {tol}")
        known.append({"x": x_idx, "samples": int(ys.size), "max_abs_err": err,
                      "tolerance": tol})
        del a
    out["known_answers"] = known
    torch.cuda.empty_cache()

    # (c) a random state through the API against torch.fft (a check and a
    # yardstick only; the port never calls it)
    env = qt.createQuESTEnv()
    q = qt.createQureg(n, env)
    q.amps = random_state(torch, n, QFT_SEED)
    z = torch.fft.ifft(torch.complex(q.amps[0], q.amps[1]), norm="ortho")
    fft = torch.stack([z.real, z.imag])
    del z
    torch.cuda.empty_cache()
    reset_qft_counts(fused, bigstate)
    t0 = time.perf_counter()
    qt.applyFullQFT(q)
    sync()
    api_wall = time.perf_counter() - t0
    api_launches = qft_launches(fused, bigstate)
    check(api_launches == want, f"applyFullQFT launches {api_launches}")
    err = max_abs_diff(torch, q.amps, fft)
    tol = 1e-5 * float(fft.abs().max())
    check(err <= tol, f"applyFullQFT at {n} qubits vs torch.fft: |err| {err} "
          f"> {tol}")
    total = qt.calcTotalProb(q)
    check(abs(total - 1.0) <= 1e-4, f"calcTotalProb after the QFT {total}")
    out["api_route"] = {"launches": api_launches, "first_wall_s": api_wall,
                        "max_abs_err_vs_fft": err, "tolerance": tol,
                        "calc_total_prob": total}
    del q, fft
    torch.cuda.empty_cache()

    # (d) the whole route against the same route through the plain versions
    y = C.fused_qft(random_state(torch, n, QFT_SEED + 1).view(
        2, -1, 128, 128), n, 0, n)
    with plain_qft_kernels(fused, bigstate):
        reset_qft_counts(fused, bigstate)
        yp = C.fused_qft(random_state(torch, n, QFT_SEED + 1).view(
            2, -1, 128, 128), n, 0, n)
        plain_launches = qft_launches(fused, bigstate)
    sync()
    check(torch.equal(y, yp), f"the {n}-qubit QFT route is not the plain "
          "route's bit for bit")
    check(all(plain_launches[k] == 0 for k in ("K8", "K9", "K10")),
          f"the plain route launched {plain_launches}")
    out["plain_route"] = {"n": n, "bit_identical": True,
                          "max_abs_err": max_abs_diff(torch, y, yp),
                          "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del y, yp
    torch.cuda.empty_cache()

    # (e) float32 against float64 at a size whose complex128 FFT is small
    m = N_QFT_F64
    psi = random_state(torch, m, QFT_SEED + 2, dtype=torch.float64)
    a = C.fused_qft(psi.float().view(2, -1, 128, 128), m, 0, m)
    z = torch.fft.ifft(torch.complex(psi[0], psi[1]), norm="ortho")
    ref = torch.stack([z.real, z.imag])
    err = float((a.reshape(2, -1).double() - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    check(err <= tol, f"QFT at {m} qubits, f32 vs f64 FFT: |err| {err}")
    out["f64_check"] = {"n": m, "max_abs_err": err, "tolerance": tol}
    del psi, a, z, ref
    torch.cuda.empty_cache()

    # (f) a 15-qubit density register (2^30 amplitudes): the per-layer
    # route, K6 at t = 14 and K7 at t = 13..7 on its ket half
    m = N_QFT_RHO

    def rho_qft(plain: bool):
        pure = qt.createQureg(m, env)
        pure.amps = random_state(torch, m, QFT_SEED + 3)
        r = qt.createDensityQureg(m, env)
        qt.initPureState(r, pure)
        reset_qft_counts(fused, bigstate)
        if plain:
            with plain_qft_kernels(fused, bigstate):
                qt.applyFullQFT(r)
        else:
            qt.applyFullQFT(r)
        sync()
        return r, qft_launches(fused, bigstate)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, rho_launches = rho_qft(False)
    rho_wall = time.perf_counter() - t0
    check(rho_launches["K6"] == 1 and rho_launches["K7"] == 7
          and rho_launches["K8"] == rho_launches["K9"] == 0,
          f"density QFT launches {rho_launches}")
    total = qt.calcTotalProb(r)
    check(abs(total - 1.0) <= 1e-4, f"density QFT: calcTotalProb {total}")
    rho_peak = torch.cuda.max_memory_allocated()
    kept = r.amps
    del r
    rp, _ = rho_qft(True)
    check(torch.equal(kept, rp.amps), "the density QFT is not its plain "
          "route's bit for bit")
    out["density"] = {"n": m, "state_qubits": 2 * m,
                      "launches": rho_launches, "calc_total_prob": total,
                      "bit_identical_to_plain": True, "first_wall_s": rho_wall,
                      "peak_mem_bytes": rho_peak}
    del kept, rp
    torch.cuda.empty_cache()
    return out, launches, rho_launches


def qft_bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def phase_qft_timing(torch, np, qt, C, fused, bigstate):
    n = N_QFT
    x = random_state(torch, n, QFT_SEED + 4)
    num_amps = 1 << n
    state_bytes = x.numel() * x.element_size()
    out = {"device": torch.cuda.get_device_name(0), "n": n,
           "state_bytes_f32": state_bytes}

    def timed(kernel, plain, nbytes, flops, library=None):
        b, by = qft_bound(nbytes, flops)
        return {"ms": time_ms(kernel),
                "plain_ms": time_ms(plain, reps=3, warmup=1),
                "library_ms": (None if library is None
                               else time_ms(library, reps=3, warmup=1)),
                "bound_ms": b, "bound_by": by}

    # K8: one figure per chunk of the 30-qubit QFT; per pair and layer 26
    # flops (the block factor, the phase, the pair combine)
    out["k8"] = []
    t = n - 1
    while t >= 14:
        t_lo = max(14, t - 3)
        kw = dict(num_qubits=n, t_hi=t, t_lo=t_lo)
        k = t - t_lo + 1
        tab_bytes = 4 * (k * 2 * 128 * 128)
        r = timed(lambda: fused.apply_qft_multi_hi(x, **kw),
                  lambda: fused.qft_multi_hi_plain(x, **kw),
                  2 * state_bytes + tab_bytes, 13.0 * k * num_amps)
        out["k8"].append({"t_hi": t, "t_lo": t_lo,
                          "H": 1 << (n - 1 - t), "M": 1 << (t_lo - 14), **r})
        t = t_lo - 1
    # K9: seven layers of 14 flops a pair
    out["k9"] = timed(lambda: fused.apply_qft_cluster_multi(x, num_qubits=n),
                      lambda: fused.qft_cluster_multi_plain(x, num_qubits=n),
                      2 * state_bytes + 4 * 7 * 2 * 128 * 128,
                      7 * 7.0 * num_amps)
    # K6 and K7 at the density register's shapes (2^30 amplitudes)
    out["k6"] = {"t": 14, **timed(
        lambda: fused.apply_qft_ladder_pallas(x, num_qubits=n, target=14),
        lambda: fused.qft_ladder_plain(x, num_qubits=n, target=14),
        2 * state_bytes + 4 * 2 * 128 * 128, 13.0 * num_amps)}
    out["k7"] = [{"t": tt, **timed(
        lambda tt=tt: fused.apply_qft_ladder_pallas(x, num_qubits=n,
                                                    target=tt),
        lambda tt=tt: fused.qft_ladder_lo_plain(x, num_qubits=n, target=tt),
        2 * state_bytes + (4 * 2 * 128 << (tt - 7)), 7.0 * num_amps)}
        for tt in (13, 7)]
    # K10, against the same permutation as one out-of-place copy
    g = min(7, n // 4)
    G = 1 << g
    view = x.view(2, G, G, 1 << (n - 4 * g), G, G)
    out["k10"] = timed(
        lambda: bigstate.apply_sigma_swap(x, num_qubits=n, group_bits=g),
        lambda: bigstate.sigma_swap_plain(x, num_qubits=n, group_bits=g),
        2 * state_bytes, 0.0,
        library=lambda: view.permute(0, 5, 4, 3, 2, 1).contiguous())
    torch.cuda.empty_cache()
    # K1 on the QFT's two pass kinds at 2^30 amplitudes
    ops = [op for op in qft_k1_ops(torch, np, C, n) if op[0] == "winfused"]
    out["k1"] = []
    for op in (ops[0], ops[-1]):
        b, by = bound_ms([op], state_bytes, num_amps, "float32")
        hi, mid = 1 << (n - op[1] - 7), 1 << (op[1] - 7)
        ac = torch.complex(op[2][0, 0], op[2][0, 1])
        bc = torch.complex(op[3][0, 0], op[3][0, 1])

        def lib(op=op, ac=ac, bc=bc, hi=hi, mid=mid):
            xc = torch.complex(x[0], x[1]).view(hi, 128, mid, 128)
            if op[4] and op[5]:
                return torch.einsum("qw,hwml,pl->hqmp", bc, xc, ac)
            return torch.einsum("qw,hwml->hqml", bc, xc)

        out["k1"].append({
            "k": op[1], "sides": [op[4], op[5]],
            "ms": time_ms(lambda op=op: fused.apply_window_stack(
                x, op[2], op[3], None, num_qubits=n, k=op[1],
                apply_a=op[4], apply_b=op[5])),
            "plain_ms": time_ms(lambda op=op: fused.window_pass_plain(
                x, op[2], op[3], None, num_qubits=n, k=op[1],
                apply_a=op[4], apply_b=op[5]), reps=3, warmup=1),
            "library_ms": time_ms(lib, reps=3, warmup=1),
            "bound_ms": b, "bound_by": by})
        torch.cuda.empty_cache()
    # the whole QFT's least time: the sum of its launches' bounds
    out["qft_bound_ms"] = (sum(c["bound_ms"] for c in out["k8"])
                           + out["k9"]["bound_ms"] + out["k10"]["bound_ms"]
                           + sum(bound_ms([op], state_bytes, num_amps,
                                          "float32")[0] for op in ops))
    # the yardstick: one complex64 FFT of 2^30 points, without and with the
    # SoA <-> complex conversions the port's layout would need
    z = torch.complex(x[0], x[1])
    out["torch_fft_ms"] = {
        "complex_in_complex_out": time_ms(
            lambda: torch.fft.ifft(z, norm="ortho"), reps=3, warmup=1)}
    del z
    torch.cuda.empty_cache()

    def fft_soa():
        w = torch.fft.ifft(torch.complex(x[0], x[1]), norm="ortho")
        return torch.stack([w.real, w.imag])

    out["torch_fft_ms"]["soa_in_soa_out"] = time_ms(fft_soa, reps=3,
                                                    warmup=1)
    torch.cuda.empty_cache()

    # wall time per QFT by both routes, median of 3, and the busy share of
    # one call of each from torch.profiler
    a = x.view(2, -1, 128, 128)
    env = qt.createQuESTEnv()
    q = qt.createQureg(n, env)
    q.amps = random_state(torch, n, QFT_SEED + 5)
    walls = {}
    for label, fn in (("fused_qft", lambda: C.fused_qft(a, n, 0, n)),
                      ("apply_full_qft", lambda: qt.applyFullQFT(q))):
        samples = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            samples.append(time.perf_counter() - t0)
            if res is not None:
                a = res
        walls[label] = statistics.median(samples)
        dev, seen = device_busy(torch, fn, "qft_hi_kernel")
        check(seen in (None, 4), f"the profiler saw {seen} K8 launches in "
              "one QFT, not 4")
        out[f"{label}_wall_ms"] = walls[label] * 1e3
        out[f"{label}_busy"] = {
            "device_ms": dev, "k8_launches_seen": seen,
            "device_busy_share": (None if dev is None
                                  else dev / (walls[label] * 1e3))}
    del q, a, x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Density-matrix noise: K5 (the fused pair-channel sweep), bench.py config 4
# ---------------------------------------------------------------------------


def channel_programs(nn):
    """K5's program shapes at nn >= 16 bits, (kind, ket bit, bra bit)
    triples: lane and sublane ket bits, in-block and grid channels in one
    sweep (rank 7: two launches), the top chunk, the two kinds mixed, a
    channel twice in a row, and a density layer.  tests/
    test_torch_channels.py holds the plain version to the reference on
    the same shapes."""
    n = nn // 2
    return {
        "lane": (("depol", 0, 14), ("damping", 3, 15), ("depol", 6, 12)),
        "sublane": (("damping", 7, 14), ("depol", 10, 15),
                    ("depol", 13, 11)),
        "inblock_grid": (("depol", 1, 9), ("damping", 2, 10),
                         ("depol", 3, 11), ("damping", 4, 12),
                         ("depol", 5, 14), ("damping", 6, 15),
                         ("depol", 0, 13)),
        "top_chunk": (("depol", 2, nn - 1), ("damping", 9, nn - 2),
                      ("depol", 12, nn - 3)),
        "mixed": tuple(("depol" if i % 2 else "damping", t, t + n)
                       for i, t in enumerate(range(n - 6, n))),
        "repeat": (("depol", 4, 15), ("depol", 4, 15), ("damping", 5, 14),
                   ("damping", 5, 14)),
        "density_layer": tuple(("depol", t, t + n) for t in range(min(n, 14))),
    }


def k5_launches(fused, program, nn) -> int:
    """K5 launches of one sweep run: one per launch group of each sweep."""
    return sum(len(fused.sweep_launch_groups(entries))
               for _b0, _k, entries in fused.sweep_schedule(program, nn))


def layer_program(n):
    """The channel run of one config-4 layer: mixDepolarising on every
    qubit of an n-qubit density register."""
    return tuple(("depol", t, t + n) for t in range(n))


def phase_channel_parity(torch, np, fused):
    out = {"cases": [], "max_abs_err": 0.0}

    def same(nn, program, label, seed):
        probs = [0.02 + 0.03 * i for i in range(len(program))]
        x = random_state(torch, nn, seed)
        before = fused.LAUNCHES["K5"]
        y = fused.apply_pair_channel_sweep(x.clone(), program, probs,
                                           num_bits=nn)
        launched = fused.LAUNCHES["K5"] - before
        yp = fused.pair_channel_sweep_plain(x, program, probs, num_bits=nn)
        sync()
        check(torch.equal(y, yp), f"K5 {label} at 2^{nn}: not bit-identical "
              "to its plain version")
        want = k5_launches(fused, program, nn)
        check(launched == want, f"K5 {label}: {launched} launches, not "
              f"{want}")
        err = max_abs_diff(torch, y, yp) if nn > 24 else float(
            (y - yp).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["cases"].append({"bits": nn, "program": label,
                             "channels": len(program), "launches": launched,
                             "max_abs_err": err})
        del x, y, yp
        torch.cuda.empty_cache()

    for i, (label, program) in enumerate(
            channel_programs(N_CHAN_PARITY).items()):
        same(N_CHAN_PARITY, program, label, 4000 + i)
    nn = 2 * N_NOISE
    same(nn, layer_program(N_NOISE), "config4_layer", 4100)
    return out


@contextmanager
def plain_channel_kernel(fused):
    """K5's wrapper replaced by its plain version, on the card too, for the
    length of the block: the plain route of a noise drain."""
    saved = fused.apply_pair_channel_sweep
    fused.apply_pair_channel_sweep = fused.pair_channel_sweep_plain
    try:
        yield
    finally:
        fused.apply_pair_channel_sweep = saved


def noise_run(qt, noise, n, kops, *, layers=1, fused=True, kind="config4",
              dtype=None, gates=None):
    """A density register from |+><+|^n through ``layers`` noise layers
    (config 4's, or mixDepolarising / mixDamping on every qubit alone),
    under gateFusion (one drain) or eagerly, after ``gates(rho)`` in the
    same drain; returns (register, |+>^n register)."""
    from contextlib import nullcontext

    env = qt.createQuESTEnv()
    qt.set_precision(2 if dtype == "float64" else 1)
    try:
        rho = qt.createDensityQureg(n, env)
        psi = qt.createQureg(n, env)
    finally:
        qt.set_precision(1)
    qt.initPlusState(rho)
    qt.initPlusState(psi)
    with (qt.gateFusion(rho) if fused else nullcontext()):
        if gates is not None:
            gates(rho)
        for _ in range(layers):
            if kind == "config4":
                noise.noise_layer(qt, rho, n, kops, prob=NOISE_P)
            else:
                for q in range(n):
                    (qt.mixDepolarising if kind == "depol"
                     else qt.mixDamping)(rho, q, NOISE_P)
    sync()
    return rho, psi


def noise_known(n, kind):
    """<+|^n rho |+>^n after one depolarise-only or damping-only layer on
    |+><+|^n: each qubit keeps 1 - 2p/3, or (1 + sqrt(1-p)) / 2."""
    import math

    per = (1 - 2 * NOISE_P / 3 if kind == "depol"
           else (1 + math.sqrt(1 - NOISE_P)) / 2)
    return per ** n


def phase_noise_main(torch, np, qt, fused, fusion, noise, circuits):
    n = N_NOISE
    nn = 2 * n
    kops = noise.bench_kraus_ops(NOISE_SEED)
    per_layer = k5_launches(fused, layer_program(n), nn)
    out = {"n": n, "state_bits": nn, "p": NOISE_P,
           "k5_launches_per_layer": per_layer,
           "sweeps_per_layer": len(fused.sweep_schedule(layer_program(n),
                                                        nn))}
    # the plan of one layer: a chansweep part and exactly one apply op for
    # the Kraus map, on the card as on the CPU
    from quest_tpu_torch.qureg import Qureg

    shadow = Qureg(n, qt.createQuESTEnv(device="cpu"), True)
    fusion.start_gate_fusion(shadow)
    for _ in range(NOISE_LAYERS):
        noise.noise_layer(qt, shadow, n, kops, prob=NOISE_P)
    items = list(shadow._fusion.gates)
    program = fusion.plan_items(items, nn, device=DEVICE, sweep_ok=True)
    pst = fusion.program_stats(program)
    check(pst.get("chansweep") == NOISE_LAYERS and pst["apply"] == NOISE_LAYERS
          and pst["total_passes"] == NOISE_LAYERS,
          f"the {NOISE_LAYERS}-layer plan is {pst}")
    out["plan"] = pst

    # (1)-(2) one layer, then four in one drain, counting K5's launches
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    rho, psi = noise_run(qt, noise, n, kops)
    f1 = qt.calcFidelity(rho, psi)
    sync()
    wall1 = time.perf_counter() - t0
    check(fused.LAUNCHES["K5"] == per_layer,
          f"one layer launched K5 {fused.LAUNCHES['K5']} times, not "
          f"{per_layer}")
    del rho
    fused.reset_launch_counts()
    rho, psi = noise_run(qt, noise, n, kops, layers=NOISE_LAYERS)
    f4 = qt.calcFidelity(rho, psi)
    launches = dict(fused.LAUNCHES)
    check(launches["K5"] == NOISE_LAYERS * per_layer,
          f"{NOISE_LAYERS} layers launched K5 {launches['K5']} times")
    total = qt.calcTotalProb(rho)
    check(abs(total - 1.0) <= 1e-4, f"noise: calcTotalProb {total}")
    check(bool(torch.isfinite(rho.amps).all()), "noise: non-finite state")
    # (3) the same drain through the plain version of K5, on the card
    with plain_channel_kernel(fused):
        rp, _ = noise_run(qt, noise, n, kops, layers=NOISE_LAYERS)
    check(torch.equal(rho.amps, rp.amps), f"the {NOISE_LAYERS}-layer drain "
          "is not its plain route's bit for bit")
    del rp
    torch.cuda.empty_cache()
    # (4) against float64 (per channel: the sweep is float32's)
    r64, p64 = noise_run(qt, noise, n, kops, layers=NOISE_LAYERS,
                         dtype="float64")
    f64 = qt.calcFidelity(r64, p64)
    check(abs(f4 - f64) <= 1e-5, f"fidelity {f4} vs float64 {f64}")
    del r64, p64
    torch.cuda.empty_cache()
    # (5) the eager route
    re_, pe = noise_run(qt, noise, n, kops, layers=NOISE_LAYERS, fused=False)
    fe = qt.calcFidelity(re_, pe)
    check(abs(f4 - fe) <= 1e-5, f"fidelity {f4} vs eager {fe}")
    del re_, pe
    torch.cuda.empty_cache()
    out.update({"fidelity_one_layer": f1, "first_wall_s_one_layer": wall1,
                "fidelity": f4, "fidelity_f64": f64, "fidelity_eager": fe,
                "calc_total_prob": total, "launches": launches,
                "bit_identical_to_plain": True})
    del rho, psi
    torch.cuda.empty_cache()
    # (6) known answers
    known = {}
    for kind in ("depol", "damping"):
        r, p = noise_run(qt, noise, n, kops, kind=kind)
        f, want = qt.calcFidelity(r, p), noise_known(n, kind)
        check(abs(f - want) <= 1e-5 * want, f"{kind} layer: fidelity {f} vs "
              f"{want}")
        known[kind] = {"fidelity": f, "exact": want,
                       "rel_err": abs(f - want) / want}
        del r, p
        torch.cuda.empty_cache()
    out["known_answers"] = known
    # (7) one drain of gates and noise: a depth-2 config-2 layer (ket and
    # bra twins) then a noise layer, against its eager route
    us = circuits.bench_unitaries(n, 2, seed=SEED)

    def gates(r):
        apply_bench_gates(qt, r, us, n)

    fused.reset_launch_counts()
    rg, pg = noise_run(qt, noise, n, kops, gates=gates)
    mixed = dict(fused.LAUNCHES)
    check(mixed["K1"] + mixed["K2"] > 0 and mixed["K5"] == per_layer,
          f"the gates-and-noise drain launched {mixed}")
    reg, _ = noise_run(qt, noise, n, kops, gates=gates, fused=False)
    err = max_abs_diff(torch, rg.amps, reg.amps)
    tol = 1e-5 * float(reg.amps.abs().max())
    check(err <= tol, f"gates-and-noise drain vs eager: |err| {err} > {tol}")
    out["gates_and_noise"] = {"depth": 2, "launches": mixed,
                              "max_abs_err_vs_eager": err, "tolerance": tol,
                              "fidelity": qt.calcFidelity(rg, pg)}
    del rg, pg, reg
    torch.cuda.empty_cache()

    # 15 qubits (2^30 amplitudes): qubit 14's ket bit is 14, so the run
    # goes channel by channel (density.apply_pair_channel), no K5
    m = N_NOISE_BIG
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    rb, pb = noise_run(qt, noise, m, kops)
    fb = qt.calcFidelity(rb, pb)
    wall_b = time.perf_counter() - t0
    check(fused.LAUNCHES["K5"] == 0, f"K5 launched {fused.LAUNCHES['K5']} "
          f"times at {m} qubits")
    tb = qt.calcTotalProb(rb)
    check(abs(tb - 1.0) <= 1e-4, f"{m} qubits: calcTotalProb {tb}")
    del rb, pb
    torch.cuda.empty_cache()
    rb, pb = noise_run(qt, noise, m, kops, fused=False)
    fbe = qt.calcFidelity(rb, pb)
    check(abs(fb - fbe) <= 1e-5, f"{m} qubits: fidelity {fb} vs eager {fbe}")
    del rb, pb
    torch.cuda.empty_cache()
    known_b = {}
    for kind in ("depol", "damping"):
        r, p = noise_run(qt, noise, m, kops, kind=kind)
        f, want = qt.calcFidelity(r, p), noise_known(m, kind)
        check(abs(f - want) <= 1e-5 * want, f"{m} qubits, {kind} layer: "
              f"fidelity {f} vs {want}")
        known_b[kind] = {"fidelity": f, "exact": want,
                         "rel_err": abs(f - want) / want}
        del r, p
        torch.cuda.empty_cache()
    out["big"] = {"n": m, "state_bits": 2 * m, "k5_launches": 0,
                  "fidelity": fb, "fidelity_eager": fbe,
                  "calc_total_prob": tb, "first_wall_s": wall_b,
                  "known_answers": known_b,
                  "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return out, launches


def phase_noise_timing(torch, np, qt, fused, noise, kernels, density):
    n = N_NOISE
    nn = 2 * n
    kops = noise.bench_kraus_ops(NOISE_SEED)
    x = random_state(torch, nn, 4200)
    state_bytes = x.numel() * x.element_size()
    out = {"device": torch.cuda.get_device_name(0), "n": n,
           "state_bytes_f32": state_bytes}
    # K5: each sweep of a config-4 layer, one launch each; the bound is one
    # read and one write of the state (a few flops an element and channel:
    # 6 per complex element and channel)
    program = layer_program(n)
    probs = [NOISE_P] * n
    sweeps = []
    for b0, k, entries in fused.sweep_schedule(program, nn):
        sub = tuple(program[e[3]] for e in entries)
        sp = [NOISE_P] * len(sub)
        t_bytes = 2 * state_bytes / HBM_BYTES_PER_S
        t_ops = 6.0 * len(sub) * (1 << nn) / PEAK_FLOPS["float32"]
        sweeps.append({
            "b0": b0, "k": k, "channels": len(sub),
            "launches": k5_launches(fused, sub, nn),
            "ms": time_ms(lambda sub=sub, sp=sp: fused.apply_pair_channel_sweep(
                x, sub, sp, num_bits=nn)),
            "plain_ms": time_ms(lambda sub=sub, sp=sp:
                                fused.pair_channel_sweep_plain(
                                    x, sub, sp, num_bits=nn),
                                reps=3, warmup=1),
            "library_ms": None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations"})
    out["k5_sweeps"] = sweeps
    out["k5_layer_ms"] = time_ms(lambda: fused.apply_pair_channel_sweep(
        x, program, probs, num_bits=nn))
    torch.cuda.empty_cache()
    # the Kraus map's apply op (a 4-qubit superoperator on bits 0, 1, n,
    # n + 1 through kernels.apply_matrix), and the per-channel form
    sup = density.superoperator_from_kraus(kops)
    from quest_tpu_torch.ops import cplx
    mat = torch.as_tensor(cplx.soa(sup), dtype=torch.float32, device=DEVICE)
    out["apply_op_ms"] = time_ms(lambda: kernels.apply_matrix(
        x, mat, num_qubits=nn, targets=(0, 1, n, n + 1)), reps=3, warmup=1)
    out["per_channel_ms"] = time_ms(lambda: density.apply_pair_channel(
        x, "depol", NOISE_P, nn=nn, t=0, b=n), reps=3, warmup=1)
    del x
    torch.cuda.empty_cache()

    # wall per layer (median of 3) and the device busy share of one layer
    def layer(m, fused_route):
        env = qt.createQuESTEnv()
        rho = qt.createDensityQureg(m, env)
        qt.initPlusState(rho)
        sync()

        def call():
            if fused_route:
                with qt.gateFusion(rho):
                    noise.noise_layer(qt, rho, m, kops, prob=NOISE_P)
            else:
                noise.noise_layer(qt, rho, m, kops, prob=NOISE_P)

        samples = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            samples.append(time.perf_counter() - t0)
        wall = statistics.median(samples)
        dev, seen = device_busy(torch, call, "chan_sweep_kernel")
        want = (k5_launches(fused, layer_program(m), 2 * m)
                if fused_route and m < 15 else 0)
        check(seen in (None, want), f"the profiler saw {seen} K5 launches "
              f"in one layer at {m} qubits, not {want}")
        del rho
        torch.cuda.empty_cache()
        return {"n": m, "wall_ms": wall * 1e3, "device_ms": dev,
                "k5_launches_seen": seen,
                "device_busy_share": None if dev is None
                else dev / (wall * 1e3)}

    out["layer_fused"] = layer(n, True)
    out["layer_eager"] = layer(n, False)
    out["layer_fused_big"] = layer(N_NOISE_BIG, True)
    return out


# ---------------------------------------------------------------------------
# The paged planner: K11 (cluster pass) and K12 (segment swap + cluster)
# ---------------------------------------------------------------------------


def paged_sides(torch, rng, rank, dtype):
    """(A, B): (R, 2, 128, 128) unitary side stacks scaled by 1/rank, on
    the card."""
    op = random_pass(rng, 7, rank, "AB", False)
    return tuple(torch.as_tensor(m, dtype=dtype, device=DEVICE)
                 for m in op[2:4])


def phase_paged_parity(torch, np, fused, C):
    n = N_PARITY
    rng = np.random.default_rng(4321)
    out = {"n": n, "k11_cases": 0, "k12_cases": 0, "k11_max_abs_err": {},
           "k12_max_abs_err": {}}
    for dtype in (torch.float32, torch.float64):
        x = rng.standard_normal((2, 1 << n))
        x /= np.sqrt((x ** 2).sum())
        x = torch.as_tensor(x, dtype=dtype, device=DEVICE)
        tol = tolerance(x)
        name = str(dtype).split(".")[-1]
        w11 = w12 = 0.0
        for rank in (1, 4):
            a, b = paged_sides(torch, rng, rank, dtype)
            y = fused.apply_cluster_stack(x, a, b, num_qubits=n)
            y1 = fused.apply_window_stack(x, a, b, None, num_qubits=n, k=7)
            sync()
            check(torch.equal(y, y1), f"K11 {name} R={rank}: not "
                  "bit-identical to K1 at k = 7")
            err = float((y - fused.cluster_stack_plain(
                x, a, b, num_qubits=n)).abs().max())
            check(err <= tol, f"K11 {name} R={rank}: |err| {err} > {tol}")
            w11 = max(w11, err)
            out["k11_cases"] += 1
            for h, bq, m in PAGED_SWAPS:
                y = fused.apply_swap_cluster_stack(x, a, b, num_qubits=n, h=h,
                                                   b=bq, m=m)
                ys = fused.apply_cluster_stack(
                    C.execute_plan(x, [("segswap", h, bq, m)], n), a, b,
                    num_qubits=n)
                sync()
                check(torch.equal(y, ys), f"K12 {name} R={rank} "
                      f"(h, b, m)={(h, bq, m)}: not bit-identical to segswap "
                      "then K11")
                err = float((y - fused.swap_cluster_stack_plain(
                    x, a, b, num_qubits=n, h=h, b=bq, m=m)).abs().max())
                check(err <= tol, f"K12 {name} R={rank} (h, b, m)="
                      f"{(h, bq, m)}: |err| {err} > {tol}")
                w12 = max(w12, err)
                out["k12_cases"] += 1
        out["k11_max_abs_err"][name] = w11
        out["k12_max_abs_err"][name] = w12
    out["k11_bit_identical_to_k1"] = True
    out["k12_bit_identical_to_segswap_k11"] = True
    return out


@contextmanager
def planner_env(name: str):
    """QT_PLANNER set to ``name`` for the block, restored after it."""
    prev = os.environ.get("QT_PLANNER")
    os.environ["QT_PLANNER"] = name
    try:
        yield
    finally:
        if prev is None:
            del os.environ["QT_PLANNER"]
        else:
            os.environ["QT_PLANNER"] = prev


def paged_counts(fused, route: str) -> dict:
    """K11's and K12's launches since the last reset; no other kernel of
    ops/fused.py may have launched."""
    others = {k: v for k, v in fused.LAUNCHES.items()
              if v and k not in ("K11", "K12")}
    check(not others, f"the paged {route} route launched {others}")
    return {k: fused.LAUNCHES[k] for k in ("K11", "K12")}


def unfuse_swaps(ops):
    """The plan with every ("swapfused", h, b, m, A, B) op split into its
    ("segswap", h, b, m) and ("fused", A, B): K12's work by segswap + K11."""
    out = []
    for op in ops:
        if op[0] == "swapfused":
            out += [("segswap", *op[1:4]), ("fused", *op[4:])]
        else:
            out.append(op)
    return out


def state_err(torch, psi, ref) -> float:
    """max |psi - ref| over max |ref|, on the card."""
    ref = ref.to(psi.device).reshape(psi.shape)
    return float((psi - ref).abs().max() / ref.abs().max())


def phase_paged_main(torch, qt, C, fused, fusion, circuits, p_windowed,
                     psi_windowed):
    """Config 2 at N_MAIN qubits through the paged planner, by the bench
    route and the API route; both final states are held against the
    windowed bench route's ``psi_windowed`` (on the host) and the bench
    route's bit for bit against the plan with its swaps unfused.  Returns
    (phase line, bench ops on the card, the API program, the
    unitaries)."""
    n = N_MAIN
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    gates = circuits.bench_gate_list(n, DEPTH, us)
    t0 = time.perf_counter()
    plan = C.plan_circuit(gates, n, planner="paged")
    plan_s = time.perf_counter() - t0
    pst = C.stats(plan)
    ops = C.plan_to_device(plan, torch.float32, DEVICE)
    items = capture_items(qt, us, n)
    env = qt.createQuESTEnv()
    with planner_env("paged"):
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
        bench_counts = paged_counts(fused, "bench")
        check(a.shape == (2, 1 << (n - 14), 128, 128)
              and bool(torch.isfinite(a).all()), "paged bench route: bad "
              "state")

        fused.reset_launch_counts()
        t0 = time.perf_counter()
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        p_api = qt.calcProbOfOutcome(q, n - 1, 0)
        total = qt.calcTotalProb(q)
        sync()
        api_wall = time.perf_counter() - t0
        api_counts = paged_counts(fused, "API")
        check(q.amps.shape == (2, 1 << n)
              and bool(torch.isfinite(q.amps).all()),
              "paged API route: bad state")
        api_vs_bench = state_err(torch, q.amps, a)
        qt.destroyQureg(q, env)
    # the whole final state: every K12 pass against segswap + K11 bit for
    # bit, and both routes against the windowed route
    unfused = C.execute_plan_chained(
        circuits.zero_state_canonical(n, torch.float32, DEVICE),
        unfuse_swaps(ops), n)
    check(torch.equal(a, unfused), "paged bench route: not bit-identical "
          "to its plan with every swapfused op run as segswap then K11")
    del unfused
    bench_vs_windowed = state_err(torch, a, psi_windowed)
    del a
    check(bench_vs_windowed <= 1e-5, f"paged bench route's state vs the "
          f"windowed route's: max|diff| / max|psi| {bench_vs_windowed}")
    check(api_vs_bench <= 1e-5, f"paged API route's state vs the paged "
          f"bench route's: max|diff| / max|psi| {api_vs_bench}")
    want_bench = {"K11": pst["fused"], "K12": pst["swapfused"]}
    want_api = {"K11": ast.get("fused", 0), "K12": ast.get("swapfused", 0)}
    check(bench_counts == want_bench, f"paged bench route launched "
          f"{bench_counts}, its plan holds {want_bench}")
    check(api_counts == want_api, f"paged API route launched {api_counts}, "
          f"its program holds {want_api}")
    check(min(want_bench.values()) > 0, f"K11 or K12 never launched on "
          f"the paged bench route: {bench_counts}")
    a64 = circuits.zero_state_canonical(n, torch.float64, DEVICE)
    a64 = run_plain(torch, fused, a64,
                    C.plan_to_device(plan, torch.float64, DEVICE), n)
    p_ref = float(circuits.prob_top_zero_canonical(a64))
    del a64
    sync()
    for label, p in (("bench", p_bench), ("API", p_api)):
        check(abs(p - p_windowed) <= 1e-5, f"paged {label} route "
              f"P(top=0) {p} vs the windowed route's {p_windowed}")
        check(abs(p - p_ref) <= 1e-5, f"paged {label} route P(top=0) {p} "
              f"vs the f64 plain route's {p_ref}")
    check(abs(total - 1.0) <= 1e-4, f"paged API route calcTotalProb {total}")
    line = {"n": n, "depth": DEPTH, "gates": len(gates),
            "bench_plan": {k: v for k, v in pst.items() if v},
            "bench_plan_seconds": plan_s,
            "bench_plan_ranks": {
                "fused": sorted(int(op[1].shape[0]) for op in ops
                                if op[0] == "fused"),
                "swapfused": sorted((int(op[4].shape[0]), op[3])
                                    for op in ops if op[0] == "swapfused"),
                "segswap_m": sorted(op[3] for op in ops
                                    if op[0] == "segswap")},
            "api_program": {k: v for k, v in ast.items() if v},
            "api_plan_seconds": api_plan_s, "api_items": len(items),
            "p_top_zero_bench": p_bench, "p_top_zero_api": p_api,
            "p_top_zero_windowed": p_windowed,
            "p_top_zero_f64_plain": p_ref, "calc_total_prob": total,
            "state_rel_err_bench_vs_windowed": bench_vs_windowed,
            "state_rel_err_api_vs_bench": api_vs_bench,
            "bench_equals_unfused_swaps": True,
            "launches_bench": bench_counts, "launches_api": api_counts,
            "bench_route_first_wall_s": bench_wall,
            "api_route_first_wall_s": api_wall}
    return line, ops, api_program, us


def cluster_library(torch, cplx, x, a, b, swap=None):
    """Single torch.einsum calls computing the same function as K11
    (``swap`` is None) or K12 (``swap`` = (h, b, m)) on the canonical state
    ``x``, as {subscripts: call}: yardsticks only, the port never calls
    them.  The operand order sets the contraction path (B.X first or X.A
    first), and a size-1 axis before the lanes (K1's view at k = 7)
    changes how torch lays the products out; the fastest form is the
    library time.  At rank 1 the forms carry no rank axis.  For K12 the
    state is viewed with the two swapped m-bit fields as their own axes,
    so the swap is a relabelling of axes inside the one call."""
    rank = a.shape[0]
    ac = torch.complex(a[:, 0], a[:, 1])
    bc = torch.complex(b[:, 0], b[:, 1])
    nb = x.shape[1]
    if swap is None:
        xc = cplx.to_complex(x)
        bv, xs, out = "qw", "gwl", "gqp"
    else:
        h, bq, m = swap
        mm = 1 << m
        glo = 1 << (h - 14)
        rlo = 1 << (bq - 7)
        ghi, rhi = nb // (glo * mm), 128 // (mm * rlo)
        # slab = (ghi, slab field, glo), row = (rhi, row field, rlo)
        xc = cplx.to_complex(x.reshape(2, ghi, mm, glo, rhi, mm, rlo, 128))
        bc = bc.reshape(rank, 128, rhi, mm, rlo)
        bv, xs, out = "qrto", "atcrsol", "ascqp"
    av = "pl"
    if rank == 1:
        ac, bc = ac[0], bc[0]
    else:
        av, bv = "k" + av, "k" + bv
    forms = {}
    for xv, xo, xt in ((xs, out, xc),
                       (xs[:-1] + "m" + xs[-1], out[:-1] + "m" + out[-1],
                        xc.unsqueeze(-2))):
        bx = f"{bv},{xv},{av}->{xo}"
        xa = f"{xv},{av},{bv}->{xo}"
        forms[bx] = lambda bx=bx, xt=xt: torch.einsum(bx, bc, xt, ac)
        forms[xa] = lambda xa=xa, xt=xt: torch.einsum(xa, xt, ac, bc)
    return forms


def library_time(torch, cplx, y, forms, tol, what):
    """Checks every einsum form against the kernel's output ``y`` and
    times each: (fastest ms, its subscripts, {subscripts: ms})."""
    times = {}
    for form, fn in forms.items():
        diff = float((y - cplx.from_complex(fn()).reshape(y.shape))
                     .abs().max())
        check(diff <= tol, f"{what}: the einsum yardstick {form} computes "
              f"another function (|diff| {diff})")
        times[form] = time_ms(fn, reps=5)
    best = min(times, key=times.get)
    return times[best], best, times


def phase_paged_timing(torch, qt, C, fused, circuits, cplx, ops, api_program,
                       us):
    n = N_MAIN
    num_amps = 1 << n
    x = torch.randn((2, 1 << (n - 14), 128, 128), dtype=torch.float32,
                    device=DEVICE)
    x /= torch.sqrt(torch.sum(x * x))
    state_bytes = x.numel() * x.element_size()
    tol = tolerance(x)
    out = {"state_bytes_f32": state_bytes}

    def pick(kind, rank):
        return next(op for op in ops if op[0] == kind
                    and op[-1].shape[0] == rank)

    for rank in (1, 4):
        op = pick("fused", rank)
        a, b = op[1], op[2]

        def k11():
            return fused.apply_cluster_stack(x, a, b, num_qubits=n)

        def plain11():
            return fused.cluster_stack_plain(x, a, b, num_qubits=n)

        y = k11()
        err = float((y - plain11()).abs().max())
        check(err <= tol, f"K11 R={rank} at {n} qubits: |err| {err}")
        lib_ms, lib_form, lib_forms = library_time(
            torch, cplx, y, cluster_library(torch, cplx, x, a, b), tol,
            f"K11 R={rank}")
        del y
        b_ms, b_by = bound_ms([("winfused", 7, a, b, True, True, None)],
                              state_bytes, num_amps, "float32")
        ms = time_ms(k11)
        out[f"k11_rank{rank}"] = {
            "rank": rank, "max_abs_err": err,
            "extra_mem_bytes": extra_bytes(k11), "ms": ms,
            "plain_ms": time_ms(plain11, reps=5), "library_ms": lib_ms,
            "ms_over_library_ms": ms / lib_ms,
            "library_form": lib_form, "library_forms_ms": lib_forms,
            "bound_ms": b_ms, "bound_by": b_by}

        op = pick("swapfused", rank)
        h, bq, m, a, b = op[1:]

        def k12():
            return fused.apply_swap_cluster_stack(x, a, b, num_qubits=n, h=h,
                                                  b=bq, m=m)

        def plain12():
            return fused.swap_cluster_stack_plain(x, a, b, num_qubits=n, h=h,
                                                  b=bq, m=m)

        y = k12()
        check(torch.equal(y, fused.apply_cluster_stack(
            C.execute_plan(x, [("segswap", h, bq, m)], n), a, b,
            num_qubits=n)), f"K12 R={rank} at {n} qubits: not "
              "bit-identical to segswap then K11")
        err = float((y - plain12()).abs().max())
        check(err <= tol, f"K12 R={rank} at {n} qubits: |err| {err}")
        lib_ms, lib_form, lib_forms = library_time(
            torch, cplx, y, cluster_library(torch, cplx, x, a, b,
                                            (h, bq, m)), tol, f"K12 R={rank}")
        del y
        b_ms, b_by = bound_ms([("winfused", 7, a, b, True, True, None)],
                              state_bytes, num_amps, "float32")
        ms = time_ms(k12)
        out[f"k12_rank{rank}"] = {
            "rank": rank, "h": h, "b": bq, "m": m, "max_abs_err": err,
            "bit_identical_to_segswap_k11": True,
            "extra_mem_bytes": extra_bytes(k12), "ms": ms,
            "plain_ms": time_ms(plain12, reps=5), "library_ms": lib_ms,
            "ms_over_library_ms": ms / lib_ms,
            "library_form": lib_form, "library_forms_ms": lib_forms,
            "bound_ms": b_ms, "bound_by": b_by}

    segswap = {}
    for op in ops:
        if op[0] == "segswap" and op[3] not in segswap:
            segswap[op[3]] = {"h": op[1], "b": op[2], "m": op[3],
                              "ms": time_ms(lambda op=op: C.execute_plan(
                                  x, [op], n), reps=5),
                              "bound_ms": 2 * state_bytes / HBM_BYTES_PER_S
                              * 1e3, "bound_by": "bytes"}
    out["segswap_by_m"] = [segswap[m] for m in sorted(segswap)]
    del x
    torch.cuda.empty_cache()

    env = qt.createQuESTEnv()

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

    api_ops = [op for _kind, part in api_program
               for op in C.plan_to_device(part, torch.float32, DEVICE)]
    with planner_env("paged"):
        for label, fn, route_ops in (("bench", bench_route, ops),
                                     ("api", api_route, api_ops)):
            samples = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                samples.append(time.perf_counter() - t0)
            wall = statistics.median(samples)
            by_kind = op_breakdown(torch, C, route_ops, n)
            busy = sum(by_kind.values())
            out[f"{label}_route_wall_s"] = wall
            out[f"{label}_breakdown"] = {"ms_by_op": by_kind,
                                         "device_ms": busy,
                                         "device_busy_share":
                                         busy / (wall * 1e3)}
    out["bench_plan_bound_ms"] = sum(
        bound_ms([("winfused", 7, op[-2], op[-1], True, True, None)], 0,
                 num_amps, "float32")[0]
        for op in ops if op[0] in ("fused", "swapfused"))
    return out


# ---------------------------------------------------------------------------
# Measurement: the seeded outcome streams (threefry and host MT19937)
# ---------------------------------------------------------------------------

N_MEAS_PARITY = 20     # state-vector qubits of the measurement parity checks
N_MEAS_RHO_PARITY = 10  # density qubits of the parity checks (2^20 amps)
N_MEAS_RHO = 13        # a density register of 2^26 amplitudes
N_SHOTS_Q = 12         # shot_sampling.py's preparation
SHOTS = 2000
MEASURE_SEEDS = [1234, 5678]
# jax.random.uniform(jax.random.fold_in(key, shot), dtype) for seeds
# [1234, 5678] and shots 0, 1, 2, pinned against JAX by
# tests/test_torch_rng.py
PINNED_F32 = [0.13736069, 0.18848944, 0.5674375]
PINNED_F64 = [0.49697267, 0.1997721, 0.90429892]


@contextmanager
def host_measure(on: bool):
    """QT_HOST_MEASURE=1 while the block runs (or unset)."""
    old = os.environ.get("QT_HOST_MEASURE")
    if on:
        os.environ["QT_HOST_MEASURE"] = "1"
    else:
        os.environ.pop("QT_HOST_MEASURE", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QT_HOST_MEASURE", None)
        else:
            os.environ["QT_HOST_MEASURE"] = old


def measure_prep(qt, q, n, density):
    """A fixed entangled preparation: H and Ry on every qubit, a CNOT
    ladder, and on a density register a depolarising layer."""
    for t in range(n):
        qt.hadamard(q, t)
        qt.rotateY(q, t, 0.15 * (t + 1))
    for t in range(n - 1):
        qt.controlledNot(q, t, t + 1)
    qt.rotateAroundAxis(q, n // 2, 0.7, (1.0, -2.0, 0.5))
    qt.multiControlledPhaseFlip(q, [0, n // 3, n - 1])
    if density:
        for t in range(n):
            qt.mixDepolarising(q, t, 0.02)


def measure_pair(qt, n, density, prec, device=None):
    """(register, clone) of the preparation at precision ``prec`` on
    ``device`` (the card by default)."""
    env = (qt.createQuESTEnv() if device is None
           else qt.createQuESTEnv(device=device))
    qt.set_precision(prec)
    try:
        q = (qt.createDensityQureg if density else qt.createQureg)(n, env)
        qt.initZeroState(q)
        measure_prep(qt, q, n, density)
        return q, qt.createCloneQureg(q, env), env
    finally:
        qt.set_precision(1)


def phase_measure_parity(torch, np, qt, measurement, threefry):
    out = {}
    # (1) the card's threshold stream against the host's, bit for bit
    key = threefry.key_from_seeds(MEASURE_SEEDS)
    for dtype, pinned in ((torch.float32, PINNED_F32),
                          (torch.float64, PINNED_F64)):
        name = str(dtype).split(".")[-1]
        dev = measurement.thresholds(key, 0, 1000, dtype, DEVICE)
        check(dev.device.type == "cuda", "thresholds did not reach the card")
        host = torch.from_numpy(threefry.uniforms(key, 0, 1000, name))
        check(torch.equal(dev.cpu(), host), f"{name} thresholds on the card "
              "differ from ops/threefry.py's")
        first = dev[:3].cpu().numpy()
        if dtype == torch.float32:
            ok = np.array_equal(first, np.array(pinned, dtype=np.float32))
        else:
            ok = bool(np.abs(first - np.array(pinned)).max() <= 1e-8)
        check(ok, f"{name} thresholds of shots 0-2 are {first.tolist()}, "
              f"not {pinned}")
        out[f"thresholds_{name}"] = first.tolist()

    # (2) measureSequence against a measureWithStats loop on a clone, and
    # the host route (and the fused one) on the card against the CPU
    for density, n in ((False, N_MEAS_PARITY), (True, N_MEAS_RHO_PARITY)):
        for prec in (1, 2):
            label = f"{'rho' if density else 'sv'}{n}_f{32 * prec}"
            q, c, env = measure_pair(qt, n, density, prec)
            qt.seedQuEST(env, MEASURE_SEEDS)
            outs, probs = qt.measureSequence(q, range(n))
            qt.seedQuEST(env, MEASURE_SEEDS)
            loop = [qt.measureWithStats(c, t) for t in range(n)]
            check(outs == [o for o, _ in loop], f"{label}: measureSequence "
                  f"{outs} != loop {[o for o, _ in loop]}")
            check(probs == [p for _, p in loop], f"{label}: probabilities of "
                  "the sequence and the loop differ")
            check(torch.equal(q.amps, c.amps), f"{label}: the sequence's and "
                  "the loop's states differ")
            check(q.amps.device.type == "cuda", f"{label}: state left the card")
            total = qt.calcTotalProb(q)
            check(abs(total - 1) <= 1e-4, f"{label}: calcTotalProb {total}")
            qt.destroyQureg(q, env)
            qt.destroyQureg(c, env)
            routes = {}
            for route in ("host", "fused"):
                got = {}
                for where in ("cuda", "cpu"):
                    with host_measure(route == "host"):
                        r, _, renv = measure_pair(
                            qt, n, density, prec,
                            device=None if where == "cuda" else "cpu")
                        qt.seedQuEST(renv, MEASURE_SEEDS)
                        got[where] = qt.measureSequence(r, range(n))
                        del r, _
                tol = 1e-5 if prec == 1 else 1e-12
                err = max(abs(a - b) for a, b in zip(got["cuda"][1],
                                                     got["cpu"][1]))
                check(got["cuda"][0] == got["cpu"][0], f"{label} {route} "
                      f"route: card {got['cuda'][0]} != CPU {got['cpu'][0]}")
                check(err <= tol, f"{label} {route} route: probabilities "
                      f"{err} from the CPU's")
                routes[route] = {"outcomes": got["cuda"][0],
                                 "max_prob_err_vs_cpu": err}
            out[label] = {"sequence_equals_loop": True,
                          "calc_total_prob": total, "routes": routes}
            torch.cuda.empty_cache()

    # (3) a zero-probability collapse raises
    env = qt.createQuESTEnv()
    q = qt.createQureg(N_MEAS_PARITY, env)
    qt.initPlusState(q)
    qt.collapseToOutcome(q, 0, 0)
    try:
        qt.collapseToOutcome(q, 0, 1)
    except qt.QuESTError as e:
        out["zero_probability_collapse"] = str(e)
    else:
        raise RuntimeError("collapseToOutcome on a zero-probability outcome "
                           "did not raise")
    qt.destroyQureg(q, env)
    return out


def phase_measure_main(torch, np, qt, fused, paulis, bigstate, noise,
                       us, want_k1, want_k2):
    """Config 2's circuit at 26 qubits through the API under gateFusion,
    then measureSequence over every qubit in the same block; the density
    and shot-sampling cases."""
    n = N_MEAS_MAIN
    out = {"n": n, "depth": DEPTH}
    env = qt.createQuESTEnv()
    for reset in (fused.reset_launch_counts, paulis.reset_launch_counts,
                  bigstate.reset_launch_counts):
        reset()
    t0 = time.perf_counter()
    q = qt.createQureg(n, env)
    with qt.gateFusion(q):
        apply_bench_gates(qt, q, us, n)
        c = qt.createCloneQureg(q, env)       # drains the circuit
        qt.seedQuEST(env, [1234])
        outs, probs = qt.measureSequence(q, range(n))
    sync()
    wall = time.perf_counter() - t0
    launches = {**fused.LAUNCHES, **paulis.LAUNCHES, **bigstate.LAUNCHES}
    check(launches["K1"] == want_k1 and launches["K2"] == want_k2,
          f"measure_main launched K1 {launches['K1']} and K2 "
          f"{launches['K2']} times, the plan holds {want_k1} and {want_k2}")
    check(launches["K1"] > 0, "K1 never launched on the measurement path")
    others = {k: v for k, v in launches.items() if k not in ("K1", "K2")
              and v}
    check(not others, f"the measurement launched kernels: {others}")
    x = sum(o << t for t, o in enumerate(outs))
    amp = abs(qt.getAmp(q, x))
    total = qt.calcTotalProb(q)
    check(abs(amp - 1) <= 1e-5, f"|amp[{x}]| = {amp} after measuring all")
    check(abs(total - 1) <= 1e-5, f"calcTotalProb {total} after measuring")
    errs = []
    for t in range(n):
        p = qt.calcProbOfOutcome(c, t, outs[t])
        errs.append(abs(p - probs[t]))
        qt.collapseToOutcome(c, t, outs[t])
    check(max(errs) <= 1e-5, f"measureSequence's probabilities stray "
          f"{max(errs)} from a step-by-step collapse")
    out.update(outcome_index=x, abs_amp=amp, calc_total_prob=total,
               max_prob_err_vs_collapse=max(errs),
               first_probs=probs[:4], launches={"K1": launches["K1"],
                                                "K2": launches["K2"]},
               wall_s=wall)
    qt.destroyQureg(q, env)
    qt.destroyQureg(c, env)
    torch.cuda.empty_cache()

    # a 13-qubit density register (2^26 amplitudes) after one config-4
    # noise layer, measured in full
    m = N_MEAS_RHO
    kops = noise.bench_kraus_ops(NOISE_SEED)
    rho = qt.createDensityQureg(m, env)
    qt.initPlusState(rho)
    fused.reset_launch_counts()
    with qt.gateFusion(rho):
        noise.noise_layer(qt, rho, m, kops, prob=NOISE_P)
    k5 = fused.LAUNCHES["K5"]
    qt.seedQuEST(env, [1234])
    routs, rprobs = qt.measureSequence(rho, range(m))
    purity = qt.calcPurity(rho)
    rtotal = qt.calcTotalProb(rho)
    check(abs(purity - 1) <= 1e-5, f"purity {purity} after measuring the "
          "density register in full")
    check(abs(rtotal - 1) <= 1e-5, f"density calcTotalProb {rtotal}")
    out["density"] = {"n": m, "amps": 1 << (2 * m), "k5_launches": k5,
                      "outcomes": routs, "purity": purity,
                      "calc_total_prob": rtotal}
    qt.destroyQureg(rho, env)
    torch.cuda.empty_cache()

    # shot_sampling.py's preparation at 12 qubits, 2000 shots
    k = N_SHOTS_Q

    def prepare():
        p = qt.createQureg(k, env)
        with qt.gateFusion(p):
            qt.hadamard(p, 0)
            for t in range(1, k):
                qt.controlledNot(p, t - 1, t)
            for t in range(k):
                qt.rotateY(p, t, 0.15 * (t + 1))
        return p

    base = prepare()
    dist = qt.calcProbOfAllOutcomes(base, range(k))
    idx = np.arange(1 << k)
    marg = np.array([dist[(idx >> t) & 1 == 1].sum() for t in range(k)])
    qt.seedQuEST(env, [1234])
    fused.reset_launch_counts()
    ones = np.zeros(k)
    t0 = time.perf_counter()
    for _ in range(SHOTS):
        o, _ = qt.measureSequence(prepare(), range(k))
        ones += o
    sync()
    shots_wall = time.perf_counter() - t0
    freq = ones / SHOTS
    sigma = np.sqrt(marg * (1 - marg) / SHOTS)
    z = np.abs(freq - marg) / sigma
    check(bool(np.all(z <= 4)), f"shot frequencies {freq.tolist()} stray "
          f"more than 4 sigma from {marg.tolist()}")
    out["shots"] = {"n": k, "shots": SHOTS, "max_z": float(z.max()),
                    "freq_of_one": freq.tolist(),
                    "exact_marginal": marg.tolist(),
                    "k1_launches": fused.LAUNCHES["K1"],
                    "wall_s": shots_wall, "ms_per_shot":
                    shots_wall * 1e3 / SHOTS}
    return out, launches["K1"]


def copies_seen(torch, call) -> dict:
    """Host-device copies one call makes, by direction, as torch.profiler
    sees them on the card (None if it sees nothing there)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=DEVICE).add_(1)
        sync()
        call()
        sync()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        return {"device_to_host": None, "host_to_device": None}
    return {"device_to_host": sum(1 for e in on_card if "DtoH" in e.name),
            "host_to_device": sum(1 for e in on_card if "HtoD" in e.name)}


def phase_measure_timing(torch, qt, us, measurement):
    n = N_MEAS_MAIN
    env = qt.createQuESTEnv()
    base = qt.createQureg(n, env)
    with qt.gateFusion(base):
        apply_bench_gates(qt, base, us, n)
    q = qt.createCloneQureg(base, env)
    state_bytes = q.amps.numel() * q.amps.element_size()
    out = {"device": torch.cuda.get_device_name(0), "n": n,
           "state_bytes_f32": state_bytes}

    def fresh():
        qt.cloneQureg(q, base)
        qt.seedQuEST(env, [1234])
        sync()

    routes = {
        "measureSequence": (False, lambda: qt.measureSequence(q, range(n))),
        "measureWithStats_loop": (False, lambda: [
            qt.measureWithStats(q, t) for t in range(n)]),
        "host_mt_loop": (True, lambda: [
            qt.measureWithStats(q, t) for t in range(n)]),
    }
    for label, (host, call) in routes.items():
        with host_measure(host):
            samples = []
            for _ in range(3):
                fresh()
                t0 = time.perf_counter()
                call()
                sync()
                samples.append(time.perf_counter() - t0)
            wall = statistics.median(samples)
            fresh()
            dev, _ = device_busy(torch, call, "none")
            fresh()
            copies = copies_seen(torch, call)
        out[label] = {"wall_ms_per_qubit": wall * 1e3 / n,
                      "wall_ms": wall * 1e3,
                      "device_ms": dev,
                      "device_busy_share": None if dev is None
                      else dev / (wall * 1e3),
                      "copies_per_sequence": copies}
    check(out["measureSequence"]["copies_per_sequence"]["device_to_host"]
          in (None, 1), "measureSequence made "
          f"{out['measureSequence']['copies_per_sequence']} copies")
    # the two steps of one qubit alone (CUDA events): the probability
    # reduction and the collapse
    from quest_tpu_torch.ops import calculations

    x = q.amps
    p0 = calculations.calc_prob_of_outcome_statevec(
        x, num_qubits=n, target=n - 1, outcome=0)
    one = torch.zeros((), dtype=torch.int64, device=DEVICE)
    out["prob_reduction_ms"] = time_ms(
        lambda: calculations.calc_prob_of_outcome_statevec(
            x, num_qubits=n, target=n - 1, outcome=0))
    out["collapse_ms"] = time_ms(lambda: measurement._collapse_traced_sv(
        x, n, n - 1, one, p0))
    out["one_qubit_device_ms"] = time_ms(lambda: measurement.measure_sequence(
        x, (1, 2), 0, num_qubits=n, targets=(n - 1,), is_density=False))
    # the least time per qubit by bytes: the probability's read plus the
    # collapse's read and write of the state (the unfused two steps), and
    # one read and one write (a collapse fused with the next probability)
    out["bound_ms_per_qubit"] = 3 * state_bytes / HBM_BYTES_PER_S * 1e3
    out["bound_ms_per_qubit_fused"] = 2 * state_bytes / HBM_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    qt.destroyQureg(q, env)
    qt.destroyQureg(base, env)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The reference's lower matmul precisions in K1, K2, K11 and K12
# ---------------------------------------------------------------------------

LOW_MODES = ("bf16_3x", "default")
# Each mode's per-product error (relative): "bf16_3x" drops x_l m_l and
# rounds the low parts, about 2^-16; "default" rounds both operands to
# TF32, about 2^-11.
MODE_UNIT = {"bf16_3x": 2.0 ** -16, "default": 2.0 ** -11}
# The least time of a mode's products: three bf16 products at the dense
# bf16 rate, one TF32 product at the TF32 rate ("highest": WINDOW_FLOPS).
MODE_FLOPS = {"bf16_3x": 989e12 / 3, "default": 495e12}
PREC_SWAPS = ((14, 7, 3), (16, 9, 2), (17, 11, 1))   # K12's (h, b, m)


def mode_tolerance(x, mode: str, model: bool) -> float:
    """How far a float32 pass under ``mode`` may stray, per pass, on the
    normalised state ``x``.  Against the mode's model (``model``,
    fused.window_pass_split): the products are the same exact products,
    summed in another order, but a dual pass splits its float32
    intermediate T again, and where T's kernel and model values straddle
    a rounding step of the split one low part moves by one unit, a
    product by the mode's unit: MODE_UNIT max|x|.  Against the full
    float32 plain version: four per-product errors, 4 MODE_UNIT max|x|
    (measured on the CPU at 20 qubits: 6.5e-6 and 3.9e-4 max|x| for
    rank-1 dual passes)."""
    return (1 if model else 4) * MODE_UNIT[mode] * float(x.abs().max())


def phase_precision_parity(torch, np, fused, C):
    """K1, K2, K11 and K12 under "bf16_3x" and "default" at float32
    against their modes' plain models and the full plain versions; K2
    and K12 bit for bit against their per-pass forms; mask-only passes
    bit for bit against "highest"; at float64 every mode bit for bit
    equal to "highest"."""
    n = N_PARITY
    rng = np.random.default_rng(2468)
    out = {"n": n, "modes": {}}
    x = rng.standard_normal((2, 1 << n))
    x /= np.sqrt((x ** 2).sum())
    x32 = torch.as_tensor(x, dtype=torch.float32, device=DEVICE)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=DEVICE)
    for mode in LOW_MODES:
        tol_m = mode_tolerance(x32, mode, True)
        tol_p = mode_tolerance(x32, mode, False)
        rec = {"tolerance_vs_model": tol_m, "tolerance_vs_plain": tol_p,
               "k1_cases": 0, "k1_max_abs_err": 0.0,
               "k1_max_abs_err_vs_plain": 0.0, "k2": []}
        for k in (7, 10, 13):
            for rank in (1, 4):
                for sides in ("AB", "B", "A"):
                    for with_mask in (False, True):
                        op = random_pass(rng, k, rank, sides, with_mask)
                        kw = dict(num_qubits=n, k=k, apply_a=op[4],
                                  apply_b=op[5])
                        y = fused.apply_window_stack(
                            x32, op[2], op[3], op[6], precision=mode, **kw)
                        ym = fused.window_pass_split(
                            x32, op[2], op[3], op[6], precision=mode, **kw)
                        yp = fused.window_pass_plain(x32, op[2], op[3],
                                                     op[6], **kw)
                        err = float((y - ym).abs().max())
                        errp = float((y - yp).abs().max())
                        what = f"K1 {mode} k={k} R={rank} {sides} " \
                               f"mask={with_mask}"
                        check(err <= tol_m, f"{what}: |err| {err} vs its "
                              f"model > {tol_m}")
                        check(errp <= tol_p, f"{what}: |err| {errp} vs "
                              f"plain > {tol_p}")
                        rec["k1_max_abs_err"] = max(rec["k1_max_abs_err"],
                                                    err)
                        rec["k1_max_abs_err_vs_plain"] = max(
                            rec["k1_max_abs_err_vs_plain"], errp)
                        rec["k1_cases"] += 1
            # a mask-only pass runs no products: the same in every mode
            op = random_pass(rng, k, 1, "M", True)
            kw = dict(num_qubits=n, k=k, apply_a=False, apply_b=False)
            check(torch.equal(
                fused.apply_window_stack(x32, op[2], op[3], op[6],
                                         precision=mode, **kw),
                fused.apply_window_stack(x32, op[2], op[3], op[6],
                                         precision="highest", **kw)),
                f"K1 {mode} k={k}: a mask-only pass differs from highest")
        # K2 on the bench plan's group shapes and a mixed group with a
        # mask-only pass: bit for bit its passes through K1, launched
        # twice with equal results, within len * tol of its model
        for spec in (*K2_BENCH_GROUPS.values(),
                     [(8, 1, "AB", True), (9, 1, "M", True),
                      (10, 4, "B", False), (7, 2, "A", True)]):
            group = [random_pass(rng, k, r, sd, m) for k, r, sd, m in spec]
            y2 = fused.apply_window_megastack(x32, group, num_qubits=n,
                                              precision=mode)
            again = fused.apply_window_megastack(x32, group, num_qubits=n,
                                                 precision=mode)
            y1 = C.execute_plan(x32, group, n, precision=mode)
            ym = fused.megawin_plain(x32, group, num_qubits=n,
                                     precision=mode)
            sync()
            check(torch.equal(y2, y1), f"K2 {mode} {spec}: not "
                  "bit-identical to K1 pass by pass")
            check(torch.equal(y2, again), f"K2 {mode} {spec}: a second "
                  "launch differs")
            err = float((y2 - ym).abs().max())
            check(err <= len(group) * tol_m, f"K2 {mode} {spec}: |err| "
                  f"{err} vs its model")
            rec["k2"].append({"passes": len(group), "max_abs_err": err,
                              "bit_identical_to_k1": True})
        # K11 (K1's kernel at k = 7) and K12 (segswap + K11, bit for bit)
        rec["k11_max_abs_err"] = rec["k12_max_abs_err"] = 0.0
        for rank in (1, 4):
            a, b = paged_sides(torch, rng, rank, torch.float32)
            y = fused.apply_cluster_stack(x32, a, b, num_qubits=n,
                                          precision=mode)
            check(torch.equal(y, fused.apply_window_stack(
                x32, a, b, None, num_qubits=n, k=7, precision=mode)),
                f"K11 {mode} R={rank}: not bit-identical to K1 at k = 7")
            err = float((y - fused.cluster_stack_plain(
                x32, a, b, num_qubits=n, precision=mode)).abs().max())
            check(err <= tol_m, f"K11 {mode} R={rank}: |err| {err}")
            rec["k11_max_abs_err"] = max(rec["k11_max_abs_err"], err)
            for h, bq, m in PREC_SWAPS:
                y = fused.apply_swap_cluster_stack(
                    x32, a, b, num_qubits=n, h=h, b=bq, m=m, precision=mode)
                ys = fused.apply_cluster_stack(
                    C.execute_plan(x32, [("segswap", h, bq, m)], n), a, b,
                    num_qubits=n, precision=mode)
                sync()
                check(torch.equal(y, ys), f"K12 {mode} R={rank} "
                      f"{(h, bq, m)}: not bit-identical to segswap then K11")
                err = float((y - fused.swap_cluster_stack_plain(
                    x32, a, b, num_qubits=n, h=h, b=bq, m=m,
                    precision=mode)).abs().max())
                check(err <= tol_m, f"K12 {mode} R={rank} {(h, bq, m)}: "
                      f"|err| {err}")
                rec["k12_max_abs_err"] = max(rec["k12_max_abs_err"], err)
        rec["k12_bit_identical_to_segswap_k11"] = True
        # float64: the same DMMA products in every mode
        f64 = 0
        for op in (random_pass(rng, 10, 4, "AB", True),
                   random_pass(rng, 7, 1, "B", False),
                   random_pass(rng, 13, 2, "A", True)):
            kw = dict(num_qubits=n, k=op[1], apply_a=op[4], apply_b=op[5])
            check(torch.equal(
                fused.apply_window_stack(x64, op[2], op[3], op[6],
                                         precision=mode, **kw),
                fused.apply_window_stack(x64, op[2], op[3], op[6],
                                         precision="highest", **kw)),
                f"K1 float64 {mode}: differs from highest")
            f64 += 1
        group = [random_pass(rng, k, r, sd, m)
                 for k, r, sd, m in K2_BENCH_GROUPS["C"]]
        check(torch.equal(
            fused.apply_window_megastack(x64, group, num_qubits=n,
                                         precision=mode),
            fused.apply_window_megastack(x64, group, num_qubits=n,
                                         precision="highest")),
            f"K2 float64 {mode}: differs from highest")
        a, b = paged_sides(torch, rng, 4, torch.float64)
        check(torch.equal(
            fused.apply_cluster_stack(x64, a, b, num_qubits=n,
                                      precision=mode),
            fused.apply_cluster_stack(x64, a, b, num_qubits=n,
                                      precision="highest")),
            f"K11 float64 {mode}: differs from highest")
        check(torch.equal(
            fused.apply_swap_cluster_stack(x64, a, b, num_qubits=n, h=16,
                                           b=9, m=2, precision=mode),
            fused.apply_swap_cluster_stack(x64, a, b, num_qubits=n, h=16,
                                           b=9, m=2, precision="highest")),
            f"K12 float64 {mode}: differs from highest")
        rec["float64_bit_identical_to_highest"] = f64 + 3
        out["modes"][mode] = rec
    return out


# P(top = 0) of config 2 under a lower mode against "highest": each
# window pass moves an amplitude by a few of the mode's per-product
# errors (MODE_UNIT), so 27 passes move the probability by well under
# 100 of them.
MODE_PROB_LIMIT = {"bf16_3x": 1e-4, "default": 1e-2}


@contextmanager
def matmul_mode(fused, mode: str):
    """The window kernels' precision mode set to ``mode`` for the block,
    "highest" restored after it."""
    fused.set_matmul_precision(mode)
    try:
        yield
    finally:
        fused.set_matmul_precision("highest")


def mode_kernel_times(torch, np, C, fused, x, ops, mode):
    """K1 (the bench plan's dual and B-only rank-1 passes), K2 (group C),
    K11 and K12 (h = n - 3, m = 3; rank 1) at 2^26 amplitudes under
    ``mode``: ms,
    the bound at the mode's rate (MODE_FLOPS), and the error against the
    mode's model on the card."""
    n = N_MAIN
    num_amps = 1 << n
    sb = x.numel() * x.element_size()
    tol = mode_tolerance(x, mode, True)
    winfused = [op for op in ops if op[0] == "winfused"]
    dual = next(op for op in winfused
                if op[4] and op[5] and op[2].shape[0] == 1)
    bonly = next(op for op in winfused
                 if op[5] and not op[4] and op[2].shape[0] == 1)
    # the largest group: config 2's group C at 26 qubits
    group_c = max((op[1] for op in ops if op[0] == "megawin"), key=len)
    rng = np.random.default_rng(97)
    a, b = paged_sides(torch, rng, 1, torch.float32)
    cluster = ("winfused", 7, a, b, True, True, None)
    cases = {
        "k1_dual_rank1": ([dual], lambda: fused.apply_window_stack(
            x, dual[2], dual[3], dual[6], num_qubits=n, k=dual[1],
            apply_a=True, apply_b=True, precision=mode),
            lambda: fused.window_pass_split(
                x, dual[2], dual[3], dual[6], num_qubits=n, k=dual[1],
                precision=mode)),
        "k1_b_only_rank1": ([bonly], lambda: fused.apply_window_stack(
            x, bonly[2], bonly[3], bonly[6], num_qubits=n, k=bonly[1],
            apply_a=False, apply_b=True, precision=mode),
            lambda: fused.window_pass_split(
                x, bonly[2], bonly[3], bonly[6], num_qubits=n, k=bonly[1],
                apply_a=False, precision=mode)),
        "k2_group_c": (list(group_c), lambda: fused.apply_window_megastack(
            x, group_c, num_qubits=n, precision=mode),
            lambda: fused.megawin_plain(x, group_c, num_qubits=n,
                                        precision=mode)),
        "k11_rank1": ([cluster], lambda: fused.apply_cluster_stack(
            x, a, b, num_qubits=n, precision=mode),
            lambda: fused.cluster_stack_plain(x, a, b, num_qubits=n,
                                              precision=mode)),
        "k12_rank1": ([cluster], lambda: fused.apply_swap_cluster_stack(
            x, a, b, num_qubits=n, h=n - 3, b=9, m=3, precision=mode),
            lambda: fused.swap_cluster_stack_plain(
                x, a, b, num_qubits=n, h=n - 3, b=9, m=3, precision=mode)),
    }
    out = {}
    for label, (passes, kern, model) in cases.items():
        err = float((kern() - model()).abs().max())
        check(err <= len(passes) * tol, f"{label} {mode} at {n} qubits: "
              f"|err| {err} vs its model")
        ms = time_ms(kern)
        b_ms, b_by = bound_ms(passes, sb, num_amps, "float32",
                              rate=MODE_FLOPS[mode])
        out[label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "fraction_of_bound": b_ms / ms, "max_abs_err": err}
    return out


def phase_precision_main(torch, np, qt, C, fused, fusion, circuits, plan,
                         us, p_highest):
    """Config 2 at 26 qubits under each lower mode, through the bench
    route (precision= on execute_plan_chained) and the API route
    (set_matmul_precision around a gateFusion drain), each with the
    launch counts reset just before it: P(top = 0) against the "highest"
    route's, calcTotalProb, the wall per circuit; then each window
    kernel's time at the main path's shapes under the mode."""
    n = N_MAIN
    ops = C.plan_to_device(plan, torch.float32, DEVICE)
    pst = C.stats(plan)
    items = capture_items(qt, us, n)
    env = qt.createQuESTEnv()
    out = {"n": n, "depth": DEPTH, "p_top_zero_highest": p_highest,
           "modes": {}}
    for mode in LOW_MODES:
        lim = MODE_PROB_LIMIT[mode]
        fused.reset_launch_counts()

        def bench_route():
            a = circuits.zero_state_canonical(n, torch.float32, DEVICE)
            a = C.execute_plan_chained(a, ops, n, precision=mode)
            return a, float(circuits.prob_top_zero_canonical(a))

        a, p_b = bench_route()
        sync()
        bench_launch = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
        check(bench_launch == {"K1": pst["winfused"], "K2": pst["megawin"]},
              f"{mode} bench route launched {bench_launch}")
        total_b = float(torch.sum(a.double() ** 2))
        del a
        with matmul_mode(fused, mode):
            ast = fusion.program_stats(fusion.plan_items(items, n,
                                                         device=DEVICE))
            fused.reset_launch_counts()

            def api_route():
                q = qt.createQureg(n, env)
                with qt.gateFusion(q):
                    apply_bench_gates(qt, q, us, n)
                p = qt.calcProbOfOutcome(q, n - 1, 0)
                t = qt.calcTotalProb(q)
                qt.destroyQureg(q, env)
                return p, t

            p_a, total_a = api_route()
            sync()
            api_launch = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
            check(api_launch == {"K1": ast.get("winfused", 0),
                                 "K2": ast.get("megawin", 0)},
                  f"{mode} API route launched {api_launch}")
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
        check(fused.matmul_precision_name() == "highest",
              "the mode was not restored")
        for label, p in (("bench", p_b), ("api", p_a)):
            check(abs(p - p_highest) <= lim, f"{mode} {label} route: P(top "
                  f"= 0) {p} vs highest {p_highest} (limit {lim})")
        for label, t in (("bench", total_b), ("api", total_a)):
            check(abs(t - 1.0) <= lim, f"{mode} {label} route: total "
                  f"probability {t}")
        x = torch.randn((2, 1 << (n - 14), 128, 128), dtype=torch.float32,
                        device=DEVICE)
        x /= torch.sqrt(torch.sum(x * x))
        times = mode_kernel_times(torch, np, C, fused, x, ops, mode)
        del x
        out["modes"][mode] = {
            "limit": lim, "p_top_zero_bench": p_b, "p_top_zero_api": p_a,
            "p_err_bench": abs(p_b - p_highest),
            "p_err_api": abs(p_a - p_highest),
            "total_prob_bench": total_b, "calc_total_prob_api": total_a,
            "launches_bench": bench_launch, "launches_api": api_launch,
            **walls, "kernels": times}
    del ops
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# DiagonalOp and the phase functions (plain torch, as the reference's
# plain XLA)
# ---------------------------------------------------------------------------

N_DIAG = 30            # an 8.6 GB float32 state and an 8.6 GB operator
N_DIAG_RHO = 15        # a density register of 2^30 amplitudes
DIAG_SEED = 7
DIAG_SAMPLES = 4096


def maxcut_ring(n: int, seed: int):
    """A weighted MaxCut ring as an all-Z PauliHamil's (codes, coeffs):
    w_e Z_i Z_{i+1 mod n}, weights uniform in [0.5, 1.5)."""
    import numpy as np

    w = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    codes = np.zeros((n, n), np.int32)
    for e in range(n):
        codes[e, e] = codes[e, (e + 1) % n] = 3
    return codes, w


def ring_energy(np, x, w):
    """sum_e w_e (-1)^(x_i + x_{i+1}) at the integer indices ``x``."""
    n = w.size
    bits = (x[:, None] >> np.arange(n)) & 1
    s = 1 - 2 * bits
    return (s * np.roll(s, -1, axis=1) * w).sum(axis=1)


def phase_diagonal_main(torch, np, qt):
    """Float32 at 30 qubits: initDiagonalOpFromPauliHamil of a MaxCut
    ring, calcExpecDiagonalOp on |+>^n (0: every term has a Z) and on a
    basis state (its ring energy), applyDiagonalOp at sampled indices,
    applyPhaseFuncOverrides on all 30 qubits and applyParamNamedPhaseFunc
    (SCALED_DISTANCE) over two 15-qubit registers against the analytic
    phases at sampled indices; a 15-qubit density register (2^30) with
    applyDiagonalOp and calcExpecDiagonalOp.  The wall per call and the
    peak device memory."""
    n = N_DIAG
    qt.set_precision(1)
    env = qt.createQuESTEnv()
    rng = np.random.default_rng(DIAG_SEED)
    codes, w = maxcut_ring(n, DIAG_SEED)
    wsum = float(np.abs(w).sum())
    # float32 sums of 2^30 products of size <= sum|w| / 2^30 (a tree
    # reduction: about log2(2^30) roundings of 2^-24), and the operator's
    # own float32 rounding: 1e-5 sum|w|
    tol_e = 1e-5 * wsum
    idx = np.concatenate([[0, (1 << n) - 1],
                          rng.integers(0, 1 << n, DIAG_SAMPLES)])
    idx_t = torch.as_tensor(idx, device=DEVICE)
    out = {"n": n, "terms": int(codes.shape[0]), "sum_abs_coeffs": wsum,
           "walls_ms": {}}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def timed(label, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out["walls_ms"][label] = (time.perf_counter() - t0) * 1e3
        return r

    hamil = qt.createPauliHamil(n, codes.shape[0])
    qt.initPauliHamil(hamil, w, codes)
    op = qt.createDiagonalOp(n, env)
    timed("initDiagonalOpFromPauliHamil",
          lambda: qt.initDiagonalOpFromPauliHamil(op, hamil))
    check(op.real.device.type == "cuda", "the operator is not on the card")
    want_d = ring_energy(np, idx, w)
    err = float(np.abs(op.real[idx_t].double().cpu().numpy() - want_d).max())
    check(err <= tol_e, f"initDiagonalOpFromPauliHamil: |err| {err}")
    out["op_max_abs_err"] = err

    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    e_plus = timed("calcExpecDiagonalOp", lambda: qt.calcExpecDiagonalOp(
        q, op))
    check(abs(e_plus) <= tol_e, f"<+|H|+> = {e_plus}, not 0")
    x = int(rng.integers(0, 1 << n))
    qt.initClassicalState(q, x)
    e_x = qt.calcExpecDiagonalOp(q, op)
    want_x = float(ring_energy(np, np.array([x]), w)[0])
    check(abs(e_x - want_x) <= tol_e and abs(e_x.imag) <= tol_e,
          f"<x|H|x> = {e_x}, want {want_x}")
    out.update(expec_plus=[e_plus.real, e_plus.imag], basis_index=x,
               expec_basis=[e_x.real, e_x.imag], expec_basis_want=want_x)

    amp = 2.0 ** (-n / 2)
    # one float32 rounding of each factor and of their product
    tol_a = 1e-5 * amp * max(1.0, wsum)

    def sampled(qq):
        a = qq.amps[:, idx_t].double().cpu().numpy()
        return a[0] + 1j * a[1]

    qt.initPlusState(q)
    timed("applyDiagonalOp", lambda: qt.applyDiagonalOp(q, op))
    err = float(np.abs(sampled(q) - amp * want_d).max())
    check(err <= tol_a, f"applyDiagonalOp: |err| {err}")
    out["apply_max_abs_err"] = err
    del op
    torch.cuda.empty_cache()

    # theta(x) = c1 x + c2 x^2 on all 30 qubits (at most 8 rad), two
    # overrides; float32 phases: |theta| errors ~ 8 * 2^-24
    qt.initPlusState(q)
    c1, c2 = 2.0 ** -28, 2.0 ** -58
    over = {0: 0.5, (1 << n) - 1: -1.0}
    timed("applyPhaseFuncOverrides", lambda: qt.applyPhaseFuncOverrides(
        q, list(range(n)), qt.UNSIGNED, [c1, c2], [1.0, 2.0],
        list(over), list(over.values())))
    xf = idx.astype(np.float64)
    theta = c1 * xf + c2 * xf * xf
    for k, v in over.items():
        theta[idx == k] = v
    tol_p = 1e-5 * amp
    err = float(np.abs(sampled(q) - amp * np.exp(1j * theta)).max())
    check(err <= tol_p, f"applyPhaseFuncOverrides: |err| {err}")
    out["phase_func_max_abs_err"] = err

    # SCALED_DISTANCE over registers [0, 15) and [15, 30): s |x2 - x1|
    qt.initPlusState(q)
    half = n // 2
    scale = 2.0 ** -13
    timed("applyParamNamedPhaseFunc", lambda: qt.applyParamNamedPhaseFunc(
        q, list(range(n)), [half, half], qt.UNSIGNED, qt.SCALED_DISTANCE,
        [scale]))
    x1 = idx & ((1 << half) - 1)
    x2 = idx >> half
    theta = scale * np.abs(x2 - x1).astype(np.float64)
    err = float(np.abs(sampled(q) - amp * np.exp(1j * theta)).max())
    check(err <= tol_p, f"SCALED_DISTANCE: |err| {err}")
    out["named_phase_func_max_abs_err"] = err
    qt.destroyQureg(q, env)
    del q
    torch.cuda.empty_cache()

    # a 15-qubit density register: D rho and Tr(D rho) on |+><+|
    m = N_DIAG_RHO
    vals = rng.uniform(-1, 1, 1 << m) + 1j * rng.uniform(-1, 1, 1 << m)
    dop = qt.createDiagonalOp(m, env)
    qt.initDiagonalOp(dop, vals.real, vals.imag)
    rho = qt.createDensityQureg(m, env)
    qt.initPlusState(rho)
    dim = 1 << m
    tol_r = 1e-5 * float(np.abs(vals).max())
    e_rho = timed("calcExpecDiagonalOp_density",
                  lambda: qt.calcExpecDiagonalOp(rho, dop))
    want = complex(vals.mean())
    check(abs(e_rho - want) <= tol_r, f"Tr(D rho) {e_rho}, want {want}")
    timed("applyDiagonalOp_density", lambda: qt.applyDiagonalOp(rho, dop))
    rows = idx & (dim - 1)
    a = rho.amps[:, idx_t].double().cpu().numpy()
    err = float(np.abs(a[0] + 1j * a[1] - vals[rows] / dim).max())
    check(err <= tol_r / dim, f"applyDiagonalOp on rho: |err| {err}")
    e_rho2 = qt.calcExpecDiagonalOp(rho, dop)
    want2 = complex((vals * vals).mean())
    check(abs(e_rho2 - want2) <= tol_r, f"Tr(D D rho) {e_rho2}, want "
          f"{want2}")
    out["density"] = {"n": m, "expec": [e_rho.real, e_rho.imag],
                      "expec_want": [want.real, want.imag],
                      "expec_after_apply": [e_rho2.real, e_rho2.imag],
                      "apply_max_abs_err": err}
    qt.destroyQureg(rho, env)
    del rho, dop
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Quad precision (M1b)
# ---------------------------------------------------------------------------

N_QUAD = 26            # config 2's circuit at precision 4 (a 1 GiB state)
QUAD_TOL = 1e-12       # quad read-outs against the precision-2 route
QUAD_A = 2.0 ** 53     # the cancellation's big amplitude (A^2 = 2^106)


def cancel_state(torch, n):
    """The reference's cancellation construction (tests/test_precision.py
    _cancel_vec) at the scale of quad_sum's 256 second-level partials:
    quarters [A][0][1][A] of the real plane, so that Re<psi|Z_(n-2)|psi>
    = 2^(n-2) (the ones' quarter) beside 2^(n-2) A^2 of cancelling
    terms, which a float64 sum loses."""
    q = 1 << (n - 2)
    x = torch.zeros((2, 1 << n), dtype=torch.float64, device=DEVICE)
    x[0, :q] = QUAD_A
    x[0, 2 * q:3 * q] = 1.0
    x[0, 3 * q:] = QUAD_A
    return x


def phase_quad_main(torch, np, qt, paulis, hamiltonians, circuits):
    """set_precision(4) on the card: config 2's circuit at 26 qubits
    through the API (float64 storage); calcTotalProb, calcProbOfOutcome,
    calcInnerProduct against a clone and calcExpecPauliHamil (config 5's
    16 terms) each within 1e-12 of the precision-2 route on the same
    register, K4 launching 0 times at quad and 16 at precision 2; a
    cancellation state at 2^26 amplitudes that the quad Pauli sum keeps;
    each read-out's wall at quad and at precision 2."""
    n = N_QUAD
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED, dtype=np.float64)
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   PAULI_SEED)
    env = qt.createQuESTEnv()
    qt.set_precision(4)
    try:
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        check(q.amps.dtype == torch.float64, "quad register is not float64")
        clone = qt.createCloneQureg(q, env)
        h = qt.createPauliHamil(n, PAULI_TERMS)
        qt.initPauliHamil(h, coeffs, codes)
        reads = {
            "calcTotalProb": lambda: qt.calcTotalProb(q),
            "calcProbOfOutcome": lambda: qt.calcProbOfOutcome(q, n - 1, 0),
            "calcInnerProduct": lambda: qt.calcInnerProduct(q, clone),
            "calcExpecPauliHamil": lambda: qt.calcExpecPauliHamil(q, h)}
        out = {"n": n, "read_outs": {}}
        k4 = {}
        vals = {}
        for prec in (4, 2):
            qt.set_precision(prec)
            paulis.reset_launch_counts()
            for name, fn in reads.items():
                sync()
                t0 = time.perf_counter()
                vals[(prec, name)] = fn()
                sync()
                out["read_outs"].setdefault(name, {})[
                    f"wall_ms_prec{prec}"] = (time.perf_counter() - t0) * 1e3
            k4[prec] = paulis.LAUNCHES["K4"]
        for name in reads:
            v4, v2 = vals[(4, name)], vals[(2, name)]
            err = abs(v4 - v2)
            check(err <= QUAD_TOL, f"quad {name} {v4} vs precision 2 {v2}")
            out["read_outs"][name].update(quad=repr(v4), prec2=repr(v2),
                                          abs_diff=err)
        check(k4[4] == 0, f"K4 launched {k4[4]} times at precision 4")
        check(k4[2] == PAULI_TERMS, f"K4 launched {k4[2]} times at "
              f"precision 2, not {PAULI_TERMS}")
        out["k4_launches"] = {"quad": k4[4], "prec2": k4[2]}
        check(abs(vals[(4, "calcTotalProb")] - 1.0) <= 1e-12,
              f"quad calcTotalProb {vals[(4, 'calcTotalProb')]}")
        # the cancellation: Z on qubit n - 2 signs the two A quarters apart
        qt.set_precision(4)
        q.amps = cancel_state(torch, n)
        z = [0] * n
        z[n - 2] = 3
        want = float(1 << (n - 2))
        sync()
        t0 = time.perf_counter()
        got = qt.calcExpecPauliSum(q, z, [1.0])
        quad_ms = (time.perf_counter() - t0) * 1e3
        qt.set_precision(2)
        t0 = time.perf_counter()
        plain = qt.calcExpecPauliSum(q, z, [1.0])
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(got == want, f"quad lost the cancellation: {got} != {want}")
        out["cancellation"] = {"amps": 1 << n, "want": want, "quad": got,
                               "plain_f64": plain,
                               "plain_lost_it": abs(plain - want) > 0.5 * want,
                               "quad_ms": quad_ms, "plain_ms": plain_ms}
        qt.destroyQureg(q, env)
        qt.destroyQureg(clone, env)
    finally:
        qt.set_precision(1)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Register banks (M14): K1, K2 and K5 over a whole bank in one launch
# ---------------------------------------------------------------------------

N_BATCH_PARITY = 20    # qubits of the bank kernels' parity checks
B_PARITY = 4
N_BATCH_MAIN = 26      # randomized compiling of config 2: 8 x 2^26
B_MAIN = 8
N_ENSEMBLE = 20        # EnsembleScheduler: 64 submissions at 20 qubits
ENSEMBLE_SUBMISSIONS = 64
N_TRAJ = 20            # trajectories: 256 at 20 qubits, 4096 at 8
TRAJ_BIG = 256
N_TRAJ_SMALL = 8
TRAJ_SMALL = 4096
TRAJ_P = 0.05
TRAJ_DAMP = 0.1
N_RHO_BANK = 13        # a density bank of 4 registers of 2^26 amplitudes
B_RHO = 4
BANK_KEYS = ("K1_bank", "K2_bank", "K5_bank", "K11_bank")


def bank_launches(fused) -> dict:
    return {k: fused.LAUNCHES[k] for k in ("K1", "K2", "K5", *BANK_KEYS)}


def bank_pass(rng, np, k, rank, sides, with_mask, per_sides, per_mask,
              nb, exact=None):
    """A bank window pass: sides shared (R, 2, 128, 128) or per element
    (B, R, 2, 128, 128), mask shared or per element; ``exact`` lists the
    elements whose sides are 0/1 permutations (TF32 values)."""
    def one(b):
        if exact is not None and b in exact:
            return permutation_pass(rng, k, sides)
        return random_pass(rng, k, rank, sides, with_mask)

    ops = [one(b) for b in range(nb if per_sides else 1)]
    if per_sides:
        a = np.stack([op[2] for op in ops])
        bm = np.stack([op[3] for op in ops])
    else:
        a, bm = ops[0][2], ops[0][3]
    mask = None
    if with_mask:
        masks = [random_pass(rng, k, 1, "M", True)[6]
                 for _ in range(nb if per_mask else 1)]
        mask = np.stack(masks) if per_mask else masks[0]
    return ("winfused", k, a, bm, "A" in sides, "B" in sides, mask)


def random_bank(torch, np, rng, n, nb, dtype):
    x = rng.standard_normal((nb, 2, 1 << n))
    x /= np.sqrt((x ** 2).sum(axis=(1, 2), keepdims=True))
    return torch.as_tensor(x, dtype=dtype, device=DEVICE)


def k1_scalar(fused, x, op, n):
    return fused.apply_window_stack(x, op[2], op[3], op[6], num_qubits=n,
                                    k=op[1], apply_a=op[4], apply_b=op[5])


def k1_bank_plain(torch, fused, x, op, n):
    """Bank K1's plain version on the card: the window pass model on each
    element with its own (or the shared) sides and mask."""
    out = []
    for b in range(x.shape[0]):
        e = fused.bank_element_op(op, b)
        out.append(fused.window_pass_model(
            x[b], e[2], e[3], e[6], num_qubits=n, k=e[1], apply_a=e[4],
            apply_b=e[5]))
    return torch.stack(out)


def k2_bank_plain(torch, fused, x, group, n):
    """Bank K2's plain version on the card: ``megawin_plain`` on each
    element with its own passes."""
    return torch.stack([fused.megawin_plain(
        x[b], [fused.bank_element_op(op, b) for op in group], num_qubits=n)
        for b in range(x.shape[0])])


def phase_batch_parity(torch, np, fused):
    """The bank kernels at 20 qubits, B = 4: bank K1 bit for bit against
    four scalar K1 launches (float32 and float64, rank 1 and 4, dual /
    B-only / A-only, with and without a mask, shared and per-element
    sides and masks), a float32 bank mixing exact (0/1) and inexact sides
    bit for bit per element, bank K2 on config 2's group shapes bit for
    bit against bank K1 pass by pass and against per-element K2, bank K5
    on a config-4 layer over four 10-qubit density registers bit for bit
    against per-element K5, each within tolerance of (K5: equal to) its
    plain version; every bank call one launch."""
    n, nb = N_BATCH_PARITY, B_PARITY
    rng = np.random.default_rng(2468)
    out = {"n": n, "batch": nb, "k1_cases": 0, "k1_max_abs_err": 0.0,
           "k2": [], "k2_max_abs_err": 0.0}

    def one_launch(key, fn):
        before = fused.LAUNCHES[key]
        y = fn()
        check(fused.LAUNCHES[key] - before == 1,
              f"{key}: {fused.LAUNCHES[key] - before} launches, not 1")
        return y

    for dtype in (torch.float32, torch.float64):
        x = random_bank(torch, np, rng, n, nb, dtype)
        tol = tolerance(x)
        for rank in (1, 4):
            for sides in ("AB", "B", "A"):
                for with_mask in (False, True):
                    for per in (False, True):
                        op = bank_pass(rng, np, 10, rank, sides, with_mask,
                                       per, per and with_mask, nb)
                        y = one_launch("K1_bank", lambda: fused
                                       .apply_window_stack(
                                           x, op[2], op[3], op[6],
                                           num_qubits=n, k=op[1],
                                           apply_a=op[4], apply_b=op[5]))
                        for b in range(nb):
                            e = fused.bank_element_op(op, b)
                            check(torch.equal(y[b], k1_scalar(fused, x[b], e,
                                                              n)),
                                  f"bank K1 {dtype} R={rank} {sides} "
                                  f"mask={with_mask} per={per} element {b}:"
                                  " not its scalar launch's bits")
                        yp = k1_bank_plain(torch, fused, x, op, n)
                        err = float((y - yp).abs().max())
                        check(err <= tol, f"bank K1 {dtype}: |err| {err}")
                        out["k1_max_abs_err"] = max(out["k1_max_abs_err"],
                                                    err)
                        out["k1_cases"] += 1
        # K2 on config 2's group shapes, per-element sides and masks
        for label, spec in K2_BENCH_GROUPS.items():
            group = [bank_pass(rng, np, k, r, s, m, True, m, nb)
                     for k, r, s, m in spec]
            y2 = one_launch("K2_bank", lambda: fused
                            .apply_window_megastack(x, group,
                                                         num_qubits=n))
            y1 = x
            for op in group:
                y1 = fused.apply_window_stack(
                    y1, op[2], op[3], op[6], num_qubits=n, k=op[1],
                    apply_a=op[4], apply_b=op[5])
            check(torch.equal(y2, y1), f"bank K2 {dtype} {label}: not bank "
                  "K1 pass by pass")
            for b in range(nb):
                yb = fused.apply_window_megastack(
                    x[b], [fused.bank_element_op(op, b) for op in group],
                    num_qubits=n)
                check(torch.equal(y2[b], yb), f"bank K2 {dtype} {label} "
                      f"element {b}: not its own K2 launch's bits")
            err = float((y2 - k2_bank_plain(torch, fused, x, group, n))
                        .abs().max())
            check(err <= len(group) * tol, f"bank K2 {dtype}: |err| {err}")
            out["k2_max_abs_err"] = max(out["k2_max_abs_err"], err)
            out["k2"].append({"dtype": str(dtype).split(".")[-1],
                              "group": label, "passes": len(group),
                              "max_abs_err": err})
        del x
    # a float32 bank whose elements mix exact and inexact sides: each
    # element takes its own split and its scalar launch's bits
    x = random_bank(torch, np, rng, n, nb, torch.float32)
    mixed = []
    for sides in ("AB", "B"):
        op = bank_pass(rng, np, 9, 1, sides, False, True, False, nb,
                       exact=(0, 2))
        splits = fused.bank_pass_splits(
            torch.float32, "highest", nb,
            *[s for s, on in ((op[2], op[4]), (op[3], op[5])) if on])
        check(splits == (1, 0, 1, 0), f"mixed bank splits {splits}")
        y = one_launch("K1_bank", lambda: fused.apply_window_stack(
            x, op[2], op[3], None, num_qubits=n, k=9, apply_a=op[4],
            apply_b=op[5]))
        for b in range(nb):
            e = fused.bank_element_op(op, b)
            check(torch.equal(y[b], k1_scalar(fused, x[b], e, n)),
                  f"mixed bank {sides} element {b}: not its scalar bits")
            if b in (0, 2):
                check(torch.equal(y[b], fused.window_pass_plain(
                    x[b], e[2], e[3], None, num_qubits=n, k=9,
                    apply_a=e[4], apply_b=e[5])),
                      f"mixed bank {sides} element {b}: an exact element "
                      "is not its plain version's bits")
        mixed.append({"sides": sides, "splits": list(splits)})
    out["mixed_exact"] = mixed
    # one side per element, the other shared
    op = bank_pass(rng, np, 10, 1, "AB", False, True, False, nb)
    op = op[:3] + (op[3][0],) + op[4:]
    y = one_launch("K1_bank", lambda: fused.apply_window_stack(
        x, op[2], op[3], None, num_qubits=n, k=10))
    for b in range(nb):
        check(torch.equal(y[b], k1_scalar(fused, x[b],
                                          fused.bank_element_op(op, b), n)),
              f"bank K1, A per element and B shared, element {b}: not its "
              "scalar launch's bits")
    # K5 on a config-4 layer over four 10-qubit density registers
    nq = N_MEAS_RHO_PARITY
    nn = 2 * nq
    program = layer_program(nq)
    probs = [NOISE_P] * len(program)
    xr = random_bank(torch, np, rng, nn, nb, torch.float32)
    before = fused.LAUNCHES["K5_bank"]
    yb = fused.apply_pair_channel_sweep(xr.clone(), program, probs,
                                             num_bits=nn)
    k5n = fused.LAUNCHES["K5_bank"] - before
    check(k5n == k5_launches(fused, program, nn), f"bank K5: {k5n} launches")
    for b in range(nb):
        ys = fused.apply_pair_channel_sweep(xr[b].clone(), program, probs,
                                            num_bits=nn)
        check(torch.equal(yb[b], ys), f"bank K5 element {b}: not its own "
              "K5 launches' bits")
    check(torch.equal(yb, torch.stack([fused.pair_channel_sweep_plain(
        xr[b], program, probs, num_bits=nn) for b in range(nb)])),
        "bank K5 is not its plain version's bits")
    out["k5"] = {"state_bits": nn, "channels": len(program),
                 "launches": k5n, "bit_identical": True}
    sync()
    torch.cuda.empty_cache()
    return out


def bank_unitaries(np, circuits, n, nb, depth):
    """Element b's config-2 unitaries: bench_unitaries with seed 7 + b
    (element 0 is config 2 itself), as (depth, n, B, 2, 2) complex."""
    us = [circuits.bench_unitaries(n, depth, seed=SEED + b)
          for b in range(nb)]
    return np.stack([u[:, :, 0] + 1j * u[:, :, 1] for u in us], axis=2), us


def apply_bank_gates(qt, q, cus, n):
    """Config 2's structure on a bank: per-element 1q unitaries through
    applyBatchedUnitary, the CNOT ladder shared."""
    for d in range(cus.shape[0]):
        for t in range(n):
            qt.applyBatchedUnitary(q, (t,), cus[d, t])
        for t in range(d % 2, n - 1, 2):
            qt.controlledNot(q, t, t + 1)


def bank_breakdown(torch, C, program, n, nb, state=None):
    """Device time of each op of a drain's program on a bank (CUDA events
    around each op, one after another, from |0...0> or ``state``),
    summed by op kind; a register when ``nb`` is 0."""
    if state is None:
        shape = (nb, 2, 1 << n) if nb else (2, 1 << n)
        state = torch.zeros(shape, dtype=torch.float32, device=DEVICE)
        state[..., 0, 0] = 1.0
    run = C.execute_plan
    marks = []
    for kind, part in program:
        for op in part:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = run(state, [op], n)
            end.record()
            marks.append((op[0], start, end))
    sync()
    out: dict = {}
    for kind, start, end in marks:
        out[kind] = out.get(kind, 0.0) + start.elapsed_time(end)
    return out


def bank_bench_plan(np, C, circuits, us, n):
    """The bench route's plan of a bank: each element's config-2 gate list
    planned (for the card: megawin groups) and every pass array stacked
    to a leading (B, ...) axis; the elements must share one skeleton."""
    skeleton, per = None, []
    for u in us:
        sk, arrays = C.split_plan(C.plan_circuit(
            circuits.bench_gate_list(n, DEPTH, u), n, device=DEVICE))
        check(skeleton is None or sk == skeleton, "the bank's elements plan "
              "to different skeletons")
        skeleton = sk
        per.append(arrays)
    return C.rebuild_plan(skeleton, [
        np.stack([np.asarray(p[j]) for p in per]) for j in range(len(per[0]))])


def bank_items(qt, n, nb, fill, density=False):
    """The items a bank's drain sees, captured on a bank that never
    allocates amplitudes."""
    from quest_tpu_torch.batch import BatchedQureg

    shadow = BatchedQureg(n, qt.createQuESTEnv(device="cpu"), nb,
                          is_density_matrix=density, seeds=[0] * nb)
    fill(shadow)
    return list(shadow._fusion.gates)


def bank_op_cases(torch, fused, bank, ops, n, nb):
    """Bank K1 on a dual rank-1 pass with per-element sides and bank K2
    on the largest group of a bank plan uploaded to the card: the
    kernel's ms, its plain version's, the bound (B times a register's),
    a library yardstick (one batched torch.einsum, for K1) and the
    error against the plain version."""
    dual = next(op for op in ops if op[0] == "winfused" and op[4] and op[5]
                and op[2].dim() == 5 and op[2].shape[1] == 1)
    group = max((op[1] for op in ops if op[0] == "megawin"), key=len)
    state_bytes = bank[0].numel() * bank.element_size()
    num_amps = bank[0].numel() // 2

    def elem_bound(subops):
        ms, by = bound_ms([fused.bank_element_op(op, 0) for op in subops],
                          state_bytes, num_amps, "float32")
        return ms * nb, by

    def k1():
        return fused.apply_window_stack(
            bank, dual[2], dual[3], dual[6], num_qubits=n, k=dual[1],
            apply_a=True, apply_b=True)

    def k1_plain():
        return k1_bank_plain(torch, fused, bank, dual, n)

    hi, mid = 1 << (n - dual[1] - 7), 1 << (dual[1] - 7)
    xc = torch.complex(*bank.reshape(nb, 2, hi, 128, mid, 128).unbind(1))
    ac = torch.complex(dual[2][:, 0, 0], dual[2][:, 0, 1])
    bc = torch.complex(dual[3][:, 0, 0], dual[3][:, 0, 1])
    args, sub = (bc, xc, ac), "bqw,bhwml,bpl->bhqmp"
    if dual[6] is not None:
        m = dual[6]
        mc = torch.complex(m[:, 0], m[:, 1]) if m.dim() == 4 else \
            torch.complex(m[0], m[1])[None].expand(nb, -1, -1)
        args, sub = (*args, mc), "bqw,bhwml,bpl,bqp->bhqmp"

    def library():
        return torch.einsum(sub, *args)

    y = k1()
    err1 = float((y - k1_plain()).abs().max())
    check(err1 <= tolerance(bank), f"bank K1 at {n} qubits x {nb}: |err| "
          f"{err1}")
    lib = torch.view_as_real(library())
    lib_err = float((lib.permute(0, 5, 1, 2, 3, 4).reshape(y.shape) - y)
                    .abs().max())
    check(lib_err <= 10 * tolerance(bank), f"bank K1's einsum yardstick "
          f"strays {lib_err}")
    del y, lib
    b1, by1 = elem_bound([dual])
    k1_rec = {"ms": time_ms(k1), "plain_ms": time_ms(k1_plain, reps=3),
              "library_ms": time_ms(library, reps=5),
              "library_form": sub, "bound_ms": b1, "bound_by": by1,
              "max_abs_err": err1, "batch": nb, "n": n,
              "per_element_sides": True}
    k1_rec["fraction_of_bound"] = b1 / k1_rec["ms"]

    def k2():
        return fused.apply_window_megastack(bank, group, num_qubits=n)

    def k2_plain():
        return k2_bank_plain(torch, fused, bank, group, n)

    def k2_via_k1():
        y = bank
        for op in group:
            y = fused.apply_window_stack(
                y, op[2], op[3], op[6], num_qubits=n, k=op[1],
                apply_a=op[4], apply_b=op[5])
        return y

    y2 = k2()
    check(torch.equal(y2, k2_via_k1()), "bank K2 at the main shape: not "
          "bank K1 pass by pass")
    err2 = float((y2 - k2_plain()).abs().max())
    check(err2 <= len(group) * tolerance(bank), f"bank K2: |err| {err2}")
    del y2
    turns = [time_ms(f) for f in (k2_via_k1, k2, k2, k2_via_k1)]
    b2, by2 = elem_bound(group)
    k2_rec = {"ms": (turns[1] + turns[2]) / 2,
              "per_pass_k1_bank_ms": (turns[0] + turns[3]) / 2,
              "turns_k1_k2_k2_k1_ms": turns,
              "plain_ms": time_ms(k2_plain, reps=2), "library_ms": None,
              "bound_ms": b2, "bound_by": by2, "max_abs_err": err2,
              "passes": len(group), "batch": nb, "n": n}
    k2_rec["fraction_of_bound"] = b2 / k2_rec["ms"]
    return k1_rec, k2_rec


def phase_batch_main(torch, np, qt, C, fused, fusion, circuits, noise,
                     batch, calculations, measurement):
    """The bank slice on the card: (a) randomized compiling of config 2 at
    26 qubits x 8, (b) the EnsembleScheduler, (c) trajectories, (d) a
    density bank under a config-4 noise layer (see the module text)."""
    out = {}
    counts = {}
    env = qt.createQuESTEnv()

    # (a) randomized compiling: config 2's structure, each element its own
    # unitaries (seeds 7 .. 14), the CNOTs shared; by the bench route (the
    # elements' plans of the gate list, stacked, through
    # execute_plan on the bank: K1 and K2 bank) and by the API route (a
    # BatchedQureg drained: its CNOT ladders run as gathers between
    # one-layer dense runs, so K1 bank only, as the scalar API route)
    n, nb = N_BATCH_MAIN, B_MAIN
    cus, us = bank_unitaries(np, circuits, n, nb, DEPTH)
    t0 = time.perf_counter()
    bplan = bank_bench_plan(np, C, circuits, us, n)
    bench_plan_s = time.perf_counter() - t0
    bst = C.stats(bplan)
    bops = C.plan_to_device(bplan, torch.float32, DEVICE)
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    a = torch.zeros((nb, 2, 1 << n), dtype=torch.float32, device=DEVICE)
    a[:, 0, 0] = 1.0
    a = C.execute_plan(a, bops, n)
    sync()
    bench_wall = time.perf_counter() - t0
    got = bank_launches(fused)
    counts["a_bench"] = got
    check(got["K1_bank"] == bst["winfused"] and got["K2_bank"] == bst[
        "megawin"] and got["K1"] == got["K2"] == 0,
        f"bench-route bank launches {got} != one per pass of {bst}")
    check(got["K1_bank"] > 0 and got["K2_bank"] > 0,
          f"the bench-route bank launched no K1 or no K2: {got}")
    p_bench = [float(calculations.calc_prob_of_outcome_statevec(
        a[b], num_qubits=n, target=n - 1, outcome=0)) for b in range(nb)]
    for b in (0, nb - 1):
        sops = C.plan_to_device(C.plan_circuit(circuits.bench_gate_list(
            n, DEPTH, us[b]), n, device=DEVICE), torch.float32, DEVICE)
        z = torch.zeros((2, 1 << n), dtype=torch.float32, device=DEVICE)
        z[0, 0] = 1.0
        z = C.execute_plan(z, sops, n)
        check(torch.equal(z, a[b]), f"bench-route element {b} is not its "
              "scalar route bit for bit")
        del z, sops
    k1_rec, k2_rec = bank_op_cases(torch, fused, a, bops, n, nb)
    del a, bops
    torch.cuda.empty_cache()
    items = bank_items(qt, n, nb, lambda q: apply_bank_gates(qt, q, cus, n))
    fusion._plan_cache.clear()
    t0 = time.perf_counter()
    # a float32 bank on the card may sweep its channels: the drain's plan
    # key holds that, so the same key is planned here
    program = fusion.plan_items(items, n, device=DEVICE, sweep_ok=True,
                                batch_size=nb)
    plan_s = time.perf_counter() - t0
    pst = fusion.program_stats(program)
    seeds = [[MEASURE_SEEDS[0] + b] for b in range(nb)]
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    q = qt.createBatchedQureg(n, env, nb, seeds=seeds)
    apply_bank_gates(qt, q, cus, n)
    bank = q.amps
    sync()
    bank_wall = time.perf_counter() - t0
    got = bank_launches(fused)
    counts["a_api"] = got
    check(got["K1_bank"] == pst.get("winfused", 0)
          and got["K2_bank"] == pst.get("megawin", 0)
          and got["K1"] == got["K2"] == 0 and got["K1_bank"] > 0,
          f"API-route bank launches {got} != one per pass of {pst}")
    check(tuple(bank.shape) == (nb, 2, 1 << n)
          and bool(torch.isfinite(bank).all()), "bank: bad state")
    p_bank = [float(calculations.calc_prob_of_outcome_statevec(
        bank[b], num_qubits=n, target=n - 1, outcome=0)) for b in range(nb)]
    # every element's P(top = 0) equals its scalar route's; elements 0
    # and 7 are their scalar drains bit for bit
    scalar_walls = []
    for b in range(nb):
        sync()
        t0 = time.perf_counter()
        s = qt.createQureg(n, env)
        with qt.gateFusion(s):
            apply_bench_gates(qt, s, us[b], n)
        p = qt.calcProbOfOutcome(s, n - 1, 0)
        sync()
        scalar_walls.append(time.perf_counter() - t0)
        check(p == p_bank[b], f"element {b}: P(top = 0) {p} differs from "
              f"the bank's {p_bank[b]}")
        check(abs(p - p_bench[b]) <= 1e-5, f"element {b}: the API route's "
              f"P(top = 0) {p} vs the bench route's {p_bench[b]}")
        if b in (0, nb - 1):
            check(torch.equal(s.amps, bank[b]), f"element {b} is not its "
                  "scalar drain bit for bit")
        qt.destroyQureg(s, env)
    # where the API route's time goes: host gate calls, planning (above),
    # device time by op kind of the bank's program and of one element's
    t0 = time.perf_counter()
    bank_items(qt, n, nb, lambda q: apply_bank_gates(qt, q, cus, n))
    host_calls_s = time.perf_counter() - t0
    dev_bank = bank_breakdown(torch, C, program, n, nb)
    dev_one = bank_breakdown(torch, C, fusion.plan_items(
        capture_items(qt, us[0], n), n, device=DEVICE, sweep_ok=True), n, 0)
    main = {"n": n, "batch": nb, "depth": DEPTH, "bank_bytes":
            bank.numel() * bank.element_size(),
            "bench_route": {"plan": bst,
                            "plan_seconds_all_elements": bench_plan_s,
                            "wall_s": bench_wall, "p_top_zero": p_bench,
                            "launches": counts["a_bench"],
                            "elements_equal_scalar": [0, nb - 1]},
            "api_route": {"program": pst,
                          "plan_seconds_all_elements": plan_s,
                          "bank_drain_wall_s": bank_wall,
                          "scalar_drains_wall_s": sum(scalar_walls),
                          "scalar_drain_wall_s_each": scalar_walls,
                          "p_top_zero": p_bank, "launches": counts["a_api"],
                          "elements_equal_scalar": [0, nb - 1],
                          "host_gate_calls_s": host_calls_s,
                          "device_ms_by_op_bank": dev_bank,
                          "device_ms_bank": sum(dev_bank.values()),
                          "device_ms_by_op_one_element": dev_one,
                          "device_ms_one_element": sum(dev_one.values())},
            "k1_bank": k1_rec, "k2_bank": k2_rec}
    # measureBatched over every qubit, per-element seeds; elements 0 and 7
    # against measureWithStats loops seeded the same way
    t0 = time.perf_counter()
    outs = [qt.measureBatched(q, t) for t in range(n)]
    sync()
    main["measure_batched_ms_per_qubit"] = \
        (time.perf_counter() - t0) * 1e3 / n
    for b in (0, nb - 1):
        s = qt.createQureg(n, env)
        with qt.gateFusion(s):
            apply_bench_gates(qt, s, us[b], n)
        measurement.KEYS.seed(seeds[b])
        for t in range(n):
            o, p = qt.measureWithStats(s, t)
            check(o == int(outs[t][0][b]) and p == float(outs[t][1][b]),
                  f"element {b} qubit {t}: measureBatched ({outs[t][0][b]},"
                  f" {outs[t][1][b]}) vs measureWithStats ({o}, {p})")
        check(torch.equal(s.amps, q.amps[b]), f"element {b}: collapsed "
              "states differ")
        qt.destroyQureg(s, env)
    main["outcomes_0_7"] = [[int(o[0][b]) for o in outs] for b in (0, nb - 1)]
    qt.destroyQureg(q, env)
    del bank
    torch.cuda.empty_cache()
    out["randomized_compiling"] = main

    # (b) the EnsembleScheduler: 64 submissions of config 2's structure at
    # 20 qubits, one bucket of 64
    n = N_ENSEMBLE
    subs = [circuits.bench_gate_list(n, DEPTH, circuits.bench_unitaries(
        n, DEPTH, seed=100 + s)) for s in range(ENSEMBLE_SUBMISSIONS)]
    sched = qt.EnsembleScheduler(n, env, max_batch=ENSEMBLE_SUBMISSIONS)
    for g in subs:
        sched.submit(g)
    fusion._plan_cache.clear()
    items = batch.bank_gate_items(subs, n, False)
    t0 = time.perf_counter()
    eprog = fusion.plan_items(items, n, device=DEVICE, sweep_ok=True,
                              batch_size=ENSEMBLE_SUBMISSIONS)
    eplan_s = time.perf_counter() - t0
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = sched.drain()
    sync()
    ens_wall = time.perf_counter() - t0
    counts["b"] = bank_launches(fused)
    est = fusion.program_stats(eprog)
    check(counts["b"]["K1_bank"] == est.get("winfused", 0)
          and counts["b"]["K2_bank"] == est.get("megawin", 0)
          and counts["b"]["K1"] == 0, f"ensemble launches {counts['b']}")
    check(sched.last_drain["buckets"] == 1
          and sched.last_drain["padded"] == ENSEMBLE_SUBMISSIONS,
          f"ensemble buckets {sched.last_drain}")
    # the scalar loop runs last submission first: the plan cache (64
    # entries, first in first out) holds submissions 1 .. 63 after the
    # bank's planning, so only submission 0 plans again
    sync()
    t0 = time.perf_counter()
    loop = {}
    for i in reversed(range(ENSEMBLE_SUBMISSIONS)):
        s = qt.createQureg(n, env)
        with qt.gateFusion(s):
            s._fusion.gates.extend(subs[i])
        loop[i] = s.amps
    sync()
    loop_wall = time.perf_counter() - t0
    sampled = sorted({0, ENSEMBLE_SUBMISSIONS // 3,
                      2 * ENSEMBLE_SUBMISSIONS // 3,
                      ENSEMBLE_SUBMISSIONS - 1})
    for s in sampled:
        check(torch.equal(res[s], loop[s]), f"ensemble submission {s} "
              "differs from its independent run")
    dev_bank = bank_breakdown(torch, C, eprog, n, ENSEMBLE_SUBMISSIONS)
    dev_one = bank_breakdown(torch, C, fusion.plan_items(
        subs[0], n, device=DEVICE, sweep_ok=True), n, 0)
    out["ensemble"] = {"n": n, "submissions": ENSEMBLE_SUBMISSIONS,
                       "device_ms_by_op_bank": dev_bank,
                       "device_ms_bank": sum(dev_bank.values()),
                       "device_ms_by_op_one_circuit": dev_one,
                       "device_ms_one_circuit": sum(dev_one.values()),
                       "program": est, "plan_seconds_all_elements": eplan_s,
                       "drain_wall_s": ens_wall,
                       "wall_ms_per_circuit": ens_wall * 1e3
                       / ENSEMBLE_SUBMISSIONS,
                       "scalar_loop_wall_s": loop_wall,
                       "scalar_loop_ms_per_circuit": loop_wall * 1e3
                       / ENSEMBLE_SUBMISSIONS,
                       "last_drain": sched.last_drain,
                       "checked_equal": sampled,
                       "launches": counts["b"]}
    del res, loop
    torch.cuda.empty_cache()

    # (c) trajectories
    out["trajectories"] = phase_trajectories(torch, np, qt, C, fused,
                                             circuits, counts)

    # (d) a density bank under one config-4 noise layer
    nq, nbr = N_RHO_BANK, B_RHO
    kops = noise.bench_kraus_ops(NOISE_SEED)
    rng = np.random.default_rng(77)
    mats = np.stack([random_unitary(rng, 2) for _ in range(nbr)])
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    rq = qt.createBatchedQureg(nq, env, nbr, is_density_matrix=True)
    qt.initPlusState(rq)
    qt.applyBatchedUnitary(rq, (2,), mats)
    noise.noise_layer(qt, rq, nq, kops, prob=NOISE_P)
    rbank = rq.amps
    sync()
    rwall = time.perf_counter() - t0
    counts["d"] = bank_launches(fused)
    per_layer = k5_launches(fused, layer_program(nq), 2 * nq)
    check(counts["d"]["K5_bank"] == per_layer and counts["d"]["K5"] == 0,
          f"density bank: K5 launches {counts['d']}, not {per_layer} bank "
          "launches")
    for b in range(nbr):
        s = qt.createDensityQureg(nq, env)
        qt.initPlusState(s)
        with qt.gateFusion(s):
            qt.unitary(s, 2, mats[b])
            noise.noise_layer(qt, s, nq, kops, prob=NOISE_P)
        check(torch.equal(s.amps, rbank[b]), f"density bank element {b} is "
              "not its scalar drain bit for bit")
        qt.destroyQureg(s, env)
    k5_rec = bank_k5_case(torch, fused, rbank, nq)
    out["density_bank"] = {"n": nq, "batch": nbr, "state_bits": 2 * nq,
                           "launches": counts["d"],
                           "k5_bank_launches_per_layer": per_layer,
                           "drain_wall_s": rwall, "k5_bank": k5_rec}
    qt.destroyQureg(rq, env)
    del rbank
    torch.cuda.empty_cache()
    return out, counts


def bank_k5_case(torch, fused, rbank, nq):
    """Bank K5 on the first launch group of a config-4 layer's first
    sweep at the density bank's shape: ms, plain ms (element by element),
    the bound (one read and write of the bank) and the error."""
    nn = 2 * nq
    program = layer_program(nq)
    b0, k, entries = fused.sweep_schedule(program, nn)[0]
    group = fused.sweep_launch_groups(entries)[0]
    sub = tuple(program[e[3]] for e in group[0])
    probs = [NOISE_P] * len(sub)
    check(k5_launches(fused, sub, nn) == 1, "the timed K5 group is not one "
          "launch")
    x = rbank.clone()

    def kern():
        return fused.apply_pair_channel_sweep(x, sub, probs,
                                                   num_bits=nn)

    def plain():
        return torch.stack([fused.pair_channel_sweep_plain(
            x[b], sub, probs, num_bits=nn) for b in range(x.shape[0])])

    want = plain()
    err = max_abs_diff(torch, kern(), want)   # in place on the card
    check(err == 0.0, f"bank K5 at the main shape: |err| {err}")
    del want
    nbytes = 2 * x.numel() * x.element_size()
    return {"ms": time_ms(kern), "plain_ms": time_ms(plain, reps=3),
            "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "max_abs_err": err,
            "channels": len(sub), "batch": int(x.shape[0])}


def traj_ops(np, C, circuits, n):
    """A depth-2 config-2 circuit (shared gates) with depolarising
    p = 0.05 on every qubit after the second layer's unitaries, and
    damping on qubit 0 at the end.  The insertions sit where each merges
    with its qubit's unitary: placed after the CNOTs, a trajectory whose
    insertions on neighbouring qubits are two X's plans a permutation run
    where another plans a dense pass, and the bank drain refuses the
    mixed skeletons, in the reference as in the port (ROADMAP Queue 3)."""
    gates = circuits.bench_gate_list(n, 2, circuits.bench_unitaries(
        n, 2, seed=SEED, dtype=np.float64))
    last = max(i for i, g in enumerate(gates) if len(g.targets) == 1)
    return (gates[:last + 1] + [("depolarising", t, TRAJ_P)
                                for t in range(n)]
            + gates[last + 1:] + [("damping", 0, TRAJ_DAMP)])


def phase_trajectories(torch, np, qt, C, fused, circuits, counts):
    """256 trajectories at 20 qubits: every trajectory's norm within 1e-5
    of 1 and the bank launches; 4096 at 8 qubits: the Z-sum observable's
    mean within 5 SEM of the density-matrix expectation."""
    env = qt.createQuESTEnv()
    out = {}
    n = N_TRAJ
    ops = traj_ops(np, C, circuits, n)
    codes = np.zeros((n, n), np.int32)
    codes[np.arange(n), np.arange(n)] = 3
    coeffs = np.ones(n) / n
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = qt.run_trajectories(ops, n, env, TRAJ_BIG, seed=SEED)
    bank = res["amps"]
    norms = torch.sum(bank.double() ** 2, dim=(1, 2))
    sync()
    wall = time.perf_counter() - t0
    counts["c"] = bank_launches(fused)
    worst = float((norms - 1).abs().max())
    check(worst <= 1e-5, f"a trajectory's norm strays {worst}")
    check(counts["c"]["K1_bank"] + counts["c"]["K2_bank"] > 0
          and counts["c"]["K1"] == counts["c"]["K2"] == 0,
          f"trajectories launches {counts['c']}")
    out["big"] = {"n": n, "trajectories": TRAJ_BIG, "wall_s": wall,
                  "max_norm_err": worst, "launches": counts["c"]}
    del bank, res
    torch.cuda.empty_cache()
    n = N_TRAJ_SMALL
    ops = traj_ops(np, C, circuits, n)
    codes = np.zeros((n, n), np.int32)
    codes[np.arange(n), np.arange(n)] = 3
    coeffs = np.ones(n) / n
    sync()
    t0 = time.perf_counter()
    res = qt.run_trajectories(ops, n, env, TRAJ_SMALL,
                              observable=(codes, coeffs), seed=SEED)
    wall = time.perf_counter() - t0
    qt.set_precision(2)
    try:
        rho = qt.createDensityQureg(n, env)
        for op in ops:
            if isinstance(op, C.Gate):
                m = np.asarray(op.mat, np.float64)
                if len(op.targets) == 1:
                    qt.unitary(rho, op.targets[0], m[0] + 1j * m[1])
                else:
                    qt.controlledNot(rho, op.targets[0], op.targets[1])
            elif op[0] == "depolarising":
                qt.mixDepolarising(rho, op[1], op[2])
            else:
                qt.mixDamping(rho, op[1], op[2])
        h = qt.createPauliHamil(n, n)
        qt.initPauliHamil(h, coeffs, codes)
        exact = qt.calcExpecPauliHamil(rho, h)
    finally:
        qt.set_precision(1)
    check(abs(res["mean"] - exact) <= 5 * res["sem"],
          f"trajectory mean {res['mean']} vs density {exact} "
          f"(sem {res['sem']})")
    out["small"] = {"n": n, "trajectories": TRAJ_SMALL, "wall_s": wall,
                    "mean": res["mean"], "sem": res["sem"],
                    "density_expectation": exact,
                    "mean_minus_exact_over_sem": (res["mean"] - exact)
                    / res["sem"]}
    return out


# ---------------------------------------------------------------------------
# The VQE and QAOA models (M14)
# ---------------------------------------------------------------------------

N_VQE = 20
VQE_DEPTH, VQE_TERMS, VQE_SEED, VQE_LR = 3, 6, 11, 5e-2
N_QAOA = 24
QAOA_DEPTH = 3
MODEL_STEPS = 10


def phase_models_main(torch, np):
    """VQE as examples/vqe_train.py builds it at 20 qubits (float64): ten
    Adam steps, the energy falls, the autograd gradient on three
    parameters within 1e-3 relative of central differences; QAOA as
    examples/qaoa_maxcut.py builds it at 24 qubits (float32): ten steps,
    the expected cut rises; the wall per step and the peak memory of
    both."""
    from quest_tpu_torch.models import qaoa, vqe

    out = {}
    codes, coeffs = vqe.random_hamiltonian(N_VQE, VQE_TERMS, seed=VQE_SEED)
    model = vqe.VQE(N_VQE, VQE_DEPTH, codes, coeffs)
    gen = torch.Generator().manual_seed(0)
    p = model.init_params(gen, dtype=torch.float64)
    # the gradient against central differences at the three parameters
    # of largest gradient (where a relative error means something)
    p0 = p.clone().requires_grad_(True)
    model.energy(p0).backward()
    grad = p0.grad
    fd = []
    for i in torch.argsort(grad.abs(), descending=True)[:3].tolist():
        h = 1e-5
        e = torch.zeros_like(p)
        e[i] = h
        with torch.no_grad():
            d = (float(model.energy(p + e)) - float(model.energy(p - e))) \
                / (2 * h)
        rel = abs(float(grad[i]) - d) / max(abs(d), 1e-12)
        check(rel <= 1e-3, f"VQE gradient {i}: autograd {float(grad[i])} "
              f"vs central difference {d}")
        fd.append({"param": i, "autograd": float(grad[i]), "central": d,
                   "rel_err": rel})
    out["vqe"] = train_record(torch, model, p, model.make_train_step,
                              falls=True)
    out["vqe"].update(n=N_VQE, depth=VQE_DEPTH, terms=VQE_TERMS,
                      dtype="float64", gradient_check=fd)
    edges = qaoa.random_graph(N_QAOA, 2 * N_QAOA, seed=1)
    qm = qaoa.QAOA(N_QAOA, edges, QAOA_DEPTH)
    qp = qm.init_params(gen, dtype=torch.float32)
    out["qaoa"] = train_record(torch, qm, qp, qm.make_train_step,
                               falls=False)
    out["qaoa"].update(n=N_QAOA, depth=QAOA_DEPTH, edges=len(edges),
                       dtype="float32")
    return out


def train_record(torch, model, p, make_step, falls: bool):
    """MODEL_STEPS Adam steps at VQE_LR from ``p``: the objective at each
    step, the wall per step, the peak device memory."""
    p = p.clone().requires_grad_(True)
    step = make_step(torch.optim.Adam([p], lr=VQE_LR))
    sync()
    torch.cuda.reset_peak_memory_stats()
    vals, walls = [], []
    for _ in range(MODEL_STEPS):
        t0 = time.perf_counter()
        vals.append(float(step(p)))
        sync()
        walls.append(time.perf_counter() - t0)
    moved = vals[-1] < vals[0] if falls else vals[-1] > vals[0]
    check(moved, f"{type(model).__name__}: the objective did not "
          f"{'fall' if falls else 'rise'}: {vals}")
    return {"objective": vals, "wall_s_per_step": statistics.median(walls),
            "first_step_wall_s": walls[0],
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


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
        from quest_tpu_torch.models import circuits, hamiltonians, noise
        from quest_tpu_torch import batch
        from quest_tpu_torch.ops import (bigstate, build, calculations, cplx,
                                         density, fused, kernels,
                                         measurement, paulis, threefry)
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
    # the paged routes' final states are held against this one (phase 16)
    psi_windowed = a.cpu()
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
    launches = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
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
    # F1: a pass of cross diagonals only (a mask), drained under
    # gateFusion, against the eager route
    mask_only = mask_only_drain(torch, qt, fused, fusion, n)
    emit({"phase": "main", "n": n, "depth": DEPTH, "gates": len(gates),
          "mask_only_drain": mask_only,
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
    groups = [op[1] for op in ops if op[0] == "megawin"]
    check([len(g) for g in groups] == [2, 2, 5],
          f"the bench plan's megawin groups changed: {groups}")

    def k1(op):
        return lambda: fused.apply_window_stack(
            x, op[2], op[3], op[6], num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5])

    def plain1(op):
        return lambda: fused.window_pass_plain(
            x, op[2], op[3], op[6], num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5])

    def library(op):
        """Single torch.einsum calls on the complex views computing the
        same function as the pass, {subscripts: call}, in both operand
        orders (B.X first, X.A first) where the pass has both sides:
        yardsticks only, the port never calls them."""
        hi = 1 << (n - op[1] - 7)
        mid = 1 << (op[1] - 7)
        xc = cplx.to_complex(x.reshape(2, hi, 128, mid, 128))
        ac = torch.complex(op[2][0, 0], op[2][0, 1])
        bc = torch.complex(op[3][0, 0], op[3][0, 1])
        mc = None if op[6] is None else torch.complex(op[6][0], op[6][1])
        if op[4]:
            forms = {"qw,hwml,pl": (bc, xc, ac), "hwml,pl,qw": (xc, ac, bc)}
            out_s, m_s = "hqmp", "qp"
        else:
            forms = {"qw,hwml": (bc, xc)}
            out_s, m_s = "hqml", "ql"
        calls = {}
        for sub, args in forms.items():
            if mc is not None:
                sub, args = f"{sub},{m_s}", (*args, mc)
            sub = f"{sub}->{out_s}"
            calls[sub] = lambda sub=sub, args=args: torch.einsum(sub, *args)
        return calls

    def time_k1(op, dtype_name):
        b_ms, b_by = bound_ms([op], x.numel() * x.element_size(), num_amps,
                              dtype_name)
        # the kernel against its plain version at the main path's shape
        y = k1(op)()
        err = float((y - plain1(op)()).abs().max())
        check(err <= tolerance(x), f"K1 at {n} qubits, {dtype_name}, "
              f"k={op[1]}: |err| {err}")
        lib_ms, lib_form, lib_forms = library_time(
            torch, cplx, y, library(op), tolerance(x), f"K1 {dtype_name}")
        # how far the kernel moves the norm, against the pass in float64
        y64 = fused.window_pass_plain(
            x.double(), *(t.double() if torch.is_tensor(t) else t
                          for t in op[2:4]),
            None if op[6] is None else op[6].double(), num_qubits=n,
            k=op[1], apply_a=op[4], apply_b=op[5])
        norm_shift = float(torch.sum(y.double() ** 2) - torch.sum(y64 ** 2))
        del y, y64
        ms = time_ms(k1(op))
        return {"k": op[1], "mask": op[6] is not None, "dtype": dtype_name,
                "max_abs_err": err, "extra_mem_bytes": extra_bytes(k1(op)),
                "ms": ms, "plain_ms": time_ms(plain1(op), reps=5),
                "library_ms": lib_ms, "library_form": lib_form,
                "library_forms_ms": lib_forms,
                "ms_over_library_ms": ms / lib_ms,
                "norm_shift_vs_f64": norm_shift,
                "bound_ms": b_ms, "bound_by": b_by}

    timing = {"k1_dual_rank1": time_k1(dual, "float32"),
              "k1_b_only_rank1": time_k1(bonly, "float32")}
    # the card's clocks and power while K1 runs back to back
    timing["k1_dual_rank1"]["under_load"] = smi_under_load(
        torch, k1(dual), seconds=2.0)
    # K2 on each of the bench plan's groups (A, B: G = 1; C: G = 8)
    timing["k2_groups"] = {
        label: time_k2_group(torch, C, fused, x, g, n, "float32")
        for label, g in zip("ABC", groups)}
    timing["k2_largest_group"] = timing["k2_groups"]["C"]
    # K2 on one pass (one ticket stream, no dependencies) against K1
    timing["k2_one_pass"] = {
        "dual": time_k2_group(torch, C, fused, x, [dual], n, "float32"),
        "b_only": time_k2_group(torch, C, fused, x, [bonly], n, "float32")}
    # the card's clocks and power while group C runs back to back, through
    # K1 pass by pass and through K2
    timing["k2_groups"]["C"]["under_load"] = {
        "k1": smi_under_load(torch, lambda: C.execute_plan(x, groups[2], n),
                             seconds=2.0),
        "k2": smi_under_load(torch, lambda: fused.apply_window_megastack(
            x, groups[2], num_qubits=n), seconds=2.0)}
    # the same dual-side pass in float64 (1 GB state), on the FP64 rate,
    # and group C
    x = x.double()
    timing["k1_dual_rank1_f64"] = time_k1(
        tuple(t.double() if torch.is_tensor(t) else t for t in dual),
        "float64")
    timing["k2_group_c_f64"] = time_k2_group(
        torch, C, fused, x,
        [tuple(t.double() if torch.is_tensor(t) else t for t in op)
         for op in groups[2]], n, "float64")
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

    # 9. the QFT kernels against their plain versions (and K1 at 2^30)
    qparity = phase_qft_parity(torch, np, fused, bigstate, C)
    emit({"phase": "qft_parity", **qparity})

    # 10. bench.py config 3 at 30 qubits, and a 15-qubit density register
    qmain, qft_counts, rho_counts = phase_qft_main(torch, np, qt, C, fused,
                                                   bigstate, circuits)
    emit({"phase": "qft_main", **qmain})
    for key in ("K8", "K9", "K10"):
        check(qft_counts[key] > 0, f"{key} never launched on the QFT path")
        launches[key] = qft_counts[key]
    for key in ("K6", "K7"):
        check(rho_counts[key] > 0, f"{key} never launched on the density "
              "QFT path")
        launches[key] = rho_counts[key]

    # 11. QFT timing at 30 qubits
    qtiming = phase_qft_timing(torch, np, qt, C, fused, bigstate)
    emit({"phase": "qft_timing", "power": smi, **qtiming})

    # 12. K5 against its plain version
    cparity = phase_channel_parity(torch, np, fused)
    emit({"phase": "channel_parity", **cparity})

    # 13. bench.py config 4 at 14 qubits (K5) and 15 (per channel)
    nmain, noise_counts = phase_noise_main(torch, np, qt, fused, fusion,
                                           noise, circuits)
    emit({"phase": "noise_main", **nmain})
    check(noise_counts["K5"] > 0, "K5 never launched on the noise path")
    launches["K5"] = noise_counts["K5"]

    # 14. noise timing
    ntiming = phase_noise_timing(torch, np, qt, fused, noise, kernels,
                                 density)
    emit({"phase": "noise_timing", "power": smi, **ntiming})

    # 15. K11 and K12 against their plain versions
    gparity = phase_paged_parity(torch, np, fused, C)
    emit({"phase": "paged_parity", **gparity})

    # 16. config 2 at 26 qubits through the paged planner
    gmain, gops, gprogram, gus = phase_paged_main(
        torch, qt, C, fused, fusion, circuits, p_bench, psi_windowed)
    del psi_windowed
    emit({"phase": "paged_main", **gmain})
    for key in ("K11", "K12"):
        launches[key] = (gmain["launches_bench"][key]
                         + gmain["launches_api"][key])

    # 17. paged timing at 26 qubits
    gtiming = phase_paged_timing(torch, qt, C, fused, circuits, cplx, gops,
                                 gprogram, gus)
    emit({"phase": "paged_timing", "power": smi, **gtiming})
    del gops, gprogram
    torch.cuda.empty_cache()

    # 18. the seeded measurement streams on the card
    mparity = phase_measure_parity(torch, np, qt, measurement, threefry)
    emit({"phase": "measure_parity", **mparity})

    # 19. config 2's circuit at 26 qubits, measured in full; a density
    # register and shot sampling
    mmain, meas_k1 = phase_measure_main(
        torch, np, qt, fused, paulis, bigstate, noise, us,
        ast.get("winfused", 0), ast.get("megawin", 0))
    emit({"phase": "measure_main", **mmain})

    # 20. measurement timing at 26 qubits
    mtiming = phase_measure_timing(torch, qt, us, measurement)
    emit({"phase": "measure_timing", "power": smi, **mtiming})

    # 21. K1, K2, K11 and K12 under the reference's lower precisions
    pparity_modes = phase_precision_parity(torch, np, fused, C)
    emit({"phase": "precision_parity", **pparity_modes})

    # 22. config 2 at 26 qubits under each lower precision
    pmodes = phase_precision_main(torch, np, qt, C, fused, fusion, circuits,
                                  plan, us, p_bench)
    emit({"phase": "precision_main", "power": smi, **pmodes})

    # 23. DiagonalOp and the phase functions at 30 qubits
    dmain = phase_diagonal_main(torch, np, qt)
    emit({"phase": "diagonal_main", "power": smi, **dmain})

    # 24. quad precision: config 2 at 26 qubits under set_precision(4)
    quad = phase_quad_main(torch, np, qt, paulis, hamiltonians, circuits)
    emit({"phase": "quad_main", "power": smi, **quad})

    # 25. the bank kernels against their scalar launches and plain versions
    bparity = phase_batch_parity(torch, np, fused)
    emit({"phase": "batch_parity", **bparity})

    # 26. register banks: randomized compiling at 26 qubits x 8, the
    # ensemble scheduler, trajectories, a density bank
    bmain, bcounts = phase_batch_main(torch, np, qt, C, fused, fusion,
                                      circuits, noise, batch, calculations,
                                      measurement)
    emit({"phase": "batch_main", "power": smi, **bmain})
    for key in ("K1_bank", "K2_bank"):
        launches[key] = bcounts["a_bench"][key] + bcounts["a_api"][key]
    launches["K5_bank"] = bcounts["d"]["K5_bank"]

    # 27. the VQE and QAOA models
    models = phase_models_main(torch, np)
    emit({"phase": "models_main", "power": smi, **models})

    # 28. kernels
    def entry(kname, replaces, t, err, source="window.cu", key=None):
        key = key or kname.split()[0]
        return {"name": kname, "route": "cuda",
                "source": f"quest_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key],
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
    k1e["f64_dual"] = timing["k1_dual_rank1_f64"]
    k1e["ms_over_library_ms"] = timing["k1_dual_rank1"]["ms_over_library_ms"]
    k2e = entry("K2 window megakernel", "quest_tpu/ops/fused.py:799",
                timing["k2_largest_group"],
                max(*(g["max_abs_err"] for g in timing["k2_groups"].values()),
                    *(g["max_abs_err_vs_plain"] for g in parity["k2"])))
    k2e["groups"] = timing["k2_groups"]
    k2e["group_c_f64"] = timing["k2_group_c_f64"]
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
    # K1 on the QFT path: its launches there and its times at 2^30
    k1e["qft"] = {"launches": qft_counts["K1"] + rho_counts["K1"],
                  "passes_2e30": qtiming["k1"],
                  "max_abs_err_2e30": max(c["max_abs_err"]
                                          for c in qparity["k1"])}
    # K1 on the measurement path (measure_main): the circuit's drain
    k1e["measure"] = {"launches": meas_k1,
                      "shots_launches": mmain["shots"]["k1_launches"]}
    # K1/K2 in the 14-qubit drain of gates and noise
    k1e["noise"] = {"launches": nmain["gates_and_noise"]["launches"]["K1"]}
    k2e["noise"] = {"launches": nmain["gates_and_noise"]["launches"]["K2"]}
    k5e = entry("K5 pair-channel sweep", "quest_tpu/ops/fused.py:1440",
                ntiming["k5_sweeps"][0], cparity["max_abs_err"],
                "channels.cu")
    k5e["kernel"] = "chan_sweep_kernel"
    k5e["per_sweep"] = ntiming["k5_sweeps"]
    k5e["library_note"] = ("none: no single PyTorch call applies a "
                           "pair-channel sweep")
    k8 = qtiming["k8"]
    k8t = {f: sum(c[f] for c in k8) / len(k8)
           for f in ("ms", "plain_ms", "bound_ms")}
    k8t.update(bound_by=k8[0]["bound_by"], library_ms=None)
    qerr = qparity["max_abs_err"]
    k6e = entry("K6 QFT ladder layer t >= 14", "quest_tpu/ops/fused.py:887",
                qtiming["k6"], qerr, "qft.cu")
    k7e = entry("K7 QFT ladder layer 7 <= t <= 13",
                "quest_tpu/ops/fused.py:1003", qtiming["k7"][0], qerr,
                "qft.cu")
    k7e["t7"] = qtiming["k7"][1]
    k8e = entry("K8 QFT multi-layer ladder pass",
                "quest_tpu/ops/fused.py:1127", k8t, qerr, "qft.cu")
    k8e["per_chunk"] = k8
    k9e = entry("K9 QFT sublane-layers pass", "quest_tpu/ops/fused.py:1228",
                qtiming["k9"], qerr, "qft.cu")
    k10e = entry("K10 sigma swap", "quest_tpu/ops/bigstate.py:108",
                 qtiming["k10"], qerr, "qft.cu")
    k6e["kernel"] = k8e["kernel"] = "qft_hi_kernel"
    k7e["kernel"] = k9e["kernel"] = "qft_sublane_kernel"
    k10e["kernel"] = "sigma_swap_kernel"
    for e in (k6e, k7e, k8e, k9e):
        e["library_note"] = "none: no single PyTorch call computes a ladder"
    k10e["library_note"] = ("the same permutation by permute(...)"
                            ".contiguous(), out of place")
    k11e = entry("K11 cluster pass", "quest_tpu/ops/fused.py:543",
                 gtiming["k11_rank1"],
                 max(*gparity["k11_max_abs_err"].values(),
                     gtiming["k11_rank1"]["max_abs_err"],
                     gtiming["k11_rank4"]["max_abs_err"]))
    k11e["kernel"] = "window_pass_kernel"
    k11e["rank4"] = gtiming["k11_rank4"]
    k11e["ms_over_library_ms"] = gtiming["k11_rank1"]["ms_over_library_ms"]
    k12e = entry("K12 segment swap + cluster pass",
                 "quest_tpu/ops/fused.py:271", gtiming["k12_rank1"],
                 max(*gparity["k12_max_abs_err"].values(),
                     gtiming["k12_rank1"]["max_abs_err"],
                     gtiming["k12_rank4"]["max_abs_err"]))
    k12e["kernel"] = "swap_cluster_kernel"
    k12e["rank4"] = gtiming["k12_rank4"]
    k12e["ms_over_library_ms"] = gtiming["k12_rank1"]["ms_over_library_ms"]
    for e in (k11e, k12e):
        e["library_note"] = ("the fastest of the single torch.einsum forms "
                             "on complex views (library_form)")
    # each window kernel under the lower precisions: its launches on the
    # main path's routes, its time, bound and error at the main path's
    # shapes, its worst error in the parity checks
    for e, key, label in ((k1e, "K1", "k1_dual_rank1"),
                          (k2e, "K2", "k2_group_c"),
                          (k11e, "K11", "k11_rank1"),
                          (k12e, "K12", "k12_rank1")):
        e["modes"] = {}
        for mode, rec in pmodes["modes"].items():
            par = pparity_modes["modes"][mode]
            worst = {"K1": par["k1_max_abs_err"],
                     "K2": max(c["max_abs_err"] for c in par["k2"]),
                     "K11": par["k11_max_abs_err"],
                     "K12": par["k12_max_abs_err"]}[key]
            e["modes"][mode] = {
                "launches": (rec["launches_bench"].get(key, 0)
                             + rec["launches_api"].get(key, 0)),
                "ms": rec["kernels"][label]["ms"],
                "bound_ms": rec["kernels"][label]["bound_ms"],
                "bound_by": rec["kernels"][label]["bound_by"],
                "max_abs_err": max(worst,
                                   rec["kernels"][label]["max_abs_err"])}
        if key == "K1":
            for mode, rec in pmodes["modes"].items():
                e["modes"][mode]["b_only"] = rec["kernels"]["k1_b_only_rank1"]
    # the bank forms: one launch per pass for a whole register bank, their
    # launches on randomized compiling's drain (K1, K2) and on the density
    # bank's (K5), their times at those banks' shapes
    rc = bmain["randomized_compiling"]
    k1b = entry("K1 window pass, bank form", "quest_tpu/ops/fused.py:497",
                rc["k1_bank"], max(rc["k1_bank"]["max_abs_err"],
                                   bparity["k1_max_abs_err"]),
                key="K1_bank")
    k1b["kernel"] = "window_pass_kernel"
    k1b["batch"] = rc["batch"]
    k1b["library_form"] = rc["k1_bank"]["library_form"]
    k2b = entry("K2 window megakernel, bank form",
                "quest_tpu/ops/fused.py:799", rc["k2_bank"],
                max(rc["k2_bank"]["max_abs_err"], bparity["k2_max_abs_err"]),
                key="K2_bank")
    k2b["kernel"] = "megawin_kernel"
    k2b["batch"] = rc["batch"]
    k2b["per_pass_k1_bank_ms"] = rc["k2_bank"]["per_pass_k1_bank_ms"]
    k2b["library_note"] = "none: no single PyTorch call runs a group"
    db = bmain["density_bank"]
    k5b = entry("K5 pair-channel sweep, bank form",
                "quest_tpu/ops/fused.py:1440", db["k5_bank"],
                db["k5_bank"]["max_abs_err"], "channels.cu", key="K5_bank")
    k5b["kernel"] = "chan_sweep_kernel"
    k5b["batch"] = db["batch"]
    k5b["library_note"] = ("none: no single PyTorch call applies a "
                           "pair-channel sweep")
    for e in (k1b, k2b, k5b):
        check(e["launches"] > 0, f"{e['name']} never launched on its path")
    emit({"kernels": [k1e, k2e, k3e, k4e, k5e, k6e, k7e, k8e, k9e, k10e,
                      k11e, k12e, k1b, k2b, k5b]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
