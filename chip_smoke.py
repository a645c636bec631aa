#!/usr/bin/env python3
"""Drive quest_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
line:

1. device  - the card's name and power limit; a CUDA device is required.
2. build   - nvcc builds csrc/window.cu (K1, K2, K11, K12: tensor-core
             products, TF32 split at float32 or the lower modes' bf16 and
             TF32 products, DMMA at float64),
             csrc/paulis.cu (K3, K4), csrc/channels.cu (K5),
             csrc/qft.cu (K6-K10) and csrc/probes.cu (P1, the HBM stream
             pass) into one library, one nvcc process per source.
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
             (28, 7), its reversal form at REV_PARITY.  K1 on every window
             pass of the 30-qubit QFT's plan and of the old route's (the
             lane fold, three B-only reversal passes) at 2^30 amplitudes
             (bit for bit where the pass is a permutation, within 1e-5
             max|psi| otherwise).
10. qft_main - bench.py config 3 at 30 qubits, float32: two
             circuit.fused_qft from |0...0> (amp_0 back at 1 within 1e-5;
             launches per QFT as the plan says: K8 4, K9 1, K1 1 (the
             A-only lane pass), K10's reversal form 1, sigma 0);
             QFT|x> against e^{2 pi i x y / 2^n} / 2^{n/2} at 4096 sampled
             y; applyFullQFT on a random state against torch.fft.ifft
             within 1e-5 max|psi|; the route bit for bit against the same
             route through the plain versions of K6-K10; at 26 qubits
             against a float64 FFT; applyFullQFT on a 15-qubit density
             register (K6 once, K7 seven times) bit for bit against its
             plain route, calcTotalProb within 1e-4 of 1.
11. qft_timing - CUDA-event medians of K8 (each chunk), K9, K6, K7, K10
             and K1's A-only lane pass and the old route's two pass kinds
             at 2^30 amplitudes against their bounds, plain versions and
             library yardsticks (torch.fft for the whole QFT); wall time
             and busy share of fused_qft and applyFullQFT (a trace whose
             K8 count is not 4 is taken again, at most three times; each
             try's count is reported).
11b. qft_reversal - K10's reversal form torch.equal to the old route's
             plan (four K1 passes and sigma, launched once each from
             counts of 0) at 30 and 31 qubits and on a bank of 2 x
             30 (one K10_rev_bank launch); applyFullQFT at 30 qubits (K8
             4, K9 1, K1 1, K10_rev 1) bit for bit against K8, K9, the
             lane pass and the old plan, and within 1e-5 max|psi| of the
             old route; CUDA-event medians of the reversal form beside its
             bytes bound, sigma, its plain version, one torch.index_select
             by the reversed index (held to it first) and the old plan;
             the A-only lane pass beside the dual lane fold; the whole
             QFT by both routes.
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
28. dist_parity - on an in-process mesh of 8 shards on the card, at 26
             qubits (nloc = 23), float32: the half-shard swap, the
             composed shard permute and a remap with every class, each
             with 1 and 8 exchange chunks, torch.equal to the same bit
             permutation by gather -> permute_qubits -> split; one
             shard's K1 on the passes config 2's sharded plan holds there
             against its plain version (0/1 permutation passes bit for
             bit) and K2 on its groups bit for bit against K1 pass by pass.
29. dist_main - config 2 at 26 qubits on 2 and 8 shards of the card: the
             bench route (the gate list planned into windows and remaps,
             run from |0>) and the API route under gateFusion, each
             within 1e-5 of the one-register state and P(top = 0), the
             bench route within 1e-5 of its plain route; K1 and K2
             launch shards x the program's passes and groups; exchanges
             and bytes equal to the cost model (remap_exchange_count and
             remap_exchange_bytes over the drain's sigmas, plus the
             canonical read's remap).  Config 4's noise layer on a
             14-qubit density register at R = 4: K5 on every shard, bit
             for bit against the plain route, within 1e-6 of one register.
30. dist_timing - API-route wall per circuit at R = 1, 2 and 8; the bench
             route's device ms by op kind, kernels against exchange
             copies, with the bytes the copies move and their GB/s; a
             30-qubit bench-route circuit on 8 shards with its peak
             memory.  Where two or more cards are visible, dist_nccl
             runs two NCCL ranks bit for bit against the in-process mesh,
             saves their register with saveQureg on the ranks and loads
             it in process onto one register, bit for bit; on one card a
             line says it did not run.
32. dist_composites_parity - K6-K9 on every shard of the sharded QFT
             routes, each launch bit for bit against its plain version on
             the same shard: config 3's 30-qubit QFT on 8 shards (K8 x4
             and K9 a shard, nloc = 27), applyQFT on the run [0, 25) of 26
             qubits on 8 shards (K6 x9 and K7 x7 a shard) and applyFullQFT
             on a 13-qubit density register on 4 (K7 in the ket run).
33. dist_composites_main - each sharded composite at full width, float32,
             against the one-register route, the launch counts and the
             exchange counters reset just before each route: the 30-qubit
             QFT on 8 shards (within 1e-5 max|psi|, K8 and K9 per shard,
             exchanges = the reference's model); the run [0, 25) at R = 2
             (inside a shard) and 8 (K6, K7); the density QFT on 4; config
             5 on |+>^30 at R = 8 (Trotter and both energies; no K3 / K4);
             config 4's eager channels on 4 shards, targets 12 and 13
             (bra bits on the mesh) and 0 and 1, within 1e-6 each;
             config 2 at 26 qubits on 2 and 8 shards measured in full
             (the one register's outcomes for seed 1234); DiagonalOp and
             the phase functions at 30 qubits on 8 shards (sampled against
             one register) and D rho at 15 qubits on 8.
34. dist_composites_timing - walls against one register (the 30-qubit
             QFT, Trotter, the energy, measureSequence, applyDiagonalOp)
             and every sharded route's device ms split into kernels,
             exchange copies and plain ops (the QFT also by stage; the
             run [0, 25), the density QFT and the eager channels on
             their meshes too); the per-shard launches of K6-K9.
35. dist_batch_parity - K1, K2 and K5's bank forms on one shard's bank
             as 8 shards of 26 qubits hold it, (8, 2, 2^23) float32: one
             launch a call, every element bit for bit its own scalar
             launch, within tolerance of the plain versions (0/1
             permutation sides and K5 bit for bit).
36. dist_batch_main - randomized compiling of config 2 (26 qubits x 8)
             as a bank on 2 and 8 shards, by the bench route (the
             elements' gate lists as one sharded bank program) and the
             API route (a BatchedQureg drained): the bank's program
             planned once (timed apart), the drain's wall and device ms
             split into K1 bank, K2 bank, gatherperm and exchange
             copies; K1 and K2 bank launches = shards x the program's
             passes (not x B);
             exchanges and bytes = B x the cost model; peak memory;
             P(top = 0) within 1e-5 of the one-register bank; elements 0
             and 7 bit for bit their scalar sharded drains; at R = 8
             config 5's 16 expectations within 1e-5 and measureBatched
             of qubits 0-2 giving the one-register bank's outcomes.  A
             13-qubit density bank of 4 under a config-4 layer on 4
             shards (K5 bank per shard, bit for bit its plain route,
             within 1e-6 of one register); an EnsembleScheduler bucket of
             8 config-2 circuits at 20 qubits on 2 shards.
37. dist_quad_main - precision 4 on 8 shards: config 2 at 26 qubits
             (float64 drain); calcTotalProb, calcProbOfOutcome,
             calcInnerProduct and calcExpecPauliHamil (config 5) within
             1e-12 of the one-register quad route on the same state, and
             calcPurity of a 13-qubit density register on 4 shards; the
             cancellation state kept exactly; walls beside one register.
38. dist_models_main - VQE at 20 qubits (float64) and QAOA at 24
             (float32) on 8 shards: objective and gradient within 1e-5
             and 1e-4 |g| of one register on the same parameters; three
             Adam steps each; wall per step and peak memory beside one
             register's.
39. telemetry_main - config 2 at 26 qubits, f32, by the bench route (one
             drain of the 770 gates) and the API route, with QT_TELEMETRY
             off, on and trace in three turns: wall per circuit (medians)
             and the on/off and trace/off ratios against the 5 % budget
             (printed, not gated); the counters of one API circuit against
             its drain (fusion_drains_total, fusion_windows_total,
             dispatch_total{family=unitary,not}) and its K1/K2 launches;
             one torch.profiler trace of an API circuit: its fusion.drain
             and fusion.plan ranges and window_pass_kernel events;
             reportPerf's line count and memory line.
40. resilience_main - runResumable over the 770 gates at 26 qubits, f32,
             every 128 gates (seven windows) on one register: wall against
             one plain drain and the windows drained without checkpoints;
             checkpoint_commit_seconds, the copy / write / fsync split and
             the write rate of the 512 MiB generations, the restore, the
             watchdog's ms per window (with the wait for the window's
             kernels) and the health reduction alone; kill@3 then a resume
             under a
             wrong seed bit for bit with the same next uniform draw; nan@2
             under raise, scale@2 under renormalize, corrupt@4 and a resume
             from the predecessor bit for bit; saveQureg / loadQureg bit
             for bit.
41. dist_resilience_main - the same on an in-process mesh of 8 shards:
             stall@2 absorbed by the exchange guard (exchange_timeouts_total)
             and shard_loss@3 failing over to 4 shards (failover_{detect,
             rollback,reshard,resume}_seconds); the result bit for bit
             against a run killed on 8 shards and resumed on 4, and within
             tolerance of an uninterrupted 4-shard run (other windows on
             other meshes: float32 products in another order).
42. governor_main - the memory governor on the card (the budget it
             derived beside torch.cuda.mem_get_info), one register,
             float32: createQureg(34) (128 GiB) refused with nothing
             allocated; a 33-qubit register admitted and its drain refused
             under QT_MEM_POLICY=strict, state and buffer intact; config
             2's drain at 26 and 30 qubits, the modeled peak against
             max_memory_allocated, the governor's host time against the
             drain's wall (governor off / on in turns); the spill rung (two
             30-qubit registers under QT_HBM_BUDGET_BYTES = 20 GiB: the
             idle one spilled to pinned memory, memory_allocated lower by
             its bytes, the drain torch.equal to the ungoverned one, the
             spilled register restored bit for bit, the spill and restore
             seconds); the OOM net (a set_per_process_memory_fraction cap
             under which the 30-qubit drain cannot run beside two idle
             registers: one real torch.cuda.OutOfMemoryError, both idle
             registers spilled, one retry, torch.equal); config 4's
             14-qubit noise layer (K5) under FaultPlan("oom@0") bit for bit
             the unfaulted layer.
43. introspect_main - explainCircuit on config 2 at 26 qubits before the
             drain, on one register and on 8 in-process shards: windows,
             plan windows, megawin windows and exchanges equal to the
             drain's counters, K1 and K2 launches to the plan's passes and
             groups per shard; drift 0, and detected on count and bytes
             under perturb_prediction(scale=2); reportPerf's
             reconciliation and governor lines; the sharded-contract check
             on 8 shards of the card; the explain wall against the drain's;
             the dispatch floor in microseconds.
44. serve_main - config 2 served by quest_tpu_torch.serve.SimServer at
             26 qubits, depth 20, float32, on one register env: two
             tenants (weights 1 and 3), 8 batch jobs of config 2's
             structure, each with its own seeded unitaries, in one bank
             of 8 (4.3 GB), measure=(0, 25), QT_SERVE_WINDOW=16; after the
             bank's third window 2 interactive jobs, whose bank preempts
             the batch bank to a checkpoint (memory_allocated drops by
             its bytes).  Every job torch.equal to its run under
             preempt="off", with the same outcomes and key states, and
             within 1e-5 of its own single-register windowed drain;
             memory_allocated back at its start after close().  Wall per
             circuit, per-class queue wait and latency, banks, windows,
             preemptions, checkpoint and resume seconds, planning seconds
             against the programs' device ms, the busy share; K1's (and
             K2's) bank-form launches.
45. serve_chaos - scripts/chaos_serve.py's trace for seed 12 on 8
             in-process shards of the card at 20 qubits: a bank fault, IO
             faults, a host loss under a 2x4 topology then a heal, an OOM
             and a poisoned job.  Only the poisoned job fails; every other
             completion torch.equal to the fault-free replay, or, when it
             ran windows on the shrunk mesh, within tolerance with equal
             outcomes; the server idle with no resident bank; flight dumps
             for the quarantine and the failover; complete request traces.
46. serve_ab - scripts/bench_serve.py's A/B at 20 qubits, recorded only:
             continuous batching against batch-at-once on one seeded
             open-loop trace, circuits/s and the interactive p99 beside
             the reference's budgets (2x and 2x).
47. f2_main - config 2's 770 gates on a 32-qubit float32 register (34.4
             GB) under QT_MEM_POLICY=degrade: refused before allocating,
             or drained to the end with a peak within the governor's
             two-state model (the drain drops its input after the first
             op), the norm 1 within 1e-3.
48. aot_main - the persistent plan cache (QT_AOT_CACHE) and serving's
             warm pool, config 2 at 26 qubits, float32: (a) two child
             processes on one cache directory, the cold one planning and
             storing, the warm one draining the bench and API routes with
             no fusion.plan span, no put, its hits the cold one's puts,
             its states' sha256 and K1/K2 launches the cold one's; (b)
             serve_main's jobs with the cache on and the warm pool off,
             then on (the serving thread's and the pool's planning
             seconds, the served walls), then a fresh child replica
             booted from the second server's export_warmset() through
             warm_from, which plans nothing; every job's state the sha256
             of its run under preempt="off"; (c) explainCircuit's compile
             status (miss, memory, hit) against the aot counters each
             drain then moved, drift 0; (d) a truncated entry: one error,
             the aot_cache_corrupt degradation, a re-plan, torch.equal.
49. examples_main - each example of examples/torch/ run on the card in
             this process through runpy (EXAMPLES): shot sampling at 26
             qubits, 8 shots; phase estimation --fused at 24 counting
             qubits, an exact phase; Grover --fused and by the API at 16
             qubits; Trotter at 26 qubits, 10 steps (K3, K4); BV and the
             tutorial as shipped; VQE and QAOA at 20 qubits.  The lines
             tests/test_examples.py checks and the examples' asserts; per
             example the wall, device ms and busy share under
             torch.profiler, and the launches by kernel.
50. bank_forms_parity - K12's bank form over PREC_SWAPS at 20 qubits
             (f32 and f64, shared and per-element sides, a float32 bank
             mixing 0/1 and inexact sides) and K10's over SIGMA_PARITY, on
             banks of 3: every element torch.equal to its scalar launch;
             a K10 bank over the grid's z limit refused before launching.
51. bank_forms_main - R7a: config 2 at 26 qubits x 8 (randomized
             compiling, seeds 7..14) under QT_PLANNER=paged, the elements'
             paged plans stacked through execute_plan on the bank:
             K11_bank and K12_bank launches equal to the plan's fused and
             swapfused ops, every element torch.equal to its scalar paged
             drain.  R7b: the 30-qubit bit reversal (bit_reversal_ops:
             K10's reversal form) through execute_plan on a float32 bank
             of 2 x 2^30 (17.2 GB): one K10_rev_bank launch, each element
             torch.equal to its scalar route; then one K10_bank (sigma) on
             the same bank.  K11's, K12's and K10's bank forms timed
             against B scalar launches, their plain versions and one
             PyTorch call each (the fastest batched torch.einsum for K11
             and K12, permute(...).contiguous() of the bank's view for
             K10, each held to the bank launch's output first).
52. probes_parity - P1 (csrc/probes.cu stream_pass_kernel) torch.equal
             to its plain version in every (op, R, in place or not) case
             at 2^20 and 2^26 amplitudes; each probe of
             quest_tpu_torch/probes/ run through its check() on the card
             at 20 qubits (K1 and K3 against their plain versions, P1
             again).
53. probes_main - the five probes' run() on the card (the TPU probes of
             scripts/probes/ and their counterparts: profile_dma P1,
             kernel_microbench K1 at offset k with K11, K12 and the
             segment swap, probe_kernel_variants K1 given A^T,
             profile_rank_kernels K1 at k = 7 under "highest" and
             "bf16_3x", probe_flip_pallas K3 over 16 terms at 24 qubits),
             every launch count set to 0 before each and read after.
54. kernels - one JSON object with every kernel's numbers (K1, K2, K11
             and K12 with their per-mode times, bounds, launches and
             errors under "modes"; K1, K2 and K5's bank forms, with their
             launches on a sharded bank under "dist"; K1, K2, K5 and
             K6-K9 marked as run per shard with their dist launches; K1's
             and K2's launches on the resumable path under "resumable";
             K1's, K2's and K5's under the governor under "governed";
             the bank forms' launches on the serving path under "serve";
             K1's on F2's drain under "f2"; K1's, K2's and their bank
             forms' with the plan cache on under "aot"; K11's, K12's and
             K10's bank forms; P1-P8, the probe sites, each with its
             counterpart kernel, its launches in probes_main and its
             times there).

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

sys.path.insert(0, str(Path(__file__).resolve().parent))
try:
    # the peaks, bounds, tolerances, timing and library yardsticks that
    # judge every kernel here and in the probes: one copy, in the package
    from quest_tpu_torch.probes.common import (
        HBM_BYTES_PER_S, MODE_FLOPS, MODE_UNIT, PEAK_FLOPS, WINDOW_FLOPS,
        bound_ms, cluster_library, emit, flops_of, least_ms, library_time,
        mode_tolerance, nvidia_smi_line, random_unitary, time_ms, tolerance,
        window_library)
except ImportError as e:
    sys.exit(f"chip_smoke: cannot import quest_tpu_torch ({e}); run from "
             "the repository root")

N_PARITY = 20          # qubits for the kernel parity checks
N_MAIN = 26            # the main path's register
N_MEAS_MAIN = 26       # the measured register (config 2's circuit)
DEPTH = 20
SEED = 7               # bench.py config 2's unitary seed
DEVICE = "cuda"
N_PAULI = 30           # config 5's register: an 8 GiB float32 state
N_PAULI_F64 = 26       # the float64 cross-check of the config-5 workload
N_QASM = 20            # the QASM-recording Trotter route
N_QFT = 30             # bench.py config 3: a full QFT at 30 qubits, f32
N_QFT_F64 = 26         # the float64 cross-check of the QFT
N_QFT_RHO = 15         # a density register of 2^30 amplitudes (K6, K7)
SIGMA_PARITY = ((20, 2), (20, 4), (28, 7))   # K10's (n, g) parity cases
# K10's reversal form: (n, g) parity cases, n - 4g from 0 to 12
REV_PARITY = ((20, 2), (17, 3), (19, 4), (28, 7), (29, 7))
N_REV_OLD = (30, 31)   # the reversal form against the old route's plan
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

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
    the union of the intervals of every kernel and copy the profiler saw
    on the card (two that overlap count once; the card-side images of
    ``record_function`` ranges, such as the telemetry spans, are no
    device work and are left out, as in qtbench/trace.py), and how many
    of those kernels were named ``kernel``; (None, None) if it saw
    nothing on the card."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # tiny first launches: the tracer may miss the first kernels of a
        # window (one QFT's first K8 launch went unseen with none, and
        # once with one)
        for _ in range(3):
            torch.ones(1, device=DEVICE).add_(1)
            sync()
        call()
        sync()
    events = list(prof.profiler.kineto_results.events())
    annotations = {e.name() for e in events if e.is_user_annotation()}
    on_card = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in events if str(e.device_type()).endswith("CUDA")
        and not e.is_user_annotation() and e.name() not in annotations)
    if not on_card:
        return None, None
    busy, end = 0, None
    for s, e, _name in on_card:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6, sum(1 for _s, _e, name in on_card if kernel in name)


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

    # K3: one read and one write of the state, 14 flops an amplitude; K4:
    # one read, 12 flops an amplitude
    k3_bound, k3_by = least_ms(2 * state_bytes, 14.0 * amps,
                               PEAK_FLOPS["float32"])
    k4_bound, k4_by = least_ms(state_bytes, 12.0 * amps,
                               PEAK_FLOPS["float32"])
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
             fused.apply_qft_ladder_pallas, bigstate.apply_sigma_swap,
             bigstate.apply_bit_reversal)
    fused.apply_qft_multi_hi = fused.qft_multi_hi_plain
    fused.apply_qft_cluster_multi = fused.qft_cluster_multi_plain
    fused.apply_qft_ladder_pallas = ladder
    bigstate.apply_sigma_swap = bigstate.sigma_swap_plain
    bigstate.apply_bit_reversal = bigstate.bit_reversal_plain
    try:
        yield
    finally:
        (fused.apply_qft_multi_hi, fused.apply_qft_cluster_multi,
         fused.apply_qft_ladder_pallas, bigstate.apply_sigma_swap,
         bigstate.apply_bit_reversal) = saved


def qft_launches(fused, bigstate) -> dict:
    return {k: fused.LAUNCHES[k] for k in ("K1", "K2", "K6", "K7", "K8",
                                           "K9")} | {
        k: bigstate.LAUNCHES[k] for k in ("K10", "K10_rev")}


def reset_qft_counts(fused, bigstate) -> None:
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()


def qft_plan_np(np, C, n, old=False):
    """The ops after K9 of one n-qubit QFT on the card, as NumPy operands.
    The route: the seven lane layers in one A-only window pass, then the
    reversal (at 30-34 qubits K10's reversal form).  ``old``: the route
    before the reversal form, the lane-layer fold (the seven lane layers
    with both low rev7 reversals) and the reference's in-place plan's
    three B-only reversal passes and sigma."""
    dt = np.float32
    gates = [C.Gate(tuple(range(qq + 1)), C._qft_layer_dense(qq, False, dt))
             for qq in range(6, -1, -1)]
    if old:
        rev7 = C._rev_perm_mat(7, dt)
        gates += [C.Gate(tuple(range(7)), rev7),
                  C.Gate(tuple(range(7, 14)), rev7)]
    ops = C.plan_circuit(gates, n, device=DEVICE)
    if old:
        return ops + C._bit_reversal_big(n, dt, skip_low_group=True)
    return ops + C.bit_reversal_ops(n, [(0, n)], dt, device=DEVICE)


def qft_k1_ops(torch, np, C, n, old=False):
    """qft_plan_np's ops, uploaded."""
    return C.plan_to_device(qft_plan_np(np, C, n, old), torch.float32,
                            DEVICE)


def old_route_qft(np, C, fused, amps, n, ops=None):
    """The n-qubit QFT by the route before K10's reversal form: K8, K9,
    then qft_plan_np(old=True)'s ops (the lane fold, three B-only
    reversal passes, sigma), as _fused_qft_multilayer ran them; or K8, K9
    and ``ops``."""
    amps = fused.apply_qft_multilayer_ladders(amps, num_qubits=n,
                                              t_top=n - 1)
    if ops is None:
        ops = qft_plan_np(np, C, n, old=True)
    return C.execute_plan(amps, ops, n)


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
    k10_before = bigstate.LAUNCHES["K10"]
    for m, g in SIGMA_PARITY:
        y = x if m == n else random_state(torch, m, 1357)
        same(lambda a: bigstate.apply_sigma_swap(a, num_qubits=m,
                                                 group_bits=g),
             lambda a: bigstate.sigma_swap_plain(a, num_qubits=m,
                                                 group_bits=g),
             f"K10 n={m} g={g}", state=y)
        out["k10_cases"].append([m, g])
        del y
    out["k10_launches"] = bigstate.LAUNCHES["K10"] - k10_before
    out["k10_rev_cases"] = []
    for m, g in REV_PARITY:
        y = x if m == n else random_state(torch, m, 1358)
        same(lambda a: bigstate.apply_bit_reversal(a, num_qubits=m,
                                                   group_bits=g),
             lambda a: bigstate.bit_reversal_plain(a, num_qubits=m,
                                                   group_bits=g),
             f"K10 reversal form n={m} g={g}", state=y)
        out["k10_rev_cases"].append([m, g])
        del y
    torch.cuda.empty_cache()

    # K1 on each pass of the QFT's plan at the main path's size, the old
    # route's passes and the route's A-only lane pass
    m = N_QFT
    x = random_state(torch, m, 97531)
    tol = tolerance(x)
    out["k1"] = []
    for op in (qft_k1_ops(torch, np, C, m, old=True)
               + qft_k1_ops(torch, np, C, m)):
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
    lane layers and the reversal, K2 per megawin group, K10 (sigma) none
    and one K10 reversal form."""
    ops = qft_k1_ops(torch, np, C, n)
    st = C.stats(ops)
    return {"K1": st["winfused"], "K2": st["megawin"], "K6": 0, "K7": 0,
            "K8": -(-(n - 14) // 4), "K9": 1, "K10": st["sigma_swap"],
            "K10_rev": st["sigma_rev"]}


def phase_qft_main(torch, np, qt, C, fused, bigstate, circuits):
    n = N_QFT
    state_bytes = 2 * 4 << n
    out = {"n": n}
    qt.set_precision(1)
    want = qft_want(torch, np, C, n)
    check(want["K10_rev"] == 1 and want["K1"] == 1,
          f"the {n}-qubit plan is not one lane pass and one reversal: "
          f"{want}")

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
    check(all(plain_launches[k] == 0
              for k in ("K8", "K9", "K10", "K10_rev")),
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


def phase_qft_timing(torch, np, qt, C, fused, bigstate):
    n = N_QFT
    x = random_state(torch, n, QFT_SEED + 4)
    num_amps = 1 << n
    state_bytes = x.numel() * x.element_size()
    out = {"device": torch.cuda.get_device_name(0), "n": n,
           "state_bytes_f32": state_bytes}

    def timed(kernel, plain, nbytes, flops, library=None):
        b, by = least_ms(nbytes, flops, PEAK_FLOPS["float32"])
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
    # K1 at 2^30 amplitudes on the route's A-only lane pass and the old
    # route's two pass kinds (the dual lane fold, a B-only reversal pass)
    ops = [op for op in qft_k1_ops(torch, np, C, n) if op[0] == "winfused"]
    old = [op for op in qft_k1_ops(torch, np, C, n, old=True)
           if op[0] == "winfused"]
    out["k1"] = []
    for op in (ops[0], old[0], old[-1]):
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
        # the tracer can still drop a kernel behind the warm-up launches
        # (one K8 of four went unseen once in a whole run, and none in
        # 200 traces of a fresh process): a trace that misses one is
        # taken again, up to three times, and each try's count reported
        seen_per_try = []
        while len(seen_per_try) < 3:
            dev, seen = device_busy(torch, fn, "qft_hi_kernel")
            seen_per_try.append(seen)
            if seen in (None, 4):
                break
        check(seen in (None, 4), f"the profiler saw {seen_per_try} K8 "
              "launches in one QFT's traces, not 4")
        out[f"{label}_wall_ms"] = walls[label] * 1e3
        out[f"{label}_busy"] = {
            "device_ms": dev, "k8_launches_seen": seen,
            "k8_seen_per_try": seen_per_try,
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


def phase_qft_reversal(torch, np, qt, C, fused, bigstate):
    """K10's reversal form against the route it replaces, which ran the
    reference's in-place plan (three B-only K1 passes and sigma after the
    lane fold): the reversal alone at 30 and 31 qubits and on a bank of 2
    x 30 against that plan, bit for bit; applyFullQFT at 30 qubits bit
    for bit against K8, K9, the A-only lane pass and that plan (its four
    0/1 passes exact), and within the tolerance of the old route, whose
    dual lane fold took its exact 0/1 B side in 3xTF32 products that drop
    the low bits of X A^T; the launches of one applyFullQFT; the reversal
    form's time (CUDA events) beside its bytes bound and the old plan's,
    and the A-only lane pass beside the dual lane fold it replaces."""
    dt = np.float32
    out = {"device": torch.cuda.get_device_name(0), "old_route": {}}
    g = 7
    for n in N_REV_OLD:
        x = random_state(torch, n, 4242 + n)
        old = C.plan_to_device(C._bit_reversal_big(n, dt), torch.float32,
                               DEVICE)
        reset_qft_counts(fused, bigstate)
        y_old = C.execute_plan(x.clone(), old, n)
        sync()
        old_launches = qft_launches(fused, bigstate)
        check(old_launches["K1"] == C.stats(old)["winfused"] == 4
              and old_launches["K10"] == 1,
              f"the old route's plan at {n} qubits launched {old_launches}, "
              "not four K1 passes and sigma")
        bigstate.reset_launch_counts()
        y = bigstate.apply_bit_reversal(x, num_qubits=n, group_bits=g)
        sync()
        check(bigstate.LAUNCHES["K10_rev"] == 1 and y.data_ptr()
              == x.data_ptr(), f"the reversal form at {n} qubits did not "
              f"run once in place: {bigstate.LAUNCHES}")
        check(torch.equal(y, y_old), f"the reversal form at {n} qubits is "
              "not the old route's plan bit for bit")
        out["old_route"][n] = {"bit_identical": True,
                               "old_plan": [op[0] for op in old],
                               "old_plan_launches": old_launches}
        del x, y, y_old, old
        torch.cuda.empty_cache()

    # a bank of 2 x 30 through execute_plan, one launch for the bank
    n, nb = N_QFT, 2
    bank = torch.stack([random_state(torch, n, 4300 + b) for b in range(nb)])
    old = C.plan_to_device(C._bit_reversal_big(n, dt), torch.float32, DEVICE)
    want = C.execute_plan(bank.clone(), old, n)
    ops = C.bit_reversal_ops(n, [(0, n)], dt, device=DEVICE)
    bigstate.reset_launch_counts()
    got = C.execute_plan(bank, ops, n)
    sync()
    check(ops == [("sigma_rev", g)] and bigstate.LAUNCHES["K10_rev_bank"]
          == 1, f"the bank's reversal: {ops}, {bigstate.LAUNCHES}")
    check(torch.equal(got, want), "the reversal form on a bank of 2 x 30 "
          "is not the old route's plan bit for bit")
    out["bank"] = {"n": n, "batch": nb, "bit_identical": True,
                   "launches": dict(bigstate.LAUNCHES),
                   "ms": time_ms(lambda: bigstate.apply_bit_reversal(
                       bank, num_qubits=n, group_bits=g), reps=5),
                   "old_plan_ms": time_ms(lambda: C.execute_plan(
                       bank, old, n), reps=3, warmup=1),
                   "bound_ms": nb * 2 * 2 * (1 << n) * 4
                   / HBM_BYTES_PER_S * 1e3}
    del bank, want, got, old
    torch.cuda.empty_cache()

    # applyFullQFT at 30 qubits against the old route, same input
    env = qt.createQuESTEnv()
    q = qt.createQureg(n, env)
    src = random_state(torch, n, QFT_SEED + 7)
    q.amps = src.clone()
    reset_qft_counts(fused, bigstate)
    qt.applyFullQFT(q)
    sync()
    api_launches = qft_launches(fused, bigstate)
    want_launches = {"K1": 1, "K2": 0, "K6": 0, "K7": 0,
                     "K8": -(-(n - 14) // 4), "K9": 1, "K10": 0,
                     "K10_rev": 1}
    check(api_launches == want_launches, f"applyFullQFT launches "
          f"{api_launches} != {want_launches}")
    y = q.amps.reshape(2, -1)
    lane_then_old_plan = (qft_plan_np(np, C, n)[:-1]
                          + C._bit_reversal_big(n, dt))
    y_mid = old_route_qft(np, C, fused, src.clone(), n,
                          lane_then_old_plan).reshape(2, -1)
    sync()
    check(torch.equal(y, y_mid), f"applyFullQFT at {n} qubits is not K8, "
          "K9, the lane pass and the old reversal plan bit for bit "
          f"(|err| {max_abs_diff(torch, y, y_mid)})")
    del y_mid
    y_old = old_route_qft(np, C, fused, src.clone(), n).reshape(2, -1)
    sync()
    err, tol = max_abs_diff(torch, y, y_old), tolerance(src)
    check(err <= tol, f"applyFullQFT at {n} qubits against the old route: "
          f"|err| {err} > {tol}")
    out["apply_full_qft"] = {
        "n": n, "launches": api_launches,
        "bit_identical_to_lane_pass_then_old_reversal": True,
        "bit_identical_to_old_route": bool(torch.equal(y, y_old)),
        "max_abs_err_vs_old_route": err, "tolerance": tol,
        "max_abs_amp": float(y.abs().max())}
    del y, y_old, q
    torch.cuda.empty_cache()

    # times at 2^30: the reversal form, sigma, the old plan, the plain
    # version, the library's one call; the whole QFT by both routes
    x = src
    old = C.plan_to_device(C._bit_reversal_big(n, dt), torch.float32, DEVICE)
    bound, by = least_ms(2 * x.numel() * 4, 0.0, PEAK_FLOPS["float32"])
    # the library yardstick: one torch.index_select of the amplitude axis
    # by the n-bit reversal of the index (int32, built once on the card),
    # held to the reversal form first
    idx = torch.arange(1 << n, dtype=torch.int32, device=DEVICE)
    rev = torch.zeros_like(idx)
    for b in range(n):
        rev.bitwise_or_(((idx >> b) & 1) << (n - 1 - b))
    del idx
    check(torch.equal(torch.index_select(x, 1, rev),
                      bigstate.apply_bit_reversal(x.clone(), num_qubits=n,
                                                  group_bits=g)),
          "index_select by the reversed index is not the reversal form")
    torch.cuda.empty_cache()
    ms = time_ms(lambda: bigstate.apply_bit_reversal(x, num_qubits=n,
                                                     group_bits=g))
    out["k10_rev"] = {
        "n": n, "ms": ms, "bound_ms": bound, "bound_by": by,
        "fraction_of_bound": bound / ms,
        "sigma_ms": time_ms(lambda: bigstate.apply_sigma_swap(
            x, num_qubits=n, group_bits=g)),
        "plain_ms": time_ms(lambda: bigstate.bit_reversal_plain(
            x, num_qubits=n, group_bits=g), reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.index_select(x, 1, rev), reps=3,
                              warmup=1),
        "library_form": "torch.index_select(x, 1, rev) with an int32 "
                        "bit-reversal index",
        "old_plan_ms": time_ms(lambda: C.execute_plan(x, old, n), reps=3,
                               warmup=1)}
    del rev
    m = N_REV_OLD[-1]
    x31 = random_state(torch, m, 4343)
    ms31 = time_ms(lambda: bigstate.apply_bit_reversal(x31, num_qubits=m,
                                                       group_bits=g), reps=5)
    b31 = least_ms(2 * x31.numel() * 4, 0.0, PEAK_FLOPS["float32"])[0]
    out["k10_rev_31"] = {"n": m, "ms": ms31, "bound_ms": b31,
                         "fraction_of_bound": b31 / ms31}
    del x31
    torch.cuda.empty_cache()
    # the lane layers' pass: A-only now, dual (with both rev7) before
    lane_new = [op for op in qft_k1_ops(torch, np, C, n)
                if op[0] == "winfused"]
    lane_old = [op for op in qft_k1_ops(torch, np, C, n, old=True)
                if op[0] == "winfused"][0]
    check(len(lane_new) == 1 and lane_new[0][4] and not lane_new[0][5],
          f"the lane pass is not A-only: {[op[4:6] for op in lane_new]}")

    def lane(op):
        return time_ms(lambda: fused.apply_window_stack(
            x, op[2], op[3], None, num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5]))

    out["lane_pass"] = {"a_only_ms": lane(lane_new[0]),
                        "dual_ms": lane(lane_old),
                        "bound_ms_bytes": bound}
    a = x.view(2, -1, 128, 128)
    out["qft_ms"] = {
        "route": time_ms(lambda: C.fused_qft(a, n, 0, n), reps=3, warmup=1),
        "old_route": time_ms(lambda: old_route_qft(np, C, fused, a, n),
                             reps=3, warmup=1)}
    del x, a, src, old
    torch.cuda.empty_cache()
    return out


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
    length of the block (a bank's elements one by one): the plain route
    of a noise drain."""
    import torch

    saved = fused.apply_pair_channel_sweep

    def plain(amps, program, probs, *, num_bits):
        if fused.bank_size(amps, num_bits):
            return torch.stack([fused.pair_channel_sweep_plain(
                a, program, probs, num_bits=num_bits) for a in amps])
        return fused.pair_channel_sweep_plain(amps, program, probs,
                                              num_bits=num_bits)

    fused.apply_pair_channel_sweep = plain
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
            y, cluster_library(x, a, b), tol, f"K11 R={rank}")
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
            y, cluster_library(x, a, b, (h, bq, m)), tol, f"K12 R={rank}")
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
PREC_SWAPS = ((14, 7, 3), (16, 9, 2), (17, 11, 1))   # K12's (h, b, m)


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
BANK_KEYS = ("K1_bank", "K2_bank", "K5_bank", "K11_bank", "K12_bank",
             "K10_bank")


def bank_launches(fused) -> dict:
    """The launch counts of K1, K2, K5 and every bank form (K10's bank
    form counts in ops/bigstate.py)."""
    from quest_tpu_torch.ops import bigstate

    counts = {**fused.LAUNCHES, **bigstate.LAUNCHES}
    return {k: counts[k] for k in ("K1", "K2", "K5", *BANK_KEYS)}


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
    # config 5's 16 terms on every element (dist_batch_main's yardstick)
    from quest_tpu_torch.models import hamiltonians

    hc, hk = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS, PAULI_SEED)
    main["expec_config5"] = [float(v) for v in qt.calcExpecPauliSumBatched(
        q, hk, hc)]
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
    # what dist_batch_main holds the bank on a mesh to: every element's
    # outcomes and probabilities of the first qubits measured
    main["measured_first"] = [
        {"qubit": t, "outcomes": [int(v) for v in outs[t][0]],
         "probs": [float(v) for v in outs[t][1]]}
        for t in range(DIST_MEASURED)]
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


def train_record(torch, model, p, make_step, falls: bool,
                 steps: int = MODEL_STEPS):
    """``steps`` Adam steps at VQE_LR from ``p``: the objective at each
    step, the wall per step, the peak device memory."""
    p = p.clone().requires_grad_(True)
    step = make_step(torch.optim.Adam([p], lr=VQE_LR))
    sync()
    torch.cuda.reset_peak_memory_stats()
    vals, walls = [], []
    for _ in range(steps):
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


# ---------------------------------------------------------------------------
# Registers split over shards (M15a): the exchange layer and the sharded
# drain on an in-process mesh of R shards on the card
# ---------------------------------------------------------------------------

N_DIST = 26            # config 2's register, split over R shards
DIST_MESHES = (2, 8)   # R of dist_main; dist_timing adds R = 1
N_DIST_PARITY = 26     # dist_parity's state: nloc = 23 at R = 8
N_DIST_RHO = 14        # config 4's density register (2^28) at R = 4
R_DIST_RHO = 4
N_DIST_BIG = 30        # one bench-route circuit at R = 8: 8.59 GB of state
DIST_SEED = 2024


def mesh_env(qt, r: int):
    """An env of ``r`` shards on the card (an in-process mesh), or the
    one-card env at r = 1."""
    if r == 1:
        return qt.createQuESTEnv()
    return qt.createQuESTEnv(devices=[DEVICE] * r)


@contextmanager
def plain_window_kernels(fused):
    """K1's and K2's wrappers replaced by their plain versions, on the card
    too, for the length of the block: the plain route of a drain."""
    saved = (fused.apply_window_stack, fused.apply_window_megastack)

    def k1_plain(amps, a, b, mask=None, *, num_qubits, k, apply_a=True,
                 apply_b=True, precision=None, staged=None):
        return fused.window_pass_plain(amps, a, b, mask,
                                       num_qubits=num_qubits, k=k,
                                       apply_a=apply_a, apply_b=apply_b)

    def k2_plain(amps, subops, *, num_qubits, precision=None):
        return fused.megawin_plain(amps, subops, num_qubits=num_qubits)

    fused.apply_window_stack, fused.apply_window_megastack = \
        k1_plain, k2_plain
    try:
        yield
    finally:
        fused.apply_window_stack, fused.apply_window_megastack = saved


def shards_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))


def shards_max_diff(torch, a, b) -> float:
    return max(max_abs_diff(torch, x, y) if x.numel() >= 1 << 25
               else float((x - y).abs().max())
               for x, y in zip(a.shards, b.shards))


def shards_tolerance(a) -> float:
    """tolerance() of a sharded state, by its largest amplitude."""
    return max(tolerance(s) for s in a.shards)


def program_passes(program) -> int:
    """Window passes per shard of a sharded program: each K1 pass and each
    pass of a K2 group."""
    return sum(1 if op[0] == "winfused" else len(op[1])
               for part in program if part[0] == "plan"
               for op in part[1] if op[0] in ("winfused", "megawin"))


def program_counts(fusion, program) -> dict:
    st = fusion.program_stats(program)
    return {"winfused": st.get("winfused", 0), "megawin": st.get("megawin", 0),
            "remap": st.get("remap", 0), "chansweep": st.get("chansweep", 0)}


def remap_model(C, PD, program, final_perm, n, nloc, itemsize) -> dict:
    """The exchange cost model of a drain and its canonical read: counts
    and per-shard bytes of the program's remaps ("window_remap") and of
    the read's remap ("remap")."""
    sigmas = [p[1] for p in program if p[0] == "remap"]
    out = {"window_remap": [sum(PD.remap_exchange_count(s, nloc, n - nloc)
                                for s in sigmas),
                            sum(C.remap_exchange_bytes(s, n, nloc, itemsize)
                                for s in sigmas)],
           "remap": [0, 0]}
    if final_perm is not None and list(final_perm) != list(range(n)):
        s = PD.canonical_sigma(tuple(final_perm))
        out["remap"] = [PD.remap_exchange_count(s, nloc, n - nloc),
                        C.remap_exchange_bytes(s, n, nloc, itemsize)]
    return out


def program_op_counts(program) -> dict:
    """Ops of a sharded program's planned and permutation parts by kind
    (a megawin group counts once), and its remaps."""
    out: dict = {}
    for part in program:
        for op in (part[1] if part[0] in ("plan", "perm") else (part,)):
            out[op[0]] = out.get(op[0], 0) + 1
    return out


def counted(PD) -> dict:
    return {op: [int(PD.counter_sum("exchanges_total", op=op)),
                 int(PD.counter_sum("exchange_bytes_total", op=op))]
            for op in ("window_remap", "remap")}


def phase_dist_parity(torch, np, qt, C, fused, fusion, circuits, kernels):
    """Each exchange primitive on the card, torch.equal to the same bit
    permutation done by gather -> permute_qubits -> split; one shard's K1
    and K2 at nloc = 23 against their plain versions."""
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH

    n = N_DIST_PARITY
    R = 8
    nloc = n - 3
    env = mesh_env(qt, R)
    x = random_state(torch, n, DIST_SEED)
    out = {"n": n, "shards": R, "nloc": nloc, "cases": []}

    def want_of(sigma):
        # permute_qubits: out bit q <- in bit perm[q]; sigma sends bit p
        # to sigma[p], so perm = sigma^-1
        return SH.split(env.mesh, kernels.permute_qubits(
            x, num_qubits=n, perm=PD.canonical_sigma(tuple(sigma))), nloc,
            torch.float32)

    def case(label, sigma, run):
        want = want_of(sigma)
        for chunks in (1, 8):
            got = run(SH.split(env.mesh, x, nloc, torch.float32), chunks)
            sync()
            check(shards_equal(torch, got, want), f"dist_parity {label} "
                  f"(chunks {chunks}) is not the bit permutation")
            del got
        out["cases"].append({"case": label, "sigma_mixed_local_mesh": [
            len(p) if p else 0 for p in PD.decompose_sigma(
                tuple(sigma), nloc, n - nloc)], "bit_identical": True})
        del want
        torch.cuda.empty_cache()

    # the half-shard swap of a local and a sharded qubit
    for lo, hi in ((0, nloc), (nloc - 10, n - 1), (nloc - 1, n - 2)):
        sigma = list(range(n))
        sigma[lo], sigma[hi] = hi, lo
        case(f"swap_{lo}_{hi}", sigma,
             lambda a, c, lo=lo, hi=hi: PD.swap_sharded(
                 a, num_qubits=n, qb_low=lo, qb_high=hi, chunks=c))
    # the composed mesh permute alone, then a remap with every class
    mesh_only = list(range(nloc)) + [n - 1, nloc, nloc + 1]
    rng = np.random.default_rng(DIST_SEED)
    mixed = [int(v) for v in rng.permutation(n)]
    for label, sigma in (("mesh_permute", mesh_only), ("remap", mixed)):
        case(label, sigma, lambda a, c, sigma=sigma: PD.remap_sharded(
            a, num_qubits=n, sigma=tuple(sigma), chunks=(c, c)))
    del x
    torch.cuda.empty_cache()

    # one shard's K1 and K2 at nloc = 23: the passes and groups config 2's
    # sharded bench program plans there
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    gates = circuits.bench_gate_list(n, DEPTH, us)
    program, _fp = fusion.plan_items_sharded(gates, n, nloc, device=DEVICE,
                                             optimize=False)
    plan_ops = [op for p in program if p[0] == "plan"
                for op in C.plan_to_device(p[1], torch.float32, DEVICE)]
    passes = [op for op in plan_ops if op[0] == "winfused"]
    groups = [op[1] for op in plan_ops if op[0] == "megawin"]
    check(passes and groups, f"the sharded bench plan at nloc = {nloc} has "
          f"{len(passes)} window passes and {len(groups)} megawin groups")
    y = random_state(torch, nloc, DIST_SEED + 1)
    tol = tolerance(y)
    k1_err = 0.0
    for op in passes[:6]:
        got = fused.apply_window_stack(y, op[2], op[3], op[6], num_qubits=nloc,
                                       k=op[1], apply_a=op[4],
                                       apply_b=op[5])
        want = fused.window_pass_plain(y, op[2], op[3], op[6],
                                       num_qubits=nloc, k=op[1],
                                       apply_a=op[4], apply_b=op[5])
        err = float((got - want).abs().max())
        check(err <= tol, f"K1 at nloc = {nloc}, k = {op[1]}: |err| {err}")
        k1_err = max(k1_err, err)
    k1_perm = 0
    for k in range(7, nloc - 6, 3):
        for sides in ("AB", "B", "A"):
            op = permutation_pass(np.random.default_rng(k), k, sides)
            got = fused.apply_window_stack(y, op[2], op[3], None,
                                           num_qubits=nloc, k=k,
                                           apply_a=op[4], apply_b=op[5])
            want = fused.window_pass_plain(y, op[2], op[3], None,
                                           num_qubits=nloc, k=k,
                                           apply_a=op[4], apply_b=op[5])
            check(torch.equal(got, want), f"K1 at nloc = {nloc}, k = {k}: a "
                  "permutation pass is not bit-identical to its plain version")
            k1_perm += 1
    k2 = [k2_case(torch, fused, y, g, nloc, tol,
                  [(op[1], op[2].shape[0]) for op in g]) for g in groups]
    sync()
    out.update(k1_passes=min(len(passes), 6), k1_max_abs_err=k1_err,
               k1_permutation_cases_bit_identical=k1_perm,
               k2_groups=k2, tolerance=tol)
    del y
    torch.cuda.empty_cache()
    return out


def dist_noise(qt, noise, env, n, kops):
    """|+><+|^n on ``env`` through one config-4 noise layer under
    gateFusion."""
    rho = qt.createDensityQureg(n, env)
    qt.initPlusState(rho)
    with qt.gateFusion(rho):
        noise.noise_layer(qt, rho, n, kops, prob=NOISE_P)
    sync()
    return rho


def phase_dist_main(torch, np, qt, C, fused, fusion, circuits, noise, us,
                    p_one, psi_one):
    """Config 2's circuit at 26 qubits on R = 2 and 8 shards of the card,
    by the bench route (the gate list planned into a sharded program, run
    from |0>) and the API route (gates under gateFusion), each against
    the one-register drain and its own plain route; then config 4's noise
    layer on a 14-qubit density register at R = 4."""
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH

    n = N_DIST
    gates = circuits.bench_gate_list(n, DEPTH, us)
    items = capture_items(qt, us, n)
    psi_flat = psi_one.reshape(2, -1)
    out = {"n": n, "depth": DEPTH, "meshes": {}}
    launches = {"K1": 0, "K2": 0, "K5": 0}
    for R in DIST_MESHES:
        nloc = n - (R.bit_length() - 1)
        env = mesh_env(qt, R)
        rec = {"shards": R, "nloc": nloc}
        # the bench route
        t0 = time.perf_counter()
        bprog, bfinal = fusion.plan_items_sharded(gates, n, nloc,
                                                  device=DEVICE,
                                                  optimize=False)
        rec["bench_plan_s"] = time.perf_counter() - t0
        key = ("dist_bench", n, R)

        def bench():
            a = SH.classical(env.mesh, nloc, torch.float32, 0)
            a = fusion.execute_sharded_program(a, bprog, (), nloc, key=key)
            if bfinal is not None and list(bfinal) != list(range(n)):
                a = PD.remap_sharded(a, num_qubits=n,
                                     sigma=PD.canonical_sigma(bfinal))
            return a

        bst = program_counts(fusion, bprog)
        fused.reset_launch_counts()
        PD.reset_counters()
        a = bench()
        sync()
        got = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
        want = {"K1": R * bst["winfused"], "K2": R * bst["megawin"]}
        check(got == want, f"bench route at R = {R}: launches {got} != "
              f"shards x program {want}")
        check(got["K1"] > 0 and got["K2"] > 0, f"bench route at R = {R}: "
              f"a kernel never launched: {got}")
        launches["K1"] += got["K1"]
        launches["K2"] += got["K2"]
        model = remap_model(C, PD, bprog, bfinal, n, nloc, 4)
        check(counted(PD) == model, f"bench route at R = {R}: exchanges "
              f"{counted(PD)} != cost model {model}")
        p_b = float(SH.prob_of_outcome_statevec(a, n - 1, 0))
        err_one = max(float((a.shards[s].cpu()
                             - psi_flat[:, s << nloc:(s + 1) << nloc])
                            .abs().max()) for s in range(R))
        with plain_window_kernels(fused):
            ap = bench()
        sync()
        err_plain = shards_max_diff(torch, a, ap)
        # each window pass within tolerance() of its plain version, the
        # errors adding up over the shard's passes
        tol_plain = program_passes(bprog) * shards_tolerance(ap)
        check(err_one <= 1e-5 and abs(p_b - p_one) <= 1e-5,
              f"bench route at R = {R}: |psi - one register| {err_one}, "
              f"P(top=0) {p_b} vs {p_one}")
        check(err_plain <= tol_plain, f"bench route at R = {R}: |kernels - "
              f"plain| {err_plain} > {tol_plain}")
        del a, ap
        torch.cuda.empty_cache()
        rec["bench"] = {"program": bst, "launches": got,
                        "exchanges": model, "p_top_zero": p_b,
                        "max_abs_err_vs_one_register": err_one,
                        "max_abs_err_vs_plain_route": err_plain,
                        "tolerance_vs_plain_route": tol_plain}
        # the API route
        aprog, afinal = fusion.plan_items_sharded(items, n, nloc,
                                                  device=DEVICE,
                                                  sweep_ok=True)
        ast = program_counts(fusion, aprog)
        fused.reset_launch_counts()
        PD.reset_counters()
        t0 = time.perf_counter()
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        p_a = qt.calcProbOfOutcome(q, n - 1, 0)
        total = qt.calcTotalProb(q)
        sync()
        rec["api_first_wall_s"] = time.perf_counter() - t0
        got = {k: fused.LAUNCHES[k] for k in ("K1", "K2")}
        want = {"K1": R * ast["winfused"], "K2": R * ast["megawin"]}
        check(got == want, f"API route at R = {R}: launches {got} != "
              f"shards x program {want}")
        launches["K1"] += got["K1"]
        launches["K2"] += got["K2"]
        model = remap_model(C, PD, aprog, afinal, n, nloc, 4)
        check(counted(PD) == model, f"API route at R = {R}: exchanges "
              f"{counted(PD)} != cost model {model}")
        amps = q.amps
        err_one = max(float((amps.shards[s].cpu()
                             - psi_flat[:, s << nloc:(s + 1) << nloc])
                            .abs().max()) for s in range(R))
        check(err_one <= 1e-5 and abs(p_a - p_one) <= 1e-5
              and abs(total - 1) <= 1e-4,
              f"API route at R = {R}: |psi - one register| {err_one}, "
              f"P(top=0) {p_a} vs {p_one}, total {total}")
        qt.destroyQureg(q, env)
        rec["api"] = {"program": ast, "launches": got, "exchanges": model,
                      "p_top_zero": p_a, "calc_total_prob": total,
                      "max_abs_err_vs_one_register": err_one}
        out["meshes"][str(R)] = rec
        torch.cuda.empty_cache()

    # config 4's noise layer on a density register split over 4 shards
    nq, R = N_DIST_RHO, R_DIST_RHO
    nn = 2 * nq
    nloc = nn - 2
    env = mesh_env(qt, R)
    kops = noise.bench_kraus_ops(NOISE_SEED)
    shadow_env = qt.createQuESTEnv(device="cpu")
    from quest_tpu_torch.qureg import Qureg

    shadow = Qureg(nq, shadow_env, True)
    fusion.start_gate_fusion(shadow)
    noise.noise_layer(qt, shadow, nq, kops, prob=NOISE_P)
    nitems = list(shadow._fusion.gates)
    nprog, _nf = fusion.plan_items_sharded(nitems, nn, nloc, device=DEVICE,
                                           sweep_ok=True)
    sweeps = [p[1] for p in nprog if p[0] == "chansweep"]
    per_shard = sum(k5_launches(fused, e, nloc) for e in sweeps)
    fused.reset_launch_counts()
    PD.reset_counters()
    rho = dist_noise(qt, noise, env, nq, kops)
    k5 = fused.LAUNCHES["K5"]
    check(per_shard > 0 and k5 == R * per_shard, f"noise layer at R = {R}: "
          f"{k5} K5 launches, not {R} shards x {per_shard}")
    launches["K5"] = k5
    with plain_channel_kernel(fused):
        rho_p = dist_noise(qt, noise, env, nq, kops)
    same = shards_equal(torch, rho._amps, rho_p._amps)
    check(same, f"noise layer at R = {R}: K5 route not bit-identical to "
          "its plain route")
    qt.destroyQureg(rho_p, env)
    one, _psi = noise_run(qt, noise, nq, kops)
    a = rho.amps
    ref = one.amps.reshape(2, -1)
    m = 1 << nloc
    err = max(max_abs_diff(torch, a.shards[s], ref[:, s * m:(s + 1) * m])
              for s in range(R))
    check(err <= 1e-6, f"noise layer at R = {R}: |rho - one register| "
          f"{err}")
    out["noise"] = {"n": nq, "state_bits": nn, "shards": R, "nloc": nloc,
                    "program": program_counts(fusion, nprog),
                    "k5_launches_per_shard": per_shard, "k5_launches": k5,
                    "bit_identical_to_plain_route": same,
                    "max_abs_err_vs_one_register": err}
    qt.destroyQureg(rho, env)
    qt.destroyQureg(one, one.env)
    torch.cuda.empty_cache()
    out["eager"] = dist_eager(torch, np, qt)
    out["launches"] = launches
    return out, launches


def dist_eager(torch, np, qt):
    """Config 2's 26 qubits on 8 shards, gate by gate with no fusion: a
    random one-qubit unitary on every qubit (the local route, then the
    exchange route on the sharded ones), a 3-target gate on local qubits,
    a 2-target gate reaching a sharded qubit (relocalization) and a gate
    under a sharded control, against the same gates on one register.
    Then the local route's 3-target gate on the shards (a fixed-order
    sum, sharded.apply_matrix_local) timed against the ordinary
    kernels.apply_matrix on each 2^23 shard."""
    from quest_tpu_torch.ops import kernels
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH
    from quest_tpu_torch.parallel.mesh import ShardedAmps

    n, R = N_DIST, 8
    nloc = n - 3
    rng = np.random.default_rng(DIST_SEED)
    u1 = [random_unitary(rng, 2) for _ in range(n)]
    u2 = random_unitary(rng, 4)
    u3 = random_unitary(rng, 8)
    gates = n + 3

    def run(env):
        q = qt.createQureg(n, env)
        for t in range(n):
            qt.unitary(q, t, u1[t])
        qt.multiQubitUnitary(q, [0, 1, 2], u3)
        qt.multiQubitUnitary(q, [n - 1, 4], u2)
        qt.controlledUnitary(q, n - 2, 5, u1[0])
        sync()
        return q

    env = mesh_env(qt, R)
    PD.reset_counters()
    t0 = time.perf_counter()
    qm = run(env)
    wall = time.perf_counter() - t0
    routes = {r: int(PD.counter_sum("dispatch_route_total", route=r))
              for r in ("perm_local", "exchange_1q", "relocalize",
                        "default")}
    check(all(routes[r] > 0 for r in ("perm_local", "exchange_1q",
                                      "relocalize")),
          f"eager gates at R = {R}: a route was not taken: {routes}")
    one = run(qt.createQuESTEnv())
    ref = one.amps.reshape(2, -1)
    a = qm.amps
    tol = gates * tolerance(ref)
    m = 1 << nloc
    err = max(max_abs_diff(torch, a.shards[s], ref[:, s * m:(s + 1) * m])
              for s in range(R))
    check(err <= tol, f"eager gates at R = {R}: |psi - one register| "
          f"{err} > {tol}")
    qt.destroyQureg(one, one.env)
    del ref
    # one 3-target gate on local qubits: both forms on the same shards
    mat = np.stack([u3.real, u3.imag])
    targets = (0, 1, 2)
    base = [sh.clone() for sh in a.shards]
    got = SH.apply_matrix_local(ShardedAmps(env.mesh, [s.clone()
                                                       for s in base]),
                                mat, targets=targets)
    want = [kernels.apply_matrix(s, mat, num_qubits=nloc, targets=targets)
            for s in base]
    gtol = tolerance(base[0])
    gerr = max(max_abs_diff(torch, x, y) for x, y in zip(got.shards, want))
    check(gerr <= gtol, f"eager 3-target gate at nloc = {nloc}: fixed-order "
          f"sum against kernels.apply_matrix {gerr} > {gtol}")
    del got, want
    work = ShardedAmps(env.mesh, [s.clone() for s in base])
    fixed_ms = time_ms(lambda: SH.apply_matrix_local(
        work, mat, targets=targets), reps=3, warmup=0)
    del work
    matmul_ms = time_ms(lambda: [kernels.apply_matrix(
        s, mat, num_qubits=nloc, targets=targets) for s in base], reps=3,
        warmup=0)
    qt.destroyQureg(qm, env)
    del base, a
    torch.cuda.empty_cache()
    return {"n": n, "shards": R, "nloc": nloc, "gates": gates,
            "routes": routes, "wall_s": wall,
            "max_abs_err_vs_one_register": err, "tolerance": tol,
            "three_target_gate": {
                "targets": list(targets), "shard_amps": m,
                "max_abs_err_fixed_order_vs_matmul": gerr,
                "fixed_order_ms_all_shards": fixed_ms,
                "apply_matrix_ms_all_shards": matmul_ms,
                "fixed_order_over_apply_matrix": fixed_ms / matmul_ms}}


@contextmanager
def event_timed(torch, targets):
    """Each (module, name, label) of ``targets``: the function replaced,
    for the block, by one that records CUDA events around each call.
    Yields a dict that holds, once the block has ended, the ms of each
    label summed over its calls (a label's calls include the labelled
    calls made inside them)."""
    marks = []
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def wrap(fn, label):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks.append((label, start, end))
            return out
        return timed

    ms: dict = {}
    for (mod, name, fn), (_mod, _name, label) in zip(saved, targets):
        setattr(mod, name, wrap(fn, label))
    try:
        yield ms
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    sync()
    for label, start, end in marks:
        ms[label] = ms.get(label, 0.0) + start.elapsed_time(end)


def timed_drain(torch, PD, fusion, fused, kernels, a, program, nloc, key):
    """fusion.execute_sharded_program, the drain a user's register runs,
    with CUDA events around its exchanges (dist._remap_shards), its shard
    runs (fusion.execute_program) and, inside those, each K1 and K2
    launch and each gatherperm: (state, ms summed over the shards for
    "exchange", "K1", "K2", "gatherperm" and "other", the rest of the
    shard runs)."""
    with event_timed(torch, [
            (PD, "_remap_shards", "exchange"),
            (fusion, "execute_program", "shard_runs"),
            (fused, "apply_window_stack", "K1"),
            (fused, "apply_window_megastack", "K2"),
            (kernels, "apply_index_permutation", "gatherperm")]) as ms:
        a = fusion.execute_sharded_program(a, program, (), nloc, key=key)
    out = {kind: ms.get(kind, 0.0)
           for kind in ("exchange", "K1", "K2", "gatherperm")}
    out["other"] = (ms.get("shard_runs", 0.0) - out["K1"] - out["K2"]
                    - out["gatherperm"])
    return a, out


def phase_dist_timing(torch, np, qt, C, fused, fusion, circuits, us,
                      kernels):
    """Wall time per circuit at R = 1, 2 and 8 (the API route), the bench
    route's drain (execute_sharded_program) with its device ms split into
    K1, K2, gatherperm, the other shard ops and the exchange copies, with
    the bytes the copies move, and one 30-qubit bench-route circuit at
    R = 8 with its peak memory."""
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH

    n = N_DIST
    out = {"n": n, "walls": {}, "split": {}}
    gates = circuits.bench_gate_list(n, DEPTH, us)
    for R in (1,) + DIST_MESHES:
        env = mesh_env(qt, R)

        def api_route(env=env):
            q = qt.createQureg(n, env)
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
            p = qt.calcProbOfOutcome(q, n - 1, 0)
            qt.destroyQureg(q, env)
            return p

        samples = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            api_route()
            sync()
            samples.append(time.perf_counter() - t0)
        out["walls"][str(R)] = {"api_route_wall_s": statistics.median(
            samples), "samples_s": samples}
        if R == 1:
            continue
        nloc = n - (R.bit_length() - 1)
        prog, _final = fusion.plan_items_sharded(gates, n, nloc,
                                                 device=DEVICE,
                                                 optimize=False)
        sigmas = [p[1] for p in prog if p[0] == "remap"]
        per_shard = sum(C.remap_exchange_bytes(s, n, nloc, 4)
                        for s in sigmas)
        splits = []
        for _ in range(3):
            a = SH.classical(env.mesh, nloc, torch.float32, 0)
            a, by_kind = timed_drain(torch, PD, fusion, fused, kernels, a,
                                     prog, nloc, ("dist_timing", n, R))
            splits.append(by_kind)
            del a
        by_kind = {kind: statistics.median(s[kind] for s in splits)
                   for kind in splits[0]}
        x_ms = by_kind["exchange"]
        moved = per_shard * R
        out["split"][str(R)] = {
            "remaps": len(sigmas), "ms_by_part": by_kind,
            "count_all_shards": {kind: v if kind == "remap" else R * v
                                 for kind, v in
                                 program_op_counts(prog).items()},
            "kernels_ms": by_kind["K1"] + by_kind["K2"],
            "exchange_ms": x_ms, "device_ms": sum(by_kind.values()),
            "exchange_bytes_per_shard": per_shard,
            "exchange_bytes_all_shards": moved,
            "exchange_gb_per_s": moved / (x_ms * 1e6) if x_ms else None,
            "exchange_share": x_ms / sum(by_kind.values())}
        torch.cuda.empty_cache()
    # one bench-route circuit at 30 qubits on 8 shards
    nb, R = N_DIST_BIG, 8
    nloc = nb - 3
    env = mesh_env(qt, R)
    ub = circuits.bench_unitaries(nb, DEPTH, seed=SEED)
    t0 = time.perf_counter()
    prog, final = fusion.plan_items_sharded(
        circuits.bench_gate_list(nb, DEPTH, ub), nb, nloc, device=DEVICE,
        optimize=False)
    plan_s = time.perf_counter() - t0
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    a = SH.classical(env.mesh, nloc, torch.float32, 0)
    a, by_kind = timed_drain(torch, PD, fusion, fused, kernels, a, prog,
                             nloc, ("dist_big", nb, R))
    if final is not None and list(final) != list(range(nb)):
        a = PD.remap_sharded(a, num_qubits=nb,
                             sigma=PD.canonical_sigma(final))
    p = float(SH.prob_of_outcome_statevec(a, nb - 1, 0))
    total = float(PD.total_prob_sharded(a))
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    state_bytes = 2 * (1 << nb) * 4
    check(abs(total - 1) <= 1e-3 and 0 <= p <= 1, f"30-qubit circuit at "
          f"R = {R}: total {total}, P(top=0) {p}")
    out["big"] = {"n": nb, "shards": R, "nloc": nloc,
                  "state_bytes": state_bytes, "plan_s": plan_s,
                  "program": program_counts(fusion, prog),
                  "wall_s": wall, "ms_by_part": by_kind,
                  "kernels_ms": by_kind["K1"] + by_kind["K2"],
                  "exchange_ms": by_kind["exchange"],
                  "peak_bytes_beside_start": peak,
                  "peak_over_state": peak / state_bytes,
                  "p_top_zero": p, "calc_total_prob": total}
    del a
    torch.cuda.empty_cache()
    return out


def _nccl_worker(rank, world, port, n, out_dir):
    """One torch.distributed rank of phase_dist_nccl: config 2's circuit
    (depth 4) at ``n`` qubits under gateFusion, one shard per card."""
    import numpy as np
    import torch.distributed as dist

    import quest_tpu_torch as qt
    from quest_tpu_torch.models import circuits
    from quest_tpu_torch.parallel import sharded as SH

    os.environ["LOCAL_RANK"] = str(rank)
    qt.initDistributed(f"tcp://localhost:{port}", world, rank, "nccl")
    try:
        qt.set_precision(1)
        env = qt.createQuESTEnv()
        us = circuits.bench_unitaries(n, 4, seed=SEED)
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        whole = SH.gather_host(q.amps)
        if rank == 0:
            np.save(os.path.join(out_dir, "nccl.npy"), whole)
        # a checkpoint written by the ranks together (M16g)
        qt.saveQureg(q, os.path.join(out_dir, "nccl_ck"))
    finally:
        dist.destroy_process_group()


def phase_dist_nccl(torch, np, qt, circuits):
    """The torch.distributed backend over NCCL, one shard per card on two
    cards: config 2's circuit (depth 4) at 20 qubits, bit for bit against
    the in-process mesh of two shards on one card; the ranks' saveQureg
    loaded in process onto one register, bit for bit too."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from quest_tpu_torch.parallel import sharded as SH

    n, world = 20, 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_nccl_worker, args=(world, port, n, tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        try:
            deadline = time.perf_counter() + 300
            while not ctx.join(timeout=10):
                check(time.perf_counter() < deadline, "dist_nccl: the ranks "
                      "did not finish in 300 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        got = np.load(os.path.join(tmp, "nccl.npy"))
        qt.set_precision(1)
        loaded = qt.loadQureg(os.path.join(tmp, "nccl_ck"),
                              mesh_env(qt, 1)).amps.cpu().numpy()
    env = mesh_env(qt, world)
    us = circuits.bench_unitaries(n, 4, seed=SEED)
    q = qt.createQureg(n, env)
    with qt.gateFusion(q):
        apply_bench_gates(qt, q, us, n)
    want = SH.gather_host(q.amps)
    same = bool(np.array_equal(got, want))
    check(same, "dist_nccl: the NCCL ranks' state differs from the "
          "in-process mesh's")
    restored = bool(np.array_equal(loaded, want))
    check(restored, "dist_nccl: the ranks' checkpoint loaded in process "
          "differs from the in-process mesh's state")
    return {"n": n, "ranks": world, "bit_identical_to_in_process": same,
            "checkpoint_on_ranks_loaded_in_process": restored}


# ---------------------------------------------------------------------------
# The sharded composites (M15b): the QFT with K6-K9 per shard, Pauli sums
# and Trotter, eager channels, measurement, DiagonalOp and the phase
# functions on registers split over shards of the card
# ---------------------------------------------------------------------------

N_COMP_QFT = 30        # config 3 on 8 shards: nloc = 27, 8.59 GB at float32
R_COMP_QFT = 8
N_COMP_RUN = 26        # applyQFT on the run [0, 25) at R = 2 and 8
COMP_RUN_MESHES = (2, 8)
N_COMP_QFT_RHO = 13    # applyFullQFT on a density register of 2^26 at R = 4
R_COMP_QFT_RHO = 4
N_COMP_PAULI = 30      # config 5 on 8 shards
R_COMP_PAULI = 8
N_COMP_NOISE = 14      # config 4's density register (2^28) at R = 4
R_COMP_NOISE = 4
N_COMP_MEAS = 26       # config 2's circuit, measured in full, R = 2 and 8
COMP_MEAS_MESHES = (2, 8)
N_COMP_DIAG = 30       # a state vector and its operator on 8 shards
N_COMP_DIAG_RHO = 15   # a density register of 2^30 amplitudes on 8 shards
R_COMP_DIAG = 8
COMP_SEED = 4242
QFT_KERNELS = ("K6", "K7", "K8", "K9")


@contextmanager
def checked_qft_kernels(torch, fused, record):
    """K6-K9's wrappers replaced, for the block, by ones that run the
    kernel on the tensor they are given (a shard) and hold its output
    against the plain version on a copy of the same input, bit for bit;
    ``record`` collects, per kernel, the calls, the shard sizes and the
    largest difference."""
    names = ("apply_qft_multi_hi", "apply_qft_cluster_multi",
             "apply_qft_ladder_pallas")
    saved = {name: getattr(fused, name) for name in names}

    def same(key, y, yp, n):
        sync()
        rec = record.setdefault(key, {"calls": 0, "shard_bits": [],
                                      "max_abs_err": 0.0})
        rec["calls"] += 1
        if n not in rec["shard_bits"]:
            rec["shard_bits"].append(n)
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 max_abs_diff(torch, y, yp))
        check(torch.equal(y, yp), f"{key} on a {n}-bit shard is not "
              "bit-identical to its plain version")

    def multi_hi(amps, *, num_qubits, t_hi, t_lo, conj=False):
        x0 = amps.clone()
        y = saved["apply_qft_multi_hi"](amps, num_qubits=num_qubits,
                                        t_hi=t_hi, t_lo=t_lo, conj=conj)
        same("K8", y, fused.qft_multi_hi_plain(
            x0, num_qubits=num_qubits, t_hi=t_hi, t_lo=t_lo, conj=conj),
            num_qubits)
        return y

    def cluster(amps, *, num_qubits, conj=False):
        x0 = amps.clone()
        y = saved["apply_qft_cluster_multi"](amps, num_qubits=num_qubits,
                                             conj=conj)
        same("K9", y, fused.qft_cluster_multi_plain(
            x0, num_qubits=num_qubits, conj=conj), num_qubits)
        return y

    def ladder(amps, *, num_qubits, target, conj=False):
        x0 = amps.clone()
        y = saved["apply_qft_ladder_pallas"](amps, num_qubits=num_qubits,
                                             target=target, conj=conj)
        lo = target < fused.CLUSTER_QUBITS
        plain = fused.qft_ladder_lo_plain if lo else fused.qft_ladder_plain
        same("K7" if lo else "K6", y, plain(
            x0, num_qubits=num_qubits, target=target, conj=conj), num_qubits)
        return y

    fused.apply_qft_multi_hi = multi_hi
    fused.apply_qft_cluster_multi = cluster
    fused.apply_qft_ladder_pallas = ladder
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)


def sharded_register(qt, SH, env, n, x, density=False):
    """A register of ``env``'s mesh holding the whole state ``x`` split
    into its shards (x is left as it was)."""
    q = (qt.createDensityQureg(n // 2, env) if density
         else qt.createQureg(n, env))
    q.amps = SH.split(env.mesh, x, n - (len(env.devices).bit_length() - 1),
                      x.dtype)
    return q


def sharded_vs_whole(torch, amps, whole) -> float:
    """max |shard - the same slice of the whole state| over the shards."""
    whole = whole.reshape(2, -1)
    m = 1 << amps.nloc
    return max(max_abs_diff(torch, sh, whole[:, s * m:(s + 1) * m])
               if sh.numel() >= 1 << 25
               else float((sh - whole[:, s * m:(s + 1) * m]).abs().max())
               for s, sh in zip(amps.mesh.local, amps.shards))


def whole_tolerance(torch, whole) -> float:
    return tolerance(whole.reshape(2, -1))


def comp_counts(fused) -> dict:
    return {k: fused.LAUNCHES[k] for k in ("K1", "K2") + QFT_KERNELS}


def exchanges_by_op(PD, ops) -> dict:
    return {op: [int(PD.counter_sum("exchanges_total", op=op)),
                 int(PD.counter_sum("exchange_bytes_total", op=op))]
            for op in ops
            if PD.counter_sum("exchanges_total", op=op)}


def qft_model(COMP, n, R, itemsize, runs=None):
    """The reference's exchange model of a sharded QFT: [count, per-shard
    bytes] by op family."""
    nloc = n - (R.bit_length() - 1)
    payload = 2 * (1 << nloc) * itemsize
    if runs is None:
        return {"qft": [R.bit_length() - 1 + 1,
                        (R.bit_length() - 1) * payload
                        + payload * (R - 1) // R]}
    cnt, nbytes = COMP.qft_runs_exchange_model(runs, nloc, itemsize)
    return {"qft_runs": [cnt, nbytes]} if cnt else {}


def phase_dist_composites_parity(torch, np, qt, fused):
    """K6-K9 on every shard of the sharded QFT routes, each launch held
    bit for bit against its plain version on the same shard: config 3's
    30-qubit QFT on 8 shards (K8 and K9), applyQFT on the run [0, 25) of
    26 qubits on 8 shards (K6 and K7 per layer) and applyFullQFT on a
    13-qubit density register on 4 shards (K7 in its ket run)."""
    from quest_tpu_torch.parallel import sharded as SH

    qt.set_precision(1)
    record: dict = {}
    out = {"cases": []}
    cases = ((N_COMP_QFT, R_COMP_QFT, False, None),
             (N_COMP_RUN, 8, False, list(range(N_COMP_RUN - 1))),
             (2 * N_COMP_QFT_RHO, R_COMP_QFT_RHO, True, None))
    for n, R, density, run in cases:
        env = mesh_env(qt, R)
        x = random_state(torch, n, COMP_SEED + n)
        q = sharded_register(qt, SH, env, n, x, density)
        del x
        before = {k: dict(v) for k, v in record.items()}
        with checked_qft_kernels(torch, fused, record):
            if run is None:
                qt.applyFullQFT(q)
            else:
                qt.applyQFT(q, run)
        check(bool(all(torch.isfinite(s).all() for s in q.amps.shards)),
              f"sharded QFT at {n} bits, R = {R}: bad state")
        calls = {k: v["calls"] - before.get(k, {}).get("calls", 0)
                 for k, v in record.items()}
        out["cases"].append({"n_state_bits": n, "shards": R,
                             "density": density, "run": run and
                             [run[0], len(run)], "kernel_calls": calls})
        qt.destroyQureg(q, env)
        del q
        torch.cuda.empty_cache()
    for key in QFT_KERNELS:
        check(record.get(key, {}).get("calls", 0) > 0,
              f"{key} was never held against its plain version on a shard")
    out["kernels"] = record
    return out


def sampled_sharded(torch, np, amps, idx):
    """The global amplitudes ``idx`` of sharded amplitudes as a complex
    NumPy array, each read from its shard."""
    nloc = amps.nloc
    idx = np.asarray(idx)
    out = np.zeros(idx.size, dtype=np.complex128)
    for s, sh in zip(amps.mesh.local, amps.shards):
        sel = np.nonzero((idx >> nloc) == s)[0]
        if sel.size:
            loc = torch.as_tensor(idx[sel] & ((1 << nloc) - 1),
                                  device=sh.device)
            a = sh[:, loc].double().cpu().numpy()
            out[sel] = a[0] + 1j * a[1]
    return out


def phase_dist_composites_main(torch, np, qt, C, fused, paulis, hamiltonians,
                               circuits, api_ops):
    """Each sharded composite route against the one-register route at
    full width, float32, the launch counts reset just before each route
    and read just after.  Returns (phase record, per-shard launches by
    kernel over the routes)."""
    from quest_tpu_torch.parallel import composites as COMP
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH

    qt.set_precision(1)
    env1 = qt.createQuESTEnv()
    out = {}
    totals = {k: 0 for k in ("K1", "K2") + QFT_KERNELS}

    def run_counted(fn):
        fused.reset_launch_counts()
        PD.reset_counters()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        counts = comp_counts(fused)
        for k, v in counts.items():
            totals[k] += v
        return counts, wall

    families = ("qft", "qft_runs", "trotter", "expec", "pair_channel",
                "depol2", "matrix_1q", "swap", "remap", "window_remap",
                "gather")

    # (a) config 3 on 8 shards: applyFullQFT at 30 qubits
    n, R = N_COMP_QFT, R_COMP_QFT
    nloc = n - 3
    env = mesh_env(qt, R)
    x = random_state(torch, n, COMP_SEED)
    q = sharded_register(qt, SH, env, n, x)
    y = C.fused_qft(x, n, 0, n).reshape(2, -1)
    del x
    counts, wall = run_counted(lambda: qt.applyFullQFT(q))
    err = sharded_vs_whole(torch, q._amps, y)
    tol = whole_tolerance(torch, y)
    check(err <= tol, f"sharded QFT at {n} qubits: |err| {err} > {tol}")
    exch = exchanges_by_op(PD, families)
    model = qft_model(COMP, n, R, 4)
    check(exch == model, f"sharded QFT exchanges {exch} != model {model}")
    per_shard = -(-(nloc - 14) // 4)
    check(counts["K8"] == R * per_shard and counts["K9"] == R
          and counts["K6"] == counts["K7"] == 0,
          f"sharded QFT launches {counts}: want K8 {R * per_shard}, K9 {R}")
    out["qft_full"] = {"n": n, "shards": R, "nloc": nloc,
                       "launches": counts,
                       "launches_per_shard": {k: counts[k] / R
                                              for k in QFT_KERNELS},
                       "max_abs_err_vs_one_register": err, "tolerance": tol,
                       "exchanges": exch, "exchange_model": model,
                       "first_wall_s": wall}
    qt.destroyQureg(q, env)
    del q, y
    torch.cuda.empty_cache()

    # (b) applyQFT on the run [0, 25) of 26 qubits at R = 2 (inside a
    # shard: the fused QFT per shard) and R = 8 (reaching mesh bits)
    n = N_COMP_RUN
    run = list(range(n - 1))
    x = random_state(torch, n, COMP_SEED + 1)
    q1 = qt.createQureg(n, env1)
    q1.amps = x.clone()
    qt.applyQFT(q1, run)
    y = q1.amps
    tol = whole_tolerance(torch, y)
    out["qft_run"] = {}
    for R in COMP_RUN_MESHES:
        env = mesh_env(qt, R)
        q = sharded_register(qt, SH, env, n, x)
        counts, wall = run_counted(lambda: qt.applyQFT(q, run))
        err = sharded_vs_whole(torch, q._amps, y)
        check(err <= tol, f"applyQFT run at R = {R}: |err| {err} > {tol}")
        exch = exchanges_by_op(PD, families)
        model = qft_model(COMP, n, R, 4, [(0, n - 1, False)])
        check(exch == model, f"applyQFT run at R = {R}: exchanges {exch} "
              f"!= model {model}")
        out["qft_run"][str(R)] = {
            "n": n, "run": [0, n - 1], "launches": counts,
            "launches_per_shard": {k: counts[k] / R for k in QFT_KERNELS},
            "max_abs_err_vs_one_register": err, "tolerance": tol,
            "exchanges": exch, "exchange_model": model,
            "first_wall_s": wall}
        qt.destroyQureg(q, env)
        del q
    check(out["qft_run"]["8"]["launches"]["K6"] > 0
          and out["qft_run"]["8"]["launches"]["K7"] > 0,
          "the run reaching mesh bits launched no K6 / K7 on its shards")
    qt.destroyQureg(q1, env1)
    del q1, x, y
    torch.cuda.empty_cache()

    # (c) applyFullQFT on a 13-qubit density register at R = 4
    m, R = N_COMP_QFT_RHO, R_COMP_QFT_RHO
    x = random_state(torch, 2 * m, COMP_SEED + 2)
    r1 = qt.createDensityQureg(m, env1)
    r1.amps = x.clone()
    qt.applyFullQFT(r1)
    env = mesh_env(qt, R)
    r = sharded_register(qt, SH, env, 2 * m, x, density=True)
    counts, wall = run_counted(lambda: qt.applyFullQFT(r))
    err = sharded_vs_whole(torch, r._amps, r1.amps)
    tol = whole_tolerance(torch, r1.amps)
    check(err <= tol, f"density QFT at R = {R}: |err| {err} > {tol}")
    exch = exchanges_by_op(PD, families)
    model = qft_model(COMP, 2 * m, R, 4, [(0, m, False), (m, m, True)])
    check(exch == model, f"density QFT exchanges {exch} != {model}")
    out["qft_density"] = {"n": m, "shards": R, "launches": counts,
                          "launches_per_shard": {k: counts[k] / R
                                                 for k in QFT_KERNELS},
                          "max_abs_err_vs_one_register": err,
                          "tolerance": tol, "exchanges": exch,
                          "exchange_model": model, "first_wall_s": wall}
    qt.destroyQureg(r, env)
    qt.destroyQureg(r1, env1)
    del r, r1, x
    torch.cuda.empty_cache()

    # (d) config 5 on 8 shards: the 16-term PauliHamil on |+>^30
    n, R = N_COMP_PAULI, R_COMP_PAULI
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   seed=PAULI_SEED)
    scale = float(np.abs(coeffs).sum())
    q1, h, e0_1, e1_1, _total = config5(qt, n, coeffs, codes)
    env = mesh_env(qt, R)
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    paulis.reset_launch_counts()
    PD.reset_counters()
    sync()
    t0 = time.perf_counter()
    e0 = qt.calcExpecPauliHamil(q, h)
    qt.applyTrotterCircuit(q, h, *TROTTER)
    e1 = qt.calcExpecPauliHamil(q, h)
    sync()
    wall = time.perf_counter() - t0
    rotations = len(api_ops._trotter_schedule(PAULI_TERMS, *TROTTER))
    exch = exchanges_by_op(PD, families)
    payload = 2 * (1 << (n - 3)) * 4
    model = {"trotter": [rotations, rotations * payload],
             "expec": [2 * PAULI_TERMS, 2 * PAULI_TERMS * payload]}
    check(exch == model, f"config 5 sharded exchanges {exch} != {model}")
    check(dict(paulis.LAUNCHES) == {"K3": 0, "K4": 0},
          "the sharded Pauli body launched K3 / K4 (it is plain PyTorch)")
    err = sharded_vs_whole(torch, q._amps, q1.amps)
    tol = whole_tolerance(torch, q1.amps)
    check(err <= tol, f"sharded Trotter: |err| {err} > {tol}")
    for got, want in ((e0, e0_1), (e1, e1_1)):
        check(abs(got - want) <= 1e-5 * scale,
              f"sharded energy {got} vs one register {want}")
    out["pauli"] = {"n": n, "shards": R, "terms": PAULI_TERMS,
                    "rotations": rotations, "e0": e0, "e1": e1,
                    "e0_one_register": e0_1, "e1_one_register": e1_1,
                    "max_abs_err_vs_one_register": err, "tolerance": tol,
                    "bit_identical_to_one_register": bool(all(
                        torch.equal(sh, q1.amps[:, s << (n - 3):
                                                (s + 1) << (n - 3)])
                        for s, sh in zip(q._amps.mesh.local,
                                         q._amps.shards))),
                    "exchanges": exch, "exchange_model": model,
                    "first_wall_s": wall}
    qt.destroyQureg(q, env)
    qt.destroyQureg(q1, env1)
    del q, q1
    torch.cuda.empty_cache()

    # (e) config 4's density register at R = 4, eager channels on targets
    # whose bra bit is a mesh bit (12, 13) and on local ones (0, 1)
    m, R = N_COMP_NOISE, R_COMP_NOISE
    x = random_state(torch, 2 * m, COMP_SEED + 3)
    r1 = qt.createDensityQureg(m, env1)
    r1.amps = x.clone()
    env = mesh_env(qt, R)
    r = sharded_register(qt, SH, env, 2 * m, x, density=True)
    o1 = qt.createDensityQureg(m, env1)
    o1.amps = random_state(torch, 2 * m, COMP_SEED + 4)
    o = sharded_register(qt, SH, env, 2 * m, o1.amps, density=True)
    del x
    p = NOISE_P
    steps = []
    for a, b in ((m - 2, m - 1), (0, 1)):
        steps += [("mixDephasing", lambda qq, a=a: qt.mixDephasing(qq, a, p)),
                  ("mixDepolarising",
                   lambda qq, a=a: qt.mixDepolarising(qq, a, p)),
                  ("mixDamping", lambda qq, b=b: qt.mixDamping(qq, b, p)),
                  ("mixTwoQubitDephasing",
                   lambda qq, a=a, b=b: qt.mixTwoQubitDephasing(qq, a, b, p)),
                  ("mixTwoQubitDepolarising",
                   lambda qq, a=a, b=b: qt.mixTwoQubitDepolarising(qq, a, b,
                                                                   p))]
    PD.reset_counters()
    errs = {}
    walls = {}
    for i, (label, fn) in enumerate(steps):
        fn(r1)
        sync()
        t0 = time.perf_counter()
        fn(r)
        sync()
        key = f"{label}_{'mesh' if i < 5 else 'local'}"
        walls[key] = time.perf_counter() - t0
        errs[key] = sharded_vs_whole(torch, r._amps, r1.amps)
        check(errs[key] <= 1e-6, f"{key}: |err| {errs[key]} > 1e-6")
    qt.mixDensityMatrix(r1, 0.25, o1)
    qt.mixDensityMatrix(r, 0.25, o)
    errs["mixDensityMatrix"] = sharded_vs_whole(torch, r._amps, r1.amps)
    check(errs["mixDensityMatrix"] <= 1e-6, "mixDensityMatrix: |err| "
          f"{errs['mixDensityMatrix']}")
    exch = exchanges_by_op(PD, families)
    payload = 2 * (1 << (2 * m - 2)) * 4
    model = {"pair_channel": [2, 2 * payload], "depol2": [2, 2 * payload]}
    check(exch == model, f"eager channels exchanges {exch} != {model}")
    out["channels"] = {"n": m, "shards": R, "p": p,
                       "max_abs_err_vs_one_register": errs,
                       "walls_s": walls, "exchanges": exch,
                       "exchange_model": model}
    for qq, e in ((r, env), (o, env), (r1, env1), (o1, env1)):
        qt.destroyQureg(qq, e)
    del r, o, r1, o1
    torch.cuda.empty_cache()

    # (f) config 2's circuit at 26 qubits on R = 2 and 8, measured in full
    n = N_COMP_MEAS
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    q1 = qt.createQureg(n, env1)
    with qt.gateFusion(q1):
        apply_bench_gates(qt, q1, us, n)
    qt.seedQuEST(env1, [1234])
    outs1, probs1 = qt.measureSequence(q1, list(range(n)))
    qt.destroyQureg(q1, env1)
    out["measure"] = {"n": n, "outcomes_one_register": outs1}
    for R in COMP_MEAS_MESHES:
        env = mesh_env(qt, R)
        q = qt.createQureg(n, env)

        def measured():
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
            qt.seedQuEST(env, [1234])
            return qt.measureSequence(q, list(range(n)))

        fused.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        outs, probs = measured()
        sync()
        wall = time.perf_counter() - t0
        counts = comp_counts(fused)
        for k, v in counts.items():
            totals[k] += v
        check(outs == outs1, f"measureSequence at R = {R}: outcomes {outs} "
              f"!= one register's {outs1}")
        perr = max(abs(a - b) for a, b in zip(probs, probs1))
        check(perr <= 1e-5, f"measureSequence at R = {R}: probabilities "
              f"stray {perr}")
        xo = sum(o << i for i, o in enumerate(outs))
        amp = abs(qt.getAmp(q, xo))
        check(abs(amp - 1) <= 1e-5, f"measured state at R = {R}: |amp| {amp}")
        out["measure"][str(R)] = {"outcomes_equal": True,
                                  "prob_max_abs_diff": perr,
                                  "amp_at_outcome": amp,
                                  "launches": counts,
                                  "circuit_and_measure_wall_s": wall}
        qt.destroyQureg(q, env)
        del q
    torch.cuda.empty_cache()

    # (g) DiagonalOp and the phase functions at 30 qubits on 8 shards:
    # the one-register route's sampled amplitudes first, then the sharded
    n, R = N_COMP_DIAG, R_COMP_DIAG
    rng = np.random.default_rng(DIAG_SEED)
    codes, w = maxcut_ring(n, DIAG_SEED)
    idx = np.concatenate([[0, (1 << n) - 1],
                          rng.integers(0, 1 << n, DIAG_SAMPLES)])
    idx_t = torch.as_tensor(idx, device=DEVICE)
    hamil = qt.createPauliHamil(n, codes.shape[0])
    qt.initPauliHamil(hamil, w, codes)
    half = n // 2
    c1, c2 = 2.0 ** -28, 2.0 ** -58
    over = {0: 0.5, (1 << n) - 1: -1.0}

    def sample(amps):
        if isinstance(amps, SH.ShardedAmps):
            return sampled_sharded(torch, np, amps, idx)
        a = amps[:, idx_t].double().cpu().numpy()
        return a[0] + 1j * a[1]

    def diag_route(q, env):
        op = qt.createDiagonalOp(n, env)
        qt.initDiagonalOpFromPauliHamil(op, hamil)
        op.imag = torch.sin(op.real)
        qt.initPlusState(q)
        res = {"expec_plus": qt.calcExpecDiagonalOp(q, op)}
        qt.applyDiagonalOp(q, op)
        res["expec_after"] = qt.calcExpecDiagonalOp(q, op)
        del op
        torch.cuda.empty_cache()
        res["after_op"] = sample(q.amps)
        qt.applyPhaseFuncOverrides(q, list(range(n)), qt.UNSIGNED, [c1, c2],
                                   [1.0, 2.0], list(over),
                                   list(over.values()))
        qt.applyParamNamedPhaseFunc(q, list(range(n)), [half, half],
                                    qt.UNSIGNED, qt.SCALED_DISTANCE,
                                    [2.0 ** -13])
        return res

    q1 = qt.createQureg(n, env1)
    res1 = diag_route(q1, env1)
    want_op = res1.pop("after_op")
    want = sample(q1.amps)
    qt.destroyQureg(q1, env1)
    del q1
    torch.cuda.empty_cache()
    env = mesh_env(qt, R)
    q = qt.createQureg(n, env)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = diag_route(q, env)
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    amp = 2.0 ** (-n / 2)
    tol_a = 1e-5 * amp * max(1.0, float(np.abs(w).sum()))
    err_op = float(np.abs(res.pop("after_op") - want_op).max())
    err = float(np.abs(sample(q.amps) - want).max())
    check(err_op <= tol_a and err <= tol_a, f"sharded DiagonalOp / phase "
          f"functions: |err| {err_op}, {err} > {tol_a}")
    tol_e = 1e-5 * float(np.abs(w).sum())
    for key in ("expec_plus", "expec_after"):
        check(abs(res[key] - res1[key]) <= tol_e,
              f"sharded {key} {res[key]} vs one register {res1[key]}")
    qt.destroyQureg(q, env)
    del q
    torch.cuda.empty_cache()
    # a 15-qubit density register (2^30) through apply_diag_op_density_sharded
    m = N_COMP_DIAG_RHO
    vals = rng.uniform(-1, 1, 1 << m) + 1j * rng.uniform(-1, 1, 1 << m)
    x = random_state(torch, 2 * m, COMP_SEED + 5)
    r1 = qt.createDensityQureg(m, env1)
    r1.amps = x.clone()
    dop1 = qt.createDiagonalOp(m, env1)
    qt.initDiagonalOp(dop1, vals.real, vals.imag)
    e_r1 = qt.calcExpecDiagonalOp(r1, dop1)
    qt.applyDiagonalOp(r1, dop1)
    r = sharded_register(qt, SH, env, 2 * m, x, density=True)
    del x
    dop = qt.createDiagonalOp(m, env)
    qt.initDiagonalOp(dop, vals.real, vals.imag)
    sync()
    t0 = time.perf_counter()
    e_r = qt.calcExpecDiagonalOp(r, dop)
    qt.applyDiagonalOp(r, dop)
    sync()
    wall_rho = time.perf_counter() - t0
    err_rho = sharded_vs_whole(torch, r._amps, r1.amps)
    tol_rho = whole_tolerance(torch, r1.amps) * float(np.abs(vals).max())
    check(err_rho <= tol_rho and abs(e_r - e_r1) <= 1e-5 * float(
        np.abs(vals).max()), f"sharded D rho: |err| {err_rho}, Tr {e_r} vs "
          f"{e_r1}")
    out["diagonal"] = {
        "n": n, "shards": R, "samples": int(idx.size),
        "max_abs_err_op_vs_one_register": err_op,
        "max_abs_err_phase_vs_one_register": err, "tolerance": tol_a,
        "expec": {k: [res[k].real, res[k].imag] for k in res},
        "expec_one_register": {k: [res1[k].real, res1[k].imag]
                               for k in res1},
        "wall_s": wall, "peak_bytes_beside_start": peak,
        "density": {"n": m, "shards": R, "max_abs_err": err_rho,
                    "tolerance": tol_rho, "expec": [e_r.real, e_r.imag],
                    "expec_one_register": [e_r1.real, e_r1.imag],
                    "wall_s": wall_rho}}
    for qq, e in ((r, env), (r1, env1)):
        qt.destroyQureg(qq, e)
    del r, r1, dop, dop1
    torch.cuda.empty_cache()
    out["launches"] = totals
    return out, totals


def phase_dist_composites_timing(torch, qt, fused, hamiltonians):
    """Walls of the sharded routes against the one-register routes, and
    each sharded route's device ms split into the kernels (K6-K9), the
    exchange copies (the mesh's permute and all_to_all) and the plain ops
    (the rest), by CUDA events; the per-shard launches of K6-K9."""
    from quest_tpu_torch.ops import kernels
    from quest_tpu_torch.parallel import composites as COMP

    qt.set_precision(1)
    env1 = qt.createQuESTEnv()
    out = {}

    def walls(fn, reps=3):
        samples = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples)

    def split(env, fn, stages=()):
        """(total device ms, {kernels, exchange, plain}) of one call, and
        the ms of each (module, name, label) of ``stages`` (each stage's
        calls, the kernels and copies inside them included)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with event_timed(torch, [
                (fused, "apply_qft_multi_hi", "kernels"),
                (fused, "apply_qft_cluster_multi", "kernels"),
                (fused, "apply_qft_ladder_pallas", "kernels"),
                (env.mesh, "permute", "exchange"),
                (env.mesh, "all_to_all", "exchange"), *stages]) as ms:
            start.record()
            fn()
            end.record()
        total = start.elapsed_time(end)
        parts = {k: ms.get(k, 0.0) for k in ("kernels", "exchange")}
        parts["plain"] = total - parts["kernels"] - parts["exchange"]
        for _mod, _name, label in stages:
            parts[label] = ms.get(label, 0.0)
        return total, parts

    # config 3: the whole-register QFT at 30 qubits, one register and R = 8
    n, R = N_COMP_QFT, R_COMP_QFT
    env = mesh_env(qt, R)
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    fused.reset_launch_counts()
    # the stages of the sharded QFT: the mesh-bit layers (exchange,
    # combine, phase), the seven lane layers (plain ladders) and the
    # per-shard transposes of the reversal
    total, parts = split(env, lambda: qt.applyFullQFT(q), stages=(
        (COMP, "_qft_mesh_layer", "stage_mesh_layers"),
        (kernels, "apply_qft_ladder", "stage_ladders"),
        (kernels, "permute_qubits", "stage_reversal_permutes")))
    launches = comp_counts(fused)
    out["qft_full"] = {"n": n, "shards": R,
                       "wall_s": walls(lambda: qt.applyFullQFT(q)),
                       "device_ms": total, "ms_by_part": parts,
                       "launches_per_shard": {k: launches[k] / R
                                              for k in QFT_KERNELS}}
    qt.destroyQureg(q, env)
    del q
    torch.cuda.empty_cache()
    q1 = qt.createQureg(n, env1)
    qt.initPlusState(q1)
    out["qft_full"]["one_register_wall_s"] = walls(
        lambda: qt.applyFullQFT(q1))
    qt.destroyQureg(q1, env1)
    del q1
    torch.cuda.empty_cache()

    # the run [0, 25) of 26 qubits on 8 shards (K6, K7 per shard)
    n = N_COMP_RUN
    env = mesh_env(qt, 8)
    q = qt.createQureg(n, env)
    qt.initPlusState(q)
    fused.reset_launch_counts()
    total, parts = split(env, lambda: qt.applyQFT(q, list(range(n - 1))))
    launches = comp_counts(fused)
    out["qft_run_r8"] = {"n": n, "run": [0, n - 1], "shards": 8,
                         "wall_s": walls(lambda: qt.applyQFT(
                             q, list(range(n - 1)))),
                         "device_ms": total, "ms_by_part": parts,
                         "launches_per_shard": {k: launches[k] / 8
                                                for k in QFT_KERNELS}}
    qt.destroyQureg(q, env)
    del q
    torch.cuda.empty_cache()

    # config 5 at 30 qubits: Trotter and the energy, one register and R = 8
    n, R = N_COMP_PAULI, R_COMP_PAULI
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   seed=PAULI_SEED)
    h = qt.createPauliHamil(n, len(coeffs))
    qt.initPauliHamil(h, coeffs, codes)
    out["pauli"] = {"n": n, "shards": R}
    for label, env in (("one_register", env1), ("sharded", mesh_env(qt, R))):
        q = qt.createQureg(n, env)
        qt.initPlusState(q)
        rec = {"trotter_wall_s": walls(
                   lambda: qt.applyTrotterCircuit(q, h, *TROTTER)),
               "expec_wall_s": walls(lambda: qt.calcExpecPauliHamil(q, h))}
        if env is not env1:
            for key, fn in (("trotter", lambda: qt.applyTrotterCircuit(
                    q, h, *TROTTER)),
                            ("expec", lambda: qt.calcExpecPauliHamil(q, h))):
                total, parts = split(env, fn)
                rec[f"{key}_device_ms"] = total
                rec[f"{key}_ms_by_part"] = parts
        out["pauli"][label] = rec
        qt.destroyQureg(q, env)
        del q
        torch.cuda.empty_cache()

    # measureSequence over 26 qubits at R = 8 against one register
    n = N_COMP_MEAS
    out["measure"] = {"n": n}
    for label, env in (("one_register", env1), ("sharded_r8", mesh_env(qt, 8))):
        q = qt.createQureg(n, env)

        def seq():
            qt.initPlusState(q)
            qt.measureSequence(q, list(range(n)))

        out["measure"][label] = {"ms_per_qubit": walls(seq) * 1e3 / n}
        if env is not env1:
            total, parts = split(env, seq)
            out["measure"][label].update(device_ms=total,
                                         ms_by_part=parts)
        qt.destroyQureg(q, env)
    torch.cuda.empty_cache()

    # config 4's density register at R = 4: one eager channel of each
    # kind, on a bra bit of the mesh (13) and a local one (0), and the
    # density register's QFT (13 qubits)
    m, R = N_COMP_NOISE, R_COMP_NOISE
    env = mesh_env(qt, R)
    r = qt.createDensityQureg(m, env)
    qt.initPlusState(r)
    out["channels"] = {"n": m, "shards": R}
    p = NOISE_P
    for key, fn in (
            ("mixDephasing_mesh", lambda: qt.mixDephasing(r, m - 1, p)),
            ("mixDepolarising_mesh", lambda: qt.mixDepolarising(r, m - 1, p)),
            ("mixDamping_mesh", lambda: qt.mixDamping(r, m - 1, p)),
            ("mixTwoQubitDepolarising_mesh",
             lambda: qt.mixTwoQubitDepolarising(r, m - 2, m - 1, p)),
            ("mixDepolarising_local", lambda: qt.mixDepolarising(r, 0, p)),
            ("mixTwoQubitDepolarising_local",
             lambda: qt.mixTwoQubitDepolarising(r, 0, 1, p))):
        total, parts = split(env, fn)
        out["channels"][key] = {"wall_s": walls(fn), "device_ms": total,
                                "ms_by_part": parts}
    qt.destroyQureg(r, env)
    m, R = N_COMP_QFT_RHO, R_COMP_QFT_RHO
    env = mesh_env(qt, R)
    r = qt.createDensityQureg(m, env)
    qt.initPlusState(r)
    fused.reset_launch_counts()
    total, parts = split(env, lambda: qt.applyFullQFT(r))
    launches = comp_counts(fused)
    out["qft_density"] = {"n": m, "shards": R,
                          "wall_s": walls(lambda: qt.applyFullQFT(r)),
                          "device_ms": total, "ms_by_part": parts,
                          "launches_per_shard": {k: launches[k] / R
                                                 for k in QFT_KERNELS}}
    qt.destroyQureg(r, env)
    del r
    torch.cuda.empty_cache()

    # applyDiagonalOp at 30 qubits, one register and R = 8
    n, R = N_COMP_DIAG, R_COMP_DIAG
    out["diagonal"] = {"n": n, "shards": R}
    for label, env in (("one_register", env1), ("sharded", mesh_env(qt, R))):
        op = qt.createDiagonalOp(n, env)
        op.real.fill_(1.0)
        q = qt.createQureg(n, env)
        qt.initPlusState(q)
        out["diagonal"][label] = {"apply_wall_s": walls(
            lambda: qt.applyDiagonalOp(q, op))}
        if env is not env1:
            total, parts = split(env, lambda: qt.applyDiagonalOp(q, op))
            out["diagonal"][label].update(device_ms=total, ms_by_part=parts)
        qt.destroyQureg(q, env)
        del q, op
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The rest of the mesh (M15c): register banks with K1, K2 and K5's bank
# forms per shard, quad precision and the models on an in-process mesh of
# shards on the card
# ---------------------------------------------------------------------------

N_DIST_BATCH = 26      # randomized compiling of config 2 on a mesh: 8 x 2^26
DIST_BATCH_MESHES = (2, 8)
N_DIST_BATCH_PARITY = 23   # one shard's bank at R = 8: (8, 2, 2^23)
DIST_EQUAL_ELEMENTS = (0, 7)   # elements held to their scalar sharded drains
DIST_MEASURED = 3      # measureBatched of qubits 0 .. 2 at R = 8
N_DIST_BATCH_RHO = 13  # a density bank of 4 x 2^26 amplitudes at R = 4
R_DIST_BATCH_RHO = 4
N_DIST_ENSEMBLE = 20   # an EnsembleScheduler bucket of 8 at R = 2
DIST_ENSEMBLE = 8
R_DIST_ENSEMBLE = 2
N_DIST_QUAD = 26       # config 2 at precision 4 on 8 shards (1 GiB, f64)
R_DIST_QUAD = 8
N_DIST_QUAD_RHO = 13   # calcPurity of a density register of 2^26 at R = 4
R_DIST_QUAD_RHO = 4
R_DIST_MODELS = 8      # VQE at N_VQE and QAOA at N_QAOA qubits on 8 shards
DIST_MODEL_STEPS = 3


def density_sweeps(qt, fusion, noise, nq, nloc):
    """The chansweep parts a config-4 noise layer on an nq-qubit density
    register plans to on shards of nloc bits (the shapes K5's bank form
    takes per shard), and the layer's items."""
    from quest_tpu_torch.qureg import Qureg

    shadow = Qureg(nq, qt.createQuESTEnv(device="cpu"), True)
    fusion.start_gate_fusion(shadow)
    noise.noise_layer(qt, shadow, nq, noise.bench_kraus_ops(NOISE_SEED),
                      prob=NOISE_P)
    items = list(shadow._fusion.gates)
    program, _fp = fusion.plan_items_sharded(items, 2 * nq, nloc,
                                             device=DEVICE, sweep_ok=True)
    return [p[1] for p in program if p[0] == "chansweep"], items


def phase_dist_batch_parity(torch, np, qt, fused, fusion, noise):
    """K1, K2 and K5's bank forms on one shard's bank as a mesh of 8 holds
    it, (8, 2, 2^23) float32: each call one launch; each element bit for
    bit its own scalar launch; K1 and K2 with per-element sides within
    tolerance of their plain versions and, with 0/1 permutation sides
    (exact TF32 values), bit for bit; K5 over the sweeps a 13-qubit
    density bank plans per shard at R = 8, bit for bit its plain
    version."""
    n, nb = N_DIST_BATCH_PARITY, B_MAIN
    rng = np.random.default_rng(1357)
    x = random_bank(torch, np, rng, n, nb, torch.float32)
    tol = tolerance(x)
    out = {"nloc": n, "batch": nb, "shard_bank_bytes":
           x.numel() * x.element_size(), "k1": [], "k2": [],
           "max_abs_err": {"K1_bank": 0.0, "K2_bank": 0.0, "K5_bank": 0.0}}

    def one_launch(key, fn):
        before = fused.LAUNCHES[key]
        y = fn()
        check(fused.LAUNCHES[key] - before == 1,
              f"{key}: {fused.LAUNCHES[key] - before} launches, not 1")
        return y

    def k1(op):
        return one_launch("K1_bank", lambda: fused.apply_window_stack(
            x, op[2], op[3], op[6], num_qubits=n, k=op[1], apply_a=op[4],
            apply_b=op[5]))

    for k, sides, mask, exact in ((10, "AB", False, False),
                                  (7, "B", True, False),
                                  (13, "AB", False, True),
                                  (n - 7, "A", False, True)):
        op = bank_pass(rng, np, k, 1, sides, mask, True, mask, nb,
                       exact=range(nb) if exact else None)
        y = k1(op)
        for b in range(nb):
            e = fused.bank_element_op(op, b)
            check(torch.equal(y[b], k1_scalar(fused, x[b], e, n)),
                  f"shard bank K1 k={k} {sides} element {b}: not its scalar "
                  "launch's bits")
        yp = k1_bank_plain(torch, fused, x, op, n)
        if exact:
            check(torch.equal(y, yp), f"shard bank K1 k={k} {sides}: a "
                  "permutation pass is not its plain version's bits")
        err = float((y - yp).abs().max())
        check(err <= tol, f"shard bank K1 k={k} {sides}: |err| {err}")
        out["max_abs_err"]["K1_bank"] = max(out["max_abs_err"]["K1_bank"],
                                            err)
        out["k1"].append({"k": k, "sides": sides, "mask": mask,
                          "permutation_sides": exact, "max_abs_err": err,
                          "bit_identical_to_plain": exact or err == 0.0})
        del y, yp
    for label, spec, exact in (
            ("C", K2_BENCH_GROUPS["C"], False),
            ("permutations", [(7, 1, "AB", False), (10, 1, "B", False),
                              (13, 1, "AB", False)], True)):
        group = [bank_pass(rng, np, k, r, s_, m, True, m, nb,
                           exact=range(nb) if exact else None)
                 for k, r, s_, m in spec]
        y2 = one_launch("K2_bank", lambda: fused.apply_window_megastack(
            x, group, num_qubits=n))
        y1 = x
        for op in group:
            y1 = fused.apply_window_stack(
                y1, op[2], op[3], op[6], num_qubits=n, k=op[1],
                apply_a=op[4], apply_b=op[5])
        check(torch.equal(y2, y1), f"shard bank K2 {label}: not bank K1 "
              "pass by pass")
        del y1
        for b in range(nb):
            yb = fused.apply_window_megastack(
                x[b], [fused.bank_element_op(op, b) for op in group],
                num_qubits=n)
            check(torch.equal(y2[b], yb), f"shard bank K2 {label} element "
                  f"{b}: not its own K2 launch's bits")
        yp = k2_bank_plain(torch, fused, x, group, n)
        if exact:
            check(torch.equal(y2, yp), f"shard bank K2 {label}: not its "
                  "plain version's bits")
        err = float((y2 - yp).abs().max())
        check(err <= len(group) * tol, f"shard bank K2 {label}: |err| {err}")
        out["max_abs_err"]["K2_bank"] = max(out["max_abs_err"]["K2_bank"],
                                            err)
        out["k2"].append({"group": label, "passes": len(group),
                          "permutation_sides": exact, "max_abs_err": err})
        del y2, yp
    del x
    torch.cuda.empty_cache()
    # K5: the sweeps of a config-4 layer on a 13-qubit density bank's
    # shard at R = 8 (nloc = 23)
    sweeps, _items = density_sweeps(qt, fusion, noise, (n + 3) // 2, n)
    check(sweeps, "the sharded density layer plans no sweep at nloc = 23")
    xr = random_bank(torch, np, rng, n, nb, torch.float32)
    k5n = 0
    for entries in sweeps:
        probs = [NOISE_P] * len(entries)
        before = fused.LAUNCHES["K5_bank"]
        yb = fused.apply_pair_channel_sweep(xr.clone(), entries, probs,
                                            num_bits=n)
        got = fused.LAUNCHES["K5_bank"] - before
        check(got == k5_launches(fused, entries, n), f"shard bank K5: {got} "
              "launches")
        k5n += got
        for b in range(nb):
            ys = fused.apply_pair_channel_sweep(xr[b].clone(), entries,
                                                probs, num_bits=n)
            check(torch.equal(yb[b], ys), f"shard bank K5 element {b}: not "
                  "its own K5 launches' bits")
        check(torch.equal(yb, torch.stack([fused.pair_channel_sweep_plain(
            xr[b], entries, probs, num_bits=n) for b in range(nb)])),
            "shard bank K5 is not its plain version's bits")
        del yb
    out["k5"] = {"sweeps": len(sweeps), "launches": k5n,
                 "channels": sum(len(e) for e in sweeps),
                 "bit_identical_to_plain": True}
    del xr
    sync()
    torch.cuda.empty_cache()
    return out


def bank_remap_model(C, PD, program, final_perm, n, nloc, nb) -> dict:
    """remap_model of a bank's drain: B times a register's counts and
    bytes (the JAX package's accounting)."""
    m = remap_model(C, PD, program, final_perm, n, nloc, 4)
    return {op: [nb * v[0], nb * v[1]] for op, v in m.items()}


def bank_split(torch, PD, fused, kernels):
    """event_timed over a sharded bank's drain: K1 and K2's bank
    launches, the gatherperms and the exchange copies."""
    return event_timed(torch, [
        (PD, "_remap_shards", "exchange"),
        (fused, "apply_window_stack", "K1_bank"),
        (fused, "apply_window_megastack", "K2_bank"),
        (kernels, "apply_index_permutation", "gatherperm")])


def progress(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def phase_dist_batch_main(torch, np, qt, C, fused, fusion, circuits, noise,
                          hamiltonians, kernels, batch, rc_one):
    """Randomized compiling of config 2 (26 qubits x 8, per-element
    unitaries, the CNOTs shared) on R = 2 and 8 shards of the card, by the
    bench route (the elements' gate lists planned into one sharded bank
    program, run from |0> by execute_sharded_program) and the API route (a
    BatchedQureg drained): planning apart; the drain's wall and device ms
    split into K1 bank, K2 bank, gatherperm and exchange copies; K1 and
    K2's bank forms launched shards x the program's passes (not x B);
    exchanges and bytes B times the cost model; peak memory; P(top = 0)
    within 1e-5 of the one-register bank (batch_main); elements 0 and 7
    bit for bit their scalar sharded drains; at R = 8 config 5's
    expectations and measureBatched against the one-register bank.  A
    13-qubit density bank of 4 under a config-4 layer at R = 4 (K5's bank
    form per shard) within 1e-6 of one register; an EnsembleScheduler
    bucket of 8 at 20 qubits on R = 2."""
    from quest_tpu_torch.parallel import dist as PD
    from quest_tpu_torch.parallel import sharded as SH

    n, nb = N_DIST_BATCH, B_MAIN
    cus, us = bank_unitaries(np, circuits, n, nb, DEPTH)
    seeds = [[MEASURE_SEEDS[0] + b] for b in range(nb)]
    items = bank_items(qt, n, nb, lambda q: apply_bank_gates(qt, q, cus, n))
    bitems = batch.bank_gate_items(
        [circuits.bench_gate_list(n, DEPTH, u) for u in us], n, False)
    p_one = rc_one["api_route"]["p_top_zero"]
    out = {"n": n, "batch": nb, "depth": DEPTH, "bank_bytes":
           nb * (2 << n) * 4, "meshes": {}}
    launches = {"K1_bank": 0, "K2_bank": 0, "K5_bank": 0}

    def p_check(bank, label):
        p_top = [float(v) for v in SH.prob_of_outcome_bank(bank, n - 1, 0)]
        dp = max(abs(a - b) for a, b in zip(p_top, p_one))
        check(dp <= 1e-5, f"{label}: P(top = 0) {p_top} vs one register's "
              f"{p_one}")
        check(bank.batch_size == nb and all(
            bool(torch.isfinite(s).all()) for s in bank.shards),
            f"{label}: bad state")
        return p_top, dp

    def launched(program, R, label):
        pst = program_counts(fusion, program)
        got = {k: fused.LAUNCHES[k] for k in ("K1", "K2", "K1_bank",
                                              "K2_bank")}
        want = {"K1": 0, "K2": 0, "K1_bank": R * pst["winfused"],
                "K2_bank": R * pst["megawin"]}
        check(got == want, f"{label}: launches {got} != shards x the "
              f"program's passes {want}")
        launches["K1_bank"] += got["K1_bank"]
        launches["K2_bank"] += got["K2_bank"]
        return pst, got

    for R in DIST_BATCH_MESHES:
        nloc = n - (R.bit_length() - 1)
        env = mesh_env(qt, R)
        rec = {"shards": R, "nloc": nloc}
        fusion._plan_cache.clear()
        # the bench route: the elements' gate lists as one bank program
        t0 = time.perf_counter()
        bprog, bfinal = fusion.plan_items_sharded(
            bitems, n, nloc, device=DEVICE, optimize=False, batch_size=nb)
        bplan_s = time.perf_counter() - t0
        progress(f"dist_batch_main R={R}: bench plan {bplan_s:.1f} s")
        fused.reset_launch_counts()
        PD.reset_counters()
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with bank_split(torch, PD, fused, kernels) as ms:
            a = SH.broadcast_bank(SH.classical(env.mesh, nloc,
                                               torch.float32, 0), nb)
            a = fusion.execute_sharded_program(a, bprog, (), nloc,
                                               key=("dist_bank", n, R))
            if bfinal is not None and list(bfinal) != list(range(n)):
                a = PD.remap_sharded(a, num_qubits=n,
                                     sigma=PD.canonical_sigma(bfinal))
        sync()
        bwall = time.perf_counter() - t0
        bpeak = torch.cuda.max_memory_allocated()
        bst, bgot = launched(bprog, R, f"bench-route bank at R = {R}")
        model = bank_remap_model(C, PD, bprog, bfinal, n, nloc, nb)
        check(counted(PD) == model, f"bench-route bank at R = {R}: "
              f"exchanges {counted(PD)} != B x the cost model {model}")
        bp, bdp = p_check(a, f"bench-route bank at R = {R}")
        del a
        torch.cuda.empty_cache()
        rec["bench_route"] = {
            "program": bst, "plan_seconds": bplan_s, "wall_s": bwall,
            "device_ms_by_part": dict(ms), "device_ms": sum(ms.values()),
            "launches": bgot, "exchanges": model, "peak_mem_bytes": bpeak,
            "p_top_zero": bp, "max_p_diff_vs_one_register": bdp}
        progress(f"dist_batch_main R={R}: bench drain {bwall:.2f} s")
        # the API route: a BatchedQureg drained, its program planned ahead
        t0 = time.perf_counter()
        program, final = fusion.plan_items_sharded(
            items, n, nloc, device=DEVICE, sweep_ok=True, batch_size=nb)
        plan_s = time.perf_counter() - t0
        progress(f"dist_batch_main R={R}: API plan {plan_s:.1f} s")
        fused.reset_launch_counts()
        PD.reset_counters()
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q = qt.createBatchedQureg(n, env, nb, seeds=seeds)
        apply_bank_gates(qt, q, cus, n)
        with bank_split(torch, PD, fused, kernels) as ms:
            bank = q.amps
        sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pst, got = launched(program, R, f"API-route bank at R = {R}")
        check(got["K1_bank"] > 0, f"API-route bank at R = {R}: no K1 bank")
        model = bank_remap_model(C, PD, program, final, n, nloc, nb)
        check(counted(PD) == model, f"API-route bank at R = {R}: exchanges "
              f"{counted(PD)} != B x the cost model {model}")
        p_top, dp = p_check(bank, f"API-route bank at R = {R}")
        progress(f"dist_batch_main R={R}: API drain {wall:.2f} s")
        # elements 0 and 7 against their own scalar sharded drains
        t0 = time.perf_counter()
        for b in DIST_EQUAL_ELEMENTS:
            s_ = qt.createQureg(n, env)
            with qt.gateFusion(s_):
                apply_bench_gates(qt, s_, us[b], n)
            sa = s_.amps
            check(all(torch.equal(x[b], y) for x, y in
                      zip(bank.shards, sa.shards)), f"bank at R = {R}: "
                  f"element {b} is not its scalar sharded drain bit for bit")
            qt.destroyQureg(s_, env)
            del sa
        scalar_s = time.perf_counter() - t0
        rec["api_route"] = {
            "program": pst, "plan_seconds": plan_s, "drain_wall_s": wall,
            "device_ms_by_part": dict(ms), "device_ms": sum(ms.values()),
            "launches": got, "exchanges": model, "peak_mem_bytes": peak,
            "p_top_zero": p_top, "max_p_diff_vs_one_register": dp,
            "elements_equal_scalar_sharded": list(DIST_EQUAL_ELEMENTS),
            "two_scalar_drains_s": scalar_s}
        if R == max(DIST_BATCH_MESHES):
            # config 5's expectations, then measureBatched, against the
            # one-register bank of batch_main
            hc, hk = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                    PAULI_SEED)
            sync()
            t0 = time.perf_counter()
            ev = [float(v) for v in qt.calcExpecPauliSumBatched(q, hk, hc)]
            rec["expec_wall_s"] = time.perf_counter() - t0
            de = max(abs(a - b) for a, b in zip(ev, rc_one["expec_config5"]))
            check(de <= 1e-5, f"bank at R = {R}: config-5 expectations "
                  f"{ev} vs one register's {rc_one['expec_config5']}")
            rec["expec_config5"] = ev
            rec["max_expec_diff_vs_one_register"] = de
            t0 = time.perf_counter()
            meas = [qt.measureBatched(q, t) for t in range(DIST_MEASURED)]
            sync()
            rec["measure_batched_ms_per_qubit"] = \
                (time.perf_counter() - t0) * 1e3 / DIST_MEASURED
            for t, (o, p) in enumerate(meas):
                want_o = rc_one["measured_first"][t]["outcomes"]
                want_p = rc_one["measured_first"][t]["probs"]
                check([int(v) for v in o] == want_o, f"bank at R = {R}: "
                      f"qubit {t} outcomes {list(o)} vs one register's "
                      f"{want_o}")
                check(max(abs(a - b) for a, b in zip(p, want_p)) <= 1e-5,
                      f"bank at R = {R}: qubit {t} probabilities {list(p)}"
                      f" vs {want_p}")
            rec["measured_first"] = [[int(v) for v in o] for o, _p in meas]
        qt.destroyQureg(q, env)
        del bank
        torch.cuda.empty_cache()
        out["meshes"][str(R)] = rec

    # a density bank under one config-4 layer at R = 4, K5's bank form on
    # every shard, against the one-register bank
    nq, nbr, R = N_DIST_BATCH_RHO, B_RHO, R_DIST_BATCH_RHO
    nloc = 2 * nq - (R.bit_length() - 1)
    kops = noise.bench_kraus_ops(NOISE_SEED)
    mats = np.stack([random_unitary(np.random.default_rng(77 + b), 2)
                     for b in range(nbr)])

    def rho_bank(env):
        rq = qt.createBatchedQureg(nq, env, nbr, is_density_matrix=True)
        qt.initPlusState(rq)
        qt.applyBatchedUnitary(rq, (2,), mats)
        noise.noise_layer(qt, rq, nq, kops, prob=NOISE_P)
        return rq

    sweeps, _ = density_sweeps(qt, fusion, noise, nq, nloc)
    per_shard = sum(k5_launches(fused, e, nloc) for e in sweeps)
    fused.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    rq = rho_bank(mesh_env(qt, R))
    ra = rq.amps
    sync()
    rwall = time.perf_counter() - t0
    k5 = fused.LAUNCHES["K5_bank"]
    check(per_shard > 0 and k5 == R * per_shard and fused.LAUNCHES["K5"] == 0,
          f"density bank at R = {R}: {k5} K5 bank launches, not {R} shards "
          f"x {per_shard}")
    launches["K5_bank"] = k5
    one = rho_bank(qt.createQuESTEnv())
    ob = one.amps
    m = 1 << nloc
    err = max(max_abs_diff(torch, ra.shards[s], ob[..., s * m:(s + 1) * m])
              for s in range(R))
    check(err <= 1e-6, f"density bank at R = {R}: |rho - one register| "
          f"{err}")
    # one shard's bank through K5's plain version, bit for bit
    with plain_channel_kernel(fused):
        rp = rho_bank(mesh_env(qt, R))
        same = all(torch.equal(x, y) for x, y in zip(ra.shards,
                                                    rp.amps.shards))
    check(same, f"density bank at R = {R}: the K5 route is not its plain "
          "route's bits")
    out["density_bank"] = {"n": nq, "batch": nbr, "shards": R, "nloc": nloc,
                           "k5_bank_launches_per_shard": per_shard,
                           "k5_bank_launches": k5, "drain_wall_s": rwall,
                           "max_abs_err_vs_one_register": err,
                           "bit_identical_to_plain_route": same}
    for r in (rq, one, rp):
        qt.destroyQureg(r, r.env)
    del ra, ob
    torch.cuda.empty_cache()

    # an EnsembleScheduler bucket of 8 config-2 circuits at 20 qubits on
    # R = 2, against the one-shard scheduler
    n2, R = N_DIST_ENSEMBLE, R_DIST_ENSEMBLE
    subs = [circuits.bench_gate_list(n2, DEPTH, circuits.bench_unitaries(
        n2, DEPTH, seed=100 + s)) for s in range(DIST_ENSEMBLE)]
    results, walls = [], []
    fused.reset_launch_counts()
    for env in (mesh_env(qt, R), qt.createQuESTEnv()):
        sched = qt.EnsembleScheduler(n2, env, max_batch=DIST_ENSEMBLE)
        for g in subs:
            sched.submit(g)
        sync()
        t0 = time.perf_counter()
        results.append(sched.drain())
        sync()
        walls.append(time.perf_counter() - t0)
        check(sched.last_drain["buckets"] == 1, f"ensemble buckets "
              f"{sched.last_drain}")
        if len(results) == 1:
            ens_launches = {k: fused.LAUNCHES[k] for k in ("K1_bank",
                                                           "K2_bank")}
    check(ens_launches["K1_bank"] > 0, f"the ensemble bucket on R = {R} "
          f"launched no K1 bank: {ens_launches}")
    launches["K1_bank"] += ens_launches["K1_bank"]
    launches["K2_bank"] += ens_launches["K2_bank"]
    m = 1 << (n2 - (R.bit_length() - 1))
    eerr = max(max_abs_diff(torch, got.shards[s], want[:, s * m:(s + 1) * m])
               for got, want in zip(*results) for s in range(R))
    check(eerr <= 1e-5, f"ensemble on R = {R}: |psi - one shard| {eerr}")
    out["ensemble"] = {"n": n2, "submissions": DIST_ENSEMBLE, "shards": R,
                       "drain_wall_s": walls[0], "one_shard_wall_s": walls[1],
                       "launches": ens_launches,
                       "max_abs_err_vs_one_shard": eerr}
    del results
    torch.cuda.empty_cache()
    check(launches["K1_bank"] > 0 and launches["K2_bank"] > 0,
          f"a bank form never launched on a sharded bank: {launches}")
    out["launches"] = launches
    return out, launches


def phase_dist_quad_main(torch, np, qt, circuits, hamiltonians):
    """set_precision(4) on a mesh of the card: config 2's circuit at 26
    qubits on 8 shards (float64); calcTotalProb, calcProbOfOutcome,
    calcInnerProduct against a clone and calcExpecPauliHamil (config 5's
    16 terms) each within 1e-12 of the one-register quad route on the
    same state; calcPurity of a 13-qubit density register on 4 shards
    likewise; the cancellation state at 2^26 amplitudes kept exactly at
    quad and lost at precision 2; the wall of each read at R = 8 and on
    one register."""
    from quest_tpu_torch import interop

    n, R = N_DIST_QUAD, R_DIST_QUAD
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED, dtype=np.float64)
    coeffs, codes = hamiltonians.bench_pauli_hamil(n, PAULI_TERMS,
                                                   PAULI_SEED)
    env, one = mesh_env(qt, R), qt.createQuESTEnv()
    out = {"n": n, "shards": R, "read_outs": {}}
    qt.set_precision(4)
    try:
        q = qt.createQureg(n, env)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        check(all(s.dtype == torch.float64 for s in q.amps.shards),
              "a quad register on a mesh is not float64")
        clone = qt.createCloneQureg(q, env)
        q1 = qt.createQureg(n, one)
        interop.load_register(q1, interop.register_state(q, True)[0])
        c1 = qt.createCloneQureg(q1, one)
        h = qt.createPauliHamil(n, PAULI_TERMS)
        qt.initPauliHamil(h, coeffs, codes)

        def reads(reg, cl):
            return {"calcTotalProb": lambda: qt.calcTotalProb(reg),
                    "calcProbOfOutcome": lambda: qt.calcProbOfOutcome(
                        reg, n - 1, 0),
                    "calcInnerProduct": lambda: qt.calcInnerProduct(reg, cl),
                    "calcExpecPauliHamil": lambda: qt.calcExpecPauliHamil(
                        reg, h)}

        for name in reads(q, clone):
            rec = {}
            for label, (reg, cl) in (("mesh", (q, clone)), ("one", (q1, c1))):
                fn = reads(reg, cl)[name]
                sync()
                t0 = time.perf_counter()
                v = fn()
                sync()
                rec[f"wall_ms_{label}"] = (time.perf_counter() - t0) * 1e3
                rec[label] = v
            err = abs(rec["mesh"] - rec["one"])
            check(err <= QUAD_TOL, f"quad {name} on {R} shards {rec['mesh']}"
                  f" vs one register {rec['one']}")
            rec.update(mesh=repr(rec["mesh"]), one=repr(rec["one"]),
                       abs_diff=err)
            out["read_outs"][name] = rec
        for r, e in ((q, env), (clone, env), (q1, one), (c1, one)):
            qt.destroyQureg(r, e)
        torch.cuda.empty_cache()
        # the cancellation: Z on qubit n - 2 signs the two A quarters apart
        x = cancel_state(torch, n)
        qc = qt.createQureg(n, env)
        interop.load_register(qc, x.cpu().numpy())
        del x
        z = [0] * n
        z[n - 2] = 3
        want = float(1 << (n - 2))
        sync()
        t0 = time.perf_counter()
        got = qt.calcExpecPauliSum(qc, z, [1.0])
        quad_ms = (time.perf_counter() - t0) * 1e3
        qt.set_precision(2)
        plain = qt.calcExpecPauliSum(qc, z, [1.0])
        qt.set_precision(4)
        check(got == want, f"quad on {R} shards lost the cancellation: "
              f"{got} != {want}")
        check(abs(plain - want) > 0.5 * want, f"precision 2 kept the "
              f"cancellation ({plain}): the case tests nothing")
        out["cancellation"] = {"amps": 1 << n, "want": want, "quad": got,
                               "plain_f64": plain, "quad_ms": quad_ms}
        qt.destroyQureg(qc, env)
        torch.cuda.empty_cache()
        # calcPurity of a 13-qubit density register on 4 shards
        nq, R4 = N_DIST_QUAD_RHO, R_DIST_QUAD_RHO
        env4 = mesh_env(qt, R4)
        rho = qt.createDensityQureg(nq, env4)
        qt.initPlusState(rho)
        with qt.gateFusion(rho):
            for t in range(nq):
                qt.rotateY(rho, t, 0.1 * (t + 1))
            for t in range(nq):
                qt.mixDepolarising(rho, t, NOISE_P)
        r1 = qt.createDensityQureg(nq, one)
        interop.load_register(r1, interop.register_state(rho, True)[0])
        rec = {}
        for label, reg in (("mesh", rho), ("one", r1)):
            sync()
            t0 = time.perf_counter()
            rec[label] = qt.calcPurity(reg)
            sync()
            rec[f"wall_ms_{label}"] = (time.perf_counter() - t0) * 1e3
        err = abs(rec["mesh"] - rec["one"])
        check(err <= QUAD_TOL, f"quad calcPurity on {R4} shards "
              f"{rec['mesh']} vs one register {rec['one']}")
        rec.update(mesh=repr(rec["mesh"]), one=repr(rec["one"]),
                   abs_diff=err, n=nq, shards=R4)
        out["read_outs"]["calcPurity"] = rec
        qt.destroyQureg(rho, env4)
        qt.destroyQureg(r1, one)
    finally:
        qt.set_precision(1)
    torch.cuda.empty_cache()
    return out


def phase_dist_models_main(torch, np):
    """VQE at 20 qubits (float64) and QAOA at 24 qubits (float32) on 8
    shards of the card: the objective and its autograd gradient on the
    same parameters within 1e-5 and 1e-4 |g| of the one-register model,
    three Adam steps moving the objective the right way, the wall per
    step and the peak memory beside one register's."""
    import quest_tpu_torch as tq
    from quest_tpu_torch.models import qaoa, vqe

    mesh = mesh_env(tq, R_DIST_MODELS).mesh
    codes, coeffs = vqe.random_hamiltonian(N_VQE, VQE_TERMS, seed=VQE_SEED)
    edges = qaoa.random_graph(N_QAOA, 2 * N_QAOA, seed=1)
    gen = torch.Generator().manual_seed(0)
    cases = {
        "vqe": (vqe.VQE(N_VQE, VQE_DEPTH, codes, coeffs, mesh=mesh),
                vqe.VQE(N_VQE, VQE_DEPTH, codes, coeffs), torch.float64,
                True, "energy", N_VQE, VQE_DEPTH),
        "qaoa": (qaoa.QAOA(N_QAOA, edges, QAOA_DEPTH, mesh=mesh),
                 qaoa.QAOA(N_QAOA, edges, QAOA_DEPTH), torch.float32,
                 False, "expected_cut", N_QAOA, QAOA_DEPTH)}
    out = {"shards": R_DIST_MODELS}
    for name, (mm, m1, dtype, falls, fn, nq, depth) in cases.items():
        p = m1.init_params(gen, dtype=dtype)
        on = mm.init_params(dtype=dtype).device
        check(on == p.device, f"{name}: the mesh model's parameters are on "
              f"{on}, not on the card's {p.device}")
        vals = {}
        for label, model in (("mesh", mm), ("one", m1)):
            t = p.clone().requires_grad_(True)
            v = getattr(model, fn)(t)
            v.backward()
            vals[label] = (float(v.detach()), t.grad.double())
        dv = abs(vals["mesh"][0] - vals["one"][0])
        gnorm = float(vals["one"][1].norm())
        dg = float((vals["mesh"][1] - vals["one"][1]).norm()) / max(gnorm,
                                                                    1e-30)
        check(dv <= 1e-5, f"{name} on {R_DIST_MODELS} shards: objective "
              f"{vals['mesh'][0]} vs one register {vals['one'][0]}")
        check(dg <= 1e-4, f"{name} on {R_DIST_MODELS} shards: |g - g_one| /"
              f" |g| = {dg}")
        rec = {"n": nq, "depth": depth, "dtype": str(dtype).split(".")[-1],
               "objective_mesh": vals["mesh"][0],
               "objective_one": vals["one"][0], "abs_diff": dv,
               "grad_rel_diff": dg, "grad_norm": gnorm,
               "mesh": train_record(torch, mm, p, mm.make_train_step, falls,
                                    DIST_MODEL_STEPS),
               "one_register": train_record(torch, m1, p, m1.make_train_step,
                                            falls, DIST_MODEL_STEPS)}
        out[name] = rec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Telemetry and resumable runs (M16a, M16b)
# ---------------------------------------------------------------------------

N_TELE = 26            # config 2 at 26 qubits, f32, through both routes
TELE_REPS = 3          # turns of off / on / trace, medians reported
TELE_BUDGET = 0.05     # the reference's budget: on within 5 % of off
N_RES = 26             # runResumable over config 2's 770 gates
RES_EVERY = 128        # seven windows: 6 x 128 + 2
N_DRES = 26            # the same on an in-process mesh of 8 shards
R_DRES = 8


def window_launches(fused) -> dict:
    return {k: fused.LAUNCHES[k] for k in ("K1", "K2")}


def hist_stats(T, hist: str, /, **labels) -> dict:
    """count, mean and max of a histogram over all its label sets (those
    holding ``labels``)."""
    series = T.snapshot().get("histograms", {}).get(hist, {})
    want = [f"{k}={v}" for k, v in labels.items()]
    series = {lab: h for lab, h in series.items()
              if all(w in lab.split(",") for w in want)}
    n = sum(h["count"] for h in series.values())
    total = sum(h["sum"] for h in series.values())
    hi = max((h["max"] for h in series.values() if h["max"] is not None),
             default=None)
    return {"count": n, "mean": total / n if n else None, "max": hi}


def inject(fusion, q, gates) -> None:
    """One gateFusion drain of ``gates`` (circuit.Gate) on ``q``."""
    fusion.start_gate_fusion(q)
    q._fusion.gates.extend(gates)
    fusion.stop_gate_fusion(q)


def phase_telemetry_main(torch, np, qt, C, fused, fusion, optimizer, us,
                         gates, tmp):
    """Config 2 at 26 qubits, f32, by the bench route (one drain of the
    770 gates) and the API route (770 API calls under gateFusion) with
    QT_TELEMETRY off, on and trace in turns; the counters of one API
    circuit against what its drain did; one torch.profiler trace of an
    API circuit; reportPerf."""
    from quest_tpu_torch import telemetry as T
    from quest_tpu_torch import utils

    n = N_TELE
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    q = qt.createQureg(n, env)

    def bench_route():
        qt.initZeroState(q)
        inject(fusion, q, gates)
        sync()

    def api_route():
        qt.initZeroState(q)
        with qt.gateFusion(q):
            apply_bench_gates(qt, q, us, n)
        sync()

    modes = ("off", "on", "trace")
    routes = {"bench": bench_route, "api": api_route}
    samples = {m: {r: [] for r in routes} for m in modes}
    old = T.mode_name()
    try:
        for fn in routes.values():
            fn()  # warm-up: plans and kernels
        for _ in range(TELE_REPS):
            for m in modes:
                T.configure(m)
                for r, fn in routes.items():
                    t0 = time.perf_counter()
                    fn()
                    samples[m][r].append((time.perf_counter() - t0) * 1e3)
        # the counters of one API circuit against what its drain did
        T.configure("on")
        T.reset()
        fused.reset_launch_counts()
        api_route()
        launches = window_launches(fused)
        counters = T.snapshot()["counters"]
        got = {"fusion_drains_total": T.counter_total("fusion_drains_total"),
               "fusion_windows_total":
                   T.counter_total("fusion_windows_total"),
               "dispatch_unitary": T.counter_value("dispatch_total",
                                                   family="unitary"),
               "dispatch_not": T.counter_value("dispatch_total",
                                               family="not")}
        # (capturing the items on a shadow register counts its dispatches
        # too: after the reading above)
        program = fusion.plan_items(capture_items(qt, us, n), n,
                                    device=DEVICE)
        windows = sum(1 for p in program if p[0] == "plan")
        st = fusion.program_stats(program)
        nots = sum(len(range(d % 2, n - 1, 2)) for d in range(DEPTH))
        want = {"fusion_drains_total": 1, "fusion_windows_total": windows,
                "dispatch_unitary": n * DEPTH, "dispatch_not": nots}
        check(got == want, f"telemetry counters {got} != the drain's {want}")
        # one register's drain splits the CNOT ladders out as permutation
        # ops, so its program holds window passes and no megawin group
        # (K2 launches on the mesh's drains, dist_resilience_main)
        check(launches == {"K1": st.get("winfused", 0),
                           "K2": st.get("megawin", 0)},
              f"API circuit launched {launches}, its program holds {st}")
        check(launches["K1"] > 0,
              f"K1 never launched on the telemetry path: {launches}")
        # one torch.profiler trace of an API circuit, planned afresh so the
        # fusion.plan span is in it
        fusion._plan_cache.clear()
        fusion._device_programs.clear()
        optimizer._cache.clear()
        with utils.profiling.trace(os.path.join(tmp, "trace")) as prof:
            api_route()
        # a record_function range shows on the host timeline and, with
        # CUDA activity, again as a device-side annotation
        cpu_type = torch.autograd.DeviceType.CPU
        host_names = [e.name for e in prof.events()
                      if e.device_type == cpu_type]
        names = [e.name for e in prof.events()]
        prof_counts = {
            "fusion.drain": host_names.count("fusion.drain"),
            "fusion.plan": host_names.count("fusion.plan"),
            "fusion.optimize": host_names.count("fusion.optimize"),
            "fusion.drain_all_timelines": names.count("fusion.drain"),
            "window_pass_kernel": sum("window_pass_kernel" in s
                                      for s in names),
            "megawin_kernel": sum("megawin_kernel" in s for s in names)}
        check(prof_counts["fusion.drain"] == 1
              and prof_counts["fusion.plan"] == 1,
              f"the profiler trace holds {prof_counts} spans")
        report = T.perf_report(env).splitlines()
    finally:
        T.configure(old)
    qt.destroyQureg(q, env)
    walls = {m: {r: statistics.median(v) for r, v in samples[m].items()}
             for m in modes}
    ratios = {r: {"on_over_off": walls["on"][r] / walls["off"][r],
                  "trace_over_off": walls["trace"][r] / walls["off"][r]}
              for r in routes}
    return {"n": n, "gates": len(gates), "reps": TELE_REPS,
            "wall_ms": walls, "wall_ms_samples": samples,
            "ratios": ratios, "budget": TELE_BUDGET,
            "on_within_budget": {r: ratios[r]["on_over_off"]
                                 <= 1 + TELE_BUDGET for r in routes},
            "trace_within_budget": {r: ratios[r]["trace_over_off"]
                                    <= 1 + TELE_BUDGET for r in routes},
            "counters_api_circuit": counters, "counters_checked": got,
            "launches": launches, "profiler": prof_counts,
            "report_lines": len(report),
            "report_memory_line": next((s for s in report
                                        if s.startswith("memory:")), None)}


def phase_resilience_main(torch, np, qt, C, fused, fusion, optimizer, us,
                          gates, tmp):
    """runResumable over config 2's 770 gates at 26 qubits, f32, every
    128 gates, on one register: (a) uninterrupted, against one plain
    drain of the 770 gates and the same windows drained without
    checkpoints; (b) killed before window 3 and resumed under a wrong
    seed: bit for bit, and the next uniform draw; (c) nan@2 under raise,
    scale@2 under renormalize, corrupt@4 then a resume from the
    predecessor generation; (d) saveQureg / loadQureg bit for bit."""
    import shutil
    import warnings

    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import telemetry as T

    n = N_RES
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    bounds = C.plan_checkpoint_boundaries(len(gates), RES_EVERY)
    check(len(bounds) == 7, f"{len(bounds)} windows, not seven")

    def fresh(seed=SEED):
        qt.seedQuEST(env, [seed])
        return qt.createQureg(n, env)

    def ckdir(name):
        d = os.path.join(tmp, name)
        shutil.rmtree(d, ignore_errors=True)
        return d

    # the plain drains, each timed after a warm-up (plans, kernels)
    def one_drain():
        q = fresh()
        inject(fusion, q, gates)
        sync()
        qt.destroyQureg(q, env)

    def window_drains():
        q = fresh()
        lo = 0
        for hi in bounds:
            inject(fusion, q, gates[lo:hi])
            lo = hi
        sync()
        qt.destroyQureg(q, env)

    one_drain()
    window_drains()
    plain_ms = host_ms(one_drain, reps=1)
    windows_ms = host_ms(window_drains, reps=1)

    # (a) uninterrupted
    T.configure("on")
    T.reset()
    fused.reset_launch_counts()
    q = fresh()
    t0 = time.perf_counter()
    qt.runResumable(q, gates, ckdir("a"), every=RES_EVERY)
    sync()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = window_launches(fused)
    check(q._drain_count == 7, f"{q._drain_count} drains, not seven")
    # the windows' programs, as the drains planned them (optimizer
    # suppressed, the drain's sweep setting: cache hits)
    sweep_ok = fused.channel_sweep_enabled(
        torch.empty(1, dtype=torch.float32, device=DEVICE))
    lo, st = 0, {}
    with optimizer.suppressed():
        for hi in bounds:
            for k, v in fusion.program_stats(fusion.plan_items(
                    gates[lo:hi], n, device=DEVICE,
                    sweep_ok=sweep_ok)).items():
                st[k] = st.get(k, 0) + v
            lo = hi
    check(launches == {"K1": st.get("winfused", 0),
                       "K2": st.get("megawin", 0)},
          f"runResumable launched {launches}, its windows hold {st}")
    check(launches["K1"] > 0,
          f"K1 never launched on the resumable path: {launches}")
    want = q.amps.clone()
    u_a = qt.GLOBAL_RNG.uniform()
    # the health reduction alone (the run's watchdog_seconds also waits
    # for the window's kernels, which the readback syncs on)
    sync()
    health_ms = host_ms(lambda: R.check_qureg_health(q), reps=5)
    check(bool(torch.isfinite(want).all())
          and abs(float(torch.sum(want.double() ** 2)) - 1.0) <= 1e-4,
          "runResumable: bad final state")
    commit = hist_stats(T, "checkpoint_commit_seconds")
    copy = hist_stats(T, "checkpoint_copy_seconds")
    write = hist_stats(T, "checkpoint_write_seconds")
    fsync = hist_stats(T, "checkpoint_fsync_seconds")
    watchdog = hist_stats(T, "watchdog_seconds")
    payload = want.numel() * want.element_size()
    qt.destroyQureg(q, env)
    shutil.rmtree(os.path.join(tmp, "a"), ignore_errors=True)

    # (b) killed before window 3, resumed under a wrong seed
    plan = qt.FaultPlan("kill@3")
    q = fresh()
    killed = False
    try:
        qt.runResumable(q, gates, ckdir("b"), every=RES_EVERY, faults=plan)
    except qt.SimulatedPreemption:
        killed = True
    check(killed and plan.log == ["kill@3"], f"kill@3 fired {plan.log}")
    qt.destroyQureg(q, env)
    t0 = time.perf_counter()
    loaded = R.load_latest(os.path.join(tmp, "b"), env)
    sync()
    restore_s = time.perf_counter() - t0
    check(loaded is not None and loaded[1]["cursor"] == 3 * RES_EVERY,
          "kill@3 left no generation at the end of window 2")
    del loaded
    q = fresh(seed=999)
    qt.runResumable(q, gates, os.path.join(tmp, "b"), every=RES_EVERY)
    resumed_equal = bool(torch.equal(q.amps, want))
    u_b = qt.GLOBAL_RNG.uniform()
    check(resumed_equal, "the killed and resumed run is not bit for bit "
          "the uninterrupted one")
    check(u_b == u_a, f"the resumed run's next draw {u_b} != {u_a}")
    check(q._drain_count == 4, f"the resume drained {q._drain_count} "
          "windows, not four")
    qt.destroyQureg(q, env)
    shutil.rmtree(os.path.join(tmp, "b"), ignore_errors=True)

    # (c) the watchdog and a corrupt generation
    q = fresh()
    err = None
    try:
        qt.runResumable(q, gates, ckdir("c1"), every=RES_EVERY,
                        watchdog="raise", faults=qt.FaultPlan("nan@2"))
    except qt.NumericalHealthError as e:
        err = e
    check(err is not None and not err.finite
          and err.window == (2 * RES_EVERY, 3 * RES_EVERY),
          f"nan@2 under raise: {err!r}")
    qt.destroyQureg(q, env)
    q = fresh()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            qt.runResumable(q, gates, ckdir("c2"), every=RES_EVERY,
                            watchdog="renormalize",
                            faults=qt.FaultPlan("scale@2,kill@4"))
        except qt.SimulatedPreemption:
            pass
    renorm = any("renormalized" in str(w.message) for w in caught)
    norm, finite = qt.checkQuregHealth(q)
    check(renorm and finite and abs(norm - 1.0) <= 1e-3,
          f"scale@2 under renormalize: warned={renorm} norm={norm}")
    qt.destroyQureg(q, env)
    q = fresh()
    try:
        qt.runResumable(q, gates, ckdir("c3"), every=RES_EVERY,
                        faults=qt.FaultPlan("corrupt@4,kill@5"))
    except qt.SimulatedPreemption:
        pass
    qt.destroyQureg(q, env)
    q = fresh(seed=999)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        qt.runResumable(q, gates, os.path.join(tmp, "c3"), every=RES_EVERY)
    fell_back = any("unreadable" in str(w.message) for w in caught)
    corrupt_equal = bool(torch.equal(q.amps, want))
    check(fell_back and corrupt_equal, f"corrupt@4: fell back={fell_back}, "
          f"bit for bit={corrupt_equal}")
    check(q._drain_count == 3, f"the resume after corrupt@4 drained "
          f"{q._drain_count} windows, not three (from window 4's start)")
    qt.destroyQureg(q, env)
    for d in ("c1", "c2", "c3"):
        shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)

    # (d) saveQureg / loadQureg
    q = fresh()
    q.amps = want.clone()
    t0 = time.perf_counter()
    qt.saveQureg(q, os.path.join(tmp, "d"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q2 = qt.loadQureg(os.path.join(tmp, "d"), env)
    sync()
    load_s = time.perf_counter() - t0
    round_trip = bool(torch.equal(q2.amps, want))
    check(round_trip, "saveQureg / loadQureg is not bit for bit")
    qt.destroyQureg(q, env)
    qt.destroyQureg(q2, env)
    shutil.rmtree(os.path.join(tmp, "d"), ignore_errors=True)
    del want
    torch.cuda.empty_cache()
    gens = commit["count"]
    per_gen = {k: v["mean"] for k, v in (("copy_s", copy), ("write_s", write),
                                         ("fsync_s", fsync))}
    return {"n": n, "gates": len(gates), "every": RES_EVERY,
            "windows": len(bounds), "launches": launches,
            "window_programs": st,
            "run_ms": run_ms, "one_plain_drain_ms": plain_ms,
            "window_drains_ms": windows_ms,
            "checkpoint_cost_ms": run_ms - windows_ms,
            "generations": gens, "generation_bytes": payload,
            "checkpoint_commit_seconds": commit,
            "per_generation_mean": per_gen,
            "write_gb_per_s": payload / (write["mean"] + fsync["mean"]) / 1e9,
            "copy_gb_per_s": payload / copy["mean"] / 1e9,
            "watchdog_ms_per_window": watchdog["mean"] * 1e3,
            "health_check_ms": health_ms,
            "restore_seconds": restore_s,
            "resume_bit_exact": resumed_equal, "rng_draw_equal": u_b == u_a,
            "nan_window": list(err.window), "renormalized": renorm,
            "corrupt_fallback_bit_exact": corrupt_equal,
            "save_seconds": save_s, "load_seconds": load_s,
            "save_load_bit_exact": round_trip}


def phase_dist_resilience_main(torch, np, qt, C, fused, fusion, us, gates,
                               tmp):
    """runResumable over config 2 at 26 qubits on an in-process mesh of 8
    shards of the card, every 128 gates, with stall@2 (absorbed by the
    exchange guard) and shard_loss@3 (the failover: rollback, shrink to 4
    shards, reshard, resume); held bit for bit against a run killed on 8
    shards and resumed on 4 (the same windows on the same meshes), and
    within tolerance of an uninterrupted run on 4 shards."""
    import shutil
    import warnings

    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import telemetry as T

    n = N_DRES
    qt.set_precision(1)
    env8 = mesh_env(qt, R_DRES)
    env4 = mesh_env(qt, R_DRES // 2)

    def fresh(env, seed=SEED):
        qt.seedQuEST(env, [seed])
        return qt.createQureg(n, env)

    def ckdir(name):
        d = os.path.join(tmp, name)
        shutil.rmtree(d, ignore_errors=True)
        return d

    # an uninterrupted run on 4 shards
    fused.reset_launch_counts()
    q4 = fresh(env4)
    t0 = time.perf_counter()
    qt.runResumable(q4, gates, ckdir("r4"), every=RES_EVERY)
    sync()
    r4_ms = (time.perf_counter() - t0) * 1e3
    r4_launches = window_launches(fused)
    ref4 = q4.amps
    shutil.rmtree(os.path.join(tmp, "r4"), ignore_errors=True)

    # stall@2 and shard_loss@3 on 8 shards
    T.configure("on")
    T.reset()
    R.DEGRADATIONS.pop(f"mesh_failover_{R_DRES}to{R_DRES // 2}", None)
    fused.reset_launch_counts()
    q = fresh(env8)
    plan = qt.FaultPlan("stall@2,shard_loss@3")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        qt.runResumable(q, gates, ckdir("f"), every=RES_EVERY, faults=plan)
        sync()
        fo_ms = (time.perf_counter() - t0) * 1e3
    launches = window_launches(fused)
    check(plan.log == ["stall@2", "shard_loss@3"], f"faults fired {plan.log}")
    check(q.env.num_devices == R_DRES // 2, f"the failover left "
          f"{q.env.num_devices} shards")
    check(any(f"mesh_failover_{R_DRES}to{R_DRES // 2}" in str(w.message)
              for w in caught), "the failover recorded no degradation")
    timeouts = T.counter_total("exchange_timeouts_total")
    check(timeouts >= 2, f"exchange_timeouts_total {timeouts}: the stall "
          "and the loss were not counted")
    # the mesh's window programs hold megawin groups: K2 launches here
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"a kernel of the failover path never launched: {launches}")
    gauges = T.snapshot()["gauges"]
    phases = {p: list(gauges.get(f"failover_{p}_seconds", {}).values())
              for p in ("detect", "rollback", "reshard", "resume")}
    check(all(len(v) == 1 and v[0] >= 0 for v in phases.values()),
          f"failover phase gauges {phases}")
    got = q.amps
    diff4 = shards_max_diff(torch, got, ref4)
    tol4 = shards_tolerance(ref4)
    check(diff4 <= tol4, f"failover vs uninterrupted 4-shard run: |err| "
          f"{diff4} > {tol4}")
    shutil.rmtree(os.path.join(tmp, "f"), ignore_errors=True)
    qt.destroyQureg(q4, env4)
    del ref4

    # the same windows on the same meshes: killed on 8, resumed on 4
    q = fresh(env8)
    try:
        qt.runResumable(q, gates, ckdir("k"), every=RES_EVERY,
                        faults=qt.FaultPlan("kill@3"))
    except qt.SimulatedPreemption:
        pass
    qt.destroyQureg(q, env8)
    q = fresh(env4, seed=999)
    qt.runResumable(q, gates, os.path.join(tmp, "k"), every=RES_EVERY)
    elastic_equal = shards_equal(torch, q.amps, got)
    check(elastic_equal, "the failover is not bit for bit the 8 -> 4 "
          "elastic resume")
    shutil.rmtree(os.path.join(tmp, "k"), ignore_errors=True)
    del got
    torch.cuda.empty_cache()
    return {"n": n, "shards": R_DRES, "every": RES_EVERY,
            "faults": plan.log, "final_shards": R_DRES // 2,
            "failover_seconds": {p: v[0] for p, v in phases.items()},
            "exchange_timeouts_total": timeouts,
            "run_ms": fo_ms, "uninterrupted_4_shards_ms": r4_ms,
            "launches": launches,
            "launches_4_shards": r4_launches,
            "k1_per_shard_4_shards": r4_launches["K1"] / (R_DRES // 2),
            "k2_per_shard_4_shards": r4_launches["K2"] / (R_DRES // 2),
            "max_abs_diff_vs_4_shards": diff4, "tolerance": tol4,
            "bit_exact_vs_elastic_resume": elastic_equal}


N_GOV_ADMIT = 34       # 128 GiB at float32: refused before any allocation
N_GOV_STRICT = 33      # 64 GiB: admitted; its drain (two states) is not
N_GOV = 30             # the spill rung and the OOM net: 8 GiB registers
N_GOV_MODEL = (26, 30)  # config 2's drain: modeled peak against the card
GOV_SPILL_BUDGET = 20 << 30   # QT_HBM_BUDGET_BYTES of the spill rung
GOV_TURNS = 3          # turns of the drain with the governor off / on
N_INTRO = 26           # introspect_main: config 2 at 26 qubits
R_INTRO = 8


@contextmanager
def env_vars(**values):
    """Environment variables set for the block (None: unset), restored
    after it."""
    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextmanager
def wrapped(module, name, before=None, after=None):
    """``module.name`` called through ``before(*args)`` / ``after(out)``
    hooks for the block."""
    real = getattr(module, name)

    def hooked(*args, **kwargs):
        if before is not None:
            before(*args)
        out = real(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(module, name, hooked)
    try:
        yield
    finally:
        setattr(module, name, real)


def bench_drain(qt, q, us, n):
    """Config 2's circuit drained on ``q`` (under gateFusion)."""
    with qt.gateFusion(q):
        apply_bench_gates(qt, q, us, n)
    sync()


def reference_state(qt, us, n, env):
    """Config 2's state at n qubits drained with the governor off on a
    register that is then destroyed: a tensor the governor does not
    count."""
    q = qt.createQureg(n, env)
    with env_vars(QT_MEM_POLICY="off"):
        bench_drain(qt, q, us, n)
    want = q.amps
    qt.destroyQureg(q, env)
    return want


def phase_governor_main(torch, np, qt, C, fused, fusion, circuits, noise):
    """The memory governor on the card, one register at full width,
    float32: (1) a 34-qubit register (128 GiB) refused before any
    allocation; (2) a 33-qubit register (64 GiB) admitted and its drain
    (two states) refused under strict before dispatch, state and buffer
    intact; (3) the spill rung: two 30-qubit registers under a 20 GiB
    budget, config 2's 770 gates on one spill the other (memory_allocated
    drops by its bytes), the drain torch.equal to the ungoverned one, the
    spilled register restored bit for bit; (5) the modeled peak of
    config 2's drain at 26 and 30 qubits against max_memory_allocated,
    and the governor's host time against the drain's; (4) a real
    torch.cuda.OutOfMemoryError under set_per_process_memory_fraction,
    caught by the net (both idle registers spilled, caches emptied, one
    retry), torch.equal to the ungoverned drain; (6) config 4's
    14-qubit noise layer (K5) under FaultPlan("oom@0") bit for bit the
    unfaulted layer."""
    import warnings

    from quest_tpu_torch import governor as G
    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import telemetry as T

    qt.set_precision(1)
    env = mesh_env(qt, 1)
    dev = env.device
    sync()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    out = {"budget_bytes": G.budget_bytes(env),
           "mem_get_info": {"free": free, "total": total},
           "memory_reserved": torch.cuda.memory_reserved(dev),
           "memory_allocated": torch.cuda.memory_allocated(dev),
           "resident_at_start": G.resident_bytes(), "policy": G.policy()}
    check(out["budget_bytes"] is not None and out["budget_bytes"] > 0,
          f"no budget on the card: {out['budget_bytes']}")
    check(G.enabled(env), "the governor is not on by default on the card")
    old_mode = T.mode_name()
    T.configure("on")
    T.reset()
    fused.reset_launch_counts()
    try:
        # (1) admission: refused before any allocation
        a0 = torch.cuda.memory_allocated(dev)
        try:
            qt.createQureg(N_GOV_ADMIT, env)
            check(False, f"createQureg({N_GOV_ADMIT}) was admitted")
        except qt.MemoryAdmissionError as e:
            refused = {"predicted": e.predicted_bytes,
                       "available": e.available_bytes,
                       "budget": e.budget_bytes}
        check(torch.cuda.memory_allocated(dev) == a0,
              "the refused register allocated device memory")
        check(refused["predicted"] == 2 * 4 << N_GOV_ADMIT,
              f"refusal {refused}")
        out["admission"] = {**refused, "allocated_change":
                            torch.cuda.memory_allocated(dev) - a0}

        # (2) strict: a 64 GiB register admitted, its drain refused
        q = qt.createQureg(N_GOV_STRICT, env)
        sync()
        a1 = torch.cuda.memory_allocated(dev)
        raw = q._amps
        mark = (id(raw), raw._version)
        with env_vars(QT_MEM_POLICY="strict"):
            try:
                with qt.gateFusion(q):
                    qt.hadamard(q, 0)
                check(False, "the strict drain was not refused")
            except qt.MemoryAdmissionError as e:
                strict = {"predicted": e.predicted_bytes,
                          "available": e.available_bytes,
                          "budget": e.budget_bytes}
        sync()
        check(len(q._fusion.gates) == 1, "the refused gate left the buffer")
        check((id(q._amps), q._amps._version) == mark
              and torch.cuda.memory_allocated(dev) == a1,
              "the refused drain touched the state or allocated")
        check(float(q._amps[0, 0]) == 1.0, "the refused state changed")
        strict["state_bytes"] = G.register_bytes_per_device(q)
        qt.destroyQureg(q, env)
        del q, raw
        torch.cuda.empty_cache()
        out["strict"] = strict
        progress(f"governor_main: admission {out['admission']}, strict "
                 f"{strict}")

        # (5) the model against the card: config 2's drain at 26 and 30
        model = {}
        for n in N_GOV_MODEL:
            us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
            q = qt.createQureg(n, env)
            state = G.register_bytes_per_device(q)
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
                t0 = time.perf_counter()
                rep = qt.explainCircuit(q)
                explain_s = time.perf_counter() - t0
                sync()
                a0 = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fused.reset_launch_counts()
                t0 = time.perf_counter()
            sync()
            drain_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - (a0 - state)
            mem = rep["memory"]
            model[n] = {"state_bytes": state,
                        "predicted_peak_bytes": mem["predicted_peak_bytes"],
                        "pass_array_bytes": mem["pass_array_bytes"],
                        "measured_peak_bytes": peak,
                        "measured_over_predicted":
                            peak / mem["predicted_peak_bytes"],
                        "fits": mem["fits"], "budget": mem["budget_bytes"],
                        "launches": window_launches(fused),
                        "explain_s": explain_s, "drain_s": drain_s}
            check(model[n]["launches"]["K1"] > 0,
                  f"K1 never launched in the governed drain at {n}")
            qt.destroyQureg(q, env)
            del q
            torch.cuda.empty_cache()
        out["model"] = model
        progress(f"governor_main: model {model}")

        # the governor's host time: its calls inside the drain against the
        # drain's wall, and the wall with the governor off and on in turns
        n = N_GOV_MODEL[0]
        us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
        q = qt.createQureg(n, env)
        bench_drain(qt, q, us, n)  # plans and side images
        starts, spent = [], []
        walls = {"off": [], "degrade": []}
        with wrapped(G, "govern_drain",
                     lambda *a: starts.append(time.perf_counter()),
                     lambda _out: G.policy() == "off" or spent.append(
                         time.perf_counter() - starts[-1])):
            for pol in ("off", "degrade", "degrade", "off") * GOV_TURNS:
                with env_vars(QT_MEM_POLICY=pol):
                    qt.initZeroState(q)
                    sync()
                    t0 = time.perf_counter()
                    bench_drain(qt, q, us, n)
                    walls[pol].append(time.perf_counter() - t0)
        qt.destroyQureg(q, env)
        del q
        out["host_overhead"] = {
            "n": n, "wall_s": {k: statistics.median(v)
                               for k, v in walls.items()},
            "wall_s_samples": walls,
            "govern_drain_s_median": statistics.median(spent),
            "govern_over_wall": statistics.median(spent)
            / statistics.median(walls["degrade"]),
            "wall_on_over_off": statistics.median(walls["degrade"])
            / statistics.median(walls["off"])}

        # (3) the spill rung
        n = N_GOV
        us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
        want = reference_state(qt, us, n, env)
        spills = []

        def before_spill(reg):
            sync()
            spills.append({"t0": time.perf_counter(),
                           "a0": torch.cuda.memory_allocated(dev)})

        def after_spill(freed):
            sync()
            spills[-1].update(seconds=time.perf_counter() - spills[-1]["t0"],
                              drop=spills[-1]["a0"]
                              - torch.cuda.memory_allocated(dev),
                              freed=freed)

        with env_vars(QT_HBM_BUDGET_BYTES=GOV_SPILL_BUDGET):
            idle = qt.createQureg(n, env)
            qt.initDebugState(idle)
            idle_copy = idle.amps.clone()
            active = qt.createQureg(n, env)
            rungs0 = T.counter_value("governor_degradations_total",
                                     rung="spill")
            with wrapped(G, "spill_register", before_spill, after_spill):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    fused.reset_launch_counts()
                    t0 = time.perf_counter()
                    bench_drain(qt, active, us, n)
                    spill_drain_s = time.perf_counter() - t0
                    spill_launches = window_launches(fused)
        check(T.counter_value("governor_degradations_total", rung="spill")
              == rungs0 + 1, "the spill rung did not fire")
        check(len(spills) == 1 and idle._amps is None,
              f"spills {spills}: the idle register was not spilled")
        state = G.register_bytes_per_device(idle)
        check(spills[0]["drop"] == state, f"the spill freed "
              f"{spills[0]['drop']} bytes of the card, not {state}")
        equal_drain = torch.equal(active.amps, want)
        check(equal_drain, "the governed drain differs from the ungoverned")
        sync()
        t0 = time.perf_counter()
        restored = idle.amps
        sync()
        restore_s = time.perf_counter() - t0
        equal_restore = torch.equal(restored, idle_copy)
        check(equal_restore, "the spilled register did not restore bit "
              "for bit")
        out["spill"] = {"n": n, "budget": GOV_SPILL_BUDGET,
                        "state_bytes": state,
                        "allocated_drop": spills[0]["drop"],
                        "spill_s": spills[0]["seconds"],
                        "restore_s": restore_s,
                        "spill_gb_per_s": state / spills[0]["seconds"] / 1e9,
                        "restore_gb_per_s": state / restore_s / 1e9,
                        "drain_s": spill_drain_s,
                        "launches": spill_launches,
                        "drain_equal": equal_drain,
                        "restore_equal": equal_restore}
        progress(f"governor_main: spill {out['spill']}")
        del restored, idle_copy
        for r in (idle, active):
            qt.destroyQureg(r, env)
        del idle, active
        torch.cuda.empty_cache()

        # (4) the real OOM net: a per-process cap under which the drain
        # cannot run beside two idle registers but can alone
        extra = model[n]["measured_peak_bytes"] - model[n]["state_bytes"]
        idles = [qt.createQureg(n, env) for _ in range(2)]
        for r in idles:
            qt.initPlusState(r)
        active = qt.createQureg(n, env)
        sync()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)   # want + 3 registers
        cap = resident - 2 * state + extra + state  # room for one spill
        fraction = cap / total
        marks = {}

        def on_recover(*_a):
            marks.setdefault("fail", time.perf_counter())

        retries0 = T.counter_total("oom_retries_total")
        torch.cuda.set_per_process_memory_fraction(fraction, dev)
        try:
            with wrapped(G, "_recover_from_oom", on_recover):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    fused.reset_launch_counts()
                    t0 = time.perf_counter()
                    bench_drain(qt, active, us, n)
                    t1 = time.perf_counter()
            oom_launches = window_launches(fused)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        retries = T.counter_total("oom_retries_total") - retries0
        check(retries == 1 and "fail" in marks,
              f"the OOM net retried {retries} times")
        check(all(r._amps is None for r in idles),
              "the OOM net did not spill both idle registers")
        equal_oom = torch.equal(active.amps, want)
        check(equal_oom, "the drain retried after the OOM differs from "
              "the ungoverned drain")
        out["oom_net"] = {"n": n, "cap_bytes": cap, "fraction": fraction,
                          "resident_before": resident,
                          "drain_extra_bytes": extra,
                          "oom_retries_total": retries,
                          "first_attempt_s": marks["fail"] - t0,
                          "retry_s": t1 - marks["fail"],
                          "launches": oom_launches, "equal": equal_oom}
        for r in idles + [active]:
            qt.destroyQureg(r, env)
        del idles, active, want
        torch.cuda.empty_cache()

        # (6) oom@0 on config 4's density drain (K5)
        nq = N_NOISE
        kops = noise.bench_kraus_ops(NOISE_SEED)
        rho_ref, _psi = noise_run(qt, noise, nq, kops)
        plan = qt.FaultPlan("oom@0")
        retries0 = T.counter_total("oom_retries_total")
        fused.reset_launch_counts()
        R._ACTIVE_FAULTS[0] = plan
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rho, _psi = noise_run(qt, noise, nq, kops)
        finally:
            R._ACTIVE_FAULTS[0] = None
        k5 = fused.LAUNCHES["K5"]
        check(plan.log == ["oom@0"], f"oom@0 fired {plan.log}")
        check(T.counter_total("oom_retries_total") == retries0 + 1,
              "oom@0 was not retried once")
        check(k5 > 0, "K5 never launched under oom@0")
        equal_rho = torch.equal(rho.amps, rho_ref.amps)
        check(equal_rho, "the faulted noise layer differs from the "
              "unfaulted one")
        out["oom_density"] = {"n": nq, "faults": plan.log, "k5_launches": k5,
                              "equal": equal_rho}
        del rho, rho_ref, _psi
        torch.cuda.empty_cache()
        out["summary_line"] = G.summary_line(env)
        out["degradations"] = {k: v for k, v in R.degradation_report().items()
                               if k.startswith("memory_governor")}
    finally:
        T.configure(old_mode)
    out["launches"] = {
        "K1": sum(m["launches"]["K1"] for m in out["model"].values())
        + out["spill"]["launches"]["K1"] + out["oom_net"]["launches"]["K1"],
        "K2": sum(m["launches"]["K2"] for m in out["model"].values())
        + out["spill"]["launches"]["K2"] + out["oom_net"]["launches"]["K2"],
        "K5": out["oom_density"]["k5_launches"]}
    return out


def phase_introspect_main(torch, np, qt, C, fused, fusion, circuits):
    """explainCircuit on config 2 at 26 qubits, one register and 8
    in-process shards, before the drain: its windows, plan windows,
    megawin windows and exchanges against the drain's counters and launch
    counts; drift 0 on 8 shards, and detected on count and bytes under
    perturb_prediction(scale=2); reportPerf's reconciliation and governor
    lines; the contract check on the card; the explain wall against the
    drain's; the dispatch floor."""
    from quest_tpu_torch import introspect
    from quest_tpu_torch import telemetry as T
    from quest_tpu_torch.analysis import contracts_check

    n = N_INTRO
    qt.set_precision(1)
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    old_mode = T.mode_name()
    T.configure("on")
    out = {"n": n}
    try:
        for r in (1, R_INTRO):
            env = mesh_env(qt, r)
            q = qt.createQureg(n, env)
            T.reset()
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
                t0 = time.perf_counter()
                rep = qt.explainCircuit(q)
                explain_s = time.perf_counter() - t0
                program = fusion.plan_items_quiet(q, list(q._fusion.gates))[0]
                fused.reset_launch_counts()
                t0 = time.perf_counter()
            sync()
            drain_s = time.perf_counter() - t0
            launches = window_launches(fused)
            st = fusion.program_stats(program)
            tot = rep["totals"]
            got = {"windows": int(T.snapshot()["histograms"].get(
                       "fusion_remap_window_items", {}).get(
                       "", {}).get("count", 1)) if r > 1 else 1,
                   "plan_windows": T.counter_total("fusion_windows_total"),
                   "mega_windows": T.counter_sum("megakernel_dispatch_total",
                                                 route="mega"),
                   "exchanges": T.counter_sum("exchanges_total",
                                              op="window_remap"),
                   "exchange_bytes": T.counter_sum("exchange_bytes_total",
                                                   op="window_remap")}
            predicted = {k: tot[k] for k in got}
            check(got == predicted, f"R={r}: the drain's counters {got} != "
                  f"explainCircuit's {predicted}")
            check(launches == {"K1": r * st.get("winfused", 0),
                               "K2": r * tot["mega_windows"]},
                  f"R={r}: launched {launches}, the plan holds {st} and "
                  f"{tot['mega_windows']} megawin groups a shard")
            check(launches["K1"] > 0, f"R={r}: K1 never launched")
            rec = {"report_totals": tot, "counters": got,
                   "launches": launches, "explain_s": explain_s,
                   "drain_s": drain_s,
                   "plan_cache": rep["plan"]["cache"],
                   "memory": rep["memory"]}
            if r > 1:
                check(launches["K2"] > 0, "K2 never launched on the mesh")
                rec["model_drift_total"] = T.counter_total("model_drift_total")
                check(rec["model_drift_total"] == 0, "a clean drain drifted")
                report = T.perf_report(env)
                rec["report_lines"] = [
                    s for s in report.splitlines()
                    if s.startswith("reconciliation")
                    or s.startswith("memory governor")]
                check(len(rec["report_lines"]) == 2, "reportPerf lacks the "
                      f"reconciliation or governor line: {rec['report_lines']}")
                # a perturbed prediction is caught on count and bytes
                q2 = qt.createQureg(n, env)
                T.reset()
                fused.reset_launch_counts()
                with introspect.perturb_prediction(scale=2):
                    bench_drain(qt, q2, us, n)
                rec["perturbed_launches"] = window_launches(fused)
                rec["perturbed_drift"] = {
                    k: T.counter_value("model_drift_total", kind=k)
                    for k in ("count", "bytes")}
                check(rec["perturbed_drift"] == {"count": 1, "bytes": 1},
                      f"drift under scale=2: {rec['perturbed_drift']}")
                check(shards_equal(torch, q2.amps, q.amps),
                      "the perturbed drain's state differs")
                qt.destroyQureg(q2, env)
            out[f"R{r}"] = rec
            qt.destroyQureg(q, env)
            del q
        errors = contracts_check.verify_sharded_contracts(
            contracts_check.canonical_env(DEVICE))
        check(errors == [], f"contract check on the card: {errors}")
        out["contracts"] = "ok"
        out["dispatch_floor_us"] = introspect.measure_dispatch_floor(
            64, torch.device(DEVICE)) * 1e6
    finally:
        T.configure(old_mode)
    torch.cuda.empty_cache()
    out["launches"] = {k: out["R1"]["launches"][k]
                       + out[f"R{R_INTRO}"]["launches"][k]
                       + out[f"R{R_INTRO}"]["perturbed_launches"][k]
                       for k in ("K1", "K2")}
    return out


# ---------------------------------------------------------------------------
# The serving layer (M16e) and F2
# ---------------------------------------------------------------------------

N_SERVE = 26           # config 2 served at its full width, float32
SERVE_JOBS = 8         # batch jobs: one bank of 8 (4.3 GB)
SERVE_BURST = 2        # interactive jobs, after the batch bank's 3rd window
SERVE_BURST_AFTER = 3
SERVE_WINDOW = 16      # QT_SERVE_WINDOW
SERVE_WEIGHTS = {"t1": 1.0, "t3": 3.0}
SERVE_MEASURE = (0, 25)
N_CHAOS = 20           # the chaos arm: 8 in-process shards of the card
R_CHAOS = 8
CHAOS_SEED = 12        # an even seed: host_loss, then heal
CHAOS_JOBS = 12
CHAOS_DEPTH = 4
N_AB = 20              # scripts/bench_serve.py's A/B at 20 qubits
AB_JOBS, AB_LIVE = 48, 16
AB_DEPTH, AB_LIVE_DEPTH = 6, 5
AB_RATE_MULT = 4.0
N_F2 = 32              # F2: config 2's drain on a 34.4 GB float32 register


def drop_plan_caches(fusion, kernels) -> None:
    """Empty the process's plan caches (their device copies of pass
    arrays and gather indices), which no register owns; the persistent
    plan tier's files stay."""
    fusion.clear_plan_caches()
    kernels._FIELD_INDEX.clear()


def serve_gates(circuits, n, depth, seed):
    """Config 2's structure at n qubits with the unitaries of ``seed``:
    one randomized-compiling variant, as a served job's gate list."""
    return circuits.bench_gate_list(
        n, depth, circuits.bench_unitaries(n, depth, seed=seed))


def percentiles(xs) -> dict:
    import numpy as np

    if not xs:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": 1e3 * float(np.percentile(xs, 50)),
            "p99_ms": 1e3 * float(np.percentile(xs, 99))}


@contextmanager
def serve_probe(torch, fusion):
    """Host seconds in the drains' planning (fusion._plan_optimized, its
    plan tiers' lookups included) on the thread that opens the block, the
    serving thread, and on any other (the warm pool's: ``pool_plan_s``),
    and device milliseconds of the programs (CUDA events around
    fusion.execute_program), summed over the block."""
    import threading

    rec = {"plan_s": 0.0, "plans": 0, "pool_plan_s": 0.0, "pool_plans": 0,
           "events": []}
    plan_real, exec_real = fusion._plan_optimized, fusion.execute_program
    serving = threading.get_ident()
    local = threading.local()

    def plan(*a, **k):
        # a bank's plan calls itself per element: time the outermost call
        depth = getattr(local, "depth", 0)
        local.depth = depth + 1
        t0 = time.perf_counter()
        try:
            return plan_real(*a, **k)
        finally:
            local.depth = depth
            if not depth:
                pre = "" if threading.get_ident() == serving else "pool_"
                rec[pre + "plan_s"] += time.perf_counter() - t0
                rec[pre + "plans"] += 1

    def execute(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = exec_real(*a, **k)
        end.record()
        rec["events"].append((start, end))
        return out

    fusion._plan_optimized, fusion.execute_program = plan, execute
    try:
        yield rec
    finally:
        fusion._plan_optimized, fusion.execute_program = plan_real, exec_real
        sync()
        rec["device_ms"] = sum(s.elapsed_time(e) for s, e in rec["events"])
        rec["programs"] = len(rec.pop("events"))


def serve_trace(torch, qt, S, fusion, env, jobs, burst, *, preempt, ckpt,
                prewarm=False, warmset=None, keep=None):
    """Serve config 2's batch jobs and, after the batch bank's third
    window, the interactive burst; returns the jobs and the run's record:
    wall, per-class latencies, counters, the preemption's memory drop and
    seconds, planning seconds against device ms.  ``prewarm``: the warm
    pool on; ``warmset``: another server's export_warmset(), adopted and
    warmed before the trace (its seconds: ``warm_from_s``); ``keep``
    receives this server's export_warmset()."""
    from quest_tpu_torch import telemetry as T

    T.reset()
    rec = {"preempt": preempt, "prewarm": prewarm}
    drops, spans = [], {"checkpoint_s": [], "resume_s": []}
    with env_vars(QT_SERVE_WINDOW=SERVE_WINDOW):
        srv = S.SimServer(env, max_batch=SERVE_JOBS, preempt=preempt,
                          ckpt_dir=ckpt, prewarm=prewarm)
        if warmset is not None:
            t0 = time.perf_counter()
            rec["warm_from_specs"] = srv.warm_from(warmset)
            check(srv.prewarm_join(timeout=600), "warm_from: the warm "
                  "pool did not drain in 600 s")
            rec["warm_from_s"] = time.perf_counter() - t0
        preempt_real, resume_real = srv._preempt, srv._resume

        def preempt_hook(bank):
            live = bank.running and not bank.paused
            sync()
            a0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
            preempt_real(bank)
            sync()
            if live and bank.preempted:
                spans["checkpoint_s"].append(time.perf_counter() - t0)
                drops.append(a0 - torch.cuda.memory_allocated())

        def resume_hook(bank):
            t0 = time.perf_counter()
            resume_real(bank)
            sync()
            spans["resume_s"].append(time.perf_counter() - t0)

        srv._preempt, srv._resume = preempt_hook, resume_hook
        try:
            for name, w in SERVE_WEIGHTS.items():
                srv.register_tenant(name, weight=w)
            names = list(SERVE_WEIGHTS)
            with serve_probe(torch, fusion) as probe:
                sync()
                t0 = time.perf_counter()
                handles = [srv.submit(g, num_qubits=N_SERVE, seed=j,
                                      tenant=names[j % 2],
                                      measure=SERVE_MEASURE)
                           for j, g in enumerate(jobs)]
                for _ in range(SERVE_BURST_AFTER):
                    srv.step()
                handles += [srv.submit(g, num_qubits=N_SERVE,
                                       seed=SERVE_JOBS + j,
                                       tenant=names[j % 2],
                                       priority=S.INTERACTIVE,
                                       measure=SERVE_MEASURE)
                            for j, g in enumerate(burst)]
                steps = SERVE_BURST_AFTER + srv.run_until_idle()
                sync()
                wall = time.perf_counter() - t0
            stats = srv.stats()
            if prewarm:
                t0 = time.perf_counter()
                check(srv.prewarm_join(timeout=600), "the warm pool did "
                      "not drain in 600 s")
                rec["pool_tail_s"] = time.perf_counter() - t0
                rec["prewarm_statuses"] = T.snapshot()["counters"].get(
                    "serve_prewarm_total", {})
            if keep is not None:
                keep["warmset"] = srv.export_warmset()
        finally:
            srv.close()
    for cls in (S.BATCH, S.INTERACTIVE):
        js = [j for j in handles if j.priority == cls]
        rec[cls] = {"jobs": len(js),
                    "queue_wait": percentiles([j.t_start - j.t_submit
                                               for j in js]),
                    "e2e": percentiles([j.t_done - j.t_submit for j in js])}
    rec.update(
        steps=steps, wall_s=wall, wall_per_circuit_s=wall / len(handles),
        banks=T.counter_total("serve_banks_total"),
        windows=T.counter_total("serve_windows_total"),
        preemptions=T.counter_total("preemptions_total"),
        resumes=T.counter_total("serve_resumes_total"),
        admission_stalls=T.counter_total("serve_admission_stalls_total"),
        memory_drops=drops, **spans,
        plan_s=probe["plan_s"], plans=probe["plans"],
        pool_plan_s=probe["pool_plan_s"], pool_plans=probe["pool_plans"],
        plan_spans=hist_stats(T, "span_seconds", name="fusion.plan")[
            "count"],
        device_ms=probe["device_ms"], programs=probe["programs"],
        device_busy_share=probe["device_ms"] / (wall * 1e3),
        plan_share_of_wall=probe["plan_s"] / wall,
        completed=stats["completed"], banks_left=stats["banks"])
    return handles, rec


def single_register_run(torch, qt, R, env, gates, seed, n):
    """One job's own run on one register: its gates drained window by
    window (the serving windows), then its measurement schedule drawn
    from the stream ``seed`` seeds, as the bank's element draws it."""
    qt.seedQuEST(env, [seed])
    q = qt.createQureg(n, env)
    ex = R.WindowExecutor(q, gates, every=SERVE_WINDOW)
    while not ex.done:
        ex.step()
    outcomes = [int(qt.measure(q, t)) for t in SERVE_MEASURE]
    amps = q.amps.cpu()
    qt.destroyQureg(q, env)
    return amps, outcomes


def phase_serve_main(torch, np, qt, fused, fusion, circuits, kernels, tmp):
    """Config 2 served by SimServer at 26 qubits on the card (see the
    module text, 44)."""
    import warnings

    from quest_tpu_torch import governor as G
    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T

    n = N_SERVE
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    drop_plan_caches(fusion, kernels)
    sync()
    torch.cuda.empty_cache()
    a_start = torch.cuda.memory_allocated()
    jobs = [serve_gates(circuits, n, DEPTH, SEED + j)
            for j in range(SERVE_JOBS)]
    burst = [serve_gates(circuits, n, DEPTH, SEED + SERVE_JOBS + j)
             for j in range(SERVE_BURST)]
    bank_bytes = SERVE_JOBS * 2 * 4 << n
    old_mode = T.mode_name()
    T.configure("on")
    out = {"n": n, "depth": DEPTH, "gates": len(jobs[0]),
           "batch_jobs": SERVE_JOBS, "interactive_jobs": SERVE_BURST,
           "window": SERVE_WINDOW, "weights": SERVE_WEIGHTS,
           "measure": list(SERVE_MEASURE), "bank_bytes": bank_bytes,
           "budget": G.budget_bytes(env), "allocated_at_start": a_start}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # the uninterrupted run: no preemption
            base, out["uninterrupted"] = serve_trace(
                torch, qt, S, fusion, env, jobs, burst, preempt="off",
                ckpt=os.path.join(tmp, "serve_off"))
            progress(f"serve_main: uninterrupted {out['uninterrupted']}")
            # the served run: the burst checkpoints the batch bank
            fused.reset_launch_counts()
            got, rec = serve_trace(
                torch, qt, S, fusion, env, jobs, burst,
                preempt="checkpoint", ckpt=os.path.join(tmp, "serve_ckpt"))
            launches = bank_launches(fused)
        out["served"] = rec
        progress(f"serve_main: served {rec}")
        check(all(j.state == S.DONE for j in got + base),
              "a served job did not complete")
        check(rec["preemptions"] >= 1 and rec["resumes"] >= 1,
              f"the burst preempted nothing: {rec}")
        check(rec["memory_drops"] and rec["memory_drops"][0] == bank_bytes,
              f"the checkpoint freed {rec['memory_drops']} bytes of the "
              f"card, not the bank's {bank_bytes}")
        equal = [torch.equal(a.amps, b.amps) for a, b in zip(got, base)]
        check(all(equal), f"served jobs differ from the uninterrupted "
              f"run: {equal}")
        check([j.outcomes for j in got] == [j.outcomes for j in base],
              "the measured outcomes differ from the uninterrupted run")
        check([j.key_state for j in got] == [j.key_state for j in base],
              "the key states differ from the uninterrupted run")
        check(launches["K1_bank"] > 0, f"K1's bank form never launched "
              f"on the serving path: {launches}")
        out["launches"] = launches
        # every job against its own single-register windowed drain
        errs, same_outcomes = [], []
        for j, g in zip(got, jobs + burst):
            amps, outs = single_register_run(torch, qt, R, env, g, j.seed,
                                             n)
            errs.append(float((amps - j.amps).abs().max()))
            same_outcomes.append(outs == [o for o, _p in j.outcomes])
        check(max(errs) <= 1e-5 and all(same_outcomes),
              f"jobs against their single-register drains: {errs}, "
              f"outcomes equal {same_outcomes}")
        out["single_register_max_abs_err"] = max(errs)
        out["jobs_equal_uninterrupted"] = all(equal)
        # the uninterrupted states' digests: aot_main's served runs are
        # held to them
        out["uninterrupted_sha256"] = [amps_sha256(j.amps) for j in base]
        del got, base
        drop_plan_caches(fusion, kernels)
        sync()
        torch.cuda.empty_cache()
        a_end = torch.cuda.memory_allocated()
        check(a_end == a_start, f"memory_allocated {a_end} after close(), "
              f"{a_start} at the start")
        out["allocated_after_close"] = a_end
        out["resident_after_close"] = G.resident_bytes()
    finally:
        T.configure(old_mode)
    return out


def phase_serve_chaos(torch, np, qt, fused, circuits, tmp):
    """scripts/chaos_serve.py's trace on 8 in-process shards of the card
    at 20 qubits for one seed: a bank fault, IO faults, a host loss then a
    heal, an OOM and a poisoned job (see the module text, 45)."""
    import warnings

    from quest_tpu_torch import governor as G
    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T

    n, seed = N_CHAOS, CHAOS_SEED
    qt.set_precision(1)
    rng = np.random.RandomState(seed)
    trace = []
    for _ in range(CHAOS_JOBS):
        tenant = ("alice", "bob", "carol")[int(rng.randint(3))]
        useed = int(rng.randint(1 << 30))
        prio = S.INTERACTIVE if rng.rand() < 0.25 else S.BATCH
        trace.append((tenant, useed, prio))
    rng = np.random.RandomState(seed ^ 0x5EED)
    loss_at = int(rng.randint(6, 10))
    heal_at = loss_at + int(rng.randint(4, 8))
    oom_at = int(rng.randint(2, 5))
    poison = int(rng.randint(0, CHAOS_JOBS))
    spec = (f"bank_fault@{int(rng.randint(2, 6))},io@2,host_loss@{loss_at},"
            f"heal@{heal_at},oom@{oom_at},poison_job@{poison}")
    gates = {u: serve_gates(circuits, n, CHAOS_DEPTH, u)
             for _t, u, _p in trace}

    def run(plan_spec, tag):
        with env_vars(QT_TOPOLOGY="2x4", QT_RETRY_BASE_SECONDS="0.001"):
            return run_trace(plan_spec, tag)

    def run_trace(plan_spec, tag):
        R.seed_backoff_jitter([20260805])
        env = mesh_env(qt, R_CHAOS)
        qt.seedQuEST(env, [seed])
        plan = R.FaultPlan(plan_spec) if plan_spec else None
        T.reset()
        srv = S.SimServer(env, window=SERVE_WINDOW, max_batch=4, retries=4,
                          watchdog=1, quarantine=(100, 3600.0), faults=plan,
                          ckpt_dir=os.path.join(tmp, tag))
        moved = set()

        def mark(fn):
            def marked(*args):
                moved.update(j.id for b in srv._banks if b.started
                             for j in b.jobs)
                return fn(*args)
            return marked

        start_real = srv._start

        def start(bank):
            start_real(bank)
            if srv.env is not srv._full_env:
                moved.update(j.id for j in bank.jobs)

        srv._failover, srv.heal = mark(srv._failover), mark(srv.heal)
        srv._start = start
        handles = []
        fused.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            for i, (tenant, u, prio) in enumerate(trace):
                handles.append(srv.submit(
                    gates[u], num_qubits=n, tenant=tenant, priority=prio,
                    measure=(0, n - 1)))
                if i % 3 == 2:
                    for _ in range(2):
                        srv.step()
            steps = srv.run_until_idle(max_steps=4000)
            sync()
            wall = time.perf_counter() - t0
            stats = srv.stats()
            dumps = []
            for p in srv.flight_dumps:
                with open(p) as f:
                    dumps.append(json.load(f)["reason"])
            traces = {h.id: srv.tracez(h) for h in handles}
        finally:
            srv.close()
        return {"handles": handles, "stats": stats, "steps": steps,
                "wall_s": wall, "plan": plan, "dumps": dumps,
                "traces": traces, "moved": moved,
                "launches": bank_launches(fused),
                "failovers": T.counter_total("serve_failovers_total"),
                "heals": T.counter_total("serve_heals_total"),
                "retries": T.counter_total("serve_bank_retries_total"),
                "mttr_s": T.gauge_max("serve_failover_mttr_seconds")}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        base = run("", "chaos_base")
        chaos = run(spec, "chaos_run")
    bj = {h.id: h for h in base["handles"]}
    failed = {h.id for h in chaos["handles"] if h.state != S.DONE}
    check(chaos["steps"] < 4000 and chaos["stats"]["queued"] == 0
          and chaos["stats"]["banks"] == 0 and G.resident_bytes() == 0,
          f"the chaos run did not reach idle: {chaos['stats']}")
    check(failed == {poison}, f"failed jobs {failed}, poisoned {poison}")
    exact, close, errs = 0, 0, []
    for h in chaos["handles"]:
        if h.id == poison:
            continue
        b = bj[h.id]
        check(h.key_state == b.key_state, f"job {h.id}: key state differs")
        if torch.equal(h.amps, b.amps) and h.outcomes == b.outcomes:
            exact += 1
            continue
        # a job whose windows ran on the shrunk mesh: planned at another
        # shard width, its sums run in another order (ROADMAP Queue 3)
        check(h.id in chaos["moved"], f"job {h.id} never left the full "
              "mesh but differs from the fault-free replay")
        err = float((h.amps - b.amps).abs().max())
        errs.append(err)
        check(err <= tolerance(b.amps) and [o for o, _ in h.outcomes]
              == [o for o, _ in b.outcomes], f"job {h.id}: {err}")
        close += 1
    fired = {e.split("@")[0] for e in chaos["plan"].log}
    check({"bank_fault", "host_loss", "heal", "poison_job", "io", "oom"}
          <= fired, f"faults fired: {chaos['plan'].log}")
    check("quarantine" in chaos["dumps"] and "failover" in chaos["dumps"],
          f"flight dumps {chaos['dumps']}")
    for h in chaos["handles"]:
        if h.id == poison:
            continue
        tz = chaos["traces"][h.id]
        names = [e["name"] for e in tz["events"]]
        order = [names.index(k) for k in ("serve.admit", "serve.bank_join",
                                          "serve.window", "serve.complete")]
        check(tz["complete"] and order == sorted(order)
              and (h.attempts == 1 or "serve.retry" in names),
              f"job {h.id}: trace {names}")
    check(chaos["launches"]["K1_bank"] > 0,
          f"K1's bank form never launched per shard: {chaos['launches']}")
    return {"n": n, "shards": R_CHAOS, "seed": seed, "plan": spec,
            "fired": chaos["plan"].log, "jobs": CHAOS_JOBS,
            "poisoned": poison, "failed": sorted(failed),
            "bit_identical": exact, "within_tolerance_after_moving": close,
            "moved_max_abs_err": max(errs) if errs else 0.0,
            "steps": chaos["steps"], "baseline_steps": base["steps"],
            "wall_s": chaos["wall_s"], "baseline_wall_s": base["wall_s"],
            "failovers": chaos["failovers"], "heals": chaos["heals"],
            "bank_retries": chaos["retries"],
            "failover_mttr_s": chaos["mttr_s"],
            "flight_dumps": chaos["dumps"],
            "devices_after": chaos["stats"]["devices"],
            "launches": chaos["launches"],
            "baseline_launches": base["launches"]}


def ab_circuit(np, C, rng, n, depth):
    """scripts/bench_serve.py's circuit: depth layers of one random SU(2)
    on every qubit; one structure, matrices per submission."""
    gates = []
    for _d in range(depth):
        for t in range(n):
            g = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
            u, _r = np.linalg.qr(g)
            gates.append(C.Gate((t,), np.stack([u.real, u.imag])))
    return gates


def phase_serve_ab(torch, np, qt, C, batch):
    """scripts/bench_serve.py's A/B at 20 qubits, recorded only (see the
    module text, 46)."""
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T

    n = N_AB
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    rng = np.random.default_rng(31)
    batch_circs = [ab_circuit(np, C, rng, n, AB_DEPTH)
                   for _ in range(AB_JOBS)]
    live_circs = [ab_circuit(np, C, rng, n, AB_LIVE_DEPTH)
                  for _ in range(AB_LIVE)]

    def drain_one(gates):
        sched = batch.EnsembleScheduler(n, env, max_batch=1)
        sched.submit(gates)
        sched.drain()
        sync()

    def baseline(trace):
        waits, e2e = [], []
        t0 = time.perf_counter()
        for gates, due in zip(batch_circs, trace):
            now = time.perf_counter() - t0
            if due > now:
                time.sleep(due - now)
            start = time.perf_counter() - t0
            drain_one(gates)
            done = time.perf_counter() - t0
            waits.append(start - due)
            e2e.append(done - due)
        span = float((time.perf_counter() - t0) - trace[0])
        return {"circuits_per_s": len(trace) / span, "makespan_s": span,
                "queue_wait": percentiles(waits), "e2e": percentiles(e2e)}

    def continuous(arrivals, only_live=False):
        srv = S.SimServer(env, window=SERVE_WINDOW, max_batch=16)
        srv.register_tenant("batch", max_pending=4096)
        srv.register_tenant("live", max_pending=4096)
        jobs = []
        try:
            i = 0
            t0 = time.perf_counter()
            while i < len(arrivals) or not all(j.done for _d, _p, j in jobs):
                now = time.perf_counter() - t0
                while i < len(arrivals) and arrivals[i][0] <= now:
                    due, gates, prio = arrivals[i]
                    jobs.append((due, prio, srv.submit(
                        gates, num_qubits=n, priority=prio, seed=i,
                        tenant="live" if prio == S.INTERACTIVE
                        else "batch")))
                    i += 1
                if not srv.step() and i < len(arrivals):
                    time.sleep(min(0.001, max(0.0, arrivals[i][0] - (
                        time.perf_counter() - t0))))
            sync()
            out = {}
            for prio in ((S.INTERACTIVE,) if only_live
                         else (S.BATCH, S.INTERACTIVE)):
                js = [(d, j) for d, p, j in jobs if p == prio]
                span = float(max(j.t_done - t0 for _d, j in js) - min(
                    d for d, _j in js))
                out[prio] = {
                    "count": len(js), "circuits_per_s": len(js) / span,
                    "queue_wait": percentiles([j.t_start - j.t_submit
                                               for _d, j in js]),
                    "e2e": percentiles([j.t_done - j.t_submit
                                        for _d, j in js])}
            return out
        finally:
            srv.close()

    # warm the plan and dispatch paths both arms take (the port compiles
    # nothing: its kernels were built at the start)
    drain_one(batch_circs[0])
    continuous([(0.0, batch_circs[1], S.BATCH),
                (0.0, live_circs[0], S.INTERACTIVE)])
    t0 = time.perf_counter()
    drain_one(batch_circs[0])
    per_circuit = time.perf_counter() - t0
    rate = AB_RATE_MULT / per_circuit
    trace = np.cumsum(rng.exponential(1.0 / rate, size=AB_JOBS))
    base = baseline(trace)
    live = np.cumsum(rng.exponential(1.0 / (rate / max(6, AB_JOBS // 2)),
                                     size=AB_LIVE))
    mixed = sorted([(float(t), g, S.BATCH)
                    for t, g in zip(trace, batch_circs)]
                   + [(float(t), g, S.INTERACTIVE)
                      for t, g in zip(live, live_circs)],
                   key=lambda a: a[0])
    T.reset()
    cont = continuous(mixed)
    cont["preemptions"] = T.counter_total("preemptions_total")
    cont["banks"] = T.counter_total("serve_banks_total")
    unloaded = continuous([(float(t), g, S.INTERACTIVE)
                           for t, g in zip(live, live_circs)], True)
    speedup = float(cont[S.BATCH]["circuits_per_s"]
                    / base["circuits_per_s"])
    loaded = cont[S.INTERACTIVE]["e2e"]["p99_ms"]
    alone = unloaded[S.INTERACTIVE]["e2e"]["p99_ms"]
    return {"n": n, "jobs": AB_JOBS, "depth": AB_DEPTH,
            "interactive_jobs": AB_LIVE, "interactive_depth": AB_LIVE_DEPTH,
            "window": SERVE_WINDOW, "max_batch": 16,
            "baseline_per_circuit_s": per_circuit,
            "arrival_rate_per_s": float(rate), "baseline": base,
            "continuous": cont, "interactive_unloaded": unloaded,
            "speedup": speedup, "speedup_budget": 2.0,
            "speedup_met": speedup >= 2.0,
            "interactive_p99_ratio": float(loaded / alone),
            "interactive_p99_budget": 2.0,
            "interactive_p99_met": bool(loaded / alone <= 2.0)}


def phase_f2_main(torch, np, qt, fused, fusion, circuits, kernels):
    """F2: config 2's 770 gates on a 32-qubit float32 register (34.4 GB)
    under QT_MEM_POLICY=degrade: refused before allocating, or drained to
    the end within the governor's two-state model (see the module text,
    47)."""
    import warnings

    from quest_tpu_torch import governor as G

    n = N_F2
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    drop_plan_caches(fusion, kernels)
    sync()
    torch.cuda.empty_cache()
    dev = env.device
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    out = {"n": n, "state_bytes": 2 * 4 << n,
           "budget": G.budget_bytes(env)}
    a0 = torch.cuda.memory_allocated(dev)
    with env_vars(QT_MEM_POLICY="degrade"):
        try:
            q = qt.createQureg(n, env)
        except qt.MemoryAdmissionError as e:
            check(torch.cuda.memory_allocated(dev) == a0,
                  "the refused register allocated")
            out.update(outcome="refused", predicted=e.predicted_bytes)
            return out
        # the drain runs as the fusion context closes: an allocator failure
        # after the admission raises there and fails the phase
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
                predicted = qt.explainCircuit(q)["memory"][
                    "predicted_peak_bytes"]
                sync()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fused.reset_launch_counts()
                t0 = time.perf_counter()
        sync()
        drain_s = time.perf_counter() - t0
        state = G.register_bytes_per_device(q)
        peak = torch.cuda.max_memory_allocated(dev) - (base - state)
        launches = window_launches(fused)
        # the norm and P(top = 0) 2^28 amplitudes at a time: calcTotalProb
        # squares the whole state in temporaries, 1.5 states more than
        # the card holds beside a 32-qubit one
        a, half, step = q.amps, 1 << (n - 1), 1 << 28
        parts = [float(torch.sum(a[:, i:i + step].double() ** 2))
                 for i in range(0, 1 << n, step)]
        total, p0 = sum(parts), sum(parts[:half // step])
        del a
        qt.destroyQureg(q, env)
        del q
    torch.cuda.empty_cache()
    check(abs(total - 1.0) <= 1e-3, f"calcTotalProb {total} at {n} qubits")
    # the two-state model holds: a third live state would be 1.5x
    check(peak <= 1.05 * predicted, f"the drain peaked at {peak} bytes, "
          f"above the governor's {predicted}")
    check(launches["K1"] > 0, "K1 never launched at 32 qubits")
    out.update(outcome="completed", predicted_peak_bytes=predicted,
               measured_peak_bytes=peak,
               measured_over_predicted=peak / predicted,
               measured_states=peak / state, drain_s=drain_s,
               calc_total_prob=total, p_top_zero=p0, launches=launches)
    return out


# ---------------------------------------------------------------------------
# The persistent plan cache and the warm pool (M16f)
# ---------------------------------------------------------------------------

AOT_CHILD_TIMEOUT = 300
# QT_AOT_CACHE_MAX_BYTES of the serving arms: the two banks' 98 window
# plans at 26 qubits, 8 and 2 elements each, with room to spare
AOT_SERVE_CAP = 4 << 30


def amps_sha256(t) -> str:
    """sha256 of a state's bytes (a tensor, copied to the host)."""
    import hashlib

    a = t.detach().contiguous().cpu().numpy()
    return hashlib.sha256(a.data).hexdigest()


def run_child(code: str, cache: str, timeout: int = AOT_CHILD_TIMEOUT):
    """``python3 -c code`` from this script's directory with QT_AOT_CACHE
    set to ``cache``; the child's last stdout line, parsed as JSON."""
    here = str(Path(__file__).resolve().parent)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=here, capture_output=True,
        text=True, timeout=timeout,
        env=dict(os.environ, QT_AOT_CACHE=cache,
                 PYTHONPATH=os.pathsep.join(
                     [here, os.environ.get("PYTHONPATH", "")]).rstrip(
                         os.pathsep)))
    check(res.returncode == 0, f"aot child failed ({res.returncode}): "
          f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def aot_record(A, T, fused) -> dict:
    """The plan tiers' counters, planning spans and K1/K2 launches of this
    process so far."""
    s = A.stats()
    spans = hist_stats(T, "span_seconds", name="fusion.plan")
    return {"aot": {k: s[k] for k in ("hits", "misses", "puts",
                                      "evictions", "errors", "bytes",
                                      "saved_seconds")},
            "plan_spans": spans["count"],
            "plan_seconds": (spans["mean"] or 0.0) * spans["count"],
            "plan_cache_hits": T.counter_total(
                "fusion_plan_cache_hits_total"),
            "plan_cache_misses": T.counter_total(
                "fusion_plan_cache_misses_total"),
            "launches": window_launches(fused)}


def aot_child() -> None:
    """(a)'s child: config 2 at N_MAIN qubits, float32, drained once by
    the bench route (the gate list as one drain) and once by the API route
    (the gates under gateFusion), with the parent's QT_AOT_CACHE; prints
    one JSON line: each route's first-drain wall and state digest, the
    seconds spent loading plans, the tiers' counters, planning spans and
    K1/K2 launches."""
    import torch

    import quest_tpu_torch as qt
    from quest_tpu_torch import aotcache as A
    from quest_tpu_torch import fusion
    from quest_tpu_torch import telemetry as T
    from quest_tpu_torch.models import circuits
    from quest_tpu_torch.ops import build, fused

    build.build_kernels()
    T.configure("on")
    qt.set_precision(1)
    n = N_MAIN
    us = circuits.bench_unitaries(n, DEPTH, seed=SEED)
    gates = circuits.bench_gate_list(n, DEPTH, us)
    env = mesh_env(qt, 1)
    loads = []
    load_real = A.load

    def load(*a, **k):
        t0 = time.perf_counter()
        try:
            return load_real(*a, **k)
        finally:
            loads.append(time.perf_counter() - t0)

    A.load = load
    T.reset()
    fused.reset_launch_counts()
    routes = {}
    for route in ("bench", "api"):
        q = qt.createQureg(n, env)
        sync()
        t0 = time.perf_counter()
        if route == "bench":
            inject(fusion, q, gates)
        else:
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, n)
        sync()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(q.amps).all()), f"{route}: bad state")
        routes[route] = {"first_drain_wall_s": wall,
                         "sha256": amps_sha256(q.amps),
                         "p_top_zero": qt.calcProbOfOutcome(q, n - 1, 0)}
        qt.destroyQureg(q, env)
    A.load = load_real
    rec = aot_record(A, T, fused)
    rec.update(routes=routes, load_seconds=sum(loads), loads=len(loads),
               entries=sorted(os.path.getsize(os.path.join(A.cache_dir(), f))
                              for f in os.listdir(A.cache_dir())
                              if f.endswith(".qtplan")))
    print(json.dumps(rec), flush=True)


def aot_replica_child(warmset_path: str) -> None:
    """(b)'s fresh replica: a SimServer that takes the first server's
    exported warm set through warm_from, then serves the same jobs as
    serve_main; prints one JSON line with the served record, the state
    digests and the tiers' counters."""
    import pickle
    import tempfile
    import warnings

    import torch

    import quest_tpu_torch as qt
    from quest_tpu_torch import aotcache as A
    from quest_tpu_torch import fusion
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T
    from quest_tpu_torch.models import circuits
    from quest_tpu_torch.ops import build, fused

    build.build_kernels()
    T.configure("on")
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    with open(warmset_path, "rb") as f:
        warmset = pickle.load(f)
    jobs = [serve_gates(circuits, N_SERVE, DEPTH, SEED + j)
            for j in range(SERVE_JOBS)]
    burst = [serve_gates(circuits, N_SERVE, DEPTH, SEED + SERVE_JOBS + j)
             for j in range(SERVE_BURST)]
    fused.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replica_") as tmp, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, rec = serve_trace(torch, qt, S, fusion, env, jobs, burst,
                               preempt="checkpoint", ckpt=tmp,
                               prewarm=True, warmset=warmset)
        tiers = aot_record(A, T, fused)
        digests = [amps_sha256(j.amps) for j in got]
    rec.update(tiers=tiers, launches=bank_launches(fused),
               sha256=digests, done=all(j.state == S.DONE for j in got))
    print(json.dumps(rec), flush=True)


def explain_steps(torch, qt, A, fusion, kernels, us, n, env, keep):
    """(c): explainCircuit's compile status before each of three drains
    of config 2's API route (cold, warm, a fresh process) and the aot
    counters each drain then moved; ``keep["amps"]`` the first state."""
    from quest_tpu_torch import telemetry as T

    steps = []
    for step in range(3):
        if step == 2:
            drop_plan_caches(fusion, kernels)
        q = qt.createQureg(n, env)
        qt.startGateFusion(q)
        apply_bench_gates(qt, q, us, n)
        t0 = time.perf_counter()
        rep = qt.explainCircuit(q)
        explain_s = time.perf_counter() - t0
        base = A.stats()
        sync()
        t0 = time.perf_counter()
        qt.stopGateFusion(q)
        sync()
        wall = time.perf_counter() - t0
        s = A.stats()
        moved = [s[k] - base[k] for k in ("hits", "misses", "puts")]
        steps.append({"predicted": rep["compile"]["aot"],
                      "moved": dict(zip(("hits", "misses", "puts"), moved)),
                      "explain_s": explain_s, "drain_wall_s": wall})
        if step == 0:
            keep["amps"] = q.amps.clone()
        qt.destroyQureg(q, env)
    want = {"miss": [0, 1, 1], "memory": [0, 0, 0], "hit": [1, 0, 0]}
    drift = sum(1 for st in steps
                if [st["moved"][k] for k in ("hits", "misses", "puts")]
                != want.get(st["predicted"]))
    return {"steps": steps, "drift": drift,
            "model_drift_total": T.counter_total("model_drift_total")}


def phase_aot_main(torch, np, qt, fused, fusion, circuits, kernels, tmp,
                   served):
    """The persistent plan cache on the card (see the module text, 48):
    (a) a cold and a warm child process, (b) serving with the warm pool
    off and on and a replica booted from its warm set, (c) explain's
    prediction against the drains' counters, (d) a truncated entry."""
    import pickle
    import warnings

    from quest_tpu_torch import aotcache as A
    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T

    out = {"n": N_MAIN, "depth": DEPTH}
    drop_plan_caches(fusion, kernels)
    sync()
    torch.cuda.empty_cache()
    # (a) the cold child plans, stores and drains; the warm child loads
    cache_a = os.path.join(tmp, "aot_a")
    code = "import chip_smoke as cs; cs.aot_child()"
    cold = run_child(code, cache_a)
    warm = run_child(code, cache_a)
    for route in ("bench", "api"):
        check(cold["routes"][route]["sha256"]
              == warm["routes"][route]["sha256"],
              f"(a) {route}: the warm child's state differs from the cold "
              "child's")
    check(warm["plan_spans"] == 0 and warm["aot"]["puts"] == 0,
          f"(a) the warm child planned: {warm}")
    check(warm["aot"]["hits"] == cold["aot"]["puts"] > 0
          and warm["plan_cache_misses"] == warm["aot"]["hits"],
          f"(a) the warm child's hits {warm['aot']} against the cold "
          f"child's puts {cold['aot']}")
    check(cold["launches"] == warm["launches"]
          and sum(cold["launches"].values()) > 0,
          f"(a) launches: cold {cold['launches']}, warm {warm['launches']}")
    out["a"] = {"cold": cold, "warm": warm,
                "plan_seconds_cold": cold["plan_seconds"],
                "load_seconds_warm": warm["load_seconds"],
                "entry_bytes": cold["entries"],
                "cache_bytes": sum(cold["entries"])}
    progress(f"aot_main (a): {out['a']}")

    # (b) serving as serve_main does it, the cache on: the warm pool off,
    # then on (each from an empty cache and an empty memory tier), then a
    # replica in a fresh child from the second server's warm set
    qt.set_precision(1)
    env = mesh_env(qt, 1)
    jobs = [serve_gates(circuits, N_SERVE, DEPTH, SEED + j)
            for j in range(SERVE_JOBS)]
    burst = [serve_gates(circuits, N_SERVE, DEPTH, SEED + SERVE_JOBS + j)
             for j in range(SERVE_BURST)]
    old_mode = T.mode_name()
    T.configure("on")
    runs, launches = {}, {}
    keep = {}
    try:
        with warnings.catch_warnings(), \
                env_vars(QT_AOT_CACHE_MAX_BYTES=AOT_SERVE_CAP):
            warnings.simplefilter("ignore")
            for arm, pool in (("pool_off", False), ("pool_on", True)):
                drop_plan_caches(fusion, kernels)
                A.reset_stats()
                fused.reset_launch_counts()
                with env_vars(QT_AOT_CACHE=os.path.join(tmp, f"aot_{arm}")):
                    got, rec = serve_trace(
                        torch, qt, S, fusion, env, jobs, burst,
                        preempt="checkpoint",
                        ckpt=os.path.join(tmp, f"serve_{arm}"),
                        prewarm=pool, keep=keep if pool else None)
                    rec["tiers"] = aot_record(A, T, fused)
                launches[arm] = bank_launches(fused)
                digests = [amps_sha256(j.amps) for j in got]
                check(all(j.state == S.DONE for j in got),
                      f"(b) {arm}: a served job did not complete")
                check(digests == served["uninterrupted_sha256"],
                      f"(b) {arm}: served jobs differ from their run under "
                      "preempt='off'")
                rec["jobs_equal_uninterrupted"] = True
                runs[arm] = rec
                del got
                progress(f"aot_main (b) {arm}: {rec}")
            drop_plan_caches(fusion, kernels)
            sync()
            torch.cuda.empty_cache()
            ws = os.path.join(tmp, "warmset.pkl")
            with open(ws, "wb") as f:
                pickle.dump(keep["warmset"], f)
            replica = run_child(
                f"import chip_smoke as cs; cs.aot_replica_child({ws!r})",
                os.path.join(tmp, "aot_pool_on"))
        check(replica["done"] and replica["sha256"]
              == served["uninterrupted_sha256"],
              "(b) the replica's jobs differ from their run under "
              "preempt='off'")
        check(replica["plan_spans"] == 0
              and replica["tiers"]["aot"]["puts"] == 0,
              f"(b) the replica planned: {replica['tiers']}")
        launches["replica"] = replica.pop("launches")
        for arm, lc in launches.items():
            check(lc["K1_bank"] > 0, f"(b) {arm}: K1's bank form never "
                  f"launched: {lc}")
        out["b"] = {"runs": runs, "replica": replica, "launches": launches,
                    "cap_bytes": AOT_SERVE_CAP,
                    "pr16_plan_s": 4.59}
        progress(f"aot_main (b) replica: {replica}")

        # (c) explain's prediction against the drain's counters, and (d)
        # a truncated entry
        cache_c = os.path.join(tmp, "aot_c")
        us = circuits.bench_unitaries(N_MAIN, DEPTH, seed=SEED)
        keep_c = {}
        with env_vars(QT_AOT_CACHE=cache_c):
            drop_plan_caches(fusion, kernels)
            A.reset_stats()
            fused.reset_launch_counts()
            c = explain_steps(torch, qt, A, fusion, kernels, us, N_MAIN,
                              env, keep_c)
            check([s["predicted"] for s in c["steps"]]
                  == ["miss", "memory", "hit"] and c["drift"] == 0
                  and c["model_drift_total"] == 0,
                  f"(c) explain's predictions against the counters: {c}")
            c["launches"] = window_launches(fused)
            out["c"] = c
            entries = [f for f in os.listdir(cache_c)
                       if f.endswith(".qtplan")]
            check(len(entries) == 1, f"(d) entries {entries}")
            path = os.path.join(cache_c, entries[0])
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
            drop_plan_caches(fusion, kernels)
            base = A.stats()
            fused.reset_launch_counts()
            q = qt.createQureg(N_MAIN, env)
            with qt.gateFusion(q):
                apply_bench_gates(qt, q, us, N_MAIN)
            s = A.stats()
            same = bool(torch.equal(q.amps, keep_c.pop("amps")))
            qt.destroyQureg(q, env)
            d = {"entry_bytes": size, "truncated_to": size // 2,
                 "errors": s["errors"] - base["errors"],
                 "puts": s["puts"] - base["puts"],
                 "hits": s["hits"] - base["hits"],
                 "degradation": "aot_cache_corrupt" in R.degradation_report(),
                 "torch_equal": same, "launches": window_launches(fused)}
            check(d["errors"] == 1 and d["puts"] == 1 and d["hits"] == 0
                  and d["degradation"] and same,
                  f"(d) the truncated entry: {d}")
            R.DEGRADATIONS.pop("aot_cache_corrupt", None)
            out["d"] = d
    finally:
        T.configure(old_mode)
        drop_plan_caches(fusion, kernels)
    return out


# ---------------------------------------------------------------------------
# 49-51. The examples on the port (M17), and K12 and K10 on a bank (R7a, R7b)
# ---------------------------------------------------------------------------

# The port's examples (examples/torch/) at sizes where the card does real
# work: (script, argv, environment, the lines tests/test_examples.py
# checks).  phi = 0.3828125 = 98/256 is exact at 24 counting qubits.
EXAMPLES = (
    ("shot_sampling.py", [], {"QT_SHOT_QUBITS": 26, "QT_SHOT_COUNT": 8},
     ("top-2 mass",)),
    ("phase_estimation.py", ["--fused"],
     {"QPE_QUBITS": 24, "QPE_PHI": "0.3828125"}, ("estimate",
                                                   "|error| = 0.0")),
    ("grovers_search.py", ["--fused"], {"QT_GROVER_QUBITS": 16},
     ("prob of solution",)),
    ("grovers_search.py", [], {"QT_GROVER_QUBITS": 16},
     ("prob of solution",)),
    ("trotter_evolution.py", [], {"QT_EVOLVE_QUBITS": 26,
                                  "QT_EVOLVE_STEPS": 10},
     ("energy drift", "OK")),
    ("bernstein_vazirani.py", [], {}, ("recovered = 17",)),
    ("tutorial_example.py", [], {}, ("Probability amplitude of |111>",)),
    ("vqe_train.py", [], {"QT_VQE_QUBITS": 20}, ("done; final energy",)),
    ("qaoa_maxcut.py", [], {"QT_QAOA_QUBITS": 20}, ("expected cut",)),
)
N_BANK_FORMS_PARITY = 20   # K12 bank's parity state: 3 x 2^20
B_BANK_PARITY = 3
N_R7A = 26                 # randomized compiling, paged: 8 x 2^26
B_R7A = 8
N_R7B = 30                 # the 30-qubit reversal on a bank of 2: 17.2 GB
B_R7B = 2


def all_launches(fused, paulis, bigstate) -> dict:
    """Every kernel wrapper's launch count (the zero ones left out)."""
    return {k: v for d in (fused.LAUNCHES, paulis.LAUNCHES,
                           bigstate.LAUNCHES) for k, v in d.items() if v}


def reset_all(fused, paulis, bigstate) -> None:
    for m in (fused, paulis, bigstate):
        m.reset_launch_counts()


def run_example(torch, script, argv, env):
    """One example run in this process through runpy, with ``argv`` and
    ``env`` set and QT_EXAMPLES_CPU unset (the card), under torch.profiler
    (kernels and copies on the card only); returns (stdout, wall seconds,
    device ms or None when the profiler saw nothing on the card)."""
    import contextlib
    import io
    import runpy

    from torch.profiler import ProfilerActivity, profile

    path = str(Path(__file__).resolve().parent / "examples" / "torch"
               / script)
    buf = io.StringIO()
    argv0 = sys.argv
    sys.argv = [path, *argv]
    try:
        with env_vars(QT_EXAMPLES_CPU=None, **env), \
                contextlib.redirect_stdout(buf):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runpy.run_path(path, run_name="__main__")
                sync()
                wall = time.perf_counter() - t0
    finally:
        sys.argv = argv0
    # the raw trace (prof.events() builds a Python tree of every event:
    # minutes over an example's hundred thousand launches)
    on_card = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    dev = (sum(e.duration_ns() for e in on_card) / 1e6 if on_card
           else None)
    return buf.getvalue(), wall, dev


def printed_numbers(text: str, key: str) -> list:
    """The number after ``key`` on each line of ``text`` holding it."""
    out = []
    for line in text.splitlines():
        if key in line:
            out.append(float(line.split(key)[1].split()[0].strip(",;")))
    return out


def phase_examples_main(torch, np, fused, paulis, bigstate):
    """Each port example of examples/torch/ run once on the card through
    runpy (EXAMPLES), at a full-size register where it has one: the lines
    tests/test_examples.py checks, the examples' own asserts, and sanity
    on the numbers they print; per example the wall seconds, the device
    ms and busy share under torch.profiler, and the kernel launches by
    key."""
    out = {}
    for script, argv, env, lines in EXAMPLES:
        label = script[:-3] + ("_fused" if "--fused" in argv else "")
        reset_all(fused, paulis, bigstate)
        text, wall, dev = run_example(torch, script, argv, env)
        torch.cuda.empty_cache()
        for want in lines:
            check(want in text, f"example {label}: no line with {want!r}")
        rec = {"argv": argv, "env": {k: str(v) for k, v in env.items()},
               "wall_s": wall, "device_ms": dev,
               "device_busy_share": None if dev is None
               else dev / (wall * 1e3),
               "launches": all_launches(fused, paulis, bigstate),
               "last_lines": text.strip().splitlines()[-3:]}
        if script == "grovers_search.py":
            probs = printed_numbers(text, "= ")
            check(probs and probs[-1] >= 0.98, f"example {label}: the "
                  f"search ends at P(solution) {probs[-1:]}")
            rec["final_prob_of_solution"] = probs[-1]
        elif script == "vqe_train.py":
            e = printed_numbers(text, "energy =")
            check(e[-1] < e[0], f"example {label}: energy {e[0]} -> {e[-1]}")
            rec["energy_first_last"] = [e[0], e[-1]]
        elif script == "qaoa_maxcut.py":
            cut = printed_numbers(text, "expected cut =")
            total = printed_numbers(text, "total weight")[0]
            check(cut[-1] > cut[0] and cut[-1] <= total, f"example "
                  f"{label}: cut {cut[0]} -> {cut[-1]} of {total}")
            rec["cut_first_last"] = [cut[0], cut[-1]]
        elif script == "trotter_evolution.py":
            check(rec["launches"].get("K3", 0) > 0
                  and rec["launches"].get("K4", 0) > 0,
                  f"example {label}: K3 or K4 never launched")
        elif script in ("shot_sampling.py", "phase_estimation.py"):
            check(rec["launches"].get("K1", 0) > 0, f"example {label}: its "
                  "gateFusion drains launched no K1")
        out[label] = rec
    return out


def sides_on(torch, np, rng, nb, per, dtype, exact=None):
    """Rank-1 cluster side stacks (A, B) on the card: shared (1, 2, 128,
    128), or per element (B, 1, 2, 128, 128) with the elements in
    ``exact`` 0/1 permutations (TF32 values)."""
    def one(b):
        op = (permutation_pass(rng, 7, "AB") if exact and b in exact
              else random_pass(rng, 7, 1, "AB", False))
        return op[2], op[3]

    pairs = [one(b) for b in range(nb if per else 1)]
    if per:
        a, bm = (np.stack([p[j] for p in pairs]) for j in (0, 1))
    else:
        a, bm = pairs[0]
    return tuple(torch.as_tensor(m, dtype=dtype, device=DEVICE)
                 for m in (a, bm))


def phase_bank_forms_parity(torch, np, fused, bigstate):
    """K12's and K10's bank forms on banks of 3 against their scalar
    launches, element by element, bit for bit, and against their plain
    versions: K12 over PREC_SWAPS at 20 qubits, float32 and float64,
    sides shared and per element (a float32 bank mixing 0/1 and inexact
    sides: two splits in one launch); K10 over SIGMA_PARITY, and a bank
    whose grid exceeds the z limit refused before any launch."""
    n, nb = N_BANK_FORMS_PARITY, B_BANK_PARITY
    rng = np.random.default_rng(8642)
    out = {"n": n, "batch": nb, "k12_cases": [], "k10_cases": [],
           "k12_max_abs_err": 0.0, "k10_max_abs_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        x = random_bank(torch, np, rng, n, nb, dtype)
        tol = tolerance(x[0])
        for per in (False, True):
            exact = {1} if per and dtype == torch.float32 else None
            a, bm = sides_on(torch, np, rng, nb, per, dtype, exact)
            for h, bq, m in PREC_SWAPS:
                fused.reset_launch_counts()
                y = fused.apply_swap_cluster_stack(x, a, bm, num_qubits=n,
                                                   h=h, b=bq, m=m)
                sync()
                check(fused.LAUNCHES["K12_bank"] == 1
                      and fused.LAUNCHES["K12"] == 0,
                      f"K12 bank: launches {fused.LAUNCHES}")
                for b in range(nb):
                    ea, eb = (a[b], bm[b]) if per else (a, bm)
                    ys = fused.apply_swap_cluster_stack(
                        x[b], ea, eb, num_qubits=n, h=h, b=bq, m=m)
                    sync()
                    check(torch.equal(y[b], ys), f"K12 bank {name} "
                          f"per={per} {(h, bq, m)} element {b}: not its "
                          "scalar launch bit for bit")
                    err = float((y[b] - fused.swap_cluster_stack_plain(
                        x[b], ea, eb, num_qubits=n, h=h, b=bq,
                        m=m)).abs().max())
                    check(err <= tol, f"K12 bank {name} element {b}: "
                          f"|err| {err} > {tol}")
                    out["k12_max_abs_err"] = max(out["k12_max_abs_err"], err)
                out["k12_cases"].append([name, per, h, bq, m])
        del x
    for m, g in SIGMA_PARITY:
        x = torch.stack([random_state(torch, m, 1357 + b)
                         for b in range(nb)])
        bigstate.reset_launch_counts()
        y = bigstate.apply_sigma_swap(x.clone(), num_qubits=m, group_bits=g)
        sync()
        check(bigstate.LAUNCHES == {"K10": 0, "K10_bank": 1, "K10_rev": 0,
                                    "K10_rev_bank": 0},
              f"K10 bank: launches {bigstate.LAUNCHES}")
        for b in range(nb):
            ys = bigstate.apply_sigma_swap(x[b].clone(), num_qubits=m,
                                           group_bits=g)
            yp = bigstate.sigma_swap_plain(x[b], num_qubits=m, group_bits=g)
            sync()
            err = float((y[b] - yp).abs().max())
            out["k10_max_abs_err"] = max(out["k10_max_abs_err"], err)
            check(torch.equal(y[b], ys) and torch.equal(y[b], yp),
                  f"K10 bank n={m} g={g} element {b}: not its scalar "
                  f"launch and plain version bit for bit (|err| {err})")
            del ys, yp
        out["k10_cases"].append([m, g])
        del x, y
        torch.cuda.empty_cache()
    # the grid limit: 16 x 2^(20 - 8) = 65536 blocks on z
    big = torch.zeros((16, 2, 1 << 20), device=DEVICE)
    bigstate.reset_launch_counts()
    try:
        bigstate.apply_sigma_swap(big, num_qubits=20, group_bits=2)
        refused = False
    except ValueError:
        refused = True
    check(refused and bigstate.LAUNCHES["K10_bank"] == 0,
          "K10 bank: a grid over the z limit was not refused")
    out["k10_grid_limit_refused"] = [16, 20, 2]
    del big
    return out


def bank_form_timing(torch, bank_call, scalar_call, plain_call, nb,
                     bound, bound_by, library):
    """One bank-form record: the bank launch's ms against B scalar
    launches (CUDA events, median), its plain version's ms, the bound, and
    ``library`` = (ms, form) of one PyTorch call computing the same
    function."""
    ms = time_ms(bank_call, reps=5)
    lib_ms, lib_form = library
    return {"ms": ms, "scalar_x_b_ms": time_ms(scalar_call, reps=5),
            "plain_ms": time_ms(plain_call, reps=3, warmup=1),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_form": lib_form, "ms_over_library_ms": ms / lib_ms,
            "batch": nb, "fraction_of_bound": bound / ms}


def bank_plain_err(y, x, plain_of, label) -> float:
    """The largest |y[b] - plain_of(b)| over a bank's elements, each
    checked against the tolerance on its input x[b]."""
    worst = 0.0
    for b in range(y.shape[0]):
        err = float((y[b] - plain_of(b)).abs().max())
        tol = tolerance(x[b])
        check(err <= tol, f"{label} element {b}: |err| {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_bank_forms_main(torch, np, C, fused, bigstate, circuits):
    """R7a: randomized compiling of config 2 at 26 qubits x 8 under
    QT_PLANNER=paged (each element's paged plan of its own unitaries,
    stacked, through execute_plan on the bank): K11_bank and K12_bank
    launches equal to the plan's fused and swapfused ops, and every
    element torch.equal to its own scalar paged drain.  R7b: execute_plan
    of the 30-qubit bit reversal (circuit.bit_reversal_ops on the card:
    K10's reversal form, in place) on a float32 bank of 2 x 2^30 (17.2
    GB): one K10_rev_bank launch, each element torch.equal to its scalar
    route; then K10's sigma bank form on the same bank.  Each form timed
    against B scalar launches and its plain version."""
    out = {}
    # R7a
    n, nb = N_R7A, B_R7A
    _cus, us = bank_unitaries(np, circuits, n, nb, DEPTH)
    with planner_env("paged"):
        t0 = time.perf_counter()
        plans = [C.plan_circuit(circuits.bench_gate_list(n, DEPTH, u), n,
                                planner="paged") for u in us]
        plan_s = time.perf_counter() - t0
        skeleton, arrays = C.split_plan(plans[0])
        per = [arrays]
        for p in plans[1:]:
            sk, arr = C.split_plan(p)
            check(sk == skeleton, "the paged plans' skeletons differ")
            per.append(arr)
        bplan = C.rebuild_plan(skeleton, [
            np.stack([np.asarray(p[j]) for p in per])
            for j in range(len(per[0]))])
        pst = C.stats(bplan)
        bops = C.plan_to_device(bplan, torch.float32, DEVICE)
        fused.reset_launch_counts()
        bigstate.reset_launch_counts()
        a = torch.zeros((nb, 2, 1 << n), dtype=torch.float32, device=DEVICE)
        a[:, 0, 0] = 1.0
        sync()
        t0 = time.perf_counter()
        a = C.execute_plan(a, bops, n)
        sync()
        wall = time.perf_counter() - t0
        got = {**bank_launches(fused), "K11": fused.LAUNCHES["K11"],
               "K12": fused.LAUNCHES["K12"]}
        check(got["K11_bank"] == pst["fused"]
              and got["K12_bank"] == pst["swapfused"]
              and got["K11"] == got["K12"] == 0 and got["K11_bank"] > 0
              and got["K12_bank"] > 0,
              f"R7a: bank launches {got} != one per pass of {pst}")
        scalar_walls = []
        for b in range(nb):
            sops = C.plan_to_device(plans[b], torch.float32, DEVICE)
            z = torch.zeros((2, 1 << n), dtype=torch.float32, device=DEVICE)
            z[0, 0] = 1.0
            sync()
            t0 = time.perf_counter()
            z = C.execute_plan(z, sops, n)
            sync()
            scalar_walls.append(time.perf_counter() - t0)
            check(torch.equal(z, a[b]), f"R7a element {b}: not its scalar "
                  "paged drain bit for bit")
            del z, sops
        launches_a = {k: got[k] for k in ("K11_bank", "K12_bank")}
        # K12's and K11's bank forms at this bank's shapes: a rank-1
        # swapfused op with the plan's largest m, and a rank-1 fused op
        sw = max((op for op in bops if op[0] == "swapfused"
                  and op[4].shape[1] == 1), key=lambda op: op[3])
        fu = next(op for op in bops if op[0] == "fused"
                  and op[1].shape[1] == 1)
        x = a
        num_amps = 1 << n
        state_bytes = 2 * num_amps * 4
        k12_bound, k12_by = bound_ms(
            [("winfused", 7, sw[4][0], sw[5][0], True, True, None)],
            state_bytes, num_amps, "float32")
        y = fused.apply_swap_cluster_stack(x, sw[4], sw[5], num_qubits=n,
                                           h=sw[1], b=sw[2], m=sw[3])
        k12_lib = library_time(
            y, cluster_library(x, sw[4], sw[5], sw[1:4], bank=True),
            10 * tolerance(x), "R7a K12 bank", plane_axis=1)[:2]
        k12 = bank_form_timing(
            torch,
            lambda: fused.apply_swap_cluster_stack(
                x, sw[4], sw[5], num_qubits=n, h=sw[1], b=sw[2], m=sw[3]),
            lambda: [fused.apply_swap_cluster_stack(
                x[b], sw[4][b], sw[5][b], num_qubits=n, h=sw[1], b=sw[2],
                m=sw[3]) for b in range(nb)],
            lambda: [fused.swap_cluster_stack_plain(
                x[b], sw[4][b], sw[5][b], num_qubits=n, h=sw[1], b=sw[2],
                m=sw[3]) for b in range(nb)],
            nb, nb * k12_bound, k12_by, k12_lib)
        k12["max_abs_err"] = bank_plain_err(
            y, x, lambda b: fused.swap_cluster_stack_plain(
                x[b], sw[4][b], sw[5][b], num_qubits=n, h=sw[1], b=sw[2],
                m=sw[3]), "R7a K12 bank")
        k12["m"] = sw[3]
        k11_bound, k11_by = bound_ms(
            [("winfused", 7, fu[1][0], fu[2][0], True, True, None)],
            state_bytes, num_amps, "float32")
        y = fused.apply_cluster_stack(x, fu[1], fu[2], num_qubits=n)
        k11_lib = library_time(
            y, cluster_library(x, fu[1], fu[2], bank=True),
            10 * tolerance(x), "R7a K11 bank", plane_axis=1)[:2]
        k11 = bank_form_timing(
            torch,
            lambda: fused.apply_cluster_stack(x, fu[1], fu[2], num_qubits=n),
            lambda: [fused.apply_cluster_stack(x[b], fu[1][b], fu[2][b],
                                               num_qubits=n)
                     for b in range(nb)],
            lambda: [fused.cluster_stack_plain(x[b], fu[1][b], fu[2][b],
                                               num_qubits=n)
                     for b in range(nb)],
            nb, nb * k11_bound, k11_by, k11_lib)
        k11["max_abs_err"] = bank_plain_err(
            y, x, lambda b: fused.cluster_stack_plain(
                x[b], fu[1][b], fu[2][b], num_qubits=n), "R7a K11 bank")
        del y, x, a, bops
        torch.cuda.empty_cache()
    out["r7a"] = {"n": n, "batch": nb, "depth": DEPTH,
                  "plan": {k: v for k, v in pst.items() if v},
                  "plan_seconds_all_elements": plan_s,
                  "bank_drain_wall_s": wall,
                  "scalar_drains_wall_s": sum(scalar_walls),
                  "launches": launches_a,
                  "elements_equal_scalar": list(range(nb)),
                  "k12_bank": k12, "k11_bank": k11}

    # R7b
    n, nb = N_R7B, B_R7B
    ops = C.bit_reversal_ops(n, [(0, n)], np.float32, device=DEVICE)
    check(ops == [("sigma_rev", 7)],
          f"R7b: the 30-qubit reversal is not K10's reversal form: {ops}")
    dops = C.plan_to_device(ops, torch.float32, DEVICE)
    bank = torch.empty((nb, 2, 1 << n), dtype=torch.float32, device=DEVICE)
    for b in range(nb):
        bank[b] = random_state(torch, n, 24680 + b)
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    bank = C.execute_plan(bank, dops, n)
    sync()
    wall = time.perf_counter() - t0
    got = {**bank_launches(fused), **bigstate.LAUNCHES}
    check(got["K10_rev_bank"] == 1 and got["K1"] == got["K1_bank"] == 0
          and got["K10"] == got["K10_bank"] == got["K10_rev"] == 0,
          f"R7b: bank launches {got}, the plan holds one reversal")
    for b in range(nb):
        z = C.execute_plan(random_state(torch, n, 24680 + b), dops, n)
        sync()
        check(torch.equal(z, bank[b]), f"R7b element {b}: not its scalar "
              "route bit for bit")
        del z
        torch.cuda.empty_cache()
    g = dops[-1][1]
    num_amps = 1 << n
    # the library yardstick: sigma on the whole bank as one out-of-place
    # permute(...).contiguous() of its (B, 2, G, G, mid, G, G) view (the
    # single register's K10 row takes the same call), held to each
    # element's plain relabel first
    G = 1 << g
    bview = bank.view(nb, 2, G, G, 1 << (n - 4 * g), G, G)

    def k10_library():
        return bview.permute(0, 1, 6, 5, 4, 3, 2).contiguous()

    lib = k10_library().view(bank.shape)
    for b in range(nb):
        check(torch.equal(lib[b], bigstate.sigma_swap_plain(
            bank[b], num_qubits=n, group_bits=g)), f"R7b: the bank's "
              f"permute yardstick is not sigma on element {b}")
    del lib
    torch.cuda.empty_cache()
    k10 = bank_form_timing(
        torch,
        lambda: bigstate.apply_sigma_swap(bank, num_qubits=n, group_bits=g),
        lambda: [bigstate.apply_sigma_swap(bank[b], num_qubits=n,
                                           group_bits=g) for b in range(nb)],
        lambda: bigstate.sigma_swap_plain(bank[0], num_qubits=n,
                                          group_bits=g),
        nb, nb * 2 * 2 * num_amps * 4 / HBM_BYTES_PER_S * 1e3, "bytes",
        (time_ms(k10_library, reps=3, warmup=1),
         "permute(0, 1, 6, 5, 4, 3, 2).contiguous() of the bank's "
         "(B, 2, G, G, mid, G, G) view"))
    # the plain version above is one element's: the bank's is B of them
    k10["plain_ms"] *= nb
    k10["plain_note"] = "B x one element's out-of-place relabel"
    # one bank launch against each element's plain relabel of the same
    # input: a pure permutation, so exactly equal
    plains = [bigstate.sigma_swap_plain(bank[b], num_qubits=n, group_bits=g)
              for b in range(nb)]
    bigstate.apply_sigma_swap(bank, num_qubits=n, group_bits=g)
    sync()
    k10["max_abs_err"] = 0.0
    for b in range(nb):
        err = float((bank[b] - plains[b]).abs().max())
        k10["max_abs_err"] = max(k10["max_abs_err"], err)
        check(torch.equal(bank[b], plains[b]), f"R7b K10 bank element {b}: "
              f"not its plain relabel bit for bit (|err| {err})")
    del plains
    got["K10_bank"] = bigstate.LAUNCHES["K10_bank"]
    out["r7b"] = {"n": n, "batch": nb, "bank_bytes": bank.numel() * 4,
                  "plan": [op[0] for op in ops], "bank_wall_s": wall,
                  "launches": {k: got[k] for k in ("K10_rev_bank",
                                                   "K10_bank")},
                  "elements_equal_scalar": list(range(nb)),
                  "k10_bank": k10}
    del bank, dops
    torch.cuda.empty_cache()
    return out


N_PROBE_PARITY = 20       # each probe's check on the card
P1_PARITY = (20, 26)      # the stream pass's parity sizes (qubits)


def probe_module(probes, name: str):
    """The probe module ``name`` of the package ``probes``."""
    import importlib

    return importlib.import_module(f"{probes.__name__}.{name}")


def phase_probes_parity(torch, np, stream, probes):
    """P1 ``torch.equal`` to its plain version in every (op, R, in place
    or not) case at 2^20 and 2^26 amplitudes; then each probe's check on
    the card at 20 qubits (K1 and K3 against their plain versions at the
    tolerances the probes state, P1 again)."""
    out = {"p1": {}}
    worst = 0.0
    rows_cases = probe_module(probes, "profile_dma").ROWS
    for n in P1_PARITY:
        gen = torch.Generator(device=DEVICE).manual_seed(n)
        x0 = torch.randn((2, 1 << n), generator=gen, device=DEVICE)
        cases = 0
        for op in stream.OPS:
            for rows in rows_cases:
                for inplace in (True, False):
                    x = x0.clone()
                    dst = None if inplace else torch.empty_like(x)
                    y = stream.stream_pass(x, rows=rows, op=op, out=dst)
                    ref = stream.stream_pass_plain(x0.clone(), rows=rows,
                                                   op=op)
                    err = float((y - ref).abs().max())
                    worst = max(worst, err)
                    check(torch.equal(y, ref) and (y is x) == inplace,
                          f"P1 {op} R={rows} in place={inplace} at 2^{n}: "
                          f"not its plain version (|err| {err})")
                    cases += 1
                    del x, y, ref, dst
        out["p1"][f"2^{n}"] = {"cases": cases, "equal": True}
        del x0
        torch.cuda.empty_cache()
    out["p1_max_abs_err"] = worst
    out["checks"] = {}
    for name in probes.PROBES:
        out["checks"][name] = probe_module(probes, name).check(
            DEVICE, N_PROBE_PARITY)
        torch.cuda.empty_cache()
    return out


def phase_probes_main(torch, fused, paulis, bigstate, stream, probes):
    """Each probe's run() on the card, every launch count set to 0 just
    before it and read just after: its kernels must have launched (P1 in
    profile_dma; K1, K11, K12 in kernel_microbench; K1 in
    probe_kernel_variants and profile_rank_kernels; K3 in
    probe_flip_pallas), and as often as the probe's own count of its timed
    launches or more (the extra ones are its checks against the plain
    versions)."""
    want = {"profile_dma": {"P1"}, "kernel_microbench": {"K1", "K11", "K12"},
            "probe_kernel_variants": {"K1"},
            "profile_rank_kernels": {"K1"}, "probe_flip_pallas": {"K3"}}
    out = {}
    for name in probes.PROBES:
        reset_all(fused, paulis, bigstate)
        stream.reset_launch_counts()
        t0 = time.perf_counter()
        res = probe_module(probes, name).run(DEVICE)
        sync()
        res["seconds"] = time.perf_counter() - t0
        counted = {**all_launches(fused, paulis, bigstate),
                   **{k: v for k, v in stream.LAUNCHES.items() if v}}
        own = res["launches"]
        check(set(own) == want[name], f"{name}: launches of {set(own)}")
        for key, n in own.items():
            check(0 < n <= counted.get(key, 0), f"{name}: {key} counted "
                  f"{counted.get(key, 0)} launches, the probe {n}")
        res["counted_launches"] = counted
        out[name] = res
        torch.cuda.empty_cache()
    return out


def probe_entries(pparity, pmain) -> list:
    """The kernels line's P1-P8 entries: P1 the stream pass, P2-P8 the
    probes whose counterparts are K1 and K3, each with its launches in
    probes_main and its times there."""
    def entry(label, name, source, replaces, head, launched, err, **extra):
        return {"name": f"{label} {name}", "route": "cuda",
                "source": f"quest_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "max_err": err, "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], **extra}

    checks = pparity["checks"]
    dma, mb = pmain["profile_dma"], pmain["kernel_microbench"]
    kv, rk = pmain["probe_kernel_variants"], pmain["profile_rank_kernels"]
    fl = pmain["probe_flip_pallas"]
    out = [entry(
        "P1", "HBM stream pass", "probes.cu",
        "scripts/probes/profile_dma.py:52", dma["headline"],
        dma["launches"]["P1"], max(pparity["p1_max_abs_err"],
                             dma["headline"]["max_abs_err"]),
        kernel="stream_pass_kernel", case="x2 at R = 8, in place, 2^26",
        library_form=dma["headline"]["library_form"],
        ms_by_rows_copy_in_place=dma["ms_by_rows_copy_in_place"],
        copy_out_of_place_r8=dma["cases"]["stream copy R=8 out of place"],
        yardstick_mul_flat_ms=dma["cases"]["torch mul_(0.5) flat"]["ms"])]
    out.append(entry(
        "P2", "offset-window cluster pass (K1 at offset k)", "window.cu",
        "scripts/probes/kernel_microbench.py:104", mb["headline"],
        mb["launches"]["K1"],
        max(checks["kernel_microbench"]["max_abs_err"],
            mb["headline"]["max_abs_err"]),
        kernel="window_pass_kernel", counterpart="K1",
        case=mb["headline"]["case"],
        library_form=mb["headline"]["library_form"],
        ms_by_case={k: c["ms"] for k, c in mb["cases"].items()}))
    out.append(entry(
        "P3", "separate-channel window pass (K1 given A^T)", "window.cu",
        "scripts/probes/probe_kernel_variants.py:93", kv["headline"],
        kv["launches"]["K1"],
        max(checks["probe_kernel_variants"]["max_abs_err"],
            kv["headline"]["max_abs_err"]),
        kernel="window_pass_kernel", counterpart="K1",
        case=kv["headline"]["case"],
        library_form=kv["headline"]["library_form"],
        ms_by_case={k: c["ms"] for k, c in kv["cases"].items()},
        lane_side=kv["lane_side"]))
    # the four sites are two functions: v1 and v3 the "bf16_3x" pass, v2
    # and v4 the "highest" one, so two sites share each timed run
    sites = {"v1": ("P4", 106), "v2": ("P5", 156), "v3": ("P6", 206),
             "v4": ("P7", 333)}
    first = {}
    for v, (label, line) in sites.items():
        prec = rk["variant_precision"][v]
        head = rk["headline"][prec]
        extra = ({"accuracy_vs_highest": rk["accuracy"]["bf16_3x_vs_highest"]}
                 if prec == "bf16_3x" else {})
        if prec in first:
            extra["same_run_as"] = first[prec]
        first.setdefault(prec, label)
        out.append(entry(
            label, f"rank-R cluster pass {v} (K1 at k = 7, {prec})",
            "window.cu", f"scripts/probes/profile_rank_kernels.py:{line}",
            head, rk["launches_by_precision"][prec],
            max(head["max_abs_err"],
                *(e for c, e in checks["profile_rank_kernels"][
                    "max_abs_err_by_case"].items() if c.startswith(prec))),
            kernel="window_pass_kernel", counterpart="K1",
            case=head["case"], library_form=head["library_form"],
            ms_by_rank={r: rk["cases"][f"{prec} rank{r}"]["ms"]
                        for r in (1, 2, 4)}, **extra))
    out.append(entry(
        "P8", "direct Pauli rotation program (K3)", "paulis.cu",
        "scripts/probes/probe_flip_pallas.py:109", fl["headline"],
        fl["launches"]["K3"],
        max(checks["probe_flip_pallas"]["max_abs_err"],
            fl["headline"]["max_abs_err"]),
        kernel="pauli_rotation_kernel", counterpart="K3",
        case=fl["headline"]["case"], per_16_terms_s={
            "k3": fl["k3"], "take_take": fl["take_take"]},
        library_note="none: no single PyTorch call applies a Pauli-string "
                     "rotation"))
    for e in out:
        check(e["launches"] > 0, f"{e['name']} never launched in "
              "probes_main")
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
        from quest_tpu_torch.models import circuits, hamiltonians, noise
        from quest_tpu_torch import batch
        from quest_tpu_torch.ops import (bigstate, build, calculations, cplx,
                                         density, fused, kernels,
                                         measurement, paulis, stream,
                                         threefry)
        from quest_tpu_torch import probes
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

    def time_k1(op, dtype_name):
        b_ms, b_by = bound_ms([op], x.numel() * x.element_size(), num_amps,
                              dtype_name)
        # the kernel against its plain version at the main path's shape
        y = k1(op)()
        err = float((y - plain1(op)()).abs().max())
        check(err <= tolerance(x), f"K1 at {n} qubits, {dtype_name}, "
              f"k={op[1]}: |err| {err}")
        lib_ms, lib_form, lib_forms = library_time(
            y, window_library(x, op[2], op[3], op[6], num_qubits=n,
                              k=op[1], apply_a=op[4]),
            tolerance(x), f"K1 {dtype_name}")
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
    for key in ("K8", "K9", "K10_rev"):
        check(qft_counts[key] > 0, f"{key} never launched on the QFT path")
        launches[key] = qft_counts[key]
    launches["K10"] = qft_counts["K10"]
    for key in ("K6", "K7"):
        check(rho_counts[key] > 0, f"{key} never launched on the density "
              "QFT path")
        launches[key] = rho_counts[key]

    # 11. QFT timing at 30 qubits
    qtiming = phase_qft_timing(torch, np, qt, C, fused, bigstate)
    emit({"phase": "qft_timing", "power": smi, **qtiming})

    # 11b. K10's reversal form against the old route's plan, bit for bit,
    # and its time beside its bound
    qrev = phase_qft_reversal(torch, np, qt, C, fused, bigstate)
    emit({"phase": "qft_reversal", "power": smi, **qrev})

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

    # 28. the exchange primitives and one shard's K1 and K2 at nloc = 23
    dparity = phase_dist_parity(torch, np, qt, C, fused, fusion, circuits,
                                kernels)
    emit({"phase": "dist_parity", **dparity})

    # 29. config 2 at 26 qubits on 2 and 8 shards of the card, and config
    # 4's noise layer on 4: K1, K2 and K5 launched on every shard
    dmain, dcounts = phase_dist_main(torch, np, qt, C, fused, fusion,
                                     circuits, noise, us, p_bench,
                                     psi_windowed)
    del psi_windowed
    emit({"phase": "dist_main", **dmain})

    # 30. walls at R = 1, 2, 8, kernels against exchange copies, and a
    # 30-qubit circuit on 8 shards
    dtiming = phase_dist_timing(torch, np, qt, C, fused, fusion, circuits,
                                us, kernels)
    emit({"phase": "dist_timing", "power": smi, **dtiming})
    if torch.cuda.device_count() >= 2:
        emit({"phase": "dist_nccl", **phase_dist_nccl(torch, np, qt,
                                                       circuits)})
    else:
        # nothing was tried: two NCCL ranks on one card are refused
        print("dist_nccl: not run (nor its checkpoint on the ranks): NCCL "
              "needs one card per rank, and "
              f"{torch.cuda.device_count()} card is visible", flush=True)

    # 32. K6-K9 on every shard of the sharded QFT routes, bit for bit
    compparity = phase_dist_composites_parity(torch, np, qt, fused)
    emit({"phase": "dist_composites_parity", **compparity})

    # 33. the sharded composites at full width against one register
    cmain, ccounts = phase_dist_composites_main(
        torch, np, qt, C, fused, paulis, hamiltonians, circuits, api_ops)
    emit({"phase": "dist_composites_main", **cmain})
    for key in QFT_KERNELS:
        check(ccounts[key] > 0, f"{key} never launched on the sharded "
              "composites' path")

    # 34. the sharded routes' walls and device ms by part
    ctiming = phase_dist_composites_timing(torch, qt, fused, hamiltonians)
    emit({"phase": "dist_composites_timing", "power": smi, **ctiming})

    # 35. K1, K2 and K5's bank forms on one shard's bank at nloc = 23
    dbparity = phase_dist_batch_parity(torch, np, qt, fused, fusion, noise)
    emit({"phase": "dist_batch_parity", **dbparity})

    # 36. randomized compiling of config 2 as a bank on 2 and 8 shards, a
    # density bank on 4 and an ensemble bucket on 2: K1, K2 and K5's bank
    # forms launched on every shard
    dbmain, dbcounts = phase_dist_batch_main(
        torch, np, qt, C, fused, fusion, circuits, noise, hamiltonians,
        kernels, batch, bmain["randomized_compiling"])
    emit({"phase": "dist_batch_main", "power": smi, **dbmain})

    # 37. quad precision on 8 (and 4) shards
    dquad = phase_dist_quad_main(torch, np, qt, circuits, hamiltonians)
    emit({"phase": "dist_quad_main", "power": smi, **dquad})

    # 38. VQE and QAOA on 8 shards
    dmodels = phase_dist_models_main(torch, np)
    emit({"phase": "dist_models_main", "power": smi, **dmodels})

    # 39-41. telemetry and resumable runs, checkpoints in a temporary
    # directory removed on exit
    import tempfile

    from quest_tpu_torch import optimizer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tele = phase_telemetry_main(torch, np, qt, C, fused, fusion,
                                    optimizer, us, gates, tmp)
        emit({"phase": "telemetry_main", "power": smi, **tele})
        res = phase_resilience_main(torch, np, qt, C, fused, fusion,
                                    optimizer, us, gates, tmp)
        emit({"phase": "resilience_main", "power": smi, **res})
        dres = phase_dist_resilience_main(torch, np, qt, C, fused, fusion,
                                          us, gates, tmp)
        emit({"phase": "dist_resilience_main", "power": smi, **dres})

    # 42-43. the memory governor and the plan explainer
    gov = phase_governor_main(torch, np, qt, C, fused, fusion, circuits,
                              noise)
    emit({"phase": "governor_main", "power": smi, **gov})
    intro = phase_introspect_main(torch, np, qt, C, fused, fusion, circuits)
    emit({"phase": "introspect_main", "power": smi, **intro})

    # 44-47. the serving layer (checkpoints in a temporary directory
    # removed on exit) and F2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        serve = phase_serve_main(torch, np, qt, fused, fusion, circuits,
                                 kernels, tmp)
        emit({"phase": "serve_main", "power": smi, **serve})
        chaos = phase_serve_chaos(torch, np, qt, fused, circuits, tmp)
        emit({"phase": "serve_chaos", "power": smi, **chaos})
    ab = phase_serve_ab(torch, np, qt, C, batch)
    emit({"phase": "serve_ab", "power": smi, **ab})
    f2 = phase_f2_main(torch, np, qt, fused, fusion, circuits, kernels)
    emit({"phase": "f2_main", "power": smi, **f2})

    # 48. the persistent plan cache and the warm pool (M16f), caches and
    # checkpoints in a temporary directory removed on exit
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aot_") as tmp:
        t_aot = time.perf_counter()
        aot = phase_aot_main(torch, np, qt, fused, fusion, circuits,
                             kernels, tmp, serve)
        aot["seconds"] = time.perf_counter() - t_aot
    emit({"phase": "aot_main", "power": smi, **aot})

    # 49. the port's examples (examples/torch/) on the card
    t_ex = time.perf_counter()
    examples = phase_examples_main(torch, np, fused, paulis, bigstate)
    emit({"phase": "examples_main", "power": smi, "examples": examples,
          "seconds": time.perf_counter() - t_ex})

    # 50. K12's and K10's bank forms against their scalar launches
    bfparity = phase_bank_forms_parity(torch, np, fused, bigstate)
    emit({"phase": "bank_forms_parity", **bfparity})

    # 51. K11 and K12 on a paged randomized-compiling bank (R7a), K1 and
    # K10 on the 30-qubit reversal of a bank of 2 (R7b)
    t_bf = time.perf_counter()
    bforms = phase_bank_forms_main(torch, np, C, fused, bigstate, circuits)
    emit({"phase": "bank_forms_main", "power": smi, **bforms,
          "seconds": time.perf_counter() - t_bf})
    r7a, r7b = bforms["r7a"], bforms["r7b"]
    launches.update(K11_bank=r7a["launches"]["K11_bank"],
                    K12_bank=r7a["launches"]["K12_bank"],
                    K10_bank=r7b["launches"]["K10_bank"])

    # 52. the stream pass (P1) against its plain version, each probe's
    # check on the card
    t_pp = time.perf_counter()
    pparity_probes = phase_probes_parity(torch, np, stream, probes)
    emit({"phase": "probes_parity", **pparity_probes,
          "seconds": time.perf_counter() - t_pp})

    # 53. the five probes' timings on the card (P1-P8)
    t_pm = time.perf_counter()
    pmain_probes = phase_probes_main(torch, fused, paulis, bigstate, stream,
                                     probes)
    emit({"phase": "probes_main", "power": smi, **pmain_probes,
          "seconds": time.perf_counter() - t_pm})

    # 54. kernels
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
    k10r = entry("K10 reversal form", "none: the reference reverses by "
                 "window passes and sigma (quest_tpu/circuit.py "
                 "_bit_reversal_big)", qrev["k10_rev"], qerr, "qft.cu",
                 key="K10_rev")
    k10r["kernel"] = "sigma_swap_kernel"
    k10r["library_form"] = qrev["k10_rev"]["library_form"]
    k10r["old_plan_ms"] = qrev["k10_rev"]["old_plan_ms"]
    k10r["old_plan_note"] = ("the reference's in-place plan it replaces: "
                             "four K1 passes and sigma")
    k6e["kernel"] = k8e["kernel"] = "qft_hi_kernel"
    k7e["kernel"] = k9e["kernel"] = "qft_sublane_kernel"
    k10e["kernel"] = "sigma_swap_kernel"
    # sigma runs on no main path since the reversal form (its launches
    # above: 0, the QFT's); counted apart, each from 0: one in the old
    # route's plan at 30 qubits, one per parity case
    k10e["old_plan_launches"] = (
        qrev["old_route"][N_QFT]["old_plan_launches"]["K10"])
    k10e["parity_launches"] = qparity["k10_launches"]
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
    # K11's, K12's and K10's bank forms: their launches and times on the
    # paged randomized-compiling bank and the 30-qubit reversal's bank
    k11b = entry("K11 cluster pass, bank form", "quest_tpu/ops/fused.py:543",
                 r7a["k11_bank"], r7a["k11_bank"]["max_abs_err"],
                 key="K11_bank")
    k11b["kernel"] = "window_pass_kernel"
    k12b = entry("K12 segment swap + cluster pass, bank form",
                 "quest_tpu/ops/fused.py:271", r7a["k12_bank"],
                 max(r7a["k12_bank"]["max_abs_err"],
                     bfparity["k12_max_abs_err"]), key="K12_bank")
    k12b["kernel"] = "swap_cluster_kernel"
    k10b = entry("K10 sigma swap, bank form",
                 "quest_tpu/ops/bigstate.py:108", r7b["k10_bank"],
                 max(r7b["k10_bank"]["max_abs_err"],
                     bfparity["k10_max_abs_err"]), "qft.cu", key="K10_bank")
    k10b["kernel"] = "sigma_swap_kernel"
    for e, rec in ((k11b, r7a["k11_bank"]), (k12b, r7a["k12_bank"]),
                   (k10b, r7b["k10_bank"])):
        e["batch"] = rec["batch"]
        e["scalar_x_b_ms"] = rec["scalar_x_b_ms"]
        e["library_form"] = rec["library_form"]
        e["ms_over_library_ms"] = rec["ms_over_library_ms"]
    for e in (k1b, k2b, k5b, k11b, k12b, k10b):
        check(e["launches"] > 0, f"{e['name']} never launched on its path")
    # the kernels the examples launched on the card, by example
    for e, key in ((k1e, "K1"), (k2e, "K2"), (k3e, "K3"), (k4e, "K4")):
        e["examples"] = {label: rec["launches"][key]
                         for label, rec in examples.items()
                         if rec["launches"].get(key)}
    # K1, K2 and K5 run per shard on the dist phases: each shard of a
    # sharded register launches the same local program
    for e, key in ((k1e, "K1"), (k2e, "K2"), (k5e, "K5")):
        e["dist"] = {"run_per_shard": True, "launches": dcounts[key],
                     "meshes": [*DIST_MESHES, R_DIST_RHO]}
        check(dcounts[key] > 0, f"{key} never launched on the dist path")
    # the bank forms run per shard on a sharded bank (dist_batch_main):
    # one launch per pass, group or sweep on each shard for the whole bank
    for e, key, meshes in (
            (k1b, "K1_bank", [*DIST_BATCH_MESHES, R_DIST_ENSEMBLE]),
            (k2b, "K2_bank", [*DIST_BATCH_MESHES, R_DIST_ENSEMBLE]),
            (k5b, "K5_bank", [R_DIST_BATCH_RHO])):
        e["dist"] = {"run_per_shard": True, "launches": dbcounts[key],
                     "meshes": meshes,
                     "max_abs_err_per_shard": dbparity["max_abs_err"][key],
                     "shard_shape": [B_MAIN, 2, 1 << N_DIST_BATCH_PARITY]}
        check(dbcounts[key] > 0, f"{key} never launched on a sharded bank")
    # K6-K9 run per shard on the sharded QFT routes (dist_composites_main)
    for e, key in ((k6e, "K6"), (k7e, "K7"), (k8e, "K8"), (k9e, "K9")):
        e["dist"] = {"run_per_shard": True, "launches": ccounts[key],
                     "max_abs_err_per_shard":
                         compparity["kernels"][key]["max_abs_err"],
                     "shard_bits": compparity["kernels"][key]["shard_bits"]}
    # K1 and K2 on the resumable path: the telemetry phase's API circuit,
    # the uninterrupted runResumable and the failover run on 8 -> 4 shards
    for e, key in ((k1e, "K1"), (k2e, "K2")):
        e["resumable"] = {"launches_telemetry_api": tele["launches"][key],
                          "launches_run": res["launches"][key],
                          "launches_failover": dres["launches"][key],
                          "launches_4_shards": dres["launches_4_shards"][key]}
    # K1, K2 and K5 under the memory governor: its phase's drains (the
    # spill rung, the OOM net, the model runs, oom@0 on the density layer)
    # and the explained drains on one register and on 8 shards
    for e, key in ((k1e, "K1"), (k2e, "K2"), (k5e, "K5")):
        e["governed"] = {"launches_governor_main": gov["launches"][key],
                         "launches_introspect_main":
                             intro["launches"].get(key, 0)}
        check(sum(e["governed"].values()) > 0,
              f"{key} never launched under the governor")
    # K1's and K2's bank forms on the serving path: the served run at 26
    # qubits on one register env, and the chaos arm per shard of 8 (and 4
    # after the failover); K1 on F2's 32-qubit drain
    for e, key in ((k1b, "K1_bank"), (k2b, "K2_bank")):
        e["serve"] = {"launches_serve_main": serve["launches"][key],
                      "launches_chaos_per_shard": chaos["launches"][key]}
    k1e["f2"] = {"launches": f2.get("launches", {}).get("K1", 0)}
    # K1 and K2 with the persistent plan cache on: (a)'s cold and warm
    # children (equal), (c)'s explained drains and (d)'s re-planned one;
    # their bank forms in (b)'s served runs (the warm pool off and on) and
    # the replica booted from the warm set
    for e, key in ((k1e, "K1"), (k2e, "K2")):
        e["aot"] = {"launches_cold_child": aot["a"]["cold"]["launches"][key],
                    "launches_warm_child": aot["a"]["warm"]["launches"][key],
                    "launches_explained": aot["c"]["launches"][key],
                    "launches_truncated_entry": aot["d"]["launches"][key]}
    for e, key in ((k1b, "K1_bank"), (k2b, "K2_bank")):
        e["aot"] = {f"launches_{arm}": lc[key]
                    for arm, lc in aot["b"]["launches"].items()}
    check(sum(k1e["aot"].values()) > 0 and sum(k1b["aot"].values()) > 0
          and sum(k2e["aot"].values()) + sum(k2b["aot"].values()) > 0,
          "a window kernel never launched on the plan cache's path")
    emit({"kernels": [k1e, k2e, k3e, k4e, k5e, k6e, k7e, k8e, k9e, k10e,
                      k10r, k11e, k12e, k1b, k2b, k5b, k11b, k12b, k10b,
                      *probe_entries(pparity_probes, pmain_probes)]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
