"""Registers split over shards (M15a) in the port against the JAX package
on its mesh.

The port's in-process mesh, ``tq.createQuESTEnv(devices=["cpu"] * R)``
for R = 2, 4 and 8, against the reference's
``qt.createQuESTEnv(num_devices=R)`` on the suite's 8-device CPU mesh,
at float64 (tests/test_distributed.py, test_remap.py and
test_mesh_sweep.py's cases).  Every case requires three things:

* amplitudes within 1e-10 (read in canonical order by both);
* the same exchange accounting: the port's counters
  (``parallel/dist.py``, op families matrix_1q, swap, remap,
  window_remap and gather, per tier, counts and per-shard bytes) equal
  to the reference's telemetry for the same calls, and the same eager
  dispatch routes;
* for drains, every sharded program the drains plan identical to the
  reference's ``_split_items_sharded``: skeleton, sigmas and final
  permutation (both packages' planners recorded during the run).

The reference's sharded path runs at 6 state-vector and 4 density
qubits (8 state bits), each circuit once per R in a module-scoped memo.
Also: lazy against eager relocation bit for bit, the fused drain
against the eager route, reads that restore canonical order mid-circuit
and inside a fusion context, the exchange guard, a one-shard env
behaving as a plain one,
the interop of a permuted register, and two spawned gloo runs of the
torch.distributed backend held bit for bit against the in-process mesh.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

import oracle
import quest_tpu as qt
import quest_tpu.circuit as RC
from quest_tpu import fusion as RF
from quest_tpu import telemetry as RTEL
from quest_tpu.parallel import dist as RD
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import interop, precision
from quest_tpu_torch.parallel import dist as PD
from quest_tpu_torch.parallel import sharded as SH
from quest_tpu_torch.parallel.mesh import ShardedAmps

TOL = 1e-10
NS = 6          # state-vector qubits: nloc = 3 at R = 8
ND = 4          # density qubits: 8 state bits, nloc = 5 at R = 8
MESHES = (2, 4, 8)
REF_OPS = ("matrix_1q", "swap", "remap", "window_remap", "gather")
ROUTES = ("perm_local", "exchange_1q", "relocalize", "default")


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    PD.use_lazy_remap(True)
    PD.use_explicit_dist(True)
    yield
    tq.set_precision(old)
    PD.use_lazy_remap(True)
    PD.use_explicit_dist(True)


@pytest.fixture(scope="module")
def telemetry_on():
    old = RTEL.mode_name()
    RTEL.configure("on")
    yield
    RTEL.configure(old)


def _require_ref_mesh():
    if qt.createQuESTEnv().num_devices < 8:
        pytest.skip("needs the suite's 8-device CPU mesh")


# ---------------------------------------------------------------------------
# Running one circuit through both packages
# ---------------------------------------------------------------------------


def _ref_counts():
    out = {}
    for name in ("exchanges_total", "exchange_bytes_total"):
        for op in REF_OPS:
            for tier in ("ici", "dcn"):
                v = RTEL.counter_sum(name, op=op, tier=tier)
                if v:
                    out[(name, op, tier)] = int(v)
    for route in ROUTES:
        v = RTEL.counter_sum("dispatch_route_total", route=route)
        if v:
            out[("route", route)] = int(v)
    return out


def _port_counts():
    out = {}
    for name in ("exchanges_total", "exchange_bytes_total"):
        for op in REF_OPS:
            for tier in ("ici", "dcn"):
                v = PD.counter_sum(name, op=op, tier=tier)
                if v:
                    out[(name, op, tier)] = int(v)
    for route in ROUTES:
        v = PD.counter_sum("dispatch_route_total", route=route)
        if v:
            out[("route", route)] = int(v)
    return out


def _initial(n, density, seed):
    rng = np.random.default_rng(seed)
    if density:
        rho = oracle.random_density(n, rng)
        flat = rho.T.reshape(-1)
    else:
        flat = oracle.random_state(n, rng)
    return np.stack([flat.real, flat.imag])


def _make(mod, env, n, density, init):
    q = (mod.createDensityQureg if density else mod.createQureg)(n, env)
    if density:
        mod.setDensityAmps(q, init[0], init[1])
    else:
        mod.initStateFromAmps(q, init[0], init[1])
    return q


def _run_one(mod, env, circuit, n, density, fuse, init):
    """Run ``circuit`` on a fresh register of ``mod``: (canonical amps,
    reads, counts before the final reads, counts after, the sharded drain
    programs planned on the way as (skeleton, final_perm) pairs)."""
    q = _make(mod, env, n, density, init)
    if mod is qt:
        RTEL.reset()
    else:
        PD.reset_counters()
    reads = []
    fmod = RF if mod is qt else PF
    planned = []
    split = fmod._split_items_sharded

    def recording(*args, **kwargs):
        out = split(*args, **kwargs)
        planned.append((_skeleton(out[0]), out[-1]))
        return out

    fmod._plan_cache.clear()
    fmod._split_items_sharded = recording
    try:
        if fuse:
            with mod.gateFusion(q):
                circuit(mod, q, reads)
        else:
            circuit(mod, q, reads)
    finally:
        fmod._split_items_sharded = split
    counts_before_read = _ref_counts() if mod is qt else _port_counts()
    reads.append(mod.calcTotalProb(q))
    reads.append(mod.calcProbOfOutcome(q, n - 1, 0))
    reads.extend(mod.calcProbOfAllOutcomes(q, [0, n - 1, 1]).tolist())
    if mod is qt:
        amps = np.asarray(q.amps)
        counts = _ref_counts()
    else:
        amps, perm = interop.register_state(q, canonical=True)
        assert perm is None
        counts = _port_counts()
    return amps, np.asarray(reads), counts_before_read, counts, planned


class _Memo:
    """The reference's results, computed once per (circuit, R) for the
    module."""

    def __init__(self):
        self.cache = {}

    def __call__(self, name, circuit, n, density, fuse, R, seed=5):
        key = (name, n, density, fuse, R, seed)
        if key not in self.cache:
            env = qt.createQuESTEnv(num_devices=R)
            init = _initial(n, density, seed)
            self.cache[key] = _run_one(qt, env, circuit, n, density, fuse,
                                       init)
        return self.cache[key]


@pytest.fixture(scope="module")
def ref(telemetry_on):
    _require_ref_mesh()
    return _Memo()


def check_against_ref(ref, name, circuit, n, density, fuse, R, seed=5):
    want = ref(name, circuit, n, density, fuse, R, seed)
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    got = _run_one(tq, env, circuit, n, density, fuse,
                   _initial(n, density, seed))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[4] == want[4]
    if fuse:
        assert got[4], "the circuit drained no sharded program"
    return got


# ---------------------------------------------------------------------------
# Circuits (the reference tests' shapes)
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(21)
U1 = oracle.random_unitary(1, _RNG)
U2 = oracle.random_unitary(2, _RNG)
U3 = oracle.random_unitary(3, _RNG)
KRAUS = oracle.random_kraus_map(1, 3, _RNG)
KRAUS2 = oracle.random_kraus_map(2, 2, _RNG)


def _hadamard_on(t):
    def circ(mod, q, reads):
        mod.hadamard(q, t)
    return circ


def _controlled(c, t):
    def circ(mod, q, reads):
        mod.controlledUnitary(q, c, t, U1)
    return circ


def _relocation(mod, q, reads):
    n = q.num_qubits_represented
    for _ in range(3):
        mod.multiQubitUnitary(q, [n - 2, n - 1], U2)
    mod.multiQubitUnitary(q, [n - 3, n - 1], U2)


def _mixed(mod, q, reads):
    """Local and sharded targets interleaved (test_remap.py's circuit)
    with diagonal gates, NOTs, SWAPs and controls on every side."""
    n = q.num_qubits_represented
    mod.hadamard(q, 0)
    mod.multiQubitUnitary(q, [n - 2, n - 1], U2)
    mod.unitary(q, n - 3, U1)
    mod.hadamard(q, 1)
    mod.multiQubitUnitary(q, [n - 2, n - 1], U2)
    mod.controlledUnitary(q, 0, n - 2, U1)
    mod.multiQubitUnitary(q, [n - 3, n - 2], U2)
    mod.pauliX(q, n - 1)
    mod.tGate(q, n - 2)
    mod.swapGate(q, 0, n - 1)
    mod.controlledNot(q, n - 1, 1)
    mod.controlledPhaseShift(q, n - 1, 2, 0.7)
    mod.multiControlledMultiQubitNot(q, [1], [n - 1, 0])
    mod.rotateZ(q, n - 1, 0.4)
    mod.multiStateControlledUnitary(q, [n - 1, 0], [0, 1], 2, U1)
    mod.multiQubitUnitary(q, [0, n - 1, 2], U3)
    mod.sqrtSwapGate(q, 1, n - 2)


def _config2_like(mod, q, reads):
    """A config-2 layer pattern: rotations on every qubit and a CNOT
    ladder, twice."""
    n = q.num_qubits_represented
    for d in range(2):
        for t in range(n):
            mod.rotateY(q, t, 0.3 + 0.1 * t + d)
            mod.rotateZ(q, t, 0.2 * t - d)
        for t in range(d % 2, n - 1, 2):
            mod.controlledNot(q, t, t + 1)


def _noise(mod, q, reads):
    """Unitaries and the pair channels (captured as channel items) on a
    density register."""
    n = q.num_qubits_represented
    for t in range(n):
        mod.hadamard(q, t)
    mod.mixDepolarising(q, n - 1, 0.1)
    mod.controlledNot(q, 0, n - 1)
    mod.mixDamping(q, 0, 0.2)
    mod.multiQubitUnitary(q, [1, n - 1], U2)
    mod.mixDepolarising(q, 2, 0.03)
    mod.mixDamping(q, n - 1, 0.1)


def _noise_kraus(mod, q, reads):
    """Kraus maps captured as superoperators among the gates."""
    n = q.num_qubits_represented
    for t in range(n):
        mod.hadamard(q, t)
    mod.mixKrausMap(q, n - 1, KRAUS)
    mod.mixDephasing(q, 1, 0.05)
    mod.multiQubitUnitary(q, [1, n - 1], U2)
    mod.mixTwoQubitKrausMap(q, 0, n - 1, KRAUS2)
    mod.mixDepolarising(q, 2, 0.03)


def _eager_kraus(mod, q, reads):
    n = q.num_qubits_represented
    mod.hadamard(q, n - 1)
    mod.mixKrausMap(q, n - 1, KRAUS)
    mod.mixTwoQubitKrausMap(q, 0, n - 1, KRAUS2)
    mod.mixKrausMap(q, 0, KRAUS)


def _mid_reads(mod, q, reads):
    n = q.num_qubits_represented
    mod.multiQubitUnitary(q, [n - 2, n - 1], U2)
    reads.append(mod.calcProbOfOutcome(q, n - 1, 1))
    reads.append(mod.getRealAmp(q, 5))
    mod.swapGate(q, 0, n - 1)
    reads.append(mod.getImagAmp(q, (1 << n) - 3))
    mod.multiQubitUnitary(q, [n - 3, 0], U2)
    reads.append(mod.calcTotalProb(q))


def _fused_reads(mod, q, reads):
    """Reads inside a fusion context drain and restore canonical order,
    and the next gates start from the live permutation."""
    n = q.num_qubits_represented
    with mod.gateFusion(q):
        for t in range(n):
            mod.hadamard(q, t)
        mod.multiQubitUnitary(q, [n - 1, 0], U2)
        reads.append(mod.getRealAmp(q, 3))
        mod.controlledNot(q, n - 1, n - 2)
        mod.multiQubitUnitary(q, [n - 2, 1], U2)
        reads.append(mod.calcProbOfOutcome(q, n - 2, 0))
        mod.swapGate(q, 1, n - 1)
        mod.rotateX(q, n - 1, 0.3)


def _density_reads(mod, q, reads):
    n = q.num_qubits_represented
    mod.multiQubitUnitary(q, [n - 1, 0], U2)
    reads.append(complex(mod.getDensityAmp(q, 3, 5)).real)
    reads.append(mod.calcProbOfOutcome(q, 0, 1))


# ---------------------------------------------------------------------------
# The register's layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", MESHES)
def test_layout(R):
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    q = tq.createQureg(NS, env)
    tq.initDebugState(q)
    assert q.is_sharded and q.shard_bits == R.bit_length() - 1
    assert q.num_chunks == R and q.num_amps_per_chunk == (1 << NS) // R
    amps = q.amps
    assert isinstance(amps, ShardedAmps) and len(amps.shards) == R
    # shard s holds global indices [s m, (s + 1) m) of the one-device state
    one = tq.createQureg(NS, tq.createQuESTEnv(device="cpu"))
    tq.initDebugState(one)
    want = one.amps
    m = (1 << NS) // R
    for s, sh in enumerate(amps.shards):
        assert sh.shape == (2, m) and sh.device.type == "cpu"
        assert torch.equal(sh, want[:, s * m:(s + 1) * m])
    # a register smaller than the mesh is replicated: one whole tensor
    with pytest.warns(UserWarning, match="Too few qubits"):
        small = tq.createQureg(1, tq.createQuESTEnv(devices=["cpu"] * 4))
    assert not small.is_sharded and torch.is_tensor(small.amps)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("kind", ["zero", "plus", "classical", "debug",
                                  "blank", "sparse", "setamps", "pure"])
def test_init_family_on_a_mesh(R, kind):
    """Every initialisation writes shard by shard the state the one-device
    register holds, bit for bit, for state vectors and density
    matrices."""
    for density in (False, True):
        n = ND if density else NS
        regs = []
        for env in (tq.createQuESTEnv(device="cpu"),
                    tq.createQuESTEnv(devices=["cpu"] * R)):
            make = tq.createDensityQureg if density else tq.createQureg
            q = make(n, env)
            if kind == "plus":
                tq.initPlusState(q)
            elif kind == "classical":
                tq.initClassicalState(q, 5)
            elif kind == "debug":
                tq.initDebugState(q)
            elif kind == "blank":
                tq.initBlankState(q)
            elif kind == "sparse" and not density:
                tq.initSparseState(q, [1, 40, 63], [0.6, 0.8j, 0])
            elif kind == "setamps" and not density:
                tq.initDebugState(q)
                tq.setAmps(q, 5, np.arange(30) / 10, -np.arange(30) / 7, 30)
            elif kind == "pure":
                psi = tq.createQureg(n, env)
                tq.initStateFromAmps(psi, *_initial(n, False, 3))
                tq.initPureState(q, psi)
            regs.append(q)
        a, _ = interop.register_state(regs[0], canonical=True)
        b, _ = interop.register_state(regs[1], canonical=True)
        assert regs[1].is_sharded
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Eager routes, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("target", range(NS))
def test_1q_gate_every_target(ref, R, target):
    got = check_against_ref(ref, f"h{target}", _hadamard_on(target), NS,
                            False, False, R)
    nloc = NS - (R.bit_length() - 1)
    route = "exchange_1q" if target >= nloc else "perm_local"
    assert got[2][("route", route)] == 1


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("ctrl,target", [(0, 4), (0, 5), (3, 4), (3, 5),
                                         (5, 4)])
def test_controlled_gate_sharded_target(ref, R, ctrl, target):
    check_against_ref(ref, f"cu{ctrl}{target}", _controlled(ctrl, target),
                      NS, False, False, R)


@pytest.mark.parametrize("R", MESHES)
def test_relocalization_keeps_the_permutation(ref, R):
    got = check_against_ref(ref, "reloc", _relocation, NS, False, False, R)
    if R > 2:
        assert got[2].get(("route", "relocalize"), 0) >= 1


def test_exhausted_pool_takes_the_default_route(ref):
    """R = 8 at 4 qubits leaves one local qubit: neither a 3-target nor
    a 2-target gate can relocalize, and both take the default route in
    both packages."""
    def circ(mod, q, reads):
        mod.multiQubitUnitary(q, [1, 2, 3], U3)
        mod.multiQubitUnitary(q, [0, 3], U2)

    got = check_against_ref(ref, "exhausted", circ, 4, False, False, 8)
    assert got[2][("route", "default")] == 2


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("fuse", [False, True])
def test_mixed_circuit(ref, R, density, fuse):
    n = ND if density else NS
    check_against_ref(ref, "mixed", _mixed, n, density, fuse, R)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("fuse", [False, True])
def test_config2_layers(ref, R, fuse):
    check_against_ref(ref, "config2", _config2_like, NS, False, fuse, R)


@pytest.mark.parametrize("R", MESHES)
def test_density_noise_drain(ref, R):
    check_against_ref(ref, "noise", _noise, ND, True, True, R)


@pytest.mark.parametrize("R", MESHES)
def test_density_kraus_drain(ref, R):
    """Captured Kraus maps: the same amplitudes.  The reference's capture
    reads ``qureg.amps`` for the dtype (quest_tpu/api_ops.py:279), which
    drains the buffer and restores canonical order at every Kraus map;
    the port's reads the register's dtype and drains once, so it moves
    at most the reference's bytes."""
    want = ref("kraus_drain", _noise_kraus, ND, True, True, R)
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    got = _run_one(tq, env, _noise_kraus, ND, True, True,
                   _initial(ND, True, 5))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)

    def moved(counts):
        return sum(v for k, v in counts.items()
                   if k[0] == "exchange_bytes_total")

    assert moved(got[3]) <= moved(want[3])


@pytest.mark.parametrize("R", MESHES)
def test_eager_kraus_route(ref, R):
    check_against_ref(ref, "kraus", _eager_kraus, ND, True, False, R)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("name,circuit,density", [
    ("mid", _mid_reads, False), ("fusedreads", _fused_reads, False),
    ("densreads", _density_reads, True)])
def test_reads_restore_canonical_order(ref, R, name, circuit, density):
    check_against_ref(ref, name, circuit, ND if density else NS, density,
                      False, R)


# ---------------------------------------------------------------------------
# The exchange primitives, against the reference's
# ---------------------------------------------------------------------------


def _both_states(R, n=NS, seed=11):
    x = _initial(n, False, seed)
    renv = qt.createQuESTEnv(num_devices=R)
    rq = qt.createQureg(n, renv)
    qt.initStateFromAmps(rq, x[0], x[1])
    penv = tq.createQuESTEnv(devices=["cpu"] * R)
    nloc = n - (R.bit_length() - 1)
    return x, rq, renv, SH.split(penv.mesh, x, nloc, torch.float64)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("lo", [0, 1, 2])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_swap_sharded(ref, R, lo, chunks):
    x, rq, renv, pamps = _both_states(R)
    hi = NS - 1
    RTEL.reset()
    PD.reset_counters()
    want = np.asarray(RD.swap_sharded(rq.amps, mesh=renv.mesh, num_qubits=NS,
                                      qb_low=lo, qb_high=hi, chunks=chunks))
    got = SH.gather_host(PD.swap_sharded(pamps, num_qubits=NS, qb_low=lo,
                                         qb_high=hi, chunks=chunks))
    np.testing.assert_array_equal(got, want)
    assert _port_counts() == _ref_counts()


@pytest.mark.parametrize("R", MESHES)
def test_total_prob_and_gather(ref, R):
    x, rq, renv, pamps = _both_states(R)
    RTEL.reset()
    PD.reset_counters()
    want = np.asarray(RD.gather_replicated(rq.amps, mesh=renv.mesh))
    got = PD.gather_replicated(pamps).numpy()
    np.testing.assert_array_equal(got, want)
    assert _port_counts() == _ref_counts()
    assert abs(float(PD.total_prob_sharded(pamps))
               - float(RD.total_prob_sharded(rq.amps, mesh=renv.mesh))) \
        <= TOL


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("ctrls", [(), (1,), (4,), (1, 4)])
def test_matrix_1q_sharded_chunked(R, ctrls):
    """The one-qubit exchange gate on the top qubit, with local and (from
    R = 4) sharded controls, gives the same state for any chunk count
    (the port's own invariant), and the oracle's."""
    x = _initial(NS, False, 13)
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    nloc = NS - (R.bit_length() - 1)
    m = np.stack([U1.real, U1.imag])
    t = NS - 1
    outs = []
    for chunks in (1, 2, 8):
        a = SH.split(env.mesh, x, nloc, torch.float64)
        outs.append(SH.gather_host(PD.apply_matrix_1q_sharded(
            a, m, num_qubits=NS, target=t, controls=ctrls,
            chunks=chunks)))
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    want = oracle.apply_to_statevec(x[0] + 1j * x[1], NS, [t], U1,
                                    list(ctrls))
    np.testing.assert_allclose(outs[0][0] + 1j * outs[0][1], want,
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Drain programs, against the reference's _split_items_sharded
# ---------------------------------------------------------------------------


def _items(mod_c, mod_f, n, density, seed):
    rng = np.random.default_rng(seed)
    items = []
    h = np.stack([oracle.H.real, oracle.H.imag])
    cnot = np.stack([np.eye(4)[[0, 3, 2, 1]], np.zeros((4, 4))])
    swap = np.stack([np.eye(4)[[0, 2, 1, 3]], np.zeros((4, 4))])
    u2 = np.stack([U2.real, U2.imag])
    for _ in range(24):
        kind = int(rng.integers(0, 5))
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        if kind == 0:
            items.append(mod_c.Gate((a,), h))
        elif kind == 1:
            items.append(mod_c.Gate((a, b), cnot))
        elif kind == 2:
            items.append(mod_c.Gate((a, b), u2))
        elif kind == 3:
            items.append(mod_c.Gate((a, b), swap))
        elif density:
            nq = n // 2
            t = a % nq
            items.append(mod_f.ChannelItem("depol" if b % 2 else "damping",
                                           t, t + nq, 0.1))
    return items


def _skeleton(program):
    out = []
    for p in program:
        if p[0] == "plan":
            sk = PC.split_plan(p[1])[0] if len(p) == 2 else p[1]
            out.append(("plan", sk))
        else:
            out.append(p)
    return out


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("start", ["canonical", "permuted"])
def test_drain_program_is_the_reference(R, density, seed, start):
    n = 2 * ND if density else NS
    nloc = n - (R.bit_length() - 1)
    perm0 = None
    if start == "permuted":
        perm0 = tuple(int(x) for x in
                      np.random.default_rng(seed + 9).permutation(n))
    ritems = _items(RC, RF, n, density, seed)
    pitems = _items(PC, PF, n, density, seed)
    rprog, _arrays, rfinal = RF._split_items_sharded(ritems, n, nloc, perm0,
                                                     False)
    pprog, pfinal = PF._split_items_sharded(pitems, n, nloc, perm0, False)
    assert _skeleton(pprog) == _skeleton(rprog)
    assert pfinal == rfinal


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------


def _relocation_circuit(q, u2):
    """Multi-target sharded gates and pure data movement (test_remap.py's
    bit-identity circuit): the same arithmetic on both paths."""
    tq.hadamard(q, 0)
    tq.multiQubitUnitary(q, [4, 5], u2)
    tq.multiQubitUnitary(q, [4, 5], u2)
    tq.multiQubitUnitary(q, [3, 4], u2)
    tq.pauliX(q, 5)
    tq.tGate(q, 4)
    tq.swapGate(q, 0, 5)
    tq.multiQubitUnitary(q, [3, 5], u2)


@pytest.mark.parametrize("R", MESHES)
def test_lazy_against_eager_bit_for_bit(R):
    outs = []
    for lazy in (True, False):
        PD.use_lazy_remap(lazy)
        env = tq.createQuESTEnv(devices=["cpu"] * R)
        q = tq.createQureg(NS, env)
        tq.initStateFromAmps(q, *_initial(NS, False, 32))
        _relocation_circuit(q, U2)
        outs.append(interop.register_state(q, canonical=True)[0])
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("chunks", [None, "2", "8"])
def test_fused_drain_against_eager_and_one_device(R, chunks, monkeypatch):
    if chunks is None:
        monkeypatch.delenv("QT_EXCHANGE_CHUNKS", raising=False)
    else:
        monkeypatch.setenv("QT_EXCHANGE_CHUNKS", chunks)
    outs = []
    for env, fuse in ((tq.createQuESTEnv(device="cpu"), False),
                      (tq.createQuESTEnv(devices=["cpu"] * R), False),
                      (tq.createQuESTEnv(devices=["cpu"] * R), True)):
        q = _make(tq, env, NS, False, _initial(NS, False, 4))
        if fuse:
            with tq.gateFusion(q):
                _mixed(tq, q, [])
        else:
            _mixed(tq, q, [])
        outs.append(interop.register_state(q, canonical=True)[0])
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=0, atol=TOL)


def test_drain_leaves_and_next_drain_starts_from_the_permutation():
    env = tq.createQuESTEnv(devices=["cpu"] * 8)
    q = tq.createQureg(NS, env)
    with tq.gateFusion(q):
        tq.hadamard(q, NS - 1)
    assert q._perm is not None           # the remap stays live
    with tq.gateFusion(q):
        tq.hadamard(q, NS - 1)           # no remap needed now
        tq.hadamard(q, 0)
    PD.reset_counters()
    assert abs(tq.getRealAmp(q, 0) - 0.5 ** 0.5) <= TOL
    # the read restored canonical order with one remap
    assert PD.counter_sum("exchanges_total", op="remap") >= 1
    assert q._perm is None


@pytest.mark.parametrize("density", [False, True])
def test_one_shard_env_is_a_plain_env(density):
    """devices=["cpu"] is the one-device env: no mesh, a plain tensor, and
    the same states bit for bit as device="cpu"."""
    outs = []
    for env in (tq.createQuESTEnv(device="cpu"),
                tq.createQuESTEnv(devices=["cpu"]),
                tq.createQuESTEnv(devices=["cpu"] * 3, num_devices=1)):
        assert env.mesh is None and env.num_devices == 1
        n = ND if density else NS
        q = _make(tq, env, n, density, _initial(n, density, 2))
        assert not q.is_sharded and torch.is_tensor(q._amps)
        with tq.gateFusion(q):
            _mixed(tq, q, [])
        outs.append(q.amps.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_env_shapes_and_errors():
    env = tq.createQuESTEnv(devices=["cpu"] * 6)
    assert env.num_devices == 4 and env.num_ranks == 4 and env.rank == 0
    env = tq.createQuESTEnv(devices=["cpu"] * 8, num_devices=2)
    assert env.num_devices == 2
    assert "Mesh=in-process x2" in tq.getEnvironmentString(env)
    with pytest.raises(tq.QuESTError):
        tq.createQuESTEnv(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(tq.QuESTError, match="no CUDA device"):
            tq.createQuESTEnv()
    assert callable(tq.initDistributed)
    assert tq.PAR is PD and tq.parallel.dist is PD


def test_interop_carries_a_permuted_register(ref):
    """A permuted reference register (its raw amplitudes and live _perm)
    handed to the port continues there as it continues in the
    reference."""
    renv = qt.createQuESTEnv(num_devices=8)
    rq = qt.createQureg(NS, renv)
    qt.initStateFromAmps(rq, *_initial(NS, False, 7))
    qt.multiQubitUnitary(rq, [4, 5], U2)
    assert rq._perm is not None
    raw = np.asarray(rq._amps_raw())
    penv = tq.createQuESTEnv(devices=["cpu"] * 8)
    pq = tq.createQureg(NS, penv)
    interop.load_register(pq, raw, rq._perm)
    assert pq._perm == rq._perm
    back, perm = interop.register_state(pq)
    assert perm == rq._perm and np.array_equal(back, raw)
    for mod, q in ((qt, rq), (tq, pq)):
        mod.multiQubitUnitary(q, [3, 5], U2)
        mod.hadamard(q, 4)
    np.testing.assert_allclose(interop.register_state(pq, canonical=True)[0],
                               np.asarray(rq.amps), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# The exchange guard
# ---------------------------------------------------------------------------


def test_guard_faults_and_call_errors(monkeypatch):
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0")
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    faults = iter(["stall", None])
    PD.EXCHANGE_FAULT_HOOK[0] = lambda op: next(faults)
    try:
        assert PD.guarded_dispatch(fn, 1, op="remap", shards=8) == 2
        assert calls == [1]
        PD.EXCHANGE_FAULT_HOOK[0] = lambda op: "shard_loss"
        with pytest.raises(PD.ShardLossError):
            PD.guarded_dispatch(fn, 1, op="remap", shards=8)
        PD.EXCHANGE_FAULT_HOOK[0] = lambda op: "host_loss"
        with pytest.raises(PD.ShardLossError) as e:
            PD.guarded_dispatch(fn, 1, op="remap", shards=8)
        assert e.value.shard == 7
    finally:
        PD.EXCHANGE_FAULT_HOOK[0] = None

    def broken(x):
        calls.append(x)
        raise RuntimeError("link down")

    calls.clear()
    with pytest.raises(PD.ShardLossError):
        PD.guarded_dispatch(broken, 3, op="gather", consumes=False)
    assert calls == [3, 3, 3]
    # a dispatch that changes its operand in place runs once
    calls.clear()
    with pytest.raises(PD.ShardLossError):
        PD.guarded_dispatch(broken, 3, op="swap")
    assert calls == [3]
    calls.clear()
    with pytest.raises(tq.QuESTError):
        PD.guarded_dispatch(lambda x: (_ for _ in ()).throw(
            tq.QuESTError("bad call")), 3, op="swap")
    monkeypatch.setenv("QT_EXCHANGE_DEADLINE_S", "0.5")
    assert PD.exchange_deadline() == 0.5
    monkeypatch.setenv("QT_EXCHANGE_DEADLINE_S", "x")
    assert PD.exchange_deadline() is None


def _fail_on_call(fn, at):
    """``fn`` that raises RuntimeError on its ``at``-th call; the calls
    are counted in ``.calls``."""
    def wrapped(*args, **kwargs):
        wrapped.calls += 1
        if wrapped.calls == at:
            raise RuntimeError("link down")
        return fn(*args, **kwargs)

    wrapped.calls = 0
    return wrapped


def _exchange_once(op, a):
    n = NS
    m = np.stack([U1.real, U1.imag])
    if op == "remap":
        sigma = tuple(int(v) for v in np.random.default_rng(3).permutation(n))
        return PD.remap_sharded(a, num_qubits=n, sigma=sigma, chunks=(4, 4))
    if op == "swap":
        return PD.swap_sharded(a, num_qubits=n, qb_low=0, qb_high=n - 1,
                               chunks=4)
    return PD.apply_matrix_1q_sharded(a, m, num_qubits=n, target=n - 1,
                                      chunks=4)


@pytest.mark.parametrize("op", ["remap", "swap", "matrix_1q"])
def test_exchange_failing_part_way_is_not_retried(op, monkeypatch):
    """A transport error after the first of four chunks: the exchange is
    not run again on its half-swapped shards, and the amplitudes refuse
    every later use rather than read wrong."""
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0")
    env = tq.createQuESTEnv(devices=["cpu"] * 4)
    x = _initial(NS, False, 7)
    want = SH.gather_host(_exchange_once(op, SH.split(env.mesh, x, NS - 2,
                                                      torch.float64)))
    failing = _fail_on_call(env.mesh.permute, 2)
    monkeypatch.setattr(env.mesh, "permute", failing)
    a = SH.split(env.mesh, x, NS - 2, torch.float64)
    with pytest.raises(PD.ShardLossError) as e:
        _exchange_once(op, a)
    assert failing.calls == 2 and e.value.op == op
    assert isinstance(e.value.__cause__, RuntimeError)
    with pytest.raises(PD.ShardLossError):
        SH.gather_host(a)
    with pytest.raises(PD.ShardLossError):
        PD.total_prob_sharded(a)
    monkeypatch.undo()
    b = SH.split(env.mesh, x, NS - 2, torch.float64)
    np.testing.assert_array_equal(SH.gather_host(_exchange_once(op, b)),
                                  want)


@pytest.mark.parametrize("R", [2, 8])
def test_drain_failing_part_way_is_not_retried(ref, R, monkeypatch):
    """A drain whose second shard run fails: the first shard's run is not
    applied twice, the register refuses every later read, and the next
    register's drain is the reference's."""
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0")
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    q = _make(tq, env, NS, False, _initial(NS, False, 5))
    failing = _fail_on_call(PF.execute_program, 2)
    monkeypatch.setattr(PF, "execute_program", failing)
    with pytest.raises(PD.ShardLossError) as e:
        with tq.gateFusion(q):
            _mixed(tq, q, [])
    assert failing.calls == 2 and e.value.op == "drain"
    for read in (tq.calcTotalProb, lambda q: tq.getAmp(q, 0),
                 lambda q: tq.calcProbOfOutcome(q, 0, 0)):
        with pytest.raises(PD.ShardLossError):
            read(q)
    monkeypatch.undo()
    check_against_ref(ref, "mixed", _mixed, NS, False, True, R)


# ---------------------------------------------------------------------------
# The torch.distributed backend: spawned gloo ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_circuit(tqm, q):
    """Gates, a drain, a Trotter step, QFTs and a measured sequence; the
    returned reads hold the outcomes and probabilities.  Two more
    registers are returned: 14 qubits after the whole-register QFT (its
    reversal's all_to_all) and 5 density qubits after a DiagonalOp (the
    operator's slices all-gathered), with that register's purity and
    expectation apart (sums of four partials, which gloo adds in its own
    order)."""
    n = q.num_qubits_represented
    with tqm.gateFusion(q):
        _config2_like(tqm, q, [])
        tqm.multiQubitUnitary(q, [n - 1, 0], U2)
    tqm.hadamard(q, n - 1)
    tqm.multiQubitUnitary(q, [n - 2, n - 1], U2)
    tqm.controlledNot(q, n - 1, 0)
    tqm.swapGate(q, 1, n - 1)
    h = tqm.createPauliHamil(n, 2)
    tqm.initPauliHamil(h, [0.4, -0.3],
                       ([1, 2, 3] * n)[:n] + ([3, 0, 1] * n)[:n])
    tqm.applyTrotterCircuit(q, h, 0.5, 2, 1)
    tqm.applyQFT(q, [0, 2, n - 1])
    big = tqm.createQureg(14, q.env)
    tqm.initStateFromAmps(big, *_initial(14, False, 7))
    tqm.applyFullQFT(big)
    rho = tqm.createDensityQureg(5, q.env)
    tqm.initDebugState(rho)
    op = tqm.createDiagonalOp(5, q.env)
    tqm.initDiagonalOp(op, np.linspace(-1, 1, 32), np.linspace(0.5, 2, 32))
    tqm.applyDiagonalOp(rho, op)
    tqm.seedQuEST(q.env, [7, 8])
    outs, probs = tqm.measureSequence(q, [n - 1, 0, n - 2])
    d = tqm.calcExpecDiagonalOp(rho, op)
    return big, rho, outs + probs, [tqm.calcPurity(rho), d.real, d.imag]


def _dist_bank_and_vqe(tqm, env, n, q):
    """A flag-2 bank drain (per-element unitaries, one on the top mesh
    bit) and one VQE energy and gradient on the env's mesh, and two quad
    reads of ``q`` (the padded partials' all_gather and the Pauli sum's
    (T, R) grid): the bank's state (exact) and [energy, *gradient, quad
    reads] (sums of partials, which gloo adds in its own order)."""
    from quest_tpu_torch.models import vqe as VQ
    from quest_tpu_torch.parallel import sharded as SHM

    rng = np.random.default_rng(17)
    mats = np.stack([oracle.random_unitary(1, rng) for _ in range(2)])
    bank = tqm.createBatchedQureg(n, env, 2)
    tqm.hadamard(bank, 0)
    tqm.applyBatchedUnitary(bank, (n - 1,), mats)
    tqm.applyBatchedUnitary(bank, (1,), mats)
    tqm.controlledNot(bank, n - 1, 2)
    state = SHM.gather_host(bank.amps)
    codes, coeffs = VQ.random_hamiltonian(n, 3, seed=5)
    model = VQ.VQE(n, 1, codes, coeffs, mesh=env.mesh)
    p = torch.tensor(rng.standard_normal(model.num_params) * 0.3,
                     requires_grad=True)
    e = model.energy(p)
    e.backward()
    tqm.set_precision(4)
    try:
        quad = [tqm.calcTotalProb(q),
                tqm.calcExpecPauliSum(q, codes.ravel(), coeffs)]
    finally:
        tqm.set_precision(2)
    return state, np.concatenate([[float(e.detach())], p.grad.numpy(),
                                  quad])


def _dist_record(SHM, tqm, q, n, big, rho, reads):
    """The bit-exact record: the three states, the reads and q's
    probability and norm."""
    return np.concatenate([SHM.gather_host(q.amps).ravel(),
                           SHM.gather_host(big.amps).ravel(),
                           SHM.gather_host(rho.amps).ravel(), reads,
                           [tqm.calcProbOfOutcome(q, n - 1, 0),
                            tqm.calcTotalProb(q)]])


def _dist_worker(rank, world, port, n, out_dir):
    import torch.distributed as dist

    import quest_tpu_torch as tqm
    from quest_tpu_torch.parallel import sharded as SHM

    tqm.initDistributed(f"tcp://localhost:{port}", world, rank, "gloo")
    try:
        tqm.set_precision(2)
        env = tqm.createQuESTEnv()
        q = tqm.createQureg(n, env)
        tqm.initStateFromAmps(q, *_initial(n, False, 6))
        big, rho, reads, sums = _dist_circuit(tqm, q)
        bank, vqe = _dist_bank_and_vqe(tqm, env, n, q)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.concatenate(
            [_dist_record(SHM, tqm, q, n, big, rho, reads), bank.ravel()]))
        np.save(os.path.join(out_dir, f"sums{rank}.npy"),
                np.concatenate([sums, vqe]))
    finally:
        dist.destroy_process_group()


def test_init_distributed_without_a_backend_refuses_the_cpu(monkeypatch):
    """With no backend named and no CUDA card, initDistributed raises
    instead of falling back to gloo on the CPU, and joins no group."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tq.QuESTError, match='backend="gloo"'):
        tq.initDistributed(f"tcp://localhost:{_free_port()}", 1, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_torch_distributed_gloo_matches_in_process(world, tmp_path):
    import torch.multiprocessing as mp

    n = 10
    ctx = mp.start_processes(_dist_worker,
                             args=(world, _free_port(), n, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120    # this test's own time limit
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, \
                f"the {world} gloo ranks did not finish in 120 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    env = tq.createQuESTEnv(devices=["cpu"] * world)
    q = tq.createQureg(n, env)
    tq.initStateFromAmps(q, *_initial(n, False, 6))
    big, rho, reads, sums = _dist_circuit(tq, q)
    bank, vqe = _dist_bank_and_vqe(tq, env, n, q)
    want = np.concatenate([_dist_record(SH, tq, q, n, big, rho, reads),
                           bank.ravel()])
    sums = np.concatenate([sums, vqe])
    for rank in range(world):
        got = np.load(tmp_path / f"rank{rank}.npy")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(np.load(tmp_path / f"sums{rank}.npy"),
                                   sums, rtol=1e-14, atol=1e-14)
