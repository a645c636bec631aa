"""The port's first slice end to end, against quest_tpu and the oracle.

* The API route: createQureg, the bench circuit's gates under gateFusion,
  calcProbOfOutcome and calcTotalProb, in both packages at 16 qubits,
  depth 6 (bench.py config 2's circuit, cut in width and depth).
* The same gates applied eagerly, with no fusion.
* The bench route: bench_gate_list -> plan_circuit -> plan_to_device ->
  execute_plan_chained -> prob_top_zero_canonical.
* The unitary-gate surface, eager and fused, against tests/oracle.py at
  6-8 qubits.

Tolerance: 1e-10 absolute at float64 — the packages apply the same gates
in window passes whose 128-term sums are taken in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import circuit as RC
from quest_tpu_torch import circuit as C
from quest_tpu_torch import precision
from quest_tpu_torch.models import circuits as TM

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run: its
    spinning worker threads starve the other test processes (with 6 test
    processes on 8 cores, tests of 0.8 s took 40 s)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-10
N, DEPTH = 16, 6


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


def _bench_gates(m, q, us, n):
    for d in range(us.shape[0]):
        for t in range(n):
            m.unitary(q, t, us[d, t, 0] + 1j * us[d, t, 1])
        for t in range(d % 2, n - 1, 2):
            m.controlledNot(q, t, t + 1)


def _amps(q):
    a = q.amps
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@functools.lru_cache(maxsize=None)
def _reference_api():
    """The JAX package's API route (one device, fused): amplitudes,
    P(top qubit = 0) and the total probability."""
    us = TM.bench_unitaries(N, DEPTH, seed=7, dtype=np.float64)
    q = qt.createQureg(N, qt.createQuESTEnv(num_devices=1))
    with qt.gateFusion(q):
        _bench_gates(qt, q, us, N)
    return (_amps(q), qt.calcProbOfOutcome(q, N - 1, 0), qt.calcTotalProb(q))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_api_route_matches_reference(fused):
    us = TM.bench_unitaries(N, DEPTH, seed=7, dtype=np.float64)
    q = tq.createQureg(N, tq.createQuESTEnv(device="cpu"))
    if fused:
        with tq.gateFusion(q):
            _bench_gates(tq, q, us, N)
            assert q._fusion.gates           # buffered, not yet applied
    else:
        _bench_gates(tq, q, us, N)
    want_amps, want_p, want_total = _reference_api()
    np.testing.assert_allclose(_amps(q), want_amps, rtol=0, atol=TOL)
    assert abs(tq.calcProbOfOutcome(q, N - 1, 0) - want_p) <= TOL
    assert abs(tq.calcTotalProb(q) - want_total) <= TOL


def test_bench_route_matches_reference():
    us = TM.bench_unitaries(N, DEPTH, seed=7)
    gates = TM.bench_gate_list(N, DEPTH, us)
    plan = C.plan_circuit(gates, N)
    a = C.execute_plan_chained(
        TM.zero_state_canonical(N, torch.float64, "cpu"),
        C.plan_to_device(plan, torch.float64, "cpu"), N)
    assert a.shape == (2, 1 << (N - 14), 128, 128)
    ref_plan = RC.plan_circuit([RC.Gate(g.targets, g.mat) for g in gates], N,
                               use_native=False)
    x0 = np.zeros((2, 1 << (N - 14), 128, 128))
    x0[0, 0, 0, 0] = 1.0
    want = np.asarray(RC.execute_plan_chained(jnp.asarray(x0), ref_plan, N))
    np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=TOL)
    p = float(TM.prob_top_zero_canonical(a))
    assert abs(p - float((want[:, : want.shape[1] // 2] ** 2).sum())) <= TOL


def test_bench_route_holds_the_norm_and_agrees_with_the_api():
    """With exactly unitary draws the planned route keeps the norm to
    1e-12 and gives the API route's probability (the float64 CNOT keeps
    the planner's controlled-form rewrite exact; see models/circuits)."""
    us = TM.bench_unitaries(N, DEPTH, seed=7, dtype=np.float64)
    plan = C.plan_circuit(TM.bench_gate_list(N, DEPTH, us), N)
    a = C.execute_plan_chained(
        TM.zero_state_canonical(N, torch.float64, "cpu"),
        C.plan_to_device(plan, torch.float64, "cpu"), N)
    assert abs(float((a * a).sum()) - 1.0) <= 1e-12
    _, want_p, _ = _reference_api()
    assert abs(float(TM.prob_top_zero_canonical(a)) - want_p) <= TOL


def test_prob_top_zero_needs_two_rows():
    with pytest.raises(ValueError):
        TM.prob_top_zero_canonical(torch.zeros((2, 1, 128, 128)))


def test_bench_unitaries_are_the_reference_draw():
    from quest_tpu.models import circuits as RM

    _, us = RM.build_random_circuit(15, 3, seed=7)
    assert np.array_equal(TM.bench_unitaries(15, 3, seed=7), np.asarray(us))


# ---------------------------------------------------------------------------
# The unitary-gate surface against the oracle
# ---------------------------------------------------------------------------

_I2 = np.eye(2, dtype=complex)
_SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]


def _rx(t):
    return np.cos(t / 2) * _I2 - 1j * np.sin(t / 2) * oracle.X


def _ry(t):
    return np.cos(t / 2) * _I2 - 1j * np.sin(t / 2) * oracle.Y


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def _gate_program(rng, n):
    """[(label, apply(module, q), targets, matrix, controls, states)]: one
    call of each ported gate with the operator the oracle applies."""
    u1, u2 = oracle.random_unitary(1, rng), oracle.random_unitary(2, rng)
    u3 = oracle.random_unitary(3, rng)
    ang = rng.uniform(-np.pi, np.pi, 8)
    a, b, c, d = (int(v) for v in rng.choice(n, 4, replace=False))
    alpha = np.exp(0.3j) * np.cos(0.4)
    beta = np.exp(-1.1j) * np.sin(0.4)
    cu = np.array([[alpha, -np.conj(beta)], [beta, np.conj(alpha)]])
    return [
        ("hadamard", lambda m, q: m.hadamard(q, a), (a,), oracle.H, (), None),
        ("pauliX", lambda m, q: m.pauliX(q, b), (b,), oracle.X, (), None),
        ("pauliY", lambda m, q: m.pauliY(q, c), (c,), oracle.Y, (), None),
        ("pauliZ", lambda m, q: m.pauliZ(q, d), (d,), oracle.Z, (), None),
        ("sGate", lambda m, q: m.sGate(q, a), (a,), np.diag([1, 1j]), (),
         None),
        ("tGate", lambda m, q: m.tGate(q, b), (b,),
         np.diag([1, np.exp(0.25j * np.pi)]), (), None),
        ("phaseShift", lambda m, q: m.phaseShift(q, c, ang[0]), (c,),
         np.diag([1, np.exp(1j * ang[0])]), (), None),
        ("rotateX", lambda m, q: m.rotateX(q, a, ang[1]), (a,), _rx(ang[1]),
         (), None),
        ("rotateY", lambda m, q: m.rotateY(q, b, ang[2]), (b,), _ry(ang[2]),
         (), None),
        ("rotateZ", lambda m, q: m.rotateZ(q, c, ang[3]), (c,), _rz(ang[3]),
         (), None),
        ("compactUnitary", lambda m, q: m.compactUnitary(q, d, alpha, beta),
         (d,), cu, (), None),
        ("unitary", lambda m, q: m.unitary(q, a, u1), (a,), u1, (), None),
        ("controlledNot", lambda m, q: m.controlledNot(q, a, b), (b,),
         oracle.X, (a,), None),
        ("controlledPauliY", lambda m, q: m.controlledPauliY(q, c, d), (d,),
         oracle.Y, (c,), None),
        ("controlledRotateX", lambda m, q: m.controlledRotateX(q, b, a,
                                                               ang[4]),
         (a,), _rx(ang[4]), (b,), None),
        ("controlledPhaseShift",
         lambda m, q: m.controlledPhaseShift(q, a, c, ang[5]), (c,),
         np.diag([1, np.exp(1j * ang[5])]), (a,), None),
        ("controlledPhaseFlip", lambda m, q: m.controlledPhaseFlip(q, b, d),
         (d,), oracle.Z, (b,), None),
        ("controlledUnitary", lambda m, q: m.controlledUnitary(q, d, c, u1),
         (c,), u1, (d,), None),
        ("multiControlledUnitary",
         lambda m, q: m.multiControlledUnitary(q, [a, b], c, u1), (c,), u1,
         (a, b), None),
        ("multiStateControlledUnitary",
         lambda m, q: m.multiStateControlledUnitary(q, [d, a], [0, 1], b, u1),
         (b,), u1, (d, a), [0, 1]),
        ("twoQubitUnitary", lambda m, q: m.twoQubitUnitary(q, c, a, u2),
         (c, a), u2, (), None),
        ("multiQubitUnitary",
         lambda m, q: m.multiQubitUnitary(q, [b, d, a], u3), (b, d, a), u3,
         (), None),
        ("swapGate", lambda m, q: m.swapGate(q, a, d), (a, d), _SWAP, (),
         None),
        ("multiQubitNot", lambda m, q: m.multiQubitNot(q, [c, a]), (c, a),
         np.kron(oracle.X, oracle.X), (), None),
    ]


@pytest.mark.parametrize("n", [6, 7, 8])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_gate_surface_matches_oracle(n, fused):
    rng = np.random.default_rng(60 + n)
    program = _gate_program(rng, n)
    q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
    tq.initDebugState(q)
    psi = oracle.debug_state(1 << n)
    if fused:
        with tq.gateFusion(q):
            for _, call, *_ in program:
                call(tq, q)
    else:
        for _, call, *_ in program:
            call(tq, q)
    for _, _, targets, mat, controls, states in program:
        psi = oracle.apply_to_statevec(psi, n, targets, mat, controls, states)
    got = _amps(q)
    np.testing.assert_allclose(got[0] + 1j * got[1], psi, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tq.calcProbOfAllOutcomes(q, [0, n - 1]),
        [np.sum(np.abs(psi[[i for i in range(1 << n)
                            if (i & 1) == o0 and (i >> (n - 1)) == o1]]) ** 2)
         for o1 in (0, 1) for o0 in (0, 1)],
        rtol=0, atol=TOL)


def test_state_api_round_trip():
    env = tq.createQuESTEnv(device="cpu")
    q = tq.createQureg(5, env)
    tq.initPlusState(q)
    assert abs(tq.calcTotalProb(q) - 1.0) <= TOL
    tq.initClassicalState(q, 6)
    assert tq.getAmp(q, 6) == 1.0
    tq.setAmps(q, 0, [0.6, 0.0], [0.0, 0.8], 2)
    assert tq.getAmp(q, 1) == 0.8j
    clone = tq.createCloneQureg(q, env)
    assert np.array_equal(_amps(clone), _amps(q))
    tq.initZeroState(clone)
    assert tq.calcInnerProduct(clone, q) == 0.6
    pure = tq.createQureg(5, env)
    tq.initPureState(pure, q)
    assert np.array_equal(_amps(pure), _amps(q))
    tq.destroyQureg(q, env)
    with pytest.raises(tq.QuESTError):
        q.amps


def test_density_register_is_created():
    rho = tq.createDensityQureg(3, tq.createQuESTEnv(device="cpu"))
    assert rho.amps.shape == (2, 1 << 6)
    assert abs(tq.calcTotalProb(rho) - 1.0) <= TOL
