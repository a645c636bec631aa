"""The paged planner's path (QT_PLANNER=paged) against quest_tpu.

* The cluster pass (K11) and the fused segment-swap + cluster pass (K12)
  are CUDA kernels in the port; on the CPU their wrappers run the plain
  versions, held here against the JAX package's Pallas kernels in
  interpret mode: within 1e-10 at float64 (the same sums of 128-term
  products in another order).
* ``plan_circuit(..., planner="paged")`` against the JAX package's
  ``plan_circuit_py``: the same op kinds in the same order, the same
  (h, b, m) and apply targets, the same ranks, matrices within 1e-12
  (both fold the same NumPy products; 1e-12 leaves room for another
  BLAS's summation order).
* The executor: a reference plan run by the port, the port's paged route
  against its windowed route and a gate-by-gate NumPy oracle, all within
  1e-10; plan (de)composition.
* The gateFusion drain under QT_PLANNER=paged against the reference's.
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
from quest_tpu.ops import fused as ref_fused
from quest_tpu_torch import circuit as C
from quest_tpu_torch import fusion, interop, precision
from quest_tpu_torch.models import circuits as TM
from quest_tpu_torch.ops import fused

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run: its
    spinning worker threads starve the other test processes."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def _no_megakernel(monkeypatch):
    monkeypatch.setenv("QT_MEGAKERNEL", "off")
    monkeypatch.delenv("QT_PLANNER", raising=False)


TOL = 1e-10
PLAN_TOL = 1e-12


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _soa(u):
    return np.stack([u.real, u.imag])


def _sides(rng, rank):
    """(R, 2, 128, 128) SoA side stacks: unitaries scaled by 1/rank."""
    return np.stack([_soa(_unitary(rng, 128)) / rank for _ in range(rank)])


def _state(rng, n):
    x = rng.standard_normal((2, 1 << n))
    return x / np.sqrt((x ** 2).sum())


# ---------------------------------------------------------------------------
# K11 and K12's plain versions against the reference kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [1, 4])
@pytest.mark.parametrize("n", [14, 15, 17])
def test_cluster_stack_matches_reference(n, rank):
    rng = np.random.default_rng(100 + 10 * n + rank)
    x = _state(rng, n)
    a, b = _sides(rng, rank), _sides(rng, rank)
    want = np.asarray(ref_fused.apply_cluster_stack(
        jnp.asarray(x), a, b, num_qubits=n, interpret=True))
    got = fused.apply_cluster_stack(torch.from_numpy(x), a, b, num_qubits=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert torch.equal(got, fused.cluster_stack_plain(
        torch.from_numpy(x), a, b, num_qubits=n))


# the (h, b, m) cases; n is the smallest of 17 and h + m the swap allows
_SWAPS = [(14, 7, 1), (14, 11, 3), (15, 9, 2), (16, 7, 3), (17, 8, 3)]


@pytest.mark.parametrize("rank", [1, 4])
@pytest.mark.parametrize("hbm", _SWAPS, ids=lambda t: "h%d-b%d-m%d" % t)
def test_swap_cluster_stack_matches_reference(hbm, rank):
    h, b, m = hbm
    n = max(17, h + m)
    rng = np.random.default_rng(200 + h + 7 * b + 31 * m + rank)
    x = _state(rng, n)
    sa, sb = _sides(rng, rank), _sides(rng, rank)
    want = np.asarray(ref_fused.apply_swap_cluster_stack(
        jnp.asarray(x), sa, sb, num_qubits=n, h=h, b=b, m=m, interpret=True))
    got = fused.apply_swap_cluster_stack(torch.from_numpy(x), sa, sb,
                                         num_qubits=n, h=h, b=b, m=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the plain version is the swap followed by the cluster pass
    swapped = C.execute_plan(torch.from_numpy(x), [("segswap", h, b, m)], n)
    assert torch.equal(got, fused.cluster_stack_plain(swapped, sa, sb,
                                                      num_qubits=n))


@pytest.mark.parametrize("n", [14, 16])
def test_cluster_pair_matches_reference(n):
    rng = np.random.default_rng(300 + n)
    x = _state(rng, n)
    a, b = _soa(_unitary(rng, 128)), _soa(_unitary(rng, 128))
    want = np.asarray(ref_fused.apply_cluster_pair(
        jnp.asarray(x), a, b, num_qubits=n, interpret=True))
    got = fused.apply_cluster_pair(torch.from_numpy(x), a, b, num_qubits=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_cluster_pair_of_kronecker_factors_matches_gatewise():
    """A pair built from 14 single-qubit unitaries is those gates applied
    one by one (the reference's TestClusterKernel.test_matches_gatewise)."""
    rng = np.random.default_rng(15)
    n = 15
    x = _state(rng, n)
    us = [_unitary(rng, 2) for _ in range(14)]
    a = us[6]
    for u in us[5::-1]:
        a = np.kron(a, u)
    b = us[13]
    for u in us[12:6:-1]:
        b = np.kron(b, u)
    got = fused.apply_cluster_pair(torch.from_numpy(x), _soa(a), _soa(b),
                                   num_qubits=n).numpy()
    want = _gatewise(x, [C.Gate((q,), _soa(u)) for q, u in enumerate(us)], n)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


_EYE = np.stack([np.eye(128), np.zeros((128, 128))])[None]


@pytest.mark.parametrize("call, match", [
    (lambda x: fused.apply_cluster_stack(x, _EYE, _EYE, num_qubits=13),
     "apply_cluster_stack needs >= 14 qubits"),
    (lambda x: fused.apply_cluster_pair(x, _EYE[0], _EYE[0], num_qubits=10),
     "apply_cluster_stack needs >= 14 qubits"),
    (lambda x: fused.apply_cluster_stack(x, _EYE[0], _EYE[0], num_qubits=16),
     r"\(R, 2, 128, 128\)"),
    (lambda x: fused.apply_cluster_stack(x, _EYE, np.concatenate([_EYE] * 2),
                                         num_qubits=16),
     r"\(R, 2, 128, 128\)"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=13,
                                              h=14, b=7, m=1),
     "apply_swap_cluster_stack needs >= 14 qubits"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=16,
                                              h=13, b=7, m=1), "h=13"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=16,
                                              h=14, b=6, m=1), "b=6"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=16,
                                              h=14, b=12, m=3), "b=12"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=20,
                                              h=14, b=7, m=4), "m=4"),
    (lambda x: fused.apply_swap_cluster_stack(x, _EYE, _EYE, num_qubits=16,
                                              h=15, b=7, m=2), "h=15"),
], ids=["n13", "pair-n10", "unstacked", "ranks-differ", "swap-n13", "h13",
        "b6", "b-plus-m", "m4", "h-plus-m"])
def test_cluster_entries_check_their_arguments(call, match):
    x = torch.zeros((2, 1 << 16), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        call(x)


def test_max_fused_swap_m_is_the_reference_value():
    assert fused.MAX_FUSED_SWAP_M == ref_fused.MAX_FUSED_SWAP_M == 3


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

_CNOT = np.zeros((2, 4, 4))
_CNOT[0] = np.array([[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]])


def _layered(rng, n, depth):
    """Per layer a Haar 1q unitary on every qubit and a CNOT ladder on
    alternating pairs (tests/test_circuit.py _layered_circuit, float64)."""
    gates = []
    for d in range(depth):
        for q in range(n):
            gates.append(C.Gate((q,), _soa(_unitary(rng, 2))))
        for q in range(d % 2, n - 1, 2):
            gates.append(C.Gate((q, q + 1), _CNOT))
    return gates


def _stream(name):
    """(n, gates) of a named gate list, made from a seed."""
    kind, n = name.split("-")
    n = int(n)
    rng = np.random.default_rng(400 + n)
    if kind == "layered2":
        return n, _layered(rng, n, 2)
    if kind == "layered3":
        return n, _layered(rng, n, 3)
    if kind == "config2":
        us = TM.bench_unitaries(n, 2, seed=7, dtype=np.float64)
        return n, TM.bench_gate_list(n, 2, us)
    if kind == "highq":
        # a 2q gate on the two high qubits, then one reaching lane 0
        # (tests/test_circuit.py test_high_qubit_2q_gate)
        return n, [C.Gate((14, 15), _soa(_unitary(rng, 4))),
                   C.Gate((0, 15), _CNOT)] + _layered(rng, n, 1)
    if kind == "farq":
        # a 2q gate whose span (8 bits) no segment swap reaches: an apply op
        return n, [C.Gate((14, n - 1), _soa(_unitary(rng, 4)))] + \
            _layered(rng, n, 1)
    raise ValueError(name)


_PLANNED = ["layered2-14", "layered3-16", "layered3-17", "layered2-20",
            "config2-16", "highq-16", "farq-22"]


@functools.lru_cache(maxsize=None)
def _plans(name):
    """(n, gates, the port's paged plan, the reference's plan_circuit_py)."""
    n, gates = _stream(name)
    mine = C.plan_circuit(gates, n, planner="paged")
    ref = RC.plan_circuit_py([RC.Gate(g.targets, g.mat) for g in gates], n)
    return n, gates, mine, ref


def _assert_same_plan(mine, ref):
    assert [op[0] for op in mine] == [op[0] for op in ref]
    for a, b in zip(mine, ref):
        if a[0] == "fused":
            mats = [(a[1], b[1]), (a[2], b[2])]
        elif a[0] == "swapfused":
            assert a[1:4] == tuple(b[1:4])
            mats = [(a[4], b[4]), (a[5], b[5])]
        elif a[0] == "apply":
            assert tuple(a[1]) == tuple(b[1])
            mats = [(a[2], b[2])]
        else:
            assert a == tuple(b)
            mats = []
        for x, y in mats:
            assert isinstance(x, np.ndarray)
            y = np.asarray(y)
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=PLAN_TOL)


@pytest.mark.parametrize("name", _PLANNED)
def test_paged_plan_matches_reference(name):
    _n, _gates, mine, ref = _plans(name)
    _assert_same_plan(mine, ref)


def test_plans_cover_every_paged_op_kind():
    kinds = {op[0] for name in _PLANNED for op in _plans(name)[2]}
    assert kinds == {"fused", "swapfused", "segswap", "apply"}
    ranks = {op[1].shape[0] for name in _PLANNED for op in _plans(name)[2]
             if op[0] == "fused"}
    assert ranks == {1, 4}


def test_below_14_qubits_every_gate_is_an_apply_op():
    rng = np.random.default_rng(9)
    gates = _layered(rng, 10, 2)
    mine = C.plan_circuit(gates, 10, planner="paged")
    ref = RC.plan_circuit_py([RC.Gate(g.targets, g.mat) for g in gates], 10)
    _assert_same_plan(mine, ref)
    assert len(mine) == len(gates)
    assert all(op[0] == "apply" for op in mine)
    x = oracle.random_state(10, rng)
    got = C.execute_plan(torch.from_numpy(np.stack([x.real, x.imag])),
                         mine, 10).numpy()
    want = x
    for g in gates:
        want = oracle.apply_to_statevec(want, 10, g.targets, g.mat[0] +
                                        1j * g.mat[1])
    np.testing.assert_allclose(got[0] + 1j * got[1], want, rtol=0, atol=TOL)


def test_qt_planner_selects_the_paged_planner(monkeypatch):
    _n, gates, mine, _ref = _plans("layered3-16")
    monkeypatch.setenv("QT_PLANNER", "paged")
    assert C.resolve_planner() == "paged"
    _assert_same_plan(C.plan_circuit(gates, 16), mine)
    monkeypatch.setenv("QT_PLANNER", "windowed")
    assert {op[0] for op in C.plan_circuit(gates, 16)} == {"winfused"}


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_unknown_planner_raises(how, monkeypatch):
    with pytest.raises(ValueError) as want:
        RC.plan_circuit([], 16, planner="window")
    if how == "environment":
        monkeypatch.setenv("QT_PLANNER", "window")
        kw = {}
    else:
        kw = {"planner": "window"}
    with pytest.raises(ValueError) as got:
        C.plan_circuit([], 16, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def _gatewise(x, gates, n):
    """A gate-by-gate NumPy simulator: each gate's matrix contracted with
    its target axes of the state as an n-axis tensor (the index algebra of
    tests/oracle.py full_operator without the 2^n x 2^n operator, which
    does not fit at 16 qubits)."""
    psi = (x[0] + 1j * x[1]).reshape((2,) * n)       # axis i = qubit n-1-i
    for g in gates:
        k = len(g.targets)
        u = (g.mat[0] + 1j * g.mat[1]).reshape((2,) * (2 * k))
        # matrix axis j (of k) = matrix bit k-1-j = targets[k-1-j]
        axes = [n - 1 - g.targets[k - 1 - j] for j in range(k)]
        psi = np.tensordot(u, psi, axes=(list(range(k, 2 * k)), axes))
        psi = np.moveaxis(psi, list(range(k)), axes)
    flat = psi.reshape(-1)
    return np.stack([flat.real, flat.imag])


@pytest.mark.parametrize("name", ["layered3-16", "layered3-17",
                                  "config2-16", "highq-16"])
def test_reference_plan_runs_in_the_port(name):
    n, _gates, _mine, ref = _plans(name)
    x = _state(np.random.default_rng(500 + n), n)
    want = np.asarray(RC.execute_plan(jnp.asarray(x), ref, n,
                                      interpret=True))
    plan = interop.plan_from_numpy(ref, "cpu", torch.float64)
    assert [op[0] for op in plan] == [op[0] for op in ref]
    got = C.execute_plan(torch.from_numpy(x), plan, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["layered3-16", "layered3-17", "highq-16",
                                  "config2-18"])
def test_paged_route_matches_windowed_route_and_oracle(name):
    n, gates = _stream(name)
    paged = C.plan_circuit(gates, n, planner="paged")
    assert {"fused", "swapfused"} & {op[0] for op in paged}
    x = _state(np.random.default_rng(600 + n), n)
    want = _gatewise(x, gates, n)
    got = C.apply_circuit(torch.from_numpy(x), gates, n)   # windowed
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    a = C.execute_plan_chained(
        torch.from_numpy(x), C.plan_to_device(paged, torch.float64, "cpu"),
        n)
    assert a.shape == (2, 1 << (n - 14), 128, 128)
    np.testing.assert_allclose(a.reshape(2, -1).numpy(), want, rtol=0,
                               atol=TOL)


def test_apply_circuit_follows_qt_planner(monkeypatch):
    n, gates = _stream("layered3-16")
    x = torch.from_numpy(_state(np.random.default_rng(7), n))
    calls = []
    real = fused.apply_swap_cluster_stack

    def spy(*a, **kw):
        calls.append((kw["h"], kw["b"], kw["m"]))
        return real(*a, **kw)

    monkeypatch.setattr(fused, "apply_swap_cluster_stack", spy)
    monkeypatch.setenv("QT_PLANNER", "paged")
    got = C.apply_circuit(x, gates, n)
    want = _plans("layered3-16")[2]
    assert calls == [op[1:4] for op in want if op[0] == "swapfused"]
    np.testing.assert_allclose(got.numpy(), _gatewise(x.numpy(), gates, n),
                               rtol=0, atol=TOL)


def test_split_and_rebuild_round_trip_a_paged_plan():
    _n, _gates, plan, _ref = _plans("farq-22")
    assert {op[0] for op in plan} == {"fused", "swapfused", "segswap",
                                      "apply"}
    skeleton, arrays = C.split_plan(plan)
    hash(skeleton)
    again = C.rebuild_plan(skeleton, arrays)
    assert C.split_plan(again)[0] == skeleton
    assert all(a is b for a, b in zip(C.split_plan(again)[1], arrays))
    _assert_same_plan(again, plan)
    # the reference's skeleton of the same plan has the same structure
    assert skeleton == RC.split_plan(_plans("farq-22")[3])[0]


def test_plan_to_device_uploads_the_paged_operands():
    _n, _gates, plan, _ref = _plans("layered3-16")
    dev = C.plan_to_device(plan, torch.float32, "cpu")
    for op, src in zip(dev, plan):
        assert op[0] == src[0]
        if op[0] == "fused":
            assert all(t.dtype == torch.float32 for t in op[1:])
        elif op[0] == "swapfused":
            assert op[1:4] == src[1:4]
            assert all(t.dtype == torch.float32 for t in op[4:])
        else:
            assert op == src


# ---------------------------------------------------------------------------
# The API and the drain
# ---------------------------------------------------------------------------

N_API, DEPTH_API = 16, 3


@pytest.fixture
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


@pytest.mark.usefixtures("double")
def test_gate_fusion_under_paged_planner_matches_reference(monkeypatch):
    monkeypatch.setenv("QT_PLANNER", "paged")
    us = TM.bench_unitaries(N_API, DEPTH_API, seed=7, dtype=np.float64)
    ref = qt.createQureg(N_API, qt.createQuESTEnv(num_devices=1))
    with qt.gateFusion(ref):
        _bench_gates(qt, ref, us, N_API)
    q = tq.createQureg(N_API, tq.createQuESTEnv(device="cpu"))
    items = []
    with tq.gateFusion(q):
        _bench_gates(tq, q, us, N_API)
        items = list(q._fusion.gates)
    np.testing.assert_allclose(_amps(q), _amps(ref), rtol=0, atol=TOL)
    assert abs(tq.calcProbOfOutcome(q, N_API - 1, 0)
               - qt.calcProbOfOutcome(ref, N_API - 1, 0)) <= TOL
    assert abs(tq.calcTotalProb(q) - 1.0) <= 1e-12
    # the drained program holds the paged planner's passes
    st = fusion.program_stats(fusion.plan_items(items, N_API, device="cpu"))
    assert st["fused"] + st["swapfused"] > 0
    assert st.get("winfused", 0) == 0


@pytest.mark.usefixtures("double")
def test_flipping_qt_planner_between_drains_replans(monkeypatch):
    us = TM.bench_unitaries(N_API, 2, seed=3, dtype=np.float64)
    env = tq.createQuESTEnv(device="cpu")
    programs = {}
    amps = {}
    for planner in ("paged", "windowed"):
        monkeypatch.setenv("QT_PLANNER", planner)
        q = tq.createQureg(N_API, env)
        with tq.gateFusion(q):
            _bench_gates(tq, q, us, N_API)
            items = list(q._fusion.gates)
        programs[planner] = fusion.program_stats(
            fusion.plan_items(items, N_API, device="cpu"))
        amps[planner] = _amps(q)
    assert programs["paged"]["fused"] + programs["paged"]["swapfused"] > 0
    assert programs["paged"].get("winfused", 0) == 0
    assert programs["windowed"]["winfused"] > 0
    assert programs["windowed"]["fused"] == 0
    np.testing.assert_allclose(amps["paged"], amps["windowed"], rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# The QFT's low layers under QT_PLANNER=paged
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _qft_pair(n, density, seed):
    """(port register, reference register) holding the same random state
    (a random mixed state for a density register)."""
    rng = np.random.default_rng(seed)
    if density:
        arr = oracle.random_density(n, rng)
        flat = arr.T.ravel()
        q = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"))
        r = qt.createDensityQureg(n, _ref_env())
    else:
        arr = oracle.random_state(n, rng)
        flat = arr
        q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
        r = qt.createQureg(n, _ref_env())
    q.amps = torch.from_numpy(np.stack([flat.real, flat.imag]).copy())
    oracle.set_qureg_from_array(qt, r, arr)
    return q, r


def _qft(m, reg, qubits):
    if qubits is None:
        m.applyFullQFT(reg)
    else:
        m.applyQFT(reg, qubits)


# (label, qubits of the register, density, QFT qubits or None for all,
# the reference's planner): the fused route's dense low layers go through
# plan_circuit; on a density register their bra twins sit at bits
# n..2n-1, which the paged planner relocates into its window.  At 8
# density qubits the paged plan holds the bra's widest layer (bits 8..14)
# as a 7-qubit `apply` op, which the reference's XLA takes minutes to
# compile on the CPU: there the reference runs windowed (the same
# operator) and the port's paged plan is held against plan_circuit_py.
_PAGED_QFT_CASES = [
    ("sv_full_16", 16, False, None, "paged"),
    ("sv_low_run_15", 15, False, list(range(0, 9)), "paged"),
    ("sv_high_run_16", 16, False, list(range(7, 16)), "paged"),
    ("rho_full_7", 7, True, None, "paged"),
    ("rho_full_8", 8, True, None, "windowed"),
    ("rho_high_run_8", 8, True, [7], "paged"),
]


def test_qft_bra_layers_paged_plan_matches_reference():
    """The dense layers of an 8-qubit density register's full QFT (ket
    bits 0..6, bra bits 8..14) planned by the paged planner: the plan
    the reference's plan_circuit_py gives, its `apply` op included."""
    gates = [(tuple(range(sh, sh + qq + 1)),
              C._qft_layer_dense(qq, sh > 0, np.float64))
             for sh in (0, 8) for qq in range(6, -1, -1)]
    mine = C.plan_circuit([C.Gate(t, m) for t, m in gates], 16,
                          planner="paged", device="cpu")
    ref = RC.plan_circuit_py([RC.Gate(t, m) for t, m in gates], 16)
    assert [op[0] for op in mine] == ["fused", "apply", "fused"]
    _assert_same_plan(mine, ref)


@pytest.mark.usefixtures("double")
@pytest.mark.parametrize("label,n,density,qubits,ref_planner",
                         _PAGED_QFT_CASES,
                         ids=[c[0] for c in _PAGED_QFT_CASES])
def test_qft_under_paged_planner_matches_reference_and_windowed(
        label, n, density, qubits, ref_planner, monkeypatch):
    passes = {"fused": 0}

    def counted(fn):
        def wrapper(*args, **kwargs):
            passes["fused"] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("apply_cluster_stack", "apply_swap_cluster_stack"):
        monkeypatch.setattr(fused, name, counted(getattr(fused, name)))
    got = {}
    for planner in ("paged", "windowed"):
        monkeypatch.setenv("QT_PLANNER", planner)
        q, r = _qft_pair(n, density, seed=len(label) + n)
        _qft(tq, q, qubits)
        got[planner] = _amps(q)
        if planner == "paged":
            # the low layers ran as the paged planner's cluster passes
            assert passes["fused"] > 0
            passes["fused"] = 0
        if planner == ref_planner:
            _qft(qt, r, qubits)
            np.testing.assert_allclose(got["paged"], _amps(r), rtol=0,
                                       atol=TOL)
    assert passes["fused"] == 0
    np.testing.assert_allclose(got["paged"], got["windowed"], rtol=0,
                               atol=TOL)
