"""The sharded composites (M15b) in the port against the JAX package on
its mesh.

The port's in-process mesh, ``tq.createQuESTEnv(devices=["cpu"] * R)``
for R = 2, 4 and 8, against the reference's
``qt.createQuESTEnv(num_devices=R)`` on the suite's 8-device CPU mesh,
at float64 unless a case says otherwise.  Each case runs one short
program of API calls through both packages on a register split over R
shards and requires:

* the amplitudes within 1e-10, read in canonical order by both (1e-6 at
  float32);
* every read within 1e-10 (measurement outcomes equal, for the same
  seeds);
* the same exchange accounting: the port's counters for the reference's
  op families (trotter, expec, pair_channel, depol2, qft, qft_runs and
  M15a's matrix_1q, swap, remap, window_remap, gather), per tier, counts
  and per-shard bytes, equal to the reference's telemetry, and the same
  eager dispatch routes.

The families cover Pauli sums and Trotter circuits (the direct body and,
with the direct cap lowered in both packages, the rotate-layer body),
the Pauli rotations, the QFT (the whole register, runs reaching mesh
bits, runs inside a shard, the density register's twin runs, the layered
path, and the multilayer route at float32 with nloc = 15), measurement,
the eager channels, the diagonal operator and the phase functions, and
the reads and writes of one and two registers, some of them carrying
live permutations from lazy relocation.  The reference's runs are
memoised per (case, R) for the module.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import oracle
import quest_tpu as qt
from quest_tpu import rng as ref_rng
from quest_tpu import telemetry as RTEL
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu.ops import paulis as RP
import quest_tpu_torch as tq
from quest_tpu_torch import interop, precision, rng
from quest_tpu_torch.ops import fused as PFU
from quest_tpu_torch.ops import measurement as M
from quest_tpu_torch.ops import paulis as PP
from quest_tpu_torch.parallel import dist as PD
from quest_tpu_torch.parallel.mesh import ShardedAmps

TOL = 1e-10
TOL32 = 1e-6
NS = 6          # state-vector qubits: nloc = 3 at R = 8
ND = 4          # density qubits: 8 state bits, nloc = 5 at R = 8
MESHES = (2, 4, 8)
SEEDS = [1234, 5678]
FAMILIES = ("matrix_1q", "swap", "remap", "window_remap", "gather",
            "trotter", "expec", "pair_channel", "depol2", "qft", "qft_runs")
ROUTES = ("perm_local", "exchange_1q", "relocalize", "default")


@pytest.fixture(autouse=True)
def _state():
    old = precision.get_precision()
    saved = (ref_rng.GLOBAL_RNG.get_state(),
             ref_measurement.KEYS.get_state(), rng.GLOBAL_RNG.get_state(),
             M.KEYS.get_state())
    tq.set_precision(2)
    PD.use_lazy_remap(True)
    PD.use_explicit_dist(True)
    yield
    tq.set_precision(old)
    qt.set_precision(2)
    PD.use_lazy_remap(True)
    PD.use_explicit_dist(True)
    ref_rng.GLOBAL_RNG.set_state(saved[0])
    ref_measurement.KEYS.set_state(saved[1])
    rng.GLOBAL_RNG.set_state(saved[2])
    M.KEYS.set_state(saved[3])


@pytest.fixture(scope="module")
def telemetry_on():
    old = RTEL.mode_name()
    RTEL.configure("on")
    yield
    RTEL.configure(old)


def _counts(mod):
    get = RTEL.counter_sum if mod is qt else PD.counter_sum
    out = {}
    for name in ("exchanges_total", "exchange_bytes_total"):
        for op in FAMILIES:
            for tier in ("ici", "dcn"):
                v = get(name, op=op, tier=tier)
                if v:
                    out[(name, op, tier)] = int(v)
    for route in ROUTES:
        v = get("dispatch_route_total", route=route)
        if v:
            out[("route", route)] = int(v)
    return out


def _initial(n, density, seed):
    rng_ = np.random.default_rng(seed)
    if density:
        flat = oracle.random_density(n, rng_).T.reshape(-1)
    else:
        flat = oracle.random_state(n, rng_)
    return np.stack([flat.real, flat.imag])


def _make(mod, env, n, density, seed):
    q = (mod.createDensityQureg if density else mod.createQureg)(n, env)
    init = _initial(n, density, seed)
    if density:
        mod.setDensityAmps(q, init[0], init[1])
    else:
        mod.initStateFromAmps(q, init[0], init[1])
    return q


def _amps(mod, q):
    if mod is qt:
        return np.asarray(q.amps)
    amps, perm = interop.register_state(q, canonical=True)
    assert perm is None
    return amps


def _flat(reads):
    out = []
    for r in reads:
        if isinstance(r, complex):
            out.extend([r.real, r.imag])
        elif isinstance(r, (list, tuple, np.ndarray)):
            out.extend(_flat(list(np.asarray(r).ravel())))
        else:
            out.append(float(r))
    return out


def _run(mod, env, case, R):
    """Run ``case`` on a fresh register of ``mod``: (canonical amps,
    reads, exchange counts)."""
    q = _make(mod, env, case.n, case.density, 5)
    mod.seedQuEST(env, SEEDS)
    if mod is qt:
        RTEL.reset()
    else:
        PD.reset_counters()
    reads = []
    case.body(mod, q, reads)
    counts = _counts(mod)
    assert mod is qt or isinstance(q._amps, ShardedAmps)
    return _amps(mod, q), np.asarray(_flat(reads)), counts


class Case:
    """A program ``body(mod, q, reads)`` on an n-qubit register; every op
    family of ``expect`` must show in its exchange counts."""

    def __init__(self, body, n, density=False, expect=()):
        self.body = body
        self.n = n
        self.density = density
        self.expect = expect


class _Memo:
    def __init__(self):
        self.cache = {}

    def __call__(self, name, R):
        key = (name, R)
        if key not in self.cache:
            env = qt.createQuESTEnv(num_devices=R)
            self.cache[key] = _run(qt, env, CASES[name], R)
        return self.cache[key]


@pytest.fixture(scope="module")
def ref(telemetry_on):
    if qt.createQuESTEnv().num_devices < 8:
        pytest.skip("needs the suite's 8-device CPU mesh")
    return _Memo()


def check(ref, name, R, tol=TOL):
    want = ref(name, R)
    got = _run(tq, tq.createQuESTEnv(devices=["cpu"] * R), CASES[name], R)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol)
    assert got[2] == want[2]
    for op in CASES[name].expect:
        assert any(k[1] == op for k in got[2]), op
    return got


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(31)
U1 = oracle.random_unitary(1, _RNG)
U2 = oracle.random_unitary(2, _RNG)


def _relocate(mod, q):
    """Leave a live permutation: a two-qubit gate on the top qubits pulls
    them into local slots without swapping back."""
    n = q.num_qubits_represented
    mod.multiQubitUnitary(q, [n - 2, n - 1], U2)
    mod.hadamard(q, 0)


def _hamil(mod, n, terms):
    h = mod.createPauliHamil(n, len(terms))
    codes = [c for _coeff, cs in terms for c in cs]
    mod.initPauliHamil(h, [c for c, _cs in terms], codes)
    return h


def _terms(n):
    """Terms over every kind of qubit: X, Y and Z on mesh and local bits,
    an all-identity term and a single-Z term."""
    rows = []
    for t in range(4):
        row = [(t + q) % 4 for q in range(n)]
        rows.append((0.3 + 0.1 * t, row))
    rows.append((0.7, [0] * n))
    rows.append((-0.4, [3] + [0] * (n - 1)))
    rows.append((0.25, [0] * (n - 1) + [1]))
    return rows


def _trotter(mod, q, reads):
    n = q.num_qubits_represented
    h = _hamil(mod, n, _terms(n))
    _relocate(mod, q)
    mod.applyTrotterCircuit(q, h, 0.7, 2, 1)
    if not q.is_density_matrix:
        reads.append(mod.calcExpecPauliHamil(q, h, None))
    mod.applyTrotterCircuit(q, h, 0.3, 1, 2)


def _expec(mod, q, reads):
    n = q.num_qubits_represented
    h = _hamil(mod, n, _terms(n))
    _relocate(mod, q)
    reads.append(mod.calcExpecPauliHamil(q, h, None))
    codes = [c for _coeff, cs in _terms(n) for c in cs]
    reads.append(mod.calcExpecPauliSum(q, codes, [c for c, _ in _terms(n)],
                                       None))
    reads.append(mod.calcExpecPauliProd(q, [0, n - 1, 1], [1, 2, 3], None))
    reads.append(mod.calcExpecPauliProd(q, [n - 2], [1], None))


def _pauli_sum(mod, q, reads):
    n = q.num_qubits_represented
    terms = _terms(n)
    out = (mod.createDensityQureg if q.is_density_matrix
           else mod.createQureg)(n, q.env)
    _relocate(mod, q)
    mod.applyPauliSum(q, [c for _co, cs in terms for c in cs],
                      [co for co, _cs in terms], out)
    h = _hamil(mod, n, terms[:3])
    mod.applyPauliHamil(out, h, q)


def _rotations(mod, q, reads):
    n = q.num_qubits_represented
    _relocate(mod, q)
    mod.multiRotateZ(q, [0, n - 1, n - 2], 0.37)
    mod.multiRotateZ(q, [n - 1], 0.21)
    mod.multiControlledMultiRotateZ(q, [n - 1], [0, 2], 0.5)
    mod.multiControlledMultiRotateZ(q, [1], [n - 1, n - 4], -0.8)
    mod.multiControlledMultiRotateZ(q, [0, n - 2], [n - 1], 1.1)
    mod.multiRotatePauli(q, [0, n - 1, n - 3], [1, 2, 3], 0.4)
    mod.multiControlledMultiRotatePauli(q, [n - 2], [1, n - 1], [2, 1],
                                        0.9)


def _qft_full(mod, q, reads):
    _relocate(mod, q)
    mod.applyFullQFT(q)
    reads.append(mod.calcProbOfOutcome(q, q.num_qubits_represented - 1, 0))


def _qft_runs(mod, q, reads):
    n = q.num_qubits_represented
    mod.applyQFT(q, list(range(7, n)))
    mod.applyQFT(q, list(range(0, n - 3)))


def _qft_density(mod, q, reads):
    mod.applyFullQFT(q)


def _qft_layered(mod, q, reads):
    n = q.num_qubits_represented
    mod.applyQFT(q, [0, 2, n - 1])
    mod.applyFullQFT(q)


def _measure(mod, q, reads):
    n = q.num_qubits_represented
    _relocate(mod, q)
    reads.append(mod.measure(q, n - 1))
    reads.extend(mod.measureWithStats(q, 0))
    p = mod.calcProbOfOutcome(q, n - 2, 1)
    reads.append(mod.collapseToOutcome(q, n - 2, 1 if p > 0.5 else 0))
    outs, probs = mod.measureSequence(q, list(range(n - 3, -1, -1)))
    reads.extend(outs)
    reads.extend(probs)


def _measure_host(mod, q, reads):
    os.environ["QT_HOST_MEASURE"] = "1"
    try:
        _measure(mod, q, reads)
    finally:
        del os.environ["QT_HOST_MEASURE"]


def _diag(mod, q, reads):
    n = q.num_qubits_represented
    op = mod.createDiagonalOp(n, q.env)
    r = np.random.default_rng(8)
    mod.initDiagonalOp(op, r.normal(size=1 << n), r.normal(size=1 << n))
    _relocate(mod, q)
    reads.append(mod.calcExpecDiagonalOp(q, op))
    mod.applyDiagonalOp(q, op)
    reads.append(mod.calcExpecDiagonalOp(q, op))


def _phase_funcs(mod, q, reads):
    n = q.num_qubits_represented
    _relocate(mod, q)
    mod.applyPhaseFunc(q, [0, n - 1], mod.UNSIGNED, [0.5, -1.0], [2.0, 1.0])
    mod.applyPhaseFuncOverrides(q, [n - 2, 1, n - 1], mod.TWOS_COMPLEMENT,
                                [0.3], [3.0], [-1, 2], [0.1, -0.2])
    mod.applyMultiVarPhaseFunc(q, [0, 1, n - 1, n - 2], [2, 2],
                               mod.UNSIGNED, [0.2, 0.4, -0.3], [1.0, 2.0,
                                                                1.0],
                               [2, 1])
    mod.applyNamedPhaseFunc(q, [0, n - 1, 1, n - 2], [2, 2], mod.UNSIGNED,
                            mod.NORM)
    mod.applyParamNamedPhaseFunc(q, [n - 1, 0, 2, n - 3], [2, 2],
                                 mod.TWOS_COMPLEMENT,
                                 mod.SCALED_INVERSE_DISTANCE, [0.6, 1.5])
    mod.applyNamedPhaseFuncOverrides(q, [n - 1, 1], [1, 1], mod.UNSIGNED,
                                     mod.PRODUCT, [1, 1], [0.9])


def _channels(mod, q, reads):
    n = q.num_qubits_represented
    for t in range(n):
        mod.hadamard(q, t)
    mod.mixDephasing(q, n - 1, 0.1)
    mod.mixDephasing(q, 0, 0.05)
    mod.mixTwoQubitDephasing(q, 0, n - 1, 0.2)
    mod.mixDepolarising(q, n - 1, 0.15)
    mod.mixDepolarising(q, 0, 0.05)
    mod.mixDamping(q, n - 1, 0.3)
    mod.mixDamping(q, 0, 0.2)
    mod.mixTwoQubitDepolarising(q, 0, n - 1, 0.1)
    mod.mixTwoQubitDepolarising(q, n - 2, n - 1, 0.05)
    mod.mixTwoQubitDepolarising(q, 0, 1, 0.07)
    other = _make(mod, q.env, n, True, 11)
    mod.mixDensityMatrix(q, 0.3, other)


def _reads_sv(mod, q, reads):
    n = q.num_qubits_represented
    other = _make(mod, q.env, n, False, 12)
    _relocate(mod, q)
    mod.multiQubitUnitary(other, [n - 3, n - 1], U2)
    reads.append(mod.calcInnerProduct(q, other))
    reads.append(mod.calcInnerProduct(other, q))
    reads.append(mod.calcFidelity(q, other))
    reads.append(mod.compareStates(q, q, 1e-12))
    reads.append(mod.compareStates(q, other, 1e-12))
    third = _make(mod, q.env, n, False, 13)
    mod.setWeightedQureg(0.3 + 0.1j, other, -0.5j, third, 0.7, q)
    mod.setWeightedQureg(1.0, q, 0.5, q, 0.25, other)
    mod.cloneQureg(third, other)
    reads.append(mod.calcInnerProduct(q, third))


def _reads_dm(mod, q, reads):
    n = q.num_qubits_represented
    other = _make(mod, q.env, n, True, 12)
    pure = _make(mod, q.env, n, False, 14)
    _relocate(mod, q)
    mod.multiQubitUnitary(other, [n - 1, 0], U2)
    reads.append(mod.calcPurity(q))
    reads.append(mod.calcDensityInnerProduct(q, other))
    reads.append(mod.calcHilbertSchmidtDistance(q, other))
    reads.append(mod.calcFidelity(q, pure))
    reads.append(mod.compareStates(q, other, 1e-12))
    mod.setWeightedQureg(0.5, other, 0.25j, q, 0.125, q)


CASES = {
    "trotter": Case(_trotter, NS, expect=("trotter", "expec")),
    "trotter_rho": Case(_trotter, ND, True, expect=("trotter",)),
    "expec": Case(_expec, NS, expect=("expec",)),
    "expec_rho": Case(_expec, ND, True),
    "pauli_sum": Case(_pauli_sum, NS),
    "pauli_sum_rho": Case(_pauli_sum, ND, True),
    "rotations": Case(_rotations, NS),
    "rotations_rho": Case(_rotations, ND, True),
    "qft_full": Case(_qft_full, 14, expect=("qft",)),
    "qft_runs": Case(_qft_runs, 14, expect=("qft_runs",)),
    "qft_local_run": Case(_qft_runs, 17, expect=("qft_runs",)),
    "qft_density": Case(_qft_density, 7, True, expect=("qft_runs",)),
    "qft_layered": Case(_qft_layered, NS),
    "qft_layered_rho": Case(_qft_layered, ND, True),
    "measure": Case(_measure, NS),
    "measure_rho": Case(_measure, ND, True),
    "measure_host": Case(_measure_host, NS),
    "diag": Case(_diag, NS),
    "diag_rho": Case(_diag, ND, True),
    "diag_tiny": Case(_diag, 2, True),
    "phase_funcs": Case(_phase_funcs, NS),
    "phase_funcs_rho": Case(_phase_funcs, ND, True),
    "channels": Case(_channels, ND, True,
                     expect=("pair_channel", "depol2")),
    "channels_tiny": Case(_channels, 2, True,
                          expect=("pair_channel", "depol2")),
    "reads": Case(_reads_sv, NS),
    "reads_rho": Case(_reads_dm, ND, True),
    "reads_tiny": Case(_reads_dm, 2, True),
    "measure_tiny": Case(_measure, 2, True),
}


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_composite_matches_reference(ref, name, R):
    check(ref, name, R)


# ---------------------------------------------------------------------------
# The rotate-layer body: the direct cap lowered in both packages
# ---------------------------------------------------------------------------


FALLBACK = {
    "trotter": Case(_trotter, 5, expect=("trotter",)),
    "trotter_rho": Case(_trotter, 3, True, expect=("trotter",)),
    "expec": Case(_expec, 5, expect=("expec",)),
}


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("name", sorted(FALLBACK))
def test_rotate_layer_body_matches_reference(ref, name, R, monkeypatch):
    """Past _DIRECT_MAX_N local bits the Pauli scans rotate each X / Y
    qubit onto Z (r exchanges per layer): the cap set to 0 in both
    packages sends every shard there (at sizes no direct case uses, so
    no compiled direct program of the reference is reused)."""
    monkeypatch.setattr(RP, "_DIRECT_MAX_N", 0)
    monkeypatch.setattr(PP, "_DIRECT_MAX_N", 0)
    key = "fallback_" + name
    CASES[key] = FALLBACK[name]
    try:
        check(ref, key, R)
    finally:
        del CASES[key]


# ---------------------------------------------------------------------------
# The multilayer QFT route per shard (K8 and K9), at float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", [2, 4])
def test_sharded_qft_multilayer_matches_reference(ref, R, monkeypatch):
    """nloc = 15: the reference runs its K8 / K9 in interpret mode on
    every shard, the port the plain versions of its K8 / K9 wrappers
    (the multilayer switch forced on for CPU tensors), counted per
    shard."""
    monkeypatch.setenv("QT_QFT_ML_INTERPRET", "1")
    real = PFU.qft_multilayer_enabled
    monkeypatch.setattr(PFU, "qft_multilayer_enabled",
                        lambda a: a.dtype == torch.float32)
    qt.set_precision(1)
    tq.set_precision(1)
    n = 15 + (R.bit_length() - 1)
    key = f"qft_ml_{n}"
    CASES[key] = Case(_qft_full, n, expect=("qft",))
    calls = {"hi": 0, "cluster": 0}
    hi, cl = PFU.apply_qft_multi_hi, PFU.apply_qft_cluster_multi

    def count_hi(*a, **k):
        calls["hi"] += 1
        return hi(*a, **k)

    def count_cl(*a, **k):
        calls["cluster"] += 1
        return cl(*a, **k)

    monkeypatch.setattr(PFU, "apply_qft_multi_hi", count_hi)
    monkeypatch.setattr(PFU, "apply_qft_cluster_multi", count_cl)
    try:
        check(ref, key, R, tol=TOL32)
    finally:
        del CASES[key]
    assert calls == {"hi": R, "cluster": R}
    assert not real(torch.zeros(2, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Reports, refusals, repairs and the explicit routes switched off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [False, True])
def test_report_state_writes_the_reference_files(ref, density, tmp_path,
                                                 monkeypatch):
    n = ND if density else NS
    outs = {}
    for name, mod, env in (
            ("ref", qt, qt.createQuESTEnv(num_devices=4)),
            ("port", tq, tq.createQuESTEnv(devices=["cpu"] * 4))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        q = _make(mod, env, n, density, 3)
        mod.reportState(q)
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.reportStateToScreen(q, env, 0)
        files = {p.name: p.read_text() for p in sorted(d.iterdir())}
        outs[name] = (files, buf.getvalue())
    assert sorted(outs["port"][0]) == [f"state_rank_{s}.csv"
                                       for s in range(4)]
    assert outs["port"] == outs["ref"]


def _dm_pair(R):
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    return _make(tq, env, ND, True, 1), _make(tq, env, ND, True, 2)


def test_hilbert_schmidt_distance_of_sharded_registers(ref):
    """The parent handed two ShardedAmps to the one-register form, which
    raised TypeError (ShardedAmps - ShardedAmps); now the per-shard
    partials sum to the reference's distance."""
    a, b = _dm_pair(4)
    env = qt.createQuESTEnv(num_devices=4)
    want = qt.calcHilbertSchmidtDistance(_make(qt, env, ND, True, 1),
                                         _make(qt, env, ND, True, 2))
    assert abs(tq.calcHilbertSchmidtDistance(a, b) - want) < TOL


@pytest.mark.parametrize("op", ["sub", "rsub", "add", "mul", "matmul",
                                "neg", "abs", "truediv"])
def test_sharded_amps_arithmetic_refuses(op):
    a, b = _dm_pair(4)
    x, y = a.amps, b.amps
    do = {"sub": lambda: x - y, "rsub": lambda: 1.0 - x,
          "add": lambda: x + y, "mul": lambda: 2.0 * x,
          "matmul": lambda: x @ y, "neg": lambda: -x, "abs": lambda: abs(x),
          "truediv": lambda: x / 2.0}[op]
    with pytest.raises(tq.QuESTError,
                       match=r"register_state\(qureg, canonical=True\)"):
        do()


@pytest.mark.parametrize("name", ["trotter", "qft_runs", "channels",
                                  "diag_rho"])
def test_explicit_routes_off_take_the_default_route(ref, name, monkeypatch):
    """With use_explicit_dist(False) in both packages the composites that
    have an explicit form gather, run the one-register op and split (the
    reference leaves them to GSPMD): the same state."""
    import quest_tpu.parallel.dist as RD

    RD.use_explicit_dist(False)
    PD.use_explicit_dist(False)
    try:
        want = _run(qt, qt.createQuESTEnv(num_devices=4), CASES[name], 4)
        got = _run(tq, tq.createQuESTEnv(devices=["cpu"] * 4), CASES[name],
                   4)
    finally:
        RD.use_explicit_dist(True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)


def test_a_failing_composite_marks_the_register_lost(monkeypatch):
    """A transport failure inside a sharded composite is not retried: the
    register is lost and every later read raises ShardLossError."""
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0")
    env = tq.createQuESTEnv(devices=["cpu"] * 4)
    q = _make(tq, env, 14, False, 1)
    calls = {"n": 0}
    real = env.mesh.permute

    def failing(sends, pairs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("link down")
        return real(sends, pairs)

    monkeypatch.setattr(env.mesh, "permute", failing)
    with pytest.raises(PD.ShardLossError) as e:
        tq.applyFullQFT(q)
    assert e.value.op == "qft" and calls["n"] == 2
    with pytest.raises(PD.ShardLossError):
        tq.calcTotalProb(q)
