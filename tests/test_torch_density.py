"""The density-matrix channels and read-outs of quest_tpu_torch against
quest_tpu's and the dense Kraus oracle (tests/oracle.py), on the CPU at
float64.

* Every function of ops/density.py, at n = 3, 4, 5 (2n below
  kernels._BIG_N: the interleaved-view form of _pair_channel) and n = 7
  (2n = 14: its bit-indicator form), against the reference function on
  the same array and against the oracle; the helpers _split2, bit_2d and
  _flip_bits_flat of ops/kernels.py against the reference's.
* Every mix* API call, eager, against the reference's API and the oracle.
* The four read-outs: calcPurity, calcFidelity (density matrix and state
  vector), calcHilbertSchmidtDistance, calcDensityInnerProduct.
* The validation errors, with the reference's messages, for each invalid
  probability, Kraus map and register type.
* Channels under gateFusion, interleaved with gates, equal to the eager
  path, as the reference's tests/test_fusion.py:280-324 holds its own.
* The slice as a whole: bench.py config 4 at n = 5 (its CPU size), two
  noise layers, calcFidelity in both packages, fused and eager.

Tolerances: 1e-10 against the reference and the oracle (float64 sums of a
few products of order-1 values), 1e-12 between the port's own fused and
eager routes (the same arithmetic in another grouping of passes).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu.ops import density as RD
from quest_tpu.ops import kernels as RK
from quest_tpu_torch import fusion, precision
from quest_tpu_torch.models import noise as TN
from quest_tpu_torch.ops import density as D
from quest_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run (its
    spinning worker threads starve the other test processes)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


TOL = 1e-10
FTOL = 1e-12


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _port_env():
    return tq.createQuESTEnv(device="cpu")


def _flat(rho):
    """rho[r, c] -> SoA (2, dim^2), flat[r + c * dim] (column-major)."""
    f = rho.T.ravel()
    return np.ascontiguousarray(np.stack([f.real, f.imag]))


def _dense(amps, n):
    a = np.asarray(amps).reshape(2, -1)
    dim = 1 << n
    return (a[0] + 1j * a[1]).reshape(dim, dim).T


def _rho(n, seed):
    return oracle.random_density(n, np.random.default_rng(seed))


def _pair(n, seed):
    """(port register, reference register, oracle matrix) holding the
    same random mixed state."""
    arr = _rho(n, seed)
    q = tq.createDensityQureg(n, _port_env())
    r = qt.createDensityQureg(n, _ref_env())
    q.amps = torch.from_numpy(_flat(arr))
    oracle.set_qureg_from_array(qt, r, arr)
    return q, r, arr


def _ref_of(r):
    return np.asarray(r.amps).reshape(2, -1)


X, Y, Z = oracle.X, oracle.Y, oracle.Z


# ---------------------------------------------------------------------------
# ops/kernels.py helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 14, 15])
def test_split2_and_bit_2d_match_reference(n):
    assert K._split2(n) == RK._split2(n)
    for q in range(n):
        got = K.bit_2d(n, q, "cpu").numpy()
        want = np.asarray(RK.bit_2d(n, q))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,targets", [(6, (0, 3)), (10, (2, 7, 9)),
                                       (14, (0, 6, 13)), (15, (1, 8, 14))])
def test_flip_bits_flat_matches_reference(n, targets):
    x = np.random.default_rng(n).standard_normal((2, 1 << n))
    got = K._flip_bits_flat(torch.from_numpy(x), n, targets).numpy()
    want = np.asarray(RK._flip_bits_flat(jnp.asarray(x), n, targets))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ops/density.py against the reference and the oracle
# ---------------------------------------------------------------------------

NS = [3, 4, 5, 7]


def _run_both(name, n, arr, **kw):
    x = _flat(arr)
    got = getattr(D, name)(torch.from_numpy(x.copy()), **kw).numpy()
    want = np.asarray(getattr(RD, name)(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    return got


def _kraus_of(kind, p):
    if kind == "depol":
        return D.depolarising_kraus(p)
    if kind == "damping":
        return D.damping_kraus(p)
    return [math.sqrt(1 - p) * np.eye(2), math.sqrt(p) * Z]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name,kind", [("mix_depolarising", "depol"),
                                       ("mix_damping", "damping"),
                                       ("mix_dephasing", "dephase")])
def test_one_qubit_channels(n, name, kind):
    arr = _rho(n, n)
    for t, p in ((0, 0.1), (n - 1, 0.3), (n // 2, 0.45)):
        got = _run_both(name, n, arr, num_qubits=n, target=t, prob=p)
        want = oracle.apply_kraus_to_density(arr, n, [t], _kraus_of(kind, p))
        np.testing.assert_allclose(_dense(got, n), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ["depol", "damping"])
def test_apply_pair_channel_explicit_bits(n, kind):
    """The drain's per-channel form at explicit bit positions, both
    sides of kernels._BIG_N."""
    arr = _rho(n, 20 + n)
    x = _flat(arr)
    for t in (0, n - 1):
        got = D.apply_pair_channel(torch.from_numpy(x.copy()), kind, 0.2,
                                   nn=2 * n, t=t, b=t + n).numpy()
        want = np.asarray(RD.apply_pair_channel(jnp.asarray(x), kind, 0.2,
                                                nn=2 * n, t=t, b=t + n))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", NS)
def test_two_qubit_channels(n):
    arr = _rho(n, 40 + n)
    q1, q2 = 0, n - 1
    got = _run_both("mix_two_qubit_dephasing", n, arr, num_qubits=n,
                    qubit1=q1, qubit2=q2, prob=0.3)
    zz = [np.kron(a, b) for a in (np.eye(2), Z) for b in (np.eye(2), Z)]
    ops = [math.sqrt(0.7) * zz[0]] + [math.sqrt(0.1) * m for m in zz[1:]]
    want = oracle.apply_kraus_to_density(arr, n, [q1, q2], ops)
    np.testing.assert_allclose(_dense(got, n), want, rtol=0, atol=TOL)
    got = _run_both("mix_two_qubit_depolarising", n, arr, num_qubits=n,
                    qubit1=q2, qubit2=q1, prob=0.4)
    want = oracle.apply_kraus_to_density(
        arr, n, [q2, q1], D.two_qubit_depolarising_kraus(0.4))
    np.testing.assert_allclose(_dense(got, n), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("targets", [(0,), (1, 0)])
def test_apply_kraus_map(n, targets):
    rng = np.random.default_rng(60 + n)
    ops = oracle.random_kraus_map(len(targets), 3, rng)
    arr = _rho(n, 61 + n)
    got = _run_both("apply_kraus_map", n, arr, kraus_ops=ops, num_qubits=n,
                    targets=targets)
    want = oracle.apply_kraus_to_density(arr, n, list(targets), ops)
    np.testing.assert_allclose(_dense(got, n), want, rtol=0, atol=TOL)


def test_kraus_builders_and_superoperator_match_reference():
    for port, ref, args in ((D.depolarising_kraus, RD.depolarising_kraus,
                             (0.2,)),
                            (D.damping_kraus, RD.damping_kraus, (0.3,)),
                            (D.pauli_kraus, RD.pauli_kraus, (0.1, 0.2, 0.05)),
                            (D.two_qubit_depolarising_kraus,
                             RD.two_qubit_depolarising_kraus, (0.5,))):
        got, want = port(*args), ref(*args)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(D.superoperator_from_kraus(got),
                                      RD.superoperator_from_kraus(want))
    assert D.kraus_targets((2, 0), 5) == RD.kraus_targets((2, 0), 5)


@pytest.mark.parametrize("n", [3, 7])
def test_mix_density_matrix(n):
    a, b = _rho(n, 1), _rho(n, 2)
    got = D.mix_density_matrix(torch.from_numpy(_flat(a)),
                               torch.from_numpy(_flat(b)), 0.3).numpy()
    want = np.asarray(RD.mix_density_matrix(jnp.asarray(_flat(a)),
                                            jnp.asarray(_flat(b)), 0.3))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(_dense(got, n), 0.7 * a + 0.3 * b, rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# The mix* API, eager
# ---------------------------------------------------------------------------

_RNG_KRAUS = np.random.default_rng(99)
_K1 = oracle.random_kraus_map(1, 3, _RNG_KRAUS)
_K2 = oracle.random_kraus_map(2, 5, _RNG_KRAUS)
_K3 = oracle.random_kraus_map(3, 2, _RNG_KRAUS)

API_CALLS = {
    "mixDephasing": ((1, 0.3), lambda n: ([1], [
        math.sqrt(0.7) * np.eye(2), math.sqrt(0.3) * Z])),
    "mixTwoQubitDephasing": ((0, 2, 0.6), None),
    "mixDepolarising": ((2, 0.5), lambda n: ([2], D.depolarising_kraus(0.5))),
    "mixDamping": ((0, 0.7), lambda n: ([0], D.damping_kraus(0.7))),
    "mixTwoQubitDepolarising": ((2, 1, 0.8), lambda n: (
        [2, 1], D.two_qubit_depolarising_kraus(0.8))),
    "mixPauli": ((1, 0.1, 0.2, 0.15), lambda n: (
        [1], D.pauli_kraus(0.1, 0.2, 0.15))),
    "mixKrausMap": ((2, _K1), lambda n: ([2], _K1)),
    "mixTwoQubitKrausMap": ((1, 0, _K2), lambda n: ([1, 0], _K2)),
    "mixMultiQubitKrausMap": (([0, 2, 1], _K3), lambda n: ([0, 2, 1], _K3)),
}


@pytest.mark.parametrize("n", [3, 5, 7])
@pytest.mark.parametrize("name", sorted(API_CALLS))
def test_mix_api_matches_reference_and_oracle(n, name):
    args, oracle_of = API_CALLS[name]
    q, r, arr = _pair(n, 7 + n)
    getattr(tq, name)(q, *args)
    getattr(qt, name)(r, *args)
    got = q.amps.numpy()
    np.testing.assert_allclose(got, _ref_of(r), rtol=0, atol=TOL)
    if oracle_of is not None:
        targets, ops = oracle_of(n)
        want = oracle.apply_kraus_to_density(arr, n, targets, ops)
        np.testing.assert_allclose(_dense(got, n), want, rtol=0, atol=TOL)


def test_mix_density_matrix_api():
    q, r, arr = _pair(4, 3)
    q2, r2, arr2 = _pair(4, 4)
    tq.mixDensityMatrix(q, 0.25, q2)
    qt.mixDensityMatrix(r, 0.25, r2)
    np.testing.assert_allclose(q.amps.numpy(), _ref_of(r), rtol=0, atol=TOL)
    np.testing.assert_allclose(_dense(q.amps, 4), 0.75 * arr + 0.25 * arr2,
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Read-outs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 5])
def test_density_readouts(n):
    q1, r1, a1 = _pair(n, 30 + n)
    q2, r2, a2 = _pair(n, 40 + n)
    pairs = (
        (tq.calcPurity(q1), qt.calcPurity(r1),
         np.trace(a1 @ a1).real),
        (tq.calcDensityInnerProduct(q1, q2),
         qt.calcDensityInnerProduct(r1, r2),
         np.trace(a1.conj().T @ a2).real),
        (tq.calcHilbertSchmidtDistance(q1, q2),
         qt.calcHilbertSchmidtDistance(r1, r2),
         np.sqrt(np.sum(np.abs(a1 - a2) ** 2))))
    for got, ref, want in pairs:
        assert abs(got - ref) < TOL
        assert abs(got - want) < TOL
    psi = oracle.random_state(n, np.random.default_rng(n))
    p = tq.createQureg(n, _port_env())
    p.amps = torch.from_numpy(np.stack([psi.real, psi.imag]).copy())
    rp = qt.createQureg(n, _ref_env())
    oracle.set_qureg_from_array(qt, rp, psi)
    got, ref = tq.calcFidelity(q1, p), qt.calcFidelity(r1, rp)
    want = np.vdot(psi, a1 @ psi).real
    assert abs(got - ref) < TOL and abs(got - want) < TOL
    # a state vector against a pure state: |<psi|phi>|^2
    phi = oracle.random_state(n, np.random.default_rng(n + 1))
    f = tq.createQureg(n, _port_env())
    f.amps = torch.from_numpy(np.stack([phi.real, phi.imag]).copy())
    rf = qt.createQureg(n, _ref_env())
    oracle.set_qureg_from_array(qt, rf, phi)
    got, ref = tq.calcFidelity(f, p), qt.calcFidelity(rf, rp)
    assert abs(got - ref) < TOL
    assert abs(got - abs(np.vdot(phi, psi)) ** 2) < TOL


# ---------------------------------------------------------------------------
# Validation: the reference's messages
# ---------------------------------------------------------------------------

_NOT_CPTP = [np.eye(2), np.eye(2)]

INVALID = [
    ("mixDephasing", (0, -0.1)), ("mixDephasing", (0, 0.6)),
    ("mixTwoQubitDephasing", (0, 1, 0.8)),
    ("mixTwoQubitDephasing", (0, 0, 0.1)),
    ("mixDepolarising", (0, 0.8)), ("mixDepolarising", (0, 1.2)),
    ("mixDepolarising", (5, 0.1)),
    ("mixDamping", (0, 1.5)), ("mixDamping", (0, -0.2)),
    ("mixTwoQubitDepolarising", (0, 1, 0.95)),
    ("mixPauli", (0, 0.3, 0.3, 0.3)), ("mixPauli", (0, -0.1, 0.0, 0.0)),
    ("mixKrausMap", (0, _NOT_CPTP)), ("mixKrausMap", (0, [])),
    ("mixKrausMap", (0, [np.eye(2)] * 5)),
    ("mixKrausMap", (0, [np.eye(4)])),
    ("mixTwoQubitKrausMap", (0, 1, [np.eye(2)])),
    ("mixTwoQubitKrausMap", (0, 1, [np.eye(4)] * 17)),
    ("mixMultiQubitKrausMap", ([0, 1, 2], [2 * np.eye(8)])),
    ("mixMultiQubitKrausMap", ([0, 0], [np.eye(4)])),
]


def _errors(fn_port, fn_ref):
    with pytest.raises(tq.QuESTError) as ep:
        fn_port()
    with pytest.raises(qt.QuESTError) as er:
        fn_ref()
    return str(ep.value), str(er.value)


@pytest.mark.parametrize("name,args", INVALID,
                         ids=[f"{n}-{i}" for i, (n, _a) in
                              enumerate(INVALID)])
def test_invalid_channel_arguments_raise_the_references_message(name, args):
    q = tq.createDensityQureg(3, _port_env())
    r = qt.createDensityQureg(3, _ref_env())
    got, want = _errors(lambda: getattr(tq, name)(q, *args),
                        lambda: getattr(qt, name)(r, *args))
    assert got == want


@pytest.mark.parametrize("name,args", [
    ("mixDepolarising", (0, 0.1)), ("mixDamping", (0, 0.1)),
    ("mixDephasing", (0, 0.1)), ("mixPauli", (0, 0.1, 0.1, 0.1)),
    ("mixKrausMap", (0, _K1)), ("mixTwoQubitDepolarising", (0, 1, 0.1))])
def test_channels_on_a_state_vector_raise(name, args):
    q = tq.createQureg(3, _port_env())
    r = qt.createQureg(3, _ref_env())
    got, want = _errors(lambda: getattr(tq, name)(q, *args),
                        lambda: getattr(qt, name)(r, *args))
    assert got == want and "density matrices" in got


def test_readout_register_checks_raise_the_references_message():
    qd = tq.createDensityQureg(3, _port_env())
    rd = qt.createDensityQureg(3, _ref_env())
    qs = tq.createQureg(3, _port_env())
    rs = qt.createQureg(3, _ref_env())
    q4 = tq.createDensityQureg(4, _port_env())
    r4 = qt.createDensityQureg(4, _ref_env())
    cases = [
        (lambda: tq.calcFidelity(qd, qd), lambda: qt.calcFidelity(rd, rd)),
        (lambda: tq.calcPurity(qs), lambda: qt.calcPurity(rs)),
        (lambda: tq.calcDensityInnerProduct(qd, q4),
         lambda: qt.calcDensityInnerProduct(rd, r4)),
        (lambda: tq.calcHilbertSchmidtDistance(qd, qs),
         lambda: qt.calcHilbertSchmidtDistance(rd, rs)),
        (lambda: tq.mixDensityMatrix(qd, 1.5, qd),
         lambda: qt.mixDensityMatrix(rd, 1.5, rd)),
        (lambda: tq.mixDensityMatrix(qd, 0.5, q4),
         lambda: qt.mixDensityMatrix(rd, 0.5, r4)),
    ]
    for port, ref in cases:
        got, want = _errors(port, ref)
        assert got == want


# ---------------------------------------------------------------------------
# Channels under gateFusion
# ---------------------------------------------------------------------------


def _interleaved_program(api, r, n):
    api.hadamard(r, 0)
    api.mixDepolarising(r, 1, 0.1)
    api.controlledNot(r, 0, 2)
    api.mixDamping(r, 0, 0.2)
    api.mixDephasing(r, 2, 0.15)
    api.rotateY(r, 1, 0.4)
    api.mixTwoQubitKrausMap(r, 1, 2, _K2)
    api.mixDepolarising(r, n - 1, 0.05)
    api.mixPauli(r, 0, 0.05, 0.1, 0.02)
    api.controlledNot(r, 2, 1)
    api.mixTwoQubitDepolarising(r, 0, n - 1, 0.3)


@pytest.mark.parametrize("n", [4, 7])
def test_channels_interleave_with_gates_under_fusion(n):
    fused = tq.createDensityQureg(n, _port_env())
    tq.initPlusState(fused)
    with tq.gateFusion(fused):
        _interleaved_program(tq, fused, n)
        assert any(isinstance(g, fusion.ChannelItem)
                   for g in fused._fusion.gates)
    eager = tq.createDensityQureg(n, _port_env())
    tq.initPlusState(eager)
    _interleaved_program(tq, eager, n)
    np.testing.assert_allclose(fused.amps.numpy(), eager.amps.numpy(),
                               rtol=0, atol=FTOL)
    ref = qt.createDensityQureg(n, _ref_env())
    qt.initPlusState(ref)
    with qt.gateFusion(ref):
        _interleaved_program(qt, ref, n)
    np.testing.assert_allclose(fused.amps.numpy(), _ref_of(ref), rtol=0,
                               atol=TOL)


def test_fused_channels_against_the_oracle():
    n = 3
    q, _r, arr = _pair(n, 11)
    with tq.gateFusion(q):
        tq.mixDepolarising(q, 2, 0.3)
        tq.mixDamping(q, 1, 0.4)
    want = (0.7 * arr + 0.1 * sum(
        oracle.full_operator(n, [2], P) @ arr @ oracle.full_operator(
            n, [2], P) for P in (X, Y, Z)))
    want = oracle.apply_kraus_to_density(want, n, [1], D.damping_kraus(0.4))
    np.testing.assert_allclose(_dense(q.amps, n), want, rtol=0, atol=TOL)


def test_channel_probability_is_not_part_of_the_plan():
    """The same channels with new probabilities plan to the same program
    (the plan cache hits) and run with the new probabilities."""
    n = 3
    results = []
    for p in (0.1, 0.25):
        q = tq.createDensityQureg(n, _port_env())
        tq.initPlusState(q)
        tq.startGateFusion(q)
        tq.hadamard(q, 1)
        tq.mixDepolarising(q, 0, p)
        tq.mixDamping(q, 1, p)
        items = list(q._fusion.gates)
        key = fusion._plan_key(items, 2 * n, False)
        assert ("chan", "depol", 0, 3) in key[-1]
        results.append((key, q.amps.numpy().copy()))
        tq.stopGateFusion(q)
    assert results[0][0] == results[1][0]
    q = tq.createDensityQureg(n, _port_env())
    tq.initPlusState(q)
    tq.hadamard(q, 1)
    tq.mixDepolarising(q, 0, 0.25)
    tq.mixDamping(q, 1, 0.25)
    np.testing.assert_allclose(results[1][1], q.amps.numpy(), rtol=0,
                               atol=FTOL)


def test_optimizer_merges_gates_only_across_disjoint_channels():
    """A gate looks back past a channel only when their supports are
    disjoint: two H on qubit 2 around a channel on qubit 0 merge (a
    matmul), around a channel on qubit 2 they stay apart."""
    from quest_tpu_torch import optimizer as O

    h = np.stack([np.array([[1, 1], [1, -1]]) / np.sqrt(2), np.zeros((2, 2))])
    from quest_tpu_torch import circuit as C

    disjoint = [C.Gate((2,), h), fusion.ChannelItem("depol", 0, 4, 0.1),
                C.Gate((2,), h)]
    out, stats = O.optimize_items(disjoint, nloc=8)
    assert len(out) == 2 and stats["removed"]["merge"] == 1
    assert isinstance(out[1], fusion.ChannelItem)
    touching = [C.Gate((2,), h), fusion.ChannelItem("depol", 2, 6, 0.1),
                C.Gate((2,), h)]
    out, stats = O.optimize_items(touching, nloc=8)
    assert len(out) == 3 and stats["gates_out"] == 2
    # a cache hit splices in the current call's channel object
    again = [C.Gate((2,), h), fusion.ChannelItem("depol", 2, 6, 0.3),
             C.Gate((2,), h)]
    out, _ = O.optimize_items(again, nloc=8)
    assert out[1] is again[1] and out[1].prob == 0.3


# ---------------------------------------------------------------------------
# The slice as a whole: bench.py config 4 at its CPU size
# ---------------------------------------------------------------------------


def test_config4_noise_kraus_ops_match_bench_draw():
    """models/noise.bench_kraus_ops is bench.py:266-272's draw, and a
    valid CPTP map."""
    rng = np.random.default_rng(5)
    raw = rng.standard_normal((4, 4, 4)) + 1j * rng.standard_normal((4, 4, 4))
    s = sum(k.conj().T @ k for k in raw)
    w = np.linalg.inv(np.linalg.cholesky(s).conj().T)
    for a, b in zip(TN.bench_kraus_ops(), [k @ w for k in raw]):
        np.testing.assert_array_equal(a, b)
    total = sum(k.conj().T @ k for k in TN.bench_kraus_ops())
    np.testing.assert_allclose(total, np.eye(4), atol=1e-12)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_config4_two_layers_fidelity_matches_reference(fused):
    n = 5
    kops = TN.bench_kraus_ops()

    def run(api, env):
        rho = api.createDensityQureg(n, env)
        api.initPlusState(rho)
        psi = api.createQureg(n, env)
        api.initPlusState(psi)
        if fused:
            with api.gateFusion(rho):
                for _ in range(2):
                    TN.noise_layer(api, rho, n, kops)
        else:
            for _ in range(2):
                TN.noise_layer(api, rho, n, kops)
        return (api.calcFidelity(rho, psi), api.calcPurity(rho),
                api.calcTotalProb(rho), np.asarray(rho.amps))

    got = run(tq, _port_env())
    want = run(qt, _ref_env())
    for a, b in zip(got[:3], want[:3]):
        assert abs(a - b) < TOL
    assert abs(got[2] - 1.0) < TOL
    np.testing.assert_allclose(got[3], want[3].reshape(2, -1), rtol=0,
                               atol=TOL)
