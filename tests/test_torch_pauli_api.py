"""The Pauli / Hamiltonian / Trotter API of quest_tpu_torch against
quest_tpu's API and the dense oracle (tests/oracle.py with scipy's expm),
on the CPU at float64.

* Every new function at 5 qubits, on state vectors and on density
  matrices (10 state bits): multiRotateZ / multiRotatePauli and their
  multi-controlled forms (eager and under gateFusion),
  calcExpecPauliProd / Sum / Hamil, applyPauliSum / Hamil, and both
  Trotter routes (the K3 term loop and, while QASM records, the per-term
  multiRotatePauli stream) for orders 1, 2 and 4.
* The validation errors, with the reference's messages, and
  createPauliHamilFromFile on files in tmp_path.
* The slice as a whole at 12 qubits: bench.py config 5's workload cut to
  6 terms (initPlusState, calcExpecPauliHamil, applyTrotterCircuit at
  order 2, calcExpecPauliHamil, calcTotalProb) in both packages.

Tolerances: states 1e-12 absolute (the reference's own Trotter test,
tests/test_operators.py:405), energies and probabilities 1e-10.
"""

import functools

import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu_torch import interop, precision
from quest_tpu_torch.models import hamiltonians as TH

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


TOL = 1e-12
ETOL = 1e-10
N = 5


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _port_env():
    return tq.createQuESTEnv(device="cpu")


def _pair(density, n=N, rng=None):
    """(port register, reference register, oracle state) holding the same
    random state (a random mixed state for a density matrix)."""
    rng = rng or np.random.default_rng(0)
    if density:
        arr = oracle.random_density(n, rng)
        flat = arr.T.ravel()
        q = tq.createDensityQureg(n, _port_env())
        r = qt.createDensityQureg(n, _ref_env())
    else:
        arr = oracle.random_state(n, rng)
        flat = arr
        q = tq.createQureg(n, _port_env())
        r = qt.createQureg(n, _ref_env())
    q.amps = torch.from_numpy(np.stack([flat.real, flat.imag]).copy())
    oracle.set_qureg_from_array(qt, r, arr)
    return q, r, arr


def _dense(q):
    a = q.amps.numpy()
    flat = a[0] + 1j * a[1]
    if q.is_density_matrix:
        dim = 1 << q.num_qubits_represented
        return flat.reshape(dim, dim).T
    return flat


def _evolve(arr, op, density):
    return op @ arr @ op.conj().T if density else op @ arr


def _rotation(n, controls, targets, codes, angle):
    """The full operator of exp(-i angle/2 P), P = the Pauli product of
    ``codes`` on ``targets``, controlled on ``controls``."""
    p = oracle.pauli_product(len(targets), range(len(targets)), codes)
    u = scipy.linalg.expm(-0.5j * angle * p)
    return oracle.controlled_operator(n, controls, targets, u)


def _check(q, r, want):
    got = _dense(q)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, oracle.state_from_qureg(r), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

_ROTATIONS = [
    ("multiRotateZ", lambda m, q: m.multiRotateZ(q, [0, 3, 4], 0.71),
     (), (0, 3, 4), (3, 3, 3), 0.71),
    ("multiControlledMultiRotateZ",
     lambda m, q: m.multiControlledMultiRotateZ(q, [1, 2], [4, 0], -1.3),
     (1, 2), (4, 0), (3, 3), -1.3),
    ("multiRotatePauli",
     lambda m, q: m.multiRotatePauli(q, [2, 0, 4, 1], [1, 2, 3, 0], 0.52),
     (), (2, 0, 4, 1), (1, 2, 3, 0), 0.52),
    ("multiControlledMultiRotatePauli",
     lambda m, q: m.multiControlledMultiRotatePauli(
         q, [3], [0, 1, 4], [2, 1, 2], 2.2),
     (3,), (0, 1, 4), (2, 1, 2), 2.2),
]


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_rotations_match_oracle_and_reference(density, fused):
    q, r, want = _pair(density, rng=np.random.default_rng(1 + density))
    if fused:
        with tq.gateFusion(q):
            tq.hadamard(q, 2)
            for _, call, *_ in _ROTATIONS:
                call(tq, q)
    else:
        tq.hadamard(q, 2)
        for _, call, *_ in _ROTATIONS:
            call(tq, q)
    qt.hadamard(r, 2)
    for _, call, *_ in _ROTATIONS:
        call(qt, r)
    want = _evolve(want, oracle.full_operator(N, [2], oracle.H), density)
    for _, _, controls, targets, codes, angle in _ROTATIONS:
        want = _evolve(want, _rotation(N, controls, targets, codes, angle),
                       density)
    _check(q, r, want)


# ---------------------------------------------------------------------------
# Expectation values and Pauli sums
# ---------------------------------------------------------------------------


def _hamil_arrays(rng, n, terms):
    codes = rng.integers(0, 4, (terms, n))
    codes[0] = 0                                 # an all-identity term
    return codes, rng.standard_normal(terms)


@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_expectations_match_oracle_and_reference(density):
    rng = np.random.default_rng(10 + density)
    q, r, arr = _pair(density, rng=rng)
    codes, coeffs = _hamil_arrays(rng, N, 5)
    h_port = interop.pauli_hamil_from_numpy(codes, coeffs)
    h_ref = qt.createPauliHamil(N, 5)
    qt.initPauliHamil(h_ref, coeffs, codes)
    hm = oracle.pauli_sum_matrix(N, codes, coeffs)
    want = (np.trace(hm @ arr) if density else np.vdot(arr, hm @ arr)).real
    got = tq.calcExpecPauliHamil(q, h_port)
    assert abs(got - want) <= ETOL
    assert abs(got - qt.calcExpecPauliHamil(r, h_ref)) <= ETOL
    got = tq.calcExpecPauliSum(q, codes.ravel(), coeffs)
    assert abs(got - want) <= ETOL
    prod = oracle.pauli_product(N, [4, 1, 2], [2, 3, 1])
    want = (np.trace(prod @ arr) if density
            else np.vdot(arr, prod @ arr)).real
    got = tq.calcExpecPauliProd(q, [4, 1, 2], [2, 3, 1])
    assert abs(got - want) <= ETOL
    assert abs(got - qt.calcExpecPauliProd(r, [4, 1, 2], [2, 3, 1])) <= ETOL


@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_apply_pauli_sum_and_hamil_match_oracle(density):
    rng = np.random.default_rng(20 + density)
    q, r, arr = _pair(density, rng=rng)
    codes, coeffs = _hamil_arrays(rng, N, 4)
    hm = oracle.pauli_sum_matrix(N, codes, coeffs)
    make_p = tq.createDensityQureg if density else tq.createQureg
    make_r = qt.createDensityQureg if density else qt.createQureg
    out_p, out_r = make_p(N, _port_env()), make_r(N, _ref_env())
    tq.applyPauliSum(q, codes.ravel(), coeffs, out_p)
    qt.applyPauliSum(r, codes.ravel(), coeffs, out_r)
    _check(out_p, out_r, hm @ arr)                # left-multiplies rho
    h = tq.createPauliHamil(N, 4)
    tq.initPauliHamil(h, coeffs, codes)
    tq.initZeroState(out_p)
    tq.applyPauliHamil(q, h, out_p)
    np.testing.assert_allclose(_dense(out_p), hm @ arr, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Trotter circuits: the term loop (K3) and the QASM per-term stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 4])
@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_trotter_routes_match_oracle_and_reference(density, order):
    rng = np.random.default_rng(30 + 3 * density + order)
    q, r, arr = _pair(density, rng=rng)
    q2, _, _ = _pair(density, rng=np.random.default_rng(
        30 + 3 * density + order))
    codes, coeffs = _hamil_arrays(rng, N, 4)
    h = interop.pauli_hamil_from_numpy(codes, coeffs)
    h_ref = qt.createPauliHamil(N, 4)
    qt.initPauliHamil(h_ref, coeffs, codes)
    time, reps = 0.37, 2
    tq.applyTrotterCircuit(q, h, time, order, reps)
    tq.startRecordingQASM(q2)
    tq.applyTrotterCircuit(q2, h, time, order, reps)
    tq.stopRecordingQASM(q2)
    qt.applyTrotterCircuit(r, h_ref, time, order, reps)
    want = arr
    for t, fac in tq.api_ops._trotter_schedule(4, time, order, reps):
        p = oracle.pauli_sum_matrix(N, codes[t:t + 1], [1.0])
        # the all-identity term is skipped: it is only a global phase
        if codes[t].any():
            want = _evolve(want, scipy.linalg.expm(-1j * fac * coeffs[t] * p),
                           density)
    _check(q, r, want)
    np.testing.assert_allclose(_dense(q2), want, rtol=0, atol=TOL)
    assert sum("multiRotatePauli" in ln for ln in q2.qasm_log.lines) == len(
        tq.api_ops._trotter_schedule(4, time, order, reps))


def test_trotter_time_zero_is_a_noop():
    q, _, arr = _pair(False)
    h = interop.pauli_hamil_from_numpy([[1, 2, 3, 0, 1]], [0.5])
    tq.applyTrotterCircuit(q, h, 0.0, 2, 1)
    np.testing.assert_array_equal(_dense(q), arr)


# ---------------------------------------------------------------------------
# Validation, files, reports
# ---------------------------------------------------------------------------


def _message(m, fn):
    with pytest.raises(m.QuESTError) as e:
        fn(m)
    return str(e.value)


def _regs(m, env, density=False):
    make = m.createDensityQureg if density else m.createQureg
    return make(3, env)


_BAD_CALLS = [
    lambda m, e: m.createPauliHamil(0, 2),
    lambda m, e: m.createPauliHamil(3, 0),
    lambda m, e: m.initPauliHamil(m.createPauliHamil(2, 1), [1.0], [[0, 4]]),
    lambda m, e: m.multiRotateZ(_regs(m, e), [0, 0], 0.1),
    lambda m, e: m.multiRotateZ(_regs(m, e), [3], 0.1),
    lambda m, e: m.multiRotatePauli(_regs(m, e), [0, 1], [1, 5], 0.1),
    lambda m, e: m.multiControlledMultiRotateZ(_regs(m, e), [1], [1, 2],
                                               0.1),
    lambda m, e: m.multiControlledMultiRotatePauli(_regs(m, e), [0], [1],
                                                   [-1], 0.1),
    lambda m, e: m.calcExpecPauliProd(_regs(m, e), [0, 1], [3, 7]),
    lambda m, e: m.calcExpecPauliSum(_regs(m, e), [], []),
    lambda m, e: m.calcExpecPauliSum(_regs(m, e), [0, 1], [1.0]),
    lambda m, e: m.calcExpecPauliSum(_regs(m, e), [0, 1, 9], [1.0]),
    lambda m, e: m.calcExpecPauliHamil(_regs(m, e), m.createPauliHamil(2, 1)),
    lambda m, e: m.applyPauliSum(_regs(m, e), [0, 1, 2], [1.0],
                                 _regs(m, e, True)),
    lambda m, e: m.applyPauliSum(_regs(m, e), [0, 1, 2], [1.0],
                                 m.createQureg(2, e)),
    lambda m, e: m.applyPauliHamil(_regs(m, e), m.createPauliHamil(4, 1),
                                   _regs(m, e)),
    lambda m, e: m.applyTrotterCircuit(_regs(m, e), m.createPauliHamil(3, 1),
                                       0.1, 3, 1),
    lambda m, e: m.applyTrotterCircuit(_regs(m, e), m.createPauliHamil(3, 1),
                                       0.1, 2, 0),
    lambda m, e: m.applyTrotterCircuit(_regs(m, e), m.createPauliHamil(2, 1),
                                       0.1, 2, 1),
]


@pytest.mark.parametrize("case", range(len(_BAD_CALLS)))
def test_validation_messages_match_reference(case):
    call = _BAD_CALLS[case]
    got = _message(tq, lambda m: call(m, _port_env()))
    assert got == _message(qt, lambda m: call(m, _ref_env()))


_FILES = {
    "good": "0.5 1 2 3\n-1.25 0 0 3\n\n2 3 1 0\n",
    "empty": "\n",
    "no_codes": "0.5\n",
    "bad_coeff": "x 1 2 3\n",
    "bad_code": "0.5 1 5 3\n",
    "unparsed_code": "0.5 1 y 3\n",
    "short_line": "0.5 1 2 3\n1.0 1 2\n",
}


@pytest.mark.parametrize("name", sorted(_FILES))
def test_pauli_hamil_from_file_matches_reference(tmp_path, name, capsys):
    path = tmp_path / f"{name}.txt"
    path.write_text(_FILES[name])
    if name != "good":
        got = _message(tq, lambda m: m.createPauliHamilFromFile(str(path)))
        assert got == _message(
            qt, lambda m: m.createPauliHamilFromFile(str(path)))
        return
    h = tq.createPauliHamilFromFile(str(path))
    r = qt.createPauliHamilFromFile(str(path))
    assert (h.num_qubits, h.num_sum_terms) == (3, 3)
    assert h.pauli_codes.dtype == np.int32 and h.term_coeffs.dtype == float
    np.testing.assert_array_equal(h.pauli_codes, r.pauli_codes)
    np.testing.assert_array_equal(h.term_coeffs, r.term_coeffs)
    tq.reportPauliHamil(h)
    port_report = capsys.readouterr().out
    qt.reportPauliHamil(r)
    assert port_report == capsys.readouterr().out
    tq.destroyPauliHamil(h)


def test_missing_file_message_matches_reference(tmp_path):
    path = str(tmp_path / "absent.txt")
    got = _message(tq, lambda m: m.createPauliHamilFromFile(path))
    assert got == _message(qt, lambda m: m.createPauliHamilFromFile(path))


def test_qasm_records_the_rotations_as_the_reference_does():
    logs = []
    for m, env in ((tq, _port_env()), (qt, _ref_env())):
        q = m.createQureg(3, env)
        m.startRecordingQASM(q)
        m.multiRotateZ(q, [0, 2], 0.25)
        m.multiRotatePauli(q, [1, 2], [1, 2], -0.5)
        m.stopRecordingQASM(q)
        m.multiRotateZ(q, [1], 0.5)
        logs.append([ln for ln in q.qasm_log.lines if ln.startswith("//")])
    assert logs[0] == logs[1] and len(logs[0]) == 2


def test_interop_hamil_checks_its_shapes():
    h = interop.pauli_hamil_from_numpy(np.zeros((2, 4), np.int64), [1, 2])
    assert h.pauli_codes.dtype == np.int32 and h.num_sum_terms == 2
    with pytest.raises(ValueError):
        interop.pauli_hamil_from_numpy(np.zeros((2, 4)), [1.0])


# ---------------------------------------------------------------------------
# The slice as a whole: bench.py config 5, cut to 12 qubits and 6 terms
# ---------------------------------------------------------------------------


def test_bench_pauli_hamil_is_the_bench_draw():
    rng = np.random.default_rng(7)                 # bench.py:318-321
    coeffs, codes = TH.bench_pauli_hamil(24, 16, seed=7)
    np.testing.assert_array_equal(coeffs, rng.standard_normal(16))
    np.testing.assert_array_equal(codes, rng.integers(0, 4, size=(16, 24)))


def test_config5_workload_matches_reference():
    n, terms = 12, 6
    coeffs, codes = TH.bench_pauli_hamil(n, terms, seed=7)
    out = []
    for m, env in ((tq, _port_env()), (qt, _ref_env())):
        h = m.createPauliHamil(n, terms)
        m.initPauliHamil(h, coeffs, codes)
        q = m.createQureg(n, env)
        m.initPlusState(q)
        e0 = m.calcExpecPauliHamil(q, h)
        m.applyTrotterCircuit(q, h, 0.1, 2, 1)
        e1 = m.calcExpecPauliHamil(q, h)
        out.append((e0, e1, m.calcTotalProb(q), oracle.state_from_qureg(q)))
    (e0, e1, total, psi), (r0, r1, rtotal, rpsi) = out
    np.testing.assert_allclose(psi, rpsi, rtol=0, atol=TOL)
    assert abs(e0 - r0) <= ETOL and abs(e1 - r1) <= ETOL
    assert abs(total - rtotal) <= ETOL and abs(total - 1.0) <= ETOL
