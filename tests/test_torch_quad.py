"""Quad precision (set_precision(4)) in the port against the JAX package.

* The precision table: float64 storage, REAL_EPS 1e-14, validation at the
  float64 tolerance, the 2^27 message cap, the reference's ValueError.
* The double-double reductions (``neumaier_sum``, ``quad_sum``,
  ``quad_sum2``) on the reference's own constructions
  (tests/test_precision.py): the 1e16 cross-block case, ``_cancel_vec``
  through the Pauli-sum scan and the API, fidelity, the density inner
  product and the diagonal expectation, each of which plain float64 loses
  and quad keeps.
* Every quad read-out against the reference's at float64 within 1e-13 on
  random states (the two sum the same products in another order; both
  are double-double accurate, so they agree to a few float64 ulps).
* K4 is not taken at quad (the reference's ``use_pl = not quad``): the
  Pauli-sum scan runs the gather form, and a measurement at quad takes
  its probability in double-double.
"""

import functools

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import precision as ref_precision
from quest_tpu import rng as ref_rng
from quest_tpu.ops import calculations as RC
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu_torch import precision, rng
from quest_tpu_torch.ops import calculations as C
from quest_tpu_torch.ops import measurement as M
from quest_tpu_torch.ops import paulis as P

import jax.numpy as jnp

TOL = 1e-13
_A = 2.0 ** 53      # ulp(256 A) = 512: unit terms vanish mid-cancellation


@pytest.fixture(autouse=True)
def quad():
    old, old_ref = precision.get_precision(), ref_precision.get_precision()
    tq.set_precision(4)
    qt.set_precision(4)
    yield
    tq.set_precision(old)
    qt.set_precision(old_ref)


@pytest.fixture(autouse=True)
def _keep_streams():
    saved = (ref_rng.GLOBAL_RNG.get_state(),
             ref_measurement.KEYS.get_state(), rng.GLOBAL_RNG.get_state(),
             M.KEYS.get_state())
    yield
    ref_rng.GLOBAL_RNG.set_state(saved[0])
    ref_measurement.KEYS.set_state(saved[1])
    rng.GLOBAL_RNG.set_state(saved[2])
    M.KEYS.set_state(saved[3])


def _envs():
    return qt.createQuESTEnv(num_devices=1), tq.createQuESTEnv(device="cpu")


def _cancel_vec():
    """The reference's (2, 1024) construction [+A x256][0][+1 x256][+A
    x256], whose unit block a plain float64 reduce loses."""
    v = np.zeros((2, 1024))
    v[0, 0:256] = _A
    v[0, 512:768] = 1.0
    v[0, 768:1024] = _A
    return v


def test_precision_table():
    assert precision.get_precision() == 4
    assert precision.real_eps() == 1e-14
    assert precision.validation_eps() == 1e-13
    assert precision.max_amps_in_msg() == 1 << 27
    assert precision.real_dtype() == torch.float64
    assert precision.complex_dtype() == torch.complex128


@pytest.mark.parametrize("bad", [0, 3, 5])
def test_invalid_precision_message_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        qt.set_precision(bad)
    with pytest.raises(ValueError) as port:
        tq.set_precision(bad)
    assert str(port.value) == str(ref.value)


def test_quad_sum_survives_cross_block_cancellation():
    B = C._QUAD_BLOCK
    v = np.zeros(4 * B)
    v[0], v[B], v[2 * B], v[3 * B] = 1e16, 1.0, -1e16, 1e-3
    got = C.quad_sum(torch.as_tensor(v))
    assert got == pytest.approx(1.0 + 1e-3, abs=1e-12)
    assert got == float(RC.quad_sum(jnp.asarray(v)))


@pytest.mark.parametrize("size", [7, 256, 1 << 12, 1 << 17])
def test_quad_sum_blocks_match_reference(size):
    """One block, 256 blocks, and a second level above 256 blocks: the
    same partials, the same Neumaier steps."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal(size) * 10.0 ** rng.integers(-8, 8, size)
    got = C.quad_sum(torch.as_tensor(x))
    assert abs(got - float(RC.quad_sum(jnp.asarray(x)))) <= TOL * max(
        1.0, np.abs(x).sum())


def test_neumaier_sum_is_the_reference_scan():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(200) * 10.0 ** rng.integers(-12, 12, 200)
    assert C.neumaier_sum(torch.as_tensor(vals)) == float(
        RC.neumaier_sum(jnp.asarray(vals)))


def test_quad_sum2_keeps_channels_apart():
    x = np.full(512, _A)
    y = np.ones(512)
    x[256:] = -_A
    assert C.quad_sum2(torch.as_tensor(x), torch.as_tensor(y)) == 512.0


def test_expec_pauli_scan_cross_block_cancellation():
    n = 10
    amps = torch.as_tensor(_cancel_vec())
    codes = np.zeros((1, n), np.int32)
    codes[0, 8] = 3
    got = float(P.expec_pauli_sum_scan(amps, codes, np.ones(1),
                                       num_qubits=n, quad=True))
    plain = float(P.expec_pauli_sum_scan(amps, codes, np.ones(1),
                                         num_qubits=n))
    assert got == pytest.approx(256.0, abs=1e-9)
    assert abs(plain - 256.0) > 100.0


def test_api_routes_quad_through_the_cancellations():
    """calcExpecPauliSum, calcFidelity, calcDensityInnerProduct and
    calcExpecDiagonalOp at precision 4 keep what float64 loses."""
    _ref, env = _envs()
    n = 10
    q = tq.createQureg(n, env)
    v = _cancel_vec()
    tq.setAmps(q, 0, v[0], v[1], 1 << n)
    assert tq.calcExpecPauliSum(q, [0] * 8 + [3] + [0] * (n - 9),
                                [1.0]) == pytest.approx(256.0, abs=1e-9)

    m = 5
    dim = 1 << m
    w = np.zeros((dim, dim))
    w[0:8, :] = _A
    w[16:24, :] = 1.0
    w[24:32, :] = -_A
    rho = tq.createDensityQureg(m, env)
    tq.setDensityAmps(rho, w.reshape(-1), np.zeros(dim * dim))
    psi = tq.createQureg(m, env)
    tq.setAmps(psi, 0, np.ones(dim), np.zeros(dim), dim)
    assert tq.calcFidelity(rho, psi) == pytest.approx(256.0, abs=1e-9)
    assert abs(float(C.calc_fidelity_density(
        rho.amps, psi.amps, num_qubits=m)) - 256.0) > 100.0

    dim2 = dim * dim
    r1, r2 = np.zeros(dim2), np.zeros(dim2)
    r1[0:256], r2[0:256] = 1.0, _A
    r1[512:768], r2[512:768] = 1.0, 1.0
    r1[768:1024], r2[768:1024] = -1.0, _A
    a = tq.createDensityQureg(m, env)
    b = tq.createDensityQureg(m, env)
    tq.setDensityAmps(a, r1, np.zeros(dim2))
    tq.setDensityAmps(b, r2, np.zeros(dim2))
    assert tq.calcDensityInnerProduct(a, b) == pytest.approx(256.0,
                                                             abs=1e-9)

    q2 = tq.createQureg(n, env)
    tq.setAmps(q2, 0, np.sqrt(np.abs(v[0])) * np.sign(v[0]),
               np.zeros(1 << n), 1 << n)
    d = tq.createDiagonalOp(n, env)
    tq.initDiagonalOp(d, 1.0 - 2.0 * (((np.arange(1 << n) >> 8) & 1)
                                      .astype(float)), np.zeros(1 << n))
    assert tq.calcExpecDiagonalOp(q2, d).real == pytest.approx(256.0,
                                                               abs=1e-9)


def _rand_sv(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _rand_rho(rng, n):
    dim = 1 << n
    m = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim,
                                                                    dim))
    r = m @ m.conj().T
    return r / np.trace(r).real


def _both(fn_name, *pairs):
    return (getattr(qt, fn_name)(*[p[0] for p in pairs]),
            getattr(tq, fn_name)(*[p[1] for p in pairs]))


def _sv_pair(envs, vec):
    r = qt.createQureg(int(np.log2(vec.size)), envs[0])
    p = tq.createQureg(int(np.log2(vec.size)), envs[1])
    qt.initStateFromAmps(r, vec.real, vec.imag)
    tq.initStateFromAmps(p, vec.real, vec.imag)
    return r, p


def _rho_pair(envs, rho):
    n = int(np.log2(rho.shape[0]))
    r = qt.createDensityQureg(n, envs[0])
    p = tq.createDensityQureg(n, envs[1])
    flat = rho.T.reshape(-1)
    qt.setDensityAmps(r, flat.real, flat.imag)
    tq.setDensityAmps(p, flat.real, flat.imag)
    return r, p


def test_state_vector_read_outs_match_reference():
    envs = _envs()
    rng = np.random.default_rng(7)
    a = _sv_pair(envs, _rand_sv(rng, 8))
    b = _sv_pair(envs, _rand_sv(rng, 8))
    ref, got = _both("calcTotalProb", a)
    assert abs(got - ref) <= TOL
    ref, got = _both("calcInnerProduct", a, b)
    assert abs(got - ref) <= TOL
    ref, got = _both("calcFidelity", a, b)
    assert abs(got - ref) <= TOL
    for t in (0, 5, 7):
        for o in (0, 1):
            ref = qt.calcProbOfOutcome(a[0], t, o)
            assert abs(tq.calcProbOfOutcome(a[1], t, o) - ref) <= TOL
    codes = rng.integers(0, 4, size=(4, 8))
    coeffs = rng.standard_normal(4)
    ref = qt.calcExpecPauliSum(a[0], codes.ravel(), coeffs)
    assert abs(tq.calcExpecPauliSum(a[1], codes.ravel(), coeffs) - ref) \
        <= TOL
    ref = qt.calcExpecPauliProd(a[0], [1, 3], [2, 1])
    assert abs(tq.calcExpecPauliProd(a[1], [1, 3], [2, 1]) - ref) <= TOL
    dr = qt.createDiagonalOp(8, envs[0])
    dp = tq.createDiagonalOp(8, envs[1])
    re, im = rng.standard_normal(256), rng.standard_normal(256)
    qt.initDiagonalOp(dr, re, im)
    tq.initDiagonalOp(dp, re, im)
    assert abs(tq.calcExpecDiagonalOp(a[1], dp)
               - qt.calcExpecDiagonalOp(a[0], dr)) <= TOL


def test_density_read_outs_match_reference():
    envs = _envs()
    rng = np.random.default_rng(9)
    a = _rho_pair(envs, _rand_rho(rng, 4))
    b = _rho_pair(envs, _rand_rho(rng, 4))
    psi = _sv_pair(envs, _rand_sv(rng, 4))
    for name, args in (("calcTotalProb", (a,)), ("calcPurity", (a,)),
                       ("calcDensityInnerProduct", (a, b)),
                       ("calcHilbertSchmidtDistance", (a, b)),
                       ("calcFidelity", (a, psi))):
        ref, got = _both(name, *args)
        assert abs(got - ref) <= TOL, name
    for t in (0, 3):
        assert abs(tq.calcProbOfOutcome(a[1], t, 1)
                   - qt.calcProbOfOutcome(a[0], t, 1)) <= TOL
    codes = rng.integers(0, 4, size=(3, 4))
    coeffs = rng.standard_normal(3)
    ref = qt.calcExpecPauliSum(a[0], codes.ravel(), coeffs)
    assert abs(tq.calcExpecPauliSum(a[1], codes.ravel(), coeffs) - ref) \
        <= TOL
    dr = qt.createDiagonalOp(4, envs[0])
    dp = tq.createDiagonalOp(4, envs[1])
    re, im = rng.standard_normal(16), rng.standard_normal(16)
    qt.initDiagonalOp(dr, re, im)
    tq.initDiagonalOp(dp, re, im)
    assert abs(tq.calcExpecDiagonalOp(a[1], dp)
               - qt.calcExpecDiagonalOp(a[0], dr)) <= TOL


def test_hamiltonian_oracle():
    """calcExpecPauliHamil at quad against the dense oracle (the
    reference's test_quad_expec_scan_sharded_parity construction)."""
    _ref, env = _envs()
    n = 8
    rng = np.random.default_rng(5)
    vec = _rand_sv(rng, n)
    q = tq.createQureg(n, env)
    tq.initStateFromAmps(q, vec.real, vec.imag)
    h = tq.createPauliHamil(n, 3)
    codes = rng.integers(0, 4, size=(3, n))
    coeffs = rng.standard_normal(3)
    tq.initPauliHamil(h, coeffs, codes)
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]]),
              np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]])]
    H = sum(coeffs[k] * functools.reduce(np.kron,
                                         [paulis[c] for c in codes[k][::-1]])
            for k in range(3))
    assert abs(tq.calcExpecPauliHamil(q, h)
               - float(np.real(vec.conj() @ H @ vec))) < 1e-12


def test_quad_takes_no_k4_route(monkeypatch):
    """At precision 4 the scan never calls the K4 wrapper (on the card it
    would launch K4); at precision 2 it calls it once per term."""
    calls = []
    real = P.expec_term
    monkeypatch.setattr(P, "expec_term",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _ref, env = _envs()
    q = tq.createQureg(6, env)
    tq.hadamard(q, 2)
    codes = [1, 0, 3, 0, 0, 2, 0, 0, 1, 0, 0, 0]
    tq.calcExpecPauliSum(q, codes, [0.5, 0.25])
    assert calls == []
    tq.set_precision(2)
    q2 = tq.createQureg(6, env)
    tq.calcExpecPauliSum(q2, codes, [0.5, 0.25])
    assert len(calls) == 2


@pytest.mark.parametrize("is_density", [False, True])
def test_measurement_at_quad_matches_reference(is_density):
    """The quad flag through measureWithStats and measureSequence: the
    same seeded outcomes as the reference at precision 4, the
    probabilities within 1e-13."""
    envs = _envs()
    rng = np.random.default_rng(4)
    pair = (_rho_pair(envs, _rand_rho(rng, 3)) if is_density
            else _sv_pair(envs, _rand_sv(rng, 6)))
    qt.seedQuEST(envs[0], [31, 7])
    tq.seedQuEST(envs[1], [31, 7])
    for t in (0, 2, 1):
        ro, rp = qt.measureWithStats(pair[0], t)
        po, pp = tq.measureWithStats(pair[1], t)
        assert po == ro and abs(pp - rp) <= TOL
    ro, rp = qt.measureSequence(pair[0], [2, 0])
    po, pp = tq.measureSequence(pair[1], [2, 0])
    assert po == ro
    np.testing.assert_allclose(pp, rp, atol=TOL, rtol=0)
    np.testing.assert_allclose(pair[1].amps.numpy(),
                               np.asarray(pair[0].amps), atol=1e-12, rtol=0)


def test_gates_run_at_quad():
    _ref, env = _envs()
    q = tq.createQureg(5, env)
    assert q.dtype == torch.float64
    tq.hadamard(q, 0)
    for t in range(1, 5):
        tq.controlledNot(q, t - 1, t)
    assert abs(tq.calcTotalProb(q) - 1.0) < 1e-14
    assert tq.calcProbOfOutcome(q, 4, 1) == pytest.approx(0.5, abs=1e-14)
