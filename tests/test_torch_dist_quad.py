"""Quad precision on a mesh (M15c) in the port against the JAX package.

At ``set_precision(4)`` every read of a register split over R = 2, 4 or
8 shards (``tq.createQuESTEnv(devices=["cpu"] * R)``) takes each shard's
share of the double-double block partials and one Neumaier combine on
the host (parallel/sharded.py), and the sharded Pauli sums per-shard
double-double term values and one all_gather (parallel/composites.py).
Each value is held within 1e-12 of the reference at precision 4 on its
mesh (``qt.createQuESTEnv(num_devices=R)``) and of the port's
one-register quad route:

* calcTotalProb, getAmp, calcProbOfOutcome, calcInnerProduct, measure,
  calcExpecPauliHamil and calcPurity, and the other quad callers of the
  sharded reads (fidelity, density inner product, Hilbert-Schmidt
  distance, Pauli products and sums on state vectors and density
  registers, diagonal expectations, measureSequence, applyPauliSum,
  calcProbOfAllOutcomes);
* the Pauli scan's quad branch at R = 2 and 8, by its direct form and by
  its rotate-layer body;
* the cross-block cancellations of tests/test_torch_quad.py split over
  the mesh: quad keeps exactly what a float64 sum loses.
"""

import numpy as np
import pytest
import torch

import oracle
import quest_tpu as qt
from quest_tpu import precision as ref_precision
from quest_tpu import rng as ref_rng
from quest_tpu.ops import measurement as ref_measurement
import quest_tpu_torch as tq
from quest_tpu_torch import interop, precision, rng
from quest_tpu_torch.ops import measurement as M
from quest_tpu_torch.ops import paulis as P
from quest_tpu_torch.parallel import sharded as SH

TOL = 1e-12
NS = 8          # state-vector qubits: nloc = 5 at R = 8
ND = 4          # density qubits
MESHES = (2, 4, 8)
_A = 2.0 ** 53


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


def _envs(R):
    if qt.createQuESTEnv().num_devices < 8:
        pytest.skip("needs the suite's 8-device CPU mesh")
    return (qt.createQuESTEnv(num_devices=R),
            tq.createQuESTEnv(device="cpu"),
            tq.createQuESTEnv(devices=["cpu"] * R))


def _sv(seed, n=NS):
    v = oracle.random_state(n, np.random.default_rng(seed))
    return v.real.copy(), v.imag.copy()


def _rho(seed, n=ND):
    flat = oracle.random_density(n, np.random.default_rng(seed)).T.reshape(-1)
    return flat.real.copy(), flat.imag.copy()


def _make(mod, env, density, seed):
    if density:
        q = mod.createDensityQureg(ND, env)
        mod.setDensityAmps(q, *_rho(seed))
    else:
        q = mod.createQureg(NS, env)
        mod.initStateFromAmps(q, *_sv(seed))
    return q


def _hamil(mod, n, seed, terms=4):
    r = np.random.default_rng(seed)
    h = mod.createPauliHamil(n, terms)
    mod.initPauliHamil(h, r.standard_normal(terms),
                       r.integers(0, 4, size=(terms, n)).ravel())
    return h


def _diag(mod, env, n, seed):
    r = np.random.default_rng(seed)
    op = mod.createDiagonalOp(n, env)
    mod.initDiagonalOp(op, r.standard_normal(1 << n),
                       r.standard_normal(1 << n))
    return op


def _flat(v):
    """A read's value as a flat float64 array."""
    if isinstance(v, complex):
        return np.array([v.real, v.imag])
    if isinstance(v, tuple):
        return np.concatenate([_flat(x) for x in v])
    return np.atleast_1d(np.asarray(v, dtype=np.float64)).ravel()


def _measure(mod, env, q, targets):
    mod.seedQuEST(env, [31, 7])
    out = [mod.measureWithStats(q, t) for t in targets]
    seq = mod.measureSequence(q, [targets[0], targets[-1]])
    return (tuple(float(o) for o, _ in out), tuple(p for _, p in out),
            tuple(float(o) for o in seq[0]), tuple(seq[1]),
            mod.calcTotalProb(q))


def _apply_pauli_sum(mod, env, q, n):
    out = mod.createQureg(n, env)
    h = _hamil(mod, n, 12, 3)
    mod.applyPauliHamil(q, h, out)
    return mod.calcInnerProduct(out, out), mod.getAmp(out, 77)


# name -> (density, body(mod, env, q)); the seeds are fixed per case
CASES = {
    "calcTotalProb": (False, lambda m, e, q: m.calcTotalProb(q)),
    "getAmp": (False, lambda m, e, q: (m.getAmp(q, 5), m.getAmp(q, 250))),
    "calcProbOfOutcome": (False, lambda m, e, q: tuple(
        m.calcProbOfOutcome(q, t, o) for t in (0, 4, NS - 2, NS - 1)
        for o in (0, 1))),
    "calcInnerProduct": (False, lambda m, e, q: m.calcInnerProduct(
        q, _make(m, e, False, 22))),
    "measure": (False, lambda m, e, q: _measure(m, e, q, [NS - 1, 1, 3])),
    "calcExpecPauliHamil": (False, lambda m, e, q: m.calcExpecPauliHamil(
        q, _hamil(m, NS, 5), None)),
    "calcFidelity": (False, lambda m, e, q: m.calcFidelity(
        q, _make(m, e, False, 23))),
    "calcExpecPauliProd": (False, lambda m, e, q: m.calcExpecPauliProd(
        q, [1, NS - 1, 3], [2, 1, 3], None)),
    "calcExpecDiagonalOp": (False, lambda m, e, q: m.calcExpecDiagonalOp(
        q, _diag(m, e, NS, 6))),
    "calcProbOfAllOutcomes": (False, lambda m, e, q: tuple(
        m.calcProbOfAllOutcomes(q, [0, NS - 1, 3]))),
    "applyPauliSum": (False, lambda m, e, q: _apply_pauli_sum(m, e, q, NS)),
    "calcPurity": (True, lambda m, e, q: m.calcPurity(q)),
    "density_calcTotalProb": (True, lambda m, e, q: m.calcTotalProb(q)),
    "density_calcProbOfOutcome": (True, lambda m, e, q: tuple(
        m.calcProbOfOutcome(q, t, 1) for t in (0, ND - 1))),
    "calcDensityInnerProduct": (True, lambda m, e, q: (
        m.calcDensityInnerProduct(q, _make(m, e, True, 24)),
        m.calcHilbertSchmidtDistance(q, _make(m, e, True, 25)))),
    "density_calcFidelity": (True, lambda m, e, q: m.calcFidelity(
        q, _sv_reg(m, e, ND, 26))),
    "density_calcExpecPauliHamil": (True, lambda m, e, q: (
        m.calcExpecPauliHamil(q, _hamil(m, ND, 7), None),
        m.calcExpecPauliProd(q, [0, ND - 1], [1, 2], None))),
    "density_calcExpecDiagonalOp": (True, lambda m, e, q: (
        m.calcExpecDiagonalOp(q, _diag(m, e, ND, 8)),
        m.getDensityAmp(q, 3, 9))),
    "density_measure": (True, lambda m, e, q: _measure(m, e, q,
                                                       [ND - 1, 0])),
}


def _sv_reg(mod, env, n, seed):
    q = mod.createQureg(n, env)
    mod.initStateFromAmps(q, *_sv(seed, n))
    return q


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_quad_read_on_a_mesh(name, R):
    renv, one, penv = _envs(R)
    density, body = CASES[name]
    seed = 1 + sorted(CASES).index(name)
    q = _make(tq, penv, density, seed)
    assert q.is_sharded
    got = _flat(body(tq, penv, q))
    want_one = _flat(body(tq, one, _make(tq, one, density, seed)))
    want_ref = _flat(body(qt, renv, _make(qt, renv, density, seed)))
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_one, atol=TOL, rtol=0)


def test_writes_and_gates_at_quad_keep_float64_on_a_mesh():
    _renv, one, penv = _envs(4)
    qs, q1 = tq.createQureg(NS, penv), tq.createQureg(NS, one)
    for q in (qs, q1):
        tq.initStateFromAmps(q, *_sv(3))
        tq.hadamard(q, NS - 1)
        tq.controlledNot(q, NS - 1, 0)
        with tq.gateFusion(q):
            tq.rotateY(q, NS - 2, 0.4)
            tq.swapGate(q, 1, NS - 1)
        tq.setAmps(q, 3, [0.25, -0.5], [0.125, 0.0], 2)
    assert qs.dtype == torch.float64
    assert all(s.dtype == torch.float64 for s in qs.amps.shards)
    np.testing.assert_allclose(interop.register_state(qs, True)[0],
                               q1.amps.numpy(), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The Pauli scan's quad branch: direct form and rotate-layer body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", (2, 8))
@pytest.mark.parametrize("body", ["direct", "rotate"])
def test_pauli_scan_quad_branch(R, body, monkeypatch):
    renv, one, penv = _envs(R)
    if body == "rotate":
        monkeypatch.setattr(P, "_DIRECT_MAX_N", 0)
    h_codes = np.random.default_rng(9).integers(0, 4, size=(5, NS))
    coeffs = np.random.default_rng(10).standard_normal(5)
    vals = []
    for mod, env in ((qt, renv), (tq, one), (tq, penv)):
        q = _sv_reg(mod, env, NS, 11)
        vals.append(mod.calcExpecPauliSum(q, h_codes.ravel(), coeffs))
    assert abs(vals[2] - vals[0]) <= TOL
    assert abs(vals[2] - vals[1]) <= TOL


# ---------------------------------------------------------------------------
# Cross-block cancellation split over the mesh
# ---------------------------------------------------------------------------


def _cancel_vec():
    """[+A x256][0][+1 x256][+A x256] (tests/test_torch_quad.py)."""
    v = np.zeros((2, 1024))
    v[0, 0:256] = _A
    v[0, 512:768] = 1.0
    v[0, 768:1024] = _A
    return v


@pytest.mark.parametrize("R", (2, 8))
def test_cancellation_on_a_mesh_comes_out_exact(R):
    _renv, _one, env = _envs(R)
    n = 10
    q = tq.createQureg(n, env)
    v = _cancel_vec()
    tq.setAmps(q, 0, v[0], v[1], 1 << n)
    z8 = [0] * 8 + [3] + [0] * (n - 9)
    assert tq.calcExpecPauliSum(q, z8, [1.0]) == 256.0

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
    assert tq.calcFidelity(rho, psi) == 256.0

    dim2 = dim * dim
    r1, r2 = np.zeros(dim2), np.zeros(dim2)
    r1[0:256], r2[0:256] = 1.0, _A
    r1[512:768], r2[512:768] = 1.0, 1.0
    r1[768:1024], r2[768:1024] = -1.0, _A
    a = tq.createDensityQureg(m, env)
    b = tq.createDensityQureg(m, env)
    tq.setDensityAmps(a, r1, np.zeros(dim2))
    tq.setDensityAmps(b, r2, np.zeros(dim2))
    assert tq.calcDensityInnerProduct(a, b) == 256.0

    q2 = tq.createQureg(n, env)
    tq.setAmps(q2, 0, np.sqrt(np.abs(v[0])) * np.sign(v[0]),
               np.zeros(1 << n), 1 << n)
    d = tq.createDiagonalOp(n, env)
    tq.initDiagonalOp(d, 1.0 - 2.0 * (((np.arange(1 << n) >> 8) & 1)
                                      .astype(float)), np.zeros(1 << n))
    assert tq.calcExpecDiagonalOp(q2, d).real == 256.0
    # what a float64 sum over the same shards loses
    tq.set_precision(2)
    q3 = tq.createQureg(n, env)
    tq.setAmps(q3, 0, v[0], v[1], 1 << n)
    assert abs(tq.calcExpecPauliSum(q3, z8, [1.0]) - 256.0) > 100.0


def test_sharded_partials_are_the_one_register_partials():
    """Where every shard holds whole final partials (R <= 256 over 2^16
    values or more), the gathered per-shard partials are the one-register
    partials bit for bit, and so is the quad sum."""
    from quest_tpu_torch.ops import calculations as CALC

    x = torch.as_tensor(np.random.default_rng(3).standard_normal(1 << 18))
    whole = CALC._quad_partials(x)
    for R in (2, 8, 64):
        pieces = list(x.reshape(R, -1))
        parts = torch.cat([CALC.quad_partials_piece(p, x.numel())
                           for p in pieces])
        assert torch.equal(parts, whole)
        mesh = tq.createQuESTEnv(devices=["cpu"] * 8).mesh
        if R == 8:
            assert SH.quad_sum_pieces(mesh, pieces, x.numel(),
                                      pieces[0].numel()) == CALC.quad_sum(x)
