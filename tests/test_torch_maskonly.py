"""The mask-only window pass of quest_tpu_torch against quest_tpu, on the
CPU at float64.

Both planners emit ("winfused", k, A, B, False, False, mask) for a pass
that folds only crossing diagonal gates (CZ, CPhase, the two halves of a
diagonal gate on a density register): Y = mask (.) X.  The reference runs
it as an A-only pass with the identity, then the mask
(quest_tpu/ops/fused.py _window_block_body); the port's plain version
applies the mask alone, and on the card K1 and K2 do the same.

* ``window_pass_plain`` and ``apply_window_stack`` with neither side,
  against the reference's ``apply_window_stack(..., interpret=True)``, at
  k = 7, 8 and n - 7.
* gateFusion drains of one crossing diagonal gate on a state vector (14
  and 16 qubits) and of one diagonal gate on a density register (7 and 8
  qubits: 14 and 16 state bits), against the reference's drain and the
  port's eager route.
* A megawin group holding a mask-only pass: ``megawin_plain`` equals its
  passes run one by one (bit for bit) and the reference's megakernel.

Tolerance: 1e-10 against the reference (a mask multiply and, in the
reference, products with the identity: one rounding of order-1 values);
the port's own fused and eager routes of one gate to 1e-12.
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
from quest_tpu.ops import fused as ref_fused
from quest_tpu_torch import precision
from quest_tpu_torch.ops import fused

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
N = 16


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _port_env():
    return tq.createQuESTEnv(device="cpu")


def _eye_stack():
    eye = np.zeros((1, 2, 128, 128))
    eye[0, 0] = np.eye(128)
    return eye


def _mask(rng):
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
    return np.stack([ph.real, ph.imag])


def _mask_only(rng, k):
    """A mask-only pass as the planners emit it: identity sides, unused."""
    return ("winfused", k, _eye_stack(), _eye_stack(), False, False,
            _mask(rng))


def _state(rng, n):
    x = rng.standard_normal((2, 1 << n))
    return x / np.sqrt((x ** 2).sum())


def _ref_pass(x, op, n):
    return np.asarray(ref_fused.apply_window_stack(
        jnp.asarray(x), jnp.asarray(op[2]), jnp.asarray(op[3]),
        jnp.asarray(op[6]), num_qubits=n, k=op[1], apply_a=op[4],
        apply_b=op[5], interpret=True))


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("k", [7, 8, N - 7])
def test_mask_only_pass_matches_reference(k, entry):
    rng = np.random.default_rng(300 + k)
    x = _state(rng, N)
    op = _mask_only(rng, k)
    fn = (fused.window_pass_plain if entry == "plain"
          else fused.apply_window_stack)
    got = fn(torch.from_numpy(x), op[2], op[3], op[6], num_qubits=N, k=k,
             apply_a=False, apply_b=False).numpy()
    want = _ref_pass(x, op, N)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the mask alone: the sides a mask-only pass carries are never read
    other = ("winfused", k, op[2] * 3.0, op[3] * 5.0, False, False, op[6])
    np.testing.assert_array_equal(
        fn(torch.from_numpy(x), other[2], other[3], other[6], num_qubits=N,
           k=k, apply_a=False, apply_b=False).numpy(), got)


def _vector_pair(n, seed):
    """Port and reference state vectors holding the same random state."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    q = tq.createQureg(n, _port_env())
    r = qt.createQureg(n, _ref_env())
    q.amps = torch.from_numpy(np.stack([psi.real, psi.imag]).copy())
    oracle.set_qureg_from_array(qt, r, psi)
    return q, r


def _density_pair(n, seed):
    """Port and reference density registers holding the same random
    mixed state."""
    rng = np.random.default_rng(seed)
    dim = 1 << n
    g = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    rho = g @ g.conj().T
    rho /= np.trace(rho).real
    q = tq.createDensityQureg(n, _port_env())
    r = qt.createDensityQureg(n, _ref_env())
    flat = rho.T.ravel()
    q.amps = torch.from_numpy(np.stack([flat.real, flat.imag]).copy())
    oracle.set_qureg_from_array(qt, r, rho)
    return q, r


@pytest.fixture
def passes_run(monkeypatch):
    """The (apply_a, apply_b) of every window pass the port executes."""
    seen = []
    real = fused.apply_window_stack

    def spy(amps, mats_a, mats_b, mask=None, **kw):
        seen.append((kw.get("apply_a", True), kw.get("apply_b", True)))
        return real(amps, mats_a, mats_b, mask, **kw)

    monkeypatch.setattr(fused, "apply_window_stack", spy)
    return seen


def _copy(q, density):
    c = (tq.createDensityQureg if density else tq.createQureg)(
        q.num_qubits_represented, _port_env())
    c.amps = q.amps.clone()
    return c


_VECTOR_GATES = [
    (14, "controlledPhaseShift", (1, 8, 0.3)),
    (16, "controlledPhaseFlip", (2, 10)),
]


@pytest.mark.parametrize("n,gate,args", _VECTOR_GATES,
                         ids=[g for _n, g, _a in _VECTOR_GATES])
def test_vector_drain_of_a_crossing_diagonal(n, gate, args, passes_run):
    q, r = _vector_pair(n, 40 + n)
    eager = _copy(q, False)
    with tq.gateFusion(q):
        getattr(tq, gate)(q, *args)
    assert passes_run == [(False, False)]
    with qt.gateFusion(r):
        getattr(qt, gate)(r, *args)
    getattr(tq, gate)(eager, *args)
    got = q.amps.numpy()
    np.testing.assert_allclose(got, np.asarray(r.amps).reshape(2, -1),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got, eager.amps.numpy(), rtol=0, atol=FTOL)


_DENSITY_GATES = [("rotateZ", (0.7,)), ("phaseShift", (0.4,)),
                  ("tGate", ()), ("pauliZ", ())]


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("gate,args", _DENSITY_GATES,
                         ids=[g for g, _a in _DENSITY_GATES])
def test_density_drain_of_a_diagonal_gate(n, gate, args, passes_run):
    q, r = _density_pair(n, 60 + n)
    eager = _copy(q, True)
    target = n - 2
    with tq.gateFusion(q):
        getattr(tq, gate)(q, target, *args)
    assert passes_run == [(False, False)]
    with qt.gateFusion(r):
        getattr(qt, gate)(r, target, *args)
    getattr(tq, gate)(eager, target, *args)
    got = q.amps.numpy()
    np.testing.assert_allclose(got, np.asarray(r.amps).reshape(2, -1),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got, eager.amps.numpy(), rtol=0, atol=FTOL)


def _random_pass(rng, k, sides, with_mask):
    def stack():
        z = (rng.standard_normal((128, 128))
             + 1j * rng.standard_normal((128, 128)))
        u, _ = np.linalg.qr(z)
        return np.stack([u.real, u.imag])[None]
    return ("winfused", k, stack(), stack(), "A" in sides, "B" in sides,
            _mask(rng) if with_mask else None)


def test_megawin_group_with_a_mask_only_pass():
    rng = np.random.default_rng(77)
    x = _state(rng, N)
    group = [_random_pass(rng, 8, "AB", True), _mask_only(rng, 9),
             _random_pass(rng, 7, "B", False)]
    xt = torch.from_numpy(x)
    got = fused.megawin_plain(xt, group, num_qubits=N)
    one_by_one = xt
    for op in group:
        one_by_one = fused.apply_window_stack(
            one_by_one, op[2], op[3], op[6], num_qubits=N, k=op[1],
            apply_a=op[4], apply_b=op[5])
    assert torch.equal(fused.apply_window_megastack(xt, group, num_qubits=N),
                       got)
    assert torch.equal(got, one_by_one)
    want = np.asarray(ref_fused.apply_window_megastack(
        jnp.asarray(x), group, num_qubits=N, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
