"""quest_tpu_torch.ops.kernels (plain PyTorch state operations) against
quest_tpu.ops.kernels and the dense NumPy oracle (tests/oracle.py).

Registers of 5-8 qubits and of 14-15 qubits: at n >= 14 the index gather
of apply_index_permutation extends a field reaching below the 128-lane
block down to bit 0, as the JAX package does.  Tolerance: 1e-12 absolute
at float64 for dense gates (a 2^k-term complex sum per amplitude, summed
in another order than XLA's); index moves (NOT, relabel, gather, segment
swap) move amplitudes without arithmetic and are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import oracle
from quest_tpu.ops import kernels as RK
from quest_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run: its
    spinning worker threads starve the other test processes (with 6 test
    processes on 8 cores, tests of 0.8 s took 40 s)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-12
SIZES = [5, 8, 14, 15]


def _state(rng, n):
    x = rng.standard_normal((2, 1 << n))
    return x / np.sqrt((x ** 2).sum())


def _soa(u):
    return np.stack([u.real, u.imag])


def _ref(fn, x, *args, **kw):
    return np.asarray(fn(jnp.asarray(x), *args, **kw))


def _pick(rng, n, count):
    return tuple(int(v) for v in rng.choice(n, count, replace=False))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nt,nc", [(1, 0), (3, 0), (2, 2), (1, 3)])
def test_apply_matrix_matches_reference(n, nt, nc):
    rng = np.random.default_rng(100 * n + 10 * nt + nc)
    x = _state(rng, n)
    bits = _pick(rng, n, nt + nc)
    targets, controls = bits[:nt], bits[nt:]
    states = tuple(int(s) for s in rng.integers(0, 2, nc))
    u = oracle.random_unitary(nt, rng)
    kw = dict(num_qubits=n, targets=targets, controls=controls,
              control_states=states)
    want = _ref(RK.apply_matrix, x, _soa(u), **kw)
    got = K.apply_matrix(torch.from_numpy(x), _soa(u), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if n <= 8:
        psi = oracle.apply_to_statevec(x[0] + 1j * x[1], n, targets, u,
                                       controls, list(states) or None)
        np.testing.assert_allclose(got[0] + 1j * got[1], psi, rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_apply_diagonal_matches_reference(n):
    rng = np.random.default_rng(n)
    x = _state(rng, n)
    targets, controls = _pick(rng, n, 2), ()
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
    kw = dict(num_qubits=n, targets=targets, controls=controls)
    want = _ref(RK.apply_diagonal, x, _soa(d), **kw)
    got = K.apply_diagonal(torch.from_numpy(x), _soa(d), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nt,nc", [(1, 0), (3, 0), (2, 1), (1, 2)])
def test_apply_multi_qubit_not_matches_reference(n, nt, nc):
    rng = np.random.default_rng(7 * n + nt + 3 * nc)
    x = _state(rng, n)
    bits = _pick(rng, n, nt + nc)
    states = tuple(int(s) for s in rng.integers(0, 2, nc))
    kw = dict(num_qubits=n, targets=bits[:nt], controls=bits[nt:],
              control_states=states)
    want = _ref(RK.apply_multi_qubit_not, x, **kw)
    got = K.apply_multi_qubit_not(torch.from_numpy(x), **kw).numpy()
    assert np.array_equal(got, want)
    if n <= 8:
        xm = np.eye(1 << nt)[::-1]
        psi = oracle.apply_to_statevec(x[0] + 1j * x[1], n, bits[:nt], xm,
                                       bits[nt:], list(states) or None)
        assert np.array_equal(got[0] + 1j * got[1], psi)


@pytest.mark.parametrize("n", SIZES)
def test_permute_qubits_matches_reference(n):
    rng = np.random.default_rng(n + 50)
    x = _state(rng, n)
    perm = tuple(int(p) for p in rng.permutation(n))
    want = _ref(RK.permute_qubits, x, num_qubits=n, perm=perm)
    got = K.permute_qubits(torch.from_numpy(x), num_qubits=n,
                           perm=perm).numpy()
    assert np.array_equal(got, want)


def test_permute_qubits_many_runs_takes_pairwise_swaps():
    """A bit reversal of 18 qubits has 18 runs, more than one transpose
    takes, so it is decomposed into swaps; the result is the same."""
    n = 18
    rng = np.random.default_rng(18)
    x = _state(rng, n)
    perm = tuple(range(n))[::-1]
    want = _ref(RK.permute_qubits, x, num_qubits=n, perm=perm)
    got = K.permute_qubits(torch.from_numpy(x), num_qubits=n,
                           perm=perm).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", [2, 3])
def test_apply_index_permutation_matches_reference(n, width):
    rng = np.random.default_rng(1000 + 10 * n + width)
    x = _state(rng, n)
    targets = _pick(rng, n, width)
    pi = tuple(int(p) for p in rng.permutation(1 << width))
    kw = dict(num_qubits=n, targets=targets, pi=pi)
    want = _ref(RK.apply_index_permutation, x, **kw)
    got = K.apply_index_permutation(torch.from_numpy(x), **kw).numpy()
    assert np.array_equal(got, want)
    if n <= 8:
        pm = np.zeros((1 << width, 1 << width))
        pm[np.arange(1 << width), np.asarray(pi)] = 1.0
        psi = oracle.apply_to_statevec(x[0] + 1j * x[1], n, targets, pm)
        assert np.array_equal(got[0] + 1j * got[1], psi)


def test_apply_index_permutation_wide_field_uses_the_matrix():
    """Targets 17 bits apart exceed the gather field cap: both packages
    fall back to the exact 0/1 matrix."""
    n = 18
    rng = np.random.default_rng(3)
    x = _state(rng, n)
    kw = dict(num_qubits=n, targets=(0, 17), pi=(2, 0, 3, 1))
    want = _ref(RK.apply_index_permutation, x, **kw)
    got = K.apply_index_permutation(torch.from_numpy(x), **kw).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("a,b,m", [(10, 2, 3), (12, 7, 2), (9, 0, 1)])
def test_swap_bit_segments_matches_reference(a, b, m):
    n = 15
    x = _state(np.random.default_rng(a), n)
    want = _ref(RK.swap_bit_segments, x, num_qubits=n, a=a, b=b, m=m)
    got = K.swap_bit_segments(torch.from_numpy(x), num_qubits=n, a=a, b=b,
                              m=m).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("init_blank_state", (32,)), ("init_zero_state", (32,)),
    ("init_plus_state", (64,)), ("init_classical_state", (32, 5)),
    ("init_debug_state", (1 << 14,)), ("init_classical_density", (3, 6)),
    ("init_plus_density", (3,)),
])
def test_init_states_match_reference(name, args):
    want = np.asarray(getattr(RK, name)(*args, jnp.float64))
    got = getattr(K, name)(*args, torch.float64, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_init_debug_state_matches_oracle():
    got = K.init_debug_state(256, torch.float64, "cpu").numpy()
    np.testing.assert_allclose(got[0] + 1j * got[1], oracle.debug_state(256),
                               rtol=0, atol=TOL)
