"""quest_tpu_torch.ops.paulis and the parity ops of ops/kernels.py against
quest_tpu's, on the CPU at float64.

* K3's plain version, direct_rotation_plain, against the reference's
  Pallas kernel _direct_rotation_pallas (interpret mode, called directly
  as tests/test_direct_rotation.py does) and its gather form
  _direct_rotation, at 15 and 16 state bits, for state vectors and the
  conjugated bra twin of a density matrix, all-identity terms included.
* K4's plain version, expec_term_plain, against _expec_term_pallas.
* The term loops trotter_scan and expec_pauli_sum_scan against the
  reference's scans; the plain Pauli-sum forms; apply_parity_phase with
  and without controls; the index flips and parity signs.
* On the CPU the K3/K4 wrappers are their plain versions.

Tolerances: states 1e-12 absolute (the reference's own Trotter test,
tests/test_operators.py:405), energies 1e-10; the sums run in another
order than XLA's.  Moves without arithmetic (flips, signs) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quest_tpu.api_ops import _trotter_schedule as ref_schedule
from quest_tpu.ops import kernels as RK
from quest_tpu.ops import paulis as RP
from quest_tpu_torch.api_ops import _trotter_schedule
from quest_tpu_torch.ops import kernels as K
from quest_tpu_torch.ops import paulis as P

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run (its
    spinning worker threads starve the other test processes)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-12
ETOL = 1e-10


def _state(rng, n):
    x = rng.standard_normal((2, 1 << n))
    return x / np.sqrt((x ** 2).sum())


def _codes(rng, nq, kind):
    """A code row of one of the shapes the kernels treat apart."""
    if kind == "identity":
        return np.zeros(nq, np.int32)
    if kind == "z_only":
        return (3 * rng.integers(0, 2, nq)).astype(np.int32)
    if kind == "x_top":
        c = np.zeros(nq, np.int32)
        c[-1] = 1
        return c
    return rng.integers(0, 4, nq).astype(np.int32)


_KINDS = ["random", "identity", "z_only", "x_top"]


@pytest.fixture(scope="module")
def rot_refs():
    """The reference's Pallas and gather rotations, jitted once."""
    statics = ("nq", "offset", "n", "conj")
    return (jax.jit(RP._direct_rotation_pallas, static_argnames=statics),
            jax.jit(RP._direct_rotation, static_argnames=statics))


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n,density", [(15, False), (16, False),
                                       (16, True)],
                         ids=["sv15", "sv16", "rho8"])
def test_direct_rotation_plain_matches_reference(rot_refs, n, density, kind):
    pallas, gather = rot_refs
    rng = np.random.default_rng(10 * n + _KINDS.index(kind) + 100 * density)
    nq = n // 2 if density else n
    offset, conj = (nq, True) if density else (0, False)
    codes = _codes(rng, nq, kind)
    ang = float(rng.normal())
    x = _state(rng, n)
    kw = dict(nq=nq, offset=offset, n=n, conj=conj)
    args = (jnp.asarray(x), jnp.asarray(codes), jnp.asarray(ang))
    want_pl = np.asarray(pallas(*args, **kw))
    want = np.asarray(gather(*args, **kw))
    term = P.pauli_term(codes, dtype=torch.float64, offset=offset,
                        theta=ang, conj=conj)
    got = P.direct_rotation_plain(torch.from_numpy(x), term,
                                  num_qubits=n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=TOL)
    if kind == "identity":
        assert np.array_equal(got, x)


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n", [15, 16])
def test_expec_term_plain_matches_reference(n, kind):
    rng = np.random.default_rng(200 + n + _KINDS.index(kind))
    codes = _codes(rng, n, kind)
    x = _state(rng, n)
    want = float(RP._expec_term_pallas(jnp.asarray(x), jnp.asarray(codes),
                                       n))
    got = P.expec_term_plain(torch.from_numpy(x),
                             P.pauli_term(codes, dtype=torch.float64),
                             num_qubits=n)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - want) <= ETOL


def test_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(3)
    n = 15
    x = torch.from_numpy(_state(rng, n))
    term = P.pauli_term(_codes(rng, n, "random"), dtype=torch.float64,
                        theta=0.4)
    P.reset_launch_counts()
    assert torch.equal(P.direct_rotation(x, term, num_qubits=n),
                       P.direct_rotation_plain(x, term, num_qubits=n))
    assert torch.equal(P.expec_term(x, term, num_qubits=n),
                       P.expec_term_plain(x, term, num_qubits=n))
    assert P.LAUNCHES == {"K3": 0, "K4": 0}


def test_wrappers_refuse_other_devices_and_bad_terms():
    x = torch.zeros((2, 1 << 10), device="meta")
    term = P.pauli_term([1] * 10, dtype=torch.float32, theta=0.1)
    with pytest.raises(RuntimeError, match="no kernel"):
        P.direct_rotation(x, term, num_qubits=10)
    with pytest.raises(RuntimeError, match="no kernel"):
        P.expec_term(x, term, num_qubits=10)
    wide = P.pauli_term([1] * 11, dtype=torch.float64)
    with pytest.raises(ValueError, match="past qubit"):
        P.expec_term(torch.zeros((2, 1 << 10), dtype=torch.float64), wide,
                     num_qubits=10)


def test_pauli_term_masks_factor_and_angle():
    # codes on qubits 0..4: I X Y Z Y -> fm = X|Y bits, zm = Y|Z bits, #Y = 2
    t = P.pauli_term([0, 1, 2, 3, 2], dtype=torch.float64, theta=0.6)
    assert (t.fm, t.zm) == (0b10110, 0b11100)
    assert (t.c_re, t.c_im) == (-1.0, 0.0)
    assert (t.co, t.si) == (np.cos(0.3), np.sin(0.3))
    # the bra twin: shifted masks, conjugated factor
    b = P.pauli_term([2], dtype=torch.float64, offset=3, theta=-0.6,
                     conj=True)
    assert (b.fm, b.zm, b.c_re, b.c_im) == (8, 8, 0.0, 1.0)
    assert b.si == np.sin(-0.3)
    # an all-identity string rotates by nothing
    i = P.pauli_term([0, 0, 0], dtype=torch.float32, theta=1.0)
    assert (i.co, i.si) == (1.0, 0.0)
    # cos/sin of 0.5 theta in the state's type
    f = P.pauli_term([3], dtype=torch.float32, theta=0.1)
    assert f.co == float(np.cos(np.float32(0.5) * np.float32(0.1)))


@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_trotter_scan_matches_reference(density):
    rng = np.random.default_rng(40 + density)
    nq = 8 if density else 15
    n = 2 * nq if density else nq
    terms = 5
    codes = rng.integers(0, 4, (terms, nq)).astype(np.int32)
    codes[2] = 0                                   # an all-identity term
    angles = rng.normal(size=terms)
    x = _state(rng, n)
    want = np.asarray(RP.trotter_scan(jnp.asarray(x), jnp.asarray(codes),
                                      jnp.asarray(angles), num_qubits=n,
                                      rep_qubits=nq))
    got = P.trotter_scan(torch.from_numpy(x), codes, angles, num_qubits=n,
                         rep_qubits=nq)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_expec_pauli_sum_scan_matches_reference():
    rng = np.random.default_rng(50)
    n, terms = 15, 6
    codes = rng.integers(0, 4, (terms, n)).astype(np.int32)
    codes[0] = 0
    coeffs = rng.standard_normal(terms)
    x = _state(rng, n)
    want = float(RP.expec_pauli_sum_scan(jnp.asarray(x), jnp.asarray(codes),
                                         jnp.asarray(coeffs), num_qubits=n))
    got = P.expec_pauli_sum_scan(torch.from_numpy(x), codes, coeffs,
                                 num_qubits=n)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= ETOL


@pytest.mark.parametrize("order", [1, 2, 4])
@pytest.mark.parametrize("reps", [1, 2])
def test_trotter_schedule_is_the_reference(order, reps):
    assert _trotter_schedule(5, 0.37, order, reps) == ref_schedule(
        5, 0.37, order, reps)


# ---------------------------------------------------------------------------
# The plain Pauli-sum forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 9, 14])
def test_apply_pauli_string_matches_reference(n):
    rng = np.random.default_rng(60 + n)
    x = _state(rng, n)
    for _ in range(4):
        k = int(rng.integers(1, n + 1))
        targets = tuple(int(t) for t in rng.choice(n, k, replace=False))
        codes = tuple(int(c) for c in rng.integers(0, 4, k))
        want = np.asarray(RP.apply_pauli_string(jnp.asarray(x), n, targets,
                                                codes))
        got = P.apply_pauli_string(torch.from_numpy(x), n, targets, codes)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [False, True], ids=["sv", "rho"])
def test_pauli_sum_forms_match_reference(density):
    rng = np.random.default_rng(70 + density)
    nq, terms = 6, 4
    nsv = 2 * nq if density else nq
    codes = tuple(int(c) for c in rng.integers(0, 4, terms * nq))
    coeffs = rng.standard_normal(terms)
    x = _state(rng, nsv)
    kw = dict(num_qubits=nq, codes_flat=codes, num_terms=terms)
    ref = (RP.calc_expec_pauli_sum_density if density
           else RP.calc_expec_pauli_sum_statevec)
    port = (P.calc_expec_pauli_sum_density if density
            else P.calc_expec_pauli_sum_statevec)
    want = float(ref(jnp.asarray(x), jnp.asarray(coeffs), **kw))
    assert abs(float(port(torch.from_numpy(x), coeffs, **kw)) - want) <= ETOL
    want = np.asarray(RP.apply_pauli_sum(
        jnp.asarray(x), jnp.asarray(coeffs), jnp.zeros_like(x),
        num_state_qubits=nsv, **kw))
    got = P.apply_pauli_sum(torch.from_numpy(x), coeffs,
                            num_state_qubits=nsv, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Parity ops of ops/kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [6, 13, 15])
@pytest.mark.parametrize("nc", [0, 1, 3])
def test_apply_parity_phase_matches_reference(n, nc):
    rng = np.random.default_rng(80 + 4 * n + nc)
    x = _state(rng, n)
    bits = tuple(int(b) for b in rng.choice(n, 3 + nc, replace=False))
    qubits, controls = bits[:3], bits[3:]
    states = tuple(int(s) for s in rng.integers(0, 2, nc))
    kw = dict(num_qubits=n, qubits=qubits, controls=controls,
              control_states=states)
    want = np.asarray(RK.apply_parity_phase(jnp.asarray(x), 0.83, **kw))
    got = K.apply_parity_phase(torch.from_numpy(x), 0.83, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [5, 12, 16])
def test_flip_bits_and_parity_signs_match_reference(n):
    rng = np.random.default_rng(90 + n)
    x = _state(rng, n)
    for k in (1, 3, n):
        targets = tuple(sorted(int(t) for t in rng.choice(n, k,
                                                          replace=False)))
        # the port's one index flip is the plain versions' split gather
        want = np.asarray(RK._flip_bits_flat(jnp.asarray(x), n, targets))
        hi, lo = P._split(n)
        got = P._flip_gather(torch.from_numpy(x).reshape(2, 1 << hi, 1 << lo),
                             sum(1 << t for t in targets), hi, lo)
        np.testing.assert_array_equal(got.reshape(2, -1).numpy(), want)
        want = np.asarray(RK.parity_sign_2d(n, targets, jnp.float64))
        got = K.parity_sign_2d(n, targets, torch.float64, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(RK.parity_sign_flat(n, targets, jnp.float64))
        got = K.parity_sign_flat(n, targets, torch.float64, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        # the factors at the plain versions' split give the same sign
        s_row, s_lane = K.parity_sign_factors(n, targets, torch.float64,
                                              "cpu", lo=lo)
        assert s_row.shape == (1 << hi, 1) and s_lane.shape == (1, 1 << lo)
        np.testing.assert_array_equal((s_row * s_lane).reshape(-1).numpy(),
                                      want)
