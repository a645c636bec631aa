"""Diagonal operators and element access of quest_tpu_torch against
quest_tpu, on the CPU at float64.

* ``ops/element.py``: ``get_amp_pair``, ``get_block_host`` and
  ``set_amp_range`` on the flat and the canonical view against the
  reference's functions; ``set_amp_range`` and ``setAmps`` write in place
  (the state's storage is unchanged, no second state is made);
  ``getAmp``/``getDensityAmp`` read through ``get_amp_pair``.
* ``DiagonalOp``: creation, ``initDiagonalOp``, ``setDiagonalOpElems``,
  ``initDiagonalOpFromPauliHamil`` and ``createDiagonalOpFromPauliHamilFile``
  against the reference's operators; ``applyDiagonalOp`` and
  ``calcExpecDiagonalOp`` on state vectors (8-12 qubits) and density
  registers (4-6 qubits).
* The validators' messages, word for word.

Tolerance: 1e-10 absolute (float64 elementwise products and sums of at
most 2^12 terms of order-1 values; both packages round the same
operations, in orders that may differ).
"""

import functools

import numpy as np
import pytest
import torch

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu.ops import element as ref_element
from quest_tpu_torch import interop, precision
from quest_tpu_torch.ops import element

torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _env():
    return tq.createQuESTEnv(device="cpu")


def _amps(q):
    a = q.amps
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _pair(n, density, seed):
    """(port register, reference register, the oracle array) holding the
    same random state."""
    rng = np.random.default_rng(seed)
    arr = (oracle.random_density(n, rng) if density
           else oracle.random_state(n, rng))
    if density:
        q = tq.createDensityQureg(n, _env())
        r = qt.createDensityQureg(n, _ref_env())
    else:
        q = tq.createQureg(n, _env())
        r = qt.createQureg(n, _ref_env())
    oracle.set_qureg_from_array(tq, q, arr)
    oracle.set_qureg_from_array(qt, r, arr)
    return q, r, arr


def _ops(n, seed):
    """The same random DiagonalOp in both packages."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    op = tq.createDiagonalOp(n, _env())
    tq.initDiagonalOp(op, vals.real, vals.imag)
    ref = qt.createDiagonalOp(n, _ref_env())
    qt.initDiagonalOp(ref, vals.real, vals.imag)
    return op, ref, vals


def _vec(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# ops/element.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 1, 127, 128, (1 << 14) - 1, 1 << 14,
                                   (1 << 15) + 12345, (1 << 16) - 1])
def test_get_amp_pair_matches_the_reference(index):
    n = 16
    flat = np.random.default_rng(3).standard_normal((2, 1 << n))
    want = np.asarray(ref_element.get_amp_pair(flat, index))
    t = torch.from_numpy(flat)
    for view in (t, t.reshape(2, 1 << (n - 14), 128, 128)):
        assert np.array_equal(element.get_amp_pair(view, index).numpy(),
                              want)


@pytest.mark.parametrize("start,m", [
    (0, 5), (100, 1 << 14), (1 << 14, 1 << 14), (5, 3 * (1 << 14)),
    ((1 << 16) - 7, 7), (3, 0)])
def test_set_amp_range_in_place_matches_the_reference(start, m):
    n = 16
    rng = np.random.default_rng(4)
    flat = rng.standard_normal((2, 1 << n))
    vals = rng.standard_normal((2, m))
    want = np.asarray(ref_element.set_amp_range(flat.copy(), start, vals))
    for canonical in (False, True):
        t = torch.from_numpy(flat.copy())
        if canonical:
            t = t.reshape(2, 1 << (n - 14), 128, 128)
        ptr = t.data_ptr()
        got = element.set_amp_range(t, start, vals)
        assert got is t and got.data_ptr() == ptr
        assert tuple(got.shape) == tuple(t.shape)
        assert np.array_equal(got.reshape(2, -1).numpy(), want)


def test_set_amp_range_refuses_a_strided_view():
    t = torch.zeros((2, 1 << 15), dtype=torch.float64)[:, ::2]
    with pytest.raises(ValueError):
        element.set_amp_range(t, 0, np.ones((2, 1)))


@pytest.mark.parametrize("b", [0, 1, 3])
def test_get_block_host_matches_the_reference(b):
    n = 16
    flat = np.random.default_rng(5).standard_normal((2, 1 << n))
    want = np.asarray(ref_element.get_block_host(flat, b))
    t = torch.from_numpy(flat)
    assert np.array_equal(element.get_block_host(t, b), want)
    assert np.array_equal(
        element.get_block_host(t.reshape(2, 4, 128, 128), b), want)


def test_set_amps_writes_in_place_and_allocates_no_second_state():
    q, r, vec = _pair(12, False, 6)
    before = q.amps
    ptr = before.data_ptr()
    tq.setAmps(q, 37, [0.5, 0.25, -1.0], [0.1, -0.1, 0.0], 3)
    qt.setAmps(r, 37, [0.5, 0.25, -1.0], [0.1, -0.1, 0.0], 3)
    assert q.amps is before and q.amps.data_ptr() == ptr
    assert np.array_equal(_amps(q), _amps(r))
    # under gateFusion the pending gates drain first, then the write
    with tq.gateFusion(q):
        tq.hadamard(q, 0)
        tq.setAmps(q, 0, [1.0], [0.0], 1)
    with qt.gateFusion(r):
        qt.hadamard(r, 0)
        qt.setAmps(r, 0, [1.0], [0.0], 1)
    np.testing.assert_allclose(_amps(q), _amps(r), rtol=0, atol=TOL)


def test_get_amp_and_get_density_amp_match_the_reference():
    q, r, vec = _pair(10, False, 7)
    for i in (0, 7, 513, 1023):
        assert abs(tq.getAmp(q, i) - qt.getAmp(r, i)) <= TOL
        assert abs(tq.getAmp(q, i) - vec[i]) <= TOL
    rho, rr, mat = _pair(4, True, 8)
    for row, col in ((0, 0), (3, 9), (15, 15), (9, 3)):
        assert abs(tq.getDensityAmp(rho, row, col)
                   - qt.getDensityAmp(rr, row, col)) <= TOL
        assert abs(tq.getDensityAmp(rho, row, col) - mat[row, col]) <= TOL


# ---------------------------------------------------------------------------
# DiagonalOp
# ---------------------------------------------------------------------------


def test_create_diagonal_op():
    op = tq.createDiagonalOp(6, _env())
    assert op.num_qubits == 6 and op.num_elems_per_chunk == 64
    for v in (op.real, op.imag):
        assert v.shape == (64,) and v.dtype == torch.float64
        assert v.device.type == "cpu" and not bool(v.any())
    tq.set_precision(1)
    assert tq.createDiagonalOp(3, _env()).real.dtype == torch.float32
    tq.syncDiagonalOp(op)
    tq.destroyDiagonalOp(op, _env())


def test_init_and_set_diagonal_op_elems_match_the_reference():
    op, ref, vals = _ops(8, 9)
    assert np.array_equal(_vec(op.real), np.asarray(ref.real))
    assert np.array_equal(_vec(op.imag), np.asarray(ref.imag))
    re, im = np.linspace(-1, 1, 20), np.linspace(2, 3, 20)
    real_before = op.real
    tq.setDiagonalOpElems(op, 100, re, im, 17)
    qt.setDiagonalOpElems(ref, 100, re, im, 17)
    assert op.real is real_before
    assert np.array_equal(_vec(op.real), np.asarray(ref.real))
    assert np.array_equal(_vec(op.imag), np.asarray(ref.imag))
    with pytest.raises(tq.QuESTError, match="Incorrect number of elements"):
        tq.initDiagonalOp(op, vals.real[:10], vals.imag[:10])


@pytest.mark.parametrize("n", [8, 10, 12])
def test_apply_diagonal_op_statevec(n):
    op, ref, vals = _ops(n, 10 + n)
    q, r, vec = _pair(n, False, 20 + n)
    tq.applyDiagonalOp(q, op)
    qt.applyDiagonalOp(r, ref)
    np.testing.assert_allclose(_amps(q), _amps(r), rtol=0, atol=TOL)
    np.testing.assert_allclose(oracle.state_from_qureg(q), vals * vec,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_apply_diagonal_op_density_left_multiplies(n):
    op, ref, vals = _ops(n, 30 + n)
    q, r, mat = _pair(n, True, 40 + n)
    tq.applyDiagonalOp(q, op)
    qt.applyDiagonalOp(r, ref)
    np.testing.assert_allclose(_amps(q), _amps(r), rtol=0, atol=TOL)
    np.testing.assert_allclose(oracle.state_from_qureg(q),
                               np.diag(vals) @ mat, rtol=0, atol=TOL)


@pytest.mark.parametrize("n,density", [(8, False), (12, False), (4, True),
                                       (6, True)])
def test_calc_expec_diagonal_op(n, density):
    op, ref, vals = _ops(n, 50 + n)
    q, r, arr = _pair(n, density, 60 + n)
    got = tq.calcExpecDiagonalOp(q, op)
    assert isinstance(got, complex)
    assert abs(got - qt.calcExpecDiagonalOp(r, ref)) <= TOL
    want = (np.sum(vals * np.diag(arr)) if density
            else np.sum(vals * np.abs(arr) ** 2))
    assert abs(got - want) <= TOL


def _zz_hamil(m, n, rng):
    codes = np.zeros((m, n), np.int32)
    for t in range(m):
        codes[t, rng.choice(n, size=rng.integers(0, n + 1), replace=False)] = 3
    return codes, rng.standard_normal(m)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_init_diagonal_op_from_pauli_hamil(n):
    rng = np.random.default_rng(70 + n)
    codes, coeffs = _zz_hamil(6, n, rng)
    h = tq.createPauliHamil(n, 6)
    tq.initPauliHamil(h, coeffs, codes)
    rh = qt.createPauliHamil(n, 6)
    qt.initPauliHamil(rh, coeffs, codes)
    op = tq.createDiagonalOp(n, _env())
    tq.initDiagonalOpFromPauliHamil(op, h)
    ref = qt.createDiagonalOp(n, _ref_env())
    qt.initDiagonalOpFromPauliHamil(ref, rh)
    np.testing.assert_allclose(_vec(op.real), np.asarray(ref.real), rtol=0,
                               atol=TOL)
    assert not bool(op.imag.any())
    # the oracle: sum_t c_t (-1)^parity(d & zmask_t)
    d = np.arange(1 << n)
    want = sum(c * (-1.0) ** np.array([bin(x & sum(1 << q for q in range(n)
                                                  if codes[t, q] == 3))
                                      .count("1") for x in d])
               for t, c in enumerate(coeffs))
    np.testing.assert_allclose(_vec(op.real), want, rtol=0, atol=TOL)


def test_create_diagonal_op_from_pauli_hamil_file(tmp_path):
    path = tmp_path / "hamil.txt"
    path.write_text("0.5 3 0 3\n-1.25 0 3 0\n2 3 3 3\n")
    op = tq.createDiagonalOpFromPauliHamilFile(str(path), _env())
    ref = qt.createDiagonalOpFromPauliHamilFile(str(path), _ref_env())
    assert op.num_qubits == 3
    np.testing.assert_allclose(_vec(op.real), np.asarray(ref.real), rtol=0,
                               atol=TOL)
    bad = tmp_path / "x.txt"
    bad.write_text("0.5 1 0 3\n")
    msgs = []
    for mod, env in ((tq, _env()), (qt, _ref_env())):
        with pytest.raises(mod.QuESTError) as e:
            mod.createDiagonalOpFromPauliHamilFile(str(bad), env)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_diagonal_op_from_numpy():
    op, ref, vals = _ops(7, 80)
    got = interop.diagonal_op_from_numpy(np.asarray(ref.real),
                                         np.asarray(ref.imag), _env())
    assert got.num_qubits == 7
    assert torch.equal(got.real, op.real) and torch.equal(got.imag, op.imag)
    q, r, _vec0 = _pair(7, False, 81)
    tq.applyDiagonalOp(q, got)
    qt.applyDiagonalOp(r, ref)
    np.testing.assert_allclose(_amps(q), _amps(r), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        interop.diagonal_op_from_numpy(np.zeros(6), np.zeros(6), _env())


def test_apply_diagonal_op_records_qasm():
    op, ref, _ = _ops(3, 82)
    q, r, _ = _pair(3, False, 83)
    tq.startRecordingQASM(q)
    qt.startRecordingQASM(r)
    tq.applyDiagonalOp(q, op)
    qt.applyDiagonalOp(r, ref)
    assert str(q.qasm_log) == str(r.qasm_log)


# ---------------------------------------------------------------------------
# Validation: the reference's messages
# ---------------------------------------------------------------------------


def _same_error(call):
    """``call(module, env)`` raises the same message in both packages."""
    msgs = []
    for mod, env in ((tq, _env()), (qt, _ref_env())):
        with pytest.raises(mod.QuESTError) as e:
            call(mod, env)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def _hamil(mod, n, codes):
    h = mod.createPauliHamil(n, len(codes))
    mod.initPauliHamil(h, [1.0] * len(codes), codes)
    return h


DIAG_ERRORS = {
    "create_zero": lambda m, e: m.createDiagonalOp(0, e),
    "elem_index": lambda m, e: m.setDiagonalOpElems(
        m.createDiagonalOp(3, e), 8, [1.0], [0.0], 1),
    "num_elems": lambda m, e: m.setDiagonalOpElems(
        m.createDiagonalOp(3, e), 0, [1.0] * 9, [0.0] * 9, 9),
    "offset": lambda m, e: m.setDiagonalOpElems(
        m.createDiagonalOp(3, e), 5, [1.0] * 4, [0.0] * 4, 4),
    "not_finite": lambda m, e: m.setDiagonalOpElems(
        m.createDiagonalOp(3, e), 0, [np.nan], [0.0], 1),
    "apply_size": lambda m, e: m.applyDiagonalOp(
        m.createQureg(4, e), m.createDiagonalOp(3, e)),
    "expec_size": lambda m, e: m.calcExpecDiagonalOp(
        m.createDensityQureg(2, e), m.createDiagonalOp(3, e)),
    "not_initialised": lambda m, e: m.calcExpecDiagonalOp(
        m.createQureg(3, e), None),
    "hamil_not_diagonal": lambda m, e: m.initDiagonalOpFromPauliHamil(
        m.createDiagonalOp(2, e), _hamil(m, 2, [[1, 0]])),
    "hamil_size": lambda m, e: m.initDiagonalOpFromPauliHamil(
        m.createDiagonalOp(3, e), _hamil(m, 2, [[3, 0]])),
}


@pytest.mark.parametrize("case", sorted(DIAG_ERRORS))
def test_diagonal_validation_messages(case):
    msg = _same_error(DIAG_ERRORS[case])
    assert msg.split(":")[0] in (
        "createDiagonalOp", "setDiagonalOpElems", "applyDiagonalOp",
        "calcExpecDiagonalOp", "initDiagonalOpFromPauliHamil")
