"""quest_tpu_torch's foundations against quest_tpu's: SoA complex helpers,
gate definitions, precision selection, and the validation layer's
messages (which must be the same text for the same bad input).

Tolerance for the numeric checks: 1e-14 absolute at float64 — the helpers
do one or two roundings per element, in the same order as NumPy.
"""

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu.ops import cplx as ref_cplx
from quest_tpu.ops import gatedefs as ref_gd
from quest_tpu_torch import precision
from quest_tpu_torch.ops import cplx
from quest_tpu_torch.ops import gatedefs as gd

torch.set_num_threads(1)

TOL = 1e-14


@pytest.fixture
def double():
    """The port at double precision for the length of one test."""
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


def _z(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_soa_round_trip_matches_reference():
    rng = np.random.default_rng(0)
    z = _z(rng, (4, 4))
    assert np.array_equal(cplx.soa(z), ref_cplx.soa(z))
    assert np.array_equal(cplx.unsoa(cplx.soa(z)), z)
    assert cplx.soa(z, np.float32).dtype == np.float32


@pytest.mark.parametrize("fn", ["cmul", "conj", "abs2", "vdot",
                                "to_from_complex"])
def test_tensor_helpers_match_numpy(fn):
    rng = np.random.default_rng(1)
    a, b = _z(rng, (64,)), _z(rng, (64,))
    sa, sb = torch.from_numpy(cplx.soa(a)), torch.from_numpy(cplx.soa(b))
    if fn == "cmul":
        got = cplx.unsoa(cplx.cmul(sa, float(b[0].real), float(b[0].imag))
                         .numpy())
        want = a * b[0]
    elif fn == "conj":
        got = cplx.unsoa(cplx.conj(sa).numpy())
        want = a.conj()
        assert np.array_equal(cplx.conj(cplx.soa(a)), ref_cplx.conj(
            cplx.soa(a)))
    elif fn == "abs2":
        got, want = cplx.abs2(sa).numpy(), np.abs(a) ** 2
    elif fn == "vdot":
        got = cplx.unsoa(cplx.vdot(sa, sb).numpy())
        want = np.vdot(a, b)
    else:
        got = cplx.unsoa(cplx.from_complex(cplx.to_complex(sa)).numpy())
        want = a
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 100)


@pytest.mark.parametrize("name", ["PAULI_I", "PAULI_X", "PAULI_Y", "PAULI_Z",
                                  "HADAMARD", "S_GATE_DIAG", "T_GATE_DIAG",
                                  "Z_DIAG", "SQRT_SWAP"])
def test_gate_constants_match_reference(name):
    assert np.array_equal(getattr(gd, name), getattr(ref_gd, name))


@pytest.mark.parametrize("fn,args", [
    ("compact_unitary_matrix", (0.6 + 0.0j, 0.0 + 0.8j)),
    ("rotate_x_matrix", (0.3,)), ("rotate_y_matrix", (-1.1,)),
    ("rotate_z_diag", (2.5,)), ("phase_shift_diag", (0.7,)),
    ("rotate_around_axis_matrix", (0.9, (1.0, -2.0, 0.5))),
    ("pauli_product_matrix", ((1, 2, 3, 0),)),
])
def test_gate_builders_match_reference(fn, args):
    np.testing.assert_allclose(getattr(gd, fn)(*args),
                               getattr(ref_gd, fn)(*args), rtol=0, atol=TOL)


@pytest.mark.parametrize("prec,dtype", [(1, torch.float32),
                                        (2, torch.float64)])
def test_precision_selects_dtype_and_eps(prec, dtype):
    old = precision.get_precision()
    try:
        tq.set_precision(prec)
        assert precision.real_dtype() == dtype
        assert tq.get_precision() == prec
        assert tq.real_eps() == qt.precision._REAL_EPS[prec]
        q = tq.createQureg(3, tq.createQuESTEnv(device="cpu"))
        assert q.amps.dtype == dtype
    finally:
        tq.set_precision(old)


def test_unknown_precision_raises():
    with pytest.raises(ValueError):
        tq.set_precision(3)


# (label, call) pairs: call(module, env) performs one invalid operation
# through module's API on a fresh 5-qubit register
_BAD = [
    ("zero qubits", lambda m, e: m.createQureg(0, e)),
    ("target out of range", lambda m, e: m.hadamard(m.createQureg(5, e), 5)),
    ("negative target", lambda m, e: m.pauliX(m.createQureg(5, e), -1)),
    ("control is target",
     lambda m, e: m.controlledNot(m.createQureg(5, e), 1, 1)),
    ("non-unitary",
     lambda m, e: m.unitary(m.createQureg(5, e), 0,
                            np.array([[1, 1], [0, 1]], complex))),
    ("unnormalised compact pair",
     lambda m, e: m.compactUnitary(m.createQureg(5, e), 0, 1.0, 1.0)),
    ("state index",
     lambda m, e: m.initClassicalState(m.createQureg(5, e), 32)),
    ("outcome", lambda m, e: m.calcProbOfOutcome(m.createQureg(5, e), 0, 2)),
    ("duplicate targets",
     lambda m, e: m.multiQubitUnitary(m.createQureg(5, e), [1, 1],
                                      np.eye(4, dtype=complex))),
    ("target in controls",
     lambda m, e: m.multiControlledUnitary(m.createQureg(5, e), [0, 2], 2,
                                           np.eye(2, dtype=complex))),
    ("amp index", lambda m, e: m.getAmp(m.createQureg(5, e), 40)),
    ("set amps range",
     lambda m, e: m.setAmps(m.createQureg(5, e), 30, [0.0] * 4, [0.0] * 4,
                            4)),
    ("swap same qubit", lambda m, e: m.swapGate(m.createQureg(5, e), 2, 2)),
]


@pytest.mark.parametrize("label,call", _BAD, ids=[b[0] for b in _BAD])
def test_validation_messages_match_reference(double, label, call):
    with pytest.raises(qt.QuESTError) as ref_err:
        call(qt, qt.createQuESTEnv(num_devices=1))
    with pytest.raises(tq.QuESTError) as port_err:
        call(tq, tq.createQuESTEnv(device="cpu"))
    assert str(port_err.value) == str(ref_err.value)
