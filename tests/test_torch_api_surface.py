"""The rest of quest_tpu_torch's single-register API (M13) against
quest_tpu's, on the CPU at float64.

* Each new call, one parametrised case per call, on a 5-qubit state
  vector and a 3-qubit density matrix where the call takes one: the
  gates (rotateAroundAxis, controlledRotateAroundAxis,
  multiControlledPhaseShift, multiControlledPhaseFlip), the raw
  matrices (applyMatrix2/4/N, applyMultiControlledMatrixN),
  setWeightedQureg, the state setters (initStateFromAmps, setDensityAmps,
  initSparseState, initSparseClusteredState, cloneQureg,
  initStateOfSingleQubit), the reads (getProbAmp, getDensityAmp,
  compareStates), the reports (reportState's file, reportStateToScreen,
  reportQuregParams, printRecordedQASM), ComplexMatrixN, the optimizer's
  modes and the misc calls.  States within 1e-10, values within 1e-12,
  text letter for letter.
* Validation: each new call's invalid inputs raise the reference's
  message.
* The QASM of a recorded circuit of the new gates and measurements,
  letter for letter; the state CSV files written by each package and
  read by the other.
* The call sequences of examples/tutorial_example.py,
  bernstein_vazirani.py, phase_estimation.py, shot_sampling.py and
  grovers_search.py (a fixed solution in place of its unseeded draw) at
  their default sizes, through both packages with the same seed: the
  same outcomes, probabilities within 1e-10.
"""

import functools
import math
from collections import Counter

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import circuit as RC
from quest_tpu import optimizer as RO
from quest_tpu import rng as ref_rng
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu_torch import circuit as TC
from quest_tpu_torch import optimizer as TO
from quest_tpu_torch import precision, rng
from quest_tpu_torch.ops import measurement as M

torch.set_num_threads(1)

STOL = 1e-10
VTOL = 1e-12
N_SV, N_RHO = 5, 3


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


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


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


@functools.lru_cache(maxsize=None)
def _port_env():
    return tq.createQuESTEnv(device="cpu")


def _env(pkg):
    return _ref_env() if pkg is qt else _port_env()


def _amps(q):
    a = q.amps
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _matrix(dim, seed):
    rng_ = np.random.default_rng(seed)
    return rng_.standard_normal((dim, dim)) + 1j * rng_.standard_normal(
        (dim, dim))


def _reg(pkg, kind, seed=0):
    """A register of ``kind`` ("sv" or "rho") in a random state made from
    ``seed`` (the same numbers in both packages)."""
    env = _env(pkg)
    rng_ = np.random.default_rng(seed)
    if kind == "sv":
        q = pkg.createQureg(N_SV, env)
        z = rng_.standard_normal(1 << N_SV) + 1j * rng_.standard_normal(
            1 << N_SV)
        z /= np.linalg.norm(z)
        pkg.initStateFromAmps(q, z.real, z.imag)
    else:
        q = pkg.createDensityQureg(N_RHO, env)
        a = _matrix(1 << N_RHO, seed)
        rho = a @ a.conj().T
        rho /= np.trace(rho).real
        flat = rho.T.ravel()
        pkg.setDensityAmps(q, flat.real, flat.imag)
    return q


M2, M4, M8 = _matrix(2, 1), _matrix(4, 2), _matrix(8, 3)


def _sparse(pkg, q):
    pkg.initSparseState(q, [3, 0, 17], [0.6, 0.48j, -0.64])


def _clustered(pkg, q):
    pkg.initSparseClusteredState(q, [2, 20], [[0.5, 0.5j], [-0.5, 0.5]])


def _clone(pkg, q):
    other = _reg(pkg, "rho" if q.is_density_matrix else "sv", seed=9)
    pkg.cloneQureg(q, other)


def _weighted(pkg, q):
    kind = "rho" if q.is_density_matrix else "sv"
    a, b = _reg(pkg, kind, seed=21), _reg(pkg, kind, seed=22)
    pkg.setWeightedQureg(0.3 - 0.2j, a, 1.1j, b, -0.7 + 0.1j, q)


def _weighted_aliased(pkg, q):
    kind = "rho" if q.is_density_matrix else "sv"
    a = _reg(pkg, kind, seed=23)
    pkg.setWeightedQureg(0.5, q, 0.25j, a, 2.0, q)


STATE_CASES = {
    "rotateAroundAxis": (
        ("sv", "rho"), lambda m, q: m.rotateAroundAxis(
            q, 1, 0.7, (0.3, -0.4, 0.5))),
    "rotateAroundAxis_Vector": (
        ("sv", "rho"), lambda m, q: m.rotateAroundAxis(
            q, 2, 1.1, m.Vector(0.0, 2.0, -1.0))),
    "controlledRotateAroundAxis": (
        ("sv", "rho"), lambda m, q: m.controlledRotateAroundAxis(
            q, 0, 2, -0.9, (1.0, 1.0, 1.0))),
    "multiControlledPhaseShift": (
        ("sv", "rho"), lambda m, q: m.multiControlledPhaseShift(
            q, [0, 2, 1], 0.9)),
    "multiControlledPhaseShift_one_qubit": (
        ("sv",), lambda m, q: m.multiControlledPhaseShift(q, [4], -0.4)),
    "multiControlledPhaseFlip": (
        ("sv", "rho"), lambda m, q: m.multiControlledPhaseFlip(q, [2, 0, 1])),
    "applyMatrix2": (
        ("sv", "rho"), lambda m, q: m.applyMatrix2(q, 1, M2)),
    "applyMatrix4": (
        ("sv", "rho"), lambda m, q: m.applyMatrix4(q, 2, 0, M4)),
    "applyMatrixN": (
        ("sv", "rho"), lambda m, q: m.applyMatrixN(q, [1, 2, 0], M8)),
    "applyMultiControlledMatrixN": (
        ("sv", "rho"), lambda m, q: m.applyMultiControlledMatrixN(
            q, [0], [2, 1], M4)),
    "setWeightedQureg": (("sv", "rho"), _weighted),
    "setWeightedQureg_aliased": (("sv", "rho"), _weighted_aliased),
    "initStateFromAmps": (
        ("sv",), lambda m, q: m.initStateFromAmps(
            q, np.linspace(-1, 1, 32), np.linspace(0.5, -0.5, 32))),
    "setDensityAmps": (
        ("rho",), lambda m, q: m.setDensityAmps(
            q, np.linspace(-1, 1, 64), np.cos(np.arange(64)))),
    "initSparseState": (("sv",), _sparse),
    "initSparseClusteredState": (("sv",), _clustered),
    "cloneQureg": (("sv", "rho"), _clone),
    "initStateOfSingleQubit": (
        ("sv", "rho"), lambda m, q: m.initStateOfSingleQubit(q, 1, 1)),
}


@pytest.mark.parametrize("name,kind", [
    (name, kind) for name, (kinds, _) in STATE_CASES.items()
    for kind in kinds])
def test_state_call_matches_reference(name, kind):
    call = STATE_CASES[name][1]
    r, p = _reg(qt, kind, seed=4), _reg(tq, kind, seed=4)
    call(qt, r)
    call(tq, p)
    assert np.abs(_amps(r) - _amps(p)).max() <= STOL


def _values(pkg):
    sv, rho = _reg(pkg, "sv", seed=5), _reg(pkg, "rho", seed=6)
    sv2 = _reg(pkg, "sv", seed=5)
    pkg.rotateX(sv2, 0, 1e-9)
    return sv, rho, sv2


VALUE_CASES = {
    "getProbAmp": lambda m, sv, rho, sv2: [m.getProbAmp(sv, i)
                                           for i in (0, 7, 31)],
    "getDensityAmp": lambda m, sv, rho, sv2: [m.getDensityAmp(rho, r, c)
                                              for r, c in ((0, 0), (3, 5),
                                                           (7, 2))],
    "compareStates": lambda m, sv, rho, sv2: [
        m.compareStates(sv, sv2, 1e-6), m.compareStates(sv, sv2, 1e-12),
        m.compareStates(sv, rho, 1.0)],
    "syncQuESTSuccess": lambda m, sv, rho, sv2: [m.syncQuESTSuccess(1),
                                                 m.syncQuESTSuccess(0)],
    "copyStateToGPU_FromGPU": lambda m, sv, rho, sv2: [
        m.copyStateToGPU(sv), m.copyStateFromGPU(sv)],
    "createComplexMatrixN": lambda m, sv, rho, sv2: m.createComplexMatrixN(2),
    "initComplexMatrixN": lambda m, sv, rho, sv2: _init_matrix(m),
    "getStaticComplexMatrixN": lambda m, sv, rho, sv2:
        m.getStaticComplexMatrixN([[1, 2], [3, 4]], [[0, -1], [1, 0]]),
    "destroyComplexMatrixN": lambda m, sv, rho, sv2: [
        m.destroyComplexMatrixN(m.createComplexMatrixN(1))],
    "precision_dtypes": lambda m, sv, rho, sv2: [
        str(m.real_dtype()).split(".")[-1].replace("'>", ""),
        str(m.complex_dtype()).split(".")[-1].replace("'>", ""),
        m.validation_eps()],
}


def _init_matrix(m):
    mat = m.createComplexMatrixN(1)
    m.initComplexMatrixN(mat, [[1, 0], [0.5, 2]], [[0, 1], [-1, 0]])
    return mat


@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_value_call_matches_reference(name):
    want = VALUE_CASES[name](qt, *_values(qt))
    got = VALUE_CASES[name](tq, *_values(tq))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert abs(g - w) <= VTOL
        elif isinstance(w, complex):
            assert abs(g - w) <= VTOL
        else:
            assert g == w


REPORTS = {
    "reportStateToScreen": lambda m, q: m.reportStateToScreen(q),
    "reportQuregParams": lambda m, q: m.reportQuregParams(q),
    "printRecordedQASM": lambda m, q: (m.startRecordingQASM(q),
                                       m.hadamard(q, 0),
                                       m.multiControlledPhaseFlip(q, [0, 1]),
                                       m.printRecordedQASM(q)),
}


@pytest.mark.parametrize("kind", ["sv", "rho"])
@pytest.mark.parametrize("name", list(REPORTS))
def test_report_prints_the_reference_text(name, kind, capsys):
    r, p = _reg(qt, kind, seed=7), _reg(tq, kind, seed=7)
    capsys.readouterr()
    REPORTS[name](qt, r)
    want = capsys.readouterr().out
    REPORTS[name](tq, p)
    assert capsys.readouterr().out == want
    assert want


@pytest.mark.parametrize("kind", ["sv", "rho"])
def test_report_state_writes_the_reference_file(kind, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    qt.reportState(_reg(qt, kind, seed=8))
    want = (tmp_path / "state_rank_0.csv").read_text()
    (tmp_path / "state_rank_0.csv").unlink()
    tq.reportState(_reg(tq, kind, seed=8))
    assert (tmp_path / "state_rank_0.csv").read_text() == want
    assert want.startswith("real, imag\n")


def test_invalid_quest_input_error_message():
    with pytest.raises(qt.QuESTError) as ref_err:
        qt.invalidQuESTInputError("bad thing", "someFunc")
    with pytest.raises(tq.QuESTError) as err:
        tq.invalidQuESTInputError("bad thing", "someFunc")
    assert str(err.value) == str(ref_err.value) == "someFunc: bad thing"


ERROR_CASES = {
    "rotateAroundAxis_zero": lambda m, sv, rho: m.rotateAroundAxis(
        sv, 0, 0.3, (0.0, 0.0, 0.0)),
    "rotateAroundAxis_target": lambda m, sv, rho: m.rotateAroundAxis(
        sv, 5, 0.3, (1.0, 0.0, 0.0)),
    "controlledRotateAroundAxis_same": lambda m, sv, rho:
        m.controlledRotateAroundAxis(sv, 1, 1, 0.3, (1.0, 0.0, 0.0)),
    "multiControlledPhaseFlip_repeat": lambda m, sv, rho:
        m.multiControlledPhaseFlip(sv, [0, 2, 0]),
    "multiControlledPhaseFlip_empty": lambda m, sv, rho:
        m.multiControlledPhaseFlip(sv, []),
    "multiControlledPhaseShift_index": lambda m, sv, rho:
        m.multiControlledPhaseShift(sv, [0, 7], 0.1),
    "applyMatrix2_size": lambda m, sv, rho: m.applyMatrix2(sv, 0, M4),
    "applyMatrix4_same": lambda m, sv, rho: m.applyMatrix4(sv, 1, 1, M4),
    "applyMatrixN_size": lambda m, sv, rho: m.applyMatrixN(sv, [0, 1], M8),
    "applyMatrixN_nan": lambda m, sv, rho: m.applyMatrixN(
        sv, [0], np.array([[np.nan, 0], [0, 1]])),
    "applyMultiControlledMatrixN_overlap": lambda m, sv, rho:
        m.applyMultiControlledMatrixN(sv, [1], [1, 2], M4),
    "setWeightedQureg_types": lambda m, sv, rho: m.setWeightedQureg(
        1, sv, 1, rho, 1, sv),
    "cloneQureg_types": lambda m, sv, rho: m.cloneQureg(sv, rho),
    "initStateFromAmps_density": lambda m, sv, rho: m.initStateFromAmps(
        rho, np.zeros(64), np.zeros(64)),
    "initStateFromAmps_count": lambda m, sv, rho: m.initStateFromAmps(
        sv, np.zeros(31), np.zeros(31)),
    "setDensityAmps_statevec": lambda m, sv, rho: m.setDensityAmps(
        sv, np.zeros(32), np.zeros(32)),
    "initSparseState_index": lambda m, sv, rho: m.initSparseState(
        sv, [0, 32], [1, 0]),
    "initSparseState_duplicate": lambda m, sv, rho: m.initSparseState(
        sv, [1, 1], [0.6, 0.8]),
    "initSparseState_lengths": lambda m, sv, rho: m.initSparseState(
        sv, [1, 2], [1.0]),
    "initSparseClusteredState_empty": lambda m, sv, rho:
        m.initSparseClusteredState(sv, [0], [[]]),
    "getDensityAmp_statevec": lambda m, sv, rho: m.getDensityAmp(sv, 0, 0),
    "getDensityAmp_index": lambda m, sv, rho: m.getDensityAmp(rho, 8, 0),
    "getProbAmp_index": lambda m, sv, rho: m.getProbAmp(sv, 32),
    "initStateOfSingleQubit_outcome": lambda m, sv, rho:
        m.initStateOfSingleQubit(sv, 0, 2),
    "createComplexMatrixN_zero": lambda m, sv, rho:
        m.createComplexMatrixN(0),
    "setCircuitOptimizer_mode": lambda m, sv, rho:
        m.setCircuitOptimizer("fast"),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_invalid_input_raises_the_reference_message(name):
    with pytest.raises(qt.QuESTError) as ref_err:
        ERROR_CASES[name](qt, _reg(qt, "sv"), _reg(qt, "rho"))
    with pytest.raises(tq.QuESTError) as err:
        ERROR_CASES[name](tq, _reg(tq, "sv"), _reg(tq, "rho"))
    assert str(err.value) == str(ref_err.value)


def test_set_density_amps_rejects_a_wrong_count():
    """The reference stores whatever it is given; the port refuses an
    array of the wrong size instead of holding a broken register."""
    p = _reg(tq, "rho")
    before = p.amps.clone()
    with pytest.raises(tq.QuESTError, match="Incorrect number"):
        tq.setDensityAmps(p, np.zeros(63), np.zeros(63))
    assert torch.equal(p.amps, before)


# ---------------------------------------------------------------------------
# The optimizer's modes
# ---------------------------------------------------------------------------


def _items(gate):
    h = np.stack([np.array([[1, 1], [1, -1]]) / np.sqrt(2), np.zeros((2, 2))])
    x = np.stack([np.array([[0.0, 1], [1, 0]]), np.zeros((2, 2))])
    z = np.stack([np.diag([1.0, -1.0]), np.zeros((2, 2))])
    s = np.stack([np.diag([1.0, 0.0]), np.diag([0.0, 1.0])])
    return [gate((0,), h), gate((0,), h), gate((1,), x), gate((1,), x),
            gate((2,), z), gate((2, 3), np.stack([np.eye(4),
                                                  np.zeros((4, 4))])),
            gate((2,), s), gate((3,), h)]


@pytest.mark.parametrize("mode", ["off", "on", "aggressive"])
def test_optimizer_modes_match_reference(mode, monkeypatch):
    monkeypatch.delenv("QT_OPTIMIZER", raising=False)
    try:
        qt.setCircuitOptimizer(mode)
        tq.setCircuitOptimizer(mode)
        assert tq.getCircuitOptimizer() == qt.getCircuitOptimizer() == mode
        assert tq.get_circuit_optimizer() == mode
        ref_out, ref_stats = RO.optimize_items(_items(RC.Gate), n=6, nloc=6,
                                               quiet=True)
        out, stats = TO.optimize_items(_items(TC.Gate), nloc=6)
        assert stats["mode"] == mode
        assert stats["removed"] == ref_stats["removed"]
        assert [g.targets for g in out] == [g.targets for g in ref_out]
        for g, w in zip(out, ref_out):
            assert np.abs(g.mat - np.asarray(w.mat)).max() <= VTOL
    finally:
        qt.setCircuitOptimizer(None)
        tq.setCircuitOptimizer(None)


@pytest.mark.parametrize("mode", ["off", "on", "aggressive"])
def test_optimizer_mode_from_the_environment(mode, monkeypatch):
    monkeypatch.setenv("QT_OPTIMIZER", mode)
    assert tq.getCircuitOptimizer() == mode
    tq.setCircuitOptimizer("off")
    try:
        assert tq.getCircuitOptimizer() == "off"
    finally:
        tq.setCircuitOptimizer(None)
    assert tq.getCircuitOptimizer() == mode


@pytest.mark.parametrize("mode", ["off", "on", "aggressive"])
def test_fused_drain_under_each_mode_matches_reference(mode, monkeypatch):
    """A gateFusion block of cancelling and merging gates drains to the
    reference's state under each mode."""
    monkeypatch.setenv("QT_OPTIMIZER", mode)
    states = []
    for pkg in (qt, tq):
        q = _reg(pkg, "sv", seed=10)
        with pkg.gateFusion(q):
            for t in range(N_SV):
                pkg.hadamard(q, t)
                pkg.hadamard(q, t)
                pkg.pauliX(q, t)
                pkg.rotateZ(q, t, 0.3)
                pkg.rotateZ(q, t, -0.1)
            pkg.controlledNot(q, 0, 1)
            pkg.controlledNot(q, 0, 1)
            pkg.multiControlledPhaseShift(q, [1, 2, 3], 0.5)
        states.append(_amps(q))
    assert np.abs(states[0] - states[1]).max() <= STOL


# ---------------------------------------------------------------------------
# QASM and state files
# ---------------------------------------------------------------------------


def _record(pkg):
    q = pkg.createQureg(4, _env(pkg))
    pkg.seedQuEST(_env(pkg), [77])
    pkg.startRecordingQASM(q)
    pkg.initZeroState(q)
    pkg.hadamard(q, 0)
    pkg.rotateAroundAxis(q, 1, 0.4, (0.0, 1.0, 0.0))
    pkg.rotateAroundAxis(q, 2, -1.3, pkg.Vector(1, -2, 0.5))
    pkg.controlledRotateAroundAxis(q, 0, 3, 2.2, (0.3, 0.3, -0.9))
    pkg.multiControlledPhaseShift(q, [0, 1, 3], 0.75)
    pkg.multiControlledPhaseShift(q, [2], -0.25)
    pkg.multiControlledPhaseFlip(q, [3, 1, 0])
    pkg.multiControlledPhaseFlip(q, [2])
    pkg.applyMatrix2(q, 1, M2 / np.linalg.norm(M2))
    pkg.applyMatrixN(q, [0, 2], np.eye(4))
    pkg.collapseToOutcome(q, 3, int(pkg.calcProbOfOutcome(q, 3, 1) > 0.5))
    pkg.measure(q, 0)
    pkg.measureWithStats(q, 2)
    pkg.measureSequence(q, [1, 3])
    return q


def test_recorded_qasm_is_the_reference_text(tmp_path, capsys):
    r, p = _record(qt), _record(tq)
    want = str(r.qasm_log)
    assert str(p.qasm_log) == want
    assert "measure q[3] -> c[3];" in want and "cRz(" in want
    qt.writeRecordedQASMToFile(r, str(tmp_path / "ref.qasm"))
    tq.writeRecordedQASMToFile(p, str(tmp_path / "port.qasm"))
    assert (tmp_path / "port.qasm").read_text() == \
        (tmp_path / "ref.qasm").read_text() == want
    qt.clearRecordedQASM(r)
    tq.clearRecordedQASM(p)
    capsys.readouterr()
    qt.printRecordedQASM(r)
    cleared = capsys.readouterr().out
    tq.printRecordedQASM(p)
    assert capsys.readouterr().out == cleared == str(p.qasm_log)
    assert cleared.count("\n") == 3


def test_write_recorded_qasm_to_an_unwritable_path(tmp_path):
    bad = str(tmp_path / "no" / "such" / "dir.qasm")
    with pytest.raises(qt.QuESTError) as ref_err:
        qt.writeRecordedQASMToFile(_record(qt), bad)
    with pytest.raises(tq.QuESTError) as err:
        tq.writeRecordedQASMToFile(_record(tq), bad)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("kind", ["sv", "rho"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_files_cross_read(writer, kind, tmp_path):
    """A state file written by either package is the other's byte for
    byte, and each package reads it back to the same state."""
    r, p = _reg(qt, kind, seed=11), _reg(tq, kind, seed=11)
    qt.writeStateToFile(r, str(tmp_path / "ref.csv"))
    tq.writeStateToFile(p, str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    src = str(tmp_path / ("ref.csv" if writer == "reference"
                          else "port.csv"))
    r2, p2 = _reg(qt, kind, seed=12), _reg(tq, kind, seed=12)
    assert qt.readStateFromFile(r2, src) is True
    assert tq.readStateFromFile(p2, src) is True
    assert np.array_equal(_amps(p2), _amps(p))
    assert np.array_equal(_amps(r2), _amps(p2))
    p3 = _reg(tq, kind, seed=13)
    assert tq.initStateFromSingleFile(p3, src) is True
    assert np.array_equal(_amps(p3), _amps(p))


BAD_FILES = {
    "missing": None,
    "malformed": "# x\n0.5, 0.5\nnot, a number\n",
    "truncated": "0.5, 0.5\n0.5, 0.5\n",
    "nan": "nan, 0.0\n" + "0.1, 0.0\n" * 40,
    "one_column": "0.5\n" * 40,
}


@pytest.mark.parametrize("bad", list(BAD_FILES))
def test_failed_read_leaves_the_register_untouched(bad, tmp_path):
    path = tmp_path / "bad.csv"
    if BAD_FILES[bad] is not None:
        path.write_text(BAD_FILES[bad])
    r, p = _reg(qt, "sv", seed=14), _reg(tq, "sv", seed=14)
    before = p.amps.clone()
    assert qt.readStateFromFile(r, str(path)) is False
    assert tq.readStateFromFile(p, str(path)) is False
    assert torch.equal(p.amps, before)


def test_read_ignores_lines_beyond_the_register(tmp_path):
    path = tmp_path / "long.csv"
    path.write_text("".join(f"{k / 64!r}, {-k / 64!r}\n" for k in range(40)))
    r, p = _reg(qt, "sv"), _reg(tq, "sv")
    assert qt.readStateFromFile(r, str(path)) is True
    assert tq.readStateFromFile(p, str(path)) is True
    assert np.array_equal(_amps(p), _amps(r))


# ---------------------------------------------------------------------------
# The examples' call sequences
# ---------------------------------------------------------------------------

SEED = [2024, 7]


def tutorial(pkg, env):
    out = []
    qubits = pkg.createQureg(3, env)
    pkg.initZeroState(qubits)
    pkg.hadamard(qubits, 0)
    pkg.controlledNot(qubits, 0, 1)
    pkg.rotateY(qubits, 2, 0.1)
    pkg.multiControlledPhaseFlip(qubits, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    pkg.unitary(qubits, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    pkg.compactUnitary(qubits, 1, a, b)
    pkg.rotateAroundAxis(qubits, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    pkg.controlledCompactUnitary(qubits, 0, 1, a, b)
    pkg.multiControlledUnitary(qubits, [0, 1], 2, u)
    toff = np.eye(8, dtype=complex)
    toff[6, 6] = toff[7, 7] = 0.0
    toff[6, 7] = toff[7, 6] = 1.0
    pkg.multiQubitUnitary(qubits, [0, 1, 2], toff)
    out.append(pkg.getProbAmp(qubits, 7))
    out.append(pkg.calcProbOfOutcome(qubits, 2, 1))
    out.append(pkg.measure(qubits, 0))
    out.extend(pkg.measureWithStats(qubits, 2))
    pkg.destroyQureg(qubits, env)
    return out


def bernstein_vazirani(pkg, env):
    num_qubits, secret = 9, 2 ** 4 + 1
    qureg = pkg.createQureg(num_qubits, env)
    pkg.initZeroState(qureg)
    pkg.pauliX(qureg, 0)
    for q in range(num_qubits):
        pkg.hadamard(qureg, q)
    for q in range(1, num_qubits):
        if (secret >> (q - 1)) & 1:
            pkg.controlledNot(qureg, q, 0)
    for q in range(1, num_qubits):
        pkg.hadamard(qureg, q)
    found = 0
    for q in range(1, num_qubits):
        found |= pkg.measure(qureg, q) << (q - 1)
    assert found == secret
    return [found]


def phase_estimation(pkg, env):
    out = []
    num_counting, phi = 8, 0.3828125
    for fused in (False, True):
        n = num_counting + 1
        q = pkg.createQureg(n, env)
        pkg.initClassicalState(q, 1 << num_counting)

        def circuit():
            for k in range(num_counting):
                pkg.hadamard(q, k)
            for k in range(num_counting):
                pkg.controlledPhaseShift(
                    q, k, num_counting, 2 * math.pi * phi * (1 << k))
            qubits = list(range(num_counting))
            for i in range(num_counting // 2):
                pkg.swapGate(q, qubits[i], qubits[num_counting - 1 - i])
            for j in range(num_counting):
                for k in range(j):
                    pkg.controlledPhaseShift(q, qubits[k], qubits[j],
                                             -math.pi / (1 << (j - k)))
                pkg.hadamard(q, qubits[j])

        if fused:
            with pkg.gateFusion(q):
                circuit()
        else:
            circuit()
        outcome = 0
        for k in range(num_counting):
            outcome |= pkg.measure(q, k) << k
        out.append(outcome / (1 << num_counting))
    assert out == [phi, phi]
    return out


def shot_sampling(pkg, env):
    n, shots = 10, 200
    counts = Counter()
    for _ in range(shots):
        q = pkg.createQureg(n, env)
        with pkg.gateFusion(q):
            pkg.hadamard(q, 0)
            for t in range(1, n):
                pkg.controlledNot(q, t - 1, t)
            for t in range(n):
                pkg.rotateY(q, t, 0.15 * (t + 1))
        outcomes, _probs = pkg.measureSequence(q, range(n))
        counts["".join(map(str, reversed(outcomes)))] += 1
    assert len(counts) > 1
    return sorted(counts.items())


def grovers_search(pkg, env):
    num_qubits, sol = 12, 2741
    num_reps = math.ceil(math.pi / 4 * math.sqrt(2 ** num_qubits))
    qureg = pkg.createQureg(num_qubits, env)
    pkg.initPlusState(qureg)
    probs = []
    everything = list(range(num_qubits))
    for _ in range(num_reps):
        for q in everything:
            if not (sol >> q) & 1:
                pkg.pauliX(qureg, q)
        pkg.multiControlledPhaseFlip(qureg, everything)
        for q in everything:
            if not (sol >> q) & 1:
                pkg.pauliX(qureg, q)
        for q in everything:
            pkg.hadamard(qureg, q)
        for q in everything:
            pkg.pauliX(qureg, q)
        pkg.multiControlledPhaseFlip(qureg, everything)
        for q in everything:
            pkg.pauliX(qureg, q)
        for q in everything:
            pkg.hadamard(qureg, q)
        probs.append(pkg.getProbAmp(qureg, sol))
    assert probs[-1] > 0.99
    return probs


EXAMPLES = {"tutorial_example": tutorial,
            "bernstein_vazirani": bernstein_vazirani,
            "phase_estimation": phase_estimation,
            "shot_sampling": shot_sampling,
            "grovers_search": grovers_search}


@pytest.mark.parametrize("route", ["fused", "host"])
@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_call_sequence_matches_reference(name, route, monkeypatch):
    if route == "host":
        monkeypatch.setenv("QT_HOST_MEASURE", "1")
    else:
        monkeypatch.delenv("QT_HOST_MEASURE", raising=False)
    results = []
    for pkg in (qt, tq):
        env = _env(pkg)
        pkg.seedQuEST(env, SEED)
        results.append(EXAMPLES[name](pkg, env))
    want, got = results
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert abs(g - w) <= STOL
        else:
            assert g == w
