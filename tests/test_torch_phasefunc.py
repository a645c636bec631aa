"""Phase functions of quest_tpu_torch against quest_tpu, on the CPU at
float64.

* ``applyPhaseFunc``/``applyPhaseFuncOverrides`` (one sub-register,
  polynomial) and ``applyMultiVarPhaseFunc``/``...Overrides`` (several),
  under both encodings, on state vectors (8-12 qubits) and density
  registers (4-6 qubits; the phase acts on the ket qubits, as in the
  reference).
* Every named function (the norm, product and distance families, scaled,
  inverse and shifted), through ``applyNamedPhaseFunc``,
  ``applyParamNamedPhaseFunc`` and their ``*Overrides`` forms, under both
  encodings.
* The QASM records of each, character for character, and the
  validators' messages word for word.
* The public names: the phase-function and diagonal-operator API and the
  enum constants are exported, and 37 of the reference's public names are
  left to port.

Tolerance: 1e-10 absolute against the reference (cos/sin of the same
float64 phases, one complex multiply), and against the NumPy oracle of
tests/test_operators.py (``_phase_expect``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu_torch import precision

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
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


def _amps(q):
    a = q.amps
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _pair(n, density=False, seed=0, record=False):
    rng = np.random.default_rng(seed)
    arr = (oracle.random_density(n, rng) if density
           else oracle.random_state(n, rng))
    make = "createDensityQureg" if density else "createQureg"
    q = getattr(tq, make)(n, tq.createQuESTEnv(device="cpu"))
    r = getattr(qt, make)(n, _ref_env())
    oracle.set_qureg_from_array(tq, q, arr)
    oracle.set_qureg_from_array(qt, r, arr)
    if record:
        tq.startRecordingQASM(q)
        qt.startRecordingQASM(r)
    return q, r, arr


def _both(q, r, name, *args):
    getattr(tq, name)(q, *args)
    getattr(qt, name)(r, *args)
    np.testing.assert_allclose(_amps(q), _amps(r), rtol=0, atol=TOL)
    assert str(q.qasm_log) == str(r.qasm_log)


def _decode(i, qs, encoding):
    v = sum(((i >> q) & 1) << j for j, q in enumerate(qs))
    if encoding == 1 and v >= (1 << (len(qs) - 1)):
        v -= 1 << len(qs)
    return v


def _oracle_phases(vec, regs, encoding, phase_fn, overrides=()):
    """tests/test_operators.py ``_phase_expect``: amp_i exp(i theta)."""
    out = np.empty_like(vec)
    for i in range(vec.size):
        xs = tuple(_decode(i, qs, encoding) for qs in regs)
        theta = next((ph for inds, ph in overrides if tuple(inds) == xs),
                     None)
        out[i] = vec[i] * np.exp(1j * (phase_fn(xs) if theta is None
                                       else theta))
    return out


# ---------------------------------------------------------------------------
# applyPhaseFunc
# ---------------------------------------------------------------------------

POLY_CASES = {
    "unsigned": (0, [0, 2, 3], [0.5, -1.2], [1.0, 2.0], []),
    "unsigned_overrides": (0, [4, 1, 7, 2], [0.3, 0.01], [1.0, 3.0],
                           [(5, 0.77), (0, -1.5), (15, 2.0)]),
    "twos": (1, [1, 4, 0], [0.8], [3.0], []),
    "twos_overrides": (1, [1, 4, 0], [0.8], [3.0], [(-4, 0.123), (1, -2.5)]),
    "negative_exponent": (0, [2, 5], [1.5], [-1.0], [(0, 0.25)]),
    "fractional": (0, [0, 1, 6], [0.7, 2.0], [0.5, 1.5], []),
}


@pytest.mark.parametrize("case", sorted(POLY_CASES))
@pytest.mark.parametrize("n", [8, 12])
def test_apply_phase_func(case, n):
    enc, qubits, coeffs, expos, overrides = POLY_CASES[case]
    q, r, vec = _pair(n, seed=n, record=True)
    if overrides:
        _both(q, r, "applyPhaseFuncOverrides", qubits, enc, coeffs, expos,
              [o[0] for o in overrides], [o[1] for o in overrides])
    else:
        _both(q, r, "applyPhaseFunc", qubits, enc, coeffs, expos)
    want = _oracle_phases(
        vec, [qubits], enc,
        lambda xs: sum(c * float(xs[0]) ** e for c, e in zip(coeffs, expos)),
        [((i,), ph) for i, ph in overrides])
    np.testing.assert_allclose(oracle.state_from_qureg(q), want, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("n", [4, 6])
def test_apply_phase_func_on_a_density_register(n):
    q, r, mat = _pair(n, density=True, seed=20 + n, record=True)
    _both(q, r, "applyPhaseFuncOverrides", [0, 2], 1, [0.4, -0.2],
          [1.0, 2.0], [-2, 1], [0.5, -0.5])


# ---------------------------------------------------------------------------
# applyMultiVarPhaseFunc
# ---------------------------------------------------------------------------

MULTI_CASES = {
    "unsigned": (0, [0, 1, 2, 3, 4], [2, 3], [1.0, 0.5, -0.3],
                 [1.0, 2.0, 1.0], [2, 1], []),
    "unsigned_overrides": (0, [5, 0, 1, 2, 3, 4], [3, 3],
                           [1.0, 0.5, -0.3, 0.2], [1.0, 2.0, 1.0, 3.0],
                           [2, 2], [((0, 0), 0.77), ((5, 2), -0.3)]),
    "twos": (1, [0, 1, 2, 3, 4, 6], [2, 2, 2], [0.3, -0.4, 0.25],
             [1.0, 2.0, 3.0], [1, 1, 1], []),
    "twos_overrides": (1, [7, 1, 2, 3], [2, 2], [0.3, -0.4], [2.0, 1.0],
                       [1, 1], [((-2, 1), 1.25), ((0, -1), -0.5)]),
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
@pytest.mark.parametrize("n", [8, 10])
def test_apply_multi_var_phase_func(case, n):
    enc, qubits, nper, coeffs, expos, terms, overrides = MULTI_CASES[case]
    q, r, vec = _pair(n, seed=30 + n, record=True)
    if overrides:
        _both(q, r, "applyMultiVarPhaseFuncOverrides", qubits, nper, enc,
              coeffs, expos, terms, [i for o in overrides for i in o[0]],
              [o[1] for o in overrides])
    else:
        _both(q, r, "applyMultiVarPhaseFunc", qubits, nper, enc, coeffs,
              expos, terms)
    regs, pos = [], 0
    for k in nper:
        regs.append(qubits[pos:pos + k])
        pos += k

    def theta(xs):
        total, flat = 0.0, 0
        for x, t in zip(xs, terms):
            for _ in range(t):
                total += coeffs[flat] * float(x) ** expos[flat]
                flat += 1
        return total

    want = _oracle_phases(vec, regs, enc, theta, overrides)
    np.testing.assert_allclose(oracle.state_from_qureg(q), want, rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# Named phase functions
# ---------------------------------------------------------------------------

# params per function for two registers (the shifted forms take one shift
# per register, or per pair of registers for the distance family)
NAMED_PARAMS = {
    "NORM": None, "SCALED_NORM": [2.5], "INVERSE_NORM": [7.0],
    "SCALED_INVERSE_NORM": [3.0, 9.0],
    "SCALED_INVERSE_SHIFTED_NORM": [0.5, 4.0, 1.0, -1.0],
    "PRODUCT": None, "SCALED_PRODUCT": [0.75], "INVERSE_PRODUCT": [2.0],
    "SCALED_INVERSE_PRODUCT": [3.0, 9.0],
    "DISTANCE": None, "SCALED_DISTANCE": [1.5], "INVERSE_DISTANCE": [6.0],
    "SCALED_INVERSE_DISTANCE": [0.5, 8.0],
    "SCALED_INVERSE_SHIFTED_DISTANCE": [0.5, 8.0, 1.0],
}


def _named_theta(name, params, xs):
    p = params or []
    if "NORM" in name:
        shifts = p[2:] if "SHIFTED" in name else [0.0] * len(xs)
        val = np.sqrt(sum((x - s) ** 2 for x, s in zip(xs, shifts)))
    elif "PRODUCT" in name:
        val = float(np.prod(xs))
    else:
        shifts = p[2:] if "SHIFTED" in name else [0.0] * (len(xs) // 2)
        val = np.sqrt(sum((xs[2 * k + 1] - xs[2 * k] - shifts[k]) ** 2
                          for k in range(len(xs) // 2)))
    if name in ("NORM", "PRODUCT", "DISTANCE"):
        return val
    if name.startswith("INVERSE"):
        return p[0] if val == 0 else 1 / val
    if name.startswith("SCALED_INVERSE"):
        return p[1] if val == 0 else p[0] / val
    return p[0] * val


@pytest.mark.parametrize("overrides", [False, True],
                         ids=["plain", "overrides"])
@pytest.mark.parametrize("enc", [0, 1], ids=["unsigned", "twos"])
@pytest.mark.parametrize("name", sorted(NAMED_PARAMS))
def test_apply_named_phase_func(name, enc, overrides):
    n = 8
    code = getattr(tq, name)
    assert code == getattr(qt, name)
    params = NAMED_PARAMS[name]
    q, r, vec = _pair(n, seed=code, record=True)
    qubits, nper = [0, 3, 1, 4, 6], [3, 2]
    ov = ([((1, -1) if enc else (1, 3), 0.77), ((0, 0), -0.3)]
          if overrides else [])
    inds = [i for o in ov for i in o[0]]
    phases = [o[1] for o in ov]
    if params is None and not overrides:
        _both(q, r, "applyNamedPhaseFunc", qubits, nper, enc, code)
    elif params is None:
        _both(q, r, "applyNamedPhaseFuncOverrides", qubits, nper, enc, code,
              inds, phases)
    elif not overrides:
        _both(q, r, "applyParamNamedPhaseFunc", qubits, nper, enc, code,
              params)
    else:
        _both(q, r, "applyParamNamedPhaseFuncOverrides", qubits, nper, enc,
              code, params, inds, phases)
    want = _oracle_phases(vec, [qubits[:3], qubits[3:]], enc,
                          lambda xs: _named_theta(name, params, xs), ov)
    np.testing.assert_allclose(oracle.state_from_qureg(q), want, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("n", [5, 6])
def test_named_phase_func_on_a_density_register(n):
    q, r, mat = _pair(n, density=True, seed=40 + n, record=True)
    _both(q, r, "applyParamNamedPhaseFuncOverrides", [0, 1, 2, 3], [2, 2],
          0, tq.SCALED_INVERSE_SHIFTED_DISTANCE, [0.5, 2.0, -1.0], [0, 0],
          [0.1])


def test_named_phase_func_many_registers_qasm_symbols():
    """Eight one-qubit registers: the records switch to the second symbol
    alphabet (qasm _sym)."""
    q, r, _ = _pair(9, seed=50, record=True)
    _both(q, r, "applyNamedPhaseFunc", list(range(8)), [1] * 8, 0,
          tq.PRODUCT)
    _both(q, r, "applyParamNamedPhaseFunc", list(range(8)), [1] * 8, 0,
          tq.SCALED_INVERSE_SHIFTED_NORM, [1.0, 2.0] + [0.5] * 8)
    assert "//     |a> = {0}" in str(q.qasm_log)


# ---------------------------------------------------------------------------
# Validation: the reference's messages
# ---------------------------------------------------------------------------


def _msg(mod, env, call):
    q = mod.createQureg(4, env)
    with pytest.raises(mod.QuESTError) as e:
        call(mod, q)
    return str(e.value)


PF_ERRORS = {
    "encoding": lambda m, q: m.applyPhaseFunc(q, [0, 1], 5, [1.0], [1.0]),
    "twos_one_qubit": lambda m, q: m.applyPhaseFunc(q, [0], 1, [1.0],
                                                    [1.0]),
    "no_qubits": lambda m, q: m.applyPhaseFunc(q, [], 0, [1.0], [1.0]),
    "qubit_index": lambda m, q: m.applyPhaseFunc(q, [0, 9], 0, [1.0],
                                                 [1.0]),
    "repeated_qubit": lambda m, q: m.applyPhaseFunc(q, [1, 1], 0, [1.0],
                                                    [1.0]),
    "no_terms": lambda m, q: m.applyPhaseFunc(q, [0, 1], 0, [], []),
    "negative_exponent": lambda m, q: m.applyPhaseFunc(q, [0, 1], 0, [1.0],
                                                       [-1.0]),
    "fraction_twos": lambda m, q: m.applyPhaseFunc(q, [0, 1, 2], 1, [1.0],
                                                   [0.5]),
    "override_unsigned": lambda m, q: m.applyPhaseFuncOverrides(
        q, [0, 1], 0, [1.0], [1.0], [4], [0.1]),
    "override_twos": lambda m, q: m.applyPhaseFuncOverrides(
        q, [0, 1], 1, [1.0], [1.0], [-3], [0.1]),
    "too_many_overrides": lambda m, q: m.applyPhaseFuncOverrides(
        q, [0], 0, [1.0], [1.0], [0, 1, 0], [0.1, 0.2, 0.3]),
    "multi_negative": lambda m, q: m.applyMultiVarPhaseFunc(
        q, [0, 1, 2, 3], [2, 2], 0, [1.0, 1.0], [1.0, -2.0], [1, 1]),
    "multi_fraction_twos": lambda m, q: m.applyMultiVarPhaseFunc(
        q, [0, 1, 2, 3], [2, 2], 1, [1.0, 1.0], [1.5, 2.0], [1, 1]),
    "multi_no_terms": lambda m, q: m.applyMultiVarPhaseFunc(
        q, [0, 1, 2, 3], [2, 2], 0, [1.0], [1.0], [1, 0]),
    "multi_override_index": lambda m, q: m.applyMultiVarPhaseFuncOverrides(
        q, [0, 1, 2, 3], [2, 2], 0, [1.0, 1.0], [1.0, 1.0], [1, 1], [0, 7],
        [0.5]),
    "name_code": lambda m, q: m.applyNamedPhaseFunc(q, [0, 1], [1, 1], 0,
                                                    14),
    "name_params": lambda m, q: m.applyParamNamedPhaseFunc(
        q, [0, 1], [1, 1], 0, m.SCALED_NORM, [1.0, 2.0]),
    "distance_odd": lambda m, q: m.applyNamedPhaseFunc(q, [0, 1, 2],
                                                       [1, 1, 1], 0,
                                                       m.DISTANCE),
    "named_twos_one_qubit": lambda m, q: m.applyNamedPhaseFunc(
        q, [0, 1, 2], [1, 2], 1, m.NORM),
}


@pytest.mark.parametrize("case", sorted(PF_ERRORS))
def test_phase_func_validation_messages(case):
    got = _msg(tq, tq.createQuESTEnv(device="cpu"), PF_ERRORS[case])
    want = _msg(qt, _ref_env(), PF_ERRORS[case])
    assert got == want


# ---------------------------------------------------------------------------
# The public names
# ---------------------------------------------------------------------------

M9B_NAMES = (
    "DISTANCE", "DiagonalOp", "INVERSE_DISTANCE", "INVERSE_NORM",
    "INVERSE_PRODUCT", "MAX_NUM_REGS_APPLY_ARBITRARY_PHASE", "NORM",
    "PRODUCT", "SCALED_DISTANCE", "SCALED_INVERSE_DISTANCE",
    "SCALED_INVERSE_NORM", "SCALED_INVERSE_PRODUCT",
    "SCALED_INVERSE_SHIFTED_DISTANCE", "SCALED_INVERSE_SHIFTED_NORM",
    "SCALED_NORM", "SCALED_PRODUCT", "TWOS_COMPLEMENT", "UNSIGNED",
    "applyDiagonalOp", "applyMultiVarPhaseFunc",
    "applyMultiVarPhaseFuncOverrides", "applyNamedPhaseFunc",
    "applyNamedPhaseFuncOverrides", "applyParamNamedPhaseFunc",
    "applyParamNamedPhaseFuncOverrides", "applyPhaseFunc",
    "applyPhaseFuncOverrides", "calcExpecDiagonalOp", "createDiagonalOp",
    "createDiagonalOpFromPauliHamilFile", "destroyDiagonalOp",
    "initDiagonalOp", "initDiagonalOpFromPauliHamil", "setDiagonalOpElems",
    "syncDiagonalOp")


def test_the_public_names_of_diagonal_ops_and_phase_functions():
    """The 35 names are exported with the reference's values, and 2 of
    the reference's public names are left, counted in a fresh process
    (the submodules a test session imports add names to the package):
    the reference's imports jax and jnp.  The serving layer's seven
    (serve, SimServer, Service, SimService, Job, Tenant,
    QuotaExceededError) are not among them.  The sharding slice's initDistributed, parallel and PAR are not
    among them, nor the 15 names of telemetry and resumable runs
    (saveQureg, loadQureg, runResumable, run_resumable, checkQuregHealth,
    FaultPlan, SimulatedPreemption, NumericalHealthError, WindowExecutor,
    degradation_report, telemetry, reportPerf, report_perf, utils and
    resilience), nor the 10 of the memory governor and the plan
    explainer."""
    assert len(M9B_NAMES) == 35
    for name in M9B_NAMES:
        assert hasattr(tq, name), name
        ref = getattr(qt, name)
        if isinstance(ref, int):
            assert getattr(tq, name) == ref, name
    code = ("import json, jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import quest_tpu, quest_tpu_torch\n"
            "print(json.dumps(sorted({n for n in dir(quest_tpu) "
            "if not n.startswith('_')} - set(dir(quest_tpu_torch)))))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    missing = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not missing & set(M9B_NAMES)
    assert not missing & {"initDistributed", "parallel", "PAR"}
    assert not missing & {
        "saveQureg", "loadQureg", "runResumable", "run_resumable",
        "checkQuregHealth", "FaultPlan", "SimulatedPreemption",
        "NumericalHealthError", "WindowExecutor", "degradation_report",
        "telemetry", "reportPerf", "report_perf", "utils", "resilience"}
    assert not missing & {
        "governor", "MemoryAdmissionError", "introspect", "explainCircuit",
        "explain_circuit", "reportCircuitPlan", "report_circuit_plan",
        "audit", "CollectiveBudget", "contracts"}
    assert not missing & {"serve", "SimServer", "Service", "SimService",
                          "Job", "Tenant", "QuotaExceededError"}
    assert missing == {"jax", "jnp"}
