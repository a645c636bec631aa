"""quest_tpu_torch's measurement (M10) against quest_tpu's, on the CPU at
float64.

* ``measure``, ``measureWithStats``, ``measureSequence`` and
  ``collapseToOutcome`` on a 10- and a 12-qubit state vector and a
  5-qubit density matrix, made from a NumPy seed, through both routes
  (the default threefry route and QT_HOST_MEASURE=1), with the same
  seedQuEST in both packages: equal outcomes, probabilities within
  1e-12, states within 1e-10 (sums of a few thousand order-1/2^n terms
  at float64, taken in another order).
* The port against itself: ``measureSequence`` equals a loop of
  ``measureWithStats`` on a ``cloneQureg`` copy bit for bit (outcomes,
  probabilities and state), and ``ops/measurement.measure_sequence``
  reads nothing on the host until its caller asks, once.
* Degenerate probabilities, zero-probability collapse and the
  measurement of a register with gates pending under ``gateFusion``.
"""

import functools

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import rng as ref_rng
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu_torch import interop, precision, rng
from quest_tpu_torch.ops import measurement as M

torch.set_num_threads(1)

PTOL = 1e-12
STOL = 1e-10
SEEDS = [1234, 5678]


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


@pytest.fixture(params=["fused", "host"])
def route(request, monkeypatch):
    if request.param == "host":
        monkeypatch.setenv("QT_HOST_MEASURE", "1")
    else:
        monkeypatch.delenv("QT_HOST_MEASURE", raising=False)
        monkeypatch.delenv("QT_STRICT_VALIDATION", raising=False)
    return request.param


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _port_env():
    return tq.createQuESTEnv(device="cpu")


def _random_sv(n, seed):
    rng_ = np.random.default_rng(seed)
    z = rng_.standard_normal(1 << n) + 1j * rng_.standard_normal(1 << n)
    return z / np.linalg.norm(z)


def _random_rho(n, seed):
    """A full-rank mixed state, flattened column-major."""
    rng_ = np.random.default_rng(seed)
    a = (rng_.standard_normal((1 << n, 1 << n))
         + 1j * rng_.standard_normal((1 << n, 1 << n)))
    rho = a @ a.conj().T
    rho /= np.trace(rho).real
    return rho.T.ravel()


CASES = {"sv10": (False, 10), "sv12": (False, 12), "rho5": (True, 5)}


def _pair(case, seed=11):
    """(reference register, port register) holding the same state, both
    packages seeded with SEEDS."""
    is_rho, n = CASES[case]
    renv, penv = _ref_env(), _port_env()
    if is_rho:
        amps = _random_rho(n, seed)
        r, p = qt.createDensityQureg(n, renv), tq.createDensityQureg(n, penv)
        qt.setDensityAmps(r, amps.real, amps.imag)
        tq.setDensityAmps(p, amps.real, amps.imag)
    else:
        amps = _random_sv(n, seed)
        r, p = qt.createQureg(n, renv), tq.createQureg(n, penv)
        qt.initStateFromAmps(r, amps.real, amps.imag)
        tq.initStateFromAmps(p, amps.real, amps.imag)
    qt.seedQuEST(renv, SEEDS)
    tq.seedQuEST(penv, SEEDS)
    return r, p


def _assert_state(r, p):
    assert np.abs(np.asarray(r.amps) - p.amps.numpy()).max() <= STOL


def _targets(case):
    n = CASES[case][1]
    return [(3 * j + 1) % n for j in range(n)]


@pytest.mark.parametrize("case", list(CASES))
def test_measure_with_stats_loop_matches_reference(case, route):
    r, p = _pair(case)
    for t in _targets(case):
        ro, rp = qt.measureWithStats(r, t)
        po, pp = tq.measureWithStats(p, t)
        assert po == ro
        assert abs(pp - rp) <= PTOL
        assert isinstance(po, int) and isinstance(pp, float)
    _assert_state(r, p)
    assert abs(tq.calcTotalProb(p) - 1) <= STOL


@pytest.mark.parametrize("case", list(CASES))
def test_measure_matches_reference(case, route):
    r, p = _pair(case, seed=12)
    outs_r = [qt.measure(r, t) for t in range(CASES[case][1])]
    outs_p = [tq.measure(p, t) for t in range(CASES[case][1])]
    assert outs_p == outs_r
    _assert_state(r, p)


@pytest.mark.parametrize("case", list(CASES))
def test_measure_sequence_matches_reference(case, route):
    r, p = _pair(case, seed=13)
    ro, rp = qt.measureSequence(r, _targets(case))
    po, pp = tq.measureSequence(p, _targets(case))
    assert po == ro
    assert np.abs(np.array(pp) - np.array(rp)).max() <= PTOL
    _assert_state(r, p)


@pytest.mark.parametrize("case", list(CASES))
def test_collapse_to_outcome_matches_reference(case):
    r, p = _pair(case, seed=14)
    for t, o in zip(_targets(case)[:4], (1, 0, 0, 1)):
        rp = qt.collapseToOutcome(r, t, o)
        pp = tq.collapseToOutcome(p, t, o)
        assert abs(pp - rp) <= PTOL
    _assert_state(r, p)


@pytest.mark.parametrize("case", list(CASES))
def test_many_shots_match_reference(case, route):
    """200 single-qubit shots on re-prepared states: the outcome streams
    (threefry or MT19937) stay equal shot after shot."""
    r, p = _pair(case, seed=15)
    r0 = qt.createCloneQureg(r, _ref_env())
    p0 = tq.createCloneQureg(p, p.env)
    got, want = [], []
    for shot in range(200):
        t = shot % CASES[case][1]
        qt.cloneQureg(r, r0)
        tq.cloneQureg(p, p0)
        want.append(qt.measure(r, t))
        got.append(tq.measure(p, t))
    assert got == want
    assert 0 < sum(got) < 200


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_equals_loop_bit_for_bit(case):
    """The port's measureSequence against a loop of its measureWithStats
    on a copy, reseeded the same way: the same outcomes, probabilities
    and state, bit for bit."""
    _, p = _pair(case, seed=16)
    env = p.env
    c = tq.createCloneQureg(p, env)
    tq.seedQuEST(env, SEEDS)
    outs, probs = tq.measureSequence(p, _targets(case))
    tq.seedQuEST(env, SEEDS)
    loop = [tq.measureWithStats(c, t) for t in _targets(case)]
    assert outs == [o for o, _ in loop]
    assert probs == [pr for _, pr in loop]
    assert torch.equal(p.amps, c.amps)


def test_measure_sequence_reads_the_host_once(monkeypatch):
    """ops/measurement.measure_sequence leaves everything on the device;
    to_host reads the outcomes and probabilities in one copy."""
    _, p = _pair("sv10", seed=17)
    amps = p.amps
    key, shot = M.KEYS.next_shots(10)
    calls = {"cpu": 0}
    real_cpu = torch.Tensor.cpu

    def no_read(name):
        def fail(self, *a, **k):
            raise AssertionError(f"host read {name} inside measure_sequence")
        return fail

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, no_read(name))
    out, outs, probs = M.measure_sequence(amps, key, shot, num_qubits=10,
                                          targets=tuple(range(10)),
                                          is_density=False)
    monkeypatch.undo()

    def counted_cpu(self, *a, **k):
        calls["cpu"] += 1
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    got = M.to_host(outs, probs)
    assert calls["cpu"] == 1
    assert len(got[0]) == len(got[1]) == 10
    assert set(got[0]) <= {0, 1}


@pytest.mark.parametrize("outcome", [0, 1])
def test_degenerate_probabilities_short_circuit(outcome, route):
    """A qubit already in a basis state measures to it whatever the
    draw, with probability 1, in both packages."""
    renv, penv = _ref_env(), _port_env()
    r, p = qt.createQureg(6, renv), tq.createQureg(6, penv)
    qt.initClassicalState(r, outcome << 2)
    tq.initClassicalState(p, outcome << 2)
    qt.seedQuEST(renv, SEEDS)
    tq.seedQuEST(penv, SEEDS)
    for _ in range(5):
        assert tq.measureWithStats(p, 2) == (outcome, 1.0)
        assert qt.measureWithStats(r, 2) == (outcome, 1.0)
    _assert_state(r, p)


@pytest.mark.parametrize("case", ["sv10", "rho5"])
def test_collapse_to_zero_probability_raises(case):
    r, p = _pair(case)
    qt.collapseToOutcome(r, 1, 0)
    tq.collapseToOutcome(p, 1, 0)
    with pytest.raises(qt.QuESTError) as ref_err:
        qt.collapseToOutcome(r, 1, 1)
    with pytest.raises(tq.QuESTError) as err:
        tq.collapseToOutcome(p, 1, 1)
    assert str(err.value) == str(ref_err.value)
    assert "zero probability" in str(err.value)


@pytest.mark.parametrize("func", ["measure", "measureWithStats",
                                  "collapseToOutcome", "measureSequence"])
def test_invalid_targets_raise_the_reference_message(func):
    r, p = _pair("sv10")
    args = {"measure": (10,), "measureWithStats": (-1,),
            "collapseToOutcome": (0, 2), "measureSequence": ([0, 12],)}[func]
    with pytest.raises(qt.QuESTError) as ref_err:
        getattr(qt, func)(r, *args)
    with pytest.raises(tq.QuESTError) as err:
        getattr(tq, func)(p, *args)
    assert str(err.value) == str(ref_err.value)


def test_measure_sequence_of_nothing():
    _, p = _pair("sv10")
    counter = M.KEYS.get_state()["counter"]
    assert tq.measureSequence(p, []) == ([], [])
    assert M.KEYS.get_state()["counter"] == counter


@pytest.mark.parametrize("how", ["sequence", "loop"])
def test_measurement_drains_pending_fused_gates(how, route):
    """A measurement inside gateFusion sees every earlier gate: the same
    outcomes and state as the eager route, and as the reference."""
    renv, penv = _ref_env(), _port_env()
    n = 8
    regs = {"ref": qt.createQureg(n, renv), "eager": tq.createQureg(n, penv),
            "fused": tq.createQureg(n, penv)}
    results = {}
    for name, q in regs.items():
        pkg = qt if name == "ref" else tq
        pkg.seedQuEST(renv if name == "ref" else penv, SEEDS)
        fusing = name == "fused"
        if fusing:
            tq.startGateFusion(q)
        for t in range(n):
            pkg.hadamard(q, t)
            pkg.rotateY(q, t, 0.2 * (t + 1))
        for t in range(n - 1):
            pkg.controlledNot(q, t, t + 1)
        if how == "sequence":
            results[name] = pkg.measureSequence(q, range(n))
        else:
            results[name] = [pkg.measureWithStats(q, t) for t in range(n)]
        if fusing:
            tq.stopGateFusion(q)
    def split(res):
        if how == "sequence":
            return res[0], res[1]
        return [o for o, _ in res], [p for _, p in res]

    fused_o, fused_p = split(results["fused"])
    for other in ("eager", "ref"):
        o, pr = split(results[other])
        assert fused_o == o
        assert np.abs(np.array(fused_p) - np.array(pr)).max() <= PTOL
    assert float((regs["fused"].amps - regs["eager"].amps).abs().max()) \
        <= STOL
    _assert_state(regs["ref"], regs["fused"])


def test_streams_continue_from_reference_snapshots(route):
    """After rng_state_from_reference, the port measures what the
    reference measures next."""
    r, p = _pair("sv12", seed=18)
    for t in range(3):
        qt.measure(r, t)
    interop.rng_state_from_reference(ref_rng.GLOBAL_RNG.get_state(),
                                     ref_measurement.KEYS.get_state())
    amps = np.asarray(r.amps)
    tq.initStateFromAmps(p, amps[0], amps[1])
    assert tq.measureSequence(p, range(3, 12))[0] == \
        qt.measureSequence(r, range(3, 12))[0]


def test_host_route_under_strict_validation(monkeypatch):
    monkeypatch.delenv("QT_HOST_MEASURE", raising=False)
    monkeypatch.setenv("QT_STRICT_VALIDATION", "1")
    assert M.host_path_enabled()
    r, p = _pair("sv10", seed=19)
    assert tq.measureSequence(p, range(10))[0] == \
        qt.measureSequence(r, range(10))[0]


def test_float32_register_draws_float32_thresholds():
    """At single precision the fused route thresholds against the float32
    uniforms, as the reference does when x64 is off."""
    tq.set_precision(1)
    env = _port_env()
    q = tq.createQureg(4, env)
    tq.initPlusState(q)
    tq.seedQuEST(env, SEEDS)
    key, shot = M.KEYS.next_shots(0)
    us = M.thresholds(key, shot, 4, q.dtype, q.device)
    assert us.dtype == torch.float32
    outs, probs = tq.measureSequence(q, range(4))
    # |+> probabilities are 1/2 at float32: outcome 0 iff u <= p0
    assert outs == [0 if u <= p else 1
                    for u, p in zip(us.tolist(), probs)]
