"""saveQureg / loadQureg (M16b) in the port against the JAX package.

The port writes ``amps.npy`` (the global array, canonical order) where
the JAX package writes an orbax checkpoint; ``qureg_meta.json`` is the
JAX package's, key for key.  Round trips are bit for bit: a state
vector, a density matrix, a bank with its key bank, a register on 2 and
8 in-process CPU shards, precisions 1, 2 and 4; the amplitudes the
reference restores from its orbax checkpoint equal the port's
``amps.npy`` for the same state.  The validations are the reference's:
a precision mismatch names both sides, ``strict_mesh`` refuses a shard
count change, a load onto fewer shards is elastic, a mesh grown past the
register shrinks (a degradation).  Float64 unless said; reference
registers use ``qt.createQuESTEnv(num_devices=R)``.
"""

import json
import os

import numpy as np
import pytest

import quest_tpu as qt
from quest_tpu import checkpoint as RCK
import quest_tpu_torch as tq
from quest_tpu_torch import checkpoint as PCK
from quest_tpu_torch import interop, precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import telemetry as PT


@pytest.fixture(autouse=True)
def double(monkeypatch):
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0.001")
    old = precision.get_precision()
    tq.set_precision(2)
    PT.configure("on")
    PT.reset()
    yield
    tq.set_precision(old)


def _penv(R):
    return tq.createQuESTEnv(devices=["cpu"] * R) if R > 1 \
        else tq.createQuESTEnv(device="cpu")


def _state(rng, shape):
    return rng.standard_normal(shape) / np.sqrt(np.prod(shape) / 2)


def _host(q):
    return interop.register_state(q, canonical=True)[0]


def _circuit(pk, q, n):
    for t in range(n):
        pk.hadamard(q, t)
    for t in range(n - 1):
        pk.controlledNot(q, t, t + 1)
    pk.rotateY(q, 1, 0.3)
    pk.tGate(q, n - 1)


@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("density", [False, True])
def test_round_trip_bit_for_bit(tmp_path, R, density):
    env = _penv(R)
    n = 4 if density else 8
    q = (tq.createDensityQureg if density else tq.createQureg)(n, env)
    _circuit(tq, q, n)
    if density:
        tq.mixDepolarising(q, 0, 0.1)
    want = _host(q)
    tq.saveQureg(q, str(tmp_path / "ck"))
    q2 = tq.loadQureg(str(tmp_path / "ck"), env)
    assert q2.is_density_matrix == density
    assert q2.num_qubits_represented == n
    assert q2.is_sharded == (R > 1)
    assert np.array_equal(_host(q2), want)
    assert np.array_equal(np.load(str(tmp_path / "ck" / "amps.npy")), want)


@pytest.mark.parametrize("prec", [1, 2, 4])
def test_precisions_round_trip(tmp_path, prec):
    tq.set_precision(prec)
    env = _penv(1)
    q = tq.createQureg(7, env)
    _circuit(tq, q, 7)
    want = _host(q)
    tq.saveQureg(q, str(tmp_path / "ck"))
    meta = json.load(open(tmp_path / "ck" / "qureg_meta.json"))
    assert meta["precision"] == prec
    assert meta["dtype"] == ("float32" if prec == 1 else "float64")
    q2 = tq.loadQureg(str(tmp_path / "ck"), env)
    assert q2.dtype == q.dtype
    assert np.array_equal(_host(q2), want)


def test_a_sharded_permuted_register_saves_in_canonical_order(tmp_path):
    env = _penv(8)
    q = tq.createQureg(8, env)
    with tq.gateFusion(q):
        _circuit(tq, q, 8)
    assert q._perm is not None  # the drain left a live permutation
    tq.saveQureg(q, str(tmp_path / "ck"))
    ref = tq.createQureg(8, _penv(1))
    _circuit(tq, ref, 8)
    got = np.load(str(tmp_path / "ck" / "amps.npy"))
    assert np.abs(got - _host(ref)).max() < 1e-12


def test_bank_round_trip_keeps_its_key_bank(tmp_path):
    env = _penv(1)
    bq = tq.createBatchedQureg(5, env, 3, seeds=[[1], [2], [3]])
    for b in range(3):
        tq.hadamard(bq, b)
    tq.measureBatched(bq, 0)
    want = np.asarray(bq.amps)
    tq.saveQureg(bq, str(tmp_path / "bank"))
    meta = json.load(open(tmp_path / "bank" / "qureg_meta.json"))
    assert meta["batch"] == 3
    q2 = tq.loadQureg(str(tmp_path / "bank"), env)
    assert isinstance(q2, tq.BatchedQureg) and q2.batch_size == 3
    assert np.array_equal(np.asarray(q2.amps), want)


@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("kind", ["state", "density", "bank"])
def test_meta_equals_the_reference(tmp_path, R, kind):
    renv = qt.createQuESTEnv(num_devices=R)
    penv = _penv(R)
    if kind == "bank":
        rq = qt.createBatchedQureg(6, renv, 2)
        pq = tq.createBatchedQureg(6, penv, 2)
    elif kind == "density":
        rq = qt.createDensityQureg(3, renv)
        pq = tq.createDensityQureg(3, penv)
    else:
        rq = qt.createQureg(6, renv)
        pq = tq.createQureg(6, penv)
    assert PCK._qureg_meta(pq) == RCK._qureg_meta(rq)
    tq.saveQureg(pq, str(tmp_path / "ck"))
    meta = json.load(open(tmp_path / "ck" / "qureg_meta.json"))
    assert meta == RCK._qureg_meta(rq)


@pytest.mark.parametrize("R", [1, 8])
def test_reference_orbax_amplitudes_equal_the_npy(tmp_path, R):
    """The same state loaded into both packages' registers: what the
    reference restores from its orbax checkpoint is the port's
    amps.npy, bit for bit; after the same circuit, within 1e-12."""
    rng = np.random.default_rng(R)
    state = _state(rng, (2, 1 << 6))
    renv = qt.createQuESTEnv(num_devices=R)
    rq = qt.createQureg(6, renv)
    rq.amps = rq.device_put(state)
    pq = tq.createQureg(6, _penv(R))
    interop.load_register(pq, state)
    qt.saveQureg(rq, str(tmp_path / "ref"))
    tq.saveQureg(pq, str(tmp_path / "port"))
    restored = np.asarray(qt.loadQureg(str(tmp_path / "ref"), renv).amps)
    npy = np.load(str(tmp_path / "port" / "amps.npy"))
    assert np.array_equal(restored, npy)
    _circuit(qt, rq, 6)
    _circuit(tq, pq, 6)
    qt.saveQureg(rq, str(tmp_path / "ref2"))
    tq.saveQureg(pq, str(tmp_path / "port2"))
    restored = np.asarray(qt.loadQureg(str(tmp_path / "ref2"), renv).amps)
    npy = np.load(str(tmp_path / "port2" / "amps.npy"))
    assert np.abs(restored - npy).max() < 1e-12


def test_precision_mismatch_names_both_sides(tmp_path):
    env = _penv(1)
    q = tq.createQureg(4, env)
    tq.initDebugState(q)
    tq.saveQureg(q, str(tmp_path / "ck"))
    tq.set_precision(1)
    with pytest.raises(tq.QuESTError) as ei:
        tq.loadQureg(str(tmp_path / "ck"), env)
    msg = str(ei.value)
    assert "precision mismatch" in msg
    assert "float64" in msg and "float32" in msg
    tq.set_precision(2)
    q2 = tq.loadQureg(str(tmp_path / "ck"), env)
    assert np.array_equal(_host(q2), _host(q))


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(tq.QuESTError, match="no qureg checkpoint"):
        tq.loadQureg(str(tmp_path / "nope"), _penv(1))


def test_strict_mesh_refuses_and_elastic_loads_onto_fewer_shards(tmp_path):
    env8, env4 = _penv(8), _penv(4)
    q = tq.createQureg(6, env8)
    _circuit(tq, q, 6)
    tq.saveQureg(q, str(tmp_path / "ck"))
    with pytest.raises(tq.QuESTError, match="mesh mismatch"):
        tq.loadQureg(str(tmp_path / "ck"), env4, strict_mesh=True)
    q8 = tq.loadQureg(str(tmp_path / "ck"), env8, strict_mesh=True)
    assert np.array_equal(_host(q8), _host(q))
    assert PT.counter_total("elastic_restores_total") == 0
    q4 = tq.loadQureg(str(tmp_path / "ck"), env4)
    assert q4.env.num_devices == 4 and q4.is_sharded
    assert np.array_equal(_host(q4), _host(q))
    assert PT.counter_total("elastic_restores_total") == 1
    q1 = tq.loadQureg(str(tmp_path / "ck"), _penv(1))
    assert np.array_equal(_host(q1), _host(q))


def test_tiny_register_shrinks_a_grown_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(PR, "DEGRADATIONS", {})
    env = _penv(8)
    q = tq.createQureg(2, env)
    tq.hadamard(q, 0)
    want = _host(q)
    tq.saveQureg(q, str(tmp_path / "ck"))
    with pytest.raises(tq.QuESTError, match="mesh has grown"):
        tq.loadQureg(str(tmp_path / "ck"), env, strict_mesh=True)
    with pytest.warns(UserWarning, match="loadQureg_mesh_8to4"):
        q2 = tq.loadQureg(str(tmp_path / "ck"), env)
    assert q2.env.num_devices == 4
    assert np.array_equal(_host(q2), want)
    assert "loadQureg_mesh_8to4" in tq.degradation_report()


def test_transient_io_errors_are_retried(tmp_path, monkeypatch):
    plan = tq.FaultPlan("io@2")
    monkeypatch.setattr(PR, "_ACTIVE_FAULTS", [plan])
    q = tq.createQureg(4, _penv(1))
    tq.initDebugState(q)
    tq.saveQureg(q, str(tmp_path / "ck"))
    assert plan.io_budget == 0 and plan.log == ["io", "io"]
    assert PT.counter_total("checkpoint_io_retries_total") == 2
    assert np.array_equal(_host(tq.loadQureg(str(tmp_path / "ck"),
                                             _penv(1))), _host(q))


def test_streams_in_chunks_through_one_buffer(tmp_path, monkeypatch):
    """Several chunks a shard (the chunk cut to 16 amplitudes): the file
    is still the global array and loads back bit for bit."""
    monkeypatch.setattr(PCK, "_CHUNK", 16)
    env = _penv(2)
    q = tq.createQureg(9, env)
    _circuit(tq, q, 9)
    tq.saveQureg(q, str(tmp_path / "ck"))
    q2 = tq.loadQureg(str(tmp_path / "ck"), env)
    assert np.array_equal(_host(q2), _host(q))


def test_torn_payload_raises(tmp_path):
    q = tq.createQureg(4, _penv(1))
    tq.saveQureg(q, str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "amps.npy", "wb") as f:
        f.write(b"\x00CORRUPT\x00")
    with pytest.raises(ValueError):
        tq.loadQureg(str(tmp_path / "ck"), _penv(1))


def test_metadata_is_written_last(tmp_path, monkeypatch):
    """A save that fails on the payload leaves no metadata: nothing
    half-written is loadable."""
    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(PCK, "_write_amps", fail)
    monkeypatch.setenv("QT_RETRY_ATTEMPTS", "1")
    q = tq.createQureg(3, _penv(1))
    with pytest.raises(tq.QuESTError, match="saveQureg"):
        tq.saveQureg(q, str(tmp_path / "ck"))
    assert not os.path.exists(tmp_path / "ck" / "qureg_meta.json")
