"""Register banks on a mesh (M15c) in the port against the JAX package.

The port's in-process mesh, ``tq.createQuESTEnv(devices=["cpu"] * R)``
for R = 2, 4 and 8, against the reference's banks on
``qt.createQuESTEnv(num_devices=R)`` (the suite's 8-device CPU mesh), at
float64, tests/test_batch.py's cases on a mesh:

* shared gates (batch flag 1) and per-element matrices (flag 2) with a
  gate on a mesh bit and a controlled gate, and a density bank with
  channels, within 1e-10 of the reference's bank, and every element
  ``torch.equal`` to its own scalar sharded drain in the port;
* seeded ``measureBatched`` (the reference's outcomes),
  ``calcExpecPauliSumBatched``, the scalar-init broadcast, the reference's
  "different program skeleton" and "shard-local space" errors;
* the exchanges and bytes of a bank B times the scalar register's, equal
  to the reference's telemetry
  (test_dispatch_and_exchange_weighted_by_batch);
* a remap of a bank's shards equal to each element's own remap, in one
  transfer per exchange;
* ``EnsembleScheduler`` and ``run_trajectories`` on a mesh env against
  the one-shard port, and a bank carried across with
  ``interop.load_register`` / ``register_state``, canonical and permuted.
"""

import numpy as np
import pytest
import torch

import quest_tpu as qt
from quest_tpu import rng as ref_rng
from quest_tpu import telemetry as RTEL
from quest_tpu.ops import measurement as ref_measurement
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as C
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import interop, precision, rng
from quest_tpu_torch.ops import measurement as M
from quest_tpu_torch.parallel import dist as PD
from quest_tpu_torch.parallel import sharded as SH

TOL = 1e-10
NQ = 6          # nloc = 3 at R = 8
NB = 4
MESHES = (2, 4, 8)


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


def _require_ref_mesh():
    if qt.createQuESTEnv().num_devices < 8:
        pytest.skip("needs the suite's 8-device CPU mesh")


def _envs(R):
    _require_ref_mesh()
    return (qt.createQuESTEnv(num_devices=R),
            tq.createQuESTEnv(devices=["cpu"] * R))


def _unitary(rng_, k=1):
    g = rng_.standard_normal((1 << k, 1 << k)) \
        + 1j * rng_.standard_normal((1 << k, 1 << k))
    u, _ = np.linalg.qr(g)
    return u


def _state(q):
    """A register's or bank's canonical state as a host array."""
    return interop.register_state(q, canonical=True)[0]


def _ref_state(b):
    return np.asarray(b.amps)


def _mixed_circuit(pkg, q, n=NQ, depth=2):
    """tests/test_batch.py's circuit: low, middle and mesh-bit qubits."""
    for d in range(depth):
        for t in range(n):
            pkg.hadamard(q, t)
        pkg.controlledNot(q, n - 1, 0)
        pkg.rotateZ(q, 2, 0.3 + 0.1 * d)
        pkg.swapGate(q, 1, n - 2)


def _scalar_drain(env, n, density, body):
    """A scalar register of the port on ``env`` drained under gateFusion."""
    q = (tq.createDensityQureg if density else tq.createQureg)(n, env)
    with tq.gateFusion(q):
        body(q)
    return _state(q)


# ---------------------------------------------------------------------------
# The bank against the reference's bank and its own scalar drains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", MESHES)
def test_shared_gates_bank(R):
    renv, penv = _envs(R)
    bq = qt.createBatchedQureg(NQ, renv, NB)
    _mixed_circuit(qt, bq)
    bp = tq.createBatchedQureg(NQ, penv, NB)
    assert bp.is_sharded and bp.amps.batch_size == NB
    _mixed_circuit(tq, bp)
    bank = _state(bp)
    assert bank.shape == (NB, 2, 1 << NQ)
    np.testing.assert_allclose(bank, _ref_state(bq), atol=TOL, rtol=0)
    want = _scalar_drain(penv, NQ, False, lambda q: _mixed_circuit(tq, q))
    for i in range(NB):
        assert np.array_equal(bank[i], want)


def _per_element(pkg, b, nq, mats, mats2, i=None):
    """Per-element 1q unitaries on a middle qubit, a shared H, a
    per-element controlled 2q unitary whose targets reach the top (mesh)
    bit, a 1q unitary on the mesh bit and a CNOT; ``i``: element i's
    scalar stream."""
    if i is None:
        pkg.applyBatchedUnitary(b, (1,), mats)
        pkg.hadamard(b, 0)
        pkg.applyBatchedUnitary(b, (0, nq - 1), mats2, controls=(nq - 2,))
        pkg.applyBatchedUnitary(b, (nq - 1,), mats)
    else:
        pkg.unitary(b, 1, mats[i])
        pkg.hadamard(b, 0)
        pkg.controlledMultiQubitUnitary(b, nq - 2, [0, nq - 1], mats2[i])
        pkg.unitary(b, nq - 1, mats[i])
    pkg.controlledNot(b, 2, 1)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("density", [False, True])
def test_per_element_unitaries_bank(R, density):
    renv, penv = _envs(R)
    rng_ = np.random.default_rng(1)
    nq = 4 if density else NQ
    mats = np.stack([_unitary(rng_) for _ in range(NB)])
    mats2 = np.stack([_unitary(rng_, 2) for _ in range(NB)])
    banks = []
    for pkg, env in ((qt, renv), (tq, penv)):
        b = pkg.createBatchedQureg(nq, env, NB, is_density_matrix=density)
        _per_element(pkg, b, nq, mats, mats2)
        banks.append(b)
    bank = _state(banks[1])
    np.testing.assert_allclose(bank, _ref_state(banks[0]), atol=TOL, rtol=0)
    for i in range(NB):
        want = _scalar_drain(penv, nq, density, lambda q: _per_element(
            tq, q, nq, mats, mats2, i))
        assert np.array_equal(bank[i], want)


@pytest.mark.parametrize("R", MESHES)
def test_density_bank_channels(R):
    """Captured depolarising, damping and dephasing channels on a density
    bank whose bra bits are mesh bits (the drain's channel parts, the K5
    route's plain body, every element under the same probabilities)."""
    renv, penv = _envs(R)
    rng_ = np.random.default_rng(2)
    nq = 4
    mats = np.stack([_unitary(rng_) for _ in range(NB)])

    def body(pkg, b, i=None):
        if i is None:
            pkg.applyBatchedUnitary(b, (0,), mats)
        else:
            pkg.unitary(b, 0, mats[i])
        pkg.mixDepolarising(b, 0, 0.1)
        pkg.mixDamping(b, 3, 0.2)
        pkg.mixDephasing(b, 2, 0.05)
        pkg.hadamard(b, 3)

    banks = []
    for pkg, env in ((qt, renv), (tq, penv)):
        b = pkg.createBatchedQureg(nq, env, NB, is_density_matrix=True)
        body(pkg, b)
        banks.append(b)
    bank = _state(banks[1])
    np.testing.assert_allclose(bank, _ref_state(banks[0]), atol=TOL, rtol=0)
    for i in range(NB):
        want = _scalar_drain(penv, nq, True, lambda q: body(tq, q, i))
        assert np.array_equal(bank[i], want)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("density", [False, True])
def test_measure_batched_gives_the_reference_outcomes(R, density):
    renv, penv = _envs(R)
    nq = 4 if density else NQ
    seeds = [[100 + i] for i in range(NB)]
    rng_ = np.random.default_rng(10)
    mats = np.stack([_unitary(rng_) for _ in range(NB)])
    res = []
    for pkg, env in ((qt, renv), (tq, penv)):
        b = pkg.createBatchedQureg(nq, env, NB, seeds=seeds,
                                   is_density_matrix=density)
        for t in range(nq):
            pkg.hadamard(b, t)
        pkg.applyBatchedUnitary(b, (1,), mats)
        pkg.applyBatchedUnitary(b, (nq - 1,), mats)
        o1, p1 = pkg.measureBatched(b, nq - 1)
        o2, p2 = pkg.measureBatched(b, 1)
        res.append((b, o1, p1, o2, p2))
    (rb, *ref), (pb, *port) = res
    assert [int(v) for v in port[0]] == [int(v) for v in ref[0]]
    assert [int(v) for v in port[2]] == [int(v) for v in ref[2]]
    np.testing.assert_allclose(port[1], np.asarray(ref[1]), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(port[3], np.asarray(ref[3]), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(_state(pb), _ref_state(rb), atol=TOL, rtol=0)
    assert pb.key_state() == rb.key_state()


@pytest.mark.parametrize("R", MESHES)
def test_expectation_batched(R):
    renv, penv = _envs(R)
    rng_ = np.random.default_rng(3)
    mats = np.stack([_unitary(rng_) for _ in range(NB)])
    codes = rng_.integers(0, 4, size=(3, NQ)).astype(np.int32)
    coeffs = np.linspace(0.5, 1.5, 3)
    vals = []
    for pkg, env in ((qt, renv), (tq, penv)):
        b = pkg.createBatchedQureg(NQ, env, NB)
        pkg.applyBatchedUnitary(b, (0,), mats)
        pkg.applyBatchedUnitary(b, (NQ - 1,), mats)
        pkg.hadamard(b, 3)
        vals.append(pkg.calcExpecPauliSumBatched(b, codes, coeffs))
    np.testing.assert_allclose(vals[1], vals[0], atol=TOL, rtol=0)
    for i in range(NB):
        qi = tq.createQureg(NQ, penv)
        tq.unitary(qi, 0, mats[i])
        tq.unitary(qi, NQ - 1, mats[i])
        tq.hadamard(qi, 3)
        assert vals[1][i] == tq.calcExpecPauliSum(qi, codes.ravel(), coeffs)


@pytest.mark.parametrize("R", MESHES)
def test_scalar_init_broadcasts_and_element(R):
    _renv, penv = _envs(R)
    bp = tq.createBatchedQureg(NQ, penv, NB)
    tq.hadamard(bp, 0)
    tq.initPlusState(bp)
    bank = bp.amps
    assert isinstance(bank, SH.ShardedAmps) and bank.batch_size == NB
    assert all(tuple(s.shape) == (NB, 2, (1 << NQ) // R)
               for s in bank.shards)
    host = _state(bp)
    np.testing.assert_array_equal(host[:, 0], 1.0 / np.sqrt(1 << NQ))
    np.testing.assert_array_equal(host[:, 1], 0.0)
    tq.initClassicalState(bp, 5)
    el = bp.element(2)
    assert isinstance(el, SH.ShardedAmps) and el.batch_size == 0
    whole = SH.gather_host(el)
    assert whole[0, 5] == 1.0 and np.abs(whole).sum() == 1.0
    with pytest.raises(tq.QuESTError, match="out of range"):
        bp.element(NB)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def _skeleton_mismatch(pkg, env):
    """Element 0 runs two X gates (a permutation run), element 1 two H
    gates (a dense run), one of them on the mesh bit."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    b = pkg.createBatchedQureg(NQ, env, 2)
    pkg.applyBatchedUnitary(b, (0,), np.stack([x, h]))
    pkg.applyBatchedUnitary(b, (NQ - 1,), np.stack([x, h]))
    return b


@pytest.mark.parametrize("R", (2, 8))
def test_skeleton_mismatch_raises_the_reference_error(R):
    renv, penv = _envs(R)
    with pytest.raises(qt.QuESTError) as ref:
        _ = _skeleton_mismatch(qt, renv).amps
    with pytest.raises(tq.QuESTError) as port:
        _ = _skeleton_mismatch(tq, penv).amps
    assert str(port.value) == str(ref.value)


def test_a_gate_wider_than_the_shard_local_space_is_refused():
    renv, penv = _envs(8)
    rng_ = np.random.default_rng(4)
    mats = np.stack([_unitary(rng_, 4) for _ in range(NB)])
    msgs = []
    for pkg, env in ((qt, renv), (tq, penv)):
        b = pkg.createBatchedQureg(NQ, env, NB)
        with pytest.raises(pkg.QuESTError,
                           match="shard-local space for a distributed "
                                 "bank") as e:
            pkg.applyBatchedUnitary(b, (0, 1, 2, 3), mats)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Exchange accounting and the bank's remap
# ---------------------------------------------------------------------------


def _remap_counts(count):
    return {(name, op): count(name, op)
            for name in ("exchanges_total", "exchange_bytes_total")
            for op in ("remap", "window_remap")}


@pytest.mark.parametrize("R", MESHES)
def test_exchanges_weighted_by_batch(R):
    """The reference's test_dispatch_and_exchange_weighted_by_batch: a
    gate on a mesh bit drained on a scalar register and on a bank; the
    bank's remap exchanges and bytes are B times the scalar's, in both
    packages alike."""
    renv, penv = _envs(R)
    old = RTEL.mode_name()
    RTEL.configure("on")
    try:
        got = {}
        for name, pkg, env, count in (
                ("ref", qt, renv,
                 lambda n, op: RTEL.counter_sum(n, op=op)),
                ("port", tq, penv,
                 lambda n, op: PD.counter_sum(n, op=op))):
            c0 = _remap_counts(count)
            qs = pkg.createQureg(NQ, env)
            with pkg.gateFusion(qs):
                pkg.hadamard(qs, NQ - 1)
            _ = qs.amps
            c1 = _remap_counts(count)
            bq = pkg.createBatchedQureg(NQ, env, NB)
            pkg.hadamard(bq, NQ - 1)
            _ = bq.amps
            c2 = _remap_counts(count)
            scalar = {k: c1[k] - c0[k] for k in c0}
            bank = {k: c2[k] - c1[k] for k in c0}
            assert bank == {k: NB * v for k, v in scalar.items()}
            assert bank[("exchange_bytes_total", "remap")] > 0
            got[name] = (scalar, bank)
        assert got["port"] == got["ref"]
    finally:
        RTEL.configure(old)


@pytest.mark.parametrize("R", MESHES)
def test_bank_remap_equals_each_elements_remap(R, monkeypatch):
    """One remap of a bank's (B, 2, 2^nloc) shards (mixed swaps, the
    per-shard axis permutation with the batch axis in front, the composed
    permute) is each element's own remap, with one mesh transfer per
    exchange chunk for the whole bank."""
    _renv, penv = _envs(R)
    mesh = penv.mesh
    rng_ = np.random.default_rng(5)
    n = NQ
    r = R.bit_length() - 1
    nloc = n - r
    full = rng_.standard_normal((NB, 2, 1 << n))
    sigma = tuple(int(v) for v in rng_.permutation(n))
    bank = SH.split(mesh, full, nloc, torch.float64)
    calls = []
    orig = mesh.permute
    monkeypatch.setattr(mesh, "permute", lambda s, p: (
        calls.append(tuple(t.shape for t in s)), orig(s, p))[1])
    out = SH.gather_host(PD._remap_shards(bank, sigma))
    mixed, _lp, tau = PD.decompose_sigma(sigma, nloc, r)
    assert len(calls) == len(mixed) + (tau is not None)
    assert all(shape[0] == 2 * NB for shapes in calls for shape in shapes)
    for b in range(NB):
        one = SH.gather_host(PD._remap_shards(
            SH.split(mesh, full[b], nloc, torch.float64), sigma))
        assert np.array_equal(out[b], one)


# ---------------------------------------------------------------------------
# The scheduler, trajectories and interop on a mesh
# ---------------------------------------------------------------------------


def _ansatz(mod, theta, n):
    h = np.stack([np.array([[1, 1], [1, -1]]) / np.sqrt(2),
                  np.zeros((2, 2))])
    rz = np.stack([np.diag([np.cos(theta / 2), np.cos(theta / 2)]),
                   np.diag([-np.sin(theta / 2), np.sin(theta / 2)])])
    return [mod.Gate((0,), h), mod.Gate((n - 1,), rz), mod.Gate((n - 1,), h),
            mod.Gate((1,), rz)]


@pytest.mark.parametrize("R", MESHES)
def test_scheduler_on_a_mesh(R):
    _renv, penv = _envs(R)
    one = tq.createQuESTEnv(device="cpu")
    thetas = [0.1 * (k + 1) for k in range(5)]
    results = []
    for env in (penv, one):
        sched = tq.EnsembleScheduler(NQ, env, max_batch=4)
        for th in thetas:
            sched.submit(_ansatz(C, th, NQ))
        results.append(sched.drain())
        assert sched.last_drain["buckets"] == 2
    for got, want in zip(*results):
        assert isinstance(got, SH.ShardedAmps)
        np.testing.assert_allclose(SH.gather_host(got), want.numpy(),
                                   atol=TOL, rtol=0)


def _noisy_ops(mod, n, theta=0.7):
    ry = np.array([[np.cos(theta / 2), -np.sin(theta / 2)],
                   [np.sin(theta / 2), np.cos(theta / 2)]])
    ry_soa = np.stack([ry, np.zeros((2, 2))])
    return [mod.Gate((0,), ry_soa), ("dephasing", 0, 0.2),
            mod.Gate((n - 1,), ry_soa), ("depolarising", n - 1, 0.15),
            ("damping", 0, 0.25), ("damping", n - 1, 0.3)]


@pytest.mark.parametrize("R", MESHES)
def test_trajectories_on_a_mesh(R):
    _renv, penv = _envs(R)
    n = 4
    one = tq.createQuESTEnv(device="cpu")
    codes = np.array([[3, 0, 0, 0], [0, 0, 0, 3], [1, 0, 0, 1]], np.int32)
    coeffs = np.array([1.0, 0.5, 0.25])
    a = tq.run_trajectories(_noisy_ops(C, n), n, penv, 16,
                            observable=(codes, coeffs), seed=9)
    b = tq.run_trajectories(_noisy_ops(C, n), n, penv, 16,
                            observable=(codes, coeffs), seed=9)
    want = tq.run_trajectories(_noisy_ops(C, n), n, one, 16,
                               observable=(codes, coeffs), seed=9)
    assert np.array_equal(a["values"], b["values"])
    np.testing.assert_allclose(a["values"], want["values"], atol=TOL,
                               rtol=0)
    out = tq.run_trajectories(_noisy_ops(C, n), n, penv, 8, seed=3)
    norms = (SH.gather_host(out["amps"]) ** 2).sum(axis=(1, 2))
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)


@pytest.mark.parametrize("R", MESHES)
def test_a_bank_carried_across_canonical_and_permuted(R):
    """A bank left permuted by its drain moves through register_state
    and load_register with its permutation: the reloaded bank reads the
    same canonical state, and a canonical load of the reference's bank
    reads back unchanged."""
    renv, penv = _envs(R)
    rng_ = np.random.default_rng(6)
    mats = np.stack([_unitary(rng_) for _ in range(NB)])
    bp = tq.createBatchedQureg(NQ, penv, NB)
    _mixed_circuit(tq, bp)
    tq.applyBatchedUnitary(bp, (NQ - 1,), mats)
    raw, perm = interop.register_state(bp)
    assert perm is not None and raw.shape == (NB, 2, 1 << NQ)
    other = tq.createBatchedQureg(NQ, penv, NB)
    interop.load_register(other, raw, perm)
    assert other._perm == perm
    np.testing.assert_array_equal(_state(other), _state(bp))
    bq = qt.createBatchedQureg(NQ, renv, NB)
    _mixed_circuit(qt, bq)
    qt.applyBatchedUnitary(bq, (NQ - 1,), mats)
    ref = _ref_state(bq)
    third = tq.createBatchedQureg(NQ, penv, NB)
    interop.load_register(third, ref)
    np.testing.assert_array_equal(_state(third), ref)
    np.testing.assert_allclose(_state(bp), ref, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="expected"):
        interop.load_register(third, ref[0])


@pytest.mark.parametrize("R", (2, 8))
def test_a_sharded_bank_plan_reaches_no_element_by_element_route(
        R, monkeypatch):
    """The sharded bank drain plans windowed passes only: a config-2 bank
    at 18 qubits (per-element unitaries) holds window passes and megawin
    groups with per-element sides, and no op that circuit.execute_plan
    runs element by element on a bank through K12's or K10's scalar
    form (swapfused, sigma_swap)."""
    _renv, _penv = _envs(R)
    monkeypatch.setenv("QT_MEGAKERNEL", "on")
    n, nb = 18, 2
    rng_ = np.random.default_rng(8)
    us = np.array([[[_unitary(rng_) for _ in range(n)] for _ in range(nb)]
                   for _ in range(3)])          # (depth, B, n, 2, 2)
    shadow = tq.createBatchedQureg(n, tq.createQuESTEnv(device="cpu"), nb)
    for d, layer in enumerate(us):
        for t in range(n):
            tq.applyBatchedUnitary(shadow, (t,), layer[:, t])
        for t in range(d % 2, n - 1, 2):
            tq.controlledNot(shadow, t, t + 1)
    items = list(shadow._fusion.gates)
    nloc = n - (R.bit_length() - 1)
    program, _final = PF.plan_items_sharded(
        items, n, nloc, device=torch.device("cpu"), batch_size=nb)
    kinds = {op[0] for part in program if part[0] in ("plan", "perm")
             for op in part[1]}
    assert {"winfused", "megawin"} <= kinds
    assert not kinds & {"swapfused", "sigma_swap"}
    sides = [op[2] for part in program if part[0] == "plan"
             for op in part[1] if op[0] == "winfused"]
    assert sides and all(np.ndim(s) == 5 and len(s) == nb for s in sides)


def test_the_shards_of_one_device_share_one_upload(monkeypatch):
    """A bank drain on 8 shards of one device uploads each planned part
    once (fusion.program_on_device keys on the plan and the device, so on
    the card the side images of every element are built once for all
    shards), and a second drain of the same program uploads nothing."""
    _renv, penv = _envs(8)
    calls = []
    real = C.plan_to_device
    monkeypatch.setattr(C, "plan_to_device", lambda ops, dt, dev: (
        calls.append(id(ops)), real(ops, dt, dev))[1])
    rng_ = np.random.default_rng(9)
    mats = np.stack([_unitary(rng_) for _ in range(NB)])

    def drain():
        b = tq.createBatchedQureg(NQ, penv, NB)
        _mixed_circuit(tq, b)
        tq.applyBatchedUnitary(b, (NQ - 1,), mats)
        return _state(b)

    first = drain()
    parts = len(calls)
    assert parts > 0 and len(set(calls)) == parts  # no part twice
    assert np.array_equal(drain(), first)
    assert len(calls) == parts
