"""Batched registers (M14) in the port against the JAX package.

* A BatchedQureg bank against the reference's bank (``quest_tpu.batch``,
  ``qt.createQuESTEnv(num_devices=1)``) within 1e-12 at float64: 6 qubits
  x 4 (tests/test_batch.py's circuit, per-element unitaries, a density
  bank) and 16 qubits x 3 under QT_MEGAKERNEL=on, so that the plans hold
  ``winfused`` passes and ``megawin`` groups with per-element sides.
* The bank against the port's own scalar drains, ``torch.equal``: each
  element is what its own register's drain gives, bit for bit.
* The bank kernels' plain versions (K1, K2, K5 and K11 through K1) against
  the scalar plain versions element by element, and the per-element TF32
  split of a bank mixing exact and inexact sides.
* A bank whose elements plan to different skeletons raises the
  reference's error; the eager fallbacks and the single-register
  measurements refuse a bank.
* ``measureBatched`` gives the reference's outcomes and probabilities for
  the same per-element seeds, and each element's measureWithStats loop.
* ``calcExpecPauliSumBatched``, the ``EnsembleScheduler``'s buckets and
  padding, ``run_trajectories`` (reproducible by seed, the reference's
  values for the same seed, converging to the density route), and the
  optimizer's merges of per-element (B, 2, s, s) stacks, which equal the
  reference's bit for bit.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu.circuit as RC
import quest_tpu_torch as tq
from quest_tpu import optimizer as ref_opt
from quest_tpu import rng as ref_rng
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu_torch import batch as TB
from quest_tpu_torch import circuit as C
from quest_tpu_torch import fusion, optimizer, precision, rng
from quest_tpu_torch.ops import fused
from quest_tpu_torch.ops import measurement as M

NQ = 6
NB = 4
TOL = 1e-12
M14_NAMES = ("BatchedQureg", "createBatchedQureg", "applyBatchedUnitary",
             "measureBatched", "calcExpecPauliSumBatched",
             "EnsembleScheduler", "run_trajectories", "runTrajectories")


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


@pytest.fixture
def envs():
    return qt.createQuESTEnv(num_devices=1), tq.createQuESTEnv(device="cpu")


def _unitary(rng, k=1):
    g = rng.standard_normal((1 << k, 1 << k)) \
        + 1j * rng.standard_normal((1 << k, 1 << k))
    u, _ = np.linalg.qr(g)
    return u


def _mixed_circuit(pkg, q, depth=2):
    """tests/test_batch.py's circuit: every gate shared."""
    for d in range(depth):
        for t in range(NQ):
            pkg.hadamard(q, t)
        pkg.controlledNot(q, NQ - 1, 0)
        pkg.rotateZ(q, 2, 0.3 + 0.1 * d)
        pkg.swapGate(q, 1, NQ - 2)


def _np(t):
    return t.detach().cpu().numpy()


def test_public_names():
    for name in M14_NAMES:
        assert hasattr(tq, name), name
    assert tq.runTrajectories is tq.run_trajectories
    from quest_tpu_torch.models import qaoa, vqe  # noqa: F401


# ---------------------------------------------------------------------------
# The bank against the reference and against its own scalar drains
# ---------------------------------------------------------------------------


def test_shared_gates_bank(envs):
    bq = qt.createBatchedQureg(NQ, envs[0], NB)
    _mixed_circuit(qt, bq)
    bp = tq.createBatchedQureg(NQ, envs[1], NB)
    _mixed_circuit(tq, bp)
    bank = bp.amps
    assert tuple(bank.shape) == (NB, 2, 1 << NQ)
    np.testing.assert_allclose(_np(bank), np.asarray(bq.amps), atol=TOL,
                               rtol=0)
    for i in range(NB):
        qi = tq.createQureg(NQ, envs[1])
        with tq.gateFusion(qi):
            _mixed_circuit(tq, qi)
        assert torch.equal(bank[i], qi.amps)


@pytest.mark.parametrize("density", [False, True])
def test_per_element_unitaries_bank(envs, density):
    rng = np.random.default_rng(1)
    nq = 3 if density else NQ
    mats = np.stack([_unitary(rng) for _ in range(NB)])
    mats2 = np.stack([_unitary(rng, 2) for _ in range(NB)])
    banks = []
    for pkg, env in zip((qt, tq), envs):
        b = pkg.createBatchedQureg(nq, env, NB, is_density_matrix=density)
        pkg.applyBatchedUnitary(b, (1,), mats)
        pkg.hadamard(b, 0)
        pkg.applyBatchedUnitary(b, (0, 1), mats2, controls=(nq - 1,))
        pkg.controlledNot(b, 2, 1)
        banks.append(b)
    bank = banks[1].amps
    np.testing.assert_allclose(_np(bank), np.asarray(banks[0].amps),
                               atol=TOL, rtol=0)
    make = tq.createDensityQureg if density else tq.createQureg
    for i in range(NB):
        qi = make(nq, envs[1])
        with tq.gateFusion(qi):
            tq.unitary(qi, 1, mats[i])
            tq.hadamard(qi, 0)
            tq.controlledMultiQubitUnitary(qi, nq - 1, [0, 1], mats2[i])
            tq.controlledNot(qi, 2, 1)
        assert torch.equal(bank[i], qi.amps)


def _layers(pkg, q, n, us, bank: bool):
    """A config-2 structure of depth len(us): per layer one 1q unitary on
    every qubit (per element on a bank), then a CNOT ladder."""
    for d, layer in enumerate(us):
        for t in range(n):
            if bank:
                pkg.applyBatchedUnitary(q, (t,), layer[:, t])
            else:
                pkg.unitary(q, t, layer[t])
        for t in range(d % 2, n - 1, 2):
            pkg.controlledNot(q, t, t + 1)


def test_sixteen_qubit_bank_with_window_passes(envs, monkeypatch):
    """16 qubits x 3 with per-element unitaries: the bank's plan holds
    winfused passes and megawin groups whose sides are per element; the
    port matches the reference's bank within 1e-12 and its own scalar
    drains bit for bit."""
    monkeypatch.setenv("QT_MEGAKERNEL", "on")
    n, nb = 16, 3
    rng = np.random.default_rng(7)
    us = np.array([[[_unitary(rng) for _ in range(n)] for _ in range(nb)]
                   for _ in range(2)])          # (depth, B, n, 2, 2)
    bp = tq.createBatchedQureg(n, envs[1], nb)
    _layers(tq, bp, n, us, bank=True)
    items, _ = optimizer.optimize_items(list(bp._fusion.gates), nloc=n)
    program = fusion.plan_items(list(bp._fusion.gates), n,
                                device=torch.device("cpu"), batch_size=nb)
    stats = fusion.program_stats(program)
    assert stats.get("megawin", 0) >= 1
    sides = [op[2] for part in program if part[0] == "plan"
             for op in part[1] if op[0] == "winfused"]
    sides += [sub[2] for part in program if part[0] == "plan"
              for op in part[1] if op[0] == "megawin" for sub in op[1]]
    assert sides and all(np.ndim(s) == 5 and len(s) == nb for s in sides)
    bank = bp.amps
    bq = qt.createBatchedQureg(n, envs[0], nb)
    _layers(qt, bq, n, us, bank=True)
    np.testing.assert_allclose(_np(bank), np.asarray(bq.amps), atol=TOL,
                               rtol=0)
    for i in (0, nb - 1):
        qi = tq.createQureg(n, envs[1])
        with tq.gateFusion(qi):
            _layers(tq, qi, n, us[:, i], bank=False)
        assert torch.equal(bank[i], qi.amps)


def test_density_bank_channels(envs):
    """Captured depolarising and damping channels on a density bank
    (the drain's channel parts, every element under the same
    probabilities) against the reference's bank and the scalar drains."""
    rng = np.random.default_rng(2)
    nq = 3
    mats = np.stack([_unitary(rng) for _ in range(NB)])
    banks = []
    for pkg, env in zip((qt, tq), envs):
        b = pkg.createBatchedQureg(nq, env, NB, is_density_matrix=True)
        pkg.applyBatchedUnitary(b, (0,), mats)
        pkg.mixDepolarising(b, 0, 0.1)
        pkg.mixDamping(b, 1, 0.2)
        pkg.mixDephasing(b, 2, 0.05)
        banks.append(b)
    bank = banks[1].amps
    np.testing.assert_allclose(_np(bank), np.asarray(banks[0].amps),
                               atol=TOL, rtol=0)
    for i in range(NB):
        qi = tq.createDensityQureg(nq, envs[1])
        with tq.gateFusion(qi):
            tq.unitary(qi, 0, mats[i])
            tq.mixDepolarising(qi, 0, 0.1)
            tq.mixDamping(qi, 1, 0.2)
            tq.mixDephasing(qi, 2, 0.05)
        assert torch.equal(bank[i], qi.amps)


def test_scalar_init_broadcasts_and_element(envs):
    bp = tq.createBatchedQureg(NQ, envs[1], NB)
    tq.hadamard(bp, 0)
    tq.initZeroState(bp)
    bank = bp.amps
    assert tuple(bank.shape) == (NB, 2, 1 << NQ)
    assert torch.all(bank[:, 0, 0] == 1.0)
    assert float(bank.abs().sum()) == NB
    assert torch.equal(bp.element(2), bank[2])
    with pytest.raises(tq.QuESTError, match="out of range"):
        bp.element(NB)


# ---------------------------------------------------------------------------
# Planning: skeletons, the cache key, the optimizer
# ---------------------------------------------------------------------------


def _skeleton_mismatch(pkg, env):
    """Element 0 runs two X gates (a permutation run), element 1 two H
    gates (a dense run): different program skeletons."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    b = pkg.createBatchedQureg(NQ, env, 2)
    pkg.applyBatchedUnitary(b, (0,), np.stack([x, h]))
    pkg.applyBatchedUnitary(b, (1,), np.stack([x, h]))
    return b


def test_skeleton_mismatch_raises_the_reference_error(envs):
    with pytest.raises(qt.QuESTError) as ref:
        _ = _skeleton_mismatch(qt, envs[0]).amps
    with pytest.raises(tq.QuESTError) as port:
        _ = _skeleton_mismatch(tq, envs[1]).amps
    assert str(port.value) == str(ref.value)


def test_plan_cache_keys_on_the_bank(envs):
    """Two banks with the same structure and different matrices, and a
    bank of another size, never replay each other's programs."""
    rng = np.random.default_rng(3)
    items = lambda m: [C.Gate((1,), TB._soa_per_element(m, len(m)))]  # noqa
    m1 = np.stack([_unitary(rng) for _ in range(2)])
    m2 = np.stack([_unitary(rng) for _ in range(2)])
    dev = torch.device("cpu")
    p1 = fusion.plan_items(items(m1), NQ, device=dev, batch_size=2)
    p2 = fusion.plan_items(items(m2), NQ, device=dev, batch_size=2)
    assert not np.array_equal(p1[0][1][0][2], p2[0][1][0][2])
    shared = [C.Gate((1,), TB._soa_per_element(m1, 2)[0])]
    k0 = fusion._plan_key(shared, NQ, False, dev)
    k1 = fusion._plan_key(shared, NQ, False, dev, (1, 0))
    assert k0 != k1
    assert fusion.batch_flag(shared, 0) == 0
    assert fusion.batch_flag(shared, 2) == 1
    assert fusion.batch_flag(items(m1), 2) == 2


def test_optimizer_merges_per_element_stacks_like_the_reference():
    """Per-element (B, 2, s, s) stacks merge with shared ones and with
    each other, the diagonal and permutation passes skip them, and every
    merged matrix equals the reference's bit for bit."""
    rng = np.random.default_rng(4)
    B = 3

    def soa(u):
        return np.stack([u.real, u.imag])

    per = lambda k: np.stack([soa(_unitary(rng, k)) for _ in range(B)])  # noqa
    x = soa(np.array([[0, 1], [1, 0]], dtype=complex))
    z = soa(np.diag([1, -1]).astype(complex))
    stream = [(0,), per(1), (0,), soa(_unitary(rng)), (1,), x, (1,), x,
              (2,), z, (2, 3), per(2), (2, 3), per(2), (0,), per(1),
              (4,), z, (5,), per(1)]
    pairs = list(zip(stream[::2], stream[1::2]))
    port_items = [C.Gate(t, m) for t, m in pairs]
    ref_items = [RC.Gate(t, m) for t, m in pairs]
    got, _ = optimizer.optimize_items(port_items, nloc=NQ)
    want, _ = ref_opt.optimize_items(ref_items, n=NQ, nloc=NQ)
    assert [g.targets for g in got] == [g.targets for g in want]
    for g, w in zip(got, want):
        assert np.asarray(g.mat).shape == np.asarray(w.mat).shape
        assert np.array_equal(np.asarray(g.mat), np.asarray(w.mat))
    assert any(np.ndim(g.mat) == 4 for g in got)


# ---------------------------------------------------------------------------
# The bank kernels' plain versions and the per-element split
# ---------------------------------------------------------------------------


def _sides(rng, rank, nb=None):
    shape = (rank, 2, 128, 128) if nb is None else (nb, rank, 2, 128, 128)
    return rng.standard_normal(shape) / 128


@pytest.mark.parametrize("per_sides,per_mask", [(False, False),
                                                (True, False),
                                                (False, True),
                                                (True, True)])
def test_window_pass_bank_plain_is_the_scalar_per_element(per_sides,
                                                          per_mask):
    rng = np.random.default_rng(5)
    n, nb = 15, 3
    bank = torch.as_tensor(rng.standard_normal((nb, 2, 1 << n)))
    a = _sides(rng, 2, nb if per_sides else None)
    b = _sides(rng, 2, nb if per_sides else None)
    mask = rng.standard_normal((nb, 2, 128, 128) if per_mask
                               else (2, 128, 128))
    out = fused.apply_window_stack(bank, a, b, mask, num_qubits=n, k=8)
    for e in range(nb):
        want = fused.apply_window_stack(
            bank[e], a[e] if per_sides else a, b[e] if per_sides else b,
            mask[e] if per_mask else mask, num_qubits=n, k=8)
        assert torch.equal(out[e], want)


def test_megawin_and_cluster_bank_plain_are_the_scalar_per_element():
    rng = np.random.default_rng(6)
    n, nb = 16, 2
    bank = torch.as_tensor(rng.standard_normal((nb, 2, 1 << n)))
    subops = (("winfused", 7, _sides(rng, 1, nb), _sides(rng, 1, nb), True,
               True, None),
              ("winfused", 9, _sides(rng, 1), _sides(rng, 1), False, True,
               rng.standard_normal((nb, 2, 128, 128))))
    out = fused.apply_window_megastack(bank, subops, num_qubits=n)
    a, b = _sides(rng, 2, nb), _sides(rng, 2)
    out2 = fused.apply_cluster_stack(bank, a, b, num_qubits=n)
    for e in range(nb):
        want = fused.apply_window_megastack(
            bank[e], [fused.bank_element_op(op, e) for op in subops],
            num_qubits=n)
        assert torch.equal(out[e], want)
        assert torch.equal(out2[e], fused.apply_cluster_stack(
            bank[e], a[e], b, num_qubits=n))


def test_channel_sweep_bank_plain_is_the_scalar_per_element():
    rng = np.random.default_rng(8)
    nn, nb = 16, 3
    bank = torch.as_tensor(rng.standard_normal((nb, 2, 1 << nn)),
                           dtype=torch.float32)
    program = (("depol", 0, 8), ("damping", 3, 11), ("depol", 5, 14))
    probs = (0.1, 0.2, 0.05)
    out = fused.apply_pair_channel_sweep(bank, program, probs,
                                         num_bits=nn)
    for e in range(nb):
        assert torch.equal(out[e], fused.apply_pair_channel_sweep(
            bank[e], program, probs, num_bits=nn))


def test_bank_split_is_per_element():
    """A float32 bank mixing exact sides (the identity, X, 0/1 entries)
    and inexact ones takes SPLIT_EXACT and SPLIT_TF32X3 element by
    element under "highest", each element's scalar split; lower modes and
    float64 take one split for all."""
    rng = np.random.default_rng(9)
    exact = np.zeros((1, 2, 128, 128))
    exact[0, 0] = np.eye(128)[::-1]
    inexact = _sides(rng, 1)
    stack = np.stack([exact, inexact, exact, inexact]).astype(np.float32)
    got = fused.bank_pass_splits(torch.float32, "highest", 4, stack)
    assert got == tuple(fused.pass_split(torch.float32, "highest", s)
                        for s in stack)
    assert got == (fused.SPLIT_EXACT, fused.SPLIT_TF32X3,
                   fused.SPLIT_EXACT, fused.SPLIT_TF32X3)
    t = torch.as_tensor(stack)
    assert fused.bank_pass_splits(torch.float32, "highest", 4, t,
                                  exact[0].astype(np.float32)) == got
    assert fused.bank_pass_splits(torch.float32, "highest", 4, t,
                                  inexact[0].astype(np.float32)) == (0,) * 4
    assert fused.bank_pass_splits(torch.float32, "default", 4, t) == (
        fused.SPLIT_TF32,) * 4
    assert fused.bank_pass_splits(torch.float64, "highest", 4, t) == (
        fused.SPLIT_EXACT,) * 4
    # the per-element images are cached under each element's own key
    img0 = fused._side_image(t, torch.float32, "cpu", got[0], elem=0)
    img1 = fused._side_image(t, torch.float32, "cpu", got[1], elem=1)
    assert img0.shape != img1.shape
    assert fused._side_image(t, torch.float32, "cpu", got[1], elem=1) \
        is img1


def test_bank_kernels_refuse_a_cpu_free_device():
    """The wrappers take their plain versions on a bank only for a CPU
    tensor."""
    bank = torch.zeros((2, 2, 1 << 14), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_window_stack(bank, _sides(np.random.default_rng(),
                                                   1), _sides(
            np.random.default_rng(), 1), num_qubits=14)


def test_window_entry_signature_matches_the_source():
    """fused.WINDOW_ARGTYPES declares qt_window_pass_f32/_f64 as
    csrc/window.cu defines them: one register and a bank share the entry
    (a bank count, the elements' passes on the host and on the card)."""
    src = (pathlib.Path(fused.__file__).parent.parent / "csrc"
           / "window.cu").read_text()
    for name in ("qt_window_pass_f32", "qt_window_pass_f64"):
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        want = []
        for p in (" ".join(q.split()) for q in m.group(1).split(",")):
            if p.startswith("const QtPass*"):
                want.append(ctypes.POINTER(fused._QtPass))
            elif "*" in p:
                want.append(ctypes.c_void_p)
            else:
                assert p.startswith("int "), p
                want.append(ctypes.c_int)
        assert list(fused.WINDOW_ARGTYPES) == want, name
    assert "window_pass_bank" not in src


@pytest.mark.parametrize("shape,nq,want", [((2, 1 << 14), 14, 0),
                                           ((2, 1, 128, 128), 14, 0),
                                           ((3, 2, 1 << 14), 14, 3),
                                           ((1, 2, 1 << 15), 15, 1),
                                           ((2, 2, 1 << 14), 15, 0)])
def test_bank_size(shape, nq, want):
    assert fused.bank_size(torch.zeros(shape), nq) == want


def test_bank_element_op_slices_only_per_element_arrays():
    rng = np.random.default_rng(12)
    nb = 3
    per, shared = _sides(rng, 1, nb), _sides(rng, 1)
    masks = rng.standard_normal((nb, 2, 128, 128))
    mats = rng.standard_normal((nb, 2, 4, 4))
    win = ("winfused", 8, per, shared, True, True, masks)
    for b in range(nb):
        e = fused.bank_element_op(win, b)
        assert e[:2] == win[:2] and e[4:6] == win[4:6]
        assert e[2] is not per and np.array_equal(e[2], per[b])
        assert e[3] is shared and np.array_equal(e[6], masks[b])
        mega = fused.bank_element_op(("megawin", [win, win]), b)
        assert np.array_equal(mega[1][1][2], per[b])
        assert np.array_equal(fused.bank_element_op(
            ("fused", shared, per), b)[2], per[b])
        sw = fused.bank_element_op(("swapfused", 14, 7, 2, per, shared), b)
        assert sw[:4] == ("swapfused", 14, 7, 2) and sw[5] is shared
        ap = fused.bank_element_op(("apply", (0, 3), mats), b)
        assert ap[1] == (0, 3) and np.array_equal(ap[2], mats[b])
        assert fused.bank_element_op(("apply", (0,), mats[0, :, :2, :2]),
                                     b)[2] is not None
        assert fused.bank_element_op(("permute", (1, 0)), b) == (
            "permute", (1, 0))


def test_bank_descriptors_per_element():
    """The per-element QtPass descriptors of a bank pass whose A side is
    per element and B side shared: each element its own A image and split,
    one shared B image; a per-element stack of another length raises."""
    rng = np.random.default_rng(14)
    nb = 3
    bank = torch.zeros((nb, 2, 1 << 14), dtype=torch.float32)
    exact = np.zeros((1, 2, 128, 128), dtype=np.float32)
    exact[0, 0] = np.eye(128)
    a = np.stack([exact, _sides(rng, 1).astype(np.float32), exact])
    b = exact
    op = ("winfused", 7, a, b, True, True, None)
    assert fused._per_element(op)
    assert fused._per_element(("winfused", 7, b, a, True, True, None))
    assert not fused._per_element(("winfused", 7, b, b, True, True, None))
    keep = []
    d0, descs = fused._bank_descs(op, bank, keep, "highest")
    assert [d.split for d in descs] == [fused.SPLIT_EXACT, fused.SPLIT_TF32X3,
                                        fused.SPLIT_EXACT]
    assert len({d.a for d in descs}) == nb and d0.a == descs[0].a
    assert descs[0].b == descs[2].b
    assert all(d.rank == 1 and d.mask is None for d in descs)
    with pytest.raises(ValueError, match="3 elements"):
        fused._bank_descs(("winfused", 7, a[:2], b, True, True, None), bank,
                          [], "highest")


def test_execute_plan_runs_a_bank_element_by_element():
    """circuit.execute_plan on a (B, 2, 2^n) bank equals the plan of each
    element (its own per-element arrays) run on that element alone,
    bit for bit, over every op kind a bank plan holds."""
    rng = np.random.default_rng(13)
    n, nb = 15, 2
    bank = torch.as_tensor(rng.standard_normal((nb, 2, 1 << n)))
    ops = [("winfused", 8, _sides(rng, 1, nb), _sides(rng, 1), True, True,
            rng.standard_normal((nb, 2, 128, 128))),
           ("apply", (1, 4), rng.standard_normal((nb, 2, 4, 4))),
           ("apply", (2,), rng.standard_normal((2, 2, 2))),
           ("permute", tuple(reversed(range(n)))),
           ("xor", (0, 9)),
           ("segswap", 14, 7, 1),
           ("fused", _sides(rng, 2), _sides(rng, 2, nb)),
           ("swapfused", 14, 8, 1, _sides(rng, 1, nb), _sides(rng, 1)),
           ("megawin", [("winfused", 7, _sides(rng, 1), _sides(rng, 1, nb),
                         True, True, None)])]
    got = C.execute_plan(bank, ops, n)
    assert got.shape == bank.shape
    for b in range(nb):
        want = C.execute_plan(bank[b].clone(),
                              [fused.bank_element_op(op, b) for op in ops],
                              n)
        assert torch.equal(got[b], want)


# ---------------------------------------------------------------------------
# Guards, measurement, expectation values
# ---------------------------------------------------------------------------


def test_eager_fallback_and_single_register_measures_refuse_a_bank(envs):
    bp = tq.createBatchedQureg(NQ, envs[1], NB)
    with pytest.raises(tq.QuESTError, match="BatchedQureg"):
        tq.multiRotateZ(bp, [0, 1], 0.3)
    with pytest.raises(tq.QuESTError, match="measureBatched"):
        tq.measure(bp, 0)
    with pytest.raises(tq.QuESTError, match="measureBatched"):
        tq.measureSequence(bp, [0, 1])
    with pytest.raises(tq.QuESTError, match="not a BatchedQureg"):
        tq.measureBatched(tq.createQureg(NQ, envs[1]), 0)


@pytest.mark.parametrize("density", [False, True])
def test_measure_batched_matches_reference_and_scalar_loops(envs, density):
    nq = 3 if density else NQ
    seeds = [[100 + i] for i in range(NB)]
    rng = np.random.default_rng(10)
    mats = np.stack([_unitary(rng) for _ in range(NB)])
    banks = []
    for pkg, env in zip((qt, tq), envs):
        b = pkg.createBatchedQureg(nq, env, NB, seeds=seeds,
                                   is_density_matrix=density)
        for t in range(nq):
            pkg.hadamard(b, t)
        pkg.applyBatchedUnitary(b, (1,), mats)
        banks.append(b)
    res = []
    for pkg, b in zip((qt, tq), banks):
        o1, p1 = pkg.measureBatched(b, 2)
        o2, p2 = pkg.measureBatched(b, 0)
        res.append((o1, p1, o2, p2))
    for r, p in zip(res[0], res[1]):
        np.testing.assert_allclose(p, np.asarray(r), atol=TOL, rtol=0)
    assert list(res[1][0]) == [int(v) for v in res[0][0]]
    bank = banks[1].amps
    make = tq.createDensityQureg if density else tq.createQureg
    for i in range(NB):
        qi = make(nq, envs[1])
        M.KEYS.seed(seeds[i])
        with tq.gateFusion(qi):
            for t in range(nq):
                tq.hadamard(qi, t)
            tq.unitary(qi, 1, mats[i])
        o1, p1 = tq.measureWithStats(qi, 2)
        o2, p2 = tq.measureWithStats(qi, 0)
        assert (o1, o2) == (int(res[1][0][i]), int(res[1][2][i]))
        assert (p1, p2) == (res[1][1][i], res[1][3][i])
        assert torch.equal(bank[i], qi.amps)
    assert banks[1].key_state() == banks[0].key_state()
    assert banks[1].key_state()["counters"] == [2] * NB


def test_expectation_batched(envs):
    rng = np.random.default_rng(3)
    mats = np.stack([_unitary(rng) for _ in range(NB)])
    codes = rng.integers(0, 4, size=(3, NQ)).astype(np.int32)
    coeffs = np.linspace(0.5, 1.5, 3)
    vals = []
    for pkg, env in zip((qt, tq), envs):
        b = pkg.createBatchedQureg(NQ, env, NB)
        pkg.applyBatchedUnitary(b, (0,), mats)
        pkg.hadamard(b, 3)
        vals.append(pkg.calcExpecPauliSumBatched(b, codes, coeffs))
    np.testing.assert_allclose(vals[1], vals[0], atol=TOL, rtol=0)
    for i in range(NB):
        qi = tq.createQureg(NQ, envs[1])
        tq.unitary(qi, 0, mats[i])
        tq.hadamard(qi, 3)
        assert vals[1][i] == tq.calcExpecPauliSum(qi, codes.ravel(), coeffs)


# ---------------------------------------------------------------------------
# EnsembleScheduler
# ---------------------------------------------------------------------------


def _ansatz(mod, theta, gates=3):
    h = np.stack([np.array([[1, 1], [1, -1]]) / np.sqrt(2),
                  np.zeros((2, 2))])
    rz = np.stack([np.diag([np.cos(theta / 2), np.cos(theta / 2)]),
                   np.diag([-np.sin(theta / 2), np.sin(theta / 2)])])
    return [mod.Gate((0,), h), mod.Gate((1,), rz), mod.Gate((2,), h)][:gates]


def test_scheduler_buckets_padding_and_results(envs):
    """Five submissions of one structure and three of another, at most
    four to a bucket: buckets of 4 + 1 and one of 3 padded to 4 with its
    last submission; every result equals its independent drain and the
    reference scheduler's result."""
    thetas = [0.1 * (k + 1) for k in range(8)]
    kinds = [3, 3, 2, 3, 2, 3, 2, 3]
    results = []
    for pkg, mod, env in ((qt, RC, envs[0]), (tq, C, envs[1])):
        sched = pkg.EnsembleScheduler(NQ, env, max_batch=4)
        for th, g in zip(thetas, kinds):
            sched.submit(_ansatz(mod, th, g))
        results.append(sched.drain())
    assert sched.last_drain == {**sched.last_drain, "circuits": 8,
                                "groups": 2, "buckets": 3, "real": 8,
                                "padded": 9}
    assert TB._bucket_size(3, 64) == 4 and TB._bucket_size(5, 4) == 4
    assert TB.bank_occupancy(tq.createBatchedQureg(2, envs[1], 3)) == {
        "size": 3, "bucket": 4, "occupancy": 0.75}
    for k, (th, g) in enumerate(zip(thetas, kinds)):
        np.testing.assert_allclose(_np(results[1][k]),
                                   np.asarray(results[0][k]), atol=TOL,
                                   rtol=0)
        qi = tq.createQureg(NQ, envs[1])
        with tq.gateFusion(qi):
            qi._fusion.gates.extend(_ansatz(C, th, g))
        assert torch.equal(results[1][k], qi.amps)
    with pytest.raises(tq.QuESTError, match="power of two"):
        tq.EnsembleScheduler(NQ, envs[1], max_batch=6)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------


def _noisy_ops(mod, theta=0.7):
    ry = np.array([[np.cos(theta / 2), -np.sin(theta / 2)],
                   [np.sin(theta / 2), np.cos(theta / 2)]])
    ry_soa = np.stack([ry, np.zeros((2, 2))])
    ops = [mod.Gate((0,), ry_soa), ("dephasing", 0, 0.2),
           mod.Gate((1,), ry_soa), ("depolarising", 1, 0.15),
           ("damping", 0, 0.25)]
    return ops, ry


def test_trajectories_match_reference_and_are_reproducible(envs):
    codes = np.array([[3, 0], [0, 3], [1, 1]], dtype=np.int32)
    coeffs = np.array([1.0, 0.5, 0.25])
    ref = qt.run_trajectories(_noisy_ops(RC)[0], 2, envs[0], 32,
                              observable=(codes, coeffs), seed=9)
    a = tq.run_trajectories(_noisy_ops(C)[0], 2, envs[1], 32,
                            observable=(codes, coeffs), seed=9)
    b = tq.runTrajectories(_noisy_ops(C)[0], 2, envs[1], 32,
                           observable=(codes, coeffs), seed=9)
    assert np.array_equal(a["values"], b["values"])
    np.testing.assert_allclose(a["values"], ref["values"], atol=1e-10,
                               rtol=0)
    assert a["mean"] == pytest.approx(ref["mean"], abs=1e-10)
    out = tq.run_trajectories(_noisy_ops(C)[0], 2, envs[1], 32, seed=3)
    norms = (out["amps"] ** 2).sum(dim=(1, 2))
    np.testing.assert_allclose(_np(norms), 1.0, atol=1e-12)
    with pytest.raises(tq.QuESTError, match="unknown noise kind"):
        tq.run_trajectories([("bitflip", 0, 0.1)], 2, envs[1], 4)


def test_trajectories_converge_to_the_density_route(envs):
    ops, ry = _noisy_ops(C)
    nq = 2
    codes = np.array([[3, 0], [0, 3], [1, 1]], dtype=np.int32)
    coeffs = np.array([1.0, 0.5, 0.25])
    out = tq.run_trajectories(ops, nq, envs[1], 512,
                              observable=(codes, coeffs), seed=5)
    rho = tq.createDensityQureg(nq, envs[1])
    tq.unitary(rho, 0, ry)
    tq.mixDephasing(rho, 0, 0.2)
    tq.unitary(rho, 1, ry)
    tq.mixDepolarising(rho, 1, 0.15)
    tq.mixDamping(rho, 0, 0.25)
    h = tq.createPauliHamil(nq, 3)
    h.pauli_codes[:] = codes
    h.term_coeffs[:] = coeffs
    exact = tq.calcExpecPauliHamil(rho, h)
    assert out["values"].shape == (512,)
    assert out["sem"] > 0
    assert abs(out["mean"] - exact) < 5 * out["sem"]
