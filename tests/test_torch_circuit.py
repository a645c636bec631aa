"""quest_tpu_torch.circuit (the windowed planner and executor) against
quest_tpu.circuit.

With QT_MEGAKERNEL=off both packages must plan a gate stream into the same
ops: the same kinds, window offsets, ranks and side flags, and matrices
within 1e-12 (the planners run the same NumPy algebra; 1e-12 leaves room
for BLAS summation order on another machine).  Executing the JAX package's
own plan with the port's executor must give its amplitudes within 1e-10
at float64 (the window passes sum 128-term products in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quest_tpu import circuit as RC
from quest_tpu_torch import circuit as C
from quest_tpu_torch import interop
from quest_tpu_torch.models import circuits as TM

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run: its
    spinning worker threads starve the other test processes (with 6 test
    processes on 8 cores, tests of 0.8 s took 40 s)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


PLAN_TOL = 1e-12
STATE_TOL = 1e-10


@pytest.fixture(autouse=True)
def _no_megakernel(monkeypatch):
    monkeypatch.setenv("QT_MEGAKERNEL", "off")


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _soa(u):
    return np.stack([u.real, u.imag])


_X = np.array([[0, 1], [1, 0]], complex)


def _random_stream(rng, n, count):
    """(targets, SoA matrix) pairs: 1q Haar unitaries and a mix of 2q gates
    (Haar, CNOT, CZ, controlled phase, controlled unitary) on random
    qubit pairs."""
    out = []
    for _ in range(count):
        kind = rng.integers(0, 6)
        if kind <= 1:
            out.append(((int(rng.integers(n)),), _soa(_unitary(rng, 2))))
            continue
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        if kind == 2:
            m = _unitary(rng, 4)
        elif kind == 3:
            m = np.eye(4, dtype=complex)
            m[2:, 2:] = _X
        elif kind == 4:
            m = np.diag([1, 1, 1, np.exp(1j * rng.uniform(0, 2 * np.pi))])
        else:
            m = np.eye(4, dtype=complex)
            m[2:, 2:] = _unitary(rng, 2)
        out.append(((a, b), _soa(m)))
    return out


def _streams():
    us = TM.bench_unitaries(16, 6, seed=11, dtype=np.float64)
    bench = [(g.targets, g.mat) for g in TM.bench_gate_list(16, 6, us)]
    return {
        "bench16": (16, bench),
        "random15": (15, _random_stream(np.random.default_rng(15), 15, 40)),
        "random16": (16, _random_stream(np.random.default_rng(16), 16, 40)),
    }


_STREAMS = _streams()


@functools.lru_cache(maxsize=None)
def _port_plan(name):
    n, stream = _STREAMS[name]
    return tuple(C.plan_circuit([C.Gate(t, m) for t, m in stream], n))


@functools.lru_cache(maxsize=None)
def _ref_plan(name):
    n, stream = _STREAMS[name]
    return tuple(RC.plan_circuit([RC.Gate(t, m) for t, m in stream], n,
                                 use_native=False))


def _assert_same_op(mine, ref):
    assert mine[0] == ref[0]
    if mine[0] == "winfused":
        assert mine[1] == ref[1]
        assert (bool(mine[4]), bool(mine[5])) == (bool(ref[4]), bool(ref[5]))
        assert np.shape(mine[2]) == np.shape(ref[2])
        for x, y in ((mine[2], ref[2]), (mine[3], ref[3])):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=0, atol=PLAN_TOL)
        assert (mine[6] is None) == (ref[6] is None)
        if mine[6] is not None:
            np.testing.assert_allclose(np.asarray(mine[6]), np.asarray(ref[6]),
                                       rtol=0, atol=PLAN_TOL)
    elif mine[0] == "apply":
        assert tuple(mine[1]) == tuple(ref[1])
        np.testing.assert_allclose(np.asarray(mine[2]), np.asarray(ref[2]),
                                   rtol=0, atol=PLAN_TOL)
    else:
        assert tuple(mine) == tuple(ref)


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_plan_matches_reference(name):
    mine, ref = _port_plan(name), _ref_plan(name)
    assert [op[0] for op in mine] == [op[0] for op in ref]
    for a, b in zip(mine, ref):
        _assert_same_op(a, b)
    assert C.stats(mine) == RC.stats(ref)


def test_split_plan_sides_matches_reference():
    """The side-minimisation rewrite (QT_SIDE_SPLIT=1, off by default):
    a run of rank-1 maskless dual-side passes becomes B-only passes plus
    one merged A pass, in both packages, and computes the same state."""
    rng = np.random.default_rng(8)
    n = 16

    def side():
        return _soa(_unitary(rng, 128))[None]

    ops = [("winfused", k, side(), side(), True, True, None)
           for k in (7, 9, 8, 9)]
    mine = C.split_plan_sides(ops)
    ref = RC.split_plan_sides(ops)
    assert [op[0] for op in mine] == [op[0] for op in ref]
    for a, b in zip(mine, ref):
        _assert_same_op(a, b)
    assert sum(1 for op in mine if op[4] and op[5]) < len(ops)
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    np.testing.assert_allclose(C.execute_plan(x, mine, n).numpy(),
                               C.execute_plan(x, ops, n).numpy(), rtol=0,
                               atol=STATE_TOL)


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_group_megawins_is_a_pure_regroup(name):
    n = _STREAMS[name][0]
    plan = _port_plan(name)
    grouped = C.group_megawins(plan, n)
    flat = [s for op in grouped
            for s in (op[1] if op[0] == "megawin" else (op,))]
    assert len(flat) == len(plan)
    assert all(a is b for a, b in zip(flat, plan))
    for op in grouped:
        if op[0] == "megawin":
            assert len(op[1]) >= 2
            kmax = max(s[1] for s in op[1])
            assert (1 << (kmax - 7)) <= min(8, 1 << (n - 14))


@pytest.mark.parametrize("name", ["bench16", "random15"])
def test_reference_plan_runs_on_the_port_executor(name):
    n = _STREAMS[name][0]
    plan = _ref_plan(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1 << n))
    x /= np.sqrt((x ** 2).sum())
    want = np.asarray(RC.execute_plan(jnp.asarray(x), plan, n,
                                      interpret=True))
    got = C.execute_plan(interop.state_from_numpy(x, "cpu"),
                         interop.plan_from_numpy(plan, "cpu", torch.float64),
                         n)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, rtol=0,
                               atol=STATE_TOL)


def test_plan_from_numpy_recurses_into_megawin_groups(monkeypatch):
    monkeypatch.setenv("QT_MEGAKERNEL", "on")
    n = _STREAMS["bench16"][0]
    plan = RC.group_megawins(_ref_plan("bench16"), n)
    assert any(op[0] == "megawin" for op in plan)
    ported = interop.plan_from_numpy(plan, "cpu", torch.float64)
    for op in ported:
        subs = op[1] if op[0] == "megawin" else (op,)
        for s in subs:
            assert torch.is_tensor(s[2]) and s[2].dtype == torch.float64


def _perm_gates(rng, n):
    """CNOT ladders, Toffolis (controlled-controlled X) and SWAPs as
    dense SoA gates."""
    swap = np.eye(4)[[0, 2, 1, 3]]
    out = []
    for t in range(0, n - 1, 2):
        out.append(RC.Gate((t + 1, t), RC.controlled_dense(_soa(_X), 1)))
    for _ in range(4):
        a, b, c = (int(v) for v in rng.choice(n, 3, replace=False))
        out.append(RC.Gate((a, b, c), RC.controlled_dense(_soa(_X), 2)))
        out.append(RC.Gate((b, c), _soa(swap.astype(complex))))
    return out


@pytest.mark.parametrize("n", [8, 15])
def test_permutation_family_matches_reference(n):
    rng = np.random.default_rng(n)
    gates = _perm_gates(rng, n)
    for g in gates:
        assert C.classify_permutation_gate(g.mat) == \
            RC.classify_permutation_gate(g.mat)
    mine_gates = [C.Gate(g.targets, g.mat) for g in gates]
    assert C.compose_permutation_run(mine_gates) == \
        RC.compose_permutation_run(gates)
    ops = C.lower_permutation_run(mine_gates, n)
    assert ops == RC.lower_permutation_run(gates, n)
    x = rng.standard_normal((2, 1 << n))
    want = np.asarray(RC.execute_plan(jnp.asarray(x), ops, n))
    got = C.execute_plan(torch.from_numpy(x), ops, n)
    assert np.array_equal(got.numpy(), want)


def test_split_and_rebuild_plan_round_trip(monkeypatch):
    monkeypatch.setenv("QT_MEGAKERNEL", "on")
    n = _STREAMS["bench16"][0]
    plan = C.group_megawins(_port_plan("bench16"), n)
    skeleton, arrays = C.split_plan(plan)
    hash(skeleton)
    again = C.rebuild_plan(skeleton, arrays)
    assert C.split_plan(again)[0] == skeleton
    assert all(a is b for a, b in zip(C.split_plan(again)[1], arrays))


@pytest.mark.parametrize("op", [
    ("fused", np.zeros((1, 2, 256, 256)), np.zeros((1, 2, 256, 256))),
    ("swapfused", 14, 7, 1, None, None),
])
def test_unported_plan_ops_raise(op):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        C.execute_plan(torch.zeros((2, 1 << 14), dtype=torch.float64),
                       [op], 14)


def test_paged_planner_is_not_ported():
    """The port plans with the windowed planner only; the paged planner's
    cluster pass raises in the executor, naming its kernel."""
    with pytest.raises(TypeError):
        C.plan_circuit([], 14, planner="paged")
    op = ("fused", np.zeros((1, 2, 256, 256)), np.zeros((1, 2, 256, 256)))
    with pytest.raises(NotImplementedError, match="K11"):
        C.execute_plan(torch.zeros((2, 1 << 14), dtype=torch.float64),
                       [op], 14)


def test_segswap_runs_through_swap_bit_segments():
    rng = np.random.default_rng(4)
    n = 15
    x = rng.standard_normal((2, 1 << n))
    op = ("segswap", 10, 2, 3)
    want = np.asarray(RC.execute_plan(jnp.asarray(x), [op], n))
    got = C.execute_plan(torch.from_numpy(x), [op], n)
    assert np.array_equal(got.numpy(), want)
