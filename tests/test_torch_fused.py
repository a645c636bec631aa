"""quest_tpu_torch.ops.fused against quest_tpu.ops.fused.

The window pass (K1) and the window megakernel (K2) are CUDA kernels in the
port; here, on the CPU, their wrappers run the plain PyTorch versions, and
those are held against the JAX package's Pallas kernels run in interpret
mode.  Tolerance: 1e-10 absolute at float64 — both sides compute the same
sums of 128-term products, in a different summation order.  The megawin
route is pinned bit-identical (torch.equal) to its passes run one by one.
"""

import ctypes
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quest_tpu.ops import fused as ref_fused
from quest_tpu_torch import circuit as tc
from quest_tpu_torch.models import circuits as tcircuits
from quest_tpu_torch.ops import fused

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run: its
    spinning worker threads starve the other test processes (with 6 test
    processes on 8 cores, tests of 0.8 s took 40 s)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-10
N = 17          # the smallest register whose window offsets reach k = 10


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _pass(rng, k, rank, sides, with_mask):
    """("winfused", k, A, B, apply_a, apply_b, mask) as NumPy arrays:
    unitary sides scaled by 1/rank and a unit-modulus mask."""
    def stack():
        return np.stack([np.stack([u.real, u.imag]) / rank
                         for u in (_unitary(rng, 128) for _ in range(rank))])
    mask = None
    if with_mask:
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
        mask = np.stack([ph.real, ph.imag])
    return ("winfused", k, stack(), stack(), sides != "B", sides != "A", mask)


def _state(rng, n):
    x = rng.standard_normal((2, 1 << n))
    return x / np.sqrt((x ** 2).sum())


def _ref_pass(x, op, n):
    return np.asarray(ref_fused.apply_window_stack(
        jnp.asarray(x), jnp.asarray(op[2]), jnp.asarray(op[3]),
        None if op[6] is None else jnp.asarray(op[6]), num_qubits=n, k=op[1],
        apply_a=op[4], apply_b=op[5], interpret=True))


def _port_pass(x, op, n):
    return fused.apply_window_stack(
        torch.from_numpy(x), op[2], op[3], op[6], num_qubits=n, k=op[1],
        apply_a=op[4], apply_b=op[5]).numpy()


# every side variant x rank x mask at the lowest and highest window offset,
# and a spread of the three knobs at the offsets between
_K1_CASES = (
    [(k, s, r, m) for k in (7, N - 7)
     for s, r, m in itertools.product(("AB", "B", "A"), (1, 2, 4),
                                      (False, True))]
    + [(8, "AB", 2, True), (8, "B", 4, False), (8, "A", 1, True),
       (9, "AB", 4, False), (9, "B", 1, True), (9, "A", 2, False)])


@pytest.mark.parametrize("k,sides,rank,with_mask", _K1_CASES)
def test_window_pass_matches_reference(k, sides, rank, with_mask):
    rng = np.random.default_rng(1000 + 97 * k + 7 * rank + len(sides))
    x = _state(rng, N)
    op = _pass(rng, k, rank, sides, with_mask)
    want = _ref_pass(x, op, N)
    got = _port_pass(x, op, N)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_window_pass_takes_the_canonical_view():
    rng = np.random.default_rng(5)
    n = 15
    x = _state(rng, n)
    op = _pass(rng, 8, 2, "AB", True)
    flat = _port_pass(x, op, n)
    canon = fused.apply_window_stack(
        torch.from_numpy(x).reshape(2, 2, 128, 128), op[2], op[3], op[6],
        num_qubits=n, k=8, apply_a=True, apply_b=True)
    assert canon.shape == (2, 2, 128, 128)
    assert torch.equal(canon.reshape(2, -1), torch.from_numpy(flat))


_K2_GROUPS = [
    [(7, 1, "AB", True), (8, 2, "B", False), (9, 4, "A", True),
     (7, 1, "AB", False)],
    [(7, 1, "AB", False), (7, 4, "B", True), (7, 2, "A", False)],
]


@pytest.mark.parametrize("spec", _K2_GROUPS, ids=["kmax9", "kmax7"])
def test_megawin_matches_reference(spec):
    n = 16
    rng = np.random.default_rng(77 + len(spec))
    x = _state(rng, n)
    group = [_pass(rng, k, r, s, m) for k, r, s, m in spec]
    want = np.asarray(ref_fused.apply_window_megastack(
        jnp.asarray(x), group, num_qubits=n, interpret=True))
    got = fused.apply_window_megastack(torch.from_numpy(x), group,
                                       num_qubits=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the megawin route is bit-identical to its passes one by one
    per_pass = torch.from_numpy(x)
    for op in group:
        per_pass = fused.apply_window_stack(
            per_pass, op[2], op[3], op[6], num_qubits=n, k=op[1],
            apply_a=op[4], apply_b=op[5])
    assert torch.equal(got, per_pass)


def test_grouped_plan_bit_identical_to_per_pass(monkeypatch):
    """A bench plan with megawin groups runs bit-identically to the same
    plan with the groups flattened into single passes."""
    n, depth = 16, 4
    us = tcircuits.bench_unitaries(n, depth, seed=3, dtype=np.float64)
    gates = tcircuits.bench_gate_list(n, depth, us)
    monkeypatch.setenv("QT_MEGAKERNEL", "on")
    grouped = tc.plan_circuit(gates, n, device="cpu")
    assert tc.stats(grouped)["megawin"] > 0
    flat = [s for op in grouped
            for s in (op[1] if op[0] == "megawin" else (op,))]
    x0 = tcircuits.zero_state_canonical(n, torch.float64, "cpu")
    a = tc.execute_plan_chained(x0, tc.plan_to_device(grouped, torch.float64,
                                                      "cpu"), n)
    b = tc.execute_plan_chained(x0, tc.plan_to_device(flat, torch.float64,
                                                      "cpu"), n)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode,device,want", [
    ("off", "cuda", False), ("on", "cpu", True), ("auto", "cpu", False),
    ("auto", "cuda", True), ("auto", None, False)])
def test_megakernel_planning_policy(monkeypatch, mode, device, want):
    monkeypatch.setenv("QT_MEGAKERNEL", mode)
    assert fused.megakernel_planning(device) is want


def test_megawin_row_cap_fits_the_register():
    assert fused.megawin_row_cap(1, 14) == 1
    assert fused.megawin_row_cap(4, 16) == 4
    assert fused.megawin_row_cap(1, 26) == 8


@pytest.mark.parametrize("name", ["bf16_3x", "default"])
def test_lower_matmul_precisions_are_taken_and_read_back(name):
    """The reference's lower modes set the window kernels' split; the
    float64 path ignores them (tests/test_torch_precisions.py holds their
    arithmetic)."""
    try:
        fused.set_matmul_precision(name)
        assert fused.matmul_precision_name() == name
        assert fused.resolve_precision(None) == name
        assert fused.resolve_precision("highest") == "highest"
        assert fused.pass_split(torch.float64, name) == fused.SPLIT_EXACT
        assert fused.pass_split(torch.float32, name) == (
            fused.SPLIT_BF16X3 if name == "bf16_3x" else fused.SPLIT_TF32)
    finally:
        fused.set_matmul_precision("highest")


def test_pass_descriptor_layout():
    """The ctypes pass descriptor has the layout of csrc/window.cu's
    struct QtPass on a 64-bit host (three pointers after five ints: the
    fifth, ``split``, padded to 8 bytes)."""
    offsets = [getattr(fused._QtPass, f).offset
               for f, _ in fused._QtPass._fields_]
    assert offsets == [0, 4, 8, 12, 16, 24, 32, 40]
    assert ctypes.sizeof(fused._QtPass) == 48
    rng = np.random.default_rng(9)
    x = torch.zeros((2, 1 << 14), dtype=torch.float64)
    keep = []
    op = _pass(rng, 7, 2, "B", True)
    d = fused._pass_struct(op, x, keep)
    assert (d.k, d.rank, d.apply_a, d.apply_b, d.split) == (7, 2, 0, 1, 1)
    assert d.mask == keep[0].data_ptr() and d.a == keep[1].data_ptr()


@pytest.mark.parametrize("bad", [
    dict(k=6), dict(k=11), dict(num_qubits=13)])
def test_window_pass_rejects_bad_arguments(bad):
    rng = np.random.default_rng(2)
    op = _pass(rng, 7, 1, "AB", False)
    kw = dict(num_qubits=N, k=7, apply_a=True, apply_b=True)
    kw.update(bad)
    with pytest.raises(ValueError):
        fused.apply_window_stack(torch.zeros((2, 1 << N), dtype=torch.float64),
                                 op[2], op[3], None, **kw)
