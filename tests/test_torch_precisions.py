"""The reference's lower matmul precisions in quest_tpu_torch's window
kernels (K1, K2, K11, K12), on the CPU.

``set_matmul_precision`` chooses how a float32 window pass's real products
split into tensor-core products: "highest" (float32 accuracy), "bf16_3x"
(the reference's three bf16 products x_h m_h + x_h m_l + x_l m_h,
quest_tpu/ops/fused.py ``_kdot``) and "default" (one TF32 product, as
JAX's Precision.DEFAULT runs on an NVIDIA card).  On the CPU the entries
run the mode's plain model (``fused.window_pass_split``), which computes
the kernels' products exactly; these tests hold it:

* "bf16_3x" against the reference's K1, K2, K11 and K12 under "bf16_3x"
  (interpret mode) at 16 qubits, float32, and config 2's plan at 14
  qubits through ``execute_plan(..., precision="bf16_3x")`` in both
  packages.  The bf16 products are the same exact products in both; the
  float32 sums run in another order, and a dual pass splits its float32
  intermediate again, where a value that lies next to a rounding step of
  the split may round the other way in the other package (one low part's
  unit, 2^-16 relative): TOL_BF16 = 4e-6 max|psi| per pass (measured
  1.5e-6 on rank-1 dual passes, 2e-7 on one-sided ones).
* "default" against the reference's "highest" (full float32 on the CPU)
  within TOL_TF32 = 2e-3 max|psi| per pass: each product rounds both
  operands to TF32 (2^-11 relative each; measured 4e-4 on rank-1 passes).
* Float64 under every mode equals "highest" bit for bit (one DMMA
  product on the card; the plain version on the CPU).
* The surface: the three names, the reference's ValueError, the mode read
  at call time, the descriptor's split and the side images per mode, and
  a mode flip between two identical drains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import circuit as RC
from quest_tpu.ops import fused as ref_fused
from quest_tpu_torch import circuit as C
from quest_tpu_torch import fusion
from quest_tpu_torch.models import circuits as TM
from quest_tpu_torch.ops import fused

torch.set_num_threads(1)

N = 16
TOL_BF16 = 4e-6
TOL_TF32 = 2e-3
MODES = ("highest", "bf16_3x", "default")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def _restore_highest():
    """Every test leaves both packages at "highest"."""
    yield
    fused.set_matmul_precision("highest")
    ref_fused.set_matmul_precision("highest")


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _stack(rng, rank):
    return np.stack([np.stack([u.real, u.imag]) / rank
                     for u in (_unitary(rng, 128) for _ in range(rank))]
                    ).astype(np.float32)


def _mask(rng):
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
    return np.stack([ph.real, ph.imag]).astype(np.float32)


def _pass(rng, k, rank, sides, with_mask):
    return ("winfused", k, _stack(rng, rank), _stack(rng, rank),
            "A" in sides, "B" in sides, _mask(rng) if with_mask else None)


def _state(rng, n, dt=np.float32):
    x = rng.standard_normal((2, 1 << n))
    return (x / np.sqrt((x ** 2).sum())).astype(dt)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ref_pass(x, op, n, precision):
    return np.asarray(ref_fused.apply_window_stack(
        jnp.asarray(x), jnp.asarray(op[2]), jnp.asarray(op[3]), _j(op[6]),
        num_qubits=n, k=op[1], apply_a=op[4], apply_b=op[5],
        interpret=True, precision=precision))


def _port_pass(x, op, n, precision):
    return fused.apply_window_stack(
        torch.from_numpy(x), op[2], op[3], op[6], num_qubits=n, k=op[1],
        apply_a=op[4], apply_b=op[5], precision=precision).numpy()


# ---------------------------------------------------------------------------
# K1 and its plain models against the reference
# ---------------------------------------------------------------------------

K1_CASES = [(7, 1, "AB", False), (9, 1, "AB", True), (N - 7, 4, "AB", True),
            (8, 2, "B", True), (N - 7, 1, "A", False), (7, 4, "A", True)]


@pytest.mark.parametrize("k,rank,sides,mask", K1_CASES)
def test_bf16_3x_matches_the_reference_k1(k, rank, sides, mask):
    rng = np.random.default_rng(100 + k * 7 + rank)
    x = _state(rng, N)
    op = _pass(rng, k, rank, sides, mask)
    want = _ref_pass(x, op, N, "bf16_3x")
    got = _port_pass(x, op, N, "bf16_3x")
    scale = np.abs(x).max()
    assert np.abs(got - want).max() <= TOL_BF16 * scale
    # the mode's products, not float32's: the model is not the plain pass
    plain = _port_pass(x, op, N, "highest")
    assert np.abs(got - plain).max() > 0.0


@pytest.mark.parametrize("k,rank,sides,mask", K1_CASES[:4])
def test_default_is_within_tf32_of_the_reference_highest(k, rank, sides,
                                                         mask):
    rng = np.random.default_rng(200 + k * 7 + rank)
    x = _state(rng, N)
    op = _pass(rng, k, rank, sides, mask)
    want = _ref_pass(x, op, N, "highest")
    got = _port_pass(x, op, N, "default")
    err = np.abs(got - want).max() / np.abs(x).max()
    assert err <= TOL_TF32
    # and coarser than bf16_3x: one TF32 product, not float32 accuracy
    assert err > TOL_BF16


def test_bf16_split_rounds_to_nearest_even():
    # 1 + 2^-8 lies half way between the bf16 values 1 and 1 + 2^-7: ties
    # go to the even one (1), as JAX's cast does
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)],
                     dtype=torch.float32)
    h, lo = fused.bf16_split(x)
    assert h.tolist() == [1.0, 1 + 2 ** -6, -1.0]
    assert torch.equal(h + lo, x)
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert np.array_equal(h.numpy(), want)
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    h, lo = fused.bf16_split(y)
    jh = jnp.asarray(y.numpy()).astype(jnp.bfloat16).astype(jnp.float32)
    jl = (jnp.asarray(y.numpy()) - jh).astype(jnp.bfloat16).astype(
        jnp.float32)
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert np.array_equal(lo.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# K2, K11 and K12 against the reference under "bf16_3x"
# ---------------------------------------------------------------------------


def test_bf16_3x_megawin_group_matches_the_reference():
    """Config 2's group C shape (five passes, up to k = 10) at 17 qubits:
    within 5 TOL_BF16 of the reference's megakernel, bit for bit its
    passes through K1's entry."""
    n = 17
    rng = np.random.default_rng(31)
    group = [_pass(rng, k, r, s, m) for k, r, s, m in
             [(7, 1, "B", True), (7, 1, "AB", True), (7, 1, "AB", True),
              (7, 1, "AB", False), (10, 1, "B", False)]]
    x = _state(rng, n)
    want = np.asarray(ref_fused.apply_window_megastack(
        jnp.asarray(x), tuple((op[0], op[1], jnp.asarray(op[2]),
                               jnp.asarray(op[3]), op[4], op[5], _j(op[6]))
                              for op in group),
        num_qubits=n, interpret=True, precision="bf16_3x"))
    xt = torch.from_numpy(x)
    got = fused.apply_window_megastack(xt, group, num_qubits=n,
                                       precision="bf16_3x")
    assert np.abs(got.numpy() - want).max() <= 5 * TOL_BF16 * np.abs(x).max()
    assert torch.equal(got, C.execute_plan(xt, group, n, precision="bf16_3x"))


@pytest.mark.parametrize("rank", [1, 4])
def test_bf16_3x_cluster_passes_match_the_reference(rank):
    rng = np.random.default_rng(40 + rank)
    x = _state(rng, N)
    a, b = _stack(rng, rank), _stack(rng, rank)
    scale = np.abs(x).max()
    want = np.asarray(ref_fused.apply_cluster_stack(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), num_qubits=N,
        interpret=True, precision="bf16_3x"))
    got = fused.apply_cluster_stack(torch.from_numpy(x), a, b, num_qubits=N,
                                    precision="bf16_3x")
    assert np.abs(got.numpy() - want).max() <= TOL_BF16 * scale
    want = np.asarray(ref_fused.apply_swap_cluster_stack(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), num_qubits=N, h=14,
        b=9, m=2, interpret=True, precision="bf16_3x"))
    got = fused.apply_swap_cluster_stack(torch.from_numpy(x), a, b,
                                         num_qubits=N, h=14, b=9, m=2,
                                         precision="bf16_3x")
    assert np.abs(got.numpy() - want).max() <= TOL_BF16 * scale


# ---------------------------------------------------------------------------
# The whole slice: config 2's plan at 14 qubits
# ---------------------------------------------------------------------------

N_PLAN, DEPTH = 14, 20


def _config2():
    us = TM.bench_unitaries(N_PLAN, DEPTH, seed=7)
    gates = TM.bench_gate_list(N_PLAN, DEPTH, us)
    plan = C.plan_circuit(gates, N_PLAN)
    ref_plan = RC.plan_circuit([RC.Gate(g.targets, g.mat) for g in gates],
                               N_PLAN, use_native=False)
    x0 = np.zeros((2, 1 << N_PLAN), dtype=np.float32)
    x0[0, 0] = 1.0
    return plan, ref_plan, x0


def _passes(plan):
    return sum(1 for op in plan if op[0] == "winfused")


@pytest.mark.parametrize("mode", ["bf16_3x", "default"])
def test_config2_plan_matches_the_reference(mode):
    """Port: ``execute_plan(..., precision=mode)``; reference:
    ``execute_plan(..., precision="bf16_3x")`` for "bf16_3x" and
    "highest" for "default" (the reference's CPU runs DEFAULT in full
    float32), within the mode's tolerance per window pass."""
    plan, ref_plan, x0 = _config2()
    want = np.asarray(RC.execute_plan(
        jnp.asarray(x0), ref_plan, N_PLAN, interpret=True,
        precision="bf16_3x" if mode == "bf16_3x" else "highest"))
    got = C.execute_plan(torch.from_numpy(x0),
                         C.plan_to_device(plan, torch.float32, "cpu"),
                         N_PLAN, precision=mode).numpy()
    tol = {"bf16_3x": TOL_BF16, "default": TOL_TF32}[mode]
    assert _passes(plan) > 0
    assert np.abs(got - want).max() <= _passes(plan) * tol * np.abs(
        want).max()
    if mode == "bf16_3x":
        highest = C.execute_plan(torch.from_numpy(x0), plan, N_PLAN,
                                 precision="highest").numpy()
        assert not np.array_equal(got, highest)


# ---------------------------------------------------------------------------
# Float64: every mode is "highest"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16_3x", "default"])
def test_float64_is_the_same_in_every_mode(mode):
    rng = np.random.default_rng(55)
    n = 15
    x = torch.from_numpy(_state(rng, n, np.float64))
    op = _pass(rng, 8, 2, "AB", True)
    op = op[:2] + tuple(None if t is None else t.astype(np.float64)
                        for t in op[2:4]) + op[4:6] + (op[6].astype(
                            np.float64),)
    kw = dict(num_qubits=n, k=8, apply_a=True, apply_b=True)

    def runs(prec):
        return (fused.apply_window_stack(x, op[2], op[3], op[6],
                                         precision=prec, **kw),
                fused.apply_window_megastack(x, [op, op], num_qubits=n,
                                             precision=prec),
                fused.apply_cluster_stack(x, op[2], op[3], num_qubits=n,
                                          precision=prec),
                fused.apply_swap_cluster_stack(x, op[2], op[3], num_qubits=n,
                                               h=14, b=8, m=1,
                                               precision=prec))
    for got, want in zip(runs(mode), runs("highest")):
        assert torch.equal(got, want)
    ops = [op]
    assert torch.equal(C.execute_plan(x, ops, n, precision=mode),
                       C.execute_plan(x, ops, n, precision="highest"))


# ---------------------------------------------------------------------------
# The surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODES)
def test_set_matmul_precision_takes_the_reference_names(name):
    fused.set_matmul_precision(name)
    assert fused.matmul_precision_name() == name
    ref_fused.set_matmul_precision(name)
    assert ref_fused.matmul_precision_name() == name


@pytest.mark.parametrize("name", ["bf16", "HIGHEST", "tf32", ""])
def test_unknown_precision_raises_the_reference_error(name):
    with pytest.raises(ValueError) as want:
        ref_fused.set_matmul_precision(name)
    with pytest.raises(ValueError) as got:
        fused.set_matmul_precision(name)
    assert str(got.value) == str(want.value)
    assert fused.matmul_precision_name() == "highest"
    with pytest.raises(ValueError):
        fused.apply_window_stack(torch.zeros((2, 1 << 14)), _stack(
            np.random.default_rng(0), 1), _stack(np.random.default_rng(1), 1),
            num_qubits=14, precision=name or "none")


def test_none_reads_the_mode_at_call_time():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_state(rng, 15))
    op = _pass(rng, 8, 1, "AB", False)
    kw = dict(num_qubits=15, k=8)
    for mode in MODES:
        fused.set_matmul_precision(mode)
        assert torch.equal(
            fused.apply_window_stack(x, op[2], op[3], **kw),
            fused.apply_window_stack(x, op[2], op[3], precision=mode, **kw))


def test_descriptor_split_and_side_images_per_mode():
    """QtPass.split follows the mode (float64: one DMMA product in every
    mode), and each mode's side image is cached beside the others: a
    bf16 image holds (re_h, im_h, re_l, im_l) in bf16, K tiles of 32
    columns in 8-row core matrices of 8-value rows."""
    rng = np.random.default_rng(9)
    x = torch.zeros((2, 1 << 15), dtype=torch.float32)
    perm = np.zeros((1, 2, 128, 128), dtype=np.float32)
    perm[0, 0, np.arange(128), rng.permutation(128)] = 1.0
    dense = ("winfused", 8, _stack(rng, 2), _stack(rng, 2), True, True, None)
    exact = ("winfused", 8, perm, perm.copy(), True, True, None)
    want = {"highest": (fused.SPLIT_TF32X3, fused.SPLIT_EXACT),
            "default": (fused.SPLIT_TF32, fused.SPLIT_TF32),
            "bf16_3x": (fused.SPLIT_BF16X3, fused.SPLIT_BF16X3)}
    for mode, (d_split, e_split) in want.items():
        assert fused._pass_struct(dense, x, [], mode).split == d_split
        assert fused._pass_struct(exact, x, [], mode).split == e_split
        assert fused._pass_struct(dense, x.double(), [], mode).split == \
            fused.SPLIT_EXACT
    side = torch.as_tensor(dense[2])
    imgs = {s: fused._side_image(side, torch.float32, "cpu", s)
            for s in (fused.SPLIT_TF32X3, fused.SPLIT_TF32,
                      fused.SPLIT_BF16X3)}
    for s, img in imgs.items():
        assert fused._side_image(side, torch.float32, "cpu", s) is img
    bf = imgs[fused.SPLIT_BF16X3]
    assert bf.dtype == torch.bfloat16
    assert tuple(bf.shape) == (2, 4, 4, 16, 4, 8, 8)
    h, lo = fused.bf16_split(side)
    flat = bf.permute(0, 1, 3, 5, 2, 4, 6).reshape(2, 4, 128, 128).float()
    assert torch.equal(flat[:, :2], h) and torch.equal(flat[:, 2:], lo)
    tf = imgs[fused.SPLIT_TF32]
    assert tuple(tf.shape) == (2, 2, 4, 16, 8, 8, 4)
    flat = tf.permute(0, 1, 3, 5, 2, 4, 6).reshape(2, 2, 128, 128)
    assert torch.equal(flat, fused.tf32_round(side))
    # a changed tensor makes its images anew
    side.mul_(2)
    assert fused._side_image(side, torch.float32, "cpu",
                             fused.SPLIT_BF16X3) is not bf


def _drain(n, us):
    q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
    with tq.gateFusion(q):
        for d in range(us.shape[0]):
            for t in range(n):
                tq.unitary(q, t, us[d, t, 0] + 1j * us[d, t, 1])
            for t in range(d % 2, n - 1, 2):
                tq.controlledNot(q, t, t + 1)
        items = list(q._fusion.gates)
    return q.amps.clone(), items


def test_flipping_the_mode_between_drains_runs_the_new_mode():
    """Two identical drains, the mode flipped between them: the second
    runs at the new mode (its program is planned under the mode's key),
    equal to that program executed at that mode, not a replay of the
    first."""
    n = 15
    old = tq.get_precision()
    tq.set_precision(1)
    try:
        us = TM.bench_unitaries(n, 3, seed=5, dtype=np.float64)
        first, items = _drain(n, us)
        key_hi = fusion._plan_key(items, n, False, "cpu")
        fused.set_matmul_precision("bf16_3x")
        second, _ = _drain(n, us)
        assert fusion._plan_key(items, n, False, "cpu") != key_hi
        program = fusion.plan_items(items, n, device="cpu")
        x0 = torch.zeros((2, 1 << n), dtype=torch.float32)
        x0[0, 0] = 1.0
        want = fusion.execute_program(x0, program, (), n)
        assert fusion.program_stats(program).get("winfused", 0) > 0
        assert torch.equal(second, want)
        assert not torch.equal(first, second)
        fused.set_matmul_precision("highest")
        third, _ = _drain(n, us)
        assert torch.equal(third, first)
    finally:
        tq.set_precision(old)


def test_reference_registers_untouched_by_the_port_mode():
    """The two packages keep their own mode."""
    fused.set_matmul_precision("default")
    assert ref_fused.matmul_precision_name() == "highest"
    env = qt.createQuESTEnv(num_devices=1)
    q = qt.createQureg(2, env)
    qt.hadamard(q, 0)
    assert abs(qt.calcTotalProb(q) - 1.0) < 1e-12
