"""The TF32 split of the window kernels' float32 products, on the CPU.

K1, K2, K11 and K12 multiply on the tensor cores in TF32: the operand that
carries the state is split into three TF32 parts (x = h + m + l), a side
matrix into two, and a pass whose sides are all TF32 values (QtPass.split
SPLIT_EXACT) takes the products h s + m s + l s, each exact.  ``ops/fused.py`` models
that arithmetic in plain PyTorch (``tf32_round``, ``tf32_split``,
``tf32_side_split``, ``window_pass_split``) and decides QtPass.split with
``tf32_exact``; the kernels run only on the card, so these tests hold the
model:

* the split: TF32 parts (low 13 bits zero) that sum back to x exactly, on
  random float32 states, on amplitudes at 30-qubit scale and on values at
  rounding ties, and ``tf32_round`` against round-half-away in float64;
* exact sides: the model equals ``window_pass_plain`` bit for bit
  (torch.equal) on every bit-reversal pass of the QFT at 16-20 qubits, on
  the identity of a mask-only pass and on random 0/1 permutation sides;
* other sides: random unitary sides at ranks 1 and 4 within 1e-5 max|psi|
  (chip_smoke.py's tolerance for K1) of the plain version;
* the classifier, and the descriptor and side images the wrapper builds
  from it.
"""

import numpy as np
import pytest
import torch

from quest_tpu_torch import circuit as C
from quest_tpu_torch.ops import fused

torch.set_num_threads(1)

LOW = 0x1FFF


def _bits(t):
    return t.contiguous().view(torch.int32)


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _stack(rng, rank):
    return np.stack([np.stack([u.real, u.imag]) / rank
                     for u in (_unitary(rng, 128) for _ in range(rank))])


def _perm_stack(rng):
    m = np.zeros((1, 2, 128, 128))
    m[0, 0, np.arange(128), rng.permutation(128)] = 1.0
    return m


def _state(rng, n, scale=1.0):
    x = rng.standard_normal((2, 1 << n))
    x *= scale / np.sqrt((x ** 2).sum())
    return torch.as_tensor(x, dtype=torch.float32)


def _ties(rng, count):
    """float32 values whose dropped 13 bits are exactly half a TF32 unit
    (and their neighbours), of both signs."""
    base = rng.integers(0x30000000, 0x40000000, count).astype(np.int64)
    base &= ~LOW
    vals = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001,
                           (base + 0x2000) | 0x1000])
    x = torch.as_tensor(vals.astype(np.int32)).view(torch.float32)
    return torch.cat([x, -x])


def _round_half_away(x):
    """The nearest value with 11 significant bits, ties away from zero,
    computed in float64 (an independent model of cvt.rna.tf32.f32)."""
    x = x.double()
    m, e = torch.frexp(x)                      # x = m 2^e, 0.5 <= |m| < 1
    scaled = m * 2048.0
    r = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    return torch.ldexp(r, e - 11)


_SPLIT_CASES = {
    "random": lambda rng: _state(rng, 16).reshape(-1),
    "30_qubit_scale": lambda rng: (
        torch.as_tensor(rng.standard_normal(1 << 16) * 2.0 ** -15,
                        dtype=torch.float32)),
    "ties": lambda rng: _ties(rng, 4096),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_parts_are_tf32_and_sum_back_exactly(case):
    rng = np.random.default_rng(11)
    x = _SPLIT_CASES[case](rng)
    h, m, l = fused.tf32_split(x)
    for part in (h, m, l):
        assert part.dtype == torch.float32
        assert not bool((_bits(part) & LOW).any())
    assert torch.equal((h + m) + l, x)
    # each part is the rounding of what the parts before it leave
    assert torch.equal(h.double(), _round_half_away(x))
    assert torch.equal(m.double(), _round_half_away(x - h))
    assert bool((l.abs() <= (x.abs() * 2.0 ** -21)).all())


def test_round_takes_ties_away_from_zero():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10                      # TF32's unit at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + 3 * ulp / 2,
                      1.0 + ulp / 2 - 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0 + 2 * ulp, 1.0],
                        dtype=torch.float32)
    assert torch.equal(fused.tf32_round(x), want)
    assert torch.equal(fused.tf32_round(one), one)


def _reversal_passes(n):
    """Every window pass of the QFT's bit reversal at n qubits, as the
    port's fused_qft plans it (its within-group reversals: 0/1 sides)."""
    ops = C.bit_reversal_ops(n, [(0, n)], np.float32)
    return [op if len(op) > 6 else (*op, None) for op in ops
            if op[0] == "winfused"]


def _model_equals_plain(x, op, n):
    kw = dict(num_qubits=n, k=op[1], apply_a=op[4], apply_b=op[5])
    got = fused.window_pass_split(x, op[2], op[3], op[6], **kw)
    want = fused.window_pass_plain(x, op[2], op[3], op[6], **kw)
    return torch.equal(got, want)


@pytest.mark.parametrize("n", [16, 18, 20])
def test_exact_sides_reversal_passes_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = _state(rng, n)
    passes = _reversal_passes(n)
    assert passes
    for op in passes:
        assert fused.tf32_exact(op[2]) and fused.tf32_exact(op[3])
        assert _model_equals_plain(x, op, n), op[1]


def test_exact_sides_identity_of_a_mask_only_pass():
    rng = np.random.default_rng(3)
    n = 16
    x = _state(rng, n)
    eye = np.zeros((1, 2, 128, 128))
    eye[0, 0] = np.eye(128)
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
    mask = np.stack([ph.real, ph.imag])
    assert fused.tf32_exact(eye)
    # the reference's route for the pass: A-only with the identity, then
    # the mask; the port's: the mask alone
    via_a = fused.window_pass_split(x, eye, eye, mask, num_qubits=n, k=9,
                                    apply_a=True, apply_b=False)
    mask_only = fused.window_pass_plain(x, eye, eye, mask, num_qubits=n, k=9,
                                        apply_a=False, apply_b=False)
    assert torch.equal(via_a, mask_only)
    for sides in ("AB", "A", "B"):
        op = ("winfused", 8, eye, eye, "A" in sides, "B" in sides, None)
        assert _model_equals_plain(x, op, n)


@pytest.mark.parametrize("sides", ["AB", "A", "B"])
def test_exact_sides_random_permutations_bit_for_bit(sides):
    rng = np.random.default_rng(len(sides) + 20)
    n = 17
    x = _state(rng, n)
    for k in (7, 10):
        op = ("winfused", k, _perm_stack(rng), _perm_stack(rng), "A" in sides,
              "B" in sides, None)
        assert _model_equals_plain(x, op, n)


@pytest.mark.parametrize("rank", [1, 4])
@pytest.mark.parametrize("sides", ["AB", "A", "B"])
def test_other_sides_within_tolerance(rank, sides):
    rng = np.random.default_rng(40 + rank + len(sides))
    n = 16
    x = _state(rng, n)
    a, b = _stack(rng, rank), _stack(rng, rank)
    assert not fused.tf32_exact(a) and not fused.tf32_exact(b)
    kw = dict(num_qubits=n, k=9, apply_a="A" in sides, apply_b="B" in sides)
    got = fused.window_pass_split(x, a, b, None, **kw)
    want = fused.window_pass_plain(x, a, b, None, **kw)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(x.abs().max())


def _hadamard_side():
    """A window side the planner folds from a Hadamard on qubit k + 2."""
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    gates = [C.Gate((12,), np.stack([h.real, h.imag]))]
    ops = C.plan_circuit_windowed(gates, 20)
    op = next(o for o in ops if o[0] == "winfused")
    return op[3] if op[5] else op[2]


def test_classifier():
    rng = np.random.default_rng(5)
    for op in _reversal_passes(20):
        assert fused.tf32_exact(op[2]) and fused.tf32_exact(op[3])
    eye = np.zeros((1, 2, 128, 128))
    eye[0, 0] = np.eye(128)
    assert fused.tf32_exact(eye)
    assert fused.tf32_exact(torch.as_tensor(eye))
    assert not fused.tf32_exact(_stack(rng, 1))
    assert not fused.tf32_exact(_stack(rng, 4))
    assert not fused.tf32_exact(_hadamard_side())


def test_wrapper_descriptor_and_side_images():
    """The descriptor carries the classifier's answer for the sides the
    pass uses, and each side goes to the kernel as its image: per plane
    and K tile of 32 columns, 8-row core matrices of 4-column rows, the
    TF32 split's four planes where the pass is not exact."""
    rng = np.random.default_rng(6)
    x = torch.zeros((2, 1 << 15), dtype=torch.float32)
    keep = []
    perm = ("winfused", 8, _perm_stack(rng), _perm_stack(rng), True, True,
            None)
    d = fused._pass_struct(perm, x, keep)
    assert d.split == 1
    img = keep[0]
    assert tuple(img.shape) == (1, 2, 4, 16, 8, 8, 4)
    src = torch.as_tensor(perm[2], dtype=torch.float32)
    for r, p, j, g, c, r0, e in [(0, 0, 0, 0, 0, 0, 0), (0, 1, 3, 15, 7, 7, 3),
                                 (0, 0, 2, 5, 1, 6, 2)]:
        assert img[r, p, j, g, c, r0, e] == src[r, p, 8 * g + r0,
                                                32 * j + 4 * c + e]
    dense = ("winfused", 8, _stack(rng, 2), _perm_stack(rng).repeat(2, 0),
             True, True, None)
    keep = []
    d = fused._pass_struct(dense, x, keep)
    assert d.split == 0 and d.rank == 2
    img = keep[0]
    assert tuple(img.shape) == (2, 4, 4, 16, 8, 8, 4)
    h, l = fused.tf32_side_split(torch.as_tensor(dense[2],
                                                 dtype=torch.float32))
    flat = img.permute(0, 1, 3, 5, 2, 4, 6).reshape(2, 4, 128, 128)
    assert torch.equal(flat[:, :2], h) and torch.equal(flat[:, 2:], l)
    # only the used sides count
    b_only = ("winfused", 8, _stack(rng, 1), _perm_stack(rng), False, True,
              None)
    assert fused._pass_struct(b_only, x, []).split == 1
    # float64 takes DMMA: no split, exact by definition; rows of 16
    # columns padded to 20
    keep = []
    assert fused._pass_struct(dense, x.double(), keep).split == 1
    img = keep[0]
    assert tuple(img.shape) == (2, 2, 8, 128, 20)
    src = torch.as_tensor(dense[2])
    assert torch.equal(img[..., :16].permute(0, 1, 3, 2, 4).reshape(
        2, 2, 128, 128), src)
    assert not bool(img[..., 16:].any())


def test_plan_upload_tags_exactness():
    rng = np.random.default_rng(7)
    ops = [("winfused", 8, _perm_stack(rng), _stack(rng, 1), True, True,
            None)]
    dev = C.plan_to_device(ops, torch.float32, "cpu")
    assert dev[0][2]._qt_tf32_exact[1] is True
    assert dev[0][3]._qt_tf32_exact[1] is False
    assert fused.pass_split(torch.float32, "highest", dev[0][2]) == 1
    assert fused.pass_split(torch.float32, "highest", dev[0][2],
                            dev[0][3]) == 0
    assert fused.pass_split(torch.float64, "highest", dev[0][3]) == 1
