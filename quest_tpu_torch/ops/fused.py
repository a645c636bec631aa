"""Fused window passes: many gates, one pass over the state.

The circuit planner (circuit.py) folds a whole run of gates into
``("winfused", k, A, B, apply_a, apply_b, mask)`` passes: the rank-R
operator ``[mask (.)] sum_r B_r (x) A_r`` with A_r on the lane qubits
[0, 7) and B_r on the window qubits [k, k+7), 7 <= k <= n-7.  Runs of such
passes whose windows fit inside 2^g consecutive canonical 128 x 128 rows
(k <= 7 + g) are grouped into ``("megawin", (passes...))`` ops.

Two hand-written CUDA kernels (``csrc/window.cu``) execute them on the
card, built with nvcc at first use (``ops/build.py``) and bound through
ctypes.  Their products run on the tensor cores: float32 as split
products chosen by the user's precision mode (``set_matmul_precision``:
"highest" TF32 splits to float32 accuracy, the reference's "bf16_3x" and
"default"; ``window_pass_split`` below models each), float64 as DMMA.

* K1, ``apply_window_stack``: one pass (replaces the Pallas kernel
  quest_tpu/ops/fused.py ``_apply_window_stack_jit``);
* K2, ``apply_window_megastack``: a megawin group in one launch, a
  persistent grid of one CTA per SM that takes (super-block, pass, item)
  tickets from a counter and waits on per-super-block done-counters
  instead of barriers (``megawin_schedule``; replaces
  ``_apply_megawin_jit``), bit-identical to its passes run one by one
  through K1.

The paged planner (``circuit.plan_circuit(..., planner="paged")``) pins
the window to [7, 14) and emits ``("fused", As, Bs)`` and ``("swapfused",
h, b, m, As, Bs)`` passes, run by two more entries of ``csrc/window.cu``:

* K11, ``apply_cluster_stack`` (and ``apply_cluster_pair``): K1's kernel
  at k = 7, dual-sided, unmasked (replaces ``_apply_cluster_stack_jit``);
* K12, ``apply_swap_cluster_stack``: the segment swap [h, h+m) <->
  [b, b+m) and the same operator in one pass, the swap a gather on the
  kernel's row loads (replaces ``_apply_swap_cluster_stack_jit``),
  bit-identical to ``kernels.swap_bit_segments`` followed by K11.

The QFT's ladder layers (Hadamard on the layer's target plus its whole
controlled-phase ladder) run in two more kernels (``csrc/qft.cu``), under
four entries:

* K6 and K7, ``apply_qft_ladder_pallas``: one layer, t >= 14 (replaces
  ``_qft_ladder_jit``) or 7 <= t <= 13 (replaces ``_qft_ladder_lo_jit``);
* K8, ``apply_qft_multi_hi``: up to five consecutive layers, all >= 14, in
  one pass (replaces ``_qft_multi_hi_jit``);
* K9, ``apply_qft_cluster_multi``: the seven layers 13..7 in one pass
  (replaces ``_qft_cluster_multi_jit``).

K6 is a launch of K8's kernel with one layer and K7 one of K9's with one
layer: they compute the same products from tables of the same layout.

A run of depolarise / damping channels on a density register runs in the
fifth kernel (``csrc/channels.cu``): K5, ``apply_pair_channel_sweep``,
chunked into sweeps as the reference chunks them (replaces
``_chan_sweep_pass``), each sweep one launch per orbit group of at most
rank 4, in place.

Beside each sits its plain PyTorch version (``window_pass_plain``,
``megawin_plain``, ``cluster_stack_plain``, ``swap_cluster_stack_plain``,
``qft_ladder_plain``, ``qft_ladder_lo_plain``,
``qft_multi_hi_plain``, ``qft_cluster_multi_plain``,
``pair_channel_sweep_plain``): the wrappers run it
for a tensor on the CPU, and launch the kernel or raise for a tensor on
the card.  Each wrapper counts its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import os
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from . import build, cplx

LANE_QUBITS = 7          # qubits 0..6  -> lanes (128)
SUBLANE_QUBITS = 7       # the window's width
CLUSTER_QUBITS = LANE_QUBITS + SUBLANE_QUBITS   # 14
CLUSTER_DIM = 128

# Largest megawin group the K2 kernel takes (its parameter block holds the
# passes by value; csrc/window.cu MAX_MEGA_PASSES).
MAX_MEGA_PASSES = 16

# Widest segment swap the paged planner fuses into a cluster pass.  The
# value is the reference's TPU VMEM limit (a 2^m-slab super-block in 16 MB
# of scoped VMEM; m = 4 overflowed there); K12 gathers across the swap and
# would take any m, but the planner's peephole reads this number and the
# port's paged plans must equal the reference's.
MAX_FUSED_SWAP_M = 3

# ---------------------------------------------------------------------------
# Matmul precision
# ---------------------------------------------------------------------------


# The window kernels' float32 products (K1, K2, K11, K12), chosen by the
# user as in the reference (quest_tpu/ops/fused.py _PRECISIONS, _kdot):
# "highest" keeps float32 accuracy (the TF32 split below), "bf16_3x" takes
# the reference's three bf16 products xh mh + xh ml + xl mh (about 2^-16
# relative each; the xl ml term dropped), "default" one TF32 product (as
# JAX's Precision.DEFAULT runs on an NVIDIA card, about 2^-11).  Float64
# runs the same DMMA products under every mode.  The QFT, Pauli and
# channel kernels ignore the mode, as the reference's do.
PRECISIONS = ("highest", "bf16_3x", "default")
_CONFIG = {"precision": "highest"}

# QtPass.split (csrc/window.cu): how a float32 pass's real products split
# into tensor-core products.
SPLIT_TF32X3 = 0    # "highest", sides not TF32 values: 3xTF32
SPLIT_EXACT = 1     # "highest", every side entry a TF32 value; float64
SPLIT_TF32 = 2      # "default": one TF32 product
SPLIT_BF16X3 = 3    # "bf16_3x": three bf16 products


def _known(name: str) -> str:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; use one of "
                         f"{list(PRECISIONS)}")
    return name


def set_matmul_precision(name: str) -> None:
    """Set the window kernels' contraction precision ("highest" |
    "bf16_3x" | "default"); entries called with ``precision=None`` read it
    at call time, and the drain's plan cache keys on it."""
    _CONFIG["precision"] = _known(name)


def matmul_precision_name() -> str:
    return _CONFIG["precision"]


def resolve_precision(precision=None) -> str:
    """``precision``, or the current mode where it is None."""
    return _known(precision or _CONFIG["precision"])


# ---------------------------------------------------------------------------
# Megakernel grouping policy
# ---------------------------------------------------------------------------


def megakernel_mode() -> str:
    """QT_MEGAKERNEL knob: "off" (never group), "on" (always group; on the
    CPU the plain version runs the groups) or "auto" (default: group when
    a CUDA device backs the register)."""
    raw = os.environ.get("QT_MEGAKERNEL", "auto").strip().lower()
    if raw in ("off", "0", "false", "no"):
        return "off"
    if raw in ("on", "1", "true", "yes"):
        return "on"
    return "auto"


def megakernel_planning(device=None) -> bool:
    """Whether the planner should form megawin groups for a register on
    ``device``.  "auto" groups only on a CUDA device, which keeps CPU
    plans identical to the JAX package's CPU plans."""
    mode = megakernel_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return device is not None and torch.device(device).type == "cuda"


def megawin_row_cap(rank: int, num_qubits: int) -> int:
    """Largest super-block (canonical rows G) a megawin group may span.
    K2 keeps a super-block's intermediate passes in its place in the
    output and in a scratch slot, served by L2 where they fit; its
    tickets run pass by pass over windows of super-blocks whose items at
    G = 8 already outnumber the card's CTAs (``megawin_schedule``), so a
    larger G would only widen the window's working set.  The rank does
    not change the kernel's working set (shared memory per CTA is
    rank-independent)."""
    del rank
    return min(8, 1 << max(0, num_qubits - CLUSTER_QUBITS))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


@contextmanager
def _full_fp32():
    """Matrix products in true float32 (no TF32) for the length of the
    block, whatever the caller set: the plain versions are the reference
    the kernels are held against."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def window_pass_plain(amps, mats_a, mats_b, mask=None, *, num_qubits: int,
                      k: int = SUBLANE_QUBITS, apply_a: bool = True,
                      apply_b: bool = True):
    """The window pass in plain PyTorch: the state viewed as (hi, 128 w,
    mid, 128 l) complex, Y = [mask (.)] sum_r B_r X A_r^T per (hi, mid)
    slab (B-only / A-only drop a side, mask-only drops both).  Same
    function as K1."""
    n = num_qubits
    _check_offset(n, k)
    hi = 1 << (n - k - SUBLANE_QUBITS)
    mid = 1 << (k - LANE_QUBITS)
    x = cplx.to_complex(amps.reshape(2, hi, CLUSTER_DIM, mid, CLUSTER_DIM))
    a = cplx.to_complex(_as_operand(mats_a, amps).transpose(0, 1))
    b = cplx.to_complex(_as_operand(mats_b, amps).transpose(0, 1))
    with _full_fp32():
        if apply_a and apply_b:
            t = torch.einsum("hwml,rpl->rhwmp", x, a)
            y = torch.einsum("rqw,rhwmp->hqmp", b, t)
        elif apply_b:
            y = torch.einsum("rqw,hwml->hqml", b, x)
        elif apply_a:
            y = torch.einsum("hwml,rpl->hwmp", x, a)
        else:
            # mask-only: a pass that folded only cross diagonals
            y = x
    if mask is not None:
        m = cplx.to_complex(_as_operand(mask, amps))
        y = y * m[None, :, None, :]
    return cplx.from_complex(y).reshape(amps.shape)


def _check_cluster(n: int, mats_a, mats_b, what: str) -> None:
    """The register size and side-stack shapes the cluster entries take."""
    if n < CLUSTER_QUBITS:
        raise ValueError(f"{what} needs >= {CLUSTER_QUBITS} qubits")
    sa, sb = tuple(np.shape(mats_a)), tuple(np.shape(mats_b))
    if (len(sa) != 4 or sa[1:] != (2, CLUSTER_DIM, CLUSTER_DIM)
            or sb != sa or sa[0] < 1):
        raise ValueError(f"{what}: side stacks must be (R, 2, 128, 128), "
                         f"got {sa} and {sb}")


def _check_swap(n: int, h: int, b: int, m: int) -> None:
    if not (1 <= m <= MAX_FUSED_SWAP_M and h >= CLUSTER_QUBITS
            and h + m <= n and b >= LANE_QUBITS
            and b + m <= CLUSTER_QUBITS):
        raise ValueError(
            f"apply_swap_cluster_stack needs h >= {CLUSTER_QUBITS}, "
            f"h + m <= n, {LANE_QUBITS} <= b, b + m <= {CLUSTER_QUBITS} and "
            f"1 <= m <= {MAX_FUSED_SWAP_M}; got h={h}, b={b}, m={m}, n={n}")


def window_pass_model(amps, mats_a, mats_b, mask=None, *, num_qubits: int,
                      k: int = SUBLANE_QUBITS, apply_a: bool = True,
                      apply_b: bool = True, precision: str = "highest"):
    """The window pass as the kernels compute it under ``precision``: a
    float32 state under "bf16_3x" or "default" takes that mode's products
    (``window_pass_split``), anything else ``window_pass_plain``."""
    if amps.dtype == torch.float32 and precision != "highest":
        return window_pass_split(amps, mats_a, mats_b, mask,
                                 num_qubits=num_qubits, k=k, apply_a=apply_a,
                                 apply_b=apply_b, precision=precision)
    return window_pass_plain(amps, mats_a, mats_b, mask,
                             num_qubits=num_qubits, k=k, apply_a=apply_a,
                             apply_b=apply_b)


def cluster_stack_plain(amps, mats_a, mats_b, *, num_qubits: int,
                        precision: str = "highest"):
    """The cluster pass in plain PyTorch: ``window_pass_model`` at k = 7,
    dual-sided, with no mask.  Same function as K11."""
    _check_cluster(num_qubits, mats_a, mats_b, "apply_cluster_stack")
    return window_pass_model(amps, mats_a, mats_b, None,
                             num_qubits=num_qubits, k=SUBLANE_QUBITS,
                             precision=precision)


def swap_cluster_stack_plain(amps, mats_a, mats_b, *, num_qubits: int,
                             h: int, b: int, m: int,
                             precision: str = "highest"):
    """The fused swap + cluster pass in plain PyTorch: the segment swap
    [h, h+m) <-> [b, b+m) (``kernels.swap_bit_segments``), then
    ``cluster_stack_plain``.  Same function as K12."""
    from . import kernels

    _check_cluster(num_qubits, mats_a, mats_b, "apply_swap_cluster_stack")
    _check_swap(num_qubits, h, b, m)
    swapped = kernels.swap_bit_segments(amps, num_qubits=num_qubits, a=h,
                                        b=b, m=m)
    return cluster_stack_plain(swapped, mats_a, mats_b,
                               num_qubits=num_qubits, precision=precision)


def megawin_plain(amps, subops, *, num_qubits: int,
                  precision: str = "highest"):
    """A megawin group in plain PyTorch: its passes one after another
    over the whole state (the same function K2 computes super-block by
    super-block)."""
    for op in subops:
        amps = window_pass_model(
            amps, op[2], op[3], op[6] if len(op) > 6 else None,
            num_qubits=num_qubits, k=op[1], apply_a=op[4], apply_b=op[5],
            precision=precision)
    return amps


# ---------------------------------------------------------------------------
# The split of the window kernels' float32 products
# ---------------------------------------------------------------------------
#
# K1, K2, K11 and K12 multiply float32 operands on the tensor cores, each
# real product split as the precision mode asks (QtPass.split):
#
# * "highest" (SPLIT_TF32X3, SPLIT_EXACT): TF32 (1 + 10 mantissa bits)
#   parts, so that the result keeps float32 accuracy: the operand that
#   carries the state into three TF32 parts (x = h + m + l, exactly), a
#   side matrix into two.  Where every entry of a pass's used sides is a
#   TF32 value (SPLIT_EXACT) a real product is h s + m s + l s, each term
#   exact; otherwise the 3xTF32 product h s_h + h s_l + m s_h.
# * "default" (SPLIT_TF32): one TF32 product, tf32(x) tf32(s).
# * "bf16_3x" (SPLIT_BF16X3): the reference's three bf16 products
#   x_h s_h + x_h s_l + x_l s_h, each operand split into bf16 parts
#   rounded to nearest even (x_h = bf16(x), x_l = bf16(x - x_h)), whatever
#   the sides hold.
#
# In every mode the pass's intermediate T = X A^T stays float32 and is
# split again for the second product.  The functions below model that
# arithmetic in plain PyTorch; the wrappers choose QtPass.split with
# ``pass_split``.

_TF32_LOW = 0x1FFF          # the 13 float32 mantissa bits TF32 drops


def tf32_round(x):
    """``cvt.rna.tf32.f32`` as the kernels use it, on a float32 tensor:
    the nearest TF32 value, ties away from zero, its low 13 bits clear.
    On the int32 view, adding half of the dropped unit to the magnitude
    bits and clearing them rounds the magnitude half away from zero
    (finite inputs)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~_TF32_LOW).view(torch.float32)


def tf32_split(x):
    """The kernels' split of a float32 state operand: (h, m, l) with
    h + m + l == x exactly, each a TF32 value (h and m of 11 significant
    bits, l of at most 2, while l stays a normal float: |x| >= 2^-102)."""
    h = tf32_round(x)
    r = x - h
    m = tf32_round(r)
    return h, m, r - m


def tf32_side_split(m):
    """The kernels' split of a side matrix that is not exact in TF32:
    (m_h, m_l), m_l the TF32 value nearest the residual."""
    h = tf32_round(m)
    return h, tf32_round(m - h)


def bf16_round(x):
    """``cvt.rn.bf16.f32`` on a float32 tensor, as a float32 tensor: the
    nearest bf16 value, ties to even (JAX's and PyTorch's cast)."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_split(x):
    """The reference's split of a float32 operand under "bf16_3x"
    (quest_tpu/ops/fused.py ``_kdot``): (h, l), h = bf16(x) and l =
    bf16(x - h), both as float32 tensors."""
    h = bf16_round(x)
    return h, bf16_round(x - h)


def tf32_exact(arr) -> bool:
    """Whether every entry of ``arr`` (NumPy or tensor), cast to float32,
    is a TF32 value: the low 13 mantissa bits are zero.  For a tensor on
    the card this reads one flag back."""
    if torch.is_tensor(arr):
        t = arr.detach().to(torch.float32).contiguous()
        return not bool((t.view(torch.int32) & _TF32_LOW).any())
    a = np.ascontiguousarray(arr, dtype=np.float32)
    return not bool((a.view(np.int32) & _TF32_LOW).any())


def note_tf32_exact(t, flag: bool) -> None:
    """Remember on side tensor ``t`` whether it is exact in TF32 (the
    executor's uploads are tagged from their NumPy source, so no launch
    reads the flag back from the card)."""
    t._qt_tf32_exact = (t._version, bool(flag))


def _side_exact(arr) -> bool:
    """``tf32_exact`` of a side operand, remembered on a tensor until the
    tensor changes."""
    if not torch.is_tensor(arr):
        return tf32_exact(arr)
    tag = getattr(arr, "_qt_tf32_exact", None)
    if tag is None or tag[0] != arr._version:
        note_tf32_exact(arr, tf32_exact(arr))
    return arr._qt_tf32_exact[1]


def pass_split(dtype, precision: str, *sides) -> int:
    """QtPass.split for a pass of ``dtype`` applying ``sides`` under
    ``precision`` (a resolved mode name).  float64 runs one DMMA product
    in every mode (SPLIT_EXACT)."""
    if dtype != torch.float32:
        return SPLIT_EXACT
    if precision == "bf16_3x":
        return SPLIT_BF16X3
    if precision == "default":
        return SPLIT_TF32
    return int(all(_side_exact(s) for s in sides))


def _elem_exact(arr, nbank: int) -> tuple:
    """``tf32_exact`` of each element of a bank's per-element side stack
    (B, R, 2, 128, 128), remembered on a tensor until it changes (one
    read for all elements)."""
    if not torch.is_tensor(arr):
        return tuple(tf32_exact(arr[b]) for b in range(nbank))
    tag = getattr(arr, "_qt_tf32_exact_elems", None)
    if tag is None or tag[0] != arr._version:
        t = arr.detach().to(torch.float32).contiguous().view(torch.int32)
        low = (t & _TF32_LOW).reshape(nbank, -1).any(dim=1).cpu()
        tag = (arr._version, tuple(not bool(v) for v in low))
        arr._qt_tf32_exact_elems = tag
    return tag[1]


def note_elem_exact(t, flags) -> None:
    """Remember on a per-element side stack ``t`` each element's TF32
    exactness (decided on the host from the NumPy source)."""
    t._qt_tf32_exact_elems = (t._version, tuple(bool(f) for f in flags))


def bank_pass_splits(dtype, precision: str, nbank: int, *sides) -> tuple:
    """QtPass.split of each element of a bank pass applying ``sides``,
    each a shared (R, 2, 128, 128) or per-element (B, R, 2, 128, 128)
    stack: under "highest" an element whose own sides are all TF32
    values takes SPLIT_EXACT and the others SPLIT_TF32X3, as each
    element's scalar launch would."""
    if dtype != torch.float32 or precision != "highest":
        return (pass_split(dtype, precision),) * nbank
    exact = [True] * nbank
    for s in sides:
        flags = (_elem_exact(s, nbank) if np.ndim(s) == 5
                 else (_side_exact(s),) * nbank)
        exact = [e and f for e, f in zip(exact, flags)]
    return tuple(int(e) for e in exact)


def _side_planes(t, split: int):
    """The planes of a float32 side stack (R, 2, 128, 128) as the kernels
    multiply them under ``split``: (re, im), their TF32 roundings, or the
    split parts (re_h, im_h, re_l, im_l) of ``tf32_side_split`` /
    ``bf16_split`` (bf16 tensors)."""
    if split == SPLIT_EXACT:
        return t
    if split == SPLIT_TF32:
        return tf32_round(t)
    if split == SPLIT_TF32X3:
        return torch.cat(tf32_side_split(t), dim=1)
    return torch.cat(bf16_split(t), dim=1).to(torch.bfloat16)


def _side_image(arr, dtype, device, split: int, elem=None):
    """A side stack (R, 2, 128, 128) as the window kernels copy it, one
    bulk copy per plane and K tile: per rank r, plane p and K tile j, a
    block of the 128 rows as the kernel's shared memory holds them.
    float32: the planes of ``_side_planes``; K tiles of 32 columns in
    8-row core matrices of 16-byte rows (4 TF32 or 8 bf16 values),
    [r][p][j][row // 8][16-byte chunk][row % 8][values] (the K-major
    layout wgmma reads).  float64: (re, im), K tiles of 16 columns, rows
    padded to 20.  Made on ``device``, once per tensor and split.  With
    ``elem``, the image of element ``elem`` of a bank's per-element stack
    (B, R, 2, 128, 128), remembered on the stack under the element's own
    key (the stack's contents, not element 0's)."""
    key = (str(torch.device(device)), dtype, int(split))
    if elem is not None:
        key += (int(elem),)
    if torch.is_tensor(arr):
        tag = getattr(arr, "_qt_side_images", None)
        if tag is not None and tag[0] == arr._version and key in tag[1]:
            return tag[1][key]
    src = arr if elem is None else arr[elem]
    t = torch.as_tensor(src if torch.is_tensor(src) else np.asarray(src),
                        dtype=dtype, device=device).contiguous()
    rank = t.shape[0]
    if dtype == torch.float32:
        t = _side_planes(t, split)
        per = 16 // t.element_size()          # values in a 16-byte row
        img = t.reshape(rank, t.shape[1], 16, 8, 4, 32 // per, per).permute(
            0, 1, 4, 2, 5, 3, 6)
    else:
        img = torch.nn.functional.pad(
            t.reshape(rank, 2, CLUSTER_DIM, 8, 16).permute(0, 1, 3, 2, 4),
            (0, 4))
    img = img.contiguous()
    if torch.is_tensor(arr):
        tag = getattr(arr, "_qt_side_images", None)
        if tag is None or tag[0] != arr._version:
            tag = (arr._version, {})
            arr._qt_side_images = tag
        tag[1][key] = img
    return img


def prepare_sides(mats_a, mats_b, apply_a: bool = True,
                  apply_b: bool = True, precision=None) -> None:
    """Make the side images of a pass whose side stacks are tensors on
    the card (the executor's uploads) under ``precision`` (None: the
    current mode), so that no launch of the pass builds them."""
    split = pass_split(mats_a.dtype, resolve_precision(precision),
                       *[s for s, on in ((mats_a, apply_a), (mats_b, apply_b))
                         if on])
    for m in (mats_a, mats_b):
        _side_image(m, m.dtype, m.device, split)


def window_pass_split(amps, mats_a, mats_b, mask=None, *, num_qubits: int,
                      k: int = SUBLANE_QUBITS, apply_a: bool = True,
                      apply_b: bool = True, precision: str = "highest"):
    """The window pass at float32 with every real product taken as the
    kernels take it under ``precision``: ``window_pass_plain``'s function,
    T = X A_r^T then Y = B_r T, each complex product four real ones, each
    real product the split products above, each exact in float32 (float32
    sums in PyTorch's order, not the card's; the mask as the plain version
    applies it)."""
    n = num_qubits
    _check_offset(n, k)
    hi = 1 << (n - k - SUBLANE_QUBITS)
    mid = 1 << (k - LANE_QUBITS)
    x = amps.to(torch.float32).reshape(2, hi, CLUSTER_DIM, mid, CLUSTER_DIM)
    a = _as_operand(mats_a, x)
    b = _as_operand(mats_b, x)
    used = [s for s, on in ((a, apply_a), (b, apply_b)) if on]
    split = pass_split(x.dtype, resolve_precision(precision), *used)

    def terms(state, side):
        if split == SPLIT_EXACT:
            return [(p, side) for p in tf32_split(state)]
        if split == SPLIT_TF32X3:
            s, (mh, ml) = tf32_split(state), tf32_side_split(side)
            return [(s[0], mh), (s[0], ml), (s[1], mh)]
        if split == SPLIT_TF32:
            return [(tf32_round(state), tf32_round(side))]
        (sh, sl), (mh, ml) = bf16_split(state), bf16_split(side)
        return [(sh, mh), (sh, ml), (sl, mh)]

    def prod(eq, side, state, side_first):
        acc = None
        for sp, mp in terms(state, side):
            p = (torch.einsum(eq, mp, sp) if side_first
                 else torch.einsum(eq, sp, mp))
            acc = p if acc is None else acc + p
        return acc

    yr = yi = None
    with _full_fp32():
        for r in range(a.shape[0] if (apply_a or apply_b) else 1):
            tr, ti = x[0], x[1]
            if apply_a:
                xa = "hwml,pl->hwmp"
                ar, ai = a[r, 0], a[r, 1]
                tr, ti = (prod(xa, ar, x[0], False)
                          + prod(xa, -ai, x[1], False),
                          prod(xa, ai, x[0], False)
                          + prod(xa, ar, x[1], False))
            if apply_b:
                bx = "qw,hwmp->hqmp"
                br, bi = b[r, 0], b[r, 1]
                tr, ti = (prod(bx, br, tr, True) + prod(bx, -bi, ti, True),
                          prod(bx, br, ti, True) + prod(bx, bi, tr, True))
            yr = tr if yr is None else yr + tr
            yi = ti if yi is None else yi + ti
    y = torch.complex(yr, yi)
    if mask is not None:
        m = cplx.to_complex(_as_operand(mask, x))
        y = y * m[None, :, None, :]
    return cplx.from_complex(y).reshape(amps.shape)


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------


class _QtPass(ctypes.Structure):
    """csrc/window.cu ``struct QtPass``."""

    _fields_ = [("k", ctypes.c_int), ("rank", ctypes.c_int),
                ("apply_a", ctypes.c_int), ("apply_b", ctypes.c_int),
                ("split", ctypes.c_int),
                ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("mask", ctypes.c_void_p)]


# qt_megawin_f32/_f64 (csrc/window.cu): state, output, slots, work
# (ticket and done-counters), CTAs, window W, slots S, n, passes, pass
# count, bank size, the elements' passes on the host and on the card
# (null for one register or shared passes), stream
MEGAWIN_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.POINTER(_QtPass),
                    ctypes.c_int, ctypes.c_int, ctypes.POINTER(_QtPass),
                    ctypes.c_void_p, ctypes.c_void_p)

# qt_window_pass_f32/_f64: state, output, n, bank size (1: one
# register), the pass, the elements' passes on the host and on the card
# (null for one register or shared passes), stream
WINDOW_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(_QtPass),
                   ctypes.POINTER(_QtPass), ctypes.c_void_p,
                   ctypes.c_void_p)

# qt_swap_cluster_stack_f32/_f64: WINDOW_ARGTYPES's state, output, n,
# bank size and passes (the pass at k = 7), then the segment swap's h, b
# and m, and the stream
SWAP_CLUSTER_ARGTYPES = WINDOW_ARGTYPES[:-1] + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

_BOUND: dict = {}
# launches of each kernel, counted where its wrapper launches it
# (launches over a register bank, one a pass for the whole bank, count
# under K1_bank, K2_bank, K5_bank, K11_bank and K12_bank)
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0, "K6": 0, "K7": 0, "K8": 0, "K9": 0,
            "K11": 0, "K12": 0, "K1_bank": 0, "K2_bank": 0, "K5_bank": 0,
            "K11_bank": 0, "K12_bank": 0}


def _lib():
    """The kernel library with the window entries' signatures declared."""
    if "lib" not in _BOUND:
        lib = build.library()
        ptr = ctypes.c_void_p
        for name in ("qt_window_pass_f32", "qt_window_pass_f64"):
            fn = getattr(lib, name)
            fn.argtypes = list(WINDOW_ARGTYPES)
            fn.restype = ctypes.c_int
        for name in ("qt_megawin_f32", "qt_megawin_f64"):
            fn = getattr(lib, name)
            fn.argtypes = list(MEGAWIN_ARGTYPES)
            fn.restype = ctypes.c_int
        lib.qt_qtpass_size.argtypes = []
        lib.qt_qtpass_size.restype = ctypes.c_int
        if lib.qt_qtpass_size() != ctypes.sizeof(_QtPass):
            raise RuntimeError("csrc/window.cu and ops/fused.py disagree on "
                               "struct QtPass")
        for name in ("qt_megawin_ctas_f32", "qt_megawin_ctas_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        for name in ("qt_swap_cluster_stack_f32",
                     "qt_swap_cluster_stack_f64"):
            fn = getattr(lib, name)
            fn.argtypes = list(SWAP_CLUSTER_ARGTYPES)
            fn.restype = ctypes.c_int
        lib.qt_max_mega_passes.argtypes = []
        lib.qt_max_mega_passes.restype = ctypes.c_int
        lib.qt_qft_hi_f32.argtypes = [ptr, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ptr, ptr, ctypes.c_int,
                                      ptr, ctypes.c_int, ptr, ptr, ptr]
        lib.qt_qft_hi_f32.restype = ctypes.c_int
        lib.qt_qft_sublane_f32.argtypes = [ptr, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ptr,
                                           ctypes.c_longlong,
                                           ctypes.c_longlong, ptr]
        lib.qt_qft_sublane_f32.restype = ctypes.c_int
        if lib.qt_max_mega_passes() != MAX_MEGA_PASSES:
            raise RuntimeError("csrc/window.cu and ops/fused.py disagree on "
                               "MAX_MEGA_PASSES")
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check_offset(n: int, k: int) -> None:
    if n < CLUSTER_QUBITS or not (LANE_QUBITS <= k <= n - SUBLANE_QUBITS):
        raise ValueError(f"window offset {k} out of range for n={n}")


def _as_operand(arr, amps):
    """A pass operand as a contiguous tensor of the state's dtype and
    device (numpy plan arrays are uploaded here)."""
    if not torch.is_tensor(arr):
        arr = np.asarray(arr)
    return torch.as_tensor(arr, dtype=amps.dtype,
                           device=amps.device).contiguous()


def _check_cuda_state(amps, what: str):
    if amps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: state dtype {amps.dtype} is not float32 "
                        "or float64")
    if not amps.is_contiguous():
        raise ValueError(f"{what}: the state must be contiguous")
    if amps.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels copy the state in 16-byte "
                         "pieces; it must start on 16 bytes")


def _pass_struct(op, amps, keep: list, precision: str = "highest") -> _QtPass:
    """ctypes pass descriptor for ("winfused", k, A, B, apply_a, apply_b
    [, mask]) under ``precision`` (a resolved mode name); the uploaded
    operands are appended to ``keep`` so they outlive the launch call."""
    sa, sb = tuple(np.shape(op[2])), tuple(np.shape(op[3]))
    rank = sa[0] if sa else 0
    if sa != (rank, 2, CLUSTER_DIM, CLUSTER_DIM) or sb != sa:
        raise ValueError(f"window pass matrices must be (R, 2, 128, 128), "
                         f"got {sa} and {sb}")
    # exactness from the operands as given: NumPy sides are checked on
    # the host, tensors carry their answer
    split = pass_split(amps.dtype, precision,
                       *[s for s, on in ((op[2], op[4]), (op[3], op[5]))
                         if on])
    a = _side_image(op[2], amps.dtype, amps.device, split)
    b = _side_image(op[3], amps.dtype, amps.device, split)
    mask = op[6] if len(op) > 6 else None
    m = None
    if mask is not None:
        m = _as_operand(mask, amps)
        if m.shape != (2, CLUSTER_DIM, CLUSTER_DIM):
            raise ValueError(f"window mask must be (2, 128, 128), got "
                             f"{tuple(m.shape)}")
        if m.data_ptr() % 16:
            # K2 reads the mask 16 bytes at a time
            m = m.clone()
        keep.append(m)
    keep += [a, b]
    return _QtPass(int(op[1]), rank, int(bool(op[4])), int(bool(op[5])),
                   split, a.data_ptr(), b.data_ptr(),
                   None if m is None else m.data_ptr())


# ---------------------------------------------------------------------------
# Register banks
# ---------------------------------------------------------------------------
#
# A BatchedQureg's drain (fusion.py, batch flags 1 and 2) hands the
# wrappers below a (B, 2, 2^n) register bank in place of one register's
# state; each runs a window pass (K1, K11), a swap + cluster pass (K12)
# or a megawin group (K2), and apply_pair_channel_sweep a sweep (K5), over
# the whole bank in ONE launch, as the reference's jax.vmap of its Pallas calls prepends a grid
# axis (csrc/window.cu and csrc/channels.cu, "Register banks").  A bank
# op's arrays are shared, or carry a leading B axis per element (flag 2:
# sides (B, R, 2, 128, 128), masks (B, 2, 128, 128), matrices (B, 2, s,
# s)).  Each element gets the bits its own launch gives: the same item
# body, and its own TF32 split (``bank_pass_splits``).  On the CPU a
# bank runs the plain version element by element.


def bank_size(amps, num_qubits: int) -> int:
    """B of a (B, 2, 2^n) register bank; 0 for one register's state (any
    full-size view of it: (2, 2^n), the canonical (2, nb, 128, 128))."""
    if amps.dim() == 3 and tuple(amps.shape[1:]) == (2, 1 << num_qubits):
        return int(amps.shape[0])
    return 0


def bank_element_op(op, b: int):
    """Element ``b``'s op of a bank plan op: each array with a leading
    per-element axis (one more than a register's) sliced to element b's,
    shared ones as they are."""
    def pick(x, ndim):
        return x[b] if x is not None and np.ndim(x) == ndim + 1 else x

    kind, op = op[0], tuple(op)
    if kind == "winfused":
        mask = (pick(op[6], 3),) if len(op) > 6 else ()
        return op[:2] + (pick(op[2], 4), pick(op[3], 4)) + op[4:6] + mask
    if kind == "megawin":
        return (kind, [bank_element_op(o, b) for o in op[1]])
    if kind == "fused":
        return (kind, pick(op[1], 4), pick(op[2], 4))
    if kind == "swapfused":
        return op[:4] + (pick(op[4], 4), pick(op[5], 4))
    if kind == "apply":
        return (kind, op[1], pick(op[2], 3)) + op[3:]
    return op


def _by_element(amps, op, run):
    """``run(element, element's op)`` on each element of a bank, stacked:
    the plain version of a bank launch."""
    return torch.stack([run(amps[b], bank_element_op(op, b))
                        for b in range(amps.shape[0])])


def _per_element(op) -> bool:
    """Whether a bank pass carries an array per element (either side
    stack, or its mask)."""
    mask = op[6] if len(op) > 6 else None
    return (np.ndim(op[2]) == 5 or np.ndim(op[3]) == 5
            or (mask is not None and np.ndim(mask) == 4))


def _bank_descs(op, bank, keep: list, precision: str):
    """(element 0's QtPass, [QtPass per element]) of a bank pass whose
    sides or mask are per element; the images and masks are appended to
    ``keep``.  Each element's pass holds its own side images (made under
    its own split), mask and split."""
    nb = int(bank.shape[0])
    mask = op[6] if len(op) > 6 else None
    if any(np.ndim(m) == d and np.shape(m)[0] != nb
           for m, d in ((op[2], 5), (op[3], 5), (mask, 4))):
        raise ValueError(f"a bank pass's per-element arrays must hold "
                         f"{nb} elements")
    sa, sb = (tuple(np.shape(m))[-4:] for m in op[2:4])
    rank = sa[0]
    if sa != (rank, 2, CLUSTER_DIM, CLUSTER_DIM) or sb != sa:
        raise ValueError(f"window pass matrices must be (R, 2, 128, 128) "
                         f"per element, got {np.shape(op[2])} and "
                         f"{np.shape(op[3])}")
    used = [m for m, on in ((op[2], op[4]), (op[3], op[5])) if on]
    splits = bank_pass_splits(bank.dtype, precision, nb, *used)
    m = None
    if mask is not None:
        m = _as_operand(mask, bank)
        if tuple(m.shape[-3:]) != (2, CLUSTER_DIM, CLUSTER_DIM):
            raise ValueError(f"window mask must be (2, 128, 128) per "
                             f"element, got {tuple(m.shape)}")
        if m.data_ptr() % 16:
            m = m.clone()
        keep.append(m)
    descs, shared = [], {}
    for b in range(nb):
        imgs = []
        for j, side in enumerate(op[2:4]):
            if np.ndim(side) == 5:
                img = _side_image(side, bank.dtype, bank.device, splits[b],
                                  elem=b)
            else:
                # a shared side: one image per split for the whole bank
                if (j, splits[b]) not in shared:
                    shared[j, splits[b]] = _side_image(
                        side, bank.dtype, bank.device, splits[b])
                img = shared[j, splits[b]]
            keep.append(img)
            imgs.append(img.data_ptr())
        mp = None
        if m is not None:
            mp = m[b].data_ptr() if m.dim() == 4 else m.data_ptr()
        descs.append(_QtPass(int(op[1]), rank, int(bool(op[4])),
                             int(bool(op[5])), splits[b], imgs[0], imgs[1],
                             mp))
    return descs[0], descs


def _upload_descs(descs, device, keep: list):
    """A host array of QtPass descriptors and its copy on ``device`` (a
    pinned staging copy, so the upload is ordered on the stream)."""
    host = (_QtPass * len(descs))(*descs)
    staged = torch.frombuffer(bytearray(host), dtype=torch.uint8)
    dev = staged.pin_memory().to(device, non_blocking=True)
    keep += [host, dev]
    return host, dev.data_ptr()


# ---------------------------------------------------------------------------
# Staged passes
# ---------------------------------------------------------------------------
#
# A drain of a cached plan runs the same window passes every time, and a
# launch makes the side images of NumPy sides anew each time: a pageable
# upload, which waits for the stream's earlier kernels, then the kernels
# of ``_side_planes``.  ``stage_ops`` makes a program's pass operands once,
# on the state's device by ``_pass_struct`` / ``_bank_descs`` (so the
# bytes are the launch's), and keeps them in one host block, pinned for a
# card.  A staged pass then reaches the card in one copy into a new device
# buffer, ordered on the stream behind the kernels before it, and its
# descriptors point into that buffer: the card holds one pass's operands
# at a time, as before.

STAGED_KINDS = ("winfused", "fused", "swapfused")
_STAGE_ALIGN = 256


class StagedPass:
    """One pass's operands in a stage's host block: ``host`` (uint8, the
    images and mask as the launch copies them), each element's QtPass
    fields with the operands' byte offsets in ``host`` in place of their
    pointers (-1: none), and whether they reach the kernel as an array
    per element (a bank pass with per-element arrays)."""

    __slots__ = ("host", "fields", "per_element")

    def __init__(self, host, fields, per_element: bool):
        self.host, self.fields, self.per_element = host, fields, per_element


def _launch_op(op):
    """The ("winfused", ...) pass ``_launch_window`` runs for a plan op of
    STAGED_KINDS: K11 and K12 take K1's pass at k = 7, dual-sided."""
    if op[0] == "fused":
        return ("winfused", SUBLANE_QUBITS, op[1], op[2], True, True)
    if op[0] == "swapfused":
        return ("winfused", SUBLANE_QUBITS, op[4], op[5], True, True)
    return op


def _align(nbytes: int) -> int:
    return -(-nbytes // _STAGE_ALIGN) * _STAGE_ALIGN


def stageable(op) -> bool:
    """Whether plan op ``op`` is a window pass whose operands are host
    arrays (tensor sides keep their images on the tensor)."""
    if op[0] not in STAGED_KINDS:
        return False
    w = _launch_op(op)
    return not any(torch.is_tensor(x) for x in w[2:4] + w[6:7])


def stage_pass(op, amps, num_qubits: int, precision: str) -> StagedPass:
    """The operands a launch of plan op ``op`` (``stageable``) on ``amps``
    (a state or a bank: its device, dtype and bank size) under
    ``precision`` makes, copied into host memory, each on 256 bytes."""
    w = _launch_op(op)
    keep: list = []
    per = bool(bank_size(amps, num_qubits)) and _per_element(w)
    descs = (_bank_descs(w, amps, keep, precision)[1] if per
             else [_pass_struct(w, amps, keep, precision)])
    blocks, size = [], 0
    for t in keep:
        if all(t.data_ptr() != b.data_ptr() for b, _ in blocks):
            blocks.append((t, _align(size)))
            size = blocks[-1][1] + t.numel() * t.element_size()
    host = torch.empty(size, dtype=torch.uint8)
    for t, at in blocks:
        raw = t.reshape(-1).view(torch.uint8)
        host[at:at + raw.numel()].copy_(raw)

    def offset(ptr):
        if ptr is None:
            return -1
        for t, at in blocks:
            if 0 <= ptr - t.data_ptr() < t.numel() * t.element_size():
                return at + ptr - t.data_ptr()
        raise RuntimeError("a pass descriptor points outside its operands")

    return StagedPass(host, tuple(
        (d.k, d.rank, d.apply_a, d.apply_b, d.split, offset(d.a),
         offset(d.b), offset(d.mask)) for d in descs), per)


def stage_ops(ops, amps, num_qubits: int, precision: str, limit: int):
    """(host block, {id(op): StagedPass}) of the ``stageable`` ops among
    ``ops`` on ``amps`` under ``precision``: made one pass at a time (the
    device holds one pass's operands at a time, as a launch does) and
    packed into one block, pinned where ``amps`` is on a card.  None when
    the block would pass ``limit`` bytes.  The caller keeps ``ops`` alive
    while it uses the ids."""
    staged, at, size = {}, {}, 0
    for op in ops:
        if id(op) in staged or not stageable(op):
            continue
        sp = stage_pass(op, amps, num_qubits, precision)
        at[id(op)] = _align(size)
        size = at[id(op)] + sp.host.numel()
        if size > limit:
            return None
        staged[id(op)] = sp
    block = torch.empty(size, dtype=torch.uint8,
                        pin_memory=amps.device.type == "cuda")
    for key, sp in staged.items():
        view = block[at[key]:at[key] + sp.host.numel()]
        view.copy_(sp.host)
        sp.host = view
    return block, staged


def _staged_descs(staged: StagedPass, device, keep: list):
    """(QtPass, host array, device array) of a staged pass: its operands
    in one copy from the pinned block into a new device buffer on the
    current stream, the descriptors pointing into that buffer."""
    buf = torch.empty(staged.host.numel(), dtype=torch.uint8, device=device)
    buf.copy_(staged.host, non_blocking=True)
    keep.append(buf)
    base = buf.data_ptr()
    descs = [_QtPass(*f[:5], *(None if o < 0 else base + o for o in f[5:]))
             for f in staged.fields]
    if not staged.per_element:
        return descs[0], None, None
    return (descs[0], *_upload_descs(descs, device, keep))


def _launch_window(amps, op, n: int, precision: str, what: str,
                   swap=None, staged=None):
    """One K1 launch of pass ``op`` over one register's state or a whole
    bank, or with ``swap`` = (h, b, m) one K12 launch (``op`` its cluster
    pass at k = 7); with ``staged``, its operands as ``stage_ops`` made
    them.  Returns the output."""
    if amps.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {amps.device}")
    _check_cuda_state(amps, what)
    nb = bank_size(amps, n)
    if amps.numel() != max(nb, 1) * (2 << n):
        raise ValueError(f"{what}: a state of {amps.numel()} reals is not "
                         f"one of {n} qubits")
    keep: list = []
    if staged is not None:
        desc, host, dev = _staged_descs(staged, amps.device, keep)
    elif nb and _per_element(op):
        desc, descs = _bank_descs(op, amps, keep, precision)
        host, dev = _upload_descs(descs, amps.device, keep)
    else:
        desc, host, dev = _pass_struct(op, amps, keep, precision), None, None
    out = torch.empty_like(amps)
    entry = "qt_window_pass" if swap is None else "qt_swap_cluster_stack"
    fn = getattr(_lib(), entry + ("_f32" if amps.dtype == torch.float32
                                  else "_f64"))
    with build.launch_stream(amps) as stream:
        build.raise_on(fn(amps.data_ptr(), out.data_ptr(), n, max(nb, 1),
                          ctypes.byref(desc), host, dev, *(swap or ()),
                          stream), what)
    return out


def apply_window_stack(amps, mats_a, mats_b, mask=None, *, num_qubits: int,
                       k: int = SUBLANE_QUBITS, apply_a: bool = True,
                       apply_b: bool = True, precision=None, staged=None):
    """One window pass (K1) under ``precision`` (None: the current mode).
    ``amps`` is any full-size contiguous view of the state ((2, 2^n) or
    the canonical (2, nb, 128, 128)), or a (B, 2, 2^n) register bank
    (``bank_size``), whose sides and mask are shared or per element, in
    one launch (the reference's vmapped _apply_window_stack_jit).  The
    result is a new tensor of the same shape.  ``staged``: the pass's
    operands as ``stage_ops`` made them for this device, dtype and mode.
    CPU tensors take the plain version (the mode's model; a bank element
    by element)."""
    n = num_qubits
    _check_offset(n, k)
    precision = resolve_precision(precision)
    op = ("winfused", k, mats_a, mats_b, apply_a, apply_b, mask)
    nb = bank_size(amps, n)
    if amps.device.type == "cpu":
        if nb:
            return _by_element(amps, op, lambda x, e: apply_window_stack(
                x, *e[2:4], e[6], num_qubits=n, k=k, apply_a=apply_a,
                apply_b=apply_b, precision=precision))
        return window_pass_model(amps, mats_a, mats_b, mask, num_qubits=n,
                                 k=k, apply_a=apply_a, apply_b=apply_b,
                                 precision=precision)
    out = _launch_window(amps, op, n, precision, "apply_window_stack",
                         staged=staged)
    LAUNCHES["K1_bank" if nb else "K1"] += 1
    return out


def apply_cluster_stack(amps, mats_a, mats_b, *, num_qubits: int,
                        precision=None, staged=None):
    """The paged planner's cluster pass (K11) under ``precision`` (None:
    the current mode): sum_r B_r X A_r^T on each 128 x 128 slab of the
    canonical view, A_r on the lane qubits [0, 7), B_r on [7, 14);
    ``mats_a``/``mats_b`` are SoA (R, 2, 128, 128), or per element
    (B, R, 2, 128, 128) on a bank.  ``amps`` is any full-size contiguous
    view of the state, or a (B, 2, 2^n) register bank (one launch); the
    result is a new tensor of the same shape.  ``staged``: as
    ``apply_window_stack``'s.  CPU tensors take the plain version."""
    n = num_qubits
    op = ("fused", mats_a, mats_b)
    nb = bank_size(amps, n)
    e0 = bank_element_op(op, 0) if nb else op
    _check_cluster(n, e0[1], e0[2], "apply_cluster_stack")
    precision = resolve_precision(precision)
    if amps.device.type == "cpu":
        if nb:
            return _by_element(amps, op, lambda x, e: cluster_stack_plain(
                x, e[1], e[2], num_qubits=n, precision=precision))
        return cluster_stack_plain(amps, mats_a, mats_b, num_qubits=n,
                                   precision=precision)
    out = _launch_window(amps, _launch_op(op), n, precision,
                         "apply_cluster_stack", staged=staged)
    LAUNCHES["K11_bank" if nb else "K11"] += 1
    return out


def apply_cluster_pair(amps, mat_a, mat_b, *, num_qubits: int,
                       precision=None):
    """One cluster pair: SoA (2, 128, 128) lane and window matrices,
    stacked to rank 1 and run through ``apply_cluster_stack`` (K11)."""
    return apply_cluster_stack(amps, mat_a[None], mat_b[None],
                               num_qubits=num_qubits, precision=precision)


def apply_swap_cluster_stack(amps, mats_a, mats_b, *, num_qubits: int,
                             h: int, b: int, m: int, precision=None,
                             staged=None):
    """The segment swap [h, h+m) <-> [b, b+m) followed by the rank-R
    cluster operator, in one pass (K12), under ``precision`` (None: the
    current mode): h >= 14, 7 <= b, b + m <= 14, m <= MAX_FUSED_SWAP_M.
    ``mats_a``/``mats_b`` are SoA (R, 2, 128, 128), or per element
    (B, R, 2, 128, 128) on a bank.  ``amps`` is any full-size contiguous
    view of the state, or a (B, 2, 2^n) register bank (one launch, the
    reference's vmapped _apply_swap_cluster_stack_jit); the result is a
    new tensor of the input's shape.  ``staged``: as
    ``apply_window_stack``'s.  CPU tensors take the plain version (a bank
    element by element)."""
    n = num_qubits
    op = ("swapfused", h, b, m, mats_a, mats_b)
    nb = bank_size(amps, n)
    e0 = bank_element_op(op, 0) if nb else op
    _check_cluster(n, e0[4], e0[5], "apply_swap_cluster_stack")
    _check_swap(n, h, b, m)
    precision = resolve_precision(precision)
    if amps.device.type == "cpu":
        if nb:
            return _by_element(amps, op, lambda x, e: swap_cluster_stack_plain(
                x, e[4], e[5], num_qubits=n, h=h, b=b, m=m,
                precision=precision))
        return swap_cluster_stack_plain(amps, mats_a, mats_b, num_qubits=n,
                                        h=h, b=b, m=m, precision=precision)
    out = _launch_window(amps, _launch_op(op), n, precision,
                         "apply_swap_cluster_stack", swap=(h, b, m),
                         staged=staged)
    LAUNCHES["K12_bank" if nb else "K12"] += 1
    return out


# K2's tickets: a pass of a window of super-blocks holds about this many
# items per CTA of the grid, so that an item's inputs were written about
# that many rounds of items before it; a ticket is MEGA_TICKET_ITEMS
# consecutive items of one super-block's pass (csrc/window.cu, K2).
MEGA_ITEMS_PER_CTA = 4
MEGA_TICKET_ITEMS = 2
_CTAS: dict = {}


def megawin_ctas(device, dtype) -> int:
    """K2's persistent grid on ``device``: its SMs times the CTAs an SM
    holds (one, at 208 KB of shared memory at float32)."""
    device = torch.device(device)
    key = (device.index, dtype)
    if key not in _CTAS:
        fn = (_lib().qt_megawin_ctas_f32 if dtype == torch.float32
              else _lib().qt_megawin_ctas_f64)
        count = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.raise_on(fn(ctypes.byref(count)), "apply_window_megastack")
        if count.value < 1:
            raise RuntimeError("apply_window_megastack: the card holds no "
                               "K2 CTA")
        _CTAS[key] = count.value
    return _CTAS[key]


def megawin_schedule(num_qubits: int, g: int, npass: int, dtype,
                     ctas: int, nbank: int = 1) -> dict:
    """K2's ticket schedule for ``npass`` passes over super-blocks of
    ``g`` rows, of one register or of each of a bank's ``nbank``: the
    super-blocks (``super_blocks``, over the whole bank), the items of one
    super-block's pass (``items_per_pass``: the lane chunks of its G
    slabs, MEGA_TICKET_ITEMS to a ticket; ``tickets`` in all),
    the super-blocks of a window (``window``, W: a pass of a window holds
    MEGA_ITEMS_PER_CTA items per CTA, or every super-block), the scratch
    slots (``slots``, S = 2W: the next window's passes need not wait for
    this one's last; none for one pass) and the workspace the wrapper
    allocates (``slot_bytes`` and the ticket and done-counters,
    ``workspace_bytes`` in all)."""
    nchunk = 2 if dtype == torch.float32 else 4
    ipp = g * nchunk
    nsb = (1 << (num_qubits - CLUSTER_QUBITS)) // g * nbank
    window = min(nsb, -(-MEGA_ITEMS_PER_CTA * ctas // ipp))
    slots = min(nsb, 2 * window) if npass > 1 else 0
    elem = 4 if dtype == torch.float32 else 8
    slot_bytes = slots * 2 * g * CLUSTER_DIM * CLUSTER_DIM * elem
    return {"ctas": ctas, "super_blocks": nsb, "items_per_pass": ipp,
            "tickets": nsb * npass * ipp // MEGA_TICKET_ITEMS,
            "window": window, "slots": slots, "slot_bytes": slot_bytes,
            "workspace_bytes": slot_bytes + 4 * (1 + nsb)}


def megawin_decode(ticket: int, sched: dict, npass: int):
    """(super-block, pass, first item) of a K2 ticket: windows of W
    super-blocks in order (the last may hold fewer), pass by pass within
    a window, then super-block by super-block and MEGA_TICKET_ITEMS
    items at a time.  The host twin of csrc/window.cu ``mega_decode``."""
    nsb, w = sched["super_blocks"], sched["window"]
    tpp = sched["items_per_pass"] // MEGA_TICKET_ITEMS
    win, r = divmod(ticket, w * npass * tpp)
    w0 = win * w
    pas, q = divmod(r, min(w, nsb - w0) * tpp)
    return w0 + q // tpp, pas, q % tpp * MEGA_TICKET_ITEMS


def megawin_first_slot_pass(npass: int) -> int:
    """The pass that first writes a super-block's slot (the passes
    alternate so that the last lands in the output; one pass: none)."""
    return -1 if npass == 1 else (0 if npass % 2 == 0 else 1)


def _megawin_check(subops, n: int) -> int:
    """The group's checks on the host; returns its G."""
    if not 1 <= len(subops) <= MAX_MEGA_PASSES:
        raise ValueError(f"a megawin group holds 1..{MAX_MEGA_PASSES} "
                         f"passes, got {len(subops)}")
    for op in subops:
        _check_offset(n, int(op[1]))
    g = 1 << (max(int(op[1]) for op in subops) - LANE_QUBITS)
    if g > (1 << (n - CLUSTER_QUBITS)):
        raise ValueError(f"megawin window offsets out of range for n={n}")
    return g


def apply_window_megastack(amps, subops, *, num_qubits: int,
                           precision=None):
    """A planned megawin group — ``subops`` is a sequence of ("winfused",
    k, A, B, apply_a, apply_b[, mask]) tuples — in ONE launch (K2), under
    ``precision`` (None: the current mode).  The
    result is a new tensor of the input's shape; the passes between go
    through a ring of scratch slots of one super-block each
    (``megawin_schedule``: tens of MB), not through a full-size buffer.
    The workspace (slots, a ticket counter and one done-counter per
    super-block) is allocated, and its counters zeroed, for every
    launch.  On a (B, 2, 2^n) register bank the launch takes every
    element (the reference's vmapped _apply_megawin_jit): element b's
    super-blocks are b * SB + s of one ticket schedule, each pass shared
    or per element as in ``apply_window_stack``.  CPU tensors take the
    plain version (a bank element by element)."""
    n = num_qubits
    g = _megawin_check(subops, n)
    precision = resolve_precision(precision)
    nb = bank_size(amps, n)
    if amps.device.type == "cpu":
        if nb:
            return _by_element(amps, ("megawin", subops),
                               lambda x, e: megawin_plain(
                                   x, e[1], num_qubits=n,
                                   precision=precision))
        return megawin_plain(amps, subops, num_qubits=n, precision=precision)
    if amps.device.type != "cuda":
        raise RuntimeError(f"apply_window_megastack: no kernel for device "
                           f"{amps.device}")
    _check_cuda_state(amps, "apply_window_megastack")
    keep: list = []
    per = [_bank_descs(op, amps, keep, precision)[1]
           if nb and _per_element(op) else None for op in subops]
    shared = [p[0] if p else _pass_struct(op, amps, keep, precision)
              for p, op in zip(per, subops)]
    host = dev = None
    if any(per):
        host, dev = _upload_descs(
            [per[i][b] if per[i] else shared[i]
             for b in range(nb) for i in range(len(subops))],
            amps.device, keep)
    descs = (_QtPass * len(subops))(*shared)
    sched = megawin_schedule(n, g, len(subops), amps.dtype,
                             megawin_ctas(amps.device, amps.dtype),
                             max(nb, 1))
    out = torch.empty_like(amps)
    slots = None
    if sched["slots"]:
        slots = torch.empty(sched["slot_bytes"] // amps.element_size(),
                            dtype=amps.dtype, device=amps.device)
    work = torch.zeros(1 + sched["super_blocks"], dtype=torch.int32,
                       device=amps.device)
    fn = (_lib().qt_megawin_f32 if amps.dtype == torch.float32
          else _lib().qt_megawin_f64)
    with build.launch_stream(amps) as stream:
        build.raise_on(fn(amps.data_ptr(), out.data_ptr(),
                          None if slots is None else slots.data_ptr(),
                          work.data_ptr(), sched["ctas"], sched["window"],
                          sched["slots"], n, descs, len(subops), max(nb, 1),
                          host, dev, stream), "apply_window_megastack")
    LAUNCHES["K2_bank" if nb else "K2"] += 1
    return out


# ---------------------------------------------------------------------------
# QFT ladder layers (K6-K9)
# ---------------------------------------------------------------------------
#
# One QFT layer on target t is the Hadamard on t followed by the whole
# controlled-phase ladder against bits [0, t): the pair (x0, x1) across bit
# t becomes ((x0 + x1) / sqrt2, (x0 - x1) / sqrt2 * e^{i sgn pi low / 2^t})
# with low = the amplitude index's bits [0, t) (agnostic_applyQFT,
# QuEST_common.c:836-898).  The phase factorises over the canonical view:
# a (128, 128) table over bits [0, 14), and for t >= 14 a factor over the
# block index j (bits [14, t_lo)) kept as two tables split at 2^11
# (tlo[j mod 2^11] * thi[j div 2^11]).  For 7 <= t <= 13 the pair bit is
# a row bit of the 128 x 128 block and one (2^(t-7), 128) table covers the
# phase.  All tables are built on the host in float64, as the reference
# builds them, and cast to the state's type; a kernel and its plain
# version read the same tables.

_TL_SPLIT = 1 << 11
QFT_RADIX_DEFAULT = 4    # layers per K8 pass
_TABLES: dict = {}


def _real(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _layer_tables(t: int, count: int, sgn: float, dt):
    """(tab (2, 128, 128), tlo (2, <= 2048), thi (2, >= 1)) of layer t
    over ``count`` block indices (fused.py:946-959)."""
    j14 = np.arange(1 << CLUSTER_QUBITS, dtype=np.float64)
    ang14 = sgn * np.pi * j14 / (1 << t)
    tab = np.stack([np.cos(ang14), np.sin(ang14)]).reshape(
        2, CLUSTER_DIM, CLUSTER_DIM)
    jlo = np.arange(min(count, _TL_SPLIT), dtype=np.float64)
    alo = sgn * np.pi * jlo * (1 << CLUSTER_QUBITS) / (1 << t)
    jhi = np.arange(max(1, count // _TL_SPLIT), dtype=np.float64)
    ahi = (sgn * np.pi * jhi * float(_TL_SPLIT)
           * (1 << CLUSTER_QUBITS) / (1 << t))
    return (tab.astype(dt), np.stack([np.cos(alo), np.sin(alo)]).astype(dt),
            np.stack([np.cos(ahi), np.sin(ahi)]).astype(dt))


@lru_cache(maxsize=None)
def _block_consts(k: int, conj: bool, dt):
    """(re, im) of the phase over the swept block bits below layer p of a
    K8 pass, e^{i sgn pi clo / 2^p} at index 2^p - 1 + clo, in the state's
    type (the reference's compile-time Python floats, fused.py:1093)."""
    sgn = -1.0 if conj else 1.0
    re = np.zeros(32, dt)
    im = np.zeros(32, dt)
    for p in range(k):
        for clo in range(1 << p):
            a = sgn * np.pi * clo / float(1 << p)
            re[(1 << p) - 1 + clo] = np.cos(a)
            im[(1 << p) - 1 + clo] = np.sin(a)
    return re, im


def _multi_hi_tables(t_hi: int, t_lo: int, conj: bool, dt):
    """K8's (ctab (k, 2, 128, 128), mlo (k, 2, <= 2048), mhi (k, 2, >= 1))
    for layers t_lo..t_hi (fused.py:1163-1183).  With t_hi == t_lo these
    are K6's tables of that layer (fused.py:946-959)."""
    sgn = -1.0 if conj else 1.0
    count = 1 << (t_lo - CLUSTER_QUBITS)
    per_layer = [_layer_tables(t, count, sgn, dt)
                 for t in range(t_lo, t_hi + 1)]
    return tuple(np.stack(parts) for parts in zip(*per_layer))


def _lo_table(t: int, conj: bool, dt):
    """K7's (2, 2^(t-7), 128) table of layer t (fused.py:939-942)."""
    sgn = -1.0 if conj else 1.0
    jlo = np.arange(1 << t, dtype=np.float64)
    ang = sgn * np.pi * jlo / (1 << t)
    return (np.stack([np.cos(ang), np.sin(ang)]).reshape(
        2, 1 << (t - LANE_QUBITS), CLUSTER_DIM).astype(dt),)


def _cluster_table(conj: bool, dt):
    """K9's (7, 2, 128, 128) table, row 13 - t for layer t; its rows
    [:2^(t-7)] are K7's table of layer t (fused.py:1255-1262)."""
    sgn = -1.0 if conj else 1.0
    sl = np.arange(CLUSTER_DIM, dtype=np.float64)[:, None]
    ll = np.arange(CLUSTER_DIM, dtype=np.float64)[None, :]
    tab = np.empty((SUBLANE_QUBITS, 2, CLUSTER_DIM, CLUSTER_DIM), dtype=dt)
    for t in range(CLUSTER_QUBITS - 1, LANE_QUBITS - 1, -1):
        ang = sgn * np.pi * (sl * CLUSTER_DIM + ll) / (1 << t)
        tab[13 - t, 0] = np.cos(ang)
        tab[13 - t, 1] = np.sin(ang)
    return (tab,)


def _tables_on(builder, args, device):
    """A table builder's arrays as tensors on ``device``, uploaded once per
    (builder, arguments, device)."""
    key = (builder.__name__, args, str(device))
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(a, device=device)
                             for a in builder(*args))
    return _TABLES[key]


def _inv_sqrt2(dt) -> float:
    """1/sqrt(2) in the state's type (the reference's weak-typed literal
    0.7071067811865476 cast to it)."""
    return float(dt(0.7071067811865476))


def _check_ladder(n: int, t: int) -> None:
    if n < CLUSTER_QUBITS + 1 or not (LANE_QUBITS <= t < n):
        raise ValueError(f"QFT ladder layer t={t} out of range for n={n} "
                         "(needs 7 <= t < n and n >= 15)")


def _check_chunk(n: int, t_hi: int, t_lo: int) -> None:
    if not (CLUSTER_QUBITS <= t_lo <= t_hi < n and 1 <= t_hi - t_lo + 1 <= 5):
        raise ValueError("apply_qft_multi_hi: bad layer chunk")


def qft_ladder_supported(amps, num_qubits: int, target: int,
                         base: int) -> bool:
    """The ladder kernels take base 0, a pair bit t >= 7, n >= 15, float32
    and a tensor on the card (the reference's rule, fused.py:912, with
    "not interpret" read as "on CUDA")."""
    return (base == 0 and target >= LANE_QUBITS and num_qubits > target
            and num_qubits >= CLUSTER_QUBITS + 1
            and amps.dtype == torch.float32 and amps.device.type == "cuda")


def qft_multilayer_enabled(amps) -> bool:
    """Multi-layer QFT passes (K8, K9): float32 on the card."""
    return amps.dtype == torch.float32 and amps.device.type == "cuda"


def _hi_layers_plain(amps, ctab, mlo, mhi, cre, cim, *, num_qubits: int,
                     t_hi: int, t_lo: int):
    """Layers t_hi..t_lo (all >= 14) on the view (2, H, 2^k, M, 128, 128),
    in the order and with the products of the K8 kernel: per layer p the
    block factor m = mlo[p][j mod 2^11] * mhi[p][j div 2^11], times the
    block-bit constant, times ctab[p][e], then the pair combine."""
    n, k = num_qubits, t_hi - t_lo + 1
    C, M = 1 << k, 1 << (t_lo - CLUSTER_QUBITS)
    H = 1 << (n - 1 - t_hi)
    inv = _inv_sqrt2(_real(amps.dtype))
    out = amps.clone()
    v = out.reshape(2, H, C, M, CLUSTER_DIM, CLUSTER_DIM)
    j = torch.arange(M, device=amps.device)
    jl, jh = j % _TL_SPLIT, j // _TL_SPLIT
    for p in range(k - 1, -1, -1):
        ar, ai = mlo[p, 0][jl], mlo[p, 1][jl]
        br, bi = mhi[p, 0][jh], mhi[p, 1][jh]
        mr = ar * br - ai * bi
        mi = ar * bi + ai * br
        ctr, cti = ctab[p, 0], ctab[p, 1]
        for c0 in range(C):
            if (c0 >> p) & 1:
                continue
            c1 = c0 | (1 << p)
            q = (1 << p) - 1 + (c0 & ((1 << p) - 1))
            cr, ci = float(cre[q]), float(cim[q])
            sr = (mr * cr - mi * ci)[:, None, None]
            si = (mr * ci + mi * cr)[:, None, None]
            phr = sr * ctr - si * cti
            phi = sr * cti + si * ctr
            x0r, x0i = v[0, :, c0], v[1, :, c0]
            x1r, x1i = v[0, :, c1], v[1, :, c1]
            s0r = (x0r + x1r) * inv
            s0i = (x0i + x1i) * inv
            dr = (x0r - x1r) * inv
            di = (x0i - x1i) * inv
            v[0, :, c0] = s0r
            v[1, :, c0] = s0i
            v[0, :, c1] = dr * phr - di * phi
            v[1, :, c1] = dr * phi + di * phr
    return out


def qft_multi_hi_plain(amps, *, num_qubits: int, t_hi: int, t_lo: int,
                       conj: bool = False):
    """Layers t = t_hi..t_lo (descending, all >= 14) as a new tensor: the
    plain version of K8 (the reference's _qft_multi_hi_kernel)."""
    _check_chunk(num_qubits, t_hi, t_lo)
    dt = _real(amps.dtype)
    tabs = _tables_on(_multi_hi_tables, (t_hi, t_lo, conj, dt), amps.device)
    consts = _block_consts(t_hi - t_lo + 1, conj, dt)
    return _hi_layers_plain(amps, *tabs, *consts, num_qubits=num_qubits,
                            t_hi=t_hi, t_lo=t_lo)


def qft_ladder_plain(amps, *, num_qubits: int, target: int,
                     conj: bool = False):
    """One layer t >= 14 as a new tensor: the plain version of K6 (the
    reference's _qft_ladder_kernel), which is K8's with one layer."""
    return qft_multi_hi_plain(amps, num_qubits=num_qubits, t_hi=target,
                              t_lo=target, conj=conj)


def _sublane_layer(x, tr, ti, t: int, inv: float):
    """One layer 7 <= t <= 13 on a (2, 2^(n-14), 128, 128) view: rows s and
    s | 2^(t-7) of each block pair up; tr, ti are (2^(t-7), 128) tables
    over the low row bits and the lanes (fused.py:975-987)."""
    s_lo = 1 << (t - LANE_QUBITS)
    v = x.reshape(2, -1, 2, s_lo, CLUSTER_DIM)
    x0, x1 = v[:, :, 0], v[:, :, 1]
    y0 = (x0 + x1) * inv
    d = (x0 - x1) * inv
    y1r = d[0] * tr - d[1] * ti
    y1i = d[0] * ti + d[1] * tr
    out = torch.stack([torch.stack([y0[0], y1r], dim=1),
                       torch.stack([y0[1], y1i], dim=1)])
    return out.reshape(x.shape)


def qft_ladder_lo_plain(amps, *, num_qubits: int, target: int,
                        conj: bool = False):
    """One layer 7 <= t <= 13 as a new tensor: the plain version of K7
    (the reference's _qft_ladder_lo_kernel)."""
    _check_ladder(num_qubits, target)
    (tab,) = _tables_on(_lo_table, (target, conj, _real(amps.dtype)),
                        amps.device)
    return _sublane_layer(amps, tab[0], tab[1], target,
                          _inv_sqrt2(_real(amps.dtype))).reshape(amps.shape)


def qft_cluster_multi_plain(amps, *, num_qubits: int, conj: bool = False):
    """Layers 13..7 as a new tensor: the plain version of K9 (the
    reference's _qft_cluster_multi_kernel), K7's layer seven times with
    rows [:2^(t-7)] of K9's table."""
    if num_qubits < CLUSTER_QUBITS + 1:
        raise ValueError("apply_qft_cluster_multi needs n >= 15")
    (tab,) = _tables_on(_cluster_table, (conj, _real(amps.dtype)),
                        amps.device)
    inv = _inv_sqrt2(_real(amps.dtype))
    x = amps
    for t in range(CLUSTER_QUBITS - 1, LANE_QUBITS - 1, -1):
        s_lo = 1 << (t - LANE_QUBITS)
        x = _sublane_layer(x, tab[13 - t, 0, :s_lo], tab[13 - t, 1, :s_lo],
                           t, inv)
    return x.reshape(amps.shape)


def _qft_cuda_state(amps, n: int, what: str):
    if amps.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {amps.device}")
    if amps.dtype != torch.float32:
        raise TypeError(f"{what}: state dtype {amps.dtype} is not float32")
    if not amps.is_contiguous():
        raise ValueError(f"{what}: the state must be contiguous")
    if amps.numel() != 2 << n:
        raise ValueError(f"{what}: a state of {tuple(amps.shape)} is not "
                         f"(2, 2^{n})")


def _launch_hi(amps, n: int, t_hi: int, t_lo: int, conj: bool, what: str):
    """The K8 kernel over layers t_hi..t_lo, in place."""
    _qft_cuda_state(amps, n, what)
    ctab, mlo, mhi = _tables_on(
        _multi_hi_tables, (t_hi, t_lo, conj, np.float32), amps.device)
    cre, cim = _block_consts(t_hi - t_lo + 1, conj, np.float32)
    with build.launch_stream(amps) as stream:
        build.raise_on(_lib().qt_qft_hi_f32(
            amps.data_ptr(), n, t_hi, t_lo, ctab.data_ptr(), mlo.data_ptr(),
            int(mlo.shape[-1]), mhi.data_ptr(), int(mhi.shape[-1]),
            cre.ctypes.data, cim.ctypes.data, stream), what)


def _launch_sublane(amps, n: int, t_hi: int, t_lo: int, tab,
                    layer_stride: int, chan_stride: int, what: str):
    """The K9 kernel over layers t_hi..t_lo (all in 7..13), in place;
    ``tab`` holds layer t_hi's table, the next layer's ``layer_stride``
    floats on, the imaginary half ``chan_stride`` floats on."""
    _qft_cuda_state(amps, n, what)
    with build.launch_stream(amps) as stream:
        build.raise_on(_lib().qt_qft_sublane_f32(
            amps.data_ptr(), n, t_hi, t_lo, tab.data_ptr(), layer_stride,
            chan_stride, stream), what)


def apply_qft_ladder_pallas(amps, *, num_qubits: int, target: int,
                            conj: bool = False):
    """One QFT layer (H on ``target`` plus the controlled-phase ladder
    against bits [0, target)) in one pass: K6 for target >= 14, K7 for
    7 <= target <= 13.  On the card the kernel overwrites the input in
    place and returns it; a CPU tensor takes the plain version, which
    returns a new tensor."""
    n, t = num_qubits, target
    _check_ladder(n, t)
    if t < CLUSTER_QUBITS:
        if amps.device.type == "cpu":
            return qft_ladder_lo_plain(amps, num_qubits=n, target=t,
                                       conj=conj)
        (tab,) = _tables_on(_lo_table, (t, conj, np.float32), amps.device)
        _launch_sublane(amps, n, t, t, tab, 0, tab[0].numel(),
                        "apply_qft_ladder_pallas")
        LAUNCHES["K7"] += 1
        return amps
    if amps.device.type == "cpu":
        return qft_ladder_plain(amps, num_qubits=n, target=t, conj=conj)
    _launch_hi(amps, n, t, t, conj, "apply_qft_ladder_pallas")
    LAUNCHES["K6"] += 1
    return amps


def apply_qft_multi_hi(amps, *, num_qubits: int, t_hi: int, t_lo: int,
                       conj: bool = False):
    """Layers t = t_hi..t_lo (descending, all >= 14, at most 5) in one
    pass (K8): 2^k amplitudes of each pair group co-resident.  In place
    on the card; a CPU tensor takes the plain version (a new tensor)."""
    _check_chunk(num_qubits, t_hi, t_lo)
    if amps.device.type == "cpu":
        return qft_multi_hi_plain(amps, num_qubits=num_qubits, t_hi=t_hi,
                                  t_lo=t_lo, conj=conj)
    _launch_hi(amps, num_qubits, t_hi, t_lo, conj, "apply_qft_multi_hi")
    LAUNCHES["K8"] += 1
    return amps


def apply_qft_cluster_multi(amps, *, num_qubits: int, conj: bool = False):
    """All seven sublane layers (t = 13..7) in one pass (K9).  In place on
    the card; a CPU tensor takes the plain version (a new tensor)."""
    if num_qubits < CLUSTER_QUBITS + 1:
        raise ValueError("apply_qft_cluster_multi needs n >= 15")
    if amps.device.type == "cpu":
        return qft_cluster_multi_plain(amps, num_qubits=num_qubits,
                                       conj=conj)
    (tab,) = _tables_on(_cluster_table, (conj, np.float32), amps.device)
    plane = CLUSTER_DIM * CLUSTER_DIM
    _launch_sublane(amps, num_qubits, CLUSTER_QUBITS - 1, LANE_QUBITS, tab,
                    2 * plane, plane, "apply_qft_cluster_multi")
    LAUNCHES["K9"] += 1
    return amps


def apply_qft_multilayer_ladders(amps, *, num_qubits: int, t_top: int,
                                 radix: int = QFT_RADIX_DEFAULT,
                                 conj: bool = False):
    """Ladder layers t = t_top .. 7 (descending) through the multilayer
    kernels: chunks of ``radix`` layers (clamped to 1..5) for t >= 14 (K8),
    then one pass of the seven sublane layers (K9); ``conj`` negates the
    phases.  Shared by the one-register QFT and the per-shard local layers
    of the sharded one.  Requires t_top >= 13 and num_qubits >= 15."""
    if t_top < CLUSTER_QUBITS - 1:
        raise ValueError("apply_qft_multilayer_ladders needs t_top >= 13 "
                         "(the cluster pass applies ALL sublane layers)")
    radix = max(1, min(5, int(radix)))
    t = t_top
    while t >= CLUSTER_QUBITS:
        t_lo = max(CLUSTER_QUBITS, t - radix + 1)
        amps = apply_qft_multi_hi(amps, num_qubits=num_qubits, t_hi=t,
                                  t_lo=t_lo, conj=conj)
        t = t_lo - 1
    return apply_qft_cluster_multi(amps, num_qubits=num_qubits, conj=conj)


# ---------------------------------------------------------------------------
# K5: the fused pair-channel sweep
# ---------------------------------------------------------------------------
#
# A depolarise / damping channel on a density register pairs each element
# with its double-flip partner (ket bit t, bra bit b) and combines the two
# with block weights (ops/density.py _pair_channel).  The reference runs a
# run of such channels in few passes over the state: channels whose bra
# bit lies above the 14-bit block are chunked by bra bit, three bits a
# sweep, in call order within a chunk (channels of different chunks act on
# disjoint bit pairs and commute); channels whose bra bit lies in the
# block ride the first sweep.  The port keeps that chunking: a sweep is one
# K5 launch per orbit group (csrc/channels.cu).

_CHAN_SWEEP_RADIX = 3      # grid bra bits per sweep, the reference's chunk
CHAN_MAX_RANK = 4          # csrc/channels.cu MAX_RANK
CHAN_MAX_ENTRIES = 32      # csrc/channels.cu MAX_ENTRIES
_NUMPY_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def channel_sweep_enabled(amps) -> bool:
    """Whether a fusion drain on ``amps`` runs its channel runs through
    sweeps: a float32 state on the card (the reference's "float32 and not
    interpret").  Elsewhere each channel runs alone (ops/density.py)."""
    return amps.dtype == torch.float32 and amps.device.type == "cuda"


def channel_weights(kind: str, prob, dtype) -> np.ndarray:
    """(w_same0, w_same1, w_diff, w2_00, w2_11) of one channel in the real
    type ``dtype`` (NumPy or torch), computed on the host in the
    reference's order of operations (fused.py:1459-1471)."""
    f = np.dtype(_NUMPY_REAL.get(dtype, dtype)).type
    p, one = f(prob), f(1)
    if kind == "depol":
        return np.array([one - f(2) * p / f(3), one - f(2) * p / f(3),
                         one - f(4) * p / f(3), f(2) * p / f(3) * one,
                         f(2) * p / f(3) * one], dtype=f)
    if kind == "damping":
        return np.array([one, one - p, np.sqrt(one - p), p * one,
                         f(0) * one], dtype=f)
    raise ValueError(f"unknown pair channel {kind!r}")


def channel_entry_tables(w: np.ndarray, grid: bool) -> np.ndarray:
    """(2, 4) weights (w1, w2) of one sweep entry at (kt, kb) = (0,0),
    (0,1), (1,0), (1,1), from its (5,) ``channel_weights``: the reference
    kernel's formulas evaluated at each bit pattern in the weights' type.
    A grid entry (bra bit >= 14) takes the exact select of fused.py:1413-
    1416; an in-block entry wd + (ws0-wd) k0b0 + (ws1-wd) k1b1 of :1400,
    which rounds the diagonal weights once more."""
    f = w.dtype.type
    ws0, ws1, wd, w2_00, w2_11 = w
    out = np.empty((2, 4), dtype=w.dtype)
    for kt in (0, 1):
        for kb in (0, 1):
            ft, fb = f(kt), f(kb)
            if grid and kb == 0:
                w1, w2 = ws0 * (f(1) - ft) + wd * ft, w2_00 * (f(1) - ft)
            elif grid:
                w1, w2 = wd * (f(1) - ft) + ws1 * ft, w2_11 * ft
            else:
                k1b1 = ft * fb
                k0b0 = (f(1) - ft) * (f(1) - fb)
                w1 = wd + (ws0 - wd) * k0b0 + (ws1 - wd) * k1b1
                w2 = w2_00 * k0b0 + w2_11 * k1b1
            out[:, 2 * kt + kb] = (w1, w2)
    return out


def _check_sweep(program, probs, nn: int) -> None:
    """The reference's preconditions (fused.py:1486-1501), with its
    messages, plus the port's own: one probability per channel, two
    distinct bits per channel."""
    if nn < CLUSTER_QUBITS + 1:
        raise ValueError("apply_pair_channel_sweep needs num_bits >= 15")
    if len(probs) != len(program):
        raise ValueError(f"apply_pair_channel_sweep: {len(program)} "
                         f"channels but {len(probs)} probabilities")
    pair_of = {}
    for _kind, t, b in program:
        if t >= CLUSTER_QUBITS or b >= nn:
            raise ValueError("sweep channels need ket bit < 14")
        if t == b or min(t, b) < 0:
            raise ValueError("sweep channels need two distinct bits")
        # chunks are keyed on the bra bit: channels sharing a bra bit
        # must share the ket bit, or call order across non-commuting
        # chunks could be rearranged
        if pair_of.setdefault(b, t) != t:
            raise ValueError(
                "apply_pair_channel_sweep: channels sharing a bra bit "
                "must share the ket bit (chunking is keyed on the bra "
                "bit; mixed pairs would reorder non-commuting channels)")


def sweep_schedule(program, num_bits: int) -> list:
    """The sweeps of a channel program, chunked as the reference chunks
    them (fused.py:1514-1534): [(b0, k, entries)], bra bits [b0, b0+k)
    co-resident, each entry (t, b, pbit, wi) with pbit = b - b0 for a grid
    entry and None for an in-block one (bra bit < 14, first sweep), wi
    the channel's index in ``program``."""
    nn, radix = num_bits, _CHAN_SWEEP_RADIX
    chunks, inblock = [], []
    for wi, (_kind, t, b) in enumerate(program):
        if b < CLUSTER_QUBITS:
            inblock.append((t, b, None, wi))
            continue
        for b0, entries in chunks:
            if b0 <= b < b0 + min(radix, nn - b0):
                entries.append((t, b, b - b0, wi))
                break
        else:
            b0 = max(CLUSTER_QUBITS, min(b, nn - radix))
            chunks.append((b0, [(t, b, b - b0, wi)]))
    if not chunks:
        chunks.append((CLUSTER_QUBITS, []))
    if inblock:
        chunks[0][1][:0] = inblock
    return [(b0, min(radix, nn - b0), tuple(entries))
            for b0, entries in chunks]


def sweep_launch_groups(entries) -> list:
    """A sweep's entries, in order, as K5 launches: consecutive runs whose
    flip masks (1<<t)|(1<<b) have rank <= CHAN_MAX_RANK over GF(2), of at
    most CHAN_MAX_ENTRIES entries.  Each group is (entries, pivots, orbit,
    subsets): the reduced echelon basis's pivot bits (ascending), the XOR
    of the basis vectors in each subset j < 2^r, and per entry the subset
    whose XOR is its mask."""
    groups, cur, basis = [], [], {}

    def reduce(m):
        for p, v in basis.items():
            if (m >> p) & 1:
                m ^= v
        return m

    def finish():
        pivots = sorted(basis)
        vecs = [basis[p] for p in pivots]
        orbit = []
        for j in range(1 << len(vecs)):
            acc = 0
            for i, v in enumerate(vecs):
                if (j >> i) & 1:
                    acc ^= v
            orbit.append(acc)
        subsets = []
        for t, b, _pbit, _wi in cur:
            m = (1 << t) | (1 << b)
            s = sum(1 << i for i, p in enumerate(pivots) if (m >> p) & 1)
            assert orbit[s] == m
            subsets.append(s)
        groups.append((tuple(cur), tuple(pivots), tuple(orbit),
                       tuple(subsets)))

    for e in entries:
        m = (1 << e[0]) | (1 << e[1])
        r = reduce(m)
        if cur and (len(cur) == CHAN_MAX_ENTRIES
                    or (r and len(basis) == CHAN_MAX_RANK)):
            finish()
            cur, basis = [], {}
            r = m
        if r:
            p = r.bit_length() - 1
            for q in basis:
                if (basis[q] >> p) & 1:
                    basis[q] ^= r
            basis[p] = r
        cur.append(e)
    if cur:
        finish()
    return groups


def _sweep_entry_plain(x, nn: int, t: int, b: int, tab):
    """One sweep entry on the whole state, as a new tensor: x * w1 +
    partner * w2, three roundings as K5 takes them."""
    lo, hi = min(t, b), max(t, b)
    v = x.reshape(2, 1 << (nn - 1 - hi), 2, 1 << (hi - 1 - lo), 2, 1 << lo)
    part = torch.flip(v, dims=(2, 4))
    w = torch.as_tensor(tab, device=x.device).reshape(2, 2, 2)  # [., kt, kb]
    w = w if t > b else w.transpose(1, 2)        # [., hi bit, lo bit]
    w1 = w[0].reshape(1, 1, 2, 1, 2, 1)
    w2 = w[1].reshape(1, 1, 2, 1, 2, 1)
    return (v * w1 + part * w2).reshape(x.shape)


def pair_channel_sweep_plain(amps, program, probs, *, num_bits: int):
    """The plain version of K5 (the reference's apply_pair_channel_sweep
    over _chan_sweep_kernel): the same sweeps, each entry applied to the
    whole state in order, in the state's type; a new tensor."""
    program = tuple(program)
    _check_sweep(program, probs, num_bits)
    wts = [channel_weights(kind, p, amps.dtype)
           for (kind, _t, _b), p in zip(program, probs)]
    x = amps
    for _b0, _k, entries in sweep_schedule(program, num_bits):
        for t, b, pbit, wi in entries:
            x = _sweep_entry_plain(x, num_bits, t, b, channel_entry_tables(
                wts[wi], pbit is not None))
    return x


def _chan_lib():
    """The kernel library with K5's entry declared."""
    if "chan" not in _BOUND:
        lib = build.library()
        ptr = ctypes.c_void_p
        lib.qt_chan_sweep_f32.argtypes = [
            ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr, ptr,
            ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
        lib.qt_chan_sweep_f32.restype = ctypes.c_int
        for name in ("qt_chan_max_rank", "qt_chan_max_entries",
                     "qt_chan_threads"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if (lib.qt_chan_max_rank(), lib.qt_chan_max_entries()) != (
                CHAN_MAX_RANK, CHAN_MAX_ENTRIES):
            raise RuntimeError("csrc/channels.cu and ops/fused.py disagree "
                               "on MAX_RANK / MAX_ENTRIES")
        _BOUND["chan"] = lib
        _BOUND["chan_threads"] = lib.qt_chan_threads()
    return _BOUND["chan"]


def _launch_chan(amps, nn: int, group, wts, nbank: int = 0) -> None:
    """One K5 launch over ``group`` (sweep_launch_groups), in place: on
    one register, or with ``nbank`` on a (B, 2, 2^nn) bank (one launch
    for every element, the same weights)."""
    entries, pivots, orbit, subsets = group
    lib = _chan_lib()
    r = len(pivots)
    i32 = np.int32
    piv = np.asarray(pivots, i32)
    orb = np.asarray(orbit, np.uint64)
    ts = np.asarray([e[0] for e in entries], i32)
    bs = np.asarray([e[1] for e in entries], i32)
    ss = np.asarray(subsets, i32)
    w = np.ascontiguousarray(np.stack([
        channel_entry_tables(wts[e[3]], e[2] is not None)
        for e in entries]), dtype=np.float32)
    threads = _BOUND["chan_threads"]
    sms = torch.cuda.get_device_properties(amps.device).multi_processor_count
    blocks = max(1, min(-(-(max(nbank, 1) << (nn - r)) // threads),
                        8 * sms))
    with build.launch_stream(amps) as stream:
        build.raise_on(lib.qt_chan_sweep_f32(
            amps.data_ptr(), 1 << nn, max(nbank, 1), r, piv.ctypes.data,
            orb.ctypes.data, len(entries), ts.ctypes.data, bs.ctypes.data,
            ss.ctypes.data, w.ctypes.data, blocks, stream),
            "apply_pair_channel_sweep")
    LAUNCHES["K5_bank" if nbank else "K5"] += 1


def apply_pair_channel_sweep(amps, program, probs, *, num_bits: int):
    """Run an ordered sequence of pair channels ``program`` = ((kind, t,
    b), ...) with probabilities ``probs`` in few passes (K5): every t, and
    every b below 14, under 14, and num_bits >= 15.  On the card the
    kernel overwrites the float32 state in place and returns it, one
    launch per group of sweep_launch_groups in each sweep of
    sweep_schedule; on a (B, 2, 2^num_bits) bank of density registers
    each launch takes every element, under the same probabilities (the
    reference's vmapped _chan_sweep_pass).  A CPU tensor takes the plain
    version (a new tensor; a bank element by element)."""
    program = tuple(program)
    nn = num_bits
    _check_sweep(program, probs, nn)
    nb = bank_size(amps, nn)
    if amps.device.type == "cpu":
        if nb:
            return torch.stack([pair_channel_sweep_plain(
                amps[b], program, probs, num_bits=nn) for b in range(nb)])
        return pair_channel_sweep_plain(amps, program, probs, num_bits=nn)
    if amps.device.type != "cuda":
        raise RuntimeError(f"apply_pair_channel_sweep: no kernel for device "
                           f"{amps.device}")
    if amps.dtype != torch.float32:
        raise TypeError(f"apply_pair_channel_sweep: state dtype {amps.dtype} "
                        "is not float32")
    if not amps.is_contiguous():
        raise ValueError("apply_pair_channel_sweep: the state must be "
                         "contiguous")
    if amps.numel() != max(nb, 1) * (2 << nn):
        raise ValueError(f"apply_pair_channel_sweep: a state of "
                         f"{tuple(amps.shape)} is not (2, 2^{nn})")
    wts = [channel_weights(kind, p, np.float32)
           for (kind, _t, _b), p in zip(program, probs)]
    for _b0, _k, entries in sweep_schedule(program, nn):
        for group in sweep_launch_groups(entries):
            _launch_chan(amps, nn, group, wts, nbank=nb)
    # the kernel wrote through the pointer: the tensor's version says so
    # (the OOM net reads it to refuse a retry on a changed state)
    torch.autograd.graph.increment_version(amps)
    return amps


def reset_launch_counts() -> None:
    """Set every kernel's launch count in ``LAUNCHES`` to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
