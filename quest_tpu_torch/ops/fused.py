"""Fused window passes: many gates, one pass over the state.

The circuit planner (circuit.py) folds a whole run of gates into
``("winfused", k, A, B, apply_a, apply_b, mask)`` passes: the rank-R
operator ``[mask (.)] sum_r B_r (x) A_r`` with A_r on the lane qubits
[0, 7) and B_r on the window qubits [k, k+7), 7 <= k <= n-7.  Runs of such
passes whose windows fit inside 2^g consecutive canonical 128 x 128 rows
(k <= 7 + g) are grouped into ``("megawin", (passes...))`` ops.

Two hand-written CUDA kernels (``csrc/window.cu``) execute them on the
card, built with nvcc at first use (``ops/build.py``) and bound through
ctypes:

* K1, ``apply_window_stack``: one pass (replaces the Pallas kernel
  quest_tpu/ops/fused.py ``_apply_window_stack_jit``);
* K2, ``apply_window_megastack``: a megawin group in one launch, a
  persistent grid of thread-block clusters that take super-blocks in turn
  (replaces ``_apply_megawin_jit``), bit-identical to its passes run one
  by one through K1.

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


def set_matmul_precision(name: str) -> None:
    """The window kernels compute in full FP32 / FP64 ("highest").  The
    reference's "bf16_3x" and "default" modes belong to the tensor-core
    redesign of K1 (ROADMAP Queue 2, K1 follow-up) and raise here."""
    if name != "highest":
        raise NotImplementedError(
            f"matmul precision {name!r} is not ported: quest_tpu_torch runs "
            "the window kernels in full precision only (ROADMAP Queue 2, "
            "K1 follow-up: tensor-core split products)")


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
    output and in one scratch buffer of its cluster, served by the 50 MB
    L2; a cluster holds two G-row buffers in flight (input and output of
    a pass, G * 128 KB each at f32), and tens of clusters run at once, so
    G = 8 (2 MB per cluster) is the largest grouping whose working set
    can stay near L2 size.  The rank does not change the kernel's working
    set (shared memory per CTA is rank-independent)."""
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
    slab (B-only / A-only drop a side).  Same function as K1."""
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
        else:
            y = torch.einsum("hwml,rpl->hwmp", x, a)
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


def cluster_stack_plain(amps, mats_a, mats_b, *, num_qubits: int):
    """The cluster pass in plain PyTorch: ``window_pass_plain`` at k = 7,
    dual-sided, with no mask.  Same function as K11."""
    _check_cluster(num_qubits, mats_a, mats_b, "apply_cluster_stack")
    return window_pass_plain(amps, mats_a, mats_b, None,
                             num_qubits=num_qubits, k=SUBLANE_QUBITS)


def swap_cluster_stack_plain(amps, mats_a, mats_b, *, num_qubits: int,
                             h: int, b: int, m: int):
    """The fused swap + cluster pass in plain PyTorch: the segment swap
    [h, h+m) <-> [b, b+m) (``kernels.swap_bit_segments``), then
    ``cluster_stack_plain``.  Same function as K12."""
    from . import kernels

    _check_cluster(num_qubits, mats_a, mats_b, "apply_swap_cluster_stack")
    _check_swap(num_qubits, h, b, m)
    swapped = kernels.swap_bit_segments(amps, num_qubits=num_qubits, a=h,
                                        b=b, m=m)
    return cluster_stack_plain(swapped, mats_a, mats_b,
                               num_qubits=num_qubits)


def megawin_plain(amps, subops, *, num_qubits: int):
    """A megawin group in plain PyTorch: its passes one after another
    over the whole state (the same function K2 computes super-block by
    super-block)."""
    for op in subops:
        amps = window_pass_plain(
            amps, op[2], op[3], op[6] if len(op) > 6 else None,
            num_qubits=num_qubits, k=op[1], apply_a=op[4], apply_b=op[5])
    return amps


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------


class _QtPass(ctypes.Structure):
    """csrc/window.cu ``struct QtPass``."""

    _fields_ = [("k", ctypes.c_int), ("rank", ctypes.c_int),
                ("apply_a", ctypes.c_int), ("apply_b", ctypes.c_int),
                ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("mask", ctypes.c_void_p)]


_BOUND: dict = {}
# launches of each kernel, counted where its wrapper launches it
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0, "K6": 0, "K7": 0, "K8": 0, "K9": 0,
            "K11": 0, "K12": 0}


def _lib():
    """The kernel library with the window entries' signatures declared."""
    if "lib" not in _BOUND:
        lib = build.library()
        ptr = ctypes.c_void_p
        p_pass = ctypes.POINTER(_QtPass)
        for name in ("qt_window_pass_f32", "qt_window_pass_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ctypes.c_int, p_pass, ptr]
            fn.restype = ctypes.c_int
        for name in ("qt_megawin_f32", "qt_megawin_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, p_pass,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        for name in ("qt_megawin_max_clusters_f32",
                     "qt_megawin_max_clusters_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        for name in ("qt_swap_cluster_stack_f32",
                     "qt_swap_cluster_stack_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr, ptr,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
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


def _pass_struct(op, amps, keep: list) -> _QtPass:
    """ctypes pass descriptor for ("winfused", k, A, B, apply_a, apply_b
    [, mask]); the uploaded operands are appended to ``keep`` so they
    outlive the launch call."""
    a = _as_operand(op[2], amps)
    b = _as_operand(op[3], amps)
    mask = op[6] if len(op) > 6 else None
    rank = int(a.shape[0])
    if a.shape != (rank, 2, CLUSTER_DIM, CLUSTER_DIM) or b.shape != a.shape:
        raise ValueError(f"window pass matrices must be (R, 2, 128, 128), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    m = None
    if mask is not None:
        m = _as_operand(mask, amps)
        if m.shape != (2, CLUSTER_DIM, CLUSTER_DIM):
            raise ValueError(f"window mask must be (2, 128, 128), got "
                             f"{tuple(m.shape)}")
        keep.append(m)
    keep += [a, b]
    return _QtPass(int(op[1]), rank, int(bool(op[4])), int(bool(op[5])),
                   a.data_ptr(), b.data_ptr(),
                   None if m is None else m.data_ptr())


def apply_window_stack(amps, mats_a, mats_b, mask=None, *, num_qubits: int,
                       k: int = SUBLANE_QUBITS, apply_a: bool = True,
                       apply_b: bool = True):
    """One window pass (K1).  ``amps`` is any full-size contiguous view of
    the state ((2, 2^n) or the canonical (2, nb, 128, 128)); the result is
    a new tensor of the same shape.  CPU tensors take the plain version."""
    n = num_qubits
    _check_offset(n, k)
    if not (apply_a or apply_b):
        raise ValueError("a window pass needs at least one side")
    if amps.device.type == "cpu":
        return window_pass_plain(amps, mats_a, mats_b, mask, num_qubits=n,
                                 k=k, apply_a=apply_a, apply_b=apply_b)
    if amps.device.type != "cuda":
        raise RuntimeError(f"apply_window_stack: no kernel for device "
                           f"{amps.device}")
    _check_cuda_state(amps, "apply_window_stack")
    keep: list = []
    desc = _pass_struct(("winfused", k, mats_a, mats_b, apply_a, apply_b,
                         mask), amps, keep)
    out = torch.empty_like(amps)
    fn = (_lib().qt_window_pass_f32 if amps.dtype == torch.float32
          else _lib().qt_window_pass_f64)
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(fn(amps.data_ptr(), out.data_ptr(), n,
                      ctypes.byref(desc), stream), "apply_window_stack")
    LAUNCHES["K1"] += 1
    return out


def _cluster_launch(amps, mats_a, mats_b, n: int, what: str):
    """Checks and uploads shared by K11 and K12: the output buffer, the
    side stacks on the card, the rank and the stream."""
    if amps.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {amps.device}")
    _check_cuda_state(amps, what)
    if amps.numel() != 2 << n:
        raise ValueError(f"{what}: a state of {amps.numel()} reals is not "
                         f"one of {n} qubits")
    a = _as_operand(mats_a, amps)
    b = _as_operand(mats_b, amps)
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    return torch.empty_like(amps), a, b, int(a.shape[0]), stream


def apply_cluster_stack(amps, mats_a, mats_b, *, num_qubits: int):
    """The paged planner's cluster pass (K11): sum_r B_r X A_r^T on each
    128 x 128 slab of the canonical view, A_r on the lane qubits [0, 7),
    B_r on [7, 14); ``mats_a``/``mats_b`` are SoA (R, 2, 128, 128).
    ``amps`` is any full-size contiguous view of the state; the result is
    a new tensor of the same shape.  CPU tensors take the plain
    version."""
    n = num_qubits
    _check_cluster(n, mats_a, mats_b, "apply_cluster_stack")
    if amps.device.type == "cpu":
        return cluster_stack_plain(amps, mats_a, mats_b, num_qubits=n)
    out, a, b, rank, stream = _cluster_launch(amps, mats_a, mats_b, n,
                                              "apply_cluster_stack")
    # K1's kernel at k = 7, dual-sided, unmasked
    desc = _QtPass(SUBLANE_QUBITS, rank, 1, 1, a.data_ptr(), b.data_ptr(),
                   None)
    fn = (_lib().qt_window_pass_f32 if amps.dtype == torch.float32
          else _lib().qt_window_pass_f64)
    build.raise_on(fn(amps.data_ptr(), out.data_ptr(), n,
                      ctypes.byref(desc), stream), "apply_cluster_stack")
    LAUNCHES["K11"] += 1
    return out


def apply_cluster_pair(amps, mat_a, mat_b, *, num_qubits: int):
    """One cluster pair: SoA (2, 128, 128) lane and window matrices,
    stacked to rank 1 and run through ``apply_cluster_stack`` (K11)."""
    return apply_cluster_stack(amps, mat_a[None], mat_b[None],
                               num_qubits=num_qubits)


def apply_swap_cluster_stack(amps, mats_a, mats_b, *, num_qubits: int,
                             h: int, b: int, m: int):
    """The segment swap [h, h+m) <-> [b, b+m) followed by the rank-R
    cluster operator, in one pass (K12): h >= 14, 7 <= b, b + m <= 14,
    m <= MAX_FUSED_SWAP_M.  The result is a new tensor of the input's
    shape.  CPU tensors take the plain version."""
    n = num_qubits
    _check_cluster(n, mats_a, mats_b, "apply_swap_cluster_stack")
    _check_swap(n, h, b, m)
    if amps.device.type == "cpu":
        return swap_cluster_stack_plain(amps, mats_a, mats_b, num_qubits=n,
                                        h=h, b=b, m=m)
    out, a, bm, rank, stream = _cluster_launch(amps, mats_a, mats_b, n,
                                               "apply_swap_cluster_stack")
    fn = (_lib().qt_swap_cluster_stack_f32 if amps.dtype == torch.float32
          else _lib().qt_swap_cluster_stack_f64)
    build.raise_on(fn(amps.data_ptr(), out.data_ptr(), n, rank,
                      a.data_ptr(), bm.data_ptr(), h, b, m, stream),
                   "apply_swap_cluster_stack")
    LAUNCHES["K12"] += 1
    return out


_MAX_CLUSTERS: dict = {}


def _megawin_clusters(amps, g: int) -> int:
    """K2's persistent grid for super-blocks of ``g`` rows: as many
    clusters as the card holds at once, and no more than there are
    super-blocks."""
    key = (amps.device.index, amps.dtype, g)
    if key not in _MAX_CLUSTERS:
        fn = (_lib().qt_megawin_max_clusters_f32
              if amps.dtype == torch.float32
              else _lib().qt_megawin_max_clusters_f64)
        count = ctypes.c_int(0)
        with torch.cuda.device(amps.device):
            build.raise_on(fn(g, ctypes.byref(count)),
                           "apply_window_megastack")
        if count.value < 1:
            raise RuntimeError(f"apply_window_megastack: the card holds no "
                               f"cluster for super-blocks of {g} rows")
        _MAX_CLUSTERS[key] = count.value
    nb = amps.numel() // (2 * CLUSTER_DIM * CLUSTER_DIM)
    return min(_MAX_CLUSTERS[key], nb // g)


def apply_window_megastack(amps, subops, *, num_qubits: int):
    """A planned megawin group — ``subops`` is a sequence of ("winfused",
    k, A, B, apply_a, apply_b[, mask]) tuples — in ONE launch (K2).  The
    result is a new tensor of the input's shape; every other pass goes
    through a scratch of one super-block per resident cluster, not
    through a full-size buffer.  CPU tensors take the plain version."""
    n = num_qubits
    for op in subops:
        _check_offset(n, int(op[1]))
    kmax = max(int(op[1]) for op in subops)
    if (1 << (kmax - LANE_QUBITS)) > (1 << (n - CLUSTER_QUBITS)):
        raise ValueError(f"megawin window offsets out of range for n={n}")
    if amps.device.type == "cpu":
        return megawin_plain(amps, subops, num_qubits=n)
    if amps.device.type != "cuda":
        raise RuntimeError(f"apply_window_megastack: no kernel for device "
                           f"{amps.device}")
    _check_cuda_state(amps, "apply_window_megastack")
    if not 1 <= len(subops) <= MAX_MEGA_PASSES:
        raise ValueError(f"a megawin group holds 1..{MAX_MEGA_PASSES} "
                         f"passes, got {len(subops)}")
    keep: list = []
    descs = (_QtPass * len(subops))(
        *[_pass_struct(op, amps, keep) for op in subops])
    g = 1 << (kmax - LANE_QUBITS)
    clusters = _megawin_clusters(amps, g)
    out = torch.empty_like(amps)
    scratch = None
    if len(subops) > 1:
        scratch = torch.empty(clusters * 2 * g * CLUSTER_DIM * CLUSTER_DIM,
                              dtype=amps.dtype, device=amps.device)
    fn = (_lib().qt_megawin_f32 if amps.dtype == torch.float32
          else _lib().qt_megawin_f64)
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(fn(amps.data_ptr(), out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      clusters, n, descs, len(subops), stream),
                   "apply_window_megastack")
    LAUNCHES["K2"] += 1
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
    stream = torch.cuda.current_stream(amps.device).cuda_stream
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
    stream = torch.cuda.current_stream(amps.device).cuda_stream
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
                                 radix: int = QFT_RADIX_DEFAULT):
    """Ladder layers t = t_top .. 7 (descending) through the multilayer
    kernels: chunks of ``radix`` layers (clamped to 1..5) for t >= 14 (K8),
    then one pass of the seven sublane layers (K9).  Requires t_top >= 13
    and num_qubits >= 15."""
    if t_top < CLUSTER_QUBITS - 1:
        raise ValueError("apply_qft_multilayer_ladders needs t_top >= 13 "
                         "(the cluster pass applies ALL sublane layers)")
    radix = max(1, min(5, int(radix)))
    t = t_top
    while t >= CLUSTER_QUBITS:
        t_lo = max(CLUSTER_QUBITS, t - radix + 1)
        amps = apply_qft_multi_hi(amps, num_qubits=num_qubits, t_hi=t,
                                  t_lo=t_lo)
        t = t_lo - 1
    return apply_qft_cluster_multi(amps, num_qubits=num_qubits)


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
            ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr, ctypes.c_int,
            ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
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


def _launch_chan(amps, nn: int, group, wts) -> None:
    """One K5 launch over ``group`` (sweep_launch_groups), in place."""
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
    blocks = max(1, min(-(-(1 << (nn - r)) // threads), 8 * sms))
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(lib.qt_chan_sweep_f32(
        amps.data_ptr(), 1 << nn, r, piv.ctypes.data, orb.ctypes.data,
        len(entries), ts.ctypes.data, bs.ctypes.data, ss.ctypes.data,
        w.ctypes.data, blocks, stream), "apply_pair_channel_sweep")
    LAUNCHES["K5"] += 1


def apply_pair_channel_sweep(amps, program, probs, *, num_bits: int):
    """Run an ordered sequence of pair channels ``program`` = ((kind, t,
    b), ...) with probabilities ``probs`` in few passes (K5): every t, and
    every b below 14, under 14, and num_bits >= 15.  On the card the
    kernel overwrites the float32 state in place and returns it, one
    launch per group of sweep_launch_groups in each sweep of
    sweep_schedule; a CPU tensor takes the plain version (a new
    tensor)."""
    program = tuple(program)
    nn = num_bits
    _check_sweep(program, probs, nn)
    if amps.device.type == "cpu":
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
    if amps.numel() != 2 << nn:
        raise ValueError(f"apply_pair_channel_sweep: a state of "
                         f"{tuple(amps.shape)} is not (2, 2^{nn})")
    wts = [channel_weights(kind, p, np.float32)
           for (kind, _t, _b), p in zip(program, probs)]
    for _b0, _k, entries in sweep_schedule(program, nn):
        for group in sweep_launch_groups(entries):
            _launch_chan(amps, nn, group, wts)
    return amps


def reset_launch_counts() -> None:
    """Set every kernel's launch count in ``LAUNCHES`` to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
