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

Beside each sits its plain PyTorch version (``window_pass_plain``,
``megawin_plain``): the wrappers run it for a tensor on the CPU, and
launch the kernel or raise for a tensor on the card.  Each wrapper counts
its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import os
from contextlib import contextmanager

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
LAUNCHES = {"K1": 0, "K2": 0}


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
        lib.qt_max_mega_passes.argtypes = []
        lib.qt_max_mega_passes.restype = ctypes.c_int
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


def reset_launch_counts() -> None:
    """Set both kernels' launch counts to 0."""
    LAUNCHES.update(K1=0, K2=0)
