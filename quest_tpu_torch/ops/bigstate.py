"""In-place kernels for states too large for out-of-place ops.

The counterpart of the JAX package's ``ops/bigstate.py``.  The QFT's final
bit reversal (agnostic_applyQFT's swap network, QuEST_common.c:836-898) is
a full-state permutation; as one out-of-place transpose it needs a second
state buffer.  For a full run at 30-34 qubits the planner factors it as

    rev[0, n) = (within-group reversals) o sigma

for the palindromic group split (g, g, n-4g, g, g): the within-group
reversals are window passes (circuit._bit_reversal_big), and sigma, which
swaps amp bits [0, g) <-> [n-g, n) and [g, 2g) <-> [n-2g, n-g) (bits
[2g, n-2g) fixed), is an involution that runs in place.

Why sigma is blockable in place: fix (G1 = c, s = d) of the view
[ch, G2, G1, b, s, l] and let (G2, l) range: that slab (c, d) is a G x G
matrix, and sigma maps it onto slab (d, c) transposed.  Slabs pair up
under sigma, so a kernel can stage two tiles, transpose them and write
them back swapped: each element moves once, and no second buffer is
needed.

K10, ``apply_sigma_swap``, runs it on the card as a hand-written CUDA
kernel (``csrc/qft.cu`` ``sigma_swap_kernel``; replaces the Pallas kernel
quest_tpu/ops/bigstate.py ``_sigma_swap_jit``).  Its plain version,
``sigma_swap_plain``, is the same permutation as one out-of-place qubit
relabel (``kernels.permute_qubits``); the wrapper runs it for a tensor on
the CPU and launches the kernel or raises for a tensor on the card.

A (B, 2, 2^n) register bank takes one launch for all its registers (the
reference's jax.vmap of ``_sigma_swap_jit``), the register folded into
the grid's z axis beside the kernel's b index.  No public API sends a QFT
into a bank drain, in either package: the path that reaches the bank
form is ``circuit.execute_plan`` on a bank (the reference's vmapped plan
executor) with the plan of ``circuit.bit_reversal_ops`` for n >= 30.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, fused, kernels

# launches of the kernel, counted where its wrapper launches it (over a
# register bank, one launch for the whole bank, under K10_bank)
LAUNCHES = {"K10": 0, "K10_bank": 0}
# the kernel's grid z extent, bank size x 2^(n - 4g), is at most the
# card's limit on grid z
SIGMA_GRID_Z_MAX = 65535
_BOUND: dict = {}
_PAIR_TABLES: dict = {}


def sigma_pair_tables(group_bits: int):
    """(ctab, dtab) int32 arrays enumerating the unordered slab pairs
    (c, d), c <= d, diagonal included: one entry per pair sigma swaps."""
    G = 1 << group_bits
    cs, ds = np.triu_indices(G)
    return (np.asarray(cs, np.int32), np.asarray(ds, np.int32))


def sigma_perm(num_qubits: int, group_bits: int) -> tuple:
    """The bit permutation sigma implements, as a perm tuple for
    kernels.permute_qubits (output qubit q holds input perm[q])."""
    n, g = num_qubits, group_bits
    perm = list(range(n))
    for j in range(g):
        perm[j], perm[n - g + j] = n - g + j, j
        perm[g + j], perm[n - 2 * g + j] = n - 2 * g + j, g + j
    return tuple(perm)


def sigma_swap_plain(amps, *, num_qubits: int, group_bits: int = 7):
    """sigma as a new tensor: the plain version of K10, one qubit relabel
    out of place (a (B, 2, 2^n) bank element by element)."""
    perm = sigma_perm(num_qubits, group_bits)
    if fused.bank_size(amps, num_qubits):
        return torch.stack([kernels.permute_qubits(
            a, num_qubits=num_qubits, perm=perm) for a in amps])
    return kernels.permute_qubits(amps, num_qubits=num_qubits, perm=perm)


def check_sigma_grid(num_qubits: int, group_bits: int, nbank: int) -> None:
    """Refuse a sigma swap whose grid z extent, max(B, 1) x
    2^(n - 4g), would exceed SIGMA_GRID_Z_MAX (csrc/qft.cu refuses it
    too)."""
    z = max(nbank, 1) << (num_qubits - 4 * group_bits)
    if z > SIGMA_GRID_Z_MAX:
        raise ValueError(
            f"apply_sigma_swap: {max(nbank, 1)} register(s) x "
            f"2^{num_qubits - 4 * group_bits} blocks exceed the kernel's "
            f"grid z limit of {SIGMA_GRID_Z_MAX}")


# qt_sigma_swap_f32: state, n, g, the pair tables, their length, bank
# size (1: one register), stream
SIGMA_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p)


def _lib():
    """The kernel library with the sigma entry's signature declared."""
    if "lib" not in _BOUND:
        lib = build.library()
        ptr = ctypes.c_void_p
        lib.qt_sigma_swap_f32.argtypes = list(SIGMA_ARGTYPES)
        lib.qt_sigma_swap_f32.restype = ctypes.c_int
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _pair_tables_on(device, group_bits: int):
    """sigma_pair_tables uploaded once per device and group width."""
    key = (str(device), group_bits)
    if key not in _PAIR_TABLES:
        _PAIR_TABLES[key] = tuple(torch.as_tensor(t, device=device)
                                  for t in sigma_pair_tables(group_bits))
    return _PAIR_TABLES[key]


def apply_sigma_swap(amps, *, num_qubits: int, group_bits: int = 7):
    """The involution sigma (K10).  Requires 4 * group_bits <= num_qubits.
    ``amps`` is one register's state or a (B, 2, 2^n) register bank (one
    launch for the bank).  On the card the kernel overwrites the input in
    place and returns it (one read and one write of the state, nothing
    allocated beside it); a CPU tensor takes the plain version, which
    returns a new tensor."""
    n, g = num_qubits, group_bits
    if g < 1 or 4 * g > n:
        raise ValueError("sigma swap needs n >= 4*group_bits")
    nb = fused.bank_size(amps, n)
    if amps.numel() != max(nb, 1) * (2 << n):
        raise ValueError(f"apply_sigma_swap: a state of {tuple(amps.shape)} "
                         f"is not (2, 2^{n}) or a bank (B, 2, 2^{n})")
    check_sigma_grid(n, g, nb)
    if amps.device.type == "cpu":
        return sigma_swap_plain(amps, num_qubits=n, group_bits=g)
    if amps.device.type != "cuda":
        raise RuntimeError(f"apply_sigma_swap: no kernel for device "
                           f"{amps.device}")
    if amps.dtype != torch.float32:
        raise TypeError(f"apply_sigma_swap: state dtype {amps.dtype} is not "
                        "float32")
    if not amps.is_contiguous():
        raise ValueError("apply_sigma_swap: the state must be contiguous")
    ctab, dtab = _pair_tables_on(amps.device, g)
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(_lib().qt_sigma_swap_f32(
        amps.data_ptr(), n, g, ctab.data_ptr(), dtab.data_ptr(),
        int(ctab.numel()), max(nb, 1), stream), "apply_sigma_swap")
    LAUNCHES["K10_bank" if nb else "K10"] += 1
    # written in place through the pointer: bump the tensor's version
    torch.autograd.graph.increment_version(amps)
    return amps


def reset_launch_counts() -> None:
    """Set the kernel's launch counts to 0."""
    LAUNCHES.update(K10=0, K10_bank=0)
