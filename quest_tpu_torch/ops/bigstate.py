"""In-place kernels for states too large for out-of-place ops.

The counterpart of the JAX package's ``ops/bigstate.py``.  The QFT's final
bit reversal (agnostic_applyQFT's swap network, QuEST_common.c:836-898) is
a full-state permutation; as one out-of-place transpose it needs a second
state buffer.  The reference factors it, for a full run at 30-34 qubits,
as

    rev[0, n) = (within-group reversals) o sigma

for the palindromic group split (g, g, n-4g, g, g): the within-group
reversals are window passes (circuit._bit_reversal_big), and sigma, which
swaps amp bits [0, g) <-> [n-g, n) and [g, 2g) <-> [n-2g, n-g) (bits
[2g, n-2g) fixed), is an involution that runs in place.  The port runs
the whole of rev[0, n) as one in-place pass instead (K10's reversal form,
below): rev is an involution too, and on a tile the within-group
reversals are index arithmetic, not products.

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

K10's reversal form, ``apply_bit_reversal``, maps amp index i to
rev_n(i) in place (``sigma_swap_kernel<true>``).  Element (G2, G1, b, s,
l) of the same view pairs with (rev l, rev s, rev b, rev G1, rev G2):
slab (G1 = c, b, s = d) maps onto slab (rev d, rev b, rev c), its matrix
M[G2][l] onto M'[rev l][rev G2].  Over the row coordinate rev G2 that is
sigma's transpose again, so the kernel runs sigma's tiles with rows
addressed through a bit reversal, over the slab pairs c <= rev d
(``rev_pair_tables``) and every b; a pair with c == rev d keeps b <=
rev b, and a slab paired with itself only its tiles on and above the
diagonal.  Each element pair moves once: one read and one write of the
state.  Its plain version, ``bit_reversal_plain``, is one
``kernels.permute_qubits`` with the reversed qubit order.

A (B, 2, 2^n) register bank takes one launch for all its registers (the
reference's jax.vmap of ``_sigma_swap_jit``), in either form, the
register folded into the grid's z axis beside the kernel's b index.  No
public API sends a QFT into a bank drain, in either package: the path
that reaches the bank form is ``circuit.execute_plan`` on a bank (the
reference's vmapped plan executor) with the plan of
``circuit.bit_reversal_ops`` for n >= 30.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, fused, kernels

# launches of the kernel, counted where its wrapper launches it (over a
# register bank, one launch for the whole bank, under K10_bank; the
# reversal form under K10_rev and K10_rev_bank)
LAUNCHES = {"K10": 0, "K10_bank": 0, "K10_rev": 0, "K10_rev_bank": 0}
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


def rev_bits(v, bits: int):
    """The low ``bits`` bits of ``v`` (an int or an integer array) in
    reverse order."""
    out = v & 0
    for j in range(bits):
        out = out | (((v >> j) & 1) << (bits - 1 - j))
    return out


def rev_pair_tables(group_bits: int):
    """(ctab, dtab) int32 arrays enumerating the unordered slab pairs of
    the reversal form: (c, d) with c <= rev d, one entry per pair
    {(c, d), (rev d, rev c)}, the pairs with c == rev d included."""
    G = 1 << group_bits
    cs, ds = np.triu_indices(G)
    return (np.asarray(cs, np.int32),
            np.asarray(rev_bits(ds, group_bits), np.int32))


def reversal_perm(num_qubits: int) -> tuple:
    """The full bit reversal as a perm tuple for kernels.permute_qubits."""
    return tuple(range(num_qubits - 1, -1, -1))


def sigma_perm(num_qubits: int, group_bits: int) -> tuple:
    """The bit permutation sigma implements, as a perm tuple for
    kernels.permute_qubits (output qubit q holds input perm[q])."""
    n, g = num_qubits, group_bits
    perm = list(range(n))
    for j in range(g):
        perm[j], perm[n - g + j] = n - g + j, j
        perm[g + j], perm[n - 2 * g + j] = n - 2 * g + j, g + j
    return tuple(perm)


def _relabel_plain(amps, num_qubits: int, perm: tuple):
    """One out-of-place qubit relabel (a (B, 2, 2^n) bank element by
    element)."""
    if fused.bank_size(amps, num_qubits):
        return torch.stack([kernels.permute_qubits(
            a, num_qubits=num_qubits, perm=perm) for a in amps])
    return kernels.permute_qubits(amps, num_qubits=num_qubits, perm=perm)


def sigma_swap_plain(amps, *, num_qubits: int, group_bits: int = 7):
    """sigma as a new tensor: the plain version of K10, one qubit relabel
    out of place (a (B, 2, 2^n) bank element by element)."""
    return _relabel_plain(amps, num_qubits,
                          sigma_perm(num_qubits, group_bits))


def bit_reversal_plain(amps, *, num_qubits: int, group_bits: int = 7):
    """The full bit reversal as a new tensor: the plain version of K10's
    reversal form (``group_bits`` only shapes the kernel's tiles)."""
    return _relabel_plain(amps, num_qubits, reversal_perm(num_qubits))


def check_sigma_grid(num_qubits: int, group_bits: int, nbank: int,
                     name: str = "apply_sigma_swap") -> None:
    """Refuse a K10 launch (either form) whose grid z extent, max(B, 1) x
    2^(n - 4g), would exceed SIGMA_GRID_Z_MAX (csrc/qft.cu refuses it
    too)."""
    z = max(nbank, 1) << (num_qubits - 4 * group_bits)
    if z > SIGMA_GRID_Z_MAX:
        raise ValueError(
            f"{name}: {max(nbank, 1)} register(s) x "
            f"2^{num_qubits - 4 * group_bits} blocks exceed the kernel's "
            f"grid z limit of {SIGMA_GRID_Z_MAX}")


# qt_sigma_swap_f32 and qt_sigma_rev_f32: state, n, g, the pair tables,
# their length, bank size (1: one register), stream
SIGMA_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p)


def _lib():
    """The kernel library with the two K10 entries' signatures
    declared."""
    if "lib" not in _BOUND:
        lib = build.library()
        for entry in (lib.qt_sigma_swap_f32, lib.qt_sigma_rev_f32):
            entry.argtypes = list(SIGMA_ARGTYPES)
            entry.restype = ctypes.c_int
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _pair_tables_on(device, group_bits: int, reverse: bool):
    """The form's pair tables uploaded once per device and group width."""
    key = (str(device), group_bits, reverse)
    if key not in _PAIR_TABLES:
        tables = (rev_pair_tables if reverse else sigma_pair_tables)(
            group_bits)
        _PAIR_TABLES[key] = tuple(torch.as_tensor(t, device=device)
                                  for t in tables)
    return _PAIR_TABLES[key]


def _k10(amps, n: int, g: int, reverse: bool):
    """Check ``amps`` and run K10 in the form ``reverse`` names: the plain
    version for a CPU tensor, else the kernel in place."""
    name = "apply_bit_reversal" if reverse else "apply_sigma_swap"
    if g < 1 or 4 * g > n:
        raise ValueError(f"{name}: needs n >= 4*group_bits")
    nb = fused.bank_size(amps, n)
    if amps.numel() != max(nb, 1) * (2 << n):
        raise ValueError(f"{name}: a state of {tuple(amps.shape)} "
                         f"is not (2, 2^{n}) or a bank (B, 2, 2^{n})")
    check_sigma_grid(n, g, nb, name)
    if amps.device.type == "cpu":
        plain = bit_reversal_plain if reverse else sigma_swap_plain
        return plain(amps, num_qubits=n, group_bits=g)
    if amps.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {amps.device}")
    if amps.dtype != torch.float32:
        raise TypeError(f"{name}: state dtype {amps.dtype} is not float32")
    if not amps.is_contiguous():
        raise ValueError(f"{name}: the state must be contiguous")
    ctab, dtab = _pair_tables_on(amps.device, g, reverse)
    lib = _lib()
    entry = lib.qt_sigma_rev_f32 if reverse else lib.qt_sigma_swap_f32
    with build.launch_stream(amps) as stream:
        build.raise_on(entry(
            amps.data_ptr(), n, g, ctab.data_ptr(), dtab.data_ptr(),
            int(ctab.numel()), max(nb, 1), stream), name)
    LAUNCHES["K10" + ("_rev" if reverse else "")
             + ("_bank" if nb else "")] += 1
    # written in place through the pointer: bump the tensor's version
    torch.autograd.graph.increment_version(amps)
    return amps


def apply_sigma_swap(amps, *, num_qubits: int, group_bits: int = 7):
    """The involution sigma (K10).  Requires 4 * group_bits <= num_qubits.
    ``amps`` is one register's state or a (B, 2, 2^n) register bank (one
    launch for the bank).  On the card the kernel overwrites the input in
    place and returns it (one read and one write of the state, nothing
    allocated beside it); a CPU tensor takes the plain version, which
    returns a new tensor."""
    return _k10(amps, num_qubits, group_bits, reverse=False)


def apply_bit_reversal(amps, *, num_qubits: int, group_bits: int = 7):
    """The full bit reversal, amp index i to rev_n(i) (K10's reversal
    form), under the same requirements, checks and bank form as
    ``apply_sigma_swap``: in place on the card, one read and one write of
    the state; the plain version for a CPU tensor."""
    return _k10(amps, num_qubits, group_bits, reverse=True)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts to 0."""
    LAUNCHES.update(K10=0, K10_bank=0, K10_rev=0, K10_rev_bank=0)
