"""State-vector operations as plain PyTorch tensor code.

The counterpart of the JAX package's ``ops/kernels.py``: dense gates with
controls, multi-qubit NOT, qubit relabelling, bit-segment swaps, index
permutations and the initial states.  A state of n qubits is a real SoA
tensor ``(2, 2^n)``; qubit q is bit q of the flat index (little-endian),
so a gate on targets T is a reshape into one small axis per touched bit
plus one large axis per contiguous gap of untouched bits, an axis
permutation and a small complex matrix product.  Views stay low-rank
(O(k) axes for a k-qubit gate, never O(n)).

These ops are memory-bound and run once per eager gate or permutation
window; the fused window passes, which carry the dense work of a
circuit, are the hand-written kernels in ``ops/fused.py``.

Every function returns a new tensor of the input's shape and leaves its
input as it was, except ``apply_qft_ladder`` where it takes the QFT
ladder kernels (a float32 state on the card), which work in place.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import cplx, fused

# States with n >= _BIG_N extend a gather field that reaches below the
# 128-lane block down to bit 0 (apply_index_permutation), as the JAX
# package does: the result is the same, the rule is kept so both packages
# view the state identically.
_LANE_BITS = 7
_BIG_N = 14

# Past this many coalesced bit runs a relabel is decomposed into pairwise
# swaps, each a rank-6 transpose.
_MAX_TRANSPOSE_RANK = 16

# Gather field width cap for apply_index_permutation: past this extent the
# op falls back to the exact 0/1 permutation matrix.
_GATHER_FIELD_MAX_BITS = 16


def _interleaved(n: int, bits):
    """Shape splitting the flat 2^n axis at each bit (channel axis first).

    Returns (shape, axis_of): ``shape`` interleaves gap axes with one
    size-2 axis per bit in ``bits`` (any order; sorted internally);
    ``axis_of[b]`` is the index of bit b's size-2 axis."""
    bits_desc = sorted(bits, reverse=True)
    shape = [2]
    axis_of = {}
    prev = n
    for b in bits_desc:
        shape.append(1 << (prev - 1 - b))
        axis_of[b] = len(shape)
        shape.append(2)
        prev = b
    shape.append(1 << prev)
    return tuple(shape), axis_of


def _control_view(amps, n: int, targets, controls, control_states):
    """(view, sel, target_axes): the interleaved view of the state, the
    index selecting the controlled subspace, and each target's axis in
    ``view[sel]`` (control axes are removed by the integer selectors)."""
    states = tuple(control_states) or (1,) * len(controls)
    shape, axis_of = _interleaved(n, tuple(targets) + tuple(controls))
    view = amps.reshape(shape)
    sel = [slice(None)] * len(shape)
    for c, s in zip(controls, states):
        sel[axis_of[c]] = int(s)
    ctrl_axes = [axis_of[c] for c in controls]

    def sub_axis(a):
        return a - sum(1 for ca in ctrl_axes if ca < a)

    return view, tuple(sel), [sub_axis(axis_of[t]) for t in targets]


def _update_subspace(amps, n, targets, controls, control_states, body):
    """Apply ``body(sub, target_axes)`` to the controlled subspace and
    return the new state (a fresh tensor)."""
    view, sel, taxes = _control_view(amps, n, targets, controls,
                                     control_states)
    sub = view[sel]
    new = body(sub, taxes)
    if not controls:
        return new.reshape(amps.shape)
    out = view.clone()
    out[sel] = new
    return out.reshape(amps.shape)


def _matmul_on_axes(sub, taxes, mat):
    """Complex matrix ``mat`` (stacked SoA (2, d, d)) on the size-2 axes
    ``taxes`` of ``sub``; taxes[0] is the least-significant matrix bit."""
    k = len(taxes)
    order = [0] + [taxes[j] for j in reversed(range(k))]
    rest = [a for a in range(sub.dim()) if a not in order]
    perm = order + rest
    x = sub.permute(perm)
    pshape = x.shape
    x = x.reshape(2, 1 << k, -1)
    y = cplx.to_complex(mat) @ cplx.to_complex(x)
    y = cplx.from_complex(y).reshape(pshape)
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return y.permute(inv)


def apply_matrix(amps, matrix, *, num_qubits: int, targets: Tuple[int, ...],
                 controls: Tuple[int, ...] = (),
                 control_states: Tuple[int, ...] = ()):
    """A dense 2^k x 2^k matrix on ``targets`` (targets[0] = least
    significant matrix bit), optionally controlled (control_states default
    to 1).  ``matrix`` is stacked SoA (2, 2^k, 2^k).  Covers the
    reference's unitary/compactUnitary/twoQubitUnitary/multiQubitUnitary
    and the multi(State)Controlled variants (QuEST_cpu.c:1743-1985)."""
    m = torch.as_tensor(np.asarray(matrix) if not torch.is_tensor(matrix)
                        else matrix, dtype=amps.dtype, device=amps.device)
    return _update_subspace(
        amps, num_qubits, tuple(targets), tuple(controls), control_states,
        lambda sub, taxes: _matmul_on_axes(sub, taxes, m))


def apply_diagonal(amps, diag, *, num_qubits: int, targets: Tuple[int, ...],
                   controls: Tuple[int, ...] = (),
                   control_states: Tuple[int, ...] = ()):
    """Multiply amplitudes by ``diag[bits(targets)]`` (stacked SoA (2,
    2^k)), optionally controlled — the phase-only family
    (QuEST_cpu.c:3146-3361)."""
    d = torch.as_tensor(np.asarray(diag) if not torch.is_tensor(diag)
                        else diag, dtype=amps.dtype, device=amps.device)
    k = len(targets)

    def body(sub, taxes):
        # factor laid out on the target axes: axis of targets[j] carries
        # bit j of the diagonal index
        fshape = [1] * (sub.dim() - 1)
        dv = d.reshape((2,) + (2,) * k)          # axis 1+i <-> bit k-1-i
        src = [1 + (k - 1 - j) for j in range(k)]
        order = sorted(range(k), key=lambda j: taxes[j])
        dv = dv.permute([0] + [src[j] for j in order])
        for j in order:
            fshape[taxes[j] - 1] = 2
        f_re = dv[0].reshape(fshape)
        f_im = dv[1].reshape(fshape)
        return cplx.cmul(sub, f_re, f_im)

    return _update_subspace(amps, num_qubits, tuple(targets),
                            tuple(controls), control_states, body)


def _parity_of(n_bits: int, qubits, device):
    """(2^n_bits,) int64 parity of the bits ``qubits`` of each index."""
    idx = torch.arange(1 << n_bits, device=device)
    par = torch.zeros_like(idx)
    for q in qubits:
        par ^= (idx >> q) & 1
    return par


def parity_sign_factors(n: int, qubits, dtype, device, lo: int = -1):
    """Row (2^(n-lo), 1) and lane (1, 2^lo) factors of (-1)^parity(bits in
    ``qubits``) over n index bits: the parity of an index is the XOR of
    its row part's and its lane part's, so the sign is their product (the
    reference's bit-parity sign trick, QuEST_cpu.c:3268-3275).  ``lo``
    defaults to n // 2."""
    lo = n // 2 if lo < 0 else lo
    s_row = 1 - 2 * _parity_of(n - lo, [q - lo for q in qubits if q >= lo],
                               device)
    s_lane = 1 - 2 * _parity_of(lo, [q for q in qubits if q < lo], device)
    return s_row.to(dtype)[:, None], s_lane.to(dtype)[None, :]


def parity_sign_2d(n: int, qubits, dtype, device):
    """(2^hi, 2^lo) tensor of (-1)^parity(bits in ``qubits``), hi = n - lo,
    lo = n // 2: the outer product of parity_sign_factors.  Callers view
    the state as (2, 2^hi, 2^lo)."""
    s_row, s_lane = parity_sign_factors(n, qubits, dtype, device)
    return s_row * s_lane


def parity_sign_flat(n: int, qubits, dtype, device):
    """(2^n,) sign vector (-1)^parity(bits in ``qubits``)."""
    return parity_sign_2d(n, qubits, dtype, device).reshape(-1)


def _split2(n: int):
    """(hi_bits, lo_bits) split of n index bits: the (2^hi, 2^lo) view
    that parity_sign_2d and bit_2d broadcast over."""
    lo = n // 2
    return n - lo, lo


def bit_2d(n: int, q: int, device):
    """Per-amplitude value (int64 0/1) of bit q, broadcastable over the
    (2^hi, 2^lo) = _split2(n) view of the state: (1, 2^lo) for a lane-half
    bit, (2^hi, 1) for a row-half bit."""
    hi, lo = _split2(n)
    if q < lo:
        return ((torch.arange(1 << lo, device=device) >> q) & 1)[None, :]
    return ((torch.arange(1 << hi, device=device) >> (q - lo)) & 1)[:, None]


def _flip_bits_flat(amps, n: int, targets):
    """X on each target bit: the index-space reversal of each target's
    size-2 axis of the interleaved view, as a new (2, 2^n) tensor.  The
    JAX package splits this into a lane matmul and half-swaps for
    n >= 14 to keep its TPU layout; the permutation is the same."""
    if not targets:
        return amps
    shape, axis_of = _interleaved(n, targets)
    view = amps.reshape(shape)
    return torch.flip(view, dims=[axis_of[t] for t in targets]).reshape(2, -1)


def apply_parity_phase(amps, theta, *, num_qubits: int,
                       qubits: Tuple[int, ...], controls: Tuple[int, ...] = (),
                       control_states: Tuple[int, ...] = ()):
    """exp(-i theta/2 * Z x Z ... Z) over a qubit subset, optionally
    controlled — reference multiRotateZ / multiControlledMultiRotateZ
    (QuEST_cpu.c:3268-3361).  A controlled phase runs on the controlled
    subspace, flattened, with the targets renumbered past the removed
    control bits."""
    n = num_qubits
    ang = torch.tensor(-0.5 * float(theta), dtype=torch.float64).to(
        amps.dtype)
    co, si = torch.cos(ang).item(), torch.sin(ang).item()
    if not controls:
        s = parity_sign_2d(n, qubits, amps.dtype, amps.device)
        view = amps.reshape(2, *s.shape)
        return cplx.cmul(view, co, si * s).reshape(amps.shape)
    sub_qubits = tuple(q - sum(1 for c in controls if c < q) for q in qubits)
    sub_n = n - len(controls)

    def body(sub, _taxes):
        s = parity_sign_flat(sub_n, sub_qubits, amps.dtype, amps.device)
        flat = sub.reshape(2, -1)
        return cplx.cmul(flat, co, si * s).reshape(sub.shape)

    return _update_subspace(amps, n, tuple(qubits), tuple(controls),
                            control_states, body)


def apply_multi_qubit_not(amps, *, num_qubits: int, targets: Tuple[int, ...],
                          controls: Tuple[int, ...] = (),
                          control_states: Tuple[int, ...] = ()):
    """X on several targets at once (reference
    multiControlledMultiQubitNot, QuEST.h:2914): an index-bit flip per
    target, no arithmetic."""
    return _update_subspace(
        amps, num_qubits, tuple(targets), tuple(controls), control_states,
        lambda sub, taxes: torch.flip(sub, dims=taxes))


def _coalesce_runs(order):
    """Merge descending runs of ``order`` (input qubits listed MSB->LSB)
    into [(hi, len), ...] in output order: each run is one contiguous
    little-endian bit block, hence one axis of the input layout."""
    runs = []
    hi = cur = order[0]
    ln = 1
    for q in order[1:]:
        if q == cur - 1:
            cur = q
            ln += 1
        else:
            runs.append((hi, ln))
            hi = cur = q
            ln = 1
    runs.append((hi, ln))
    return runs


def _transpose_runs(amps, runs):
    in_order = sorted(runs, key=lambda r: -r[0])
    shape = (2,) + tuple(1 << ln for _, ln in in_order)
    axis_of = {r: i + 1 for i, r in enumerate(in_order)}
    axes = (0,) + tuple(axis_of[r] for r in runs)
    return amps.reshape(shape).permute(axes).reshape(2, -1)


def _swap_impl(amps, n: int, qb1: int, qb2: int):
    i, j = max(qb1, qb2), min(qb1, qb2)
    if i == j:
        return amps.reshape(2, -1)
    view = amps.reshape(2, 1 << (n - 1 - i), 2, 1 << (i - j - 1), 2, 1 << j)
    return view.permute(0, 1, 4, 3, 2, 5).reshape(2, -1)


def permute_qubits(amps, *, num_qubits: int, perm: Tuple[int, ...]):
    """Relabel qubits in one transpose pass: output qubit q holds what
    input qubit perm[q] held.  Contiguous bit runs coalesce into single
    axes; a permutation with too many runs is decomposed into pairwise
    swaps."""
    n = num_qubits
    order = tuple(perm[n - 1 - i] for i in range(n))
    runs = _coalesce_runs(order)
    if len(runs) <= _MAX_TRANSPOSE_RANK:
        return _transpose_runs(amps, runs).reshape(amps.shape)
    cur = list(range(n))
    out = amps
    for q in range(n):
        if cur[q] != perm[q]:
            j = cur.index(perm[q])
            out = _swap_impl(out, n, q, j)
            cur[q], cur[j] = cur[j], cur[q]
    return out.reshape(amps.shape)


def swap_bit_segments(amps, *, num_qubits: int, a: int, b: int, m: int):
    """Exchange the m-bit index segments [a, a+m) and [b, b+m)
    (a >= b+m) as one transpose."""
    n = num_qubits
    if a < b + m:
        raise ValueError(f"swap_bit_segments needs a >= b + m, got {(a, b, m)}")
    view = amps.reshape(
        2, 1 << (n - a - m), 1 << m, 1 << (a - b - m), 1 << m, 1 << b)
    return view.permute(0, 1, 4, 3, 2, 5).reshape(amps.shape)


def apply_index_permutation(amps, *, num_qubits: int,
                            targets: Tuple[int, ...], pi: Tuple[int, ...]):
    """General basis-index permutation on ``targets``: the new amplitude
    at target-field sub-index i is the old amplitude at sub-index ``pi[i]``.
    The gather runs as index selection along a contiguous bit field
    [lo, hi] covering the targets, viewed as (2, pre, 2^field, 2^lo); the
    move is exact (amplitudes are relocated, never recombined).  Fields
    wider than _GATHER_FIELD_MAX_BITS use the exact 0/1 matrix instead."""
    n = num_qubits
    lo, hi = min(targets), max(targets)
    if n >= _BIG_N and lo < _LANE_BITS:
        lo = 0
        hi = max(hi, _LANE_BITS - 1)
    if hi + 1 - lo > _GATHER_FIELD_MAX_BITS:
        d = 1 << len(targets)
        m = np.zeros((2, d, d), np.float64)
        m[0, np.arange(d), np.asarray(pi, dtype=np.int64)] = 1.0
        return apply_matrix(amps, m, num_qubits=n, targets=tuple(targets))
    d = 1 << (hi + 1 - lo)
    idx = np.arange(d)
    sub = np.zeros(d, dtype=np.int64)
    for b, t in enumerate(targets):
        sub |= ((idx >> (t - lo)) & 1) << b
    mapped = np.asarray(pi, dtype=np.int64)[sub]
    lifted = idx.copy()
    for t in targets:
        lifted &= ~(1 << (t - lo))
    for b, t in enumerate(targets):
        lifted |= ((mapped >> b) & 1) << (t - lo)
    view = amps.reshape(2, 1 << (n - hi - 1), d, 1 << lo)
    index = torch.as_tensor(lifted, device=amps.device)
    return torch.index_select(view, 2, index).reshape(amps.shape)


def apply_qft_ladder(amps, *, num_qubits: int, target: int, base: int = 0,
                     conj: bool = False):
    """One QFT layer: Hadamard on ``target`` followed by the whole
    controlled-phase ladder against the contiguous qubits [base, target),
    diag(1, e^{i pi low / 2^(target-base)}) on the target with low = the
    integer those qubits hold (agnostic_applyQFT, QuEST_common.c:836-898).
    ``base`` > 0 serves the density-matrix bra twin (qubits shifted by
    numQubits); ``conj`` negates the phases.

    Where the ladder kernels apply (fused.qft_ladder_supported: float32,
    base 0, a tensor on the card) the layer is K6/K7, in place.
    Elsewhere (float64, the bra twin, the CPU) it is this elementwise
    form: the phase factorises over 7-bit chunks of ``low`` into host
    tables of at most 128 entries, applied as broadcast complex
    multiplies after the pair combine; a new tensor is returned."""
    n, t = num_qubits, target
    if fused.qft_ladder_supported(amps, n, t, base):
        return fused.apply_qft_ladder_pallas(amps, num_qubits=n, target=t,
                                             conj=conj)
    tr = t - base
    lo = 1 << base         # untouched low axis (bra-twin case)
    hi = 1 << (n - 1 - t)
    dt = np.float32 if amps.dtype == torch.float32 else np.float64
    sgn = -1.0 if conj else 1.0
    inv = float(dt(1.0 / math.sqrt(2.0)))
    if tr < 10 and base == 0:
        widths = [tr]      # one table, flat view
    else:
        widths = []        # 7-bit chunks from the low end
        p = 0
        while p < tr:
            widths.append(min(7, tr - p))
            p += 7
    tabs = []
    p = 0
    for w in widths:
        j = np.arange(1 << w, dtype=np.float64)
        ang = sgn * np.pi * (j * (1 << p)) / (1 << tr)
        tabs.append((np.cos(ang).astype(dt), np.sin(ang).astype(dt)))
        p += w
    # axis order after [2, hi, 2 (pair)]: highest chunk first, lowest
    # chunk last, then the untouched lo axis (if any)
    factor_dims = [1 << w for w in reversed(widths)]
    v = amps.reshape([2, hi, 2] + factor_dims + ([lo] if base else []))
    x0r, x0i = v[0, :, 0], v[1, :, 0]
    x1r, x1i = v[0, :, 1], v[1, :, 1]
    y0r, y0i = (x0r + x1r) * inv, (x0i + x1i) * inv
    y1r, y1i = (x0r - x1r) * inv, (x0i - x1i) * inv
    ntail = len(widths) + (1 if base else 0)   # axes after hi in y*
    for ci, (w, (tc, ts)) in enumerate(zip(widths, tabs)):
        axis_from_end = (1 if base else 0) + ci
        bshape = [1] * (1 + ntail)
        bshape[len(bshape) - 1 - axis_from_end] = 1 << w
        pr = torch.as_tensor(tc, device=amps.device).reshape(bshape)
        pi_ = torch.as_tensor(ts, device=amps.device).reshape(bshape)
        y1r, y1i = pr * y1r - pi_ * y1i, pr * y1i + pi_ * y1r
    out = torch.stack([torch.stack([y0r, y1r], dim=1),
                       torch.stack([y0i, y1i], dim=1)])
    return out.reshape(amps.shape)


# ---------------------------------------------------------------------------
# State initialisation (reference QuEST_cpu.c:1453-1729)
# ---------------------------------------------------------------------------


def apply_full_diagonal(amps, op_real, op_imag):
    """Elementwise multiply by a full-Hilbert diagonal operator given as
    separate real/imag vectors (statevec_applyDiagonalOp,
    QuEST_cpu.c:4007-4041)."""
    return cplx.cmul(amps, op_real.to(amps.dtype), op_imag.to(amps.dtype))


def diag_from_z_hamil(codes, coeffs, *, num_qubits: int, dtype, device):
    """diag_d = sum_t c_t (-1)^parity(d & zmask_t) for an all-I/Z
    Hamiltonian ``codes`` (T, n) with coefficients ``coeffs`` (T,)
    (agnostic_initDiagonalOpFromPauliHamil, QuEST_cpu.c:4188-4227),
    accumulated term by term in ``dtype`` as the JAX package's scan does.
    Each term's sign is the outer product of its row and lane factors
    (parity_sign_factors), so no index vector of the operator's size is
    made, and each adds into the operator in place (c_t s is exact)."""
    n = num_qubits
    lo = n // 2
    acc = torch.zeros((1 << (n - lo), 1 << lo), dtype=dtype, device=device)
    codes = np.asarray(codes)
    for t in range(codes.shape[0]):
        zq = [q for q in range(n) if int(codes[t, q]) == 3]
        s_row, s_lane = parity_sign_factors(n, zq, dtype, device, lo)
        acc.add_((float(coeffs[t]) * s_row) * s_lane)
    return acc.reshape(-1)


def init_blank_state(num_amps: int, dtype, device):
    return torch.zeros((2, num_amps), dtype=dtype, device=device)


def init_zero_state(num_amps: int, dtype, device):
    return init_classical_state(num_amps, 0, dtype, device)


def init_plus_state(num_amps: int, dtype, device):
    out = torch.zeros((2, num_amps), dtype=dtype, device=device)
    out[0] = 1.0 / math.sqrt(num_amps)
    return out


def init_classical_state(num_amps: int, state_index: int, dtype, device):
    out = torch.zeros((2, num_amps), dtype=dtype, device=device)
    out[0, state_index] = 1.0
    return out


def init_debug_state(num_amps: int, dtype, device):
    """amp_k = (2k mod 10)/10 + i((2k+1) mod 10)/10 — reference
    initStateDebug (QuEST_cpu.c:1646, QuEST_debug.h)."""
    k = torch.arange(num_amps, dtype=dtype, device=device)
    re = torch.remainder(2.0 * k, 10.0) / 10.0
    im = torch.remainder(2.0 * k + 1.0, 10.0) / 10.0
    return torch.stack([re, im])


def init_classical_density(num_qubits: int, state_index: int, dtype, device):
    """rho = |s><s| as a flattened 2n-qubit vector (column-major, ket =
    low bits; reference densmatr_initClassicalState)."""
    dim = 1 << num_qubits
    return init_classical_state(dim * dim, state_index + state_index * dim,
                                dtype, device)


def init_plus_density(num_qubits: int, dtype, device):
    dim = 1 << num_qubits
    out = torch.zeros((2, dim * dim), dtype=dtype, device=device)
    out[0] = 1.0 / dim
    return out


def init_pure_density(psi):
    """rho = |psi><psi| flattened column-major: flat[r + c*dim] =
    psi_r conj(psi_c)."""
    z = cplx.to_complex(psi)
    rho_cr = z[None, :] * z.conj()[:, None]       # [c, r]
    return cplx.from_complex(rho_cr.reshape(-1))


# ---------------------------------------------------------------------------
# Collapse, weighted sums and sparse initialisation (reference
# QuEST_cpu.c:3727-3880, 785-860, 3965-4006)
# ---------------------------------------------------------------------------


def _bit_indicator_2d(n: int, bit_states, dtype, device):
    """{0, 1} tensor broadcastable over the (2^hi, 2^lo) = _split2(n) view
    of the state: 1 where every (bit, state) pair matches."""
    ind = None
    for b, s in bit_states:
        m = bit_2d(n, b, device) == int(s)
        ind = m if ind is None else ind & m
    return ind.to(dtype)


def collapse_statevec(amps, prob: float, *, num_qubits: int, target: int,
                      outcome: int):
    """Zero the discarded half, scale the kept half by 1/sqrt(prob)
    (statevec_collapseToKnownProbOutcomeLocal, QuEST_cpu.c:3727-3815)."""
    n = num_qubits
    scale = 1.0 / torch.sqrt(torch.tensor(prob, dtype=amps.dtype))
    ind = _bit_indicator_2d(n, ((target, outcome),), amps.dtype,
                            amps.device)
    hi, lo = _split2(n)
    view = amps.reshape(2, 1 << hi, 1 << lo)
    return (view * (scale * ind)[None]).reshape(amps.shape)


def collapse_density(amps, prob: float, *, num_qubits: int, target: int,
                     outcome: int):
    """rho: zero every element whose ket- or bra-target bit differs from
    the outcome; renormalise by 1/prob (densmatr_collapseToKnownProbOutcome,
    QuEST_cpu.c:785-860)."""
    n = num_qubits
    ind = _bit_indicator_2d(2 * n, ((target, outcome), (target + n, outcome)),
                            amps.dtype, amps.device)
    hi, lo = _split2(2 * n)
    view = amps.reshape(2, 1 << hi, 1 << lo)
    scale = torch.tensor(prob, dtype=amps.dtype)
    return (view * (ind / scale)[None]).reshape(amps.shape)


def set_weighted_qureg(amps_out, amps1, amps2, facs):
    """out = f1*q1 + f2*q2 + fOut*out (reference setWeightedQureg,
    QuEST_cpu.c:3965-4006).  ``facs`` is a (2, 3) array of the three
    complex factors (fOut, f1, f2), real parts then imaginary parts."""
    f = [[float(x) for x in row] for row in facs]
    out = cplx.cmul(amps_out, f[0][0], f[1][0])
    out = out + cplx.cmul(amps1, f[0][1], f[1][1])
    return out + cplx.cmul(amps2, f[0][2], f[1][2])


def init_sparse_state(num_amps: int, indices, res, ims, dtype, device):
    """Scatter k nonzero amplitudes into an otherwise-zero state (the
    JAX package's sparse state preparation, arXiv:2504.08705)."""
    out = torch.zeros((2, num_amps), dtype=dtype, device=device)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device)
    out[0, idx] = torch.as_tensor(np.asarray(res), dtype=dtype, device=device)
    out[1, idx] = torch.as_tensor(np.asarray(ims), dtype=dtype, device=device)
    return out
