"""Circuit scheduler: fold gate streams into fused window passes.

The counterpart of the JAX package's ``circuit.py`` windowed planner and
executor.  Planning is pure host work over NumPy matrices and is a copy of
the reference algorithm, so the two packages produce the same plans (same
op kinds, window offsets, ranks, side flags; matrices to rounding).  The
plan is a list of tuples:

    ('winfused', k, As, Bs, apply_a, apply_b, mask)
                              one pass applying the rank-R operator
                              [mask (.)] sum_r B_r (x) A_r, A on lane qubits
                              [0,7), B on the window [k, k+7)
                              (ops/fused.py apply_window_stack, kernel K1)
    ('megawin', (winfused...)) a run of window passes in one launch
                              (ops/fused.py apply_window_megastack, K2)
    ('apply', targets, mat)   a dense gate no window covers
    ('xor' | 'permute' | 'gatherperm', ...)
                              matrix-free permutation ops
    ('segswap', a, b, m)      bit-segment exchange
    ('sigma_swap', g)         the QFT bit reversal's in-place double
                              bit-block swap (ops/bigstate.py
                              apply_sigma_swap, kernel K10)
    ('sigma_rev', g)          the whole bit reversal of the state in one
                              in-place pass (ops/bigstate.py
                              apply_bit_reversal, K10's reversal form)

The paged planner (``plan_circuit_py``; ``planner="paged"`` or
``QT_PLANNER=paged``) instead pins the window to [7, 14) and relocates
high qubits into it:

    ('fused', As, Bs)         cluster pass on qubits [0, 14)
                              (ops/fused.py apply_cluster_stack, K11)
    ('swapfused', h, b, m, As, Bs)
                              segment swap [h, h+m) <-> [b, b+m) fused
                              into a cluster pass
                              (apply_swap_cluster_stack, K12)
    ('segswap', a, b, m)      a relocation the peephole could not fuse
    ('apply', targets, mat)   a gate no relocation brings into the window

On a sharded register the drain first groups its items into windows
whose qubits fit the shard-local space and schedules one batched remap
per window (``plan_remap_windows``; its exchange cost model is
``remap_exchange_bytes``); each window then plans as above at nloc.

The module also holds the QFT's planner (``fused_qft``,
``_fused_qft_multilayer``) and its bit-reversal decomposition
(``bit_reversal_ops``, ``_bit_reversal_big``).  The JAX package's native
C++ scheduler is not ported: planning runs in Python, with the same
result.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import bigstate, fused, kernels

LANE = fused.LANE_QUBITS            # 7
WINDOW = fused.CLUSTER_QUBITS       # 14
DIM = fused.CLUSTER_DIM             # 128
_LOOKAHEAD = 256                    # next-use horizon for eviction choice
PLANNERS = ("windowed", "paged")


@dataclass(frozen=True)
class Gate:
    """One dense gate: ``mat`` is stacked SoA (2, 2^k, 2^k) NumPy over
    ``targets`` (targets[0] = least-significant matrix bit)."""

    targets: Tuple[int, ...]
    mat: np.ndarray


def controlled_dense(mat_soa, num_controls: int, control_states=()):
    """Embed a k-qubit SoA matrix as a (num_controls+k)-qubit controlled
    matrix (control i is matrix bit k+i, conditioned on
    ``control_states[i]``, default 1)."""
    m = np.asarray(mat_soa)
    d = m.shape[-1]
    nc = int(num_controls)
    full = d << nc
    states = tuple(int(s) for s in control_states) or (1,) * nc
    active = 0
    for i, s in enumerate(states):
        active |= (s & 1) << i
    idx = np.arange(full)
    ci, ti = idx // d, idx % d
    same_c = ci[:, None] == ci[None, :]
    gate_mask = same_c & (ci == active)[:, None]
    eye_mask = same_c & (ci != active)[:, None] & (idx[:, None] == idx[None, :])
    row = np.broadcast_to(ti[:, None], (full, full))
    col = np.broadcast_to(ti[None, :], (full, full))
    out = m[:, row, col] * gate_mask.astype(m.dtype)
    out[0] += eye_mask.astype(m.dtype)
    return out


# ---------------------------------------------------------------------------
# Permutation gate family: classification + gather-shaped lowering
# ---------------------------------------------------------------------------

# Composed gather tables are 2^|union| entries: past this width a run is
# split into several gather passes.
PERM_GATHER_MAX_BITS = 10


def _classify_pi(pi):
    """Classify ``new[i] = old[pi[i]]`` as ("xor", c), ("relabel", s) or
    ("gather", pi)."""
    pi = np.asarray(pi, dtype=np.int64)
    d = len(pi)
    k = d.bit_length() - 1
    idx = np.arange(d)
    c = int(pi[0])
    if np.array_equal(pi, idx ^ c):
        return ("xor", c)
    if c == 0:
        s = []
        for j in range(k):
            img = int(pi[1 << j])
            if img and not (img & (img - 1)):
                s.append(img.bit_length() - 1)
        if len(s) == k and len(set(s)) == k:
            lin = np.zeros(d, dtype=np.int64)
            for j in range(k):
                lin |= ((idx >> j) & 1) << s[j]
            if np.array_equal(pi, lin):
                return ("relabel", tuple(s))
    return ("gather", tuple(int(p) for p in pi))


@lru_cache(maxsize=512)
def _classify_perm_cached(shape, dstr, buf):
    m = np.frombuffer(buf, dtype=np.dtype(dstr)).reshape(shape)
    if m[1].any():
        return None
    re = m[0]
    if not np.all((re == 0) | (re == 1)):
        return None
    if not (np.all(re.sum(axis=0) == 1) and np.all(re.sum(axis=1) == 1)):
        return None
    return _classify_pi(re.argmax(axis=1))


def classify_permutation_gate(mat):
    """``None | ("xor", c) | ("relabel", s) | ("gather", pi)`` for a
    stacked SoA gate matrix (X, CNOT, Toffoli/MCX, SWAP and products)."""
    if not isinstance(mat, np.ndarray) or mat.ndim != 3:
        return None
    if mat.shape[0] != 2 or mat.shape[1] != mat.shape[2]:
        return None
    return _classify_perm_cached(mat.shape, mat.dtype.str, mat.tobytes())


def compose_permutation_run(gates):
    """Fold a run of permutation-classified gates (stream order) into one
    index permutation over the sorted union of their targets: returns
    ``(union, pi)`` with ``new[i] = old[pi[i]]``, or None when any gate
    fails classification.  Exact integer arithmetic."""
    union = sorted({t for g in gates for t in g.targets})
    upos = {q: j for j, q in enumerate(union)}
    d = 1 << len(union)
    idx = np.arange(d)
    total = idx.copy()
    for g in gates:
        cls = classify_permutation_gate(g.mat)
        if cls is None:
            return None
        kind, payload = cls
        pos = [upos[t] for t in g.targets]
        if kind == "xor":
            mask = 0
            for b, p in enumerate(pos):
                if (payload >> b) & 1:
                    mask |= 1 << p
            lifted = idx ^ mask
        else:
            if kind == "relabel":
                kg = len(pos)
                gidx = np.arange(1 << kg)
                pi_g = np.zeros(1 << kg, dtype=np.int64)
                for j in range(kg):
                    pi_g |= ((gidx >> j) & 1) << payload[j]
            else:
                pi_g = np.asarray(payload, dtype=np.int64)
            sub = np.zeros(d, dtype=np.int64)
            for b, p in enumerate(pos):
                sub |= ((idx >> p) & 1) << b
            mapped = pi_g[sub]
            lifted = idx
            for p in pos:
                lifted = lifted & ~(1 << p)
            for b, p in enumerate(pos):
                lifted |= ((mapped >> b) & 1) << p
        total = total[lifted]
    return tuple(union), tuple(int(p) for p in total)


def lower_permutation_run(gates, num_qubits: int):
    """Lower a permutation-classified gate run to matrix-free plan ops:
    group stream neighbours while the composed gather table stays within
    PERM_GATHER_MAX_BITS, then emit per group ("xor", flips),
    ("permute", perm) or ("gatherperm", union, pi)."""
    ops: List[tuple] = []
    group: List[Gate] = []
    gbits: set = set()

    def flush():
        if not group:
            return
        union, pi = compose_permutation_run(group)
        kind, payload = _classify_pi(pi)
        if kind == "xor":
            flips = tuple(union[j] for j in range(len(union))
                          if (payload >> j) & 1)
            if flips:
                ops.append(("xor", flips))
        elif kind == "relabel":
            perm = list(range(num_qubits))
            for j, q in enumerate(union):
                perm[q] = union[payload[j]]
            if perm != list(range(num_qubits)):
                ops.append(("permute", tuple(perm)))
        else:
            ops.append(("gatherperm", tuple(union), tuple(payload)))
        group.clear()
        gbits.clear()

    for g in gates:
        b = set(g.targets)
        if group:
            nb = gbits | b
            if (len(nb) > PERM_GATHER_MAX_BITS
                    or max(nb) - min(nb) >= kernels._GATHER_FIELD_MAX_BITS):
                flush()
        group.append(g)
        gbits |= b
    flush()
    return ops


def perm_item_entry(targets, mat):
    """Window-planner entry of one gate: ``("relabel", pairs)`` when the
    gate only relabels bits (pairs ``((q, rho(q)), ...)``: qubit q's new
    content comes from qubit rho(q)), which plan_remap_windows folds into
    the live permutation with no data motion; else the sorted bit tuple
    (quest_tpu/circuit.py perm_item_entry, permutation fast paths on)."""
    cls = classify_permutation_gate(mat)
    if cls is not None and cls[0] == "relabel":
        s = cls[1]
        pairs = tuple(sorted(
            (targets[j], targets[s[j]])
            for j in range(len(targets)) if s[j] != j))
        return ("relabel", pairs) if pairs else ()
    return tuple(sorted(targets))


def _is_relabel_entry(entry) -> bool:
    """True for the tagged ``("relabel", pairs)`` planner entry."""
    return len(entry) == 2 and isinstance(entry[0], str) \
        and entry[0] == "relabel"


# ---------------------------------------------------------------------------
# Cluster embedding: k-qubit matrix -> 128x128 via static index arrays
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _embed_indices(bits: Tuple[int, ...]):
    """Static (row, col, mask) arrays embedding a 2^k matrix on cluster
    bits ``bits`` into the 128x128 cluster space (the insertZeroBit index
    algebra of QuEST_cpu.c:1901-1985 as precomputed gathers)."""
    idx = np.arange(DIM)
    sub = np.zeros(DIM, dtype=np.int64)
    for pos, b in enumerate(bits):
        sub |= ((idx >> b) & 1) << pos
    rest = idx.copy()
    for b in bits:
        rest &= ~(1 << b)
    mask = (rest[:, None] == rest[None, :]).astype(np.float64)
    row = sub[:, None] * np.ones((1, DIM), dtype=np.int64)
    col = np.ones((DIM, 1), dtype=np.int64) * sub[None, :]
    return row, col, mask


def embed_in_cluster(mat_soa, bits: Tuple[int, ...]):
    """SoA (2, 2^k, 2^k) gate on cluster bits -> SoA (2, 128, 128), in C
    order: the gather leaves a strided layout, on which NumPy's matmul
    bypasses BLAS for the planners' 128 x 128 fold products."""
    row, col, mask = _embed_indices(tuple(bits))
    m = np.asarray(mat_soa)
    return np.ascontiguousarray(m[:, row, col] * mask.astype(m.dtype))


def soa_matmul(a, b):
    """Complex matrix product of stacked SoA NumPy matrices."""
    re = a[0] @ b[0] - a[1] @ b[1]
    im = a[0] @ b[1] + a[1] @ b[0]
    return np.stack([re, im])


@lru_cache(maxsize=None)
def _eye_cluster():
    return np.stack([np.eye(DIM), np.zeros((DIM, DIM))])


# ---------------------------------------------------------------------------
# Operator-Schmidt and controlled-form decompositions of 2q gates
# ---------------------------------------------------------------------------

_SCHMIDT_TOL = 1e-7
_CACHE_MAX = 4096
_schmidt_cache: dict = {}
_ctrl_cache: dict = {}


def _concrete44(mat_soa):
    m = np.asarray(mat_soa)
    if m.dtype == object or m.shape != (2, 4, 4):
        return None
    return m


def schmidt_terms_2q(mat_soa) -> Optional[List[tuple]]:
    """Operator-Schmidt decomposition of a SoA (2,4,4) 2q gate:
    U = sum_r hi_r (x) lo_r over (matrix bit 1, matrix bit 0).  Returns
    [(lo_soa, hi_soa), ...], one pair per Schmidt term (1 for product
    gates, 2 for CNOT/CZ/controlled-phase, 4 generically)."""
    m = _concrete44(mat_soa)
    if m is None:
        return None
    key = (m.dtype.str, m.tobytes())
    hit = _schmidt_cache.get(key)
    if hit is not None:
        return hit
    if len(_schmidt_cache) >= _CACHE_MAX:
        _schmidt_cache.pop(next(iter(_schmidt_cache)))
    u = m[0] + 1j * m[1]
    # row index = 2*b1 + b0; regroup to T[(b1,b1'),(b0,b0')]
    t = u.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    uu, s, vh = np.linalg.svd(t)
    # relative truncation at the dtype's working precision; a zero matrix
    # keeps its leading (zero) term so the rank is always >= 1
    eps = _SCHMIDT_TOL if m.dtype == np.float32 else 1e-12
    tol = eps * max(float(s[0]), 1.0)
    keep = [r for r in range(4) if s[r] > tol] or [0]
    terms = []
    for r in keep:
        hi = (np.sqrt(s[r]) * uu[:, r]).reshape(2, 2)
        lo = (np.sqrt(s[r]) * vh[r, :]).reshape(2, 2)
        terms.append((np.stack([lo.real, lo.imag]).astype(m.dtype),
                      np.stack([hi.real, hi.imag]).astype(m.dtype)))
    _schmidt_cache[key] = terms
    return terms


def _diag_tol(m) -> float:
    return 1e-6 if m.dtype == np.float32 else 1e-11


def diag4_2q(mat_soa):
    """The (4,) complex diagonal of a diagonal 2q gate (index 2*b1 + b0),
    or None when not diagonal.  Diagonal crossing gates fold into a
    window pass's elementwise mask at no rank cost."""
    m = _concrete44(mat_soa)
    if m is None:
        return None
    u = m[0] + 1j * m[1]
    d = np.diag(u)
    if np.abs(u - np.diag(d)).max() > _diag_tol(m) * max(np.abs(u).max(), 1.0):
        return None
    return d


def controlled_form_2q(mat_soa):
    """Decompose a 2q gate that is diagonal in one matrix bit
    (U = |0><0|_c (x) U0 + |1><1|_c (x) U1: CNOT, controlled-V, control
    on 0) into U = (post on acted bit) . diag(d4) . (pre on acted bit).
    Returns (pre_soa, d4_soa, post_soa, acted_bit) or None."""
    m = _concrete44(mat_soa)
    if m is None or diag4_2q(mat_soa) is not None:
        return None
    key = (m.dtype.str, m.tobytes())
    hit = _ctrl_cache.get(key, "miss")
    if hit != "miss":
        return hit
    if len(_ctrl_cache) >= _CACHE_MAX:
        _ctrl_cache.pop(next(iter(_ctrl_cache)))
    u = m[0] + 1j * m[1]
    tol = _diag_tol(m) * max(np.abs(u).max(), 1.0)
    result = None
    for cb in (0, 1):
        v4 = u.reshape(2, 2, 2, 2)  # [b1, b0, b1', b0']
        if cb == 0:
            coupling = np.abs(v4[:, 0, :, 1]).max() + np.abs(v4[:, 1, :, 0]).max()
            blocks = [v4[:, v, :, v] for v in (0, 1)]
        else:
            coupling = np.abs(v4[0, :, 1, :]).max() + np.abs(v4[1, :, 0, :]).max()
            blocks = [v4[v, :, v, :] for v in (0, 1)]
        if coupling > tol:
            continue
        u0, u1 = blocks
        v = u0.conj().T @ u1
        if np.abs(v - np.diag(np.diag(v))).max() <= tol:
            w = np.eye(2, dtype=complex)
            ev = np.diag(v)
        else:
            ev, w = np.linalg.eig(v)
            w, _ = np.linalg.qr(w)
            ev = np.diag(w.conj().T @ v @ w)
        pre = w.conj().T
        post = u0 @ w
        acted = 1 - cb
        d4 = np.ones(4, dtype=complex)
        for ba in (0, 1):
            idx = (2 * ba + 1) if cb == 0 else (2 + ba)
            d4[idx] = ev[ba]
        # the decomposition must reconstruct the input, or the gate takes
        # the exact rank-2 Schmidt fold instead
        if acted == 0:
            full_pre = np.kron(np.eye(2), pre)
            full_post = np.kron(np.eye(2), post)
        else:
            full_pre = np.kron(pre, np.eye(2))
            full_post = np.kron(post, np.eye(2))
        recon = full_post @ np.diag(d4) @ full_pre
        if np.abs(recon - u).max() > 16 * tol:
            continue
        dt = m.dtype
        result = (np.stack([pre.real, pre.imag]).astype(dt),
                  np.stack([d4.real, d4.imag]).astype(dt),
                  np.stack([post.real, post.imag]).astype(dt),
                  acted)
        break
    _ctrl_cache[key] = result
    return result


def rewrite_controlled_gates(glist: List[Gate]) -> List[Gate]:
    """Rewrite every controlled-form 2q gate as [pre(acted qubit),
    diagonal 2q gate, post(acted qubit)], so a crossing diagonal part
    folds into a pass mask while pre/post fold as dense 1q gates."""
    out: List[Gate] = []
    for g in glist:
        cf = controlled_form_2q(g.mat) if len(g.targets) == 2 else None
        if cf is None:
            out.append(g)
            continue
        pre, d4, post, acted = cf
        tq = g.targets[acted]
        dd = np.zeros((2, 4, 4), dtype=d4.dtype)
        dd[0][np.diag_indices(4)] = d4[0]
        dd[1][np.diag_indices(4)] = d4[1]
        out.append(Gate((tq,), pre))
        out.append(Gate(g.targets, dd))
        out.append(Gate((tq,), post))
    return out


def is_identity_gate(mat_soa) -> bool:
    """Exactly the identity, bitwise (the optimizer's cancellation test).
    Accepts (2, s, s) and batched (B, 2, s, s) stacks."""
    m = np.asarray(mat_soa)
    if m.dtype == object or m.ndim not in (3, 4):
        return False
    eye = np.eye(m.shape[-1], dtype=m.dtype)
    return bool((m[..., 0, :, :] == eye).all()
                and (m[..., 1, :, :] == 0.0).all())


def is_diag_gate(mat_soa) -> bool:
    """Diagonal (any size): such gates commute with a pass's mask."""
    m = np.asarray(mat_soa)
    if m.dtype == object or m.ndim != 3:
        return False
    u = m[0] + 1j * m[1]
    off = np.abs(u - np.diag(np.diag(u))).max()
    return bool(off <= _diag_tol(m) * max(np.abs(u).max(), 1.0))


# ---------------------------------------------------------------------------
# The windowed scheduler
# ---------------------------------------------------------------------------


def _stack_sides(As, Bs):
    """Stack per-rank side matrices (None = identity) into (R, 2, 128, 128)
    NumPy arrays."""
    eye = _eye_cluster()
    dts = [x.dtype for x in As + Bs if x is not None]
    dt = dts[0] if dts else np.float64
    a = np.stack([x if x is not None else eye.astype(dt) for x in As])
    b = np.stack([x if x is not None else eye.astype(dt) for x in Bs])
    return a, b


class _WinAcc:
    """Accumulator for one offset-window pass: the operator on {lane
    qubits [0,7)} x {window qubits [k, k+7)} as a rank-R Kronecker sum
    sum_r B_r (x) A_r, plus an optional elementwise mask."""

    def __init__(self, k: int):
        self.k = k
        self.As: List[Optional[np.ndarray]] = [None]
        self.Bs: List[Optional[np.ndarray]] = [None]
        self.rank = 1
        self.count = 0
        self.a_used = False
        self.b_used = False
        self.mask: Optional[np.ndarray] = None  # complex (128, 128)

    def fold_side(self, side: str, bits: Tuple[int, ...], mat):
        e = embed_in_cluster(mat, bits)
        accs = self.As if side == "A" else self.Bs
        for r in range(self.rank):
            accs[r] = e if accs[r] is None else soa_matmul(e, accs[r])
        if side == "A":
            self.a_used = True
        else:
            self.b_used = True
        self.count += 1

    def fold_cross(self, lane_bit: int, win_bit: int, mat,
                   lane_is_bit0: bool):
        """Fold a 2q gate with one lane target and one window target
        (``win_bit`` window-relative) through its Schmidt terms."""
        terms = schmidt_terms_2q(mat)
        pairs = [(lo, hi) if lane_is_bit0 else (hi, lo) for lo, hi in terms]
        As, Bs = [], []
        for lane_m, win_m in pairs:
            ea = embed_in_cluster(lane_m, (lane_bit,))
            eb = embed_in_cluster(win_m, (win_bit,))
            for r in range(self.rank):
                As.append(ea if self.As[r] is None
                          else soa_matmul(ea, self.As[r]))
                Bs.append(eb if self.Bs[r] is None
                          else soa_matmul(eb, self.Bs[r]))
        self.As, self.Bs = As, Bs
        self.rank = len(As)
        self.a_used = True
        self.b_used = True
        self.count += 1

    def fold_mask(self, lane_bit: int, win_bit: int, d4, lane_is_bit0: bool):
        """Fold a diagonal crossing 2q gate as an elementwise post-mask."""
        lb = (np.arange(DIM) >> lane_bit) & 1
        wb = (np.arange(DIM) >> win_bit) & 1
        if lane_is_bit0:
            idx = 2 * wb[:, None] + lb[None, :]
        else:
            idx = 2 * lb[None, :] + wb[:, None]
        m = np.asarray(d4, dtype=complex)[idx]          # (window, lane)
        self.mask = m if self.mask is None else self.mask * m
        self.count += 1

    def mask_soa(self):
        if self.mask is None:
            return None
        return np.stack([self.mask.real, self.mask.imag])

    def stacks(self):
        return _stack_sides(self.As, self.Bs)


RANK_CAP = 4  # max Kronecker-sum rank per window pass (FLOPs scale with it)


def _gate_xranks(gates: Sequence[Gate]) -> List[int]:
    """Per-gate cross-fold rank: the Schmidt rank of 2q gates, 0 else."""
    return [len(schmidt_terms_2q(g.mat)) if len(g.targets) == 2 else 0
            for g in gates]


def plan_circuit_windowed(gates: Sequence[Gate],
                          num_qubits: int) -> List[tuple]:
    """Offset-window DAG list scheduler (zero relocation).  Each pass
    applies a rank-R operator on {lane qubits [0,7)} x {window [k, k+7)};
    per pass the scheduler picks the offset k whose transitive fold
    closure over the ready frontier covers the most gates (ties: lower
    rank, then lower k).  2q gates straddling lane x window fold through
    their Schmidt terms (rank capped at RANK_CAP); controlled-form gates
    are first rewritten so a crossing diagonal part folds into the pass
    mask, after which only gates commuting with the mask may join the
    pass.  Gates no window covers become one 'apply' pass each."""
    n = num_qubits
    glist = list(gates)
    if n < WINDOW:
        return [("apply", g.targets, g.mat) for g in glist]
    glist = rewrite_controlled_gates(glist)

    num_gates = len(glist)
    queues: List[List[int]] = [[] for _ in range(n)]
    for gi, g in enumerate(glist):
        for t in g.targets:
            queues[t].append(gi)
    heads = [0] * n

    xrank = _gate_xranks(glist)
    gdiag4 = [diag4_2q(g.mat) if len(g.targets) == 2 else None for g in glist]
    gdiag = [is_diag_gate(g.mat) for g in glist]

    k_lo, k_hi = LANE, n - LANE  # valid window offsets (inclusive)

    def classify(targets: Tuple[int, ...], k: int):
        lane = all(t < LANE for t in targets)
        if lane:
            return ("A", targets)
        win = all(k <= t < k + LANE for t in targets)
        if win:
            return ("B", tuple(t - k for t in targets))
        if len(targets) == 2:
            t0, t1 = targets
            if t0 < LANE and k <= t1 < k + LANE:
                return ("X", t0, t1 - k, True)
            if t1 < LANE and k <= t0 < k + LANE:
                return ("X", t1, t0 - k, False)
        return None

    def is_ready(gi, hd):
        return all(
            hd[t] < len(queues[t]) and queues[t][hd[t]] == gi
            for t in glist[gi].targets
        )

    ready = sorted(gi for gi in range(num_gates) if is_ready(gi, heads))

    def advance(gi, hd, rdy):
        for t in glist[gi].targets:
            hd[t] += 1
        rdy.remove(gi)
        for t in glist[gi].targets:
            if hd[t] < len(queues[t]):
                cand = queues[t][hd[t]]
                if cand not in rdy and is_ready(cand, hd):
                    rdy.append(cand)
        rdy.sort()

    def simulate(k):
        """Transitive fold closure for window k over copies of the DAG
        state: (count, final_rank, folds in fold order)."""
        hd = heads[:]
        rdy = list(ready)
        rank, count, folds = 1, 0, []
        mask_bits: set = set()
        progressed = True
        while progressed:
            progressed = False
            for gi in list(rdy):
                c = classify(glist[gi].targets, k)
                if c is None:
                    continue
                blocked = (
                    mask_bits
                    and not gdiag[gi]
                    and (mask_bits & set(glist[gi].targets))
                )
                if c[0] == "X":
                    if gdiag4[gi] is not None:
                        mask_bits |= set(glist[gi].targets)
                    else:
                        if blocked:
                            continue
                        r = xrank[gi]
                        if rank * r > RANK_CAP:
                            continue
                        rank *= r
                elif blocked:
                    continue
                count += 1
                folds.append(gi)
                advance(gi, hd, rdy)
                progressed = True
        return count, rank, folds

    ops: List[tuple] = []
    while ready:
        cands = {k_lo}
        for gi in ready:
            for t in glist[gi].targets:
                if t >= LANE:
                    for k in range(max(k_lo, t - LANE + 1),
                                   min(k_hi, t) + 1):
                        cands.add(k)
        # windows 8 and 9 are tried only when no other window covers a
        # ready gate, as in the JAX planner (its TPU layout makes them
        # slow); keeping the rule keeps the two packages' plans equal
        if k_hi >= 10:
            cands -= {8, 9}
        best = None
        for k in sorted(cands):
            count, rank, folds = simulate(k)
            key = (count, -rank, -k)
            if best is None or key > best[0]:
                best = (key, k, folds)
        if best is None or best[0][0] == 0:
            for k in (8, 9):
                if k_lo <= k <= k_hi:
                    count, rank, folds = simulate(k)
                    key = (count, -rank, -k)
                    if count and (best is None or key > best[0]):
                        best = (key, k, folds)
        if best is None or best[0][0] == 0:
            gi = ready[0]
            ops.append(("apply", glist[gi].targets, glist[gi].mat))
            advance(gi, heads, ready)
            continue
        _, k, folds = best
        acc = _WinAcc(k)
        for gi in folds:
            c = classify(glist[gi].targets, k)
            if c[0] == "X":
                if gdiag4[gi] is not None:
                    acc.fold_mask(c[1], c[2], gdiag4[gi], c[3])
                else:
                    acc.fold_cross(c[1], c[2], glist[gi].mat, c[3])
            else:
                acc.fold_side(c[0], c[1], glist[gi].mat)
            advance(gi, heads, ready)
        a, b = acc.stacks()
        ops.append(("winfused", k, a, b, acc.a_used, acc.b_used,
                    acc.mask_soa()))
    return ops


def _side_split_enabled() -> bool:
    return os.environ.get("QT_SIDE_SPLIT", "0") == "1"


def split_plan_sides(ops: Sequence[tuple]) -> List[tuple]:
    """Side-minimisation rewrite (QT_SIDE_SPLIT=1, off by default): a run
    of rank-1 maskless dual-side passes equals (prod B_i) o (prod A_i),
    because the A sides act on lane qubits [0,7) and the B sides on window
    qubits >= 7; j >= 2 such passes become j B-only passes plus one merged
    A pass.  Barriers: rank > 1 passes, masked passes whose mask depends
    on a touched lane bit, and every non-winfused op."""
    def deferrable(op):
        return (op[0] == "winfused" and np.shape(op[2])[0] == 1
                and (len(op) < 7 or op[6] is None) and op[4]
                and isinstance(op[2], np.ndarray))

    def mask_commutes(op, touched: set) -> bool:
        if not isinstance(op[6], np.ndarray):
            return False
        m = op[6][0] + 1j * op[6][1]           # (window, lane)
        cols = np.arange(DIM)
        for lbit in touched:
            if not np.allclose(m, m[:, cols ^ (1 << lbit)], atol=1e-12):
                return False
        return True

    def lane_bits_of(a) -> set:
        u = a[0] + 1j * a[1]
        idx = np.arange(DIM)
        out = set()
        for lbit in range(LANE):
            r0 = idx[((idx >> lbit) & 1) == 0]
            r1 = r0 ^ (1 << lbit)
            off = max(np.abs(u[np.ix_(r0, r1)]).max(),
                      np.abs(u[np.ix_(r1, r0)]).max())
            sym = np.abs(u[np.ix_(r0, r0)] - u[np.ix_(r1, r1)]).max()
            if off > 1e-12 or sym > 1e-12:
                out.add(lbit)
        return out

    out: List[tuple] = []
    region: List[tuple] = []

    def flush_region():
        if sum(1 for _, d in region if d) < 2:
            out.extend(op for op, _ in region)
            region.clear()
            return
        a_prod = None
        for op, d in region:
            if d:
                a_prod = (op[2][0] if a_prod is None
                          else soa_matmul(op[2][0], a_prod))
                if op[5]:
                    out.append(("winfused", op[1], op[2], op[3],
                                False, True, None))
            else:
                out.append(op)
        out.append(("winfused", LANE, a_prod[None],
                    _eye_cluster().astype(a_prod.dtype)[None],
                    True, False, None))
        region.clear()

    touched: set = set()
    for op in ops:
        if deferrable(op):
            region.append((op, True))
            touched |= lane_bits_of(op[2][0])
            continue
        if op[0] == "winfused" and not op[4]:
            if len(op) < 7 or op[6] is None or mask_commutes(op, touched):
                region.append((op, False))
                continue
        flush_region()
        touched = set()
        out.append(op)
    flush_region()
    return out


# Matrix operands of one megawin group: every item K2 runs copies its
# pass's side tiles from L2, and the CTAs run items of every pass of the
# group within one window of super-blocks, so the group closes when the
# sides' total would crowd the window's intermediates
# (fused.megawin_schedule) out of the 50 MB L2.
MEGA_MAT_BYTES = 8 << 20


def _winfused_mat_bytes(op) -> int:
    """Bytes of one winfused pass's matrix operands as K2 reads them."""
    a = np.asarray(op[2])
    nbytes = 2 * a.nbytes
    if len(op) > 6 and op[6] is not None:
        nbytes += np.asarray(op[6]).nbytes
    return nbytes


def group_megawins(ops: Sequence[tuple], num_qubits: int) -> List[tuple]:
    """Fold each run of consecutive winfused passes into
    ``("megawin", (passes...))`` groups that run as ONE K2 launch.  A pass
    joins the open group while G = 2^(kmax-7) stays within every member's
    row cap (fused.megawin_row_cap) and the register's row count, the
    group's matrices stay within MEGA_MAT_BYTES and its length within
    fused.MAX_MEGA_PASSES.  Groups of one are left ungrouped."""
    if num_qubits < WINDOW:
        return list(ops)
    nb = 1 << (num_qubits - WINDOW)
    out: List[tuple] = []
    group: List[tuple] = []
    kmax = allowed = mat_bytes = 0

    def close():
        nonlocal group, kmax, allowed, mat_bytes
        if len(group) >= 2:
            out.append(("megawin", tuple(group)))
        else:
            out.extend(group)
        group, kmax, allowed, mat_bytes = [], 0, 0, 0

    for op in ops:
        if op[0] != "winfused":
            close()
            out.append(op)
            continue
        cap = min(fused.megawin_row_cap(int(np.shape(op[2])[0]),
                                        num_qubits), nb)
        nbytes = _winfused_mat_bytes(op)
        if (1 << (op[1] - LANE)) > cap:
            close()
            out.append(op)           # window too wide to ever be grouped
            continue
        if group:
            nk = max(kmax, op[1])
            na = min(allowed, cap)
            if ((1 << (nk - LANE)) <= na
                    and mat_bytes + nbytes <= MEGA_MAT_BYTES
                    and len(group) < fused.MAX_MEGA_PASSES):
                group.append(op)
                kmax, allowed, mat_bytes = nk, na, mat_bytes + nbytes
                continue
            close()
        group, kmax, allowed, mat_bytes = [op], op[1], cap, nbytes
    close()
    return out


# ---------------------------------------------------------------------------
# The paged scheduler (QT_PLANNER=paged)
# ---------------------------------------------------------------------------

_CROSS_RANK = 4  # rank of the |a><b| (x) U_ab decomposition of a 2q gate


class _FoldAcc:
    """Accumulator for the cluster operator as a rank-R Kronecker sum
    sum_r B_r (x) A_r (A_r on lanes 0-6, B_r on 7-13): pure cluster gates
    multiply into every term; one lane x window 2q gate raises R from 1 to
    4 through its |a><b| block decomposition (fused.apply_cluster_stack
    runs the sum in one pass).  NumPy throughout."""

    def __init__(self):
        self.As: List[Optional[np.ndarray]] = [None]  # None = identity
        self.Bs: List[Optional[np.ndarray]] = [None]
        self.rank = 1
        self.count = 0

    def fold(self, cluster: str, bits: Tuple[int, ...], mat):
        e = embed_in_cluster(mat, bits)
        accs = self.As if cluster == "A" else self.Bs
        for r in range(self.rank):
            accs[r] = e if accs[r] is None else soa_matmul(e, accs[r])
        self.count += 1

    def fold_cross(self, phys: Tuple[int, ...], mat):
        """Fold a 2q gate with one lane and one window target; requires
        rank == 1 (the caller flushes first otherwise)."""
        assert self.rank == 1
        mat = np.asarray(mat)
        if phys[0] < LANE:
            la, sb = phys[0], phys[1]

            def block(a, b):
                return mat[:, 2 * a:2 * a + 2, 2 * b:2 * b + 2]
        else:
            sb, la = phys[0], phys[1]

            def block(a, b):
                return mat[:, a::2, b::2]
        A0, B0 = self.As[0], self.Bs[0]
        As, Bs = [], []
        for a in (0, 1):
            for b in (0, 1):
                ea = embed_in_cluster(block(a, b), (la,))
                eb_np = np.zeros((2, 2, 2))
                eb_np[0, a, b] = 1.0
                eb = embed_in_cluster(eb_np, (sb - LANE,))
                As.append(ea if A0 is None else soa_matmul(ea, A0))
                Bs.append(eb if B0 is None else soa_matmul(eb, B0))
        self.As, self.Bs = As, Bs
        self.rank = _CROSS_RANK
        self.count += 1

    def stacks(self):
        return _stack_sides(self.As, self.Bs)

    def reset(self):
        self.As, self.Bs = [None], [None]
        self.rank = 1
        self.count = 0


class _Plan:
    """Mutable planning state of the paged scheduler; emits the ops."""

    def __init__(self, num_qubits: int):
        self.n = num_qubits
        # pos[logical qubit] = current physical position
        self.pos = list(range(num_qubits))
        self.ops: List[tuple] = []
        self.acc = _FoldAcc()
        # relocation segment size bounds: m <= seg_max by the high bits
        # there are; m >= seg_min = 3 unless fewer high bits exist
        self.seg_max = min(LANE, max(0, num_qubits - WINDOW))
        self.seg_min = min(3, self.seg_max) if self.seg_max > 0 else 0

    def flush(self):
        if self.acc.count == 0:
            return
        a, b = self.acc.stacks()
        self.ops.append(("fused", a, b))
        self.acc.reset()

    def _emit_segswap(self, h: int, b: int, m: int):
        """Exchange bit segments [h, h+m) <-> [b, b+m)."""
        self.flush()
        self.ops.append(("segswap", h, b, m))
        newpos = []
        for p in self.pos:
            if b <= p < b + m:
                newpos.append(h + (p - b))
            elif h <= p < h + m:
                newpos.append(b + (p - h))
            else:
                newpos.append(p)
        self.pos = newpos

    def final_restore(self):
        """Return every qubit to its home position with a greedy
        block-sort of segment swaps (the net permutation usually collapses
        to a handful, fewer than replaying the swap history)."""
        self.flush()
        n = self.n
        while True:
            q = next((i for i in range(n) if self.pos[i] != i), None)
            if q is None:
                break
            assert q >= LANE  # lane bits are never relocated
            p = self.pos[q]  # where logical q currently lives (p > q)
            m = 1
            while (
                q + m < p
                and q + m < n
                and p + m < n
                and self.pos[q + m] == p + m
            ):
                m += 1
            self._emit_segswap(p, q, m)


def _cluster_of(phys: Sequence[int]) -> Optional[str]:
    if all(p < LANE for p in phys):
        return "A"
    if all(LANE <= p < WINDOW for p in phys):
        return "B"
    return None


def _is_cross2(phys: Sequence[int]) -> bool:
    """2q gate with one lane (0-6) and one window (7-13) target, foldable
    as a rank-4 Kronecker sum (_FoldAcc.fold_cross)."""
    if len(phys) != 2:
        return False
    a, b = phys
    return (a < LANE <= b < WINDOW) or (b < LANE <= a < WINDOW)


def _peephole(ops: List[tuple], num_qubits: int) -> List[tuple]:
    """Merge each segment swap with the cluster pass that follows it into
    one swap + cluster pass (fused.apply_swap_cluster_stack) when the swap
    is at most fused.MAX_FUSED_SWAP_M bits wide, its high segment lies at
    or above bit 14 and its low one inside the window [7, 14)."""
    out: List[tuple] = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if (
            op[0] == "segswap"
            and i + 1 < len(ops)
            and ops[i + 1][0] == "fused"
            and op[3] <= fused.MAX_FUSED_SWAP_M
            and op[1] >= WINDOW
            and LANE <= op[2]
            and op[2] + op[3] <= WINDOW
        ):
            out.append(("swapfused", op[1], op[2], op[3],
                        ops[i + 1][1], ops[i + 1][2]))
            i += 2
        else:
            out.append(op)
            i += 1
    return out


def plan_circuit_py(gates: Sequence[Gate], num_qubits: int) -> List[tuple]:
    """The paged planner: a dependency-DAG list scheduler over the
    per-qubit program-order queues.  It repeatedly (1) folds every ready
    gate that sits inside the cluster [0, 14) or crosses lane x window,
    (2) when nothing folds, emits the segment swap that makes the most
    ready gates foldable (ties: later eviction, narrower, lower), and
    (3) otherwise pops the lowest ready gate as an 'apply' op.  Every
    qubit is restored home at the end, and swaps followed by a cluster
    pass are fused (_peephole).  Below 14 qubits every gate is an
    'apply' op."""
    n = num_qubits
    glist = list(gates)
    if n < WINDOW:
        return [("apply", g.targets, g.mat) for g in glist]

    plan = _Plan(n)
    num_gates = len(glist)
    queues: List[List[int]] = [[] for _ in range(n)]
    for gi, g in enumerate(glist):
        for t in g.targets:
            queues[t].append(gi)
    heads = [0] * n

    def is_ready(gi):
        return all(
            heads[t] < len(queues[t]) and queues[t][heads[t]] == gi
            for t in glist[gi].targets
        )

    ready = sorted(gi for gi in range(num_gates) if is_ready(gi))
    done = 0

    def pop(gi):
        nonlocal done
        for t in glist[gi].targets:
            heads[t] += 1
        done += 1
        ready.remove(gi)
        for t in glist[gi].targets:
            if heads[t] < len(queues[t]):
                cand = queues[t][heads[t]]
                if cand not in ready and is_ready(cand):
                    ready.append(cand)
        ready.sort()

    def phys_of(gi):
        return tuple(plan.pos[t] for t in glist[gi].targets)

    def try_fold(gi):
        phys = phys_of(gi)
        cl = _cluster_of(phys)
        if cl is not None:
            bits = tuple(p if cl == "A" else p - LANE for p in phys)
            plan.acc.fold(cl, bits, glist[gi].mat)
            pop(gi)
            return True
        if _is_cross2(phys):
            if plan.acc.rank > 1:
                plan.flush()
            plan.acc.fold_cross(phys, glist[gi].mat)
            pop(gi)
            return True
        return False

    def swapped_pos(p, h, b, m):
        if b <= p < b + m:
            return h + (p - b)
        if h <= p < h + m:
            return b + (p - h)
        return p

    def best_swap():
        """(h, b, m) of the segment swap enabling the most ready folds,
        or None if none enables one."""
        if plan.seg_max <= 0:
            return None
        cand_hm = []
        for gi in ready:
            high = [p for p in phys_of(gi) if p >= WINDOW]
            if not high:
                continue
            span = max(high) - min(high) + 1
            for m in range(max(plan.seg_min, span), plan.seg_max + 1):
                lo_h = max(WINDOW, max(high) - m + 1)
                hi_h = min(n - m, min(high))
                if lo_h <= hi_h and (hi_h, m) not in cand_hm:
                    cand_hm.append((hi_h, m))
        if not cand_hm:
            return None
        cand_hm.sort()
        # next-use distance per physical position (capped horizon) over
        # the pending gate-target occurrences in gate order
        next_use = {}
        d = 0
        for gi in range(num_gates):
            if d > _LOOKAHEAD:
                break
            for t in glist[gi].targets:
                if d > _LOOKAHEAD:
                    break
                q = queues[t]
                hpos = heads[t]
                if hpos < len(q) and gi >= q[hpos]:
                    p = plan.pos[t]
                    if p not in next_use:
                        next_use[p] = d
                    d += 1
        best = None
        for h, m in cand_hm:
            for b in range(LANE, WINDOW - m + 1):
                count = 0
                for gi in ready:
                    pp = tuple(swapped_pos(p, h, b, m) for p in phys_of(gi))
                    if _cluster_of(pp) is not None or _is_cross2(pp):
                        count += 1
                evict = min(
                    (next_use.get(p, _LOOKAHEAD + 1) for p in range(b, b + m)),
                    default=0,
                )
                key = (count, evict, -m, -h, -b)
                if best is None or key > best[0]:
                    best = (key, h, b, m)
        # a swap costs one transpose pass and an apply pass several, so
        # relocating for even one foldable gate wins
        if best is None or best[0][0] < 1:
            return None
        return best[1], best[2], best[3]

    while done < num_gates:
        progressed = True
        while progressed:
            progressed = False
            for gi in list(ready):
                if try_fold(gi):
                    progressed = True
        if done == num_gates:
            break
        sw = best_swap()
        if sw is not None:
            plan._emit_segswap(*sw)
            continue
        gi = ready[0]
        plan.flush()
        plan.ops.append(("apply", phys_of(gi), glist[gi].mat))
        pop(gi)
    plan.final_restore()
    return _peephole(plan.ops, n)


def resolve_planner(planner: Optional[str] = None) -> str:
    """The planner to use: ``planner``, or QT_PLANNER when it is None
    (default "windowed")."""
    if planner is None:
        planner = os.environ.get("QT_PLANNER", "windowed")
    if planner not in PLANNERS:
        raise ValueError(
            f"unknown planner {planner!r}: expected 'windowed' or 'paged'"
        )
    return planner


def plan_circuit(gates: Sequence[Gate], num_qubits: int, device=None,
                 planner: Optional[str] = None) -> List[tuple]:
    """Plan a gate list.  ``planner``: "windowed" (offset-window passes,
    no relocation) or "paged" (the segment-swap relocation scheduler,
    plan_circuit_py); None reads QT_PLANNER.  ``device`` is where the plan
    will run: under QT_MEGAKERNEL=auto, windowed plans form megawin
    groups only for a CUDA device.  Paged plans are returned as planned,
    without side-splitting or grouping, as the JAX package returns
    them."""
    if resolve_planner(planner) == "paged":
        return plan_circuit_py(gates, num_qubits)
    ops = plan_circuit_windowed(gates, num_qubits)
    if _side_split_enabled() and num_qubits >= WINDOW:
        ops = split_plan_sides(ops)
    if fused.megakernel_planning(device) and num_qubits >= WINDOW:
        ops = group_megawins(ops, num_qubits)
    return ops


# ---------------------------------------------------------------------------
# Sharded-register relocation: communication at window granularity
# ---------------------------------------------------------------------------

_REMAP_LOOKAHEAD = 256  # next-use horizon for the eviction choice


def remap_exchange_bytes(sigma: Tuple[int, ...], num_qubits: int, nloc: int,
                         itemsize: int = 8) -> int:
    """Bytes one shard exchanges for the batched remap ``sigma``: half a
    shard per mixed local<->mesh transposition, a whole shard for a
    residual composed mesh permute, nothing for the per-shard axis
    permutation."""
    from .parallel import dist as PAR

    r = num_qubits - nloc
    mixed, _local_perm, mesh_tau = PAR.decompose_sigma(sigma, nloc, r)
    shard = 2 * (1 << nloc) * itemsize
    total = len(mixed) * (shard // 2)
    if mesh_tau is not None:
        total += shard
    return total


def remap_exchange_bytes_tiers(sigma: Tuple[int, ...], num_qubits: int,
                               nloc: int, itemsize: int = 8,
                               topology=None) -> Dict[str, int]:
    """remap_exchange_bytes split by tier, {"ici": b, "dcn": b}, summing
    to the flat total."""
    from .parallel import dist as PAR

    r = num_qubits - nloc
    tiers = PAR.remap_exchange_tiers(sigma, nloc, r, itemsize, topology)
    return {tier: b for tier, (_c, b) in tiers.items()}


def plan_remap_windows(bit_sets: Sequence[Tuple[int, ...]], num_qubits: int,
                       nloc: int, perm=None):
    """Group a logical item stream (``bit_sets[i]``: the state-vector bits
    item i touches, or a relabel entry) into windows whose distinct
    qubits fit the shard-local space, one batched remap each; runs of
    relabel entries fold into the permutation with no remap.  The
    permutation persists past the last window (``final_perm``).  Returns
    (segments, final_perm), segments = [((start, end), sigma | None,
    perm_during_window), ...]; ValueError when one item touches more
    than ``nloc`` qubits (quest_tpu/circuit.py plan_remap_windows)."""
    from .parallel import dist as PAR

    n = num_qubits
    perm = tuple(perm) if perm is not None else tuple(range(n))
    segments: List[tuple] = []
    i = 0
    total = len(bit_sets)
    while i < total:
        if _is_relabel_entry(bit_sets[i]):
            j = i
            while j < total and _is_relabel_entry(bit_sets[j]):
                rho = dict(bit_sets[j][1])
                perm = tuple(perm[rho.get(q, q)] for q in range(n))
                j += 1
            segments.append(((i, j), None, perm))
            i = j
            continue
        w: set = set()
        j = i
        while j < total:
            if _is_relabel_entry(bit_sets[j]):
                break
            b = set(bit_sets[j])
            if len(w | b) > nloc:
                break
            w |= b
            j += 1
        if j == i:
            raise ValueError(
                f"plan_remap_windows: item {i} touches {len(set(bit_sets[i]))}"
                f" qubits but only {nloc} can be shard-local")
        # next-use distances over the rest of the stream: evict the local
        # residents needed furthest ahead
        next_use: dict = {}
        d = 0
        for k in range(j, min(total, j + _REMAP_LOOKAHEAD)):
            if _is_relabel_entry(bit_sets[k]):
                continue
            for q in bit_sets[k]:
                if q not in next_use:
                    next_use[q] = d
                d += 1
        sigma, new_perm = PAR.plan_window_remap(
            n, nloc, perm, sorted(w), next_use)
        assert new_perm is not None  # |w| <= nloc makes it feasible
        perm = new_perm
        segments.append(((i, j), sigma, perm))
        i = j
    return segments, perm


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def execute_plan(amps, ops: Sequence[tuple], num_qubits: int,
                 precision: Optional[str] = None, stage=None):
    """Run a plan on ``amps`` (any full-size contiguous view of the state)
    and return the new state, in the same shape.  Window passes go
    through K1, megawin groups through K2, cluster passes through K11,
    swap + cluster passes through K12 and sigma swaps and whole bit
    reversals through K10 (on the CPU, their plain versions); the rest
    are plain PyTorch ops.  The window passes run at ``precision`` (None:
    the mode current at the call, ``fused.set_matmul_precision``).  A
    sigma swap or a reversal works in place on the card: the input is
    consumed.

    ``amps`` may be a (B, 2, 2^n) register bank (a BatchedQureg drain:
    the reference's jax.vmap of its plan executor, quest_tpu/fusion.py
    _plan_runner), whose ops' arrays are shared or carry a leading B axis
    per element (``fused.bank_element_op``).  Window passes, megawin
    groups, cluster and swap + cluster passes, sigma swaps and reversals
    then take the whole bank in one launch each (K1, K2, K11, K12, K10);
    the data-movement ops take it as a batch dimension (``torch.vmap``,
    exact); only dense ``apply`` ops, whose batched product would sum in
    another order, run element by element.  Each element's result equals
    its own drain's bit for bit.  A sigma swap or a reversal on a bank
    comes only from a plan of ``bit_reversal_ops`` at n >= 30 run here:
    no public API sends a QFT into a bank drain.

    ``stage``: {id(op): fused.StagedPass} of the window passes among
    ``ops`` whose operands a drain staged (``fused.stage_ops``, made at
    ``precision`` for this state's device and dtype)."""
    n = num_qubits
    precision = fused.resolve_precision(precision)
    nb = fused.bank_size(amps, n)
    for op in ops:
        kind = op[0]
        staged = stage.get(id(op)) if stage else None
        if nb and kind == "apply":
            amps = torch.stack([execute_plan(
                amps[b], [fused.bank_element_op(op, b)], n,
                precision=precision) for b in range(nb)])
        elif nb and kind in ("segswap", "permute", "xor", "gatherperm"):
            amps = torch.vmap(lambda a, o=op: execute_plan(
                a, [o], n, precision=precision))(amps)
        elif kind == "fused":
            amps = fused.apply_cluster_stack(amps, op[1], op[2],
                                             num_qubits=n,
                                             precision=precision,
                                             staged=staged)
        elif kind == "swapfused":
            amps = fused.apply_swap_cluster_stack(
                amps, op[4], op[5], num_qubits=n, h=op[1], b=op[2], m=op[3],
                precision=precision, staged=staged)
        elif kind == "winfused":
            amps = fused.apply_window_stack(
                amps, op[2], op[3], op[6] if len(op) > 6 else None,
                num_qubits=n, k=op[1], apply_a=op[4], apply_b=op[5],
                precision=precision, staged=staged)
        elif kind == "megawin":
            amps = fused.apply_window_megastack(amps, op[1], num_qubits=n,
                                                precision=precision)
        elif kind == "apply":
            amps = kernels.apply_matrix(amps, op[2], num_qubits=n,
                                        targets=tuple(op[1]))
        elif kind == "segswap":
            amps = kernels.swap_bit_segments(
                amps, num_qubits=n, a=op[1], b=op[2], m=op[3])
        elif kind == "permute":
            amps = kernels.permute_qubits(amps, num_qubits=n, perm=op[1])
        elif kind == "xor":
            amps = kernels.apply_multi_qubit_not(
                amps, num_qubits=n, targets=tuple(op[1]))
        elif kind == "gatherperm":
            amps = kernels.apply_index_permutation(
                amps, num_qubits=n, targets=tuple(op[1]), pi=tuple(op[2]))
        elif kind == "sigma_swap":
            amps = bigstate.apply_sigma_swap(amps, num_qubits=n,
                                             group_bits=op[1])
        elif kind == "sigma_rev":
            amps = bigstate.apply_bit_reversal(amps, num_qubits=n,
                                               group_bits=op[1])
        else:
            raise ValueError(f"unknown op {kind}")
    return amps


def canonical_view(amps, num_qubits: int):
    """The state in its canonical view (2, 2^(n-14), 128, 128): rows =
    amp bits [14, n), then bits [7,14), then lanes [0,7)."""
    if num_qubits < WINDOW:
        return amps
    return amps.reshape(2, 1 << (num_qubits - WINDOW), DIM, DIM)


def plan_to_device(ops: Sequence[tuple], dtype, device) -> List[tuple]:
    """Upload every pass operand once (NumPy -> tensor on ``device``), so
    repeated executions do not re-transfer matrices."""
    def up(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=device).contiguous()

    def up_sides(a, b, apply_a=True, apply_b=True):
        # the window kernels' TF32 exactness, decided here on the host,
        # and on the card the sides as the kernels copy them under the
        # current precision mode (another mode makes its own images); a
        # bank's per-element stacks (B, R, 2, 128, 128) element by element
        ta, tb = up(a), up(b)
        if np.ndim(a) == 5:
            if ta.dtype == torch.float32:
                for t, src in ((ta, a), (tb, b)):
                    fused.note_elem_exact(t, [fused.tf32_exact(src[i])
                                              for i in range(len(src))])
            return ta, tb
        if ta.dtype == torch.float32:
            fused.note_tf32_exact(ta, fused.tf32_exact(a))
            fused.note_tf32_exact(tb, fused.tf32_exact(b))
        if ta.device.type == "cuda":
            fused.prepare_sides(ta, tb, apply_a, apply_b)
        return ta, tb

    out: List[tuple] = []
    for op in ops:
        if op[0] == "winfused":
            mask = op[6] if len(op) > 6 else None
            out.append(("winfused", op[1],
                        *up_sides(op[2], op[3], op[4], op[5]), op[4],
                        op[5], None if mask is None else up(mask)))
        elif op[0] == "megawin":
            out.append(("megawin", tuple(plan_to_device(op[1], dtype,
                                                        device))))
        elif op[0] == "fused":
            out.append(("fused", *up_sides(op[1], op[2])))
        elif op[0] == "swapfused":
            out.append(("swapfused", op[1], op[2], op[3],
                        *up_sides(op[4], op[5])))
        elif op[0] == "apply":
            out.append(("apply", op[1], up(op[2])))
        else:
            out.append(op)
    return out


def apply_circuit(amps, gates: Sequence[Gate], num_qubits: int):
    """Plan (by QT_PLANNER) and execute in one call."""
    return execute_plan(amps, plan_circuit(gates, num_qubits,
                                           device=amps.device), num_qubits)


def execute_plan_chained(amps, ops: Sequence[tuple], num_qubits: int,
                         precision: Optional[str] = None):
    """Execute a plan on the canonical view (the bench route's executor)
    at ``precision`` (as ``execute_plan``); the state is returned in the
    canonical view."""
    return execute_plan(canonical_view(amps, num_qubits), ops, num_qubits,
                        precision=precision)


def stats(ops: Sequence[tuple]) -> dict:
    """Pass-count accounting for logging and launch checks."""
    c = Counter(op[0] for op in ops)
    return {"fused": c.get("fused", 0), "swapfused": c.get("swapfused", 0),
            "winfused": c.get("winfused", 0),
            "megawin": c.get("megawin", 0),
            "megawin_ops": sum(len(op[1]) for op in ops
                               if op[0] == "megawin"),
            "apply": c.get("apply", 0), "segswap": c.get("segswap", 0),
            "permute": c.get("permute", 0),
            "xor": c.get("xor", 0),
            "gatherperm": c.get("gatherperm", 0),
            "sigma_swap": c.get("sigma_swap", 0),
            "sigma_rev": c.get("sigma_rev", 0),
            "total_passes": sum(c.values())}


# ---------------------------------------------------------------------------
# Fused QFT: ladder passes + one scheduled low-qubit pass + the bit reversal
# ---------------------------------------------------------------------------


def _qft_layer_dense(tr: int, conj: bool, dt) -> np.ndarray:
    """Dense matrix of one low QFT layer on tr+1 contiguous qubits (matrix
    bit tr = the layer target): Hadamard on the target followed by the
    controlled-phase ladder diag(1, e^{i pi low / 2^tr}) against the lower
    bits."""
    d = 1 << tr
    low = np.arange(d)
    sgn = -1.0 if conj else 1.0
    ph = np.exp(sgn * 1j * np.pi * low / d)
    inv = 1.0 / np.sqrt(2.0)
    m = np.zeros((2 * d, 2 * d), complex)
    m[low, low] = inv
    m[low, d + low] = inv
    m[d + low, low] = inv * ph
    m[d + low, d + low] = -inv * ph
    return np.stack([m.real, m.imag]).astype(dt)


def fused_qft(amps, num_qubits: int, start: int, count: int,
              shifts: Sequence[int] = (0,), conj_first: bool = False,
              attrs: Optional[dict] = None):
    """QFT on the contiguous qubits [start, start+count), plus a conjugated
    twin per extra entry of ``shifts`` (the density-matrix bra half), as:

      * one ladder pass per high layer (kernels.apply_qft_ladder: Hadamard
        plus the whole controlled-phase ladder, K6/K7 where they apply),
      * the <= 7-qubit low layers folded by the windowed planner,
      * the swap network of all halves as one bit reversal
        (bit_reversal_ops).

    A full or [0, count >= 15) run of a float32 state vector on the card
    takes the multilayer route (_fused_qft_multilayer).  ``conj_first``
    conjugates the first run too (a sharded density register's bra run,
    alone in its shard).  Requires start == 0 or start >= 7 (callers take
    the layered path otherwise).  ``attrs`` (a span's attributes) gets
    ``rev_launches``, the launches of the reversal's ops (1 where K10's
    reversal form does it all).
    The input is consumed: the kernels work in place on the card."""
    n = num_qubits
    if not (start == 0 or start >= LANE):
        raise ValueError("fused_qft needs start == 0 or start >= 7")
    dt = np.float64 if amps.dtype == torch.float64 else np.float32
    if (start == 0 and tuple(shifts) == (0,) and count >= 15
            and fused.qft_multilayer_enabled(amps)):
        return _fused_qft_multilayer(amps, n, count, conj=conj_first,
                                     attrs=attrs)
    dense_gates: List[Gate] = []
    for si, sh in enumerate(shifts):
        conj = si > 0 or conj_first
        base = start + sh
        for qq in range(count - 1, -1, -1):
            if qq >= LANE:
                amps = kernels.apply_qft_ladder(
                    amps, num_qubits=n, target=base + qq, base=base,
                    conj=conj)
            else:
                dense_gates.append(Gate(
                    tuple(range(base, base + qq + 1)),
                    _qft_layer_dense(qq, conj, dt)))
    if dense_gates:
        amps = execute_plan(amps, plan_circuit(dense_gates, n,
                                               device=amps.device), n)
    runs = [(start + sh, count) for sh in shifts]
    rev_ops = bit_reversal_ops(n, runs, dt, device=amps.device)
    if rev_ops is None:
        perm = list(range(n))
        for b, c in runs:
            for i in range(c // 2):
                perm[b + i], perm[b + c - 1 - i] = (
                    perm[b + c - 1 - i], perm[b + i])
        rev_ops = [("permute", tuple(perm))] if perm != list(range(n)) else []
    if attrs is not None:
        attrs["rev_launches"] = len(rev_ops)
    return execute_plan(amps, rev_ops, n)


def _fused_qft_multilayer(amps, n: int, count: int,
                          radix: int = fused.QFT_RADIX_DEFAULT,
                          conj: bool = False, attrs: Optional[dict] = None):
    """Radix-2^k QFT of the run [0, count) of a state vector:

      * layers t >= 14 in chunks of ``radix`` layers a pass (K8),
      * all seven sublane layers (t = 13..7) in one pass (K9),
      * the seven lane layers (t = 6..0) in one window pass,
      * then the reversal: where it runs in place (a full run at 30-34
        qubits, _in_place_reversal) K10's reversal form, one pass;
        elsewhere the lane and sublane within-group reversals fold into
        the lane layers' window pass, and the high groups' reversal
        passes and the group-order reversal come from
        bit_reversal_ops(skip_low_group=True).

    ``attrs`` as fused_qft's.  The reference's per-gate dispatch is ~2.5n
    sweeps (agnostic_applyQFT, QuEST_common.c:836-898)."""
    dt = np.float64 if amps.dtype == torch.float64 else np.float32
    amps = fused.apply_qft_multilayer_ladders(
        amps, num_qubits=n, t_top=count - 1, radix=radix, conj=conj)
    dense_gates = [Gate(tuple(range(qq + 1)), _qft_layer_dense(qq, conj, dt))
                   for qq in range(LANE - 1, -1, -1)]
    runs = [(0, count)]
    in_place = _in_place_reversal(n, runs, dt, amps.device)
    if not in_place:
        rev7 = _rev_perm_mat(LANE, dt)
        dense_gates.append(Gate(tuple(range(LANE)), rev7))
        dense_gates.append(Gate(tuple(range(LANE, 2 * LANE)), rev7))
    ops = plan_circuit(dense_gates, n, device=amps.device)
    rev_ops = bit_reversal_ops(n, runs, dt, skip_low_group=not in_place,
                               device=amps.device)
    if attrs is not None:
        attrs["rev_launches"] = len(rev_ops)
    return execute_plan(amps, list(ops) + rev_ops, n)


def _rev_perm_mat(bits: int, dt, off: int = 0) -> np.ndarray:
    """SoA 128x128 permutation matrix reversing bits [off, off+bits) of a
    7-bit cluster index (other bits untouched)."""
    d = 1 << LANE
    mask = ((1 << bits) - 1) << off
    m = np.zeros((d, d))
    for i in range(d):
        seg = (i & mask) >> off
        rev = int(format(seg, f"0{bits}b")[::-1], 2) if bits else 0
        m[(i & ~mask) | (rev << off), i] = 1.0
    return np.stack([m, np.zeros((d, d))]).astype(dt)


def _bit_reversal_big(n: int, dt, skip_low_group: bool = False) -> List[tuple]:
    """Bit reversal of the full state with no out-of-place transpose:
    rev[0, n) = (within-group reversals, window passes) o sigma for the
    palindromic group split (7, 7, n-28, 7, 7), sigma (swap bits
    [0,7) <-> [n-7,n) and [7,14) <-> [n-14,n-7)) running in place (K10).
    An out-of-place transpose would need a second full-state buffer."""
    r = n - 28
    ops: List[tuple] = []
    rev7 = _rev_perm_mat(LANE, dt)
    eye = _eye_cluster().astype(dt)
    if not skip_low_group:
        ops.append(("winfused", LANE, rev7[None], rev7[None], True, True))
    if r:
        m = _rev_perm_mat(r, dt, off=0)
        ops.append(("winfused", WINDOW, eye[None], m[None], False, True))
    for k in (WINDOW + r, n - LANE):
        ops.append(("winfused", k, eye[None], rev7[None], False, True))
    ops.append(("sigma_swap", LANE))
    return ops


def _in_place_reversal(n: int, runs: Sequence[Tuple[int, int]], dt,
                       device) -> bool:
    """Whether the reversal of ``runs`` takes the in-place route: a single
    full run at 30 <= n < 35 of a float32 state on the card (``device``),
    where an out-of-place transpose would need a second full-state
    buffer."""
    return (len(runs) == 1 and tuple(runs[0]) == (0, n) and 30 <= n < 35
            and np.dtype(dt) == np.float32 and device is not None
            and torch.device(device).type == "cuda")


def bit_reversal_ops(n: int, runs: Sequence[Tuple[int, int]], dt,
                     skip_low_group: bool = False,
                     device=None) -> Optional[List[tuple]]:
    """Ops reversing the qubit order of each contiguous run (start, count),
    or None when no fast decomposition applies.

    Each run splits into 7-bit groups: rev(run) = (reverse the order of
    the groups) o (reverse within each group).  The within-group reversals
    are window-pass permutation matrices at the groups' own positions (the
    lane group rides the A side of the first pass), and the group-order
    reversal of all runs is one axis permutation.

    A single full run at 30 <= n < 35 of a float32 state on the card
    (``device``, _in_place_reversal) takes the in-place route instead:
    the transpose would need a second full-state buffer.  There the whole
    reversal is one op, ``('sigma_rev', 7)`` (K10's reversal form).

    ``skip_low_group=True`` omits the merged lane+sublane within-group
    reversal pass (the caller folds those two reversals into its own dense
    window pass, _fused_qft_multilayer); it needs a single run starting at
    0 with two full 7-bit low groups."""
    if skip_low_group and not (
            len(runs) == 1 and runs[0][0] == 0 and runs[0][1] >= 14):
        raise ValueError("skip_low_group needs one run = (0, count >= 14)")
    if not skip_low_group and _in_place_reversal(n, runs, dt, device):
        return [("sigma_rev", LANE)]
    ops: List[tuple] = []
    perm = list(range(n))
    eye = _eye_cluster().astype(dt)
    for start, count in runs:
        if count <= 1:
            continue
        if not (start == 0 or start >= LANE):
            return None
        groups = []
        o = start
        while o < start + count:
            sz = min(LANE, start + count - o)
            groups.append((o, sz))
            o += sz
        # within-group reversal passes (the lane group merges into the
        # second group's window pass when both exist)
        i0 = 0
        if groups[0][0] == 0:
            if len(groups) > 1 and groups[1][1] > 1:
                if not skip_low_group:
                    a_mat = _rev_perm_mat(groups[0][1], dt)
                    o1, sz1 = groups[1]
                    k1 = min(o1, n - LANE)
                    b_mat = _rev_perm_mat(sz1, dt, off=o1 - k1)
                    ops.append(("winfused", k1, a_mat[None], b_mat[None],
                                True, True))
                i0 = 2
            else:
                a_mat = _rev_perm_mat(groups[0][1], dt)
                ops.append(("winfused", LANE, a_mat[None], eye[None],
                            True, False))
                i0 = 1
        for o, sz in groups[i0:]:
            if sz <= 1:
                continue
            k = min(o, n - LANE)
            b_mat = _rev_perm_mat(sz, dt, off=o - k)
            ops.append(("winfused", k, eye[None], b_mat[None], False, True))
        # group-order reversal: new offset of group i = start + the total
        # size of the groups after it (order kept within groups)
        off = start
        for o, sz in reversed(groups):
            for j in range(sz):
                perm[off + j] = o + j
            off += sz
    if perm != list(range(n)):
        ops.append(("permute", tuple(perm)))
    return ops


# ---------------------------------------------------------------------------
# Plan (de)composition: static skeleton + array operands
# ---------------------------------------------------------------------------


def split_plan(ops: Sequence[tuple]):
    """(hashable skeleton, array list): separates a plan into its static
    structure and its array operands (fusion's plan cache keys on the
    former)."""
    skeleton: List[tuple] = []
    arrays: List[object] = []
    for op in ops:
        if op[0] == "winfused":
            mask = op[6] if len(op) > 6 else None
            skeleton.append(("winfused", op[1], tuple(np.shape(op[2])),
                             op[4], op[5], mask is not None))
            arrays.extend([op[2], op[3]])
            if mask is not None:
                arrays.append(mask)
        elif op[0] == "megawin":
            sub_sk, sub_arrays = split_plan(op[1])
            skeleton.append(("megawin", sub_sk))
            arrays.extend(sub_arrays)
        elif op[0] == "apply":
            skeleton.append(("apply", tuple(op[1]), tuple(np.shape(op[2]))))
            arrays.append(op[2])
        elif op[0] == "fused":
            skeleton.append(("fused", tuple(np.shape(op[1]))))
            arrays.extend([op[1], op[2]])
        elif op[0] == "swapfused":
            skeleton.append(("swapfused", op[1], op[2], op[3],
                             tuple(np.shape(op[4]))))
            arrays.extend([op[4], op[5]])
        else:
            skeleton.append(tuple(op))
    return tuple(skeleton), arrays


def rebuild_plan(skeleton: Sequence[tuple], arrays: Sequence) -> List[tuple]:
    """Inverse of split_plan."""
    return _rebuild_plan_iter(skeleton, iter(arrays))


def _rebuild_plan_iter(skeleton: Sequence[tuple], it) -> List[tuple]:
    ops: List[tuple] = []
    for sk in skeleton:
        if sk[0] == "winfused":
            a, b = next(it), next(it)
            mask = next(it) if sk[5] else None
            ops.append(("winfused", sk[1], a, b, sk[3], sk[4], mask))
        elif sk[0] == "megawin":
            ops.append(("megawin", tuple(_rebuild_plan_iter(sk[1], it))))
        elif sk[0] == "apply":
            ops.append(("apply", sk[1], next(it)))
        elif sk[0] == "fused":
            ops.append(("fused", next(it), next(it)))
        elif sk[0] == "swapfused":
            a, b = next(it), next(it)
            ops.append(("swapfused", sk[1], sk[2], sk[3], a, b))
        else:
            ops.append(sk)
    return ops


def plan_checkpoint_boundaries(num_gates: int, every: int,
                               start: int = 0) -> List[int]:
    """Gate cursors where a resumable run may checkpoint: every ``every``
    gates plus the stream end (quest_tpu/circuit.py:1750-1764).
    ``resilience.run_resumable`` drains one fusion window per span
    between two boundaries, so a checkpoint never lands mid-window and a
    resumed run re-plans the same window sequence."""
    if every < 1:
        raise ValueError("plan_checkpoint_boundaries: every must be >= 1")
    out = list(range(start + every, num_gates, every))
    if num_gates > start:
        out.append(num_gates)
    return out
