"""Circuit optimizer: rewrite the pending gate stream before planning.

The counterpart of the JAX package's ``optimizer.py`` for registers on
one device, where fewer gates is strictly better and the rewrite is taken
unconditionally:

* **Cancellation / merging**: a gate searches backwards through gates it
  commutes with for a same-target partner and composes with it (one host
  matmul).  A product that is EXACTLY the identity cancels (X·X, CNOT·
  CNOT); anything else replaces the partner as one merged gate.
* **Diagonal coalescing**: maximal runs of adjacent diagonal gates
  collapse into one diagonal gate on the union targets.
* **Permutation coalescing**: maximal runs of adjacent permutation gates
  (X / CNOT / Toffoli / SWAP chains) compose by exact integer index
  arithmetic into one permutation gate; identity products drop.

``QT_OPTIMIZER=off|on|aggressive`` (default ``on``) selects the mode, and
``set_circuit_optimizer`` (``setCircuitOptimizer``) overrides it: ``off``
drains the stream verbatim, ``aggressive`` also drops a merged pair whose
product is the identity only up to the dtype's rounding (H.H).  The mode
is part of the rewrite's cache key.

On a sharded register every rewrite is a candidate scored by the
exchange cost model (``_stream_cost``: tier-weighted exchange bytes,
exchange count, remap windows, the canonical read's remap included),
program order among them, and the commutation-aware reordering
(``_reorder``: greedy locality-clustering linearizations of the
commutation DAG) is tried on each; the cheapest stream drains
(quest_tpu/optimizer.py:417-509,588-629).

Channels (``fusion.ChannelItem``) are never composed or dropped; a gate
looks back past one only when their supports are disjoint, so channels
keep their order relative to each other and to every gate they touch.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import circuit as C
from . import telemetry as _telemetry

_MODES = ("off", "on", "aggressive")

# programmatic override (setCircuitOptimizer); None = read QT_OPTIMIZER
_OVERRIDE: List[Optional[str]] = [None]

# widest coalesced gate — mirrors fusion.FUSION_MAX_GATE_QUBITS
MAX_GATE_QUBITS = 7

# memoized rewrites: a hot angle-sweep loop re-drains the same stream
_CACHE_MAX = 128
_cache: dict = {}

# longest stream the reordering considers (its DAG is quadratic)
_REORDER_MAX_ITEMS = 512

# suppression depth (suppressed()): > 0 makes optimize_items return the
# stream verbatim whatever the mode
_SUPPRESS: List[int] = [0]


def mode() -> str:
    """Active optimizer mode: the ``set_circuit_optimizer`` override when
    set, else ``QT_OPTIMIZER`` (default ``on``)."""
    if _OVERRIDE[0] is not None:
        return _OVERRIDE[0]
    m = os.environ.get("QT_OPTIMIZER", "on").strip().lower()
    return m if m in _MODES else "on"


def set_circuit_optimizer(m: Optional[str]) -> None:
    """Override the optimizer mode (``None`` returns control to the
    ``QT_OPTIMIZER`` environment variable)."""
    if m is not None:
        m = str(m).strip().lower()
        if m not in _MODES:
            from .validation import QuESTError

            raise QuESTError(
                f"setCircuitOptimizer: unknown mode {m!r} "
                f"(expected one of {'/'.join(_MODES)})")
    _OVERRIDE[0] = m


def get_circuit_optimizer() -> str:
    """The active optimizer mode string."""
    return mode()


class suppressed:
    """Context manager making :func:`optimize_items` return the stream
    verbatim for the drains it encloses (quest_tpu/optimizer.py:123-140).
    Window-stepped execution (resilience.WindowExecutor) drains one
    window at a time and its checkpoint cursor indexes the raw gate list;
    a resumed run may re-enter the stream on another mesh and under
    another live permutation, on which the cost-scored rewrite depends,
    so those drains run under ``suppressed()``."""

    def __enter__(self):
        _SUPPRESS[0] += 1
        return self

    def __exit__(self, *exc):
        _SUPPRESS[0] -= 1
        return False


def _is_gate(it) -> bool:
    return isinstance(it, C.Gate)


def _concrete(it) -> bool:
    """A gate whose matrix is host data: a (2, s, s) stack, or a bank's
    per-element (B, 2, s, s) stack."""
    return _is_gate(it) and isinstance(it.mat, np.ndarray) \
        and it.mat.ndim in (3, 4)


def _bits(it) -> frozenset:
    """The state-vector bits an item touches: a gate's targets, a
    channel's ket and bra bits."""
    if _is_gate(it):
        return frozenset(it.targets)
    return frozenset((it.target, it.bra))


def _soa_matmul_any(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Complex SoA product of (2, s, s) and per-element (B, 2, s, s)
    stacks, a shared operand broadcast across a batched one.  Two (2, s,
    s) stacks go through circuit.soa_matmul, so a merged gate equals the
    planner's fold of the same pair bit for bit."""
    if a.ndim == 3 and b.ndim == 3:
        return C.soa_matmul(a, b)
    ar, ai = a[..., 0, :, :], a[..., 1, :, :]
    br, bi = b[..., 0, :, :], b[..., 1, :, :]
    return np.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], axis=-3)


def _near_identity(m: np.ndarray) -> bool:
    """Identity up to the dtype's diagonal-detection tolerance: the
    ``aggressive`` drop for merged pairs like H.H whose product is the
    identity only up to rounding (every element of a per-element
    stack)."""
    eye = np.eye(m.shape[-1], dtype=m.dtype)
    tol = 1e-5 if m.dtype == np.float32 else 1e-10
    return bool(np.abs(m[..., 0, :, :] - eye).max() <= tol
                and np.abs(m[..., 1, :, :]).max() <= tol)


def _is_diag(it) -> bool:
    return _concrete(it) and it.mat.ndim == 3 and C.is_diag_gate(it.mat)


def _is_perm(it) -> bool:
    return _concrete(it) and it.mat.ndim == 3 \
        and C.classify_permutation_gate(it.mat) is not None


def _mats_commute(a: np.ndarray, b: np.ndarray) -> bool:
    ab = _soa_matmul_any(a, b)
    ba = _soa_matmul_any(b, a)
    tol = 1e-5 if ab.dtype == np.float32 else 1e-10
    return bool(np.abs(ab - ba).max() <= tol)


def _commutes(a, b, diag_a: bool, diag_b: bool) -> bool:
    """May items ``a`` and ``b`` swap order?  Disjoint supports, both
    diagonal, or the same targets with numerically commuting matrices; a
    channel commutes only by disjointness."""
    if not (_bits(a) & _bits(b)):
        return True
    if not (_is_gate(a) and _is_gate(b)):
        return False
    if diag_a and diag_b:
        return True
    if (tuple(a.targets) == tuple(b.targets) and _concrete(a)
            and _concrete(b) and a.mat.ndim == 3 and b.mat.ndim == 3):
        return _mats_commute(a.mat, b.mat)
    return False


def _cancel_merge(items: list, removed: dict, aggressive: bool) -> list:
    """Each gate looks backwards through gates it commutes with for a
    same-target partner: an exact-identity product (or, when
    ``aggressive``, a near-identity one) cancels the pair, anything else
    replaces the partner (``new @ old``)."""
    out: list = []
    diag: list = []
    for it in items:
        if not _concrete(it):
            out.append(it)
            diag.append(False)
            continue
        d_it = _is_diag(it)
        j = len(out) - 1
        composed = False
        while j >= 0:
            prev = out[j]
            if _concrete(prev) and tuple(prev.targets) == tuple(it.targets):
                merged = _soa_matmul_any(it.mat, prev.mat)
                if C.is_identity_gate(merged) or (
                        aggressive and _near_identity(merged)):
                    out.pop(j)
                    diag.pop(j)
                    removed["cancel"] += 2
                else:
                    out[j] = C.Gate(prev.targets, merged)
                    diag[j] = _is_diag(out[j])
                    removed["merge"] += 1
                composed = True
                break
            if _commutes(prev, it, diag[j], d_it):
                j -= 1
                continue
            break
        if not composed:
            out.append(it)
            diag.append(d_it)
    return out


def _compose_diag_run(run: Sequence[C.Gate]) -> C.Gate:
    """One diagonal gate on the sorted union of a run's targets."""
    union = sorted({t for g in run for t in g.targets})
    upos = {t: i for i, t in enumerate(union)}
    d = 1 << len(union)
    idx = np.arange(d)
    dt = np.result_type(*[g.mat.dtype for g in run])
    re = np.ones(d, dtype=dt)
    im = np.zeros(d, dtype=dt)
    for g in run:
        sub = np.zeros(d, dtype=np.int64)
        for i, t in enumerate(g.targets):
            sub |= ((idx >> upos[t]) & 1) << i
        m = np.asarray(g.mat, dtype=dt)
        gidx = np.arange(m.shape[-1])
        gd = m[:, gidx, gidx]
        gre, gim = gd[0][sub], gd[1][sub]
        re, im = re * gre - im * gim, re * gim + im * gre
    mat = np.zeros((2, d, d), dtype=dt)
    mat[0][idx, idx] = re
    mat[1][idx, idx] = im
    return C.Gate(tuple(union), mat)


def _coalesce(items: list, removed: dict, nloc: int, pred, compose,
              key: str) -> list:
    """Collapse maximal runs of ADJACENT items satisfying ``pred`` whose
    union target set fits one fused gate; ``compose`` returns the merged
    gate, or None when the run is the identity."""
    cap = min(MAX_GATE_QUBITS, nloc)
    out: list = []
    run: list = []
    runbits: set = set()

    def flush():
        if len(run) >= 2:
            g = compose(run)
            if g is None:
                removed[key] += len(run)
            else:
                out.append(g)
                removed[key] += len(run) - 1
        else:
            out.extend(run)
        run.clear()
        runbits.clear()

    for it in items:
        if pred(it):
            b = set(it.targets)
            if len(runbits | b) > cap:
                flush()
            run.append(it)
            runbits |= b
        else:
            flush()
            out.append(it)
    flush()
    return out


def _compose_perm_run(run: Sequence[C.Gate]):
    """One permutation gate equal to the run (exact integer arithmetic),
    or None when the run composes to the identity."""
    union, pi = C.compose_permutation_run(run)
    d = 1 << len(union)
    idx = np.arange(d)
    if np.array_equal(np.asarray(pi), idx):
        return None
    dt = np.result_type(*[g.mat.dtype for g in run])
    mat = np.zeros((2, d, d), dtype=dt)
    mat[0, idx, np.asarray(pi)] = 1.0
    return C.Gate(tuple(union), mat)


def _rewrite(items: list, nloc: int, aggressive: bool,
             coalesce: bool = True) -> tuple:
    """cancel/merge (+ diagonal and permutation coalescing when
    ``coalesce``) to a small fixpoint.  Returns (items, removed)."""
    removed = {"cancel": 0, "merge": 0, "diag_coalesce": 0,
               "perm_coalesce": 0}
    out = list(items)
    for _ in range(3):
        before = len(out)
        out = _cancel_merge(out, removed, aggressive)
        if coalesce:
            out = _coalesce(out, removed, nloc, _is_diag,
                            _compose_diag_run, "diag_coalesce")
            out = _coalesce(out, removed, nloc, _is_perm,
                            _compose_perm_run, "perm_coalesce")
        if len(out) == before:
            break
    return out, removed


# ---------------------------------------------------------------------------
# Commutation-aware reordering (sharded registers)
# ---------------------------------------------------------------------------


def _stream_cost(items: Sequence, n: int, nloc: int, perm0) -> tuple:
    """The exchange cost of draining ``items`` in this order from the live
    permutation ``perm0``: (tier-weighted bytes, exchange count, remap
    windows), the canonical read's remap included, so clustering cannot
    win by deferring cost to the read."""
    from . import fusion as F
    from .parallel import dist as PAR
    from .parallel import topology as _topo

    nsh = n - nloc
    weights = _topo.tier_weights()
    segments, final_perm = C.plan_remap_windows(
        [F._item_entry(it) for it in items], n, nloc, perm0)
    sigmas = [s for _ij, s, _p in segments if s is not None]
    if final_perm is not None and list(final_perm) != list(range(n)):
        sigmas.append(PAR.canonical_sigma(tuple(final_perm)))
    count = 0
    weighted = 0.0
    for sigma in sigmas:
        count += PAR.remap_exchange_count(tuple(sigma), nloc, nsh)
        for tier, b in C.remap_exchange_bytes_tiers(
                tuple(sigma), n, nloc).items():
            weighted += weights.get(tier, 1.0) * b
    return (weighted, count, len(segments))


def _greedy_order(items: Sequence, nloc: int, prefer_overlap: bool) -> list:
    """Greedy linearization of the commutation DAG: schedule the ready
    item that grows the current window's qubit set least
    (``prefer_overlap`` breaks ties toward the largest overlap)."""
    k = len(items)
    bits = [_bits(it) for it in items]
    diag = [_is_diag(it) for it in items]
    preds = [0] * k
    succs: List[List[int]] = [[] for _ in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            if not _commutes(items[i], items[j], diag[i], diag[j]):
                preds[j] += 1
                succs[i].append(j)
    ready = [i for i in range(k) if preds[i] == 0]
    order: list = []
    window: set = set()
    while ready:
        best = None
        for i in ready:
            grow = len(bits[i] - window)
            if len(window | bits[i]) > nloc:
                grow = len(bits[i]) + nloc  # forces a fresh window
            key = (grow, -len(bits[i] & window), i) if prefer_overlap \
                else (grow, i)
            if best is None or key < best[0]:
                best = (key, i)
        i = best[1]
        if len(window | bits[i]) > nloc:
            window = set()
        window |= bits[i]
        order.append(i)
        ready.remove(i)
        for j in succs[i]:
            preds[j] -= 1
            if preds[j] == 0:
                ready.append(j)
    return order


def _reorder(items: list, n: int, nloc: int, perm0,
             aggressive: bool) -> tuple:
    """Keep the first greedy linearization the cost model scores strictly
    cheaper than program order.  Returns (items, reordered, cost_before,
    cost_after)."""
    base = _stream_cost(items, n, nloc, perm0)
    if len(items) < 3 or len(items) > _REORDER_MAX_ITEMS:
        return items, False, base, base
    variants = (False, True) if aggressive else (False,)
    best_items, best_cost = items, base
    for prefer_overlap in variants:
        order = _greedy_order(items, nloc, prefer_overlap)
        if order == list(range(len(items))):
            continue
        cand = [items[i] for i in order]
        cost = _stream_cost(cand, n, nloc, perm0)
        if cost < best_cost:
            best_items, best_cost = cand, cost
    return best_items, best_items is not items, base, best_cost


def _optimize_sharded(items: list, n: int, nloc: int, perm0,
                      aggressive: bool) -> tuple:
    """The sharded rewrite: the full rewrite and (when it coalesced
    diagonals) the cancel/merge-only rewrite are candidates, each
    reordered; the cheapest (cost, gate count) wins over program order
    only when strictly cheaper.  Returns (items, removed, reordered,
    windows): ``windows`` is (remap windows before, after), or None when
    the stream is not plannable in the remap-window model."""
    none = {"cancel": 0, "merge": 0, "diag_coalesce": 0,
            "perm_coalesce": 0}
    out, removed = _rewrite(items, nloc, aggressive, True)
    try:
        candidates = [(out, removed)]
        if removed["diag_coalesce"]:
            candidates.append(_rewrite(items, nloc, aggressive, False))
        best = None
        for cand, rem in candidates:
            cand, reord, _pre, cost = _reorder(cand, n, nloc, perm0,
                                               aggressive)
            ngates = sum(1 for it in cand if _is_gate(it))
            key = (cost, ngates)
            if best is None or key < best[0]:
                best = (key, cand, rem, reord)
        gates_in = sum(1 for it in items if _is_gate(it))
        base = _stream_cost(items, n, nloc, perm0)
        if best[0] < (base, gates_in):
            return (best[1], best[2], best[3],
                    (int(base[2]), int(best[0][0][2])))
        return list(items), none, False, (int(base[2]), int(base[2]))
    except ValueError:
        # not plannable in the remap-window model (an item wider than the
        # shard-local space): keep the rewrite in program order
        return out, removed, False, None


def _content_key(items, nloc: int, m: str, n: int = 0, nsh: int = 0,
                 perm0=None):
    """Memoization key: the mode, gate content bytes, and (kind, target,
    bra) for a channel, whose probability is a run-time value; on a
    sharded register also n, the shard bits, the starting permutation
    and the topology's signature."""
    parts = []
    for it in items:
        if not _is_gate(it):
            parts.append(("chan", it.kind, it.target, it.bra))
            continue
        mat = it.mat
        if not isinstance(mat, np.ndarray):
            return None
        parts.append((tuple(it.targets), mat.dtype.str, mat.shape,
                      mat.tobytes()))
    sharded = None
    if nsh:
        from .parallel import topology as _topo

        sharded = (n, nsh, None if perm0 is None else tuple(perm0),
                   _topo.signature(1 << nsh))
    return (m, nloc, sharded, tuple(parts))


def _freeze_out(items, out) -> tuple:
    """Cache form of a rewritten stream: each channel is replaced by its
    input index, so a hit splices in the current call's channels (and
    their probabilities), not the first call's."""
    pos = {id(it): i for i, it in enumerate(items)}
    return tuple(it if _is_gate(it) else ("__chan__", pos[id(it)])
                 for it in out)


def _thaw_out(items, frozen) -> list:
    return [items[e[1]] if isinstance(e, tuple) else e for e in frozen]


def optimize_items(items: Sequence, *, nloc: int, n: Optional[int] = None,
                   nsh: int = 0, perm0=None,
                   quiet: bool = False) -> Tuple[list, dict]:
    """Rewrite a drain's item stream under the active mode; returns
    (items, stats).  ``nloc`` is the register's local bits (all of them
    on one device); a sharded drain passes its ``n``, shard bits ``nsh``
    and starting permutation ``perm0``, and takes the cost-scored
    sharded rewrite.  Unless ``quiet``, records optimizer_seconds (on a
    rewrite, not a memoized hit), optimizer_gates_removed_total{kind}
    and optimizer_windows_merged_total (quest_tpu/optimizer.py:683-697)."""
    m = mode() if not _SUPPRESS[0] else "off"
    items = list(items)
    gates_in = sum(1 for it in items if _is_gate(it))
    none = {"mode": m, "gates_in": gates_in, "gates_out": gates_in,
            "reordered": False, "windows_before": None,
            "windows_after": None,
            "removed": {"cancel": 0, "merge": 0, "diag_coalesce": 0,
                        "perm_coalesce": 0}}
    if m == "off" or len(items) < 2:
        return items, none
    if nsh and any(_is_gate(it) and not isinstance(it.mat, np.ndarray)
                   for it in items):
        return items, none
    key = _content_key(items, nloc, m, n or 0, nsh, perm0)
    hit = _cache.get(key) if key is not None else None
    if hit is not None:
        out, stats = _thaw_out(items, hit[0]), hit[1]
    else:
        t0 = time.perf_counter()
        reordered = False
        windows = None
        if nsh:
            out, removed, reordered, windows = _optimize_sharded(
                items, n, nloc, perm0, m == "aggressive")
        else:
            out, removed = _rewrite(items, nloc, m == "aggressive")
        stats = {"mode": m, "gates_in": gates_in,
                 "gates_out": sum(1 for it in out if _is_gate(it)),
                 "removed": dict(removed), "reordered": bool(reordered),
                 "windows_before": None if windows is None else windows[0],
                 "windows_after": None if windows is None else windows[1]}
        if not quiet:
            _telemetry.observe("optimizer_seconds",
                               time.perf_counter() - t0)
        if key is not None:
            if len(_cache) >= _CACHE_MAX:
                _cache.pop(next(iter(_cache)))
            _cache[key] = (_freeze_out(items, out), stats)
    if not quiet and _telemetry.enabled():
        for kind, v in stats["removed"].items():
            if v:
                _telemetry.inc("optimizer_gates_removed_total", v,
                               kind=kind)
        wb, wa = stats["windows_before"], stats["windows_after"]
        if wb is not None and wa is not None and wb > wa:
            _telemetry.inc("optimizer_windows_merged_total", wb - wa)
    return list(out), stats


def summary_line() -> str:
    """``Optimizer=...`` fragment of getEnvironmentString: the active
    mode, plus the gates removed and remap windows merged once any were
    recorded."""
    m = mode()
    removed = _telemetry.counter_total("optimizer_gates_removed_total")
    merged = _telemetry.counter_total("optimizer_windows_merged_total")
    s = f"Optimizer={m}"
    if removed or merged:
        s += f"(removed={int(removed)} windows_merged={int(merged)})"
    return s
