"""Gate fusion for the imperative API: batch gates, execute in few passes.

Inside a ``gateFusion(qureg)`` context, gates issued through the ordinary
imperative API (hadamard, controlledNot, unitary, ...) are BUFFERED
instead of executed, and drained through the circuit optimizer and the
planner (windowed, or paged under QT_PLANNER=paged) the moment anything
needs the amplitudes:

    with qt.gateFusion(q):
        for d in range(depth):
            for t in range(n):
                qt.unitary(q, t, u[d, t])
            for t in range(d % 2, n - 1, 2):
                qt.controlledNot(q, t, t + 1)
    p = qt.calcProbOfOutcome(q, n - 1, 0)      # any read drains

Semantics are identical to the unfused path: validation and QASM
recording happen per call, in call order, and any read of the state
drains the buffer first via the ``Qureg.amps`` property.  A drain splits
the optimized stream into runs of permutation gates (lowered to
matrix-free index ops), dense runs (planned into window passes) and runs
of decoherence channels, and executes them in order on the register's
tensor.  On a density register a Kraus channel is buffered as its
superoperator, a dense gate on (T, T+n) (``capture_raw``); depolarising
and damping are buffered as ``ChannelItem``s (``capture_pair_channel``),
and a run of them drains through the K5 sweep kernel on the card
(``fused.apply_pair_channel_sweep``) or channel by channel
(``density.apply_pair_channel``).

On a sharded register (``Qureg.is_sharded``) the drain groups the stream
into windows whose qubits fit the shard-local space, brings each
window's qubits local with one batched remap (``("remap", sigma)``
parts, parallel/dist.py) and rewrites the window's items to their
physical bits; every other part runs shard by shard, each shard running
the same local program on its ``(2, 2^nloc)`` tensor (so on the card K1,
K2 and K5 launch once per shard for each pass, group and sweep).  The
permutation a drain leaves stays on the register (``Qureg._perm``) until
a read restores canonical order (quest_tpu/fusion.py
_split_items_sharded and the "remap" parts of its runner).  A sharded
register bank (batch.BatchedQureg on a mesh) drains the same way with
``(B, 2, 2^nloc)`` shards: one program for the whole bank (per-element
plans of one skeleton and one final permutation, stacked, under batch
flag 2), one exchange per remap moving every element, and K1, K2 and K5
in their bank forms, one launch per pass, group or sweep on each shard.

A drain of a plan the memory tier holds feeds its window passes from
their operands staged once in host memory (``_program_stage``,
``fused.stage_ops``: one pinned block per program, one copy a pass).

Every drain runs under the memory governor (governor.govern_drain: the
program as it is, or split into dispatch groups, after spilling idle
registers if need be; each group through governor.oom_net), and a
sharded drain holds its window-remap counters against the cost model's
prediction (introspect.reconcile_drain).  ``plan_items_quiet`` plans a
drain without running it, recording nothing (explainCircuit).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from functools import partial
from typing import List

import numpy as np
import torch

from . import aotcache as _aot
from . import circuit as C
from . import optimizer as _opt
from . import telemetry as _telemetry
from .ops import cplx as _cplx
from .ops import density as _density
from .ops import fused as _fused

# largest dense gate (targets + controls) worth buffering; anything bigger
# executes eagerly
FUSION_MAX_GATE_QUBITS = 7


class FusionBuffer:
    __slots__ = ("gates", "t0_ns", "parent")

    def __init__(self):
        # C.Gate and ChannelItem entries, executed in order by the drain
        self.gates: List[object] = []
        # the capture's start (telemetry.now_ns; 0: not stamped) and the
        # span open when it began: the drain's fusion.capture record
        self.t0_ns = 0
        self.parent = None

    def add(self, *items) -> None:
        """Buffer ``items`` in order: every capture path buffers through
        here, so the first item into an empty buffer stamps the start of
        the capture."""
        if not self.gates:
            self.t0_ns = _telemetry.now_ns()
            self.parent = _telemetry.current_span()
        self.gates.extend(items)


def start_gate_fusion(qureg) -> None:
    """Begin buffering gates on ``qureg`` (idempotent)."""
    if qureg._fusion is None:
        qureg._fusion = FusionBuffer()


def stop_gate_fusion(qureg) -> None:
    """Drain any buffered gates and stop buffering.  If execution fails
    the buffer stays attached with its gates intact."""
    drain(qureg)
    qureg._fusion = None


def drain(qureg) -> None:
    """Execute buffered gates now (called from the Qureg.amps property).
    On failure the gates are restored to the buffer.  Counts
    ``fusion_drains_total`` and ``_drain_count`` (the resilience layer's
    window-boundary count), observes ``fusion_drain_gates``, runs under
    the ``fusion.drain`` span, and samples the memory watermark after the
    drain (quest_tpu/fusion.py:71-94).

    The drain's spans, each with the ``drain`` attr (the fusion.drain
    record's id): ``fusion.capture`` (ring only: from the first item
    buffered to the drain's start; ``gates``), and inside fusion.drain
    ``fusion.optimize`` (``items_in``, ``items_out``), ``fusion.lookup``
    (key and plan-cache lookup; ``source``: memory, disk or planned;
    ``fusion.plan`` inside it on a miss), ``fusion.govern`` (the governor
    and the program accounting) and one ``fusion.dispatch`` per program
    group (its host enqueue; attrs: the group's op counts,
    ``program_stats``)."""
    buf = qureg._fusion
    if buf is not None and buf.gates:
        gates, buf.gates = buf.gates, []
        t0_ns, buf.t0_ns = buf.t0_ns, 0
        _telemetry.inc("fusion_drains_total")
        _telemetry.observe("fusion_drain_gates", len(gates))
        outer = getattr(_DRAIN, "id", 0)
        try:
            with _telemetry.span("fusion.drain", gates=len(gates)) as sp:
                sp.attrs["drain"] = _DRAIN.id = sp.id
                if t0_ns:
                    _telemetry.record_span(
                        "fusion.capture", t0_ns, sp.start_ns, buf.parent,
                        gates=len(gates), drain=sp.id)
                _run(qureg, gates)
        except BaseException:
            buf.gates = gates + buf.gates
            buf.t0_ns = t0_ns
            raise
        finally:
            _DRAIN.id = outer
        qureg._drain_count += 1
        if _telemetry.enabled():
            from .utils import profiling as _prof

            _prof.memory_watermark()


_PLAN_CACHE_MAX = 64
_plan_cache: dict = {}
# plan key -> its disk digest, for the entries of _plan_cache that the
# persistent tier (aotcache) loaded or stored
_plan_digests: dict = {}
# guards _plan_cache, _plan_digests and _device_programs: the serving
# layer's warm pool plans in its own thread beside the scheduling thread
_PLAN_LOCK = threading.RLock()

# > 0 while plan_items / plan_items_sharded plan ahead of a drain: the
# per-window observations are not recorded (only drains record them)
_QUIET = _opt.ThreadCount()
# > 0 while plan_items_quiet dry-runs a drain's planning
# (explain_circuit, the governor's predictor): nothing is inserted into
# the plan cache either, and the disk tier is read but neither written
# nor counted
_DRY = _opt.ThreadCount()
# where the last recorded plan lookup of this thread found its plan:
# "memory", "disk" or "planned" (the first_request_seconds label), and
# the plan key it looked up (``key``)
_SOURCE = threading.local()
# the id of the fusion.drain span running on this thread (0: none): the
# "drain" attr of every span of that drain
_DRAIN = threading.local()
# op counts of dispatched program groups (the fusion.dispatch attrs), made
# once per group: id(group) -> (group, counts); the entry holds the
# group, so its id names no other object while it is here
_GROUP_STATS: dict = {}
# the window-pass operands of memory-tier plans, staged in host memory
# (fused.stage_ops): plan key -> {(device, dtype, precision mode): a
# _Stage, _SEEN after the plan's first drain there, or _OVER for a
# program whose operands would pass _STAGE_MAX_BYTES}; a plan's entry
# leaves with the plan
_stages: dict = {}
_SEEN, _OVER = "seen", "over"
# the host bytes (pinned on a card's host) all stages hold together
_STAGE_MAX_BYTES = 1 << 30
# the device types whose drains stage their passes
_STAGE_DEVICES = ("cuda",)


def _span(name: str, **attrs):
    """telemetry.span with the running drain's id as its ``drain``
    attr."""
    return _telemetry.span(name, drain=getattr(_DRAIN, "id", 0), **attrs)


def _store(key, value, digest=None) -> None:
    """Insert a plan into the memory tier (not during a dry run);
    ``digest``: its disk key, when the persistent tier holds it."""
    if key is None or _DRY[0]:
        return
    with _PLAN_LOCK:
        if key not in _plan_cache and len(_plan_cache) >= _PLAN_CACHE_MAX:
            old = next(iter(_plan_cache))
            del _plan_cache[old]
            _stages.pop(old, None)
            gone = _plan_digests.pop(old, None)
            if gone is not None:
                _aot._MEMORY_KEYS.discard(gone)
        if _plan_cache.get(key) is not value:
            _stages.pop(key, None)
        _plan_cache[key] = value
        if digest is not None:
            _plan_digests[key] = digest
            _aot._MEMORY_KEYS.add(digest)


def clear_plan_caches() -> None:
    """Drop this process's plans, their device copies and their staged
    operands (the memory tier; the disk tier stays)."""
    with _PLAN_LOCK:
        _plan_cache.clear()
        _device_programs.clear()
        _stages.clear()
        _GROUP_STATS.clear()
        for d in _plan_digests.values():
            _aot._MEMORY_KEYS.discard(d)
        _plan_digests.clear()


class ChannelItem:
    """A captured depolarise / damping channel, buffered between gate
    segments and run by the drain in call order.  ``prob`` is a run-time
    value: the plan of a drain does not depend on it."""

    __slots__ = ("kind", "target", "bra", "prob")

    def __init__(self, kind: str, target: int, bra: int, prob: float):
        self.kind = kind
        self.target = target       # ket bit position in the state vector
        self.bra = bra             # bra twin bit (target + numQubits)
        self.prob = float(prob)


def _plan_key(items, nloc: int, sweep_ok: bool, device=None,
              bank: tuple = (0, 0), perm0=None, nsh: int = 0):
    """Content key for an item list: the gate matrices' bytes, each
    channel's (kind, target, bra) (its probability is a run-time value),
    whether channel runs may sweep, the knobs that change the plan (the
    planner, QT_PLANNER, megawin grouping and QT_SIDE_SPLIT), the window
    kernels' precision mode, which the reference's key holds as well
    (quest_tpu/fusion.py:565), and ``bank``, (batch flag, bank size):
    a bank's per-element program never replays for another bank or for a
    single register.  On a sharded register (``nsh`` shard bits) the key
    also holds the live permutation the drain starts from, ``perm0``, and
    the topology's signature: the same items plan to other windows and
    remaps from another permutation or arrangement."""
    parts = []
    for it in items:
        if isinstance(it, ChannelItem):
            parts.append(("chan", it.kind, it.target, it.bra))
            continue
        m = it.mat
        if not isinstance(m, np.ndarray):
            return None
        parts.append((it.targets, m.dtype.str, m.shape, m.tobytes()))
    sharded = None
    if nsh:
        from .parallel import topology as _topo

        sharded = (nsh, None if perm0 is None else tuple(perm0),
                   _topo.signature(1 << nsh))
    return (nloc, sweep_ok, C.resolve_planner(),
            _fused.megakernel_planning(device), C._side_split_enabled(),
            _fused.matmul_precision_name(), tuple(bank), sharded,
            tuple(parts))


def _drain_key(items, nloc: int, sweep_ok: bool, device, bsz: int,
               perm0=None, nsh: int = 0):
    """_plan_key of a drain of ``items`` on a register (or a bank of
    ``bsz``): the bank part is (batch flag, bank size under flag 2)."""
    flag = batch_flag(items, bsz)
    return _plan_key(items, nloc, sweep_ok, device,
                     (flag, bsz if flag == 2 else 0), perm0, nsh)


# minimum adjacent permutation-classified gates worth splitting out of a
# dense segment: a lone X between dense neighbours fuses better inside
# their window pass than as its own pass
_PERM_RUN_MIN = 2


def _perm_runs(seg):
    """Partition one gate segment into maximal runs of permutation gates
    and interleaved dense runs, in stream order:
    ``[("perm" | "dense", [gates...]), ...]``.  Runs shorter than
    _PERM_RUN_MIN are demoted to dense."""
    flags = [C.classify_permutation_gate(g.mat) is not None for g in seg]
    i = 0
    while i < len(seg):
        if flags[i]:
            j = i
            while j < len(seg) and flags[j]:
                j += 1
            if j - i < _PERM_RUN_MIN:
                for k in range(i, j):
                    flags[k] = False
            i = j
        else:
            i += 1
    runs: List[tuple] = []
    for flag, g in zip(flags, seg):
        kind = "perm" if flag else "dense"
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(g)
        else:
            runs.append((kind, [g]))
    return runs


def _split_items(items, nloc: int, sweep_ok: bool, device=None):
    """Items -> program: a tuple of ("perm", ops), ("plan", ops),
    ("chan", kind, t, b) and ("chansweep", ((kind, t, b), ...)) parts
    executed in order (channel probabilities are walked at run time).
    With ``sweep_ok``, a run of consecutive channels whose ket bits all
    lie below 14 on a register of 15 bits or more is one chansweep part
    (fused.apply_pair_channel_sweep)."""
    program = []
    seg: list = []
    chans: list = []

    def flush_gates():
        if seg and not _QUIET[0]:
            _telemetry.observe("fusion_window_gates", len(seg))
        for kind, sub in _perm_runs(seg):
            if kind == "perm":
                ops = C.lower_permutation_run(sub, nloc)
                if ops:
                    program.append(("perm", tuple(ops)))
            else:
                program.append(("plan", tuple(C.plan_circuit(
                    list(sub), nloc, device=device))))
        seg.clear()

    def flush_chans():
        if not chans:
            return
        if (sweep_ok and nloc >= _fused.CLUSTER_QUBITS + 1
                and all(t < _fused.CLUSTER_QUBITS for _k, t, _b in chans)):
            program.append(("chansweep", tuple(chans)))
        else:
            program.extend(("chan", kind, t, b) for kind, t, b in chans)
        chans.clear()

    for it in items:
        if isinstance(it, ChannelItem):
            flush_gates()
            chans.append((it.kind, it.target, it.bra))
        else:
            flush_chans()
            seg.append(it)
    flush_chans()
    flush_gates()
    return tuple(program)


def _item_entry(it):
    """Window-planner entry of one drain item: a channel's (ket, bra)
    bits; a gate's circuit.perm_item_entry (a relabel entry for a pure
    bit relabel).  The sharded planner and the optimizer's stream cost
    both price items through this one function."""
    if isinstance(it, ChannelItem):
        return (it.target, it.bra)
    return C.perm_item_entry(it.targets, it.mat)


def _split_items_sharded(items, n: int, nloc: int, perm0, sweep_ok: bool,
                         device=None):
    """Windows and one batched remap each for a sharded drain: group the
    items into windows whose qubits fit the shard-local space
    (circuit.plan_remap_windows), emit a ("remap", sigma) part bringing
    the window's qubits local, then rewrite the window's items to their
    physical bits and split them as one register's items at nloc.  A run
    of relabel gates folds into the permutation and emits nothing.
    Returns (program, final_perm) (quest_tpu/fusion.py:286-326)."""
    entries = [_item_entry(it) for it in items]
    segments, final_perm = C.plan_remap_windows(entries, n, nloc, perm0)
    program: List[tuple] = []
    for (i, j), sigma, perm in segments:
        if not _QUIET[0]:
            _telemetry.observe("fusion_remap_window_items", j - i)
        if C._is_relabel_entry(entries[i]):
            continue
        if sigma is not None:
            program.append(("remap", sigma))
        sub = []
        for it in items[i:j]:
            if isinstance(it, ChannelItem):
                pt, pb = perm[it.target], perm[it.bra]
                # both channel kinds are symmetric in (t, b): a remap that
                # lands the bra below the ket swaps their roles
                sub.append(ChannelItem(it.kind, min(pt, pb), max(pt, pb),
                                       it.prob))
            else:
                sub.append(C.Gate(tuple(perm[t] for t in it.targets),
                                  it.mat))
        program.extend(_split_items(sub, nloc, sweep_ok, device))
    return tuple(program), final_perm


def batch_flag(items, batch_size: int) -> int:
    """The reference's batch flag of a drain (quest_tpu/fusion.py:566):
    0 for one register, 1 for a bank whose items are all shared, 2 for a
    bank with a per-element (B, 2, s, s) gate matrix."""
    if not batch_size:
        return 0
    per = any(not isinstance(it, ChannelItem)
              and getattr(it.mat, "ndim", 0) == 4 for it in items)
    return 2 if per else 1


def _items_for_element(items, b: int):
    """Item list of bank element ``b``: per-element (B, 2, s, s) matrices
    sliced to element b's; shared matrices and channels as they are."""
    out = []
    for it in items:
        if isinstance(it, ChannelItem) or getattr(it.mat, "ndim", 0) != 4:
            out.append(it)
        else:
            out.append(C.Gate(it.targets, it.mat[b]))
    return out


def _program_split(program):
    """(skeleton, arrays) of a program: its planned parts' operands
    apart (circuit.split_plan), the rest as they are."""
    skeleton, arrays = [], []
    for part in program:
        if part[0] == "plan":
            sk, arr = C.split_plan(part[1])
            skeleton.append(("plan", sk))
            arrays.extend(arr)
        else:
            skeleton.append(part)
    return tuple(skeleton), arrays


def _program_rebuild(skeleton, arrays):
    it = iter(arrays)
    return tuple(("plan", tuple(C._rebuild_plan_iter(part[1], it)))
                 if part[0] == "plan" else part for part in skeleton)


def _stack_element_plans(plans):
    """One bank program from its elements' (program, final_perm) plans
    (quest_tpu/fusion.py _plan_batched_items): every element must give
    element 0's skeleton (remaps included) and final permutation, and
    each pass array is stacked to a leading (B, ...) axis.  Returns
    (program, final_perm)."""
    from .validation import QuESTError

    skeleton, final, per_elem = None, None, []
    for b, (program, fp) in enumerate(plans):
        sk, arrays = _program_split(program)
        if b == 0:
            skeleton, final = sk, fp
        elif sk != skeleton or fp != final:
            raise QuESTError(
                "batched drain: batch element %d's gate stream plans to a "
                "different program skeleton than element 0 (value-dependent "
                "decomposition, e.g. a controlled gate of different Schmidt "
                "rank) — such submissions cannot share one batched program; "
                "run them in separate ensemble groups" % b)
        per_elem.append(arrays)
    stacked = [np.stack([np.asarray(e[j]) for e in per_elem])
               for j in range(len(per_elem[0]))]
    return _program_rebuild(skeleton, stacked), final


def _plan_batched_items(items, bsz: int, num_qubits: int, device,
                        sweep_ok: bool):
    """The program of a bank drain whose items carry per-element
    matrices: each element is planned on its own (a controlled gate's
    decomposition depends on its values; each element's plan is cached
    as that element's scalar drain would cache it) and the plans are
    stacked (``_stack_element_plans``)."""
    return _stack_element_plans(
        (_plan_optimized(_items_for_element(items, b), num_qubits, device,
                         sweep_ok, disk=False), None)
        for b in range(bsz))[0]


def _cache_lookup(key, record: bool, disk: bool = True):
    """The plan cached under ``key`` (None: a miss): the memory tier,
    then (``disk``) the persistent tier, whose hit joins the memory tier
    (not during a dry run).  A drain's lookup (``record``) counts
    fusion_plan_cache_hits_total / _misses_total (the memory tier's
    answer) and the disk tier's aot_cache_hits_total / _misses_total; any
    other lookup reads the disk tier without counting."""
    with _PLAN_LOCK:
        hit = _plan_cache.get(key) if key is not None else None
    if record:
        _telemetry.inc("fusion_plan_cache_hits_total" if hit is not None
                       else "fusion_plan_cache_misses_total")
        _SOURCE.where = "memory"
        _SOURCE.key = key
    if hit is None and key is not None and disk and _aot.enabled():
        digest = _aot.plan_key_digest(key)
        got = _aot.load(digest, quiet=not record)
        if got is not None:
            hit = got[0]
            _store(key, hit, digest)
            if record:
                _SOURCE.where = "disk"
    return hit


def _store_planned(key, value, seconds: float, persist: bool) -> None:
    """Insert a fresh plan into the memory tier and, for a drain's plan
    (``persist``) with the persistent tier on, onto the disk."""
    digest = None
    if persist and key is not None and _aot.enabled():
        digest = _aot.plan_key_digest(key)
        if not _aot.store(digest, value, seconds):
            digest = None
    _store(key, value, digest)


def _plan_optimized(items, num_qubits: int, device, sweep_ok: bool,
                    batch_size: int = 0, record: bool = False,
                    disk: bool = True):
    """The program of an optimized item list (cached on its content), of
    one register or of a bank of ``batch_size`` registers.  A drain's
    call (``record``) counts the cache lookup, plans a miss under the
    ``fusion.plan`` span and persists it.  ``disk=False``: a bank
    element's plan, which the disk tier holds only inside its bank's."""
    if not items:
        return ()
    flag = batch_flag(items, batch_size)
    key = _drain_key(items, num_qubits, sweep_ok, device, batch_size)
    hit = _cache_lookup(key, record, disk)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    with _span("fusion.plan", items=len(items)) if record \
            else nullcontext():
        if flag == 2:
            program = _plan_batched_items(items, batch_size, num_qubits,
                                          device, sweep_ok)
        else:
            program = _split_items(items, num_qubits, sweep_ok, device)
    if record:
        _SOURCE.where = "planned"
    _store_planned(key, program, time.perf_counter() - t0, record and disk)
    return program


def plan_items(items, num_qubits: int, device=None, sweep_ok: bool = False,
               batch_size: int = 0):
    """The program a drain of ``items`` on an n-qubit register (or a bank
    of ``batch_size`` registers) on ``device`` executes: the optimized
    stream split into permutation, planned and channel parts (cached on
    the items' content).  A drain passes ``sweep_ok =
    fused.channel_sweep_enabled(state)``.  Planning ahead records no
    telemetry: only drains count."""
    _QUIET[0] += 1
    try:
        items, _stats = _opt.optimize_items(items, nloc=num_qubits,
                                            quiet=True)
        return _plan_optimized(items, num_qubits, device, sweep_ok,
                               batch_size)
    finally:
        _QUIET[0] -= 1


def _sweep_ok(qureg) -> bool:
    """fused.channel_sweep_enabled for the register's state (its first
    shard on a mesh; its type and device while it is spilled)."""
    a = qureg._amps
    if a is None:
        a = torch.empty(0, dtype=qureg.dtype, device=qureg.device)
    elif qureg.is_sharded:
        a = a.shards[0]
    return _fused.channel_sweep_enabled(a)


def _drain_view(qureg, items) -> dict:
    """What a drain of ``items`` on ``qureg`` (a register, or a
    register-shaped stub such as serve._PlanStub) plans from, derived as
    the drain derives it and recording nothing: the optimized items,
    their plan key and the register's shape (n, nloc, nsh, perm0, bsz,
    sweep_ok, device)."""
    n = qureg.num_qubits_in_state_vec
    nsh = qureg.shard_bits
    nloc = n - nsh
    perm0 = qureg._perm if nsh else None
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    if items:
        if nsh:
            items, _stats = _opt.optimize_items(items, nloc=nloc, n=n,
                                                nsh=nsh, perm0=perm0,
                                                quiet=True)
        else:
            items, _stats = _opt.optimize_items(items, nloc=n, quiet=True)
    sweep_ok = _sweep_ok(qureg)
    key = _drain_key(items, nloc, sweep_ok, qureg.device, bsz, perm0,
                     nsh) if items else None
    return {"items": items, "key": key, "n": n, "nloc": nloc, "nsh": nsh,
            "perm0": perm0, "bsz": bsz, "sweep_ok": sweep_ok,
            "device": qureg.device}


def _plan_view(v: dict):
    """(program, final_perm) of a _drain_view, planned (or found) by the
    planners a drain calls, without recording."""
    if v["nsh"]:
        program, final_perm, _key = _plan_sharded(
            v["items"], v["n"], v["nloc"], v["perm0"], v["device"],
            v["sweep_ok"], v["bsz"])
        return program, final_perm
    return _plan_optimized(v["items"], v["n"], v["device"], v["sweep_ok"],
                           v["bsz"]), None


def plan_items_quiet(qureg, items):
    """The program a drain of ``items`` on ``qureg`` would dispatch,
    planned exactly as the drain plans it (the same optimizer rewrite,
    the live permutation, the bank) with no telemetry recorded and no
    plan-cache insertion: a cached plan is read (the persistent tier's
    too), a miss is not stored.  The dry run behind explain_circuit's
    ``memory`` section and the governor's predictor
    (quest_tpu/fusion.py:670-714).  Returns (program, final_perm, nloc,
    nsh)."""
    v = _drain_view(qureg, items)
    if not v["items"]:
        return (), None, v["nloc"], v["nsh"]
    program, final_perm = _dry_plan(v)
    return program, final_perm, v["nloc"], v["nsh"]


def _dry_plan(v: dict):
    """_plan_view as a dry run: nothing recorded, nothing stored."""
    _QUIET[0] += 1
    _DRY[0] += 1
    try:
        return _plan_view(v)
    finally:
        _QUIET[0] -= 1
        _DRY[0] -= 1


def aot_plan_info(qureg, items):
    """Quiet planning plus the key derivation of the drain ``items`` on
    ``qureg`` would run (quest_tpu/fusion.py:717): everything the
    persistent tier needs to name or warm that drain's plan, recording
    nothing and inserting nothing.  ``qureg`` may be a register-shaped
    stub (serve._PlanStub).  None for an empty drain."""
    v = _drain_view(qureg, items)
    if not v["items"]:
        return None
    program, final_perm = _dry_plan(v)
    return {"program": program, "final_perm": final_perm,
            "key": v["key"], "nloc": v["nloc"], "nsh": v["nsh"],
            "batch_size": v["bsz"],
            "batch_flag": batch_flag(v["items"], v["bsz"])}


def aot_probe(qureg, items) -> dict:
    """Side-effect-free prediction of where the drain of ``items`` finds
    its plan (quest_tpu/fusion.py:762), explainCircuit's ``compile``
    section: {"enabled", "status", "key"}, status ``disabled`` /
    ``uncacheable`` / ``memory`` (the key is in _plan_cache: the disk
    will not be consulted) / ``hit`` / ``miss`` (the disk tier's
    answer).  Derives the key without planning."""
    if not _aot.enabled():
        return {"enabled": False, "status": "disabled", "key": None}
    key = _drain_view(qureg, items)["key"]
    with _PLAN_LOCK:
        in_mem = key is not None and key in _plan_cache
    return _aot.probe(key, in_mem)


def aot_prewarm(qureg, items):
    """Put the plan of the drain ``items`` on ``qureg`` (a register or a
    register-shaped stub) in the memory tier ahead of the drain, from the
    disk or by planning it and persisting it: the warm pool's unit of
    work.  Returns (status, final_perm): ``present`` (already in memory),
    ``hit`` (loaded from the disk, counted), ``compiled`` (planned as a
    dry run, so a bank's element plans stay out of the memory tier, and
    stored: a counted miss and put), ``empty`` (nothing to plan) or
    ``uncacheable``."""
    v = _drain_view(qureg, items)
    if not v["items"]:
        return "empty", None
    key = v["key"]
    if key is None:
        return "uncacheable", None
    with _PLAN_LOCK:
        value = _plan_cache.get(key)
    status = "present"
    if value is None:
        digest = _aot.plan_key_digest(key)
        got = _aot.load(digest)
        if got is not None:
            value, status = got[0], "hit"
        else:
            t0 = time.perf_counter()
            planned = _dry_plan(v)
            value = planned if v["nsh"] else planned[0]
            if not _aot.store(digest, value, time.perf_counter() - t0):
                digest = None
            status = "compiled"
        _store(key, value, digest)
    return status, (value[1] if v["nsh"] else None)


def program_stats(program) -> dict:
    """circuit.stats summed over a program's planned parts, plus its
    channel parts: "chan" (one channel each) and "chansweep" (a run), and
    a sharded program's "remap" parts."""
    total: dict = {}
    for part in program:
        if part[0] in ("chan", "chansweep", "remap"):
            total[part[0]] = total.get(part[0], 0) + 1
            continue
        for k, v in C.stats(part[1]).items():
            total[k] = total.get(k, 0) + v
    return total


def _group_stats(group) -> dict:
    """program_stats of a dispatched group, made once per group."""
    with _PLAN_LOCK:
        hit = _GROUP_STATS.get(id(group))
    if hit is not None:
        return hit[1]
    counts = program_stats(group)
    with _PLAN_LOCK:
        if len(_GROUP_STATS) >= _PLAN_CACHE_MAX:
            del _GROUP_STATS[next(iter(_GROUP_STATS))]
        _GROUP_STATS[id(group)] = (group, counts)
    return counts


def _dispatch_span(group, staged=None):
    """The fusion.dispatch span of one program group, its op counts as
    attrs, and on a device that stages, ``staged``: its window passes fed
    from a stage."""
    if not _telemetry.enabled():
        return nullcontext()
    extra = {} if staged is None else {"staged": staged}
    return _span("fusion.dispatch", **extra, **_group_stats(group))


class _Stage:
    """A program's staged window-pass operands on one device, dtype and
    precision mode: the host block and {id(op): fused.StagedPass}; it
    holds the program, so no other op takes one of its ops' ids."""

    __slots__ = ("program", "block", "passes")

    def __init__(self, program, block, passes):
        self.program, self.block, self.passes = program, block, passes


def _stage_bytes() -> int:
    return sum(s.block.numel() for slot in _stages.values()
               for s in slot.values() if isinstance(s, _Stage))


def _program_stage(key, program, amps, num_qubits: int, precision: str):
    """{id(op): fused.StagedPass} for a drain of ``program``, the plan the
    memory tier holds under ``key``, on ``amps`` under ``precision``;
    None: the drain's passes make their operands as a launch does.  A
    plan's passes are staged at its second drain on a device, dtype and
    mode (a plan drained once stages nothing), and stay staged while the
    plan stays in the memory tier, as the ops of the cached program (so
    any split of it into dispatch groups finds them).  A program whose
    operands would pass _STAGE_MAX_BYTES is not staged; older stages
    leave to make room for a new one."""
    if key is None or amps.device.type not in _STAGE_DEVICES:
        return None
    sub = (str(amps.device), amps.dtype, precision)
    with _PLAN_LOCK:
        if _plan_cache.get(key) is not program:
            return None
        slot = _stages.setdefault(key, {})
        got = slot.get(sub)
        if got is None:
            slot[sub] = _SEEN
        if got is not _SEEN:
            return got.passes if isinstance(got, _Stage) else None
    ops = [op for part in program if part[0] == "plan" for op in part[1]]
    with _span("fusion.stage") as sp:
        made = _fused.stage_ops(ops, amps, num_qubits, precision,
                                _STAGE_MAX_BYTES)
        sp.attrs["bytes"] = None if made is None else made[0].numel()
    with _PLAN_LOCK:
        if _plan_cache.get(key) is not program:
            return None if made is None else made[1]
        if made is None:
            _stages.setdefault(key, {})[sub] = _OVER
            return None
        for old in [(k, s) for k, slot in _stages.items()
                    for s, v in slot.items() if isinstance(v, _Stage)]:
            if _stage_bytes() + made[0].numel() <= _STAGE_MAX_BYTES:
                break
            _stages[old[0]][old[1]] = _SEEN
        _stages.setdefault(key, {})[sub] = _Stage(program, *made)
    return made[1]


def _window_passes(group, stage) -> tuple:
    """(window passes, of them fed from ``stage``) of a dispatched group;
    a megawin group's passes count, never staged."""
    total = staged = 0
    for part in group:
        if part[0] != "plan":
            continue
        for op in part[1]:
            if op[0] == "megawin":
                total += len(op[1])
            elif op[0] in _fused.STAGED_KINDS:
                total += 1
                staged += bool(stage) and id(op) in stage
    return total, staged


def execute_program(amps, program, probs, num_qubits: int, release=None,
                    stage=None):
    """Run a program's parts in order; ``probs`` holds the probability of
    each of its channels, in order.  Returns the new state (a sweep
    overwrites a float32 state on the card in place).  The state may be
    a (B, 2, 2^n) register bank: its planned parts and sweeps take the
    whole bank (``circuit.execute_plan``, K5), a channel takes it as a
    batch dimension, every element under the same probabilities (the
    reference's vmap in_axes).

    Plan parts run op by op, so no frame here holds a part's input while
    its later ops run: with ``release``, called once the first op has
    produced its output (the caller then drops its own reference to the
    input), the program holds at most two states at a time, an op's input
    and its output: the governor's model of a drain (the reference
    donates the input buffer to its executor).  ``stage``: the staged
    window passes of the program's ops (``_program_stage``)."""
    n = num_qubits
    bank = _fused.bank_size(amps, n)
    run = partial(C.execute_plan, stage=stage) if stage else C.execute_plan
    pi = 0
    for part in program:
        if part[0] == "chansweep":
            entries = part[1]
            amps = _fused.apply_pair_channel_sweep(
                amps, entries, probs[pi:pi + len(entries)], num_bits=n)
            pi += len(entries)
        elif part[0] == "chan":
            _, kind, t, b = part

            def chan(a, kind=kind, p=probs[pi], t=t, b=b):
                return _density.apply_pair_channel(a, kind, p, nn=n, t=t,
                                                   b=b)

            amps = torch.vmap(chan)(amps) if bank else chan(amps)
            pi += 1
        else:
            for op in part[1]:
                amps = run(amps, (op,), n)
                if release is not None:
                    release()
                    release = None
            continue
        if release is not None:
            release()
            release = None
    return amps


def _run(qureg, items) -> None:
    """Plan with the concrete gate matrices (so controlled gates Schmidt-
    decompose to their true rank), then execute the program on the
    register's tensor, with the channels' probabilities in stream order.
    A BatchedQureg (batch.py) drains its whole (B, 2, 2^n) bank through
    one program: shared plans (flag 1), or per-element plans of one
    skeleton stacked (flag 2).  A sharded register drains through
    _run_sharded.  A register the governor spilled is restored first;
    the planned program then runs under the memory governor
    (governor.govern_drain: as it is, or in the groups the ladder split
    it into), each group through the OOM net (quest_tpu/fusion.py:342-418,
    606).  On a card the window passes of a plan drained before take
    their operands from its stage (``_program_stage``), counted in
    fusion_staged_passes_total{source="stage"} against those made as a
    launch makes them ("built")."""
    from . import governor as _gov

    _gov.ensure_resident(qureg)
    if qureg._amps is None:
        raise qureg._no_state_error()
    if qureg.is_sharded:
        _run_sharded(qureg, items)
        return
    n = qureg.num_qubits_in_state_vec
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    t0 = time.perf_counter()
    with _span("fusion.optimize", items_in=len(items)) as sp:
        items, _stats = _opt.optimize_items(items, nloc=n)
        sp.attrs["items_out"] = len(items)
    if not items:
        return  # everything cancelled: nothing runs
    with _span("fusion.lookup") as sp:
        program = _plan_optimized(items, n, qureg.device, _sweep_ok(qureg),
                                  bsz, record=True)
        sp.attrs["source"] = getattr(_SOURCE, "where", None)
    key = getattr(_SOURCE, "key", None)
    probs = tuple(it.prob for it in items if isinstance(it, ChannelItem))
    try:
        with _span("fusion.govern"):
            groups = _governed_groups(qureg, program, probs, nloc=n, nsh=0)
            _record_program(program, items)
        stage = _program_stage(key, program, qureg._amps, n,
                               _fused.resolve_precision(None))
        counted = (_telemetry.enabled()
                   and qureg._amps.device.type in _STAGE_DEVICES)
        for group, gprobs in groups:
            passes, staged = _window_passes(group, stage) if counted \
                else (0, None)

            def dispatch(g=group, gp=gprobs, s=staged):
                # a plain call: the program's frame then holds the only
                # reference to the state once the register lets it go (a
                # partial or an unpacked call would keep it alive)
                with _dispatch_span(g, s):
                    return execute_program(qureg._amps, g, gp, n,
                                           release=lambda: _consume(qureg),
                                           stage=stage)

            try:
                qureg._amps = _timed_group(
                    qureg, group, lambda d=dispatch: _gov.oom_net(d, qureg))
            except BaseException as e:
                if qureg._amps is None:
                    qureg._consumed_by = f"{type(e).__name__}: {e}"
                raise
            if counted:
                _telemetry.inc("fusion_staged_passes_total", staged,
                               source="stage")
                _telemetry.inc("fusion_staged_passes_total",
                               passes - staged, source="built")
        _first_request(qureg, t0)
    finally:
        _gov.end_drain()


def _first_request(qureg, t0: float) -> None:
    """first_request_seconds{fingerprint_cached}, with the persistent tier
    on: the wall, from the optimizer on, of a drain whose plan was not in
    the memory tier (its plan's first request in this process): "true"
    when the disk held the plan, "false" when the drain planned it (the
    reference observes its runners' first calls, quest_tpu/aotcache.py
    wrap_runner)."""
    where = getattr(_SOURCE, "where", None)
    _SOURCE.where = None
    if where not in ("disk", "planned") or not _aot.enabled() \
            or not _telemetry.enabled():
        return
    if qureg.device.type == "cuda":
        torch.cuda.synchronize(qureg.device)
    _telemetry.observe("first_request_seconds", time.perf_counter() - t0,
                       fingerprint_cached="true" if where == "disk"
                       else "false")


def _consume(qureg) -> None:
    """A drain's first op has produced its output: the register drops its
    input, so the input is freed as the program moves on.  The OOM net can
    then no longer retry the group (its state mark changed), and a failure
    from here on leaves the register without a state
    (``Qureg._consumed_by``)."""
    qureg._amps = None


def _governed_groups(qureg, program, probs, *, nloc: int, nsh: int):
    """[(part group, its channel probabilities)] of a planned drain: the
    whole program, or the dispatch groups the governor's ladder split it
    into (governor.govern_drain, which raises MemoryAdmissionError on a
    refusal)."""
    from . import governor as _gov

    gov = _gov.govern_drain(qureg, program, nloc=nloc, nsh=nsh)
    out, pi = [], 0
    for group in (gov or {}).get("groups") or (program,):
        cnt = sum(_part_probs(p) for p in group)
        out.append((group, probs[pi:pi + cnt]))
        pi += cnt
    return out


def _group_route(program) -> str:
    """Dominant plan-entry family of a dispatched program, the
    plan_route_seconds label (quest_tpu/fusion.py:421-441): megawin,
    winfused, permfast, channel, remap."""
    saw = set()
    for part in program:
        if part[0] == "plan":
            for op in part[1]:
                saw.add("megawin" if op[0] == "megawin" else "winfused")
        elif part[0] == "perm":
            saw.add("permfast")
        elif part[0] in ("chan", "chansweep"):
            saw.add("channel")
        elif part[0] == "remap":
            saw.add("remap")
    for route in ("megawin", "winfused", "permfast", "channel", "remap"):
        if route in saw:
            return route
    return "other"


def _record_program(program, items, n: int = 0, nloc: int = 0,
                    perm0=None) -> None:
    """A drain's program accounting (quest_tpu/fusion.py:451-505):
    fusion_windows_total (planned parts), megakernel_dispatch_total
    {route=mega} (megawin groups), the window_hbm_round_trips gauge
    (ops per planned part) and permutation_gates_total by route (a
    lowered permutation op: relabel or gather; on a sharded register a
    relabel folded into the permutation: exchange when it touches a bit
    held on the shard axis at the drain's start, else relabel)."""
    if not _telemetry.enabled():
        return
    plans = [part[1] for part in program if part[0] == "plan"]
    _telemetry.inc("fusion_windows_total", len(plans))
    mega = sum(1 for ops in plans for op in ops if op[0] == "megawin")
    if mega:
        _telemetry.inc("megakernel_dispatch_total", mega, route="mega")
    if plans:
        _telemetry.set_gauge("window_hbm_round_trips",
                             sum(len(ops) for ops in plans) / len(plans))
    for part in program:
        if part[0] == "perm":
            for op in part[1]:
                _telemetry.inc(
                    "permutation_gates_total",
                    route="relabel" if op[0] == "permute" else "gather")
    if n > nloc:
        p0 = tuple(perm0) if perm0 is not None else tuple(range(n))
        for it in items:
            e = _item_entry(it)
            if C._is_relabel_entry(e):
                ex = any(p0[a] >= nloc or p0[b] >= nloc for a, b in e[1])
                _telemetry.inc("permutation_gates_total",
                               route="exchange" if ex else "relabel")


def _timed_group(qureg, program, dispatch):
    """Run one dispatched program group, observing its wall time into
    plan_route_seconds{route} and counting plan_route_dispatch_total
    (quest_tpu/fusion.py:587-613).  In trace mode the card is
    synchronised after the group, so the time is the device's; in on
    mode only the host dispatch is timed (no added sync)."""
    if not _telemetry.enabled():
        return dispatch()
    t0 = time.perf_counter()
    out = dispatch()
    if _telemetry.mode_name() == "trace" and qureg.device.type == "cuda":
        torch.cuda.synchronize(qureg.device)
    route = _group_route(program)
    _telemetry.observe("plan_route_seconds", time.perf_counter() - t0,
                       route=route)
    _telemetry.inc("plan_route_dispatch_total", route=route)
    return out


# device copies of sharded programs: (plan key, device, dtype) -> program
_device_programs: dict = {}


def plan_items_sharded(items, n: int, nloc: int, perm0=None, device=None,
                       sweep_ok: bool = False, optimize: bool = True,
                       batch_size: int = 0):
    """The (program, final_perm) a drain of ``items`` on an n-bit register
    (or a bank of ``batch_size`` registers) split into shards of nloc
    bits, starting from the live permutation ``perm0``, executes: the
    optimized stream (with the sharded reordering; ``optimize=False``:
    the stream as given) split into remap, permutation, planned and
    channel parts, cached on the items' content and ``perm0``.  Records
    no telemetry, as plan_items."""
    nsh = n - nloc
    _QUIET[0] += 1
    try:
        if optimize:
            items, _stats = _opt.optimize_items(items, nloc=nloc, n=n,
                                                nsh=nsh, perm0=perm0,
                                                quiet=True)
        return _plan_sharded(items, n, nloc, perm0, device, sweep_ok,
                             batch_size)[:2]
    finally:
        _QUIET[0] -= 1


def _plan_sharded(items, n, nloc, perm0, device, sweep_ok, bsz: int = 0,
                  record: bool = False, disk: bool = True):
    """(program, final_perm, key) of an optimized sharded item list of
    one register or of a bank of ``bsz``: under batch flag 2 each element
    planned on its own from the live permutation (cached as its scalar
    drain would be) and the plans stacked (``_stack_element_plans``),
    the bank's program cached under its own key.  ``record``: a drain's
    call (_plan_optimized); ``disk``: as there."""
    nsh = n - nloc
    flag = batch_flag(items, bsz)
    key = _drain_key(items, nloc, sweep_ok, device, bsz, perm0, nsh)
    hit = _cache_lookup(key, record, disk)
    if hit is not None:
        return hit[0], hit[1], key
    t0 = time.perf_counter()
    with _span("fusion.plan", items=len(items)) if record \
            else nullcontext():
        if flag == 2:
            program, final_perm = _stack_element_plans(
                _plan_sharded(_items_for_element(items, b), n, nloc, perm0,
                              device, sweep_ok, disk=False)[:2]
                for b in range(bsz))
        else:
            program, final_perm = _split_items_sharded(
                items, n, nloc, perm0, sweep_ok, device)
    if record:
        _SOURCE.where = "planned"
    _store_planned(key, (program, final_perm), time.perf_counter() - t0,
                   record and disk)
    return program, final_perm, key


def program_on_device(program, dtype, device, key=None):
    """The program with every planned part's operands on ``device`` in
    ``dtype`` (circuit.plan_to_device), made once per program (``key``:
    the plan key it is cached under; None: not cached), device and type:
    the shards on one device share one upload, and on the card one side
    image per pass."""
    ck = None if key is None else (key, str(device), dtype)
    with _PLAN_LOCK:
        hit = _device_programs.get(ck) if ck is not None else None
    if hit is not None:
        return hit
    out = tuple(("plan", tuple(C.plan_to_device(part[1], dtype, device)))
                if part[0] == "plan" else part for part in program)
    if ck is not None:
        with _PLAN_LOCK:
            if ck not in _device_programs \
                    and len(_device_programs) >= _PLAN_CACHE_MAX:
                del _device_programs[next(iter(_device_programs))]
            _device_programs[ck] = out
    return out


def _part_probs(part) -> int:
    if part[0] == "chansweep":
        return len(part[1])
    return 1 if part[0] == "chan" else 0


def execute_sharded_program(amps, program, probs, nloc: int, key=None):
    """Run a sharded program on a ShardedAmps: each ("remap", sigma) part
    through the exchange layer (dist._remap_shards), counted per tier
    under op "window_remap" with the cost model's exchanges and bytes
    (dist.remap_exchange_tiers; a bank's B times a register's, as the
    JAX package counts them, quest_tpu/fusion.py:525-537) and covered by
    one ``mesh.remap`` span (attrs ``bytes``: the bytes it counts,
    ``swaps``: its mixed half-shard swaps, ``local``: whether a shard
    permutes its own axes, ``tier``), every other
    part through execute_program at nloc bits, one op at a time on every
    shard in turn (a shard holds at most its input and its output at
    once), on that shard's device copy of the program (program_on_device,
    cached under ``key``: the shards of one device share one upload and
    one build of each pass's side images).  A bank's (B, 2, 2^nloc)
    shards take each op whole (execute_plan's bank forms).  Returns the
    ShardedAmps."""
    from .parallel import dist as PAR
    from .parallel import topology as _topo

    nsh = PAR.num_shard_bits(amps.mesh)
    ck = str(PAR.exchange_config_key() or "auto")
    topology = _topo.resolve(1 << nsh)
    bw = max(amps.batch_size, 1)
    progs = {}
    for sh in amps.shards:
        dk = (sh.device, sh.dtype)
        if dk not in progs:
            progs[dk] = program_on_device(program, sh.dtype, sh.device,
                                          key)
    pi = 0
    for i, part in enumerate(program):
        if part[0] == "remap":
            moved, tiers = 0, []
            for tier, (cnt, b) in PAR.remap_exchange_tiers(
                    part[1], nloc, nsh, amps.itemsize, topology).items():
                if cnt or b:
                    PAR.record_exchange("window_remap", cnt * bw, b * bw,
                                        chunks=ck, tier=tier)
                    moved += b * bw
                    tiers.append(tier)
            mixed, local, _tau = PAR.decompose_sigma(part[1], nloc, nsh)
            PAR.settle_traced(amps.mesh)
            with _span("mesh.remap", bytes=moved, swaps=len(mixed),
                       local=local is not None, tier="+".join(tiers)):
                amps = PAR._remap_shards(amps, part[1])
                PAR.settle_traced(amps.mesh)
            continue
        count = _part_probs(part)
        rprobs = probs[pi:pi + count]
        pi += count
        planned = part[0] not in ("chan", "chansweep")
        for j in range(len(part[1]) if planned else 1):
            for k, sh in enumerate(amps.shards):
                step = progs[(sh.device, sh.dtype)][i]
                if planned:
                    step = (step[0], step[1][j:j + 1])
                amps.shards[k] = execute_program(sh, (step,), rprobs, nloc)
    return amps


def _run_sharded(qureg, items) -> None:
    """The drain of a sharded register or bank: optimize (with the
    reordering the exchange cost model scores), plan windows and remaps
    from the live permutation (a bank: one program for every element),
    run the program (or the governor's groups of it) under the exchange
    guard and the OOM net, reconcile the window remaps' counters with an
    independent prediction (introspect.reconcile_drain) and leave the
    final permutation on the register."""
    from . import governor as _gov
    from .parallel import dist as PAR

    n = qureg.num_qubits_in_state_vec
    nsh = qureg.shard_bits
    nloc = n - nsh
    perm0 = qureg._perm
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    t0 = time.perf_counter()
    with _span("fusion.optimize", items_in=len(items)) as sp:
        items, _stats = _opt.optimize_items(items, nloc=nloc, n=n, nsh=nsh,
                                            perm0=perm0)
        sp.attrs["items_out"] = len(items)
    if not items:
        return  # everything cancelled: nothing runs, the perm stays
    with _span("fusion.lookup") as sp:
        program, final_perm, key = _plan_sharded(
            items, n, nloc, perm0, qureg._amps.device, _sweep_ok(qureg), bsz,
            record=True)
        sp.attrs["source"] = getattr(_SOURCE, "where", None)
    probs = tuple(it.prob for it in items if isinstance(it, ChannelItem))
    try:
        with _span("fusion.govern"):
            groups = _governed_groups(qureg, program, probs, nloc=nloc,
                                      nsh=nsh)
            _record_program(program, items, n, nloc, perm0)
            gkey = key if len(groups) == 1 else None
            if gkey is not None:
                # each shard device's copy of the program, made here
                # (cached under the key) rather than in the dispatch
                for dk in {(sh.device, sh.dtype)
                           for sh in qureg._amps.shards}:
                    program_on_device(program, dk[1], dk[0], gkey)
        before = _remap_counters() if _telemetry.enabled() else None
        for group, gprobs in groups:
            def dispatch(g=group, gp=gprobs):
                with _dispatch_span(g):
                    return PAR.guarded_dispatch(
                        execute_sharded_program, qureg._amps, g, gp, nloc,
                        gkey, op="drain", shards=qureg.num_chunks)

            qureg._amps = _timed_group(
                qureg, group, lambda d=dispatch: _gov.oom_net(d, qureg))
        if before is not None:
            _reconcile(qureg, items, before, n=n, nloc=nloc, nsh=nsh,
                       perm0=perm0, bsz=bsz)
        _first_request(qureg, t0)
    finally:
        _gov.end_drain()
    if final_perm is not None and list(final_perm) != list(range(n)):
        qureg._perm = tuple(final_perm)
    else:
        qureg._perm = None


def _remap_counters():
    """(count, bytes, bytes by tier) of the window remaps counted so far."""
    from .parallel import topology as _topo

    return (_telemetry.counter_sum("exchanges_total", op="window_remap"),
            _telemetry.counter_sum("exchange_bytes_total",
                                   op="window_remap"),
            {t: _telemetry.counter_sum("exchange_bytes_total",
                                       op="window_remap", tier=t)
             for t in _topo.TIERS})


def _reconcile(qureg, items, before, *, n, nloc, nsh, perm0, bsz) -> None:
    """Hold a drain's measured window-remap counters against the
    independent re-plan of its items (quest_tpu/fusion.py:539-555)."""
    from . import introspect as _introspect
    from .parallel import dist as PAR

    after = _remap_counters()
    _introspect.reconcile_drain(
        bit_sets=[_item_entry(it) for it in items], n=n, nloc=nloc,
        nsh=nsh, perm0=perm0,
        itemsize=torch.empty((), dtype=qureg.dtype).element_size(),
        batch=bsz, measured_count=after[0] - before[0],
        measured_bytes=after[1] - before[1],
        measured_chunks=str(PAR.exchange_config_key() or "auto"),
        measured_tier_bytes={t: after[2][t] - before[2][t]
                             for t in after[2]})


def _capturable(qureg, bits) -> bool:
    """Can a gate on qubit positions ``bits`` be buffered?  Size-capped;
    on a sharded register also no wider than the shard-local space, and
    a gate reaching a sharded bit only while the explicit exchange and
    the lazy permutation are on (quest_tpu/fusion.py:919-945)."""
    if qureg._fusion is None:
        return False
    bits = tuple(bits)
    if len(bits) > FUSION_MAX_GATE_QUBITS:
        return False
    nsh = _shard_bits(qureg)
    if nsh:
        nloc = qureg.num_qubits_in_state_vec - nsh
        if len(set(bits)) > nloc:
            return False
        if max(bits) >= nloc:
            from .parallel import dist as PAR

            if not (PAR.explicit_dist_enabled()
                    and PAR.lazy_remap_enabled()):
                return False
    return True


def _shard_bits(qureg) -> int:
    """Leading qubits held as shard-index bits (0 on one shard or for a
    replicated register)."""
    return qureg.shard_bits


def capture_unitary(qureg, stacked, targets, controls=(),
                    control_states=()) -> bool:
    """Buffer a dense gate (with the density-matrix conjugate twin,
    QuEST.c:181-183) if fusion is active and the gate qualifies; returns
    False to tell the caller to execute eagerly (after draining, so order
    is preserved)."""
    base_bits = tuple(targets) + tuple(controls)
    if not _capturable(qureg, base_bits):
        drain(qureg)
        return False
    mat = stacked
    if controls:
        mat = C.controlled_dense(stacked, len(controls), control_states)
    buf = qureg._fusion
    buf.add(C.Gate(tuple(targets) + tuple(controls), mat))
    if qureg.is_density_matrix:
        sh = qureg.num_qubits_represented
        cmat = _cplx.conj(stacked)
        if controls:
            cmat = C.controlled_dense(cmat, len(controls), control_states)
        buf.add(C.Gate(tuple(t + sh for t in targets)
                       + tuple(c + sh for c in controls), cmat))
    return True


def capture_raw(qureg, stacked, targets) -> bool:
    """Buffer a dense matrix on state-vector bit positions ``targets`` with
    no density-matrix twin: a decoherence channel's superoperator, which
    already acts on the combined (T, T+n) targets (QuEST_common.c:630-652),
    so it folds into the drain's planned passes like a gate."""
    if not _capturable(qureg, tuple(targets)):
        drain(qureg)
        return False
    qureg._fusion.add(C.Gate(tuple(targets), stacked))
    return True


def capture_pair_channel(qureg, kind: str, target: int, prob) -> bool:
    """Buffer a depolarise / damping channel as a ChannelItem, run by the
    drain in call order between the gate segments (not as a superoperator
    fold: these channels have operator-Schmidt rank 4 across (t, t+n))."""
    sh = qureg.num_qubits_represented
    if not _capturable(qureg, (target, target + sh)):
        drain(qureg)
        return False
    qureg._fusion.add(ChannelItem(kind, target, target + sh, prob))
    return True


_X = np.stack([np.array([[0.0, 1.0], [1.0, 0.0]]), np.zeros((2, 2))])


def capture_not(qureg, targets, controls=(), control_states=()) -> bool:
    """Buffer a (multi-controlled) multi-qubit NOT: uncontrolled targets
    become independent 1q X gates; controlled ones one dense gate."""
    if not controls:
        if qureg._fusion is None:
            return False
        sh = qureg.num_qubits_represented
        bits = list(targets)
        if qureg.is_density_matrix:
            bits += [t + sh for t in targets]
        if not all(_capturable(qureg, (b,)) for b in bits):
            drain(qureg)
            return False
        for t in targets:
            qureg._fusion.add(C.Gate((t,), _X))
            if qureg.is_density_matrix:
                qureg._fusion.add(C.Gate((t + sh,), _X))
        return True
    # size-check BEFORE densifying the 2^nt x 2^nt matrix
    if not _capturable(qureg, tuple(targets) + tuple(controls)):
        drain(qureg)
        return False
    d = 1 << len(targets)
    xr = np.zeros((d, d))
    for i in range(d):
        xr[i, i ^ (d - 1)] = 1.0
    mat = np.stack([xr, np.zeros((d, d))])
    return capture_unitary(qureg, mat, targets, controls, control_states)


def capture_diag(qureg, diag_stacked, targets, controls=(),
                 control_states=()) -> bool:
    """Buffer a diagonal gate as its dense matrix."""
    if not _capturable(qureg, tuple(targets) + tuple(controls)):
        drain(qureg)
        return False
    d = diag_stacked.shape[-1]
    mat = np.zeros((2, d, d), dtype=diag_stacked.dtype)
    mat[0][np.diag_indices(d)] = diag_stacked[0]
    mat[1][np.diag_indices(d)] = diag_stacked[1]
    return capture_unitary(qureg, mat, targets, controls, control_states)


@contextmanager
def gate_fusion(qureg):
    """Context manager: buffer imperative-API gates on ``qureg`` and
    execute them through the fused planner on exit (or the moment any
    operation needs the amplitudes).  Nesting-safe: an inner context
    reuses the outer buffer and leaves it active on exit."""
    created = qureg._fusion is None
    start_gate_fusion(qureg)
    try:
        yield qureg
    finally:
        if created:
            stop_gate_fusion(qureg)
