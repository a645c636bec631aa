"""Memory-governed execution: budget, admission, spill, the OOM net.

The JAX package's ``governor.py`` on the card's caching allocator.  A
register's footprint is an admission decision, the way a server gates
requests on a memory budget:

* **Budget** -- bytes per device: ``QT_HBM_BUDGET_BYTES`` when set (the
  reference's per-mesh-device meaning, so the 8-shard CPU tests price
  as the reference does), else probed on the register's CUDA devices.
  The probe is ``torch.cuda.mem_get_info``'s free bytes plus what this
  process's caching allocator already reserves: the bytes this
  process's tensors can occupy on the card, the counterpart of the
  reference's allocator cap ``memory_stats()['bytes_limit']``.
  ``mem_get_info``'s total is not used: it also covers the CUDA context,
  the libraries' workspaces and other processes.  A card shared by R
  shards of an in-process mesh gives each a 1/R share (on
  torch.distributed a rank holds one shard of its card).  A CPU device
  has no budget: the governor is inert there, as the reference is on the
  bare CPU backend; on a CUDA device a probe that fails raises.
  ``QT_MEM_POLICY`` selects ``off`` / ``degrade`` (default) / ``strict``.

* **Ledger** -- every live register is tracked weakly with its modeled
  bytes per device and an LRU tick: "available" is the budget minus the
  resident bytes, and spill candidates come out least recently used
  first.

* **Predictor** -- a drain's peak, ``state x (1 + max part extra) +
  pass-array bytes``: a gate or channel part holds one extra copy, a
  monolithic remap two, a remap over C chunks 1 + 2/C (the reference's
  donated-output model, kept so that decisions match it; on the card K1
  runs out of place and a drain holds its input, PERF.md).  The pass
  arrays are the port's own plan operands.

* **Enforcement** -- ``admit_new`` gates createQureg, createDensityQureg,
  createCloneQureg and createBatchedQureg with a
  :class:`MemoryAdmissionError`; ``govern_drain`` walks the ladder when a
  drain's peak exceeds the budget: (1) more exchange chunks, (2) the
  program split into dispatch groups, (3) idle registers spilled to host
  (pinned memory on the card) behind a handle that restores on the next
  touch, (4) refusal.  ``strict`` refuses at once, before any dispatch.

* **OOM net** -- :func:`oom_net` wraps every drain dispatch: an
  allocator failure (``torch.cuda.OutOfMemoryError``, or a FaultPlan
  ``oom@W``) spills every idle register, empties the plan and device
  caches and ``torch.cuda.empty_cache()``, and retries once, unless the
  failed attempt already changed the register's state in place (a K5
  sweep, a remap): then the failure propagates.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Dict, List, Optional

import torch

from . import telemetry as _telemetry
from .validation import QuESTError

_POLICY_ENV = "QT_MEM_POLICY"
_BUDGET_ENV = "QT_HBM_BUDGET_BYTES"
_POLICIES = ("off", "degrade", "strict")

# --- live-copy model (quest_tpu/governor.py:74-87) -------------------------
# a gate or channel part holds its output beside its input; a monolithic
# window remap a whole shard's exchange transient more, a pipelined one
# at most two chunks of it
GATE_PART_EXTRA = 1.0


def remap_part_extra(chunks: int) -> float:
    """Extra live shard copies of one ("remap", sigma) part at chunk
    count ``chunks``: 2.0 monolithic, 1 + 2/C pipelined."""
    c = max(int(chunks), 1)
    return 2.0 if c <= 1 else 1.0 + 2.0 / c


class MemoryAdmissionError(QuESTError):
    """A register or drain was refused because its predicted footprint per
    device exceeds the available budget; carries the numbers."""

    def __init__(self, func: str, predicted_bytes: int,
                 available_bytes: int, budget_bytes: int):
        self.predicted_bytes = int(predicted_bytes)
        self.available_bytes = int(available_bytes)
        self.budget_bytes = int(budget_bytes)
        super().__init__(
            f"{func}: predicted peak of {self.predicted_bytes} bytes per "
            f"device exceeds the {self.available_bytes} bytes available "
            f"under the {self.budget_bytes}-byte per-device HBM budget "
            f"(policy={policy()}; set {_BUDGET_ENV} / {_POLICY_ENV} to "
            f"adjust)")


class _InjectedOOM(RuntimeError):
    """The allocator failure a FaultPlan ``oom@W`` event raises before the
    dispatch runs; its message carries the marker _is_oom reads."""


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def _is_oom(e: BaseException) -> bool:
    """An allocator failure: torch's OutOfMemoryError by type, or any
    error whose text says so ("CUDA out of memory", RESOURCE_EXHAUSTED)."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return any(m in s for m in _OOM_MARKERS)


# ---------------------------------------------------------------------------
# Policy and budget
# ---------------------------------------------------------------------------

# card -> probed bytes this process's tensors can hold there (cached)
_DEVICE_LIMIT: Dict[str, int] = {}


def policy() -> str:
    """``QT_MEM_POLICY``: off | degrade (default) | strict."""
    p = os.environ.get(_POLICY_ENV, "degrade").strip().lower() or "degrade"
    if p not in _POLICIES:
        from . import resilience

        resilience.record_degradation(
            "memory_governor_policy",
            f"unknown {_POLICY_ENV}={p!r}; using 'degrade'")
        return "degrade"
    return p


def _override():
    """(True, bytes or None) when QT_HBM_BUDGET_BYTES holds an integer (0
    or less: no budget), else (False, None); an unparseable value is
    recorded and ignored, as the reference does."""
    raw = os.environ.get(_BUDGET_ENV)
    if raw is None:
        return False, None
    try:
        v = int(raw)
    except ValueError:
        from . import resilience

        resilience.record_degradation(
            "memory_governor_budget",
            f"unparseable {_BUDGET_ENV}={raw!r}; ignoring")
        return False, None
    return True, (v if v > 0 else None)


def _limit(dev: torch.device) -> int:
    """The bytes this process's tensors can occupy on card ``dev``: its
    free bytes plus what the caching allocator already reserves there.
    A failed probe raises: the governor never goes inert on a card."""
    key = str(dev)
    if key not in _DEVICE_LIMIT:
        try:
            free, _total = torch.cuda.mem_get_info(dev)
            held = torch.cuda.memory_reserved(dev)
        except Exception as e:  # noqa: BLE001 - any failure must surface
            raise QuESTError(
                f"memory governor: cannot read the memory of {dev} ({e!r}); "
                f"set {_BUDGET_ENV}, or {_POLICY_ENV}=off") from e
        _DEVICE_LIMIT[key] = int(free) + int(held)
    return _DEVICE_LIMIT[key]


def _pieces(x) -> Optional[Dict[torch.device, int]]:
    """card -> pieces of ``x`` there: a register's shard tensors on each
    device (one tensor for a register held whole), an env's local shards,
    or with ``x`` None every visible card once.  None when any of them is
    not a CUDA device (no budget)."""
    if x is None:
        if not torch.cuda.is_available():
            return None
        return {torch.device("cuda", i): 1
                for i in range(torch.cuda.device_count())}
    env = getattr(x, "env", x)
    mesh = env.mesh
    if mesh is None or (x is not env and not x.is_sharded):
        devs = [env.device]
    else:
        devs = [mesh.devices[s] for s in mesh.local]
    out: Dict[torch.device, int] = {}
    for d in devs:
        d = torch.device(d)
        if d.type != "cuda":
            return None
        if d.index is None:  # "cuda": the current card
            d = torch.device("cuda", torch.cuda.current_device())
        out[d] = out.get(d, 0) + 1
    return out


def budget_bytes(x=None) -> Optional[int]:
    """Per-device budget of register or env ``x``: ``QT_HBM_BUDGET_BYTES``,
    else the least share of a card it lies on (None off the card, the
    governor inert); ``x`` None: every visible card."""
    set_, v = _override()
    if set_:
        return v
    pieces = _pieces(x)
    if not pieces:
        return None
    return min(_limit(d) // k for d, k in pieces.items())


def enabled(x=None) -> bool:
    return policy() != "off" and budget_bytes(x) is not None


# ---------------------------------------------------------------------------
# Register ledger
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("ref", "bytes", "tick", "spilled")

    def __init__(self, ref, nbytes: int, tick: int):
        self.ref = ref
        self.bytes = int(nbytes)
        self.tick = tick
        self.spilled = False


_LEDGER: dict = {}  # id(qureg) -> _Entry (weakly referenced)
_TICK = [0]
# max modeled (resident + drain transient) bytes of any governed drain
_MODELED_PEAK: List[Optional[int]] = [None]


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _total_bytes(qureg) -> int:
    b = max(int(getattr(qureg, "batch_size", 0) or 0), 1)
    return b * 2 * qureg.num_amps_total * _itemsize(qureg.dtype)


def register_bytes_per_device(qureg) -> int:
    """Modeled bytes one device holds for ``qureg``: ``B x 2 x 2^n x
    itemsize`` split over the shards (a register too small to shard is
    held whole)."""
    total = _total_bytes(qureg)
    env = qureg.env
    if env.mesh is not None and qureg.num_amps_total >= env.num_devices:
        return total // env.num_devices
    return total


def _card_bytes(qureg) -> Dict[torch.device, int]:
    """Bytes of ``qureg`` on each card it lies on."""
    pieces = _pieces(qureg) or {}
    per = register_bytes_per_device(qureg)
    return {d: per * k for d, k in pieces.items()}


def refresh_budget() -> None:
    """Probe the cards again and re-price every resident entry against
    its register's current env (after a failover changed the mesh)."""
    _DEVICE_LIMIT.clear()
    for key in list(_LEDGER):
        e = _LEDGER.get(key)
        q = e.ref() if e is not None else None
        if q is None:
            _LEDGER.pop(key, None)
            continue
        if not e.spilled:
            e.bytes = register_bytes_per_device(q)
    _telemetry.inc("governor_budget_rederivations_total")


def _next_tick() -> int:
    _TICK[0] += 1
    return _TICK[0]


def track(qureg) -> None:
    """Enter ``qureg`` into the ledger (idempotent; always on)."""
    key = id(qureg)

    def _gone(_ref, _key=key):
        _LEDGER.pop(_key, None)

    _LEDGER[key] = _Entry(weakref.ref(qureg, _gone),
                          register_bytes_per_device(qureg), _next_tick())


def release(qureg) -> None:
    """Drop ``qureg`` from the ledger (destroyQureg)."""
    _LEDGER.pop(id(qureg), None)


def touch(qureg) -> None:
    """Bump the register's LRU tick (a drain or a restore)."""
    e = _LEDGER.get(id(qureg))
    if e is not None:
        e.tick = _next_tick()


def _resident():
    """(key, entry, register) of every tracked register whose amplitudes
    are on its devices."""
    for key in list(_LEDGER):
        e = _LEDGER.get(key)
        if e is None:
            continue
        q = e.ref()
        if q is None:
            _LEDGER.pop(key, None)
            continue
        if e.spilled or q._amps is None:
            continue
        yield key, e, q


def resident_bytes(exclude=None) -> int:
    """Modeled bytes per device of every resident tracked register (spilled
    and destroyed ones do not count), the reference's sum."""
    ex = id(exclude) if exclude is not None else None
    return sum(e.bytes for key, e, _q in _resident() if key != ex)


def _room(qureg):
    """(budget, other resident bytes) in ``qureg``'s bytes per device, or
    None when no budget applies.  Under QT_HBM_BUDGET_BYTES the
    reference's per-mesh-device sums; on the card, per card: the other
    registers' bytes there and the card's budget, each divided among
    ``qureg``'s shards on it, for the card with the least room."""
    if policy() == "off":
        return None
    set_, v = _override()
    if set_:
        return None if v is None else (v, resident_bytes(exclude=qureg))
    pieces = _pieces(qureg)
    if not pieces:
        return None
    ex = id(qureg)
    on = {d: 0 for d in pieces}
    for key, _e, q in _resident():
        if key == ex:
            continue
        for d, nb in _card_bytes(q).items():
            if d in on:
                on[d] += nb
    best = None
    for d, k in pieces.items():
        b, o = _limit(d) // k, on[d] // k
        if best is None or b - o < best[0] - best[1]:
            best = (b, o)
    return best


# ---------------------------------------------------------------------------
# Admission (register creation)
# ---------------------------------------------------------------------------


def admit_new(qureg, func: str) -> None:
    """Gate a new register before its allocation: with a budget, refuse
    (MemoryAdmissionError) when its footprint does not fit beside the
    resident registers."""
    room = _room(qureg)
    if room is not None:
        need = register_bytes_per_device(qureg)
        b, other = room
        if need > b - other:
            _telemetry.inc("admission_rejects_total", func=func)
            raise MemoryAdmissionError(func, need, b - other, b)
    track(qureg)


# ---------------------------------------------------------------------------
# Spill to host
# ---------------------------------------------------------------------------


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned memory for a card's tensor."""
    h = torch.empty(t.shape, dtype=t.dtype,
                    pin_memory=t.device.type == "cuda")
    h.copy_(t)
    return h


class SpillHandle:
    """Host snapshot of an evicted register: its raw (possibly permuted)
    tensors, one per local shard, the live permutation, the type and, for
    a BatchedQureg, the measurement key bank.  Restored lazily on the
    next touch (Qureg.amps / _amps_raw)."""

    __slots__ = ("pieces", "mesh", "perm", "dtype", "key_state", "nbytes")

    def __init__(self, amps, perm, dtype, key_state):
        from .parallel.mesh import ShardedAmps

        if isinstance(amps, ShardedAmps):
            self.mesh, src = amps.mesh, list(amps.shards)
        else:
            self.mesh, src = None, [amps]
        self.pieces = [(t.device, _host_copy(t)) for t in src]
        self.perm = None if perm is None else tuple(perm)
        self.dtype = dtype
        self.key_state = key_state
        self.nbytes = sum(h.numel() * h.element_size()
                          for _d, h in self.pieces)

    def materialize(self, qureg):
        """The amplitudes back on their devices."""
        from .parallel.mesh import ShardedAmps

        ts = [h.to(d) for d, h in self.pieces]
        return ShardedAmps(self.mesh, ts) if self.mesh is not None else ts[0]


class _SparseHandle:
    """A lazy sparse state (initSparseState under the governor): admitted
    at the cost of its indices and values, made dense on its devices at
    the first touch, through restore_register and so under admission."""

    __slots__ = ("indices", "res", "ims", "perm", "dtype", "key_state",
                 "nbytes")

    def __init__(self, indices, res, ims, dtype):
        import numpy as np

        self.indices = np.asarray(indices, dtype=np.int64)
        self.res = np.asarray(res, dtype=np.float64)
        self.ims = np.asarray(ims, dtype=np.float64)
        self.perm = None
        self.dtype = dtype
        self.key_state = None
        self.nbytes = int(self.indices.nbytes
                          + 2 * self.indices.size * _itemsize(dtype))

    def materialize(self, qureg):
        if qureg.is_sharded:
            from .parallel import sharded as SH

            return SH.sparse(qureg.env.mesh, qureg.num_qubits_in_state_vec
                             - qureg.shard_bits, self.dtype, self.indices,
                             self.res, self.ims)
        from .ops import kernels as K

        return K.init_sparse_state(qureg.num_amps_total, self.indices,
                                   self.res, self.ims, self.dtype,
                                   qureg.device)


def _mark_spilled(qureg) -> None:
    e = _LEDGER.get(id(qureg))
    if e is None:
        track(qureg)
        e = _LEDGER[id(qureg)]
    e.spilled = True


def admit_sparse_state(qureg, indices, res, ims,
                       func: str = "initSparseState") -> None:
    """Install a lazy sparse state: the device state is dropped, the
    handle admitted at its sparse cost, and the dense state made at the
    first touch under admission (spilling neighbours if need be)."""
    h = _SparseHandle(indices, res, ims, qureg.dtype)
    room = _room(qureg)
    if room is not None and h.nbytes > room[0] - room[1]:
        _telemetry.inc("admission_rejects_total", func=func)
        raise MemoryAdmissionError(func, h.nbytes, room[0] - room[1],
                                   room[0])
    qureg._amps = None
    qureg._perm = None
    qureg._spill = h
    _mark_spilled(qureg)


def spill_register(qureg) -> int:
    """Evict ``qureg``'s amplitudes to host memory behind a lazy
    :class:`SpillHandle`; returns the modeled bytes per device freed (0
    when nothing was resident).  Pending fused gates stay buffered."""
    if qureg._amps is None or getattr(qureg, "_spill", None) is not None:
        return 0
    key_state = qureg.key_state() if hasattr(qureg, "key_state") else None
    h = SpillHandle(qureg._amps, qureg._perm, qureg.dtype, key_state)
    qureg._spill = h
    qureg._amps = None
    qureg._perm = None
    _mark_spilled(qureg)
    _telemetry.inc("spills_total")
    _telemetry.inc("spill_bytes_total", h.nbytes)
    return _LEDGER[id(qureg)].bytes


def restore_register(qureg) -> bool:
    """Bring a spilled register back onto its devices, bit for bit (raw
    amplitudes, permutation, key bank), making room first; False when it
    was never spilled (Qureg.amps then raises its destroyed-register
    error)."""
    h = getattr(qureg, "_spill", None)
    if h is None:
        return False
    qureg._spill = None
    e = _LEDGER.get(id(qureg))
    if e is not None:
        e.spilled = False
    room = _room(qureg)
    need = register_bytes_per_device(qureg)
    if room is not None and room[1] + need > room[0]:
        spill_until(need, exclude=qureg)
    qureg.dtype = h.dtype
    qureg._set_amps_permuted(h.materialize(qureg), h.perm)
    if h.key_state is not None:
        qureg.set_key_state(h.key_state)
    touch(qureg)
    _telemetry.inc("spill_restores_total")
    return True


def ensure_resident(qureg) -> None:
    """Restore ``qureg`` if it was spilled (the drain reads ``_amps``
    directly, past the property)."""
    if getattr(qureg, "_spill", None) is not None:
        restore_register(qureg)


def _spill_candidates(exclude=None) -> list:
    """Resident registers other than ``exclude``, least recently used
    first; on the card only those sharing a card with ``exclude``."""
    ex = id(exclude) if exclude is not None else None
    cards = None
    if exclude is not None and not _override()[0]:
        cards = set(_pieces(exclude) or ()) or None
    out = []
    for key, e, q in _resident():
        if key == ex:
            continue
        if cards is not None and not cards & set(_card_bytes(q)):
            continue
        out.append((e.tick, e, q))
    out.sort(key=lambda t: t[0])
    return out


def spill_until(need: int, exclude=None) -> int:
    """Spill idle registers in LRU order until ``need`` bytes fit beside
    what stays resident; returns the bytes freed."""
    freed = 0
    for _tick, _e, q in _spill_candidates(exclude):
        room = (_room(exclude) if exclude is not None
                else (budget_bytes(), resident_bytes()))
        if room is None or room[0] is None or room[1] + need <= room[0]:
            break
        freed += spill_register(q)
    return freed


def spill_all_idle(exclude=None) -> int:
    """Evict every idle register (the OOM net's last move)."""
    return sum(spill_register(q)
               for _t, _e, q in _spill_candidates(exclude))


# ---------------------------------------------------------------------------
# Drain prediction and the degradation ladder
# ---------------------------------------------------------------------------


def _part_array_bytes(part) -> int:
    """Bytes of one program part's pass arrays (a planned part's
    operands; other parts carry none)."""
    if part[0] != "plan":
        return 0
    from . import circuit as C

    return int(sum(int(getattr(a, "nbytes", 0) or 0)
                   for a in C.split_plan(part[1])[1]))


def _resolved_chunks(qureg, nloc: int, nsh: int) -> int:
    """Full-shard chunk count the remap parts resolve under the live
    chunk policy (env override, governor override, heuristic)."""
    if not nsh:
        return 1
    from .parallel import dist as PAR

    return int(PAR.remap_chunk_plan(
        nloc, _itemsize(qureg.dtype), qureg.device.type,
        int(getattr(qureg, "batch_size", 0) or 0))[1])


def _program_peak(program, state: int, arrays_b: int, chunks: int) -> int:
    """Predicted peak per device of dispatching ``program`` as one group."""
    extra = 0.0
    for part in program:
        pe = (remap_part_extra(chunks) if part[0] == "remap"
              else GATE_PART_EXTRA)
        extra = max(extra, pe)
    return int(state * (1.0 + extra)) + int(arrays_b)


def predict_drain(qureg, program, *, nloc: int, nsh: int,
                  chunks: Optional[int] = None) -> dict:
    """The modeled footprint per device of draining ``program`` on
    ``qureg``: what govern_drain enforces and explain_circuit's
    ``memory`` section reports."""
    itemsize = _itemsize(qureg.dtype)
    state = register_bytes_per_device(qureg)
    arrays_b = sum(_part_array_bytes(p) for p in program)
    c = chunks if chunks is not None else _resolved_chunks(qureg, nloc,
                                                            nsh)
    peak = (_program_peak(program, state, arrays_b, c) if program
            else state)
    room = _room(qureg)
    b, other = room if room is not None else (
        budget_bytes(qureg), resident_bytes(exclude=qureg))
    tier_b = {"ici": 0, "dcn": 0}
    if nsh:
        from .parallel import dist as PAR
        from .parallel import topology as _topo

        topology = _topo.resolve(1 << nsh)
        for part in program:
            if part[0] != "remap":
                continue
            for t, (_cnt, nb) in PAR.remap_exchange_tiers(
                    part[1], nloc, nsh, itemsize, topology).items():
                tier_b[t] += nb
        weights = _topo.tier_weights()
    else:
        weights = {"ici": 1.0, "dcn": 1.0}
    return {
        "policy": policy(),
        "budget_bytes": b,
        "state_bytes_per_device": int(state),
        "pass_array_bytes": int(arrays_b),
        "live_multiplier": round(
            (peak - arrays_b) / state, 4) if state else 1.0,
        "exchange_chunks": int(c),
        "predicted_peak_bytes": int(peak),
        "other_resident_bytes": int(other),
        "predicted_total_bytes": int(other + peak),
        "headroom_bytes": None if b is None else int(b - other - peak),
        "fits": None if b is None else bool(other + peak <= b),
        "exchange_tier_bytes": {t: int(v) for t, v in tier_b.items()},
        "weighted_exchange_cost": float(sum(
            weights[t] * v for t, v in tier_b.items())),
    }


def _split_program(program, state: int, other: int, b: int, chunks: int):
    """Rung 2: pack the parts greedily into contiguous dispatch groups
    each fitting the budget beside ``other``; the groups run one after
    the other, part by part as the whole program would, so the result is
    the same.  None when grouping cannot help."""
    sizes = [_part_array_bytes(p) for p in program]
    groups: List[tuple] = []
    cur: List[tuple] = []
    start = 0
    for i, part in enumerate(program):
        trial = cur + [part]
        if cur and other + _program_peak(
                trial, state, sum(sizes[start:i + 1]), chunks) > b:
            groups.append(tuple(cur))
            cur, start = [part], i
        else:
            cur = trial
    if cur:
        groups.append(tuple(cur))
    if len(groups) <= 1:
        return None
    if other + _max_group_peak(groups, state, chunks) > b:
        return None
    return tuple(groups)


def _max_group_peak(groups, state: int, chunks: int) -> int:
    return max(_program_peak(g, state, sum(_part_array_bytes(p) for p in g),
                             chunks) for g in groups)


def govern_drain(qureg, program, *, nloc: int, nsh: int):
    """Enforce the budget on one planned drain.  None when the governor is
    inert or the drain fits; else ``{"groups": part groups or None,
    "chunks": C or None}`` after the ladder (chunks, split, spill,
    refuse).  ``strict`` raises MemoryAdmissionError before any dispatch;
    the drain's failure path puts the gates back in the buffer."""
    touch(qureg)
    room = _room(qureg)
    if room is None or not program:
        return None
    from . import resilience as _res
    from .parallel import dist as PAR

    b, other = room
    state = register_bytes_per_device(qureg)
    arrays_b = sum(_part_array_bytes(p) for p in program)
    c0 = _resolved_chunks(qureg, nloc, nsh)
    need = _program_peak(program, state, arrays_b, c0)
    if other + need <= b:
        _record_usage(other + need)
        return None
    if policy() == "strict":
        _telemetry.inc("admission_rejects_total", func="drain")
        raise MemoryAdmissionError("gateFusion drain", need, b - other, b)

    applied = []
    # rung 1: pipeline the remaps harder; an explicit QT_EXCHANGE_CHUNKS
    # is the user's word and is never fought
    c = c0
    if (nsh and any(p[0] == "remap" for p in program)
            and os.environ.get(PAR._EXCHANGE_ENV) is None):
        cap = min(PAR.MAX_EXCHANGE_CHUNKS, 1 << max(nloc - 1, 0))
        pick = None
        t = max(c0, 1)
        while t < cap:
            t *= 2
            if other + _program_peak(program, state, arrays_b, t) <= b:
                pick = t
                break
        if pick is None and cap > c0:
            pick = cap
        if pick is not None and pick != c0:
            c = pick
            PAR._GOVERNOR_CHUNKS[0] = int(c)
            applied.append(("chunks",
                            f"exchange chunks {c0} -> {c} to shrink "
                            "remap transients"))
            need = _program_peak(program, state, arrays_b, c)

    # rung 2: split the program into dispatch groups
    groups = None
    if other + need > b:
        groups = _split_program(program, state, other, b, c)
        if groups is not None:
            applied.append(("split",
                            f"drain split into {len(groups)} dispatch "
                            "groups"))
            need = _max_group_peak(groups, state, c)

    # rung 3: spill idle registers, least recently used first
    if other + need > b:
        freed = spill_until(need, exclude=qureg)
        if freed:
            applied.append(("spill",
                            f"spilled {freed} resident bytes of idle "
                            "registers to host"))
        b, other = _room(qureg)

    if other + need > b:
        _telemetry.inc("admission_rejects_total", func="drain")
        end_drain()
        raise MemoryAdmissionError("gateFusion drain", need, b - other, b)

    for rung, why in applied:
        _telemetry.inc("governor_degradations_total", rung=rung)
        _res.record_degradation("memory_governor_" + rung, why)
    _record_usage(other + need)
    return {"groups": groups, "chunks": c if c != c0 else None}


def end_drain() -> None:
    """Clear the drain's chunk escalation (the drain's ``finally``)."""
    from .parallel import dist as PAR

    PAR._GOVERNOR_CHUNKS[0] = None


def _record_usage(total: int) -> None:
    _MODELED_PEAK[0] = max(int(total), _MODELED_PEAK[0] or 0)


def modeled_watermark_bytes() -> Optional[int]:
    """The largest modeled (resident + transient) bytes per device of any
    governed drain: utils.profiling.memory_watermark publishes it as
    ``hbm_watermark_bytes{device="model"}`` where no device statistics
    exist."""
    if not enabled():
        return None
    return _MODELED_PEAK[0]


# ---------------------------------------------------------------------------
# OOM net
# ---------------------------------------------------------------------------


def _state_mark(qureg):
    """The identity and version of ``qureg``'s amplitude tensors: an
    attempt that changed them (an in-place kernel, a remap, a rebound
    shard, a carrier marked lost) cannot be run again."""
    if qureg is None or qureg._amps is None:
        return None
    from .parallel import dist as PAR
    from .parallel.mesh import ShardedAmps

    a = qureg._amps
    if not isinstance(a, ShardedAmps):
        return (id(a), a._version)
    try:
        return (id(a), PAR.state_mark(a))
    except Exception:  # noqa: BLE001 - a lost carrier raises its error
        return ("lost", id(a))


def oom_net(fn, qureg=None):
    """Run ``fn()`` (one drain dispatch) under the allocator-failure net:
    on a failure (real, or a FaultPlan ``oom@W`` injected before the
    dispatch) evict the idle registers, clear the caches, back off and
    retry once; a second failure propagates.  A failure after the attempt
    changed the register's state in place propagates at once."""
    from . import resilience as _res

    plan = _res._ACTIVE_FAULTS[0]
    if plan is not None:
        # a drain outside run_resumable counts its oom@W events as window 0
        plan.arm_oom(0)

    def attempt():
        if plan is not None and plan.take_oom_fault():
            raise _InjectedOOM(
                "RESOURCE_EXHAUSTED: injected allocation failure "
                "(FaultPlan oom)")
        return fn()

    mark = _state_mark(qureg)
    try:
        return attempt()
    except Exception as e:  # noqa: BLE001 - only allocator failures retry
        if not _is_oom(e) or _state_mark(qureg) != mark:
            raise
        why = f"{type(e).__name__}: {e}"
    # the failed attempt's frames (and the tensors they held) are gone here
    _recover_from_oom(qureg, why)
    return attempt()


def _recover_from_oom(qureg, why: str) -> None:
    from . import fusion as _fusion
    from . import resilience as _res

    _telemetry.inc("oom_retries_total")
    _telemetry.inc("governor_degradations_total", rung="oom_retry")
    _res.record_degradation(
        "memory_governor_oom_retry",
        f"allocator failure at dispatch ({why:.120}); evicted idle "
        "registers and cleared the plan caches for one retry")
    spill_all_idle(exclude=qureg)
    _fusion._plan_cache.clear()
    _fusion._device_programs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    time.sleep(float(os.environ.get("QT_RETRY_BASE_SECONDS", "0.05")))


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------


def explain_memory(qureg, items) -> dict:
    """explain_circuit's ``memory`` section: ``items`` planned quietly (no
    telemetry, no plan-cache insertion) and the predictor run over the
    program the drain would dispatch."""
    from . import fusion as F

    program, _fp, nloc, nsh = F.plan_items_quiet(qureg, items)
    return predict_drain(qureg, program, nloc=nloc, nsh=nsh)


def summary_line(env=None) -> Optional[str]:
    """The governor's reportPerf line (None when inert and nothing ever
    fired)."""
    rejects = _telemetry.counter_total("admission_rejects_total")
    spills = _telemetry.counter_total("spills_total")
    ooms = _telemetry.counter_total("oom_retries_total")
    if not enabled(env) and not (rejects or spills or ooms):
        return None
    b = budget_bytes(env)
    parts = [f"memory governor: policy={policy()}",
             f"budget={b if b is not None else '-'}",
             f"resident={resident_bytes()}"]
    if _MODELED_PEAK[0] is not None:
        parts.append(f"modeled_peak={_MODELED_PEAK[0]}")
    parts.append(f"rejects={int(rejects)} spills={int(spills)} "
                 f"oom_retries={int(ooms)}")
    return " ".join(parts)


def reset() -> None:
    """Forget all governor state (tests): ledger, modeled peak, probes and
    any live chunk escalation."""
    _LEDGER.clear()
    _TICK[0] = 0
    _MODELED_PEAK[0] = None
    _DEVICE_LIMIT.clear()
    end_drain()
