"""The exchange layer: gates, swaps, remaps and sums across shards.

The port of the first half of the JAX package's ``parallel/dist.py`` and
its remap layer.  A state of n qubits split over R = 2^r shards keeps
qubits 0..nloc-1 inside each shard and qubits nloc..n-1 as the shard
index's bits (the reference's chunkId scheme, QuEST.h:330-338).  Where
the JAX package runs ``shard_map`` bodies with ``ppermute`` / ``psum``,
the port loops over the mesh's local shards and moves data with the
mesh's ``permute`` / ``sum`` / ``gather`` (parallel/mesh.py):

* a one-qubit gate on a sharded target: one full-shard exchange with the
  XOR partner and an elementwise combine (``apply_matrix_1q_sharded``;
  QuEST_cpu_distributed.c:854-928);
* a swap of a local and a sharded qubit: the mismatched half-shard moves
  (``swap_sharded``; QuEST_cpu_distributed.c:1397-1436);
* a batched bit permutation (``remap_sharded``): the mixed half-shard
  swaps, one per-shard axis permutation (kernels.permute_qubits) and one
  composed shard-index permute (``decompose_sigma``);
* sums over shards (``total_prob_sharded``) and the gather of the whole
  register (``gather_replicated``).

Every exchange is chunked (``exchange_pipelined``): the payload splits
into C pieces along its last axis, moved and combined one piece at a
time, so the receive buffer is one chunk; the result is the same for any
C.  The exchanges are counted in the telemetry registry, by op family,
tier and chunk setting, as the JAX package counts them
(``exchanges_total`` / ``exchange_bytes_total``; per-shard bytes).
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import telemetry as _telemetry
from ..contracts import sharded_contract
from ..ops import cplx, kernels
from . import topology as topo
from ..validation import QuESTError
from .mesh import Mesh, ShardedAmps

_CONFIG = {"explicit": True, "lazy_remap": True}

# ---------------------------------------------------------------------------
# Exchange accounting: the telemetry registry's series (telemetry.py)
# ---------------------------------------------------------------------------


def _inc(name: str, value: float, **labels) -> None:
    _telemetry.inc(name, value, **labels)


def record_exchange(op: str, count: int = 1, nbytes: int = 0, *,
                    chunks="auto", tier: str = "ici") -> None:
    """One call per exchange program and tier: ``count`` transfers moving
    ``nbytes`` per-shard bytes (telemetry.record_exchange)."""
    _telemetry.record_exchange(op, count, nbytes, chunks=str(chunks),
                               tier=tier)


def record_route(route: str) -> None:
    """One eager dispatch on a sharded register, by route (local,
    exchange_1q, relocalize, default)."""
    _telemetry.inc("dispatch_route_total", route=route)


def counter_sum(name: str, /, **labels) -> float:
    """Sum of counter ``name`` over every series whose labels hold
    ``labels`` (telemetry.counter_sum)."""
    return _telemetry.counter_sum(name, **labels)


def reset_counters() -> None:
    """Clear the telemetry registry (telemetry.reset)."""
    _telemetry.reset()


def mesh_topology(mesh: Mesh) -> topo.Topology:
    """The live arrangement of the mesh (QT_TOPOLOGY; one host)."""
    return topo.resolve(amp_axis_size(mesh))


def _record_exchange_tiers(op: str, parts, chunks) -> None:
    """One record per nonzero tier of ``parts``: tier -> (count, bytes)."""
    for tier, (count, nbytes) in parts.items():
        if count or nbytes:
            record_exchange(op, count, nbytes, chunks=chunks, tier=tier)


# ---------------------------------------------------------------------------
# The guard around every exchange dispatch
# ---------------------------------------------------------------------------

_DEADLINE_ENV = "QT_EXCHANGE_DEADLINE_S"
_GUARD_ATTEMPTS_ENV = "QT_EXCHANGE_RETRIES"

# fault-injection slot: a callable taking the op name and returning None,
# "stall", "shard_loss" or "host_loss" (one fault per attempt)
EXCHANGE_FAULT_HOOK: list = [None]


class ShardLossError(RuntimeError):
    """A shard is presumed dead: an exchange kept failing past its retry
    budget, or an injected fault declared the loss.  Not a QuESTError:
    it signals a failure of the machine, not of the call."""

    def __init__(self, msg: str, *, shard: Optional[int] = None,
                 op: str = "exchange"):
        super().__init__(msg)
        self.shard = shard
        self.op = op


# errors of the call itself, raised at once rather than retried
_CALL_ERRORS = (QuESTError, ValueError, TypeError, AssertionError,
                IndexError, KeyError, NotImplementedError)


def exchange_deadline() -> Optional[float]:
    """The per-dispatch deadline in seconds (None: no deadline)."""
    raw = os.environ.get(_DEADLINE_ENV)
    if not raw:
        return None
    try:
        d = float(raw)
    except ValueError:
        return None
    return d if d > 0 else None


def guarded_dispatch(fn, *args, op: str = "exchange", shards: int = 1,
                     consumes: bool = True, **kwargs):
    """Run one exchange dispatch under the guard: up to
    QT_EXCHANGE_RETRIES attempts (default 3) with exponential backoff
    (QT_RETRY_BASE_SECONDS), each first taking one injected fault from
    EXCHANGE_FAULT_HOOK; a dispatch slower than QT_EXCHANGE_DEADLINE_S
    counts ``exchange_timeouts_total`` (its result is still used).  After
    the budget, ShardLossError with the last error chained
    (quest_tpu/parallel/dist.py guarded_dispatch).

    ``fn`` consumes its first argument, a ShardedAmps it changes shard by
    shard and chunk by chunk in place, unless ``consumes`` is False.  A
    consuming dispatch that fails may have left some shards or chunks
    updated and others not, so it is never run again: its operand is
    marked lost (every later use raises the same ShardLossError) and
    the ShardLossError is raised at once, unless it was an allocator
    failure (``torch.OutOfMemoryError``) that changed no shard: that
    propagates as it is, the register whole, for the memory governor's
    OOM net to retry.  Injected stalls come before the dispatch and are
    retried either way."""
    attempts = max(1, int(os.environ.get(_GUARD_ATTEMPTS_ENV, "3")))
    operand = args[0] if args and isinstance(args[0], ShardedAmps) \
        else None
    base_delay = float(os.environ.get("QT_RETRY_BASE_SECONDS", "0.05"))
    deadline = exchange_deadline()
    last = None
    for k in range(attempts):
        hook = EXCHANGE_FAULT_HOOK[0]
        fault = hook(op) if hook is not None else None
        if fault == "shard_loss":
            _inc("exchange_timeouts_total", 1, op=op)
            topo.notify_mesh_event("shard_loss", op=op, shard=None)
            raise ShardLossError(
                f"injected shard loss during {op} dispatch", op=op)
        if fault == "host_loss":
            _inc("exchange_timeouts_total", 1, op=op)
            topo.notify_mesh_event("host_loss", op=op,
                                   shard=int(shards) - 1)
            raise ShardLossError(
                f"injected host loss during {op} dispatch", op=op,
                shard=int(shards) - 1)
        if fault == "stall":
            _inc("exchange_timeouts_total", 1, op=op)
            last = TimeoutError(f"injected stall during {op} dispatch")
        else:
            mark = state_mark(operand) if operand is not None else None
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except _CALL_ERRORS:
                raise  # a fault of the call, not of the machine
            # a transport failure of any other class: a pure dispatch is
            # retried and the last failure chained to the ShardLossError
            # below; a consuming one cannot be run again on its half
            # updated operand
            # qlint: allow(oom-swallow): an allocator failure that changed nothing is re-raised at once for governor.oom_net, the guard only tells it from a transport failure
            except Exception as e:  # qlint: allow(broad-except): a transport failure of any class is retried or turned into a ShardLossError, and the last one is chained
                if (isinstance(e, torch.OutOfMemoryError)
                        and mark is not None
                        and state_mark(operand) == mark):
                    raise  # nothing changed: the register stays whole
                if consumes:
                    lost = ShardLossError(
                        f"{op} dispatch failed part-way; the register it "
                        f"was changing is lost (error: {e!r})", op=op)
                    topo.notify_mesh_event("shard_loss", op=op, shard=None,
                                           exhausted_attempts=k + 1)
                    if args and isinstance(args[0], ShardedAmps):
                        args[0].mark_lost(lost)
                    raise lost from e
                last = e
            else:
                elapsed = time.perf_counter() - t0
                _telemetry.observe("exchange_latency_seconds", elapsed,
                                   op=op, shards=str(shards))
                if deadline is not None and elapsed > deadline:
                    _inc("exchange_timeouts_total", 1, op=op)
                return out
        if k + 1 < attempts:
            time.sleep(base_delay * (1 << k))
    topo.notify_mesh_event("shard_loss", op=op, shard=None,
                           exhausted_attempts=attempts)
    raise ShardLossError(
        f"{op} dispatch failed after {attempts} attempts "
        f"(last error: {last!r})", op=op) from last


def state_mark(amps: ShardedAmps) -> tuple:
    """The identity and version of each shard tensor of ``amps``: a
    dispatch after which they are all the same changed nothing (an
    in-place write bumps a tensor's version; a rebound shard changes its
    identity)."""
    return tuple((id(t), t._version) for t in amps.shards)


def use_explicit_dist(enabled: bool) -> None:
    """Toggle the explicit exchange routes.  Off, an eager gate on a
    sharded register takes the ``default`` route (gather, the ordinary
    op, split), the port's counterpart of the JAX package's GSPMD
    propagation."""
    _CONFIG["explicit"] = bool(enabled)


def explicit_dist_enabled() -> bool:
    return _CONFIG["explicit"]


def use_lazy_remap(enabled: bool) -> None:
    """Toggle the lazy logical->physical permutation.  Off, every
    relocalization swaps back at once (the reference's per-gate scheme,
    QuEST_cpu_distributed.c:1447-1545)."""
    _CONFIG["lazy_remap"] = bool(enabled)


def lazy_remap_enabled() -> bool:
    return _CONFIG["lazy_remap"]


# ---------------------------------------------------------------------------
# Chunked exchange
# ---------------------------------------------------------------------------

_EXCHANGE_ENV = "QT_EXCHANGE_CHUNKS"

# below this many payload bytes an exchange is monolithic
PIPELINE_MIN_BYTES = 1 << 21
_TARGET_CHUNK_BYTES = 1 << 22
MAX_EXCHANGE_CHUNKS = 8

# the memory governor's chunk escalation for one drain (governor.govern_drain
# rung 1), cleared in the drain's finally (governor.end_drain): published
# through exchange_config_key, so the remaps, their counters and the
# reconciliation's prediction see one chunk policy; QT_EXCHANGE_CHUNKS wins
_GOVERNOR_CHUNKS: list = [None]


def exchange_config_key() -> Optional[str]:
    """The live chunk-policy override, a key component for anything that
    bakes a chunk count in: QT_EXCHANGE_CHUNKS first, then the memory
    governor's escalation of the current drain."""
    v = os.environ.get(_EXCHANGE_ENV)
    if v is not None:
        return v
    g = _GOVERNOR_CHUNKS[0]
    return None if g is None else str(int(g))


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def exchange_chunks(payload_bytes: int, limit: int = 1 << 30,
                    backend: Optional[str] = None) -> int:
    """Chunk count for one exchange of ``payload_bytes`` bytes:
    QT_EXCHANGE_CHUNKS when set (rounded down to a power of two), else
    monolithic on the CPU and below PIPELINE_MIN_BYTES, else chunks of
    about 4 MiB, at most MAX_EXCHANGE_CHUNKS; never above ``limit``.
    ``backend`` is the shards' device type ("cpu" / "cuda"; default: the
    card when there is one)."""
    limit = max(1, _pow2_floor(limit))
    override = exchange_config_key()
    if override is not None:
        try:
            c = max(1, int(override))
        except ValueError:
            from .. import resilience

            resilience.record_degradation(
                "exchange_chunks",
                f"unparseable {_EXCHANGE_ENV}={override!r}; monolithic")
            return 1
        if c != _pow2_floor(c):
            from .. import resilience

            resilience.record_degradation(
                "exchange_chunks",
                f"{_EXCHANGE_ENV}={c} not a power of two; "
                f"using {_pow2_floor(c)}")
        return min(_pow2_floor(c), limit)
    if backend is None:
        backend = _default_backend()
    if backend == "cpu" or payload_bytes < PIPELINE_MIN_BYTES:
        return 1
    c = _pow2_floor(payload_bytes // _TARGET_CHUNK_BYTES)
    return max(1, min(c, MAX_EXCHANGE_CHUNKS, limit))


def amp_axis_size(mesh: Mesh) -> int:
    return int(mesh.axis_size)


def num_shard_bits(mesh: Mesh) -> int:
    return int(math.log2(amp_axis_size(mesh)))


def _hypercube_perm(ndev: int, bit: int):
    """The XOR-partner pairs of mesh bit ``bit`` (chunkId ^ 2^bit,
    QuEST_cpu_distributed.c:313-333)."""
    return [(i, i ^ (1 << bit)) for i in range(ndev)]


def _shard_payload_bytes(amps: ShardedAmps) -> int:
    """Bytes of one shard: the full-shard exchange payload (a bank's
    shard holds every element's slice: B times a register's)."""
    return 2 * (1 << amps.nloc) * amps.itemsize * max(amps.batch_size, 1)


def _backend(amps: ShardedAmps) -> str:
    return amps.device.type


def _chunk(view: torch.Tensor, i: int, chunks: int) -> torch.Tensor:
    """Chunk ``i`` of ``chunks`` of a (c, hi, lo) view (c = 2, or 2B for
    a bank's shard), splitting its flattened (hi, lo) index into equal
    contiguous ranges."""
    hi, lo = int(view.shape[1]), int(view.shape[2])
    if chunks <= hi:
        step = hi // chunks
        return view[:, i * step:(i + 1) * step, :]
    per = chunks // hi
    step = lo // per
    h, j = divmod(i, per)
    return view[:, h:h + 1, j * step:(j + 1) * step]


def settle_traced(mesh: Mesh) -> None:
    """Under a recording ``torch.profiler``, wait until every card of
    ``mesh`` has run all it was given; nothing otherwise.  The
    ``mesh.remap`` and ``mesh.exchange`` spans call it before they open
    and before they close, so that in a trace the device work inside such
    a span on a card's timeline is the span's own: the host otherwise
    runs ahead of the cards, by whole circuits."""
    if not torch.autograd._profiler_enabled():
        return
    for dev in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def exchange_pipelined(mesh: Mesh, sends: Sequence[torch.Tensor], pairs,
                       combine, *, chunks: int) -> None:
    """Chunked exchange over the local shards, in place.

    ``sends[k]`` is a (c, hi, lo) view of local shard ``mesh.local[k]``
    (c = 2, or 2B: a bank's elements move in the same transfer):
    the data it sends along ``pairs`` and the place its result goes.  For
    each chunk i in order, every shard's chunk i is copied into a receive
    buffer on its destination before any shard writes, then
    ``combine(i, k, own_chunk, recv_chunk)`` gives local shard k's new
    chunk i, written back into its view.  The combines are elementwise on
    disjoint chunks, so the result is the same for any chunk count
    (quest_tpu/parallel/dist.py exchange_pipelined).  One ``mesh.exchange``
    span covers it: attrs ``bytes`` (what each shard sends) and
    ``chunks``."""
    m = int(sends[0].shape[1]) * int(sends[0].shape[2])
    if chunks <= 1 or m % chunks or m // chunks == 0:
        chunks = 1
    settle_traced(mesh)
    with _telemetry.span("mesh.exchange", chunks=chunks,
                         bytes=sends[0].numel() * sends[0].element_size()):
        for i in range(chunks):
            own = [_chunk(v, i, chunks) for v in sends]
            recv = mesh.permute(own, pairs)
            for k, v in enumerate(own):
                v.copy_(combine(i, k, v, recv[k]))
        settle_traced(mesh)


def _contiguous(shards: List[torch.Tensor]) -> None:
    """Make every shard of the list contiguous, in the list: the
    exchanges write through views of the shards."""
    for k, t in enumerate(shards):
        if not t.is_contiguous():
            shards[k] = t.contiguous()


def _swap_halves(mesh: Mesh, shards: List[torch.Tensor], lb: int, mb: int,
                 nloc: int, chunks: int = 1) -> None:
    """Half-shard SWAP of local bit ``lb`` and mesh bit ``mb``, in place:
    each shard sends the half whose bit ``lb`` differs from its mesh bit
    to the XOR partner and splices the received half into the same place
    (statevec_swapQubitAmps, QuEST_cpu_distributed.c:1397-1436)."""
    views = []
    _contiguous(shards)
    for k, s in enumerate(mesh.local):
        u = (s >> mb) & 1
        # a bank's (B, 2, 2^nloc) shard: every element's half in one view
        lv = shards[k].view(-1, 1 << (nloc - 1 - lb), 2, 1 << lb)
        views.append(lv[:, :, 1 - u, :])
    exchange_pipelined(mesh, views, _hypercube_perm(mesh.axis_size, mb),
                       lambda i, k, own, rv: rv, chunks=chunks)


def _shard_coeffs(m, mybit: int):
    """(a, b) coefficients of a 1q gate on a sharded target for a shard
    whose target bit is ``mybit``: a = m[b, b], b = m[b, 1 - b]
    (statevec_compactUnitaryDistributed, QuEST_cpu.c:1841-1900)."""
    row = mybit
    return (m[0, row, row], m[1, row, row],
            m[0, row, 1 - row], m[1, row, 1 - row])


def _local_control_mask(nloc: int, lo: int, count: int, controls,
                        device) -> Optional[torch.Tensor]:
    """Boolean mask over local indices [lo, lo + count) where every
    (bit, state) of ``controls`` holds; None when there are none."""
    if not controls:
        return None
    idx = torch.arange(lo, lo + count, device=device)
    ok = torch.ones(count, dtype=torch.bool, device=device)
    for c, s in controls:
        ok &= ((idx >> c) & 1) == s
    return ok


@sharded_contract(collectives={"collective-permute": 1},
                  max_exchange_bytes=1 << 10,
                  max_tier_bytes={"ici": 1 << 10, "dcn": 1 << 10})
def apply_matrix_1q_sharded(amps: ShardedAmps, matrix, *, num_qubits: int,
                            target: int, controls: Tuple[int, ...] = (),
                            control_states: Tuple[int, ...] = (),
                            chunks: Optional[int] = None) -> ShardedAmps:
    """A one-qubit dense gate on a sharded target: one chunked full-shard
    exchange with the XOR partner and the combine a * own + b * recv
    (QuEST_cpu_distributed.c:854-928).  Local controls select the
    combined elements; a shard failing a sharded control keeps its
    amplitudes (the exchange still runs, as in the reference's collective
    form).  The input is consumed."""
    mesh = amps.mesh
    if chunks is None:
        chunks = exchange_chunks(_shard_payload_bytes(amps),
                                 backend=_backend(amps))
    r = num_shard_bits(mesh)
    nloc = num_qubits - r
    record_exchange("matrix_1q", 1, _shard_payload_bytes(amps),
                    chunks=chunks,
                    tier=mesh_topology(mesh).tier_of_bit(target - nloc))
    return guarded_dispatch(
        _apply_matrix_1q_sharded, amps, matrix, op="matrix_1q",
        shards=amp_axis_size(mesh), num_qubits=num_qubits, target=target,
        controls=tuple(controls), control_states=tuple(control_states),
        chunks=int(chunks))


def _apply_matrix_1q_sharded(amps, matrix, *, num_qubits, target, controls,
                             control_states, chunks):
    mesh = amps.mesh
    nloc = num_qubits - num_shard_bits(mesh)
    assert target >= nloc, "local targets take the ordinary kernel"
    bit = target - nloc
    states = control_states or (1,) * len(controls)
    local_controls = tuple((c, s) for c, s in zip(controls, states)
                           if c < nloc)
    shard_controls = tuple((c - nloc, s) for c, s in zip(controls, states)
                           if c >= nloc)
    chunks = min(_pow2_floor(chunks), 1 << nloc)
    m = torch.as_tensor(matrix, dtype=amps.dtype)
    coeffs, live = [], []
    for s in mesh.local:
        coeffs.append([float(x) for x in _shard_coeffs(m, (s >> bit) & 1)])
        live.append(all(((s >> cb) & 1) == cs for cb, cs in shard_controls))
    step = (1 << nloc) // max(chunks, 1)

    def combine(i, k, own, rv):
        if not live[k]:
            return own
        a_re, a_im, b_re, b_im = coeffs[k]
        new = cplx.cmul(own, a_re, a_im) + cplx.cmul(rv, b_re, b_im)
        mask = _local_control_mask(nloc, i * step, own.shape[-1],
                                   local_controls, own.device)
        if mask is not None:
            new = torch.where(mask, new, own)
        return new

    _contiguous(amps.shards)
    views = [s.view(2, 1, -1) for s in amps.shards]
    exchange_pipelined(mesh, views, _hypercube_perm(mesh.axis_size, bit),
                       combine, chunks=chunks)
    return amps


@sharded_contract(collectives={"collective-permute": 1},
                  max_exchange_bytes=1 << 9,
                  max_tier_bytes={"ici": 1 << 9, "dcn": 1 << 9})
def swap_sharded(amps: ShardedAmps, *, num_qubits: int, qb_low: int,
                 qb_high: int, chunks: Optional[int] = None) -> ShardedAmps:
    """SWAP of local qubit ``qb_low`` and sharded qubit ``qb_high``: only
    the mismatched half-shard moves.  The input is consumed."""
    mesh = amps.mesh
    half = _shard_payload_bytes(amps) // 2
    if chunks is None:
        chunks = exchange_chunks(half, backend=_backend(amps))
    r = num_shard_bits(mesh)
    record_exchange("swap", 1, half, chunks=chunks,
                    tier=mesh_topology(mesh).tier_of_bit(
                        qb_high - (num_qubits - r)))
    return guarded_dispatch(
        _swap_sharded, amps, op="swap", shards=amp_axis_size(mesh),
        num_qubits=num_qubits, qb_low=qb_low, qb_high=qb_high,
        chunks=int(chunks))


def _swap_sharded(amps, *, num_qubits, qb_low, qb_high, chunks):
    nloc = num_qubits - num_shard_bits(amps.mesh)
    assert qb_high >= nloc and qb_low < nloc
    chunks = min(_pow2_floor(chunks), 1 << (nloc - 1))
    _swap_halves(amps.mesh, amps.shards, qb_low, qb_high - nloc, nloc,
                 chunks)
    return amps


def total_prob_sharded(amps: ShardedAmps) -> torch.Tensor:
    """Sum of |amp|^2: a per-shard partial and one sum over the mesh
    (QuEST_cpu_distributed.c:1308-1322)."""
    return amps.mesh.sum([cplx.abs2(s).sum() for s in amps.shards])


@sharded_contract(collectives={"all-gather": 1},
                  max_exchange_bytes=1 << 13)
def gather_replicated(amps: ShardedAmps) -> torch.Tensor:
    """The whole state on the first local shard's device (the reference's
    copyVecIntoMatrixPairState, QuEST_cpu_distributed.c:379-423), counted
    as the JAX package counts its all-gather."""
    mesh = amps.mesh
    ndev = amp_axis_size(mesh)
    t = mesh_topology(mesh)
    payload = _shard_payload_bytes(amps)
    dcn_b = payload * (ndev - t.chips)
    _record_exchange_tiers(
        "gather",
        {"ici": (0 if dcn_b else 1, payload * (t.chips - 1)),
         "dcn": (1 if dcn_b else 0, dcn_b)}, 1)
    return guarded_dispatch(lambda a: a.mesh.gather(a.shards), amps,
                            op="gather", shards=ndev, consumes=False)


# ---------------------------------------------------------------------------
# The remap layer: batched physical bit permutations
# ---------------------------------------------------------------------------


def decompose_sigma(sigma: Tuple[int, ...], nloc: int, r: int):
    """Split a physical bit permutation (``sigma[p]`` = destination of the
    bit at physical position p) into (mixed, local_perm, mesh_tau): one
    (local_bit, mesh_bit) half-shard swap per boundary crossing, one
    per-shard axis permutation (out bit q <- in bit local_perm[q]) and
    one composed shard-index permute (``mesh_tau[b]`` = destination mesh
    bit of coordinate bit b), applied in that order."""
    n = nloc + r
    cur = list(sigma)
    assert sorted(cur) == list(range(n)), sigma
    mixed = []
    from_local = [p for p in range(nloc) if cur[p] >= nloc]
    from_mesh = {p for p in range(nloc, n) if cur[p] < nloc}
    assert len(from_local) == len(from_mesh)
    for l in from_local:
        # pair each crossing local bit with its destination mesh slot when
        # that slot crosses down: a transposition sigma decomposes into
        # mixed swaps alone
        m = cur[l] if cur[l] in from_mesh else min(from_mesh)
        from_mesh.discard(m)
        mixed.append((l, m - nloc))
        cur[l], cur[m] = cur[m], cur[l]
    local_perm = None
    if cur[:nloc] != list(range(nloc)):
        inv = [0] * nloc
        for p in range(nloc):
            inv[cur[p]] = p
        local_perm = tuple(inv)
    mesh_tau = None
    tau = [cur[nloc + b] - nloc for b in range(r)]
    if tau != list(range(r)):
        mesh_tau = tuple(tau)
    return tuple(mixed), local_perm, mesh_tau


def remap_exchange_count(sigma: Tuple[int, ...], nloc: int, r: int) -> int:
    """Exchanges one remap of ``sigma`` dispatches: one per mixed swap,
    plus one when a composed mesh permute remains."""
    mixed, _local_perm, mesh_tau = decompose_sigma(tuple(sigma), nloc, r)
    return len(mixed) + (1 if mesh_tau is not None else 0)


def remap_exchange_tiers(sigma: Tuple[int, ...], nloc: int, r: int,
                         itemsize: int = 8,
                         topology: Optional[topo.Topology] = None):
    """Per-tier (count, per-shard bytes) of one remap: a mixed swap moves
    half a shard over its mesh bit's tier; the composed permute moves a
    whole shard, cross-host iff it moves any host bit."""
    t = topology if topology is not None else topo.resolve(1 << r)
    mixed, _local_perm, mesh_tau = decompose_sigma(tuple(sigma), nloc, r)
    shard = 2 * (1 << nloc) * itemsize
    parts = {"ici": [0, 0], "dcn": [0, 0]}
    for _lb, mb in mixed:
        acc = parts[t.tier_of_bit(mb)]
        acc[0] += 1
        acc[1] += shard // 2
    if mesh_tau is not None:
        moved = 0
        for b, dst in enumerate(mesh_tau):
            if b != dst:
                moved |= (1 << b) | (1 << dst)
        acc = parts[t.tier_of_mask(moved)]
        acc[0] += 1
        acc[1] += shard
    return {k: (v[0], v[1]) for k, v in parts.items()}


def remap_chunk_plan(nloc: int, itemsize: int = 8,
                     backend: Optional[str] = None,
                     batch: int = 0) -> Tuple[int, int]:
    """(half-shard chunks, full-shard chunks) for one shard of
    ``2 * 2^nloc * itemsize`` bytes, or of a bank of ``batch`` elements
    (B times the bytes: the bank's elements move in one transfer)."""
    nbytes = 2 * (1 << nloc) * itemsize * max(int(batch), 1)
    return (exchange_chunks(nbytes // 2, backend=backend),
            exchange_chunks(nbytes, backend=backend))


def _permute_local(shard: torch.Tensor, nloc: int, perm) -> torch.Tensor:
    """kernels.permute_qubits on one shard; a bank's (B, 2, 2^nloc) shard
    with the batch axis kept in front (each element the same relabel,
    exact)."""
    if shard.dim() == 3:
        return torch.vmap(lambda a: kernels.permute_qubits(
            a, num_qubits=nloc, perm=perm))(shard)
    return kernels.permute_qubits(shard, num_qubits=nloc, perm=perm)


def _remap_shards(amps: ShardedAmps, sigma: Tuple[int, ...],
                  chunks: Optional[Tuple[int, int]] = None) -> ShardedAmps:
    """Apply ``sigma`` to every shard: the mixed half-shard swaps, the
    per-shard axis permutation, then the composed shard-index permute
    (decompose_sigma).  Shared by remap_sharded and the drain's
    ("remap", sigma) parts.  A bank's shards remap every element with the
    same sigma, each exchange moving all B slices at once (the JAX
    package's vmap inside one shard_map, quest_tpu/parallel/dist.py
    _remap_sharded), chunked over the bank's bytes."""
    mesh = amps.mesh
    ndev = mesh.axis_size
    r = num_shard_bits(mesh)
    nloc = amps.nloc
    mixed, local_perm, mesh_tau = decompose_sigma(tuple(sigma), nloc, r)
    t = topo.resolve(ndev)
    if t.dcn_bits and len(mixed) > 1:
        # the cross-host swaps first, as the JAX package orders them; the
        # transpositions touch disjoint bit pairs, so the state is the same
        mixed = tuple(sorted(mixed, key=lambda lm: lm[1] < t.ici_bits))
    if chunks is None:
        chunks = remap_chunk_plan(nloc, amps.itemsize, _backend(amps),
                                  amps.batch_size)
    ch_half = min(_pow2_floor(chunks[0]), 1 << max(nloc - 1, 0))
    ch_full = min(_pow2_floor(chunks[1]), 1 << nloc)
    for lb, mb in mixed:
        _swap_halves(mesh, amps.shards, lb, mb, nloc, ch_half)
    if local_perm is not None:
        # one shard at a time: a shard's old tensor is freed before the
        # next shard's transpose allocates
        for k in range(len(amps.shards)):
            amps.shards[k] = _permute_local(amps.shards[k], nloc,
                                            local_perm)
    if mesh_tau is not None:
        def dest(i):
            j = 0
            for b, tb in enumerate(mesh_tau):
                j |= ((i >> b) & 1) << tb
            return j

        _contiguous(amps.shards)
        exchange_pipelined(
            mesh, [s.view(-1, 1, 1 << nloc) for s in amps.shards],
            [(i, dest(i)) for i in range(ndev)],
            lambda i, k, own, rv: rv, chunks=ch_full)
    return amps


@sharded_contract(collectives={"collective-permute": 1},
                  max_exchange_bytes=1 << 9,
                  max_tier_bytes={"ici": 1 << 9, "dcn": 1 << 9})
def remap_sharded(amps: ShardedAmps, *, num_qubits: int,
                  sigma: Tuple[int, ...],
                  chunks: Optional[Tuple[int, int]] = None) -> ShardedAmps:
    """One batched physical bit permutation of a sharded register, counted
    per tier under op "remap" (a bank's counts and bytes B times a
    register's, as the JAX package counts them, though its elements move
    in one transfer).  The input is consumed."""
    mesh = amps.mesh
    nloc = amps.nloc
    if chunks is None:
        nbytes = _shard_payload_bytes(amps)
        chunks = (exchange_chunks(nbytes // 2, backend=_backend(amps)),
                  exchange_chunks(nbytes, backend=_backend(amps)))
    assert num_qubits == nloc + num_shard_bits(mesh)
    bw = max(amps.batch_size, 1)
    tiers = remap_exchange_tiers(tuple(sigma), nloc, num_shard_bits(mesh),
                                 amps.itemsize, mesh_topology(mesh))
    _record_exchange_tiers("remap", {k: (c * bw, b * bw)
                                     for k, (c, b) in tiers.items()},
                           str(tuple(chunks)))
    return guarded_dispatch(
        _remap_shards, amps, tuple(sigma),
        (int(chunks[0]), int(chunks[1])), op="remap",
        shards=amp_axis_size(mesh))


def canonical_sigma(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    """The physical permutation that restores canonical order from a live
    logical->physical ``perm`` (sigma = perm^-1)."""
    sigma = [0] * len(perm)
    for q, p in enumerate(perm):
        sigma[p] = q
    return tuple(sigma)


def plan_window_remap(num_qubits: int, nloc: int, perm: Tuple[int, ...],
                      want_local, next_use=None, topology=None):
    """The least-movement permutation making every logical qubit of
    ``want_local`` shard-local: local ones stay; each sharded one swaps
    with the local slot whose resident is needed furthest ahead
    (``next_use``: logical qubit -> distance; absent = never, evicted
    first).  On a multi-host topology, wanted qubits on cross-host bits
    are served first, so the coldest evictees land there.  Returns
    (sigma | None, new_perm); (None, None) when ``want_local`` exceeds
    the local capacity."""
    n = num_qubits
    perm = list(perm)
    want_local = sorted(set(want_local))
    if len(want_local) > nloc:
        return None, None
    inv = [0] * n
    for q, p in enumerate(perm):
        inv[p] = q
    need = [q for q in want_local if perm[q] >= nloc]
    if not need:
        return None, tuple(perm)
    if topology is None:
        topology = topo.resolve(1 << max(num_qubits - nloc, 0))
    if topo.hierarchical_enabled(topology):
        need.sort(key=lambda q: (perm[q] - nloc < topology.ici_bits,
                                 -(perm[q] - nloc)))
    wanted = set(want_local)
    pool = [p for p in range(nloc) if inv[p] not in wanted]
    assert len(pool) >= len(need)
    if next_use is None:
        next_use = {}
    pool.sort(key=lambda p: next_use.get(inv[p], 1 << 60), reverse=True)
    sigma = list(range(n))
    for q in need:
        p_high = perm[q]
        p_slot = pool.pop(0)
        q_evicted = inv[p_slot]
        sigma[p_slot], sigma[p_high] = p_high, p_slot
        perm[q], perm[q_evicted] = p_slot, p_high
        inv[p_slot], inv[p_high] = q, q_evicted
    return tuple(sigma), tuple(perm)


def plan_relocalization(num_qubits: int, nloc: int,
                        targets: Tuple[int, ...],
                        controls: Tuple[int, ...] = (), free_order=None):
    """Swap pairs pulling every sharded target down to a free local qubit
    (controls are kept out of the free pool; ``free_order`` is the
    eviction preference, coldest first, default lowest first).  Returns
    (swaps, new_targets), or (None, None) when too few local qubits are
    free (QuEST_cpu_distributed.c:1508-1531)."""
    targets = list(targets)
    blocked = set(targets) | set(controls)
    order = free_order if free_order is not None else range(nloc)
    free_local = [q for q in order if q not in blocked]
    swaps = []
    for i, t in enumerate(targets):
        if t >= nloc:
            if not free_local:
                return None, None
            fq = free_local.pop(0)
            swaps.append((fq, t))
            targets[i] = fq
    return tuple(swaps), tuple(targets)
