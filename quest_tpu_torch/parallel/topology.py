"""Hierarchical hosts x devices topology of the amplitude mesh.

A copy of the JAX package's model (quest_tpu/parallel/topology.py), which
imports no framework: with ``2^r`` shards arranged as ``hosts x chips``
(both powers of two), shard ``i`` is device ``i % chips`` of host
``i // chips``.  Mesh-coordinate bit ``b`` (state-vector qubit
``nloc + b``) is an intra-host bit, tier ``"ici"``, when
``b < log2(chips)``, and a cross-host bit, tier ``"dcn"``, otherwise (the
tier names are the JAX package's, so the two packages' exchange
accounting compares key for key; on NVIDIA cards "ici" is the peer link
within a host and "dcn" the network between hosts).  An exchange's tier:

* XOR-partner hop on mesh bit ``b``  -> ``tier_of_bit(b)``;
* composed shard-index permutation   -> "dcn" iff any moved pair crosses
  a host boundary (``tier_of_pair``).

``QT_TOPOLOGY=HxC`` forces an H-host x C-device arrangement; a spec that
does not factor the live shard count is ignored (one host: every bit
intra-host).  ``QT_TIER_WEIGHT_ICI`` / ``QT_TIER_WEIGHT_DCN`` (defaults
1 / 8) weigh the tiers' bytes in the remap planner's eviction choice and
the optimizer's stream cost; ``QT_TOPOLOGY_PLANNER=flat`` turns the
tier-aware planning off.  Topology changes where bytes move, never what
is computed.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

TOPOLOGY_ENV = "QT_TOPOLOGY"
PLANNER_ENV = "QT_TOPOLOGY_PLANNER"          # "hier" (default) | "flat"
WEIGHT_ICI_ENV = "QT_TIER_WEIGHT_ICI"
WEIGHT_DCN_ENV = "QT_TIER_WEIGHT_DCN"

TIERS = ("ici", "dcn")

# default ICI:DCN per-byte cost ratio, the JAX package's default (one
# cross-host byte costs 8 intra-host bytes); QT_TIER_WEIGHT_* override it
DEFAULT_TIER_WEIGHTS = {"ici": 1.0, "dcn": 8.0}


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


@dataclass(frozen=True)
class Topology:
    """An ``hosts x chips`` arrangement of the amplitude mesh.

    ``hosts == 1`` is the flat (single-host) model every pre-topology
    code path assumed: all mesh bits ICI, all classification trivially
    "ici" — so the default topology changes nothing."""

    hosts: int
    chips: int

    def __post_init__(self):
        if not _is_pow2(self.hosts) or not _is_pow2(self.chips):
            raise ValueError(
                f"Topology: hosts={self.hosts} chips={self.chips} must "
                f"both be powers of two")

    @property
    def num_devices(self) -> int:
        return self.hosts * self.chips

    @property
    def ici_bits(self) -> int:
        """Mesh-coordinate bits addressing the chip within a host."""
        return int(math.log2(self.chips))

    @property
    def dcn_bits(self) -> int:
        """Mesh-coordinate bits addressing the host."""
        return int(math.log2(self.hosts))

    def tier_of_bit(self, mesh_bit: int) -> str:
        """Tier of an XOR-partner exchange on mesh-coordinate bit
        ``mesh_bit`` (state-vector qubit ``nloc + mesh_bit``)."""
        return "ici" if mesh_bit < self.ici_bits else "dcn"

    def tier_of_mask(self, xor_mask: int) -> str:
        """Tier of a composed XOR hop (e.g. the double-flip pair-channel
        partner): DCN iff any flipped bit addresses the host."""
        return "dcn" if (xor_mask >> self.ici_bits) else "ici"

    def tier_of_pair(self, src: int, dst: int) -> str:
        """Tier of one ``collective-permute`` source-target pair — the
        classification the JAX package applies to its compiled programs."""
        return self.tier_of_mask(src ^ dst)

    def host_of(self, shard: int) -> int:
        return shard // self.chips

    def host_range(self, host: int) -> range:
        """Device indices belonging to ``host``."""
        return range(host * self.chips, (host + 1) * self.chips)

    def describe(self) -> str:
        """``HxC (ici=a, dcn=b)`` — the getEnvironmentString line body."""
        return (f"{self.hosts}x{self.chips} "
                f"(ici={self.ici_bits}, dcn={self.dcn_bits})")

    def signature(self) -> Tuple:
        """Hashable planning-relevant identity — a cache-key component
        for plans/predictions that depend on the topology (fusion's plan
        cache, introspect's prediction cache)."""
        w = tier_weights()
        return (self.hosts, self.chips, planner_mode(), w["ici"], w["dcn"])


def parse_spec(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"HxC"`` (also ``H×C``) -> (hosts, chips); None / unparseable ->
    None.  Validation against the live device count happens in
    :func:`resolve` — a non-factoring spec falls back to single-host."""
    if not spec:
        return None
    raw = str(spec).strip().lower().replace("×", "x")
    if raw.count("x") != 1:
        return None
    h, _, c = raw.partition("x")
    try:
        hosts, chips = int(h), int(c)
    except ValueError:
        return None
    if hosts < 1 or chips < 1:
        return None
    return hosts, chips


def planner_mode() -> str:
    """``"hier"`` (tier-aware remap planning, the default) or ``"flat"``
    (classification + accounting only — the A/B baseline)."""
    raw = os.environ.get(PLANNER_ENV, "hier").strip().lower()
    return "flat" if raw == "flat" else "hier"


def tier_weights() -> Dict[str, float]:
    """Relative per-byte cost of each tier (higher = slower link)."""
    out = dict(DEFAULT_TIER_WEIGHTS)
    for tier, env in (("ici", WEIGHT_ICI_ENV), ("dcn", WEIGHT_DCN_ENV)):
        raw = os.environ.get(env)
        if raw:
            try:
                v = float(raw)
            except ValueError:
                continue
            if v > 0:
                out[tier] = v
    return out


def resolve(num_devices: int, spec: Optional[str] = None) -> Topology:
    """The live topology for a ``num_devices``-shard amplitude mesh:
    ``spec`` (default ``$QT_TOPOLOGY``) when it exactly factors the
    device count into power-of-two hosts x chips, else the flat
    single-host arrangement.  The silent fallback is load-bearing for
    elastic failover: after a host loss the mesh is smaller than the
    spec describes, and the survivors must keep classifying consistently
    (the JAX package's env.shrink_env / resilience._failover)."""
    ndev = max(1, int(num_devices))
    if spec is None:
        spec = os.environ.get(TOPOLOGY_ENV)
    parsed = parse_spec(spec)
    if parsed is not None:
        hosts, chips = parsed
        if _is_pow2(hosts) and _is_pow2(chips) and hosts * chips == ndev:
            return Topology(hosts, chips)
    return Topology(1, ndev)


def shrink(topo: Optional[Topology], num_devices: int) -> Topology:
    """Topology of a degraded mesh: keep the chips-per-host arrangement
    when the survivor count is a whole number of hosts (a host loss:
    ``2x4 -> 1x4``), else collapse to single-host (a sub-host shrink has
    no cross-host axis left worth modeling)."""
    ndev = max(1, int(num_devices))
    if topo is not None and topo.chips <= ndev and ndev % topo.chips == 0:
        hosts = ndev // topo.chips
        if _is_pow2(hosts):
            return Topology(hosts, topo.chips)
    return Topology(1, ndev)


def grow(topo: Optional[Topology], num_devices: int) -> Topology:
    """Topology of a HEALED mesh — the inverse of :func:`shrink` for the
    serving layer's mesh-heal path (the JAX package's serve.SimServer.heal).  The spec
    (``QT_TOPOLOGY``) wins when it factors the recovered device count —
    healing restores the arrangement the operator declared (``1x4`` back
    to ``2x4``); otherwise re-host the surviving chips-per-host shape."""
    ndev = max(1, int(num_devices))
    spec_topo = resolve(ndev)
    if spec_topo.hosts > 1 or topo is None:
        return spec_topo
    if topo.chips <= ndev and ndev % topo.chips == 0 \
            and _is_pow2(ndev // topo.chips):
        return Topology(ndev // topo.chips, topo.chips)
    return spec_topo


# ---------------------------------------------------------------------------
# Mesh loss/heal notification hooks
# ---------------------------------------------------------------------------

# Subsystems whose cached state depends on the live mesh shape register a
# callback here: the serving layer hooks the memory governor's budget
# re-derivation, dist.guarded_dispatch announces a declared shard/host
# loss the instant it raises ShardLossError, and serve.SimServer
# announces failover/heal after swapping its environment.  Callbacks take
# ``(event: str, info: dict)``; an exception inside one is swallowed with
# a warning — a notification fan-out that can fail would turn an
# already-degraded moment into a crash.
MESH_EVENT_LISTENERS: list = []


def add_mesh_listener(cb) -> None:
    if cb not in MESH_EVENT_LISTENERS:
        MESH_EVENT_LISTENERS.append(cb)


def remove_mesh_listener(cb) -> None:
    try:
        MESH_EVENT_LISTENERS.remove(cb)
    except ValueError:
        pass


def notify_mesh_event(event: str, **info) -> None:
    """Fan ``event`` ("shard_loss" / "host_loss" / "serve_failover" /
    "serve_heal") out to every registered listener."""
    import warnings

    for cb in list(MESH_EVENT_LISTENERS):
        try:
            cb(event, dict(info))
        except Exception as e:  # qlint: allow(broad-except): notification fan-out must never crash an already-degraded run
            warnings.warn(f"mesh-event listener failed on {event!r}: {e!r}",
                          RuntimeWarning, stacklevel=2)


def hierarchical_enabled(topo: Optional[Topology]) -> bool:
    """Whether tier-aware remap planning is active: a multi-host
    topology AND the planner not forced flat.  Single-host meshes always
    plan flat — bit-for-bit the pre-topology behaviour."""
    return (topo is not None and topo.dcn_bits > 0
            and planner_mode() == "hier")


def signature(num_devices: int) -> Tuple:
    """resolve(num_devices).signature() — the one call plan caches key
    on (fusion._plan_key, introspect._predict_cached)."""
    return resolve(num_devices).signature()


def split_pair_list(pairs, chips: int) -> Dict[str, int]:
    """Histogram of ``(src, dst)`` collective pairs by tier — the HLO
    ``source_target_pairs`` classifier (introspect.AuditReport
    .tier_counts in the JAX package).  Self-pairs
    (src == dst) move nothing and are not counted."""
    chips = max(1, int(chips))
    out = {"ici": 0, "dcn": 0}
    for src, dst in pairs:
        if src == dst:
            continue
        out["dcn" if (src ^ dst) >= chips else "ici"] += 1
    return out
