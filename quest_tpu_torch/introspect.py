"""Execution introspection: plan explainer, exchange audit, reconciliation.

The JAX package's ``introspect.py`` for the port:

* **Plan explainer** -- :func:`explain_circuit` dry-runs the drain's
  planning (the optimizer rewrite, ``circuit.plan_remap_windows`` and
  the split into parts) with no execution and no telemetry, and returns
  a per-window report: gates fused, remap sigma, the exchanges and bytes
  per shard of the cost model, the chunk split, the plan-cache status,
  the bank's occupancy and the memory governor's prediction.  The report
  is a JSON-serialisable dict with a ``.table()`` rendering;
  :func:`report_circuit_plan` prints it.  Its ``compile`` section reads
  the reference's answer with its AOT cache off (no AOT tier in the
  port yet).

* **Exchange audit** -- :func:`audit` runs a function once, on clones of
  its tensor arguments, and histograms the exchange calls it makes on
  the mesh under the JAX package's HLO opcode families: ``Mesh.permute``
  (and so ``Mesh.exchange``) is ``collective-permute``, ``gather`` and
  ``all_gather`` are ``all-gather``, ``all_to_all`` is ``all-to-all`` and
  ``sum`` is ``all-reduce``.  The reference compiles without running and
  reads the optimized HLO; the port has no compile-only step, so it
  executes, and reports no cost analysis (``flops`` / ``bytes_accessed``
  None, ``cost`` empty: the reference's answer where its backend has no
  cost analysis).  A chunked exchange makes one call per chunk where
  XLA's HLO may hold one collective.  :class:`CollectiveBudget` asserts
  budgets on the histogram, ambient as a context manager.

* **Reconciliation** -- after each sharded drain, ``fusion`` calls
  :func:`reconcile_drain`: the measured ``exchanges_total`` /
  ``exchange_bytes_total{op=window_remap}`` deltas against an independent
  re-plan through the cost model.  Agreement is the contract
  (``model_drift_total == 0``); a deviation counts
  ``model_drift_total{kind}`` and logs one JSON line on the
  ``quest_tpu_torch.introspect`` logger.  :func:`perturb_prediction` (or
  ``QT_INTROSPECT_PERTURB``) perturbs the prediction to prove the loop
  detects drift.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import re
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from . import circuit as C
from . import telemetry as _telemetry

_LOG = logging.getLogger("quest_tpu_torch.introspect")

_PERTURB_ENV = "QT_INTROSPECT_PERTURB"

# ---------------------------------------------------------------------------
# Plan explainer
# ---------------------------------------------------------------------------


class ExplainReport(dict):
    """The explain_circuit result: a plain JSON-serialisable dict plus a
    ``table()`` text rendering."""

    def table(self) -> str:
        return format_explain(self)


def _as_items(gates) -> list:
    """A user gate sequence as drain items: circuit.Gate and
    fusion.ChannelItem as they are; ``(targets, mat)`` pairs as Gates
    (mat in the stacked (2, s, s) form)."""
    from . import fusion as F

    items = []
    for g in gates:
        if isinstance(g, (C.Gate, F.ChannelItem)):
            items.append(g)
        else:
            targets, mat = g
            items.append(C.Gate(tuple(int(t) for t in targets),
                                np.asarray(mat)))
    return items


def _segment_stats(items, nloc=None, perm=None, device=None) -> tuple:
    """(plan_windows, gates, channels, perm_windows, mega_windows,
    mega_ops) of one item run as the drain splits it: each run of gates
    into permutation runs and dense runs (one ("plan", ...) part each),
    channels apart.  With ``nloc`` and megawin grouping on for
    ``device``, each dense run is planned to count its megawin groups;
    ``perm`` first rewrites logical targets to their physical bits."""
    from . import fusion as F
    from .ops import fused as _fused

    count_mega = (nloc is not None and nloc >= C.WINDOW
                  and _fused.megakernel_planning(device))
    plan_parts = perm_parts = gates = chans = mega_groups = mega_ops = 0
    seg: list = []

    def flush():
        nonlocal plan_parts, perm_parts, mega_groups, mega_ops
        if not seg:
            return
        for kind, sub in F._perm_runs(seg):
            if kind == "perm":
                perm_parts += 1
            else:
                plan_parts += 1
                if count_mega:
                    for op in C.plan_circuit(list(sub), nloc,
                                             device=device):
                        if op[0] == "megawin":
                            mega_groups += 1
                            mega_ops += len(op[1])
        seg.clear()

    for it in items:
        if isinstance(it, F.ChannelItem):
            chans += 1
            flush()
        else:
            gates += 1
            if perm is not None:
                it = C.Gate(tuple(perm[t] for t in it.targets), it.mat)
            seg.append(it)
    flush()
    return plan_parts, gates, chans, perm_parts, mega_groups, mega_ops


def _sigma_cost(sigma, n: int, nloc: int, nsh: int, itemsize: int,
                backend: Optional[str] = None) -> dict:
    """Exchange classes, bytes per shard and the chunk split of one
    batched remap, from the exchange layer's own cost model."""
    from .parallel import dist as PAR

    mixed, _lp, mesh_tau = PAR.decompose_sigma(tuple(sigma), nloc, nsh)
    ch_half, ch_full = PAR.remap_chunk_plan(nloc, itemsize, backend)
    tiers = PAR.remap_exchange_tiers(tuple(sigma), nloc, nsh, itemsize)
    return {
        "sigma": [int(p) for p in sigma],
        "mixed_swaps": len(mixed),
        "mesh_permute": mesh_tau is not None,
        "exchanges": PAR.remap_exchange_count(tuple(sigma), nloc, nsh),
        "exchange_bytes": int(C.remap_exchange_bytes(
            tuple(sigma), n, nloc, itemsize)),
        "tier_bytes": {t: int(b) for t, (_c, b) in tiers.items()},
        "tier_exchanges": {t: int(c) for t, (c, _b) in tiers.items()},
        "chunks": {"half_shard": int(ch_half), "full_shard": int(ch_full)},
    }


def _optimizer_section(orig_items, opt_items, ostats, *, n, nloc, nsh,
                       perm0, itemsize, bw, device) -> dict:
    """The report's ``optimizer`` entry: the rewrite's stats and the
    exchanges it saves on a sharded register (the local planner's pass
    count on one register)."""
    from . import fusion as F
    from .parallel import dist as PAR

    section = {
        "mode": ostats["mode"],
        "gates_in": int(ostats["gates_in"]),
        "gates_out": int(ostats["gates_out"]),
        "removed": {k: int(v) for k, v in ostats["removed"].items()},
        "reordered": bool(ostats["reordered"]),
        "windows_before": ostats["windows_before"],
        "windows_after": ostats["windows_after"],
        "tier_savings_bytes": None,
        "exchange_savings": None,
    }
    changed = (ostats["reordered"] or any(ostats["removed"].values())
               or len(opt_items) != len(orig_items))
    if nsh and orig_items:

        def _cost(seq):
            tiers = {"ici": 0, "dcn": 0}
            count = 0
            if not seq:
                return tiers, count
            segments, fperm = C.plan_remap_windows(
                [F._item_entry(it) for it in seq], n, nloc, perm0)
            sigmas = [s for _ij, s, _p in segments if s is not None]
            if fperm is not None and list(fperm) != list(range(n)):
                sigmas.append(PAR.canonical_sigma(tuple(fperm)))
            for sigma in sigmas:
                count += PAR.remap_exchange_count(tuple(sigma), nloc, nsh)
                for t, b in C.remap_exchange_bytes_tiers(
                        tuple(sigma), n, nloc, itemsize).items():
                    tiers[t] = tiers.get(t, 0) + b
            return tiers, count

        t0, c0 = _cost(orig_items)
        t1, c1 = (t0, c0) if not changed else _cost(opt_items)
        section["tier_savings_bytes"] = {
            t: int((t0.get(t, 0) - t1.get(t, 0)) * bw) for t in t0}
        section["exchange_savings"] = int((c0 - c1) * bw)
    elif not nsh:
        # one register: the local planner's pass count, for bounded streams
        gates0 = [it for it in orig_items if isinstance(it, C.Gate)]
        if 0 < len(gates0) <= 512 and all(
                isinstance(g.mat, np.ndarray) and g.mat.ndim == 3
                for g in gates0):
            gates1 = [it for it in opt_items if isinstance(it, C.Gate)]
            wb = C.stats(C.plan_circuit(gates0, nloc, device=device))[
                "total_passes"]
            wa = (C.stats(C.plan_circuit(gates1, nloc, device=device))[
                "total_passes"] if gates1 else 0)
            if not changed:
                wa = wb
            section["windows_before"] = int(wb)
            section["windows_after"] = int(wa)
    return section


def _window_entry(k, i, j, stats) -> dict:
    parts, ngates, nchans, pparts, mparts, mops = stats
    return {"window": k, "start": int(i), "end": int(j),
            "gates": ngates, "channels": nchans,
            "plan_windows": parts, "perm_windows": pparts,
            "mega_windows": mparts, "mega_ops": mops,
            "kind": ("mega" if mparts
                     else "perm" if parts == 0 and pparts else "dense"),
            "sigma": None, "exchanges": 0, "exchange_bytes": 0,
            "chunks": None}


def _scaled(cost: dict, bw: int) -> dict:
    """A remap's cost for a bank of ``bw`` elements (each moves its own
    amplitudes)."""
    cost["exchanges"] *= bw
    cost["exchange_bytes"] *= bw
    for t in cost["tier_bytes"]:
        cost["tier_bytes"][t] *= bw
        cost["tier_exchanges"][t] *= bw
    return cost


def explain_circuit(qureg, gates=None) -> ExplainReport:
    """Dry-run the drain's planning over ``gates`` (or the register's
    pending fusion buffer when None): no execution, no drain, no
    telemetry, no plan-cache insertion.  Returns the per-window plan
    report of the optimized stream the drain would run.

    The predicted window-remap exchanges and bytes per shard are the
    quantities the drain counts (``exchanges_total`` /
    ``exchange_bytes_total{op=window_remap}``); ``final_remap`` is the
    canonical-order remap the next ``Qureg.amps`` read pays (``op=remap``)
    when the plan leaves a live permutation."""
    from . import fusion as F
    from . import governor as _gov
    from . import optimizer as _optimizer
    from .parallel import dist as PAR
    from .parallel import topology as _topology

    if gates is None:
        buf = qureg._fusion
        items = list(buf.gates) if buf is not None else []
    else:
        items = _as_items(gates)
    n = qureg.num_qubits_in_state_vec
    nsh = qureg.shard_bits
    nloc = n - nsh
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    bw = max(bsz, 1)
    itemsize = torch.empty((), dtype=qureg.dtype).element_size()
    sweep_ok = F._sweep_ok(qureg)
    perm0 = qureg._perm if nsh else None
    device = qureg.device
    backend = device.type

    orig_items = items
    if nsh:
        items, ostats = _optimizer.optimize_items(
            items, nloc=nloc, n=n, nsh=nsh, perm0=perm0, quiet=True)
    else:
        items, ostats = _optimizer.optimize_items(items, nloc=n, quiet=True)
    optimizer_section = _optimizer_section(
        orig_items, items, ostats, n=n, nloc=nloc, nsh=nsh, perm0=perm0,
        itemsize=itemsize, bw=bw, device=device)

    register = {
        "qubits": int(qureg.num_qubits_represented),
        "density": bool(qureg.is_density_matrix),
        "state_bits": int(n),
        "shards": int(1 << nsh),
        "shard_bits": int(nsh),
        "nloc": int(nloc),
        "perm0": None if perm0 is None else [int(p) for p in perm0],
        "itemsize": int(itemsize),
    }
    if bsz:
        from . import batch as _batch

        register["batch"] = _batch.bank_occupancy(qureg)

    windows: list = []
    final_remap = None
    tot_exch = tot_bytes = 0
    tot_tier = {"ici": 0, "dcn": 0}
    plan_windows = perm_windows = mega_windows = 0
    if nsh and items:
        entries = [F._item_entry(it) for it in items]
        segments, final_perm = C.plan_remap_windows(entries, n, nloc, perm0)
        for k, ((i, j), sigma, _perm) in enumerate(segments):
            if C._is_relabel_entry(entries[i]):
                # a relabel run folds into the live permutation: nothing
                # dispatches; a cross-shard part surfaces in final_remap
                entry = _window_entry(k, i, j, (0, j - i, 0, 0, 0, 0))
                entry["kind"] = "relabel"
                windows.append(entry)
                continue
            stats = _segment_stats(items[i:j], nloc=nloc, perm=_perm,
                                   device=device)
            plan_windows += stats[0]
            perm_windows += stats[3]
            mega_windows += stats[4]
            entry = _window_entry(k, i, j, stats)
            if sigma is not None:
                entry.update(_scaled(_sigma_cost(sigma, n, nloc, nsh,
                                                 itemsize, backend), bw))
                for t in entry["tier_bytes"]:
                    tot_tier[t] += entry["tier_bytes"][t]
                tot_exch += entry["exchanges"]
                tot_bytes += entry["exchange_bytes"]
            windows.append(entry)
        if final_perm is not None and list(final_perm) != list(range(n)):
            final_remap = _scaled(_sigma_cost(
                PAR.canonical_sigma(tuple(final_perm)), n, nloc, nsh,
                itemsize, backend), bw)
            final_remap["final_perm"] = [int(p) for p in final_perm]
    else:
        stats = _segment_stats(items, nloc=nloc, device=device)
        plan_windows, perm_windows, mega_windows = (stats[0], stats[3],
                                                    stats[4])
        if items:
            windows.append(_window_entry(0, 0, len(items), stats))

    key = None
    if items:
        flag = F.batch_flag(items, bsz)
        key = F._plan_key(items, nloc, sweep_ok, device,
                          (flag, bsz if flag == 2 else 0),
                          perm0, nsh)
    cacheable = key is not None
    hit = cacheable and key in F._plan_cache
    plan = {
        "cacheable": cacheable,
        "cache": "hit" if hit else ("miss" if cacheable else "uncacheable"),
        # a miss means the drain plans again
        "retrace_expected": None if not cacheable else not hit,
        "exchange_chunks_key": str(PAR.exchange_config_key() or "auto"),
    }
    # no AOT tier in the port yet: the reference's report with its AOT
    # cache off
    compile_section = {"aot": "disabled", "aot_enabled": False,
                       "aot_key": None, "plan_cache": plan["cache"]}
    read_exch = final_remap["exchanges"] if final_remap else 0
    read_bytes = final_remap["exchange_bytes"] if final_remap else 0
    # the governor's prediction over the program the drain would dispatch
    # (planned quietly from the original stream, optimized once there)
    memory = _gov.explain_memory(qureg, orig_items)
    return ExplainReport(
        register=register,
        items=len(items),
        windows=windows,
        final_remap=final_remap,
        plan=plan,
        compile=compile_section,
        optimizer=optimizer_section,
        memory=memory,
        totals={
            "windows": len(windows),
            "plan_windows": int(plan_windows),
            "perm_windows": int(perm_windows),
            "mega_windows": int(mega_windows),
            "exchanges": int(tot_exch),
            "exchange_bytes": int(tot_bytes),
            "exchanges_with_read": int(tot_exch + read_exch),
            "exchange_bytes_with_read": int(tot_bytes + read_bytes),
            "tier_bytes": {t: int(b) for t, b in tot_tier.items()},
            "weighted_exchange_cost": float(sum(
                _topology.tier_weights()[t] * b
                for t, b in tot_tier.items())),
            "topology": _topology.resolve(1 << nsh).describe()
            if nsh else None,
        },
    )


def format_explain(report: dict) -> str:
    """Fixed-width text table of an :func:`explain_circuit` report."""
    reg = report["register"]
    head = (f"circuit plan: {reg['qubits']} qubits"
            f"{' (density)' if reg['density'] else ''}, "
            f"{reg['shards']} shard(s)")
    if reg["shard_bits"]:
        head += f" (nloc={reg['nloc']})"
    if reg.get("batch"):
        b = reg["batch"]
        head += (f", batch={b['size']} (bucket={b['bucket']} "
                 f"occupancy={b['occupancy']:.2f})")
    plan = report["plan"]
    head += (f", {report['items']} item(s), plan-cache={plan['cache']}, "
             f"chunks={plan['exchange_chunks_key']}")
    comp = report.get("compile")
    if comp and comp.get("aot") != "disabled":
        head += f", aot={comp['aot']}"
    lines = [head]
    opt = report.get("optimizer")
    if opt:
        rm = opt["removed"]
        oline = (f"optimizer: mode={opt['mode']} "
                 f"gates {opt['gates_in']}->{opt['gates_out']} "
                 f"(cancel={rm['cancel']} merge={rm['merge']} "
                 f"diag={rm['diag_coalesce']} "
                 f"perm={rm.get('perm_coalesce', 0)}"
                 + (" reordered" if opt["reordered"] else "") + ")")
        if opt["windows_before"] is not None:
            oline += (f" windows {opt['windows_before']}->"
                      f"{opt['windows_after']}")
        ts = opt.get("tier_savings_bytes")
        if ts is not None:
            oline += (f" saves exch={opt['exchange_savings']} "
                      f"bytes ici={ts['ici']} dcn={ts['dcn']}")
        lines.append(oline)
    lines.append(f"{'window':>7} {'kind':>8} {'items':>6} {'gates':>6} "
                 f"{'chans':>6} {'exch':>5} {'bytes/shard':>12} "
                 f"{'chunks':>7}  sigma")

    def row(label, kind, items, gates, chans, entry):
        ch = entry.get("chunks")
        ch_s = f"{ch['half_shard']}/{ch['full_shard']}" if ch else "-"
        sig = entry.get("sigma")
        sig_s = "(" + ",".join(str(p) for p in sig) + ")" if sig else "-"
        lines.append(
            f"{label:>7} {kind:>8} {items:>6} {gates:>6} {chans:>6} "
            f"{entry['exchanges']:>5} {entry['exchange_bytes']:>12} "
            f"{ch_s:>7}  {sig_s}")

    for w in report["windows"]:
        row(str(w["window"]), w.get("kind", "dense"),
            w["end"] - w["start"], w["gates"], w["channels"], w)
    if report["final_remap"]:
        row("read", "-", "-", "-", "-", report["final_remap"])
    t = report["totals"]
    lines.append(
        f"totals: plan_windows={t['plan_windows']}"
        + (f" perm_windows={t['perm_windows']}"
           if t.get("perm_windows") else "")
        + (f" mega_windows={t['mega_windows']}"
           if t.get("mega_windows") else "")
        + f" exchanges={t['exchanges']} bytes={t['exchange_bytes']}"
        + (f" (+{t['exchanges_with_read'] - t['exchanges']} exch / "
           f"+{t['exchange_bytes_with_read'] - t['exchange_bytes']} bytes "
           f"at read)" if report["final_remap"] else ""))
    if t.get("topology"):
        tb = t["tier_bytes"]
        lines.append(
            f"topology: {t['topology']} tier bytes: ici={tb['ici']} "
            f"dcn={tb['dcn']} weighted_cost={t['weighted_exchange_cost']:.0f}")
    mem = report.get("memory")
    if mem:
        line = (f"memory: peak/device={mem['predicted_peak_bytes']} "
                f"(state={mem['state_bytes_per_device']} "
                f"x{mem['live_multiplier']:.2f} + "
                f"arrays={mem['pass_array_bytes']}), "
                f"resident_other={mem['other_resident_bytes']}")
        if mem["budget_bytes"] is not None:
            line += (f", budget={mem['budget_bytes']} "
                     f"policy={mem['policy']} "
                     f"fits={'yes' if mem['fits'] else 'NO'}")
        lines.append(line)
    return "\n".join(lines)


def report_circuit_plan(qureg, gates=None) -> None:
    """Print the plan explainer's table (the ``report*`` family)."""
    print(explain_circuit(qureg, gates).table())


# ---------------------------------------------------------------------------
# Exchange audit
# ---------------------------------------------------------------------------

# loose word regex over the audit text (an upper bound on the exact
# histogram, as over the reference's HLO text)
COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|collective-permute|all-gather|all-to-all|"
    r"reduce-scatter)\b")

# the JAX package's exact opcode families
COLLECTIVE_OPS = (
    "all-reduce", "all-reduce-start", "collective-permute",
    "collective-permute-start", "all-gather", "all-gather-start",
    "all-to-all", "reduce-scatter",
)

# a collective-permute's routing table in the audit text, as in HLO:
# source_target_pairs={{0,1},{1,0},...}
_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:[^{}]|\{[^{}]*\})*)\}")
_PAIR_RE = re.compile(r"\{\s*(\d+)\s*,\s*(\d+)\s*\}")

# the mesh's transport calls and the opcode family each one is
_MESH_FAMILIES = (("permute", "collective-permute"),
                  ("gather", "all-gather"), ("all_gather", "all-gather"),
                  ("all_to_all", "all-to-all"), ("sum", "all-reduce"))

_HLO_TYPES = {torch.float32: "f32", torch.float64: "f64",
              torch.float16: "f16", torch.bfloat16: "bf16",
              torch.int64: "s64", torch.int32: "s32", torch.bool: "pred"}


class CollectiveBudgetError(AssertionError):
    """An audited function exceeded its collective budget."""


class AuditReport:
    """Result of :func:`audit`: ``collectives`` (the exact histogram of the
    mesh's exchange calls by opcode family), ``matches`` (the loose
    regex histogram over ``text``), ``calls`` (one record per call:
    family, payload bytes per shard, routing pairs), ``text`` (one
    HLO-like line per call) and ``flops`` / ``bytes_accessed`` / ``cost``
    (None / empty: the port has no cost analysis)."""

    __slots__ = ("collectives", "matches", "flops", "bytes_accessed",
                 "cost", "text", "calls")

    def __init__(self, collectives, matches, cost, text, calls=()):
        self.collectives = collectives
        self.matches = matches
        self.cost = cost
        self.flops = cost.get("flops")
        self.bytes_accessed = cost.get("bytes accessed")
        self.text = text
        self.calls = list(calls)

    def count(self, family: str) -> int:
        """Calls of ``family`` with its ``-start`` variant."""
        return (self.collectives.get(family, 0)
                + self.collectives.get(family + "-start", 0))

    @property
    def total(self) -> int:
        return sum(self.collectives.values())

    def tier_counts(self, chips: int) -> dict:
        """collective-permute calls by interconnect tier under a ``hosts x
        chips`` reading of the mesh: a call with any pair crossing a host
        boundary (``src ^ dst >= chips``) is "dcn", else "ici"."""
        from .parallel import topology as _topo

        out = {"ici": 0, "dcn": 0}
        for m in _PAIRS_RE.finditer(self.text):
            pairs = [(int(a), int(b))
                     for a, b in _PAIR_RE.findall(m.group(1))]
            split = _topo.split_pair_list(pairs, chips)
            if split["ici"] or split["dcn"]:
                out["dcn" if split["dcn"] else "ici"] += 1
        return out

    def as_dict(self) -> dict:
        return {"collectives": dict(self.collectives),
                "matches": dict(self.matches),
                "flops": self.flops, "bytes_accessed": self.bytes_accessed}

    def __repr__(self) -> str:
        return (f"AuditReport(collectives={self.collectives}, "
                f"flops={self.flops}, bytes_accessed={self.bytes_accessed})")


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) if torch.is_tensor(t) else 0


def _call_record(family: str, method: str, args) -> dict:
    """One exchange call: its family, the largest payload per shard (the
    gathered whole for a gather, as the HLO all-gather's output), its
    tensors' shape and type and a permute's pairs."""
    tensors = [t for t in (args[0] if args else ()) if torch.is_tensor(t)]
    if method in ("gather", "all_gather"):
        nbytes = sum(_nbytes(t) for t in tensors)
    else:
        nbytes = max((_nbytes(t) for t in tensors), default=0)
    t0 = tensors[0] if tensors else None
    shape = [] if t0 is None else list(t0.shape)
    if method in ("gather", "all_gather") and t0 is not None:
        axis = -1 if method == "gather" else 0
        shape[axis] = sum(int(t.shape[axis]) for t in tensors)
    pairs = ([(int(a), int(b)) for a, b in args[1]]
             if method == "permute" and len(args) > 1 else None)
    return {"op": family, "bytes": nbytes, "pairs": pairs,
            "type": _HLO_TYPES.get(getattr(t0, "dtype", None), "f32"),
            "shape": shape}


def _mesh_classes():
    from .parallel.mesh import Mesh

    out, todo = [], [Mesh]
    while todo:
        cls = todo.pop()
        out.append(cls)
        todo.extend(cls.__subclasses__())
    return out


@contextlib.contextmanager
def _counting(calls: list) -> Iterator[None]:
    """Record every transport call any mesh makes while the block runs
    (the outermost call only: ``exchange`` reaches ``permute`` once)."""
    depth = [0]
    saved = []

    def wrap(orig, method, family):
        @functools.wraps(orig)
        def counted(self, *args, **kwargs):
            if depth[0] == 0:
                calls.append(_call_record(family, method, args))
            depth[0] += 1
            try:
                return orig(self, *args, **kwargs)
            finally:
                depth[0] -= 1
        return counted

    for cls in _mesh_classes():
        for method, family in _MESH_FAMILIES:
            if method in cls.__dict__:
                saved.append((cls, method, cls.__dict__[method]))
                setattr(cls, method, wrap(cls.__dict__[method], method,
                                          family))
    try:
        yield
    finally:
        for cls, method, orig in saved:
            setattr(cls, method, orig)


def _cloned(a):
    """A tensor or sharded argument copied, so the audited run leaves the
    caller's state as it was."""
    from .parallel.mesh import ShardedAmps

    if isinstance(a, ShardedAmps):
        return ShardedAmps(a.mesh, [s.clone() for s in a.shards])
    if torch.is_tensor(a):
        return a.clone()
    return a


def _render(calls) -> str:
    lines = []
    for i, c in enumerate(calls):
        shape = ",".join(str(d) for d in c["shape"])
        line = (f"%{c['op']}.{i} = {c['type']}[{shape}] {c['op']}(payload), "
                f"payload_bytes={c['bytes']}")
        if c["pairs"] is not None:
            line += ", source_target_pairs={" + ",".join(
                f"{{{a},{b}}}" for a, b in c["pairs"]) + "}"
        lines.append(line)
    return "\n".join(lines)


def audit(fn, *args, donate: bool = False) -> AuditReport:
    """Run ``fn(*args)`` once on clones of its tensor and sharded
    arguments and audit the exchange calls it makes: the exact histogram
    by opcode family, the loose regex histogram of the call text, each
    call's payload.  ``donate`` is accepted for the reference's signature
    and changes nothing (the port never donates).  Every ambient
    :class:`CollectiveBudget` checks the report before it is returned."""
    calls: list = []
    cargs = [_cloned(a) for a in args]
    with _counting(calls):
        fn(*cargs)
    collectives: dict = {}
    for c in calls:
        collectives[c["op"]] = collectives.get(c["op"], 0) + 1
    txt = _render(calls)
    matches: dict = {}
    for m in COLLECTIVE_RE.finditer(txt):
        matches[m.group(1)] = matches.get(m.group(1), 0) + 1
    report = AuditReport(collectives, matches, {}, txt, calls)
    for budget in _BUDGET_STACK:
        budget.check(report)
    return report


_BUDGET_STACK: list = []


class CollectiveBudget:
    """Collective-count budget for audited functions.

    ``CollectiveBudget(collective_permute=2)`` caps the collective-permute
    count (with its ``-start`` variant) at 2; ``exact={...}`` pins the
    whole histogram; ``total=N`` caps the sum; ``allow=(...)`` rejects any
    family outside the set.  ``check(report)`` raises
    :class:`CollectiveBudgetError`.  As a context manager the budget is
    ambient: every :func:`audit` inside is checked::

        with CollectiveBudget(collective_permute=1):
            introspect.audit(my_sharded_gate, amps)
    """

    def __init__(self, exact: Optional[dict] = None,
                 total: Optional[int] = None,
                 allow: Optional[Sequence[str]] = None, **max_ops):
        self.exact = dict(exact) if exact is not None else None
        self.total = total
        self.allow = tuple(allow) if allow is not None else None
        # keyword budgets name families with underscores
        self.max_ops = {k.replace("_", "-"): int(v)
                        for k, v in max_ops.items()}

    def check(self, report) -> "AuditReport":
        hist = (report.collectives if isinstance(report, AuditReport)
                else dict(report))
        if not isinstance(report, AuditReport):
            report = None

        def fam_count(family):
            return hist.get(family, 0) + hist.get(family + "-start", 0)

        if self.exact is not None and hist != self.exact:
            raise CollectiveBudgetError(
                f"collective budget: expected exactly {self.exact}, "
                f"the audited function made {hist}")
        for family, cap in self.max_ops.items():
            got = fam_count(family)
            if got > cap:
                raise CollectiveBudgetError(
                    f"collective budget: {family} x{got} exceeds the "
                    f"budget of {cap} ({hist})")
        if self.total is not None and sum(hist.values()) > self.total:
            raise CollectiveBudgetError(
                f"collective budget: {sum(hist.values())} collectives "
                f"exceed the total budget of {self.total} ({hist})")
        if self.allow is not None:
            allowed = set(self.allow) | {a + "-start" for a in self.allow}
            extra = set(hist) - allowed
            if extra:
                raise CollectiveBudgetError(
                    f"collective budget: {sorted(extra)} outside the "
                    f"allowed families {sorted(self.allow)} ({hist})")
        return report

    def __enter__(self) -> "CollectiveBudget":
        _BUDGET_STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _BUDGET_STACK.remove(self)


# ---------------------------------------------------------------------------
# Predicted-vs-measured reconciliation
# ---------------------------------------------------------------------------

# active prediction perturbations; QT_INTROSPECT_PERTURB ("chunks=4",
# "scale=2", "count=N", "nbytes=N") is folded in at reconcile time
_PERTURB_STACK: list = []


@contextlib.contextmanager
def perturb_prediction(count: Optional[int] = None,
                       nbytes: Optional[int] = None,
                       chunks: Optional[str] = None,
                       scale: Optional[float] = None) -> Iterator[None]:
    """Perturb the reconciliation's prediction, to prove the loop detects
    drift: ``chunks`` forces the predicted chunk key, ``scale`` multiplies
    the predicted exchanges and bytes, ``count`` / ``nbytes`` force
    them."""
    entry = {"count": count, "nbytes": nbytes, "chunks": chunks,
             "scale": scale}
    _PERTURB_STACK.append(entry)
    try:
        yield
    finally:
        _PERTURB_STACK.remove(entry)


def _env_perturbation() -> Optional[dict]:
    raw = os.environ.get(_PERTURB_ENV, "").strip()
    if not raw:
        return None
    out = {"count": None, "nbytes": None, "chunks": None, "scale": None}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k == "chunks":
            out["chunks"] = v.strip()
        elif k == "scale":
            out["scale"] = float(v)
        elif k in ("count", "nbytes"):
            out[k] = int(v)
    return out


def _apply_perturbations(pred: dict) -> dict:
    stack = list(_PERTURB_STACK)
    env = _env_perturbation()
    if env:
        stack.append(env)
    for p in stack:
        if p["scale"] is not None:
            pred["count"] = int(pred["count"] * p["scale"])
            pred["nbytes"] = int(pred["nbytes"] * p["scale"])
        if p["count"] is not None:
            pred["count"] = int(p["count"])
        if p["nbytes"] is not None:
            pred["nbytes"] = int(p["nbytes"])
        if p["chunks"] is not None:
            pred["chunks"] = str(p["chunks"])
    return pred


@functools.lru_cache(maxsize=256)
def _predict_cached(bit_key, n: int, nloc: int, nsh: int, perm_key,
                    itemsize: int, topo_sig):
    # a pure function of the plan's inputs, memoised; ``topo_sig`` keys
    # the live arrangement, under which the planner picks other sigmas
    from .parallel import dist as PAR
    from .parallel import topology as _topo

    count = nbytes = 0
    tiers = {"ici": 0, "dcn": 0}
    topology = _topo.resolve(1 << nsh)
    segments, _final_perm = C.plan_remap_windows(
        list(bit_key), n, nloc,
        list(perm_key) if perm_key is not None else None)
    for _ij, sigma, _perm in segments:
        if sigma is None:
            continue
        count += PAR.remap_exchange_count(tuple(sigma), nloc, nsh)
        nbytes += C.remap_exchange_bytes(tuple(sigma), n, nloc, itemsize)
        for t, (_c, b) in PAR.remap_exchange_tiers(
                tuple(sigma), nloc, nsh, itemsize, topology).items():
            tiers[t] += b
    return count, nbytes, (tiers["ici"], tiers["dcn"])


def predict_window_exchanges(bit_sets: Sequence, n: int, nloc: int,
                             nsh: int, perm0, itemsize: int,
                             batch: int = 0) -> dict:
    """Independent re-derivation of what a sharded drain over
    ``bit_sets`` must exchange (``op=window_remap``): re-plan the windows
    and fold every sigma through the cost model, with the split by tier
    under the live topology."""
    from .parallel import dist as PAR
    from .parallel import topology as _topo

    bw = max(int(batch), 1)
    count, nbytes, (ici_b, dcn_b) = _predict_cached(
        tuple(tuple(b) for b in bit_sets), n, nloc, nsh,
        tuple(perm0) if perm0 is not None else None, itemsize,
        _topo.signature(1 << nsh))
    return {"count": count * bw, "nbytes": nbytes * bw,
            "tier_nbytes": {"ici": ici_b * bw, "dcn": dcn_b * bw},
            "chunks": str(PAR.exchange_config_key() or "auto")}


def reconcile_drain(*, bit_sets: Sequence, n: int, nloc: int, nsh: int,
                    perm0, itemsize: int, batch: int,
                    measured_count: float, measured_bytes: float,
                    measured_chunks: str,
                    measured_tier_bytes: Optional[dict] = None
                    ) -> Optional[dict]:
    """Hold a drain's measured window-remap counter deltas against the
    independent prediction: records ``predicted_exchanges_total`` /
    ``predicted_exchange_bytes_total{tier}``; each drifting dimension
    (count, bytes, chunks, tier_bytes) counts ``model_drift_total{kind}``
    and the drift logs one JSON line.  Returns the drift (empty when the
    model holds; None with telemetry off)."""
    if not _telemetry.enabled():
        return None
    pred = _apply_perturbations(predict_window_exchanges(
        bit_sets, n, nloc, nsh, perm0, itemsize, batch))
    if pred["count"]:
        _telemetry.inc("predicted_exchanges_total", pred["count"],
                       op="window_remap")
    for tier, b in pred["tier_nbytes"].items():
        if b:
            _telemetry.inc("predicted_exchange_bytes_total", b,
                           op="window_remap", tier=tier)
    drift: dict = {}
    if int(measured_count) != int(pred["count"]):
        drift["count"] = {"predicted": int(pred["count"]),
                          "measured": int(measured_count)}
    if int(measured_bytes) != int(pred["nbytes"]):
        drift["bytes"] = {"predicted": int(pred["nbytes"]),
                          "measured": int(measured_bytes)}
    if measured_tier_bytes is not None:
        for tier, b in pred["tier_nbytes"].items():
            if int(measured_tier_bytes.get(tier, 0)) != int(b):
                drift.setdefault("tier_bytes", {})[tier] = {
                    "predicted": int(b),
                    "measured": int(measured_tier_bytes.get(tier, 0))}
    if (pred["count"] or measured_count) and \
            str(measured_chunks) != str(pred["chunks"]):
        drift["chunks"] = {"predicted": str(pred["chunks"]),
                           "measured": str(measured_chunks)}
    if drift:
        for kind in drift:
            _telemetry.inc("model_drift_total", kind=kind)
        _telemetry.flight_event("model_drift",
                                kinds=",".join(sorted(drift)),
                                shards=1 << nsh, items=len(bit_sets))
        _LOG.warning(json.dumps(
            {"event": "model_drift", "kinds": sorted(drift),
             "drift": drift, "shards": 1 << nsh, "items": len(bit_sets)},
            sort_keys=True))
    return drift


def measure_dispatch_floor(calls: int = 64, device=None) -> float:
    """Median host seconds of one trivial op on ``device`` (a device, a
    register, an env; default: the card when there is one) followed by
    ``torch.cuda.synchronize()`` there: the per-program dispatch floor.
    Publishes the ``per_program_dispatch_seconds`` gauge, against which
    reportPerf labels a route ``dispatch_bound``."""
    if device is not None and not isinstance(device, (str, torch.device)):
        device = getattr(device, "device", None) or device.env.device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cuda = device.type == "cuda"
    x = torch.zeros((), device=device)

    def once():
        y = x + 1.0
        if cuda:
            torch.cuda.synchronize(device)
        return y

    once()  # first use outside the timed loop
    samples = []
    for _ in range(max(8, int(calls))):
        t0 = time.perf_counter()
        once()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    floor = samples[len(samples) // 2]
    _telemetry.set_gauge("per_program_dispatch_seconds", floor)
    return floor


# camelCase mirrors (the reference's API surface)
explainCircuit = explain_circuit
reportCircuitPlan = report_circuit_plan
