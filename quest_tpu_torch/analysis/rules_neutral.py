"""qlint rule family 1 of the port: the framework-neutral hygiene rules
of the JAX package's ``quest_tpu/analysis/rules_trace.py``, with its rule
ids.

* ``nondeterminism``: ``time.time()`` / unseeded ``random`` in the
  product package undermines bit-identical resume (resilience.py's core
  contract) unless the value is recorded;
* ``fault-plan-spec``: a string fault schedule handed to
  ``resilience.FaultPlan`` must be comma-joined ``kind@N`` events of
  registered kinds: a typo raises at plan construction, and in an
  environment default it silently never fires;
* ``broad-except``: a bare or broad ``except`` without a justified pragma
  swallows the structured error taxonomy (QuESTError, ShardLossError,
  MemoryAdmissionError) the recovery layers dispatch on;
* ``oom-swallow``: a handler inspecting ``torch.OutOfMemoryError`` (or
  ``torch.cuda.OutOfMemoryError``) anywhere but governor.py bypasses the
  governor's evict-and-retry-once protocol (``governor.oom_net``).

Left out, with their reasons: ``host-sync-in-traced``,
``tracer-branch`` and ``telemetry-in-traced`` guard code that runs under
a jax trace, and the port has no tracing (its drains execute plans
eagerly); ``f64-literal`` rests on float64 being software-emulated on a
TPU, and the H100 runs float64 natively.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from .engine import Finding, Rule, _all_nodes, register

PRODUCT = "quest_tpu_torch/"

_NP_NAMES = {"np", "numpy", "_np", "onp"}


def _dotted(node) -> Optional[Tuple[str, ...]]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


@register
class NondeterminismRule(Rule):
    id = "nondeterminism"
    doc = ("wall-clock / unseeded-RNG source in the product package — "
           "breaks bit-identical resume unless recorded and justified")
    scope = (PRODUCT,)

    _LEGACY_NP_SAMPLERS = {"rand", "randn", "random", "random_sample",
                           "randint", "choice", "permutation", "shuffle",
                           "normal", "uniform", "bytes"}
    _STDLIB_SAMPLERS = {"random", "randint", "randrange", "choice",
                        "shuffle", "uniform", "sample", "getrandbits",
                        "gauss"}

    def check(self, tree, src, path) -> Iterator[Finding]:
        has_random_import = any(
            isinstance(n, ast.Import) and
            any(a.name == "random" for a in n.names)
            for n in _all_nodes(tree))
        for node in _all_nodes(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _dotted(node.func)
            if fname is None:
                continue
            if fname[-1] in {"time", "time_ns"} and len(fname) >= 2 and \
                    fname[-2] in {"time", "_time"}:
                yield self.finding(
                    path, node,
                    "wall-clock time.time() feeds program state — breaks "
                    "bit-identical replay unless the value is recorded")
            elif len(fname) == 2 and fname[0] == "random" and \
                    fname[1] in self._STDLIB_SAMPLERS and \
                    has_random_import:
                yield self.finding(
                    path, node,
                    f"stdlib random.{fname[1]} draws from the unseeded "
                    f"process-global stream")
            elif len(fname) >= 3 and fname[0] in _NP_NAMES and \
                    fname[1] == "random" and \
                    fname[2] in self._LEGACY_NP_SAMPLERS:
                yield self.finding(
                    path, node,
                    f"np.random.{fname[2]} draws from the unseeded "
                    f"legacy global RNG — use a seeded Generator / "
                    f"rng.GLOBAL_RNG")
            elif len(fname) >= 3 and fname[0] in _NP_NAMES and \
                    fname[1] == "random" and fname[2] == "default_rng" \
                    and not node.args:
                yield self.finding(
                    path, node,
                    "np.random.default_rng() without a seed is "
                    "entropy-seeded — pass an explicit seed")


@register
class FaultPlanSpecRule(Rule):
    id = "fault-plan-spec"
    doc = ("string fault schedule passed to resilience.FaultPlan must be "
           "comma-joined kind@N events with registered kinds — a typo'd "
           "kind raises at plan construction, and in an env default it "
           "silently never fires")

    # the port's resilience.FaultPlan._KINDS, the serve-level kinds
    # (bank_fault / heal / poison_job) included; a literal, so that the
    # analyzer imports no torch (pinned by tests/test_torch_analysis.py)
    KINDS = frozenset({
        "kill", "killsave", "corrupt", "io", "nan", "inf", "scale",
        "stall", "shard_loss", "host_loss", "oom",
        "bank_fault", "heal", "poison_job",
    })

    def check(self, tree, src, path) -> Iterator[Finding]:
        for node in _all_nodes(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = _dotted(node.func)
            if fname is None or fname[-1] != "FaultPlan":
                continue
            spec = node.args[0]
            if not isinstance(spec, ast.Constant) \
                    or not isinstance(spec.value, str):
                continue  # dynamic specs are validated at run time
            for part in spec.value.split(","):
                part = part.strip()
                if not part:
                    continue
                kind, sep, arg = part.partition("@")
                kind = kind.strip()
                if kind not in self.KINDS:
                    yield self.finding(
                        path, spec,
                        f"unknown fault kind {kind!r} in FaultPlan spec "
                        f"{spec.value!r} (registered: "
                        f"{', '.join(sorted(self.KINDS))})")
                elif sep and not arg.strip().lstrip("-").isdigit():
                    yield self.finding(
                        path, spec,
                        f"non-integer argument {arg.strip()!r} for "
                        f"{kind!r} in FaultPlan spec {spec.value!r}")


@register
class BroadExceptRule(Rule):
    id = "broad-except"
    doc = ("bare/broad except without a justified pragma — swallows the "
           "structured error taxonomy (QuESTError, ShardLossError, "
           "MemoryAdmissionError) the recovery layers dispatch on")
    scope = (PRODUCT,)

    def check(self, tree, src, path) -> Iterator[Finding]:
        for node in _all_nodes(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            broad = t is None or (
                isinstance(t, ast.Name) and
                t.id in {"Exception", "BaseException"})
            if not broad:
                continue
            # cleanup-and-reraise never swallows: the taxonomy still
            # propagates (fusion's drain-requeue is the canonical case)
            if any(isinstance(s, ast.Raise) and s.exc is None
                   for s in node.body):
                continue
            what = "bare except" if t is None else f"except {t.id}"
            yield self.finding(
                path, node,
                f"{what} without narrowing — name the expected "
                f"failure classes or justify with a qlint pragma")


@register
class OomSwallowRule(Rule):
    id = "oom-swallow"
    doc = ("torch.OutOfMemoryError handled outside governor.oom_net — "
           "only the governor may catch allocation failure (evict-and-"
           "retry-once protocol)")
    scope = (PRODUCT,)
    exclude = ("quest_tpu_torch/governor.py",)

    def check(self, tree, src, path) -> Iterator[Finding]:
        for node in _all_nodes(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            seg = ast.get_source_segment(src, node) or ""
            if "OutOfMemoryError" in seg or "_is_oom" in seg:
                yield self.finding(
                    path, node,
                    "except handler inspects torch.OutOfMemoryError "
                    "outside governor.oom_net — route OOM recovery "
                    "through the memory governor")
