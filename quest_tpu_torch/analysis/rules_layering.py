"""qlint rule family 2 of the port: layering and collective confinement
(the JAX package's ``quest_tpu/analysis/rules_layering.py`` on the port's
own import DAG, with its rule ids).

**Layer DAG.**  "API functions should never call each other"; all
inter-device communication lives in one exchange layer.  Over module-level
imports of ``quest_tpu_torch``:

    api (api, api_ops, debug, models, probes)  rank 0
      ↓
    serve (serve)                              rank 1
      ↓
    orchestration (fusion, batch, circuit,     rank 2
      optimizer, resilience, checkpoint,
      introspect, governor, interop)
      ↓
    dist (parallel/*, aotcache)                rank 3
      ↓
    ops (ops/*, ops/build included)            rank 4
      ↓
    env (env)                                  rank 5

plus a **shared** stratum (validation, precision, rng, telemetry,
contracts, qureg, qasm, utils, analysis) importable from every layer but
itself restricted to shared + env.  The port's extra modules sit where
their imports put them: ``interop`` (it carries plans and states in, so
it imports circuit) in orchestration, ``ops/build`` (the kernels' build)
in ops, ``parallel/mesh`` in dist, ``utils/profiling`` in shared,
``aotcache`` in dist, as the reference places it, and ``probes`` (the
TPU probes on the card, a tool on top like ``models``) in api.
Function-scope lazy imports are the package's cycle-breaking idiom and
are not flagged: the rule reads only module-level ``import`` / ``from``
nodes.

**Collective confinement.**  A ``torch.distributed`` call other than the
process group's lifecycle (init, destroy, rank, size, backend), an
attribute call named ``all_gather`` / ``all_to_all`` (or the reference's
lax collective names), and the Mesh exchange methods (``permute``,
``exchange``, ``gather``, ``all_gather``, ``all_to_all``, ``sum``)
called on a mesh are flagged anywhere outside ``quest_tpu_torch/parallel/``:
the exchange layer's wrappers carry the guard, the fault hooks and the
accounting, and a collective issued elsewhere bypasses all three.
``Mesh.barrier`` is not an exchange: the checkpoint's ranks meet on it.

**Contract presence.**  Every wrapper named in
``quest_tpu_torch.contracts.REQUIRED_WRAPPERS`` must carry the
``@sharded_contract`` decorator; ``contracts_check.py`` (``--contracts``)
verifies the declarations against the wrappers' exchange calls.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from .engine import Finding, Rule, _all_nodes, register
from ..contracts import REQUIRED_WRAPPERS

PACKAGE = "quest_tpu_torch"

# module key (first path component under quest_tpu_torch/, or module
# stem) -> layer name.  Keep in sync with the diagram above.
LAYER_OF = {
    "api": "api", "api_ops": "api", "debug": "api", "models": "api",
    "probes": "api",
    "serve": "serve",
    "fusion": "orch", "batch": "orch", "circuit": "orch",
    "optimizer": "orch", "resilience": "orch", "checkpoint": "orch",
    "introspect": "orch", "governor": "orch", "interop": "orch",
    "parallel": "dist", "aotcache": "dist",
    "ops": "ops",
    "env": "env",
}

LAYER_RANK = {"api": 0, "serve": 1, "orch": 2, "dist": 3, "ops": 4,
              "env": 5}

# importable from everywhere; may import only shared + env
SHARED = {"validation", "precision", "rng", "telemetry", "contracts",
          "qureg", "qasm", "utils", "analysis"}

# attribute calls flagged on any receiver: the reference's lax
# collective names, unambiguous in this package
COLLECTIVE_NAMES = {"ppermute", "psum", "psum_scatter", "all_gather",
                    "all_to_all", "pshuffle", "pmean", "pmax", "pmin",
                    "axis_index_groups"}
# the Mesh exchange methods, flagged when called on a mesh
MESH_METHODS = {"permute", "exchange", "gather", "all_gather",
                "all_to_all", "sum"}
# torch.distributed calls that set up or describe the process group and
# move no data
DIST_LIFECYCLE = {"init_process_group", "destroy_process_group",
                  "is_initialized", "is_available", "get_rank",
                  "get_world_size", "get_backend", "new_group",
                  "is_nccl_available", "is_gloo_available",
                  "is_torchelastic_launched"}
EXCHANGE_LAYER = "quest_tpu_torch/parallel/"


def _module_key(path: str) -> Optional[str]:
    """quest_tpu_torch/ops/kernels.py -> 'ops'; quest_tpu_torch/env.py ->
    'env';
    None for the package root __init__ and non-package files."""
    parts = path.split("/")
    if parts[0] != PACKAGE or len(parts) < 2:
        return None
    if len(parts) == 2:
        stem = parts[1][:-3] if parts[1].endswith(".py") else parts[1]
        return None if stem == "__init__" else stem
    return parts[1]


def _imported_keys(node, path: str) -> Iterator[Tuple[str, ast.AST]]:
    """Module keys (under quest_tpu_torch) a top-level import node pulls
    in."""
    pkg_parts = path.split("/")[:-1]  # containing package of this file
    if isinstance(node, ast.Import):
        for alias in node.names:
            parts = alias.name.split(".")
            if parts[0] == PACKAGE and len(parts) > 1:
                yield parts[1], node
    elif isinstance(node, ast.ImportFrom):
        if node.level == 0:
            parts = (node.module or "").split(".")
            if parts[0] != PACKAGE:
                return
            if len(parts) > 1:
                yield parts[1], node
            else:
                # `from quest_tpu_torch import fusion, env` — names are
                # modules
                for alias in node.names:
                    yield alias.name, node
            return
        # relative: resolve against the containing package
        base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
        if not base or base[0] != PACKAGE:
            return
        if node.module:
            target = base + node.module.split(".")
            if len(target) > 1:
                yield target[1], node
        else:
            # `from . import x, y` — each name is a module
            for alias in node.names:
                target = base + [alias.name]
                if len(target) > 1:
                    yield target[1], node


def _top_level_imports(tree: ast.Module) -> Iterator[ast.AST]:
    """Module-level import nodes, including those inside top-level
    try/except and `if TYPE_CHECKING:` shims — but NOT function bodies
    (lazy imports are the sanctioned cycle-breaking idiom)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, (ast.Try, ast.If)):
            stack.extend(getattr(node, "body", ()))
            stack.extend(getattr(node, "orelse", ()))
            stack.extend(getattr(node, "finalbody", ()))
            for h in getattr(node, "handlers", ()):
                stack.extend(h.body)


@register
class LayerViolationRule(Rule):
    id = "layer-violation"
    doc = ("module-level import against the layer DAG "
           "(api → serve → orch → dist → ops → env, shared importable by "
           "all) — upward or lateral imports couple layers the design "
           "keeps independent")
    scope = ("quest_tpu_torch/",)
    exclude = ("quest_tpu_torch/__init__.py",)

    def check(self, tree, src, path) -> Iterator[Finding]:
        me = _module_key(path)
        if me is None:
            return
        my_layer = LAYER_OF.get(me)
        for node in _top_level_imports(tree):
            for key, at in _imported_keys(node, path):
                if key == me:
                    continue  # intra-layer submodule import
                dep_layer = LAYER_OF.get(key)
                if me in SHARED:
                    if key in SHARED or dep_layer == "env":
                        continue
                    yield self.finding(
                        path, at,
                        f"shared module '{me}' imports layered module "
                        f"'{key}' at module level — shared modules may "
                        f"import only shared/env")
                    continue
                if key in SHARED or my_layer is None:
                    continue
                if dep_layer is None:
                    continue
                if my_layer == "api" and dep_layer == "api":
                    yield self.finding(
                        path, at,
                        f"api-layer module '{me}' imports api-layer "
                        f"module '{key}' — API functions must not call "
                        f"each other (compose via the orchestration "
                        f"layer)")
                elif LAYER_RANK[dep_layer] < LAYER_RANK[my_layer]:
                    yield self.finding(
                        path, at,
                        f"'{me}' ({my_layer}, rank "
                        f"{LAYER_RANK[my_layer]}) imports '{key}' "
                        f"({dep_layer}, rank {LAYER_RANK[dep_layer]}) — "
                        f"upward import against the layer DAG")


def _dotted(node) -> Optional[Tuple[str, ...]]:
    """('a', 'b', 'c') for the expression a.b.c; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own(scope) -> list:
    """The nodes of one scope (module or function), nested function
    definitions included but not their bodies."""
    out, stack = [], list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if not isinstance(node, _SCOPES):
            stack.extend(ast.iter_child_nodes(node))
    return out


def _bind(nodes, mods: set, names: set) -> Tuple[set, set]:
    """(module aliases of torch.distributed, names imported from it) in a
    scope: the enclosing scope's, updated by this scope's imports (an
    import of anything else under the same name rebinds it)."""
    mods, names = set(mods), set(names)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                mods.discard(bound)
                names.discard(bound)
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                bound = a.asname or a.name
                mods.discard(bound)
                names.discard(bound)
                if node.level == 0 and node.module == "torch" \
                        and a.name == "distributed":
                    mods.add(bound)
                elif node.level == 0 \
                        and node.module == "torch.distributed":
                    names.add(bound)
    return mods, names


def _scoped_calls(scope, mods=frozenset(), names=frozenset()):
    """(call, torch.distributed aliases, names) for every call, each
    resolved against the imports of its own function and of the scopes
    enclosing it."""
    own = _own(scope)
    mods, names = _bind(own, mods, names)
    for node in own:
        if isinstance(node, ast.Call):
            yield node, mods, names
        elif isinstance(node, _SCOPES):
            yield from _scoped_calls(node, mods, names)


def _is_mesh(node) -> bool:
    """Is the receiver a mesh: a name or attribute ending in ``mesh``
    (``mesh``, ``amps.mesh``, ``self._mesh``, ``env.mesh``)?"""
    d = _dotted(node)
    return d is not None and d[-1].lower().endswith("mesh")


@register
class CollectiveOutsideDistRule(Rule):
    id = "collective-outside-dist"
    doc = ("torch.distributed or Mesh exchange call outside parallel/ — "
           "all inter-shard communication must go through the exchange "
           "layer's guarded wrappers")
    exclude = (EXCHANGE_LAYER,)

    def check(self, tree, src, path) -> Iterator[Finding]:
        for node, mods, names in _scoped_calls(tree):
            f = node.func
            name = None
            if isinstance(f, ast.Name):
                if f.id in names and f.id not in DIST_LIFECYCLE:
                    name = f"torch.distributed.{f.id}"
            elif isinstance(f, ast.Attribute):
                d = _dotted(f.value)
                owner = ".".join(d) if d is not None else None
                if owner in mods or owner == "torch.distributed":
                    if f.attr not in DIST_LIFECYCLE:
                        name = f"torch.distributed.{f.attr}"
                elif f.attr in COLLECTIVE_NAMES:
                    name = f.attr
                elif f.attr in MESH_METHODS and _is_mesh(f.value):
                    name = f"Mesh.{f.attr}"
            if name is not None:
                yield self.finding(
                    path, node,
                    f"'{name}' issued outside the exchange layer "
                    f"({EXCHANGE_LAYER}) — use the guarded sharded "
                    f"wrappers")


@register
class ContractMissingRule(Rule):
    id = "contract-missing"
    doc = ("registered sharded dispatch wrapper without a "
           "@sharded_contract declaration — its collective shape would "
           "be unpinned against drift of its exchange calls")
    scope = (EXCHANGE_LAYER,)

    def check(self, tree, src, path) -> Iterator[Finding]:
        seen = {}
        for node in _all_nodes(tree):
            if isinstance(node, ast.FunctionDef):
                seen[node.name] = node
        for name in REQUIRED_WRAPPERS:
            fn = seen.get(name)
            if fn is None:
                continue  # wrapper moved/renamed; registry drift shows
                # up in hlocheck, not here
            if not any(self._is_contract(dec)
                       for dec in fn.decorator_list):
                yield self.finding(
                    path, fn,
                    f"sharded dispatch wrapper '{name}' carries no "
                    f"@sharded_contract declaration "
                    f"(quest_tpu_torch/contracts.py)")

    @staticmethod
    def _is_contract(dec) -> bool:
        target = dec.func if isinstance(dec, ast.Call) else dec
        while isinstance(target, ast.Attribute):
            if target.attr == "sharded_contract":
                return True
            target = target.value
        return isinstance(target, ast.Name) and \
            target.id == "sharded_contract"
