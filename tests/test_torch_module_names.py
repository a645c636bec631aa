"""Every public top-level name of every module of the JAX package has a
home in the port: it is defined in the port's module of the same path, or
MOVED names where the port keeps it, or LEFT_OUT says why the port has no
such name.  Both tables are exact: an entry for a name the reference no
longer defines, or that the port's module of the same path now holds,
fails as well.

A reference module's public names are the functions, classes and
assignments at its top level (inside top-level ``if`` / ``try`` blocks
too) whose names do not start with an underscore; its imports are not
its names.  A port module holds a name when the imported module has the
attribute (``__main__`` modules are read, not imported: importing them
runs them)."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "quest_tpu"
PORT = REPO / "quest_tpu_torch"

# (reference module, name) -> (port module, the attribute that holds it)
MOVED = {
    # the sharded composites live beside the rest of the port's
    # explicit-exchange forms
    ("parallel/dist.py", name): ("parallel/composites.py", name)
    for name in ("apply_diag_op_density_sharded",
                 "expec_pauli_sum_scan_sharded", "fused_qft_runs_sharded",
                 "fused_qft_sharded", "mix_pair_channel_sharded",
                 "mix_two_qubit_depol_sharded", "qft_runs_exchange_model",
                 "qft_runs_exchange_tiers", "trotter_scan_sharded")
}
MOVED.update({
    # the diagonal of a Z-only Hamiltonian is built with the other
    # diagonal operators
    ("ops/paulis.py", "diag_from_z_hamil"):
        ("ops/kernels.py", "diag_from_z_hamil"),
    # the port's tier persists plans, not compiled runners: the
    # lookup-or-plan that wrap_runner put around a jit runner is fusion's
    # memory and disk lookup
    ("aotcache.py", "wrap_runner"): ("fusion.py", "_cache_lookup"),
})

# (reference module, name) -> why the port has no such name
_NO_JIT = "an XLA compilation artifact: the port compiles no programs"
LEFT_OUT = {
    ("aotcache.py", "amps_struct"): _NO_JIT + " (a jax.ShapeDtypeStruct)",
    ("aotcache.py", "arg_sig"): _NO_JIT + " (an executable's argument "
                                "signature)",
    ("aotcache.py", "runner_key"): _NO_JIT + " (a serialized executable's "
                                   "key; plans key on fusion._plan_key)",
    ("circuit.py", "materialize_plan"): "the native C++ scheduler's plan "
                                        "materializer; the Python planners "
                                        "give the same plans",
    ("circuit.py", "materialize_windowed_plan"): "the native scheduler's "
                                                 "windowed form, likewise",
    ("circuit.py", "perm_fast_enabled"): "the QT_PERM_FAST switch, left "
                                         "out by design",
    ("env.py", "AMP_AXIS"): "the name of the JAX mesh axis",
    ("env.py", "shard_map"): "jax.experimental.shard_map's import shim",
    ("env.py", "compile_cache_stats"): "JAX's persistent compilation "
                                       "cache statistics",
    ("ops/kernels.py", "bit_indicator_2d"): "a jnp helper of the JAX "
                                            "kernels; the port's is "
                                            "_bit_indicator_2d",
    ("ops/kernels.py", "set_weighted_qureg_donated"): "a buffer-donating "
                                                      "jit variant: torch "
                                                      "has no donation",
    ("ops/cplx.py", "real_matrix_rep"): "the real 2x2-block matrix form "
                                        "the TPU matmuls take; the port's "
                                        "products are complex or its own "
                                        "kernels'",
    ("ops/fused.py", "BLOCK_AMPS"): "the Pallas kernels' block size",
    ("ops/fused.py", "lane_real_rep"): "the Pallas kernels' real lane "
                                       "operand layout",
    ("ops/fused.py", "sublane_real_rep"): "the Pallas kernels' real "
                                          "sublane operand layout",
    ("ops/fused.py", "megakernel_executable"): "the Pallas megakernel's "
                                               "lowering probe",
    ("ops/fused.py", "megakernel_lowering_ok"): "the Pallas megakernel's "
                                                "lowering probe",
    ("ops/paulis.py", "apply_pauli_prod"): "a jit shell nothing calls",
    ("ops/paulis.py", "pallas_lowering_ok"): "the Pallas lowering probe "
                                             "and its silent downgrade",
}

# reference modules with no module of the same path in the port
NO_COUNTERPART = {
    "native/__init__.py": "the native C++ scheduler, left out by design",
    "analysis/hlocheck.py": "HLO checks of XLA programs; the port's "
                            "contract checks are analysis/contracts_check.py",
    "analysis/rules_trace.py": "rules over jax tracing; the port's "
                               "framework-neutral rules are "
                               "analysis/rules_neutral.py",
    "utils/bits.py": "jnp bit helpers, inlined in the port",
}


def _assigned(node):
    for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def _top_level(body):
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            yield from _assigned(node)
        elif isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _top_level(part)


def reference_names(rel: str) -> set:
    tree = ast.parse((REF / rel).read_text())
    return {n for n in _top_level(tree.body) if not n.startswith("_")}


def port_holds(rel: str, name: str) -> bool:
    path = PORT / rel
    if path.name == "__main__.py":
        tree = ast.parse(path.read_text())
        return name in set(_top_level(tree.body))
    mod = ".".join(("quest_tpu_torch",) + Path(rel).with_suffix("").parts)
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return hasattr(importlib.import_module(mod), name)


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_reference_name_has_a_home(rel):
    if rel in NO_COUNTERPART:
        assert not (PORT / rel).exists(), \
            f"{rel} now has a port: drop it from NO_COUNTERPART"
        return
    assert (PORT / rel).exists(), f"no port of {rel}"
    missing = []
    for name in sorted(reference_names(rel)):
        if (rel, name) in MOVED:
            continue
        if (rel, name) in LEFT_OUT:
            continue
        if not port_holds(rel, name):
            missing.append(name)
    assert not missing, f"quest_tpu/{rel}: {missing} neither ported, " \
                        "moved nor left out"


@pytest.mark.parametrize("key", sorted(MOVED), ids="/".join)
def test_moved_entries_are_exact(key):
    rel, name = key
    assert name in reference_names(rel), f"stale: quest_tpu/{rel} has no {name}"
    assert not port_holds(rel, name), \
        f"stale: quest_tpu_torch/{rel} defines {name} itself"
    where, attr = MOVED[key]
    assert port_holds(where, attr), f"quest_tpu_torch/{where} lacks {attr}"


@pytest.mark.parametrize("key", sorted(LEFT_OUT), ids="/".join)
def test_left_out_entries_are_exact(key):
    rel, name = key
    assert name in reference_names(rel), f"stale: quest_tpu/{rel} has no {name}"
    assert not port_holds(rel, name), \
        f"stale: quest_tpu_torch/{rel} now defines {name}"
    assert LEFT_OUT[key].strip()


def test_no_counterpart_entries_are_reference_modules():
    assert set(NO_COUNTERPART) <= set(REF_MODULES)
    assert all(reason.strip() for reason in NO_COUNTERPART.values())
