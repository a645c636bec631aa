"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""

import ast
import sys

import pytest

from qtbench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py")
               if ".cache" not in p.parts)


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((harness.BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_imports(path) <= {"__future__", "math", "torch", "numpy"}


def test_forbidden_compares_whole_names(monkeypatch):
    mods = dict(sys.modules)
    for m in harness.FORBIDDEN:
        mods.pop(m, None)
    mods["quest_tpu_torch"] = sys
    mods["quest_tpu_torch.ops"] = sys
    mods["jaxtyping"] = sys
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == []
    mods["quest_tpu.ops"] = sys
    assert harness.forbidden_modules() == ["quest_tpu"]
