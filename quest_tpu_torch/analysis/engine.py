"""qlint rule engine of the port: findings, suppressions, baseline, tree
walking (the JAX package's ``quest_tpu/analysis/engine.py``, with the
same pragma syntax, finding format and baseline schema).

The analyzer is a plain stdlib-``ast`` pass (no dependencies, imports
neither torch nor jax): rules are small classes registered in
:data:`RULES`, each receiving one parsed file and yielding
:class:`Finding` objects.  Three escape hatches keep the gate honest
rather than noisy:

* **Inline suppressions**: ``# qlint: allow(<rule>): <reason>`` on the
  offending line (or the line directly above) silences exactly that rule
  at that site.  The reason is MANDATORY: a bare ``allow`` or an unknown
  rule id is itself a finding (``bad-pragma``), so every suppression in
  the tree documents why the hazard is intended.  The rule ids are the
  reference's, letter for letter: the reference's analyzer walks the
  port's test files too, and a pragma naming an id it lacks would be a
  ``bad-pragma`` there.
* **Baseline file**: a committed JSON list of grandfathered findings
  (``{"rule", "path", "line", "reason"}``, reason mandatory) matched by
  (rule, path, line), ``quest_tpu_torch/analysis/baseline.json``.
* **Per-rule path scoping**: the product rules (nondeterminism,
  broad-except, oom-swallow, layering) restrict themselves to
  ``quest_tpu_torch/``; the structural rules (collective callsites,
  fault-plan specs, pragma syntax) run over the whole walk
  (``quest_tpu_torch/`` and ``tests/test_torch_*.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

# repo root: quest_tpu_torch/analysis/engine.py -> quest_tpu_torch -> repo
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the port and its tests (a walk root may be a glob pattern)
DEFAULT_WALK = ("quest_tpu_torch", "tests/test_torch_*.py")

BASELINE_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

_PRAGMA_RE = re.compile(
    r"qlint:\s*allow\(([A-Za-z0-9_*-]+)\)\s*(?::\s*(\S.*))?")
# a pragma-looking comment that failed to parse as allow(rule): reason
_PRAGMA_LOOSE_RE = re.compile(r"qlint:\s*allow")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str

    def key(self) -> tuple:
        return (self.rule, self.path, self.line)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


def _all_nodes(tree) -> list:
    """The file's shared node index (analyze_source caches it on the
    tree); falls back to a fresh walk when a rule is driven directly."""
    nodes = getattr(tree, "_qlint_all_nodes", None)
    if nodes is None:
        nodes = list(ast.walk(tree))
        tree._qlint_all_nodes = nodes
    return nodes


class Rule:
    """Base rule: subclasses set ``id``/``doc``, override ``check``.

    ``scope``: None = every walked file; otherwise a tuple of
    repo-relative path prefixes the rule is restricted to.
    ``exclude``: repo-relative paths (exact or prefix) the rule skips.
    """

    id: str = ""
    doc: str = ""
    scope: Optional[tuple] = None
    exclude: tuple = ()

    def applies_to(self, path: str) -> bool:
        if self.scope is not None and not any(
                path.startswith(p) for p in self.scope):
            return False
        return not any(path == e or path.startswith(e.rstrip("/") + "/")
                       for e in self.exclude)

    def check(self, tree: ast.Module, src: str,
              path: str) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, path: str, node, message: str) -> Finding:
        return Finding(self.id, path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0) + 1, message)


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the registry (import-order
    stable; rules_neutral / rules_layering register on import)."""
    rule = cls()
    assert rule.id and rule.id not in RULES, rule.id
    RULES[rule.id] = rule
    return cls


def _ensure_rules_loaded() -> None:
    # rule modules register via the decorator on first import
    from . import rules_layering  # noqa: F401
    from . import rules_neutral  # noqa: F401


def all_rules() -> Dict[str, Rule]:
    _ensure_rules_loaded()
    return dict(RULES)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


def _comment_lines(src: str):
    """(line number, comment text) for every real COMMENT token — a
    pragma mentioned inside a docstring or string literal is
    documentation, not a suppression (tokenize distinguishes them where
    a line regex cannot).  Files that fail to tokenize fall back to the
    raw-line scan; the parse-error finding covers genuinely broken
    files."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, text in enumerate(src.splitlines(), start=1):
            if "#" in text:
                yield i, text[text.index("#"):]


def parse_suppressions(src: str, path: str):
    """(suppressions, pragma_findings): suppressions maps line number ->
    set of rule ids allowed there (a pragma covers its own line and the
    line below, so it can sit above a long statement); pragma_findings
    are bad-pragma diagnostics (missing reason / unparseable form).
    Unknown rule ids are validated by the caller against the registry."""
    sup: Dict[int, set] = {}
    bad: List[Finding] = []
    if "qlint" not in src:
        return sup, bad
    for i, text in _comment_lines(src):
        if "qlint" not in text:
            continue
        m = _PRAGMA_RE.search(text)
        if not m:
            if _PRAGMA_LOOSE_RE.search(text):
                bad.append(Finding(
                    "bad-pragma", path, i, 1,
                    "unparseable qlint pragma — expected "
                    "'# qlint: allow(<rule>): <reason>'"))
            continue
        rule_id, reason = m.group(1), m.group(2)
        if not reason or not reason.strip():
            bad.append(Finding(
                "bad-pragma", path, i, 1,
                f"suppression of '{rule_id}' carries no reason — the "
                f"reason is mandatory"))
            continue
        for ln in (i, i + 1):
            sup.setdefault(ln, set()).add(rule_id)
    return sup, bad


def _validate_pragma_rules(sup: Dict[int, set], path: str,
                           known: Iterable[str]) -> List[Finding]:
    known = set(known) | {"*"}
    out = []
    seen = set()
    for ln in sorted(sup):
        for rid in sorted(sup[ln] - known):
            if (ln - 1, rid) in seen:  # same pragma covers two lines
                continue
            seen.add((ln, rid))
            out.append(Finding(
                "bad-pragma", path, ln, 1,
                f"suppression names unknown rule '{rid}'"))
    return out


# ---------------------------------------------------------------------------
# Per-file analysis
# ---------------------------------------------------------------------------


def analyze_source(src: str, path: str,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) rules over one file's source text, applying
    inline suppressions.  ``path`` is the repo-relative path used for
    rule scoping and reporting; it need not exist on disk (the test
    fixtures analyze snippets)."""
    _ensure_rules_loaded()
    path = path.replace(os.sep, "/")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 0, 1,
                        f"file does not parse: {e.msg}")]
    # one shared node index per file — rules iterate this instead of
    # re-walking the tree (the walk dominates analyzer runtime)
    tree._qlint_all_nodes = list(ast.walk(tree))
    sup, findings = parse_suppressions(src, path)
    findings = list(findings)
    findings += _validate_pragma_rules(sup, path, RULES.keys())
    active = ([RULES[r] for r in rules] if rules is not None
              else RULES.values())
    for rule in active:
        if not rule.applies_to(path):
            continue
        for f in rule.check(tree, src, path):
            if f.rule in sup.get(f.line, ()) or "*" in sup.get(f.line, ()):
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def iter_python_files(paths: Sequence[str] = DEFAULT_WALK,
                      root: str = REPO_ROOT) -> Iterator[str]:
    """Repo-relative paths of every .py file under the walk roots (a root
    holding ``*`` is a glob pattern of files)."""
    for base in paths:
        if "*" in base:
            for p in sorted(glob.glob(os.path.join(root, base))):
                if p.endswith(".py") and os.path.isfile(p):
                    yield os.path.relpath(p, root).replace(os.sep, "/")
            continue
        absbase = os.path.join(root, base)
        if os.path.isfile(absbase):
            yield base.replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(absbase):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    yield rel.replace(os.sep, "/")


def analyze_paths(paths: Sequence[str] = DEFAULT_WALK,
                  root: str = REPO_ROOT,
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_python_files(paths, root):
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            src = f.read()
        findings += analyze_source(src, rel, rules=rules)
    return findings


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str = BASELINE_DEFAULT) -> List[dict]:
    """The committed grandfathered-findings list.  Every entry must name
    rule/path/line and carry a non-empty reason — a reasonless entry is
    rejected (ValueError) so the baseline cannot become a silent dump."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("findings", data) if isinstance(data, dict) else data
    for e in entries:
        if not all(k in e for k in ("rule", "path", "line")):
            raise ValueError(f"baseline entry missing rule/path/line: {e}")
        if not str(e.get("reason", "")).strip():
            raise ValueError(
                f"baseline entry for {e['path']}:{e['line']} ({e['rule']}) "
                f"carries no reason — every grandfathered finding must be "
                f"justified")
    return list(entries)


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[dict]):
    """(new, grandfathered, stale): findings not in the baseline, those
    matched by it, and baseline entries that no longer fire (candidates
    for deletion — reported so the baseline only shrinks)."""
    index = {(e["rule"], e["path"], int(e["line"])): e for e in baseline}
    new, old = [], []
    hit = set()
    for f in findings:
        if f.key() in index:
            hit.add(f.key())
            old.append(f)
        else:
            new.append(f)
    stale = [e for k, e in index.items() if k not in hit]
    return new, old, stale


def write_baseline(findings: Sequence[Finding],
                   path: str = BASELINE_DEFAULT,
                   reason: str = "grandfathered at baseline capture") -> None:
    entries = [{"rule": f.rule, "path": f.path, "line": f.line,
                "reason": reason, "message": f.message}
               for f in sorted(findings, key=lambda f: f.key())]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"findings": entries}, f, indent=2, sort_keys=True)
        f.write("\n")
