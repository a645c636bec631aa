"""Static and runtime checks of the port (the JAX package's
``analysis/``).

* ``python -m quest_tpu_torch.analysis``: qlint over ``quest_tpu_torch/``
  and ``tests/test_torch_*.py``, the framework-neutral rules
  (``rules_neutral``: nondeterminism, fault-plan-spec, broad-except,
  oom-swallow; ``rules_layering``: layer-violation,
  collective-outside-dist, contract-missing), with the reference's
  pragmas, ``bad-pragma``, ``parse-error`` and a baseline
  (``baseline.json``).  Exit 1 on findings, 2 on usage or baseline
  errors; ``--contracts`` also runs ``contracts_check``.
* ``contracts_check`` verifies every ``@sharded_contract`` against the
  exchange calls its canonical dispatch makes.
* :func:`analyze_paths` / :func:`analyze_source`: the library API
  (tests/test_torch_analysis.py).
"""

from .engine import (  # noqa: F401
    BASELINE_DEFAULT,
    DEFAULT_WALK,
    Finding,
    REPO_ROOT,
    Rule,
    all_rules,
    analyze_paths,
    analyze_source,
    apply_baseline,
    iter_python_files,
    load_baseline,
    register,
    write_baseline,
)
