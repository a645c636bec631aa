"""qlint of the port (M16f: quest_tpu_torch/analysis), modelled on
tests/test_analysis.py.

* **Fixture corpus**: one minimal snippet per rule, written as a string
  literal (the reference's analyzer walks this file too): the rule flags
  its fixture and only its rule fires, and a corrected twin stays clean.
* **Engine mechanics**: pragma parsing (the reason is mandatory,
  docstrings do not count, unknown rule ids are rejected), the baseline
  (reasons mandatory, stale entries surfaced) and the CLI's options.
* **The vocabulary**: every rule id is the reference's, letter for
  letter; the rules the port leaves out are absent; the fault-plan
  rule's kinds are the port's ``FaultPlan._KINDS``.
* **The tree itself**: the port's walk (``quest_tpu_torch/`` and
  ``tests/test_torch_*.py``) comes back with zero unsuppressed findings,
  every baseline entry carries a reason, and the reference's analyzer
  still finds nothing over its own walk, this suite's files included.
"""

import json
import subprocess
import sys
import textwrap

import pytest

from quest_tpu.analysis import engine as REF
from quest_tpu_torch import contracts as PCON
from quest_tpu_torch import resilience as PR
from quest_tpu_torch.analysis import __main__ as CLI
from quest_tpu_torch.analysis import engine
from quest_tpu_torch.analysis import rules_neutral


def run(src, path="quest_tpu_torch/fake.py", rules=None):
    return engine.analyze_source(textwrap.dedent(src), path, rules=rules)


def rule_ids(findings):
    return sorted(f.rule for f in findings)


class TestVocabulary:
    def test_rule_ids_are_the_references(self):
        ours = set(engine.all_rules())
        assert ours == {"layer-violation", "collective-outside-dist",
                        "contract-missing", "nondeterminism",
                        "fault-plan-spec", "broad-except", "oom-swallow"}
        assert ours <= set(REF.all_rules())

    def test_the_left_out_rules_are_absent_and_named(self):
        left = {"host-sync-in-traced", "tracer-branch",
                "telemetry-in-traced", "f64-literal"}
        assert not left & set(engine.all_rules())
        for rid in left:
            assert rid in rules_neutral.__doc__

    def test_fault_kinds_are_the_ports(self):
        kinds = engine.all_rules()["fault-plan-spec"].KINDS
        assert set(kinds) == set(PR.FaultPlan._KINDS)
        assert set(kinds) == set(REF.all_rules()["fault-plan-spec"].KINDS)


class TestNondeterminism:
    def test_wall_clock_flagged(self):
        fs = run(
            """
            import time

            def stamp():
                return time.time()
            """)
        assert rule_ids(fs) == ["nondeterminism"]

    @pytest.mark.parametrize("call", [
        "np.random.default_rng().random()", "np.random.rand(3)",
        "random.random()"])
    def test_unseeded_sources_flagged(self, call):
        fs = run(
            f"""
            import random
            import numpy as np

            def draw():
                return {call}
            """)
        assert rule_ids(fs) == ["nondeterminism"]

    def test_seeded_generator_clean(self):
        fs = run(
            """
            import numpy as np

            def draw(seed):
                return np.random.default_rng(seed).random()
            """)
        assert fs == []

    def test_rule_scoped_to_the_package(self):
        fs = run(
            """
            import time

            def stamp():
                return time.time()
            """,
            path="tests/test_torch_fake.py")
        assert fs == []


class TestFaultPlanSpec:
    def test_unknown_kind_flagged(self):
        fs = run(
            """
            from quest_tpu_torch import resilience as R

            plan = R.FaultPlan("kill@1,explode@2")
            """,
            path="tests/test_torch_fake.py")
        assert rule_ids(fs) == ["fault-plan-spec"]
        assert "explode" in fs[0].message

    def test_non_integer_argument_flagged(self):
        fs = run(
            """
            from quest_tpu_torch.resilience import FaultPlan

            plan = FaultPlan("kill@soon")
            """)
        assert rule_ids(fs) == ["fault-plan-spec"]

    def test_registered_and_dynamic_specs_clean(self):
        fs = run(
            """
            from quest_tpu_torch.resilience import FaultPlan

            def plans(spec):
                return (FaultPlan("killsave@1,io@2,poison_job@3,heal@4"),
                        FaultPlan(spec))
            """)
        assert fs == []


class TestBroadExcept:
    def test_bare_and_broad_flagged(self):
        fs = run(
            """
            def f(g):
                try:
                    return g()
                except Exception:
                    return None

            def h(g):
                try:
                    return g()
                except:
                    return None
            """)
        assert rule_ids(fs) == ["broad-except", "broad-except"]

    def test_cleanup_and_reraise_clean(self):
        fs = run(
            """
            def f(g, undo):
                try:
                    return g()
                except BaseException:
                    undo()
                    raise
            """)
        assert fs == []

    def test_narrow_except_clean(self):
        fs = run(
            """
            def f(g):
                try:
                    return g()
                except (ValueError, OSError):
                    return None
            """)
        assert fs == []


class TestOomSwallow:
    SRC = """
        import torch

        def f(g):
            try:
                return g()
            except RuntimeError as e:
                if isinstance(e, torch.OutOfMemoryError):
                    return None
                raise
        """

    def test_oom_handling_outside_governor_flagged(self):
        assert rule_ids(run(self.SRC)) == ["oom-swallow"]

    def test_cuda_spelling_flagged(self):
        fs = run(
            """
            import torch

            def f(g):
                try:
                    return g()
                except torch.cuda.OutOfMemoryError:
                    return None
            """)
        assert rule_ids(fs) == ["oom-swallow"]

    def test_governor_exempt(self):
        assert run(self.SRC, path="quest_tpu_torch/governor.py") == []


class TestLayerViolation:
    def test_upward_import_flagged(self):
        fs = run(
            """
            from quest_tpu_torch import api
            """,
            path="quest_tpu_torch/ops/fake.py")
        assert rule_ids(fs) == ["layer-violation"]
        assert "upward" in fs[0].message

    def test_api_lateral_import_flagged(self):
        fs = run(
            """
            from quest_tpu_torch import debug
            """,
            path="quest_tpu_torch/api.py")
        assert rule_ids(fs) == ["layer-violation"]
        assert "API functions must not call each other" in fs[0].message

    def test_shared_module_importing_layered_flagged(self):
        fs = run(
            """
            from . import fusion
            """,
            path="quest_tpu_torch/qureg.py")
        assert rule_ids(fs) == ["layer-violation"]

    @pytest.mark.parametrize("path,src", [
        ("quest_tpu_torch/fusion.py", "from . import aotcache"),
        ("quest_tpu_torch/interop.py", "from .circuit import plan_to_device"),
        ("quest_tpu_torch/aotcache.py", "from . import telemetry"),
        ("quest_tpu_torch/parallel/mesh.py",
         "from ..validation import QuESTError"),
        ("quest_tpu_torch/utils/profiling.py", "from .. import telemetry"),
        ("quest_tpu_torch/probes/profile_dma.py", "from ..ops import stream"),
        ("quest_tpu_torch/probes/kernel_microbench.py", "from . import common"),
    ])
    def test_the_ports_extra_modules_sit_in_the_dag(self, path, src):
        assert run(src, path=path) == []

    @pytest.mark.parametrize("path,src", [
        ("quest_tpu_torch/aotcache.py", "from . import fusion"),
        ("quest_tpu_torch/ops/build.py", "from .. import circuit"),
        ("quest_tpu_torch/utils/profiling.py", "from .. import governor"),
        ("quest_tpu_torch/interop.py", "from . import serve"),
        ("quest_tpu_torch/probes/common.py", "from .. import api"),
    ])
    def test_the_ports_extra_modules_cannot_import_upward(self, path, src):
        assert rule_ids(run(src, path=path)) == ["layer-violation"]

    def test_lazy_function_scope_import_not_flagged(self):
        fs = run(
            """
            def helper():
                from quest_tpu_torch import api
                return api
            """,
            path="quest_tpu_torch/ops/fake.py")
        assert fs == []


class TestCollectiveOutsideDist:
    @pytest.mark.parametrize("body", [
        "import torch.distributed as dist\n\ndef f(t):\n"
        "    dist.all_reduce(t)\n",
        "import torch\n\ndef f(t):\n    torch.distributed.barrier()\n",
        "from torch.distributed import broadcast\n\ndef f(t):\n"
        "    broadcast(t, 0)\n",
        "from torch import distributed as td\n\ndef f(t):\n"
        "    td.send(t, 1)\n",
        "def f(amps, t):\n    return amps.mesh.permute([t], [(0, 1)])\n",
        "def f(mesh, t):\n    return mesh.sum([t])\n",
        "def f(self, xs):\n    return self._mesh.exchange(xs, [])\n",
        "def f(x):\n    return x.all_gather([x])\n",
    ])
    def test_collective_callsite_flagged(self, body):
        fs = run(body, path="quest_tpu_torch/api.py")
        assert rule_ids(fs) == ["collective-outside-dist"]
        assert rule_ids(run(body, path="tests/test_torch_fake.py")) == [
            "collective-outside-dist"]

    def test_lifecycle_tensor_sums_and_barrier_clean(self):
        fs = run(
            """
            import torch.distributed as dist

            def f(t, mesh):
                dist.init_process_group("gloo")
                n = dist.get_world_size() + dist.get_rank()
                mesh.barrier()
                dist.destroy_process_group()
                return t.sum() + n
            """)
        assert fs == []

    def test_a_rebound_name_is_not_torch_distributed(self):
        fs = run(
            """
            import torch.distributed as dist

            def key():
                from .parallel import dist
                return dist.exchange_config_key()
            """)
        assert fs == []

    def test_exchange_layer_exempt(self):
        fs = run(
            """
            import torch.distributed as dist

            def f(mesh, t):
                dist.all_reduce(t)
                return mesh.gather([t])
            """,
            path="quest_tpu_torch/parallel/mesh.py")
        assert fs == []


class TestContractMissing:
    def test_undeclared_wrapper_flagged(self):
        fs = run(
            """
            def swap_sharded(amps):
                return amps
            """,
            path="quest_tpu_torch/parallel/dist.py")
        assert rule_ids(fs) == ["contract-missing"]

    def test_decorated_wrapper_clean(self):
        fs = run(
            """
            from ..contracts import sharded_contract

            @sharded_contract(collectives={"collective-permute": 1},
                              max_exchange_bytes=1024)
            def mix_pair_channel_sharded(amps):
                return amps
            """,
            path="quest_tpu_torch/parallel/composites.py")
        assert fs == []

    def test_the_wrappers_are_the_ports(self):
        from quest_tpu_torch.parallel import composites  # noqa: F401
        from quest_tpu_torch.parallel import dist  # noqa: F401

        assert set(PCON.SHARDED_CONTRACTS) == set(PCON.REQUIRED_WRAPPERS)


class TestParseError:
    def test_broken_file_reports_parse_error(self):
        assert rule_ids(run("def f(:\n")) == ["parse-error"]


class TestSuppressions:
    SRC = """
        import time

        def stamp():
            # qlint: allow(nondeterminism): recorded upstream
            return time.time()
        """

    def test_pragma_suppresses_next_line(self):
        assert run(self.SRC) == []

    def test_pragma_on_same_line_suppresses(self):
        fs = run(
            """
            import time

            def stamp():
                return time.time()  # qlint: allow(nondeterminism): logged
            """)
        assert fs == []

    def test_reasonless_pragma_is_a_finding(self):
        fs = run(
            """
            import time

            def stamp():
                # qlint: allow(nondeterminism)
                return time.time()
            """)
        assert rule_ids(fs) == ["bad-pragma", "nondeterminism"]

    @pytest.mark.parametrize("rid", ["no-such-rule", "f64-literal"])
    def test_unknown_rule_id_is_a_finding(self, rid):
        fs = run(
            f"""
            def f():
                # qlint: allow({rid}): whatever
                return 1
            """)
        assert rule_ids(fs) == ["bad-pragma"]
        assert rid in fs[0].message

    def test_pragma_in_docstring_does_not_suppress(self):
        fs = run(
            '''
            import time

            def stamp():
                """Docs may show '# qlint: allow(nondeterminism): x'."""
                return time.time()
            ''')
        assert rule_ids(fs) == ["nondeterminism"]

    def test_wildcard_pragma_suppresses_all(self):
        fs = run(
            """
            import time

            def stamp():
                # qlint: allow(*): fixture exercising the wildcard
                return time.time()
            """)
        assert fs == []


class TestBaseline:
    def test_reasonless_entry_rejected(self, tmp_path):
        p = tmp_path / "baseline.json"
        p.write_text(json.dumps({"findings": [
            {"rule": "broad-except", "path": "x.py", "line": 3}]}))
        with pytest.raises(ValueError, match="no reason"):
            engine.load_baseline(str(p))

    def test_apply_baseline_splits_new_old_stale(self):
        f1 = engine.Finding("broad-except", "a.py", 3, 1, "m")
        f2 = engine.Finding("broad-except", "b.py", 9, 1, "m")
        baseline = [
            {"rule": "broad-except", "path": "a.py", "line": 3,
             "reason": "grandfathered"},
            {"rule": "oom-swallow", "path": "gone.py", "line": 1,
             "reason": "file was deleted"},
        ]
        new, old, stale = engine.apply_baseline([f1, f2], baseline)
        assert new == [f2]
        assert old == [f1]
        assert [e["path"] for e in stale] == ["gone.py"]

    def test_write_then_load_round_trips(self, tmp_path):
        p = str(tmp_path / "b.json")
        fs = run("import time\n\ndef f():\n    return time.time()\n")
        engine.write_baseline(fs, p, reason="a fixture")
        back = engine.load_baseline(p)
        assert [(e["rule"], e["line"], e["reason"]) for e in back] == [
            ("nondeterminism", 4, "a fixture")]
        assert engine.apply_baseline(fs, back)[0] == []

    def test_committed_baseline_lives_in_the_port_with_reasons(self):
        assert engine.BASELINE_DEFAULT.endswith(
            "quest_tpu_torch/analysis/baseline.json")
        for e in engine.load_baseline():
            assert str(e["reason"]).strip()


class TestCli:
    def test_findings_exit_1_and_json(self, monkeypatch, capsys):
        f = engine.Finding("broad-except", "quest_tpu_torch/x.py", 3, 1,
                           "m")
        monkeypatch.setattr(CLI.engine, "analyze_paths",
                            lambda walk, rules=None: [f])
        assert CLI.main(["--no-baseline"]) == 1
        assert f.format() in capsys.readouterr().out
        assert CLI.main(["--no-baseline", "--json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert [x["rule"] for x in out["findings"]] == ["broad-except"]

    def test_unknown_rule_is_a_usage_error(self, capsys):
        assert CLI.main(["--rules", "no-such-rule"]) == 2

    def test_list_rules(self, capsys):
        assert CLI.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        assert all(rid in out for rid in engine.all_rules())

    def test_write_baseline_then_clean(self, tmp_path, capsys):
        p = str(tmp_path / "b.json")
        assert CLI.main(["--rules", "nondeterminism", "--baseline", p,
                         "--write-baseline"]) == 0
        assert CLI.main(["--rules", "nondeterminism", "--baseline", p]) == 0


class TestFullTree:
    def test_the_walk_is_the_port_and_its_tests(self):
        files = list(engine.iter_python_files())
        assert "quest_tpu_torch/fusion.py" in files
        assert "tests/test_torch_analysis.py" in files
        assert not any(f.startswith("quest_tpu/") for f in files)
        assert all(f.startswith(("quest_tpu_torch/", "tests/test_torch_"))
                   for f in files)

    def test_zero_unsuppressed_findings(self):
        findings = engine.analyze_paths()
        new, _old, stale = engine.apply_baseline(findings,
                                                 engine.load_baseline())
        assert new == [], "\n".join(f.format() for f in new)
        assert stale == [], f"stale baseline entries: {stale}"

    def test_the_cli_exits_0(self):
        res = subprocess.run(
            [sys.executable, "-m", "quest_tpu_torch.analysis"],
            capture_output=True, text=True, timeout=300,
            cwd=engine.REPO_ROOT)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "qlint: 0 finding(s)" in res.stdout

    def test_the_references_walk_stays_clean(self):
        """The reference's analyzer walks tests/, this suite's files
        included: zero findings there too."""
        new, _old, _stale = REF.apply_baseline(REF.analyze_paths(),
                                               REF.load_baseline())
        assert new == [], "\n".join(f.format() for f in new)
