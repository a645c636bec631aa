"""Execution introspection (M16d) in the port against the JAX package.

The classes of tests/test_introspect.py: explain_circuit's report key by
key against the reference's on 1 and 8 shards (all but the memory
section's fields that add the port's own pass arrays in), and against
the cost model and the drain's counters; the audit's histograms of the
five contracted wrappers against the reference's audit of its compiled
HLO (chunked too: one collective per chunk in both), the contract check;
CollectiveBudget's pass and fail cases; the reconciliation (drift 0 on a
clean drain, drift detected under perturb_prediction and
QT_INTROSPECT_PERTURB, the reportPerf section); the watermark and the
dispatch floor.  Registers of 6 qubits, float64, on in-process CPU
meshes, the reference on the suite's 8-device mesh (``num_devices=1``
for one register).
"""

import gc
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as qt
from quest_tpu import fusion as RF
from quest_tpu import introspect as RI
from quest_tpu import optimizer as RO
from quest_tpu import telemetry as RT
from quest_tpu.analysis import hlocheck
from quest_tpu.parallel import dist as RD
import quest_tpu_torch as tq
from quest_tpu_torch import batch as PB
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import governor as G
from quest_tpu_torch import introspect
from quest_tpu_torch import optimizer as PO
from quest_tpu_torch import precision
from quest_tpu_torch import telemetry as T
from quest_tpu_torch.analysis import contracts_check
from quest_tpu_torch.contracts import REQUIRED_WRAPPERS
from quest_tpu_torch.parallel import dist
from quest_tpu_torch.parallel import sharded as SH

N = 6
BIT_SETS = [(0, 1), (N - 2, N - 1), (0, 1)]

# memory-section fields that add the port's own pass arrays in
ARRAY_FIELDS = ("pass_array_bytes", "predicted_peak_bytes",
                "predicted_total_bytes", "headroom_bytes")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """The raw planner (the optimizer off, as the reference's suite pins
    it), telemetry on and empty, float64, fresh plan caches and
    governors in both packages."""
    monkeypatch.setenv("QT_OPTIMIZER", "off")
    for var in ("QT_HBM_BUDGET_BYTES", "QT_MEM_POLICY",
                "QT_INTROSPECT_PERTURB", "QT_EXCHANGE_CHUNKS"):
        monkeypatch.delenv(var, raising=False)
    old = precision.get_precision()
    tq.set_precision(2)
    modes = (T.mode_name(), RT.mode_name())
    for tele in (T, RT):
        tele.configure("on")
        tele.reset()
    RO.clear_cache()
    PO._cache.clear()
    RF._plan_cache.clear()
    PF._plan_cache.clear()
    G.reset()
    yield
    T.configure(modes[0])
    RT.configure(modes[1])
    tq.set_precision(old)
    G.reset()


@pytest.fixture(scope="module")
def penv8():
    return tq.createQuESTEnv(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def penv1():
    return tq.createQuESTEnv(device="cpu")


@pytest.fixture(scope="module")
def renv1():
    return qt.createQuESTEnv(num_devices=1)


def _u4(seed=3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    return np.linalg.qr(g)[0]


def _buffered(mod, env, n=N, bit_sets=None, u=None):
    q = mod.createQureg(n, env)
    mod.startGateFusion(q)
    for ts in (bit_sets or BIT_SETS):
        mod.multiQubitUnitary(q, list(ts), u if u is not None else _u4())
    return q


def _model_window_cost(bit_sets, n, nloc, r, itemsize):
    """Independent re-derivation of the drain's window-remap cost."""
    count = nbytes = 0
    segments, final_perm = PC.plan_remap_windows(list(bit_sets), n, nloc,
                                                 None)
    for _ij, sigma, _p in segments:
        if sigma is None:
            continue
        count += dist.remap_exchange_count(sigma, nloc, r)
        nbytes += PC.remap_exchange_bytes(sigma, n, nloc, itemsize)
    return count, nbytes, final_perm


def _comparable(report) -> dict:
    """The report as plain JSON, without the memory fields that hold the
    pass arrays."""
    out = json.loads(json.dumps(report))
    for k in ARRAY_FIELDS:
        out["memory"].pop(k)
    return out


def _stream_gates(n, seed=7):
    """Config 2's shape at n qubits: random 1q unitaries and a CNOT
    ladder, as (targets, SoA matrix) pairs."""
    rng = np.random.default_rng(seed)
    cx = np.zeros((4, 4))
    cx[0, 0] = cx[1, 1] = cx[2, 3] = cx[3, 2] = 1.0
    out = []
    for d in range(3):
        for t in range(n):
            u = np.linalg.qr(rng.normal(size=(2, 2))
                             + 1j * rng.normal(size=(2, 2)))[0]
            out.append(((t,), np.stack([u.real, u.imag])))
        for t in range(d % 2, n - 1, 2):
            out.append(((t, t + 1), np.stack([cx, np.zeros((4, 4))])))
    return out


# ---------------------------------------------------------------------------
# Plan explainer
# ---------------------------------------------------------------------------


class TestExplainCircuit:
    def test_dry_run_does_not_drain(self, penv8):
        q = _buffered(tq, penv8)
        report = tq.explainCircuit(q)
        assert len(q._fusion.gates) == len(BIT_SETS)
        assert report["items"] == len(BIT_SETS)
        assert T.counter_total("fusion_drains_total") == 0
        assert T.counter_total("exchanges_total") == 0
        assert len(PF._plan_cache) == 0

    @pytest.mark.parametrize("case", ["buffer8", "buffer1", "stream8",
                                      "stream1_n16", "replicated8",
                                      "bank8", "optimized8"])
    def test_report_equals_the_reference(self, case, env, penv8, penv1,
                                         renv1, monkeypatch):
        """Key by key: register, windows, final remap, plan-cache status,
        compile section, optimizer section, totals, and the memory
        section but for the pass arrays."""
        # registers of earlier tests that wait in reference cycles for the
        # collector count as resident in one package's ledger and not in
        # the other's
        gc.collect()
        budget = case in ("stream8", "bank8")
        if budget:
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        if case == "optimized8":
            monkeypatch.setenv("QT_OPTIMIZER", "on")
        reports = []
        for mod, e8, e1 in ((qt, env, renv1), (tq, penv8, penv1)):
            if case in ("buffer8", "optimized8"):
                q = _buffered(mod, e8, bit_sets=BIT_SETS + [(1, 5), (2, 4)])
                rep = mod.explainCircuit(q)
            elif case == "buffer1":
                rep = mod.explainCircuit(_buffered(mod, e1))
            elif case == "stream8":
                rep = mod.explainCircuit(mod.createQureg(N, e8),
                                         _stream_gates(N))
            elif case == "stream1_n16":
                rep = mod.explainCircuit(mod.createQureg(16, e1),
                                         _stream_gates(16))
            elif case == "replicated8":
                u = _u4()
                rep = mod.explainCircuit(mod.createQureg(2, e8), [
                    ((0, 1), np.stack([u.real, u.imag]))])
            else:
                bq = mod.createBatchedQureg(N, e8, 3)
                mats = np.stack([_u4(s) for s in range(3)])
                mod.applyBatchedUnitary(bq, (0, 1), mats)
                mod.applyBatchedUnitary(bq, (N - 2, N - 1), mats)
                rep = mod.explainCircuit(bq)
            reports.append(_comparable(rep))
        ref, got = reports
        assert got == ref
        assert got["compile"] == {"aot": "disabled", "aot_enabled": False,
                                  "aot_key": None,
                                  "plan_cache": got["plan"]["cache"]}

    def test_pinned_8shard_dryrun_matches_cost_model_and_counters(
            self, penv8):
        """explainer == cost model == telemetry, exactly, drift 0."""
        q = _buffered(tq, penv8)
        n = N
        r = q.shard_bits
        nloc = n - r
        itemsize = 8
        report = tq.explainCircuit(q)
        count, nbytes, final_perm = _model_window_cost(
            BIT_SETS, n, nloc, r, itemsize)
        assert report["totals"]["exchanges"] == count
        assert report["totals"]["exchange_bytes"] == nbytes
        sigma_read = dist.canonical_sigma(final_perm)
        assert report["final_remap"]["exchanges"] == \
            dist.remap_exchange_count(sigma_read, nloc, r)
        assert report["final_remap"]["exchange_bytes"] == \
            PC.remap_exchange_bytes(sigma_read, n, nloc, itemsize)
        assert report["totals"]["windows"] == 3
        assert report["windows"][0]["sigma"] is None
        assert report["windows"][1]["exchanges"] > 0
        assert report["register"]["shards"] == 8
        T.reset()
        _ = q.amps
        assert T.counter_sum("exchanges_total", op="window_remap") == \
            report["totals"]["exchanges"]
        assert T.counter_sum("exchange_bytes_total", op="window_remap") == \
            report["totals"]["exchange_bytes"]
        assert T.counter_total("exchanges_total") == \
            report["totals"]["exchanges_with_read"]
        assert T.counter_sum("exchange_bytes_total", op="remap") + \
            T.counter_sum("exchange_bytes_total", op="window_remap") == \
            report["totals"]["exchange_bytes_with_read"]
        assert T.counter_total("model_drift_total") == 0
        assert T.counter_total("predicted_exchanges_total") == \
            report["totals"]["exchanges"]
        assert T.counter_total("fusion_windows_total") == \
            report["totals"]["plan_windows"]

    def test_plan_cache_and_retrace_prediction(self, penv8):
        u = _u4()
        q1 = _buffered(tq, penv8, u=u)
        rep1 = tq.explainCircuit(q1)
        assert rep1["plan"]["cacheable"]
        assert rep1["plan"]["cache"] == "miss"
        assert rep1["plan"]["retrace_expected"] is True
        _ = q1.amps  # the drain fills the plan cache
        rep2 = tq.explainCircuit(_buffered(tq, penv8, u=u))
        assert rep2["plan"]["cache"] == "hit"
        assert rep2["plan"]["retrace_expected"] is False

    def test_json_serializable_and_table(self, penv8, capsys):
        q = _buffered(tq, penv8)
        report = tq.explainCircuit(q)
        json.dumps(report)
        table = report.table()
        assert "circuit plan: 6 qubits, 8 shard(s)" in table
        assert "bytes/shard" in table
        assert "totals: plan_windows=" in table
        tq.reportCircuitPlan(q)
        assert "circuit plan" in capsys.readouterr().out

    def test_batched_register_occupancy_and_scaling(self, penv8):
        bsz = 3
        bq = tq.createBatchedQureg(N, penv8, bsz)
        mats = np.stack([_u4(s) for s in range(bsz)])
        tq.applyBatchedUnitary(bq, (0, 1), mats)
        tq.applyBatchedUnitary(bq, (N - 2, N - 1), mats)
        report = tq.explainCircuit(bq)
        occ = report["register"]["batch"]
        assert occ == {"size": 3, "bucket": 4, "occupancy": 0.75}
        r = report["register"]["shard_bits"]
        count, nbytes, _fp = _model_window_cost(
            [(0, 1), (N - 2, N - 1)], N, N - r, r, 8)
        assert report["totals"]["exchanges"] == count * bsz
        assert report["totals"]["exchange_bytes"] == nbytes * bsz
        T.reset()
        _ = bq.amps
        assert T.counter_sum("exchanges_total", op="window_remap") == \
            report["totals"]["exchanges"]
        assert T.counter_total("model_drift_total") == 0

    def test_bank_occupancy_helper(self):
        class Fake:
            batch_size = 5

        assert PB.bank_occupancy(Fake()) == {"size": 5, "bucket": 8,
                                             "occupancy": 5 / 8}
        assert PB.bank_occupancy(object()) == {
            "size": 0, "bucket": 0, "occupancy": 1.0}


# ---------------------------------------------------------------------------
# Audit and the contracts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_histograms():
    """The reference's audit of its five canonical dispatches: the family
    histogram of each compiled program."""
    env = qt.createQuESTEnv()
    return {name: hlocheck._family_histogram(
        RI.audit(fn, amps, donate=donate).collectives)
        for name, (fn, amps, donate) in hlocheck.canonical_cases(env).items()}


def _gate_case(penv8, chunks=None, n=10):
    h = (1 / np.sqrt(2)) * np.array([[1.0, 1], [1, -1]])
    m = np.stack([h, np.zeros((2, 2))])
    amps = np.random.default_rng(0).standard_normal((2, 1 << n))
    amps /= np.sqrt((amps ** 2).sum())
    state = SH.split(penv8.mesh, amps, n - 3, torch.float64)

    def f(a):
        return dist.apply_matrix_1q_sharded(a, m, num_qubits=n,
                                            target=n - 1, chunks=chunks)
    return f, state


class TestAudit:
    @pytest.mark.parametrize("name", REQUIRED_WRAPPERS)
    def test_contracted_wrapper_histograms_equal_the_reference(
            self, name, ref_histograms):
        fn, amps, donate = contracts_check.canonical_cases(
            contracts_check.canonical_env())[name]
        report = introspect.audit(fn, amps, donate=donate)
        assert report.collectives == ref_histograms[name]

    @pytest.mark.parametrize("chunks", [2, 4])
    def test_one_call_per_chunk_as_the_reference_compiles(self, chunks,
                                                          env, penv8):
        """A chunked exchange: one collective-permute per chunk, in the
        reference's compiled HLO and in the port's calls."""
        n = 10
        h = (1 / np.sqrt(2)) * np.array([[1.0, 1], [1, -1]])
        m = np.stack([h, np.zeros((2, 2))])
        a = np.random.default_rng(0).standard_normal((2, 1 << n))
        rrep = RI.audit(lambda x: RD.apply_matrix_1q_sharded(
            x, jnp.asarray(m), mesh=env.mesh, num_qubits=n, target=n - 1,
            chunks=chunks), jax.device_put(jnp.asarray(a),
                                           env.amp_sharding()))
        f, state = _gate_case(penv8, chunks=chunks)
        prep = introspect.audit(f, state)
        assert prep.collectives == \
            hlocheck._family_histogram(rrep.collectives) == \
            {"collective-permute": chunks}

    def test_the_contract_check_passes_and_catches_drift(self):
        assert contracts_check.verify_sharded_contracts() == []
        from quest_tpu_torch.contracts import SHARDED_CONTRACTS
        import dataclasses

        bad = dict(SHARDED_CONTRACTS)
        bad["swap_sharded"] = dataclasses.replace(
            bad["swap_sharded"], collectives={"collective-permute": 2})
        bad["remap_sharded"] = dataclasses.replace(
            bad["remap_sharded"], max_exchange_bytes=256)
        errors = contracts_check.verify_sharded_contracts(contracts=bad)
        assert len(errors) == 2
        assert errors[0].startswith("swap_sharded:")
        assert "max_exchange_bytes=256" in errors[1]
        del bad["gather_replicated"]
        assert "gather_replicated: required wrapper" in \
            contracts_check.verify_sharded_contracts(contracts=bad)[0]

    def test_exact_collective_histogram_and_no_cost(self, penv8):
        f, state = _gate_case(penv8)
        before = [s.clone() for s in state.shards]
        report = introspect.audit(f, state, donate=True)
        assert report.collectives == {"collective-permute": 1}
        assert report.count("collective-permute") == 1
        assert report.total == 1
        assert report.matches.get("collective-permute", 0) >= 1
        assert " collective-permute(" in report.text
        assert report.flops is None and report.bytes_accessed is None
        assert report.cost == {}
        assert report.calls[0]["bytes"] == 2 * 128 * 8
        assert report.tier_counts(4) == {"ici": 0, "dcn": 1}
        assert report.tier_counts(8) == {"ici": 1, "dcn": 0}
        assert isinstance(report.as_dict()["collectives"], dict)
        # the caller's state is as it was: the audit ran on a clone
        assert all(torch.equal(a, b) for a, b in zip(before, state.shards))

    def test_no_collectives_on_local_fn(self):
        report = introspect.audit(lambda x: x * 2.0, torch.ones(8))
        assert report.collectives == {} and report.total == 0

    def test_reads_count_as_the_reference_names_them(self, penv8):
        """A sum over the shards is an all-reduce, a gather an
        all-gather."""
        _f, state = _gate_case(penv8)
        rep = introspect.audit(dist.total_prob_sharded, state)
        assert rep.collectives == {"all-reduce": 1}
        rep = introspect.audit(dist.gather_replicated, state)
        assert rep.collectives == {"all-gather": 1}
        assert rep.calls[0]["bytes"] == 2 * 1024 * 8


class TestCollectiveBudget:
    def _hist(self, **h):
        return {k.replace("_", "-"): v for k, v in h.items()}

    def test_max_budget_passes_and_fails(self):
        b = introspect.CollectiveBudget(collective_permute=2)
        b.check(self._hist(collective_permute=2))
        with pytest.raises(introspect.CollectiveBudgetError):
            b.check(self._hist(collective_permute=3))
        with pytest.raises(introspect.CollectiveBudgetError):
            b.check({"collective-permute": 2,
                     "collective-permute-start": 1})

    def test_exact_total_and_allow(self):
        introspect.CollectiveBudget(
            exact={"all-reduce": 1}).check({"all-reduce": 1})
        with pytest.raises(introspect.CollectiveBudgetError):
            introspect.CollectiveBudget(
                exact={"all-reduce": 1}).check({"all-reduce": 2})
        with pytest.raises(introspect.CollectiveBudgetError):
            introspect.CollectiveBudget(total=1).check(
                self._hist(all_gather=1, all_reduce=1))
        introspect.CollectiveBudget(allow=("all-reduce",)).check(
            {"all-reduce": 4, "all-reduce-start": 1})
        with pytest.raises(introspect.CollectiveBudgetError):
            introspect.CollectiveBudget(allow=("all-reduce",)).check(
                {"all-to-all": 1})

    def test_same_verdicts_as_the_reference(self):
        cases = [({"collective_permute": 1}, {"collective-permute": 1}),
                 ({"collective_permute": 1}, {"collective-permute": 2}),
                 ({"total": 0}, {"all-gather": 1}),
                 ({"allow": ("all-gather",)}, {"all-to-all": 1}),
                 ({"exact": {"all-gather": 1}}, {"all-gather": 1})]
        for kw, hist in cases:
            verdicts = []
            for mod in (RI, introspect):
                try:
                    mod.CollectiveBudget(**kw).check(hist)
                    verdicts.append("pass")
                except AssertionError as e:
                    verdicts.append(str(e).split(" (")[0])
            assert verdicts[0].replace("compiled program has",
                                       "the audited function made") == \
                verdicts[1], kw

    def test_ambient_budget_checks_audits(self, penv8):
        f, state = _gate_case(penv8)
        with introspect.CollectiveBudget(collective_permute=1):
            introspect.audit(f, state, donate=True)
        with pytest.raises(introspect.CollectiveBudgetError):
            with introspect.CollectiveBudget(total=0):
                introspect.audit(f, state, donate=True)
        assert introspect._BUDGET_STACK == []
        introspect.audit(f, state, donate=True)


# ---------------------------------------------------------------------------
# Reconciliation and drift injection
# ---------------------------------------------------------------------------


def _drain(env):
    q = _buffered(tq, env)
    _ = q.amps
    return q


class TestReconciliation:
    def test_clean_drain_zero_drift_no_log(self, penv8, caplog):
        with caplog.at_level(logging.INFO,
                             logger="quest_tpu_torch.introspect"):
            _drain(penv8)
        assert T.counter_total("model_drift_total") == 0
        assert T.counter_total("predicted_exchanges_total") > 0
        assert caplog.records == []

    def test_predictions_equal_the_reference(self, env, penv8):
        rq = _buffered(qt, env)
        _ = rq.amps
        _drain(penv8)
        for name in ("predicted_exchanges_total",
                     "predicted_exchange_bytes_total"):
            assert T.snapshot()["counters"][name] == \
                RT.snapshot()["counters"][name]
        assert RT.counter_total("model_drift_total") == \
            T.counter_total("model_drift_total") == 0

    def test_forced_chunk_override_detected_as_drift(self, penv8, caplog):
        with caplog.at_level(logging.WARNING,
                             logger="quest_tpu_torch.introspect"):
            with introspect.perturb_prediction(chunks="4"):
                _drain(penv8)
        assert T.counter_value("model_drift_total", kind="chunks") == 1
        lines = [rec for rec in caplog.records
                 if rec.name == "quest_tpu_torch.introspect"]
        assert len(lines) == 1
        payload = json.loads(lines[0].getMessage())
        assert payload["event"] == "model_drift"
        assert payload["kinds"] == ["chunks"]
        assert payload["drift"]["chunks"]["predicted"] == "4"

    def test_scaled_prediction_drifts_on_count_and_bytes(self, penv8,
                                                         caplog):
        with caplog.at_level(logging.WARNING,
                             logger="quest_tpu_torch.introspect"):
            with introspect.perturb_prediction(scale=2):
                _drain(penv8)
        assert T.counter_value("model_drift_total", kind="count") == 1
        assert T.counter_value("model_drift_total", kind="bytes") == 1
        lines = [rec for rec in caplog.records
                 if rec.name == "quest_tpu_torch.introspect"]
        assert len(lines) == 1
        assert json.loads(lines[0].getMessage())["kinds"] == \
            ["bytes", "count"]

    def test_env_var_perturbation(self, penv8, monkeypatch):
        monkeypatch.setenv("QT_INTROSPECT_PERTURB", "scale=3")
        _drain(penv8)
        assert T.counter_total("model_drift_total") >= 1

    def test_governor_chunk_escalation_reconciles(self, penv8, monkeypatch):
        """Under the ladder's chunk rung the remaps, their counters and the
        prediction all see the escalated chunk key: drift 0."""
        n = 13
        q = tq.createQureg(n, penv8)
        state = G.register_bytes_per_device(q)
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(int(2.75 * state)))
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with tq.gateFusion(q):
                tq.multiQubitUnitary(q, [0, 1], _u4())
                tq.multiQubitUnitary(q, [n - 2, n - 1], _u4())
        assert T.counter_value("governor_degradations_total",
                               rung="chunks") == 1
        assert T.counter_sum("exchanges_total", op="window_remap",
                             chunks="4") > 0
        assert T.counter_total("model_drift_total") == 0
        assert dist._GOVERNOR_CHUNKS[0] is None

    def test_perf_report_reconciliation_section(self, penv8):
        _drain(penv8)
        text = T.perf_report()
        assert "reconciliation (window remaps, predicted vs measured):" \
            in text
        assert "cost model holds" in text
        pred = T.counter_sum("predicted_exchanges_total", op="window_remap")
        assert f"exchanges: predicted={int(pred)}" in text

    def test_perf_report_flags_drift(self, penv8):
        with introspect.perturb_prediction(scale=2):
            _drain(penv8)
        assert "MODEL DRIFT" in T.perf_report()


# ---------------------------------------------------------------------------
# The watermark and the dispatch floor
# ---------------------------------------------------------------------------


class TestWatermark:
    def test_drain_samples_watermark_gauge(self, penv8):
        _drain(penv8)
        peak = T.gauge_max("hbm_watermark_bytes")
        assert peak is not None and peak > 0

    def test_environment_string_surfaces_peak(self, penv8):
        _drain(penv8)
        s = tq.getEnvironmentString(penv8)
        assert f"HbmPeak={int(T.gauge_max('hbm_watermark_bytes'))}" in s

    def test_perf_report_memory_line(self, penv8):
        _drain(penv8)
        assert "memory: hbm_watermark_bytes peak=" in T.perf_report()

    def test_gauge_gated_by_mode(self, penv8):
        T.configure("off")
        _drain(penv8)
        T.configure("on")
        assert T.gauge_max("hbm_watermark_bytes") is None


class TestDispatchFloor:
    def test_floor_is_measured_and_reported(self, penv1):
        floor = introspect.measure_dispatch_floor(16, penv1)
        assert 0 < floor < 1.0
        assert T.gauge_max("per_program_dispatch_seconds") == floor
        q = tq.createQureg(4, penv1)
        with tq.gateFusion(q):
            tq.hadamard(q, 0)
        assert "dispatch floor:" in T.perf_report()
        assert introspect.measure_dispatch_floor(8, q) > 0
