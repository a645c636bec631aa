"""The persistent plan cache (M16f: quest_tpu_torch/aotcache.py) and the
serving layer's warm pool on it, the port's counterpart of
tests/test_aotcache.py, on the CPU at 4 to 8 qubits.

The port persists plans where the JAX package persists compiled
executables; the contracts are the reference's:

- a drain's plan is stored on a miss and loaded on a hit: a simulated
  fresh process (memory tier, device copies and memory keys dropped)
  and a real subprocess drain from the disk with results bit-identical,
  the loaded program identical to the planned one, and a bank window
  one load;
- the invalidation matrix: the precision mode, the planner, megawin
  planning, the side split, the topology signature, a spoofed toolchain
  tag and an edit to a planner source each miss and re-plan;
- a corrupt or truncated entry is a counted error with a degradation
  recorded and the entry replaced, the result bit-identical;
- mtime-LRU eviction under QT_AOT_CACHE_MAX_BYTES, and the reference's
  ``*.aot`` entries in a shared directory never counted, evicted or
  deleted;
- explainCircuit's ``compile`` prediction (miss -> memory -> hit) pinned
  drift-0 against the counters the drain then moves, the sequence the
  reference reports run the same way;
- the warm pool: the live and half-mesh specs on an in-process mesh,
  ``_prewarm_one``'s statuses against the reference's, ``warm_from``
  booting a replica that plans nothing, and the port's own failover pin:
  a degraded-mesh drain after prewarm plans nothing (no ``fusion.plan``
  span, no put);
- the environment-string fragment and the telemetry fold.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import quest_tpu as qt
import quest_tpu.circuit as RC
from quest_tpu import aotcache as RA
from quest_tpu import serve as RS
import quest_tpu_torch as tq
from quest_tpu_torch import aotcache as A
from quest_tpu_torch import batch as PB
from quest_tpu_torch import circuit as C
from quest_tpu_torch import fusion as F
from quest_tpu_torch import introspect as I
from quest_tpu_torch import precision
from quest_tpu_torch import resilience as R
from quest_tpu_torch import serve as S
from quest_tpu_torch import telemetry as T
from quest_tpu_torch.env import shrink_env
from quest_tpu_torch.ops import fused as _fused
from quest_tpu_torch.parallel import sharded as SH

N = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear_process_tiers():
    """Simulate a fresh process: drop the plans, their device copies and
    the memory keys, so the next drain must consult the disk tier."""
    F.clear_plan_caches()
    A._MEMORY_KEYS.clear()


@pytest.fixture(autouse=True)
def double(monkeypatch):
    for var in ("QT_AOT_CACHE", "QT_AOT_CACHE_MAX_BYTES", "QT_PLANNER",
                "QT_MEGAKERNEL", "QT_SIDE_SPLIT", "QT_TOPOLOGY"):
        monkeypatch.delenv(var, raising=False)
    old = precision.get_precision()
    tq.set_precision(2)
    T.configure("on")
    T.reset()
    yield
    tq.set_precision(old)
    T.reset()


@pytest.fixture
def aot(tmp_path, monkeypatch):
    d = str(tmp_path / "aot")
    monkeypatch.setenv("QT_AOT_CACHE", d)
    _clear_process_tiers()
    A.reset_stats()
    yield d
    _clear_process_tiers()
    A.reset_stats()
    R.DEGRADATIONS.pop("aot_cache_corrupt", None)


def _env(R_=1):
    return tq.createQuESTEnv(devices=["cpu"] * R_) if R_ > 1 \
        else tq.createQuESTEnv(device="cpu")


def _host(q):
    a = q.amps
    return a.clone() if isinstance(a, torch.Tensor) \
        else torch.from_numpy(SH.gather_host(a))


def _gates(mod, q, n, theta):
    for k in range(n):
        mod.hadamard(q, k)
        mod.rotateZ(q, k, theta + 0.1 * k)
    for k in range(n - 1):
        mod.controlledNot(q, k, k + 1)


def _drain(env, n=N, theta=0.3):
    q = tq.createQureg(n, env)
    with tq.gateFusion(q):
        _gates(tq, q, n, theta)
    return _host(q)


def _plan_spans() -> int:
    h = T.snapshot()["histograms"].get("span_seconds", {})
    return h.get("name=fusion.plan", {}).get("count", 0)


def _entries(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".qtplan"))


class TestRoundTrip:
    def test_persist_on_miss_then_fresh_process_hit_bitident(self, aot):
        env = _env()
        a1 = _drain(env)
        s1 = A.stats()
        assert (s1["puts"], s1["misses"], s1["hits"]) == (1, 1, 0)
        assert s1["bytes"] > 0 and s1["memory_keys"] == 1
        assert len(_entries(aot)) == len(os.listdir(aot)) == 1
        _clear_process_tiers()
        spans = _plan_spans()
        a2 = _drain(env)
        s2 = A.stats()
        assert s2["hits"] == 1 and s2["puts"] == 1
        assert s2["saved_seconds"] > 0
        assert _plan_spans() == spans   # the drain planned nothing
        assert torch.equal(a1, a2)

    def test_the_loaded_program_is_the_planned_one(self, aot):
        env = _env()
        _drain(env)
        (key, planned), = F._plan_cache.items()
        payload, meta = A.load(A.plan_key_digest(key))
        assert meta["plan_seconds"] > 0
        sk1, arr1 = F._program_split(planned)
        sk2, arr2 = F._program_split(payload)
        assert sk1 == sk2 and len(arr1) == len(arr2) > 0
        for x, y in zip(arr1, arr2):
            assert isinstance(y, np.ndarray)
            assert x.dtype == y.dtype and np.array_equal(x, y)

    def test_plan_info_names_the_drains_plan_and_records_nothing(
            self, aot):
        env = _env()
        q = tq.createQureg(N, env)
        tq.startGateFusion(q)
        _gates(tq, q, N, 0.3)
        base = A.stats()
        info = F.aot_plan_info(q, list(q._fusion.gates))
        assert A.stats() == base and len(F._plan_cache) == 0
        assert (info["nloc"], info["nsh"], info["batch_flag"]) == (N, 0, 0)
        tq.stopGateFusion(q)
        (key, planned), = F._plan_cache.items()
        assert info["key"] == key
        assert F._program_split(info["program"])[0] == \
            F._program_split(planned)[0]
        assert F.aot_plan_info(q, []) is None

    def test_disabled_is_a_pass_through(self, tmp_path):
        _clear_process_tiers()
        A.reset_stats()
        env = _env()
        a1 = _drain(env)
        s = A.stats()
        assert not s["enabled"] and s["dir"] is None
        assert (s["hits"], s["misses"], s["puts"]) == (0, 0, 0)
        assert A.load("0" * 64) is None
        assert not A.store("0" * 64, (), 1.0)
        _clear_process_tiers()
        assert torch.equal(_drain(env), a1)

    def test_a_sharded_bank_window_is_one_load(self, aot):
        """A flag-2 bank (per-element matrices) on 4 in-process shards:
        the bank's program is one entry, loaded whole."""
        env = _env(4)
        rng = np.random.default_rng(5)

        def run():
            q = tq.createBatchedQureg(6, env, 4)
            mats = np.stack([np.linalg.qr(
                rng.standard_normal((2, 2))
                + 1j * rng.standard_normal((2, 2)))[0] for _ in range(4)])
            with tq.gateFusion(q):
                tq.hadamard(q, 0)
                tq.applyBatchedUnitary(q, (5,), mats)
                tq.controlledNot(q, 5, 1)
            return SH.gather_host(q.amps)

        rng = np.random.default_rng(5)
        b1 = run()
        assert A.stats()["puts"] == 1
        _clear_process_tiers()
        rng = np.random.default_rng(5)
        b2 = run()
        s = A.stats()
        assert (s["hits"], s["puts"]) == (1, 1)
        assert np.array_equal(b1, b2)


def _flip_precision():
    old = _fused.matmul_precision_name()
    other = "bf16_3x" if old != "bf16_3x" else "highest"
    return (lambda: _fused.set_matmul_precision(other),
            lambda: _fused.set_matmul_precision(old))


class TestInvalidationMatrix:
    def _flip_and_expect_miss(self, flip, unflip, env=None, n=N):
        env = env or _env()
        _drain(env, n)
        base = A.stats()
        try:
            flip()
            _clear_process_tiers()
            _drain(env, n)
        finally:
            unflip()
        s = A.stats()
        assert s["hits"] == base["hits"], "a flip must not hit an entry"
        assert s["misses"] > base["misses"]
        assert s["puts"] > base["puts"]   # planned and persisted anew
        # and flipped back, the first entry hits again
        _clear_process_tiers()
        _drain(env, n)
        assert A.stats()["hits"] == base["hits"] + 1

    def test_precision_mode_flip_misses(self, aot):
        self._flip_and_expect_miss(*_flip_precision())

    @pytest.mark.parametrize("var,value", [
        ("QT_PLANNER", "paged"), ("QT_MEGAKERNEL", "on"),
        ("QT_SIDE_SPLIT", "1")])
    def test_planning_knob_flip_misses(self, aot, monkeypatch, var, value):
        self._flip_and_expect_miss(
            lambda: monkeypatch.setenv(var, value),
            lambda: monkeypatch.delenv(var, raising=False))

    def test_topology_signature_flip_misses(self, aot, monkeypatch):
        from quest_tpu_torch.parallel import topology as _topo

        sig0 = _topo.signature(4)
        monkeypatch.setenv("QT_TOPOLOGY", "2x2")
        assert _topo.signature(4) != sig0
        monkeypatch.delenv("QT_TOPOLOGY")
        self._flip_and_expect_miss(
            lambda: monkeypatch.setenv("QT_TOPOLOGY", "2x2"),
            lambda: monkeypatch.delenv("QT_TOPOLOGY", raising=False),
            env=_env(4), n=6)

    def test_spoofed_toolchain_tag_misses(self, aot):
        self._flip_and_expect_miss(
            lambda: A._VERSION_OVERRIDE.__setitem__(0, "torch-99-spoof"),
            lambda: A._VERSION_OVERRIDE.__setitem__(0, None))

    def test_an_edit_to_a_planner_source_misses(self, aot, tmp_path,
                                                monkeypatch):
        copy = tmp_path / "fusion_copy.py"
        shutil.copy(os.path.join(REPO, "quest_tpu_torch", "fusion.py"),
                    copy)
        monkeypatch.setattr(A, "_PLAN_SOURCES",
                            list(A._PLAN_SOURCES) + [str(copy)])
        original = copy.read_bytes()
        self._flip_and_expect_miss(
            lambda: copy.write_bytes(original + b"\n# an edit\n"),
            lambda: copy.write_bytes(original))

    def test_the_key_holds_every_plan_knob(self):
        """Every knob the drain's plan depends on is a field of the memory
        tier's key, which the disk key hashes whole."""
        it = [C.Gate((0,), np.stack([np.eye(2), np.zeros((2, 2))]))]
        key = F._plan_key(it, 4, False, None, (0, 0))
        assert key[:6] == (4, False, C.resolve_planner(),
                           _fused.megakernel_planning(None),
                           C._side_split_enabled(),
                           _fused.matmul_precision_name())


class TestCorruption:
    @pytest.mark.parametrize("how", ["magic", "checksum", "truncated",
                                     "other_key"])
    def test_a_bad_entry_replans_counted_and_bitident(self, aot, how):
        env = _env()
        a1 = _drain(env)
        base = A.stats()
        (name,) = _entries(aot)
        path = os.path.join(aot, name)
        blob = open(path, "rb").read()
        if how == "magic":
            blob = b"garbage!" + blob[8:]
        elif how == "checksum":
            blob = blob[:-1] + bytes([blob[-1] ^ 0xFF])
        elif how == "truncated":
            blob = blob[:len(blob) // 2]
        else:
            # a whole entry, but of another key: the key echo rejects it
            other = A._decode(blob, name[:-len(".qtplan")])
            other["key"] = "f" * 64
            body = pickle.dumps(other)
            import hashlib

            blob = A._MAGIC + hashlib.sha256(body).digest() + body
        with open(path, "wb") as f:
            f.write(blob)
        _clear_process_tiers()
        a2 = _drain(env)
        s = A.stats()
        assert s["errors"] == base["errors"] + 1
        assert s["hits"] == base["hits"]   # a bad entry never hits
        assert s["puts"] == base["puts"] + 1   # planned and stored anew
        assert "aot_cache_corrupt" in R.degradation_report()
        assert open(path, "rb").read() != blob   # the entry was replaced
        assert torch.equal(a1, a2)
        _clear_process_tiers()
        assert torch.equal(_drain(env), a1)
        assert A.stats()["hits"] == base["hits"] + 1

    def test_a_dry_run_leaves_a_bad_entry_to_the_drain(self, aot):
        env = _env()
        _drain(env)
        (name,) = _entries(aot)
        path = os.path.join(aot, name)
        with open(path, "r+b") as f:
            f.write(b"garbage!")
        _clear_process_tiers()
        q = tq.createQureg(N, env)
        tq.startGateFusion(q)
        _gates(tq, q, N, 0.3)
        base = A.stats()
        rep = tq.explainCircuit(q)
        assert rep["compile"]["aot"] == "hit"   # the file is there
        assert A.stats() == base and os.path.exists(path)
        tq.stopGateFusion(q)
        assert A.stats()["errors"] == base["errors"] + 1


class TestEviction:
    def test_lru_eviction_respects_the_byte_cap(self, aot, monkeypatch):
        env = _env()
        _drain(env, theta=0.1)
        per_entry = A.stats()["bytes"]
        assert per_entry > 0
        monkeypatch.setenv("QT_AOT_CACHE_MAX_BYTES",
                           str(int(per_entry * 1.5)))
        _drain(env, theta=0.9)   # a second entry: the first goes
        s = A.stats()
        assert s["evictions"] == 1 and len(_entries(aot)) == 1
        assert s["bytes"] <= int(per_entry * 1.5)
        _clear_process_tiers()
        _drain(env, theta=0.9)
        assert A.stats()["hits"] == 1   # the newest entry survived

    def test_a_hit_refreshes_the_lru_position(self, aot, monkeypatch):
        env = _env()
        _drain(env, theta=0.1)
        (first,) = _entries(aot)
        per_entry = A.stats()["bytes"]
        _drain(env, theta=0.5)
        old = os.path.getmtime(os.path.join(aot, first)) - 100
        for name in _entries(aot):
            os.utime(os.path.join(aot, name), (old, old))
        _clear_process_tiers()
        _drain(env, theta=0.1)   # a hit: the first entry is the newest
        monkeypatch.setenv("QT_AOT_CACHE_MAX_BYTES",
                           str(int(per_entry * 2.5)))
        _drain(env, theta=0.9)   # a third entry evicts the 0.5 one
        assert first in _entries(aot) and len(_entries(aot)) == 2

    def test_the_references_entries_are_left_alone(self, aot, monkeypatch):
        """A directory shared with the JAX package: the reference's .aot
        entry (here garbage, which the reference itself would unlink on
        a read) is never counted, evicted or deleted by the port, and the
        reference's scan does not see the port's entries."""
        os.makedirs(aot, exist_ok=True)
        ref_entry = os.path.join(aot, "0" * 64 + ".aot")
        with open(ref_entry, "wb") as f:
            f.write(b"not the port's" * 1000)
        stat0 = os.stat(ref_entry)
        monkeypatch.setenv("QT_AOT_CACHE_MAX_BYTES", "1")
        env = _env()
        _drain(env, theta=0.1)
        _drain(env, theta=0.2)
        s = A.stats()
        assert s["evictions"] == 2 and _entries(aot) == []
        monkeypatch.setenv("QT_AOT_CACHE_MAX_BYTES", str(1 << 30))
        _drain(env, theta=0.3)
        assert A.stats()["bytes"] == sum(
            os.path.getsize(os.path.join(aot, e)) for e in _entries(aot))
        st = os.stat(ref_entry)
        assert (st.st_size, st.st_mtime_ns) == (stat0.st_size,
                                                stat0.st_mtime_ns)
        assert [p for p, _s, _m in RA._scan()] == [ref_entry]


class TestCrossProcess:
    def test_a_subprocess_must_hit(self, aot, tmp_path):
        a1 = _drain(_env())
        assert A.stats()["puts"] == 1
        out = str(tmp_path / "child_amps.npy")
        script = tmp_path / "child.py"
        script.write_text(
            "import numpy as np\n"
            "import quest_tpu_torch as tq\n"
            "from quest_tpu_torch import aotcache as A\n"
            "from quest_tpu_torch import telemetry as T\n"
            "T.configure('on')\n"
            "tq.set_precision(2)\n"
            "env = tq.createQuESTEnv(device='cpu')\n"
            "q = tq.createQureg(%d, env)\n"
            "with tq.gateFusion(q):\n"
            "    for k in range(%d):\n"
            "        tq.hadamard(q, k)\n"
            "        tq.rotateZ(q, k, 0.3 + 0.1 * k)\n"
            "    for k in range(%d - 1):\n"
            "        tq.controlledNot(q, k, k + 1)\n"
            "s = A.stats()\n"
            "h = T.snapshot()['histograms'].get('span_seconds', {})\n"
            "assert 'name=fusion.plan' not in h, h\n"
            "assert (s['hits'], s['puts']) == (1, 0), s\n"
            "np.save(%r, q.amps.numpy())\n"
            "print('CHILD_HIT_OK', s['hits'])\n" % (N, N, N, out))
        env = dict(os.environ, QT_AOT_CACHE=aot,
                   PYTHONPATH=os.pathsep.join([REPO] + sys.path))
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert res.returncode == 0, res.stderr
        assert "CHILD_HIT_OK" in res.stdout
        assert torch.equal(torch.from_numpy(np.load(out)), a1)


def _pending(mod, env, n=N):
    q = mod.createQureg(n, env)
    mod.startGateFusion(q)
    _gates(mod, q, n, 0.3)
    return q


def _explain_sequence(mod, A_, clear, env):
    """explainCircuit's aot status before each of three drains (cold,
    warm, fresh process) and the aot counters each drain moved."""
    out = []
    for step in range(3):
        if step == 2:
            clear()
        q = _pending(mod, env)
        rep = mod.explainCircuit(q)
        base = A_.stats()
        mod.stopGateFusion(q)
        s = A_.stats()
        out.append((rep["compile"]["aot"],
                    tuple(s[k] - base[k] for k in ("hits", "misses",
                                                   "puts"))))
    return out


class TestExplainCompileSection:
    def test_predictions_pin_counters_drift0(self, aot):
        seq = _explain_sequence(tq, A, _clear_process_tiers, _env())
        assert seq == [("miss", (0, 1, 1)), ("memory", (0, 0, 0)),
                       ("hit", (1, 0, 0))]
        assert T.counter_total("model_drift_total") == 0

    def test_the_status_sequence_is_the_references(self, aot, env):
        from quest_tpu import fusion as RF
        from quest_tpu import telemetry as RT

        def clear_ref():
            RF._plan_runner.cache_clear()
            RF._plan_cache.clear()
            RA._MEMORY_KEYS.clear()

        old = RT.mode_name()
        RT.configure("on")
        clear_ref()
        RA.reset_stats()
        try:
            ref = _explain_sequence(qt, RA, clear_ref, env)
        finally:
            clear_ref()
            RA.reset_stats()
            RT.configure(old)
        port = _explain_sequence(tq, A, _clear_process_tiers, _env())
        assert [s for s, _c in port] == [s for s, _c in ref]
        assert [c for _s, c in port] == [c for _s, c in ref]

    def test_disabled_status_and_formatting(self):
        _clear_process_tiers()
        q = _pending(tq, _env())
        rep = tq.explainCircuit(q)
        assert rep["compile"] == {"aot": "disabled", "aot_enabled": False,
                                  "aot_key": None, "plan_cache": "miss"}
        assert "aot=" not in I.format_explain(rep)
        tq.stopGateFusion(q)

    def test_format_shows_status(self, aot):
        q = _pending(tq, _env())
        rep = tq.explainCircuit(q)
        assert rep["compile"]["aot_enabled"] and rep["compile"]["aot_key"]
        assert "aot=miss" in I.format_explain(rep)
        tq.stopGateFusion(q)


def _h(mod_C, t):
    m = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    return mod_C.Gate((t,), np.stack([m, np.zeros((2, 2))]))


def _rz(mod_C, t, theta):
    d = np.exp(1j * np.array([-theta / 2, theta / 2]))
    return mod_C.Gate((t,), np.stack([np.diag(d.real), np.diag(d.imag)]))


def _circ(mod_C, theta, depth=3, n=4):
    return [g for d in range(depth) for q in range(n)
            for g in (_h(mod_C, q), _rz(mod_C, q, theta + 0.1 * q + d))]


def _serve(env, theta, prewarm=True, jobs=4):
    """A server on ``env`` running ``jobs`` jobs of one structure to
    completion with the warm pool drained: (server, jobs' states)."""
    srv = S.SimServer(env, window=4, max_batch=8, prewarm=prewarm)
    js = [srv.submit(_circ(C, theta), num_qubits=4, seed=i)
          for i in range(jobs)]
    srv.run_until_idle(max_steps=500)
    assert srv.prewarm_join(timeout=120)
    return srv, np.stack([np.asarray(j.amps) for j in js])


class TestWarmPool:
    @pytest.fixture(autouse=True)
    def _opt_off(self, monkeypatch):
        monkeypatch.setenv("QT_OPTIMIZER", "off")

    def test_prewarm_covers_live_and_half_meshes(self, aot):
        env = _env(4)
        srv, _states = _serve(env, 0.3)
        try:
            h = srv._healthz()
            ws = srv.export_warmset()
        finally:
            srv.close()
        assert h["prewarm_backlog"] == 0 and h["warm_pool_depth"] == 2
        assert sorted(spec["ndev"] for spec in ws) == [2, 4]
        statuses = T.snapshot()["counters"]["serve_prewarm_total"]
        assert set(statuses) <= {"status=compiled", "status=hit",
                                 "status=present"}
        assert sum(statuses.values()) == 2
        back = pickle.loads(pickle.dumps(ws))
        assert [b["ndev"] for b in back] == [w["ndev"] for w in ws]

    def test_prewarm_one_statuses_are_the_references(self, aot, env,
                                                     monkeypatch):
        """One spec warmed three times, synchronously: planned, then in
        memory, then (a fresh process) from the disk; and "disabled" with
        the cache off.  The reference reports the same sequence."""
        from quest_tpu import fusion as RF

        def seq(mod_S, mod_C, env, clear):
            srv = mod_S.SimServer(env, window=4, max_batch=8)
            try:
                spec = {"v": 1, "items": _circ(mod_C, 0.3), "sfp": "s",
                        "n": 4, "batch": 4, "dtype": "float64",
                        "ndev": env.num_devices}
                out = [srv._prewarm_one(spec), srv._prewarm_one(spec)]
                clear()
                out.append(srv._prewarm_one(spec))
                monkeypatch.delenv("QT_AOT_CACHE")
                out.append(srv._prewarm_one(spec))
                monkeypatch.setenv("QT_AOT_CACHE", aot)
                return out
            finally:
                srv.close()

        def clear_ref():
            RF._plan_runner.cache_clear()
            RF._plan_cache.clear()
            RA._MEMORY_KEYS.clear()

        clear_ref()
        try:
            ref = seq(RS, RC, env, clear_ref)
        finally:
            clear_ref()
            RA.reset_stats()
        port = seq(S, C, _env(), _clear_process_tiers)
        assert port == ref == ["compiled", "present", "hit", "disabled"]

    def test_warm_from_boots_a_replica_that_plans_nothing(self, aot):
        env = _env(4)
        srv, want = _serve(env, 0.7)
        try:
            blob = pickle.dumps(srv.export_warmset())
        finally:
            srv.close()
        _clear_process_tiers()
        base = A.stats()
        spans = _plan_spans()
        srv2 = S.SimServer(env, window=4, max_batch=8, prewarm=True)
        try:
            assert srv2.warm_from(pickle.loads(blob)) == 2
            assert srv2.prewarm_join(timeout=120)
            s = A.stats()
            assert s["hits"] > base["hits"]    # plans came from the disk
            assert s["puts"] == base["puts"]   # nothing planned
            js = [srv2.submit(_circ(C, 0.7), num_qubits=4, seed=i)
                  for i in range(4)]
            srv2.run_until_idle(max_steps=500)
            got = np.stack([np.asarray(j.amps) for j in js])
        finally:
            srv2.close()
        assert _plan_spans() == spans
        assert A.stats()["puts"] == base["puts"]
        assert np.array_equal(got, want)

    def test_a_degraded_mesh_drain_after_prewarm_plans_nothing(self, aot):
        """The failover pin: the half-mesh plans a failover restores onto
        were warmed at bank start, so a fresh process replaying the bank's
        windows on the shrunk mesh plans nothing (no fusion.plan span, no
        put) and loads every window's plan."""
        env = _env(4)
        srv, _states = _serve(env, 0.5)
        srv.close()
        _clear_process_tiers()
        base = A.stats()
        spans = _plan_spans()
        small = shrink_env(env, 2)
        q = PB.createBatchedQureg(4, small, 4, seeds=list(range(4)))
        items = PB.bank_gate_items([_circ(C, 0.5)] * 4, 4, False, qureg=q)
        ex = R.WindowExecutor(q, items, every=4)
        while not ex.done:
            ex.step()
        s = A.stats()
        assert _plan_spans() == spans
        assert s["puts"] == base["puts"]
        assert s["hits"] - base["hits"] == ex.num_windows


class TestThreads:
    def test_the_tiers_survive_concurrent_inserts_and_reads(self, aot):
        """The warm pool inserts plans while the scheduling thread reads
        them: many threads, a short switch interval, and the memory tier's
        bookkeeping stays whole (no KeyError or RuntimeError, at most 64
        plans, every digest of a live plan a memory key)."""
        import threading

        errors = []

        def work(t):
            try:
                for i in range(5000):
                    key = ("stress", t, i % 80)
                    F._store(key, ("plan", t, i), digest=f"{t}-{i % 80}")
                    F._cache_lookup(("stress", (t + 1) % 8, i % 80), False,
                                    disk=False)
                    F.program_on_device((), torch.float64, "cpu",
                                        key=("stress", t, i % 70))
            except Exception as e:  # the test's own report of a race
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
        assert errors == []
        assert len(F._plan_cache) <= F._PLAN_CACHE_MAX
        assert len(F._device_programs) <= F._PLAN_CACHE_MAX
        assert set(F._plan_digests) <= set(F._plan_cache)
        assert A._MEMORY_KEYS == set(F._plan_digests.values())

    def test_an_eviction_racing_another_is_serialized(self, monkeypatch):
        """The interleaving a race needs, forced: between one thread's
        choice of the memory tier's oldest plan and its eviction, another
        inserts and evicts the same plan.  Under the lock the second
        waits; both plans end up in a full tier."""
        import threading

        F.clear_plan_caches()
        for i in range(F._PLAN_CACHE_MAX):
            F._store(("race", i), i)
        done = threading.Event()

        def racer():
            F._store(("race", "b"), "b")
            done.set()

        class Hooked(dict):
            armed = True

            def __delitem__(self, key):
                # between picking the oldest plan and evicting it
                if Hooked.armed:
                    Hooked.armed = False
                    threading.Thread(target=racer).start()
                    done.wait(0.5)   # the racer runs now, unless it waits
                super().__delitem__(key)

        monkeypatch.setattr(F, "_plan_cache", Hooked(F._plan_cache))
        F._store(("race", "a"), "a")
        assert done.wait(30)
        assert len(F._plan_cache) == F._PLAN_CACHE_MAX
        assert ("race", "a") in F._plan_cache
        assert ("race", "b") in F._plan_cache
        F.clear_plan_caches()

    def test_quiet_depths_are_per_thread(self):
        """A dry run or a suppression in one thread leaves another
        thread's drains recording and storing."""
        import threading
        from quest_tpu_torch import optimizer as _opt

        seen = []
        F._DRY[0] += 1
        with _opt.suppressed():
            th = threading.Thread(target=lambda: seen.append(
                (F._DRY[0], F._QUIET[0], _opt._SUPPRESS[0])))
            th.start()
            th.join(timeout=30)
            mine = (F._DRY[0], _opt._SUPPRESS[0])
        F._DRY[0] -= 1
        assert seen == [(0, 0, 0)] and mine == (1, 1)


class TestSurfaces:
    def test_environment_string_fragment(self, aot):
        env = _env()
        _drain(env)
        s = tq.getEnvironmentString(env)
        frag = s.split("AotCache=")[1]
        assert frag.startswith(f"{aot}(hits=0 misses=1 puts=1 bytes=")

    def test_no_fragment_when_disabled(self):
        assert "AotCache=" not in tq.getEnvironmentString(_env())

    def test_telemetry_folds_the_tier(self, aot):
        env = _env()
        _drain(env)
        _clear_process_tiers()
        _drain(env)
        snap = T.snapshot()
        assert snap["counters"]["aot_cache_hits_total"] == {"": 1.0}
        assert snap["counters"]["aot_cache_puts_total"] == {"": 1.0}
        assert snap["gauges"]["aot_cache_bytes"][""] == A.stats()["bytes"]
        assert "aot_cache_hits=1" in T.summary()
        report = T.perf_report()
        assert "AOT cache / warm pool" in report
        assert "plans: hits=1 misses=1 puts=1" in report

    def test_first_request_histogram_labels(self, aot):
        env = _env()
        _drain(env)
        _drain(env)   # a memory hit: not a first request
        hist = T.snapshot()["histograms"]["first_request_seconds"]
        assert {k: v["count"] for k, v in hist.items()} == {
            "fingerprint_cached=false": 1}
        _clear_process_tiers()
        _drain(env)
        hist = T.snapshot()["histograms"]["first_request_seconds"]
        assert {k: v["count"] for k, v in hist.items()} == {
            "fingerprint_cached=false": 1, "fingerprint_cached=true": 1}
