"""Checkpoints of registers split over torch.distributed ranks (M16g).

Two gloo ranks are spawned once for the module (the pattern of
tests/test_torch_dist.py).  On the ranks, a float64 register of N qubits
(one shard bit, so its gates remap across the ranks and a live
permutation is saved) is:

* saved with ``saveQureg`` after a fused drain;
* loaded from a snapshot the parent wrote in process;
* run through ``run_resumable`` in windows of EVERY gates, killed before
  window 2 and resumed from the ranks' last generation;
* run again with a kill at window 1's commit point (an interrupted
  save);
* served by a ``SimServer(preempt="checkpoint")``, one long batch job
  preempted by an interactive burst and resumed.

The parent then holds each result against the same work in process: a
snapshot written on ranks loads onto 1 and onto 4 in-process shards
equal to the in-process state, with an in-process save's metadata key
for key; the rank-side load of an in-process snapshot, the resumed run
and the served jobs are bit for bit their in-process counterparts; the
interrupted save leaves the generation of window 0 the newest loadable
one.  ``shrink_env`` still refuses a ranks env, and a checkpointing
server on ranks without a shared checkpoint root is refused.
"""

import json
import os
import socket
import time

import numpy as np
import pytest

import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import interop, precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import serve as PS

WORLD = 2
N = 10          # state-vector qubits: nloc = 9 on 2 ranks
EVERY = 4


@pytest.fixture(autouse=True)
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _initial(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 1 << n))
    return a / np.linalg.norm(a)


def _fused(mod, q):
    """A fused drain that touches the shard bit: the register is left in
    a live permutation."""
    n = q.num_qubits_represented
    with mod.gateFusion(q):
        for t in range(n):
            mod.rotateY(q, t, 0.3 + 0.1 * t)
        for t in range(n - 1):
            mod.controlledNot(q, t, t + 1)
        mod.rotateZ(q, n - 1, 0.7)


def _stream(n):
    """run_resumable's gate stream: (targets, SoA matrix) pairs, the
    shard bit among the targets."""
    rng = np.random.default_rng(3)
    gates = []
    for k in range(5 * EVERY):
        t = int(rng.integers(n))
        th = float(rng.uniform(0, np.pi))
        m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        gates.append(((t,), np.stack([m, np.zeros((2, 2))])))
        if k % 3 == 0:
            gates.append(((t, (t + 1) % n), _cnot()))
    return gates


def _cnot():
    m = np.eye(4)[[0, 3, 2, 1]]
    return np.stack([m, np.zeros((4, 4))])


def _h(t):
    m = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    return PC.Gate((t,), np.stack([m, np.zeros((2, 2))]))


def _rz(t, theta):
    d = np.exp(1j * np.array([-theta / 2, theta / 2]))
    return PC.Gate((t,), np.stack([np.diag(d.real), np.diag(d.imag)]))


def _circ(theta, depth, n):
    return [g for d in range(depth) for q in range(n)
            for g in (_h(q), _rz(q, theta + 0.1 * q + d))]


def _long_job(srv, n):
    """One long batch job interrupted by an interactive burst after 3
    windows (tests/test_torch_serve.py's _long_job): the job's state,
    then the burst's."""
    job = srv.submit(_circ(0.5, 6, n), num_qubits=n, tenant="batchy",
                     seed=11)
    for _ in range(3):
        srv.step()
    burst = [srv.submit(_circ(1.5, 1, n), num_qubits=n, tenant="vip",
                        seed=40 + i, priority=PS.INTERACTIVE)
             for i in range(2)]
    while not all(b.done for b in burst):
        srv.step()
    srv.run_until_idle(max_steps=500)
    assert job.state == PS.DONE and all(b.state == PS.DONE for b in burst)
    return np.stack([np.asarray(j.amps) for j in [job] + burst])


def _host(q):
    return interop.register_state(q, canonical=True)[0]


def _rank_worker(rank, world, port, out):
    import torch.distributed as dist

    import quest_tpu_torch as tqm
    from quest_tpu_torch import env as E
    from quest_tpu_torch import resilience as R
    from quest_tpu_torch import serve as S
    from quest_tpu_torch import telemetry as T

    tqm.initDistributed(f"tcp://localhost:{port}", world, rank, "gloo")
    rec = {}
    try:
        tqm.set_precision(2)
        T.configure("on")
        env = tqm.createQuESTEnv()

        def fresh():
            q = tqm.createQureg(N, env)
            tqm.initStateFromAmps(q, *_initial(N, 6))
            return q

        def save(name, arr):
            np.save(os.path.join(out, f"{name}{rank}.npy"), arr)

        q = fresh()
        _fused(tqm, q)
        rec["perm"] = list(q._perm) if q._perm is not None else None
        tqm.saveQureg(q, os.path.join(out, "ranks_ck"))
        save("loaded", _host(tqm.loadQureg(os.path.join(out, "inproc_ck"),
                                           env)))
        gates = _stream(N)
        try:
            R.run_resumable(fresh(), gates, os.path.join(out, "rr"),
                            every=EVERY, faults=R.FaultPlan("kill@2"))
        except R.SimulatedPreemption:
            rec["killed"] = True
        rec["rr_cursor"] = R.latest_committed_cursor(os.path.join(out, "rr"))
        save("resumed", _host(R.run_resumable(
            fresh(), gates, os.path.join(out, "rr"), every=EVERY)))
        try:
            R.run_resumable(fresh(), gates, os.path.join(out, "ks"),
                            every=EVERY, faults=R.FaultPlan("killsave@1"))
        except R.SimulatedPreemption:
            rec["killsave"] = True
        rec["ks_cursor"] = R.latest_committed_cursor(os.path.join(out, "ks"))
        srv = S.SimServer(env, window=EVERY, max_batch=4,
                          preempt="checkpoint",
                          ckpt_dir=os.path.join(out, "serve"))
        try:
            save("served", _long_job(srv, N))
        finally:
            srv.close()
        rec["preemptions"] = T.counter_sum("preemptions_total",
                                           mode="checkpoint")
        try:
            E.shrink_env(env, 1)
        except tqm.QuESTError:
            rec["shrink_refused"] = True
        try:
            S.SimServer(env, preempt="checkpoint").close()
        except tqm.QuESTError:
            rec["rootless_refused"] = True
    finally:
        with open(os.path.join(out, f"rec{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the rank side once: the parent's in-process snapshot first,
    then the two gloo ranks.  Returns (output directory, each rank's
    record)."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("ranks")
    old = precision.get_precision()
    tq.set_precision(2)
    try:
        q = tq.createQureg(N, _env(WORLD))
        tq.initStateFromAmps(q, *_initial(N, 9))
        _fused(tq, q)
        tq.saveQureg(q, str(out / "inproc_ck"))
    finally:
        tq.set_precision(old)
    ctx = mp.start_processes(_rank_worker,
                             args=(WORLD, _free_port(), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 150    # this fixture's own time limit
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, \
                f"the {WORLD} gloo ranks did not finish in 150 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    recs = [json.load(open(out / f"rec{r}.json")) for r in range(WORLD)]
    return out, recs


def _env(R):
    return tq.createQuESTEnv(devices=["cpu"] * R) if R > 1 \
        else tq.createQuESTEnv(device="cpu")


def _in_process_fused():
    q = tq.createQureg(N, _env(WORLD))
    tq.initStateFromAmps(q, *_initial(N, 6))
    _fused(tq, q)
    return q


@pytest.mark.parametrize("R", [1, 4])
def test_a_save_on_ranks_loads_in_process(ranks, R):
    out, recs = ranks
    want = _in_process_fused()
    assert [r["perm"] for r in recs] == [list(want._perm)] * WORLD
    q = tq.loadQureg(str(out / "ranks_ck"), _env(R))
    assert q.is_sharded == (R > 1)
    assert np.array_equal(_host(q), _host(want))
    assert np.array_equal(np.load(str(out / "ranks_ck" / "amps.npy")),
                          _host(want))


def test_a_save_on_ranks_has_the_in_process_meta(ranks, tmp_path):
    out, _recs = ranks
    tq.saveQureg(_in_process_fused(), str(tmp_path / "ck"))
    got = json.load(open(out / "ranks_ck" / "qureg_meta.json"))
    assert got == json.load(open(tmp_path / "ck" / "qureg_meta.json"))
    assert got["mesh_shards"] == WORLD


def test_an_in_process_save_loads_on_ranks(ranks):
    out, _recs = ranks
    want = tq.loadQureg(str(out / "inproc_ck"), _env(1))
    for r in range(WORLD):
        assert np.array_equal(np.load(out / f"loaded{r}.npy"), _host(want))


def test_run_resumable_resumes_on_ranks_bit_for_bit(ranks, tmp_path):
    out, recs = ranks
    assert all(r.get("killed") for r in recs)
    assert all(r["rr_cursor"] == 2 * EVERY for r in recs)
    q = tq.createQureg(N, _env(WORLD))
    tq.initStateFromAmps(q, *_initial(N, 6))
    PR.run_resumable(q, _stream(N), str(tmp_path / "rr"), every=EVERY)
    for r in range(WORLD):
        assert np.array_equal(np.load(out / f"resumed{r}.npy"), _host(q))


def test_a_save_cut_before_its_commit_leaves_the_previous_generation(
        ranks):
    out, recs = ranks
    assert all(r.get("killsave") for r in recs)
    assert all(r["ks_cursor"] == EVERY for r in recs)
    want = tq.createQureg(N, _env(WORLD))
    tq.initStateFromAmps(want, *_initial(N, 6))
    ex = PR.WindowExecutor(want, _stream(N), every=EVERY)
    ex.step()
    got, meta = PR.load_latest(str(out / "ks"), _env(1))
    assert meta["cursor"] == EVERY
    assert np.array_equal(_host(got), _host(want))


def test_checkpoint_preemption_serves_on_ranks(ranks):
    out, recs = ranks
    assert all(r["preemptions"] >= 1 for r in recs)
    srv = PS.SimServer(_env(WORLD), window=EVERY, max_batch=4,
                       preempt="off")
    try:
        want = _long_job(srv, N)
    finally:
        srv.close()
    for r in range(WORLD):
        assert np.array_equal(np.load(out / f"served{r}.npy"), want)


def test_ranks_refuse_what_stays_in_process(ranks):
    _out, recs = ranks
    assert all(r.get("shrink_refused") for r in recs)
    assert all(r.get("rootless_refused") for r in recs)
