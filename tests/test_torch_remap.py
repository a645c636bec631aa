"""The port's remap layer and its cost model against the JAX package's.

Pure planning functions, held case by case against the reference's
(which run no collectives): ``decompose_sigma``, ``remap_exchange_count``
/ ``remap_exchange_tiers`` and ``remap_chunk_plan`` over seeded random
sigmas at r = 1..3; ``plan_window_remap`` and ``plan_relocalization``
over seeded random permutations and wanted sets; the windowed planner
``plan_remap_windows`` and ``remap_exchange_bytes`` / ``_tiers`` over
random bit streams (relabel entries among them); ``exchange_chunks`` with
``QT_EXCHANGE_CHUNKS`` unset and set; the optimizer's sharded reordering,
whose chosen order must be the reference's.  Then the remap kernels
themselves on the port's in-process mesh: ``remap_sharded`` is the bit
permutation it names for any chunk count, on the CPU at float64.
"""

import itertools

import numpy as np
import pytest
import torch

import quest_tpu.circuit as RC
from quest_tpu import fusion as RF
from quest_tpu import optimizer as RO
from quest_tpu.parallel import dist as RD
from quest_tpu.parallel import topology as RTOP
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import optimizer as PO
from quest_tpu_torch.parallel import dist as PD
from quest_tpu_torch.parallel import sharded as SH
from quest_tpu_torch.parallel import topology as PTOP

CASES = [(nloc, r, seed) for r in (1, 2, 3) for nloc in (3, 5)
         for seed in range(6)]


def _sigma(n, seed):
    return tuple(int(x) for x in np.random.default_rng(seed).permutation(n))


@pytest.mark.parametrize("nloc,r,seed", CASES)
def test_decompose_and_count(nloc, r, seed):
    sigma = _sigma(nloc + r, 100 * r + seed)
    assert PD.decompose_sigma(sigma, nloc, r) == \
        RD.decompose_sigma(sigma, nloc, r)
    assert PD.remap_exchange_count(sigma, nloc, r) == \
        RD.remap_exchange_count(sigma, nloc, r)
    for itemsize in (4, 8):
        for hc in ((1, 1 << r), (2, 1 << (r - 1))):
            assert PD.remap_exchange_tiers(
                sigma, nloc, r, itemsize, PTOP.Topology(*hc)) == \
                RD.remap_exchange_tiers(sigma, nloc, r, itemsize,
                                        RTOP.Topology(*hc))
        assert PC.remap_exchange_bytes(sigma, nloc + r, nloc, itemsize) == \
            RC.remap_exchange_bytes(sigma, nloc + r, nloc, itemsize)
        assert PC.remap_exchange_bytes_tiers(
            sigma, nloc + r, nloc, itemsize) == \
            RC.remap_exchange_bytes_tiers(sigma, nloc + r, nloc, itemsize)


@pytest.mark.parametrize("nloc", [3, 18, 19, 20, 22, 23, 25])
@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_remap_chunk_plan(nloc, backend, monkeypatch):
    monkeypatch.delenv("QT_EXCHANGE_CHUNKS", raising=False)
    port_backend = "cuda" if backend == "tpu" else "cpu"
    for itemsize in (4, 8):
        assert PD.remap_chunk_plan(nloc, itemsize, port_backend) == \
            RD.remap_chunk_plan(nloc, itemsize, backend)


@pytest.mark.parametrize("override", [None, "1", "2", "4", "6", "8",
                                      "16", "x"])
def test_exchange_chunks(override, monkeypatch):
    if override is None:
        monkeypatch.delenv("QT_EXCHANGE_CHUNKS", raising=False)
    else:
        monkeypatch.setenv("QT_EXCHANGE_CHUNKS", override)
    assert PD.exchange_config_key() == RD.exchange_config_key()
    for nbytes, limit in itertools.product(
            [1 << 10, (1 << 21) - 1, 1 << 21, 1 << 23, 1 << 26, 1 << 30],
            [1, 2, 8, 1 << 30]):
        for backend, port_backend in (("cpu", "cpu"), ("tpu", "cuda")):
            assert PD.exchange_chunks(nbytes, limit, port_backend) == \
                RD.exchange_chunks(nbytes, limit, backend)


@pytest.mark.parametrize("n,nloc,seed", [(n, nloc, seed)
                                         for n, nloc in ((6, 3), (8, 5),
                                                         (9, 6))
                                         for seed in range(5)])
def test_plan_window_remap(n, nloc, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    perm = tuple(int(x) for x in rng.permutation(n))
    for size in range(1, nloc + 2):
        want = sorted(int(x) for x in rng.choice(n, size, replace=False))
        nxt = {int(q): int(d) for q, d in zip(
            rng.choice(n, n // 2, replace=False), rng.integers(0, 9, n // 2))}
        for spec in (None, "2x4"):
            if spec is None:
                monkeypatch.delenv("QT_TOPOLOGY", raising=False)
            else:
                monkeypatch.setenv("QT_TOPOLOGY", spec)
            assert PD.plan_window_remap(n, nloc, perm, want, nxt) == \
                RD.plan_window_remap(n, nloc, perm, want, nxt)
            assert PD.plan_window_remap(n, nloc, perm, want) == \
                RD.plan_window_remap(n, nloc, perm, want)


@pytest.mark.parametrize("n,nloc,seed", [(n, nloc, seed)
                                         for n, nloc in ((6, 3), (4, 1),
                                                         (8, 5))
                                         for seed in range(5)])
def test_plan_relocalization(n, nloc, seed):
    rng = np.random.default_rng(seed)
    qubits = [int(x) for x in rng.permutation(n)]
    nt = int(rng.integers(1, min(4, n)))
    targets, rest = tuple(qubits[:nt]), qubits[nt:]
    controls = tuple(rest[:int(rng.integers(0, 3))])
    order = [int(x) for x in rng.permutation(nloc)]
    for fo in (None, order):
        assert PD.plan_relocalization(n, nloc, targets, controls, fo) == \
            RD.plan_relocalization(n, nloc, targets, controls, fo)
    assert PD.canonical_sigma(tuple(qubits)) == \
        RD.canonical_sigma(tuple(qubits))


def _entries(rng, n, count, relabel):
    out = []
    for _ in range(count):
        if relabel and rng.random() < 0.2:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            out.append(("relabel", tuple(sorted(((a, b), (b, a))))))
        else:
            k = int(rng.integers(1, 4))
            out.append(tuple(sorted(int(x) for x in
                                    rng.choice(n, k, replace=False))))
    return out


@pytest.mark.parametrize("n,nloc,seed,relabel", [
    (n, nloc, seed, relabel) for n, nloc in ((6, 3), (8, 5), (10, 7))
    for seed in range(4) for relabel in (False, True)])
def test_plan_remap_windows(n, nloc, seed, relabel):
    rng = np.random.default_rng(seed)
    entries = _entries(rng, n, 40, relabel)
    perm0 = tuple(int(x) for x in rng.permutation(n)) if seed % 2 else None
    got = PC.plan_remap_windows(entries, n, nloc, perm0)
    want = RC.plan_remap_windows(entries, n, nloc, perm0)
    assert got == want
    for (_ij, sigma, _p) in got[0]:
        if sigma is not None:
            assert PC.remap_exchange_bytes(sigma, n, nloc) == \
                RC.remap_exchange_bytes(sigma, n, nloc)


def test_plan_remap_windows_refuses_a_too_wide_item():
    with pytest.raises(ValueError):
        PC.plan_remap_windows([(0, 1, 2, 3)], 6, 3)
    with pytest.raises(ValueError):
        RC.plan_remap_windows([(0, 1, 2, 3)], 6, 3)


def _soa(u):
    return np.stack([u.real, u.imag])


def _stream(rng, n, count, mod):
    """A gate stream of 1q rotations, CNOTs, diagonal phases and SWAPs
    on random qubits (both packages' Gate type)."""
    gates = []
    cnot = np.eye(4)[[0, 3, 2, 1]]
    swap = np.eye(4)[[0, 2, 1, 3]]
    for _ in range(count):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            t = int(rng.integers(0, n))
            th = float(rng.uniform(0, 3))
            u = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
            gates.append(mod.Gate((t,), _soa(u.astype(complex))))
        elif kind == 1:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            gates.append(mod.Gate((a, b), _soa(cnot.astype(complex))))
        elif kind == 2:
            t = int(rng.integers(0, n))
            ph = np.diag([1, np.exp(1j * float(rng.uniform(0, 3)))])
            gates.append(mod.Gate((t,), _soa(ph)))
        else:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            gates.append(mod.Gate((a, b), _soa(swap.astype(complex))))
    return gates


@pytest.mark.parametrize("mode", ["on", "aggressive"])
@pytest.mark.parametrize("n,nloc,seed", [(6, 3, 0), (6, 3, 1), (8, 5, 2),
                                         (8, 5, 3), (7, 4, 4)])
def test_optimizer_reordering_is_the_reference(mode, n, nloc, seed):
    rng = np.random.default_rng(seed)
    ref_items = _stream(rng, n, 30, RC)
    port_items = [PC.Gate(g.targets, g.mat) for g in ref_items]
    perm0 = tuple(int(x) for x in rng.permutation(n)) if seed % 2 else None
    try:
        RO.set_circuit_optimizer(mode)
        PO.set_circuit_optimizer(mode)
        want, wstats = RO.optimize_items(ref_items, n=n, nloc=nloc,
                                         nsh=n - nloc, perm0=perm0,
                                         quiet=True)
        got, gstats = PO.optimize_items(port_items, nloc=nloc, n=n,
                                        nsh=n - nloc, perm0=perm0)
    finally:
        RO.set_circuit_optimizer(None)
        PO.set_circuit_optimizer(None)
    assert [g.targets for g in got] == [g.targets for g in want]
    for g, w in zip(got, want):
        assert np.abs(g.mat - np.asarray(w.mat)).max() <= 1e-12
    assert gstats["reordered"] == wstats["reordered"]
    assert gstats["removed"] == wstats["removed"]
    assert PO._stream_cost(got, n, nloc, perm0) == \
        RO._stream_cost(want, n, nloc, perm0)
    entries = [PF._item_entry(g) for g in got]
    assert entries == [RF._item_entry(g) for g in want]


def _bit_permuted(vec, sigma):
    n = len(sigma)
    idx = np.arange(1 << n)
    dest = np.zeros_like(idx)
    for p in range(n):
        dest |= ((idx >> p) & 1) << sigma[p]
    out = np.zeros_like(vec)
    out[:, dest] = vec[:, idx]
    return out


@pytest.mark.parametrize("R,seed,chunks", [
    (R, seed, c) for R in (2, 4, 8) for seed in range(3)
    for c in ((1, 1), (2, 4), (8, 8))])
def test_remap_sharded_is_the_bit_permutation(R, seed, chunks):
    n = 7
    nloc = n - (R.bit_length() - 1)
    env = tq.createQuESTEnv(devices=["cpu"] * R)
    x = np.random.default_rng(seed).standard_normal((2, 1 << n))
    sigma = _sigma(n, seed + 17)
    amps = SH.split(env.mesh, x, nloc, torch.float64)
    out = PD.remap_sharded(amps, num_qubits=n, sigma=sigma, chunks=chunks)
    np.testing.assert_array_equal(SH.gather_host(out),
                                  _bit_permuted(x, sigma))
