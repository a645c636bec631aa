"""The port's mesh topology model against the JAX package's.

``quest_tpu_torch/parallel/topology.py`` is a copy of the JAX package's
framework-free model; every function is held case by case against the
reference's: spec parsing, resolution against a shard count, tier
classification of bits, masks and pairs, host arithmetic, shrink / grow,
the pair-list histogram, the tier weights and planner mode read from the
environment, the signature plan caches key on, and the mesh-event
listeners.  The port's env resolves its topology from ``QT_TOPOLOGY`` as
the reference's env does.
"""

import itertools

import pytest

import quest_tpu_torch as tq
from quest_tpu.parallel import topology as RT
from quest_tpu_torch.parallel import topology as PT

SPECS = [None, "", "2x4", "2×4", "1x8", "4x2", "8x1", "3x4", "2x2", "x4",
         "2x", "ax4", "2x4x1", "0x8", " 2X4 "]


def _same(a, b):
    assert (a.hosts, a.chips) == (b.hosts, b.chips)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec(spec):
    assert PT.parse_spec(spec) == RT.parse_spec(spec)


@pytest.mark.parametrize("ndev,spec", list(itertools.product(
    [1, 2, 4, 8, 16], [None, "2x4", "1x8", "4x2", "2x2", "3x4", "2x8"])))
def test_resolve(ndev, spec):
    _same(PT.resolve(ndev, spec), RT.resolve(ndev, spec))


@pytest.mark.parametrize("hosts,chips", [(1, 8), (2, 4), (4, 2), (8, 1),
                                         (2, 2), (1, 1)])
def test_tier_classification_and_host_arithmetic(hosts, chips):
    p, r = PT.Topology(hosts, chips), RT.Topology(hosts, chips)
    assert (p.num_devices, p.ici_bits, p.dcn_bits) == \
        (r.num_devices, r.ici_bits, r.dcn_bits)
    nd = hosts * chips
    for b in range(4):
        assert p.tier_of_bit(b) == r.tier_of_bit(b)
    for mask in range(16):
        assert p.tier_of_mask(mask) == r.tier_of_mask(mask)
    for src in range(nd):
        assert p.host_of(src) == r.host_of(src)
        for dst in range(nd):
            assert p.tier_of_pair(src, dst) == r.tier_of_pair(src, dst)
    for h in range(hosts):
        assert list(p.host_range(h)) == list(r.host_range(h))
    assert p.describe() == r.describe()


@pytest.mark.parametrize("hosts,chips", [(3, 4), (2, 3), (0, 2)])
def test_invalid_topology_rejected(hosts, chips):
    with pytest.raises(ValueError):
        RT.Topology(hosts, chips)
    with pytest.raises(ValueError):
        PT.Topology(hosts, chips)


@pytest.mark.parametrize("start,ndev", list(itertools.product(
    [None, (2, 4), (1, 8), (4, 2)], [1, 2, 4, 8, 16])))
def test_shrink_and_grow(start, ndev, monkeypatch):
    monkeypatch.delenv("QT_TOPOLOGY", raising=False)
    p0 = None if start is None else PT.Topology(*start)
    r0 = None if start is None else RT.Topology(*start)
    _same(PT.shrink(p0, ndev), RT.shrink(r0, ndev))
    _same(PT.grow(p0, ndev), RT.grow(r0, ndev))
    monkeypatch.setenv("QT_TOPOLOGY", "2x4")
    _same(PT.grow(p0, ndev), RT.grow(r0, ndev))


@pytest.mark.parametrize("chips", [1, 2, 4, 8])
def test_split_pair_list(chips):
    pairs = [(i, j) for i in range(8) for j in range(8)]
    assert PT.split_pair_list(pairs, chips) == \
        RT.split_pair_list(pairs, chips)


@pytest.mark.parametrize("ici,dcn,planner", [
    (None, None, None), ("2", "16", "flat"), ("bad", "-1", "hier"),
    ("0.5", None, "FLAT")])
def test_weights_planner_signature(ici, dcn, planner, monkeypatch):
    for var, val in (("QT_TIER_WEIGHT_ICI", ici),
                     ("QT_TIER_WEIGHT_DCN", dcn),
                     ("QT_TOPOLOGY_PLANNER", planner)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    assert PT.tier_weights() == RT.tier_weights()
    assert PT.planner_mode() == RT.planner_mode()
    for spec in ("2x4", "1x8"):
        monkeypatch.setenv("QT_TOPOLOGY", spec)
        assert PT.signature(8) == RT.signature(8)
        for hc in ((1, 8), (2, 4)):
            assert PT.hierarchical_enabled(PT.Topology(*hc)) == \
                RT.hierarchical_enabled(RT.Topology(*hc))
    assert PT.hierarchical_enabled(None) == RT.hierarchical_enabled(None)


def test_mesh_listeners_fan_out_and_survive_a_failing_listener():
    seen = []

    def good(event, info):
        seen.append((event, info))

    def bad(event, info):
        raise RuntimeError("listener failure")

    PT.add_mesh_listener(good)
    PT.add_mesh_listener(good)          # registered once
    PT.add_mesh_listener(bad)
    try:
        with pytest.warns(RuntimeWarning):
            PT.notify_mesh_event("shard_loss", op="remap", shard=3)
    finally:
        PT.remove_mesh_listener(good)
        PT.remove_mesh_listener(bad)
        PT.remove_mesh_listener(bad)    # removing twice is harmless
    assert seen == [("shard_loss", {"op": "remap", "shard": 3})]


@pytest.mark.parametrize("spec,want", [("2x4", (2, 4)), ("4x4", (1, 8)),
                                       (None, (1, 8))])
def test_env_resolves_its_topology(spec, want, monkeypatch):
    if spec is None:
        monkeypatch.delenv("QT_TOPOLOGY", raising=False)
    else:
        monkeypatch.setenv("QT_TOPOLOGY", spec)
    env = tq.createQuESTEnv(devices=["cpu"] * 8)
    assert (env.topology.hosts, env.topology.chips) == want
    assert env.num_devices == env.num_ranks == 8
