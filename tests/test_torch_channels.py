"""K5, the fused pair-channel sweep, of quest_tpu_torch against
quest_tpu's, on the CPU.

* The port's apply_pair_channel_sweep on CPU float32 tensors (its plain
  version) against the reference's apply_pair_channel_sweep in interpret
  mode on the same float32 arrays, at 16 and 18 bits, over the program
  shapes chip_smoke.py's channel_parity holds K5 to on the card: lane
  and sublane ket bits, in-block and grid channels in one sweep (rank
  above 4, so split into several launches), the top chunk, depolarise
  and damping mixed, the same channel twice in a row, a config-4 layer.
  Limit 1e-6 max|rho|: the weights and products are the same float32
  values, XLA may fuse a multiply-add the port rounds twice.
* The plain sweep at float64 against the same channels applied one by one
  through the reference's density.apply_pair_channel, within 1e-12.
* The kernel's orbit arithmetic (sweep_launch_groups: echelon pivots,
  orbit offsets, subsets), emulated here in NumPy, equals the plain
  version bit for bit: the CUDA kernel itself runs only on the card.
* The chunk schedule, recorded by a spy on the reference's
  _chan_sweep_pass, and the precondition errors' messages.
* The fusion drain: _split_items(..., sweep_ok=True) on config 4's items
  gives the reference's channel parts, and the program runs on the CPU
  to the same state as the sweep_ok=False program.
* The slice as a whole: config 4 at 8 qubits in float32, the sweep forced
  through sweep_ok, within 1e-6 of the reference's interpret-mode sweep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import fusion as RFU
from quest_tpu.ops import density as RD
from quest_tpu.ops import fused as RF
from quest_tpu_torch import fusion, precision
from quest_tpu_torch.models import noise as TN
from quest_tpu_torch.ops import fused as F

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run (its
    spinning worker threads starve the other test processes)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


KTOL = 1e-6     # float32 plain sweep against the reference kernel, x max|rho|
TOL = 1e-12     # float64


def programs(nn):
    """The program shapes of chip_smoke.py's channel_parity, at nn >= 16
    bits: (kind, ket bit, bra bit) triples."""
    n = nn // 2
    return {
        "lane": (("depol", 0, 14), ("damping", 3, 15), ("depol", 6, 12)),
        "sublane": (("damping", 7, 14), ("depol", 10, 15),
                    ("depol", 13, 11)),
        # five in-block channels and two grid ones in one sweep: rank 7,
        # two launches (rank 4, then 3)
        "inblock_grid": (("depol", 1, 9), ("damping", 2, 10),
                         ("depol", 3, 11), ("damping", 4, 12),
                         ("depol", 5, 14), ("damping", 6, 15),
                         ("depol", 0, 13)),
        "top_chunk": (("depol", 2, nn - 1), ("damping", 9, nn - 2),
                      ("depol", 12, nn - 3)),
        "mixed": tuple(("depol" if i % 2 else "damping", t, t + n)
                       for i, t in enumerate(range(n - 6, n))),
        "repeat": (("depol", 4, 15), ("depol", 4, 15), ("damping", 5, 14),
                   ("damping", 5, 14)),
        "config4_layer": tuple(("depol", t, t + n) for t in range(n)
                               if t < 14),
    }


def _probs(program):
    return [0.02 + 0.03 * i for i in range(len(program))]


def _state(nn, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((2, 1 << nn))
    return (x / np.linalg.norm(x)).astype(dtype)


CASES = [(nn, name) for nn in (16, 18) for name in programs(nn)]


@pytest.mark.parametrize("nn,name", CASES,
                         ids=[f"{nn}-{name}" for nn, name in CASES])
def test_sweep_plain_matches_reference_kernel(nn, name):
    program = programs(nn)[name]
    probs = _probs(program)
    x = _state(nn, np.float32, nn)
    got = F.apply_pair_channel_sweep(torch.from_numpy(x.copy()), program,
                                     probs, num_bits=nn).numpy()
    want = np.asarray(RF.apply_pair_channel_sweep(
        jnp.asarray(x), program, probs, num_bits=nn, interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=KTOL * np.abs(x).max())


@pytest.mark.parametrize("nn,name", CASES,
                         ids=[f"{nn}-{name}" for nn, name in CASES])
def test_sweep_plain_f64_matches_channels_one_by_one(nn, name):
    program = programs(nn)[name]
    probs = _probs(program)
    x = _state(nn, np.float64, nn + 1)
    got = F.pair_channel_sweep_plain(torch.from_numpy(x), program, probs,
                                     num_bits=nn).numpy()
    want = jnp.asarray(x)
    for (kind, t, b), p in zip(program, probs):
        want = RD.apply_pair_channel(want, kind, p, nn=nn, t=t, b=b)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def _emulate_k5(x, nn, program, probs):
    """csrc/channels.cu's arithmetic in NumPy, vectorised over orbits:
    the same launch groups, zero insertion at the pivots, orbit offsets,
    subsets and weight tables, each product and sum rounded in float32."""
    x = x.copy()
    re, im = x[0], x[1]
    wts = [F.channel_weights(k, p, np.float32)
           for (k, _t, _b), p in zip(program, probs)]
    for _b0, _k, entries in F.sweep_schedule(program, nn):
        for ents, pivots, orbit, subsets in F.sweep_launch_groups(entries):
            r = len(pivots)
            assert 1 <= r <= F.CHAN_MAX_RANK
            assert len(ents) <= F.CHAN_MAX_ENTRIES
            rep = np.arange(1 << (nn - r), dtype=np.uint64)
            for p in pivots:
                low = np.uint64((1 << p) - 1)
                rep = ((rep & ~low) << np.uint64(1)) | (rep & low)
            idx = [rep ^ np.uint64(o) for o in orbit]
            xr = [re[i] for i in idx]
            xi = [im[i] for i in idx]
            for (t, b, pbit, wi), s in zip(ents, subsets):
                tab = F.channel_entry_tables(wts[wi], pbit is not None)
                for j in range(1 << r):
                    p = j ^ s
                    if j >= p:
                        continue
                    sel = (((idx[j] >> np.uint64(t)) & np.uint64(1)) * 2
                           + ((idx[j] >> np.uint64(b)) & np.uint64(1))
                           ).astype(np.int64)
                    w1j, w2j = tab[0][sel], tab[1][sel]
                    w1p, w2p = tab[0][3 - sel], tab[1][3 - sel]
                    for v in (xr, xi):
                        vj, vp = v[j], v[p]
                        v[j] = vj * w1j + vp * w2j
                        v[p] = vp * w1p + vj * w2p
            for j in range(1 << r):
                re[idx[j]] = xr[j]
                im[idx[j]] = xi[j]
    return x


@pytest.mark.parametrize("name", sorted(programs(16)))
def test_kernel_orbit_arithmetic_equals_plain_bit_for_bit(name):
    nn = 16
    program = programs(nn)[name]
    probs = _probs(program)
    x = _state(nn, np.float32, 3)
    got = _emulate_k5(x, nn, program, probs)
    want = F.pair_channel_sweep_plain(torch.from_numpy(x), program, probs,
                                      num_bits=nn).numpy()
    np.testing.assert_array_equal(got, want)


def test_launch_groups_split_by_rank_and_entry_count_in_order():
    entries = F.sweep_schedule(programs(16)["inblock_grid"], 16)[0][2]
    groups = F.sweep_launch_groups(entries)
    assert [len(g[1]) for g in groups] == [4, 3]
    assert sum((g[0] for g in groups), ()) == entries
    many = tuple((4, 15, 1, i) for i in range(F.CHAN_MAX_ENTRIES + 3))
    groups = F.sweep_launch_groups(many)
    assert [len(g[0]) for g in groups] == [F.CHAN_MAX_ENTRIES, 3]
    assert all(g[1] == (15,) and g[3] == (1,) * len(g[0]) for g in groups)


def test_chunk_schedule_matches_reference(monkeypatch):
    """The reference's sweeps, recorded by a spy on its _chan_sweep_pass
    (run for real at 16 bits; at 28 bits only recorded, on a stand-in
    array)."""
    seen = []
    real = RF._chan_sweep_pass

    def spy(amps, wmat, xmats, *, num_bits, b0, k, chunk, xmap_items,
            interpret=None):
        seen.append((b0, k, tuple(chunk)))
        if num_bits > 18:
            return amps
        return real(amps, wmat, xmats, num_bits=num_bits, b0=b0, k=k,
                    chunk=chunk, xmap_items=xmap_items, interpret=interpret)

    monkeypatch.setattr(RF, "_chan_sweep_pass", spy)
    for nn in (16, 28):
        x = jnp.asarray(_state(nn, np.float32, 1) if nn <= 18
                        else np.zeros((2, 2), np.float32))
        for name, program in programs(nn).items():
            seen.clear()
            RF.apply_pair_channel_sweep(x, program, _probs(program),
                                        num_bits=nn, interpret=True)
            assert F.sweep_schedule(program, nn) == seen, (nn, name)
    # config 4's layer at 14 qubits: five sweeps of 3, 3, 3, 3, 2
    layer = tuple(("depol", t, t + 14) for t in range(14))
    assert [(b0, len(e)) for b0, _k, e in F.sweep_schedule(layer, 28)] == [
        (14, 3), (17, 3), (20, 3), (23, 3), (25, 2)]


@pytest.mark.parametrize("program,nn", [
    ((("depol", 0, 14),), 14),
    ((("depol", 14, 20),), 16),
    ((("depol", 0, 16),), 16),
    ((("depol", 0, 15), ("damping", 1, 15)), 16)],
    ids=["small", "ket14", "bra_out", "shared_bra"])
def test_precondition_messages_match_reference(program, nn):
    x = np.zeros((2, 1 << min(nn, 16)), np.float32)
    with pytest.raises(ValueError) as ep:
        F.apply_pair_channel_sweep(torch.from_numpy(x), program,
                                   _probs(program), num_bits=nn)
    with pytest.raises(ValueError) as er:
        RF.apply_pair_channel_sweep(jnp.asarray(x), program, _probs(program),
                                    num_bits=nn, interpret=True)
    assert str(ep.value) == str(er.value)


def test_wrapper_checks_of_its_own():
    x = torch.zeros((2, 1 << 16))
    with pytest.raises(ValueError, match="probabilities"):
        F.apply_pair_channel_sweep(x, (("depol", 0, 14),), [], num_bits=16)
    with pytest.raises(ValueError, match="distinct"):
        F.apply_pair_channel_sweep(x, (("depol", 5, 5),), [0.1], num_bits=16)


def test_channel_weights_match_reference():
    for kind in ("depol", "damping"):
        for p in (0.0, 0.05, 0.3, 0.75):
            for dt in (np.float32, np.float64):
                got = F.channel_weights(kind, p, dt)
                want = np.asarray(RF.channel_weights(kind, p, dt))
                assert got.dtype == dt
                np.testing.assert_array_equal(got, want)
    assert F.channel_weights("depol", 0.1, torch.float32).dtype == np.float32


def test_channel_sweep_is_not_chosen_on_the_cpu():
    assert not F.channel_sweep_enabled(torch.zeros(2, dtype=torch.float32))
    assert not F.channel_sweep_enabled(torch.zeros(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The fusion drain
# ---------------------------------------------------------------------------


def _config4_items(n, layers=1, gates=False):
    """The items a gateFusion drain of config-4 noise layers (each after a
    Hadamard layer, with ``gates``) sees: captured through the port's API
    on a register that never allocates amplitudes, and the same items as
    the reference's Gate and ChannelItem objects."""
    from quest_tpu import circuit as RC
    from quest_tpu_torch.qureg import Qureg

    kops = TN.bench_kraus_ops()
    rho = Qureg(n, tq.createQuESTEnv(device="cpu"), True)
    fusion.start_gate_fusion(rho)
    for _ in range(layers):
        if gates:
            for q in range(n):
                tq.hadamard(rho, q)
        TN.noise_layer(tq, rho, n, kops)
    items = list(rho._fusion.gates)
    ref = [RFU.ChannelItem(it.kind, it.target, it.bra, it.prob)
           if isinstance(it, fusion.ChannelItem)
           else RC.Gate(it.targets, it.mat) for it in items]
    return items, ref


def _chan_parts(program):
    return [p for p in program if p[0] in ("chan", "chansweep")]


@pytest.mark.parametrize("n", [8, 14, 15])
def test_split_items_channel_parts_match_reference(n):
    port_items, ref_items = _config4_items(n, layers=2, gates=True)
    for sweep_ok in (True, False):
        got = fusion._split_items(port_items, 2 * n, sweep_ok)
        want, _arrays = RFU._split_items(ref_items, 2 * n, sweep_ok)
        assert _chan_parts(got) == _chan_parts(want)
        assert [p[0] for p in got if p[0] != "perm"] == \
            [p[0] for p in want if p[0] != "perm"]
    program = fusion.plan_items(port_items, 2 * n, sweep_ok=True)
    if n < 15:
        assert fusion.program_stats(program)["chansweep"] == 2
    else:
        assert "chansweep" not in fusion.program_stats(program)


def test_swept_program_equals_per_channel_program_on_cpu():
    n = 8
    port_items, _ = _config4_items(n, layers=2, gates=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 1 << (2 * n))))
    probs = [it.prob for it in port_items
             if isinstance(it, fusion.ChannelItem)]
    swept = fusion.plan_items(port_items, 2 * n, sweep_ok=True)
    plain = fusion.plan_items(port_items, 2 * n, sweep_ok=False)
    assert [p[0] for p in swept] != [p[0] for p in plain]
    a = fusion.execute_program(x, swept, probs, 2 * n)
    b = fusion.execute_program(x, plain, probs, 2 * n)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


def test_config4_fidelity_with_forced_sweep_matches_reference_sweep(
        monkeypatch):
    """bench.py config 4 at 8 qubits (16 bits), float32: the port's drain
    planned with sweep_ok (which the CPU does not choose) against the
    reference's interpret-mode sweep (its QT_CHAN_SWEEP_INTERPRET
    opt-in)."""
    n = 8
    monkeypatch.setenv("QT_CHAN_SWEEP_INTERPRET", "1")
    kops = TN.bench_kraus_ops()
    old = qt.get_precision()
    qt.set_precision(1)
    try:
        ref = qt.createDensityQureg(n, qt.createQuESTEnv(num_devices=1))
        qt.initPlusState(ref)
        rpsi = qt.createQureg(n, qt.createQuESTEnv(num_devices=1))
        qt.initPlusState(rpsi)
        with qt.gateFusion(ref):
            for _ in range(2):
                TN.noise_layer(qt, ref, n, kops)
        want = qt.calcFidelity(ref, rpsi)
    finally:
        qt.set_precision(old)
    pold = precision.get_precision()
    tq.set_precision(1)
    try:
        env = tq.createQuESTEnv(device="cpu")
        rho = tq.createDensityQureg(n, env)
        tq.initPlusState(rho)
        psi = tq.createQureg(n, env)
        tq.initPlusState(psi)
        tq.startGateFusion(rho)
        for _ in range(2):
            TN.noise_layer(tq, rho, n, kops)
        items = list(rho._fusion.gates)
        rho._fusion.gates.clear()
        tq.stopGateFusion(rho)
        program = fusion.plan_items(items, 2 * n, sweep_ok=True)
        assert fusion.program_stats(program)["chansweep"] == 2
        probs = [it.prob for it in items
                 if isinstance(it, fusion.ChannelItem)]
        rho.amps = fusion.execute_program(rho.amps, program, probs, 2 * n)
        got = tq.calcFidelity(rho, psi)
        assert rho.amps.dtype == torch.float32
    finally:
        tq.set_precision(pold)
    assert abs(got - want) < 1e-6
    assert 0.0 < got < 1.0
