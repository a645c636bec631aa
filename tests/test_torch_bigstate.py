"""quest_tpu_torch.ops.bigstate and the in-place bit reversal of the
30-34-qubit QFT against quest_tpu's, on the CPU.

* K10's plain version, sigma_swap_plain, against the reference's Pallas
  kernel _sigma_swap_jit (interpret mode, through apply_sigma_swap) for
  the reference's own cases (tests/test_inplace_bigstate.py:19): exact,
  since sigma moves amplitudes without arithmetic.
* The pair tables and sigma_perm equal the reference's.
* circuit._bit_reversal_big's op lists equal the reference's at n =
  28..31 (kinds, offsets, side flags, matrices), and composed at the
  index level they are the full bit reversal
  (tests/test_inplace_bigstate.py:70).
* execute_plan runs ("sigma_swap", g) through the K10 wrapper, which on
  the CPU takes its plain version and launches nothing.
* K10's reversal form: a model of the kernel's grid (its pair tables,
  skips, tiles and addresses) moves every element exactly once, each to
  its bit-reversed index, at small group widths (every n - 4g from 0 to
  6, and two tiles a slab side at g = 6); at g = 7 and n = 30..34 its
  pair tables and b loop cover every slab once, each paired with its
  reversal image.  Its wrapper on the CPU is one permute_qubits with the
  reversed order (a bank element by element) and launches nothing.
* The card route: bit_reversal_ops of a full float32 run at 30..34
  qubits is the one op ("sigma_rev", 7), whose index map is the full
  reversal, and _fused_qft_multilayer there plans an A-only lane pass
  and that op.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu import circuit as RC
from quest_tpu.ops import bigstate as RB
from quest_tpu_torch import circuit as C
from quest_tpu_torch.ops import bigstate as B
from quest_tpu_torch.ops import kernels

torch.set_num_threads(1)

_SIGMA_CASES = [(9, 2), (12, 2), (13, 3), (16, 4)]


@pytest.mark.parametrize("n,g", _SIGMA_CASES)
def test_sigma_swap_plain_matches_reference_kernel(n, g):
    a = np.random.default_rng(7).normal(size=(2, 1 << n)).astype(np.float32)
    want = np.asarray(RB.apply_sigma_swap(jnp.asarray(a), num_qubits=n,
                                          group_bits=g, interpret=True))
    got = B.sigma_swap_plain(torch.from_numpy(a), num_qubits=n,
                             group_bits=g)
    np.testing.assert_array_equal(got.numpy().reshape(2, -1),
                                  want.reshape(2, -1))


@pytest.mark.parametrize("n,g", _SIGMA_CASES + [(28, 7), (30, 7), (34, 7)])
def test_sigma_tables_and_perm_match_reference(n, g):
    assert B.sigma_perm(n, g) == RB.sigma_perm(n, g)
    p = B.sigma_perm(n, g)
    assert [p[p[q]] for q in range(n)] == list(range(n))
    for got, want in zip(B.sigma_pair_tables(g), RB.sigma_pair_tables(g)):
        np.testing.assert_array_equal(got, want)


def test_sigma_swap_wrapper_on_cpu_is_plain_and_launches_nothing():
    B.reset_launch_counts()
    n, g = 12, 3
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 1 << n)))
    y = C.execute_plan(x, [("sigma_swap", g)], n)
    assert torch.equal(y, B.sigma_swap_plain(x, num_qubits=n, group_bits=g))
    assert torch.equal(B.apply_sigma_swap(y, num_qubits=n, group_bits=g), x)
    assert B.LAUNCHES == {"K10": 0, "K10_bank": 0, "K10_rev": 0,
                          "K10_rev_bank": 0}
    with pytest.raises(ValueError, match="4\\*group_bits"):
        B.apply_sigma_swap(x, num_qubits=n, group_bits=4)


def _same_ops(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[0] == b[0]
        if a[0] == "sigma_swap":
            assert a == tuple(b)
            continue
        assert a[1] == b[1] and a[4:6] == tuple(b[4:6])
        for x, y in zip(a[2:4], b[2:4]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n", [28, 29, 30, 31])
@pytest.mark.parametrize("skip_low", [False, True])
def test_bit_reversal_big_ops_match_reference(n, skip_low):
    got = C._bit_reversal_big(n, np.float32, skip_low_group=skip_low)
    _same_ops(got, RC._bit_reversal_big(n, np.float32,
                                        skip_low_group=skip_low))


def _winfused_index_map(op):
    """out[i] = in[f(i)] for a window pass whose A and B are permutation
    matrices (the only kind _bit_reversal_big emits)."""
    k, a, b = op[1], np.asarray(op[2])[0, 0], np.asarray(op[3])[0, 0]
    pl_, pw_ = np.argmax(a, axis=1), np.argmax(b, axis=1)
    assert (a[np.arange(128), pl_] == 1).all()
    assert (b[np.arange(128), pw_] == 1).all()

    def f(i):
        rest = i & ~(127 | (127 << k))
        return rest | int(pl_[i & 127]) | (int(pw_[(i >> k) & 127]) << k)

    return f


def _sigma_index_map(n, g):
    perm = B.sigma_perm(n, g)

    def f(i):
        j = 0
        for q in range(n):
            j |= ((i >> q) & 1) << perm[q]
        return j

    return f


@pytest.mark.parametrize("n", [28, 29, 30, 31])
def test_bit_reversal_big_composes_to_full_reversal(n):
    """The port's op list, composed at the index level on random sample
    indices, is the full bit reversal."""
    ops = C._bit_reversal_big(n, np.float32)
    assert ops[-1][0] == "sigma_swap"
    maps = [_winfused_index_map(op) if op[0] == "winfused"
            else _sigma_index_map(n, op[1]) for op in ops]
    for i in np.random.default_rng(3).integers(0, 1 << n, size=500):
        j = int(i)
        for f in reversed(maps):
            j = f(j)
        assert j == int(format(int(i), f"0{n}b")[::-1], 2)


def test_bit_reversal_ops_take_the_in_place_route_only_on_the_card():
    """A full 30-qubit float32 run is one in-place reversal (K10's
    reversal form) only for a register on the card; on the CPU (the
    reference's interpret mode) it is the windowed route with one
    permute."""
    dt = np.float32
    cpu = C.bit_reversal_ops(30, [(0, 30)], dt, device="cpu")
    assert cpu[-1][0] == "permute"
    _same_ops(cpu[:-1], RC.bit_reversal_ops(30, [(0, 30)], dt)[:-1])
    assert cpu[-1] == RC.bit_reversal_ops(30, [(0, 30)], dt)[-1]
    card = C.bit_reversal_ops(30, [(0, 30)], dt, device="cuda")
    assert card == [("sigma_rev", 7)]
    assert C.bit_reversal_ops(30, [(0, 30)], np.float64,
                              device="cuda")[-1][0] == "permute"
    assert C.bit_reversal_ops(28, [(0, 28)], dt,
                              device="cuda")[-1][0] == "permute"


def _rev(v, bits):
    return B.rev_bits(np.asarray(v, np.int64), bits)


def _rev_kernel_ctas(n, g):
    """Per CTA of sigma_swap_kernel<true>'s grid, as csrc/qft.cu computes
    them: (A, Bt), the addresses of its tile of slab A, A[r][tx], and of
    its partner tile of slab B, B[r][tx]; the kernel stores B[tx][r] at
    A[r][tx] and A[tx][r] at B[r][tx]."""
    G = 1 << g
    T = min(G, 32)
    nt = G // T
    bb = n - 4 * g
    sS, sB = G, G * G
    sG1 = sB << bb
    sG2 = sG1 * G
    ctab, dtab = B.rev_pair_tables(g)
    r = np.arange(T)
    for c, d in zip(ctab.tolist(), dtab.tolist()):
        for b in range(1 << bb):
            pc, pb, pd = int(_rev(d, g)), int(_rev(b, bb)), int(_rev(c, g))
            if c == pc and pb < b:
                continue
            for blk in range(nt * nt):
                ti, tj = blk // nt, blk % nt
                if c == pc and pb == b and ti > tj:
                    continue
                x0, y0 = ti * T, tj * T
                base_a = c * sG1 + b * sB + d * sS
                base_b = pc * sG1 + pb * sB + pd * sS
                a = base_a + _rev(x0 + r, g)[:, None] * sG2 + y0 + r[None]
                bt = base_b + _rev(y0 + r, g)[:, None] * sG2 + x0 + r[None]
                yield a, bt


@pytest.mark.parametrize("n,g", [(n, 2) for n in range(8, 15)]
                         + [(13, 3), (24, 6), (25, 6)])
def test_rev_kernel_grid_moves_every_element_once_to_its_reversal(n, g):
    """The reversal form's grid at small group widths: the CTAs' tiles
    partition the state (each element pair is moved by exactly one CTA,
    so it runs in place), and each store lands at the bit reversal of the
    element's index (the map is the full reversal, an involution)."""
    cover = np.zeros(1 << n, np.uint8)
    ctas = 0
    for a, bt in _rev_kernel_ctas(n, g):
        np.testing.assert_array_equal(_rev(a, n), bt.T)
        cover[np.union1d(a, bt)] += 1
        ctas += 1
    assert (cover == 1).all()
    G = 1 << g
    assert len(B.rev_pair_tables(g)[0]) == G * (G + 1) // 2
    assert ctas <= (G // min(G, 32)) ** 2 * G * (G + 1) // 2 << (n - 4 * g)


@pytest.mark.parametrize("n", [30, 31, 32, 33, 34])
def test_rev_pair_tables_cover_every_slab_once_at_g7(n):
    """The real tables (g = 7) and the kernel's b loop and skips: every
    slab (G1, b, s) is one CTA row's slab A or slab B, exactly once, and
    slab B holds the reversal images of slab A's elements."""
    g, G, bb = 7, 128, n - 28
    ctab, dtab = (t.astype(np.int64) for t in B.rev_pair_tables(g))
    c = np.repeat(ctab, 1 << bb)
    d = np.repeat(dtab, 1 << bb)
    b = np.tile(np.arange(1 << bb), len(ctab))
    pc, pb, pd = _rev(d, g), _rev(b, bb), _rev(c, g)
    keep = ~((c == pc) & (pb < b))
    c, d, b, pc, pb, pd = (v[keep] for v in (c, d, b, pc, pb, pd))
    slab_a = (c << bb | b) * G + d
    slab_b = (pc << bb | pb) * G + pd
    cover = np.bincount(slab_a, minlength=G * G << bb)
    cover += np.bincount(slab_b[slab_b != slab_a], minlength=G * G << bb)
    assert (cover == 1).all()
    # element (x, y) = (G2, l) of slab A against its image in slab B
    rng = np.random.default_rng(n)
    x, y = rng.integers(0, G, (2, len(c)))
    i = y + (d << 7) + (b << 14) + (c << (14 + bb)) + (x << (21 + bb))
    j = (_rev(x, g) + (pd << 7) + (pb << 14) + (pc << (14 + bb))
         + (_rev(y, g) << (21 + bb)))
    np.testing.assert_array_equal(_rev(i, n), j)


@pytest.mark.parametrize("n,g", [(8, 2), (11, 2), (14, 2), (13, 3), (16, 4)])
def test_bit_reversal_wrapper_on_cpu_is_plain_and_launches_nothing(n, g):
    B.reset_launch_counts()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(2, 1 << n)).astype(np.float32))
    want = kernels.permute_qubits(x, num_qubits=n,
                                  perm=tuple(range(n - 1, -1, -1)))
    y = B.apply_bit_reversal(x, num_qubits=n, group_bits=g)
    assert torch.equal(y, want)
    assert torch.equal(C.execute_plan(x, [("sigma_rev", g)], n), want)
    idx = _rev(np.arange(1 << n), n)
    assert torch.equal(y, x[:, torch.from_numpy(idx)])
    assert torch.equal(B.apply_bit_reversal(y, num_qubits=n, group_bits=g),
                       x)
    bank = torch.from_numpy(rng.normal(size=(3, 2, 1 << n)))
    got = B.apply_bit_reversal(bank, num_qubits=n, group_bits=g)
    for e in range(3):
        assert torch.equal(got[e], B.bit_reversal_plain(
            bank[e], num_qubits=n, group_bits=g))
    assert not any(B.LAUNCHES.values())


@pytest.mark.parametrize("n", [30, 31, 32, 33, 34])
def test_card_route_is_one_in_place_reversal(n):
    ops = C.bit_reversal_ops(n, [(0, n)], np.float32, device="cuda")
    assert ops == [("sigma_rev", 7)]
    assert C.stats(ops)["sigma_rev"] == 1
    assert C.split_plan(ops) == ((("sigma_rev", 7),), [])
    perm = B.reversal_perm(n)

    def f(i):
        j = 0
        for q in range(n):
            j |= ((i >> q) & 1) << perm[q]
        return j

    for i in np.random.default_rng(n).integers(0, 1 << n, size=200):
        assert f(int(i)) == int(format(int(i), f"0{n}b")[::-1], 2)
    # a partial run, two runs, float64 and the sizes either side keep the
    # windowed route
    for m, runs, dt in ((n, [(0, n - 1)], np.float32),
                        (n, [(0, 14), (14, n - 14)], np.float32),
                        (n, [(0, n)], np.float64),
                        (29, [(0, 29)], np.float32),
                        (35, [(0, 35)], np.float32)):
        assert "sigma_rev" not in [op[0] for op in C.bit_reversal_ops(
            m, runs, dt, device="cuda")]


@pytest.mark.parametrize("n", [30, 31])
def test_multilayer_qft_on_the_card_route_plans_one_lane_pass_and_one_reversal(
        monkeypatch, n):
    """_fused_qft_multilayer on a float32 register on the card, built
    without a launch: the ladders' wrapper and the executor are
    monkeypatched; the plan after K8/K9 is the A-only lane pass and the
    in-place reversal, and the span attrs count one reversal launch."""
    seen = {}
    monkeypatch.setattr(C.fused, "apply_qft_multilayer_ladders",
                        lambda amps, **k: amps)
    monkeypatch.setattr(C, "execute_plan",
                        lambda amps, ops, m: seen.setdefault("ops", ops))
    amps = types.SimpleNamespace(dtype=torch.float32,
                                 device=torch.device("cuda"))
    attrs = {}
    C._fused_qft_multilayer(amps, n, n, attrs=attrs)
    ops = seen["ops"]
    assert [op[0] for op in ops] == ["winfused", "sigma_rev"]
    assert ops[0][1] == 7 and ops[0][4:6] == (True, False)
    assert ops[1] == ("sigma_rev", 7)
    assert attrs == {"rev_launches": 1}
    # a partial run keeps the lane fold and the windowed reversal
    C._fused_qft_multilayer(amps, n, n - 1, attrs=attrs)
    assert attrs["rev_launches"] > 1
