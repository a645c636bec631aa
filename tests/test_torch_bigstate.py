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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu import circuit as RC
from quest_tpu.ops import bigstate as RB
from quest_tpu_torch import circuit as C
from quest_tpu_torch.ops import bigstate as B

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
    assert B.LAUNCHES == {"K10": 0, "K10_bank": 0}
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
    """A full 30-qubit float32 run decomposes into window passes and sigma
    only for a register on the card; on the CPU (the reference's interpret
    mode) it is the windowed route with one permute."""
    dt = np.float32
    cpu = C.bit_reversal_ops(30, [(0, 30)], dt, device="cpu")
    assert cpu[-1][0] == "permute"
    _same_ops(cpu[:-1], RC.bit_reversal_ops(30, [(0, 30)], dt)[:-1])
    assert cpu[-1] == RC.bit_reversal_ops(30, [(0, 30)], dt)[-1]
    card = C.bit_reversal_ops(30, [(0, 30)], dt, device="cuda")
    _same_ops(card, RC._bit_reversal_big(30, dt))
    assert C.bit_reversal_ops(30, [(0, 30)], np.float64,
                              device="cuda")[-1][0] == "permute"
    assert C.bit_reversal_ops(28, [(0, 28)], dt,
                              device="cuda")[-1][0] == "permute"
