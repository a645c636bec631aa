"""The frozen roofline arithmetic against hand-computed bytes and
operations for three pass shapes."""

import pytest

from qtbench import roofline as RF


def test_dual_rank1_pass_at_2_26():
    # both sides, rank 1, no mask, 2^26 float32 amplitudes
    nbytes, flops = RF.window_pass_cost(1, 2, False, 1 << 26)
    assert nbytes == 2 * 2 * 4 * 67108864 == 1073741824
    assert flops == 8 * 128 * 1 * 2 * 67108864 == 137438953472
    # bytes bind: 0.3205 ms against 0.2777 ms of products
    assert RF.least_s(nbytes, flops) == pytest.approx(1073741824 / 3.35e12)


def test_b_only_masked_pass_at_2_30():
    nbytes, flops = RF.window_pass_cost(1, 1, True, 1 << 30)
    assert nbytes == 17179869184
    assert flops == 8 * 128 * 1073741824 + 6 * 1073741824 == 1105954078720


def test_bank_group_of_two_passes():
    # a megawin group over a bank of 8 x 2^26: a dual rank-2 pass and a
    # one-sided rank-4 pass; the state crosses memory once
    num = 8 << 26
    nbytes, flops = RF.group_cost([(2, 2, False), (4, 1, False)], num)
    assert nbytes == 16 * 536870912 == 8589934592
    assert flops == 8 * 128 * (2 * 2 + 4 * 1) * 536870912 == 4398046511104
    # operations bind: 8.885 ms against 2.564 ms of bytes
    assert RF.least_s(nbytes, flops) == pytest.approx(4398046511104 / 495e12)
