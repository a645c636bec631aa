"""The plain reference against exact answers."""

import math

import numpy as np
import pytest
import torch

from qtbench.circuits import qft
from qtbench.reference import statevec as R


def zero(n):
    psi = torch.zeros(1 << n, dtype=torch.complex128)
    psi[0] = 1.0
    return psi


def test_bell_pair():
    psi = zero(2)
    R.apply_calls(psi, [("hadamard", (0,)), ("controlledNot", (0, 1))])
    want = torch.tensor([1, 0, 0, 1], dtype=torch.complex128) / math.sqrt(2)
    assert torch.allclose(psi, want, atol=1e-15)
    assert R.prob_of_outcome(psi, 1, 0) == pytest.approx(0.5, abs=1e-15)


@pytest.mark.parametrize("n,x", [(3, 5), (6, 1), (7, 100)])
def test_qft_of_a_basis_state(n, x):
    """QFT |x> = 2^(-n/2) sum_y e^(2 pi i x y / 2^n) |y>."""
    N = 1 << n
    psi = torch.zeros(N, dtype=torch.complex128)
    psi[x] = 1.0
    R.full_qft(psi, block=4)
    y = np.arange(N)
    want = np.exp(2j * np.pi * x * y / N) / math.sqrt(N)
    assert np.allclose(psi.numpy(), want, atol=1e-14)


@pytest.mark.parametrize("n", [5, 8])
def test_qft_gates_equal_the_transform(n):
    gen = torch.Generator().manual_seed(n)
    psi = torch.complex(torch.randn(1 << n, generator=gen, dtype=torch.float64),
                        torch.randn(1 << n, generator=gen, dtype=torch.float64))
    a, b = psi.clone(), psi.clone()
    R.full_qft(a)
    R.apply_calls(b, qft.register_calls({"num_qubits": n}, 0, route="gates"))
    assert torch.allclose(a, b, atol=1e-12)


def test_swap_and_phase():
    psi = torch.arange(8, dtype=torch.float64).to(torch.complex128)
    R.swap_gate(psi, 0, 2)                 # index bits b2 b1 b0 -> b0 b1 b2
    assert psi.real.tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
    R.controlled_phase_shift(psi, 0, 1, math.pi)
    assert psi.real.tolist() == [0, 4, 2, -6, 1, 5, 3, -7]


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      1.0 + 2 ** -10], dtype=torch.float32)
    got = R.tf32_round(x).tolist()
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert got == [1.0, 1.0, 1.0 + 2 ** -9, -1.0, 1.0 + 2 ** -10]
