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


def _haar(rng):
    z = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _every_placement(n, rng):
    """Each gate the chunked form has, on every qubit and every ordered
    pair of qubits, in a random order."""
    calls = []
    for q in range(n):
        calls += [("unitary", (q, _haar(rng))), ("hadamard", (q,))]
    for a in range(n):
        for b in range(n):
            if a != b:
                calls += [("controlledNot", (a, b)),
                          ("controlledPhaseShift",
                           (a, b, float(rng.uniform(0, 2 * math.pi)))),
                          ("swapGate", (a, b))]
    return [calls[i] for i in rng.permutation(len(calls))]


@pytest.mark.parametrize("block", [1 << 24, 8])
@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("chunks,n", [(2, 8), (2, 9), (2, 10), (4, 8),
                                      (4, 9), (4, 10)])
def test_chunked_equals_whole(chunks, n, tf32, block, monkeypatch):
    """The state in 2 or 4 chunks against the whole state: every gate in
    every placement of control and target around the shard bits, and the
    probability of each outcome of every qubit.  Blocks of 8 amplitudes
    (below the chunk's size) take the pairings' paths by block."""
    monkeypatch.setattr(R, "BLOCK", block)
    rng = np.random.default_rng([n, chunks])
    dtype = torch.complex64 if tf32 else torch.complex128
    x = rng.standard_normal((2, 1 << n))
    psi = torch.complex(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    psi = (psi / torch.linalg.vector_norm(psi)).to(dtype)
    whole = psi.clone()
    parts = R.initial_chunks(
        n, ["cpu"] * chunks, dtype,
        (torch.stack([c.real, c.imag]) for c in psi.chunk(chunks)))
    calls = _every_placement(n, rng)
    R.check(calls, "calcProbOfOutcome", chunks)
    R.apply_calls(whole, calls, tf32=tf32)
    R.apply_calls(parts, calls, tf32=tf32)
    tol = 1e-6 if tf32 else 1e-12
    err = torch.linalg.vector_norm(torch.cat(parts) - whole)
    assert float(err / torch.linalg.vector_norm(whole)) <= tol
    for q in range(n):
        for outcome in (0, 1):
            assert R.readout(parts, "calcProbOfOutcome", (q, outcome)) \
                == pytest.approx(R.prob_of_outcome(whole, q, outcome),
                                 abs=tol)


def test_chunked_form_names_a_call_it_lacks():
    with pytest.raises(NotImplementedError, match="applyFullQFT"):
        R.check([("hadamard", (0,)), ("applyFullQFT", ())],
                "calcProbOfOutcome", 4)
    R.check([("applyFullQFT", ())], "calcProbOfOutcome", 1)
