"""The plain reference: a state vector of 2^n complex amplitudes in plain
PyTorch, with the QuEST calls the benchmark's circuits use applied one by
one, and the quantum Fourier transform as a discrete Fourier transform.

Index order is QuEST's: qubit q is bit q of the amplitude index.  Every
function works on a complex tensor ``psi`` of 2^n entries in place, on the
device it lives on.  Nothing here imports the program under test: the
reference takes the inputs the benchmark makes (matrices, angles, the
seeded state) and works out every result again.

``tf32=True`` rounds every operand of a product to TF32 (10 explicit
mantissa bits, round to nearest even) and the result back to float32
after each step, as a float32 product on the tensor cores with TF32 on
would: the control that a float32 simulator must be told apart from.
"""

from __future__ import annotations

import math

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) with each real part rounded to the
    nearest TF32 value (ties to even)."""
    if x.is_complex():
        return torch.complex(tf32_round(x.real.contiguous()),
                             tf32_round(x.imag.contiguous()))
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _views(psi: torch.Tensor, a: int, b: int):
    """psi as (2^(n-hi-1), 2, 2^(hi-lo-1), 2, 2^lo) with hi = max(a, b),
    lo = min(a, b), and the axes of a and b in that view."""
    n = psi.numel().bit_length() - 1
    hi, lo = max(a, b), min(a, b)
    v = psi.view(1 << (n - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    return v, (1 if a == hi else 3), (1 if b == hi else 3)


def _bit(v: torch.Tensor, axis: int, value: int, other: int = None,
         other_value: int = None):
    index = [slice(None)] * 5
    index[axis] = value
    if other is not None:
        index[other] = other_value
    return v[tuple(index)]


def unitary(psi: torch.Tensor, target: int, u, tf32: bool = False) -> None:
    """A 2x2 matrix ``u`` (nested sequence or array of complex) on
    ``target``."""
    n = psi.numel().bit_length() - 1
    v = psi.view(1 << (n - target - 1), 2, 1 << target)
    m = torch.as_tensor(u, dtype=psi.dtype).to(psi.device)
    rnd = tf32_round if tf32 else (lambda t: t)
    m = rnd(m)
    a0, a1 = rnd(v[:, 0].clone()), rnd(v[:, 1].clone())
    v[:, 0] = rnd(m[0, 0] * a0 + m[0, 1] * a1)
    v[:, 1] = rnd(m[1, 0] * a0 + m[1, 1] * a1)


def hadamard(psi: torch.Tensor, target: int, tf32: bool = False) -> None:
    h = 1.0 / math.sqrt(2.0)
    unitary(psi, target, [[h, h], [h, -h]], tf32)


def controlled_not(psi: torch.Tensor, control: int, target: int,
                   tf32: bool = False) -> None:
    v, ca, ta = _views(psi, control, target)
    lo = _bit(v, ca, 1, ta, 0).clone()
    _bit(v, ca, 1, ta, 0).copy_(_bit(v, ca, 1, ta, 1))
    _bit(v, ca, 1, ta, 1).copy_(lo)


def controlled_phase_shift(psi: torch.Tensor, q1: int, q2: int,
                           angle: float, tf32: bool = False) -> None:
    v, a1, a2 = _views(psi, q1, q2)
    phase = torch.tensor(complex(math.cos(angle), math.sin(angle)),
                         dtype=psi.dtype, device=psi.device)
    both = _bit(v, a1, 1, a2, 1)
    if tf32:
        both.copy_(tf32_round(tf32_round(both) * tf32_round(phase)))
    else:
        both.mul_(phase)


def swap_gate(psi: torch.Tensor, q1: int, q2: int,
              tf32: bool = False) -> None:
    v, a1, a2 = _views(psi, q1, q2)
    one_zero = _bit(v, a1, 1, a2, 0).clone()
    _bit(v, a1, 1, a2, 0).copy_(_bit(v, a1, 0, a2, 1))
    _bit(v, a1, 0, a2, 1).copy_(one_zero)


def full_qft(psi: torch.Tensor, tf32: bool = False,
             block: int = 1 << 24) -> None:
    """The QFT of the whole register, |x> -> 2^(-n/2) sum_y e^(2 pi i x y
    / 2^n) |y>, as a four-step DFT over (2^n1, 2^n2) with n1 + n2 = n, in
    blocks of about ``block`` amplitudes: it needs a second state for the
    final transpose and a block of scratch."""
    n = psi.numel().bit_length() - 1
    n1 = n // 2
    n2 = n - n1
    N1, N2 = 1 << n1, 1 << n2
    # index x = x1 + N1 * x2 (x1 < N1, x2 < N2); output y = y2 + N2 * y1
    # X[y2 + N2 y1] = sum_x1 w^(x1 y2) e^(2 pi i x1 y1 / N1)
    #                 [sum_x2 e^(2 pi i x2 y2 / N2) x[x1 + N1 x2]]
    # with w = e^(2 pi i / N): first a DFT over x2 for each x1, a twiddle,
    # then a DFT over x1 for each y2.
    grid = psi.view(N2, N1)            # grid[x2, x1]
    rnd = tf32_round if tf32 else (lambda t: t)
    cols = max(1, block // N2)
    real = torch.float64 if psi.dtype == torch.complex128 else torch.float32
    y2 = torch.arange(N2, device=psi.device, dtype=real)
    for c0 in range(0, N1, cols):
        part = rnd(grid[:, c0:c0 + cols])
        # sum over x2 with e^(+...): N2 * ifft along dim 0
        out = torch.fft.ifft(part, dim=0) * N2
        x1 = torch.arange(c0, min(c0 + cols, N1), device=psi.device,
                          dtype=real)
        ang = (2.0 * math.pi / (N1 * N2)) * torch.outer(y2, x1)
        tw = rnd(torch.polar(torch.ones_like(ang), ang).to(psi.dtype))
        grid[:, c0:c0 + cols] = rnd(rnd(out) * tw)
    rows = max(1, block // N1)
    # grid[y2, x1] now; the DFT over x1 for each y2 gives out[y2, y1],
    # which belongs at index y2 + N2 y1: a transpose of the grid
    result = torch.empty_like(psi).view(N1, N2)
    for r0 in range(0, N2, rows):
        part = grid[r0:r0 + rows]
        out = torch.fft.ifft(part, dim=1) * N1     # out[y2, y1]
        result[:, r0:r0 + rows] = rnd(out).transpose(0, 1)
    result.div_(math.sqrt(N1 * N2))
    psi.copy_(rnd(result).view(-1))


def prob_of_outcome(psi: torch.Tensor, qubit: int, outcome: int) -> float:
    """P(qubit = outcome), summed in float64."""
    n = psi.numel().bit_length() - 1
    v = psi.view(1 << (n - qubit - 1), 2, 1 << qubit)[:, outcome]
    return float(torch.sum(v.real.double() ** 2 + v.imag.double() ** 2))


CALLS = {
    "unitary": unitary,
    "hadamard": hadamard,
    "controlledNot": controlled_not,
    "controlledPhaseShift": controlled_phase_shift,
    "swapGate": swap_gate,
    "applyFullQFT": full_qft,
}


def apply_calls(psi: torch.Tensor, calls, tf32: bool = False) -> None:
    """Apply the benchmark's calls [(QuEST name, args after the
    register)] to ``psi`` in order."""
    for name, args in calls:
        CALLS[name](psi, *args, tf32=tf32)
