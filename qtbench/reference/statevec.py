"""The plain reference: a state vector of 2^n complex amplitudes in plain
PyTorch, with the QuEST calls the benchmark's circuits use applied one by
one, and the quantum Fourier transform as a discrete Fourier transform.

Index order is QuEST's: qubit q is bit q of the amplitude index.  Every
function works on a complex tensor ``psi`` of 2^n entries in place, on the
device it lives on.  Nothing here imports the program under test: the
reference takes the inputs the benchmark makes (matrices, angles, the
seeded state) and works out every result again.

A state too large for one device is a list of R = 2^r complex chunks,
chunk c holding the indices [c 2^m, (c + 1) 2^m) with m = n - r, each on
its own device: the split the program's registers use, so that chunk c
lies beside the program's shard c.  A call runs the functions above on
blocks of at most ``BLOCK`` amplitudes: in place on each block where its
qubits lie below the block's bits, and else on the 2 or 4 blocks that
differ in its higher qubits (of one chunk, or of chunks that differ in a
shard bit), copied end to end onto the first one's device and back.  One
chunk is the whole state, and runs the functions above on it unchanged.  The harness calls ``initial_chunks``,
``check``, ``apply_calls`` and ``readout``.

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


# ---------------------------------------------------------------------------
# the state in chunks, one a device
# ---------------------------------------------------------------------------

BLOCK = 1 << 24     # amplitudes in a block: the most a call copies at once


def _on_blocks(chunks, qubits, fn) -> None:
    """Run ``fn(mini, where)`` over the chunked state block by block: a
    block is BLOCK amplitudes (or a chunk, where smaller) of one chunk,
    and ``mini`` is a small state of the blocks that differ only in the
    bits of ``qubits`` at or above the block's, laid end to end (one
    block, in place, where there are none).  ``where[q]`` is qubit q's
    bit in ``mini``: q itself below the block's bits, the next bits above
    them for the others, in order.  ``mini`` is copied back to its
    blocks on their own devices."""
    size = chunks[0].numel()
    step = min(BLOCK, size)
    low = step.bit_length() - 1
    high = sorted(q for q in set(qubits) if q >= low)
    where = {q: q if q < low else low + high.index(q) for q in qubits}
    blocks = (len(chunks) * size) // step
    for g in range(blocks):
        if any(g >> (q - low) & 1 for q in high):
            continue
        members = []
        for k in range(1 << len(high)):
            gk = g
            for j, q in enumerate(high):
                gk |= (k >> j & 1) << (q - low)
            c, s = divmod(gk * step, size)
            members.append(chunks[c][s:s + step])
        if len(members) == 1:
            fn(members[0], where)
            continue
        dev = members[0].device
        mini = torch.cat([x.to(dev) for x in members])
        fn(mini, where)
        for k, x in enumerate(members):
            x.copy_(mini[k * step:(k + 1) * step].to(x.device))
        del mini


def chunked_prob_of_outcome(chunks, qubit: int, outcome: int) -> float:
    """P(qubit = outcome) of the chunked state, summed in float64 block
    by block."""
    if len(chunks) == 1:
        return prob_of_outcome(chunks[0], qubit, outcome)
    size = chunks[0].numel()
    step = min(BLOCK, size)
    low = step.bit_length() - 1
    total = 0.0
    for c, psi in enumerate(chunks):
        for s in range(0, size, step):
            x = psi[s:s + step]
            if qubit < low:
                total += prob_of_outcome(x, qubit, outcome)
            elif ((c * size + s) >> qubit & 1) == outcome:
                total += float(torch.sum(x.real.double() ** 2
                                         + x.imag.double() ** 2))
    return total


def expec_z_sum(chunks, codes, coeffs) -> float:
    """sum_t coeffs[t] <Z_q> for terms that are one Z each (Pauli codes 0
    = I, 3 = Z), <Z_q> = 2 P(q = 0) - 1."""
    total = 0.0
    for term, coeff in zip(codes, coeffs):
        zs = [q for q, code in enumerate(term) if code]
        if len(zs) != 1 or term[zs[0]] != 3:
            raise NotImplementedError(
                f"the reference reads a Pauli term of one Z only, not {term}")
        total += coeff * (2.0 * chunked_prob_of_outcome(chunks, zs[0], 0)
                          - 1.0)
    return total


CALLS = {
    "unitary": unitary,
    "hadamard": hadamard,
    "controlledNot": controlled_not,
    "controlledPhaseShift": controlled_phase_shift,
    "swapGate": swap_gate,
    "applyFullQFT": full_qft,
}

# the calls a state of several chunks takes, and how many of each call's
# leading arguments are qubits
CHUNKED = {
    "unitary": 1,
    "hadamard": 1,
    "controlledNot": 2,
    "controlledPhaseShift": 2,
    "swapGate": 2,
}

# the read-outs, by QuEST name, of one register (a bank's, of one element)
READOUTS = {
    "calcProbOfOutcome": chunked_prob_of_outcome,
    "calcExpecPauliSumBatched": expec_z_sum,
}


def initial_chunks(n: int, devices, dtype, reals=None) -> list:
    """The initial state of ``n`` qubits as len(devices) chunks, chunk c
    on ``devices[c]``: |0...0>, or the benchmark's draw where ``reals``
    yields each chunk's (2, 2^m) real and imaginary parts in turn (each
    converted and released before the next is drawn)."""
    size = (1 << n) // len(devices)
    chunks = []
    if reals is None:
        for dev in devices:
            chunks.append(torch.zeros(size, dtype=dtype, device=dev))
        chunks[0][0] = 1.0
        return chunks
    real = dtype.to_real()
    for x in reals:
        chunks.append(torch.complex(x[0].to(real), x[1].to(real)))
        del x
    return chunks


def check(calls, readout: str, num_chunks: int) -> None:
    """Raise, naming it, where a call or the read-out has no form here
    for a state of ``num_chunks`` chunks (before the window opens)."""
    table = CALLS if num_chunks == 1 else CHUNKED
    for name, _args in calls:
        if name not in table:
            raise NotImplementedError(
                f"the reference has no {name!r} for a state in "
                f"{num_chunks} chunks")
    if readout not in READOUTS:
        raise NotImplementedError(
            f"the reference has no read-out {readout!r}")


def apply_calls(psi, calls, tf32: bool = False) -> None:
    """Apply the benchmark's calls [(QuEST name, args after the
    register)] in order to ``psi``: one tensor, or a list of chunks."""
    chunks = [psi] if isinstance(psi, torch.Tensor) else psi
    if len(chunks) == 1:
        for name, args in calls:
            CALLS[name](chunks[0], *args, tf32=tf32)
        return
    for name, args in calls:
        qubits, rest = args[:CHUNKED[name]], args[CHUNKED[name]:]

        def call(mini, where):
            CALLS[name](mini, *[where[q] for q in qubits], *rest,
                        tf32=tf32)

        _on_blocks(chunks, qubits, call)


def readout(chunks, name: str, args) -> float:
    """The read-out ``name`` (a QuEST name, with its arguments after the
    register) of the chunked state."""
    return READOUTS[name](chunks, *args)
