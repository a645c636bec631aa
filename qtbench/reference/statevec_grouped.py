"""The plain reference of ``statevec`` with runs of calls grouped: the same
state, chunks and read-outs, but consecutive calls are multiplied into one
dense operator on a few qubits before they touch the state, and the
operator is applied to each block by one complex matrix product.

``statevec`` applies a one-qubit unitary with about ten elementwise
passes over each of its blocks of 2^24 amplitudes, and a 33-qubit state
of 980 calls then takes minutes on four cards.  Here a call joins the run
before it while the run's qubits number at most ``K`` and at most
``HIGH`` of them lie at or above a block's bits (blocks of 2^BLOCK_BITS
amplitudes: a group of blocks that differ in those qubits is at most four
blocks); otherwise the run is applied and the call starts the next.  A
run costs one product and one copy back a block, however many calls it
holds.  A group of blocks on several devices (a run on a chunk's bits) is
copied end to end onto one of them and back, the groups taking the
devices in turn, so that every device computes its share.

The operators are built on the host in complex128 (NumPy) by index
arithmetic alone: a call's matrix embedded on the run's qubits (bit j of
an operator's index is the run's j-th qubit in ascending order, as bit q
of an amplitude's index is qubit q), multiplied on the left.  Nothing here
imports the program under test, or ``statevec``: the chunked layout, the
initial state and the read-outs are the same as there, written again.
There is no TF32 form: a cell that names this reference has a control of
the program's, not of the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the most qubits one run's operator acts on: a 64 x 64 complex128
# product costs 8 x 64 operations an amplitude, about what the card's
# float64 rate does in the time its memory moves the amplitude twice
K = 6
# the most qubits of a run at or above a block's bits
HIGH = 2
# a block's amplitudes: 537 MB at complex128; a group of four (2.1 GB),
# its product and a contraction's copies of it, beside a 34.4 GB chunk
# and the program's 17.2 GB shard, fit a card of 80 GB
BLOCK_BITS = 25

_H = 1.0 / math.sqrt(2.0)


def gate(name: str, args):
    """(qubits, matrix) of a call: the matrix's index bit j is qubit
    ``qubits[j]``."""
    if name == "unitary":
        return (args[0],), np.asarray(args[1], dtype=np.complex128)
    if name == "hadamard":
        return (args[0],), np.array([[_H, _H], [_H, -_H]],
                                    dtype=np.complex128)
    eye = np.eye(4, dtype=np.complex128)
    if name == "controlledNot":        # index = control + 2 target
        return tuple(args[:2]), eye[:, [0, 3, 2, 1]]
    if name == "swapGate":
        return tuple(args[:2]), eye[:, [0, 2, 1, 3]]
    if name == "controlledPhaseShift":
        m = eye.copy()
        m[3, 3] = complex(math.cos(args[2]), math.sin(args[2]))
        return tuple(args[:2]), m
    raise NotImplementedError(f"the reference has no {name!r}")


GATES = ("unitary", "hadamard", "controlledNot", "swapGate",
         "controlledPhaseShift")


def embed(matrix: np.ndarray, qubits, run) -> np.ndarray:
    """``matrix`` on ``qubits`` as an operator on ``run`` (ascending,
    holding every one of ``qubits``): identity on the others."""
    pos = [run.index(q) for q in qubits]
    idx = np.arange(1 << len(run))
    sub = np.zeros_like(idx)
    for j, p in enumerate(pos):
        sub |= ((idx >> p) & 1) << j
    rest = idx & ~sum(1 << p for p in pos)
    same = rest[:, None] == rest[None, :]
    return np.where(same, matrix[sub[:, None], sub[None, :]], 0.0)


def runs(calls, low: int):
    """[(run's qubits, ascending; its operator)] of ``calls`` in order,
    ``low`` the block's bits."""
    out = []
    qubits, op = [], None
    for name, args in calls:
        gq, gm = gate(name, args)
        merged = sorted(set(qubits) | set(gq))
        if op is not None and (len(merged) > K or sum(
                q >= low for q in merged) > HIGH):
            out.append((tuple(qubits), op))
            qubits, op = [], None
            merged = sorted(gq)
        op = embed(gm, gq, merged) @ (
            embed(op, qubits, merged) if op is not None
            else np.eye(1 << len(merged), dtype=np.complex128))
        qubits = merged
    if op is not None:
        out.append((tuple(qubits), op))
    return out


def apply_dense(psi: torch.Tensor, bits, op: torch.Tensor) -> None:
    """The operator ``op`` (2^k x 2^k, on ``psi``'s device) on bits
    ``bits`` (ascending) of the state ``psi``, in place: one product where
    the bits are contiguous, else a contraction over the view that holds
    each of them as an axis."""
    n = psi.numel().bit_length() - 1
    k = len(bits)
    lo = bits[0]
    if list(bits) == list(range(lo, lo + k)):
        if lo == 0:
            out = psi.view(-1, 1 << k) @ op.transpose(0, 1)
        else:
            out = torch.matmul(op, psi.view(-1, 1 << k, 1 << lo))
        psi.copy_(out.view(-1))
        return
    # axes from the top: the span above the highest bit, that bit, the
    # span below it, ..., the lowest bit, the span under it
    dims, top = [], n
    for b in reversed(bits):
        dims += [1 << (top - b - 1), 2]
        top = b
    dims.append(1 << bits[0])
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    state, ins, outs = [], [], []
    for i in range(len(dims)):
        if i % 2:
            ins.append(next(letters))
            outs.append(next(letters))
            state.append(ins[-1])
        else:
            state.append(next(letters))
    result = "".join(outs[(i - 1) // 2] if i % 2 else s
                     for i, s in enumerate(state))
    spec = f"{''.join(outs)}{''.join(ins)},{''.join(state)}->{result}"
    out = torch.einsum(spec, op.reshape([2] * (2 * k)), psi.view(dims))
    psi.copy_(out.reshape(-1))


def initial_chunks(n: int, devices, dtype, reals=None) -> list:
    """The initial state of ``n`` qubits as len(devices) chunks, chunk c
    (indices [c 2^m, (c + 1) 2^m)) on ``devices[c]``: |0...0>, or the
    benchmark's draw where ``reals`` yields each chunk's (2, 2^m) real and
    imaginary parts in turn (each converted and released before the next
    is drawn)."""
    size = (1 << n) // len(devices)
    if reals is None:
        chunks = [torch.zeros(size, dtype=dtype, device=dev)
                  for dev in devices]
        chunks[0][0] = 1.0
        return chunks
    real = dtype.to_real()
    chunks = []
    for x in reals:
        chunks.append(torch.complex(x[0].to(real), x[1].to(real)))
        del x
    return chunks


def prob_of_outcome(chunks, qubit: int, outcome: int) -> float:
    """P(qubit = outcome) of the chunked state, summed in float64 block
    by block."""
    size = chunks[0].numel()
    step = 1 << min(BLOCK_BITS, size.bit_length() - 1)
    total = 0.0
    for c, psi in enumerate(chunks):
        for s in range(0, size, step):
            x = psi[s:s + step]
            if (1 << qubit) < step:
                x = x.view(-1, 2, 1 << qubit)[:, outcome]
            elif ((c * size + s) >> qubit & 1) != outcome:
                continue
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
        total += coeff * (2.0 * prob_of_outcome(chunks, zs[0], 0) - 1.0)
    return total


# the read-outs, by QuEST name, of one register (a bank's, of one element)
READOUTS = {
    "calcProbOfOutcome": prob_of_outcome,
    "calcExpecPauliSumBatched": expec_z_sum,
}


def readout(chunks, name: str, args) -> float:
    """The read-out ``name`` (a QuEST name, with its arguments after the
    register) of the chunked state."""
    return READOUTS[name](chunks, *args)


def check(calls, readout_name: str, num_chunks: int) -> None:
    """Raise, naming it, where a call or the read-out has no form here
    (before the window opens)."""
    for name, _args in calls:
        if name not in GATES:
            raise NotImplementedError(
                f"the reference has no {name!r}: statevec_grouped takes "
                f"{', '.join(GATES)}")
    if readout_name not in READOUTS:
        raise NotImplementedError(
            f"the reference has no read-out {readout_name!r}")


def _on_blocks(chunks, qubits, fn) -> None:
    """Run ``fn(mini, where)`` over the chunked state block by block:
    ``mini`` is a block, or the blocks that differ only in the bits of
    ``qubits`` at or above a block's laid end to end on one of their
    devices (each group on the next of its members' devices), and
    ``where[q]`` qubit q's bit in ``mini``; ``mini`` is copied back to its
    blocks."""
    size = chunks[0].numel()
    low = min(BLOCK_BITS, size.bit_length() - 1)
    step = 1 << low
    high = sorted(q for q in set(qubits) if q >= low)
    where = {q: q if q < low else low + high.index(q) for q in qubits}
    turn = 0
    for g in range(len(chunks) * size // step):
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
        dev = members[turn % len(members)].device
        turn += 1
        mini = torch.empty(len(members) * step, dtype=members[0].dtype,
                           device=dev)
        for k, x in enumerate(members):
            mini[k * step:(k + 1) * step].copy_(x)
        fn(mini, where)
        for k, x in enumerate(members):
            x.copy_(mini[k * step:(k + 1) * step])
        del mini


def apply_calls(psi, calls, tf32: bool = False) -> None:
    """Apply the benchmark's calls [(QuEST name, args after the
    register)] in order to ``psi``: one tensor, or a list of chunks."""
    if tf32:
        raise NotImplementedError("statevec_grouped has no TF32 form; "
                                  "statevec has")
    chunks = [psi] if isinstance(psi, torch.Tensor) else psi
    low = min(BLOCK_BITS, chunks[0].numel().bit_length() - 1)
    for qubits, op in runs(calls, low):
        ops: dict = {}

        def one(mini, where, qubits=qubits, op=op, ops=ops):
            dev = mini.device
            if dev not in ops:
                ops[dev] = torch.as_tensor(op, dtype=mini.dtype).to(dev)
            apply_dense(mini, [where[q] for q in qubits], ops[dev])

        _on_blocks(chunks, qubits, one)
