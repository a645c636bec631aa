"""States, plans, Hamiltonians, diagonal operators and measurement
streams carried across.

A state, plan, PauliHamil or DiagonalOp produced elsewhere (for example by
the JAX package, handed over as NumPy arrays) becomes the port's objects
here, so the port can run it; states go back to NumPy for comparison.  The JAX
package's measurement-stream snapshots (JSON dicts) continue in the port
through ``rng_state_from_reference``.  This module imports neither
framework of the other side: it only sees NumPy arrays and dicts.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .circuit import plan_to_device
from .ops import measurement
from .qureg import DiagonalOp, PauliHamil
from .rng import GLOBAL_RNG


def state_from_numpy(amps_np, device, dtype=None) -> torch.Tensor:
    """A SoA amplitude array, (2, 2^n) or canonical (2, nb, 128, 128), as a
    tensor of the same shape on ``device`` (dtype: the array's own, or
    ``dtype``)."""
    a = np.ascontiguousarray(np.asarray(amps_np))
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def state_to_numpy(amps) -> np.ndarray:
    """The inverse of state_from_numpy."""
    return amps.detach().cpu().numpy()


def plan_from_numpy(ops: Sequence[tuple], device, dtype) -> List[tuple]:
    """A plan whose operands are NumPy arrays (or anything np.asarray
    accepts) as the port's plan, with every operand a tensor of ``dtype``
    on ``device``; megawin groups are converted recursively, and the
    paged planner's fused / swapfused passes keep their (h, b, m)."""
    def as_np(op):
        if op[0] == "megawin":
            return ("megawin", tuple(as_np(s) for s in op[1]))
        if op[0] == "winfused":
            mask = op[6] if len(op) > 6 else None
            return ("winfused", int(op[1]), np.asarray(op[2]),
                    np.asarray(op[3]), bool(op[4]), bool(op[5]),
                    None if mask is None else np.asarray(mask))
        if op[0] == "apply":
            return ("apply", tuple(op[1]), np.asarray(op[2]))
        if op[0] == "fused":
            return ("fused", np.asarray(op[1]), np.asarray(op[2]))
        if op[0] == "swapfused":
            return ("swapfused", int(op[1]), int(op[2]), int(op[3]),
                    np.asarray(op[4]), np.asarray(op[5]))
        return tuple(op)

    return plan_to_device([as_np(op) for op in ops], dtype, device)


def pauli_hamil_from_numpy(codes, coeffs) -> PauliHamil:
    """A PauliHamil from a (T, n) code array and (T,) coefficients (the
    reference's ``pauli_codes`` and ``term_coeffs``)."""
    codes = np.asarray(codes)
    coeffs = np.asarray(coeffs, dtype=np.float64).ravel()
    if codes.ndim != 2 or codes.shape[0] != coeffs.size:
        raise ValueError(f"codes {codes.shape} do not match {coeffs.size} "
                         "coefficients")
    h = PauliHamil(codes.shape[1], codes.shape[0])
    h.pauli_codes[...] = codes
    h.term_coeffs[:] = coeffs
    return h


def diagonal_op_from_numpy(real, imag, env, dtype=None) -> DiagonalOp:
    """A DiagonalOp on ``env``'s device from its real and imaginary (2^n,)
    vectors (a JAX package DiagonalOp's ``real`` and ``imag`` as NumPy),
    in ``dtype`` (default: the working precision's)."""
    real = np.asarray(real).ravel()
    imag = np.asarray(imag).ravel()
    n = real.size.bit_length() - 1
    if real.size != 1 << n or imag.size != real.size:
        raise ValueError(f"a diagonal operator holds 2^n values, got "
                         f"{real.size} and {imag.size}")
    op = DiagonalOp(n, env)
    dt = dtype or op.real.dtype
    op.real = torch.tensor(real, dtype=dt, device=op.real.device)
    op.imag = torch.tensor(imag, dtype=dt, device=op.imag.device)
    return op


def rng_state_from_reference(rng_state: dict, key_state: dict) -> None:
    """Continue the JAX package's two measurement streams in the port:
    ``rng_state`` is its ``GLOBAL_RNG.get_state()`` (the host Mersenne
    Twister of QT_HOST_MEASURE=1), ``key_state`` its
    ``measurement.KEYS.get_state()`` (the threefry key and shot counter
    of the default route).  The port's next outcomes are the ones the
    JAX package would draw next."""
    GLOBAL_RNG.set_state(rng_state)
    measurement.KEYS.set_state(key_state)
