"""Reductions: probabilities, inner products, purity and fidelity.

Counterparts of the JAX package's ``ops/calculations.py`` (reference
``calc*`` kernels, QuEST_cpu.c:3363-3645), as single PyTorch reductions
over the SoA state.  Scalar results return as 0-d tensors, complex ones as
stacked (2,) tensors; the API layer converts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cplx
from .kernels import _interleaved


def calc_total_prob_statevec(amps):
    """Sum of |amp|^2."""
    return torch.sum(cplx.abs2(amps))


def _diag(amps, num_qubits: int):
    """Diagonal of the column-major flattened rho: (2, dim) stacked."""
    dim = 1 << num_qubits
    return torch.diagonal(amps.reshape(2, dim, dim), dim1=1, dim2=2)


def calc_total_prob_density(amps, *, num_qubits: int):
    """Re(trace(rho)) (densmatr_calcTotalProb)."""
    return torch.sum(_diag(amps, num_qubits)[0])


def calc_prob_of_outcome_statevec(amps, *, num_qubits: int, target: int,
                                  outcome: int):
    """(statevec_calcProbOfOutcome, QuEST_cpu.c:3418-3508): the sum of
    |amp|^2 over the half of the index space whose target bit equals
    ``outcome``."""
    n = num_qubits
    view = amps.reshape(2, 1 << (n - 1 - target), 2, 1 << target)
    return torch.sum(cplx.abs2(view[:, :, int(outcome), :]))


def calc_prob_of_outcome_density(amps, *, num_qubits: int, target: int,
                                 outcome: int):
    """Sum of diagonal rho elements whose target bit equals outcome
    (densmatr_calcProbOfOutcome, QuEST_cpu.c:3363-3417)."""
    d = _diag(amps, num_qubits)[0]
    view = d.reshape(1 << (num_qubits - 1 - target), 2, 1 << target)
    return torch.sum(view[:, int(outcome), :])


def calc_prob_of_all_outcomes_statevec(amps, *, num_qubits: int,
                                       qubits: Tuple[int, ...]):
    """2^k-outcome histogram; outcome index bit j <-> qubits[j]
    (calcProbOfAllOutcomes, QuEST_cpu.c:3510-3574)."""
    return _outcome_histogram(cplx.abs2(amps), num_qubits, qubits)


def calc_prob_of_all_outcomes_density(amps, *, num_qubits: int,
                                      qubits: Tuple[int, ...]):
    return _outcome_histogram(_diag(amps, num_qubits)[0], num_qubits, qubits)


def _outcome_histogram(vals, n: int, qubits: Tuple[int, ...]):
    """Sum ``vals`` (one value per basis state) grouped by the bits of
    ``qubits``."""
    shape, axis_of = _interleaved(n, qubits)
    vals = vals.reshape(shape[1:])
    keep = [axis_of[q] - 1 for q in reversed(qubits)]   # MSB first
    gaps = [a for a in range(vals.dim()) if a not in keep]
    hist = torch.sum(vals, dim=gaps) if gaps else vals
    # the surviving axes are in ascending axis order; put qubits[k-1]
    # first so the flat index is sum_j bit_j << j
    ascending = sorted(keep)
    hist = hist.permute([ascending.index(a) for a in keep])
    return hist.reshape(-1)


def calc_inner_product(bra_amps, ket_amps):
    """<bra|ket> -> stacked (2,) (statevec_calcInnerProductLocal,
    QuEST_cpu.c:1071)."""
    return cplx.vdot(bra_amps, ket_amps)


def calc_density_inner_product(rho1_amps, rho2_amps):
    """Re Tr(rho1^dagger rho2) (densmatr_calcInnerProductLocal,
    QuEST_cpu.c:958)."""
    return torch.sum(rho1_amps[0] * rho2_amps[0]
                     + rho1_amps[1] * rho2_amps[1])


def calc_purity(rho_amps):
    """Tr(rho^2) = sum |rho_rc|^2 for Hermitian rho (calcPurityLocal,
    QuEST_cpu.c:861)."""
    return torch.sum(cplx.abs2(rho_amps))


def calc_fidelity_density(rho_amps, psi_amps, *, num_qubits: int):
    """<psi|rho|psi> (densmatr_calcFidelityLocal, QuEST_cpu.c:990): two
    matrix-vector products per plane (the JAX package leaves them to XLA
    likewise), then one reduction."""
    dim = 1 << num_qubits
    m = rho_amps.reshape(2, dim, dim)   # [channel, col, row]
    p0, p1 = psi_amps[0], psi_amps[1]
    # v_c = sum_r rho_{r,c} conj(psi_r)
    v_re = torch.matmul(m[0], p0) + torch.matmul(m[1], p1)
    v_im = torch.matmul(m[1], p0) - torch.matmul(m[0], p1)
    # Re(sum_c psi_c v_c)
    return torch.sum(p0 * v_re - p1 * v_im)


def calc_hilbert_schmidt_distance(rho1_amps, rho2_amps):
    """sqrt(sum |rho1 - rho2|^2) (calcHilbertSchmidtDistanceSquaredLocal,
    QuEST_cpu.c:923)."""
    return torch.sqrt(torch.sum(cplx.abs2(rho1_amps - rho2_amps)))


def calc_expec_diagonal_statevec(amps, op_real, op_imag):
    """sum_i |amp_i|^2 d_i -> stacked (2,) (statevec_calcExpecDiagonalOp,
    QuEST_cpu.c:4094-4126)."""
    p = cplx.abs2(amps)
    return torch.stack([torch.sum(p * op_real), torch.sum(p * op_imag)])


def calc_expec_diagonal_density(amps, op_real, op_imag, *, num_qubits: int):
    """sum_r d_r rho_rr -> stacked (2,) (densmatr_calcExpecDiagonalOp,
    QuEST_cpu.c:4127-4186)."""
    d = _diag(amps, num_qubits)
    re = torch.sum(d[0] * op_real - d[1] * op_imag)
    im = torch.sum(d[0] * op_imag + d[1] * op_real)
    return torch.stack([re, im])
