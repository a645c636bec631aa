"""Reductions: probabilities, inner products, purity and fidelity.

Counterparts of the JAX package's ``ops/calculations.py`` (reference
``calc*`` kernels, QuEST_cpu.c:3363-3645), as single PyTorch reductions
over the SoA state.  Scalar results return as 0-d tensors, complex ones as
stacked (2,) tensors; the API layer converts.

Quad precision (``set_precision(4)``) passes ``quad=True``: the reduction
accumulates in double-double (``quad_sum``).  Block partials are summed
on the device and their compensated (Neumaier) combine runs on the host
after one copy of at most 256 values (2 KB), with the IEEE steps of the
JAX package's ``lax.scan``; the quad results are 0-d (or (2,)) float64
tensors on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cplx
from .kernels import _interleaved


def calc_total_prob_statevec(amps):
    """Sum of |amp|^2."""
    return torch.sum(cplx.abs2(amps))


# ---------------------------------------------------------------------------
# Quad-precision (QuEST_PREC=4) reductions: double-double accumulation
# ---------------------------------------------------------------------------

_QUAD_BLOCK = 256


def neumaier_sum(vals) -> float:
    """Neumaier's compensated sum of a short 1-D sequence (a tensor on any
    device, or host numbers), in order: the serial combine of the JAX
    package's ``neumaier_sum`` (a ``lax.scan``), step for step in IEEE
    float64 on the host after one copy."""
    s, c = neumaier_pair(vals)
    return float(s + c)


def neumaier_pair(vals):
    """Neumaier's sum of ``vals`` as its (sum, compensation) pair, not
    yet rounded to one float64: a double-double value that a later
    combine can carry on (a shard's term value of the sharded quad Pauli
    scan, parallel/composites.py)."""
    if torch.is_tensor(vals):
        vals = vals.detach().reshape(-1).cpu().numpy()
    vals = np.asarray(vals, dtype=np.float64).reshape(-1)
    s = c = np.float64(0.0)
    for v in vals:
        t = s + v
        c = c + (((s - t) + v) if abs(s) >= abs(v) else ((v - t) + s))
        s = t
    return s, c


def _quad_partials(x):
    """The JAX package's block partials of ``quad_sum``: sums of blocks
    of 256 values, and above 256 blocks a second level of 256 sums."""
    flat = x.reshape(-1)
    nb = max(1, flat.numel() // _QUAD_BLOCK)
    partials = flat.reshape(nb, -1).sum(dim=1)
    if nb > _QUAD_BLOCK:
        partials = partials.reshape(_QUAD_BLOCK, -1).sum(dim=1)
    return partials


def quad_layout(total: int) -> Tuple[int, int]:
    """(values per first-level block, first-level blocks per final
    partial) of ``_quad_partials`` over ``total`` values: a register
    split into shards computes each shard's share of the same partials
    (parallel/sharded.quad_sum_pieces)."""
    nb = max(1, total // _QUAD_BLOCK)
    return total // nb, (nb // _QUAD_BLOCK if nb > _QUAD_BLOCK else 1)


def quad_partials_piece(piece, total: int):
    """The share of ``_quad_partials`` of a ``total``-value vector that a
    contiguous run ``piece`` of it holds, when the run holds whole final
    partials (a shard of R <= 256: 256 / R of them), each summed as the
    whole vector's route sums it; a run shorter than one partial's span
    (a small register split over many shards) is one partial of its
    own."""
    piece = piece.reshape(-1)
    bs, top = quad_layout(total)
    m = piece.numel()
    if m == 0:
        return piece
    if m % (bs * top):
        return piece.sum().reshape(1)
    partials = piece.reshape(-1, bs).sum(dim=1)
    if top > 1:
        partials = partials.reshape(-1, top).sum(dim=1)
    return partials


def quad_slots(max_piece: int, total: int) -> int:
    """The partials of the longest run of ``max_piece`` values."""
    bs, top = quad_layout(total)
    return max(1, max_piece // (bs * top))


def quad_sum(x) -> float:
    """Double-double compensated sum of a tensor (QuEST_PREC=4): block
    partials on the tensor's device, their Neumaier combine on the host."""
    return neumaier_sum(_quad_partials(x))


def quad_sum_dd(x):
    """quad_sum as its (sum, compensation) pair (neumaier_pair)."""
    return tuple(float(v) for v in neumaier_pair(_quad_partials(x)))


def quad_sum2(x, y) -> float:
    """quad_sum(x) + quad_sum(y): the two channels of a two-channel
    reduction enter separate compensated sums, never pre-added (a float64
    pre-add would round the smaller channel away first)."""
    return quad_sum(x) + quad_sum(y)


def _host64(*vals):
    """Quad results as a float64 host tensor: 0-d, or stacked (k,)."""
    if len(vals) == 1:
        return torch.tensor(vals[0], dtype=torch.float64)
    return torch.tensor(vals, dtype=torch.float64)


def calc_total_prob_statevec_quad(amps):
    return _host64(quad_sum2(amps[0] * amps[0], amps[1] * amps[1]))


def calc_total_prob_density_quad(amps, *, num_qubits: int):
    return _host64(quad_sum(_diag(amps, num_qubits)[0]))


def calc_inner_product_quad(bra_amps, ket_amps):
    """<bra|ket> with double-double accumulation -> stacked (2,)."""
    br, bi = bra_amps[0], bra_amps[1]
    kr, ki = ket_amps[0], ket_amps[1]
    return _host64(quad_sum2(br * kr, bi * ki),
                   quad_sum2(br * ki, -(bi * kr)))


def _diag(amps, num_qubits: int):
    """Diagonal of the column-major flattened rho: (2, dim) stacked."""
    dim = 1 << num_qubits
    return torch.diagonal(amps.reshape(2, dim, dim), dim1=1, dim2=2)


def calc_total_prob_density(amps, *, num_qubits: int):
    """Re(trace(rho)) (densmatr_calcTotalProb)."""
    return torch.sum(_diag(amps, num_qubits)[0])


def calc_prob_of_outcome_statevec(amps, *, num_qubits: int, target: int,
                                  outcome: int, quad: bool = False):
    """(statevec_calcProbOfOutcome, QuEST_cpu.c:3418-3508): the sum of
    |amp|^2 over the half of the index space whose target bit equals
    ``outcome``."""
    n = num_qubits
    view = amps.reshape(2, 1 << (n - 1 - target), 2, 1 << target)
    half = view[:, :, int(outcome), :]
    if quad:
        return _host64(quad_sum2(half[0] * half[0], half[1] * half[1]))
    return torch.sum(cplx.abs2(half))


def calc_prob_of_outcome_density(amps, *, num_qubits: int, target: int,
                                 outcome: int, quad: bool = False):
    """Sum of diagonal rho elements whose target bit equals outcome
    (densmatr_calcProbOfOutcome, QuEST_cpu.c:3363-3417)."""
    d = _diag(amps, num_qubits)[0]
    view = d.reshape(1 << (num_qubits - 1 - target), 2, 1 << target)
    if quad:
        return _host64(quad_sum(view[:, int(outcome), :]))
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


def calc_density_inner_product(rho1_amps, rho2_amps, *, quad: bool = False):
    """Re Tr(rho1^dagger rho2) (densmatr_calcInnerProductLocal,
    QuEST_cpu.c:958)."""
    if quad:
        return _host64(quad_sum2(rho1_amps[0] * rho2_amps[0],
                                 rho1_amps[1] * rho2_amps[1]))
    return torch.sum(rho1_amps[0] * rho2_amps[0]
                     + rho1_amps[1] * rho2_amps[1])


def calc_purity(rho_amps, *, quad: bool = False):
    """Tr(rho^2) = sum |rho_rc|^2 for Hermitian rho (calcPurityLocal,
    QuEST_cpu.c:861)."""
    if quad:
        return _host64(quad_sum2(rho_amps[0] * rho_amps[0],
                                 rho_amps[1] * rho_amps[1]))
    return torch.sum(cplx.abs2(rho_amps))


def calc_fidelity_density(rho_amps, psi_amps, *, num_qubits: int,
                          quad: bool = False):
    """<psi|rho|psi> (densmatr_calcFidelityLocal, QuEST_cpu.c:990): two
    matrix-vector products per plane (the JAX package leaves them to XLA
    likewise), then one reduction.  Quad takes the elementwise form, every
    signed term Re[conj(psi_r) rho_rc psi_c] in the compensated sum (the
    matrix-vector form would round the inner contraction at float64)."""
    dim = 1 << num_qubits
    m = rho_amps.reshape(2, dim, dim)   # [channel, col, row]
    p0, p1 = psi_amps[0], psi_amps[1]
    if quad:
        # conj(psi_r) psi_c = a[c, r] + i b[c, r]
        a = p0[:, None] * p0[None, :] + p1[:, None] * p1[None, :]
        b = p1[:, None] * p0[None, :] - p0[:, None] * p1[None, :]
        return _host64(quad_sum2(m[0] * a, -(m[1] * b)))
    # v_c = sum_r rho_{r,c} conj(psi_r)
    v_re = torch.matmul(m[0], p0) + torch.matmul(m[1], p1)
    v_im = torch.matmul(m[1], p0) - torch.matmul(m[0], p1)
    # Re(sum_c psi_c v_c)
    return torch.sum(p0 * v_re - p1 * v_im)


def calc_hilbert_schmidt_distance(rho1_amps, rho2_amps, *,
                                  quad: bool = False):
    """sqrt(sum |rho1 - rho2|^2) (calcHilbertSchmidtDistanceSquaredLocal,
    QuEST_cpu.c:923)."""
    d = rho1_amps - rho2_amps
    if quad:
        return torch.sqrt(_host64(quad_sum2(d[0] * d[0], d[1] * d[1])))
    return torch.sqrt(torch.sum(cplx.abs2(d)))


def calc_expec_diagonal_statevec(amps, op_real, op_imag, *,
                                 quad: bool = False):
    """sum_i |amp_i|^2 d_i -> stacked (2,) (statevec_calcExpecDiagonalOp,
    QuEST_cpu.c:4094-4126)."""
    if quad:
        sq0, sq1 = amps[0] * amps[0], amps[1] * amps[1]
        return _host64(quad_sum2(sq0 * op_real, sq1 * op_real),
                       quad_sum2(sq0 * op_imag, sq1 * op_imag))
    p = cplx.abs2(amps)
    return torch.stack([torch.sum(p * op_real), torch.sum(p * op_imag)])


def calc_expec_diagonal_density(amps, op_real, op_imag, *, num_qubits: int,
                                quad: bool = False):
    """sum_r d_r rho_rr -> stacked (2,) (densmatr_calcExpecDiagonalOp,
    QuEST_cpu.c:4127-4186)."""
    d = _diag(amps, num_qubits)
    if quad:
        return _host64(quad_sum2(d[0] * op_real, -(d[1] * op_imag)),
                       quad_sum2(d[0] * op_imag, d[1] * op_real))
    re = torch.sum(d[0] * op_real - d[1] * op_imag)
    im = torch.sum(d[0] * op_imag + d[1] * op_real)
    return torch.stack([re, im])
