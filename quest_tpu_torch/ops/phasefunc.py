"""Phase functions: the per-amplitude phase exp(i theta(x1..xm)).

The counterpart of the JAX package's ``ops/phasefunc.py``:
``apply_phase_func`` (a polynomial of one sub-register),
``apply_multi_var_phase_func`` (a sum of polynomials of several) and
``apply_named_phase_func`` (the named norm, product and distance
families), each with overrides.  Each amplitude's sub-register integers
are decoded from its index bits, theta is evaluated in the state's type
and the amplitude is multiplied by cos(theta) + i sin(theta) (the
reference's update, QuEST_cpu.c:4228-4564).  Plain PyTorch, as the JAX
package computes them in plain XLA: elementwise passes.

Phase-function name codes match ``enum phaseFunc`` (QuEST.h:231-234).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cplx

# enum phaseFunc (QuEST.h:231-234)
NORM = 0
SCALED_NORM = 1
INVERSE_NORM = 2
SCALED_INVERSE_NORM = 3
SCALED_INVERSE_SHIFTED_NORM = 4
PRODUCT = 5
SCALED_PRODUCT = 6
INVERSE_PRODUCT = 7
SCALED_INVERSE_PRODUCT = 8
DISTANCE = 9
SCALED_DISTANCE = 10
INVERSE_DISTANCE = 11
SCALED_INVERSE_DISTANCE = 12
SCALED_INVERSE_SHIFTED_DISTANCE = 13

UNSIGNED = 0
TWOS_COMPLEMENT = 1

_NORM_FUNCS = (NORM, SCALED_NORM, INVERSE_NORM, SCALED_INVERSE_NORM,
               SCALED_INVERSE_SHIFTED_NORM)
_PROD_FUNCS = (PRODUCT, SCALED_PRODUCT, INVERSE_PRODUCT,
               SCALED_INVERSE_PRODUCT)
_DIST_FUNCS = (DISTANCE, SCALED_DISTANCE, INVERSE_DISTANCE,
               SCALED_INVERSE_DISTANCE, SCALED_INVERSE_SHIFTED_DISTANCE)


def _decode_subregister(idx, qubits, twos_complement: bool):
    """The integer a sub-register holds in each index of ``idx``:
    qubits[0] is its least-significant bit; with ``twos_complement`` the
    top qubit is the sign bit (QuEST_cpu.c:4228-4303)."""
    val = torch.zeros_like(idx)
    for j, q in enumerate(qubits):
        val = val + (((idx >> q) & 1) << j)
    if twos_complement:
        nbits = len(qubits)
        val = torch.where(val >= (1 << (nbits - 1)), val - (1 << nbits), val)
    return val


def _index_dtype(num_bits: int):
    """int32 while every index fits (the JAX package's choice), else
    int64."""
    return torch.int64 if num_bits > 31 else torch.int32


def _phase_inds(num_amps: int, reg_qubits, encoding: int, device,
                offset: int = 0):
    """Per-register decoded integers, each (num_amps,), of the global
    indices offset .. offset + num_amps - 1.  A register's value is the
    sum of what its bits in the index's high half, in its low half and in
    the offset (a shard's first index, above the local bits) contribute,
    so each is decoded on 2^(n/2) indices and the parts meet in one
    broadcast add."""
    n = max(num_amps.bit_length() - 1, 1)
    lo = n // 2
    dt = _index_dtype(max(n, int(offset).bit_length()))
    hi_idx = torch.arange(1 << (n - lo), dtype=dt, device=device) << lo
    lo_idx = torch.arange(1 << lo, dtype=dt, device=device)
    out = []
    for qs in reg_qubits:
        val = (_decode_subregister(hi_idx, qs, False)[:, None]
               + _decode_subregister(lo_idx, qs, False)[None, :]).reshape(-1)
        if offset:
            val = val + sum(((offset >> q) & 1) << j
                            for j, q in enumerate(qs))
        if encoding == TWOS_COMPLEMENT:
            nb = len(qs)
            val = torch.where(val >= (1 << (nb - 1)), val - (1 << nb), val)
        out.append(val[:num_amps])
    return out


def _apply_overrides(phase, inds, override_inds, override_phases):
    """First match wins (QuEST_cpu.c:4464-4480): scan in reverse so that
    earlier entries overwrite later ones."""
    for i in range(override_inds.shape[0] - 1, -1, -1):
        match = torch.ones(phase.shape, dtype=torch.bool, device=phase.device)
        for r, ind_arr in enumerate(inds):
            match = match & (ind_arr == int(override_inds[i, r]))
        phase = torch.where(match, torch.as_tensor(
            float(override_phases[i]), dtype=phase.dtype,
            device=phase.device), phase)
    return phase


def _mul_phase(amps, phase, conj: bool):
    """amp *= exp(i phase) on the SoA state, by explicit cos/sin as the
    reference updates (QuEST_cpu.c:4552-4562)."""
    if conj:
        phase = -phase
    return cplx.cmul(amps, torch.cos(phase), torch.sin(phase))


def _guarded(val, fallback, numerator):
    """numerator / val, or ``fallback`` where val == 0 (the reference's
    divergence parameter)."""
    safe = torch.where(val == 0, torch.ones_like(val), val)
    return torch.where(val == 0, fallback, numerator / safe)


def apply_named_phase_func(amps, params, override_inds, override_phases, *,
                           num_qubits: int,
                           reg_qubits: Tuple[Tuple[int, ...], ...],
                           encoding: int, func_name: int,
                           conj: bool = False, offset: int = 0):
    """exp(i theta) on every amplitude of the (2, 2^num_qubits) state, theta
    the named function ``func_name`` of the sub-registers ``reg_qubits``
    (statevec_applyParamNamedPhaseFuncOverrides, QuEST_cpu.c:4406-4564).
    ``params`` holds the scale, the divergence value and the shifts at the
    reference's fixed slots; ``override_inds`` (num_overrides, num_regs)
    and ``override_phases`` replace theta at listed register values.
    ``offset`` is the global index of the tensor's first amplitude (a
    shard's).  Returns a new tensor."""
    num_amps = amps.shape[-1]
    inds = _phase_inds(num_amps, reg_qubits, encoding, amps.device, offset)
    rdt = amps.dtype
    params = torch.as_tensor(params, dtype=rdt, device=amps.device)
    find = [x.to(rdt) for x in inds]
    num_regs = len(reg_qubits)

    if func_name in _NORM_FUNCS:
        acc = torch.zeros((num_amps,), dtype=rdt, device=amps.device)
        for r in range(num_regs):
            x = find[r]
            if func_name == SCALED_INVERSE_SHIFTED_NORM:
                x = x - params[2 + r]
            acc = acc + x * x
        val = torch.sqrt(acc)
        if func_name == NORM:
            phase = val
        elif func_name == INVERSE_NORM:
            phase = _guarded(val, params[0], 1)
        elif func_name == SCALED_NORM:
            phase = params[0] * val
        else:  # SCALED_INVERSE_NORM, SCALED_INVERSE_SHIFTED_NORM
            phase = _guarded(val, params[1], params[0])
    elif func_name in _PROD_FUNCS:
        prod = torch.ones((num_amps,), dtype=rdt, device=amps.device)
        for r in range(num_regs):
            prod = prod * find[r]
        if func_name == PRODUCT:
            phase = prod
        elif func_name == INVERSE_PRODUCT:
            phase = _guarded(prod, params[0], 1)
        elif func_name == SCALED_PRODUCT:
            phase = params[0] * prod
        else:
            phase = _guarded(prod, params[1], params[0])
    elif func_name in _DIST_FUNCS:
        acc = torch.zeros((num_amps,), dtype=rdt, device=amps.device)
        for r in range(0, num_regs, 2):
            d = find[r + 1] - find[r]
            if func_name == SCALED_INVERSE_SHIFTED_DISTANCE:
                d = d - params[2 + r // 2]
            acc = acc + d * d
        val = torch.sqrt(acc)
        if func_name == DISTANCE:
            phase = val
        elif func_name == INVERSE_DISTANCE:
            phase = _guarded(val, params[0], 1)
        elif func_name == SCALED_DISTANCE:
            phase = params[0] * val
        else:
            phase = _guarded(val, params[1], params[0])
    else:
        raise ValueError(f"unknown phase function {func_name}")

    del find
    phase = _apply_overrides(phase, inds, override_inds, override_phases)
    del inds
    return _mul_phase(amps, phase, conj)


def apply_multi_var_phase_func(amps, coeffs, exponents, override_inds,
                               override_phases, *, num_qubits: int,
                               reg_qubits: Tuple[Tuple[int, ...], ...],
                               encoding: int,
                               terms_per_reg: Tuple[int, ...],
                               conj: bool = False, offset: int = 0):
    """theta = sum_r sum_t coeff_{r,t} x_r^exp_{r,t}
    (statevec_applyMultiVarPhaseFuncOverrides, QuEST_cpu.c:4305-4404);
    ``coeffs``/``exponents`` are flat over the registers (the reference's
    layout); ``offset`` as in apply_named_phase_func.  Returns a new
    tensor."""
    num_amps = amps.shape[-1]
    inds = _phase_inds(num_amps, reg_qubits, encoding, amps.device, offset)
    rdt = amps.dtype
    coeffs = torch.as_tensor(coeffs, dtype=rdt, device=amps.device)
    exponents = torch.as_tensor(exponents, dtype=rdt, device=amps.device)
    phase = torch.zeros((num_amps,), dtype=rdt, device=amps.device)
    flat = 0
    for r in range(len(reg_qubits)):
        x = inds[r].to(rdt)
        for _ in range(terms_per_reg[r]):
            phase.add_(coeffs[flat] * torch.pow(x, exponents[flat]))
            flat += 1
    del x
    phase = _apply_overrides(phase, inds, override_inds, override_phases)
    del inds
    return _mul_phase(amps, phase, conj)


def apply_phase_func(amps, coeffs, exponents, override_inds,
                     override_phases, *, num_qubits: int,
                     qubits: Tuple[int, ...], encoding: int,
                     conj: bool = False, offset: int = 0):
    """Single-register polynomial theta(x) = sum_i c_i x^{e_i}
    (statevec_applyPhaseFuncOverrides, QuEST_cpu.c:4228-4303); ``offset``
    as in apply_named_phase_func.  Returns a new tensor."""
    num_amps = amps.shape[-1]
    (ind,) = _phase_inds(num_amps, (tuple(qubits),), encoding, amps.device,
                         offset)
    rdt = amps.dtype
    coeffs = torch.as_tensor(coeffs, dtype=rdt, device=amps.device)
    exponents = torch.as_tensor(exponents, dtype=rdt, device=amps.device)
    x = ind.to(rdt)
    phase = torch.zeros((num_amps,), dtype=rdt, device=amps.device)
    for i in range(coeffs.shape[0]):
        phase.add_(coeffs[i] * torch.pow(x, exponents[i]))
    del x
    phase = _apply_overrides(phase, [ind], override_inds, override_phases)
    del ind
    return _mul_phase(amps, phase, conj)
