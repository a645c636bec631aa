"""Pauli strings: application, expectation values, rotations.

The counterpart of the JAX package's ``ops/paulis.py``.  States are SoA
``(2, 2^n)`` real tensors (ops/cplx.py); a Pauli string is a row of codes
(0 = I, 1 = X, 2 = Y, 3 = Z), one per qubit.

* Plain PyTorch forms (the reference's XLA forms): ``apply_pauli_string``
  and the whole-sum ``calc_expec_pauli_sum_statevec`` /
  ``calc_expec_pauli_sum_density`` and ``apply_pauli_sum``, all on the
  direct form's one P psi (``_signed_partner``).
* The direct form, one pass over the state per term:
  e^{-i theta/2 P} psi = cos(theta/2) psi - i sin(theta/2) (P psi) with
  (P psi)[i] = (-i)^{#Y} (-1)^{parity(i & zm)} psi[i ^ fm].  Two
  hand-written CUDA kernels (``csrc/paulis.cu``) run it on the card:

  - K3, ``direct_rotation``: one term's rotation, in place (replaces the
    Pallas kernel ``_direct_rotation_pallas``);
  - K4, ``expec_term``: Re <psi| P |psi> for one term (replaces
    ``_expec_term_pallas``).

  Beside each sits its plain PyTorch version (``direct_rotation_plain``,
  ``expec_term_plain``), which the wrappers run for a tensor on the CPU;
  for a tensor on the card they launch the kernel or raise.  Each wrapper
  counts its launches in ``LAUNCHES``.
* ``trotter_scan`` and ``expec_pauli_sum_scan``: host loops over a term
  table, one K3 (two on a density matrix) or one K4 launch per term.

The codes are host data here, so a term's masks are host integers
(``pauli_term``), computed once per term with the cos/sin of its angle in
the state's type: the kernel and its plain version get the same scalars.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build
from .kernels import parity_sign_factors

PAULI_I, PAULI_X, PAULI_Y, PAULI_Z = 0, 1, 2, 3
# (-i)^k as (re, im) for k = 0..3
_MINUS_I_POW = [(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)]


# ---------------------------------------------------------------------------
# Plain forms (the reference's XLA programs, paulis.py:27-137)
# ---------------------------------------------------------------------------


def apply_pauli_string(amps, n: int, targets: Tuple[int, ...],
                       codes: Tuple[int, ...]):
    """Apply a Pauli product to flat (2, 2^n) SoA amps: P psi with
    (P psi)[i] = (-i)^{#Y} (-1)^{parity(i & zm)} psi[i ^ fm] (Y|b> =
    i(2b'-1)|b'> with b' the flipped bit), the direct form's signed
    partner as a new (2, 2^n) tensor.  statevec_applyPauliProd semantics
    (QuEST_common.c:505-516)."""
    row = [PAULI_I] * n
    for t, c in zip(targets, codes):
        row[t] = c
    pr, pi = _signed_partner(amps, pauli_term(row, dtype=amps.dtype), n)
    return torch.stack([pr, pi]).reshape(2, -1)


def _term_codes(codes_flat, n: int, t: int):
    return codes_flat[t * n:(t + 1) * n]


def _coeff_tensor(coeffs, amps):
    """The term coefficients as a tensor of the state's type and device
    (a tensor passes through, so that a gradient can reach it)."""
    if not torch.is_tensor(coeffs):
        coeffs = np.asarray(coeffs)
    return torch.as_tensor(coeffs, dtype=amps.dtype, device=amps.device)


def _quad_term(amps, term: "PauliTerm", n: int) -> float:
    """Re <psi| P |psi> for one term in double-double: the gather form's
    two product channels in separate compensated sums (the JAX package's
    quad branch, which never takes K4)."""
    from . import calculations as _calc

    hi, lo = _split(n)
    x = amps.reshape(2, 1 << hi, 1 << lo)
    pr, pi = _signed_partner(amps, term, n)
    return _calc.quad_sum2(x[0] * pr, x[1] * pi)


def _quad_total(coeffs, vals, dtype):
    """The quad cross-term combine: each term's value times its
    coefficient in the state's type, then a Neumaier sum."""
    from . import calculations as _calc

    real = _NUMPY_DTYPE[dtype]
    return torch.tensor(_calc.neumaier_sum(
        [real(c) * real(v) for c, v in zip(coeffs, vals)]),
        dtype=torch.float64)


def calc_expec_pauli_sum_statevec(amps, coeffs, *, num_qubits: int,
                                  codes_flat: Tuple[int, ...],
                                  num_terms: int, quad: bool = False):
    """Re <psi| sum_t c_t P_t |psi> (QuEST_common.c:534-546), each term
    through the plain K4 form (``quad``: in double-double, a float64 host
    tensor)."""
    n = num_qubits
    terms = [pauli_term(_term_codes(codes_flat, n, t), dtype=amps.dtype)
             for t in range(num_terms)]
    if quad:
        return _quad_total(np.asarray(coeffs, np.float64),
                           [_quad_term(amps, t, n) for t in terms],
                           amps.dtype)
    coeffs = _coeff_tensor(coeffs, amps)
    vals = [coeffs[t] * expec_term_plain(amps, term, num_qubits=n)
            for t, term in enumerate(terms)]
    return torch.sum(torch.stack(vals))


def calc_expec_pauli_sum_density(amps, coeffs, *, num_qubits: int,
                                 codes_flat: Tuple[int, ...],
                                 num_terms: int, quad: bool = False):
    """Re Tr(rho sum_t c_t P_t): P on the ket qubits of the flattened rho,
    then the trace of the real part (QuEST_common.c:519-546); ``quad``
    sums each trace and the terms in double-double."""
    from . import calculations as _calc

    n = num_qubits
    dim = 1 << n
    traces = []
    for t in range(num_terms):
        pr, _ = _signed_partner(amps, pauli_term(
            _term_codes(codes_flat, n, t), dtype=amps.dtype), 2 * n)
        d = torch.diagonal(pr.reshape(dim, dim))
        traces.append(_calc.quad_sum(d) if quad else torch.sum(d))
    if quad:
        return _quad_total(np.asarray(coeffs, np.float64), traces,
                           amps.dtype)
    coeffs = _coeff_tensor(coeffs, amps)
    return torch.sum(torch.stack([coeffs[t] * v
                                  for t, v in enumerate(traces)]))


def apply_pauli_sum(amps, coeffs, *, num_qubits: int, num_state_qubits: int,
                    codes_flat: Tuple[int, ...], num_terms: int):
    """sum_t c_t P_t |in> as a new tensor (statevec_applyPauliSum,
    QuEST_common.c:547-569).  On a density matrix this left-multiplies:
    num_state_qubits = 2 * num_qubits and the codes act on the ket
    qubits only."""
    n = num_qubits
    coeffs = torch.as_tensor(np.asarray(coeffs), dtype=amps.dtype,
                             device=amps.device)
    acc = torch.zeros_like(amps.reshape(2, -1))
    for t in range(num_terms):
        pv = apply_pauli_string(amps, num_state_qubits, tuple(range(n)),
                                _term_codes(codes_flat, n, t))
        acc = acc + coeffs[t] * pv
    return acc


# ---------------------------------------------------------------------------
# The direct form: one term's masks and scalars on the host
# ---------------------------------------------------------------------------

_GATHER_LO_BITS = 12     # lane width of the plain versions' split gather
_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class PauliTerm(NamedTuple):
    """One Pauli string as the direct form sees it: ``fm`` its X|Y bits,
    ``zm`` its Z|Y bits, (c_re, c_im) = (-i)^{#Y} (imaginary part negated
    for the conjugated bra twin), and (co, si) = (cos, sin)(theta/2) in the
    state's type (theta zeroed for an all-identity string)."""

    fm: int
    zm: int
    c_re: float
    c_im: float
    co: float
    si: float


def _direct_masks(codes, offset: int = 0):
    """(fm, zm, #Y) of a code row acting on qubits [offset, offset + len)."""
    fm = zm = ny = 0
    for q, c in enumerate(int(c) for c in codes):
        bit = 1 << (q + offset)
        if c in (PAULI_X, PAULI_Y):
            fm |= bit
        if c in (PAULI_Y, PAULI_Z):
            zm |= bit
        ny += c == PAULI_Y
    return fm, zm, ny


def pauli_term(codes, *, dtype, offset: int = 0, theta: float = 0.0,
               conj: bool = False) -> PauliTerm:
    """The host-side description of one term, shared by a kernel and its
    plain version.  cos/sin are taken of 0.5 * theta in ``dtype``, as the
    reference does after casting the angle to the state's type; an
    all-identity string only contributes a global phase the gate stream
    skips, so its angle is zeroed (paulis.py:406, 560-561)."""
    fm, zm, ny = _direct_masks(codes, offset)
    c_re, c_im = _MINUS_I_POW[ny % 4]
    if conj:
        c_im = -c_im
    real = _NUMPY_DTYPE[dtype]
    th = real(0.0) if fm == zm == 0 else real(theta)
    half = real(0.5) * th
    return PauliTerm(fm, zm, c_re, c_im, float(np.cos(half)),
                     float(np.sin(half)))


def _split(n: int):
    lo = min(_GATHER_LO_BITS, n)
    return n - lo, lo


def _flip_gather(view, fm: int, hi: int, lo: int):
    """psi[i ^ fm] on the (2, 2^hi, 2^lo) view: one row take and one lane
    take with small index vectors (a flat 2^n int64 index would be 8 GiB at
    30 qubits)."""
    fm_hi, fm_lo = fm >> lo, fm & ((1 << lo) - 1)
    if fm_hi:
        idx = torch.arange(1 << hi, device=view.device) ^ fm_hi
        view = torch.index_select(view, 1, idx)
    if fm_lo:
        idx = torch.arange(1 << lo, device=view.device) ^ fm_lo
        view = torch.index_select(view, 2, idx)
    return view


def _signed_partner(amps, term: PauliTerm, n: int):
    """(pr, pi) = P psi as (2^hi, 2^lo) tensors, with the products in the
    order the kernels take them: pr = s (c_re f0 - c_im f1), pi = s (c_re
    f1 + c_im f0); the sign is applied as its row and lane factors, which
    is exact (each is +-1)."""
    hi, lo = _split(n)
    pv = _flip_gather(amps.reshape(2, 1 << hi, 1 << lo), term.fm, hi, lo)
    s_row, s_lane = parity_sign_factors(
        n, [b for b in range(n) if (term.zm >> b) & 1], amps.dtype,
        amps.device, lo=lo)
    pr = (term.c_re * pv[0] - term.c_im * pv[1]) * s_row * s_lane
    pi = (term.c_re * pv[1] + term.c_im * pv[0]) * s_row * s_lane
    return pr, pi


def direct_rotation_plain(amps, term: PauliTerm, *, num_qubits: int):
    """e^{-i theta/2 P} psi as a new tensor: the plain version of K3, the
    reference's _direct_rotation (paulis.py:399-411) with its split-axis
    gather.  out0 = co x0 + si pi, out1 = co x1 - si pr."""
    n = num_qubits
    hi, lo = _split(n)
    x = amps.reshape(2, 1 << hi, 1 << lo)
    pr, pi = _signed_partner(amps, term, n)
    out0 = term.co * x[0] + term.si * pi
    del pi
    out1 = term.co * x[1] - term.si * pr
    # stacked, not written through out=, so that autograd follows it
    return torch.stack([out0, out1]).reshape(amps.shape)


def expec_term_plain(amps, term: PauliTerm, *, num_qubits: int):
    """Re <psi| P |psi> as a 0-d tensor of the state's type: the plain
    version of K4, the reference's gather-form term (paulis.py:742-746)."""
    hi, lo = _split(num_qubits)
    x = amps.reshape(2, 1 << hi, 1 << lo)
    pr, pi = _signed_partner(amps, term, num_qubits)
    return torch.sum(x[0] * pr + x[1] * pi)


# ---------------------------------------------------------------------------
# The CUDA kernels K3 and K4: bind, launch
# ---------------------------------------------------------------------------

_BOUND: dict = {}
_BLOCKS_PER_SM = 8       # 8 blocks of 256 threads fill an SM's 2048
# launches of each kernel, counted where its wrapper launches it
LAUNCHES = {"K3": 0, "K4": 0}


def _lib():
    """The kernel library with the Pauli entries' signatures declared."""
    if "lib" not in _BOUND:
        lib = build.library()
        ptr, i64, u64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
        for suffix, real in (("f32", ctypes.c_float),
                             ("f64", ctypes.c_double)):
            fn = getattr(lib, f"qt_pauli_rotation_{suffix}")
            fn.argtypes = [ptr, i64, u64, u64, real, real, real, real,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"qt_pauli_expec_{suffix}")
            fn.argtypes = [ptr, i64, u64, u64, real, real, ptr, ctypes.c_int,
                           ptr]
            fn.restype = ctypes.c_int
        lib.qt_pauli_threads.argtypes = []
        lib.qt_pauli_threads.restype = ctypes.c_int
        _BOUND["lib"] = lib
        _BOUND["threads"] = lib.qt_pauli_threads()
    return _BOUND["lib"]


def _check_term(amps, term: PauliTerm, n: int, what: str) -> int:
    num_amps = 1 << n
    if amps.numel() != 2 * num_amps:
        raise ValueError(f"{what}: a state of {tuple(amps.shape)} is not "
                         f"(2, 2^{n})")
    if term.fm >= num_amps or term.zm >= num_amps:
        raise ValueError(f"{what}: the Pauli string reaches past qubit {n}")
    return num_amps


def _cuda_state(amps, what: str):
    if amps.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {amps.device}")
    if amps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: state dtype {amps.dtype} is not float32 "
                        "or float64")
    if not amps.is_contiguous():
        raise ValueError(f"{what}: the state must be contiguous")
    return "f32" if amps.dtype == torch.float32 else "f64"


def _grid(amps, term: PauliTerm, num_amps: int) -> int:
    """The kernels' fixed grid: one thread per amplitude (fm = 0) or per
    pair, at most as many blocks as fill the card once."""
    _lib()
    threads = _BOUND["threads"]
    work = num_amps if term.fm == 0 else num_amps // 2
    sms = torch.cuda.get_device_properties(amps.device).multi_processor_count
    return max(1, min(-(-work // threads), _BLOCKS_PER_SM * sms))


def direct_rotation(amps, term: PauliTerm, *, num_qubits: int):
    """One term's rotation e^{-i theta/2 P} psi (K3).  The input is
    consumed: on the card the kernel overwrites it in place and returns it
    (the reference's trotter_scan donates it likewise); a CPU tensor takes
    the plain version, which returns a new tensor."""
    num_amps = _check_term(amps, term, num_qubits, "direct_rotation")
    if amps.device.type == "cpu":
        return direct_rotation_plain(amps, term, num_qubits=num_qubits)
    suffix = _cuda_state(amps, "direct_rotation")
    fn = getattr(_lib(), f"qt_pauli_rotation_{suffix}")
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(fn(amps.data_ptr(), num_amps, term.fm, term.zm,
                      term.c_re, term.c_im, term.co, term.si,
                      _grid(amps, term, num_amps), stream),
                   "direct_rotation")
    LAUNCHES["K3"] += 1
    return amps


def expec_term(amps, term: PauliTerm, *, num_qubits: int):
    """Re <psi| P |psi> for one term (K4) as a 0-d tensor: float64 from
    the kernel, which accumulates in float64 and writes one partial per
    block, summed here; the plain version's type for a CPU tensor."""
    num_amps = _check_term(amps, term, num_qubits, "expec_term")
    if amps.device.type == "cpu":
        return expec_term_plain(amps, term, num_qubits=num_qubits)
    suffix = _cuda_state(amps, "expec_term")
    fn = getattr(_lib(), f"qt_pauli_expec_{suffix}")
    blocks = _grid(amps, term, num_amps)
    partials = torch.empty(blocks, dtype=torch.float64, device=amps.device)
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(fn(amps.data_ptr(), num_amps, term.fm, term.zm,
                      term.c_re, term.c_im, partials.data_ptr(), blocks,
                      stream), "expec_term")
    LAUNCHES["K4"] += 1
    return torch.sum(partials)


def reset_launch_counts() -> None:
    """Set both kernels' launch counts to 0."""
    LAUNCHES.update(K3=0, K4=0)


# ---------------------------------------------------------------------------
# Term-table loops (the reference's lax.scan programs, paulis.py:636-752)
# ---------------------------------------------------------------------------


def trotter_scan(amps, codes_seq, angles, *, num_qubits: int,
                 rep_qubits: int):
    """The Trotter gate stream (agnostic_applyTrotterCircuit,
    QuEST_common.c:752-834) over a (T, nq) code table and (T,) angles: one
    direct rotation per term, and on a density matrix its conjugated bra
    twin on qubits [nq, 2nq) at -theta.  Consumes ``amps`` (see
    direct_rotation) and returns the evolved state."""
    n, nq = num_qubits, rep_qubits
    for codes, ang in zip(np.asarray(codes_seq),
                          np.asarray(angles, np.float64)):
        amps = direct_rotation(
            amps, pauli_term(codes, dtype=amps.dtype, theta=ang),
            num_qubits=n)
        if n == 2 * nq:
            amps = direct_rotation(
                amps, pauli_term(codes, dtype=amps.dtype, offset=nq,
                                 theta=-ang, conj=True), num_qubits=n)
    return amps


def expec_pauli_sum_scan(amps, codes_seq, coeffs, *, num_qubits: int,
                         quad: bool = False):
    """Re <psi| sum_t c_t P_t |psi> over a (T, n) code table: one
    expec_term per term, weighted and summed in float64 on the device (one
    0-d tensor; nothing waits for the card until the caller reads it).
    ``quad`` keeps the gather form, as the JAX package does (its
    channel-split double-double sums need the full product vectors): no
    K4 launch, each term in double-double and a Neumaier combine, a
    float64 host tensor."""
    if quad:
        return _quad_total(
            np.asarray(coeffs, np.float64),
            [_quad_term(amps, pauli_term(codes, dtype=amps.dtype),
                        num_qubits) for codes in np.asarray(codes_seq)],
            amps.dtype)
    total = torch.zeros((), dtype=torch.float64, device=amps.device)
    for codes, c in zip(np.asarray(codes_seq),
                        np.asarray(coeffs, np.float64)):
        r = expec_term(amps, pauli_term(codes, dtype=amps.dtype),
                       num_qubits=num_qubits)
        total = total + float(c) * r.to(torch.float64)
    return total
