"""The sharded composites: Pauli sums and Trotter circuits, the QFT, the
eager pair channels and the diagonal operator of a density register, on
a register split over R = 2^r shards.

The port of the second half of the JAX package's ``parallel/dist.py``
(:686-1631), under the reference's names.  Where the reference runs one
``shard_map`` body per call, the port loops over the mesh's local shards
and moves data with the mesh's ``permute``, ``all_to_all`` and
``all_gather`` (parallel/mesh.py):

* Pauli terms (``trotter_scan_sharded``, ``expec_pauli_sum_scan_sharded``):
  the direct form per term, its flip mask split into a mesh part (one
  composed XOR permute to the partner shard) and a local part (the split
  gather of ops/paulis.py), its parity sign into a per-shard scalar times
  the local sign.  Plain PyTorch, as the reference's sharded body is plain
  XLA.  Past ``paulis._DIRECT_MAX_N`` local bits the rotate-layer body
  runs instead (basis rotations per shard and by exchange).
* The QFT (``fused_qft_sharded``, ``fused_qft_runs_sharded``): a layer on
  a mesh bit is one full-shard exchange and a combine whose phase splits
  into a per-shard scalar and local tables; the local layers run per shard
  through the one-register kernels (K8 and K9 where the multilayer route
  applies, K6 and K7 per layer where the ladder kernels apply); the bit
  reversal is local permutes around one ``all_to_all``.
* The pair channels (``mix_pair_channel_sharded``,
  ``mix_two_qubit_depol_sharded``): one exchange per bra bit that is a
  mesh bit and an elementwise combine.
* ``apply_diag_op_density_sharded``: the operator's two vectors
  all-gathered to every shard, then an elementwise multiply.

Each records its exchanges under the reference's op family and tiers
(``trotter``, ``expec``, ``pair_channel``, ``depol2``, ``qft``,
``qft_runs``) and runs inside ``guarded_dispatch``: a failure part way
marks the register lost.  The data motion of the operations the
reference leaves to GSPMD (uncounted there) is counted here under the
port's own family ``pauli`` (the Pauli products of applyPauliSum and of
the expectation reads that take no scan).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cplx, kernels
from ..ops import paulis as P
from . import dist as PAR
from .mesh import ShardedAmps

from .sharded import _diag_index, shard_offsets
from .sharded import shard_parity_sign as _shard_parity_sign


def _np_dtype(amps: ShardedAmps):
    return P._NUMPY_DTYPE[amps.dtype]


def _sweep_exchange_tiers(nex: int, r: int, payload: int, t,
                          composed: bool) -> dict:
    """Tier split of ``nex`` full-shard exchanges of a Pauli sweep: spread
    evenly over the r mesh bits (the rotate-layer bodies), or, for the
    direct bodies whose one composed permute per term may touch any mesh
    bit, all on the slower tier of the topology."""
    if composed:
        tier = "dcn" if t.dcn_bits else "ici"
        return {tier: (nex, nex * payload)}
    dcn_n = nex * t.dcn_bits // max(r, 1)
    return {"ici": (nex - dcn_n, (nex - dcn_n) * payload),
            "dcn": (dcn_n, dcn_n * payload)}


# ---------------------------------------------------------------------------
# Pauli terms on a mesh (dist.py:794-1150)
# ---------------------------------------------------------------------------


def _split_mask(mask: int, nloc: int) -> Tuple[int, int]:
    """(local bits, mesh bits) of a global index mask: mesh bit j is
    global bit nloc + j."""
    return mask & ((1 << nloc) - 1), mask >> nloc


def _mesh_flip_gather(amps: ShardedAmps, sfm: int) -> List[torch.Tensor]:
    """Per local shard s, the tensor of shard s ^ sfm: one composed XOR
    permute (none for sfm = 0, where each shard reads itself)."""
    if not sfm:
        return list(amps.shards)
    mesh = amps.mesh
    return mesh.permute(amps.shards,
                        [(i, i ^ sfm) for i in range(mesh.axis_size)])


def _local_term(term: P.PauliTerm, s: int, nloc: int) -> P.PauliTerm:
    """Shard s's part of a global term: the local flip and parity masks,
    the shard's parity sign folded into the (-i)^#Y factor (both exact)."""
    fm_loc, _ = _split_mask(term.fm, nloc)
    zm_loc, szm = _split_mask(term.zm, nloc)
    sg = _shard_parity_sign(s, szm)
    return term._replace(fm=fm_loc, zm=zm_loc, c_re=sg * term.c_re,
                         c_im=sg * term.c_im)


def _apply_pauli_sharded(amps: ShardedAmps, term: P.PauliTerm):
    """Per local shard, (pr, pi) = (P psi) on the shard's indices as
    (2^hi, 2^lo) tensors: psi[global ^ fm] from the partner shard, the
    local split gather and the signs (ops/paulis._signed_partner)."""
    nloc = amps.nloc
    recv = _mesh_flip_gather(amps, term.fm >> nloc)
    out = []
    for k, s in enumerate(amps.mesh.local):
        out.append(P._signed_partner(recv[k], _local_term(term, s, nloc),
                                     nloc))
        recv[k] = None
    return out


def _direct_rotation_sharded(amps: ShardedAmps, term: P.PauliTerm) -> None:
    """e^{-i theta/2 P} psi on every shard, in the shard list: one
    (possibly exchanged) gather and the combine of
    ops/paulis.direct_rotation_plain, out0 = co x0 + si pi,
    out1 = co x1 - si pr."""
    nloc = amps.nloc
    hi, lo = P._split(nloc)
    recv = _mesh_flip_gather(amps, term.fm >> nloc)
    for k, s in enumerate(amps.mesh.local):
        own = amps.shards[k]
        pr, pi = P._signed_partner(recv[k], _local_term(term, s, nloc),
                                   nloc)
        recv[k] = None
        x = own.reshape(2, 1 << hi, 1 << lo)
        out0 = term.co * x[0] + term.si * pi
        del pi
        out1 = term.co * x[1] - term.si * pr
        del pr
        amps.shards[k] = torch.stack([out0, out1]).reshape(own.shape)


def _apply_1q_mesh_bit(amps: ShardedAmps, m, q: int, num_qubits: int,
                       chunks: int) -> None:
    """A one-qubit gate on mesh qubit ``q`` inside a sweep: the full-shard
    exchange and combine of apply_matrix_1q_sharded, uncounted (the sweep
    counts its exchanges); an identity still exchanges, as the
    reference's does."""
    PAR._apply_matrix_1q_sharded(amps, m, num_qubits=num_qubits, target=q,
                                 controls=(), control_states=(),
                                 chunks=chunks)


def _layer_sharded(amps: ShardedAmps, mats, num_qubits: int,
                   chunks: int) -> ShardedAmps:
    """The one-qubit product layer mats[q] on every qubit: the local
    qubits per shard (ops/paulis._product_layer), then each mesh qubit by
    exchange."""
    nloc = amps.nloc
    for k in range(len(amps.shards)):
        amps.shards[k] = P._product_layer(amps.shards[k], mats[:nloc], nloc)
    for q in range(nloc, num_qubits):
        _apply_1q_mesh_bit(amps, mats[q], q, num_qubits, chunks)
    return amps


def _parity_phase_sharded(amps: ShardedAmps, theta, zmask: int):
    """exp(-i theta/2 (-1)^parity(global & zmask)) on every shard: the
    local sign times the shard's scalar sign."""
    nloc = amps.nloc
    zm_loc, szm = _split_mask(zmask, nloc)
    for k, s in enumerate(amps.mesh.local):
        amps.shards[k] = P._parity_phase_mask(
            amps.shards[k], theta, zm_loc, nloc,
            sign=_shard_parity_sign(s, szm))
    return amps


def trotter_scan_sharded(amps: ShardedAmps, codes_seq, angles, *,
                         num_qubits: int, rep_qubits: int,
                         chunks: Optional[int] = None) -> ShardedAmps:
    """The Trotter gate stream (agnostic_applyTrotterCircuit,
    QuEST_common.c:752-834) on a sharded register: per term the direct
    rotation (one composed permute at most; two on a density matrix, the
    ket and its bra twin), or past _DIRECT_MAX_N local bits the
    rotate-layer body (2 r exchanges per term).  Counted under
    "trotter" as the reference counts it (its direct count is one per
    rotation whether or not the term flips a mesh bit).  The input is
    consumed."""
    mesh = amps.mesh
    r = PAR.num_shard_bits(mesh)
    nloc = num_qubits - r
    direct = nloc <= P._DIRECT_MAX_N
    payload = PAR._shard_payload_bytes(amps)
    if chunks is None:
        chunks = PAR.exchange_chunks(payload, backend=PAR._backend(amps))
    nterms = len(codes_seq)
    if direct:
        chunks = 1
        nex = (2 if num_qubits == 2 * rep_qubits else 1) * nterms
    else:
        nex = 2 * r * nterms
    if nex:
        PAR._record_exchange_tiers(
            "trotter", _sweep_exchange_tiers(nex, r, payload,
                                             PAR.mesh_topology(mesh),
                                             direct), chunks)
    return PAR.guarded_dispatch(
        _trotter_scan_sharded, amps, np.asarray(codes_seq),
        np.asarray(angles, np.float64), op="trotter",
        shards=PAR.amp_axis_size(mesh), num_qubits=num_qubits,
        rep_qubits=rep_qubits, chunks=int(chunks))


def _trotter_scan_sharded(amps, codes_seq, angles, *, num_qubits,
                          rep_qubits, chunks):
    n, nq = num_qubits, rep_qubits
    nloc = amps.nloc
    dt = amps.dtype
    is_density = n == 2 * nq
    if nloc <= P._DIRECT_MAX_N:
        for codes, ang in zip(codes_seq, angles):
            _direct_rotation_sharded(amps, P.pauli_term(codes, dtype=dt,
                                                        theta=ang))
            if is_density:
                _direct_rotation_sharded(amps, P.pauli_term(
                    codes, dtype=dt, offset=nq, theta=-ang, conj=True))
        return amps
    chunks = min(PAR._pow2_floor(chunks), 1 << nloc)
    body = P.make_trotter_body(
        _np_dtype(amps), nq, is_density,
        layer=lambda a, mats: _layer_sharded(a, mats, n, chunks),
        parity_phase=_parity_phase_sharded)
    for codes, ang in zip(codes_seq, angles):
        amps = body(amps, codes, ang)
    return amps


def expec_pauli_sum_scan_sharded(amps: ShardedAmps, codes_seq, coeffs, *,
                                 num_qubits: int,
                                 chunks: Optional[int] = None):
    """Re <psi| sum_t c_t P_t |psi> on a sharded state vector: per term
    Re <psi|P|psi> from the direct form (one composed permute at most) or
    the rotate-layer body (r exchanges), each shard's partial weighted and
    accumulated, and one sum over the mesh at the end (the reference's
    local reduce and MPI_Allreduce, QuEST_cpu_distributed.c:35-51).
    Counted under "expec".  Returns a 0-d tensor of the state's type."""
    mesh = amps.mesh
    r = PAR.num_shard_bits(mesh)
    nloc = num_qubits - r
    direct = nloc <= P._DIRECT_MAX_N
    payload = PAR._shard_payload_bytes(amps)
    if chunks is None:
        chunks = PAR.exchange_chunks(payload, backend=PAR._backend(amps))
    nterms = len(codes_seq)
    if direct:
        chunks = 1
        nex = nterms
    else:
        nex = r * nterms
    if nex:
        PAR._record_exchange_tiers(
            "expec", _sweep_exchange_tiers(nex, r, payload,
                                           PAR.mesh_topology(mesh), direct),
            chunks)
    return PAR.guarded_dispatch(
        _expec_pauli_sum_scan_sharded, amps, np.asarray(codes_seq),
        np.asarray(coeffs, np.float64), op="expec",
        shards=PAR.amp_axis_size(mesh), consumes=False,
        num_qubits=num_qubits, chunks=int(chunks))


def _expec_pauli_sum_scan_sharded(amps, codes_seq, coeffs, *, num_qubits,
                                  chunks):
    nloc = amps.nloc
    dt = amps.dtype
    real = _np_dtype(amps)
    hi, lo = P._split(nloc)
    acc = [torch.zeros((), dtype=dt, device=s.device) for s in amps.shards]
    if nloc <= P._DIRECT_MAX_N:
        for codes, c in zip(codes_seq, coeffs):
            parts = _apply_pauli_sharded(amps, P.pauli_term(codes, dtype=dt))
            for k, (pr, pi) in enumerate(parts):
                x = amps.shards[k].reshape(2, 1 << hi, 1 << lo)
                v = torch.sum(x[0] * pr + x[1] * pi)
                acc[k] = acc[k] + float(real(c)) * v
        return amps.mesh.sum(acc)
    chunks = min(PAR._pow2_floor(chunks), 1 << nloc)

    def layer(state, mats):
        phi = ShardedAmps(state.mesh, [s.clone() for s in state.shards])
        return _layer_sharded(phi, mats, num_qubits, chunks)

    def signed_norm(phi, zmask):
        zm_loc, szm = _split_mask(zmask, nloc)
        out = []
        for k, s in enumerate(phi.mesh.local):
            f = phi.shards[k].reshape(2, 1 << hi, 1 << lo)
            s_row, s_lane = kernels.parity_sign_factors(
                nloc, [b for b in range(nloc) if (zm_loc >> b) & 1], dt,
                f.device, lo=lo)
            v = torch.sum(s_row * s_lane * (f[0] * f[0] + f[1] * f[1]))
            out.append(_shard_parity_sign(s, szm) * v.to(acc[0].device))
        return torch.stack(out)

    value = P.make_expec_term_value(real, num_qubits, layer=layer,
                                    signed_norm=signed_norm)
    total = torch.zeros(len(acc), dtype=dt, device=acc[0].device)
    for codes, c in zip(codes_seq, coeffs):
        total = total + value(amps, codes, c)
    return amps.mesh.sum([total[k] for k in range(len(acc))])


def _record_pauli(amps: ShardedAmps, terms: Sequence[P.PauliTerm]) -> None:
    """Count the composed permutes of Pauli products outside the scans
    (family "pauli", the port's own: the reference leaves these to GSPMD):
    one full-shard exchange per term that flips a mesh bit."""
    mesh = amps.mesh
    topo = PAR.mesh_topology(mesh)
    payload = PAR._shard_payload_bytes(amps)
    for term in terms:
        sfm = term.fm >> amps.nloc
        if sfm:
            PAR.record_exchange("pauli", 1, payload, chunks=1,
                                tier=topo.tier_of_mask(sfm))


def _terms(codes_flat, num_qubits: int, num_terms: int, dt):
    return [P.pauli_term(codes_flat[t * num_qubits:(t + 1) * num_qubits],
                         dtype=dt) for t in range(num_terms)]


def expec_pauli_sum_statevec_sharded(amps: ShardedAmps, coeffs, *,
                                     num_qubits: int, codes_flat,
                                     num_terms: int):
    """calcExpecPauliProd on a sharded state vector (the reference's
    calc_expec_pauli_sum_statevec under GSPMD): per term the direct
    form's per-shard partials, one sum over the mesh per term."""
    terms = _terms(codes_flat, num_qubits, num_terms, amps.dtype)
    _record_pauli(amps, terms)
    return PAR.guarded_dispatch(_expec_terms_sv, amps, terms,
                                np.asarray(coeffs, np.float64), op="pauli",
                                shards=PAR.amp_axis_size(amps.mesh),
                                consumes=False)


def _expec_terms_sv(amps, terms, coeffs):
    hi, lo = P._split(amps.nloc)
    real = _np_dtype(amps)
    vals = []
    for term, c in zip(terms, coeffs):
        parts = []
        for k, (pr, pi) in enumerate(_apply_pauli_sharded(amps, term)):
            x = amps.shards[k].reshape(2, 1 << hi, 1 << lo)
            parts.append(torch.sum(x[0] * pr + x[1] * pi))
        vals.append(float(real(c)) * amps.mesh.sum(parts))
    return torch.sum(torch.stack(vals))


def expec_pauli_sum_density_sharded(amps: ShardedAmps, coeffs, *,
                                    num_qubits: int, codes_flat,
                                    num_terms: int):
    """Re Tr(rho sum_t c_t P_t) on a sharded density register: P on the
    ket qubits of each shard (a permute only where a ket bit is a mesh
    bit), then the real part of the diagonal entries each shard holds,
    one sum over the mesh per term (calc_expec_pauli_sum_density)."""
    terms = _terms(codes_flat, num_qubits, num_terms, amps.dtype)
    _record_pauli(amps, terms)
    return PAR.guarded_dispatch(_expec_terms_dm, amps, terms,
                                np.asarray(coeffs, np.float64),
                                num_qubits, op="pauli",
                                shards=PAR.amp_axis_size(amps.mesh),
                                consumes=False)


def _expec_terms_dm(amps, terms, coeffs, nq):
    real = _np_dtype(amps)
    offsets = shard_offsets(amps)
    idx = [_diag_index(amps, lo, nq, amps.shards[k].device)
           for k, lo in offsets]
    vals = []
    for term, c in zip(terms, coeffs):
        parts = []
        for k, (pr, _pi) in enumerate(_apply_pauli_sharded(amps, term)):
            parts.append(torch.sum(pr.reshape(-1)[idx[k]]))
        vals.append(float(real(c)) * amps.mesh.sum(parts))
    return torch.sum(torch.stack(vals))


def apply_pauli_sum_sharded(amps: ShardedAmps, coeffs, *, num_qubits: int,
                            codes_flat, num_terms: int) -> ShardedAmps:
    """sum_t c_t P_t |in> as new shards (statevec_applyPauliSum,
    QuEST_common.c:547-569; on a density register the codes act on the
    ket qubits: left multiplication).  The input is read, not changed."""
    terms = _terms(codes_flat, num_qubits, num_terms, amps.dtype)
    _record_pauli(amps, terms)
    return PAR.guarded_dispatch(_apply_terms, amps, terms,
                                np.asarray(coeffs, np.float64), op="pauli",
                                shards=PAR.amp_axis_size(amps.mesh),
                                consumes=False)


def _apply_terms(amps, terms, coeffs):
    cs = torch.as_tensor(coeffs, dtype=amps.dtype)
    acc = [torch.zeros_like(s) for s in amps.shards]
    for t, term in enumerate(terms):
        for k, (pr, pi) in enumerate(_apply_pauli_sharded(amps, term)):
            pv = torch.stack([pr, pi]).reshape(2, -1)
            acc[k] = acc[k] + cs[t].to(pv.device) * pv
    return ShardedAmps(amps.mesh, acc)


# ---------------------------------------------------------------------------
# Pair channels on a mesh (dist.py:686-792, 1153-1245)
# ---------------------------------------------------------------------------


def _pair_channel_weights(kind: str, p, ktv, btv):
    """(w1, w2) of the double-flip pair channels for ket / bra target-bit
    values (ints, or a tensor of ket values): depol w1 = 1 - 2p/3 where
    the bits agree, 1 - 4p/3 where not, w2 = 2p/3 where they agree;
    damping w1 = [[1, s], [s, 1 - p]][bt, kt] (s = sqrt(1 - p)), w2 = p at
    (0, 0).  ``p`` is a 0-d tensor of the state's type."""
    same = ktv == btv
    zero = torch.zeros_like(p)
    one = torch.ones_like(p)
    if kind == "depol":
        return (torch.where(torch.as_tensor(same), 1 - 2 * p / 3,
                            1 - 4 * p / 3),
                torch.where(torch.as_tensor(same), 2 * p / 3, zero))
    s = torch.sqrt(1 - p)
    w1 = torch.where(torch.as_tensor(same),
                     torch.where(torch.as_tensor(ktv == 0), one, 1 - p), s)
    w2 = torch.where(torch.as_tensor((ktv == 0) & (btv == 0)), p, zero)
    return w1, w2


def mix_pair_channel_sharded(amps: ShardedAmps, prob, *, num_qubits: int,
                             target: int, kind: str,
                             chunks: Optional[int] = None) -> ShardedAmps:
    """Depolarise ("depol") or damping ("damping") on a sharded density
    register whose bra target bit is a mesh bit: one chunked full-shard
    exchange with the double-flip partner and an elementwise combine (the
    reference's pack-and-exchange decoherence,
    QuEST_cpu_distributed.c:553-852).  Counted under "pair_channel".
    The input is consumed."""
    mesh = amps.mesh
    payload = PAR._shard_payload_bytes(amps)
    if chunks is None:
        chunks = PAR.exchange_chunks(payload, backend=PAR._backend(amps))
    nloc = 2 * num_qubits - PAR.num_shard_bits(mesh)
    xor_mask = 1 << (target + num_qubits - nloc)
    if target >= nloc:
        xor_mask |= 1 << (target - nloc)
    PAR.record_exchange("pair_channel", 1, payload, chunks=chunks,
                        tier=PAR.mesh_topology(mesh).tier_of_mask(xor_mask))
    return PAR.guarded_dispatch(
        _mix_pair_channel_sharded, amps, prob, op="pair_channel",
        shards=PAR.amp_axis_size(mesh), num_qubits=num_qubits,
        target=target, kind=kind, chunks=int(chunks))


def _mix_pair_channel_sharded(amps, prob, *, num_qubits, target, kind,
                              chunks):
    from ..ops.density import _scalar

    mesh = amps.mesh
    nq = num_qubits
    nloc = amps.nloc
    t, b = target, target + nq
    assert b >= nloc, "local channels take ops/density.py"
    bbit = b - nloc
    # with a local ket bit, the combine flips that bit inside each chunk:
    # chunks hold whole blocks above it
    limit = (1 << nloc) if t >= nloc else (1 << (nloc - 1 - t))
    chunks = min(PAR._pow2_floor(chunks), limit)
    ps = [_scalar(prob, s) for s in amps.shards]
    PAR._contiguous(amps.shards)
    views = [s.view(2, 1, -1) for s in amps.shards]
    if t >= nloc:
        tbit = t - nloc
        w = [_pair_channel_weights(kind, ps[k], (s >> tbit) & 1,
                                   (s >> bbit) & 1)
             for k, s in enumerate(mesh.local)]
        PAR.exchange_pipelined(
            mesh, views,
            [(i, i ^ (1 << bbit) ^ (1 << tbit))
             for i in range(mesh.axis_size)],
            lambda i, k, own, rv: own * w[k][0] + rv * w[k][1],
            chunks=chunks)
        return amps
    w = []
    for k, s in enumerate(mesh.local):
        ktv = torch.arange(2, device=amps.shards[k].device).reshape(
            1, 1, 2, 1)
        w.append(_pair_channel_weights(kind, ps[k], ktv, (s >> bbit) & 1))

    def combine(i, k, own, rv):
        shape = (2, -1, 2, 1 << t)
        v = own.reshape(shape)
        pv = torch.flip(rv.reshape(shape), dims=(2,))
        return (v * w[k][0] + pv * w[k][1]).reshape(own.shape)

    PAR.exchange_pipelined(mesh, views, PAR._hypercube_perm(mesh.axis_size,
                                                            bbit),
                           combine, chunks=chunks)
    return amps


def mix_two_qubit_depol_sharded(amps: ShardedAmps, prob, *,
                                num_qubits: int, qubit1: int,
                                qubit2: int) -> ShardedAmps:
    """Two-qubit depolarising on a sharded density register: the orbit sum
    S = (1 + F2)(1 + F1) rho with one exchange per flip whose bra bit is a
    mesh bit (at most two), then one elementwise combine
    (ops/density.mix_two_qubit_depolarising's block formula).  Counted
    under "depol2" when it exchanges.  The input is consumed."""
    mesh = amps.mesh
    nloc = 2 * num_qubits - PAR.num_shard_bits(mesh)
    topo = PAR.mesh_topology(mesh)
    payload = PAR._shard_payload_bytes(amps)
    parts = {"ici": [0, 0], "dcn": [0, 0]}
    for q in (qubit1, qubit2):
        b = q + num_qubits
        if b < nloc:
            continue
        xor_mask = 1 << (b - nloc)
        if q >= nloc:
            xor_mask |= 1 << (q - nloc)
        acc = parts[topo.tier_of_mask(xor_mask)]
        acc[0] += 1
        acc[1] += payload
    if parts["ici"][0] or parts["dcn"][0]:
        PAR._record_exchange_tiers(
            "depol2", {k: tuple(v) for k, v in parts.items()}, 1)
    return PAR.guarded_dispatch(
        _mix_two_qubit_depol_sharded, amps, prob, op="depol2",
        shards=PAR.amp_axis_size(mesh), num_qubits=num_qubits,
        qubit1=qubit1, qubit2=qubit2)


def _mix_two_qubit_depol_sharded(amps, prob, *, num_qubits, qubit1, qubit2):
    from ..ops.density import _scalar

    mesh = amps.mesh
    nq = num_qubits
    nloc = amps.nloc
    ndev = mesh.axis_size
    hi, lo = kernels._split2(nloc)

    def dflip(xs, t, b):
        # flip ket bit t and bra bit b (t < b) of every shard in ``xs``
        if b < nloc:
            return [kernels._flip_bits_flat(x, nloc, (t, b)) for x in xs]
        if t < nloc:
            recv = mesh.permute(xs, PAR._hypercube_perm(ndev, b - nloc))
            return [kernels._flip_bits_flat(x, nloc, (t,)) for x in recv]
        return mesh.permute(xs, [(i, i ^ (1 << (t - nloc)) ^ (1 << (b - nloc)))
                                 for i in range(ndev)])

    x = [s.reshape(2, -1) for s in amps.shards]
    f1 = dflip(x, qubit1, qubit1 + nq)
    s = [a + f for a, f in zip(x, f1)]
    del f1
    f2 = dflip(s, qubit2, qubit2 + nq)
    s = [a + f for a, f in zip(s, f2)]
    del f2
    for k, sh in enumerate(mesh.local):
        own = amps.shards[k]
        dt, dev = own.dtype, own.device
        p = _scalar(prob, own)

        def bitval(pos):
            if pos < nloc:
                return kernels.bit_2d(nloc, pos, dev).to(dt)
            return torch.tensor(float((sh >> (pos - nloc)) & 1), dtype=dt,
                                device=dev)

        def same(t, b):
            d = bitval(t) - bitval(b)
            return 1 - d * d

        block = same(qubit1, qubit1 + nq) * same(qubit2, qubit2 + nq)
        c1 = 1 - 16 * p / 15
        c2 = 4 * p / 15
        v = own.reshape(2, 1 << hi, 1 << lo)
        sv = s[k].reshape(2, 1 << hi, 1 << lo)
        s[k] = None
        amps.shards[k] = (v * c1 + sv * torch.broadcast_to(
            c2 * block, (1 << hi, 1 << lo))[None]).reshape(own.shape)
    return amps


# ---------------------------------------------------------------------------
# The diagonal operator of a density register (dist.py:1247-1274)
# ---------------------------------------------------------------------------


def apply_diag_op_density_sharded(amps: ShardedAmps, op_re_parts,
                                  op_im_parts, *,
                                  num_qubits: int) -> ShardedAmps:
    """D rho on a sharded density register: element (row, col) scales by
    D[row], the rows being the low n index bits, so every shard needs the
    whole operator.  ``op_*_parts`` are the local shards' slices of the
    operator (R equal slices of its 2^n entries); two all-gathers rebuild
    it on every shard and the state's sharding is not touched (the
    reference's copyDiagOpIntoMatrixPairState,
    QuEST_cpu_distributed.c:1548-1587).  The input is consumed."""
    return PAR.guarded_dispatch(
        _apply_diag_op_density_sharded, amps, list(op_re_parts),
        list(op_im_parts), op="diag_op",
        shards=PAR.amp_axis_size(amps.mesh), num_qubits=num_qubits)


def _apply_diag_op_density_sharded(amps, op_re_parts, op_im_parts, *,
                                   num_qubits):
    nq = num_qubits
    nloc = amps.nloc
    assert nloc >= nq, "op rows must be shard-local (r <= num_qubits)"
    re_full = amps.mesh.all_gather(op_re_parts)
    im_full = amps.mesh.all_gather(op_im_parts)
    for k, own in enumerate(amps.shards):
        v = own.reshape(2, 1 << (nloc - nq), 1 << nq)
        f_re = re_full.to(device=own.device, dtype=own.dtype)[None]
        f_im = im_full.to(device=own.device, dtype=own.dtype)[None]
        amps.shards[k] = cplx.cmul(v, f_re, f_im).reshape(own.shape)
    return amps


# ---------------------------------------------------------------------------
# The QFT on a mesh (dist.py:1276-1631)
# ---------------------------------------------------------------------------

_INV_SQRT2 = 0.7071067811865476


def _ladder_phase_chunks(nbits: int, t_eff: int, sgn: float, dt):
    """Host tables of exp(sgn i pi li / 2^t_eff) over 7-bit chunks of the
    ``nbits``-bit index li, low chunk first: [(width, (2, 2^width)
    table), ...] (the phase of a sum of bit contributions factorises)."""
    out = []
    p = 0
    while p < nbits:
        w = min(7, nbits - p)
        j = np.arange(1 << w, dtype=np.float64)
        ang = sgn * np.pi * (j * (1 << p)) / (1 << t_eff)
        out.append((w, np.stack([np.cos(ang), np.sin(ang)]).astype(dt)))
        p += w
    return out


def _apply_local_phase(local, chunks, skip: int = 0):
    """Multiply by the factored phase over the local index bits
    [skip, nloc), leaving a trailing untouched 2^skip axis."""
    widths = [w for w, _ in chunks]
    shape = [2] + [1 << w for w in reversed(widths)]
    if skip:
        shape.append(1 << skip)
    v = local.reshape(shape)
    ndim = len(shape) - 1
    off = 1 if skip else 0
    for ci, (w, tab) in enumerate(chunks):
        bshape = [1] * ndim
        bshape[ndim - 1 - ci - off] = 1 << w
        t = torch.as_tensor(tab, device=local.device)
        v = cplx.cmul(v, t[0].reshape(bshape), t[1].reshape(bshape))
    return v.reshape(local.shape)


def _qft_mesh_layer(amps: ShardedAmps, t: int, base: int,
                    sgn: float) -> None:
    """One QFT layer on mesh qubit t >= nloc: the full-shard exchange with
    the partner on t's mesh bit, the Hadamard combine, and on the shards
    whose bit t is 1 the controlled-phase ladder over the run bits
    [base, t), its phase a per-shard scalar (the ladder's mesh bits) times
    the factored local tables.  In the shard list."""
    mesh = amps.mesh
    nloc = amps.nloc
    dt = amps.dtype
    bit = t - nloc
    recv = mesh.permute(amps.shards,
                        PAR._hypercube_perm(mesh.axis_size, bit))
    inv = torch.tensor(_INV_SQRT2, dtype=dt)
    sb = max(base - nloc, 0)
    width = bit - sb
    tabs = (_ladder_phase_chunks(nloc - base, t - base, sgn,
                                 _np_dtype(amps)) if base < nloc else None)
    for k, s in enumerate(mesh.local):
        mybit = (s >> bit) & 1
        own = amps.shards[k]
        comb = (own * (1.0 if mybit == 0 else -1.0) + recv[k]) * inv
        recv[k] = None
        if mybit:
            if tabs:
                comb = _apply_local_phase(comb, tabs, skip=base)
            if width:
                mlow = (s >> sb) & ((1 << width) - 1)
                theta = (torch.tensor(sgn * math.pi, dtype=dt)
                         * torch.tensor(float(mlow), dtype=dt) / (1 << width))
                comb = cplx.cmul(comb, torch.cos(theta), torch.sin(theta))
        amps.shards[k] = comb


def fused_qft_sharded(amps: ShardedAmps, *, num_qubits: int,
                      conj: bool = False) -> ShardedAmps:
    """The QFT of a whole sharded state vector (agnostic_applyQFT,
    QuEST_common.c:836-898): the r mesh-bit layers by exchange, the local
    layers per shard through the one-register kernels (the multilayer
    route, K8 then K9, on a float32 card shard of at least 15 bits; else
    one ladder per layer, K6 / K7 where the ladder kernels apply), and the
    bit reversal rev[0, n) = rev[0, r) o all_to_all o (rev[0, r) x
    rev[r, nloc)).  Counted under "qft": r full-shard exchanges and the
    all_to_all's (R - 1) / R of a shard.  The input is consumed."""
    mesh = amps.mesh
    r = PAR.num_shard_bits(mesh)
    if r:
        payload = PAR._shard_payload_bytes(amps)
        ndev = PAR.amp_axis_size(mesh)
        t = PAR.mesh_topology(mesh)
        a2a_total = (payload * (ndev - 1)) // ndev
        a2a_dcn = (payload * (ndev - t.chips)) // ndev
        multi = t.dcn_bits > 0
        PAR._record_exchange_tiers(
            "qft",
            {"ici": (t.ici_bits + (0 if multi else 1),
                     t.ici_bits * payload + (a2a_total - a2a_dcn)),
             "dcn": (t.dcn_bits + (1 if multi else 0),
                     t.dcn_bits * payload + a2a_dcn)}, 1)
    return PAR.guarded_dispatch(
        _fused_qft_sharded, amps, op="qft", shards=PAR.amp_axis_size(mesh),
        num_qubits=num_qubits, conj=conj)


def _fused_qft_sharded(amps, *, num_qubits, conj):
    from ..ops import fused

    n = num_qubits
    r = PAR.num_shard_bits(amps.mesh)
    nloc = n - r
    sgn = -1.0 if conj else 1.0
    for t in range(n - 1, nloc - 1, -1):
        _qft_mesh_layer(amps, t, 0, sgn)
    perm1 = tuple([r - 1 - q for q in range(r)]
                  + [r + (nloc - 1 - q) for q in range(r, nloc)])
    for k in range(len(amps.shards)):
        local = amps.shards[k]
        if (fused.qft_multilayer_enabled(local)
                and nloc >= fused.CLUSTER_QUBITS + 1):
            local = fused.apply_qft_multilayer_ladders(
                local, num_qubits=nloc, t_top=nloc - 1, conj=conj)
            low_start = fused.LANE_QUBITS - 1
        else:
            low_start = nloc - 1
        for t in range(low_start, -1, -1):
            local = kernels.apply_qft_ladder(local, num_qubits=nloc,
                                             target=t, conj=conj)
        amps.shards[k] = None
        amps.shards[k] = kernels.permute_qubits(local, num_qubits=nloc,
                                                perm=perm1)
        del local
    # the (2, 2^(nloc-r), R) view's last axis, block j to shard j
    blocks = [s.reshape(2, 1 << (nloc - r), 1 << r).permute(2, 0, 1)
              for s in amps.shards]
    recv = amps.mesh.all_to_all(blocks)
    del blocks
    perm2 = tuple([r - 1 - q for q in range(r)] + list(range(r, nloc)))
    for k in range(len(amps.shards)):
        amps.shards[k] = None
        local = recv[k].permute(1, 2, 0).reshape(2, -1)
        recv[k] = None
        amps.shards[k] = kernels.permute_qubits(local, num_qubits=nloc,
                                                perm=perm2)
    return amps


def _reverse_run_sharded(amps: ShardedAmps, base: int, count: int) -> None:
    """Bit reversal of the run [base, base + count), as disjoint swaps:
    local-local pairs fold into one per-shard axis permutation, mesh-mesh
    pairs into one composed shard permute, and each local-mesh pair is a
    half-shard swap (QuEST_cpu_distributed.c:1397-1436)."""
    mesh = amps.mesh
    nloc = amps.nloc
    top = base + count
    perm_local = list(range(nloc))
    mesh_pairs, mixed = [], []
    for i in range(count // 2):
        p, q = base + i, top - 1 - i
        if q < nloc:
            perm_local[p], perm_local[q] = perm_local[q], perm_local[p]
        elif p >= nloc:
            mesh_pairs.append((p - nloc, q - nloc))
        else:
            mixed.append((p, q - nloc))
    if perm_local != list(range(nloc)):
        for k in range(len(amps.shards)):
            amps.shards[k] = kernels.permute_qubits(
                amps.shards[k], num_qubits=nloc, perm=tuple(perm_local))
    if mesh_pairs:
        def sig(i):
            j = i
            for a, b in mesh_pairs:
                ba, bb = (i >> a) & 1, (i >> b) & 1
                j = (j & ~((1 << a) | (1 << b))) | (ba << b) | (bb << a)
            return j

        recv = mesh.permute(amps.shards,
                            [(i, sig(i)) for i in range(mesh.axis_size)])
        amps.shards[:] = recv
    for lb, mb in mixed:
        # reversals stay monolithic: a pure relabel has no combine to hide
        # the transfer behind
        PAR._swap_halves(mesh, amps.shards, lb, mb, nloc, 1)


def qft_runs_exchange_model(runs, nloc: int, itemsize: int = 8):
    """(exchange count, per-shard bytes) of fused_qft_runs_sharded: per
    run reaching mesh bits, one full-shard exchange per mesh-bit layer,
    one half-shard swap per local-mesh reversal pair and one composed
    full-shard permute when mesh-mesh pairs fold.  Local runs cost
    nothing."""
    shard = 2 * (1 << nloc) * itemsize
    count = 0
    nbytes = 0
    for base, cnt, _conj in runs:
        top = base + cnt
        layers = max(0, top - max(base, nloc))
        count += layers
        nbytes += layers * shard
        mixed = mesh_pairs = 0
        for i in range(cnt // 2):
            p, q = base + i, top - 1 - i
            if q < nloc:
                continue
            if p >= nloc:
                mesh_pairs += 1
            else:
                mixed += 1
        if mesh_pairs:
            count += 1
            nbytes += shard
        count += mixed
        nbytes += mixed * (shard // 2)
    return count, nbytes


def qft_runs_exchange_tiers(runs, nloc: int, itemsize: int = 8,
                            topology=None):
    """The tier split of qft_runs_exchange_model: a mesh-bit layer and a
    local-mesh pair ride their mesh bit's tier, the composed mesh-mesh
    permute the slower tier of the bits it moves; the tiers sum to the
    model."""
    t = topology
    shard = 2 * (1 << nloc) * itemsize
    parts = {"ici": [0, 0], "dcn": [0, 0]}

    def tier_of(mesh_bit):
        return t.tier_of_bit(mesh_bit) if t is not None else "ici"

    for base, cnt, _conj in runs:
        top = base + cnt
        for q in range(max(base, nloc), top):
            acc = parts[tier_of(q - nloc)]
            acc[0] += 1
            acc[1] += shard
        mesh_mask = 0
        for i in range(cnt // 2):
            p, q = base + i, top - 1 - i
            if q < nloc:
                continue
            if p >= nloc:
                mesh_mask |= (1 << (p - nloc)) | (1 << (q - nloc))
            else:
                acc = parts[tier_of(q - nloc)]
                acc[0] += 1
                acc[1] += shard // 2
        if mesh_mask:
            tier = t.tier_of_mask(mesh_mask) if t is not None else "ici"
            parts[tier][0] += 1
            parts[tier][1] += shard
    return {k: (v[0], v[1]) for k, v in parts.items()}


def fused_qft_runs_sharded(amps: ShardedAmps, *, num_qubits: int,
                           runs: Tuple[Tuple[int, int, bool], ...]
                           ) -> ShardedAmps:
    """The QFT of contiguous runs [(base, count, conj), ...] of a sharded
    register (a partial QFT, or the density register's ket run and its
    conjugated bra run): a run inside a window-sized shard is the
    one-register fused QFT per shard; a run reaching mesh bits takes the
    mesh-bit layers by exchange, its local layers per shard (ladder
    kernels) and the mixed bit reversal.  Counted under "qft_runs"
    (qft_runs_exchange_tiers).  The input is consumed."""
    mesh = amps.mesh
    nloc = num_qubits - PAR.num_shard_bits(mesh)
    cnt, _nbytes = qft_runs_exchange_model(runs, nloc, amps.itemsize)
    if cnt:
        PAR._record_exchange_tiers(
            "qft_runs", qft_runs_exchange_tiers(runs, nloc, amps.itemsize,
                                                PAR.mesh_topology(mesh)), 1)
    return PAR.guarded_dispatch(
        _fused_qft_runs_sharded, amps, op="qft_runs",
        shards=PAR.amp_axis_size(mesh), num_qubits=num_qubits,
        runs=tuple(runs))


def _fused_qft_runs_sharded(amps, *, num_qubits, runs):
    from .. import circuit as CIRC

    nloc = amps.nloc
    for base, count, conj in runs:
        top = base + count
        sgn = -1.0 if conj else 1.0
        if top <= nloc and nloc >= CIRC.WINDOW:
            for k in range(len(amps.shards)):
                amps.shards[k] = CIRC.fused_qft(
                    amps.shards[k], nloc, base, count, shifts=(0,),
                    conj_first=conj)
            continue
        for t in range(top - 1, max(base, nloc) - 1, -1):
            _qft_mesh_layer(amps, t, base, sgn)
        for k in range(len(amps.shards)):
            local = amps.shards[k]
            for t in range(min(top, nloc) - 1, base - 1, -1):
                local = kernels.apply_qft_ladder(
                    local, num_qubits=nloc, target=t, base=base, conj=conj)
            amps.shards[k] = local
        _reverse_run_sharded(amps, base, count)
    return amps
