"""A sharded register's states and reads, shard by shard.

Each state initialisation writes every shard from its own global index
range (shard s holds ``[s 2^nloc, (s + 1) 2^nloc)``), so no full state is
ever built on one device; each read takes a per-shard partial and one sum
over the mesh (``Mesh.sum``), the reference's local reduce plus
MPI_Allreduce (QuEST_cpu_distributed.c:1308-1322).  The reads run on
canonical-order amplitudes (the register's ``amps`` getter restores the
order first, as the JAX package's getter does).

At quad precision (``set_precision(4)``) a read takes each shard's share
of the one-register route's double-double block partials
(calculations.quad_partials_piece), gathers them in shard order
(``Mesh.all_gather``) and runs one Neumaier combine on the host, so the
value is the one-register quad route's (``quad_sum_pieces``).

A register bank on a mesh (batch.BatchedQureg) holds ``(B, 2, 2^nloc)``
shards: ``broadcast_bank`` lifts one state to every element (the init
family), ``prob_of_outcome_bank`` takes every element's probability in
one sum over the mesh, ``collapse_drawn_bank`` collapses each element
onto its own outcome.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops import calculations as CALC
from ..ops import cplx
from .mesh import Mesh, ShardedAmps


def shard_offsets(amps: ShardedAmps):
    """(local shard index k, first global index of that shard) pairs."""
    m = 1 << amps.nloc
    return [(k, s * m) for k, s in enumerate(amps.mesh.local)]


def from_fn(mesh: Mesh, nloc: int, dtype,
            fn: Callable[[int, int, torch.dtype, torch.device],
                         torch.Tensor]) -> ShardedAmps:
    """A sharded state whose shard s is ``fn(start, count, dtype, device)``
    for its global index range."""
    m = 1 << nloc
    return ShardedAmps(mesh, [fn(s * m, m, dtype, mesh.device_of(s))
                              for s in mesh.local])


def blank(mesh, nloc, dtype) -> ShardedAmps:
    return from_fn(mesh, nloc, dtype, lambda lo, m, dt, dev: torch.zeros(
        (2, m), dtype=dt, device=dev))


def classical(mesh, nloc, dtype, index: int) -> ShardedAmps:
    """|index>: a 1 in the owning shard, zeros elsewhere."""
    def fn(lo, m, dt, dev):
        out = torch.zeros((2, m), dtype=dt, device=dev)
        if lo <= index < lo + m:
            out[0, index - lo] = 1.0
        return out

    return from_fn(mesh, nloc, dtype, fn)


def uniform(mesh, nloc, dtype, value: float) -> ShardedAmps:
    """Every amplitude ``value`` (real): |+>^n and the plus density."""
    def fn(lo, m, dt, dev):
        out = torch.zeros((2, m), dtype=dt, device=dev)
        out[0] = value
        return out

    return from_fn(mesh, nloc, dtype, fn)


def debug(mesh, nloc, dtype) -> ShardedAmps:
    """amp_k = (2k mod 10)/10 + i((2k+1) mod 10)/10 at global index k
    (initStateDebug, QuEST_cpu.c:1646)."""
    def fn(lo, m, dt, dev):
        k = torch.arange(lo, lo + m, dtype=dt, device=dev)
        return torch.stack([torch.remainder(2.0 * k, 10.0) / 10.0,
                            torch.remainder(2.0 * k + 1.0, 10.0) / 10.0])

    return from_fn(mesh, nloc, dtype, fn)


def sparse(mesh, nloc, dtype, indices, res, ims) -> ShardedAmps:
    """Nonzero amplitudes ``res + i ims`` at global ``indices``, written
    shard by shard (initSparseState)."""
    indices = np.asarray(indices, dtype=np.int64)
    res, ims = np.asarray(res), np.asarray(ims)

    def fn(lo, m, dt, dev):
        out = torch.zeros((2, m), dtype=dt, device=dev)
        sel = (indices >= lo) & (indices < lo + m)
        if sel.any():
            idx = torch.as_tensor(indices[sel] - lo, device=dev)
            out[0, idx] = torch.as_tensor(res[sel], dtype=dt, device=dev)
            out[1, idx] = torch.as_tensor(ims[sel], dtype=dt, device=dev)
        return out

    return from_fn(mesh, nloc, dtype, fn)


def split(mesh: Mesh, full, nloc: int, dtype) -> ShardedAmps:
    """A whole (2, 2^n) state, or (B, 2, 2^n) bank, (tensor or NumPy)
    cut into the local shards, each copied to its device."""
    if not torch.is_tensor(full):
        full = torch.from_numpy(np.array(full))
    return from_fn(mesh, nloc, dtype, lambda lo, m, dt, dev: full[
        ..., lo:lo + m].to(device=dev, dtype=dt, copy=True))


def broadcast_bank(amps: ShardedAmps, batch: int) -> ShardedAmps:
    """One register's sharded state as the state of every element of a
    bank of ``batch``: each shard lifted to (B, 2, 2^nloc) (the init
    family writes one state for all elements, batch.BatchedQureg)."""
    return ShardedAmps(amps.mesh, [
        s.unsqueeze(0).expand((int(batch),) + tuple(s.shape)).contiguous()
        for s in amps.shards])


def pure_density(mesh: Mesh, psi: torch.Tensor, num_qubits: int, nloc: int,
                 dtype) -> ShardedAmps:
    """rho = |psi><psi| (column-major: flat[r + c dim] = psi_r conj(psi_c))
    from the whole pure state ``psi``, each shard built from its columns."""
    dim = 1 << num_qubits
    z = cplx.to_complex(psi.to(dtype))

    def fn(lo, m, dt, dev):
        zz = z.to(dev)
        flat = torch.arange(lo, lo + m, device=dev)
        r, c = flat % dim, flat // dim
        return cplx.from_complex(zz[r] * zz[c].conj()).to(dt)

    return from_fn(mesh, nloc, dtype, fn)


def set_range(amps: ShardedAmps, start: int, vals) -> None:
    """Overwrite global amplitudes [start, start + m) with ``vals`` (2, m)
    in place, each piece in its shard (setAmps)."""
    vals = np.asarray(vals)
    m_all = vals.shape[1]
    m = 1 << amps.nloc
    for k, lo in shard_offsets(amps):
        a, b = max(start, lo), min(start + m_all, lo + m)
        if a < b:
            sh = amps.shards[k]
            sh[:, a - lo:b - lo] = torch.as_tensor(
                vals[:, a - start:b - start], dtype=sh.dtype,
                device=sh.device)


def sum_partials(amps: ShardedAmps, partials: Sequence[torch.Tensor]):
    """The sum over every shard of its partial (the local partials given,
    aligned with ``mesh.local``): one value, the same on every shard."""
    return amps.mesh.sum(list(partials))


def gather_device(amps: ShardedAmps) -> torch.Tensor:
    """The whole register, the shards concatenated in shard order, on the
    first local shard's device (it moves the whole state)."""
    return amps.mesh.gather(amps.shards)


def gather_rows(amps: ShardedAmps) -> torch.Tensor:
    """The whole (2, 2^n) register gathered along its amplitude axis
    through the mesh's all_gather of the transposed shards, on the first
    local shard's device."""
    return amps.mesh.all_gather([s.t() for s in amps.shards]).t()


def partners(mesh: Mesh, xs, mask: int):
    """Per local shard s, shard s ^ mask's tensor, through the mesh's
    differentiable exchange (the models' state on a mesh)."""
    if not mask:
        return list(xs)
    return mesh.exchange(xs, [(i, i ^ mask) for i in range(mesh.axis_size)])


def quad_sum_pieces(mesh: Mesh, pieces: Sequence[torch.Tensor], total: int,
                    max_piece: int) -> float:
    """The double-double sum of a ``total``-value vector whose values the
    local shards hold as contiguous runs ``pieces`` (in global order,
    shard after shard; a shard may hold none): each shard's share of the
    one-register block partials (calculations.quad_partials_piece), zero
    padded to the partials of the longest run, ``max_piece`` values (the
    same on every process), all gathered in shard order and combined by
    one Neumaier sum on the host.  A zero is an exact no-op of the
    Neumaier step, so the value is the one-register quad route's
    wherever each shard holds whole partials."""
    slots = CALC.quad_slots(int(max_piece), int(total))
    parts = []
    for p in pieces:
        q = CALC.quad_partials_piece(p, total)
        parts.append(torch.nn.functional.pad(q, (0, slots - q.numel())))
    return CALC.neumaier_sum(mesh.all_gather(parts))


def _quad2(amps: ShardedAmps, xs, ys, total: int, max_piece: int) -> float:
    """quad_sum_pieces of two channels, each its own compensated sum
    (calculations.quad_sum2)."""
    return (quad_sum_pieces(amps.mesh, xs, total, max_piece)
            + quad_sum_pieces(amps.mesh, ys, total, max_piece))


def _diag_count(lo: int, m: int, num_qubits: int) -> int:
    """How many density diagonal entries the shard [lo, lo + m) holds."""
    dim = 1 << num_qubits
    d0 = -(-lo // (dim + 1))
    d1 = (lo + m - 1) // (dim + 1)
    return max(0, d1 - d0 + 1)


def _diag_max(amps: ShardedAmps, num_qubits: int) -> int:
    """The most diagonal entries any shard of the mesh holds."""
    m = 1 << amps.nloc
    return max(_diag_count(s * m, m, num_qubits)
               for s in range(amps.mesh.axis_size))


def total_prob_quad(amps: ShardedAmps, density: bool = False,
                    num_qubits: int = 0) -> float:
    """calcTotalProb at quad precision, shard by shard."""
    if density:
        return quad_sum_pieces(
            amps.mesh, [_diag_entries(amps, k, lo, num_qubits)[0]
                        for k, lo in shard_offsets(amps)],
            1 << num_qubits, _diag_max(amps, num_qubits))
    m = 1 << amps.nloc
    total = m * amps.mesh.axis_size
    return _quad2(amps, [s[0] * s[0] for s in amps.shards],
                  [s[1] * s[1] for s in amps.shards], total, m)


def prob_of_outcome_quad(amps: ShardedAmps, target: int, outcome: int,
                         density: bool = False, num_qubits: int = 0) -> float:
    """calcProbOfOutcome at quad precision: the half of the index space
    (or of the density diagonal) whose target bit is ``outcome``, each
    shard's run of it in global order."""
    nloc = amps.nloc
    if density:
        pieces = []
        for k, lo in shard_offsets(amps):
            v, d = _diag_entries(amps, k, lo, num_qubits)
            pieces.append(v[((d >> target) & 1) == outcome])
        return quad_sum_pieces(amps.mesh, pieces, 1 << (num_qubits - 1),
                               _diag_max(amps, num_qubits))
    m = 1 << nloc
    total = m * amps.mesh.axis_size // 2
    xs, ys = [], []
    for k, s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        if target < nloc:
            half = sh.reshape(2, 1 << (nloc - 1 - target), 2,
                              1 << target)[:, :, int(outcome), :]
        elif ((s >> (target - nloc)) & 1) == outcome:
            half = sh
        else:
            half = sh[:, :0]
        xs.append(half[0] * half[0])
        ys.append(half[1] * half[1])
    return _quad2(amps, xs, ys, total, m)


def inner_product_quad(bra: ShardedAmps, ket: ShardedAmps):
    """<bra|ket> at quad precision as (re, im) floats."""
    m = 1 << bra.nloc
    total = m * bra.mesh.axis_size
    pairs = [(a, b.to(a.device)) for a, b in zip(bra.shards, ket.shards)]
    re = _quad2(bra, [a[0] * b[0] for a, b in pairs],
                [a[1] * b[1] for a, b in pairs], total, m)
    im = _quad2(bra, [a[0] * b[1] for a, b in pairs],
                [-(a[1] * b[0]) for a, b in pairs], total, m)
    return re, im


def density_inner_product_quad(a: ShardedAmps, b: ShardedAmps) -> float:
    m = 1 << a.nloc
    total = m * a.mesh.axis_size
    pairs = [(x, y.to(x.device)) for x, y in zip(a.shards, b.shards)]
    return _quad2(a, [x[0] * y[0] for x, y in pairs],
                  [x[1] * y[1] for x, y in pairs], total, m)


def purity_quad(a: ShardedAmps) -> float:
    m = 1 << a.nloc
    return _quad2(a, [x[0] * x[0] for x in a.shards],
                  [x[1] * x[1] for x in a.shards], m * a.mesh.axis_size, m)


def hilbert_schmidt_distance_quad(a: ShardedAmps, b: ShardedAmps) -> float:
    m = 1 << a.nloc
    ds = [x - y.to(x.device) for x, y in zip(a.shards, b.shards)]
    return math.sqrt(_quad2(a, [d[0] * d[0] for d in ds],
                            [d[1] * d[1] for d in ds],
                            m * a.mesh.axis_size, m))


def fidelity_density_quad(rho: ShardedAmps, psi: torch.Tensor,
                          num_qubits: int) -> float:
    """<psi|rho|psi> at quad precision in the elementwise form of
    calculations.calc_fidelity_density: every signed term
    Re[conj(psi_r) rho_rc psi_c] of the shard's entries (flat index
    r + c dim) in the compensated sum."""
    dim = 1 << num_qubits
    m = 1 << rho.nloc
    xs, ys = [], []
    for k, lo in shard_offsets(rho):
        sh = rho.shards[k]
        p = psi.to(device=sh.device, dtype=sh.dtype)
        flat = torch.arange(lo, lo + m, device=sh.device)
        r, c = flat % dim, flat // dim
        a = p[0, c] * p[0, r] + p[1, c] * p[1, r]
        b = p[1, c] * p[0, r] - p[0, c] * p[1, r]
        xs.append(sh[0] * a)
        ys.append(-(sh[1] * b))
    return _quad2(rho, xs, ys, m * rho.mesh.axis_size, m)


def expec_diagonal_statevec_quad(amps: ShardedAmps, op_real, op_imag):
    """sum_i |amp_i|^2 d_i at quad precision as (re, im) floats."""
    m = 1 << amps.nloc
    total = m * amps.mesh.axis_size
    cols = []
    for k, lo in shard_offsets(amps):
        sh = amps.shards[k]
        cols.append((sh[0] * sh[0], sh[1] * sh[1],
                     op_real[lo:lo + m].to(sh.device),
                     op_imag[lo:lo + m].to(sh.device)))
    re = _quad2(amps, [a * r for a, _b, r, _i in cols],
                [b * r for _a, b, r, _i in cols], total, m)
    im = _quad2(amps, [a * i for a, _b, _r, i in cols],
                [b * i for _a, b, _r, i in cols], total, m)
    return re, im


def expec_diagonal_density_quad(amps: ShardedAmps, op_real, op_imag,
                                num_qubits: int):
    """sum_r d_r rho_rr at quad precision as (re, im) floats."""
    ents = []
    for k, lo in shard_offsets(amps):
        sh = amps.shards[k]
        d = _diag_rows(amps, lo, num_qubits, sh.device)
        v = sh[:, d * ((1 << num_qubits) + 1) - lo]
        ents.append((v, op_real.to(sh.device)[d].to(sh.dtype),
                     op_imag.to(sh.device)[d].to(sh.dtype)))
    total, mx = 1 << num_qubits, _diag_max(amps, num_qubits)
    re = (quad_sum_pieces(amps.mesh, [v[0] * r for v, r, _i in ents],
                          total, mx)
          + quad_sum_pieces(amps.mesh, [-(v[1] * i) for v, _r, i in ents],
                            total, mx))
    im = (quad_sum_pieces(amps.mesh, [v[0] * i for v, _r, i in ents],
                          total, mx)
          + quad_sum_pieces(amps.mesh, [v[1] * r for v, r, _i in ents],
                            total, mx))
    return re, im


def amp_pair(amps: ShardedAmps, index: int) -> torch.Tensor:
    """(re, im) of global amplitude ``index``: the owning shard's value,
    zeros from the others, one sum."""
    m = 1 << amps.nloc
    parts = []
    for k, lo in shard_offsets(amps):
        sh = amps.shards[k]
        if lo <= index < lo + m:
            parts.append(sh[:, index - lo].clone())
        else:
            parts.append(torch.zeros(2, dtype=sh.dtype, device=sh.device))
    return sum_partials(amps, parts)


def prob_of_outcome_statevec(amps: ShardedAmps, target: int,
                             outcome: int) -> torch.Tensor:
    """P(target = outcome): a local target reads its half of each shard;
    a sharded one takes whole shards whose index bit matches."""
    nloc = amps.nloc
    parts = []
    for k, s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        if target < nloc:
            parts.append(CALC.calc_prob_of_outcome_statevec(
                sh, num_qubits=nloc, target=target, outcome=outcome))
        elif ((s >> (target - nloc)) & 1) == outcome:
            parts.append(CALC.calc_total_prob_statevec(sh))
        else:
            parts.append(torch.zeros((), dtype=sh.dtype, device=sh.device))
    return sum_partials(amps, parts)


def _histogram(vals: torch.Tensor, global_idx: torch.Tensor,
               qubits: Tuple[int, ...]) -> torch.Tensor:
    """Sum ``vals`` by the bits of ``qubits`` of their global indices:
    outcome bit j <-> qubits[j]."""
    out_idx = torch.zeros_like(global_idx)
    for j, q in enumerate(qubits):
        out_idx |= ((global_idx >> q) & 1) << j
    hist = torch.zeros(1 << len(qubits), dtype=vals.dtype,
                       device=vals.device)
    return hist.index_add_(0, out_idx, vals)


def all_outcomes_statevec(amps: ShardedAmps,
                          qubits: Tuple[int, ...]) -> torch.Tensor:
    """The 2^k outcome probabilities of ``qubits``: the local qubits'
    histogram of each shard placed at the shard's fixed outcome bits."""
    nloc = amps.nloc
    local = [(j, q) for j, q in enumerate(qubits) if q < nloc]
    parts = []
    for k, s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        fixed = 0
        for j, q in enumerate(qubits):
            if q >= nloc:
                fixed |= ((s >> (q - nloc)) & 1) << j
        full = torch.zeros(1 << len(qubits), dtype=sh.dtype,
                           device=sh.device)
        probs = cplx.abs2(sh)
        if local:
            h = CALC._outcome_histogram(probs, nloc,
                                        tuple(q for _j, q in local))
            idx = torch.arange(h.numel(), device=sh.device)
            place = torch.full_like(idx, fixed)
            for i, (j, _q) in enumerate(local):
                place |= ((idx >> i) & 1) << j
            full.index_add_(0, place, h)
        else:
            full[fixed] = probs.sum()
        parts.append(full)
    return sum_partials(amps, parts)


def _diag_rows(amps: ShardedAmps, lo: int, num_qubits: int, device):
    """The rows d of the density diagonal entries rho[d, d] that the shard
    starting at global index ``lo`` holds: flat index d (dim + 1) in
    [lo, lo + 2^nloc)."""
    dim = 1 << num_qubits
    m = 1 << amps.nloc
    d0 = -(-lo // (dim + 1))
    d1 = (lo + m - 1) // (dim + 1)
    return torch.arange(d0, max(d1 + 1, d0), device=device)


def _diag_index(amps: ShardedAmps, lo: int, num_qubits: int, device=None):
    """Local positions of those diagonal entries in the shard."""
    d = _diag_rows(amps, lo, num_qubits, device)
    return d * ((1 << num_qubits) + 1) - lo


def _diag_entries(amps: ShardedAmps, k: int, lo: int, num_qubits: int):
    """(values, d) of the density diagonal entries rho[d, d] held by local
    shard k (real parts)."""
    sh = amps.shards[k]
    d = _diag_rows(amps, lo, num_qubits, sh.device)
    return sh[0, d * ((1 << num_qubits) + 1) - lo], d


def total_prob_density(amps: ShardedAmps, num_qubits: int) -> torch.Tensor:
    """Re(trace(rho)) from each shard's diagonal entries."""
    return sum_partials(amps, [_diag_entries(amps, k, lo, num_qubits)[0].sum()
                       for k, lo in shard_offsets(amps)])


def prob_of_outcome_density(amps: ShardedAmps, num_qubits: int,
                            target: int, outcome: int) -> torch.Tensor:
    parts = []
    for k, lo in shard_offsets(amps):
        v, d = _diag_entries(amps, k, lo, num_qubits)
        parts.append(v[((d >> target) & 1) == outcome].sum())
    return sum_partials(amps, parts)


def all_outcomes_density(amps: ShardedAmps, num_qubits: int,
                         qubits: Tuple[int, ...]) -> torch.Tensor:
    parts = []
    for k, lo in shard_offsets(amps):
        v, d = _diag_entries(amps, k, lo, num_qubits)
        parts.append(_histogram(v, d, qubits))
    return sum_partials(amps, parts)


def gather_host(amps: ShardedAmps) -> np.ndarray:
    """The whole state as a host (2, 2^n) array, in shard order (a
    readback for tests and interop: it moves the whole state)."""
    return amps.mesh.gather([s.detach() for s in amps.shards]).cpu().numpy()


# ---------------------------------------------------------------------------
# Eager gates at physical positions, shard by shard
# ---------------------------------------------------------------------------


def _split_controls(nloc: int, controls, states):
    states = tuple(states) or (1,) * len(controls)
    local = tuple((c, s) for c, s in zip(controls, states) if c < nloc)
    shard = tuple((c - nloc, s) for c, s in zip(controls, states)
                  if c >= nloc)
    return local, shard


def _live(s: int, shard_controls) -> bool:
    return all(((s >> b) & 1) == v for b, v in shard_controls)


# widest gate the eager sharded routes apply by fixed-order accumulation
EXACT_MAX_QUBITS = 3


def _fixed_order_product(sub, taxes, m):
    """``m`` (stacked SoA (2, d, d)) on the size-2 axes ``taxes`` of
    ``sub``, each output amplitude summed over the matrix columns in
    index order by elementwise operations: the result of an amplitude
    does not depend on where its target bits sit in the shard (a
    matrix product's rounding depends on the column an amplitude lands
    in), so a gate relocated to other slots computes the same bits."""
    k = len(taxes)
    d = 1 << k
    order = [0] + [taxes[j] for j in reversed(range(k))]
    rest = [a for a in range(sub.dim()) if a not in order]
    perm = order + rest
    x = sub.permute(perm)
    pshape = x.shape
    x = x.reshape(2, d, -1)
    mr = m[0].tolist()
    mi = m[1].tolist()
    rows = []
    for i in range(d):
        re = x[0, 0] * mr[i][0] - x[1, 0] * mi[i][0]
        im = x[1, 0] * mr[i][0] + x[0, 0] * mi[i][0]
        for j in range(1, d):
            re = re + (x[0, j] * mr[i][j] - x[1, j] * mi[i][j])
            im = im + (x[1, j] * mr[i][j] + x[0, j] * mi[i][j])
        rows.append(torch.stack([re, im]))
    y = torch.stack(rows, dim=1).reshape(pshape)
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return y.permute(inv)


def apply_matrix_local(amps: ShardedAmps, matrix, *, targets, controls=(),
                       control_states=()) -> ShardedAmps:
    """A dense gate whose targets are all shard-local: each shard whose
    sharded controls hold applies it with its local controls; no data
    moves (the JAX package's perm_local route).  Gates of up to
    EXACT_MAX_QUBITS targets accumulate in a fixed order
    (``_fixed_order_product``), so the lazy and the eager relocation give
    the same bits; wider ones take the ordinary kernel."""
    from ..ops import kernels as K

    nloc = amps.nloc
    assert all(t < nloc for t in targets)
    lc, sc = _split_controls(nloc, controls, control_states)
    ctrl = tuple(c for c, _ in lc)
    states = tuple(v for _, v in lc)
    for k, s in enumerate(amps.mesh.local):
        if not _live(s, sc):
            continue
        sh = amps.shards[k]
        if len(targets) <= EXACT_MAX_QUBITS:
            m = torch.as_tensor(np.asarray(matrix), dtype=sh.dtype)
            amps.shards[k] = K._update_subspace(
                sh, nloc, tuple(targets), ctrl, states,
                lambda sub, taxes: _fixed_order_product(sub, taxes, m))
        else:
            amps.shards[k] = K.apply_matrix(
                sh, matrix, num_qubits=nloc, targets=tuple(targets),
                controls=ctrl, control_states=states)
    return amps


def apply_diagonal(amps: ShardedAmps, diag, *, targets, controls=(),
                   control_states=()) -> ShardedAmps:
    """A diagonal gate at any positions, with no data motion: a sharded
    target's bit is fixed in each shard, which takes the matching entries
    of the diagonal; a sharded control selects whole shards (the
    reference's phase kernels pair no amplitudes, QuEST_cpu.c:3146-3361)."""
    from ..ops import kernels as K

    nloc = amps.nloc
    diag = np.asarray(diag)
    lt = [(j, t) for j, t in enumerate(targets) if t < nloc]
    lc, sc = _split_controls(nloc, controls, control_states)
    for k, s in enumerate(amps.mesh.local):
        if not _live(s, sc):
            continue
        fixed = 0
        for j, t in enumerate(targets):
            if t >= nloc:
                fixed |= ((s >> (t - nloc)) & 1) << j
        idx = []
        for m in range(1 << len(lt)):
            v = fixed
            for i, (j, _t) in enumerate(lt):
                v |= ((m >> i) & 1) << j
            idx.append(v)
        sub = diag[:, idx]
        sh = amps.shards[k]
        if lt:
            amps.shards[k] = K.apply_diagonal(
                sh, sub, num_qubits=nloc, targets=tuple(t for _j, t in lt),
                controls=tuple(c for c, _ in lc),
                control_states=tuple(v for _, v in lc))
        elif lc:
            # a phase on the controlled subspace: the first local control
            # carries it as a one-qubit diagonal
            (c0, v0), rest = lc[0], lc[1:]
            d2 = np.zeros((2, 2), dtype=diag.dtype)
            d2[0, 1 - v0] = 1.0
            d2[:, v0] = sub[:, 0]
            amps.shards[k] = K.apply_diagonal(
                sh, d2, num_qubits=nloc, targets=(c0,),
                controls=tuple(c for c, _ in rest),
                control_states=tuple(v for _, v in rest))
        else:
            amps.shards[k] = cplx.cmul(sh, float(sub[0, 0]),
                                       float(sub[1, 0]))
    return amps


def apply_not(amps: ShardedAmps, *, targets, controls=(),
              control_states=()) -> ShardedAmps:
    """A (multi-controlled) multi-qubit NOT at any positions: local
    targets flip inside each shard; sharded targets move each shard to
    the partner whose index differs in their bits, one full-shard
    exchange (counted under op "not"), then the local flips and the
    local controls apply.  A shard failing a sharded control keeps its
    amplitudes (its partner fails it too)."""
    from ..ops import kernels as K
    from . import dist as PAR

    mesh = amps.mesh
    nloc = amps.nloc
    lt = tuple(t for t in targets if t < nloc)
    smask = 0
    for t in targets:
        if t >= nloc:
            smask |= 1 << (t - nloc)
    lc, sc = _split_controls(nloc, controls, control_states)
    live = [_live(s, sc) for s in mesh.local]
    if not smask:
        for k in range(len(amps.shards)):
            if live[k]:
                amps.shards[k] = K.apply_multi_qubit_not(
                    amps.shards[k], num_qubits=nloc, targets=lt,
                    controls=tuple(c for c, _ in lc),
                    control_states=tuple(v for _, v in lc))
        return amps
    PAR.record_exchange("not", 1, 2 * (1 << nloc) * amps.itemsize,
                        chunks=1,
                        tier=PAR.mesh_topology(mesh).tier_of_mask(smask))
    recv = mesh.permute(amps.shards,
                        [(i, i ^ smask) for i in range(mesh.axis_size)])
    for k in range(len(amps.shards)):
        if not live[k]:
            continue
        new = recv[k]
        if lt:
            new = K.apply_multi_qubit_not(new, num_qubits=nloc, targets=lt)
        mask = PAR._local_control_mask(nloc, 0, 1 << nloc, lc, new.device)
        if mask is not None:
            new = torch.where(mask, new, amps.shards[k])
        amps.shards[k] = new
    return amps


# ---------------------------------------------------------------------------
# Elementwise operations and reads in the global index (M15b): each shard
# decodes its mesh bits from its index, so nothing moves
# ---------------------------------------------------------------------------


def map_shards(amps: ShardedAmps, fn, *others: ShardedAmps) -> ShardedAmps:
    """New sharded amplitudes whose shard s is ``fn(shard, s, lo, *the
    other amplitudes' shard s)``, lo its first global index."""
    m = 1 << amps.nloc
    out = []
    for k, s in enumerate(amps.mesh.local):
        out.append(fn(amps.shards[k], s, s * m,
                      *(o.shards[k] for o in others)))
    return ShardedAmps(amps.mesh, out)


def _mesh_bit(s: int, pos: int, nloc: int) -> int:
    return (s >> (pos - nloc)) & 1


def shard_parity_sign(s: int, shard_mask: int) -> float:
    """(-1)^parity(s & shard_mask): shard s's factor of a global parity
    sign (mesh bit j = bit j of the shard index)."""
    return -1.0 if bin(s & shard_mask).count("1") & 1 else 1.0


def _mesh_mask(bits, nloc: int) -> int:
    return sum(1 << (b - nloc) for b in bits if b >= nloc)


def indicator(nloc: int, s: int, bit_states, dtype, device):
    """{0, 1} factor of "every (bit, state) of ``bit_states`` holds" over
    shard s, broadcastable over its (2^hi, 2^lo) = _split2(nloc) view: a
    mesh bit is a constant of the shard."""
    from ..ops import kernels as K

    ok = all(_mesh_bit(s, b, nloc) == int(v) for b, v in bit_states
             if b >= nloc)
    local = [(b, v) for b, v in bit_states if b < nloc]
    if not ok:
        return torch.zeros((1, 1), dtype=dtype, device=device)
    if not local:
        return torch.ones((1, 1), dtype=dtype, device=device)
    return K._bit_indicator_2d(nloc, local, dtype, device)


def parity_sign(nloc: int, s: int, bits, dtype, device):
    """(-1)^parity of the global index bits ``bits`` over shard s, as a
    (2^hi, 2^lo) factor (the local bits' sign times the shard's)."""
    from ..ops import kernels as K

    sg = shard_parity_sign(s, _mesh_mask(bits, nloc))
    return sg * K.parity_sign_2d(nloc, [b for b in bits if b < nloc],
                                 dtype, device)


def apply_parity_phase(amps: ShardedAmps, theta: float, *, qubits,
                       controls=()) -> ShardedAmps:
    """exp(-i theta/2 Z..Z) on ``qubits`` at physical positions (multiRotateZ,
    QuEST_cpu.c:3268-3361).  With a local target, each shard whose mesh
    controls hold runs the one-register kernel on its local targets and
    controls, the mesh targets' parity flipping its angle (cos is even,
    sin odd); with every target a mesh bit the phase is a constant of
    each shard: a diagonal gate over the mesh targets (apply_diagonal)."""
    from ..ops import kernels as K

    nloc = amps.nloc
    lq = tuple(q for q in qubits if q < nloc)
    if not lq:
        ang = -0.5 * float(theta)
        k = len(qubits)
        sign = [shard_parity_sign(j, (1 << k) - 1) for j in range(1 << k)]
        diag = np.stack([np.full(1 << k, math.cos(ang)),
                         math.sin(ang) * np.asarray(sign)])
        return apply_diagonal(amps, diag, targets=qubits, controls=controls)
    lc, sc = _split_controls(nloc, controls, ())
    smask = _mesh_mask(qubits, nloc)
    for k, s in enumerate(amps.mesh.local):
        if _live(s, sc):
            amps.shards[k] = K.apply_parity_phase(
                amps.shards[k], shard_parity_sign(s, smask) * theta,
                num_qubits=nloc, qubits=lq,
                controls=tuple(c for c, _ in lc))
    return amps


def collapse(amps: ShardedAmps, prob: float, bit_states,
             density: bool) -> ShardedAmps:
    """Project onto ``bit_states`` and renormalise (the collapse of
    ops/kernels.py, shard by shard): zero whole shards whose mesh bits
    differ, a masked part of the others; scale by 1/sqrt(prob) (a state
    vector) or 1/prob (a density matrix)."""
    from ..ops import kernels as K

    nloc = amps.nloc
    hi, lo = K._split2(nloc)

    def fn(sh, s, _lo):
        ind = indicator(nloc, s, bit_states, sh.dtype, sh.device)
        view = sh.reshape(2, 1 << hi, 1 << lo)
        if density:
            f = ind / torch.tensor(prob, dtype=sh.dtype)
        else:
            f = (1.0 / torch.sqrt(torch.tensor(prob, dtype=sh.dtype))) * ind
        return (view * f[None]).reshape(sh.shape)

    return map_shards(amps, fn)


def _bit_factor(nloc: int, s: int, pos: int, outcome, dtype):
    """Indicator of (global bit ``pos`` == the 0-d tensor ``outcome``)
    over shard s, broadcastable over its (2, 2^hi, 2^lo) view."""
    from ..ops import measurement as M

    if pos < nloc:
        return M._bit_factor(nloc, pos, outcome, dtype)
    return (outcome == _mesh_bit(s, pos, nloc)).to(dtype).reshape(1, 1, 1)


def measure_once(amps: ShardedAmps, u, *, num_qubits: int, target: int,
                 is_density: bool, quad: bool = False):
    """One measurement shot of a sharded register with the threshold
    ``u`` (a 0-d device tensor): the probability as one sum over the mesh
    (``quad``: in double-double, combined on the host), the outcome drawn
    on the device (measurement._draw_outcome) and the collapse of
    ops/measurement.py shard by shard.  Returns (new amps, outcome,
    probability), the last two 0-d tensors on the first local shard's
    device; nothing is read on the host but a quad probability."""
    from ..ops import measurement as M

    if quad:
        p0 = torch.tensor(prob_of_outcome_quad(
            amps, target, 0, is_density, num_qubits), dtype=amps.dtype,
            device=amps.device)
    elif is_density:
        p0 = prob_of_outcome_density(amps, num_qubits, target, 0)
    else:
        p0 = prob_of_outcome_statevec(amps, target, 0)
    outcome, prob = M._draw_outcome(p0, u.to(p0.device))
    return (collapse_drawn(amps, outcome, prob, num_qubits=num_qubits,
                           target=target, is_density=is_density),
            outcome, prob)


def collapse_drawn(amps: ShardedAmps, outcome, prob, *, num_qubits: int,
                   target: int, is_density: bool) -> ShardedAmps:
    """The collapse of a drawn outcome (0-d device tensors ``outcome`` and
    ``prob``) shard by shard, as ops/measurement.py collapses one
    register: new shards (``collapse_drawn_bank`` on a bank of one)."""
    bank = collapse_drawn_bank(
        ShardedAmps(amps.mesh, [s[None] for s in amps.shards]),
        outcome.reshape(1), prob.reshape(1), num_qubits=num_qubits,
        target=target, is_density=is_density)
    return ShardedAmps(amps.mesh, [s[0] for s in bank.shards])


def collapse_drawn_bank(amps: ShardedAmps, outcomes, probs, *,
                        num_qubits: int, target: int,
                        is_density: bool) -> ShardedAmps:
    """collapse_drawn of every element of a bank at once: element b
    collapses onto ``outcomes[b]`` with ``probs[b]`` ((B,) device
    tensors), one pass over each shard (the same factors as one
    register's collapse, element by element)."""
    from ..ops import kernels as K

    nloc = amps.nloc
    hi, lo = K._split2(nloc)
    nb = amps.batch_size

    def factor(s, pos, o, dtype, device):
        # (B, 2^hi, 2^lo)-broadcastable indicator of bit pos == o[b]
        o = o.to(device).reshape(nb, 1, 1)
        if pos >= nloc:
            return (o == _mesh_bit(s, pos, nloc)).to(dtype)
        return (K.bit_2d(nloc, pos, device)[None] == o).to(dtype)

    def fn(sh, s, _lo):
        p = probs.to(sh.device).reshape(nb, 1, 1)
        v = sh.reshape(nb, 2, 1 << hi, 1 << lo)
        f = factor(s, target, outcomes, sh.dtype, sh.device)
        if is_density:
            f = f * (1.0 / p) * factor(s, target + num_qubits, outcomes,
                                        sh.dtype, sh.device)
        else:
            f = f * torch.rsqrt(p)
        return (v * f[:, None]).reshape(sh.shape)

    return map_shards(amps, fn)


def prob_of_outcome_bank(amps: ShardedAmps, target: int, outcome: int, *,
                         is_density: bool = False,
                         num_qubits: int = 0) -> torch.Tensor:
    """P(target = outcome) of every element of a bank's (B, 2, 2^nloc)
    shards as a (B,) tensor: per-shard (B,) partials and one sum over the
    mesh (``num_qubits``: a density bank's represented qubits)."""
    nloc = amps.nloc
    parts = []
    for k, s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        nb = sh.shape[0]
        if is_density:
            lo = s << nloc
            d = _diag_rows(amps, lo, num_qubits, sh.device)
            v = sh[:, 0, d * ((1 << num_qubits) + 1) - lo]
            parts.append(v[:, ((d >> target) & 1) == outcome].sum(dim=1))
        elif target < nloc:
            half = sh.reshape(nb, 2, 1 << (nloc - 1 - target), 2,
                              1 << target)[:, :, :, int(outcome), :]
            parts.append((half * half).sum(dim=(1, 2, 3)))
        elif ((s >> (target - nloc)) & 1) == outcome:
            parts.append((sh * sh).sum(dim=(1, 2)))
        else:
            parts.append(torch.zeros(nb, dtype=sh.dtype, device=sh.device))
    return sum_partials(amps, parts)


def inner_product(bra: ShardedAmps, ket: ShardedAmps) -> torch.Tensor:
    """<bra|ket> as a stacked (2,) tensor: per-shard partials, one sum."""
    return sum_partials(bra, [cplx.vdot(a, b.to(a.device))
                            for a, b in zip(bra.shards, ket.shards)])


def density_inner_product(a: ShardedAmps, b: ShardedAmps) -> torch.Tensor:
    return sum_partials(a, [CALC.calc_density_inner_product(x, y)
                          for x, y in zip(a.shards, b.shards)])


def purity(a: ShardedAmps) -> torch.Tensor:
    return sum_partials(a, [CALC.calc_purity(x) for x in a.shards])


def hilbert_schmidt_distance(a: ShardedAmps, b: ShardedAmps) -> torch.Tensor:
    """sqrt of the summed per-shard |a - b|^2."""
    return torch.sqrt(sum_partials(a, [cplx.abs2(x - y).sum()
                                     for x, y in zip(a.shards, b.shards)]))


def fidelity_density(rho: ShardedAmps, psi: torch.Tensor,
                     num_qubits: int) -> torch.Tensor:
    """<psi|rho|psi> with ``psi`` the whole (2, 2^n) pure state: each shard
    holds whole columns (or a part of one) of the column-major rho, so its
    partial is sum_c psi_c sum_r rho_rc conj(psi_r) over its rows and
    columns (calc_fidelity_density's two matrix-vector products)."""
    dim = 1 << num_qubits
    m = 1 << rho.nloc
    rows = min(m, dim)
    parts = []
    for k, lo in shard_offsets(rho):
        sh = rho.shards[k]
        p = psi.to(device=sh.device, dtype=sh.dtype)
        r0, c0 = lo % dim, lo // dim
        mat = sh.reshape(2, -1, rows)            # [channel, col, row]
        ncol = mat.shape[1]
        pr0, pr1 = p[0, r0:r0 + rows], p[1, r0:r0 + rows]
        pc0, pc1 = p[0, c0:c0 + ncol], p[1, c0:c0 + ncol]
        v_re = torch.matmul(mat[0], pr0) + torch.matmul(mat[1], pr1)
        v_im = torch.matmul(mat[1], pr0) - torch.matmul(mat[0], pr1)
        parts.append(torch.sum(pc0 * v_re - pc1 * v_im))
    return sum_partials(rho, parts)


def expec_diagonal_statevec(amps: ShardedAmps, op_real,
                            op_imag) -> torch.Tensor:
    """sum_i |amp_i|^2 d_i as a stacked (2,): each shard with its slice of
    the operator."""
    m = 1 << amps.nloc
    parts = []
    for k, lo in shard_offsets(amps):
        sh = amps.shards[k]
        parts.append(CALC.calc_expec_diagonal_statevec(
            sh, op_real[lo:lo + m].to(sh.device),
            op_imag[lo:lo + m].to(sh.device)))
    return sum_partials(amps, parts)


def expec_diagonal_density(amps: ShardedAmps, op_real, op_imag,
                           num_qubits: int) -> torch.Tensor:
    """sum_r d_r rho_rr as a stacked (2,), from each shard's diagonal
    entries."""
    parts = []
    for k, lo in shard_offsets(amps):
        sh = amps.shards[k]
        d = _diag_rows(amps, lo, num_qubits, sh.device)
        v = sh[:, d * ((1 << num_qubits) + 1) - lo]
        opr = op_real.to(sh.device)[d].to(sh.dtype)
        opi = op_imag.to(sh.device)[d].to(sh.dtype)
        parts.append(torch.stack([torch.sum(v[0] * opr - v[1] * opi),
                                  torch.sum(v[0] * opi + v[1] * opr)]))
    return sum_partials(amps, parts)


def apply_full_diagonal(amps: ShardedAmps, op_real, op_imag) -> ShardedAmps:
    """D psi: each shard times its slice of the operator."""
    from ..ops import kernels as K

    m = 1 << amps.nloc
    return map_shards(amps, lambda sh, s, lo: K.apply_full_diagonal(
        sh, op_real[lo:lo + m].to(sh.device),
        op_imag[lo:lo + m].to(sh.device)))


def apply_diag_op_density(amps: ShardedAmps, op_real, op_imag,
                          num_qubits: int) -> ShardedAmps:
    """D rho with the whole operator on every shard: element (row, col)
    times D[row], row = the low n bits of its global index (the
    elementwise form under any split, r > n included)."""
    dim = 1 << num_qubits

    def fn(sh, s, lo):
        rows = (torch.arange(sh.shape[-1], device=sh.device) + lo) % dim
        return cplx.cmul(sh, op_real.to(sh.device)[rows].to(sh.dtype),
                         op_imag.to(sh.device)[rows].to(sh.dtype))

    return map_shards(amps, fn)


def mix_dephasing(amps: ShardedAmps, prob, *, pairs) -> ShardedAmps:
    """One- or two-qubit dephasing (ops/density.py's sign forms) over the
    (ket, bra) bit ``pairs``, each sign decoded per shard."""
    from ..ops import kernels as K
    from ..ops.density import _scalar

    nloc = amps.nloc
    hi, lo = K._split2(nloc)

    def fn(sh, s, _lo):
        p = _scalar(prob, sh)
        signs = [parity_sign(nloc, s, pair, sh.dtype, sh.device)
                 for pair in pairs]
        if len(signs) == 1:
            factor = (1 - p) + p * signs[0]
        else:
            s1, s2 = signs
            factor = (1 - p) + (p / 3) * (s1 + s2 + s1 * s2)
        view = sh.reshape(2, 1 << hi, 1 << lo)
        return (view * factor[None]).reshape(sh.shape)

    return map_shards(amps, fn)


def compare(a: ShardedAmps, b: ShardedAmps, precision: float) -> bool:
    """Every |a - b| component within ``precision``: per-shard counts of
    the amplitudes outside it, one sum."""
    bad = [torch.sum(torch.abs(x - y.to(x.device)) > precision).to(
        torch.float64) for x, y in zip(a.shards, b.shards)]
    return float(a.mesh.sum(bad)) == 0.0


def report_files(amps: ShardedAmps) -> None:
    """One ``state_rank_<s>.csv`` per local shard s, the header in shard
    0's only (the reference's per-rank files, QuEST_common.c:229-245)."""
    chunk = 1 << 20
    for k, s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        with open(f"state_rank_{s}.csv", "w") as f:
            if s == 0:
                f.write("real, imag\n")
            for a in range(0, sh.shape[-1], chunk):
                part = sh[:, a:a + chunk].cpu().numpy()
                f.writelines(f"{re:.12f}, {im:.12f}\n"
                             for re, im in zip(part[0], part[1]))


def report_screen(amps: ShardedAmps) -> None:
    """Every amplitude to stdout, shard by shard in shard order, read to
    the host a slice at a time (nothing is gathered)."""
    chunk = 1 << 20
    if 0 in amps.mesh.local:
        print("Reporting state from rank 0:")
    for k, _s in enumerate(amps.mesh.local):
        sh = amps.shards[k]
        for a in range(0, sh.shape[-1], chunk):
            part = sh[:, a:a + chunk].cpu().numpy()
            for re, im in zip(part[0], part[1]):
                print(f"{re} {im}")
