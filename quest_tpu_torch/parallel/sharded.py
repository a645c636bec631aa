"""A sharded register's states and reads, shard by shard.

Each state initialisation writes every shard from its own global index
range (shard s holds ``[s 2^nloc, (s + 1) 2^nloc)``), so no full state is
ever built on one device; each read takes a per-shard partial and one sum
over the mesh (``Mesh.sum``), the reference's local reduce plus
MPI_Allreduce (QuEST_cpu_distributed.c:1308-1322).  The reads run on
canonical-order amplitudes (the register's ``amps`` getter restores the
order first, as the JAX package's getter does).
"""

from __future__ import annotations

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
    """A whole (2, 2^n) state (tensor or NumPy) cut into the local
    shards, each copied to its device."""
    if not torch.is_tensor(full):
        full = torch.from_numpy(np.array(full))
    return from_fn(mesh, nloc, dtype, lambda lo, m, dt, dev: full[
        :, lo:lo + m].to(device=dev, dtype=dt, copy=True))


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


def _sum(amps: ShardedAmps, partials: Sequence[torch.Tensor]):
    return amps.mesh.sum(list(partials))


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
    return _sum(amps, parts)


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
    return _sum(amps, parts)


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
    return _sum(amps, parts)


def _diag_entries(amps: ShardedAmps, k: int, lo: int, num_qubits: int):
    """(values, d) of the density diagonal entries rho[d, d] held by local
    shard k: flat index d (dim + 1) in [lo, lo + 2^nloc)."""
    dim = 1 << num_qubits
    m = 1 << amps.nloc
    sh = amps.shards[k]
    d0 = -(-lo // (dim + 1))
    d1 = (lo + m - 1) // (dim + 1)
    if d1 < d0:
        empty = torch.zeros(0, dtype=sh.dtype, device=sh.device)
        return empty, torch.zeros(0, dtype=torch.long, device=sh.device)
    d = torch.arange(d0, d1 + 1, device=sh.device)
    return sh[0, d * (dim + 1) - lo], d


def total_prob_density(amps: ShardedAmps, num_qubits: int) -> torch.Tensor:
    """Re(trace(rho)) from each shard's diagonal entries."""
    return _sum(amps, [_diag_entries(amps, k, lo, num_qubits)[0].sum()
                       for k, lo in shard_offsets(amps)])


def prob_of_outcome_density(amps: ShardedAmps, num_qubits: int,
                            target: int, outcome: int) -> torch.Tensor:
    parts = []
    for k, lo in shard_offsets(amps):
        v, d = _diag_entries(amps, k, lo, num_qubits)
        parts.append(v[((d >> target) & 1) == outcome].sum())
    return _sum(amps, parts)


def all_outcomes_density(amps: ShardedAmps, num_qubits: int,
                         qubits: Tuple[int, ...]) -> torch.Tensor:
    parts = []
    for k, lo in shard_offsets(amps):
        v, d = _diag_entries(amps, k, lo, num_qubits)
        parts.append(_histogram(v, d, qubits))
    return _sum(amps, parts)


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
