"""Register snapshots: ``saveQureg`` / ``loadQureg``, and state files in
the reference's CSV format.

``saveQureg(q, path)`` writes a directory holding ``amps.npy`` (the
amplitudes in canonical order, one NumPy array of shape ``(2, 2^n)``, or
``(B, 2, 2^n)`` for a register bank) and ``qureg_meta.json`` with the JAX
package's keys (``num_qubits_represented``, ``is_density_matrix``,
``dtype``, ``precision``, ``mesh_shards``, ``batch``).  The JAX package
stores the amplitudes as an orbax checkpoint instead; the metadata is
the same, key for key.  A sharded register writes each shard's slice at
its global offset, so the file is the global array and loads onto any
shard count (an elastic load onto fewer shards counts
``elastic_restores_total``).  The state moves between the device and the
file in chunks of 2^20 amplitudes through one staging buffer (pinned on
the card), never as a second full-size host copy; the metadata is
written last, by an atomic rename.

``writeStateToFile`` writes one ``re, im`` line per amplitude after a
``#`` comment line; ``readStateFromFile`` reads such a file (blank and
``#`` lines skipped), as the reference's reportState and
initStateFromSingleFile do (QuEST_common.c:229-245, QuEST_cpu.c:1680-1729).
The files are the JAX package's, byte for byte for the same state, so
each package reads what the other writes.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from . import precision
from .env import QuESTEnv
from .qureg import Qureg
from .validation import QuESTError

# amplitudes per chunk moved between the device and the file: 2^20
# float64 pairs = a 16 MB host buffer
_CHUNK = 1 << 20

_META_NAME = "qureg_meta.json"
_AMPS_NAME = "amps.npy"


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def _qureg_meta(qureg: Qureg) -> dict:
    """Base register metadata, the JAX package's keys (the resilience
    layer extends it with a circuit cursor, the live permutation and
    the measurement streams' state)."""
    return {
        "num_qubits_represented": qureg.num_qubits_represented,
        "is_density_matrix": qureg.is_density_matrix,
        "dtype": str(_np_dtype(qureg.dtype)),
        "precision": precision.get_precision(),
        "mesh_shards": qureg.num_chunks,
        # 0 = one register; B >= 1 = a BatchedQureg bank of B elements
        # whose payload is (B, 2, 2^n)
        "batch": int(getattr(qureg, "batch_size", 0) or 0),
    }


def _write_meta(path: str, meta: dict) -> None:
    tmp = os.path.join(path, _META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, _META_NAME))


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, _META_NAME)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no qureg checkpoint at {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or "num_qubits_represented" not in meta:
        raise ValueError(f"malformed checkpoint metadata at {meta_path}")
    return meta


def _payload_shape(qureg: Qureg) -> tuple:
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    return ((bsz,) if bsz else ()) + (2, qureg.num_amps_total)


def _pieces(amps):
    """(global offset, tensor) of every locally held piece of a register's
    amplitudes: the whole tensor, or each shard of a ShardedAmps (whose
    shards must all live in this process)."""
    from .parallel.mesh import InProcessMesh, ShardedAmps

    if not isinstance(amps, ShardedAmps):
        return [(0, amps)]
    if not isinstance(amps.mesh, InProcessMesh):
        raise QuESTError(
            "saveQureg/loadQureg: a register split over torch.distributed "
            "ranks cannot be checkpointed yet (only in-process meshes)")
    m = 1 << amps.nloc
    return [(s * m, sh) for s, sh in zip(amps.mesh.local, amps.shards)]


def _staging(lead: tuple, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    return torch.empty(lead + (_CHUNK,), dtype=dtype, pin_memory=pin)


def _stream_to_host(amps, out: np.ndarray) -> None:
    """Copy every piece of ``amps`` into the host array ``out`` at its
    global offset, 2^20 amplitudes at a time through one staging buffer
    (pinned when the pieces are on the card)."""
    buf = None
    for off, t in _pieces(amps):
        lead = tuple(t.shape[:-1])
        if buf is None or tuple(buf.shape[:-1]) != lead:
            buf = _staging(lead, t.dtype, t.device.type == "cuda")
        total = int(t.shape[-1])
        for lo in range(0, total, _CHUNK):
            m = min(_CHUNK, total - lo)
            part = buf[..., :m]
            part.copy_(t[..., lo:lo + m])
            out[..., off + lo:off + lo + m] = part.numpy()


def _write_amps(path: str, amps, shape: tuple, dtype: torch.dtype) -> None:
    """Write ``amps`` as ``<path>/amps.npy`` of ``shape`` (the global
    array), flushed and fsynced."""
    fname = os.path.join(path, _AMPS_NAME)
    mm = np.lib.format.open_memmap(fname, mode="w+", dtype=_np_dtype(dtype),
                                   shape=shape)
    try:
        _stream_to_host(amps, mm)
        mm.flush()
    finally:
        del mm
    _fsync_file(fname)


def _fsync_file(fname: str) -> None:
    fd = os.open(fname, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _read_payload(path: str, shape: tuple, dtype: torch.dtype) -> np.ndarray:
    """The memory-mapped ``amps.npy`` of a checkpoint, checked against the
    register's shape and type (a mismatch or a torn file raises
    ValueError)."""
    arr = np.load(os.path.join(path, _AMPS_NAME), mmap_mode="r")
    if tuple(arr.shape) != tuple(shape) or arr.dtype != _np_dtype(dtype):
        raise ValueError(
            f"checkpoint payload at {path} holds {arr.dtype}{arr.shape}, "
            f"expected {_np_dtype(dtype)}{tuple(shape)}")
    return arr


def _upload(arr: np.ndarray, lo: int, count: int, dtype: torch.dtype,
            device) -> torch.Tensor:
    """Indices [lo, lo + count) of the host array ``arr`` as a tensor on
    ``device``, copied 2^20 amplitudes at a time through one staging
    buffer."""
    device = torch.device(device)
    lead = tuple(arr.shape[:-1])
    out = torch.empty(lead + (count,), dtype=dtype, device=device)
    buf = _staging(lead, dtype, device.type == "cuda")
    for a in range(0, count, _CHUNK):
        m = min(_CHUNK, count - a)
        part = buf[..., :m]
        part.numpy()[...] = arr[..., lo + a:lo + a + m]
        out[..., a:a + m].copy_(part)
    return out


def _restore_amps(path: str, q: Qureg):
    """The payload of the checkpoint at ``path`` as ``q``'s amplitudes on
    ``q``'s env: one tensor, or a ShardedAmps cut at the env's shard
    boundaries (transient IO errors retried, resilience.retry_io)."""
    from . import resilience
    from .parallel.mesh import ShardedAmps

    arr = resilience.retry_io(_read_payload, path, _payload_shape(q),
                              q.dtype, what="loadQureg(amps)")
    if not q.is_sharded:
        return _upload(arr, 0, q.num_amps_total, q.dtype, q.device)
    mesh = q.env.mesh
    m = q.num_amps_per_chunk
    return ShardedAmps(mesh, [_upload(arr, s * m, m, q.dtype,
                                      mesh.device_of(s))
                              for s in mesh.local])


def _qureg_from_meta(meta: dict, env: QuESTEnv) -> Qureg:
    """The target register of a restore, the checkpoint validated against
    ``env`` first: a precision mismatch or a mesh too large for the
    register is a QuESTError naming both sides."""
    ck_dtype = np.dtype(meta["dtype"])
    env_dtype = _np_dtype(precision.real_dtype())
    if ck_dtype != env_dtype:
        raise QuESTError(
            "loadQureg: checkpoint precision mismatch — the checkpoint "
            f"was written at dtype {ck_dtype} (precision "
            f"{meta.get('precision', '?')}) but this environment runs at "
            f"dtype {env_dtype} (precision "
            f"{precision.get_precision()}); call set_precision to match "
            "before loading")
    batch = int(meta.get("batch", 0) or 0)
    if batch:
        from .batch import BatchedQureg

        q = BatchedQureg(meta["num_qubits_represented"], env, batch,
                         is_density_matrix=meta["is_density_matrix"])
    else:
        q = Qureg(meta["num_qubits_represented"], env,
                  meta["is_density_matrix"])
    if q.num_amps_total < env.num_devices:
        raise QuESTError(
            "loadQureg: the mesh has grown past the register's shardable "
            f"size — the checkpoint holds {q.num_amps_total} amplitudes "
            f"({meta['num_qubits_represented']} qubits, density="
            f"{meta['is_density_matrix']}) but this environment has "
            f"{env.num_devices} devices; load on a mesh with at most "
            f"{q.num_amps_total} devices")
    return q


def saveQureg(qureg: Qureg, path: str) -> None:
    """Write a snapshot of ``qureg`` (amplitudes and metadata) at
    ``path``, a directory.  State-vectors, density matrices and register
    banks, on one device or split over shards; the amplitudes are written
    in canonical qubit order (a live permutation is undone first), the
    metadata last by atomic rename, and transient IO errors are retried
    with bounded backoff (resilience.retry_io)."""
    from . import resilience

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    amps = qureg.amps
    resilience.retry_io(_write_amps, path, amps, _payload_shape(qureg),
                        qureg.dtype, what="saveQureg(amps)")
    resilience.retry_io(_write_meta, path, _qureg_meta(qureg),
                        what="saveQureg(meta)")


def loadQureg(path: str, env: QuESTEnv, *, strict_mesh: bool = False
              ) -> Qureg:
    """Restore a register saved by :func:`saveQureg` onto ``env``.

    The metadata is validated first: a precision mismatch raises a
    QuESTError naming both sides.  The payload is the global array, so
    it loads onto any shard count; ``strict_mesh=True`` refuses any
    difference from the writing mesh.  When the mesh has grown past the
    register's shardable size (more shards than amplitudes) the load is
    elastic by default: onto the largest usable sub-mesh
    (env.shrink_env, recorded as a degradation), which the returned
    register's ``env`` names; ``strict_mesh=True`` raises instead."""
    from . import resilience, telemetry
    from . import env as _env_mod

    path = os.path.abspath(path)
    try:
        meta = _read_meta(path)
    except FileNotFoundError:
        raise QuESTError(f"no qureg checkpoint at {path}", "loadQureg")
    saved_shards = meta.get("mesh_shards")
    if strict_mesh and saved_shards is not None \
            and int(saved_shards) != env.num_devices:
        raise QuESTError(
            "loadQureg: checkpoint mesh mismatch — written on "
            f"{saved_shards} shards but this environment has "
            f"{env.num_devices} devices, and strict_mesh=True refuses "
            "elastic restore")
    n_sv = (2 if meta.get("is_density_matrix") else 1) \
        * int(meta["num_qubits_represented"])
    total = 1 << n_sv
    if not strict_mesh and total < env.num_devices:
        shrunk = _env_mod.shrink_env(env, total)
        resilience.record_degradation(
            f"loadQureg_mesh_{env.num_devices}to{total}",
            f"the mesh ({env.num_devices} devices) has grown past the "
            f"register's shardable size ({total} amplitudes); loaded "
            f"onto a {total}-device sub-mesh")
        env = shrunk
    if saved_shards is not None and int(saved_shards) != env.num_devices:
        telemetry.inc("elastic_restores_total")
    q = _qureg_from_meta(meta, env)
    q._amps = _restore_amps(path, q)
    return q


def writeStateToFile(qureg: Qureg, filename: str) -> None:
    """Dump the amplitudes as reference-style CSV (QuEST_common.c:229-245),
    one ``repr(re), repr(im)`` line each, chunk by chunk."""
    amps = qureg.amps
    total = qureg.num_amps_total
    with open(filename, "w") as f:
        f.write("# quest_tpu state dump: re, im per amplitude\n")
        for start in range(0, total, _CHUNK):
            part = amps[:, start:start + _CHUNK].double().cpu().numpy()
            f.writelines(f"{float(re)!r}, {float(im)!r}\n"
                         for re, im in zip(part[0], part[1]))


def readStateFromFile(qureg: Qureg, filename: str) -> bool:
    """Load amplitudes from reference-style CSV; returns success
    (statevec_initStateFromSingleFile, QuEST_cpu.c:1680-1729).  The file
    streams chunk by chunk into a fresh tensor on the register's device,
    and the register is rebound only on full success: a missing,
    malformed, truncated or non-finite (NaN/Inf) file leaves the state
    untouched.  Lines beyond the register's size are ignored."""
    if not os.path.exists(filename):
        return False
    total = qureg.num_amps_total
    work = torch.zeros((2, total), dtype=qureg.dtype, device=qureg.device)
    buf = np.zeros((2, _CHUNK))
    fill = 0          # valid amps in buf
    written = 0       # amps copied to the device

    def flush():
        work[:, written:written + fill] = torch.from_numpy(
            buf[:, :fill]).to(device=qureg.device, dtype=qureg.dtype)

    try:
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if written + fill >= total:
                    break
                parts = line.split(",")
                re, im = float(parts[0]), float(parts[1])
                if not (math.isfinite(re) and math.isfinite(im)):
                    return False
                buf[0, fill], buf[1, fill] = re, im
                fill += 1
                if fill == _CHUNK:
                    flush()
                    written += fill
                    fill = 0
    except (ValueError, IndexError):
        return False  # a malformed line: the state stays as it was
    if fill:
        flush()
        written += fill
    if written < total:
        return False  # a truncated file
    qureg.amps = work
    return True
