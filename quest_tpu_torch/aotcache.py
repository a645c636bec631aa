"""Persistent plan cache: the port's counterpart of the JAX package's AOT
executable tier (``quest_tpu/aotcache.py``).

The JAX package persists compiled XLA executables, because its cold start
is compilation.  The port has no jit step: its kernels are built once per
hash of their sources (``ops/build.py``) and a drain executes its plan
directly (``circuit.execute_plan``).  Its cold start is planning (a
26-qubit config-2 drain plans for about as long as it runs), so the
artefact this tier persists is the **plan**: the program
``fusion._plan_optimized`` / ``fusion._plan_sharded`` return (the
program, or ``(program, final_perm)`` on a mesh), NumPy arrays and
tuples only, never a device tensor.  A fresh process, a fresh replica or
the shrunk-mesh drains a failover restores onto then pay one file read
instead of a planning pass.

Key schema (``plan_key_digest``): sha256, fed incrementally, over

  - the toolchain tag: ``torch.__version__``, ``numpy.__version__`` and a
    sha256 over the sources whose code shapes a plan (``_PLAN_SOURCES``),
    so a change to the planner invalidates every entry as a jax upgrade
    does in the reference (``_VERSION_OVERRIDE`` spoofs the tag in
    tests);
  - the memory tier's key, ``fusion._plan_key``: the items' content (each
    matrix's bytes), ``sweep_ok``, the planner, megawin planning, the
    side split, the precision mode, the batch flag and size and, on a
    mesh, the starting permutation and the topology's signature.

File format: ``b"QTPLAN1\\n" + sha256(body) + body``, body a pickle of
``{v, key, payload, meta}``, one ``<key>.qtplan`` file per entry.  The
magic and the suffix are the port's own: a ``QT_AOT_CACHE`` directory
shared with the JAX package (``*.aot`` entries) never makes either
package count, evict or delete the other's files.  Writes are atomic
(tempfile + ``os.replace``); a load verifies the magic, the checksum and
the key echo, and any mismatch counts an error, records the
``aot_cache_corrupt`` degradation, unlinks the entry and lets the caller
plan afresh (the results are bit-identical either way: the cache is an
accelerator, never a dependency).  Only the disk I/O and the unpickling
sit inside that guard.  Eviction is mtime-LRU against
``QT_AOT_CACHE_MAX_BYTES`` (default 1 GiB); a hit ``os.utime``s its entry.

Enabled by ``QT_AOT_CACHE=<dir>``; unset, every function here is a
no-op and the drain plans as before.  The directory must be one only
this program writes: an entry is unpickled, and its checksum guards
against corruption, not against a forged entry.  ``aot_compile_seconds_saved_total``
keeps the reference's name and counts the planning seconds hits avoided.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from . import telemetry as _telemetry

__all__ = [
    "enabled", "cache_dir", "max_bytes", "plan_key_digest", "load",
    "store", "probe", "stats", "reset_stats",
]

_DIR_ENV = "QT_AOT_CACHE"
_MAX_BYTES_ENV = "QT_AOT_CACHE_MAX_BYTES"
_DEFAULT_MAX_BYTES = 1 << 30  # 1 GiB
_MAGIC = b"QTPLAN1\n"
_SUFFIX = ".qtplan"

# Spoofable toolchain tag: tests set _VERSION_OVERRIDE[0] to prove a
# toolchain change invalidates every entry.
_VERSION_OVERRIDE: list = [None]

# The sources whose code shapes a plan, relative to the package (an
# absolute path is taken as it is): their sha256 is part of every key.
_PLAN_SOURCES = [
    "aotcache.py", "circuit.py", "fusion.py", "optimizer.py",
    "ops/fused.py", "parallel/topology.py",
]
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))

_LOCK = threading.Lock()

# Digests of the plans live in THIS process's memory tier
# (fusion._plan_cache): the next drain of one of them reads no file.
_MEMORY_KEYS: set = set()

# Process-wide accounting, a plain dict so that the tier accounts with
# telemetry off; telemetry._series folds it in as the aot_cache_* series.
_STATS = {
    "hits": 0, "misses": 0, "puts": 0, "evictions": 0, "errors": 0,
    "bytes": 0, "saved_seconds": 0.0,
}

# (path, mtime, size) of every planning source -> their digest
_SRC_DIGEST: dict = {}


def reset_stats() -> None:
    """Test hook: zero the stats and the in-memory key set (a fresh
    process, for hit/miss pinning)."""
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if k == "saved_seconds" else 0
        _MEMORY_KEYS.clear()


def cache_dir() -> Optional[str]:
    d = os.environ.get(_DIR_ENV, "").strip()
    return d or None


def enabled() -> bool:
    return cache_dir() is not None


def max_bytes() -> int:
    try:
        return int(os.environ.get(_MAX_BYTES_ENV, str(_DEFAULT_MAX_BYTES)))
    except ValueError:
        return _DEFAULT_MAX_BYTES


def _source_digest() -> str:
    """sha256 over the planning sources, recomputed when one of them
    changes on disk."""
    paths = [p if os.path.isabs(p) else os.path.join(_PKG_DIR, p)
             for p in _PLAN_SOURCES]
    sig = []
    for p in paths:
        st = os.stat(p)
        sig.append((p, st.st_mtime_ns, st.st_size))
    sig = tuple(sig)
    got = _SRC_DIGEST.get(sig)
    if got is None:
        h = hashlib.sha256()
        for p in paths:
            with open(p, "rb") as f:
                h.update(f.read())
        got = h.hexdigest()
        _SRC_DIGEST.clear()
        _SRC_DIGEST[sig] = got
    return got


def _version_tag() -> tuple:
    if _VERSION_OVERRIDE[0] is not None:
        return ("override", str(_VERSION_OVERRIDE[0]))
    return (torch.__version__, np.__version__, _source_digest())


def _feed(h, obj) -> None:
    """Hash ``obj`` into ``h`` piece by piece: bytes as they are, tuples
    element by element, anything else by its repr (each piece
    length-prefixed, so no two keys feed the same stream)."""
    if isinstance(obj, (bytes, bytearray)):
        h.update(b"b%d:" % len(obj))
        h.update(obj)
    elif isinstance(obj, (tuple, list)):
        h.update(b"(%d:" % len(obj))
        for x in obj:
            _feed(h, x)
        h.update(b")")
    else:
        r = repr(obj).encode()
        h.update(b"r%d:" % len(r))
        h.update(r)


def plan_key_digest(key) -> str:
    """sha256 hex of one plan: the toolchain tag and the memory tier's
    key (``fusion._plan_key``)."""
    h = hashlib.sha256()
    _feed(h, ("qt-plan-v1", _version_tag()))
    _feed(h, key)
    return h.hexdigest()


def _path(key: str) -> str:
    return os.path.join(cache_dir(), key + _SUFFIX)


def _bump(name: str, by=1) -> None:
    with _LOCK:
        _STATS[name] += by


def _count(name: str) -> None:
    _bump(name)
    if _telemetry.enabled():
        _telemetry.inc(f"aot_cache_{name}_total")


def _record_corrupt(path: str, why: str) -> None:
    from . import resilience as _res

    _bump("errors")
    try:
        os.remove(path)
    except OSError:
        pass
    _res.record_degradation(
        "aot_cache_corrupt",
        "plan cache entry %s rejected (%s); planned afresh, results are "
        "unaffected" % (os.path.basename(path), why))
    _refresh_bytes()


def _scan() -> list:
    """[(path, size, mtime)] of every entry of this package in the cache
    directory (another package's files are not looked at)."""
    d = cache_dir()
    out = []
    if not d or not os.path.isdir(d):
        return out
    for name in os.listdir(d):
        if not name.endswith(_SUFFIX):
            continue
        p = os.path.join(d, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out.append((p, st.st_size, st.st_mtime))
    return out


def _set_bytes(total: int) -> None:
    with _LOCK:
        _STATS["bytes"] = total
    if _telemetry.enabled():
        _telemetry.set_gauge("aot_cache_bytes", float(total))


def _refresh_bytes() -> int:
    total = sum(sz for _p, sz, _m in _scan())
    _set_bytes(total)
    return total


def _evict() -> None:
    """mtime-LRU eviction down to QT_AOT_CACHE_MAX_BYTES."""
    cap = max_bytes()
    entries = sorted(_scan(), key=lambda e: e[2])  # oldest first
    total = sum(sz for _p, sz, _m in entries)
    for p, sz, _m in entries:
        if total <= cap:
            break
        try:
            os.remove(p)
        except OSError:
            continue
        total -= sz
        _count("evictions")
    _set_bytes(total)


def _decode(blob: bytes, key: str):
    """The entry of a file's bytes; ValueError (or an unpickling error)
    when it is not a whole entry of ``key``."""
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError("bad magic")
    off = len(_MAGIC)
    view = memoryview(blob)   # no copy of the body
    digest, body = blob[off:off + 32], view[off + 32:]
    if hashlib.sha256(body).digest() != digest:
        raise ValueError("checksum mismatch")
    ent = pickle.loads(body)
    if not isinstance(ent, dict) or ent.get("v") != 1 \
            or ent.get("key") != key:
        raise ValueError("key/version mismatch")
    return ent


def load(key: str, *, quiet: bool = False):
    """Consult the disk tier for the plan ``key`` names: (payload, meta)
    on a verified hit, None otherwise.  A drain's load counts a hit or a
    miss; a corrupt entry of any kind is a counted error and miss, with a
    degradation recorded and the entry unlinked.  ``quiet`` (a dry run)
    reads and counts nothing, and leaves a bad entry for the next drain
    to reject."""
    if not enabled():
        return None
    path = _path(key)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        if not quiet:
            _count("misses")
        return None
    except OSError as e:
        if not quiet:
            _record_corrupt(path, "unreadable: %s" % e)
            _count("misses")
        return None
    try:
        ent = _decode(blob, key)
    # qlint: allow(broad-except): the corruption fallback — a truncated, tampered or stale entry may fail anywhere in unpickling, and every such failure plans afresh
    except Exception as e:
        if not quiet:
            _record_corrupt(path, str(e) or type(e).__name__)
            _count("misses")
        return None
    meta = ent.get("meta") or {}
    if not quiet:
        saved = float(meta.get("plan_seconds", 0.0))
        _count("hits")
        _bump("saved_seconds", saved)
        if _telemetry.enabled() and saved:
            _telemetry.inc("aot_compile_seconds_saved_total", saved)
        try:
            os.utime(path)  # refresh the LRU position
        except OSError:
            pass
    return ent["payload"], meta


def _host_only(obj) -> None:
    """Raise TypeError when a payload holds a torch tensor (a plan must
    be NumPy arrays and tuples only)."""
    if isinstance(obj, torch.Tensor):
        raise TypeError("a plan holds a torch tensor")
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _host_only(x)


def store(key: str, payload, plan_seconds: float, meta=None) -> bool:
    """Persist one plan (atomic tempfile + os.replace), then evict down to
    the byte cap.  Best effort: a failure counts an error and the caller
    keeps its plan in memory."""
    d = cache_dir()
    if d is None:
        return False
    try:
        _host_only(payload)
        ent = {"v": 1, "key": key, "payload": payload,
               "meta": dict(meta or {}, plan_seconds=float(plan_seconds),
                            version=_version_tag())}
        body = pickle.dumps(ent, protocol=pickle.HIGHEST_PROTOCOL)
        blob = _MAGIC + hashlib.sha256(body).digest() + body
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, _path(key))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    except (OSError, TypeError, pickle.PicklingError):
        _bump("errors")
        return False
    _count("puts")
    _evict()
    return True


def probe(key, in_memory: bool = False) -> dict:
    """Side-effect-free prediction for explainCircuit: where the plan of
    the memory tier's key ``key`` (None: uncacheable) lives now.
    ``memory``: in this process's memory tier (the disk will not be
    consulted); ``hit`` / ``miss``: the disk tier's answer."""
    if not enabled():
        return {"enabled": False, "status": "disabled", "key": None}
    if key is None:
        return {"enabled": True, "status": "uncacheable", "key": None}
    digest = plan_key_digest(key)
    if in_memory:
        status = "memory"
    elif os.path.exists(_path(digest)):
        status = "hit"
    else:
        status = "miss"
    return {"enabled": True, "status": status, "key": digest}


def stats() -> dict:
    with _LOCK:
        out = dict(_STATS)
    out["enabled"] = enabled()
    out["dir"] = cache_dir()
    out["memory_keys"] = len(_MEMORY_KEYS)
    return out
