"""Build and load the hand-written CUDA kernels.

Every source under ``csrc/`` (``window.cu``: K1, K2, K11, K12;
``paulis.cu``: K3, K4; ``channels.cu``: K5; ``qft.cu``: K6-K10;
``probes.cu``: P1, the HBM stream pass) is compiled with nvcc for
``sm_90a`` into one shared library with a plain C interface, in the git-ignored ``_build/`` directory of the
package, at first use.  The library's name carries a hash of all sources
and flags, so an edited source is rebuilt and an unchanged one is not.
The sources compile in parallel, one nvcc process each, and link in one
more step.  The kernel modules (``ops/fused.py``, ``ops/paulis.py``,
``ops/bigstate.py``, ``ops/stream.py``) load the library from here and
declare their own entry points' ctypes signatures.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# --fmad=false: no multiply-add contraction, so a kernel's products round
# exactly where its plain PyTorch version's do (K2 == K1 pass by pass,
# K3 == its plain version, both bit for bit).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIB: dict = {}
_LOCK = threading.Lock()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the kernels are built from csrc/*.cu "
                       "with the CUDA toolkit at first use")


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libqt_kernels-{digest.hexdigest()[:12]}.so"


def _compile(path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, err = proc.communicate()
            log.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{src.name}:\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / path.name
        done = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *(str(obj) for _s, obj, _p in procs)],
            capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernels:\n"
                               f"{done.stderr}")
        os.replace(tmp, path)
        path.with_suffix(".log").write_text("".join(log))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_kernels() -> float:
    """Compile csrc/*.cu into the build directory unless this set of
    sources has been built already, and load the library.  Returns the
    seconds spent building (0.0 when nothing had to be built)."""
    with _LOCK:
        if "lib" in _LIB:
            return 0.0
        path = library_path()
        seconds = 0.0
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        lib.qt_error_string.argtypes = [ctypes.c_int]
        lib.qt_error_string.restype = ctypes.c_char_p
        _LIB["lib"] = lib
        return seconds


def library():
    """The loaded kernel library (built first if need be)."""
    if "lib" not in _LIB:
        build_kernels()
    return _LIB["lib"]


@contextlib.contextmanager
def launch_stream(tensor):
    """``with launch_stream(t) as stream:`` the raw CUDA stream of ``t``'s
    card to launch a kernel over ``t`` into, with that card the current
    device until the block ends: CUDA refuses a launch into a stream of
    another device, so a shard on ``cuda:1`` must not be launched with
    ``cuda:0`` current.  On the current card the guard changes nothing."""
    import torch

    with torch.cuda.device(tensor.device):
        yield torch.cuda.current_stream(tensor.device).cuda_stream


def raise_on(code: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if code != 0:
        msg = library().qt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def kernel_resources() -> dict:
    """Registers and spill bytes per kernel entry, as ptxas reported them
    when the library was built ({} when the build left no log)."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return {}
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out
