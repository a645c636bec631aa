#!/usr/bin/env python3
"""Time the parts of the window kernels' items on the card: K2 (the
window megakernel) against K1 (the window pass), from an instrumented
copy of csrc/window.cu.

    python3 scripts/k2_segments.py

The script copies quest_tpu_torch into the git-ignored
quest_tpu_torch/_build/segments/, inserts %globaltimer marks into the copy
of csrc/window.cu (thread 0 of each CTA records, in shared memory, when
an item starts, when its first and its last K tile have landed, when its
products end, when it has issued its next item's first copies and when it
has issued its stores; the kernels add the differences to a device array),
builds the copy there and runs, at 26 qubits, float32, on random sides
made from a seed:

* one rank-1 dual-side pass (k = 19) and one B-only pass (k = 14);
* the shapes of bench.py config 2's megawin groups: A/B (a masked B-only
  and a masked dual pass at k = 7) and C (five passes up to k = 10).

Each case runs through K2 and pass by pass through K1 (CUDA-event
milliseconds in turns K1, K2, K2, K1, and K2 bit for bit against K1),
then once more each for the marks.  Per dual-side item: the microseconds
from its start to its first K tile's data (`start`), to its last tile's
(`body`), to the end of its products (`last`), to its next item's copies
issued (`issue`, K2 only) and to its stores issued (`stores`); per K tile
of a rank-1 dual item, the time from one tile's data to the next's
(`tiles`, 7 of them); and K2's schedule: items, items whose first tile
the previous item issued (`primed`), and microseconds its CTAs waited for
inputs.  One JSON line per case, then the card's name and power limit.
The marks cost the kernels a few percent; compare times within one run.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "quest_tpu_torch" / "_build" / "segments"
N = 26
SEED = 3

# (old, new) insertions into the copy of csrc/window.cu
MARKS = [
    ("// One (slab, lane chunk) item of one window pass, where `ia` says.",
     """__device__ unsigned long long g_seg[48];
__shared__ unsigned long long g_ts[8];
__device__ __forceinline__ unsigned long long gtime() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ void mark(int i) {
    if (threadIdx.x == 0) g_ts[i] = gtime();
}
// parts of a dual-side item: g_seg[base + 0] items, [base + 1 ..] parts
__device__ __forceinline__ void segs(int base) {
    if (threadIdx.x != 0) return;
    atomicAdd(&g_seg[base], 1ull);
    for (int i = 0; i < 5; ++i)
        atomicAdd(&g_seg[base + 1 + i], g_ts[i + 1] - g_ts[i]);
}
// One (slab, lane chunk) item of one window pass, where `ia` says."""),
    ("    T* t_r = smem + STAGES * stage_elems<T>();   // [DIM][TS]: T = X "
     "A^T chunk",
     "    mark(0);\n    T* t_r = smem + STAGES * stage_elems<T>();   "
     "// [DIM][TS]: T = X A^T chunk"),
    ("""        bar_wait(&bars[pos % STAGES], (pos / STAGES) & 1);
""", """        bar_wait(&bars[pos % STAGES], (pos / STAGES) & 1);
        if (tile == 0) mark(1);
        if (tile == total - 1) mark(2);
        if (threadIdx.x == 0 && p.apply_a && p.apply_b && total == 8) {
            // K tile j of a rank-1 dual item: [32 + 8 K2 + j]
            const unsigned long long now = gtime();
            if (tile > 0)
                atomicAdd(&g_seg[32 + (Next::enabled ? 8 : 0) + tile],
                          now - g_ts[6]);
            g_ts[6] = now;
        }
"""),
    ("""    __syncthreads();
    // a staged mask holds one more ring position
    const int end = ring + total + (STAGE_MASK ? 1 : 0);
    if constexpr (Next::enabled) next.issue(smem, bars, end);
""", """    __syncthreads();
    mark(3);
    // a staged mask holds one more ring position
    const int end = ring + total + (STAGE_MASK ? 1 : 0);
    if constexpr (Next::enabled) next.issue(smem, bars, end);
    mark(4);
"""),
    ("""            ia.yr[d] = vr;
            ia.yi[d] = vi;
        }
    return end;""", """            ia.yr[d] = vr;
            ia.yi[d] = vi;
        }
    mark(5);
    return end;"""),
    ("""mid * DIM, chunk * Cfg<T>::LC};
    NoNext none;
    init_ring(bars, NTHREADS);
    run_item<T, FAM>(ia, p, smem, bars, 0, false, none);
}""", """mid * DIM, chunk * Cfg<T>::LC};
    NoNext none;
    init_ring(bars, NTHREADS);
    run_item<T, FAM>(ia, p, smem, bars, 0, false, none);
    if (p.apply_a && p.apply_b) segs(0);
}"""),
    ("                    mega_wait(m, L);",
     """                    const unsigned long long w0 = gtime();
                    mega_wait(m, L);
                    atomicAdd(&g_seg[16], gtime() - w0);"""),
    ("""        primed = (p.apply_a || p.apply_b) && L.go;
        if (tid == 0) {""", """        if (p.apply_a && p.apply_b) segs(8);
        if (tid == 0) {
            atomicAdd(&g_seg[17], 1ull);
            atomicAdd(&g_seg[18], (unsigned long long)primed);
        }
        primed = (p.apply_a || p.apply_b) && L.go;
        if (tid == 0) {"""),
    ('extern "C" {', '''extern "C" {
int qt_segments(unsigned long long* host) {
    const unsigned long long zero[48] = {0};
    cudaError_t err = cudaMemcpyFromSymbol(host, g_seg, sizeof(g_seg));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(g_seg, zero, sizeof(zero));
    return (int)err;
}'''),
]

CASES = {
    "one dual pass": [(19, 1, "AB", False)],
    "one B-only pass": [(14, 1, "B", False)],
    "groups A/B shape": [(7, 1, "B", True), (7, 1, "AB", True)],
    "group C shape": [(7, 1, "B", True), (7, 1, "AB", True),
                      (7, 1, "AB", True), (7, 1, "AB", False),
                      (10, 1, "B", False)],
}


def instrumented_copy() -> Path:
    """The package copied into COPY with the marks in its window.cu."""
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(ROOT / "quest_tpu_torch", COPY / "quest_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = COPY / "quest_tpu_torch" / "csrc" / "window.cu"
    text = src.read_text()
    for old, new in MARKS:
        if text.count(old) != 1:
            raise RuntimeError("csrc/window.cu changed: cannot place a mark "
                               f"at {old.strip()[:60]!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return COPY


def parts(v, base):
    n = v[base]
    return {"items": n, "us": {name: v[base + 1 + i] / max(n, 1) / 1e3
                               for i, name in enumerate(
                                   ("start", "body", "last", "issue",
                                    "stores"))}}


def tiles(v, base, n):
    """Microseconds from K tile j - 1's data to tile j's, j = 1..7."""
    return [v[base + j] / max(n, 1) / 1e3 for j in range(1, 8)]


def run_cases() -> None:
    import numpy as np
    import torch

    # the instrumented copy comes first on the path (PYTHONPATH), the
    # repository after it for chip_smoke's helpers
    sys.path.append(str(ROOT))
    import chip_smoke as cs
    from quest_tpu_torch import circuit as C
    from quest_tpu_torch.ops import build, fused

    if not Path(fused.__file__).resolve().is_relative_to(COPY):
        raise RuntimeError(f"imported {fused.__file__}, not the copy")

    build.build_kernels()
    lib = build.library()
    lib.qt_segments.argtypes = [ctypes.c_void_p]
    lib.qt_segments.restype = ctypes.c_int

    def read():
        buf = (ctypes.c_ulonglong * 48)()
        build.raise_on(lib.qt_segments(buf), "qt_segments")
        return list(buf)

    rng = np.random.default_rng(SEED)
    x = torch.randn((2, 1 << (N - 14), 128, 128), device="cuda")
    x /= x.norm()
    for name, spec in CASES.items():
        group = [tuple(torch.as_tensor(t, dtype=torch.float32, device="cuda")
                       if isinstance(t, np.ndarray) else t
                       for t in cs.random_pass(rng, k, r, s, m))
                 for k, r, s, m in spec]

        def k2():
            return fused.apply_window_megastack(x, group, num_qubits=N)

        def k1():
            return C.execute_plan(x, group, N)

        equal = torch.equal(k1(), k2())
        turns = [cs.time_ms(f) for f in (k1, k2, k2, k1)]
        read()
        k2()
        torch.cuda.synchronize()
        v2 = read()
        k1()
        torch.cuda.synchronize()
        v1 = read()
        print(json.dumps({
            "case": name, "k2_bit_identical_to_k1": equal,
            "turns_k1_k2_k2_k1_ms": turns,
            "k1": {**parts(v1, 0), "tiles_us": tiles(v1, 32, v1[0])},
            "k2": {**parts(v2, 8), "tiles_us": tiles(v2, 40, v2[8]),
                   "schedule": {"items": v2[17], "primed": v2[18],
                                "wait_us": v2[16] / 1e3}}}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


def main() -> int:
    if os.environ.get("QT_K2_SEGMENTS_CHILD"):
        run_cases()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k2_segments: no CUDA device is available", file=sys.stderr)
        return 2
    copy = instrumented_copy()
    env = dict(os.environ, QT_K2_SEGMENTS_CHILD="1",
               PYTHONPATH=os.pathsep.join(
                   [str(copy), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, __file__], env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
