"""Profiling hooks: device traces, named regions, timings and the memory
watermark (the JAX package's ``utils/profiling.py`` on ``torch.profiler``
and the CUDA caching allocator's statistics).

``trace(logdir)`` captures a ``torch.profiler`` trace of the enclosed
block (CPU activity, and CUDA activity where a card is present) and
exports it as a Chrome trace, ``<logdir>/trace.json`` (open it in
Perfetto or chrome://tracing); the telemetry spans (``fusion.drain``,
``fusion.plan``, ...) appear in it as ``record_function`` ranges around
the kernels they enclose, and as NVTX ranges for Nsight.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator, Optional

import torch

from .. import telemetry as _telemetry


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it to ``<logdir>/trace.json`` (Chrome trace format)::

        with quest_tpu_torch.utils.profiling.trace("qt_trace") as prof:
            run_circuit()

    Yields the ``torch.profiler.profile`` object, whose ``events()`` and
    ``key_averages()`` can be read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace: ``torch.profiler.record_function``
    plus an NVTX range where CUDA is available (telemetry.annotate)."""
    return _telemetry.annotate(name)


@contextlib.contextmanager
def timed(label: str, sync: Optional[object] = None) -> Iterator[dict]:
    """Wall-clock a block; given a CUDA tensor as ``sync``, wait for its
    device's queued work before reading the clock.  The yielded dict
    gains {'seconds': ...} on exit, and the time is observed into the
    ``timed_seconds{label}`` telemetry histogram."""
    out: dict = {"label": label}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        out["seconds"] = time.perf_counter() - t0
        _telemetry.observe("timed_seconds", out["seconds"], label=label)


def _maxrss_bytes(res=None, platform: Optional[str] = None) -> int:
    """Host process peak RSS in bytes (``ru_maxrss`` is kilobytes on
    Linux, bytes on macOS)."""
    if res is None:
        import resource as res
    if platform is None:
        platform = sys.platform
    scale = 1 if platform.startswith("darwin") else 1024
    return int(res.getrusage(res.RUSAGE_SELF).ru_maxrss) * scale


def memory_watermark() -> dict:
    """Per-card memory statistics ``{"cuda:i": {"bytes_in_use",
    "peak_bytes_in_use"}}`` from ``torch.cuda.memory_allocated`` /
    ``max_memory_allocated``, published as the ``device_bytes_in_use``,
    ``hbm_watermark_bytes`` and ``device_memory_watermark_bytes`` gauges
    (``{device}``), the peak the
    drain samples after each drain and getEnvironmentString / reportPerf
    report.  Without a card the memory governor's modeled peak per
    device stands in under ``device="model"`` while a budget is active
    (so a CPU run's watermark agrees with the predictor), else the host
    process's peak RSS under ``device="host"``."""
    out: dict = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            dev = f"cuda:{i}"
            stats = {"bytes_in_use": int(torch.cuda.memory_allocated(i)),
                     "peak_bytes_in_use":
                         int(torch.cuda.max_memory_allocated(i))}
            out[dev] = stats
            _telemetry.set_gauge("device_bytes_in_use",
                                 stats["bytes_in_use"], device=dev)
            _telemetry.set_gauge("hbm_watermark_bytes",
                                 stats["peak_bytes_in_use"], device=dev)
            _telemetry.set_gauge("device_memory_watermark_bytes",
                                 stats["peak_bytes_in_use"], device=dev)
        return out
    from .. import governor as _governor

    modeled = _governor.modeled_watermark_bytes()
    if modeled is not None:
        out["model"] = {"modeled_peak_bytes_in_use": int(modeled)}
        _telemetry.set_gauge("hbm_watermark_bytes", modeled, device="model")
        _telemetry.set_gauge("device_memory_watermark_bytes", modeled,
                             device="model")
        return out
    rss = _maxrss_bytes()
    out["host"] = {"peak_bytes_in_use": rss}
    _telemetry.set_gauge("hbm_watermark_bytes", rss, device="host")
    _telemetry.set_gauge("device_memory_watermark_bytes", rss,
                         device="host")
    return out
