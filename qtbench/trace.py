"""The traced run's reading of a ``torch.profiler`` trace: device events
(kernels, copies and fills on the card), the host regions the harness and
the program annotate, and the reductions the per-layer metrics and the
result's ``breakdown`` take from them.

Times are in seconds.  Busy time is the union of the device events'
intervals, never their sum: two events that overlap count once.  Each
device event carries the index of the card it ran on; ``Trace.device``
holds the events of every card.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

# Host regions an idle gap of the card is put down to, innermost first
# when several cover it: the harness's own and the program's spans.
HOST_REGIONS = ("fusion.plan", "fusion.optimize", "fusion.drain",
                "qtbench.init", "qtbench.gate_calls", "qtbench.readout",
                "qtbench.circuit")

_COPY = re.compile(r"^(Memcpy|Memset)")


@dataclass
class DeviceEvent:
    name: str
    start: float
    end: float
    card: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def is_kernel(self) -> bool:
        return not _COPY.match(self.name)

    @property
    def function(self) -> str:
        """The kernel's function name without its return type, template
        arguments and parameters."""
        name = self.name.replace("(anonymous namespace)::", "")
        if name.startswith("void "):
            name = name[5:]
        name = name.split("(")[0].split("<")[0]
        return name.split("::")[-1].strip()


@dataclass
class Trace:
    device: list = field(default_factory=list)    # DeviceEvent, by start
    host: list = field(default_factory=list)      # (name, start, end)
    window_s: float = 0.0


def profiler():
    """A profiler over the host and the card, not yet started."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def read(prof, window_s: float) -> Trace:
    """The device events and annotated host regions of a stopped
    profiler.  A host annotation's image on the card's timeline (a
    ``record_function`` range the profiler also draws there) is no device
    event and is left out."""
    out = Trace(window_s=window_s)
    events = list(prof.profiler.kineto_results.events())
    annotations = {ev.name() for ev in events if ev.is_user_annotation()}
    annotations.update(HOST_REGIONS)
    for ev in events:
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        on_card = str(ev.device_type()).endswith("CUDA")
        if on_card and not ev.is_user_annotation() \
                and ev.name() not in annotations:
            out.device.append(DeviceEvent(ev.name(), start, end,
                                          ev.device_index()))
        elif not on_card and ev.name() in HOST_REGIONS:
            out.host.append((ev.name(), start, end))
    out.device.sort(key=lambda e: e.start)
    return out


def busy_intervals(events) -> list:
    """The union of the events' intervals, as sorted disjoint
    [start, end] pairs."""
    merged: list = []
    for ev in sorted(events, key=lambda e: e.start):
        if merged and ev.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ev.end)
        else:
            merged.append([ev.start, ev.end])
    return merged


def busy_s(trace: Trace, card=None) -> float:
    """Seconds in which something ran on the card ``card`` (an index;
    None: on any card)."""
    events = [ev for ev in trace.device if card is None or ev.card == card]
    return sum(e - s for s, e in busy_intervals(events))


def idle_within(trace: Trace, region: str) -> float:
    """Seconds in which the card idled while the host was inside an
    annotated region named ``region`` (the union of its intervals, less
    every busy interval of the card)."""
    spans = busy_intervals(
        [DeviceEvent(name, s, e) for name, s, e in trace.host
         if name == region])
    busy = busy_intervals(trace.device)
    idle, j = 0.0, 0
    for s, e in spans:
        idle += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            idle -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return idle


def top_device_ops(trace: Trace, count: int = 10) -> list:
    """[[kernel function, seconds]] of the ``count`` functions that took
    the most device time."""
    by: dict = {}
    for ev in trace.device:
        key = ev.function if ev.is_kernel else ev.name
        by[key] = by.get(key, 0.0) + ev.seconds
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:count]]


def idle_gaps(trace: Trace, count: int = 10) -> list:
    """[[host region, seconds]]: the card's idle gaps between busy
    intervals, summed by the innermost annotated host region that covers
    each gap's middle ("host other" where none does)."""
    busy = busy_intervals(trace.device)
    gaps = [(0.5 * (e0 + s1), s1 - e0)
            for (_s0, e0), (s1, _e1) in zip(busy, busy[1:])]
    host = sorted(trace.host, key=lambda h: h[1])
    by: dict = {}
    active: list = []
    i = 0
    for mid, length in gaps:         # gaps are in time order
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        label = min(active, key=lambda h: h[2] - h[1])[0] if active \
            else "host other"
        by[label] = by.get(label, 0.0) + length
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:count]]


def port_kernel_functions(package_dir: Path) -> set:
    """The names of every ``__global__`` function in the program's CUDA
    sources: the kernels the port writes itself."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(", re.S)
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names
