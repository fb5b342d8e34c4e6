"""The device trace of a short steady stretch: ``torch.profiler`` with CPU and
CUDA activities, exported as a Chrome trace under ``TMPDIR`` and read back.

Device operations are kernels, copies and memsets. Each is tied through its
correlation id to the host call that launched it (runtime or driver API), and
through that call's host time to the benchmark's ranges (``hooks``): an
operation belongs to a range when it was launched while the range was open,
whatever thread launched it (autograd launches backward kernels from its own
thread while the caller waits inside ``backward``). Busy time is the union
of the device intervals, so overlapping operations count once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.hooks import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STRETCH = PREFIX + "stretch"


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals (any unit)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class DeviceOp:
    name: str
    start: float  # us, on the trace's clock
    end: float
    launched: Optional[float]  # host time of its launch, us


@dataclass
class Stretch:
    """A profiled stretch: its wall time, device operations, the benchmark's
    ranges and the host's operations, all in microseconds on one clock."""
    start: float
    end: float
    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[float, float]]]
    host: List[Tuple[float, float, str]] = field(default_factory=list)
    units: int = 0  # batches or steps the stretch holds

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def clipped(self) -> List[Tuple[float, float]]:
        return [(max(o.start, self.start), min(o.end, self.end)) for o in self.ops
                if o.end > self.start and o.start < self.end]

    @property
    def busy_s(self) -> float:
        return union_seconds(self.clipped()) * 1e-6

    def in_ranges(self, name: str) -> List[DeviceOp]:
        spans = sorted(self.ranges.get(PREFIX + name, []))
        starts = [a for a, _ in spans]
        out = []
        for o in self.ops:
            if o.launched is None:
                continue
            i = bisect.bisect_right(starts, o.launched) - 1
            if i >= 0 and o.launched <= spans[i][1]:
                out.append(o)
        return out

    def range_device_s(self, name: str) -> float:
        """Device time of the operations launched inside the range ``name``."""
        return union_seconds([(o.start, o.end) for o in self.in_ranges(name)]) * 1e-6

    def unattributed(self) -> int:
        return sum(1 for o in self.ops if o.launched is None)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.ops:
            by[short(o.name)] = by.get(short(o.name), 0.0) + (o.end - o.start) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, labelled: int = 500) -> List[list]:
        """The device's idle time in the stretch, by the innermost host
        operation open at each gap's middle (the one that started last); the
        ``labelled`` longest gaps are labelled, the rest summed as one."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        idle = sorted(gaps(self.clipped(), self.start, self.end), key=lambda g: g[0] - g[1])
        for k, (a, b) in enumerate(idle):
            label = "(shorter gaps)"
            if k < labelled:
                mid, label = 0.5 * (a + b), "(no host op)"
                i = bisect.bisect_right(starts, mid) - 1
                for h in host[max(i - 5000, -1) + 1:i + 1][::-1]:
                    if h[1] >= mid:
                        label = h[2]
                        break
            by[short(label)] = by.get(short(label), 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments, at most ``width`` long."""
    head = name.split("<", 1)[0] if not name.startswith("<") else name
    return head[:width]


def parse(events: List[dict], units: int) -> Stretch:
    launches: Dict[int, float] = {}
    ops, ranges, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = ts
        elif cat in DEVICE_CATS:
            ops.append((e.get("name", "?"), ts, ts + dur, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ranges.setdefault(e["name"], []).append((ts, ts + dur))
        if cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((ts, ts + dur, e.get("name", "?")))
    if STRETCH not in ranges:
        raise RuntimeError("the trace holds no stretch range: the profiler recorded no host "
                           "events")
    if not ops:
        raise RuntimeError("the trace holds no device operation: the profiler did not see "
                           "the card")
    start, end = ranges[STRETCH][0]
    dev = [DeviceOp(n, a, b, launches.get(int(c)) if c is not None else None)
           for n, a, b, c in ops]
    return Stretch(start, end, dev, ranges, host, units)


class Profiled:
    """A profiled stretch not yet read: :meth:`read` exports and parses its
    trace, which takes seconds, so it runs after the window."""

    def __init__(self, prof, units: int):
        self.prof, self.units = prof, units

    def read(self) -> Stretch:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return parse(events, self.units)


def capture(fn: Callable[[], int], device) -> Profiled:
    """Profile ``fn`` (which returns the units it ran) inside the range
    ``portbench.stretch``, the device synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            units = fn()
            torch.cuda.synchronize(device)
    return Profiled(prof, units)
