"""A profiled slice of a run: the device's operations from
``torch.profiler`` (CUPTI), read as intervals.

Device time is the union of the operations' intervals: since K1's
launches overlap (programmatic dependent launch), summed durations would
count some time twice. A slice is profiled after the timed window, as a
continuation of the same traffic, so the window itself runs untraced.
"""

from __future__ import annotations

import re
import time

import torch


class Slice:
    """What a profiled slice saw: device operations (name, start, end) in
    seconds on the profiler's clock, host operations likewise, the
    slice's wall seconds, and the run's own notes about the work in it."""

    def __init__(self, device_ops, host_ops, wall_s, work):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.wall_s = wall_s
        self.work = work

    def union_s(self, pattern=None, exclude=None) -> float:
        """Seconds in which an operation (whose name matches ``pattern``, a
        regex, and not ``exclude``) ran."""
        spans = sorted((a, b) for name, a, b in self.device_ops
                       if (pattern is None or re.search(pattern, name))
                       and not (exclude and re.search(exclude, name)))
        return union(spans)

    def busy_s(self) -> float:
        return self.union_s()

    def matches(self, pattern) -> int:
        return sum(1 for name, _, _ in self.device_ops
                   if re.search(pattern, name))

    def top_ops(self, n=10):
        by = {}
        for name, a, b in self.device_ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in top]

    def idle_gaps(self, n=10):
        """The longest stretches with no device operation inside the span
        of the slice's operations, each named by the innermost host
        operation running at its middle ("host idle" if none)."""
        spans = sorted((a, b) for _, a, b in self.device_ops)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2.0
            inner = [(s, name) for name, s, e in self.host_ops
                     if s <= mid <= e]
            label = max(inner)[1] if inner else "host idle"
            out.append([label[:120], b - a])
        return out


def union(spans) -> float:
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def profile(fn, work):
    """Run ``fn()`` under ``torch.profiler`` (host and device activity)
    and read it: a :class:`Slice`, or None where the profiler saw no device
    operation. ``work`` is filled by ``fn`` with its notes."""
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ops, host_ops = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range leaves a device-side span too
            if getattr(e, "is_user_annotation", False):
                continue
            device_ops.append((e.name, start, end))
        else:
            host_ops.append((e.name, start, end))
    if not device_ops:
        return None
    return Slice(device_ops, host_ops, wall, work)
