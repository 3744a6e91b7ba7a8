"""The traced sub-window: a few units of a cell's work under
``torch.profiler``, reduced to what the per-layer readers and the
``breakdown`` need.

Device time is the union of the device's own events (kernels, copies,
fills) on the profiler's timeline; the window is the host's clock from
before the first launch to the synchronisation after the last.  An idle
gap (between two device events, or between the first and last host event
and the device's first and last) is named after the innermost host event
(an operator or a runtime call) running at its midpoint.  No Chrome trace
is written.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _HostOps:
    """The host operators of a trace, for 'what ran at time t'."""

    def __init__(self, events):
        ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in events)
        self.starts = [o[0] for o in ops]
        self.ops = ops

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            s, e, name = self.ops[j]
            if e > t:
                return name
        return "python (between operators)"


def _activity(e) -> str:
    """An event's kind; releases without ``activity_type`` are told by the
    names CUPTI gives copies and fills."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def profile(unit, units: int, sync) -> dict:
    """Run ``unit()`` ``units`` times under the profiler and reduce."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    kernels = sum(1 for e in dev if _activity(e) == "kernel")
    by_name: dict = defaultdict(float)
    for e in dev:
        by_name[e.name()[:200]] += e.duration_ns() / 1e9
    busy = _merge([(e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps: dict = defaultdict(float)
    if busy and host:
        ops = _HostOps(host)
        w0, w1 = ops.ops[0][0], max(o[1] for o in ops.ops)
        edges = [(w0, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], w1))
        for s, e in edges:
            if e > s:
                gaps[ops.at((s + e) // 2)[:200]] += (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"units": units, "kernels": kernels, "device_events": len(dev),
            "busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": [list(kv) for kv in top],
                          "idle_gaps": [list(kv) for kv in idle]}}
