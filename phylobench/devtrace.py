"""A traced stretch of the window: ``torch.profiler`` over the host and
the card, its events kept in memory and reduced here.

The device's busy time is the union of the intervals in which any device
operation (kernel, copy, set) ran, so operations that overlap count once.
Idle gaps are the rest of the traced stretch, each named by what the
host was doing at its middle: the benchmark's own span around the
request and the innermost host operation running then.
"""

from __future__ import annotations

import heapq

import torch

SPAN = "phylobench.traced"
# the profiler's activity types of work on the device
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(busy, lo: float, hi: float):
    """The idle intervals of [lo, hi] between the disjoint ``busy`` ones."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def host_activity(cpu_events, times) -> list[str]:
    """What the host ran at each of the sorted ``times``: the benchmark's
    outermost span and the innermost operation covering the time."""
    events = sorted((s, e, name) for name, s, e in cpu_events
                    if name != SPAN)
    live, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            heapq.heappush(live, (events[i][1], events[i][0], events[i][2]))
            i += 1
        while live and live[0][0] < t:
            heapq.heappop(live)
        outer = inner = None
        for e, s, name in live:
            if name.startswith("phylobench.") and (
                    outer is None or e - s > outer[0]):
                outer = (e - s, name)
            if inner is None or e - s < inner[0]:
                inner = (e - s, name)
        parts = [x[1] for x in (outer, inner) if x is not None]
        if len(parts) == 2 and parts[0] == parts[1]:
            parts = parts[:1]
        out.append(" / ".join(parts) or "host outside any traced operation")
    return out


def top(pairs: dict, n: int = 10, width: int = 120) -> list:
    """The n largest (name, seconds), names cut to ``width`` letters."""
    return [[k[:width], v] for k, v in
            sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def reduce(device_events, cpu_events, lo: float, hi: float,
           n_requests: int) -> dict:
    """The summary of one traced stretch [lo, hi] (seconds, one clock):
    ``device_events`` and ``cpu_events`` are (name, start, end)."""
    dev = clip([(s, e) for _, s, e in device_events], lo, hi)
    busy = union(dev)
    by_op: dict[str, float] = {}
    for name, s, e in device_events:
        for cs, ce in clip([(s, e)], lo, hi):
            by_op[name] = by_op.get(name, 0.0) + (ce - cs)
    idle = gaps(busy, lo, hi)
    by_host: dict[str, float] = {}
    for (s, e), what in zip(idle, host_activity(
            cpu_events, [0.5 * (s + e) for s, e in idle])):
        by_host[what] = by_host.get(what, 0.0) + (e - s)
    return {"busy_s": sum(e - s for s, e in busy), "window_s": hi - lo,
            "requests": n_requests,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)}}


def is_device_op(ev, DeviceType) -> bool:
    """A kernel, copy or set on the device, not an annotation of a span."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_OPS
    # torch builds without activity_type(): every device event that is not
    # a span's copy on the device's timeline
    note = getattr(ev, "is_user_annotation", None)
    return (ev.device_type() == DeviceType.CUDA
            and not (note is not None and note())
            and not ev.name().startswith("phylobench."))


class Window:
    """The profiler over a stretch of requests; :meth:`summary` after it
    closes."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = torch.device(device)
        self.prof = profile(activities=acts)
        self.span = None

    def __enter__(self):
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, n_requests: int) -> dict:
        """The stretch reduced (:func:`reduce`), from the profiler's raw
        events: device operations are its kernels, copies and sets."""
        from torch.autograd import DeviceType
        dev, cpu, lo, hi = [], [], None, None
        for ev in self.prof.profiler.kineto_results.events():
            s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
            if is_device_op(ev, DeviceType):
                dev.append((ev.name(), s, e))
            elif ev.device_type() == DeviceType.CPU:
                if ev.name() == SPAN:
                    lo, hi = s, e
                else:
                    cpu.append((ev.name(), s, e))
        if lo is None:
            raise RuntimeError("the traced stretch's span is missing from "
                               "the profile")
        return reduce(dev, cpu, lo, hi, n_requests)
