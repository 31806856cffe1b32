"""What a traced run reads: the device's activity from ``torch.profiler``
and the program's telemetry spans.

The profiler's events carry wall-clock nanoseconds, so the harness marks
its own phases with ``time.time_ns()`` and matches device activity to
them by time.  Device activity is every kernel, copy
and fill on the card; its union over the traced window is the busy
time."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Phases", "DeviceTrace", "union_s", "span_self_s"]

#: Entries kept in each list of a breakdown.
TOP = 10


class Phases:
    """The harness's own phases, as ``(name, start_ns, end_ns)`` on the
    profiler's clock."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    def mark(self, name: str):
        return _Phase(self, name)


class _Phase:
    def __init__(self, phases: Phases, name: str):
        self.phases, self.name = phases, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.phases.spans.append((self.name, self.t0, time.time_ns()))
        return False


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)``
    intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


class DeviceTrace:
    """``torch.profiler`` over a window, recording the device's activity
    alone (recording every host operation too would slow the host-bound
    paths several times over).  After :meth:`collect`, ``device`` holds
    ``(name, start_ns, end_ns)`` of every device operation, and
    ``t0_ns`` / ``t1_ns`` bound the window, each end behind a device
    synchronisation."""

    def __init__(self, device):
        self.dev = device
        self.prof = None
        self.running = False
        self.device: List[Tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.dev)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.running = True
        self.t0_ns = time.time_ns()

    def stop(self):
        import torch

        torch.cuda.synchronize(self.dev)
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.running = False

    def collect(self):
        """Read the stopped profile's events (kept out of the window: it
        takes a while)."""
        from torch.autograd import DeviceType

        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                self.device.append((e.name(), s, s + e.duration_ns()))
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_s(self, t0_ns: Optional[int] = None,
               t1_ns: Optional[int] = None) -> float:
        """Union of device activity inside ``[t0_ns, t1_ns)`` (the whole
        window by default), clipped to it."""
        a = self.t0_ns if t0_ns is None else t0_ns
        b = self.t1_ns if t1_ns is None else t1_ns
        return union_s((max(s, a), min(e, b)) for _, s, e in self.device
                       if e > a and s < b)

    def device_ops(self) -> List[List]:
        """The device operations that took most time, ``[name,
        seconds]``, summed by name."""
        tot: Dict[str, int] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, phases: Phases) -> List[List]:
        """The longest stretches of the window with nothing on the
        device, ``[what the host was doing, seconds]``: the harness
        phase at the gap's middle."""
        edges, cur = [], self.t0_ns
        for _, s, e in sorted((r for r in self.device),
                              key=lambda r: r[1]):
            if s > cur:
                edges.append((cur, min(s, self.t1_ns)))
            cur = max(cur, e)
            if cur >= self.t1_ns:
                break
        if cur < self.t1_ns:
            edges.append((cur, self.t1_ns))
        edges = sorted(edges, key=lambda g: g[0] - g[1])[:TOP]
        out = []
        for a, b in edges:
            mid = (a + b) // 2
            phase = next((n for n, s, e in phases.spans if s <= mid < e),
                         "between phases")
            out.append([phase, (b - a) / 1e9])
        return out


def span_self_s(spans: List[Dict], name: str) -> Tuple[int, float]:
    """``(count, summed self seconds)`` of the spans called ``name``: a
    span's duration less its direct children's."""
    kids: Dict[Tuple, float] = {}
    for s in spans:
        if s.get("parent") is not None:
            key = (s.get("tid"), s["parent"])
            kids[key] = kids.get(key, 0.0) + float(s.get("dur", 0.0))
    n, tot = 0, 0.0
    for s in spans:
        if s["name"] == name:
            n += 1
            tot += max(float(s.get("dur", 0.0))
                       - kids.get((s.get("tid"), s.get("sid")), 0.0), 0.0)
    return n, tot
