"""What the spans cost, and where a traced batch leaves the card idle.

- ``disabled``: host microseconds of the disabled path: one launch's
  spans, one run's own, and one span without keyword arguments (the
  scan step's and the metrics pass's sites); ``enabled_per_span_us``
  the same span recorded.
- ``headline``: phase 5's headline simulate (10,000 lanes through the
  event kernel) timed with CUDA events, the telemetry sink off and on in
  alternating runs.
- ``batches``: per engine, the headline batch as the benchmark's sim
  cells run it (``simulate_batch``, a sync, ``feed_metrics_batch`` and
  ``num_posts``, a sync) under ``torch.profiler`` (device activity), the
  sink off and on in turn (off, on, on, off).  Each reports its wall time
  and the card's idle share; the batch's spans times one span's cost is
  the spans' cost with the sink off, and the sink's own cost when on.
  From the sink-on batches: the idle time put down to the innermost span
  open at each instant (``idle_by_span``), the device operations
  launched inside each ``scan.step`` (and each of its stages) and per
  metrics column, the simulate call's time outside its engine, and
  whether every event-kernel launch lies inside an
  ``engine.pallas.launch`` span (the spans and the profiler's records on
  one clock).

Prints one JSON line.

    python -m redqueen_tpu_torch.smoke.span_cost [--pairs 30]
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.runtime import telemetry
from redqueen_tpu_torch.smoke.fused import HEADLINE_B, headline_component

#: The device name of the event kernel (``csrc/event_kernel.cu``).
EVENT_KERNEL = "event_kernel"
#: Where no span is open.
NO_SPAN = "(no span)"
#: Entries kept in ``idle_by_span``.
TOP = 10
#: The headline's horizon (phase 5's, and the benchmark's sim cells').
HEADLINE_T = 100.0


def disabled_launch_us(n: int = 200_000) -> dict:
    """Host microseconds of one launch's spans (``engine.pallas.launch``
    and ``engine.pallas.sync``), of one run's own (its span, the dispatch
    event and the two counters) and of one span without keyword
    arguments, with telemetry off, each less an empty loop's time."""
    telemetry.configure(enabled=False, reset=True)

    def per(body):
        t0 = time.perf_counter()
        body(n)
        return (time.perf_counter() - t0) / n * 1e6

    def empty(k):
        for _ in range(k):
            pass

    def launch(k):
        for _ in range(k):
            with telemetry.span("engine.pallas.launch"):
                pass
            with telemetry.span("engine.pallas.sync"):
                pass

    def run(k):
        for _ in range(k):
            with telemetry.span("engine.pallas.run", k=8, capacity=64,
                                lanes=1) as sp:
                sp.set(dispatches=1)
            telemetry.counter("engine.pallas.launches", 1)
            telemetry.event("engine.dispatch", engine="pallas",
                            requested="fused")
            telemetry.counter("engine.dispatch.pallas")

    def bare(k):
        for _ in range(k):
            with telemetry.span("scan.step"):
                pass

    base = per(empty)
    return {"per_launch_us": per(launch) - base,
            "per_run_us": per(run) - base,
            "per_span_us": per(bare) - base, "iterations": n}


def enabled_span_us(n: int = 50_000) -> float:
    """Host microseconds of one recorded span without keyword arguments
    (``n`` stays under the span buffer's bound), less an empty loop's
    time: the sink's own cost a span when it is on."""
    telemetry.configure(enabled=True, reset=True)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        t1 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("scan.step"):
                pass
        t2 = time.perf_counter()
    finally:
        telemetry.configure(enabled=False, reset=True)
    return ((t2 - t1) - (t1 - t0)) / n * 1e6


def headline_pairs(pairs: int, device) -> dict:
    """``pairs`` alternating (off, on) runs of the headline simulate, each
    timed with CUDA events; the first of each pair alternates too."""
    cfg, params, adj, _opt, mc = headline_component(HEADLINE_B,
                                                    HEADLINE_T, device)
    seeds = np.arange(HEADLINE_B) + 10_000

    def once(on: bool) -> float:
        telemetry.configure(enabled=on, reset=True)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                          sync_every=8, engine="fused", device=device)
        b.record()
        b.synchronize()
        spans[on] = len(telemetry.get().spans)
        return a.elapsed_time(b)

    spans = {}
    for on in (False, True):  # warm-up, not kept
        once(on)
    ms = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            ms[on].append(once(on))
    telemetry.configure(enabled=False, reset=True)
    off, on = np.asarray(ms[False]), np.asarray(ms[True])
    diff = on - off
    return {"pairs": pairs, "off_ms": off.tolist(), "on_ms": on.tolist(),
            "off_median_ms": float(np.median(off)),
            "on_median_ms": float(np.median(on)),
            "on_minus_off_median_ms": float(np.median(diff)),
            "on_minus_off_se_ms": float(diff.std(ddof=1)
                                        / np.sqrt(len(diff))),
            "spans_per_run": {"off": spans[False], "on": spans[True]}}


# ---------------------------------------------------------------------------
# A traced window: the profiler's records and the spans on one clock
# ---------------------------------------------------------------------------

Interval = Tuple[int, int]


def profiler_records(events) -> Tuple[List[Tuple[str, int, int]],
                                      Dict[int, int]]:
    """From a stopped profile's events (``kineto_results.events()``):
    the device operations ``[(name, start_ns, end_ns)]`` and, by device
    operation's index, the start of the host-side runtime record that
    launched it (the record sharing its correlation id).  Operations
    whose launch record is missing have no entry."""
    from torch.autograd import DeviceType

    device, corr = [], []
    host: Dict[int, int] = {}
    for e in events:
        c = int(e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            device.append((e.name(), s, s + e.duration_ns()))
            corr.append(c)
        elif c:
            host[c] = min(host.get(c, e.start_ns()), e.start_ns())
    launches = {i: host[c] for i, c in enumerate(corr) if c in host}
    return device, launches


def span_interval(s: Dict) -> Interval:
    """A span dict's ``[start_ns, end_ns)`` on the wall clock."""
    t = int(s["t_ns"])
    return t, t + int(round(float(s.get("dur", 0.0)) * 1e9))


def innermost(spans: Sequence[Dict]) -> List[Tuple[int, int, str]]:
    """The spans' timeline as ``[(start_ns, end_ns, name)]`` segments,
    each instant under the innermost span open then.  Spans of one
    thread nest; a span reaching past its parent is cut at the parent's
    end."""
    items = sorted((span_interval(s) + (s["name"],) for s in spans
                    if s.get("dur", 0.0) > 0),
                   key=lambda x: (x[0], -x[1]))
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []   # (end_ns, name), innermost last
    t = None
    for a, b, name in items:
        while stack and stack[-1][0] <= a:
            e, n = stack.pop()
            if t < e:
                out.append((t, e, n))
            t = max(t, e)
        if stack:
            if t < a:
                out.append((t, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append((b, name))
        t = a
    while stack:
        e, n = stack.pop()
        if t < e:
            out.append((t, e, n))
        t = max(t, e)
    return out


def idle_intervals(device: Sequence[Tuple[str, int, int]], t0: int,
                   t1: int) -> List[Interval]:
    """The stretches of ``[t0, t1)`` with nothing on the device."""
    out, cur = [], t0
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(idle: Sequence[Interval],
                 segments: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds put down to the innermost span open at each instant
    (``NO_SPAN`` where none is), summed by span name, largest first."""
    tot: Dict[str, int] = {}
    starts = [s for s, _, _ in segments]
    for a, b in idle:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        cur = a
        while cur < b:
            while i < len(segments) and segments[i][1] <= cur:
                i += 1
            if i < len(segments) and segments[i][0] <= cur:
                end, name = min(b, segments[i][1]), segments[i][2]
            else:
                end = min(b, segments[i][0]) if i < len(segments) else b
                name = NO_SPAN
            tot[name] = tot.get(name, 0) + (end - cur)
            cur = end
    return {n: ns / 1e9
            for n, ns in sorted(tot.items(), key=lambda kv: -kv[1])}


def launched_inside(launches: Dict[int, int], spans: Sequence[Dict],
                    name: str, device=None, kernel: Optional[str] = None
                    ) -> Tuple[int, int]:
    """``(inside, of)``: of the device operations with a launch record
    (only those named ``kernel``, where given), how many were launched
    while a span called ``name`` was open."""
    iv = sorted(span_interval(s) for s in spans if s["name"] == name)
    starts = [a for a, _ in iv]
    inside = of = 0
    for i, t in launches.items():
        if kernel is not None and kernel not in device[i][0]:
            continue
        of += 1
        j = bisect.bisect_right(starts, t) - 1
        inside += j >= 0 and t < iv[j][1]
    return inside, of


def attribution(spans: Sequence[Dict], device, launches, t0: int,
                t1: int) -> dict:
    """What one traced batch's spans say of its window (see the module's
    docstring).  The launch counts are None where the profiler delivered
    no launch records."""
    idle = idle_intervals(device, t0, t1)
    idle_s = sum(b - a for a, b in idle) / 1e9
    by = idle_by_span(idle, innermost(spans))
    named = {s["name"]: s for s in spans}
    steps = sum(s["name"] == "scan.step" for s in spans)
    columns = sum(int((s.get("attrs") or {}).get("columns", 0))
                  for s in spans if s["name"] == "metrics.feed")
    out = {
        "window_s": (t1 - t0) / 1e9, "device_ops": len(device),
        "launch_records": len(launches),
        "idle_pct": 100.0 * idle_s / max((t1 - t0) / 1e9, 1e-12),
        "idle_by_span": dict(list(by.items())[:TOP]),
        "idle_in_call_self_pct": 100.0 * (
            by.get("sim.simulate_batch", 0.0)
            + by.get("metrics.feed", 0.0)) / max(idle_s, 1e-12),
        "scan_steps": steps, "metrics_columns": columns,
        "summary": {k: {"count": v["count"], "total_s": v["total_s"],
                        "self_s": v["self_s"]}
                    for k, v in telemetry.summarize(spans)["stages"].items()},
    }
    sim = named.get("sim.simulate_batch")
    engine = named.get("engine.pallas.run") or named.get("engine.scan.drive")
    if sim is not None and engine is not None:
        out["simulate_outside_engine_ms"] = 1e3 * (
            float(sim["dur"]) - float(engine["dur"]))
    if launches:
        if steps:
            out["scan_launches_per_step"] = launched_inside(
                launches, spans, "scan.step")[0] / steps
            out["scan_launches_per_step_by_stage"] = {
                st: launched_inside(launches, spans, st)[0] / steps
                for st in ("scan.panel", "scan.fire", "scan.react")}
        if columns:
            out["metrics_launches_per_column"] = launched_inside(
                launches, spans, "metrics.feed")[0] / columns
        if "engine.pallas.run" in named:
            inside, of = launched_inside(launches, spans,
                                         "engine.pallas.launch", device,
                                         EVENT_KERNEL)
            out["event_kernel_launches"] = {"inside_launch_span": inside,
                                            "of": of}
    return out


def traced_batch(system, seeds, spans_on: bool) -> dict:
    """One batch of ``system`` (:class:`Headline`) under
    ``torch.profiler`` with the telemetry sink on or off: its wall time,
    the card's idle share and, with the sink on, its attribution."""
    from torch.profiler import ProfilerActivity, profile

    telemetry.configure(enabled=spans_on, reset=True)
    torch.cuda.synchronize(system.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        system.batch(seeds)
        t1 = time.time_ns()
    spans = telemetry.get().drain_spans()
    telemetry.configure(enabled=False, reset=True)
    device, launches = profiler_records(prof.profiler.kineto_results.events())
    if spans_on:
        return {"spans": len(spans),
                **attribution(spans, device, launches, t0, t1)}
    idle = idle_intervals(device, t0, t1)
    return {"window_s": (t1 - t0) / 1e9, "device_ops": len(device),
            "launch_records": len(launches),
            "idle_pct": 100.0 * sum(b - a for a, b in idle) / (t1 - t0)}


class Headline:
    """The benchmark's sim batch on one engine: the headline component,
    ``simulate_batch``, then the metrics pass, each ending in a sync."""

    def __init__(self, engine: str, lanes: int, end_time: float, device):
        self.engine, self.device = engine, device
        self.cfg, self.params, self.adj, self.opt, self.mc = \
            headline_component(lanes, end_time, device)

    def batch(self, seeds):
        log = rt.simulate_batch(self.cfg, self.params, self.adj, seeds,
                                max_chunks=self.mc, engine=self.engine,
                                device=self.device)
        torch.cuda.synchronize(self.device)
        m = rt.feed_metrics_batch(log.times, log.srcs, self.adj, self.opt,
                                  self.cfg.end_time)
        m.mean_time_in_top_k()
        rt.num_posts(log.srcs, self.opt)
        torch.cuda.synchronize(self.device)
        return log


def engine_batches(engine: str, device, per_span_us: float,
                   on_span_us: float) -> dict:
    """Traced headline batches of one engine, sink off and on in turn
    (off, on, on, off, after an untraced warm-up), with their spans' cost
    with the sink off and on (spans a batch times one span's cost)."""
    system = Headline(engine, HEADLINE_B, HEADLINE_T, device)
    system.batch(np.arange(HEADLINE_B) + 20_000)
    runs = {False: [], True: []}
    for i, on in enumerate((False, True, True, False)):
        runs[on].append(traced_batch(
            system, np.arange(HEADLINE_B) + 30_000 + i, on))
    spans = runs[True][0]["spans"]
    return {"engine": engine, "spans_per_batch": spans,
            "disabled_ms_per_batch": spans * per_span_us / 1e3,
            "enabled_ms_per_batch": spans * on_span_us / 1e3,
            "traced_off": runs[False], "traced_on": runs[True]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    disabled, on_us = disabled_launch_us(), enabled_span_us()
    out = {"card": card, "torch": torch.__version__, "disabled": disabled,
           "enabled_per_span_us": on_us,
           "headline": headline_pairs(args.pairs, dev),
           "batches": [engine_batches(e, dev, disabled["per_span_us"], on_us)
                       for e in ("fused", "scan")]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
