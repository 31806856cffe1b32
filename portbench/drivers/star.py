"""The star driver: batches of star components (one ``Opt`` broadcaster
against Hawkes walls, BASELINE config 2) run back to back through the
port's star engine, ``simulate_star_batch``, and scored by the mean
time-in-top-1 over each lane's feeds.

Each batch has fresh lane seeds (``drivers.sim.lane_seeds``).  The
window runs from its start to the end of the last batch (a batch that
starts before the deadline is finished and counted), each batch ending
in a device synchronisation; its events are every wall event and every
post.  The lanes of the first batch are all kept, and from every later
batch a sample drawn from the seed and the lane with the most wall
events.  Once the window has closed the reference (``reference.star``)
judges them: the later batches' lanes, at most the mix's
``check_later_max`` of them (``common.later_rows``: past it a sample
drawn from the seed, with the lane of most wall events), then as many of
the first batch's as the run's budget of seconds leaves room for, lane
of most events first.

The record carries the driver name ``"sim"``, so that the simulate
cells' readers (``sim_events_per_s``, ``setup_s``, ``device_idle.sim``)
read it as they are.  A traced run runs one more batch after the window
under the profiler with the program's telemetry on, and keeps its spans,
its counters and, for each device operation, when it was launched."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np

from .. import roofline, roofline_star
from ..common import GcPauses, Record, host_probe_ms, later_rows, rng
from ..reference import star as ref
from ..trace import DeviceTrace, Phases
from .sim import lane_seeds

__all__ = ["Program", "Control", "control", "run", "LaunchTrace",
           "stage_s"]

#: Lanes of the first batch the reference judges at a time.
CHECK_BLOCK = 8
#: Seconds from the process's start within which the check of the first
#: batch's lanes starts its last block (a run then ends under ~90 s).
RUN_BUDGET_S = 80.0

#: The program's spans whose time the per-layer metrics read.
STAGES = ("star.simulate_batch", "star.streams", "star.streams.hawkes",
          "star.fires", "star.metrics", "star.checks")


class Program:
    """The port's timed path: ``presets.config2_hawkes`` built once and
    tiled over the lanes with ``broadcast_star``, each batch one
    ``simulate_star_batch`` and the mean time-in-top-1 of its lanes."""

    def __init__(self, config: Dict, traffic: Dict, device):
        import torch

        import redqueen_tpu_torch as rt
        from redqueen_tpu_torch.parallel.star_types import StarBatchResult

        if "wall_times" not in StarBatchResult._fields:
            raise RuntimeError(
                "this program's StarBatchResult has no wall_times: the "
                "reference cannot check the walls it simulated")
        if float(config["s_sink"]) != 1.0:
            raise ValueError("config2_hawkes weighs every feed 1")
        self.torch, self.rt, self.dev = torch, rt, device
        self.lanes = int(traffic["lanes"])
        self.fire_mode = traffic["fire_mode"]
        self.metric_K = int(traffic["metric_K"])
        self.cfg, self.wall, self.ctrl = self._build(
            config, float(config["end_time"]))

    def _build(self, config, end_time):
        from redqueen_tpu_torch import presets

        F = int(config["followers"])
        _, cfg, wall, ctrl = presets.config2_hawkes(
            scale=F / 1000, end_time=end_time, q=float(config["q"]),
            l0=float(config["l0"]), alpha=float(config["alpha"]),
            beta=float(config["beta"]), wall_cap=int(config["wall_cap"]),
            post_cap=int(config["post_cap"]), device=self.dev)
        if cfg.n_feeds != F:
            raise ValueError(f"config2_hawkes gave {cfg.n_feeds} feeds, "
                             f"not {F}")
        wall, ctrl = self.rt.broadcast_star(wall, ctrl, self.lanes)
        return cfg, wall, ctrl

    def with_end_time(self, config, end_time):
        """The same program at another horizon (for the warm-up)."""
        other = object.__new__(Program)
        other.__dict__.update(self.__dict__)
        other.cfg, other.wall, other.ctrl = self._build(config, end_time)
        return other

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def simulate(self, seeds):
        return self.rt.simulate_star_batch(
            self.cfg, self.wall, self.ctrl, seeds, metric_K=self.metric_K,
            fire_mode=self.fire_mode, device=self.dev)

    @staticmethod
    def score(res):
        return res.metrics.mean_time_in_top_k()

    @staticmethod
    def events(res) -> int:
        return int(res.wall_n.sum()) + int(res.n_posts.sum())

    def keep(self, res, mean, sample):
        """The sampled lanes, the lane with the most wall events first,
        left on the device and cut to the widest feed and the most posts
        among them."""
        torch = self.torch
        top = torch.argmax(res.wall_n.sum(-1))
        idx = torch.as_tensor(np.asarray(sample), device=top.device)
        idx = torch.cat([top[None], idx[idx != top]]).long()
        wn = res.wall_n[idx]
        W, K = int(wn.max()), int(res.n_posts[idx].max())
        return {"lanes": idx, "wall_times": res.wall_times[idx, :, :W],
                "wall_n": wn, "own_times": res.own_times[idx, :K],
                "n_posts": res.n_posts[idx],
                "top": res.metrics.time_in_top_k[idx], "mean": mean[idx]}

    @staticmethod
    def lanes_to_host(kept, rows):
        """Rows ``rows`` of what :meth:`keep` kept, on the host."""
        return {k: v[rows].cpu().numpy() for k, v in kept.items()}

    @staticmethod
    def wall_events(kept):
        """The wall events of each lane :meth:`keep` kept, on the host."""
        return kept["wall_n"].sum(-1).cpu().numpy()

    def totals(self, res):
        """The traced batch's wall events, posts and sources."""
        return {"wall_events": int(res.wall_n.sum()),
                "posts": int(res.n_posts.sum()),
                "sources": int(res.wall_n.numel())}

    @contextlib.contextmanager
    def telemetry(self, into: Dict):
        """The program's telemetry on inside the block; its spans and
        counters into ``into``."""
        from redqueen_tpu_torch.runtime import telemetry

        tel = telemetry.get()
        tel.configure(enabled=True, reset=True)
        try:
            yield
        finally:
            into["spans"] = tel.drain_spans()
            into["counters"] = dict(tel.counters)
            tel.configure(enabled=False, reset=True)

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.dev))

    def release(self):
        self.wall = self.ctrl = None
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


class Control:
    """The reference put in the program's place, every operation rounded
    to ``precision`` (the control runs it in bfloat16).  It simulates the
    lanes it is judged on: a later batch's sample when the batch is kept,
    the first batch's lanes a block at a time when the check asks for
    them (a free run in bfloat16 takes seconds a lane)."""

    def __init__(self, config: Dict, traffic: Dict, precision: str):
        self.star = ref.star_component(config)
        self.precision = precision

    def sync(self):
        pass

    def simulate(self, seeds):
        return np.asarray(seeds)

    @staticmethod
    def score(res):
        return None

    @staticmethod
    def events(res) -> int:
        return 0

    def _run(self, seeds, lanes):
        times, n, own, n_p, top, mean = ref.simulate(
            self.star, seeds[lanes], self.precision)
        return {"lanes": lanes, "wall_times": times.numpy(),
                "wall_n": n.numpy(), "own_times": own.numpy(),
                "n_posts": n_p.numpy(), "top": top.numpy(),
                "mean": mean.numpy()}

    def keep(self, res, mean, sample):
        lanes = np.asarray(sample)
        if len(lanes) < len(res):
            return self._run(res, lanes)
        return {"seeds": res, "lanes": lanes}

    def lanes_to_host(self, kept, rows):
        if "seeds" in kept:
            return self._run(kept["seeds"], kept["lanes"][rows])
        return {k: v[rows] for k, v in kept.items()}

    @staticmethod
    def wall_events(kept):
        return kept["wall_n"].sum(-1)

    def totals(self, res):
        return None

    @contextlib.contextmanager
    def telemetry(self, into: Dict):
        yield

    def memory_peak(self) -> int:
        return 0

    def release(self):
        pass


def control(config: Dict, traffic: Dict, precision: str) -> Control:
    """The control in the program's place, as ``run`` takes it."""
    return Control(config, traffic, precision)


class LaunchTrace(DeviceTrace):
    """The device's activity as :class:`trace.DeviceTrace` records it,
    and for each device operation the start of the host record that
    launched it (by the profiler's correlation id; ``None`` where that
    record is missing)."""

    def __init__(self, device):
        super().__init__(device)
        self.launch = []

    def collect(self):
        from torch.autograd import DeviceType

        host: Dict[int, int] = {}
        corr = []
        for e in self.prof.profiler.kineto_results.events():
            c = int(e.correlation_id())
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                self.device.append((e.name(), s, s + e.duration_ns()))
                corr.append(c)
            elif c:
                host[c] = min(host.get(c, e.start_ns()), e.start_ns())
        self.launch = [host.get(c) for c in corr]
        self.prof = None


def stage_s(spans, trace, name: str) -> float:
    """Seconds the spans called ``name`` held the batch: from each one's
    start to its end or to the end of the last device operation launched
    inside it, whichever is later (a span measures the host's issue, and
    the device may still be running what it issued), summed."""
    known = [i for i, t in enumerate(trace.launch) if t is not None]
    launch = np.array([trace.launch[i] for i in known], np.int64)
    end = np.array([trace.device[i][2] for i in known], np.int64)
    total = 0.0
    for s in spans:
        if s["name"] != name:
            continue
        a = int(s["t_ns"])
        b = a + int(round(float(s["dur"]) * 1e9))
        inside = (launch >= a) & (launch < b)
        last = int(end[inside].max()) if inside.any() else b
        total += (max(b, last) - a) / 1e9
    return total


def _mark(phases, name):
    return phases.mark(name) if phases is not None else \
        contextlib.nullcontext()


def run(ctx) -> Record:
    cfg, tr = ctx.config, ctx.traffic
    system = ctx.system or Program(cfg, tr, ctx.device)
    rec = Record("sim")
    B = int(tr["lanes"])
    star = ref.star_component(cfg)

    # Warm-up: the cell's shapes once, at the traffic's warm-up horizon.
    if isinstance(system, Program):
        warm = system.with_end_time(cfg, float(tr["warmup_end_time"]))
        res = warm.simulate(lane_seeds(ctx.seed, 1 << 20, B))
        mean = warm.score(res)
        warm.lanes_to_host(warm.keep(res, mean, np.arange(2)), [0])
        warm.sync()
        del res, mean, warm

    sim_s, events, kept, seeds_kept = [], [], [], []

    def one_batch(batch, phases=None):
        seeds = lane_seeds(ctx.seed, batch, B)
        sample = np.arange(B) if batch == 0 else rng(ctx.seed, 2, batch) \
            .choice(B, min(int(tr["check_lanes"]), B), replace=False)
        p0 = time.perf_counter()
        with _mark(phases, "simulate"):
            res = system.simulate(seeds)
            mean = system.score(res)
            system.sync()
        p1 = time.perf_counter()
        kept.append(system.keep(res, mean, sample))
        seeds_kept.append(seeds)
        return res, p0, p1

    # The host's pace before and after the window, and the collector's
    # pauses inside it (diagnostics: the cell is bound by the host).
    probe = [host_probe_ms()]
    pauses = GcPauses()
    system.sync()
    t_start = time.perf_counter()
    rec.setup_s = t_start - ctx.t_process
    deadline = t_start + float(ctx.seconds)
    t_end = t_start
    batch = 0
    with pauses:
        while batch == 0 or time.perf_counter() < deadline:
            res, p0, t_end = one_batch(batch)
            events.append(system.events(res))
            sim_s.append(t_end - p0)
            del res
            batch += 1
    system.sync()
    probe.append(host_probe_ms())
    rec.memory_peak_bytes = system.memory_peak()
    rec.attempted = batch * B
    rec.values.update(window_s=t_end - t_start, events=sum(events),
                      batches=batch, simulate_s=sim_s)
    rec.notes.update(simulate_s=[round(x, 4) for x in sim_s],
                     events=events, host_probe_ms=probe, gc=pauses.notes())

    if ctx.trace:
        # One more batch under the profiler and the program's telemetry,
        # after the window, so that their cost stays out of its numbers.
        trace, phases, tel = LaunchTrace(ctx.device), Phases(), {}
        with system.telemetry(tel):
            trace.start()
            res = one_batch(batch, phases)[0]
            trace.stop()
        totals = system.totals(res)
        del res
        trace.collect()
        rec.trace, rec.phases = trace, phases
        rec.spans = tel.get("spans", [])
        counters = tel.get("counters", {})
        rec.values["counters"] = counters
        rec.values["stage_s"] = {n: stage_s(rec.spans, trace, n)
                                 for n in STAGES}
        root = [s for s in rec.spans if s["name"] == "star.simulate_batch"]
        if root and totals:
            a = int(root[0]["t_ns"])
            b = a + int(round(float(root[0]["dur"]) * 1e9))
            w = roofline_star.work(B, **totals)
            rec.values.update(traced_least_s=roofline.least_s(w),
                              traced_batch_device_s=trace.busy_s(a, b))
        rec.notes.update(counters=counters, stage_s={
            k: round(v, 6) for k, v in rec.values["stage_s"].items()})

    # The comparison with the reference, once the window has closed: the
    # later batches' lanes first, at most check_later_max of them, then
    # the first batch's in blocks while the run's budget lasts.
    limits = tr["limits"]
    budget_end = ctx.t_process + RUN_BUDGET_S
    gaps = {"wall_gap": [], "post_gap": [], "metrics_gap": []}
    state = {"lanes": 0, "ties": 0, "flip": 0.0}
    judged = []   # (batch, its lanes judged), in the order judged

    def judge(b, k, seeds, rows):
        got = system.lanes_to_host(k, rows)
        judged.append((b, got["lanes"]))
        s = seeds[np.asarray(got["lanes"])]
        wg, ties, flip = ref.check_walls(star, s, got["wall_times"],
                                         got["wall_n"])
        pg = ref.check_posts(star, s, got["wall_times"], got["wall_n"],
                             got["own_times"], got["n_posts"])
        top, mean = ref.top1(star, got["wall_times"], got["wall_n"],
                             got["own_times"], got["n_posts"])
        mg = np.maximum(
            np.abs(got["top"].astype(np.float64) - top.numpy()).max(-1),
            np.abs(got["mean"].astype(np.float64) - mean.numpy()))
        gaps["wall_gap"].append(wg.numpy())
        gaps["post_gap"].append(pg.numpy())
        gaps["metrics_gap"].append(np.where(np.isnan(mg), np.inf, mg))
        state["lanes"] += len(s)
        state["ties"] += ties
        state["flip"] = max(state["flip"], flip)

    lane_events = [system.wall_events(k) for k in kept[1:]]
    rows = later_rows(lane_events, int(tr["check_later_max"]), ctx.seed)
    for b, r in enumerate(rows, 1):
        if len(r):
            judge(b, kept[b], seeds_kept[b], r)
    later = state["lanes"]
    n_first = len(kept[0]["lanes"])
    done = 0
    while done < n_first and (done == 0 or time.perf_counter() < budget_end):
        judge(0, kept[0], seeds_kept[0], slice(done, done + CHECK_BLOCK))
        done += CHECK_BLOCK
    check_s = time.perf_counter() - t_end
    system.release()
    for name, g in gaps.items():
        rec.check(name, float(np.concatenate(g).max()), limits)
    rec.values.update(checked_lanes=state["lanes"], judged=judged)
    rec.notes.update(checked_lanes=state["lanes"],
                     later_lanes_seen=sum(map(len, lane_events)),
                     later_lanes_judged=later,
                     check_s=round(check_s, 3),
                     first_batch_checked=min(done, n_first),
                     tied_proposals=state["ties"],
                     flip_margin=state["flip"])
    return rec
