"""The simulate-and-score driver: batches of independent components run
back to back through ``simulate_batch`` and the metrics pass.

Each batch has fresh lane seeds drawn from the run's seed and the batch
index.  The window runs from its start to the end of the last batch (a
batch that starts before the deadline is finished and counted), each
batch ending in a device synchronisation.  Every lane of the first
batch is kept, and from every later batch a sample of lanes drawn from
the seed and the lane with the most events; once the window has closed
the reference judges them (see ``reference.sim``): the first batch's
lanes all, and at most the mix's ``check_later_max`` of the later
batches' (``common.later_rows``: past it a sample drawn from the seed,
with the lane of most events)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np

from .. import roofline
from ..common import Record, later_rows, rng, seed_words
from ..reference import sim as ref
from ..trace import DeviceTrace, Phases

__all__ = ["Program", "Control", "control", "run", "lane_seeds"]

#: A log's route, as the program names it, and the draws it makes.
ROUTE_DRAWS = {"cuda": "fused", "plain": "fused", "scan": "scan"}


def lane_seeds(seed: int, batch: int, lanes: int) -> np.ndarray:
    """The integer seeds of a batch's lanes: consecutive from a base word
    drawn for (run seed, batch)."""
    base = int(seed_words(seed, 1, batch)[0])
    return (base + np.arange(lanes, dtype=np.int64)) % 2 ** 32


class Program:
    """The port's timed path: ``simulate_batch`` on the card, then
    ``feed_metrics_batch`` and ``num_posts`` of the tracked row."""

    def __init__(self, config: Dict, traffic: Dict, device):
        import torch

        import redqueen_tpu_torch as rt

        self.torch, self.rt, self.dev = torch, rt, device
        self.engine = traffic["engine"]
        self.lanes = int(traffic["lanes"])
        F, T = int(config["followers"]), float(config["end_time"])
        self.capacity, self.max_chunks = rt.shape_budget(
            F, T, float(config["wall_rate"]))
        self.cfg, self.params, self.adj, self.opt = self._build(config, T)

    def _build(self, config, end_time):
        rt = self.rt
        F = int(config["followers"])
        gb = rt.GraphBuilder(n_sinks=F, end_time=end_time)
        opt = gb.add_opt(q=float(config["q"]))
        for f in range(F):
            gb.add_poisson(rate=float(config["wall_rate"]), sinks=[f])
        cfg, p0, a0 = gb.build(capacity=self.capacity, device=self.dev)
        params, adj = rt.stack_components([p0] * self.lanes,
                                          [a0] * self.lanes)
        return cfg, params, adj, opt

    def with_end_time(self, config, end_time):
        """The same program at another horizon (for the warm-up)."""
        other = object.__new__(Program)
        other.__dict__.update(self.__dict__)
        other.cfg, other.params, other.adj, other.opt = self._build(
            config, end_time)
        return other

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def simulate(self, seeds):
        return self.rt.simulate_batch(
            self.cfg, self.params, self.adj, seeds,
            max_chunks=self.max_chunks, engine=self.engine, device=self.dev)

    def score(self, log):
        m = self.rt.feed_metrics_batch(log.times, log.srcs, self.adj,
                                       self.opt, self.cfg.end_time)
        return m.mean_time_in_top_k(), self.rt.num_posts(log.srcs, self.opt)

    @staticmethod
    def route(log) -> str:
        return log.engine

    def events(self, log) -> int:
        return int(log.n_events.sum())

    def columns(self, log) -> int:
        return int(log.times.shape[1])

    def keep(self, log, top, posts, sample):
        """The rows of the sampled lanes and of the lane with the most
        events, left on the device: ``(lanes, times, srcs, nev, top1,
        posts)``."""
        torch = self.torch
        idx = torch.cat([torch.as_tensor(sample, device=log.times.device),
                         torch.argmax(log.n_events)[None].long()])
        return (idx, log.times[idx], log.srcs[idx], log.n_events[idx],
                top[idx], posts[idx])

    def source_counts(self, log):
        s = log.srcs.reshape(-1).long()
        return self.torch.bincount(
            s[s >= 0], minlength=int(self.params.kind.shape[1])).cpu().numpy()

    def sick_lanes(self, log) -> int:
        return int((log.health != 0).sum())

    @staticmethod
    def to_host(kept):
        return tuple(x.cpu().numpy() for x in kept)

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.dev))

    def release(self):
        self.params = self.adj = None
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


class Control:
    """The reference put in the program's place, every operation rounded
    to ``precision`` (the control runs it in bfloat16): it simulates the
    whole batch free and scores it itself."""

    def __init__(self, config: Dict, traffic: Dict, precision: str):
        self.comp = ref.headline_component(config)
        self.lanes = int(traffic["lanes"])
        self.route_name = traffic["route"]
        self.draws = ROUTE_DRAWS[self.route_name]
        self.precision = precision
        self.max_events = int(traffic["control_max_events"])

    def sync(self):
        pass

    def simulate(self, seeds):
        times, srcs, nev = ref.simulate(
            self.comp, ref.draws_for(self.draws, seeds, self.comp.S),
            len(seeds), self.precision, self.max_events)
        return times, srcs, nev

    def score(self, log):
        return ref.feed_metrics(self.comp, *log, self.precision)

    def route(self, log) -> str:
        return self.route_name

    def events(self, log) -> int:
        return int(log[2].sum())

    def columns(self, log) -> int:
        return int(log[0].shape[1])

    def keep(self, log, top, posts, sample):
        times, srcs, nev = log
        idx = np.concatenate([np.asarray(sample), [int(np.argmax(nev))]])
        return idx, times[idx], srcs[idx], nev[idx], top[idx], posts[idx]

    def sick_lanes(self, log) -> int:
        return 0

    @staticmethod
    def to_host(kept):
        return kept

    def memory_peak(self) -> int:
        return 0

    def release(self):
        pass


def control(config: Dict, traffic: Dict, precision: str) -> Control:
    """The control in the program's place, as ``run`` takes it."""
    return Control(config, traffic, precision)


def _mark(phases, name):
    return phases.mark(name) if phases is not None else \
        contextlib.nullcontext()


def _pad(rows, width, fill, dtype):
    out = np.full((len(rows), width), fill, dtype)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def run(ctx) -> Record:
    cfg, tr = ctx.config, ctx.traffic
    system = ctx.system or Program(cfg, tr, ctx.device)
    rec = Record("sim")
    B = int(tr["lanes"])
    n_sample = int(tr["check_lanes"])
    comp = ref.headline_component(cfg)

    # Warm-up: the cell's shapes once, at the traffic's warm-up horizon.
    warm_T = float(tr.get("warmup_end_time", cfg["end_time"]))
    if warm_T > 0 and isinstance(system, Program):
        warm = system if warm_T == float(cfg["end_time"]) else \
            system.with_end_time(cfg, warm_T)
        log = warm.simulate(lane_seeds(ctx.seed, 1 << 20, B))
        top, posts = warm.score(log)
        warm.to_host(warm.keep(log, top, posts, np.arange(2)))
        warm.sync()
        del log, top, posts, warm

    sim_s, met_s, cols, events, kept, seeds_kept = [], [], [], [], [], []
    routes, sick = [], 0

    def one_batch(batch, phases=None):
        seeds = lane_seeds(ctx.seed, batch, B)
        sample = np.arange(B) if batch == 0 else rng(ctx.seed, 2, batch) \
            .choice(B, min(n_sample, B), replace=False)
        p0 = time.perf_counter()
        with _mark(phases, "simulate"):
            log = system.simulate(seeds)
            system.sync()
        p1 = time.perf_counter()
        with _mark(phases, "metrics_pass"):
            top, posts = system.score(log)
            system.sync()
        p2 = time.perf_counter()
        kept.append(system.keep(log, top, posts, sample))
        seeds_kept.append(seeds)
        routes.append(system.route(log))
        return log, p0, p1, p2

    system.sync()
    t_start = time.perf_counter()
    rec.setup_s = t_start - ctx.t_process
    deadline = t_start + float(ctx.seconds)
    t_end = t_start
    batch = 0
    while batch == 0 or time.perf_counter() < deadline:
        log, p0, p1, t_end = one_batch(batch)
        events.append(system.events(log))
        cols.append(system.columns(log))
        sick += system.sick_lanes(log)
        sim_s.append(p1 - p0)
        met_s.append(t_end - p1)
        del log
        batch += 1
    system.sync()
    window_s = t_end - t_start
    rec.memory_peak_bytes = system.memory_peak()
    rec.attempted = batch * B
    rec.failed = sick
    rec.values.update(window_s=window_s, events=sum(events),
                      batches=batch, simulate_s=sim_s, metrics_s=met_s,
                      columns=cols)
    rec.notes.update(simulate_s=[round(x, 4) for x in sim_s],
                     metrics_s=[round(x, 4) for x in met_s],
                     columns=cols)

    if ctx.trace:
        # One more batch under the profiler, after the window, so that
        # the profiler's cost stays out of the window's numbers.
        trace, phases = DeviceTrace(ctx.device), Phases()
        trace.start()
        log = one_batch(batch, phases)[0]
        trace.stop()
        counts = system.source_counts(log)
        del log
        trace.collect()
        rec.trace, rec.phases = trace, phases
        sim_phase = next(p for p in phases.spans if p[0] == "simulate")
        w = roofline.work(comp.kind == ref.OPT, comp.adj, counts, B)
        rec.values.update(
            traced_least_s=roofline.least_s(w),
            traced_simulate_device_s=trace.busy_s(sim_phase[1],
                                                  sim_phase[2]))
    kept = [system.to_host(k) for k in kept]
    system.release()
    rows = later_rows([k[3] for k in kept[1:]],
                      int(tr["check_later_max"]), ctx.seed)
    rec.values["judged"] = [(b, k[0][r]) for b, (k, r)
                            in enumerate(zip(kept[1:], rows), 1)]
    rec.notes.update(later_lanes_seen=sum(len(k[0]) for k in kept[1:]),
                     later_lanes_judged=sum(map(len, rows)))
    kept[1:] = [tuple(x[r] for x in k) for k, r in zip(kept[1:], rows)]

    # The comparison with the reference, once the window has closed.  It
    # makes the draws of the engine the cell names, so a batch that went
    # another route shows as gaps.
    limits = tr["limits"]
    rec.notes["routes"] = sorted(set(routes))
    draws = ROUTE_DRAWS[tr["route"]]
    lanes = np.concatenate([s[k[0]] for s, k in zip(seeds_kept, kept)])
    width = max(k[1].shape[1] for k in kept)
    times = _pad([r for k in kept for r in k[1]], width, np.inf, np.float64)
    srcs = _pad([r for k in kept for r in k[2]], width, -1, np.int64)
    nev = np.concatenate([k[3] for k in kept]).astype(np.int64)
    top1 = np.concatenate([k[4] for k in kept]).astype(np.float64)
    posts = np.concatenate([k[5] for k in kept]).astype(np.float64)
    gap = ref.check_events(comp, ref.draws_for(draws, lanes, comp.S),
                           times, srcs, nev)
    if any(r != tr["route"] for r in routes):
        gap = np.full_like(gap, np.inf)
    r_top1, r_posts = ref.feed_metrics(comp, times, srcs, nev)
    rec.check("event_gap", float(gap.max()), limits)
    rec.check("metrics_gap", float(np.max(np.maximum(
        np.abs(top1 - r_top1), np.abs(posts - r_posts)))), limits)
    rec.values["checked_lanes"] = int(len(nev))
    rec.notes.update(checked_lanes=int(len(nev)),
                     check_s=round(time.perf_counter() - t_end, 3))
    return rec
