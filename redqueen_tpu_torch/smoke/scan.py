"""Phase 6 of the smoke run: the scan engine on the card (the headline at
full width, the same code on card and CPU, resume, ``max_events`` and
``engine="auto"``)."""

import dataclasses
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch import device as rt_device
from redqueen_tpu_torch.ops import kernels
from .common import check, sync
from .fused import HEADLINE_B, bits, headline_component


# (b): lanes of the headline and of the every-kind mix run on the card and
# on the CPU.
SCAN_CROSS_B = {"headline": 256, "mix": 64}
# (b): times agree within this on identical lanes; a lane whose first
# difference has its two times within it diverged at a near-tie, and such
# lanes may be at most NEAR_TIE_MAX_SHARE of the batch.
NEAR_TIE_RTOL = 1e-5
NEAR_TIE_MAX_SHARE = 0.02


class HostSyncTimer:
    """Counts the scan engine's host syncs (``device.host_read``, where
    the host waits for the card) and the seconds spent in them."""

    def __enter__(self):
        self.n, self.seconds = 0, 0.0
        self._read = rt_device.host_read

        def timed_read(x):
            t0 = time.perf_counter()
            try:
                return self._read(x)
            finally:
                self.n += 1
                self.seconds += time.perf_counter() - t0

        rt_device.host_read = timed_read
        return self

    def __exit__(self, *exc):
        rt_device.host_read = self._read


def scan_mix_component(B, device):
    """Every non-neural kind: the full mix of phase 4 with a second Opt
    row on feeds 1 and 3."""
    gb = rt.GraphBuilder(n_sinks=5, end_time=15.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])
    gb.add_opt(q=0.5, sinks=[1, 3])
    cfg, p0, a0 = gb.build(capacity=64, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def scan_run(cfg, params, adj, seeds, mc, dev, **kw):
    return rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                             sync_every=8, engine="scan", device=dev, **kw)


def scan_headline(dev, B, T, fused):
    """(a) The headline through the scan engine; ``fused`` is phase 5's
    (mean, std, lanes) of time-in-top-1.  Returns the result and
    the run's (cfg, params, adj, opt, max_chunks, seeds, log)."""
    cfg, params, adj, opt, mc = headline_component(B, T, dev)
    seeds = np.arange(B)
    warm = dataclasses.replace(cfg, end_time=2.0)
    scan_run(warm, params, adj, seeds, mc, dev)
    sync(dev)
    kernels.reset_launch_counts()
    with HostSyncTimer() as syncs:
        t0 = time.perf_counter()
        log = scan_run(cfg, params, adj, seeds, mc, dev)
        sync(dev)
        t1 = time.perf_counter()
    m = rt.feed_metrics_batch(log.times, log.srcs, adj, opt, cfg.end_time)
    top1 = m.mean_time_in_top_k()
    posts = rt.num_posts(log.srcs, opt)
    sync(dev)
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    sim_s, met_s = t1 - t0, t2 - t1
    check(log.engine == "scan" and log.engine_reason is None,
          f"engine {log.engine!r} ({log.engine_reason}), expected 'scan'")
    check(launches["event_kernel"] == 0,
          f"the scan path launched the event kernel "
          f"{launches['event_kernel']} times")
    check(bool((log.health == 0).all()), "sick lanes in the scan headline")
    nev = log.n_events
    events = int(nev.sum())
    check(events == int((log.srcs >= 0).sum()), "n_events vs log")
    top1_h = top1.double().cpu().numpy()
    check(np.isfinite(top1_h).all() and (top1_h >= 0).all()
          and (top1_h <= T).all(), "time-in-top-1 outside [0, T]")
    walls = torch.stack([(log.srcs == w).sum(-1) for w in range(1, 11)], 1)
    wall = walls.double().cpu().numpy().reshape(-1)
    w_se = wall.std() / np.sqrt(wall.size)
    check(abs(wall.mean() - T) < 4 * w_se,
          f"scan: mean events per Poisson wall {wall.mean():.3f} is not "
          f"{T} within 4 sigma ({4 * w_se:.3f})")
    f_mean, f_std, f_lanes = fused
    se = np.sqrt(top1_h.var() / B + f_std ** 2 / f_lanes)
    diff = top1_h.mean() - f_mean
    check(abs(diff) < 4 * se,
          f"scan mean time-in-top-1 {top1_h.mean():.4f} vs fused "
          f"{f_mean:.4f}: {diff:+.4f} beyond 4 sigma ({4 * se:.4f})")
    steps = int(log.times.shape[1])
    res = {
        "B": B, "T": T, "capacity": cfg.capacity, "sync_every": 8,
        "events": events, "simulate_s": sim_s, "metrics_s": met_s,
        "events_per_s": events / (sim_s + met_s),
        "events_per_s_simulate_only": events / sim_s,
        "dispatches": log.dispatches, "steps": steps,
        "ms_per_step": sim_s / steps * 1e3,
        "host_syncs": syncs.n, "host_sync_s": syncs.seconds,
        "host_sync_share": syncs.seconds / sim_s,
        "steps_share": 1.0 - syncs.seconds / sim_s,
        "launches": launches, "mean_top1": float(top1_h.mean()),
        "std_top1": float(top1_h.std()), "fused_mean_top1": f_mean,
        "top1_diff": float(diff), "top1_4se": float(4 * se),
        "posts_per_lane": float(posts.double().mean()),
        "wall_mean_events": float(wall.mean()), "wall_4se": float(4 * w_se),
    }
    print(f"phase 6 (a) scan headline: B={B} T={T} capacity={cfg.capacity} "
          f"sync_every=8: {events} events; simulate {sim_s:.3f} s = "
          f"{events / sim_s:,.0f} events/s, with metrics "
          f"{events / (sim_s + met_s):,.0f} events/s; {steps} steps at "
          f"{res['ms_per_step']:.3f} ms; dispatches {log.dispatches}; "
          f"{syncs.n} host syncs took {syncs.seconds:.3f} s "
          f"({100 * res['host_sync_share']:.1f}% of simulate); event-kernel "
          f"launches {launches['event_kernel']}; mean time-in-top-1 "
          f"{top1_h.mean():.4f} vs fused {f_mean:.4f} ({diff:+.4f}, 4 sigma "
          f"{4 * se:.4f}); mean events per wall {wall.mean():.3f}")
    return res, (cfg, params, adj, opt, mc, seeds, log)


def first_difference(a, b):
    """Per lane of two [B, E] tensors: whether they differ and the first
    index where they do (0 where they do not)."""
    d = a != b
    return d.any(1), torch.argmax(d.to(torch.int8), 1)


def padded(log, E):
    """``(times, srcs)`` of a log on the host, padded with (+inf, -1) to E
    columns."""
    t, s = log.times.cpu(), log.srcs.cpu()
    pad = E - t.shape[1]
    if pad:
        t = torch.cat([t, torch.full((t.shape[0], pad), float("inf"))], 1)
        s = torch.cat([s, torch.full((s.shape[0], pad), -1,
                                     dtype=s.dtype)], 1)
    return t, s


def compare_devices(label, card, cpu, end_time, tag="phase 6 (b)"):
    """(b) A scan run on the card against the same run on the CPU."""
    E = max(card.times.shape[1], cpu.times.shape[1])
    tc, sc = padded(card, E)
    tp, sp = padded(cpu, E)
    B = tc.shape[0]
    differs, j = first_difference(sc, sp)
    differs |= card.n_events.cpu() != cpu.n_events.cpu()
    a = tc.double().gather(1, j[:, None])[:, 0]
    b = tp.double().gather(1, j[:, None])[:, 0]
    close = (a - b).abs() <= NEAR_TIE_RTOL * b.abs()
    # A tie with the horizon: one side's event fell just past it.
    at_end = ((torch.isinf(a) & ((b - end_time).abs()
                                 <= NEAR_TIE_RTOL * end_time))
              | (torch.isinf(b) & ((a - end_time).abs()
                                   <= NEAR_TIE_RTOL * end_time)))
    near = differs & (close | at_end)
    n_near, n_far = int(near.sum()), int((differs & ~near).sum())
    same = ~differs
    fin = torch.isfinite(tp) & same[:, None]
    rel = ((tc.double() - tp.double()).abs()
           / tp.double().abs().clamp(min=1e-30))[fin]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    print(f"{tag} {label} card vs CPU: B={B}, lanes differing "
          f"{int(differs.sum())} (near-ties {n_near}, others {n_far}), "
          f"max rel |dt| on identical lanes {max_rel:.3g}, events "
          f"{int(card.n_events.sum())}/{int(cpu.n_events.sum())}")
    check(n_far == 0, f"(b) {label}: {n_far} lanes differ from the CPU run "
                      f"at other than a near-tie")
    check(n_near <= NEAR_TIE_MAX_SHARE * B,
          f"(b) {label}: {n_near} near-tie lanes of {B}, more than "
          f"{NEAR_TIE_MAX_SHARE:.0%}")
    check(max_rel <= NEAR_TIE_RTOL,
          f"(b) {label}: times differ by rel {max_rel:.3g} > "
          f"{NEAR_TIE_RTOL} on identical lanes")
    return {"lanes": B, "lanes_differing": int(differs.sum()),
            "near_ties": n_near, "max_rel_err": max_rel,
            "events_card": int(card.n_events.sum()),
            "events_cpu": int(cpu.n_events.sum())}


def scan_cross(key, B, dev):
    """(b) for one mix: the same batch on ``dev`` and on the CPU."""
    if key == "headline":
        cfg, params, adj, _, mc = headline_component(B, 100.0, dev)
    else:
        cfg, params, adj, mc = scan_mix_component(B, dev)
    seeds = np.arange(B)
    card = scan_run(cfg, params, adj, seeds, mc, dev)
    cpu = scan_run(cfg, params.to("cpu"), adj.cpu(), seeds, mc, "cpu")
    return compare_devices(key, card, cpu, cfg.end_time)


def joined(first, second):
    """The valid events of two logs of the same lanes, one after the
    other, as [B, E] tensors on the host."""
    n1 = first.n_events.cpu().long()[:, None]
    n = n1 + second.n_events.cpu().long()[:, None]
    E = max(int(n.max()), 1)
    p = torch.arange(E)[None, :]
    t1, s1 = padded(first, max(E, first.times.shape[1]))
    t2, s2 = padded(second, max(E, second.times.shape[1]))
    i2 = torch.clamp(p - n1, min=0)
    t = torch.where(p < n1, t1[:, :E], t2.gather(1, i2))
    s = torch.where(p < n1, s1[:, :E], s2.gather(1, i2))
    valid = p < n
    return (torch.where(valid, t, torch.full_like(t, float("inf"))),
            torch.where(valid, s, torch.full_like(s, -1)), n[:, 0])


def same_prefix(label, t, s, n, ref):
    """Check that [B, E] host tensors (t, s) with n events per lane are
    the log ``ref`` bit for bit: equal counts, equal entries, and nothing
    in ``ref`` past them."""
    E = t.shape[1]
    tr, sr = padded(ref, max(E, ref.times.shape[1]))
    n_bad = int(((n != ref.n_events.cpu().long())
                 | (sr[:, :E] != s).any(1)
                 | (bits(tr[:, :E]) != bits(t)).any(1)
                 | (sr[:, E:] != -1).any(1)).sum())
    check(n_bad == 0, f"{label}: {n_bad} lanes differ from the reference "
                      f"log")
    return n_bad


def scan_resume(ctx, dev):
    """(c) T/2 with return_state, then resume to T, against the
    continuous run."""
    cfg, params, adj, _, mc, seeds, cont = ctx
    half = dataclasses.replace(cfg, end_time=cfg.end_time / 2)
    log1, state = scan_run(half, params, adj, seeds, mc, dev,
                           return_state=True)
    log2, _ = rt.resume(cfg, params, adj, state, max_chunks=mc)
    t, s, n = joined(log1, log2)
    n_bad = same_prefix("(c) resume", t, s, n, cont)
    B = len(seeds)
    print(f"phase 6 (c) resume: T={half.end_time} then {cfg.end_time}: "
          f"{int(log1.n_events.sum())} + {int(log2.n_events.sum())} "
          f"events, lanes not bit-identical to the continuous run "
          f"{n_bad} of {B}")
    return {"lanes": B, "lanes_differing": n_bad,
            "events_first": int(log1.n_events.sum()),
            "events_resumed": int(log2.n_events.sum())}


def scan_max_events(ctx, dev):
    """(d) A budget per lane, drawn in [0, its unbounded count]."""
    cfg, params, adj, _, mc, seeds, full = ctx
    n_full = full.n_events.cpu().numpy()
    rng = np.random.RandomState(6)
    budget = (rng.uniform(0, 1, n_full.size) * (n_full + 1)).astype(np.int64)
    log = scan_run(cfg, params, adj, seeds, mc, dev, max_events=budget)
    n = log.n_events.cpu().long()
    check(bool((n == torch.from_numpy(budget)).all()),
          f"(d) max_events: {int((n != torch.from_numpy(budget)).sum())} "
          f"lanes did not stop at their budget")
    E = max(int(n.max()), 1)
    t, s = padded(log, max(E, log.times.shape[1]))
    check(bool((s[:, E:] == -1).all()), "(d) events past the budget")
    tf, sf = padded(full, max(E, full.times.shape[1]))
    p = torch.arange(E)[None, :]
    inside = p < n[:, None]
    n_bad = int((inside & ((s[:, :E] != sf[:, :E])
                           | (bits(t[:, :E]) != bits(tf[:, :E])))).any(1)
                .sum())
    check(n_bad == 0, f"(d) max_events: {n_bad} lanes are not a prefix of "
                      f"the unbounded run")
    print(f"phase 6 (d) max_events: {len(budget)} lanes stopped at exactly "
          f"their budgets ({int(budget.sum())} events), every log a prefix "
          f"of the unbounded run; dispatches {log.dispatches}")
    return {"lanes": len(budget), "events": int(budget.sum()),
            "lanes_not_prefix": n_bad, "dispatches": log.dispatches}


def scan_auto(ctx, dev):
    """(e) ``engine="auto"``: the kernel for the headline on the card,
    the scan engine with its reason when ``max_events`` is given."""
    cfg, params, adj, _, mc, seeds, _ = ctx
    want = "cuda" if torch.device(dev).type == "cuda" else "scan"
    kernels.reset_launch_counts()
    log = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                            engine="auto", device=dev)
    launches = kernels.LAUNCHES["event_kernel"]
    check(log.engine == want, f"(e) auto ran {log.engine!r} "
                              f"({log.engine_reason}), expected {want!r}")
    if want == "cuda":
        check(launches == log.dispatches > 0 and log.engine_reason is None,
              f"(e) auto: {launches} launches, {log.dispatches} "
              f"dispatches, reason {log.engine_reason!r}")
    bounded = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                                engine="auto", max_events=5, device=dev)
    reason = bounded.engine_reason or ""
    check(bounded.engine == "scan" and "max_events" in reason,
          f"(e) auto with max_events ran {bounded.engine!r} ({reason!r})")
    check(bool((bounded.n_events == 5).all()), "(e) max_events=5 counts")
    print(f"phase 6 (e) auto: headline on {log.engine!r} ({launches} "
          f"event-kernel launches); with max_events on "
          f"{bounded.engine!r}: {reason}")
    return {"headline_engine": log.engine, "launches": launches,
            "bounded_engine": bounded.engine, "bounded_reason": reason}


def phase_scan(dev, fused):
    """Phase 6; ``fused`` is phase 5's (mean, std, lanes) of
    time-in-top-1."""
    t0 = time.perf_counter()
    res = {}
    res["headline"], ctx = scan_headline(dev, HEADLINE_B, 100.0, fused)
    res["cross"] = {key: scan_cross(key, B, dev)
                    for key, B in SCAN_CROSS_B.items()}
    res["resume"] = scan_resume(ctx, dev)
    res["max_events"] = scan_max_events(ctx, dev)
    res["auto"] = scan_auto(ctx, dev)
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 6 scan engine: {res['phase_s']:.1f} s")
    return res
