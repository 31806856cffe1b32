"""Phase 7 of the smoke run: the BASELINE presets and the star engine at
``benchmarks/run.py``'s full settings, and the power-law ragged lanes."""

import os
import shutil
import tempfile
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import kernels
from .common import check, sync
from .fused import bits
from .scan import NEAR_TIE_RTOL


# benchmarks/run.py's _FULL settings for configs 1-4 and its seeds: 1,024
# seeds for config 1, lanes 0..999 for config 3, 4 seeds for the star
# configs 2 and 4.
PRESET_FULL = {
    1: dict(scale=1.0, end_time=100.0),
    2: dict(scale=1.0, end_time=100.0, wall_cap=1024, post_cap=8192),
    3: dict(scale=1.0, end_time=100.0),
    4: dict(scale=1.0, end_time=100.0, q=2500.0, post_cap=4096),
}
PRESET_SEEDS = {1: np.arange(1024), 2: np.arange(4), 3: 0, 4: np.arange(4)}
# (c): the star presets at a small scale (config 4's q scaled with its
# feeds), card against CPU, one simulate_star per seed.
STAR_CROSS = {
    2: dict(scale=0.02, end_time=100.0, wall_cap=1024, post_cap=8192),
    4: dict(scale=0.001, end_time=100.0, q=2.5, post_cap=4096),
}
STAR_CROSS_SEEDS = (0, 1)
# (f): power-law ragged lanes through the event kernel.  Bucket widths
# are powers of two and a component has width + 1 sources, so the
# kernel's MAX_S = 32 admits followers up to 16 (31 would make a width-32
# bucket of 33 sources).
POWER_LAW_FUSED = dict(B=10_000, max_followers=16, end_time=100.0)
# (g): the default widths (up to 1,024 followers) through the scan
# engine, B and T cut: a hub lane at full T would take ~10^5 steps.
POWER_LAW_SCAN = dict(B=512, end_time=2.0)
# (c): at most this share of a star run's feeds may have a wall stream
# that left the CPU's at a thinning near-tie.
STAR_NEAR_TIE_MAX_SHARE = 0.02
ENV_AUTOTUNE = "RQ_LANES_AUTOTUNE"


class StageTimer:
    """Seconds spent in each stage of the star kernel with an Opt
    broadcaster (``star_run``'s wall streams, fires and metrics), each
    bracketed by device syncs; restores the stages on exit."""

    STAGES = {"streams": "_wall_streams", "fires": "_opt_fires",
              "metrics": "_feed_metrics_star"}

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        from redqueen_tpu_torch.parallel import star_run

        self._mod = star_run
        self.seconds = {k: 0.0 for k in self.STAGES}
        self._orig = {n: getattr(star_run, n) for n in self.STAGES.values()}
        for k, n in self.STAGES.items():
            setattr(star_run, n, self._wrap(k, self._orig[n]))
        return self

    def _wrap(self, stage, fn):
        def timed_stage(*a, **kw):
            sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.dev)
            self.seconds[stage] += time.perf_counter() - t0
            return out
        return timed_stage

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._mod, n, fn)


def timed_preset(which, kw, seeds, dev, stages=False, **run_kw):
    """Build preset ``which`` on ``dev`` and run it once through
    ``run_preset``: ``(out, build_s, run_s, stage seconds or None)``."""
    from redqueen_tpu_torch.presets import build_preset, run_preset

    t0 = time.perf_counter()
    bundle = build_preset(which, device=dev, **kw)
    sync(dev)
    t1 = time.perf_counter()
    timer = StageTimer(dev) if stages else None
    if timer is not None:
        timer.__enter__()
    try:
        out = run_preset(bundle, seeds, device=dev, **run_kw)
        sync(dev)
    finally:
        if timer is not None:
            timer.__exit__(None, None, None)
    t2 = time.perf_counter()
    check(out["events"] > 0 and np.isfinite(out["per_seed_top_k"]).all(),
          f"config {which}: no events or non-finite time-in-top-1")
    top = np.asarray(out["per_seed_top_k"])
    check(((top >= 0) & (top <= out["end_time"])).all(),
          f"config {which}: time-in-top-1 outside [0, T]")
    return (out, bundle, t1 - t0, t2 - t1,
            None if timer is None else timer.seconds)


def preset_batch(dev, fused, full=PRESET_FULL):
    """(a) config 1 at its 1,024 seeds against phase 5's fused mean
    within 4 sigma; (b) config 3, whose lanes are config 1's component at
    seeds 0..999: per seed bit for bit config 1's first lanes."""
    out1, _, b1, s1, _ = timed_preset(1, full[1], PRESET_SEEDS[1], dev)
    top1 = np.asarray(out1["per_seed_top_k"])
    f_mean, f_std, f_lanes = fused
    se = np.sqrt(top1.var() / top1.size + f_std ** 2 / f_lanes)
    diff = top1.mean() - f_mean
    check(abs(diff) < 4 * se,
          f"(a) config 1 mean time-in-top-1 {top1.mean():.4f} vs fused "
          f"{f_mean:.4f}: {diff:+.4f} beyond 4 sigma ({4 * se:.4f})")
    out3, _, b3, s3, _ = timed_preset(3, full[3], PRESET_SEEDS[3], dev)
    n3 = len(out3["per_seed_top_k"])
    n_bad = int(sum(
        a != b or c != d for a, b, c, d in zip(
            out3["per_seed_top_k"], out1["per_seed_top_k"][:n3],
            out3["per_seed_posts"], out1["per_seed_posts"][:n3])))
    check(n_bad == 0, f"(b) config 3: {n_bad} of {n3} lanes differ from "
                      f"config 1 at the same seed")
    res = {
        "config1": {"seeds": top1.size, "events": out1["events"],
                    "build_s": b1, "run_s": s1,
                    "events_per_s": out1["events"] / s1,
                    "mean_top1": float(top1.mean()),
                    "std_top1": float(top1.std()),
                    "mean_posts": out1["mean_posts"],
                    "fused_mean_top1": f_mean, "top1_diff": float(diff),
                    "top1_4se": float(4 * se)},
        "config3": {"lanes": n3, "events": out3["events"], "build_s": b3,
                    "run_s": s3, "events_per_s": out3["events"] / s3,
                    "mean_top1": out3["mean_time_in_top_k"],
                    "lanes_differing_from_config1": n_bad},
    }
    for key, which in (("config1", 1), ("config3", 3)):
        r = res[key]
        print(f"phase 7 ({'a' if which == 1 else 'b'}) config {which}: "
              f"{r['events']} events in {r['run_s']:.3f} s = "
              f"{r['events_per_s']:,.0f} events/s (scan engine, build "
              f"{r['build_s']:.3f} s); mean time-in-top-1 "
              f"{r['mean_top1']:.4f}")
    print(f"  config 1 against phase 5's fused mean {f_mean:.4f}: "
          f"{diff:+.4f} (4 sigma {4 * se:.4f}); config 3 lanes differing "
          f"from config 1's at the same seed: {n_bad} of {n3}")
    return res


def star_feed_divergence(card, cpu):
    """Per feed of two ``StarResult``s of the same seed: whether the wall
    streams differ (count or times beyond rtol 1e-5)."""
    wc, wp = card.wall_times.cpu().double(), cpu.wall_times.double()
    fin = torch.isfinite(wp)
    close = torch.where(fin, (wc - wp).abs() <= NEAR_TIE_RTOL * wp.abs(),
                        ~torch.isfinite(wc))
    return ~close.all(1) | (card.wall_n.cpu() != cpu.wall_n)


def star_cross(which, kw, dev, seeds=STAR_CROSS_SEEDS):
    """(c) a star preset at a small scale on the card and on the CPU, the
    same port code: wall streams identical but for thinning near-ties (at
    most STAR_NEAR_TIE_MAX_SHARE of the feeds, counted); where no feed
    differs, the posts within rtol 1e-5 and the mean time-in-top-1 within
    rtol 1e-4."""
    from redqueen_tpu_torch.presets import build_preset

    _, cfg, wall, ctrl = build_preset(which, device="cpu", **kw)
    n_feeds_diff, lanes_posts_checked, max_rel, max_top_rel = 0, 0, 0.0, 0.0
    for s in seeds:
        card = rt.simulate_star(cfg, wall.to(dev), ctrl.to(dev), seed=s,
                                device=dev)
        cpu = rt.simulate_star(cfg, wall, ctrl, seed=s, device="cpu")
        diverged = star_feed_divergence(card, cpu)
        n_feeds_diff += int(diverged.sum())
        if diverged.any():
            continue
        lanes_posts_checked += 1
        oc, op = card.own_times.cpu().double(), cpu.own_times.double()
        check(torch.equal(torch.isfinite(oc), torch.isfinite(op)),
              f"(c) config {which} seed {s}: {card.n_posts} posts on the "
              f"card, {cpu.n_posts} on the CPU")
        fin = torch.isfinite(op)
        rel = ((oc - op).abs() / op.abs().clamp(min=1e-30))[fin]
        max_rel = max(max_rel, float(rel.max()) if rel.numel() else 0.0)
        tc = float(card.metrics.mean_time_in_top_k())
        tp = float(cpu.metrics.mean_time_in_top_k())
        max_top_rel = max(max_top_rel, abs(tc - tp) / max(abs(tp), 1e-30))
    n_feeds = cfg.n_feeds * len(seeds)
    check(n_feeds_diff <= STAR_NEAR_TIE_MAX_SHARE * n_feeds,
          f"(c) config {which}: {n_feeds_diff} of {n_feeds} feeds' wall "
          f"streams differ from the CPU's")
    check(max_rel <= NEAR_TIE_RTOL,
          f"(c) config {which}: post times differ by rel {max_rel:.3g}")
    check(max_top_rel <= 1e-4,
          f"(c) config {which}: time-in-top-1 differs by rel "
          f"{max_top_rel:.3g}")
    print(f"phase 7 (c) config {which} at scale {kw['scale']} card vs CPU: "
          f"seeds {list(seeds)}, {cfg.n_feeds} feeds: wall streams differing "
          f"{n_feeds_diff} of {n_feeds}; post times max rel {max_rel:.3g} "
          f"and time-in-top-1 max rel {max_top_rel:.3g} on "
          f"{lanes_posts_checked} lane(s)")
    return {"feeds": n_feeds, "feeds_differing": n_feeds_diff,
            "lanes_compared": lanes_posts_checked, "max_rel_post": max_rel,
            "max_rel_top1": max_top_rel}


def hawkes_mean_count(l0, alpha, beta, T):
    """E[N(T)] of an exponential-kernel Hawkes process started empty: the
    stationary l0*T/(1 - alpha/beta) of
    tests/test_bigf.py::TestStreams::test_hawkes_count_closed_form, less
    its start-up transient."""
    n = alpha / beta
    return (l0 * T / (1 - n)
            - l0 * n * (1 - np.exp(-(beta - alpha) * T))
            / ((1 - n) * (beta - alpha)))


def star_stage_line(label, out, run_s, stages):
    other = run_s - sum(stages.values())
    print(f"phase 7 {label}: {out['events']} events in {run_s:.3f} s = "
          f"{out['events'] / run_s:,.0f} events/s; streams "
          f"{stages['streams']:.3f} s, fires {stages['fires']:.3f} s, "
          f"metrics {stages['metrics']:.3f} s, other {other:.3f} s; mean "
          f"posts {out['mean_posts']:.1f}, mean time-in-top-1 "
          f"{out['mean_time_in_top_k']:.4f}")


def star_config2(dev, kw=PRESET_FULL[2], seeds=PRESET_SEEDS[2]):
    """(d) config 2 at its full settings, timed with its stages, its star
    batch one launch of the thinning kernel on the card (none on the
    CPU); seed 0's mean wall count per feed within 4 sigma of the Hawkes
    closed form."""
    kernels.reset_launch_counts()
    out, bundle, b_s, run_s, stages = timed_preset(2, kw, seeds, dev,
                                                   stages=True)
    thin = kernels.LAUNCHES["hawkes_thin"]
    want = 1 if torch.device(dev).type == "cuda" else 0
    check(thin == want, f"(d) config 2: {thin} launches of the thinning "
                        f"kernel in one star batch, not {want}")
    _, cfg, wall, ctrl = bundle
    res0 = rt.simulate_star(cfg, wall, ctrl, seed=0, device=dev)
    walls = res0.wall_n.double().cpu().numpy()
    l0, alpha, beta = (float(getattr(wall, f).reshape(-1)[0])
                       for f in ("l0", "alpha", "beta"))
    expect = hawkes_mean_count(l0, alpha, beta, cfg.end_time)
    stationary = l0 * cfg.end_time / (1 - alpha / beta)
    se = walls.std() / np.sqrt(walls.size)
    check(abs(walls.mean() - expect) < 4 * se,
          f"(d) config 2: mean wall count {walls.mean():.3f} vs the closed "
          f"form {expect:.3f} beyond 4 sigma ({4 * se:.3f})")
    star_stage_line("(d) config 2", out, run_s, stages)
    print(f"  seed 0: mean wall count per feed {walls.mean():.3f} against "
          f"the closed form {expect:.3f} (stationary {stationary:.3f}), 4 "
          f"sigma {4 * se:.3f}; {res0.n_posts} posts; build {b_s:.3f} s")
    return {"lanes": len(out["per_seed_top_k"]), "feeds": cfg.n_feeds,
            "events": out["events"], "build_s": b_s, "run_s": run_s,
            "thin_launches": thin,
            "events_per_s": out["events"] / run_s, "stages_s": stages,
            "mean_posts": out["mean_posts"],
            "mean_top1": out["mean_time_in_top_k"],
            "wall_mean": float(walls.mean()), "wall_closed_form": expect,
            "wall_stationary": stationary, "wall_4se": float(4 * se)}


def star_modes(cfg, wall, ctrl, seed, dev):
    """Seed ``seed`` through the star kernel in every (compression, fire
    mode) pair: ``{(compress, mode): outputs}``, each checked free of
    overflow."""
    from redqueen_tpu_torch.parallel import star_run

    keys = rt.sim._as_keys(np.array([seed]), torch.device(dev))
    wb, cb = wall.map(lambda x: x[None]), ctrl.map(lambda x: x[None])
    outs, secs = {}, {}
    for compress in (True, False):
        for mode in ("loop", "doubling"):
            sync(dev)
            t0 = time.perf_counter()
            out = star_run._get_fn(cfg, 1, compress, mode,
                                   torch.device(dev))(wb, cb, keys)
            sync(dev)
            secs[(compress, mode)] = time.perf_counter() - t0
            flags = [bool(f.any()) for f in out[5:8]]
            check(not any(flags), f"(e) compress={compress} {mode}: "
                                  f"overflow flags {flags}")
            outs[(compress, mode)] = out
    return outs, secs


def star_config4(dev, kw=PRESET_FULL[4], seeds=PRESET_SEEDS[4]):
    """(e) config 4 at its full settings, timed with its stages; seed 0 in
    both fire modes, compressed and not: bit-identical."""
    out, bundle, b_s, run_s, stages = timed_preset(4, kw, seeds, dev,
                                                   stages=True)
    _, cfg, wall, ctrl = bundle
    outs, secs = star_modes(cfg, wall, ctrl, 0, dev)
    modes = {f"{'compressed' if c else 'uncompressed'} {m}": v
             for (c, m), v in secs.items()}
    ref = outs[(True, "doubling")]
    n_bad = 0
    for key, o in outs.items():
        same = (torch.equal(bits(o[0]), bits(ref[0]))
                and all(torch.equal(bits(a), bits(b))
                        for a, b in zip(o[4][:3], ref[4][:3])))
        n_bad += not same
    check(n_bad == 0, f"(e) config 4: {n_bad} of 4 (compression, fire "
                      f"mode) runs differ from compressed doubling")
    n_posts = int(ref[1][0])
    star_stage_line("(e) config 4", out, run_s, stages)
    print(f"  seed 0 in 4 (compression, fire mode) runs, "
          + ", ".join(f"{k} {v:.3f} s" for k, v in modes.items())
          + f": bit-identical posts ({n_posts}) and metrics; build "
          f"{b_s:.3f} s for {cfg.n_feeds} feeds, wall_cap {cfg.wall_cap}")
    return {"lanes": len(out["per_seed_top_k"]), "feeds": cfg.n_feeds,
            "wall_cap": cfg.wall_cap, "events": out["events"],
            "build_s": b_s, "run_s": run_s,
            "events_per_s": out["events"] / run_s, "stages_s": stages,
            "mean_posts": out["mean_posts"],
            "mean_top1": out["mean_time_in_top_k"],
            "modes_identical": 4 - n_bad, "modes_s": modes,
            "seed0_posts": n_posts}


def ragged_pair(label, counts, opts, dev, engine):
    """Bucketed (max_buckets=8) against dense-padded (max_buckets=1),
    per lane bit for bit; event-kernel launches counted around the
    bucketed run."""
    from redqueen_tpu_torch.parallel.lanes import simulate_ragged

    seeds = np.arange(len(counts))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rb = simulate_ragged(counts, seeds, engine=engine, max_buckets=8,
                         return_logs=True, device=dev, **opts)
    t1 = time.perf_counter()
    launches = kernels.LAUNCHES["event_kernel"]
    rd = simulate_ragged(counts, seeds, engine=engine, max_buckets=1,
                         return_logs=True, device=dev, **opts)
    t2 = time.perf_counter()
    diffs = {"logs": int(sum(
        not (np.array_equal(tb.view(np.int32), td.view(np.int32))
             and np.array_equal(sb, sd))
        for (tb, sb), (td, sd) in zip(rb.logs, rd.logs)))}
    for f in ("n_events", "top_k", "posts", "health"):
        diffs[f] = int((getattr(rb, f) != getattr(rd, f)).sum())
    n_bad = sum(diffs.values())
    check(n_bad == 0, f"{label}: lanes differing between the bucketed and "
                      f"the dense-padded plan, by field: {diffs}")
    check((rb.health == 0).all(), f"{label}: sick lanes")
    on_card = torch.device(dev).type == "cuda"
    want = "scan" if engine == "scan" else ("cuda" if on_card else "plain")
    check(rb.engine == want, f"{label}: engine {rb.engine!r}, want {want!r}")
    if want == "cuda":
        check(launches == rb.dispatches > 0,
              f"{label}: {launches} event-kernel launches vs "
              f"{rb.dispatches} dispatches")
    else:
        check(launches == 0, f"{label}: the {want} route launched the "
                             f"event kernel {launches} times")
    res = {"lanes": len(counts), "max_count": int(counts.max()),
           "widths": list(rb.plan.widths), "events": rb.events,
           "bucketed_s": t1 - t0, "dense_s": t2 - t1,
           "events_per_s_bucketed": rb.events / (t1 - t0),
           "pad_frac_bucketed": rb.plan.pad_frac_bucketed,
           "pad_frac_dense": rb.plan.pad_frac_dense,
           "dispatches": rb.dispatches, "launches": launches,
           "lanes_differing": n_bad, "engine": rb.engine,
           "mean_top1": float(rb.top_k.mean())}
    print(f"phase 7 {label}: B={len(counts)} widths {list(rb.plan.widths)} "
          f"(max {int(counts.max())} followers), T={opts['end_time']}: "
          f"{rb.events} events; bucketed {t1 - t0:.3f} s "
          f"({rb.events / (t1 - t0):,.0f} events/s, pad "
          f"{rb.plan.pad_frac_bucketed:.1%}) vs dense {t2 - t1:.3f} s (pad "
          f"{rb.plan.pad_frac_dense:.1%}); lanes differing {n_bad}; "
          f"engine {rb.engine!r}, dispatches {rb.dispatches}, event-kernel "
          f"launches {launches}")
    return res


def power_law(dev, fused_kw=POWER_LAW_FUSED, scan_kw=POWER_LAW_SCAN):
    """(f) the kernel route and (g) the scan route of power-law ragged
    lanes."""
    from redqueen_tpu_torch.presets import build_preset

    _, counts, opts = build_preset("power_law", **fused_kw)
    res = {"fused": ragged_pair("(f) power_law, event kernel", counts, opts,
                                dev, "fused")}
    _, counts, opts = build_preset("power_law", **scan_kw)
    res["scan"] = ragged_pair("(g) power_law, scan engine", counts, opts,
                              dev, "scan")
    return res


def phase_presets(dev, fused):
    """Phase 7; ``fused`` is phase 5's (mean, std, lanes) of
    time-in-top-1."""
    t0 = time.perf_counter()
    # The lane layer's autotune cache: a file of this run's own.
    tmp = tempfile.mkdtemp(prefix="rq_autotune_")
    os.environ[ENV_AUTOTUNE] = os.path.join(tmp, "lanes_autotune.json")
    try:
        res = phase_presets_body(dev, fused)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 7 presets and star engine: {res['phase_s']:.1f} s")
    return res


def phase_presets_body(dev, fused):
    res = {"batch": preset_batch(dev, fused)}
    res["star_cross"] = {w: star_cross(w, kw, dev)
                         for w, kw in STAR_CROSS.items()}
    res["config2"] = star_config2(dev)
    res["config4"] = star_config4(dev)
    res["power_law"] = power_law(dev)
    return res
