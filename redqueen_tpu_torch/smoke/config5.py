"""Phase 8 of the smoke run: the headline bench as a subprocess and
config 5 (the RMTPP policy), gated against the NumPy oracle."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.models.base import map_weights as rt_map_weights
from .common import check, sync
from .scan import NEAR_TIE_MAX_SHARE, NEAR_TIE_RTOL, compare_devices


REPO_DIR = str(Path(__file__).resolve().parents[2])
BENCH_TIMEOUT_S = 600
# Config 5 at benchmarks/run.py's _FULL[5] (scale 1: 10 Poisson feeds of
# rate 1; T = 100; 1,024 seeds) with the preset's hidden 8, 120 fit steps
# and capacity 2,048.
CONFIG5_FULL = dict(scale=1.0, end_time=100.0, hidden=8, capacity=2048)
CONFIG5_SEEDS = 1024
CONFIG5_FIT_STEPS = 120
CONFIG5_ORACLE_SEEDS = 64
# (c): card against CPU; (e): the hidden-16 weights, gated.
CONFIG5_CROSS = dict(B=64, end_time=50.0, capacity=1024)
CONFIG5_NPZ = dict(B=256, end_time=100.0, capacity=2048)
FIT_RTOL = 1e-3


def bench_run(args=(), platform=None, timeout=BENCH_TIMEOUT_S):
    """(a) The bench as a user runs it, in its own process: its last
    stdout line, with both engines inside the oracle's gate."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_DIR)
    wall_s = time.perf_counter() - t0
    for ln in out.stderr.strip().splitlines()[-8:]:
        print(f"  bench: {ln}")
    check(out.returncode == 0, f"(a) the bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    platform = platform or torch.cuda.get_device_name(0)
    check(line["platform"] == platform,
          f"(a) bench platform {line['platform']!r}, expected {platform!r}")
    engines = line["engines"]
    check(set(engines) == {"scan", "fused"}, f"(a) engines {set(engines)}")
    for name, e in engines.items():
        check(e["gate_ok"] is True,
              f"(a) {name}: |engine - oracle| time-in-top-1 {e['gate']} "
              f"beyond {e['gate_tol']}")
    fused = engines["fused"]
    if platform != "cpu":
        check(fused["route"] == "cuda" and fused["launches"] > 0,
              f"(a) the fused engine ran {fused['route']!r} with "
              f"{fused['launches']} event-kernel launches")
    print(f"phase 8 (a) bench: {line['metric']}: {line['value']:,.1f} "
          f"events/s ({line['engine']}), {line['vs_baseline']}x the oracle "
          f"({line['oracle_events_per_sec']:,.1f} events/s); "
          + "; ".join(
              f"{n} {e['events_per_sec']:,.1f} events/s, time-in-top-1 "
              f"{e['top1']} vs oracle {e['oracle_top1']} (|d| {e['gate']} "
              f"<= {e['gate_tol']})" for n, e in engines.items())
          + f"; fused launches {fused['launches']}; {wall_s:.1f} s")
    return dict(line, wall_s=wall_s)


def oracle_rmtpp(weights, hidden, T, n_seeds, n_followers=10):
    """Posts and time-in-top-1 of ``oracle.numpy_ref.RMTPP`` with
    ``weights`` (as float64) over ``n_seeds`` components of the bench's
    oracle (``bench.oracle_components``)."""
    from redqueen_tpu_torch.bench import oracle_components
    from redqueen_tpu_torch.convert import rmtpp_weights_to_jax

    w64 = rt_map_weights(lambda a: np.asarray(a, np.float64),
                         rmtpp_weights_to_jax(weights))
    res = oracle_components(
        n_seeds, n_followers, T, 1.0,
        manager=lambda so, c: so.create_manager_with_rmtpp(
            seed=c, weights=w64, hidden=hidden))
    return res["posts"], res["top1"]


def gate_4se(label, got, want, floor):
    """The bench's 4-sigma gate (``bench.gate``) of the mean of ``got``
    against the oracle's ``want``, independent seeds on both sides."""
    from redqueen_tpu_torch.bench import gate

    d, tol = gate(*((x.mean(), x.std(), x.size) for x in (got, want)),
                  floor=floor)
    check(d <= tol, f"{label}: {got.mean():.4f} vs oracle {want.mean():.4f}"
                    f", |d| {d:.4f} beyond {tol:.4f}")
    return {"mean": float(got.mean()), "oracle_mean": float(want.mean()),
            "diff": float(d), "tol": float(tol)}


def rmtpp_batch(weights, B, end_time, capacity, dev, hidden):
    """Config 5's component with ``weights``, stacked ``B`` times on
    ``dev`` (``presets.batch_lanes``): ``(cfg, params, adj, row)``."""
    from redqueen_tpu_torch.presets import batch_lanes, build_preset

    bundle = build_preset(5, weights=weights, end_time=end_time,
                          capacity=capacity, hidden=hidden, device=dev)
    return batch_lanes(bundle, np.arange(B), dev)[:4]


def rmtpp_run(cfg, params, adj, row, seeds, dev):
    """``run_preset``'s batch run, simulate and metrics each timed to a
    sync: ``(log, top1 [B], posts [B], simulate s, metrics s)``."""
    from redqueen_tpu_torch.presets import batch_metrics

    t0 = time.perf_counter()
    log = rt.simulate_batch(cfg, params, adj, seeds, device=dev)
    sync(dev)
    t1 = time.perf_counter()
    top, posts, _ = batch_metrics(log, adj, row, cfg.end_time)
    sync(dev)
    return (log, top.double().cpu().numpy(), posts.double().cpu().numpy(),
            t1 - t0, time.perf_counter() - t1)


def config5_full(dev, kw=CONFIG5_FULL, n_seeds=CONFIG5_SEEDS,
                 fit_steps=CONFIG5_FIT_STEPS,
                 oracle_seeds=CONFIG5_ORACLE_SEEDS):
    """(b) Config 5 at full width, its weights fitted on ``dev``."""
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()
    t0 = time.perf_counter()
    weights, _, losses = rmtpp.fit(0, taus, mask, hidden=kw["hidden"],
                                   steps=fit_steps, device=dev)
    sync(dev)
    fit_s = time.perf_counter() - t0
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"(b) the fit's loss went {losses[0]:.4f} -> {losses[-1]:.4f}")
    cfg, params, adj, row = rmtpp_batch(weights, n_seeds, kw["end_time"],
                                        kw["capacity"], dev, kw["hidden"])
    log, top, posts, sim_s, met_s = rmtpp_run(cfg, params, adj, row,
                                              np.arange(n_seeds), dev)
    events = int(log.n_events.sum())
    check(log.engine == "scan" and bool((log.health == 0).all()),
          f"(b) engine {log.engine!r}, sick lanes "
          f"{int((log.health != 0).sum())}")
    check(np.isfinite(top).all() and ((top >= 0) & (top <= cfg.end_time))
          .all(), "(b) time-in-top-1 outside [0, T]")
    t1 = time.perf_counter()
    o_posts, o_top = oracle_rmtpp(weights, kw["hidden"], kw["end_time"],
                                  oracle_seeds)
    oracle_s = time.perf_counter() - t1
    g_posts = gate_4se("(b) config 5 mean posts", posts, o_posts,
                       0.02 * o_posts.mean())
    g_top = gate_4se("(b) config 5 mean time-in-top-1", top, o_top,
                     0.02 * kw["end_time"])
    res = {"seeds": n_seeds, "events": events, "fit_s": fit_s,
           "fit_steps": fit_steps, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "simulate_s": sim_s,
           "metrics_s": met_s, "steps": int(log.times.shape[1]),
           "ms_per_step": 1e3 * sim_s / log.times.shape[1],
           "events_per_s": events / (sim_s + met_s),
           "events_per_s_simulate_only": events / sim_s,
           "dispatches": log.dispatches, "posts": g_posts,
           "top1": g_top, "oracle_seeds": oracle_seeds,
           "oracle_s": oracle_s, "losses": losses.tolist()}
    print(f"phase 8 (b) config 5: fit {fit_steps} steps {fit_s:.3f} s "
          f"(loss {losses[0]:.4f} -> {losses[-1]:.4f}); {n_seeds} seeds: "
          f"{events} events, simulate {sim_s:.3f} s ({res['steps']} steps, "
          f"{res['ms_per_step']:.3f} ms each), metrics {met_s:.3f} s = "
          f"{res['events_per_s']:,.0f} events/s "
          f"({events / sim_s:,.0f} simulate only); mean posts "
          f"{g_posts['mean']:.3f} vs oracle {g_posts['oracle_mean']:.3f} "
          f"(tol {g_posts['tol']:.3f}); time-in-top-1 {g_top['mean']:.4f} "
          f"vs oracle {g_top['oracle_mean']:.4f} (tol {g_top['tol']:.4f}); "
          f"oracle {oracle_seeds} seeds {oracle_s:.1f} s")
    return res, weights


def config5_cross(weights, dev, B=None, end_time=None, capacity=None,
                  tag="phase 8 (c)"):
    """(c) The same weights and seeds on the card and on the CPU."""
    c = CONFIG5_CROSS
    B, end_time = B or c["B"], end_time or c["end_time"]
    capacity = capacity or c["capacity"]
    hidden = weights["v"]["kernel"].shape[-2]
    cfg, params, adj, _ = rmtpp_batch(weights, B, end_time, capacity, dev,
                                      hidden)
    card = rt.simulate_batch(cfg, params, adj, np.arange(B), device=dev)
    cpu = rt.simulate_batch(cfg, params.to("cpu"), adj.cpu(), np.arange(B),
                            device="cpu")
    return compare_devices(f"config 5 (hidden {hidden})", card, cpu,
                           end_time, tag=tag)


def rmtpp_stream_cross(weights, dev, n=256, T=100.0, cap=512):
    """(d) ``rmtpp_stream`` and an RMTPP-controlled star run (100 Poisson
    feeds), card against CPU: counts identical but for near-ties at the
    horizon, times within rtol 1e-5."""
    from redqueen_tpu_torch.ops import prng, streams

    hidden = int(weights["v"]["kernel"].shape[-2])
    keys = prng.split(prng.PRNGKey(7), n)
    w_cpu = rt_map_weights(lambda t: t.cpu(), weights)
    sc = streams.rmtpp_stream(weights, keys.to(dev), 0.0, T, cap, hidden)
    sp = streams.rmtpp_stream(w_cpu, keys, 0.0, T, cap, hidden)
    tc, tp = sc.times.cpu().double(), sp.times.double()
    same_n = sc.n.cpu() == sp.n
    fin = torch.isfinite(tp) & same_n[:, None]
    rel = ((tc - tp).abs() / tp.abs().clamp(min=1e-30))[fin]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    n_diff = int((~same_n).sum())
    check(n_diff <= NEAR_TIE_MAX_SHARE * n and max_rel <= NEAR_TIE_RTOL,
          f"(d) rmtpp_stream card vs CPU: {n_diff} of {n} counts differ, "
          f"max rel {max_rel:.3g}")
    sb = rt.StarBuilder(n_feeds=100, end_time=T)
    for f in range(100):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_rmtpp(w_cpu, hidden=hidden)
    cfg, wall, ctrl = sb.build(wall_cap=256, post_cap=cap, device="cpu")
    star = {}
    for s in (0, 1):
        card = rt.simulate_star(cfg, wall.to(dev), ctrl.to(dev), seed=s,
                                device=dev)
        cpu = rt.simulate_star(cfg, wall, ctrl, seed=s, device="cpu")
        oc, op = card.own_times.cpu().double(), cpu.own_times.double()
        check(card.n_posts == cpu.n_posts,
              f"(d) star seed {s}: {card.n_posts} posts on the card, "
              f"{cpu.n_posts} on the CPU")
        fin = torch.isfinite(op)
        r = float(((oc - op).abs() / op.abs().clamp(min=1e-30))[fin].max())
        top_c = float(card.metrics.mean_time_in_top_k())
        top_p = float(cpu.metrics.mean_time_in_top_k())
        check(r <= NEAR_TIE_RTOL and abs(top_c - top_p) <= 1e-4 * top_p,
              f"(d) star seed {s}: post times rel {r:.3g}, time-in-top-1 "
              f"{top_c} vs {top_p}")
        star[s] = {"posts": card.n_posts, "max_rel_post": r,
                   "top1_card": top_c, "top1_cpu": top_p}
    print(f"phase 8 (d) rmtpp_stream card vs CPU: {n} streams, "
          f"{int(sc.n.sum())} events, counts differing {n_diff}, max rel "
          f"{max_rel:.3g}; RMTPP-controlled star (100 feeds): "
          + ", ".join(f"seed {s} {v['posts']} posts (rel "
                      f"{v['max_rel_post']:.3g})" for s, v in star.items()))
    return {"streams": n, "events": int(sc.n.sum()), "counts_differing":
            n_diff, "max_rel": max_rel, "star": star}


def config5_npz(dev, B=None, end_time=None, capacity=None,
                oracle_seeds=CONFIG5_ORACLE_SEEDS, cross=None):
    """(e) The committed hidden-16 weights: one run gated against the
    oracle, and (c)'s card-against-CPU run (``cross``: its ``B``,
    ``end_time`` and ``capacity``), which holds the hidden-16 path far
    tighter than the oracle's spread can."""
    c = CONFIG5_NPZ
    B, end_time = B or c["B"], end_time or c["end_time"]
    capacity = capacity or c["capacity"]
    weights, info = rt.load_rmtpp_npz(device=dev)
    cfg, params, adj, row = rmtpp_batch(weights, B, end_time, capacity, dev,
                                        16)
    log, top, posts, sim_s, met_s = rmtpp_run(cfg, params, adj, row,
                                              np.arange(B), dev)
    o_posts, o_top = oracle_rmtpp(weights, 16, end_time, oracle_seeds)
    g_posts = gate_4se("(e) hidden-16 mean posts", posts, o_posts,
                       0.02 * o_posts.mean())
    g_top = gate_4se("(e) hidden-16 mean time-in-top-1", top, o_top,
                     0.02 * end_time)
    events = int(log.n_events.sum())
    print(f"phase 8 (e) committed hidden-16 weights (held-out NLL "
          f"{float(info['heldout_nll']):.4f}): B={B}, {events} events in "
          f"{sim_s:.3f} s + metrics {met_s:.3f} s; posts {g_posts['mean']:.3f}"
          f" vs oracle {g_posts['oracle_mean']:.3f} (tol {g_posts['tol']:.3f})"
          f"; time-in-top-1 {g_top['mean']:.4f} vs oracle "
          f"{g_top['oracle_mean']:.4f} (tol {g_top['tol']:.4f})")
    xs = config5_cross(weights, dev, tag="phase 8 (e)", **(cross or {}))
    return {"B": B, "events": events, "simulate_s": sim_s,
            "metrics_s": met_s, "posts": g_posts, "top1": g_top,
            "cross": xs}


def fit_cross(card_losses, fit_steps=CONFIG5_FIT_STEPS, hidden=8):
    """(f) The CPU fit from the same initial weights as (b)'s card fit:
    the largest relative gap of the two loss curves."""
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()
    _, _, cpu = rmtpp.fit(0, taus, mask, hidden=hidden, steps=fit_steps,
                          device="cpu")
    card = np.asarray(card_losses)
    gap = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    check(gap <= FIT_RTOL, f"(f) fit card vs CPU: largest relative loss gap "
                           f"{gap:.3g} > {FIT_RTOL}")
    print(f"phase 8 (f) fit card vs CPU over {fit_steps} steps: largest "
          f"relative loss gap {gap:.3g} (last {card[-1]:.6f} vs "
          f"{cpu[-1]:.6f})")
    return {"max_rel_gap": gap, "loss_last_card": float(card[-1]),
            "loss_last_cpu": float(cpu[-1])}


def phase_config5(dev, bench_args=()):
    """Phase 8."""
    t0 = time.perf_counter()
    res = {"bench": bench_run(bench_args)}
    res["config5"], weights = config5_full(dev)
    res["cross"] = config5_cross(weights, dev)
    res["streams"] = rmtpp_stream_cross(weights, dev)
    res["npz"] = config5_npz(dev)
    res["fit"] = fit_cross(res["config5"]["losses"])
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 8 bench and config 5: {res['phase_s']:.1f} s")
    return res
