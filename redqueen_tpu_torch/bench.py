"""The port's headline bench: simulated events per second on the headline
graph, held to the NumPy oracle's time-in-top-1 by a 4-sigma gate.

    python -m redqueen_tpu_torch.bench [--quick] [--engines scan,fused]
                                       [--device cuda|cpu] [--no-oracle]

It follows the protocol of the JAX package's ``bench.py`` (its engines
and its oracle run in one process here, with no subprocess children):

- **Shapes**: B = 10,000 components of one RedQueen ``Opt`` broadcaster
  (q = 1) against 10 followers, each with one Poisson wall of rate 1,
  T = 100 (``--quick``: B = 64, T = 20); chunk capacity and allowance
  from ``parallel.lanes.shape_budget``.
- **Oracle** (the denominator): ``oracle.numpy_ref`` on 32 components (2
  under ``--quick``), Poisson walls seeded ``40_000 + 1000 c + i`` and
  ``Opt`` seeded ``c``; best of 3 passes while the next one fits the
  time budget; time-in-top-1 through ``utils.metrics_pandas``.
- **Engines**: the scan engine and the fused engine (the hand-written
  CUDA event kernel on the card) on the device asked for.  One warm-up
  run, then the best of 3 timed runs at seeds ``10_000 + lane``, each
  covering simulate and the metrics pass and ending in
  ``torch.cuda.synchronize()`` on the card.  Events are counted from the
  logs; time-in-top-1 mean, std and n come from the run's own metrics.
- **Gate**: ``|engine - oracle|`` of mean time-in-top-1 against
  ``max(4 sqrt(se_engine^2 + se_oracle^2), 0.02 T)``.
- **Result line**: one JSON object on stdout for the fastest engine so
  far, printed again after each engine, so the last line is the result:
  ``metric``, ``value`` (events/s), ``unit``, ``vs_baseline``,
  ``oracle_events_per_sec``, the gate block of the fastest engine
  (``top1``, ``oracle_top1``, ``gate``, ``gate_tol``, ``gate_ok``),
  ``engine``, ``platform`` (the card's name, or ``"cpu"``) and every
  engine's own numbers and gate under ``engines``.  Diagnostics go to
  stderr.

Exit codes: 0; 3 when any engine fails its gate (the line is printed
first); 2, with no result line, when the card is asked for (the
default) and torch sees no CUDA device: a CPU run is only ever made
with ``--device cpu``, and says so in ``platform``."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["TIMED_REPS", "oracle_components", "run_oracle", "run_engine",
           "gate", "gate_fields", "result_line", "shapes", "main"]

#: Timed runs per engine and oracle passes: the best of them is kept.
TIMED_REPS = 3
#: Oracle components (full, ``--quick``).
ORACLE_COMPS = (32, 2)
ENGINES = ("scan", "fused")
#: Wall-clock budget of a run: the oracle takes at most 30% of it, and no
#: timed rep starts that would pass it.
DEADLINE_S = 900.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _more_reps_fit(best_secs: float, deadline_abs: Optional[float]) -> bool:
    """False when the next rep (about the best so far, plus 15%) would
    pass the deadline; the first rep always runs."""
    if deadline_abs is None or not np.isfinite(best_secs):
        return True
    return time.monotonic() + 1.15 * best_secs <= deadline_abs


def shapes(quick: bool):
    """``(B, T, oracle components)`` of the headline or of ``--quick``."""
    return (64, 20.0, ORACLE_COMPS[1]) if quick else \
        (10_000, 100.0, ORACLE_COMPS[0])


def oracle_components(n_comps: int, n_followers: int, T: float,
                      wall_rate: float, manager, q: float = 1.0) -> Dict:
    """One pass of the NumPy oracle over ``n_comps`` components: the
    controlled broadcaster (source 0) built by ``manager(sim_opts, c)``
    against ``n_followers`` followers, each with one Poisson wall seeded
    ``40_000 + 1000 c + i``.  Returns the events and, per component, the
    broadcaster's posts and its time-in-top-1."""
    from .oracle.numpy_ref import SimOpts
    from .utils import metrics_pandas as mp

    events, posts, tops = 0, [], []
    for c in range(n_comps):
        others = [
            ("poisson", dict(src_id=100 + i, seed=40_000 + 1000 * c + i,
                             rate=wall_rate, sink_ids=[i]))
            for i in range(n_followers)]
        so = SimOpts(src_id=0, sink_ids=list(range(n_followers)),
                     other_sources=others, end_time=T, q=q)
        mgr = manager(so, c)
        mgr.run_till()
        df = mgr.state.get_dataframe()
        events += df["event_id"].nunique()
        posts.append(mp.num_posts_of_src(df, 0))
        tops.append(mp.time_in_top_k(df, 1, T, src_id=0,
                                     sink_ids=so.sink_ids))
    return {"events": int(events), "posts": np.asarray(posts, np.float64),
            "top1": np.asarray(tops, np.float64)}


def run_oracle(n_comps: int, n_followers: int, T: float, q: float,
               wall_rate: float, budget_s: float = 380.0) -> Dict:
    """The NumPy oracle on ``n_comps`` headline components (``Opt``
    seeded ``c``): events, the best seconds, and the mean, std and count
    of time-in-top-1."""
    deadline = time.monotonic() + budget_s
    secs, run = np.inf, None
    for _ in range(TIMED_REPS):
        if not _more_reps_fit(secs, deadline):
            break
        t0 = time.perf_counter()  # host work only: nothing to wait for
        run = oracle_components(
            n_comps, n_followers, T, wall_rate, q=q,
            manager=lambda so, c: so.create_manager_with_opt(seed=c))
        secs = min(secs, time.perf_counter() - t0)
    tops = run["top1"]
    return {"events": run["events"], "secs": float(secs),
            "top1": float(tops.mean()), "top1_std": float(tops.std()),
            "top1_n": int(tops.size), "comps": n_comps}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_engine(name: str, B: int, n_followers: int, T: float, q: float,
               wall_rate: float, device: torch.device,
               deadline_abs: Optional[float] = None) -> Dict:
    """One engine on the headline batch: a warm-up run, then the best of
    :data:`TIMED_REPS` runs of simulate + metrics at seeds ``10_000 +
    lane``.  Returns the best run's events, seconds (and their split),
    time-in-top-1 statistics, posts per lane, dispatches and event-kernel
    launches."""
    from .config import GraphBuilder, stack_components
    from .ops import kernels
    from .parallel.lanes import shape_budget
    from .sim import simulate_batch
    from .utils.metrics import feed_metrics_batch, num_posts

    capacity, max_chunks = shape_budget(n_followers, T, wall_rate)
    gb = GraphBuilder(n_sinks=n_followers, end_time=T)
    opt = gb.add_opt(q=q)
    for i in range(n_followers):
        gb.add_poisson(rate=wall_rate, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=capacity, device=device)
    params, adj = stack_components([p0] * B, [a0] * B)

    def once(seeds):
        t0 = time.perf_counter()
        lg = simulate_batch(cfg, params, adj, seeds, max_chunks=max_chunks,
                            engine=name, device=device)
        _sync(device)
        t1 = time.perf_counter()
        m = feed_metrics_batch(lg.times, lg.srcs, adj, opt, T)
        top = m.mean_time_in_top_k()
        posts = num_posts(lg.srcs, opt)
        _sync(device)
        t2 = time.perf_counter()
        return lg, top, posts, t1 - t0, t2 - t1

    once(np.arange(B))                                   # warm-up
    best = None
    for _ in range(TIMED_REPS):
        if best is not None and not _more_reps_fit(best[3] + best[4],
                                                   deadline_abs):
            log(f"engine {name}: stopping timed reps early (deadline)")
            break
        kernels.reset_launch_counts()
        run = once(np.arange(B) + 10_000)
        run += (kernels.LAUNCHES["event_kernel"],)
        if best is None or run[3] + run[4] < best[3] + best[4]:
            best = run
    lg, top, posts, sim_s, met_s, launches = best
    top = top.double().cpu().numpy()
    return {"engine": name, "route": lg.engine,
            "events": int(lg.n_events.sum()), "secs": sim_s + met_s,
            "simulate_s": sim_s, "metrics_s": met_s,
            "top1": float(top.mean()), "top1_std": float(top.std()),
            "top1_n": int(top.size),
            "posts": float(posts.double().mean()),
            "dispatches": int(lg.dispatches or 0), "launches": launches,
            "capacity": capacity, "max_chunks": max_chunks}


def gate(a, b, floor: float):
    """``(|mean_a - mean_b|, tol)`` of two independent samples, each
    given as ``(mean, std, n)``: ``tol = max(4 sqrt(std_a^2 / n_a +
    std_b^2 / n_b), floor)`` (the seeds are independent, so the standard
    errors add in quadrature; the floor guards a degenerate spread on few
    samples)."""
    se2 = sum(std ** 2 / max(n, 1) for _, std, n in (a, b))
    return abs(a[0] - b[0]), max(4.0 * se2 ** 0.5, floor)


def gate_fields(res: Dict, oracle: Optional[Dict], T: float) -> Dict:
    """The quality gate of a result: :func:`gate` of its mean
    time-in-top-1 against the oracle's, with the floor ``0.02 T``.  All
    None but ``top1`` without an oracle."""
    if oracle is None:
        return {"top1": res["top1"], "oracle_top1": None, "gate": None,
                "gate_tol": None, "gate_ok": None}
    d, tol = gate(*((r["top1"], r["top1_std"], r["top1_n"])
                    for r in (res, oracle)), floor=0.02 * T)
    return {"top1": round(res["top1"], 4),
            "oracle_top1": round(oracle["top1"], 4),
            "gate": round(d, 4), "gate_tol": round(tol, 4),
            "gate_ok": bool(d <= tol)}


def _platform(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def result_line(best: Dict, done: List[Dict], oracle: Optional[Dict],
                B: int, n_followers: int, T: float, platform: str) -> Dict:
    """The self-describing result line of the fastest engine ``best``,
    with every finished engine's numbers and gate under ``engines``."""
    o_eps = oracle["events"] / oracle["secs"] if oracle else None
    eps = best["events"] / best["secs"]
    line = {
        "metric": f"simulated events/sec ({B}x{B * n_followers} graph)",
        "value": round(eps, 1),
        "unit": "events/s",
        "vs_baseline": round(eps / o_eps, 2) if o_eps else None,
        "oracle_events_per_sec": round(o_eps, 1) if o_eps else None,
        "engine": best["engine"],
        "platform": platform,
    }
    line.update(gate_fields(best, oracle, T))
    line["engines"] = {
        r["engine"]: {**{k: r[k] for k in (
            "route", "events", "secs", "simulate_s", "metrics_s",
            "posts", "dispatches", "launches", "top1_std", "top1_n")},
            "events_per_sec": round(r["events"] / r["secs"], 1),
            **gate_fields(r, oracle, T)}
        for r in done}
    if oracle is not None:
        line["oracle"] = dict(oracle)
    return line


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m redqueen_tpu_torch.bench",
        description="Events/s of the headline graph on the port's engines, "
                    "gated against the NumPy oracle's time-in-top-1.")
    ap.add_argument("--quick", action="store_true",
                    help="B = 64, T = 20 and 2 oracle components")
    ap.add_argument("--engines", default=",".join(ENGINES),
                    help="comma list from {scan,fused} (default: both)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the card; the "
                         "bench never falls back to the CPU by itself)")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the oracle: vs_baseline and the gate null")
    args = ap.parse_args(argv)
    engines = [e for e in args.engines.split(",") if e]
    bad = [e for e in engines if e not in ENGINES]
    if bad or not engines:
        ap.error(f"--engines takes names from {ENGINES}, got {args.engines!r}")
    return args, engines


def main(argv=None) -> int:
    args, engines = _parse(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench: torch sees no CUDA device; pass --device cpu for a CPU "
            "run (no result is reported)")
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    deadline = time.monotonic() + DEADLINE_S
    B, T, comps = shapes(args.quick)
    F, q, wall_rate = 10, 1.0, 1.0
    platform = _platform(dev)
    oracle = None
    if not args.no_oracle:
        oracle = run_oracle(comps, F, T, q, wall_rate,
                            budget_s=0.3 * DEADLINE_S)
        log(f"numpy oracle: {oracle['events']} events in "
            f"{oracle['secs']:.3f} s on {comps} components; time-in-top-1 "
            f"{oracle['top1']:.4f} (std {oracle['top1_std']:.4f})")
    done, best = [], None
    for name in engines:
        res = run_engine(name, B, F, T, q, wall_rate, dev,
                         deadline_abs=deadline)
        done.append(res)
        log(f"engine {name} ({res['route']}): {res['events']} events in "
            f"{res['secs']:.4f} s (simulate {res['simulate_s']:.4f}, "
            f"metrics {res['metrics_s']:.4f}) = "
            f"{res['events'] / res['secs']:,.0f} events/s; time-in-top-1 "
            f"{res['top1']:.4f}; gate {gate_fields(res, oracle, T)}")
        if best is None or res["events"] / res["secs"] > \
                best["events"] / best["secs"]:
            best = res
        print(json.dumps(result_line(best, done, oracle, B, F, T,
                                     platform)), flush=True)
    failed = [r["engine"] for r in done
              if gate_fields(r, oracle, T)["gate_ok"] is False]
    if failed:
        log(f"QUALITY GATE FAILED for {failed}: |engine - oracle| "
            f"time-in-top-1 beyond its tolerance — exiting 3")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
