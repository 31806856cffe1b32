"""A rank timeline on the port: r(t) on one follower's feed, RedQueen
against budget-matched Poisson (the counterpart of
``experiments/rank_timeline.py``).

One component each, the controlled broadcaster against Poisson walls,
at the same seed: the walls are bit-identical in both, so only the
broadcaster differs.  RedQueen's rank hugs 0, re-posting when pushed
down; the budget-matched Poisson drifts.

    python -m redqueen_tpu_torch.experiments.rank_timeline [--seed N]
        [--feed I] [--out F.json] [--fig out.png] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import add_device_argument, write_result


def run(T: float = 100.0, F: int = 5, q: float = 1.0, wall_rate: float = 1.0,
        seed: int = 0, capacity: int = 4096, device="cuda"):
    """``({"opt": (df, src), "poisson": (df, src)}, budget)``: the
    RedQueen component, then Poisson at RedQueen's realised post count,
    each exported to the reference-schema DataFrame."""
    from ..baselines import budget_matched_poisson_rate
    from ..config import GraphBuilder
    from ..device import resolve_device
    from ..sim import simulate
    from ..utils.dataframe import events_to_dataframe
    from ..utils.metrics_pandas import num_posts_of_src

    dev = resolve_device(device)

    def component(add_ctrl):
        gb = GraphBuilder(n_sinks=F, end_time=T)
        ctrl = add_ctrl(gb)
        for i in range(F):
            gb.add_poisson(rate=wall_rate, sinks=[i])
        cfg, params, adj = gb.build(capacity=capacity, device=dev)
        log = simulate(cfg, params, adj, seed=seed, device=dev)
        df = events_to_dataframe(log.times, log.srcs, adj)
        return df, ctrl

    df_opt, opt_id = component(lambda gb: gb.add_opt(q=q))
    budget = num_posts_of_src(df_opt, opt_id)
    rate = budget_matched_poisson_rate(budget, T)
    df_poi, poi_id = component(lambda gb: gb.add_poisson(rate=rate))
    return {"opt": (df_opt, opt_id), "poisson": (df_poi, poi_id)}, budget


def rank_steps(df, src_id, sink_id, T: float):
    """``(times, ranks)``: the step function of ``src_id``'s rank in
    ``sink_id``'s feed over [0, T], rank 0 before any feed activity, one
    step per event touching the feed."""
    from ..utils.metrics_pandas import rank_of_src_in_df

    times, ranks = rank_of_src_in_df(df, src_id).get(
        sink_id, (np.empty(0), np.empty(0, np.int64)))
    t = np.concatenate([[0.0], times, [T]])
    last = ranks[-1] if len(ranks) else 0
    r = np.concatenate([[0], ranks, [last]])
    return t, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--feed", type=int, default=0)
    ap.add_argument("--followers", type=int, default=5)
    ap.add_argument("--horizon", type=float, default=100.0)
    ap.add_argument("--out", default="RANK_TIMELINE_torch.json")
    ap.add_argument("--fig", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if not 0 <= args.feed < args.followers:
        ap.error(f"--feed {args.feed} out of range for "
                 f"--followers {args.followers}")

    from ..device import resolve_device
    from ..parallel.lanes import shape_budget
    from ..utils.metrics_pandas import time_in_top_k

    dev = resolve_device(args.device)
    # A chunk of about a sixteenth of the events: they do not depend on
    # it, and a run steps whole chunks.
    cap, _ = shape_budget(args.followers, args.horizon, 1.0)
    results, budget = run(T=args.horizon, F=args.followers, seed=args.seed,
                          capacity=cap, device=dev)
    print(f"budget (RedQueen realized posts): {budget}")
    steps = {name: rank_steps(df, src, args.feed, args.horizon)
             for name, (df, src) in results.items()}
    out = {}
    for name, (df, src) in results.items():
        t, r = steps[name]
        frac0 = time_in_top_k(df, 1, args.horizon, src,
                              per_sink=True)[args.feed] / args.horizon
        out[name] = {"feed_events": len(t) - 2, "top1_fraction": float(frac0),
                     "times": t.tolist(), "ranks": r.tolist()}
        print(f"{name:8s} feed {args.feed}: {len(t) - 2} feed events, "
              f"top-1 fraction {frac0:.3f}")
    write_result(args.out, {"seed": args.seed, "feed": args.feed,
                            "followers": args.followers, "T": args.horizon,
                            "budget": int(budget), "policies": out},
                 "rq.experiment.rank_timeline/1", dev)
    print(f"wrote {args.out}")

    if args.fig:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(9, 5), sharex=True)
        rmax = max(r.max() for _t, r in steps.values())
        for ax, name in zip(axes, steps):
            t, rc = steps[name]
            ax.step(t, rc, where="post", lw=1.2,
                    color="tab:red" if name == "opt" else "tab:blue")
            ax.fill_between(t, 0, 0.999, where=rc == 0, step="post",
                            alpha=0.25, color="tab:green")
            ax.set_ylabel(f"{name}\nrank r(t)")
            ax.set_ylim(-0.3, rmax + 0.5)
        axes[0].set_title(
            f"Rank in feed {args.feed} over time at matched budget "
            f"({budget} posts): RedQueen re-posts on demotion")
        axes[1].set_xlabel("time")
        fig.tight_layout()
        fig.savefig(args.fig, dpi=120)
        print(f"wrote {args.fig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
