"""The paper's figure 2 on the port: the posting budget against
time-in-top-1 as RedQueen's cost q moves over a grid, against
budget-matched Poisson at each realised budget (the counterpart of
``experiments/tradeoff.py``).

Each sweep is one batch of (q point x seed) lanes through
``sweep.run_sweep``; with ``--ckpt-dir`` both go through
``sweep.run_sweep_checkpointed`` (chunks of ``--chunk-points`` points,
resumable bit for bit after a kill).

    python -m redqueen_tpu_torch.experiments.tradeoff [--qgrid 0.1 1 3]
        [--seeds N] [--ckpt-dir D] [--chunk-points N] [--out F.json]
        [--fig out.png] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import add_device_argument, write_result

QGRID = (0.05, 0.1, 0.3, 1.0, 3.0, 10.0)


def points(q_grid, make, F=10, T=100.0, wall_rate=1.0, capacity=4096,
           device="cuda"):
    """One sweep point per q: ``make(gb, qi, q)`` adds the controlled
    broadcaster (source row 0), then one Poisson wall per follower."""
    from .. import GraphBuilder

    pts = []
    for qi, q in enumerate(q_grid):
        gb = GraphBuilder(n_sinks=F, end_time=T)
        make(gb, qi, q)
        for i in range(F):
            gb.add_poisson(rate=wall_rate, sinks=[i])
        pts.append(gb.build(capacity=capacity, device=device))
    return pts


def opt_points(q_grid, F=10, T=100.0, wall_rate=1.0, capacity=4096,
               device="cuda"):
    """The RedQueen half's points: one ``Opt`` of cost q per point."""
    return points(q_grid, lambda gb, qi, q: gb.add_opt(q=q), F, T,
                  wall_rate, capacity, device)


def poisson_points(q_grid, budgets, F=10, T=100.0, wall_rate=1.0,
                   capacity=4096, device="cuda"):
    """The budget-matched half's points: a Poisson broadcaster at the
    rate that spends q's realised budget (``budgets[qi]``) over T."""
    from ..baselines import budget_matched_poisson_rate

    rates = [budget_matched_poisson_rate(b, T) for b in budgets]
    return points(q_grid,
                  lambda gb, qi, q: gb.add_poisson(rate=float(rates[qi])),
                  F, T, wall_rate, capacity, device)


def sweep(pts, n_seeds, seed0, ckpt_dir=None, chunk_points=8, **kw):
    """``run_sweep`` of ``pts``, or ``run_sweep_checkpointed`` into
    ``ckpt_dir`` when one is given (bit-identical grids)."""
    from ..sweep import run_sweep, run_sweep_checkpointed

    if ckpt_dir is None:
        return run_sweep(pts, n_seeds, seed0=seed0, **kw)
    return run_sweep_checkpointed(pts, n_seeds, ckpt_dir,
                                  chunk_points=chunk_points, seed0=seed0,
                                  **kw)


def run_grids(q_grid, n_seeds=8, F=10, T=100.0, wall_rate=1.0,
              capacity=4096, ckpt_dir=None, chunk_points=8, engine="scan",
              max_chunks=100, device="cuda"):
    """``(opt, poisson)``, the two ``SweepResult`` grids [P, n_seeds]:
    RedQueen at each q (seeds from 0), then Poisson at each q's mean
    realised budget (seeds from 10,000).  ``ckpt_dir`` routes both sweeps
    through checkpointed chunks (its ``opt`` and ``poisson``
    subdirectories)."""
    kw = dict(engine=engine, max_chunks=max_chunks, device=device)
    sub = (lambda name: None) if ckpt_dir is None else (
        lambda name: os.path.join(ckpt_dir, name))
    res_o = sweep(opt_points(q_grid, F, T, wall_rate, capacity, device),
                  n_seeds, 0, sub("opt"), chunk_points, **kw)
    budgets = res_o.n_posts.mean(axis=1)
    res_p = sweep(poisson_points(q_grid, budgets, F, T, wall_rate, capacity,
                                 device),
                  n_seeds, 10_000, sub("poisson"), chunk_points, **kw)
    return res_o, res_p


def run(q_grid, n_seeds=8, F=10, T=100.0, wall_rate=1.0, capacity=4096,
        ckpt_dir=None, chunk_points=8, engine="scan", max_chunks=100,
        device="cuda"):
    """``(budgets [P], opt top-1 [P, n_seeds], poisson top-1 [P, n_seeds],
    poisson posts [P, n_seeds])``, the JAX package's result, from
    :func:`run_grids`."""
    res_o, res_p = run_grids(q_grid, n_seeds, F, T, wall_rate, capacity,
                             ckpt_dir, chunk_points, engine, max_chunks,
                             device)
    return (res_o.n_posts.mean(axis=1), res_o.time_in_top_k,
            res_p.time_in_top_k, res_p.n_posts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qgrid", type=float, nargs="*", default=list(QGRID))
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--followers", type=int, default=10)
    ap.add_argument("--horizon", type=float, default=100.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="run both sweeps checkpointed into this directory "
                         "(a killed run resumes bit for bit)")
    ap.add_argument("--chunk-points", type=int, default=8)
    ap.add_argument("--out", default="TRADEOFF_torch.json")
    ap.add_argument("--fig", type=str, default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..parallel.lanes import shape_budget

    dev = resolve_device(args.device)
    # A chunk of about a sixteenth of a lane's events: the events do not
    # depend on it, and a run steps whole chunks.
    cap, mc = shape_budget(args.followers, args.horizon, 1.0)
    budgets, top_o, top_p, posts_p = run(
        args.qgrid, args.seeds, args.followers, args.horizon, capacity=cap,
        ckpt_dir=args.ckpt_dir, chunk_points=args.chunk_points,
        max_chunks=mc, device=dev)
    T = args.horizon
    print(f"{'q':>7} {'budget':>8} {'opt top-1':>10} {'poisson top-1':>14}")
    for q, b, to, tp in zip(args.qgrid, budgets, top_o.mean(1),
                            top_p.mean(1)):
        print(f"{q:>7.2f} {b:>8.1f} {to / T:>10.3f} {tp / T:>14.3f}")
    write_result(args.out, {
        "q_grid": list(args.qgrid), "n_seeds": args.seeds,
        "followers": args.followers, "T": T,
        "budgets": budgets.tolist(),
        "opt_top1_mean": top_o.mean(1).tolist(),
        "poisson_top1_mean": top_p.mean(1).tolist(),
        "poisson_posts_mean": posts_p.mean(1).tolist()},
        "rq.experiment.tradeoff/1", dev)
    print(f"wrote {args.out}")

    if args.fig:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(budgets, top_o.mean(1) / T, "o-", color="black",
                label="RedQueen (Opt)")
        ax.plot(budgets, top_p.mean(1) / T, "s--", color="#888",
                label="budget-matched Poisson")
        ax.set_xlabel("posting budget (posts per horizon)")
        ax.set_ylabel("time-in-top-1 fraction")
        ax.set_xscale("log")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.fig, dpi=150)
        print(f"wrote {args.fig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
