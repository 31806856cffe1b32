"""The paper's figure 1 on the port: RedQueen against the baselines on
diurnal walls, at a matched posting budget (the counterpart of
``experiments/compare_policies.py``).

The controlled broadcaster posts into F feeds whose walls follow a
square-wave day/night profile; against RedQueen's realised budget run
budget-matched Poisson, budget-matched Hawkes (bursty), the offline
water-filling schedule (``baselines.offline_schedule``), a busy-hours
"real user" replay, and the learned RMTPP policy (BASELINE config 5):
its weights are the committed ``redqueen_tpu_torch/data/
rmtpp_checkpoint0.npz`` when that file's training provenance matches the
run, else trained here (``models.rmtpp.fit_traces``) and saved through
``utils.checkpoint`` when ``--rmtpp-ckpt`` names a directory.

    python -m redqueen_tpu_torch.experiments.compare_policies [--seeds N]
        [--followers F] [--horizon T] [--q Q] [--out F.json]
        [--csv out.csv] [--fig out.png] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import add_device_argument, write_result

#: The committed weights (the JAX package's trained checkpoint, exported).
RMTPP_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "rmtpp_checkpoint0.npz")


def diurnal_profile(T: float, lo: float = 0.3, hi: float = 2.5,
                    n_cycles: int = 2):
    """Square-wave day/night wall intensity: ``n_cycles`` quiet/busy pairs."""
    seg = T / (2 * n_cycles)
    change_times = np.arange(2 * n_cycles) * seg
    rates = np.tile([lo, hi], n_cycles)
    return change_times, rates


def _human_trace(rng, change_times, rates, T, n_posts):
    """A synthetic 'real user': post times drawn in proportion to the
    walls' activity (people post when everyone else does)."""
    durs = np.diff(np.concatenate([change_times, [T]]))
    w = rates * durs
    seg = rng.choice(len(rates), size=n_posts, p=w / w.sum())
    return np.sort(change_times[seg] + rng.uniform(0, durs[seg]))


def _saved_weights(ckpt, device):
    """``(weights, info)`` from ``ckpt`` (an RMTPP npz, or a
    ``utils.checkpoint`` directory), or None when there is none."""
    from ..convert import load_rmtpp_npz
    from ..utils import checkpoint

    if ckpt is None:
        return None
    if ckpt.endswith(".npz"):
        if not os.path.exists(ckpt):
            return None
        return load_rmtpp_npz(ckpt, device=device)
    try:
        saved = checkpoint.restore(ckpt)
    except FileNotFoundError:
        return None
    weights = _to_device(saved["weights"], device)
    return weights, saved.get("info", {})


def _to_device(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), dtype=torch.float32).to(device)


def _trained_rmtpp_weights(budget: float, T: float, ckpt: str = None,
                           hidden: int = 16, steps: int = 200,
                           n_users: int = 48, device="cuda"):
    """Weights for the learned-policy line, trained on a synthetic corpus
    whose mean rate is the budget's.  A saved checkpoint is reused only
    when its ``trained_on`` provenance matches this run (the same T and
    hidden size, a mean rate within a factor e^0.25): a ``--horizon`` or
    ``--q`` change moves the budget, and stale weights would break the
    premise.  A retrained checkpoint is saved into ``ckpt`` when it is a
    directory (the committed npz is never overwritten)."""
    from ..data import traces as tr
    from ..models import rmtpp
    from ..utils import checkpoint

    trained_on = {"T": float(T), "mean_rate": float(budget / T),
                  "hidden": float(hidden), "steps": float(steps),
                  "n_users": float(n_users)}
    saved = _saved_weights(ckpt, device)
    if saved is not None:
        weights, info = saved
        old = {k: float(v) for k, v in info.get("trained_on", {}).items()}
        if (old.get("T") == trained_on["T"]
                and old.get("hidden") == trained_on["hidden"]
                and old.get("mean_rate") is not None
                and abs(np.log(old["mean_rate"]
                               / trained_on["mean_rate"])) < 0.25):
            return weights, info
        print(f"checkpoint at {ckpt} was trained on {old}; this run needs "
              f"{trained_on} — retraining", file=sys.stderr)
    corpus = tr.synthetic_twitter(seed=11, n_users=n_users, end_time=T,
                                  mean_rate=budget / T)
    weights, _, info = rmtpp.fit_traces(9, corpus, hidden=hidden,
                                        steps=steps, device=device)
    info["trained_on"] = trained_on
    if ckpt and not ckpt.endswith(".npz"):
        checkpoint.save(ckpt, 0, {"weights": weights, "info": info})
    return weights, info


def run(n_seeds=16, F=10, T=96.0, q=0.4, lo=0.3, hi=2.5, capacity=4096,
        rmtpp_ckpt=None, rmtpp_steps=200, engine="scan", device="cuda"):
    """``(results, budget, T)``: ``results[policy] = (time_in_top_1,
    average_rank, posts)``, each [n_seeds], for ``opt``, ``poisson``,
    ``hawkes``, ``offline``, ``replay`` and ``rmtpp``.  ``engine`` goes
    to every sweep: the scan engine by default, as in the JAX package;
    ``"auto"`` runs each policy the event kernel covers on it on the card
    (RMTPP stays on the scan engine).  The scan engine's events do not
    depend on ``capacity``, only its cost does, as long as 64 chunks hold
    a lane's events."""
    from .. import GraphBuilder, baselines, run_sweep
    from ..device import resolve_device
    from ..models import rmtpp as rmtpp_mod

    dev = resolve_device(device)
    ct, wall_rates = diurnal_profile(T, lo, hi)

    def point(add_me):
        """One sweep point: the policy under test vs F diurnal walls."""
        gb = GraphBuilder(n_sinks=F, end_time=T)
        add_me(gb)
        for i in range(F):
            gb.add_piecewise(ct, wall_rates, sinks=[i])
        return gb.build(capacity=capacity, device=dev)

    def evaluate(points, seed0, n=n_seeds):
        res = run_sweep(points, n_seeds=n, seed0=seed0, max_chunks=64,
                        engine=engine, device=dev)
        return (res.time_in_top_k.reshape(-1),
                res.average_rank.reshape(-1),
                res.n_posts.reshape(-1))

    results = {}
    # 1) RedQueen fixes the budget everyone else must match.
    top, rank, posts = evaluate([point(lambda gb: gb.add_opt(q=q))], 0)
    budget = float(posts.mean())
    results["opt"] = (top, rank, posts)
    # 2) Budget-matched Poisson.
    rate = baselines.budget_matched_poisson_rate(budget, T)
    results["poisson"] = evaluate(
        [point(lambda gb: gb.add_poisson(rate=rate))], 1000)
    # 2b) Budget-matched Hawkes (branching ratio 1/2, l0 matching the
    # budget in expectation).
    beta_h, alpha_h = 2.0, 1.0
    l0_h = (budget / T) * (1 - alpha_h / beta_h)
    results["hawkes"] = evaluate(
        [point(lambda gb: gb.add_hawkes(l0=l0_h, alpha=alpha_h,
                                        beta=beta_h))], 4000)
    # 3) The offline schedule at the same budget.
    ct_off, mu = baselines.offline_schedule(
        np.tile(wall_rates, (F, 1)), ct, T, budget, device=dev)
    results["offline"] = evaluate(
        [point(lambda gb: gb.add_piecewise(ct_off, mu))], 2000)
    # 4) "Real user" replay: each lane a distinct trace, so the lanes are
    # sweep points with one seed each.
    rng = np.random.RandomState(7)
    n_posts = max(int(round(budget)), 1)
    replay_pts = [
        point(lambda gb: gb.add_realdata(
            _human_trace(rng, ct, wall_rates, T, n_posts)))
        for _ in range(n_seeds)]
    results["replay"] = evaluate(replay_pts, 3000, n=1)
    # 5) The learned policy, its budget calibrated (a bias shift in
    # log-intensity).
    weights, _info = _trained_rmtpp_weights(budget, T, ckpt=rmtpp_ckpt,
                                            steps=rmtpp_steps, device=dev)
    weights = rmtpp_mod.calibrate_budget(weights, budget, T, device=dev)
    cfg_r, params_r, adj_r = point(lambda gb: gb.add_rmtpp())
    results["rmtpp"] = evaluate(
        [(cfg_r, rmtpp_mod.attach(params_r, weights), adj_r)], 5000)
    return results, budget, T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--followers", type=int, default=10)
    ap.add_argument("--horizon", type=float, default=96.0)
    ap.add_argument("--q", type=float, default=0.4)
    ap.add_argument("--out", default="COMPARE_POLICIES_torch.json")
    ap.add_argument("--fig", type=str, default=None)
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--rmtpp-ckpt", type=str, default=RMTPP_NPZ,
                    help="the learned policy's weights: an RMTPP npz or a "
                         "checkpoint directory (reused when its provenance "
                         "matches; a directory receives retrained weights)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..parallel.lanes import shape_budget

    dev = resolve_device(args.device)
    # A chunk of about a sixteenth of a lane's events at the walls' mean
    # rate (the events do not depend on it, and a run steps whole chunks);
    # 64 of them, run()'s allowance, hold four times a lane's events.
    _, wall_rates = diurnal_profile(args.horizon)
    cap, _ = shape_budget(args.followers, args.horizon,
                          float(wall_rates.mean()))
    t0 = time.perf_counter()
    results, budget, T = run(args.seeds, args.followers, args.horizon,
                             args.q, capacity=cap, rmtpp_ckpt=args.rmtpp_ckpt,
                             device=dev)
    hdr = f"{'policy':<10} {'top-1 frac':>11} {'avg rank':>9} {'posts':>7}"
    print(f"matched budget ~ {budget:.1f} posts over T={T}")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for name, (top, rank, posts) in results.items():
        row = (name, float(top.mean() / T), float(rank.mean()),
               float(posts.mean()))
        rows.append(row)
        print(f"{row[0]:<10} {row[1]:>11.3f} {row[2]:>9.2f} {row[3]:>7.1f}")
    write_result(args.out, {
        "n_seeds": args.seeds, "followers": args.followers, "T": T,
        "q": args.q, "budget": budget, "capacity": cap,
        "wall_s": time.perf_counter() - t0,
        "policies": {name: {"top1": top.tolist(), "avg_rank": rank.tolist(),
                            "posts": posts.tolist()}
                     for name, (top, rank, posts) in results.items()}},
        "rq.experiment.compare_policies/1", dev)
    print(f"wrote {args.out}")

    if args.csv:
        import csv
        import io

        from ..runtime import atomic_write_text

        buf = io.StringIO(newline="")
        w = csv.writer(buf)
        w.writerow(["policy", "top1_fraction", "avg_rank", "posts"])
        w.writerows(rows)
        atomic_write_text(args.csv, buf.getvalue())
        print(f"wrote {args.csv}")

    if args.fig:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = [r[0] for r in rows]
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
        for ax, idx, label in ((axes[0], 1, "time-in-top-1 fraction"),
                               (axes[1], 2, "time-averaged rank")):
            ax.bar(names, [r[idx] for r in rows], color="#888",
                   edgecolor="black")
            ax.set_ylabel(label)
        fig.suptitle(f"RedQueen vs baselines, matched budget ({budget:.0f} "
                     f"posts, diurnal walls)")
        fig.tight_layout()
        fig.savefig(args.fig, dpi=150)
        print(f"wrote {args.fig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
