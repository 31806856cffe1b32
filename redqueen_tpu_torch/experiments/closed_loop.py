"""Simulate, fit, re-simulate under control: the closed learning loop on
the port (the counterpart of ``experiments/closed_loop.py``).

1. **Simulate** D self-exciting walls with known parameters over one long
   horizon.
2. **Fit** ``(mu, alpha, beta)`` back out of the log with both solvers
   (EM and Frank-Wolfe, ``learn.fit_hawkes``: every pass over the events
   is the ``hawkes_pass`` kernel on the card); record the recovery errors
   against :data:`TOLERANCES`.
3. **Control**: one RedQueen broadcaster against the TRUE and each
   FITTED world, at the same seeds, one ``run_sweep`` each; the gap in
   the paper's control cost (``int r^2 dt + q * posts``) is the loop's
   end-to-end error.

Writes the enveloped ``rq.learn.closed_loop/1`` artifact (default
``CLOSED_LOOP_torch.json``), with the platform and the card's name.

    python -m redqueen_tpu_torch.experiments.closed_loop [--dims D]
        [--seeds N] [--quick] [--out F.json] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import add_device_argument, write_result

# The JAX package's recovery tolerances (experiments/closed_loop.py:48-53):
# branching ratios are the identifiable quantity, so they get the tight
# absolute bound; the control-cost gap is the end-to-end number.
TOLERANCES = {
    "mu_rel_err": 0.40,
    "branching_abs_err": 0.15,
    "beta_rel_err": 0.60,
    "control_cost_rel_gap": 0.25,
}

# The scan engine's chunk.  Its events do not depend on the chunk (the
# reference builds these components at 4,096), only its cost does: a run
# steps whole chunks, and the card issues a step's operations one by one.
CAPACITY = 256


def true_params(D: int):
    """A deterministic, comfortably subcritical D-dim world (D <= 4)."""
    mu = np.array([0.3, 0.5, 0.4, 0.35])[:D]
    alpha = np.array([0.8, 0.5, 0.6, 0.7])[:D]
    beta = np.array([2.0, 1.5, 2.5, 2.2])[:D]
    return mu, alpha, beta


def _recovery_errors(fit, mu_t, a_t, b_t):
    br_true = a_t / np.maximum(b_t, 1e-300)
    br_fit = np.diag(fit.branching())
    return {
        "mu_rel_err": float(np.max(
            np.abs(fit.mu - mu_t) / np.maximum(mu_t, 1e-300))),
        "branching_abs_err": float(np.max(np.abs(br_fit - br_true))),
        "beta_rel_err": float(np.max(
            np.abs(fit.beta - b_t) / np.maximum(b_t, 1e-300))),
        "offdiag_branching_max": float(np.max(
            fit.branching() - np.diag(np.diag(fit.branching()))))
        if fit.n_dims > 1 else 0.0,
        "mu": fit.mu.tolist(),
        "alpha_diag": np.diag(fit.alpha).tolist(),
        "beta": fit.beta.tolist(),
        "final_loglik": fit.final_loglik,
        "converged": bool(fit.converged),
        "n_iter": int(fit.n_iter),
        "sick_dims": int((fit.health != 0).sum()),
    }


def run(D: int = 3, T_fit: float = 600.0, T_ctrl: float = 100.0,
        q: float = 1.0, n_seeds: int = 8, em_iters: int = 150,
        fw_iters: int = 300, sim_seed: int = 7, ckpt_dir=None, log=None,
        engine="scan", device="cuda"):
    """The payload of ``rq.learn.closed_loop/1`` (its ``passed`` says
    whether every solver recovered within :data:`TOLERANCES`).
    ``engine`` runs the control sweeps, every world on the same one and
    the same seeds: the scan engine by default, as in the JAX package,
    or ``"auto"``, the event kernel on the card."""
    from .. import GraphBuilder, simulate
    from ..device import resolve_device
    from ..learn import control, fit_hawkes, hawkes_loglik, ingest
    from ..sweep import run_sweep

    def _log(*a):
        if log is not None:
            log(*a)

    if not 2 <= D <= 4:
        raise ValueError(f"closed loop is specified for 2-4 dims, got {D}")
    dev = resolve_device(device)
    mu_t, a_t, b_t = true_params(D)

    # ---- 1. simulate the known world (walls only, long horizon) ----
    gb = GraphBuilder(n_sinks=D, end_time=float(T_fit))
    rows = gb.add_hawkes(mu_t, a_t, b_t)
    cfg, params, adj = gb.build(capacity=CAPACITY, device=dev)
    log_fit = simulate(cfg, params, adj, seed=sim_seed, device=dev)
    stream = ingest.from_event_log(log_fit, sources=rows)
    _log(f"closed loop: simulated {stream.n_events} events over "
         f"T={T_fit:g} ({D} dims: {stream.counts().astype(int).tolist()})")
    ll_true = hawkes_loglik(stream, mu_t, np.diag(a_t), b_t,
                            device=dev).loglik

    # ---- 2. fit with both solvers ----
    fits = {}
    for solver, iters in (("em", em_iters), ("fw", fw_iters)):
        ckpt = (os.path.join(ckpt_dir, f"closed_loop_{solver}.npz")
                if ckpt_dir else None)
        fits[solver] = fit_hawkes(stream, solver=solver, max_iters=iters,
                                  tol=1e-7, ckpt_path=ckpt, device=dev)
        err = _recovery_errors(fits[solver], mu_t, a_t, b_t)
        _log(f"closed loop [{solver}]: mu_rel {err['mu_rel_err']:.3f} "
             f"branching_abs {err['branching_abs_err']:.3f} "
             f"beta_rel {err['beta_rel_err']:.3f} "
             f"ll {err['final_loglik']:.1f} (true-params ll {ll_true:.1f})")

    # ---- 3. RedQueen against true vs fitted worlds, same seeds ----
    worlds = {"true": (mu_t, a_t, b_t)}
    worlds.update(fits)
    costs = {}
    for name, world in worlds.items():
        (cfg_c, params_c, adj_c), opt_row = control.control_component(
            world, end_time=float(T_ctrl), q=q, capacity=CAPACITY,
            device=dev)
        res = run_sweep([(cfg_c, params_c, adj_c)], n_seeds=n_seeds,
                        src_index=opt_row, seed0=1000, engine=engine,
                        device=dev)
        lane_costs = control.control_cost(res, q=q).reshape(-1)
        costs[name] = {
            "mean_cost": float(lane_costs.mean()),
            "std_cost": float(lane_costs.std()),
            "mean_posts": float(np.asarray(res.n_posts).mean()),
            "mean_avg_rank": float(np.asarray(res.average_rank).mean()),
            "sick_lanes": int((np.asarray(res.health) != 0).sum()),
        }
        _log(f"closed loop control [{name}]: cost "
             f"{costs[name]['mean_cost']:.2f} +- "
             f"{costs[name]['std_cost']:.2f} "
             f"({costs[name]['mean_posts']:.1f} posts)")

    payload = {
        "dims": D, "T_fit": float(T_fit), "T_ctrl": float(T_ctrl),
        "q": float(q), "n_seeds": int(n_seeds),
        "n_events_fit": stream.n_events,
        "true": {"mu": mu_t.tolist(), "alpha": a_t.tolist(),
                 "beta": b_t.tolist(),
                 "loglik_at_truth": float(ll_true)},
        "solvers": {s: _recovery_errors(f, mu_t, a_t, b_t)
                    for s, f in fits.items()},
        "control_costs": costs,
        "tolerances": dict(TOLERANCES),
    }
    base = costs["true"]["mean_cost"]
    ok = True
    for s in fits:
        gap = abs(costs[s]["mean_cost"] - base) / max(abs(base), 1e-300)
        payload["control_costs"][s]["rel_gap_vs_true"] = float(gap)
        e = payload["solvers"][s]
        within = (e["mu_rel_err"] <= TOLERANCES["mu_rel_err"]
                  and e["branching_abs_err"]
                  <= TOLERANCES["branching_abs_err"]
                  and e["beta_rel_err"] <= TOLERANCES["beta_rel_err"]
                  and gap <= TOLERANCES["control_cost_rel_gap"])
        payload["solvers"][s]["recovered_within_tol"] = bool(within)
        ok &= within
    payload["passed"] = bool(ok)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="simulate -> fit -> re-simulate-under-control "
                    "closed-loop experiment (rq.learn.closed_loop/1)")
    ap.add_argument("--dims", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=None,
                    help="control-phase seed sweep width "
                         "(default: 8, or 4 under --quick)")
    ap.add_argument("--horizon-fit", type=float, default=None,
                    help="fit-phase observation horizon "
                         "(default: 600, or 300 under --quick)")
    ap.add_argument("--horizon-ctrl", type=float, default=100.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--quick", action="store_true",
                    help="shorter horizons + fewer iterations (CI smoke)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for resumable rq.learn.fit/1 "
                         "checkpoints (killed fits continue)")
    ap.add_argument("--out", default="CLOSED_LOOP_torch.json")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)
    # --quick supplies DEFAULTS; an explicit --seeds or --horizon-fit wins.
    kw = dict(em_iters=80, fw_iters=150) if args.quick else {}
    kw["T_fit"] = (args.horizon_fit if args.horizon_fit is not None
                   else (300.0 if args.quick else 600.0))
    kw["n_seeds"] = (args.seeds if args.seeds is not None
                     else (4 if args.quick else 8))
    payload = run(D=args.dims, T_ctrl=args.horizon_ctrl, q=args.q,
                  ckpt_dir=args.ckpt_dir,
                  log=lambda *a: print(*a, file=sys.stderr, flush=True),
                  device=dev, **kw)
    write_result(args.out, payload, "rq.learn.closed_loop/1", dev)
    import json

    print(json.dumps({"passed": payload["passed"],
                      "out": os.path.abspath(args.out)}))
    return 0 if payload["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
