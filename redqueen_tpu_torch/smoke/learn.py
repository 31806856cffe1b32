"""Phase 9 of the smoke run: the learn path through the ``hawkes_pass``
kernel (the kernel and its carries against their plain versions, the
closed-loop world fitted on card and CPU, the config-4 corpus)."""

import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import kernels
from redqueen_tpu_torch.utils import roofline
from .common import check, sync, time_launches


# experiments/closed_loop.py:48-61 (copied: that file imports the JAX
# package): the 3-dim self-exciting world and its recovery tolerances.
WORLD_MU = np.array([0.3, 0.5, 0.4])
WORLD_ALPHA = np.array([0.8, 0.5, 0.6])
WORLD_BETA = np.array([2.0, 1.5, 2.5])
WORLD = dict(end_time=600.0, capacity=4096, seed=7)
RECOVER_TOLERANCES = {"mu_rel_err": 0.40, "branching_abs_err": 0.15,
                      "beta_rel_err": 0.60}
# benchmarks/run.py:283-324: EM 150 iterations, FW 300 after a 30-sweep
# EM warm-up of beta, both at tol 1e-7, each after a warm-up fit.
RECOVER_ITERS = {"em": 150, "fw": 300}
RECOVER_FW_WARMUP = 30
RECOVER_TOL = 1e-7
# The card's fitted parameters against the CPU's (mu, beta relative;
# alpha relative to its largest entry), and final log-likelihoods.  The
# passes differ by float32 ulps (expf/logf, the order of the sum over
# dimensions), and EM's stopping rule can then stop at another sync
# window: the port's CPU fit against the JAX package's stopped at 72
# against 80 iterations with parameters 8.4e-4 apart.
RECOVER_CARD_CPU_RTOL = 5e-3
RECOVER_LL_RTOL = 1e-5
# (c): the config-4 corpus (benchmarks/run.py:326-345, LEARN_BENCH.json):
# 100,000 synthetic users grouped by hash into 64 dimensions, chunks of
# 4,096 events.
CORPUS = dict(seed=7, n_users=100_000, end_time=100.0, mean_rate=1.0,
              max_len=256, n_dims=64)
CORPUS_ROWS = 8_581_381
CORPUS_CHUNK_SHAPE = (2304, 4096)
# EM at 1, 1 and 21 iterations, the marginal seconds of an iteration from
# the warm pair (benchmarks/run.py:336-358 takes 1, 1 and 3): with a pass
# of a few ms, two iterations apart is within the noise of a fit's set-up
# (the stream's copy to the card).
CORPUS_ITERS = (1, 1, 21)
# Kernel against plain version: every output within PASS_RTOL of its
# largest magnitude (float32 per-chunk sums in another order, expf/logf
# ulps), health equal.
PASS_RTOL = 1e-4
# The kernel's carries (phases (A) and (B)) against hawkes_carry_plain on
# the same tensors: every R and Q at a segment start within CARRY_RTOL of
# the largest magnitude (the same folds in the same order; expf ulps).
CARRY_RTOL = 1e-5
# Segments a chunk for a carry check on the CPU, which has no kernel (and
# so no launch shape) of its own; on the card, the pass's own.
CPU_SEGMENTS = 8
EM_DROP_RTOL = 1e-3          # tests/test_learn.py::test_em_loglik_monotone
RESPONSIBILITY_RTOL = 1e-4   # |sum s0 + sum S - n_events| / n_events
# Operations per (event, dimension) of a pass, as the algorithm needs
# them: stats mode the decay (multiply, exp), Q (3), R (1), alpha_ij R_j,
# the sum, S (divide, add) and W (multiply, divide, add); grad mode the
# decay, R, alpha_ij R_j, the sum and g_alpha (multiply, add).
PASS_OPS = {False: 13, True: 7}


def pass_stream(D, n, K, seed, degenerate=True):
    """A random stream of ``n`` events over ``D`` dimensions in chunks of
    ``K`` (padded; dimension 0 degenerate: mu 0 and no excitation, so its
    health bit trips) and its ``(mu, alpha, beta)``."""
    rng = np.random.RandomState(seed)
    T = 50.0
    times = np.sort(rng.uniform(0, T, n))
    dims = rng.randint(0, D, n)
    mu = rng.uniform(0.1, 1.0, D)
    alpha = rng.uniform(0.0, 0.5, (D, D)) / max(D / 8, 1)
    beta = rng.uniform(0.5, 3.0, D)
    if degenerate:
        mu[0] = 0.0
        alpha[0, :] = 0.0
    ch = rt.learn.chunk_events(
        rt.learn.ingest.make_stream(times, dims, D, t_end=T), K)
    return ch, mu, alpha, beta


def pass_inputs(ch, mu, alpha, beta, dev):
    ev = rt.learn.loglik.to_device(ch, dev)
    f = [torch.as_tensor(np.asarray(x, np.float32)).to(dev)
         for x in (mu, alpha, beta)]
    return (ev.dt, ev.dims, ev.mask, ev.tail, *f)


def pass_cross(label, ch, mu, alpha, beta, dev, grad, reps=1):
    """The kernel and its plain version on the same tensors on ``dev``
    (each run ``reps`` times, the last one timed, host clock around a
    device sync): every per-chunk output within PASS_RTOL of its largest
    magnitude, health equal.  Returns the errors and each side's
    milliseconds."""
    from redqueen_tpu_torch.learn import loglik

    args = pass_inputs(ch, mu, alpha, beta, dev)
    times = {}
    outs = {}
    for name, fn in (("kernel", loglik.hawkes_pass),
                     ("plain", loglik.hawkes_pass_plain)):
        for _ in range(reps):  # the last run is timed warm
            sync(dev)
            t0 = time.perf_counter()
            outs[name] = fn(*args, grad=grad)
            sync(dev)
            times[name] = (time.perf_counter() - t0) * 1e3
    k, p = outs["kernel"], outs["plain"]
    names = ("ll", "a", "b", "w", "e")
    err = {}
    for nm, x, y in zip(names, k[:5], p[:5]):
        x, y = x.double().cpu(), y.double().cpu()
        scale = float(y.abs().max())
        d = float((x - y).abs().max())
        err[nm] = (d, d / max(scale, 1e-30))
        check(bool(torch.isfinite(x).all()) and d <= PASS_RTOL * scale,
              f"{label}: {nm} kernel against plain |d| {d:.3g} beyond "
              f"{PASS_RTOL} x {scale:.3g}")
    hk, hp = k[5].cpu(), p[5].cpu()
    check(torch.equal(hk, hp), f"{label}: health {hk.tolist()} against "
                               f"the plain version's {hp.tolist()}")
    C, K = ch.dt.shape
    print(f"{label}: D={ch.n_dims}, {ch.n_events} events in {C} chunks of "
          f"{K}, {'grad' if grad else 'stats'} mode: largest |d| "
          + ", ".join(f"{n} {e[0]:.3g} ({e[1]:.3g} rel)"
                      for n, e in err.items())
          + f"; health {hk.tolist()[:8]} equal; kernel {times['kernel']:.3f} "
          f"ms, plain {times['plain']:.1f} ms")
    return {"max_abs_err": max(e[0] for e in err.values()),
            "max_rel_err": max(e[1] for e in err.values()),
            "health": hk.tolist(), "kernel_ms": times["kernel"],
            "plain_ms": times["plain"],
            "shape": f"D = {ch.n_dims}, {ch.n_events} events in {C} chunks "
                     f"of {K}, {'grad' if grad else 'stats'} mode"}


def carry_cross(label, ch, beta, dev, grad, segments=None):
    """The kernel's phases (A) and (B) against ``hawkes_carry_plain`` on
    the same tensors on ``dev`` (at the kernel's own segments unless
    ``segments`` is given): R and Q at every segment start within
    CARRY_RTOL of their largest magnitude."""
    from redqueen_tpu_torch.learn import loglik

    ev = loglik.to_device(ch, dev)
    b = torch.as_tensor(np.asarray(beta, np.float32)).to(dev)
    if segments is None:
        segments = (kernels.hawkes_segments(ch.n_dims)
                    if ev.dt.device.type == "cuda" else CPU_SEGMENTS)
    kern = loglik.hawkes_carry(ev.dt, ev.dims, ev.mask, b, segments,
                               grad=grad)
    W = kern[0].shape[1]
    plain = loglik.hawkes_carry_plain(ev.dt, ev.dims, ev.mask, b, W,
                                      grad=grad)
    err = {}
    for nm, x, y in zip(("r_in", "q_in"), kern, plain):
        x, y = x.double().cpu(), y.double().cpu()
        scale = float(y.abs().max())
        d = float((x - y).abs().max())
        err[nm] = d / max(scale, 1e-30)
        check(bool(torch.isfinite(x).all()) and d <= CARRY_RTOL * scale,
              f"{label}: {nm} kernel against plain |d| {d:.3g} beyond "
              f"{CARRY_RTOL} x {scale:.3g}")
    print(f"{label}: carries at {ch.dt.shape[0]} x {W} segment starts, "
          f"{'grad' if grad else 'stats'} mode: largest relative |d| "
          + ", ".join(f"{n} {e:.3g}" for n, e in err.items()))
    return {"segments": W, "max_rel_err": max(err.values())}


def pass_parity(dev, small=(5, 3000, 1024), wide=(64, 8, 512)):
    """(a): both modes on a D = 5 stream (padding, chunk boundaries, a
    degenerate dimension) and on a D = 64 stream of 8 chunks."""
    D, n, K = small
    ch5 = pass_stream(D, n, K, seed=5)
    check(ch5[0].dt.shape[0] > 1 and not ch5[0].mask.all(),
          "(a) the D = 5 stream has no chunk boundary or no padding")
    D, C, K = wide
    ch64 = pass_stream(D, C * K - K // 2, K, seed=64)
    check(ch64[0].dt.shape[0] == C, f"(a) {ch64[0].dt.shape[0]} chunks")
    out = {}
    for key, ch in (("d5", ch5), ("d64", ch64)):
        for grad in (False, True):
            out[f"{key}_{'grad' if grad else 'stats'}"] = r = pass_cross(
                f"phase 9 (a) {key}", *ch, dev, grad, reps=2)
            if key == "d5":
                check(r["health"][0] != 0 and not any(r["health"][1:]),
                      f"(a) health {r['health']}: dimension 0 should "
                      f"trip alone")
            r["carry"] = carry_cross(f"phase 9 (a) {key}", ch[0], ch[3],
                                     dev, grad)
    return out


def world_stream(dev, world=WORLD):
    """The closed-loop world simulated by the port on ``dev`` with the
    scan engine, as a fit stream."""
    gb = rt.GraphBuilder(n_sinks=3, end_time=world["end_time"])
    rows = gb.add_hawkes(WORLD_MU, WORLD_ALPHA, WORLD_BETA)
    cfg, params, adj = gb.build(capacity=world["capacity"], device=dev)
    log = rt.simulate(cfg, params, adj, seed=world["seed"], device=dev)
    return rt.learn.from_event_log(log, sources=rows)


def recover_fit(stream, solver, dev, iters=None, warmup=RECOVER_FW_WARMUP):
    """One timed fit after a warm-up fit: ``(fit, seconds, sweeps)``,
    sweeps counting FW's EM warm-up too."""
    iters = RECOVER_ITERS[solver] if iters is None else iters
    rt.learn.fit_hawkes(stream, solver=solver, max_iters=2,
                        fw_beta_warmup=2, device=dev)
    before = kernels.LAUNCHES["hawkes_pass"]
    t0 = time.perf_counter()
    fit = rt.learn.fit_hawkes(stream, solver=solver, max_iters=iters,
                              tol=RECOVER_TOL, fw_beta_warmup=warmup,
                              device=dev)
    secs = time.perf_counter() - t0
    sweeps = fit.n_iter + (warmup if solver == "fw" else 0)
    if torch.device(dev).type == "cuda":
        # Every pass went through the kernel: one per sweep, FW's G, the
        # final score (and a second score if quarantine changed a value).
        want = sweeps + (1 if solver == "fw" else 0) + 1
        got = kernels.LAUNCHES["hawkes_pass"] - before
        check(got - want in (0, 1),
              f"(b) {solver}: {got} hawkes_pass launches for {want} passes")
    return fit, secs, sweeps


def recover_errors(fit):
    br = np.diag(fit.branching())
    return {
        "mu_rel_err": float(np.max(np.abs(fit.mu - WORLD_MU) / WORLD_MU)),
        "branching_abs_err": float(np.max(np.abs(
            br - WORLD_ALPHA / WORLD_BETA))),
        "beta_rel_err": float(np.max(np.abs(fit.beta - WORLD_BETA)
                                     / WORLD_BETA))}


def recover_check(label, fit, ll_true):
    """closed_loop's recovery gate: health zero, each error within its
    tolerance, and the fit scoring at least the truth's likelihood - 1."""
    errs = recover_errors(fit)
    check(not fit.health.any(), f"{label}: health {fit.health.tolist()}")
    for k, tol in RECOVER_TOLERANCES.items():
        check(errs[k] <= tol, f"{label}: {k} {errs[k]:.4f} beyond {tol}")
    check(fit.final_loglik >= ll_true - 1.0,
          f"{label}: final log-likelihood {fit.final_loglik:.3f} below the "
          f"truth's {ll_true:.3f} - 1")
    return errs


def fits_agree(label, card, cpu):
    """The card's fit against the CPU's from the same stream."""
    gaps = {
        "mu": float(np.max(np.abs(card.mu - cpu.mu) / np.abs(cpu.mu))),
        "beta": float(np.max(np.abs(card.beta - cpu.beta)
                             / np.abs(cpu.beta))),
        "alpha": float(np.max(np.abs(card.alpha - cpu.alpha))
                       / max(float(np.abs(cpu.alpha).max()), 1e-30)),
        "final_loglik": abs(card.final_loglik - cpu.final_loglik)
        / abs(cpu.final_loglik)}
    for k in ("mu", "beta", "alpha"):
        check(gaps[k] <= RECOVER_CARD_CPU_RTOL,
              f"{label}: card {k} {gaps[k]:.3g} from the CPU's, beyond "
              f"{RECOVER_CARD_CPU_RTOL}")
    check(gaps["final_loglik"] <= RECOVER_LL_RTOL,
          f"{label}: final log-likelihood {card.final_loglik} on the card, "
          f"{cpu.final_loglik} on the CPU")
    return gaps


def recover(dev, world=WORLD, iters=None):
    """(b): simulate the world on ``dev``, fit it with EM and FW there
    (the main path, its kernel launches counted from 0) and on the CPU,
    gate each."""
    stream = world_stream(dev, world)
    ll_true = rt.learn.hawkes_loglik(stream, WORLD_MU, np.diag(WORLD_ALPHA),
                                     WORLD_BETA, device=dev).loglik
    out = {"n_events": stream.n_events, "ll_true": ll_true}
    n = {s: None if iters is None else iters[s] for s in ("em", "fw")}
    # The main path, with the counts set to 0 just before it and read
    # just after: both fits on ``dev``.
    kernels.reset_launch_counts()
    card = {s: recover_fit(stream, s, dev, n[s]) for s in ("em", "fw")}
    out["launches"] = kernels.LAUNCHES["hawkes_pass"]
    for solver in ("em", "fw"):
        fit, secs, sweeps = card[solver]
        cpu, cpu_secs, _ = recover_fit(stream, solver, torch.device("cpu"),
                                       n[solver])
        label = f"phase 9 (b) {solver}"
        errs = recover_check(label, fit, ll_true)
        recover_check(f"{label} (CPU)", cpu, ll_true)
        gaps = fits_agree(label, fit, cpu)
        out[solver] = {
            "iters": fit.n_iter, "converged": fit.converged, "secs": secs,
            "sweeps": sweeps,
            "events_per_s": stream.n_events * sweeps / max(secs, 1e-9),
            "cpu_iters": cpu.n_iter, "cpu_secs": cpu_secs,
            "final_loglik": fit.final_loglik, "errors": errs,
            "card_vs_cpu": gaps}
        print(f"{label}: {stream.n_events} events, {fit.n_iter} iterations "
              f"(converged {fit.converged}) + {sweeps - fit.n_iter} warm-up "
              f"sweeps in {secs:.3f} s = "
              f"{out[solver]['events_per_s']:,.0f} events/s; CPU "
              f"{cpu.n_iter} iterations in {cpu_secs:.2f} s; errors "
              + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
              + f"; final log-likelihood {fit.final_loglik:.3f} (truth "
              f"{ll_true:.3f}); card against CPU "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    return out


def corpus_chunks(corpus=CORPUS):
    """The config-4 corpus as the reference's learn bench builds it, cut
    to ``corpus`` (the full one by default)."""
    from redqueen_tpu_torch.data.traces import synthetic_twitter

    t0 = time.perf_counter()
    traces = synthetic_twitter(corpus["seed"], corpus["n_users"],
                               corpus["end_time"],
                               mean_rate=corpus["mean_rate"],
                               max_len=corpus["max_len"])
    stream = rt.learn.from_traces(traces, n_dims=corpus["n_dims"],
                                  assign="hash",
                                  t_end=corpus["end_time"])
    return rt.learn.chunk_events(stream), time.perf_counter() - t0


def corpus_bound(ch, grad=False):
    """Least time of one pass over ``ch``: bytes (every input read once,
    every output written once) over HBM bandwidth, and the operations
    this stream's events need over the float32 issue rate
    (``utils.roofline``)."""
    C, K = ch.dt.shape
    D = ch.n_dims
    in_bytes = C * K * (4 + 4 + 1 + 4) + (2 * D + D * D) * 4
    out_bytes = (C * (1 + 3 * D + D * D) + D) * 4
    ops = ch.n_events * D * PASS_OPS[grad]
    return {"bytes": in_bytes + out_bytes, "ops": ops,
            **roofline.bound(in_bytes + out_bytes, ops)}


# The three launches of one pass, by the name the profiler gives each.
PASS_PHASES = (("A", "summary_kernel"), ("B", "carry_kernel"),
               ("C", "pass_kernel"))


def pass_phase_ms(args, grad=False, reps=3):
    """Device milliseconds of each phase of one kernel pass over ``args``
    (``pass_inputs``), from ``torch.profiler``'s CUDA trace over ``reps``
    passes, and each one's share of their sum; ``None`` where the trace
    holds no device time for the pass's kernels (or on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from redqueen_tpu_torch.learn import loglik

    if args[0].device.type != "cuda":
        return None
    loglik.hawkes_pass(*args, grad=grad)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            loglik.hawkes_pass(*args, grad=grad)
        torch.cuda.synchronize()
    us = dict.fromkeys((k for k, _ in PASS_PHASES), 0.0)
    for ev in prof.key_averages():
        for key, name in PASS_PHASES:
            if name in ev.key:
                us[key] += ev.device_time_total
    total = sum(us.values())
    if total <= 0:
        return None
    return {"ms": {k: v / reps / 1e3 for k, v in us.items()},
            "share": {k: v / total for k, v in us.items()}}


def responsibilities_identity(out, n_events):
    """Each event's p0 + sum_j pr_j is 1, so sum s0 + sum S is the event
    count on a healthy pass."""
    total = float(out[1].double().sum() + out[2].double().sum())
    gap = abs(total - n_events)
    check(gap <= RESPONSIBILITY_RTOL * n_events,
          f"(c) sum s0 + sum S = {total:.1f} against {n_events} events")
    return total, gap


def corpus_fit(dev, corpus=CORPUS, rows=CORPUS_ROWS,
               chunk_shape=CORPUS_CHUNK_SHAPE, iters=CORPUS_ITERS,
               timed=None):
    """(c): EM on the corpus at ``iters`` iterations, each fit timed to
    its end (``fit_hawkes`` returns host values), the marginal seconds
    per iteration (warm-3 - warm-1) / 2 as benchmarks/run.py:336-358
    takes them, and the gates."""
    ch, build_s = corpus_chunks(corpus)
    check(ch.n_events == rows, f"(c) corpus of {ch.n_events} rows, "
                               f"expected {rows}")
    check(tuple(ch.dt.shape) == tuple(chunk_shape),
          f"(c) chunk shape {tuple(ch.dt.shape)}, expected {chunk_shape}")
    walls, fits = [], []
    kernels.reset_launch_counts()  # the main path: counts from 0
    for n in iters:
        t0 = time.perf_counter()
        fits.append(rt.learn.fit_hawkes(ch, solver="em", max_iters=n,
                                        tol=0.0, device=dev))
        walls.append(time.perf_counter() - t0)
    launches = kernels.LAUNCHES["hawkes_pass"]
    fit = fits[-1]
    check(not fit.health.any(), f"(c) health {fit.health.tolist()}")
    curve = fit.loglik
    drops = np.diff(curve)
    check(len(curve) == iters[-1] and (
        drops.min(initial=0.0) >= -abs(curve[-1]) * EM_DROP_RTOL),
        f"(c) the EM curve {curve.tolist()} falls by more than "
        f"{EM_DROP_RTOL} relative")
    per_iter = max((walls[2] - walls[1]) / max(iters[2] - iters[1], 1),
                   1e-9)
    res = {"rows": ch.n_events, "chunk_shape": list(ch.dt.shape),
           "n_dims": ch.n_dims, "build_s": build_s, "walls_s": walls,
           "secs_per_iter": per_iter,
           "events_per_s_fitted": ch.n_events / per_iter,
           "launches": launches, "curve": curve.tolist()}
    return res, ch, fit


def corpus_pass_checks(ch, fit, dev, n_compare=8):
    """(c)'s pass checks at the fitted parameters: the kernel timed on
    the whole corpus (on the card; on the CPU its plain version runs once
    untimed), the responsibilities identity, and the kernel against its
    plain version on the first ``n_compare`` chunks."""
    from redqueen_tpu_torch.learn import loglik

    args = pass_inputs(ch, fit.mu, fit.alpha, fit.beta, dev)
    if args[0].device.type == "cuda":
        ms, host_ms, out = time_launches(loglik.hawkes_pass, *args,
                                         reps=10)
    else:
        ms, host_ms, out = [], [], loglik.hawkes_pass(*args)
    total, gap = responsibilities_identity(out, ch.n_events)
    phases = pass_phase_ms(args)
    head = ch._replace(dt=ch.dt[:n_compare], dims=ch.dims[:n_compare],
                       mask=ch.mask[:n_compare], tail=ch.tail[:n_compare],
                       n_events=int(ch.mask[:n_compare].sum()))
    cross = pass_cross(f"phase 9 (c) first {n_compare} chunks", head,
                       fit.mu, fit.alpha, fit.beta, dev, grad=False)
    return {"kernel_ms": ms, "kernel_with_host_ms": host_ms,
            "phases": phases, "responsibility_sum": total,
            "responsibility_gap": gap, "cross": cross,
            "bound": corpus_bound(ch)}


def phase_learn(dev):
    """Phase 9."""
    t0 = time.perf_counter()
    res = {"parity": pass_parity(dev)}
    res["recover"] = recover(dev)
    res["corpus"], ch, fit = corpus_fit(dev)
    res["corpus"].update(corpus_pass_checks(ch, fit, dev))
    c = res["corpus"]
    res["launches"] = res["recover"]["launches"] + c["launches"]
    check(res["launches"] > 0, "phase 9: the fits launched no hawkes_pass")
    print(f"phase 9 (c) corpus: {c['rows']} events x {c['n_dims']} dims in "
          f"chunks {c['chunk_shape']} (built in {c['build_s']:.1f} s); EM "
          f"walls {['%.3f' % w for w in c['walls_s']]} s for "
          f"{list(CORPUS_ITERS)} iterations: {c['secs_per_iter']:.3f} s per "
          f"iteration = {c['events_per_s_fitted']:,.0f} events/s fitted; "
          f"hawkes_pass launches {c['launches']}; kernel "
          f"{['%.3f' % m for m in c['kernel_ms']]} ms per pass against a "
          f"bound of {c['bound']['bound_ms']:.4f} ms by "
          f"{c['bound']['bound_by']}; sum s0 + sum S - n_events "
          f"{c['responsibility_gap']:.3g}; curve {c['curve']}")
    ph = c["phases"]
    print("phase 9 (c) the pass's phases on the device: " + (
        ", ".join(f"({k}) {ph['ms'][k]:.3f} ms ({100 * ph['share'][k]:.1f}%)"
                  for k, _ in PASS_PHASES)
        if ph else "not measured (the profiler saw no device time)"))
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 9 learn: {res['phase_s']:.1f} s, hawkes_pass launches on "
          f"the main path {res['launches']}")
    return res
