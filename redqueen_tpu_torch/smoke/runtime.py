"""Phase 12 of the smoke run: the runtime and the paper's experiments on
the card.

(a) The trade-off experiment (``tradeoff.run_grids``) at the headline's
width: 6 values of q x 1,667 seeds = 10,002 lanes of one ``Opt``
against 10 Poisson walls, T = 100, then the budget-matched Poisson half
at the same width, both through ``run_sweep_checkpointed`` on the event
kernel, in a child under ``Supervisor(backend="default",
allow_degrade=False)``.  The child is SIGTERMed once its first chunk
lands, the retry resumes it, and both grids must equal an uninterrupted
in-process run bit for bit; then a flipped byte in one chunk is
quarantined and only that chunk recomputes.  (b) The trade-off's
finding: RedQueen's time-in-top-1 above Poisson's at every q, by more
than 4 standard errors at q = 1.  (c) ``closed_loop`` at its defaults,
inside its tolerances, through ``hawkes_pass``.  (d) ``compare_policies``
at its defaults on the card and on the card machine's CPU (processes of
their own, started first and run beside the rest), the orderings the
JAX package's experiment tests assert, the card within 4 sigma of the
CPU; ``rank_timeline``'s checks.  (e) ``live_swap --quick`` with its
learner kill.  (f) The native trace loader built with g++, a
100,000-user corpus of about 10^6 rows loaded by both engines, equal.
(g) The card's liveness probe and ``ensure_backend``."""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.experiments import (closed_loop, live_swap,
                                            rank_timeline, tradeoff)
from redqueen_tpu_torch.ops import kernels
from redqueen_tpu_torch.runtime import supervisor, telemetry
from .common import check

#: The trade-off sweep: the reference's --qgrid, 1,667 seeds a point
#: (10,002 lanes, the headline's width), 10 Poisson walls of rate 1.
SWEEP = dict(q_grid=tradeoff.QGRID, n_seeds=1667, F=10, T=100.0,
             wall_rate=1.0)
CHUNK_POINTS = 2
ENGINE = "pallas"
#: RedQueen above Poisson by more than this many standard errors of the
#: difference at q = 1 (the paper's claim).
SE_GATE = 4.0
#: compare_policies at its defaults (16 seeds, F = 10, T = 96, q = 0.4)
#: but two, which fit the phase in its budget: every sweep the event
#: kernel covers runs on it (``engine="auto"``: on the card; the CPU's
#: process runs the scan engine, a 4-sigma comparison), and the scan
#: engine steps chunks of 64 (its events do not depend on the chunk).
#: The scan engine on a few lanes costs ~10 ms a step on the card's
#: host: every sweep on it took the phase to 244.8 s (PERF.md).
COMPARE = dict(n_seeds=16, F=10, T=96.0, q=0.4, capacity=64, engine="auto")
#: closed_loop at its defaults, its control sweeps on the event kernel.
CLOSED_LOOP = dict(engine="auto")
COMPARE_SIGMA = 4.0
RANK = dict(T=100.0, F=5, seed=0, capacity=256)
#: The native loader's corpus: 100,000 users, about 10 rows each.
CORPUS = dict(seed=5, n_users=100_000, end_time=10.0)
BUDGET_S = 150.0
# How long the phase waits, at most, for the probes and for a
# compare_policies process (the budget check comes after).
PROBE_WAIT_S = 120.0
COMPARE_WAIT_S = 300.0


def grids(settings, device, **kw):
    """The trade-off experiment's two grids (``tradeoff.run_grids``) at
    ``settings`` on the event kernel, at ``shape_budget``'s chunk."""
    cap, mc = rt.shape_budget(settings["F"], settings["T"],
                              settings["wall_rate"])
    return tradeoff.run_grids(**settings, capacity=cap, engine=ENGINE,
                              max_chunks=mc, device=device, **kw)


def sweep_child(ckpt_dir, settings, device, pid_file):
    """The supervised child: the checkpointed trade-off experiment on
    ``device`` with telemetry on.  Returns the platform the sweep ran on
    (``"cuda"`` only when it launched the event kernel), its launches
    (the wrapper's count) and ``engine.pallas.launches``."""
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    telemetry.configure(enabled=True, reset=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    grids(settings, device, ckpt_dir=ckpt_dir, chunk_points=CHUNK_POINTS)
    launches = kernels.LAUNCHES["event_kernel"]
    return {"platform": "cuda" if launches else "cpu",
            "event_kernel_launches": launches,
            "pallas_launches": telemetry.get().counters.get(
                "engine.pallas.launches", 0),
            "wall_s": time.perf_counter() - t0}


def _chunks(ckpt_dir):
    """``{"<half>/chunk_*.npz": mtime}`` over both halves' directories."""
    out = {}
    for half in ("opt", "poisson"):
        d = os.path.join(ckpt_dir, half)
        if os.path.isdir(d):
            out.update({f"{half}/{f}": os.path.getmtime(os.path.join(d, f))
                        for f in sorted(os.listdir(d))
                        if f.startswith("chunk_") and f.endswith(".npz")})
    return out


def _kill_after_first_chunk(ckpt_dir, pid_file, stop, seen):
    """SIGTERM the child whose pid is in ``pid_file`` once the RedQueen
    half's ``chunk_00000.npz`` has landed; ``seen`` gets the chunks on
    disk at that moment and the pid."""
    first = os.path.join(ckpt_dir, "opt", "chunk_00000.npz")
    while not stop.is_set():
        if os.path.exists(first) and os.path.exists(pid_file):
            pid = int(open(pid_file).read())
            seen["chunks"] = _chunks(ckpt_dir)
            seen["pid"] = pid
            os.kill(pid, signal.SIGTERM)
            return
        time.sleep(0.002)


def flip_payload_byte(path, member="time_in_top_k.npy"):
    """Flip one bit of the last byte of ``member``'s data in the npz at
    ``path`` (a byte the archive's CRC and the envelope's sha256 both
    cover; a flip in a zip header field may go unread).  Returns the
    offset."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as z:
        info = z.getinfo(member)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        off = (info.header_offset + 30 + name_len + extra_len
               + info.compress_size - 1)
        f.seek(off)
        b = f.read(1)[0]
        f.seek(off)
        f.write(bytes([b ^ 0x01]))
    return off


def same_grids(a, b):
    """Two ``(opt, poisson)`` pairs of ``SweepResult``: every field of
    both halves bit for bit."""
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def lane_events(pts, n, seed0, mc, dev):
    """``(events, posts [P, n])`` of ``run_sweep``'s lanes for ``pts``
    (its stacking and seeds), from ``simulate_batch``."""
    params, adj = rt.stack_components(
        [p for _, p, _ in pts for _ in range(n)],
        [a for _, _, a in pts for _ in range(n)])
    log = rt.simulate_batch(pts[0][0], params, adj,
                            seed0 + np.arange(len(pts) * n), max_chunks=mc,
                            engine=ENGINE, device=dev)
    posts = rt.num_posts(log.srcs, 0).reshape(len(pts), n).cpu().numpy()
    return int(log.n_events.sum()), posts


def supervised_sweep(dev, settings, tmp):
    """(a): the trade-off experiment, checkpointed, supervised, killed and
    resumed, against the uninterrupted run, then a corrupt chunk; returns
    the measurements and the uninterrupted run's ``(opt, poisson)``."""
    ckpt = os.path.join(tmp, "sweep")
    os.makedirs(ckpt)
    pid_file = os.path.join(tmp, "child.pid")
    stop, seen = threading.Event(), {}
    killer = threading.Thread(target=_kill_after_first_chunk,
                              args=(ckpt, pid_file, stop, seen), daemon=True)
    sup = supervisor.Supervisor(
        name="phase12-sweep", backend="default", allow_degrade=False,
        retry=supervisor.RetryPolicy(max_attempts=2, base_delay_s=0.2,
                                     jitter=0.0),
        deadline_s=600.0, report_dir=os.path.join(tmp, "reports"))
    killer.start()
    t0 = time.perf_counter()
    try:
        report = sup.run(sweep_child, kwargs=dict(
            ckpt_dir=ckpt, settings=settings, device=str(dev),
            pid_file=pid_file))
    finally:
        stop.set()
        killer.join(5.0)
    supervised_s = time.perf_counter() - t0
    outcomes = [a.outcome for a in report.attempts]
    check(report.ok and outcomes == ["crash", "ok"]
          and report.attempts[0].returncode == -signal.SIGTERM,
          f"phase 12 (a): the supervised sweep gave {outcomes} (rc "
          f"{[a.returncode for a in report.attempts]}); want a SIGTERMed "
          f"first attempt and a resumed second")
    check(report.backend_used == dev.type and not report.degraded
          and not report.degradations,
          f"phase 12 (a): backend_used {report.backend_used!r}, degraded "
          f"{report.degraded}; want {dev.type!r} with no degradation")
    after = _chunks(ckpt)
    n_chunks = 2 * -(-len(settings["q_grid"]) // CHUNK_POINTS)
    check(len(after) == n_chunks, f"phase 12 (a): {len(after)} chunks "
          f"on disk, want {n_chunks}")
    kept = [f for f, t in seen["chunks"].items() if after.get(f) == t]
    check(sorted(kept) == sorted(seen["chunks"]), "phase 12 (a): the "
          "resume recomputed a chunk that had landed before the kill")
    recomputed = (n_chunks - len(kept)) / n_chunks
    child = report.result

    n = settings["n_seeds"]
    l0 = kernels.LAUNCHES["event_kernel"]
    t0 = time.perf_counter()
    ref = grids(settings, dev)
    ref_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["event_kernel"] - l0
    # Loaded, not recomputed: every chunk verifies and matches.
    resumed = grids(settings, dev, ckpt_dir=ckpt, chunk_points=CHUNK_POINTS)
    check(_chunks(ckpt) == after and kernels.LAUNCHES["event_kernel"]
          == l0 + launches, "phase 12 (a): a complete checkpoint "
          "recomputed")
    check(same_grids(resumed, ref), "phase 12 (a): the resumed sweep's "
          "grids differ from the uninterrupted run's")
    # The events of the same lanes, and their posts against the grids'.
    cap, mc = rt.shape_budget(settings["F"], settings["T"],
                              settings["wall_rate"])
    sets = dict(q_grid=settings["q_grid"], F=settings["F"],
                T=settings["T"], wall_rate=settings["wall_rate"],
                capacity=cap, device=dev)
    ev_o, posts_o = lane_events(tradeoff.opt_points(**sets), n, 0, mc, dev)
    ev_p, posts_p = lane_events(tradeoff.poisson_points(
        budgets=ref[0].n_posts.mean(axis=1), **sets), n, 10_000, mc, dev)
    events = ev_o + ev_p
    check(np.array_equal(posts_o, ref[0].n_posts)
          and np.array_equal(posts_p, ref[1].n_posts), "phase 12 (a): the "
          "sweeps' posts differ from simulate_batch's on the same lanes")

    victim = "opt/chunk_00001.npz"
    flip_payload_byte(os.path.join(ckpt, victim))
    before = _chunks(ckpt)
    again = grids(settings, dev, ckpt_dir=ckpt, chunk_points=CHUNK_POINTS)
    now = _chunks(ckpt)
    quarantined = [f for f in os.listdir(os.path.join(ckpt, "opt"))
                   if f.startswith("chunk_00001.npz.corrupt-")
                   and not f.endswith(".report.json")]
    check(len(quarantined) == 1, f"phase 12 (a): quarantined {quarantined} "
          f"in {sorted(os.listdir(os.path.join(ckpt, 'opt')))}")
    check(all(now[f] == t for f, t in before.items() if f != victim)
          and now[victim] != before[victim], "phase 12 (a): the corrupt "
          "run recomputed another chunk than the corrupt one")
    check(same_grids(again, ref), "phase 12 (a): the grids after the "
          "corrupt chunk's recompute differ")
    out = {"lanes": len(settings["q_grid"]) * n,
           "points": len(settings["q_grid"]), "seeds": n, "capacity": cap,
           "chunks": n_chunks,
           "attempts": [a.to_dict() for a in report.attempts],
           "backend_used": report.backend_used,
           "backoff_s": report.backoff_schedule,
           "supervised_s": supervised_s, "child": child,
           "recomputed_share": recomputed, "uninterrupted_s": ref_s,
           "events": events, "events_per_s": events / ref_s,
           "uninterrupted_launches": launches,
           "quarantined": "opt/" + quarantined[0]}
    if dev.type == "cuda":
        check(child["event_kernel_launches"] > 0
              and child["event_kernel_launches"]
              == child["pallas_launches"], f"phase 12 (a): the child's "
              f"event-kernel launches {child['event_kernel_launches']} "
              f"against engine.pallas.launches {child['pallas_launches']}")
        check(launches > 0, "phase 12 (a): the uninterrupted run "
              "launched no event kernel")
    print(f"phase 12 (a) trade-off {out['lanes']} lanes a half "
          f"({out['points']} q x {n} seeds, RedQueen then budget-matched "
          f"Poisson, {n_chunks} chunks of {CHUNK_POINTS} points): "
          f"supervised {supervised_s:.1f} s, attempts {outcomes} (SIGTERM "
          f"after RedQueen's chunk 0), backend {report.backend_used}, the "
          f"resume computed {recomputed:.2f} of the chunks; uninterrupted "
          f"{ref_s:.3f} s, {events:,} events, {out['events_per_s']:,.0f} "
          f"events/s; grids bit-identical; corrupt chunk quarantined and "
          f"recomputed; child launches {child['event_kernel_launches']}")
    return out, ref


def tradeoff_finding(settings, opt, poisson):
    """(b): RedQueen's time-in-top-1 above the budget-matched Poisson
    half's at every q, by more than :data:`SE_GATE` standard errors at
    q = 1."""
    n = settings["n_seeds"]
    budgets = opt.n_posts.mean(axis=1)
    to = opt.time_in_top_k.astype(np.float64)
    tp = poisson.time_in_top_k.astype(np.float64)
    diff = to.mean(1) - tp.mean(1)
    se = np.sqrt(to.var(1, ddof=1) / n + tp.var(1, ddof=1) / n)
    z = diff / np.maximum(se, 1e-12)
    q = list(settings["q_grid"])
    check(bool(np.all(diff > 0)), f"phase 12 (b): RedQueen's time-in-top-1 "
          f"is not above Poisson's at every q: differences {diff}")
    check(z[q.index(1.0)] > SE_GATE, f"phase 12 (b): at q = 1 RedQueen "
          f"leads by {z[q.index(1.0)]:.2f} standard errors, want > "
          f"{SE_GATE}")
    print("phase 12 (b) RedQueen - Poisson time-in-top-1 at matched "
          "budget: " + "; ".join(
              f"q {qq:g}: {d:.3f} ({zz:.1f} se, budget {b:.1f})"
              for qq, d, zz, b in zip(q, diff, z, budgets)))
    return {"q": q, "budgets": budgets.tolist(),
            "opt_mean": to.mean(1).tolist(), "poisson_mean":
            tp.mean(1).tolist(), "poisson_posts": poisson.n_posts.mean(1)
            .tolist(), "diff": diff.tolist(), "se": se.tolist(),
            "z": z.tolist()}


def closed_loop_run(dev, **kw):
    """(c): closed_loop at its defaults (or ``kw``), its tolerances and
    its ``hawkes_pass`` launches."""
    before = kernels.LAUNCHES["hawkes_pass"]
    t0 = time.perf_counter()
    payload = closed_loop.run(device=dev, **kw)
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["hawkes_pass"] - before
    check(payload["passed"], "phase 12 (c): closed_loop outside its "
          f"tolerances: {json.dumps(payload['solvers'])[:400]}")
    if dev.type == "cuda":
        check(launches > 0, "phase 12 (c): no hawkes_pass launch")
    print(f"phase 12 (c) closed_loop: {payload['n_events_fit']} events, "
          f"passed, {launches} hawkes_pass launches, {wall:.2f} s")
    return {"wall_s": wall, "launches": launches,
            "n_events_fit": payload["n_events_fit"],
            "solvers": {s: {k: e[k] for k in ("mu_rel_err",
                                               "branching_abs_err",
                                               "beta_rel_err", "n_iter")}
                        for s, e in payload["solvers"].items()},
            "control_gap": {s: payload["control_costs"][s][
                "rel_gap_vs_true"] for s in payload["solvers"]}}


def compare_child(device, out, settings):
    """The body of a compare process: ``compare_policies.run`` at
    ``settings`` on ``device``, with the committed RMTPP weights where
    their provenance matches, its result written as the experiment's
    command line writes it."""
    from redqueen_tpu_torch.experiments import compare_policies, write_result

    t0 = time.perf_counter()
    results, budget, T = compare_policies.run(
        **settings, rmtpp_ckpt=compare_policies.RMTPP_NPZ, device=device)
    write_result(out, {
        **settings, "budget": budget, "T": T,
        "wall_s": time.perf_counter() - t0,
        "policies": {name: {"top1": top.tolist(), "avg_rank": rank.tolist(),
                            "posts": posts.tolist()}
                     for name, (top, rank, posts) in results.items()}},
        "rq.experiment.compare_policies/1", device)


def start_compare(device, out, settings):
    """:func:`compare_child` as its own process on ``device``."""
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "2"  # beside the card's host work
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-c",
           "import sys, json; from redqueen_tpu_torch.smoke.runtime import "
           "compare_child; compare_child(sys.argv[1], sys.argv[2], "
           "json.loads(sys.argv[3]))", device, out, json.dumps(settings)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _finish(proc, label, timeout):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        check(False, f"phase 12 (d): compare_policies on {label} did not "
              f"finish in {timeout:.0f} s: {out[-1500:]}")
    check(proc.returncode == 0, f"phase 12 (d): compare_policies on "
          f"{label} exited {proc.returncode}: {out[-1500:]}")


def compare_checks(card_json, cpu_json, card_label):
    """(d): the orderings of the JAX package's experiment tests on the
    card's run, and each policy's mean within :data:`COMPARE_SIGMA` of
    the CPU's."""
    from redqueen_tpu_torch.runtime import integrity

    card = integrity.read_json(card_json,
                               schema="rq.experiment.compare_policies/1")
    cpu = integrity.read_json(cpu_json,
                              schema="rq.experiment.compare_policies/1")
    check(card["platform"] == card_label, f"phase 12 (d): the card run "
          f"reports platform {card['platform']!r}")
    pol = {k: {f: np.asarray(v[f], np.float64) for f in v}
           for k, v in card["policies"].items()}
    T, budget = card["T"], card["budget"]
    top = {k: v["top1"].mean() for k, v in pol.items()}
    check(set(pol) == {"opt", "poisson", "hawkes", "offline", "replay",
                       "rmtpp"}, f"phase 12 (d): policies {sorted(pol)}")
    check(budget > 0 and all(np.all((v["top1"] >= 0) & (v["top1"] <= T))
                             for v in pol.values()),
          "phase 12 (d): a time-in-top-1 outside [0, T]")
    check(top["opt"] > top["poisson"] and top["opt"] > top["rmtpp"]
          and top["opt"] > top["hawkes"] and pol["rmtpp"]["posts"].mean()
          > 0 and abs(pol["hawkes"]["posts"].mean() - budget)
          < 0.5 * budget, f"phase 12 (d): the orderings fail: {top}")
    sig = {}
    for k, v in pol.items():
        a, b = v["top1"], np.asarray(cpu["policies"][k]["top1"], np.float64)
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        sig[k] = float(abs(a.mean() - b.mean()) / max(se, 1e-12))
        check(abs(a.mean() - b.mean()) <= max(COMPARE_SIGMA * se, 1e-6 * T),
              f"phase 12 (d): {k}'s mean time-in-top-1 on the card "
              f"{a.mean():.3f} against the CPU's {b.mean():.3f}: "
              f"{sig[k]:.2f} sigma")
    return {"budget": budget, "budget_cpu": cpu["budget"],
            "wall_s": card["wall_s"], "wall_s_cpu": cpu["wall_s"],
            "top1_fraction": {k: t / T for k, t in top.items()},
            "top1_fraction_cpu": {k: float(np.mean(v["top1"])) / T
                                  for k, v in cpu["policies"].items()},
            "card_vs_cpu_sigma": sig}


def rank_checks(dev, settings):
    """(d): rank_timeline on ``dev``, the JAX package's smoke checks."""
    from redqueen_tpu_torch.utils.metrics_pandas import (num_posts_of_src,
                                                         time_in_top_k)

    T = settings["T"]
    res, budget = rank_timeline.run(T=T, F=settings["F"],
                                    seed=settings["seed"],
                                    capacity=settings["capacity"],
                                    device=dev)
    check(budget > 0, "phase 12 (d): rank_timeline's RedQueen never posts")
    out = {"budget": int(budget)}
    for name, (df, src) in res.items():
        check(num_posts_of_src(df, src) > 0,
              f"phase 12 (d): rank_timeline's {name} never posts")
        t, r = rank_timeline.rank_steps(df, src, 0, T)
        check(t[0] == 0.0 and t[-1] == T and np.all(np.diff(t) >= 0)
              and np.all(r >= 0), f"phase 12 (d): {name}'s rank steps")
        frac = float(np.sum(np.diff(t)[r[:-1] == 0]))
        want = time_in_top_k(df, 1, T, src, per_sink=True)[0]
        check(abs(frac - want) <= 1e-9, f"phase 12 (d): {name}'s rank "
              f"steps integrate to {frac}, the metric to {want}")
        out[name] = frac / T
    return out


def native_load(tmp, corpus=CORPUS):
    """(f): build the native loader, load a corpus by both engines."""
    from redqueen_tpu_torch.data import traces
    from redqueen_tpu_torch.native import loader

    t0 = time.perf_counter()
    loader.build(force=True)
    build_s = time.perf_counter() - t0
    tr = traces.synthetic_twitter(corpus["seed"], corpus["n_users"],
                                  corpus["end_time"])
    path = os.path.join(tmp, "corpus.csv")
    traces.save_csv(path, tr)
    got = {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        got[engine] = traces.load_csv(path, engine=engine, return_stats=True)
        got[engine] += (time.perf_counter() - t0,)
    (tn, sn, dn), (tp, sp, dp) = got["native"], got["python"]
    check(sn == sp and len(tn) == len(tp) and all(
        np.array_equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tn, tp)), "phase 12 (f): the native load differs "
          "from the Python load")
    out = {"rows": sn.n_rows, "users": sn.n_users,
           "duplicates": sn.duplicate_timestamps, "build_s": build_s,
           "native_rows_per_s": sn.n_rows / dn,
           "python_rows_per_s": sp.n_rows / dp, "native_s": dn,
           "python_s": dp}
    print(f"phase 12 (f) native loader: built in {build_s:.2f} s; "
          f"{sn.n_rows:,} rows of {sn.n_users:,} users: native "
          f"{out['native_rows_per_s']:,.0f} rows/s, Python "
          f"{out['python_rows_per_s']:,.0f} rows/s, equal")
    return out


def probes(dev, out):
    """(g): the probe subprocess and ``ensure_backend`` (``RQ_BACKEND``
    unset), into ``out``."""
    from redqueen_tpu_torch.utils import backend

    t0 = time.perf_counter()
    out["probe"] = backend.probe_default_backend(120.0)
    env = os.environ.pop(supervisor.ENV_BACKEND, None)
    try:
        out["ensure_backend"] = supervisor.ensure_backend(log=None)
    finally:
        if env is not None:
            os.environ[supervisor.ENV_BACKEND] = env
    out["probe_s"] = time.perf_counter() - t0


def phase_runtime(dev, sweep=SWEEP, compare=COMPARE, rank=RANK,
                  corpus=CORPUS, closed_loop_kw=CLOSED_LOOP,
                  live_swap_quick=True, budget_s=BUDGET_S):
    """Phase 12.  ``compare_policies`` runs as two processes of its own
    from the start, one on the card and one on the CPU, and the probes in
    a thread, beside the rest, which runs here one part at a time."""
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rq_phase12_")
    jsons = {label: os.path.join(tmp, f"compare_{label}.json")
             for label in dict.fromkeys((dev.type, "cpu"))}
    procs = {}
    timeline = {}

    def lap(name, t0):
        timeline[name] = time.perf_counter() - t0
        print(f"phase 12 [{name}] {timeline[name]:.1f} s", file=sys.stderr,
              flush=True)

    try:
        for label, path in jsons.items():
            procs[label] = start_compare(label, path, compare)
        probe = {}
        prober = threading.Thread(target=probes, args=(dev, probe),
                                  daemon=True)
        prober.start()
        kernels.reset_launch_counts()
        res = {"budget_s": budget_s, "timeline": timeline}
        t0 = time.perf_counter()
        res["sweep"], (opt, poisson) = supervised_sweep(dev, sweep, tmp)
        lap("a", t0)
        t0 = time.perf_counter()
        res["finding"] = tradeoff_finding(sweep, opt, poisson)
        lap("b", t0)
        t0 = time.perf_counter()
        res["closed_loop"] = closed_loop_run(dev, **closed_loop_kw)
        lap("c", t0)
        t0 = time.perf_counter()
        res["rank_timeline"] = rank_checks(dev, rank)
        lap("d_rank", t0)
        t0 = time.perf_counter()
        rep = live_swap.run(os.path.join(tmp, "live_swap.json"),
                            quick=live_swap_quick, device=dev)
        check(rep["pass"] and rep["learner_kill"]["rc"] == -signal.SIGKILL,
              f"phase 12 (e): live_swap failed: "
              f"{json.dumps({k: rep.get(k) for k in ('latency', 'audit')})}")
        res["live_swap"] = {
            "wall_s": time.perf_counter() - t0,
            "latency_s": rep["latency"]["journal_write_to_params_live_s"],
            "recovery_frac": rep["recovery"]["canary_nll"]["recovery_frac"],
            "platform": rep["platform"]}
        lap("e", t0)
        print(f"phase 12 (e) live_swap --quick: pass, learner SIGKILLed, "
              f"latency {res['live_swap']['latency_s'] * 1e3:.1f} ms, "
              f"recovery {res['live_swap']['recovery_frac']:.2f}")
        t0 = time.perf_counter()
        res["native"] = native_load(tmp, corpus)
        lap("f", t0)
        t0 = time.perf_counter()
        prober.join(PROBE_WAIT_S)
        lap("g_wait", t0)
        check(probe.get("probe") == (True, 1, "cuda")
              if dev.type == "cuda" else "probe" in probe,
              f"phase 12 (g): probe_default_backend gave "
              f"{probe.get('probe')}")
        check(probe.get("ensure_backend") == "cuda"
              if dev.type == "cuda" else "ensure_backend" in probe,
              f"phase 12 (g): ensure_backend gave "
              f"{probe.get('ensure_backend')!r}")
        res["probe"] = {"probe": list(probe["probe"]),
                        "ensure_backend": probe["ensure_backend"],
                        "probe_s": probe["probe_s"]}
        print(f"phase 12 (g) probe {probe['probe']}, ensure_backend "
              f"{probe['ensure_backend']!r} ({probe['probe_s']:.1f} s)")
        for label, proc in procs.items():
            t0 = time.perf_counter()
            _finish(proc, label, COMPARE_WAIT_S)
            lap(f"d_wait_{label}", t0)
        res["compare"] = compare_checks(jsons[dev.type], jsons["cpu"],
                                        dev.type)
        print("phase 12 (d) compare_policies, time-in-top-1 fraction (card "
              "against CPU, sigma): " + "; ".join(
                  f"{k} {res['compare']['top1_fraction'][k]:.3f} ({v:.2f})"
                  for k, v in res["compare"]["card_vs_cpu_sigma"].items())
              + f"; rank_timeline {res['rank_timeline']}")
        res["launches"] = {"event_kernel": kernels.LAUNCHES["event_kernel"]
                           + res["sweep"]["child"]["event_kernel_launches"],
                           "hawkes_pass": kernels.LAUNCHES["hawkes_pass"]}
        res["total_s"] = time.perf_counter() - t_start
        print(f"phase 12 runtime and experiments: {res['total_s']:.1f} s of "
              f"its {budget_s:.0f} s budget (" + ", ".join(
                  f"{k} {v:.1f}" for k, v in timeline.items())
              + f" s); launches {res['launches']}")
        check(res["total_s"] <= budget_s, f"phase 12 took "
              f"{res['total_s']:.1f} s, over its {budget_s:.0f} s budget")
        return res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
