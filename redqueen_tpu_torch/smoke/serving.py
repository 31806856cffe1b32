"""Phase 10 of the smoke run: the serving path on the card (the serving
bench's own settings, the apply at a million edges, bit-identity on the
card and against the CPU, and fit-while-serving through the
``hawkes_pass`` kernel).

The runtime computes its apply with PyTorch operations (the reference's
is XLA operations, with no Pallas kernel), so this phase holds no kernel
against a plain version; the ``hawkes_pass`` kernel runs on this path
through ``learn.StreamingEM``, and its launches here are counted into its
row."""

import os
import shutil
import tempfile
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch import serving
from redqueen_tpu_torch.ops import kernels
from redqueen_tpu_torch.ops.threefry import threefry2x32, uniform_from_bits
from redqueen_tpu_torch.runtime import telemetry
from redqueen_tpu_torch.serving import service as svc
from redqueen_tpu_torch.serving import state as sstate
from redqueen_tpu_torch.utils import roofline
from .common import check, sync

# The serving bench's settings (benchmarks/run.py:387-410, 480-503): a
# 2,048-feed graph, 2,048 measured batches of 64 events (Poisson) after 8
# warm-up batches, coalesce 32, queue 64, reorder window 8, 256 events a
# batch at most, and the quorum tier: binary journal, replication factor
# 2, quorum 1, group commit of at most 64 records or 25 ms; snapshots
# off.
BENCH_FEEDS = 2048
BENCH_BATCHES = 2048
WARMUP = 8
EVENTS_PER_BATCH = 64
BENCH_KW = dict(snapshot_every=10 ** 9, queue_capacity=64, reorder_window=8,
                max_batch_events=256, coalesce=32, flush_mode="group",
                max_unflushed_records=64, max_flush_delay_ms=25.0,
                journal_format="binary", replication_factor=2,
                replication_quorum=1)
# (b): the scale ``serving/state.py`` names ("millions of edges").
BIG_FEEDS = 1_000_000
# Rounds traced by the profiler in (b) for the device's busy time.
PROFILED_ROUNDS = 8
# (c): a q at which about a third of the stream's batches post (at the
# bench's q = 1 every batch posts: p_post is 1 to float precision, and a
# near-tie cannot happen), and the near-tie rule of the card against the
# CPU: |u - p_post| <= NEAR_TIE_RTOL p_post, at most MAX_NEAR_TIE_SHARE
# of the batches.
Q_MIXED = 1e4
CROSS_BATCHES = 512
NEAR_TIE_RTOL = 1e-5
MAX_NEAR_TIE_SHARE = 0.02
# (d): fit-while-serving over the corpus's 64 dimensions.
FIT_DIMS = 64
FIT_T_END = 3000.0
FIT_SEED = 11
FIT_BATCH = 64
FIT_RTOL = 5e-3     # the card's candidate against the CPU's


def bench_stream(n_feeds, n_batches=BENCH_BATCHES, seed=0):
    return serving.synthetic_stream(seed, n_batches + WARMUP, n_feeds,
                                    events_per_batch=EVENTS_PER_BATCH)


def apply_bound_ms(n_feeds):
    """The least time one ``_apply`` over ``[F]`` could take on the card:
    it reads rank, health and s_sink (4 bytes an edge each) and writes the
    new rank and health, once each (the batch's events are noise beside
    them), over the HBM rate."""
    return roofline.bound(20.0 * n_feeds)["bound_ms"]


class _HostWait:
    """Wraps ``service.read_decisions`` (the apply's one device-to-host
    read) and ``service.state_digest`` (the journal record's digest) for
    one run: host milliseconds in each, per call."""

    def __init__(self):
        self.read_ms, self.digest_ms = [], []

    def __enter__(self):
        self._read, self._digest = svc.read_decisions, svc.state_digest

        def read(*a):
            t0 = time.perf_counter()
            out = self._read(*a)
            self.read_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def digest(st):
            t0 = time.perf_counter()
            out = self._digest(st)
            self.digest_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        svc.read_decisions, svc.state_digest = read, digest
        return self

    def __exit__(self, *exc):
        svc.read_decisions, svc.state_digest = self._read, self._digest
        return False


def _device_busy_ms(dev, fn):
    """Device milliseconds of every kernel and copy ``fn`` runs, from
    ``torch.profiler``'s CUDA trace; None on the CPU or where the trace
    holds no device time."""
    if torch.device(dev).type != "cuda":
        fn()
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    us = sum(ev.self_device_time_total for ev in prof.key_averages())
    return us / 1e3 if us > 0 else None


def serve_bench(dev, n_feeds, batches, traced=False, profile_rounds=0,
              kw=BENCH_KW):
    """The serving bench's loop on ``dev``: warm the measured runtime,
    reset its metrics, then one poll round per ``coalesce`` batches
    (each under a ``serve.round`` root span when traced).  Returns the
    metrics report, the stage breakdown (traced), the host's waits and
    the final digest; checks the accounting identity."""
    tel = telemetry.get()
    d = tempfile.mkdtemp(prefix="rq-serving-smoke-")
    tel.configure(enabled=traced, reset=True)
    out = {"n_feeds": n_feeds, "traced": traced}
    try:
        r = serving.ServingRuntime(n_feeds, dir=d, device=dev, **kw)
        with r:
            for b in batches[:WARMUP]:
                r.submit(b)
                r.poll()
            r.reset_metrics()
            tel.configure(reset=True)
            K = r.coalesce
            rounds = [batches[i:i + K] for i in range(WARMUP, len(batches),
                                                       K)]

            def serve(rs):
                for chunk in rs:
                    with tel.trace("serve.round"):
                        for b in chunk:
                            r.submit(b)
                        r.poll()

            with _HostWait() as waits:
                t0 = time.perf_counter()
                serve(rounds[:len(rounds) - profile_rounds])
                sync(dev)
                wall = time.perf_counter() - t0
            rep = r.metrics.report(pending=r.pending)
            if profile_rounds:
                busy = _device_busy_ms(
                    dev, lambda: serve(rounds[len(rounds) - profile_rounds:]))
                out["device_ms_per_round"] = (
                    None if busy is None else busy / profile_rounds)
            out["durability"] = r.durability()
            out["digest"] = r.state_digest()
            out["applied_seq"] = r.applied_seq
            if traced:
                out["breakdown"] = telemetry.summarize(
                    tel.payload()["spans"])
    finally:
        tel.configure(enabled=False, reset=True)
        shutil.rmtree(d, ignore_errors=True)
    ident = rep["applied"] + rep["shed"] + rep["rejected"] + \
        rep["duplicates"] + rep["pending"]
    check(rep["ingested"] == ident and rep["reconciles"],
          f"serving accounting: ingested {rep['ingested']} != applied + "
          f"shed + rejected + duplicates + pending = {ident}")
    check(rep["shed"] == 0 and rep["rejected"] == 0,
          f"serving shed {rep['shed']} and rejected {rep['rejected']} "
          f"batches of the bench stream")
    n_rounds = len(rounds) - profile_rounds
    out.update({
        "report": rep, "rounds": n_rounds, "wall_s": wall,
        "events_per_s": rep["events_per_sec"],
        "latency": rep["decision_latency"],
        "host_read_ms_per_round": float(np.sum(waits.read_ms)) / n_rounds,
        "host_digest_ms_per_round": (float(np.sum(waits.digest_ms))
                                     / n_rounds),
    })
    return out


def stage_table(breakdown):
    """``{stage: (total ms, percent of the rounds' wall)}`` of a traced
    run (``telemetry.summarize``)."""
    return {name: (round(1e3 * st["total_s"], 3), st["pct_of_wall"])
            for name, st in breakdown.get("stages", {}).items()}


# ---- (c) bit-identity on the card ----

def _port_run(dev, n_feeds, batches, coalesce, poll_every, **kw):
    r = serving.ServingRuntime(n_feeds, q=Q_MIXED, seed=3, device=dev,
                               coalesce=coalesce, max_batch_events=256,
                               queue_capacity=256, **kw)
    decs = []
    for i, b in enumerate(batches):
        r.submit(b)
        if (i + 1) % poll_every == 0:
            decs += r.poll()
    decs += r.poll()
    return r, decs


def coalesce_invariance(dev, n_feeds=BENCH_FEEDS, n_batches=256):
    """K = 1 against K = 32 (and groups cut at a stride of 7): the same
    digest and decisions, bit for bit."""
    batches = bench_stream(n_feeds, n_batches)
    runs = [_port_run(dev, n_feeds, batches, k, p)
            for k, p in ((1, 1), (32, 32), (32, 7))]
    digests = [r.state_digest() for r, _ in runs]
    check(len(set(digests)) == 1,
          f"coalesce invariance on {dev}: digests {digests}")
    check(runs[0][1] == runs[1][1] == runs[2][1],
          f"coalesce invariance on {dev}: decisions differ")
    return {"digest": digests[0], "batches": len(batches),
            "posts": int(sum(d.post for d in runs[0][1]))}


def width_invariance(dev, n_feeds=BENCH_FEEDS, n_rounds=8, K=32, E=256):
    """Every round of a coalesced apply at its pow-2 bucket width against
    the same round at the full width: the same carry and outputs."""
    batches = bench_stream(n_feeds, n_rounds * K)[WARMUP:]
    s = torch.ones(n_feeds, device=dev)
    q = torch.tensor(Q_MIXED, dtype=torch.float32, device=dev)
    sts = [sstate.init_feed_state(n_feeds, 5, device=dev) for _ in range(2)]
    outs = [[], []]
    for i in range(0, len(batches), K):
        grp = batches[i:i + K]
        for j, width in enumerate((svc._pad_width(
                max(b.n_events for b in grp), E), E)):
            t = np.zeros((K, width), np.float32)
            f = np.zeros((K, width), np.int32)
            n = np.zeros(K, np.int32)
            sq = np.zeros(K, np.int32)
            for m, b in enumerate(grp):
                t[m], f[m], n[m] = svc._pad_events(b.times, b.feeds, width)
                sq[m] = b.seq
            sts[j], o = sstate._apply_many(sts[j], t, f, n, sq, len(grp),
                                           s, q)
            outs[j].append(tuple(a.tobytes()
                                 for a in sstate.read_decisions(*o)))
    d0, d1 = (sstate.state_digest(x) for x in sts)
    check(d0 == d1 and outs[0] == outs[1],
          f"pad-width invariance on {dev}: {d0[:12]} != {d1[:12]}")
    return {"digest": d0, "rounds": len(outs[0])}


def recover_mid_stream(dev, n_feeds=BENCH_FEEDS, n_batches=256,
                       close_at=150):
    """A run on the bench's tier closed mid-stream with no snapshot of
    its tail, recovered on ``dev``: the carry of the run at that point,
    no acked seq lost, and the rest of the stream then ends at the
    uninterrupted run's digest."""
    batches = bench_stream(n_feeds, n_batches)
    want = _port_run(dev, n_feeds, batches, 32, 32)[0].state_digest()
    kw = dict(BENCH_KW, q=Q_MIXED, seed=3)
    d = tempfile.mkdtemp(prefix="rq-serving-recover-")
    try:
        r = serving.ServingRuntime(n_feeds, dir=d, device=dev, **kw)
        for i, b in enumerate(batches[:close_at]):
            r.submit(b)
            if (i + 1) % 32 == 0:
                r.poll()
        r.poll()
        acked, at_close = r.applied_seq, r.state_digest()
        r.close()
        rec, info = serving.recover(d, acked_seq=acked, device=dev)
        with rec:
            check(rec.state_digest() == at_close,
                  f"recover on {dev}: digest differs from the closed run's")
            check(info.lost_acked_seqs == () and info.snapshot_seq is None,
                  f"recover on {dev}: {info}")
            for i, b in enumerate(batches[close_at:]):
                rec.submit(b)
                if (i + 1) % 32 == 0:
                    rec.poll()
            rec.poll()
            got = rec.state_digest()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(got == want, f"recover on {dev}: the resumed run ends at "
                       f"{got[:12]}, the uninterrupted one at {want[:12]}")
    return {"replayed": info.replayed, "recovered_seq": info.recovered_seq,
            "digest": got}


def _draw(key, seq):
    w0, _ = threefry2x32(int(key[0]), int(key[1]), int(seq), 0x80000000)
    return float(uniform_from_bits(torch.as_tensor(w0)))


def card_against_cpu(dev, n_feeds=BENCH_FEEDS, n_batches=CROSS_BATCHES):
    """The same stream applied on ``dev`` and on the CPU from the same
    carry, batch by batch: decisions equal but for near-ties (counted, at
    most 2%), the carry's digest equal after every equal decision,
    intensities within 1e-5; then whole runtimes on both, whose final
    digests are equal when no batch was a near-tie."""
    batches = bench_stream(n_feeds, n_batches)[WARMUP:]
    s = np.random.RandomState(1).uniform(0.0, 2.0, n_feeds)
    s32 = torch.as_tensor(s, dtype=torch.float32)
    q = torch.tensor(Q_MIXED, dtype=torch.float32)
    cpu = torch.device("cpu")
    st = sstate.init_feed_state(n_feeds, 3, device=dev)
    ties, posts, lam_err = [], 0, 0.0
    for b in batches:
        t, f, n = svc._pad_events(b.times, b.feeds,
                                  svc._pad_width(b.n_events, 256))
        st_c = sstate.FeedState(**{k: v.to(cpu)
                                   for k, v in vars(st).items()})
        new, o = sstate._apply(st, t, f, n, np.int32(b.seq), s32.to(dev),
                               q.to(dev))
        new_c, o_c = sstate._apply(st_c, t, f, n, np.int32(b.seq), s32, q)
        pd, td, ld = (a[0] for a in sstate.read_decisions(*o))
        pc, tc, lc = (a[0] for a in sstate.read_decisions(*o_c))
        check(td == tc, f"card/CPU clock differs at seq {b.seq}")
        lam_err = max(lam_err, abs(float(ld) - float(lc))
                      / max(abs(float(lc)), 1e-30))
        posts += bool(pc)
        if bool(pd) != bool(pc):
            p = -np.expm1(-float(lc) * (float(tc) - float(st_c.t)))
            u = _draw(sstate.state_to_numpy(st_c)["key"], b.seq)
            check(abs(u - p) <= NEAR_TIE_RTOL * p,
                  f"card/CPU decision differs at seq {b.seq}: u {u} p {p}")
            ties.append(int(b.seq))
        else:
            check(sstate.state_digest(new) == sstate.state_digest(new_c),
                  f"card/CPU carry differs after seq {b.seq}")
        st = new
    check(len(ties) <= MAX_NEAR_TIE_SHARE * len(batches),
          f"card/CPU near-ties {len(ties)} of {len(batches)}")
    check(lam_err <= 1e-5, f"card/CPU intensity differs by {lam_err:.3g}")
    runs = [_port_run(d, n_feeds, batches, 32, 32, s_sink=s)
            for d in (dev, cpu)]
    same = runs[0][0].state_digest() == runs[1][0].state_digest()
    check(same or ties, "card/CPU final digests differ with no near-tie")
    return {"batches": len(batches), "posts": posts, "near_ties": ties,
            "max_lam_rel_err": lam_err, "final_digests_equal": same}


# ---- (d) fit while serving ----

def fit_truth(D=FIT_DIMS, seed=FIT_SEED):
    """A subcritical cross-exciting world over ``D`` feeds: base rates
    0.05-0.15, a sparse jump matrix with branching ratio about 0.4."""
    rng = np.random.RandomState(seed)
    mu = rng.uniform(0.05, 0.15, D)
    beta = rng.uniform(1.0, 3.0, D)
    mask = rng.uniform(size=(D, D)) < 4.0 / D
    alpha = mask * rng.uniform(0.5, 1.5, (D, D)) * 0.1 * beta[None, :]
    return mu, alpha, beta


def fit_while_serving(dev, D=FIT_DIMS, t_end=FIT_T_END):
    """Verify flow 6 on ``dev``: serve a simulated cross-exciting stream
    (binary journal), fit it with ``StreamingEM`` (its ``hawkes_pass``
    launches counted), install the candidate as epoch 1 through the gate,
    serve on, close, and ``recover``: epoch, fingerprint, s_sink and
    digest equal.  The same fit on the CPU from the same journal: the
    candidates within 5e-3."""
    mu, alpha, beta = fit_truth(D)
    times, dims = rt.learn.simulate_cross_exciting(mu, alpha, beta,
                                                   t_end=t_end, seed=3)
    dims = dims.astype(np.int32)
    n = len(times)
    cut = (n * 3 // 4) // FIT_BATCH * FIT_BATCH
    batches = [serving.EventBatch(i, times[s:s + FIT_BATCH],
                                  dims[s:s + FIT_BATCH])
               for i, s in enumerate(range(0, n, FIT_BATCH))]
    head, tail = batches[:cut // FIT_BATCH], batches[cut // FIT_BATCH:]
    d = tempfile.mkdtemp(prefix="rq-fit-serving-")
    try:
        r = serving.ServingRuntime(D, dir=d, journal_format="binary",
                                   snapshot_every=10 ** 9, coalesce=32,
                                   device=dev)

        def serve(bs):
            for i, b in enumerate(bs):
                check(r.submit(b).status == "accepted",
                      "fit-while-serving: a batch was not accepted")
                if (i + 1) % 32 == 0:
                    r.poll()
            r.poll()

        serve(head)
        kernels.LAUNCHES["hawkes_pass"] = 0
        t0 = time.perf_counter()
        em = rt.learn.StreamingEM(d, D, device=dev)
        upd = em.run_once()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = kernels.LAUNCHES["hawkes_pass"]
        em_cpu = rt.learn.StreamingEM(
            d, D, candidate_path=os.path.join(d, "candidate_cpu.json"),
            device="cpu")
        t0 = time.perf_counter()
        em_cpu.run_once()
        cpu_s = time.perf_counter() - t0
        gaps = {k: float(np.max(np.abs(getattr(em, k) - getattr(em_cpu, k)))
                         / max(float(np.max(np.abs(getattr(em_cpu, k)))),
                               1e-30))
                for k in ("mu", "alpha", "beta")}
        for k, g in gaps.items():
            check(g <= FIT_RTOL, f"fit-while-serving: card {k} {g:.3g} "
                                 f"from the CPU's, beyond {FIT_RTOL}")
        check(upd.candidate is not None, "fit-while-serving: no candidate")
        out = serving.ParamSwapper(r).poll_artifact(upd.candidate)
        check(out is not None and out["installed"],
              f"fit-while-serving: the candidate was not installed: {out}")
        live = r.live_params()
        check(live["epoch"] == 1, f"fit-while-serving: epoch {live}")
        serve(tail)
        want = r.state_digest()
        r.close()
        rec, info = serving.recover(d, acked_seq=len(batches) - 1,
                                    device=dev)
        with rec:
            lp = rec.live_params()
            got = rec.state_digest()
        check(lp["epoch"] == 1 and lp["fingerprint"] == live["fingerprint"]
              and np.array_equal(lp["s_sink"], live["s_sink"])
              and got == want and info.lost_acked_seqs == (),
              f"fit-while-serving: recovery differs (epoch {lp['epoch']}, "
              f"digest {got[:12]} vs {want[:12]}, lost "
              f"{info.lost_acked_seqs})")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"events": int(n), "dims": D, "fit_events": int(upd.n_events),
            "fit_s": fit_s, "cpu_fit_s": cpu_s, "launches": launches,
            "gaps": gaps, "epoch": lp["epoch"],
            "fingerprint": lp["fingerprint"], "replayed": info.replayed}


def phase_serving(dev, big_feeds=BIG_FEEDS, bench_batches=BENCH_BATCHES):
    """Phase 10."""
    t_start = time.perf_counter()
    res = {"apply_bound_ms": {"bench": apply_bound_ms(BENCH_FEEDS),
                              "big": apply_bound_ms(big_feeds)}}
    batches = bench_stream(BENCH_FEEDS, bench_batches)
    res["bench"] = a = serve_bench(dev, BENCH_FEEDS, batches)
    res["bench_traced"] = at = serve_bench(dev, BENCH_FEEDS, batches,
                                         traced=True)
    check(a["digest"] == at["digest"],
          "phase 10 (a): the traced run's carry differs from the untraced")
    lat = a["latency"]
    print(f"phase 10 (a) serving bench, {BENCH_FEEDS} feeds, "
          f"{bench_batches} batches of ~{EVENTS_PER_BATCH} events, coalesce "
          f"{BENCH_KW['coalesce']}, tier {a['durability']}: "
          f"{a['events_per_s']:,.0f} events/s untraced, "
          f"{at['events_per_s']:,.0f} traced; decision latency p50 "
          f"{lat['p50_ms']} ms, p99 {lat['p99_ms']} ms, max "
          f"{lat['max_ms']} ms; host blocked in the decision read "
          f"{a['host_read_ms_per_round']:.3f} ms a round, digest "
          f"{a['host_digest_ms_per_round']:.3f} ms a round")
    print(f"phase 10 (a) stages of the traced run (total ms, % of the "
          f"rounds' wall; coverage {at['breakdown']['coverage']}): "
          + ", ".join(f"{k} {v[0]} ({v[1]}%)" for k, v in
                      stage_table(at["breakdown"]).items()))
    big = bench_stream(big_feeds, bench_batches)
    res["big"] = b = serve_bench(dev, big_feeds, big,
                               profile_rounds=PROFILED_ROUNDS)
    dev_ms = b.get("device_ms_per_round")
    print(f"phase 10 (b) {big_feeds:,} feeds: {b['events_per_s']:,.0f} "
          f"events/s, decision latency p50 {b['latency']['p50_ms']} ms p99 "
          f"{b['latency']['p99_ms']} ms; the device busy "
          + (f"{dev_ms:.3f} ms a round" if dev_ms is not None
             else "not measured (the profiler saw no device time)")
          + f" against the apply's bound of "
          f"{BENCH_KW['coalesce'] * res['apply_bound_ms']['big']:.4f} ms "
          f"({res['apply_bound_ms']['big'] * 1e3:.2f} us an apply); host "
          f"blocked {b['host_read_ms_per_round']:.3f} ms a round in the "
          f"decision read and {b['host_digest_ms_per_round']:.3f} ms in "
          f"the digest; wall {b['wall_s'] / b['rounds'] * 1e3:.3f} ms a "
          f"round")
    res["coalesce"] = coalesce_invariance(dev)
    res["widths"] = width_invariance(dev)
    res["recover"] = recover_mid_stream(dev)
    res["cross"] = c = card_against_cpu(dev)
    print(f"phase 10 (c) K = 1 / 32 / stride 7 equal "
          f"({res['coalesce']['posts']} posts of "
          f"{res['coalesce']['batches']}); pow-2 widths = full width over "
          f"{res['widths']['rounds']} rounds; recovered mid-stream "
          f"(replayed {res['recover']['replayed']} batches) to the "
          f"uninterrupted digest; card vs CPU over {c['batches']} batches: "
          f"{len(c['near_ties'])} near-ties, {c['posts']} posts, intensity "
          f"within {c['max_lam_rel_err']:.2g}, final digests equal "
          f"{c['final_digests_equal']}")
    res["fit"] = f = fit_while_serving(dev)
    print(f"phase 10 (d) fit while serving: {f['events']} events over "
          f"{f['dims']} feeds, StreamingEM on {f['fit_events']} in "
          f"{f['fit_s']:.3f} s ({f['launches']} hawkes_pass launches; CPU "
          f"{f['cpu_fit_s']:.3f} s), card vs CPU "
          + ", ".join(f"{k} {v:.2g}" for k, v in f["gaps"].items())
          + f"; installed epoch {f['epoch']}, recovered bit-identically")
    res["launches"] = f["launches"]
    if torch.device(dev).type == "cuda":
        check(res["launches"] > 0,
              "phase 10: StreamingEM launched no hawkes_pass")
    res["phase_s"] = time.perf_counter() - t_start
    print(f"phase 10 serving: {res['phase_s']:.1f} s")
    return res
