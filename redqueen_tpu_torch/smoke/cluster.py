"""Phase 11 of the smoke run: the sharded serving cluster on the card.

(a) the serving bench's clustered wire-speed settings at 4 shards, each
a worker process with its own CUDA context (socket placement), then the
same workload in process; (b) the shard-count sweep in process; (c) a
real SIGKILL of one worker process mid-stream, the survivors serving on,
``recover_shard`` and retransmit back to the uninterrupted digest; (d)
the offline ``reshard`` 4 -> 2 and a live grow 3 -> 4 under traffic,
held against the same script on the CPU; (e) the same 4-shard stream on
the card and on the CPU, batch by batch; (f) a fit read from the
cluster's shard journals through the ``hawkes_pass`` kernel.

The cluster is host code (routing, journals, processes, hashing); on
the card each shard's carry and apply are PyTorch operations, so the
one kernel of this path is ``hawkes_pass``, run by the fit in (f) and
counted into its row."""

import os
import shutil
import signal
import subprocess
import tempfile
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch import serving
from redqueen_tpu_torch.ops import kernels
from redqueen_tpu_torch.ops.prng import PRNGKey
from .common import check, sync
from .learn import fits_agree
from .serving import (BENCH_BATCHES, BENCH_FEEDS, BENCH_KW,
                      EVENTS_PER_BATCH, MAX_NEAR_TIE_SHARE, NEAR_TIE_RTOL,
                      Q_MIXED, WARMUP, _draw, bench_stream, fit_truth)

# The clustered phase of the serving bench (benchmarks/run.py:414-417,
# :626-700): 4 socket-placed worker processes on the quorum tier, with
# the single runtime's settings otherwise (BENCH_KW: coalesce 32, queue
# 64, reorder window 8, binary journal, replication factor 2, quorum 1,
# group commit of 64 records or 25 ms, snapshots off).
CLUSTER_SHARDS = 4
SWEEP = (1, 2, 4)
# (d): the live grow 3 -> 4 (live resharding only grows; the offline
# reshard shrinks) on a shorter stream of the bench's graph.
RESHARD_BATCHES = 256
# (e): phase 10's q, at which about a third of a shard's decisions post
# on the bench's stream (at q = 1 every one does, and no near-tie can
# arise), over phase 10's 512 batches.
CROSS_BATCHES = 512
# (f): the fit read from the shard journals.
FIT_DIMS = 64
FIT_T_END = 3000.0
FIT_BATCH = 64
FIT_ITERS = 5


def cluster(dev, d, n_shards, placement="in-process", n_feeds=BENCH_FEEDS,
            kw=BENCH_KW, **extra):
    return serving.ServingCluster(n_feeds=n_feeds, n_shards=n_shards, dir=d,
                                  placement=placement, device=dev,
                                  **dict(kw, **extra))


def rounds(batches, size):
    return [batches[i:i + size] for i in range(0, len(batches), size)]


def serve_rounds(cl, batches, size):
    """The bench's wire-speed loop: one ``submit_many`` and one poll a
    round of ``size`` batches."""
    for chunk in rounds(batches, size):
        cl.submit_many(chunk)
        cl.poll()


def check_identity(rep, label):
    ident = rep["applied"] + rep["shed"] + rep["rejected"] + \
        rep["duplicates"] + rep["pending"]
    check(rep["ingested"] == ident and rep["reconciles"],
          f"{label}: ingested {rep['ingested']} != applied + shed + "
          f"rejected + duplicates + pending = {ident}")


def _device_nodes(pid):
    """The card's device nodes (``/dev/nvidiaN``) process ``pid`` holds
    open: a process with a CUDA context holds its card's node."""
    nodes = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia") and target[11:].isdigit():
            nodes.add(target)
    return sorted(nodes)


def card_contexts(pids):
    """That every process in ``pids`` holds a context on the card, from
    ``nvidia-smi --query-compute-apps=pid,used_memory``: each pid listed
    where the tool sees this process's pids, else (a container, where
    it lists every context under another pid namespace's id) at least
    one listed context for each of ``pids``, and each of ``pids``
    holding the card's device node open."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi compute-apps exited "
                               f"{out.returncode}: {out.stderr[-500:]}")
    apps = []
    for line in out.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if parts and parts[0].isdigit():
            apps.append((int(parts[0]), parts[1] if len(parts) > 1 else ""))
    listed = {p for p, _ in apps}
    if os.getpid() in listed:
        missing = [p for p in pids if p not in listed]
        check(not missing, f"worker pids {missing} hold no context on the "
                           f"card (nvidia-smi lists {sorted(listed)})")
        return {"method": "pid", "contexts": len(apps),
                "apps": [list(a) for a in apps if a[0] in pids]}
    check(len(apps) >= len(pids),
          f"nvidia-smi lists {len(apps)} contexts ({out.stdout.strip()!r}), "
          f"fewer than the {len(pids)} workers")
    nodes = {p: _device_nodes(p) for p in pids}
    bare = [p for p, n in nodes.items() if not n]
    check(not bare, f"worker pids {bare} hold no card device node open")
    return {"method": "count", "contexts": len(apps),
            "apps": [list(a) for a in apps],
            "device_nodes": {str(p): n for p, n in nodes.items()}}


def cluster_bench(dev, placement, n_shards, batches, n_feeds=BENCH_FEEDS,
                  kw=BENCH_KW, check_contexts=False):
    """The bench's steady-state pass: warm the measured cluster, reset
    its metrics, serve the rest in rounds of ``coalesce``; events/s,
    decision p50/p99 and the accounting identity.  Worker placements
    also report their child pids (and, on the card, their contexts)."""
    d = tempfile.mkdtemp(prefix="rq-cluster-smoke-")
    out = {"placement": placement, "n_shards": n_shards}
    try:
        t0 = time.perf_counter()
        with cluster(dev, d, n_shards, placement, n_feeds, kw) as cl:
            out["open_s"] = time.perf_counter() - t0
            for b in batches[:WARMUP]:
                cl.submit(b)
                cl.poll()
            if placement in serving.WORKER_PLACEMENTS:
                pids = [s.runtime.proc.pid for s in cl._slots]
                devs = [s.runtime.device for s in cl._slots]
                check(all(x == str(cl.device) for x in devs),
                      f"workers serve on {devs}, not {cl.device}")
                out["worker_pids"] = pids
                if check_contexts and torch.device(dev).type == "cuda":
                    out["contexts"] = card_contexts(pids)
            cl.reset_metrics()
            t0 = time.perf_counter()
            serve_rounds(cl, batches[WARMUP:], cl.coalesce)
            sync(dev)
            out["wall_s"] = time.perf_counter() - t0
            rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
            check_identity(rep, f"cluster {placement} x{n_shards}")
            check(rep["shed"] == 0 and rep["rejected"] == 0,
                  f"cluster {placement} x{n_shards} shed {rep['shed']}, "
                  f"rejected {rep['rejected']}")
            out["digest"] = cl.cluster_digest()
            out["applied_seq"] = cl.applied_seq
            out["durability"] = cl.durability()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    lat = rep["decision_latency"]
    out.update(events_per_s=rep["events_per_sec"],
               p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
               max_ms=lat["max_ms"], reconciles=rep["reconciles"])
    return out


# ---- (c) kill one worker process mid-stream ----

def kill_one_worker(dev, batches, want_digest, n_shards=CLUSTER_SHARDS,
                    n_feeds=BENCH_FEEDS, kw=BENCH_KW):
    """Workers placement: a real SIGKILL to shard 0's process halfway
    through the measured stream (no auto-recovery: the outage is the
    driver's), the survivors serve the second half, ``recover_shard(0)``
    (its MTTR pays the new child's torch import and CUDA start and the
    journal replay), then retransmit until the cluster reconverges.  The
    accounting identity closes through the outage and the final cluster
    digest is ``want_digest`` (an uninterrupted in-process run)."""
    d = tempfile.mkdtemp(prefix="rq-cluster-kill-")
    body = batches[WARMUP:]
    half = len(body) // 2
    try:
        with cluster(dev, d, n_shards, "workers", n_feeds, kw,
                     auto_recover=False) as cl:
            for b in batches[:WARMUP]:
                cl.submit(b)
                cl.poll()
            cl.reset_metrics()
            K = cl.coalesce
            serve_rounds(cl, body[:half], K)
            ev0 = sum(s["events_applied"] for s in cl.metrics.report(
                cl.pending_by_shard, cl.health_by_shard)["shards"])
            victim = cl._slots[0].runtime.proc
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait(timeout=30)
            t_kill = time.perf_counter()
            serve_rounds(cl, body[half:], K)
            outage_s = time.perf_counter() - t_kill
            ev1 = sum(s["events_applied"] for s in cl.metrics.report(
                cl.pending_by_shard, cl.health_by_shard)["shards"])
            health = list(cl.health_by_shard)
            check(health[0] == serving.cluster.QUARANTINED
                  and all(h != serving.cluster.QUARANTINED
                          for h in health[1:]),
                  f"after the SIGKILL the shards are {health}")
            t0 = time.perf_counter()
            info = cl.recover_shard(0)
            mttr_recover_ms = (time.perf_counter() - t0) * 1e3
            check(cl._slots[0].runtime.proc.pid != victim.pid,
                  "recover_shard reused the killed process")
            for attempt in range(8):
                missing = [b for b in batches
                           if int(b.seq) > cl.applied_seq]
                if not missing:
                    break
                serve_rounds(cl, missing, K)
            mttr_ms = (time.perf_counter() - t0) * 1e3
            check(cl.applied_seq == batches[-1].seq,
                  f"the cluster did not reconverge: applied_seq "
                  f"{cl.applied_seq} != {batches[-1].seq}")
            rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
            check_identity(rep, "kill one worker")
            digest = cl.cluster_digest()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(digest == want_digest,
          f"the killed-and-recovered cluster's digest {digest[:12]} is not "
          f"the uninterrupted run's {want_digest[:12]}")
    check(rep["crashes"] == 1, f"crashes {rep['crashes']}, not 1")
    return {"killed_pid": victim.pid, "outage_batches": len(body) - half,
            "outage_s": outage_s,
            "survivor_events_per_s_during_outage": (ev1 - ev0) / outage_s,
            "replayed": info.replayed,
            "lost_acked_seqs": len(info.lost_acked_seqs),
            "mttr_recover_ms": mttr_recover_ms,
            "mttr_reconverge_ms": mttr_ms,
            "crashes": rep["crashes"],
            "shed_unavailable": rep["shards"][0]["shed_unavailable"],
            "lost_on_crash": rep["shards"][0]["lost_on_crash"],
            "lost_in_window": rep["lost_in_window"],
            "reconciles": rep["reconciles"], "digest": digest}


# ---- (d) resharding ----

def reshard_offline(dev, batches, n_feeds=BENCH_FEEDS, src_shards=4,
                    dst_shards=2):
    """Serve, close, ``reshard`` src -> dst on ``dev``: the edge digest
    equal across the move, and the resharded cluster serving on."""
    root = tempfile.mkdtemp(prefix="rq-reshard-")
    src, dst = os.path.join(root, "src"), os.path.join(root, "dst")
    try:
        with cluster(dev, src, src_shards, n_feeds=n_feeds) as cl:
            serve_rounds(cl, batches, cl.coalesce)
            want = cl.edge_digest()
        t0 = time.perf_counter()
        rep = serving.reshard(src, dst, dst_shards, device=dev)
        secs = time.perf_counter() - t0
        check(rep["verified"] and rep["edge_digest"] == want,
              "offline reshard: the edge digest moved")
        cl, _ = serving.ServingCluster.recover(dst, device=dev)
        with cl:
            check(cl.edge_digest() == want and cl.n_shards == dst_shards,
                  "offline reshard: the recovered destination differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"from": src_shards, "to": dst_shards, "seq": rep["seq"],
            "edges_per_shard": rep["edges_per_shard"], "reshard_s": secs,
            "edge_digest": want}


def live_grow(dev, batches, n_feeds=BENCH_FEEDS, n_from=3, n_to=4):
    """``begin_reshard`` n_from -> n_to while serving (a round of traffic
    between handoff steps), driven to completion and drained: the
    topology log's records, the edge digest and the ranges moved."""
    d = tempfile.mkdtemp(prefix="rq-live-reshard-")
    try:
        with cluster(dev, d, n_from, n_feeds=n_feeds, q=1.0,
                     coalesce=1) as cl:
            head = len(batches) // 4
            serve_rounds(cl, batches[:head], 8)
            before = cl.edge_digest()
            t0 = time.perf_counter()
            mig = cl.begin_reshard(n_to)
            i, steps = head, 0
            while not mig.done:
                mig.step()
                steps += 1
                serve_rounds(cl, batches[i:i + 8], 8)
                i += 8
            secs = time.perf_counter() - t0
            serve_rounds(cl, batches[i:], 8)
            for _ in range(4):
                cl.poll()
            check(cl.applied_seq == batches[-1].seq,
                  f"live reshard: applied_seq {cl.applied_seq}")
            records, torn = serving.read_topology_log(
                os.path.join(d, serving.TOPOLOGY_LOG))
            check(not torn, "live reshard: the topology log is torn")
            out = {"records": records, "edge_digest": cl.edge_digest(),
                   "edge_digest_before": before, "ranges": steps,
                   "migrate_s": secs, "n_shards": cl.n_shards,
                   "health": list(cl.health_by_shard)}
            rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
            check_identity(rep, "live reshard")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def reshard_checks(dev, n_feeds=BENCH_FEEDS, n_batches=RESHARD_BATCHES):
    batches = bench_stream(n_feeds, n_batches)
    off = reshard_offline(dev, batches, n_feeds)
    live = live_grow(dev, batches, n_feeds)
    ref = live_grow("cpu", batches, n_feeds)
    check(live["records"] == ref["records"],
          "live reshard: the topology records differ from the CPU run's")
    check(live["edge_digest"] == ref["edge_digest"],
          "live reshard: the edge digest differs from the CPU run's")
    live.pop("records")
    return {"offline": off, "live": live,
            "records": len(ref["records"]),
            "record_kinds": sorted({r["kind"] for r in ref["records"]})}


# ---- (e) card against CPU ----

def shard_key(seed, k):
    return [int(w) for w in PRNGKey(serving.shard_seed(seed, k)).tolist()]


def card_against_cpu(dev, n_feeds=BENCH_FEEDS, n_batches=CROSS_BATCHES,
                     n_shards=CLUSTER_SHARDS, q=Q_MIXED, seed=3):
    """The same stream through a 4-shard cluster on ``dev`` and one on
    the CPU, one batch a poll: each shard's decisions equal but for
    near-ties (counted, at most 2%); each shard's digest equal after
    every batch up to its first near-tie."""
    batches = bench_stream(n_feeds, n_batches)
    cpu = torch.device("cpu")
    kw = dict(q=q, seed=seed, coalesce=1, max_batch_events=256)
    t_prev = [0.0] * n_shards
    ties, posts, decisions, lam_err = [], 0, 0, 0.0
    diverged = set()
    with cluster(dev, None, n_shards, n_feeds=n_feeds, kw={}, **kw) as cd, \
            cluster(cpu, None, n_shards, n_feeds=n_feeds, kw={},
                    **kw) as cc:
        for b in batches:
            cd.submit(b)
            cc.submit(b)
            od, oc = cd.poll(), cc.poll()
            dd, dc = cd.shard_digests(), cc.shard_digests()
            for k in range(n_shards):
                check(len(od[k]) == len(oc[k]) == 1,
                      f"card/CPU: shard {k} applied {len(od[k])} and "
                      f"{len(oc[k])} batches at seq {b.seq}")
                x, y = od[k][0], oc[k][0]
                check(x.post_time == y.post_time,
                      f"card/CPU clock differs on shard {k} at {b.seq}")
                lam_err = max(lam_err, abs(x.intensity - y.intensity)
                              / max(abs(y.intensity), 1e-30))
                posts += bool(y.post)
                decisions += 1
                if bool(x.post) != bool(y.post):
                    p = -np.expm1(-float(y.intensity)
                                  * (float(y.post_time) - t_prev[k]))
                    u = _draw(shard_key(seed, k), b.seq)
                    check(abs(u - p) <= NEAR_TIE_RTOL * p,
                          f"card/CPU decision differs on shard {k} at seq "
                          f"{b.seq}: u {u} p {p}")
                    ties.append((k, int(b.seq)))
                    diverged.add(k)
                elif k not in diverged:
                    check(dd[k] == dc[k],
                          f"card/CPU shard {k} digest differs after seq "
                          f"{b.seq}")
                t_prev[k] = float(y.post_time)
        same = cd.cluster_digest() == cc.cluster_digest()
    check(len(ties) <= MAX_NEAR_TIE_SHARE * decisions,
          f"card/CPU near-ties {len(ties)} of {decisions}")
    check(lam_err <= 1e-5, f"card/CPU intensity differs by {lam_err:.3g}")
    check(same or ties, "card/CPU cluster digests differ with no near-tie")
    return {"batches": len(batches), "decisions": decisions, "posts": posts,
            "near_ties": ties, "max_lam_rel_err": lam_err,
            "final_digests_equal": same}


# ---- (f) a fit from the cluster's journals ----

def fit_from_journals(dev, D=FIT_DIMS, t_end=FIT_T_END,
                      n_shards=CLUSTER_SHARDS, iters=FIT_ITERS):
    """Serve a cross-exciting stream through the cluster (binary
    journals), then ``learn.from_journal(cluster_dir)`` -> ``fit_hawkes``
    on ``dev`` (its ``hawkes_pass`` launches counted from 0) and on the
    CPU from the same journals: parameters within 5e-3."""
    mu, alpha, beta = fit_truth(D)
    times, dims = rt.learn.simulate_cross_exciting(mu, alpha, beta,
                                                   t_end=t_end, seed=3)
    dims = dims.astype(np.int32)
    batches = [serving.EventBatch(i, times[s:s + FIT_BATCH],
                                  dims[s:s + FIT_BATCH])
               for i, s in enumerate(range(0, len(times), FIT_BATCH))]
    d = tempfile.mkdtemp(prefix="rq-cluster-fit-")
    try:
        with cluster(dev, d, n_shards, n_feeds=D) as cl:
            serve_rounds(cl, batches, cl.coalesce)
            for _ in range(4):
                cl.poll()
            check(cl.applied_seq == len(batches) - 1,
                  f"fit stream: applied_seq {cl.applied_seq}")
        stream = rt.learn.from_journal(d)
        check(stream.n_events == len(times) and stream.n_dims == D,
              f"from_journal read {stream.n_events} events over "
              f"{stream.n_dims} dimensions, not {len(times)} over {D}")
        kernels.LAUNCHES["hawkes_pass"] = 0
        t0 = time.perf_counter()
        fit = rt.learn.fit_hawkes(stream, solver="em", max_iters=iters,
                                  tol=0.0, device=dev)
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = kernels.LAUNCHES["hawkes_pass"]
        t0 = time.perf_counter()
        fit_cpu = rt.learn.fit_hawkes(stream, solver="em", max_iters=iters,
                                      tol=0.0, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gaps = fits_agree("phase 11 (f) fit from the shard journals", fit,
                      fit_cpu)
    return {"events": int(len(times)), "dims": D, "iters": fit.n_iter,
            "fit_s": fit_s, "cpu_fit_s": cpu_s, "launches": launches,
            "gaps": gaps}


def phase_cluster(dev, n_batches=BENCH_BATCHES):
    """Phase 11."""
    t_start = time.perf_counter()
    batches = bench_stream(BENCH_FEEDS, n_batches)
    res = {}
    res["sockets"] = s = cluster_bench(dev, "sockets", CLUSTER_SHARDS,
                                       batches, check_contexts=True)
    res["in_process"] = ip = cluster_bench(dev, "in-process",
                                           CLUSTER_SHARDS, batches)
    check(s["digest"] == ip["digest"],
          "phase 11 (a): the socket workers' digest differs from the "
          "in-process run's")
    print(f"phase 11 (a) cluster, {BENCH_FEEDS} feeds, {CLUSTER_SHARDS} "
          f"shards, {n_batches} batches of ~{EVENTS_PER_BATCH} events, "
          f"coalesce {BENCH_KW['coalesce']}, tier "
          f"{s['durability']['tier']}: sockets (4 worker processes, "
          f"contexts by {s.get('contexts', {}).get('method')}, opened in "
          f"{s['open_s']:.1f} s) {s['events_per_s']:,.0f} events/s, p50 "
          f"{s['p50_ms']} ms p99 {s['p99_ms']} ms; in process "
          f"{ip['events_per_s']:,.0f} events/s, p50 {ip['p50_ms']} ms p99 "
          f"{ip['p99_ms']} ms; reconciles {s['reconciles']} / "
          f"{ip['reconciles']}")
    sweep = []
    for k in SWEEP:
        r = ip if k == CLUSTER_SHARDS else cluster_bench(
            dev, "in-process", k, batches)
        sweep.append({"n_shards": k, "events_per_s": r["events_per_s"],
                      "p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"]})
    res["sweep"] = sweep
    print("phase 11 (b) in-process sweep: " + "; ".join(
        f"{r['n_shards']} shard(s) {r['events_per_s']:,.0f} events/s p99 "
        f"{r['p99_ms']} ms" for r in sweep))
    res["kill"] = kl = kill_one_worker(dev, batches, ip["digest"])
    print(f"phase 11 (c) SIGKILL of shard 0's process (pid "
          f"{kl['killed_pid']}) halfway: survivors "
          f"{kl['survivor_events_per_s_during_outage']:,.0f} events/s over "
          f"{kl['outage_batches']} batches; recover_shard "
          f"{kl['mttr_recover_ms']:.0f} ms (replayed {kl['replayed']}), "
          f"reconverged in {kl['mttr_reconverge_ms']:.0f} ms; identity "
          f"{kl['reconciles']}, digest = the uninterrupted run's")
    res["reshard"] = rs = reshard_checks(dev)
    print(f"phase 11 (d) offline reshard {rs['offline']['from']} -> "
          f"{rs['offline']['to']} at seq {rs['offline']['seq']} in "
          f"{rs['offline']['reshard_s']:.2f} s, edge digest equal; live "
          f"3 -> 4 under traffic: {rs['live']['ranges']} ranges in "
          f"{rs['live']['migrate_s']:.2f} s, {rs['records']} topology "
          f"records ({', '.join(rs['record_kinds'])}) and the edge digest "
          f"equal to the CPU run's")
    res["cross"] = c = card_against_cpu(dev)
    print(f"phase 11 (e) card vs CPU, {CLUSTER_SHARDS} shards over "
          f"{c['batches']} batches: {len(c['near_ties'])} near-ties in "
          f"{c['decisions']} decisions ({c['posts']} posts), intensity "
          f"within {c['max_lam_rel_err']:.2g}, final digests equal "
          f"{c['final_digests_equal']}")
    res["fit"] = f = fit_from_journals(dev)
    print(f"phase 11 (f) fit from {CLUSTER_SHARDS} shard journals: "
          f"{f['events']} events over {f['dims']} dimensions, EM "
          f"{f['iters']} iterations in {f['fit_s']:.3f} s "
          f"({f['launches']} hawkes_pass launches; CPU "
          f"{f['cpu_fit_s']:.3f} s), card vs CPU "
          + ", ".join(f"{k} {v:.2g}" for k, v in f["gaps"].items()))
    res["launches"] = f["launches"]
    if torch.device(dev).type == "cuda":
        check(res["launches"] > 0,
              "phase 11: the fit launched no hawkes_pass")
    res["phase_s"] = time.perf_counter() - t_start
    print(f"phase 11 cluster: {res['phase_s']:.1f} s")
    return res
