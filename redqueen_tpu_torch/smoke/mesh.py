"""Phase 13 of the smoke run: the mesh layer on the card.

(a) A world of one rank on NCCL (``cuda:0``) at full width: the headline
(B = 10,000 components of one Opt against 10 Poisson walls, T = 100,
q = 1, phase 5's seeds) through ``simulate_sharded`` on
``make_mesh({"data": 1})``, every lane bit-identical to
``simulate_batch(engine="scan")`` on the card, ``log.engine == "scan"``
and no event-kernel launch (the wrapper's count and
``engine.pallas.launches``), both runs timed.  Then two ranks sharing
``cuda:0`` over gloo, each a child process started with the
``RQ_COORDINATOR``/``RQ_NUM_PROCESSES``/``RQ_PROCESS_ID`` environment
(``python -m redqueen_tpu_torch.smoke.mesh --child``), each printing its
``process_summary()``: (b) 5,000 of (a)'s lanes a rank, gathered on both
ranks equal to (a) bit for bit, and ``run_sweep`` on ``{"data": 2}`` on
the trade-off experiment's q grid (32 seeds a point) equal to its
unsharded grid; (c) config 4 at ``benchmarks/run.py``'s full settings
(100,000 replay feeds, q = 2,500), seed 0, through ``simulate_star`` on
``{"feed": 2}``: posts, ``wall_n`` and the per-feed metrics bit for bit
those of the unsharded loop-mode run on the card, its fires split into
the ranks' own work and the ``pmin`` collectives (count, mean us); (d)
config 2 (1,000 Hawkes feeds), 4 seeds, through ``simulate_star_batch``
on ``{"data": 2}`` and on ``{"data": 1, "feed": 2}``, equal to the
unsharded batch; (e) ``run_preset`` of config 1 at 1,024 seeds on
``{"data": 2}``, equal to the unsharded preset.  This process builds
config 4 once for the ranks and runs the unsharded references of
(b)-(e) and then (a) beside them.

Run alone: ``python -c "import torch, chip_smoke as c; c.phase_device();
c.phase_mesh(torch.device('cuda', 0))"``."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.experiments import tradeoff
from redqueen_tpu_torch.ops import kernels
from redqueen_tpu_torch.parallel import comm, multihost
from redqueen_tpu_torch.parallel.shard import simulate_sharded
from redqueen_tpu_torch.runtime import telemetry
from .common import check, sync
from .fused import headline_component
from .presets import PRESET_FULL, StageTimer

#: The phase's settings: the headline's width, the trade-off sweep's
#: seeds a point, and the presets at ``benchmarks/run.py``'s full
#: settings (configs 1, 2, 4) with their seeds; config 1 steps in the
#: headline's chunks of 64 events (``shape_budget``), not 2,048, which
#: changes no event and saves the last chunk's idle steps.
MESH = dict(headline_B=10_000, T=100.0, sweep_seeds=32,
            preset1=dict(PRESET_FULL[1], capacity=64), preset1_seeds=1024,
            preset2=PRESET_FULL[2], preset2_seeds=4, preset4=PRESET_FULL[4])
RANKS = 2
BUDGET_S = 90.0
CHILD_WAIT_S = 300.0
#: Seconds a collective waits for the other rank before it fails.
COLLECTIVE_TIMEOUT_S = 120.0
MEAN_RTOL = 1e-6
LOG_FIELDS = ("times", "srcs", "n_events", "health")


def digest(arrays) -> str:
    """SHA-256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def headline(dev, settings):
    """The headline's inputs: ``(cfg, params, adj, seeds, max_chunks)``."""
    cfg, params, adj, _, mc = headline_component(settings["headline_B"],
                                                 settings["T"], dev)
    return cfg, params, adj, np.arange(settings["headline_B"]), mc


def warm_up(dev, mesh):
    """The first sharded mark imports and sets up DTensor (about a second
    on the host): done before any timed run."""
    multihost.gather_global(comm.mark(torch.zeros(mesh.size, device=dev),
                                      mesh, comm.P(mesh.axis_names[0])))


PROBE_COLLECTIVES = 200


def collective_probe(dev, mesh) -> float:
    """Mean us of one ``pmin`` of one float on ``mesh``'s first axis with
    nothing queued on the card (through the host on gloo)."""
    x = torch.ones(1, 1, device=dev)
    run = comm.shard_map(lambda b: comm.pmin(b, mesh.axis_names[0]), mesh,
                         comm.P(), comm.P())
    run(x)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(PROBE_COLLECTIVES):
        run(x)
    sync(dev)
    return 1e6 * (time.perf_counter() - t0) / PROBE_COLLECTIVES


def _pallas_launches():
    return telemetry.get().counters.get("engine.pallas.launches", 0)


def _lanes_differing(got, want) -> int:
    """Lane fields of a gathered log that differ from ``want``'s."""
    B = len(want[2])
    return int(sum((~np.all(g.reshape(B, -1) == w.reshape(B, -1),
                            axis=1)).sum() for g, w in zip(got[:2], want[:2]))
               + (got[2] != want[2]).sum() + (got[3] != want[3]).sum())


def world_of_one(dev, settings, tmp):
    """(a): the headline on ``{"data": 1}`` of a world of one rank (NCCL
    on the card) against the unsharded scan run, timed in the order
    unsharded, sharded, sharded, unsharded while the ranks run beside
    it: a drift in their load weighs on both sides alike.  Its gathered
    log is what the ranks' gathered headline is held against."""
    cfg, params, adj, seeds, mc = headline(dev, settings)
    multihost.initialize(f"file://{tmp}/pg1", 1, 0, device=dev,
                         timeout_s=COLLECTIVE_TIMEOUT_S)
    secs = {"plain": [], "sharded": []}
    want, bad, launches = None, 0, [0, 0]
    try:
        backend = multihost.process_summary()["backend"]
        check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
              f"phase 13 (a): a world of one on {dev.type} chose {backend}")
        mesh = comm.make_mesh({"data": 1})
        warm_up(dev, mesh)
        comm.reset_stats()
        for kind in ("plain", "sharded", "sharded", "plain"):
            k0, p0 = kernels.LAUNCHES["event_kernel"], _pallas_launches()
            sync(dev)
            t0 = time.perf_counter()
            if kind == "plain":
                log = rt.simulate_batch(cfg, params, adj, seeds,
                                        max_chunks=mc, engine="scan",
                                        device=dev)
            else:
                log = simulate_sharded(cfg, params, adj, seeds, mesh,
                                       max_chunks=mc, device=dev)
            sync(dev)
            secs[kind].append(time.perf_counter() - t0)
            check(log.engine == "scan", f"phase 13 (a): engine "
                                        f"{log.engine!r}, want scan")
            if kind == "sharded":
                launches[0] += kernels.LAUNCHES["event_kernel"] - k0
                launches[1] += _pallas_launches() - p0
            t0 = time.perf_counter()
            got = multihost.gather_global([getattr(log, k)
                                           for k in LOG_FIELDS])
            gather_s = time.perf_counter() - t0
            del log
            if want is None:
                want = got
            else:
                bad += _lanes_differing(got, want)
                bad += sum(g.shape != w.shape for g, w in zip(got, want))
        stats = {k: list(v) for k, v in comm.STATS.items()}
    finally:
        multihost.shutdown()
    check(launches == [0, 0], f"phase 13 (a): the sharded runs launched "
                              f"the event kernel {launches}")
    check(bad == 0, f"phase 13 (a): {bad} lane field(s) differ from the "
                    f"unsharded scan run")
    n_events = int(want[2].sum())
    plain_s, sharded_s = (float(np.mean(secs[k]))
                          for k in ("plain", "sharded"))
    print(f"  (a) world of 1 ({backend}): {len(seeds)} lanes, {n_events} "
          f"events bit-identical; unsharded scan "
          f"{', '.join(f'{x:.3f}' for x in secs['plain'])} s, sharded "
          f"{', '.join(f'{x:.3f}' for x in secs['sharded'])} s (means "
          f"{plain_s:.3f} / {sharded_s:.3f}: {sharded_s - plain_s:+.3f}), "
          f"gather {gather_s:.3f} s; 0 event-kernel launches; collectives "
          f"{stats}")
    return {"lanes": len(seeds), "events": n_events,
            "plain_s": secs["plain"], "sharded_s": secs["sharded"],
            "overhead_s": sharded_s - plain_s,
            "gather_s": gather_s, "backend": backend, "collectives": stats,
            "launches": {"event_kernel": launches[0],
                         "pallas": launches[1]}}, digest(want)


def sweep_points(dev, settings):
    cap, mc = rt.shape_budget(10, settings["T"], 1.0)
    return tradeoff.opt_points(tradeoff.QGRID, T=settings["T"],
                               capacity=cap, device=dev), mc


def _star_bundle(which, settings, dev):
    return rt.build_preset(which, device=dev, **settings[f"preset{which}"])


C4_FILE = "config4.pt"


def share_bundle(tmp, settings, dev):
    """Config 4's bundle (100,000 replay feeds: seconds to build), built
    once here and handed to the ranks through ``tmp``."""
    bundle = _star_bundle(4, settings, dev)
    part = os.path.join(tmp, C4_FILE + ".part")
    torch.save(bundle, part)
    os.replace(part, os.path.join(tmp, C4_FILE))
    return bundle


def shared_bundle(tmp, dev):
    """A rank's copy of :func:`share_bundle`'s bundle, once it is there."""
    path = os.path.join(tmp, C4_FILE)
    deadline = time.perf_counter() + CHILD_WAIT_S
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"no {path} within {CHILD_WAIT_S} s")
        time.sleep(0.05)
    return torch.load(path, map_location=dev, weights_only=False)


def references(dev, settings, bundle4):
    """The unsharded runs (b)-(e) are held against, on this process."""
    out = {}
    pts, mc = sweep_points(dev, settings)
    out["sweep"] = rt.run_sweep(pts, settings["sweep_seeds"], max_chunks=mc,
                                device=dev)
    _, cfg, wall, ctrl = bundle4
    res = rt.simulate_star(cfg, wall, ctrl, seed=0, fire_mode="loop",
                           device=dev)
    out["c4"] = star_arrays(res)
    _, cfg, wall, ctrl = _star_bundle(2, settings, dev)
    n = settings["preset2_seeds"]
    wb, cb = rt.broadcast_star(wall, ctrl, n)
    out["c2"] = batch_arrays(rt.simulate_star_batch(cfg, wb, cb,
                                                    np.arange(n),
                                                    device=dev))
    b1 = rt.build_preset(1, device=dev, **settings["preset1"])
    out["c1"] = rt.run_preset(b1, np.arange(settings["preset1_seeds"]),
                              device=dev)
    return out


def star_arrays(res) -> dict:
    """A ``StarResult``'s arrays, whole, as numpy (every rank calls it)."""
    g = multihost.gather_global({
        "own_times": res.own_times, "wall_n": res.wall_n,
        "top": res.metrics.time_in_top_k, "int_rank": res.metrics.int_rank,
        "int_rank2": res.metrics.int_rank2})
    g["n_posts"] = np.asarray(res.n_posts)
    g["mean"] = np.asarray(comm.local(
        res.metrics.mean_time_in_top_k()).cpu())
    return g


def batch_arrays(res) -> dict:
    return multihost.gather_global({
        "own_times": res.own_times, "n_posts": res.n_posts,
        "wall_n": res.wall_n, "top": res.metrics.time_in_top_k,
        "int_rank": res.metrics.int_rank,
        "mean": res.metrics.mean_time_in_top_k()})


# --------------------------------------------------------------------------
# a rank of the two-rank world
# --------------------------------------------------------------------------


def child(tmp) -> int:
    """One rank of (b)-(e): joins from the ``RQ_*`` environment, runs the
    sharded runs, writes its arrays (rank 0) and its timings."""
    with open(os.path.join(tmp, "settings.json")) as f:
        settings = json.load(f)
    dev = torch.device(settings["device"])
    t_start = time.perf_counter()
    rank, world = multihost.initialize(device=dev,
                                       timeout_s=COLLECTIVE_TIMEOUT_S)
    dev = multihost.rank_device(dev)
    summary = multihost.process_summary()
    times, arrays = {"joined_at": time.time()}, {}
    k0 = kernels.LAUNCHES["event_kernel"]
    try:
        data = comm.make_mesh({"data": world})
        warm_up(dev, data)
        times["pmin_probe_us"] = collective_probe(dev, data)
        # (b) the headline, 5,000 lanes a rank, gathered on both.
        cfg, params, adj, seeds, mc = headline(dev, settings)
        sync(dev)
        t0 = time.perf_counter()
        log = simulate_sharded(cfg, params, adj, seeds, data, max_chunks=mc,
                               device=dev)
        sync(dev)
        times["headline_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = multihost.gather_global([getattr(log, k) for k in LOG_FIELDS])
        times["gather_s"] = time.perf_counter() - t0
        arrays["headline_digest"] = np.array(digest(got))
        del log, got
        pts, mc = sweep_points(dev, settings)
        t0 = time.perf_counter()
        grid = rt.run_sweep(pts, settings["sweep_seeds"], mesh=data,
                            max_chunks=mc, device=dev)
        times["sweep_s"] = time.perf_counter() - t0
        arrays.update({f"sweep_{f}": getattr(grid, f)
                       for f in grid._fields})
        # (c) config 4 with its feeds over the ranks.
        _, cfg, wall, ctrl = shared_bundle(tmp, dev)
        comm.reset_stats()
        sync(dev)
        t0 = time.perf_counter()
        with StageTimer(dev) as stages:
            res = rt.simulate_star(cfg, wall, ctrl, seed=0,
                                   mesh=comm.make_mesh({"feed": world}),
                                   device=dev)
        times["c4_s"] = time.perf_counter() - t0
        times["c4_stages_s"] = dict(stages.seconds)
        times["c4_collectives"] = {k: list(v)
                                   for k, v in comm.STATS.items()}
        arrays.update({f"c4_{k}": v for k, v in star_arrays(res).items()})
        # (d) config 2 over lanes, and over lanes x feeds.
        _, cfg, wall, ctrl = _star_bundle(2, settings, dev)
        n = settings["preset2_seeds"]
        wb, cb = rt.broadcast_star(wall, ctrl, n)
        for name, shape, fa in (("data", {"data": world}, None),
                                ("feed", {"data": 1, "feed": world},
                                 "feed")):
            t0 = time.perf_counter()
            res = rt.simulate_star_batch(cfg, wb, cb, np.arange(n),
                                         mesh=comm.make_mesh(shape),
                                         feed_axis=fa, device=dev)
            got = batch_arrays(res)
            times[f"c2_{name}_s"] = time.perf_counter() - t0
            arrays.update({f"c2_{name}_{k}": v for k, v in got.items()})
        # (e) config 1 at 1,024 seeds over both ranks.
        b1 = rt.build_preset(1, device=dev, **settings["preset1"])
        t0 = time.perf_counter()
        c1 = rt.run_preset(b1, np.arange(settings["preset1_seeds"]),
                           mesh=data, device=dev)
        times["c1_s"] = time.perf_counter() - t0
        arrays["c1_json"] = np.array(json.dumps(c1))
    finally:
        multihost.shutdown()
    times["event_kernel_launches"] = kernels.LAUNCHES["event_kernel"] - k0
    times["total_s"] = time.perf_counter() - t_start
    times["summary"] = summary
    if rank == 0:
        np.savez(os.path.join(tmp, "rank0.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(times, f)
    print(f"  rank {rank}: done in {times['total_s']:.1f} s", flush=True)
    return 0


def start_children(tmp, settings, dev, ranks=RANKS):
    """The ranks, started together with the launcher environment."""
    with open(os.path.join(tmp, "settings.json"), "w") as f:
        json.dump({**settings, "device": dev.type}, f)
    procs = []
    for r in range(ranks):
        env = dict(os.environ, **{
            multihost.ENV_COORD: f"file://{tmp}/pg2",
            multihost.ENV_NPROC: str(ranks), multihost.ENV_PROC_ID: str(r)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "redqueen_tpu_torch.smoke.mesh",
             "--child", tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def stop(procs):
    """Kill the ranks still running (a failed phase leaves none)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def wait_children(procs):
    outs = [p.communicate(timeout=CHILD_WAIT_S)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        print("\n".join(ln for ln in o.splitlines() if ln.startswith("  ")))
        check(p.returncode == 0, f"phase 13: rank {r} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8) if a.dtype.kind == "f" else a,
        b.view(np.uint8) if b.dtype.kind == "f" else b)


def compare(got, refs, headline_digest, settings):
    """(b)-(e) against the unsharded references; returns the counts."""
    check(str(got["headline_digest"]) == headline_digest,
          "phase 13 (b): the gathered two-rank headline differs from (a)")
    sweep = refs["sweep"]
    bad = [f for f in sweep._fields
           if not _same(got[f"sweep_{f}"], getattr(sweep, f))]
    check(not bad, f"phase 13 (b): sharded sweep fields {bad} differ")
    bad = [k for k, v in refs["c4"].items()
           if k != "mean" and not _same(got[f"c4_{k}"], v)]
    check(not bad, f"phase 13 (c): config 4 fields {bad} differ from the "
                   f"unsharded loop-mode run")
    check(np.allclose(got["c4_mean"], refs["c4"]["mean"], rtol=MEAN_RTOL,
                      atol=0), "phase 13 (c): config 4's mean time-in-top-1")
    for name in ("data", "feed"):
        bad = [k for k, v in refs["c2"].items() if k != "mean"
               and not _same(got[f"c2_{name}_{k}"], v)]
        check(not bad, f"phase 13 (d): config 2 on {name}: {bad} differ")
        check(np.allclose(got[f"c2_{name}_mean"], refs["c2"]["mean"],
                          rtol=MEAN_RTOL, atol=0),
              f"phase 13 (d): config 2 on {name}: mean time-in-top-1")
    c1 = json.loads(str(got["c1_json"]))
    check(c1 == refs["c1"], "phase 13 (e): run_preset of config 1 on "
                            "{'data': 2} differs from the unsharded preset")
    return {"c4_posts": int(refs["c4"]["n_posts"]),
            "c1_events": c1["events"]}


def phase_mesh(dev, settings=MESH, ranks=RANKS):
    """Phase 13; returns its measurements.  ``ranks`` child ranks: two
    sharing the card over gloo in the smoke run; as many as there are
    cards, each on its own over NCCL, from ``python -m
    redqueen_tpu_torch.smoke.mesh --ranks N``."""
    t_start = time.perf_counter()
    print("phase 13 mesh:")
    with tempfile.TemporaryDirectory(prefix="rq_mesh_") as tmp:
        # The ranks start and run while this process builds config 4 for
        # them, runs the references and then (a).
        t0, spawned_at = time.perf_counter(), time.time()
        procs = start_children(tmp, settings, dev, ranks)
        try:
            refs = references(dev, settings,
                              share_bundle(tmp, settings, dev))
            sync(dev)
            refs_s = time.perf_counter() - t0
            a, headline_digest = world_of_one(dev, settings, tmp)
            wait_children(procs)
            wall_s = time.perf_counter() - t0
        finally:
            stop(procs)
        got = dict(np.load(os.path.join(tmp, "rank0.npz")))
        reports = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        counts = compare(got, refs, headline_digest, settings)
    launches = sum(r["event_kernel_launches"] for r in reports)
    check(launches == 0, f"phase 13: the ranks launched the event kernel "
                         f"{launches} times")
    r0 = reports[0]
    join_s = max(r["joined_at"] for r in reports) - spawned_at
    pmin = r0["c4_collectives"].get("pmin", [0, 0.0])
    fires = r0["c4_stages_s"]["fires"]
    pmin_us = 1e6 * pmin[1] / max(pmin[0], 1)
    print(f"  (b) {ranks} ranks ({r0['summary']['backend']}, "
          f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
          f"card(s)): children {wall_s:.1f} s "
          f"wall, joined {join_s:.1f} s after the spawn; config 4's "
          f"build and the references ({refs_s:.1f} s), then (a), ran "
          f"beside them; a pmin alone {r0['pmin_probe_us']:.1f} "
          f"us; headline shard {r0['headline_s']:.3f} s, gather "
          f"{r0['gather_s']:.3f} s: bit-identical to (a); sweep "
          f"{r0['sweep_s']:.3f} s equal to unsharded")
    print(f"  (c) config 4 on {{'feed': {ranks}}}: {r0['c4_s']:.3f} s, "
          f"{counts['c4_posts']} posts bit-identical; fires {fires:.3f} s = "
          f"{pmin[0]} pmin x {pmin_us:.1f} us (each waits for its step's "
          f"queued work) + {fires - pmin[1]:.3f} s issuing the steps")
    print(f"  (d) config 2 on data {r0['c2_data_s']:.3f} s, on data x feed "
          f"{r0['c2_feed_s']:.3f} s; (e) config 1 preset "
          f"{r0['c1_s']:.3f} s: equal to unsharded")
    total = time.perf_counter() - t_start
    print(f"phase 13: {total:.1f} s (budget {BUDGET_S:.0f} s)")
    check(total <= BUDGET_S, f"phase 13 took {total:.1f} s, over its "
                             f"{BUDGET_S:.0f} s budget")
    return {"world_of_one": a,
            "children_wall_s": wall_s, "join_s": join_s,
            "references_s": refs_s, "ranks": reports,
            "pmin_count": pmin[0], "pmin_mean_us": pmin_us,
            "pmin_probe_us": r0["pmin_probe_us"],
            "c4_fires_s": fires, "c4_fires_local_s": fires - pmin[1],
            "total_s": total,
            "launches": {"event_kernel": launches
                         + a["launches"]["event_kernel"],
                         "hawkes_pass": 0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="phase 13, or one of its "
                                             "ranks")
    ap.add_argument("--child", metavar="DIR",
                    help="run as a rank (the RQ_* environment joins it)")
    ap.add_argument("--ranks", type=int, default=RANKS,
                    help="ranks of the phase run alone on the card")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    print(json.dumps({"mesh": phase_mesh(torch.device("cuda", 0),
                                         ranks=args.ranks)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
