"""Worlds of ranks for the port's mesh tests, on the CPU over gloo.

Imported by the tests, it spawns a world (:func:`run_world`) and holds a
world of one rank in the test's own process (:func:`one_rank`).  Run as
a script, it is one rank of a spawned world: it joins the group through
``parallel.multihost.initialize`` (a ``file://`` rendezvous in the test's
directory, so parallel test workers never share a port), runs the named
cases, writes each case's arrays to ``<out>/<case>.<rank>.npz`` and
leaves.  A rank imports only the port, never JAX; the tests hold what the
ranks wrote against the port's own unsharded runs (computed in the
ranks) and the JAX package's sharded runs (computed in the test on its
8 virtual CPU devices)."""

import argparse
import contextlib
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds a spawned world may take, import and every case included.
WORLD_TIMEOUT_S = 300
#: Seconds a collective waits for the other ranks inside a world.
COLLECTIVE_TIMEOUT_S = 120


def run_world(n: int, cases, out_dir: str, timeout: float = WORLD_TIMEOUT_S):
    """Spawn ``n`` ranks running ``cases``; return ``{case: [rank 0's
    arrays, rank 1's, ...]}``.  Fails if any rank fails."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    env.pop("RQ_FAULT", None)
    cmd = [sys.executable, os.path.abspath(__file__), "--world", str(n),
           "--init", f"file://{out_dir}/pg", "--out", out_dir,
           "--cases", ",".join(cases)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{o[-4000:]}"
    return {c: [dict(np.load(os.path.join(out_dir, f"{c}.{r}.npz")))
                for r in range(n)] for c in cases}


@contextlib.contextmanager
def one_rank(tmp_dir):
    """A world of one rank on the CPU in this process, for the ``with``
    body."""
    from redqueen_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_dir}/pg1", 1, 0, device="cpu",
                         timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        yield
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# The shared inputs (the JAX side builds the same with its own package)
# ---------------------------------------------------------------------------


def component(pkg, B, n=4, T=30.0, q=1.0, capacity=128, **kw):
    """``tests/test_sharding.py``'s component (one Opt against a Poisson
    wall on each of ``n`` feeds), stacked ``B`` times."""
    gb = pkg.GraphBuilder(n_sinks=n, end_time=T)
    opt = gb.add_opt(q=q)
    for i in range(n):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=capacity, **kw)
    params, adj = pkg.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, opt


def _star_builder(pkg):
    if pkg.__name__ == "redqueen_tpu":
        from redqueen_tpu.parallel.bigf import StarBuilder

        return StarBuilder
    return pkg.StarBuilder


def star_poisson(pkg, n_feeds=6, T=40.0, q=1.0, **kw):
    """``tests/test_bigf.py``'s star: Poisson walls, one Opt."""
    sb = _star_builder(pkg)(n_feeds=n_feeds, end_time=T)
    for f in range(n_feeds):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_opt(q=q)
    return sb.build(**kw)


def q_points(pkg, q_grid, F=5, T=12.0, capacity=128, **kw):
    pts = []
    for q in q_grid:
        gb = pkg.GraphBuilder(n_sinks=F, end_time=T)
        gb.add_opt(q=q)
        for i in range(F):
            gb.add_poisson(rate=1.0, sinks=[i])
        pts.append(gb.build(capacity=capacity, **kw))
    return pts


def star_q_points(pkg, q_grid, F=8, T=12.0, **kw):
    pts = []
    for q in q_grid:
        sb = _star_builder(pkg)(n_feeds=F, end_time=T)
        for f in range(F):
            sb.wall_poisson(f, 1.0)
        sb.ctrl_opt(q=q)
        pts.append(sb.build(wall_cap=64, post_cap=256, **kw))
    return pts


STAR_2D_SHAPES = {2: ({"data": 1, "feed": 2}, {"data": 2, "feed": 1}),
                  4: ({"data": 2, "feed": 2}, {"data": 1, "feed": 4},
                      {"data": 4, "feed": 1})}
SWEEP_Q = [0.5, 2.0]
PRESET_2 = dict(scale=0.008, end_time=12.0, wall_cap=256, post_cap=512)
PRESET_3 = dict(scale=0.008, end_time=10.0, capacity=128)


# ---------------------------------------------------------------------------
# The cases a rank runs (each returns a dict of arrays)
# ---------------------------------------------------------------------------


def _np(x):
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def case_summary(n):
    from redqueen_tpu_torch.parallel import comm, multihost

    s = multihost.process_summary()
    return {"summary": np.array(repr(sorted(s.items()))),
            "mesh": np.array(repr(comm.make_mesh({"data": n})))}


def case_shard_data(n):
    """B = 16 over ``{"data": n}`` (and over ``("dcn", "data")`` at 4)."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.parallel.shard import simulate_sharded

    cfg, params, adj, _ = component(rt, 16, device="cpu")
    seeds = np.arange(16)
    ref = rt.simulate_batch(cfg, params, adj, seeds, device="cpu")
    out = {f"ref_{k}": _np(getattr(ref, k))
           for k in ("times", "srcs", "n_events", "health")}
    meshes = {"data": (comm.make_mesh({"data": n}), "data")}
    if n == 4:
        meshes["dcn"] = (comm.make_mesh({"dcn": 2, "data": 2}),
                         ("dcn", "data"))
    for name, (mesh, axis) in meshes.items():
        log = simulate_sharded(cfg, params, adj, seeds, mesh, axis=axis,
                               device="cpu")
        g = multihost.gather_global({k: getattr(log, k) for k in (
            "times", "srcs", "n_events", "health")})
        out.update({f"{name}_{k}": v for k, v in g.items()})
        out[f"{name}_local_rows"] = np.array(log.times.to_local().shape[0])
        out[f"{name}_engine"] = np.array(log.engine)
    return out


def case_shard_metrics(n):
    """Metrics on each rank's rows, gathered."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.parallel.shard import simulate_sharded

    B = 8
    cfg, params, adj, opt = component(rt, B, device="cpu")
    mesh = comm.make_mesh({"data": n})
    log = simulate_sharded(cfg, params, adj, np.arange(B), mesh,
                           device="cpu")
    adj_l = comm.block(adj, mesh, comm.P("data"))
    times, srcs = comm.local((log.times, log.srcs))
    m = rt.feed_metrics_batch(times, srcs, adj_l, opt, cfg.end_time)
    top = multihost.gather_global(
        comm.mark(m.mean_time_in_top_k(), mesh, comm.P("data")))
    ref = rt.simulate_batch(cfg, params, adj, np.arange(B), device="cpu")
    mr = rt.feed_metrics_batch(ref.times, ref.srcs, adj, opt, cfg.end_time)
    return {"top": top, "ref_top": _np(mr.mean_time_in_top_k())}


def case_errors(n):
    """The entry points' refusals."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.parallel.shard import simulate_sharded

    cfg, params, adj, _ = component(rt, n + 1, device="cpu")
    mesh = comm.make_mesh({"data": n})
    scfg, wall, ctrl = star_poisson(rt, n_feeds=2 * n, device="cpu")
    wb, cb = rt.broadcast_star(wall, ctrl, n)
    mesh_sp = comm.make_mesh({"data": n // 2, "sp": 2})
    mesh_f = comm.make_mesh({"f": n})
    return {
        "indivisible": np.array(_error(lambda: simulate_sharded(
            cfg, params, adj, np.arange(n + 1), mesh, device="cpu"))),
        "mesh_size": np.array(_error(lambda: comm.make_mesh({"data": 8}))),
        "process_mesh_bad": np.array(_error(
            lambda: multihost.process_mesh({"data": 3}))),
        "feed_axis_sp": np.array(_error(lambda: rt.simulate_star_batch(
            scfg, wb, cb, np.arange(n), mesh=mesh_sp, feed_axis="sp",
            device="cpu"))),
        "axis_f": np.array(_error(lambda: rt.simulate_star(
            scfg, wall, ctrl, seed=0, mesh=mesh_f, axis="f",
            device="cpu"))),
        "doubling": np.array(_error(lambda: rt.simulate_star(
            scfg, wall, ctrl, seed=0, mesh=comm.make_mesh({"feed": n}),
            fire_mode="doubling", device="cpu"))),
    }


def case_collectives(n):
    """No-ops outside a mesh; reductions inside ``shard_map``."""
    import torch

    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.parallel.bigf import StarConfig, _opt_fires
    from redqueen_tpu_torch.ops import prng

    x = torch.tensor([1.0, 2.0])
    mesh = comm.make_mesh({"data": n})
    xs = torch.arange(8.0)

    def f(blk):
        return comm.psum(blk.sum(), "data") * torch.ones_like(blk)

    out = comm.shard_map(f, mesh, comm.P("data"), comm.P("data"))(xs)

    def sizes(blk):
        return torch.tensor([comm.axis_size_or_1("data"),
                             comm.axis_index("data"),
                             int(comm.axis_present("data")),
                             int(comm.axis_present("feed"))])

    sz = comm.shard_map(sizes, mesh, comm.P("data"), comm.P("data"))(xs)
    mins = comm.shard_map(
        lambda b: torch.stack([comm.pmin(b.min(), "data"),
                               comm.pmax(b.max(), "data")]),
        mesh, comm.P("data"), comm.P())(xs)
    anys = comm.shard_map(
        lambda b: comm.pany(b.max() > 6.5, "data")[None], mesh,
        comm.P("data"), comm.P())(xs)
    fmesh = comm.make_mesh({"feed": n})
    cfg = StarConfig(n_feeds=8, walls_per_feed=1, end_time=20.0,
                     wall_cap=64, post_cap=256)
    ft = torch.as_tensor(np.sort(np.random.default_rng(0).exponential(
        1.0, (1, 8, 64)).astype(np.float32), axis=-1))

    def fires(mode):
        return lambda blk: _opt_fires(
            cfg, blk, torch.ones(1, blk.shape[1]), prng.PRNGKey(0)[None],
            comm.axis_index("feed") * blk.shape[1], fire_mode=mode)[0]

    loop = comm.shard_map(fires("loop"), fmesh, comm.P(None, "feed"),
                          comm.P())(ft)
    return {
        "noop_psum": comm.psum(x).numpy(), "noop_pmin": comm.pmin(x).numpy(),
        "noop_pany": np.array(bool(comm.pany(torch.tensor(True)))),
        "psum_out": multihost.gather_global(out), "sizes":
            multihost.gather_global(sz), "minmax": _np(mins),
        "any": _np(anys),
        "fires_sharded": _np(loop),
        "fires_plain": _np(fires("loop")(ft)),
        "doubling_sharded": np.array(_error(lambda: comm.shard_map(
            fires("doubling"), fmesh, comm.P(None, "feed"), comm.P())(ft))),
    }


def case_gather_rule(n):
    """``gather_global``'s per-leaf rule across ranks."""
    import torch

    from redqueen_tpu_torch.parallel import comm, multihost

    mesh = comm.make_mesh({"data": n})
    own = np.array([1.0, 2.0, 3.0])
    sharded = comm.shard_leading(torch.arange(4 * n), mesh)
    g = multihost.gather_global({"own_times": own, "dev": torch.arange(5),
                                 "sharded": sharded})
    pm = multihost.process_mesh({"data": -1})
    pm2 = multihost.process_mesh({"feed": 1, "data": -1})
    return {**g, "process_mesh": np.array(repr(pm.shape)),
            "process_mesh2": np.array(repr(pm2.shape)),
            "sharded_local": _np(sharded.to_local())}


def case_star(n):
    """``simulate_star`` over ``{"feed": n}``; ``simulate_star_batch`` over
    ``{"data": n}`` and the 2-D layouts."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm, multihost

    out = {}
    cfg, wall, ctrl = star_poisson(rt, n_feeds=8, device="cpu")
    a = rt.simulate_star(cfg, wall, ctrl, seed=7, device="cpu")
    b = rt.simulate_star(cfg, wall, ctrl, seed=7,
                         mesh=comm.make_mesh({"feed": n}), device="cpu")
    gb = multihost.gather_global({
        "own_times": b.own_times, "wall_times": b.wall_times,
        "wall_n": b.wall_n, "top": b.metrics.time_in_top_k,
        "int_rank": b.metrics.int_rank, "int_rank2": b.metrics.int_rank2})
    out.update({f"feed_{k}": v for k, v in gb.items()})
    out.update(feed_n_posts=np.array(b.n_posts), ref_n_posts=np.array(
        a.n_posts), ref_own_times=_np(a.own_times),
        ref_wall_times=_np(a.wall_times), ref_wall_n=_np(a.wall_n),
        ref_top=_np(a.metrics.time_in_top_k),
        feed_mean=_np(b.metrics.mean_time_in_top_k()),
        ref_mean=_np(a.metrics.mean_time_in_top_k()),
        feed_mean_rank=_np(b.metrics.mean_average_rank()),
        ref_mean_rank=_np(a.metrics.mean_average_rank()),
        feed_wall_local=np.array(b.wall_n.to_local().shape[0]))
    cfg, wall, ctrl = star_poisson(rt, n_feeds=8, T=25.0, device="cpu")
    B = 8
    wb, cb = rt.broadcast_star(wall, ctrl, B)
    ref = rt.simulate_star_batch(cfg, wb, cb, np.arange(B), device="cpu")
    out.update(batch_ref_own=_np(ref.own_times), batch_ref_posts=_np(
        ref.n_posts), batch_ref_wall_n=_np(ref.wall_n),
        batch_ref_top=_np(ref.metrics.time_in_top_k),
        batch_ref_mean=_np(ref.metrics.mean_time_in_top_k()))
    layouts = [({"data": n}, None)] + [(s, "feed")
                                       for s in STAR_2D_SHAPES[n]]
    for i, (shape, fa) in enumerate(layouts):
        r = rt.simulate_star_batch(cfg, wb, cb, np.arange(B),
                                   mesh=comm.make_mesh(shape), feed_axis=fa,
                                   device="cpu")
        g = multihost.gather_global({
            "own": r.own_times, "posts": r.n_posts, "wall_n": r.wall_n,
            "top": r.metrics.time_in_top_k,
            "mean": r.metrics.mean_time_in_top_k()})
        out.update({f"batch{i}_{k}": v for k, v in g.items()})
    out["batch_layouts"] = np.array(repr(layouts))
    return out


def case_sweeps(n, ckpt_root):
    """``run_sweep``/``run_sweep_star`` sharded, and a sharded
    checkpointed sweep killed after its first chunk and resumed."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch import sweep
    from redqueen_tpu_torch.parallel import comm

    out = {}
    pts = q_points(rt, SWEEP_Q, device="cpu")
    ref = sweep.run_sweep(pts, n_seeds=8, device="cpu")
    mesh, axis = ((comm.make_mesh({"dcn": 2, "data": 2}), ("dcn", "data"))
                  if n == 4 else (comm.make_mesh({"data": n}), "data"))
    sh = sweep.run_sweep(pts, n_seeds=8, mesh=mesh, axis=axis, device="cpu")
    for f in sweep.SweepResult._fields:
        out[f"ref_{f}"] = getattr(ref, f)
        out[f"sh_{f}"] = getattr(sh, f)
    out["engine_error"] = np.array(_error(lambda: sweep.run_sweep(
        pts, n_seeds=8, mesh=mesh, axis=axis, engine="fused",
        device="cpu")))
    spts = star_q_points(rt, SWEEP_Q, device="cpu")
    sref = sweep.run_sweep_star(spts, n_seeds=4, device="cpu")
    for i, (m, fa) in enumerate(((comm.make_mesh({"data": n}), None),
                                 (comm.make_mesh({"data": n // 2, "feed": 2}),
                                  "feed"))):
        ssh = sweep.run_sweep_star(spts, n_seeds=4, mesh=m, feed_axis=fa,
                                   device="cpu")
        for f in sweep.SweepResult._fields:
            out[f"star{i}_{f}"] = getattr(ssh, f)
    for f in sweep.SweepResult._fields:
        out[f"star_ref_{f}"] = getattr(sref, f)
    # Killed after the first chunk lands, then resumed.
    cpts = q_points(rt, [0.25, 0.5, 1.0, 2.0, 4.0], device="cpu")
    want = sweep.run_sweep(cpts, n_seeds=4, device="cpu")
    ckpt = os.path.join(ckpt_root, "ckpt")
    calls = []
    real = sweep._preempt.check_preempt

    class Killed(Exception):
        pass

    def kill_after_first(where):
        calls.append(where)
        raise Killed(where)

    sweep._preempt.check_preempt = kill_after_first
    try:
        sweep.run_sweep_checkpointed(cpts, 4, ckpt, chunk_points=2,
                                     mesh=mesh, axis=axis, device="cpu")
    except Killed:
        pass
    finally:
        sweep._preempt.check_preempt = real
    ran = []
    real_run = sweep.run_sweep

    def counting(p, k, **kw):
        ran.append(len(p))
        return real_run(p, k, **kw)

    sweep.run_sweep = counting
    try:
        got = sweep.run_sweep_checkpointed(cpts, 4, ckpt, chunk_points=2,
                                           mesh=mesh, axis=axis,
                                           device="cpu")
    finally:
        sweep.run_sweep = real_run
    for f in sweep.SweepResult._fields:
        out[f"ckpt_want_{f}"] = getattr(want, f)
        out[f"ckpt_got_{f}"] = getattr(got, f)
    out["ckpt_killed_after"] = np.array(len(calls))
    out["ckpt_resumed_points"] = np.array(ran)
    # A lane poisoned in chunk 1, recorded sick, then healed alone on the
    # next run (the heal drops the mesh: one lane divides no axis).
    hpts = cpts[:4]
    heal = os.path.join(ckpt_root, "heal")
    os.environ["RQ_FAULT"] = "numeric:nan@lane5,chunk1"
    try:
        sick = sweep.run_sweep_checkpointed(hpts, 4, heal, chunk_points=2,
                                            mesh=mesh, axis=axis,
                                            device="cpu")
    finally:
        del os.environ["RQ_FAULT"]
    healed = sweep.run_sweep_checkpointed(hpts, 4, heal, chunk_points=2,
                                          mesh=mesh, axis=axis, device="cpu")
    out["heal_sick"] = np.flatnonzero(sick.health.reshape(-1))
    for f in sweep.SweepResult._fields:
        out[f"heal_{f}"] = getattr(healed, f)
    return out


def case_presets(n):
    """``run_preset`` with a mesh against the same preset without."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm

    out = {}
    data = comm.make_mesh({"data": n})
    runs = {
        "batch": (rt.build_preset(3, **PRESET_3, device="cpu"),
                  np.arange(8), data),
        "star_data": (rt.build_preset(2, **PRESET_2, device="cpu"),
                      np.arange(8), data),
        "star_feed": (rt.build_preset(2, **PRESET_2, device="cpu"),
                      np.arange(2), comm.make_mesh({"feed": n})),
        "star_2d": (rt.build_preset(2, **PRESET_2, device="cpu"),
                    np.arange(4), comm.make_mesh({"data": n // 2,
                                                  "feed": 2})),
    }
    for name, (bundle, seeds, mesh) in runs.items():
        sh = rt.run_preset(bundle, seeds, mesh=mesh, device="cpu")
        ref = rt.run_preset(bundle, seeds, device="cpu")
        for k in ("per_seed_top_k", "per_seed_posts"):
            out[f"{name}_{k}"] = np.asarray(sh[k])
            out[f"{name}_ref_{k}"] = np.asarray(ref[k])
        for k in ("events", "mean_time_in_top_k", "mean_posts"):
            out[f"{name}_{k}"] = np.asarray(sh[k])
            out[f"{name}_ref_{k}"] = np.asarray(ref[k])
    return out


CASES = {"summary": case_summary, "shard_data": case_shard_data,
         "shard_metrics": case_shard_metrics, "errors": case_errors,
         "collectives": case_collectives, "gather_rule": case_gather_rule,
         "star": case_star, "sweeps": case_sweeps, "presets": case_presets}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.environ["RQ_LANES_AUTOTUNE"] = os.path.join(
        args.out, f"autotune.{args.rank}.json")
    from redqueen_tpu_torch.parallel import multihost

    multihost.initialize(args.init, args.world, args.rank, device="cpu",
                         timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        for name in args.cases.split(","):
            fn = CASES[name]
            got = (fn(args.world, args.out) if name == "sweeps"
                   else fn(args.world))
            np.savez(os.path.join(args.out, f"{name}.{args.rank}.npz"),
                     **got)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
