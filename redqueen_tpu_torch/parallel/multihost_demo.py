"""One rank of an N-process run of the port: the counterpart of the JAX
package's ``tools/multihost_demo.py``, with the same computation and the
same summary.

Each rank joins the run through ``multihost.initialize``, builds the
process-aligned mesh (``{"dcn": N, "data": 1}``: a rank drives one
device), runs the sharded simulation over ``("dcn", "data")``, gathers
the event log on every rank, runs the star engine with its feed axis
across every rank (the fire clock's ``pmin`` crosses the process
boundary), and rank 0 writes the summary as JSON::

    python -m redqueen_tpu_torch.parallel.multihost_demo \\
        --coordinator localhost:9876 --num-procs 2 --proc-id 0 \\
        --out /tmp/p0.json --device cpu &
    python -m redqueen_tpu_torch.parallel.multihost_demo \\
        --coordinator localhost:9876 --num-procs 2 --proc-id 1 \\
        --out /tmp/p1.json --device cpu

``--coordinator`` may also be an init URL (``file:///path``); without
the flags the ``RQ_COORDINATOR``/``RQ_NUM_PROCESSES``/``RQ_PROCESS_ID``
environment is read.  ``--device`` is ``cuda`` (the default: the rank's
card, shared over gloo when ranks outnumber cards) or ``cpu``."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def summary(device) -> dict:
    """The demo's computation on the current process group."""
    import redqueen_tpu_torch as rt
    from redqueen_tpu_torch.parallel import comm, multihost
    from redqueen_tpu_torch.parallel.shard import simulate_sharded

    n, T, q = 4, 60.0, 1.0
    gb = rt.GraphBuilder(n_sinks=n, end_time=T)
    opt = gb.add_opt(q=q)
    for i in range(n):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=1024, device=device)

    B = 16
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    mesh = multihost.process_mesh({"data": -1})
    axis = ("dcn", "data")
    log = simulate_sharded(cfg, params, adj, np.arange(B), mesh, axis=axis,
                           device=device)
    times, srcs = comm.local((log.times, log.srcs))
    m = rt.feed_metrics_batch(times, srcs, comm.block(adj, mesh,
                                                      comm.P(axis)), opt, T)
    gathered = multihost.gather_global({
        "times": log.times, "srcs": log.srcs,
        "top1": comm.mark(m.mean_time_in_top_k(), mesh, comm.P(axis))})

    # The star engine with its feed axis over every rank: 8 feeds, rank r
    # holding feeds [r * 8 / N, (r + 1) * 8 / N).
    feed_mesh = comm.make_mesh({"feed": -1})
    sb = rt.StarBuilder(n_feeds=8, end_time=T)
    for f in range(8):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_opt(q=q)
    scfg, swall, sctrl = sb.build(wall_cap=256, post_cap=512, device=device)
    star = rt.simulate_star(scfg, swall, sctrl, seed=3, mesh=feed_mesh,
                            axis="feed", device=device)
    own64 = star.own_times.detach().cpu().numpy().astype(np.float64)
    star_gathered = multihost.gather_global({
        "wall_n": star.wall_n, "top1": star.metrics.time_in_top_k,
        # A replicated leaf beside the sharded ones: it must come back
        # with its own shape, not once per rank.
        "own_times": star.own_times})

    out = multihost.process_summary()
    t64 = np.asarray(gathered["times"], np.float64)
    out.update(
        mesh_shape={k: int(v) for k, v in mesh.shape.items()},
        # finite entries only: the +inf pad would make the sum inf
        times_sum=float(t64[np.isfinite(t64)].sum()),
        srcs_sum=int(np.asarray(gathered["srcs"], np.int64).sum()),
        top1_mean=float(np.asarray(gathered["top1"]).mean()),
        times_shape=list(gathered["times"].shape),
        star_n_posts=int(star.n_posts),
        star_own_sum=float(own64[np.isfinite(own64)].sum()),
        star_wall_n=[int(x) for x in star_gathered["wall_n"]],
        star_top1=[round(float(x), 6) for x in star_gathered["top1"]],
        star_own_shape=list(np.asarray(star_gathered["own_times"]).shape),
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator")
    ap.add_argument("--num-procs", type=int)
    ap.add_argument("--proc-id", type=int)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from redqueen_tpu_torch.parallel import multihost
    from redqueen_tpu_torch.runtime import atomic_write_json

    pid, nproc = multihost.initialize(args.coordinator, args.num_procs,
                                      args.proc_id, device=args.device)
    try:
        if args.num_procs is not None and nproc != args.num_procs:
            raise RuntimeError(f"joined a world of {nproc}, asked for "
                               f"{args.num_procs}")
        out = summary(multihost.rank_device())
        if pid == 0:
            # Atomic: the caller reads it the moment rank 0 exits.
            atomic_write_json(args.out, out, trailing_newline=False)
        print(f"[rank {pid}/{nproc}] OK: {out}", flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
