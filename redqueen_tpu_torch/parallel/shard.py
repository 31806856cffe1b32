"""Sharded batch runs: the counterpart of ``redqueen_tpu.parallel.shard``.
Components of a batch do not couple (a broadcaster's control reads only
its own followers' ranks), so a batch splits over the ranks of a mesh
axis with no communication in the hot loop: each rank runs the scan
engine's ``simulate_batch`` on its rows with their own seeds.  A lane's
streams depend only on its seed, so every lane is bit-identical to the
unsharded run; sharding changes placement, never results.

This file holds no kernel logic: it places data and calls
``sim.simulate_batch`` itself, so the sharded and unsharded paths cannot
drift apart."""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, SourceParams
from ..device import DeviceLike, resolve_device
from ..runtime import faultinject as _faultinject
from ..runtime.numerics import NumericalHealthError
from ..sim import EventLog, simulate_batch
from . import comm

__all__ = ["simulate_sharded"]


def _rows(x):
    return int(x.shape[0])


def _agree(mesh, axis, width: int, failed: bool, dead: bool, dev):
    """One all-reduce over every rank of ``axis``: the widest log, whether
    any rank failed, and whether every rank's lanes all died."""
    flags = torch.tensor([width, int(failed), -int(dead)], dtype=torch.int64,
                         device=dev)
    width, failed, neg_dead = comm.mesh_reduce(flags, mesh, "MAX",
                                               axis).tolist()
    return int(width), bool(failed), neg_dead == -1


def _pad(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    if x.shape[1] == width:
        return x
    pad = torch.full((x.shape[0], width - x.shape[1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], 1)


def simulate_sharded(cfg: SimConfig, params: SourceParams, adj, seeds,
                     mesh: comm.Mesh, axis="data", max_chunks: int = 100,
                     return_state: bool = False,
                     device: DeviceLike = "cuda"):
    """Run a component batch split over ``mesh`` axis ``axis`` (a name, or
    a tuple of names in the mesh's order such as ``("dcn", "data")``) on
    this rank's ``device`` (the card by default).

    ``params``/``adj``/``seeds`` carry the whole batch (or are already
    sharded by ``comm.shard_leading``), its size divisible by the axis
    size.  Each rank runs its rows on the scan engine.  The log's
    ``times``/``srcs``/``n_events``/``health`` are marked as sharded over
    the axis (``multihost.gather_global`` assembles them, equal to
    ``simulate_batch`` on the whole batch); every rank's log is padded to
    the widest rank's, the unsharded width.  ``return_state`` also
    returns this rank's final ``SimState`` (its rows only).

    Every rank of the axis calls it.  A rank that fails makes every rank
    raise; all lanes dead on every rank raises ``NumericalHealthError``,
    as the unsharded run does."""
    dev = resolve_device(device)
    if not comm.is_sharded(seeds):
        seeds = torch.as_tensor(np.asarray(
            seeds.detach().cpu() if isinstance(seeds, torch.Tensor)
            else seeds))
    B, B_params, B_adj = _rows(seeds), _rows(params.kind), _rows(adj)
    if not (B == B_params == B_adj):
        raise ValueError(
            f"batch dims disagree: seeds={B}, params={B_params}, adj={B_adj}")
    ax_size = comm.axis_total(mesh, axis)
    if B % ax_size != 0:
        raise ValueError(f"batch {B} not divisible by mesh axis {axis}="
                         f"{ax_size}")
    params_l, adj_l, seeds_l = comm.block((params, adj, seeds), mesh,
                                          comm.P(axis))
    offset = comm.block_index(mesh, axis) * (B // ax_size)
    chunk, base = _faultinject.numeric_scope_ctx()
    log = state = err = None
    dead = False
    try:
        # A numeric fault addresses the same logical lane as unsharded.
        with _faultinject.numeric_scope(chunk=chunk, lane_base=base + offset):
            log, state = simulate_batch(
                cfg, params_l, adj_l, seeds_l.cpu().numpy(),
                max_chunks=max_chunks, return_state=True, engine="scan",
                device=dev)
    except NumericalHealthError as e:
        log, state = e.partial
        dead = True
    except Exception as e:  # every rank must learn of it: see _agree
        err = e
    width, failed, all_dead = _agree(
        mesh, axis, 0 if log is None else int(log.times.shape[1]),
        err is not None, dead, dev)
    if err is not None:
        raise err
    if failed:
        raise RuntimeError("simulate_sharded: another rank of the mesh "
                           "failed (its error is in its own output)")
    spec = comm.P(axis)
    health = comm.mark(log.health, mesh, spec)
    if all_dead:
        from .multihost import gather_global

        h = gather_global(health)
        raise NumericalHealthError(h, context=f"simulation of {h.size} "
                                              f"lane(s)")
    out = EventLog(
        comm.mark(_pad(log.times, width, float("inf")), mesh,
                  comm.P(axis, None)),
        comm.mark(_pad(log.srcs, width, -1), mesh, comm.P(axis, None)),
        comm.mark(log.n_events, mesh, spec), cfg, health=health,
        dispatches=log.dispatches, engine=log.engine,
        engine_reason=log.engine_reason)
    return (out, state) if return_state else out
