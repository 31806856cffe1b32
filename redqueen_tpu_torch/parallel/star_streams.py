"""Wall-source and controlled-broadcaster streams of the star engine
(step 1 of the design in ``bigf.py``): the counterpart of
``redqueen_tpu.parallel.star_streams``.

The JAX engine runs a ``lax.switch`` over the slot's kind for every
``[F, M]`` wall slot under ``vmap``.  Here the slots are grouped by kind:
each kind's sampler runs once on all of its slots, batched, and the
streams are scattered back into slot order.  A slot's key depends only
on its global index, so the grouping changes no stream."""

from __future__ import annotations

import torch

from ..models.base import (
    KIND_HAWKES,
    KIND_PIECEWISE,
    KIND_POISSON,
    KIND_REALDATA,
    KIND_RMTPP,
)
from ..ops import streams
from ..runtime import telemetry as _telemetry
from .star_types import _EMPTY, StarConfig, WallParams

__all__ = ["_wall_branches", "_wall_streams", "_ctrl_stream",
           "_check_wall_kinds"]

_SLOT_FIELDS = ("rate", "l0", "alpha", "beta", "pw_times", "pw_rates",
                "rd_times")


def _replay(row: torch.Tensor, t0, T, cap: int) -> streams.Stream:
    """Replay rows ``[n, Kr]`` fitted to the ``[n, cap]`` stream buffer:
    padded with +inf when shorter; when longer, the first ``cap``
    in-window events are kept and truncation is flagged if any were
    dropped."""
    Kr = row.shape[-1]
    if Kr < cap:
        row = torch.cat([row, torch.full(row.shape[:-1] + (cap - Kr,),
                                         float("inf"), dtype=row.dtype,
                                         device=row.device)], -1)
    s = streams.realdata_stream(row, t0, T)
    if Kr <= cap:
        return s
    return streams.Stream(s.times[..., :cap], torch.clamp(s.n, max=cap),
                          s.n > cap)


def _wall_branches(cfg: StarConfig):
    """(codes, branch fns) of the wall-slot kinds the config holds
    (``cfg.wall_kinds``; empty = every supported kind).  A branch takes
    the slot rows of its kind (``dict`` of ``[n, ...]`` tensors) and their
    keys ``[n, 2]`` and returns their streams."""
    t0, T, cap = cfg.start_time, cfg.end_time, cfg.wall_cap

    def b_empty(p, keys):
        n = keys.shape[0]
        return streams.Stream(
            torch.full((n, cap), float("inf"), device=keys.device),
            torch.zeros(n, dtype=torch.int32, device=keys.device),
            torch.zeros(n, dtype=torch.bool, device=keys.device))

    def b_poisson(p, keys):
        return streams.poisson_stream(keys, p["rate"], t0, T, cap)

    def b_hawkes(p, keys):
        with _telemetry.span("star.streams.hawkes",
                             sources=int(keys.shape[0])):
            return streams.hawkes_stream(keys, p["l0"], p["alpha"],
                                         p["beta"], t0, T, cap)

    def b_piecewise(p, keys):
        return streams.piecewise_stream(keys, p["pw_times"], p["pw_rates"],
                                        t0, T, cap)

    def b_realdata(p, keys):
        return _replay(p["rd_times"], t0, T, cap)

    table = {
        _EMPTY: b_empty,
        KIND_POISSON: b_poisson,
        KIND_HAWKES: b_hawkes,
        KIND_PIECEWISE: b_piecewise,
        KIND_REALDATA: b_realdata,
    }
    codes = sorted(cfg.wall_kinds) if cfg.wall_kinds else sorted(table)
    for c in codes:
        if c not in table:
            raise ValueError(f"unsupported wall-source kind {c}")
    return codes, [table[c] for c in codes]


def _wall_streams(cfg: StarConfig, wall: WallParams,
                  keys: torch.Tensor) -> streams.Stream:
    """Every wall slot's stream: ``wall`` leaves ``[B, F, M, ...]``, slot
    keys ``[B, F, M, 2]`` -> a ``Stream`` of ``[B, F, M, cap]`` times."""
    lead = tuple(wall.kind.shape)
    N = wall.kind.numel()
    cap = cfg.wall_cap
    dev = keys.device
    codes, branches = _wall_branches(cfg)
    kinds = wall.kind.reshape(N)
    keys = keys.reshape(N, 2)
    present = [int(k) for k in torch.unique(kinds).cpu()]
    rows = {f: getattr(wall, f).reshape((N,) + getattr(wall, f).shape[
        len(lead):]) for f in _SLOT_FIELDS}
    if len(present) == 1:
        s = branches[codes.index(present[0])](rows, keys)
        times, n, trunc = s.times, s.n, s.truncated
    else:
        times = torch.full((N, cap), float("inf"), device=dev)
        n = torch.zeros(N, dtype=torch.int32, device=dev)
        trunc = torch.zeros(N, dtype=torch.bool, device=dev)
        for code in present:
            idx = torch.nonzero(kinds == code)[:, 0]
            s = branches[codes.index(code)](
                {f: v[idx] for f, v in rows.items()}, keys[idx])
            times[idx] = s.times
            n[idx] = s.n
            trunc[idx] = s.truncated
    return streams.Stream(times.reshape(lead + (cap,)), n.reshape(lead),
                          trunc.reshape(lead))


def _ctrl_stream(cfg: StarConfig, ctrl, key):
    """Posting stream of a non-Opt controlled broadcaster, per lane
    (``ctrl`` leaves and ``key`` with a leading ``[B]``)."""
    t0, T, K = cfg.start_time, cfg.end_time, cfg.post_cap
    k = cfg.ctrl_kind
    if k == KIND_POISSON:
        return streams.poisson_stream(key, ctrl.rate, t0, T, K)
    if k == KIND_PIECEWISE:
        return streams.piecewise_stream(key, ctrl.pw_times, ctrl.pw_rates,
                                        t0, T, K)
    if k == KIND_HAWKES:
        # Hawkes depends only on its own history, so it is a legal
        # controlled stream.
        if ctrl.l0 is None:
            raise ValueError(
                "ctrl_kind=HAWKES requires CtrlParams.l0/alpha/beta — build "
                "via StarBuilder.ctrl_hawkes")
        return streams.hawkes_stream(key, ctrl.l0, ctrl.alpha, ctrl.beta,
                                     t0, T, K)
    if k == KIND_REALDATA:
        return _replay(ctrl.rd_times, t0, T, K)
    if k == KIND_RMTPP:
        # RMTPP depends only on its own history too.
        if ctrl.rmtpp is None:
            raise ValueError(
                "ctrl_kind=RMTPP requires CtrlParams.rmtpp weights")
        return streams.rmtpp_stream(ctrl.rmtpp, key, t0, T, K,
                                    cfg.rmtpp_hidden)
    raise ValueError(f"unsupported ctrl_kind {k}")


def _check_wall_kinds(cfg: StarConfig, wall: WallParams):
    """Reject wall slots whose kind the config has no branch for."""
    codes, _ = _wall_branches(cfg)
    got = set(int(k) for k in torch.unique(wall.kind.cpu()))
    if not got.issubset(codes):
        raise ValueError(
            f"wall slots contain kinds {sorted(got - set(codes))} not in the "
            f"config's wall_kinds {codes} — build wall params and config "
            f"from the same StarBuilder")
