"""Trace-replay broadcaster (the JAX package's ``models/realdata.py``):
timestamps in a +inf-padded ``[S, Kr]`` tensor, a cursor per source that
moves on the source's own events only."""

from __future__ import annotations

import torch

from .base import (
    KIND_REALDATA,
    PolicyDef,
    SourceUpdate,
    at_source,
    register_policy,
)


def _peek(rd_times, ptr):
    """The replay time at each cursor (``rd_times [..., Kr]``, ``ptr
    [...]``), +inf past the end."""
    kr = rd_times.shape[-1]
    idx = torch.clamp(ptr, max=kr - 1).to(torch.int64)[..., None]
    t = torch.gather(rd_times, -1, idx)[..., 0]
    return torch.where(ptr < kr, t, torch.full_like(t, float("inf")))


def on_init(params, state, t0, keys, rows):
    # First replay timestamp at or after the start (searchsorted 'left'
    # on the sorted, +inf-padded row, as a count).
    ptr = (params.rd_times < t0).sum(-1).to(torch.int32)
    return SourceUpdate(t_next=_peek(params.rd_times, ptr), rd_ptr=ptr)


def on_fire(params, state, fired, t, key, u, lanes):
    ptr = at_source(state.rd_ptr, fired) + 1
    return SourceUpdate(t_next=_peek(at_source(params.rd_times, fired), ptr),
                        rd_ptr=ptr)


REALDATA = register_policy(
    PolicyDef(kind=KIND_REALDATA, name="realdata", on_init=on_init,
              on_fire=on_fire, fire_uses_key=False)
)
