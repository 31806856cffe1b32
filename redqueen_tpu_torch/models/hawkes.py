"""Self-exciting Hawkes broadcaster (the JAX package's
``models/hawkes.py``): intensity l0 + alpha * sum_j exp(-beta (t - t_j))
over its own past events, tracked as one (excitation, fold time) pair,
and the next event by Ogata thinning (``ops.sampling.hawkes_next_time``)
on the source's (key, counter) stream, with sampler failures reported
through ``SourceUpdate.ok``."""

from __future__ import annotations

import torch

from ..ops.sampling import hawkes_next_time
from ..runtime.numerics import safe_exp
from .base import (
    KIND_HAWKES,
    PolicyDef,
    SourceUpdate,
    at_source,
    register_policy,
)


def on_init(params, state, t0, keys, rows):
    zero = torch.zeros_like(params.l0)
    t0 = t0.expand_as(params.l0)
    t_next, ok = hawkes_next_time(
        keys, t0, params.l0, params.alpha, params.beta, zero, t0,
        float("inf"), return_ok=True, active=rows)
    return SourceUpdate(t_next=t_next, exc=zero, exc_t=t0, ok=ok)


def on_fire(params, state, fired, t, key, u, lanes):
    # Fold the decayed excitation to the fire time and add this jump.
    alpha = at_source(params.alpha, fired)
    beta = at_source(params.beta, fired)
    decay = safe_exp(-beta * (t - at_source(state.exc_t, fired)))
    exc = at_source(state.exc, fired) * decay + alpha
    t_next, ok = hawkes_next_time(
        key, t, at_source(params.l0, fired), alpha, beta, exc, t,
        float("inf"), return_ok=True, active=lanes)
    return SourceUpdate(t_next=t_next, exc=exc, exc_t=t, ok=ok)


HAWKES = register_policy(
    PolicyDef(kind=KIND_HAWKES, name="hawkes", on_init=on_init,
              on_fire=on_fire)
)
