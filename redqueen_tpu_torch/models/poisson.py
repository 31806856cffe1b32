"""Constant-rate Poisson broadcaster (the JAX package's
``models/poisson.py``): one Exp(rate) per own event, its first from the
source's init key and every later one from the step panel's fire word.
Other sources' posts never move its schedule."""

from __future__ import annotations

from ..ops.sampling import exponential_delta, exponential_from_uniform
from .base import (
    KIND_POISSON,
    PolicyDef,
    SourceUpdate,
    at_source,
    register_policy,
)


def on_init(params, state, t0, keys, rows):
    return SourceUpdate(t_next=t0 + exponential_delta(keys, params.rate))


def on_fire(params, state, fired, t, key, u, lanes):
    rate = at_source(params.rate, fired)
    return SourceUpdate(t_next=t + exponential_from_uniform(u, rate))


POISSON = register_policy(
    PolicyDef(kind=KIND_POISSON, name="poisson", on_init=on_init,
              on_fire=on_fire, fire_uses_key=False)
)
