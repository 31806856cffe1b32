"""Piecewise-constant-rate broadcaster (the JAX package's
``models/piecewise.py``): exact inversion of the cumulative hazard at an
Exp(1) target from the source's (key, counter) stream."""

from __future__ import annotations

from ..ops.sampling import piecewise_next_time
from .base import (
    KIND_PIECEWISE,
    PolicyDef,
    SourceUpdate,
    at_source,
    register_policy,
)


def on_init(params, state, t0, keys, rows):
    return SourceUpdate(t_next=piecewise_next_time(
        keys, t0, params.pw_times, params.pw_rates))


def on_fire(params, state, fired, t, key, u, lanes):
    return SourceUpdate(t_next=piecewise_next_time(
        key, t, at_source(params.pw_times, fired),
        at_source(params.pw_rates, fired)))


PIECEWISE = register_policy(
    PolicyDef(kind=KIND_PIECEWISE, name="piecewise", on_init=on_init,
              on_fire=on_fire)
)
