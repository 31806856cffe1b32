"""Policy registry of the port: the counterpart of
``redqueen_tpu.models.base``, with the same dense kind codes so that
parameters carry across unchanged.

A policy is a kind code plus pure functions over the engine state.  The
scan engine (``ops.scan_core``) computes the fired source's resample with
the ``on_fire`` of every kind the config compiles and keeps, per lane,
the one of the fired source's kind (what ``lax.switch`` under ``vmap``
does in the JAX engine), and applies every ``on_react`` hook to the
sources that did not fire.  Adding a policy is registering one
``PolicyDef``.

The hooks work on whole batches, lanes first:

- ``on_init(params, state, t0, keys, rows) -> SourceUpdate`` over
  ``[B, S]``: first draws at the start ``t0`` from the init keys ``keys
  [B, S, 2]``; ``rows`` (bool ``[B, S]``) marks the sources of this kind,
  the only entries that are kept.
- ``on_fire(params, state, fired, t, key, u, lanes) -> SourceUpdate`` over
  ``[B]``: the fired source ``fired [B]`` posted at ``t [B]``; ``key [B,
  2]`` is its (key, counter) stream's next key (None when no compiled
  kind reads it), ``u [B]`` the step panel's fire word, ``lanes`` (bool
  ``[B]``) the valid lanes whose fired source is of this kind.
- ``on_react(cfg, params, state, consts, fired, t, valid, us) ->
  (t_next [B, S], bump bool [B, S])``, optional: re-decide the sources
  that did not fire (the RedQueen superposition trick); ``us [B, S]`` is
  the panel's react words and ``consts`` what ``react_consts(cfg, params,
  adj)`` computed once for the run.

A ``SourceUpdate`` field left None echoes the state's value."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

__all__ = [
    "KIND_POISSON", "KIND_HAWKES", "KIND_PIECEWISE", "KIND_REALDATA",
    "KIND_OPT", "KIND_RMTPP", "KIND_NAMES", "N_KINDS",
    "SourceUpdate", "PolicyDef", "register_policy", "get_registry",
    "n_kinds", "at_source", "map_weights",
]

KIND_POISSON = 0
KIND_HAWKES = 1
KIND_PIECEWISE = 2
KIND_REALDATA = 3
KIND_OPT = 4
KIND_RMTPP = 5

#: Policy names by kind code (the JAX registry's ``PolicyDef.name``).
KIND_NAMES = {
    KIND_POISSON: "poisson",
    KIND_HAWKES: "hawkes",
    KIND_PIECEWISE: "piecewise",
    KIND_REALDATA: "realdata",
    KIND_OPT: "opt",
    KIND_RMTPP: "rmtpp",
}

N_KINDS = len(KIND_NAMES)


def at_source(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each lane's row ``s [B]`` of a per-source tensor ``x [B, S, ...]``
    -> ``[B, ...]``."""
    idx = s.reshape((-1, 1) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((x.shape[0], 1) + x.shape[2:]))[:, 0]


def map_weights(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the RMTPP
    weight trees): ``fn(leaf, ...)`` per leaf position; None maps to
    None."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: map_weights(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class SourceUpdate(NamedTuple):
    """Per-source state written back after ``on_init``/``on_fire``; a
    field left None echoes the state's value."""

    t_next: torch.Tensor                   # next event time (+inf = never)
    exc: Optional[torch.Tensor] = None     # Hawkes excitation at exc_t
    exc_t: Optional[torch.Tensor] = None   # time the excitation was folded to
    rd_ptr: Optional[torch.Tensor] = None  # RealData replay cursor
    h: Optional[torch.Tensor] = None       # RMTPP recurrent state
    # False flags a sampler failure (runtime.numerics.BIT_SAMPLER_FAILURE);
    # None for samplers that cannot fail.
    ok: Optional[torch.Tensor] = None


class PolicyDef(NamedTuple):
    kind: int
    name: str
    on_init: Callable
    on_fire: Callable
    on_react: Optional[Callable] = None
    # Once-per-run constants of on_react (None: it takes none).
    react_consts: Optional[Callable] = None
    # False when on_fire ignores ``key``: a config whose kinds all say so
    # keeps no (key, counter) stream position.
    fire_uses_key: bool = True


_REGISTRY: Dict[int, PolicyDef] = {}


def register_policy(pdef: PolicyDef) -> PolicyDef:
    if pdef.kind in _REGISTRY and _REGISTRY[pdef.kind].name != pdef.name:
        raise ValueError(
            f"kind {pdef.kind} already registered as "
            f"{_REGISTRY[pdef.kind].name!r}, refusing {pdef.name!r}"
        )
    _REGISTRY[pdef.kind] = pdef
    return pdef


def get_registry() -> Dict[int, PolicyDef]:
    """Kind -> PolicyDef. The codes must be dense from 0."""
    kinds = sorted(_REGISTRY)
    if kinds != list(range(len(kinds))):
        raise RuntimeError(
            f"policy kind codes must be dense from 0, got {kinds}")
    return dict(_REGISTRY)


def n_kinds() -> int:
    return len(_REGISTRY)
