"""Carry parameters and carries across from the JAX package.

A JAX ``SourceParams``, ``SimState``, ``WallParams`` or ``CtrlParams``
read out as numpy arrays (one per field) and a JAX ``SimConfig`` or
``StarConfig`` read out as its plain fields become the port's objects,
so both packages can run the very same component, and the port can
resume a run the JAX package began (the RMTPP state ``h`` included).
RMTPP weights cross as the flax tree of numpy arrays
(``jax.tree.map(np.asarray, w)``): the port keeps the flax names and
layout, so the map is leaf by leaf.  Nothing here imports the JAX
package: the caller reads the arrays out, for example ``{f:
np.asarray(getattr(p, f)) for f in PARAM_FIELDS}`` and
``dataclasses.asdict(cfg)``."""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import PARAM_FIELDS, STATE_FIELDS, SimConfig, SimState, \
    SourceParams
from .device import DeviceLike, resolve_device
from .models.base import map_weights

__all__ = ["source_params_from_numpy", "source_params_to_numpy",
           "sim_config_from_fields", "sim_state_from_numpy",
           "sim_state_to_numpy", "star_config_from_fields",
           "wall_params_from_numpy", "ctrl_params_from_numpy",
           "rmtpp_weights_from_jax", "rmtpp_weights_to_jax",
           "load_rmtpp_npz", "save_rmtpp_npz", "RMTPP_CHECKPOINT0"]

#: The JAX package's committed RMTPP checkpoint
#: (``experiments/checkpoints/rmtpp/0``, hidden 16) exported to npz: the
#: weights under ``weights/<path>`` and the fit's record under
#: ``info/<path>``, paths joined by ``/``.
RMTPP_CHECKPOINT0 = os.path.join(os.path.dirname(__file__), "data",
                                 "rmtpp_checkpoint0.npz")


def rmtpp_weights_from_jax(tree, device: DeviceLike = "cuda"):
    """RMTPP weights for the port (float32 tensors on ``device``) from the
    JAX package's flax tree read out as numpy arrays (nested dicts, the
    same names and ``[in, out]`` layout)."""
    dev = resolve_device(device)
    return map_weights(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree)


def rmtpp_weights_to_jax(weights):
    """The port's RMTPP weights as the flax tree of float32 numpy arrays
    (the inverse of :func:`rmtpp_weights_from_jax`)."""
    return map_weights(
        lambda t: t.detach().cpu().numpy().astype(np.float32), weights)


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def save_rmtpp_npz(path: str, weights, info=None) -> None:
    """Write a weight tree of numpy arrays (and an optional ``info``
    tree) as the npz :func:`load_rmtpp_npz` reads."""
    arrays = _flatten(weights, "weights")
    if info is not None:
        arrays.update(_flatten(info, "info"))
    np.savez(path, **arrays)


def load_rmtpp_npz(path: Optional[str] = None,
                   device: DeviceLike = "cuda"):
    """``(weights, info)`` from an RMTPP npz (by default the exported
    checkpoint :data:`RMTPP_CHECKPOINT0`): the weights as float32 tensors
    on ``device``, ``info`` as a nested dict of numpy values."""
    trees = {"weights": {}, "info": {}}
    with np.load(RMTPP_CHECKPOINT0 if path is None else path) as z:
        for name in z.files:
            parts = name.split("/")
            node = trees.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[name]
    return rmtpp_weights_from_jax(trees["weights"], device), trees["info"]


def source_params_from_numpy(fields: Mapping[str, np.ndarray],
                             device: DeviceLike = "cuda") -> SourceParams:
    """``SourceParams`` on ``device`` from one numpy array per field
    (``kind`` becomes int32, every other field float32).  Missing or
    unknown fields raise ``KeyError``."""
    dev = resolve_device(device)
    missing = [f for f in PARAM_FIELDS if f not in fields]
    extra = [f for f in fields if f not in PARAM_FIELDS and f != "rmtpp"]
    if missing or extra:
        raise KeyError(
            f"SourceParams fields: missing {missing}, unknown {extra}")
    out = {}
    for f in PARAM_FIELDS:
        a = np.asarray(fields[f])
        dt = torch.int32 if f == "kind" else torch.float32
        out[f] = torch.from_numpy(np.array(a)).to(dev, dt)
    rmtpp = fields.get("rmtpp")
    return SourceParams(**out, rmtpp=None if rmtpp is None
                        else rmtpp_weights_from_jax(rmtpp, dev))


def source_params_to_numpy(params: SourceParams) -> Dict[str, np.ndarray]:
    """One numpy array per ``SourceParams`` field, and the RMTPP weights
    as a numpy tree under ``rmtpp`` when attached (the inverse of
    :func:`source_params_from_numpy`)."""
    out = {f: getattr(params, f).detach().cpu().numpy()
           for f in PARAM_FIELDS}
    if params.rmtpp is not None:
        out["rmtpp"] = rmtpp_weights_to_jax(params.rmtpp)
    return out


def sim_config_from_fields(fields: Mapping[str, Any]) -> SimConfig:
    """``SimConfig`` from the JAX ``SimConfig``'s plain fields (e.g.
    ``dataclasses.asdict``); unknown fields raise ``TypeError``."""
    kw = dict(fields)
    for f in ("present_kinds", "opt_rows"):
        if f in kw:
            kw[f] = tuple(int(x) for x in kw[f])
    for f in ("n_sources", "n_sinks", "capacity", "rmtpp_hidden"):
        if f in kw:
            kw[f] = int(kw[f])
    for f in ("end_time", "start_time"):
        if f in kw:
            kw[f] = float(kw[f])
    return SimConfig(**kw)


# SimState field -> (port dtype, JAX dtype); uint32 words ride on int64.
_STATE_DTYPES = {
    "t": (torch.float32, np.float32), "t_next": (torch.float32, np.float32),
    "exc": (torch.float32, np.float32), "exc_t": (torch.float32, np.float32),
    "rd_ptr": (torch.int32, np.int32), "h": (torch.float32, np.float32),
    "key": (torch.int64, np.uint32), "keys": (torch.int64, np.uint32),
    "ctr": (torch.int64, np.uint32), "n_events": (torch.int32, np.int32),
    "budget": (torch.int32, np.int32), "health": (torch.int64, np.uint32),
}


def sim_state_from_numpy(fields: Mapping[str, np.ndarray],
                         device: DeviceLike = "cuda") -> SimState:
    """``SimState`` on ``device`` from one numpy array per field of a JAX
    ``SimState`` (``budget``/``health`` may be None or missing).  A single
    component's state (``t_next`` [S]) gains a lane axis of 1."""
    dev = resolve_device(device)
    unknown = [f for f in fields if f not in STATE_FIELDS]
    missing = [f for f in STATE_FIELDS[:10] if f not in fields]
    if missing or unknown:
        raise KeyError(f"SimState fields: missing {missing}, unknown "
                       f"{unknown}")
    single = np.ndim(fields["t_next"]) == 1
    out = {}
    for f in STATE_FIELDS:
        a = fields.get(f)
        if a is None:
            out[f] = None
            continue
        a = np.asarray(a)
        if single:
            a = a[None]
        dt, _ = _STATE_DTYPES[f]
        out[f] = torch.from_numpy(a.astype(np.int64) if dt == torch.int64
                                  else np.array(a)).to(dev, dt)
    return SimState(**out)


def sim_state_to_numpy(state: SimState) -> Dict[str, Optional[np.ndarray]]:
    """One numpy array per ``SimState`` field in the JAX package's dtypes
    (uint32 keys, counters and health words), None where the state has
    none (the inverse of :func:`sim_state_from_numpy`)."""
    out = {}
    for f in STATE_FIELDS:
        v = getattr(state, f)
        out[f] = None if v is None else \
            v.detach().cpu().numpy().astype(_STATE_DTYPES[f][1])
    return out


def star_config_from_fields(fields: Mapping[str, Any]):
    """``StarConfig`` from the JAX ``StarConfig``'s plain fields (e.g.
    ``dataclasses.asdict``); unknown fields raise ``TypeError``."""
    from .parallel.star_types import StarConfig

    kw = dict(fields)
    if "wall_kinds" in kw:
        kw["wall_kinds"] = tuple(int(x) for x in kw["wall_kinds"])
    for f in ("n_feeds", "walls_per_feed", "wall_cap", "post_cap",
              "ctrl_kind", "rmtpp_hidden"):
        if f in kw:
            kw[f] = int(kw[f])
    for f in ("end_time", "start_time"):
        if f in kw:
            kw[f] = float(kw[f])
    return StarConfig(**kw)


def wall_params_from_numpy(fields: Mapping[str, np.ndarray],
                           device: DeviceLike = "cuda"):
    """``WallParams`` on ``device`` from one numpy array per field of a
    JAX ``WallParams`` (``kind`` int32, the rest float32)."""
    from .parallel.star_types import WALL_FIELDS, WallParams

    dev = resolve_device(device)
    missing = [f for f in WALL_FIELDS if f not in fields]
    extra = [f for f in fields if f not in WALL_FIELDS]
    if missing or extra:
        raise KeyError(f"WallParams fields: missing {missing}, unknown "
                       f"{extra}")
    return WallParams(**{
        f: torch.from_numpy(np.array(fields[f])).to(
            dev, torch.int32 if f == "kind" else torch.float32)
        for f in WALL_FIELDS})


def ctrl_params_from_numpy(fields: Mapping[str, Optional[np.ndarray]],
                           device: DeviceLike = "cuda"):
    """``CtrlParams`` on ``device`` from one numpy array (or None) per
    field of a JAX ``CtrlParams``, the RMTPP weights as a numpy tree."""
    from .parallel.star_types import CTRL_FIELDS, CtrlParams

    dev = resolve_device(device)
    known = CTRL_FIELDS + ("l0", "alpha", "beta", "rmtpp")
    missing = [f for f in CTRL_FIELDS if f not in fields]
    extra = [f for f in fields if f not in known]
    if missing or extra:
        raise KeyError(f"CtrlParams fields: missing {missing}, unknown "
                       f"{extra}")
    rmtpp = fields.get("rmtpp")
    return CtrlParams(
        rmtpp=None if rmtpp is None else rmtpp_weights_from_jax(rmtpp, dev),
        **{f: None if fields.get(f) is None else
           torch.from_numpy(np.array(fields[f])).to(dev, torch.float32)
           for f in known if f != "rmtpp"})
