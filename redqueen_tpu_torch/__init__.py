"""redqueen_tpu_torch: the PyTorch/CUDA port of redqueen_tpu.

A batch of components, each a mix of Poisson, Opt (RedQueen), Hawkes,
RealData replay, piecewise-constant and RMTPP neural-policy sources
(``models/rmtpp.py``), runs on one of two
engines: the scan engine, PyTorch ops one event of every lane per step
(the default, as in the JAX package, and the one route of ``simulate``,
``resume``, ``max_events``, ``return_state`` and key-array seeds), or
the fused engine, a hand-written CUDA event kernel on an NVIDIA Hopper
card with a plain PyTorch version of its step for CPU tensors.  Entry
points run on the card unless the caller passes ``device="cpu"``.

    cfg, p, a = GraphBuilder(...).build(capacity=..., device="cuda")
    params, adj = stack_components([p] * B, [a] * B)
    log = simulate_batch(cfg, params, adj, seeds)           # scan engine
    log = simulate_batch(cfg, params, adj, seeds, engine="fused")  # kernel
    m = feed_metrics_batch(log.times, log.srcs, adj, 0, cfg.end_time)

The star engine (``parallel/bigf.py``: one broadcaster against a large
follower set, no event loop), the bucketed ragged dispatch
(``parallel/lanes.py``), the BASELINE presets (``presets.py``), sweeps
(``sweep.py``) and the offline baseline (``baselines.py``) sit on top;
``learn`` fits multivariate Hawkes models to event logs on the card
(the ``hawkes_pass`` kernel) and feeds them back into control.

This package imports torch and numpy only; the JAX package
``redqueen_tpu`` is its reference and is never imported here."""

__version__ = "0.1.0"

import os as _os

# Serving worker children (RQ_SERVING_WORKER=1, set by
# serving.worker.WorkerHandle.spawn) must spawn cheap and stay torch-free
# until their first open/recover request loads the shard.  Under the
# flag the eager torch-pulling re-exports below are skipped; the
# module-level __getattr__ (PEP 562) resolves every one of them lazily,
# so the public surface is identical either way — only the import COST
# moves.
_RQ_MINIMAL_IMPORT = bool(_os.environ.get("RQ_SERVING_WORKER"))

# name -> owning submodule (None: a subpackage): THE definition of the
# re-exported surface.  The eager loop below and the PEP 562 fallback
# both read it, so a new export is added exactly once and behaves the
# same on the normal and the minimal-import (worker-child) path.
_LAZY_ATTRS = {
    "ConfigValidationError": ".config", "GraphBuilder": ".config",
    "SimConfig": ".config", "SimState": ".config",
    "SourceParams": ".config", "stack_components": ".config",
    "budget_matched_poisson_rate": ".baselines",
    "offline_rates": ".baselines", "offline_schedule": ".baselines",
    "offline_visibility": ".baselines",
    "ctrl_params_from_numpy": ".convert",
    "feed_state_from_numpy": ".convert", "load_rmtpp_npz": ".convert",
    "rmtpp_weights_from_jax": ".convert",
    "rmtpp_weights_to_jax": ".convert",
    "sim_config_from_fields": ".convert",
    "sim_state_from_numpy": ".convert", "sim_state_to_numpy": ".convert",
    "source_params_from_numpy": ".convert",
    "source_params_to_numpy": ".convert",
    "star_config_from_fields": ".convert",
    "wall_params_from_numpy": ".convert",
    "resolve_device": ".device",
    "learn": None,  # the Hawkes fit: learn.fit_hawkes, ...
    "runtime": None, "utils": None,
    "CtrlParams": ".parallel.bigf", "StarBuilder": ".parallel.bigf",
    "StarConfig": ".parallel.bigf", "WallParams": ".parallel.bigf",
    "broadcast_star": ".parallel.bigf", "simulate_star": ".parallel.bigf",
    "simulate_star_batch": ".parallel.bigf", "stack_star": ".parallel.bigf",
    "plan_buckets": ".parallel.lanes", "shape_budget": ".parallel.lanes",
    "simulate_ragged": ".parallel.lanes",
    "PRESETS": ".presets", "build_preset": ".presets",
    "power_law_graph": ".presets", "run_preset": ".presets",
    "NumericalHealthError": ".runtime.numerics",
    "EventLog": ".sim", "resume": ".sim", "select_engine": ".sim",
    "simulate": ".sim", "simulate_batch": ".sim",
    "SweepResult": ".sweep", "run_sweep": ".sweep",
    "run_sweep_star": ".sweep", "run_sweep_checkpointed": ".sweep",
    "FeedMetrics": ".utils.metrics", "feed_metrics": ".utils.metrics",
    "feed_metrics_batch": ".utils.metrics", "num_posts": ".utils.metrics",
}


def __getattr__(name):
    if name in _LAZY_ATTRS:
        import importlib

        target = _LAZY_ATTRS[name]
        if target is None:  # a subpackage re-export
            return importlib.import_module("." + name, __name__)
        return getattr(importlib.import_module(target, __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if not _RQ_MINIMAL_IMPORT:
    for _n in _LAZY_ATTRS:
        globals()[_n] = __getattr__(_n)
    del _n

__all__ = [
    "__version__", "runtime", "utils", "ConfigValidationError", "GraphBuilder", "SimConfig", "SimState",
    "SourceParams", "stack_components", "sim_config_from_fields",
    "sim_state_from_numpy", "sim_state_to_numpy",
    "source_params_from_numpy", "source_params_to_numpy", "resolve_device",
    "shape_budget", "NumericalHealthError", "EventLog", "simulate",
    "simulate_batch", "resume", "select_engine", "FeedMetrics",
    "feed_metrics", "feed_metrics_batch", "num_posts",
    "star_config_from_fields", "wall_params_from_numpy",
    "ctrl_params_from_numpy", "feed_state_from_numpy",
    "StarConfig", "WallParams", "CtrlParams",
    "StarBuilder", "simulate_star", "simulate_star_batch", "stack_star",
    "broadcast_star", "plan_buckets", "simulate_ragged", "PRESETS",
    "build_preset", "run_preset", "power_law_graph", "SweepResult",
    "run_sweep", "run_sweep_star", "run_sweep_checkpointed", "offline_rates", "offline_visibility",
    "offline_schedule", "budget_matched_poisson_rate",
    "rmtpp_weights_from_jax", "rmtpp_weights_to_jax", "load_rmtpp_npz",
    "learn",
]
