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

from .config import (
    ConfigValidationError,
    GraphBuilder,
    SimConfig,
    SimState,
    SourceParams,
    stack_components,
)
from .baselines import (
    budget_matched_poisson_rate,
    offline_rates,
    offline_schedule,
    offline_visibility,
)
from .convert import (
    ctrl_params_from_numpy,
    load_rmtpp_npz,
    rmtpp_weights_from_jax,
    rmtpp_weights_to_jax,
    sim_config_from_fields,
    sim_state_from_numpy,
    sim_state_to_numpy,
    source_params_from_numpy,
    source_params_to_numpy,
    star_config_from_fields,
    wall_params_from_numpy,
)
from .device import resolve_device
from . import learn  # noqa: E402  (the Hawkes fit: learn.fit_hawkes, ...)
from .parallel.bigf import (
    CtrlParams,
    StarBuilder,
    StarConfig,
    WallParams,
    broadcast_star,
    simulate_star,
    simulate_star_batch,
    stack_star,
)
from .parallel.lanes import plan_buckets, shape_budget, simulate_ragged
from .presets import PRESETS, build_preset, power_law_graph, run_preset
from .runtime.numerics import NumericalHealthError
from .sim import EventLog, resume, select_engine, simulate, simulate_batch
from .sweep import SweepResult, run_sweep, run_sweep_star
from .utils.metrics import (
    FeedMetrics,
    feed_metrics,
    feed_metrics_batch,
    num_posts,
)

__all__ = [
    "ConfigValidationError", "GraphBuilder", "SimConfig", "SimState",
    "SourceParams", "stack_components", "sim_config_from_fields",
    "sim_state_from_numpy", "sim_state_to_numpy",
    "source_params_from_numpy", "source_params_to_numpy", "resolve_device",
    "shape_budget", "NumericalHealthError", "EventLog", "simulate",
    "simulate_batch", "resume", "select_engine", "FeedMetrics",
    "feed_metrics", "feed_metrics_batch", "num_posts",
    "star_config_from_fields", "wall_params_from_numpy",
    "ctrl_params_from_numpy", "StarConfig", "WallParams", "CtrlParams",
    "StarBuilder", "simulate_star", "simulate_star_batch", "stack_star",
    "broadcast_star", "plan_buckets", "simulate_ragged", "PRESETS",
    "build_preset", "run_preset", "power_law_graph", "SweepResult",
    "run_sweep", "run_sweep_star", "offline_rates", "offline_visibility",
    "offline_schedule", "budget_matched_poisson_rate",
    "rmtpp_weights_from_jax", "rmtpp_weights_to_jax", "load_rmtpp_npz",
    "learn",
]
