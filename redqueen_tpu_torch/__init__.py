"""redqueen_tpu_torch: the PyTorch/CUDA port of redqueen_tpu.

A batch of components, each a mix of Poisson, Opt (RedQueen), Hawkes,
RealData replay and piecewise-constant sources, runs on one of two
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
from .convert import (
    sim_config_from_fields,
    sim_state_from_numpy,
    sim_state_to_numpy,
    source_params_from_numpy,
    source_params_to_numpy,
)
from .device import resolve_device
from .parallel.lanes import shape_budget
from .runtime.numerics import NumericalHealthError
from .sim import EventLog, resume, select_engine, simulate, simulate_batch
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
]
