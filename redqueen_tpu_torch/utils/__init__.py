"""Evaluation and persistence utilities of the port.

- ``metrics``: on-device feed-rank metrics over event logs;
- ``metrics_pandas``: the pandas twin on the reference-schema DataFrame;
- ``dataframe``: event log -> reference-schema DataFrame;
- ``checkpoint``: enveloped NPZ checkpoints of weights and carries;
- ``backend``: the card's liveness probe;
- ``roofline``: the card's peak rates and the bounds built on them.

Every submodule loads on first use (PEP 562).  Stated difference from the
JAX package, whose ``utils/__init__`` imports ``dataframe`` and
``metrics_pandas`` eagerly (and so pandas): here they are lazy, so that
importing the port loads no pandas."""

__all__ = ["dataframe", "metrics", "metrics_pandas", "checkpoint",
           "backend", "roofline"]


def __getattr__(name):
    if name in __all__:
        # importlib, not ``from . import``: a from-import would re-enter
        # this hook before the submodule binds.
        import importlib

        module = importlib.import_module("." + name, __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
