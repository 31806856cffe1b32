"""Trace data of the port: the part of the JAX package's ``data`` layer
that BASELINE config 4 and corpus serving need."""

from .traces import (  # noqa: F401
    LoadStats,
    TraceOrderError,
    load_csv,
    pad_traces,
    save_csv,
    star_from_traces,
    synthetic_twitter,
)
