"""Trace data of the port: the part of the JAX package's ``data`` layer
that BASELINE config 4 needs."""

from .traces import pad_traces, star_from_traces, synthetic_twitter  # noqa: F401
