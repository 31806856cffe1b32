"""Trace data of the port: loading (CSV through the Python or the native
engine, npz), normalisation, padding and bucketing, synthetic corpora and
the star components built from them."""

from .traces import (  # noqa: F401
    LoadStats,
    TraceOrderError,
    bucket_traces,
    load_csv,
    load_npz,
    normalize_traces,
    pad_traces,
    replay_buckets,
    save_csv,
    save_npz,
    star_from_traces,
    synthetic_twitter,
)
