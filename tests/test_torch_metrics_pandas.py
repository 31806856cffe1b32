"""The port's pandas export and evaluation layer (utils/dataframe.py,
utils/metrics_pandas.py) on the same logs as the JAX package's: the
DataFrames equal, ``time_in_top_k``/``average_rank``/``int_rank2_dt``/
``num_posts_of_src`` equal, and equal to the port's own tensor metrics
(``feed_metrics``) within the tolerance ``tests/test_metrics.py`` holds
the JAX pair to.

Tolerance: DataFrames and pandas values identical (the same float64
inputs); against ``feed_metrics``, as ``tests/test_metrics.py``: abs 1e-3
for time-in-top-k and 1e-4 for the average rank."""

import numpy as np
import pandas as pd
import pytest
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu.utils import dataframe as jdf
from redqueen_tpu.utils import metrics_pandas as jmp
from redqueen_tpu_torch.utils import dataframe as tdf
from redqueen_tpu_torch.utils import metrics_pandas as tmp
import torch_parity as tp
from torch_parity import partitionable  # noqa: F401  (autouse fixture)

T = 20.0


@pytest.fixture(scope="module")
def logs():
    """A batch of the golden shape and of every kind, from the port's
    default engine (the scan engine) on the CPU."""
    out = {}
    for name, fill, F in [("golden", tp.golden, 4),
                          ("every_kind", tp.every_kind, 5)]:
        cfg, params, adj = tp.build(rt, fill, F, T, 64, 4, device="cpu")
        log = rt.simulate_batch(cfg, params, adj, np.arange(4) + 5,
                                device="cpu")
        out[name] = (log, adj)
    return out


@pytest.mark.parametrize("name", ["golden", "every_kind"])
@pytest.mark.parametrize("lane", [0, 3])
def test_dataframe_equals_the_jax_export(logs, name, lane):
    log, adj = logs[name]
    got = tdf.events_to_dataframe(log.times[lane], log.srcs[lane], adj[lane],
                                  start_time=0.5)
    want = jdf.events_to_dataframe(log.times[lane].numpy(),
                                   log.srcs[lane].numpy(),
                                   adj[lane].numpy(), start_time=0.5)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > int(log.n_events[lane])   # some posts reach 2+ feeds


@pytest.mark.parametrize("name,src", [("golden", 0), ("every_kind", 0),
                                      ("every_kind", 6)])
@pytest.mark.parametrize("K,start", [(1, 0.0), (2, 3.5)])
def test_pandas_metrics_equal_jax_and_feed_metrics(logs, name, src, K,
                                                   start):
    log, adj = logs[name]
    for lane in range(4):
        df = tdf.events_to_dataframe(log.times[lane], log.srcs[lane],
                                     adj[lane])
        sinks = np.flatnonzero(adj[lane, src].numpy())
        top = tmp.time_in_top_k(df, K, T, src, start_time=start,
                                sink_ids=sinks)
        avg = tmp.average_rank(df, T, src, start_time=start, sink_ids=sinks)
        r2 = tmp.int_rank2_dt(df, T, src, start_time=start, sink_ids=sinks)
        assert top == jmp.time_in_top_k(df, K, T, src, start_time=start,
                                        sink_ids=sinks)
        assert avg == jmp.average_rank(df, T, src, start_time=start,
                                       sink_ids=sinks)
        assert r2 == jmp.int_rank2_dt(df, T, src, start_time=start,
                                      sink_ids=sinks)
        assert tmp.num_posts_of_src(df, src) == int(
            (log.srcs[lane] == src).sum()) == jmp.num_posts_of_src(df, src)
        m = rt.feed_metrics(log.times[lane], log.srcs[lane], adj[lane], src,
                            T, K=K, start_time=start)
        assert abs(float(m.mean_time_in_top_k()) - top) < 1e-3
        assert abs(float(m.mean_average_rank()) - avg) < 1e-4


def test_rank_of_src_and_is_sorted_match(logs):
    log, adj = logs["every_kind"]
    df = tdf.events_to_dataframe(log.times[1], log.srcs[1], adj[1])
    got, want = tmp.rank_of_src_in_df(df, 0), jmp.rank_of_src_in_df(df, 0)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
        assert tmp.is_sorted(got[k][0])


def test_export_takes_tensors_and_arrays_alike(logs):
    log, adj = logs["golden"]
    a = tdf.events_to_dataframe(log.times[2], log.srcs[2], adj[2])
    b = tdf.events_to_dataframe(log.times[2].numpy(), log.srcs[2].numpy(),
                                adj[2].numpy())
    pd.testing.assert_frame_equal(a, b)
    assert isinstance(log.times, torch.Tensor)
