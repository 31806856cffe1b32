"""The rest of the port's ``data/traces.py`` against the JAX package's:
``save_npz``/``load_npz`` (round trips across the packages both ways),
``normalize_traces``, ``bucket_traces`` and ``replay_buckets`` (the
buckets' users, padding and lengths, and each star component's replay
times), and ``data/__init__``'s re-exports.  Exact: equal arrays (the
same float64 arithmetic in numpy; the star components' times are the
float32 of the same values)."""

import numpy as np
import pytest

from redqueen_tpu import data as jdata
from redqueen_tpu.data import traces as jtraces
from redqueen_tpu_torch import data as tdata
from redqueen_tpu_torch.data import traces


def corpus(seed=0, n=40, T=50.0, max_len=None):
    tr = traces.synthetic_twitter(seed, n, T, max_len=max_len)
    return tr + [np.empty(0)]  # an empty trace joins the first bucket


def same_traces(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)


def test_data_reexports_the_references_names():
    for name in ("bucket_traces", "load_csv", "normalize_traces",
                 "pad_traces", "save_npz", "load_npz", "replay_buckets",
                 "star_from_traces", "synthetic_twitter"):
        assert hasattr(jdata, name) and hasattr(tdata, name), name


@pytest.mark.parametrize("writer,reader", [
    (traces.save_npz, jtraces.load_npz), (jtraces.save_npz, traces.load_npz),
    (traces.save_npz, traces.load_npz)], ids=["port>ref", "ref>port",
                                              "port>port"])
def test_npz_round_trips_across_the_packages(tmp_path, writer, reader):
    tr = corpus()
    p = str(tmp_path / "t.npz")
    writer(p, tr)
    same_traces(reader(p), tr)


@pytest.mark.parametrize("kw", [{}, dict(t_min=5.0, t_max=30.0),
                                dict(t_min=1.5e9)])
def test_normalize_traces_matches(kw):
    tr = [t + 1.5e9 for t in corpus(1)] if "t_min" in kw and kw[
        "t_min"] > 1e6 else corpus(1)
    kw = dict(kw)
    same_traces(traces.normalize_traces(tr, 100.0, **kw),
                jtraces.normalize_traces(tr, 100.0, **kw))
    assert traces.normalize_traces([], 10.0) == []


@pytest.mark.parametrize("edges", [(16, 64, 256, 1024), (2, 4), (8,)])
def test_bucket_traces_matches(edges):
    tr = corpus(2, n=60, T=40.0)
    got = traces.bucket_traces(tr, edges=edges)
    want = jtraces.bucket_traces(tr, edges=edges)
    assert len(got) == len(want) > 0
    for (gi, gp, gl), (wi, wp, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)


def test_replay_buckets_matches():
    tr = corpus(3, n=30, T=30.0)
    ctrl = np.sort(np.random.RandomState(4).uniform(0, 30.0, 12))
    s_sink = np.linspace(0.5, 2.0, len(tr))
    got = traces.replay_buckets(tr, 30.0, ctrl, edges=(8, 32),
                                s_sink=s_sink, device="cpu")
    want = jtraces.replay_buckets(tr, 30.0, ctrl, edges=(8, 32),
                                  s_sink=s_sink)
    assert len(got) == len(want)
    for (gi, gcfg, gw, gc), (wi, wcfg, ww, wc) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        for f in ("n_feeds", "end_time"):
            assert getattr(gcfg, f) == getattr(wcfg, f), f
        for f in ("kind", "rd_times", "s_sink"):
            np.testing.assert_array_equal(getattr(gw, f).numpy(),
                                          np.asarray(getattr(ww, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(gc.rd_times.numpy(),
                                      np.asarray(wc.rd_times))
