"""Corpus replay and the sharded stream CLI of the port, held against the
JAX package on the same inputs (the port on the CPU): the CSV loader's
Python engine and writer, ``merge_traces``, ``corpus_batches``,
``serve_corpus`` at 2 shards, the corpus CLI, and ``python -m
redqueen_tpu_torch.serving.stream --shards 2`` against the reference
CLI's ``final.json``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from redqueen_tpu.data import traces as jtraces
from redqueen_tpu.runtime import integrity
from redqueen_tpu.serving import corpus as jcorpus
from redqueen_tpu_torch.data import traces as ttraces
from redqueen_tpu_torch.serving import corpus as tcorpus
from torch_cluster import J, T, compare_clusters
from torch_serving import no_fault  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traces(n_users=12, mean=15, seed=7):
    rng = np.random.RandomState(seed)
    tr = [np.sort(rng.uniform(0, 40, rng.poisson(mean)))
          for _ in range(n_users)]
    tr[3] = np.empty(0)            # an empty user vanishes on round trip
    tr[5][2] = tr[5][1]            # a duplicate timestamp
    return tr


def _csv(tmp_path, tr=None):
    path = os.path.join(str(tmp_path), "corpus.csv")
    jtraces.save_csv(path, _traces() if tr is None else tr)
    return path


def test_save_csv_writes_the_reference_bytes(tmp_path):
    tr = _traces()
    jtraces.save_csv(str(tmp_path / "j.csv"), tr)
    ttraces.save_csv(str(tmp_path / "t.csv"), tr)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_load_csv_matches_the_reference_python_engine(tmp_path):
    path = _csv(tmp_path)
    # rows out of order within a user, and a blank line
    with open(path, "a") as f:
        f.write("u000000,0.5\n\nu000001,1e-3\n")
    want, wstats = jtraces.load_csv(path, engine="python",
                                    return_stats=True)
    for engine in ("python", "auto"):
        got, gstats = ttraces.load_csv(path, engine=engine,
                                       return_stats=True)
        assert gstats == wstats
        assert wstats.non_monotonic_rows == 2
        assert wstats.duplicate_timestamps == 1
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = ttraces.load_csv(path, delimiter=",", skip_header=1)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_load_csv_refuses_nan_and_the_native_engine(tmp_path):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write("user,time\nu0,1.0\nu1,nan\n")
    with pytest.raises(jtraces.TraceOrderError, match="line 2"):
        jtraces.load_csv(path, engine="python")
    with pytest.raises(ttraces.TraceOrderError, match="line 2"):
        ttraces.load_csv(path)
    # the native engine refuses the NaN row as the Python one does
    with pytest.raises(ttraces.TraceOrderError, match="line 2"):
        ttraces.load_csv(path, engine="native")
    with pytest.raises(ValueError, match="unknown engine"):
        ttraces.load_csv(path, engine="rust")


@pytest.mark.parametrize("max_rows", [None, 1, 37])
def test_merge_traces_and_batches_match_the_reference(max_rows):
    tr = _traces()
    tj, fj = jcorpus.merge_traces(tr, max_rows=max_rows)
    tt, ft = tcorpus.merge_traces(tr, max_rows=max_rows)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(ft, fj)
    assert ft.dtype == fj.dtype and tt.dtype == tj.dtype
    for size in (1, 16, 500):
        bj = list(jcorpus.corpus_batches(tj, fj, size))
        bt = list(tcorpus.corpus_batches(tt, ft, size))
        assert [b.seq for b in bt] == [b.seq for b in bj]
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a.times, b.times)
            np.testing.assert_array_equal(a.feeds, b.feeds)
    assert tcorpus.merge_traces([])[0].shape == (0,)


def test_serve_corpus_at_two_shards_matches_the_reference(tmp_path):
    """The same corpus served through 2 shards by each package: the same
    summary (rows, users, batches, engine, reconciliation) and the same
    per-shard decisions and digests."""
    path = _csv(tmp_path)
    kw = dict(n_shards=2, batch_events=16, snapshot_every=4, q=1.0,
              seed=3)
    pj = jcorpus.serve_corpus(path, str(tmp_path / "jax"), engine="python",
                              **kw)
    pt = tcorpus.serve_corpus(path, str(tmp_path / "torch"), device="cpu",
                              engine="python", **kw)
    for k in ("loader_engine", "corpus_rows", "corpus_users",
              "duplicate_timestamps", "non_monotonic_rows", "rows_served",
              "rows_truncated", "n_shards", "n_batches", "batch_events",
              "reconciles", "applied_seq"):
        assert pt[k] == pj[k], k
    assert pt["loader_engine"] == "python" and pt["reconciles"] is True
    cj, _ = J.ServingCluster.recover(str(tmp_path / "jax"))
    ct, _ = T.ServingCluster.recover(str(tmp_path / "torch"), device="cpu")
    with cj, ct:
        compare_clusters(cj, ct, seed=3)


def test_corpus_cli_serves_on_the_cpu_when_asked(tmp_path):
    path = _csv(tmp_path)
    env = dict(os.environ)
    env.pop("RQ_FAULT", None)
    out = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.serving.corpus",
         "--csv", path, "--dir", str(tmp_path / "srv"), "--shards", "2",
         "--batch-events", "16", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["loader_engine"] == "native"  # "auto" where g++ builds
    assert payload["rows_served"] == sum(len(t) for t in _traces())
    assert payload["reconciles"] is True


def _stream_cli(module, d, extra=()):
    env = dict(os.environ)
    env.pop("RQ_FAULT", None)
    env.pop("RQ_FAULT_POINT", None)
    cmd = [sys.executable, "-m", module, "--dir", str(d), "--batches", "14",
           "--feeds", "16", "--events-per-batch", "6", "--q", "1.0",
           "--shards", "2", "--coalesce", "4", *extra]
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_stream_cli_shards_matches_the_reference_final(tmp_path):
    """``stream --shards 2`` in both packages: the port's ``final.json``
    carries the reference's cluster, edge and shard digests and the same
    per-shard decision histories."""
    rj = _stream_cli("redqueen_tpu.serving.stream", tmp_path / "jax")
    assert rj.returncode == 0, rj.stderr[-2000:]
    rt = _stream_cli("redqueen_tpu_torch.serving.stream", tmp_path / "torch",
                     ("--device", "cpu"))
    assert rt.returncode == 0, rt.stderr[-2000:]
    fj, ft = (integrity.read_json(os.path.join(str(tmp_path / d),
                                               "final.json"),
                                  schema="rq.serving.cluster.final/1")
              for d in ("jax", "torch"))
    assert ft["cluster_digest"] == fj["cluster_digest"]
    assert ft["edge_digest"] == fj["edge_digest"]
    assert ft["applied_seq"] == fj["applied_seq"] == 13
    assert [s["digest"] for s in ft["shards"]] == \
        [s["digest"] for s in fj["shards"]]
    assert [s["decisions"] for s in ft["shards"]] == \
        [s["decisions"] for s in fj["shards"]]
    assert ft["metrics"]["reconciles"] is True


def test_stream_cli_without_a_card_fails_unless_asked_for_the_cpu(
        tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves")
    r = _stream_cli("redqueen_tpu_torch.serving.stream", tmp_path / "c")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not os.path.exists(str(tmp_path / "c" / "final.json"))
