"""The port's sharded serving cluster held against the JAX package's on
the same inputs (the port's on the CPU): one stream through both
packages' ``ServingCluster`` with equal decisions but for counted
near-ties and equal shard, cluster and edge digests; cluster
directories that recover across packages in both directions, a killed
shard included; and the offline ``reshard`` giving the same report and
edge digest in both.

A directory crosses packages with snapshots off: each package reads
only its own snapshot format (the journals, configs and topology log
are shared)."""

import os
import shutil

import numpy as np
import pytest

from torch_cluster import (J, Q_CLUSTER, T, compare_clusters, posts,
                           serve_cluster)
from torch_serving import no_fault  # noqa: F401

NO_SNAPSHOTS = 10 ** 6


def _stream(F, n, epb=16, seed=0):
    return T.synthetic_stream(seed, n, F, events_per_batch=epb)


@pytest.mark.parametrize("shards,coalesce,fmt,replication", [
    (4, 1, None, 0),          # K = 1, JSONL journals
    (3, 8, "binary", 0),      # coalesced rounds, binary journals
    (4, 8, "binary", 2),      # the quorum tier: factor 2, quorum 1
], ids=["jsonl-k1", "binary-k8", "replicated"])
def test_same_stream_matches_the_reference(tmp_path, shards, coalesce,
                                           fmt, replication):
    F, seed = 48, 5
    kw = dict(n_feeds=F, n_shards=shards, q=Q_CLUSTER, seed=seed,
              coalesce=coalesce, journal_format=fmt,
              replication_factor=replication,
              replication_quorum=1 if replication else None,
              snapshot_every=4, reorder_window=8, queue_capacity=64)
    batches = _stream(F, 48, seed=seed)
    with J.ServingCluster(dir=str(tmp_path / "jax"), **kw) as cj, \
            T.ServingCluster(dir=str(tmp_path / "torch"), device="cpu",
                             **kw) as ct:
        for cl in (cj, ct):
            serve_cluster(cl, batches, poll_every=coalesce)
            assert cl.applied_seq == len(batches) - 1
        compare_clusters(cj, ct, seed)
        assert 0 < posts(ct) < len(batches) * shards
        mj = cj.metrics.report(cj.pending_by_shard, cj.health_by_shard)
        mt = ct.metrics.report(ct.pending_by_shard, ct.health_by_shard)
        assert mt["reconciles"] and mj["reconciles"]
        assert ct.durability() == cj.durability()


def _serve_with_a_dead_shard(pkg, d, batches, device_kw):
    """Serve the first half, kill shard 1, serve the second half with it
    down (no auto-recovery), close: the directory a crash leaves."""
    cl = pkg.ServingCluster(dir=d, n_feeds=32, n_shards=4, q=Q_CLUSTER,
                            seed=2, snapshot_every=NO_SNAPSHOTS,
                            auto_recover=False, **device_kw)
    half = len(batches) // 2
    for b in batches[:half]:
        cl.submit(b)
        cl.poll()
    cl.kill_shard(1)
    for b in batches[half:]:
        cl.submit(b)
        cl.poll()
    assert cl.health_by_shard[1] == "quarantined"
    cl.close()


def _recover_and_drain(pkg, d, batches, device_kw):
    cl, infos = pkg.ServingCluster.recover(d, **device_kw)
    serve_cluster(cl, batches)
    assert cl.applied_seq == len(batches) - 1
    return cl, infos


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cluster_directories_recover_across_packages(tmp_path, writer):
    """One package serves with shard 1 killed mid-stream and closes; the
    other package recovers the directory (every shard from its own
    journal), retransmits, and lands on the digests the writer reaches
    recovering its own copy."""
    batches = _stream(32, 24, seed=2)
    d = str(tmp_path / "dir")
    cpu = dict(device="cpu")
    wpkg, wkw, rpkg, rkw = ((J, {}, T, cpu) if writer == "jax"
                            else (T, cpu, J, {}))
    _serve_with_a_dead_shard(wpkg, d, batches, wkw)
    shutil.copytree(d, str(tmp_path / "copy"))
    cr, infos = _recover_and_drain(rpkg, d, batches, rkw)
    cw, infos_w = _recover_and_drain(wpkg, str(tmp_path / "copy"),
                                     batches, wkw)
    with cr, cw:
        assert [i.replayed for i in infos] == \
            [i.replayed for i in infos_w]
        assert infos[1].recovered_seq < len(batches) // 2
        cj, ct = (cw, cr) if writer == "jax" else (cr, cw)
        compare_clusters(cj, ct, seed=2)


def test_reshard_matches_the_reference(tmp_path):
    """The same drained source directory (written by the reference,
    snapshots off) resharded 4 -> 2 by each package: the same report
    but for its paths, the same edge digest, and the same digests after
    more traffic through the resharded clusters."""
    batches = _stream(32, 30, seed=4)
    src = str(tmp_path / "src")
    with J.ServingCluster(dir=src, n_feeds=32, n_shards=4, q=Q_CLUSTER,
                          seed=4, snapshot_every=NO_SNAPSHOTS) as cl:
        serve_cluster(cl, batches[:20])
        want = cl.edge_digest()
    shutil.copytree(src, str(tmp_path / "src2"))
    rj = J.reshard(src, str(tmp_path / "dj"), 2)
    rt = T.reshard(str(tmp_path / "src2"), str(tmp_path / "dt"), 2,
                   device="cpu")
    for r in (rj, rt):
        r.pop("src_dir")
        r.pop("dst_dir")
    assert rt == rj and rt["edge_digest"] == want
    cj, _ = J.ServingCluster.recover(str(tmp_path / "dj"))
    ct, _ = T.ServingCluster.recover(str(tmp_path / "dt"), device="cpu")
    with cj, ct:
        for cl in (cj, ct):
            serve_cluster(cl, batches)
        compare_clusters(cj, ct, seed=4)


def test_cluster_config_reads_the_same_in_both_packages(tmp_path):
    """``cluster.json`` names no device: the port writes the reference's
    config, key for key."""
    kw = dict(n_feeds=16, n_shards=2, q=2.0, seed=1, coalesce=4,
              flush_mode="group", journal_format="binary")
    with J.ServingCluster(dir=str(tmp_path / "j"), **kw), \
            T.ServingCluster(dir=str(tmp_path / "t"), device="cpu", **kw):
        pass
    from redqueen_tpu.runtime import integrity

    cj = integrity.read_json(str(tmp_path / "j" / "cluster.json"),
                             schema=J.CLUSTER_SCHEMA)
    ct = integrity.read_json(str(tmp_path / "t" / "cluster.json"),
                             schema=T.CLUSTER_SCHEMA)
    assert ct == cj and "device" not in ct


def test_cluster_without_a_card_raises_unless_asked_for_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ServingCluster(n_feeds=8, n_shards=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ServingCluster(n_feeds=8, n_shards=2, dir=str(tmp_path / "w"),
                         placement="workers")
    assert not os.path.exists(str(tmp_path / "w"))
    with T.ServingCluster(n_feeds=8, n_shards=2, device="cpu") as cl:
        assert cl.device.type == "cpu"
        assert np.all([s.runtime.device.type == "cpu" for s in cl._slots])
