"""Sharded serving fault domains of the port (``redqueen_tpu_torch.
serving.cluster``, on the CPU): per-shard journals, health-aware
routing, crash isolation, digest-asserted reshard — case for case the
JAX package's ``tests/test_serving_cluster.py``.

THE chaos acceptance scenario: kill 1 of N>=4 shards mid-stream under
load and prove (a) healthy shards never stall or shed because of the
dead shard, (b) the recovered shard's post-recovery carry AND decision
stream are bit-identical to an uninterrupted run, (c) cluster-wide
accounting reconciles at every instant — including mid-recovery.  All
deterministic, on CPU, driven by the new ``shard:*`` fault kinds.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from redqueen_tpu_torch import serving
from redqueen_tpu_torch.serving import cluster as cluster_mod
from redqueen_tpu_torch.serving import corpus as corpus_mod
from redqueen_tpu_torch.runtime import faultinject, integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = dict(n_feeds=16, n_shards=4, q=1.0, seed=0, snapshot_every=3,
              reorder_window=8, queue_capacity=64)
N_BATCHES = 10


def _batches(n=N_BATCHES):
    return serving.synthetic_stream(0, n, PARAMS["n_feeds"],
                                    events_per_batch=6)


def _drain(cl, batches, rounds=6):
    """Retransmit everything past the cluster's acked position until it
    converges (the source model) — poll-first so auto-recovery runs."""
    for _ in range(rounds):
        cl.poll()
        missing = [b for b in batches if int(b.seq) > cl.applied_seq]
        if not missing:
            break
        for b in missing:
            cl.submit(b)
            cl.poll()
    cl.poll()


def _run_cluster(dir, batches=None, fault_env=None, monkeypatch=None):
    """One full in-process cluster run (submit+poll per batch, then
    drain); returns the OPEN cluster — caller closes."""
    if fault_env is not None:
        monkeypatch.setenv(faultinject.ENV_FAULT, fault_env)
    batches = _batches() if batches is None else batches
    cl = serving.ServingCluster(dir=str(dir), **PARAMS, device="cpu")
    for b in batches:
        cl.submit(b)
        cl.poll()
    _drain(cl, batches)
    return cl


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted cluster run every fault scenario must reproduce
    bitwise: cluster digest, partition-independent edge digest, and the
    per-shard retained decision histories."""
    d = tmp_path_factory.mktemp("cluster_ref")
    cl = _run_cluster(d)
    with cl:
        assert cl.applied_seq == N_BATCHES - 1
        ref = {
            "cluster_digest": cl.cluster_digest(),
            "edge_digest": cl.edge_digest(),
            "decisions": [serving.journal_decisions(sd)
                          for sd in cl.shard_dirs],
        }
    return ref


# ---------------------------------------------------------------------------
# Partition + seed derivation
# ---------------------------------------------------------------------------


class TestPartition:
    def test_balanced_and_deterministic(self):
        a1 = serving.partition(1000, 7)
        a2 = serving.partition(1000, 7)
        assert (a1 == a2).all()
        counts = np.bincount(a1, minlength=7)
        assert counts.max() - counts.min() <= 1
        assert counts.sum() == 1000
        # every edge owned by exactly one shard in range
        assert ((a1 >= 0) & (a1 < 7)).all()

    def test_hash_dealing_decorrelates_locality(self):
        # contiguous feed ids do NOT map to contiguous shards
        a = serving.partition(64, 4)
        assert len(set(a[:8].tolist())) > 1

    def test_more_shards_than_feeds_refused(self):
        with pytest.raises(ValueError, match="at least one edge"):
            serving.partition(3, 4)

    def test_shard_seeds_distinct(self):
        seeds = [serving.shard_seed(0, k) for k in range(64)]
        assert len(set(seeds)) == 64
        assert serving.shard_seed(0, 3) != serving.shard_seed(1, 3)


# ---------------------------------------------------------------------------
# Fault-spec parsing
# ---------------------------------------------------------------------------


class TestShardFaultSpecs:
    def test_parse_every_mode(self):
        for mode in faultinject.SHARD_MODES:
            spec = faultinject.parse_fault(f"shard:{mode}@shard2,batch7")
            assert spec.kind == "shard"
            f = faultinject.parse_shard(spec.arg)
            assert f == faultinject.ShardFault(mode, 2, 7)
        # batch qualifier is optional (None = first opportunity)
        f = faultinject.parse_shard("crash@shard1")
        assert f == faultinject.ShardFault("crash", 1, None)

    @pytest.mark.parametrize("bad", [
        None, "crash", "warp@shard1", "crash@lane3", "crash@shardX",
        "crash@shard-1", "crash@shard1,lane2", "crash@shard1,batchX",
    ])
    def test_malformed_specs_raise(self, bad):
        with pytest.raises(ValueError):
            faultinject.parse_shard(bad)

    def test_env_accessor_fires_only_for_shard_kind(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:wedge@shard0")
        assert faultinject.shard_fault() == \
            faultinject.ShardFault("wedge", 0, None)
        monkeypatch.setenv(faultinject.ENV_FAULT, "ingest:dup@batch2")
        assert faultinject.shard_fault() is None
        monkeypatch.delenv(faultinject.ENV_FAULT)
        assert faultinject.shard_fault() is None

    def test_maybe_inject_validates_shard_specs_fast(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:bogus@shard1")
        with pytest.raises(ValueError, match="bogus"):
            faultinject.maybe_inject()
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:crash@shard1")
        faultinject.maybe_inject()  # valid data-plane spec: no-op here

    def test_out_of_range_shard_index_refused_at_construction(
            self, monkeypatch):
        """Regression: a spec addressing a shard the cluster doesn't
        have could never fire — a chaos run would pass while injecting
        nothing, so the cluster refuses to start instead."""
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:crash@shard4")
        with pytest.raises(ValueError, match="could never fire"):
            serving.ServingCluster(**PARAMS, device="cpu")
        # in range: constructs fine (and would fire at shard 3)
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:crash@shard3")
        serving.ServingCluster(**PARAMS, device="cpu").close()


# ---------------------------------------------------------------------------
# Routing: fan-out, empty slices, admission statuses, accounting units
# ---------------------------------------------------------------------------


class TestRouting:
    def test_every_shard_journals_every_batch(self, tmp_path):
        """Per-shard seq == global seq: every shard's journal holds one
        record per global batch (empty slices included), so each fault
        domain replays independently."""
        cl = _run_cluster(tmp_path / "srv")
        with cl:
            for sd in cl.shard_dirs:
                decs = serving.journal_decisions(sd)
                assert [d.seq for d in decs][-1] == N_BATCHES - 1

    def test_events_route_to_owning_shard_only(self, tmp_path):
        cl = serving.ServingCluster(dir=None, **PARAMS, device="cpu")
        assign = serving.partition(PARAMS["n_feeds"], PARAMS["n_shards"])
        b = _batches()[0]
        adm = cl.submit(b)
        assert adm.status == "accepted"
        # per-shard queued event totals match the partition's split
        want = np.bincount(assign[b.feeds],
                           minlength=PARAMS["n_shards"])
        for k, slot in enumerate(cl._slots):
            got = sum(q[0].n_events for q in slot.runtime._queue)
            assert got == want[k]
        cl.close()

    def test_global_rejection_counts_one_per_shard(self):
        cl = serving.ServingCluster(dir=None, **PARAMS, device="cpu")
        bad = serving.EventBatch(0, np.asarray([1.0, np.nan]),
                                 np.asarray([0, 1]))
        adm = cl.submit(bad)
        assert adm.status == "rejected"
        assert adm.per_shard == ("rejected",) * PARAMS["n_shards"]
        assert cl.metrics.reconciles(cl.pending_by_shard)
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        assert rep["rejected"] == PARAMS["n_shards"]
        assert rep["global_rejected_batches"] == 1
        cl.close()

    def test_unavailable_shard_slice_is_shed_with_seq(self, tmp_path):
        cl = _run_cluster(tmp_path / "srv", batches=_batches(5))
        with cl:
            cl.kill_shard(1)
            adm = cl.submit(_batches(6)[5])
            assert adm.status == "partial"
            assert adm.per_shard[1] == "unavailable"
            assert adm.backpressure
            s = cl.metrics.shards[1]
            assert s.shed_unavailable == 1 and 5 in s.shed_seqs
            assert cl.metrics.reconciles(cl.pending_by_shard)

    def test_duplicate_global_batch_acks_everywhere(self, tmp_path):
        cl = _run_cluster(tmp_path / "srv")
        with cl:
            adm = cl.submit(_batches()[0])
            assert adm.status == "accepted"  # all-duplicate = an ack
            assert set(adm.per_shard) == {"duplicate"}
            assert cl.metrics.reconciles(cl.pending_by_shard)

    def test_decide_aggregates_and_counts_quarantined(self, tmp_path):
        cl = _run_cluster(tmp_path / "srv")
        with cl:
            d = cl.decide()
            assert d is not None and d.shards_reporting == 4
            assert d.shards_quarantined == 0
            assert np.isfinite(d.intensity)
            cl.kill_shard(2)
            d2 = cl.decide()
            assert d2.shards_reporting == 3
            assert d2.shards_quarantined == 1

    def test_reset_metrics_refused_with_backlog(self):
        cl = serving.ServingCluster(dir=None, **PARAMS, device="cpu")
        cl.submit(_batches()[0])
        with pytest.raises(ValueError, match="pending"):
            cl.reset_metrics()
        cl.poll()
        cl.reset_metrics()
        assert cl.metrics.report(
            cl.pending_by_shard, cl.health_by_shard)["ingested"] == 0
        cl.close()

    def test_cluster_config_mismatch_refused(self, tmp_path):
        d = str(tmp_path / "srv")
        serving.ServingCluster(dir=d, **PARAMS, device="cpu").close()
        bad = dict(PARAMS, n_shards=2)
        with pytest.raises(ValueError, match="n_shards"):
            serving.ServingCluster(dir=d, **bad, device="cpu")
        bad = dict(PARAMS, seed=9)
        with pytest.raises(ValueError, match="seed"):
            serving.ServingCluster(dir=d, **bad, device="cpu")
        # matching params reopen fine
        serving.ServingCluster(dir=d, **PARAMS, device="cpu").close()


# ---------------------------------------------------------------------------
# THE chaos acceptance scenario (in process): SIGKILL-equivalent loss of
# one fault domain mid-stream under load
# ---------------------------------------------------------------------------


def test_kill_one_shard_under_load_isolates_and_recovers(tmp_path,
                                                         reference):
    batches = _batches()
    cl = serving.ServingCluster(dir=str(tmp_path / "srv"), **PARAMS,
                                device="cpu")
    with cl:
        for b in batches[:5]:
            cl.submit(b)
            cl.poll()
        # load up the cluster, THEN kill shard 1 with batches queued
        # inside it — the queued sub-batches die with the carry
        for b in batches[5:8]:
            cl.submit(b)
        cl.kill_shard(1, reason="chaos: SIGKILL fault domain 1")
        assert cl.health_by_shard[1] == cluster_mod.QUARANTINED
        s = cl.metrics.shards[1]
        assert s.crashes == 1
        assert s.lost_on_crash == 3 and s.lost_seqs == [5, 6, 7]
        # (c) accounting reconciles MID-RECOVERY: the dead shard's
        # accepted-but-unapplied sub-batches were reclassified lost
        assert cl.metrics.reconciles(cl.pending_by_shard)
        # healthy shards drain their queues right through the outage
        cl.poll()
        for k in (0, 2, 3):
            assert cl.metrics.shards[k].applied == 8
        # shard 1 auto-recovered in place on that poll (probation)
        assert cl.health_by_shard[1] == cluster_mod.DEGRADED
        assert cl.metrics.shards[1].recoveries == 1
        assert cl.metrics.reconciles(cl.pending_by_shard)
        # the stream continues + the source retransmits the un-acked
        for b in batches[8:]:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        assert cl.applied_seq == N_BATCHES - 1
        # (a) healthy shards never stalled or shed because of the dead
        # one: every global batch applied exactly once, nothing shed,
        # nothing lost, no timeouts
        for k in (0, 2, 3):
            s = cl.metrics.shards[k]
            assert s.applied == N_BATCHES
            assert s.shed_queue == s.shed_unavailable == 0
            assert s.lost_on_crash == s.rejected == s.timeouts == 0
        # (b) bit-identical to the uninterrupted run: cluster + edge
        # digests and EVERY shard's decision history (including the
        # recovered shard's post-recovery stream)
        assert cl.cluster_digest() == reference["cluster_digest"]
        assert cl.edge_digest() == reference["edge_digest"]
        for sd, want in zip(cl.shard_dirs, reference["decisions"]):
            assert serving.journal_decisions(sd) == want
        # (c) ... and cluster-wide accounting still reconciles
        assert cl.metrics.reconciles(cl.pending_by_shard)
        # recovered shard healed after its clean applies
        assert cl.health_by_shard[1] == cluster_mod.HEALTHY


# ---------------------------------------------------------------------------
# Per-fault-kind bit-identity (env-driven, in process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", [
    "shard:crash@shard1,batch5",
    "shard:torn_journal@shard2,batch4",
    "shard:corrupt_snapshot@shard0,batch7",
    "shard:wedge@shard3,batch3",
])
def test_shard_faults_end_bit_identical(tmp_path, monkeypatch,
                                        reference, fault):
    d = tmp_path / "srv"
    cl = _run_cluster(d, fault_env=fault, monkeypatch=monkeypatch)
    with cl:
        assert cl.applied_seq == N_BATCHES - 1
        assert cl.cluster_digest() == reference["cluster_digest"]
        assert cl.edge_digest() == reference["edge_digest"]
        for sd, want in zip(cl.shard_dirs, reference["decisions"]):
            assert serving.journal_decisions(sd) == want
        assert cl.metrics.reconciles(cl.pending_by_shard)
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        pf = faultinject.parse_shard(fault.split(":", 1)[1])
        s = cl.metrics.shards[pf.shard]
        if pf.mode == "wedge":
            # fired, degraded, backed off, healed — never quarantined
            assert s.timeouts == cluster_mod.WEDGE_FIRES
            assert s.backoff_rounds > 0 and s.crashes == 0
            assert cl.health_by_shard[pf.shard] == cluster_mod.HEALTHY
        else:
            assert s.crashes == 1 and s.recoveries == 1
            assert rep["recoveries"] == 1
        if pf.mode == "torn_journal":
            # the torn append was quarantined to a sidecar, and the
            # never-acked batch counts lost (not applied) on the ledger
            sdir = cl.shard_dirs[pf.shard]
            assert glob.glob(os.path.join(sdir, "journal.jsonl.torn-*"))
            assert s.lost_on_crash >= 1 and pf.batch in s.lost_seqs
        if pf.mode == "corrupt_snapshot":
            # recovery provably fell back PAST the scribbled snapshot:
            # the bad step was quarantined, never trusted
            snaps = os.path.join(cl.shard_dirs[pf.shard], "snapshots")
            assert glob.glob(os.path.join(snaps, "*.corrupt-*"))


def test_no_fault_counters_stay_zero(tmp_path, reference):
    cl = _run_cluster(tmp_path / "srv")
    with cl:
        assert cl.cluster_digest() == reference["cluster_digest"]
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        assert (rep["crashes"], rep["recoveries"], rep["timeouts"],
                rep["shed"], rep["rejected"]) == (0, 0, 0, 0, 0)
        assert cl.health_by_shard == [cluster_mod.HEALTHY] * 4


def test_foreign_fault_kinds_do_not_fire(tmp_path, monkeypatch,
                                         reference):
    monkeypatch.setenv(faultinject.ENV_FAULT, "numeric:nan@lane99")
    cl = _run_cluster(tmp_path / "srv")
    with cl:
        assert cl.cluster_digest() == reference["cluster_digest"]
        assert cl.metrics.report(
            cl.pending_by_shard, cl.health_by_shard)["crashes"] == 0


# ---------------------------------------------------------------------------
# Health state machine: timeouts escalate to quarantine, recovery
# probation heals
# ---------------------------------------------------------------------------


def test_repeated_timeouts_quarantine_then_recover(tmp_path, monkeypatch,
                                                   reference):
    """A shard that stays wedged past QUARANTINE_AFTER consecutive
    deadline expiries is declared dead (volatile state untrusted),
    recovered from durable state, and the stream reconverges
    bit-identically."""
    monkeypatch.setattr(cluster_mod, "WEDGE_FIRES",
                        cluster_mod.QUARANTINE_AFTER + 2)
    monkeypatch.setenv(faultinject.ENV_FAULT, "shard:wedge@shard2,batch3")
    d = tmp_path / "srv"
    batches = _batches()
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    with cl:
        for b in batches:
            cl.submit(b)
            cl.poll()
        # extra rounds so the backoff/timeout cadence plays out fully
        _drain(cl, batches, rounds=24)
        s = cl.metrics.shards[2]
        assert s.crashes == 1  # quarantined via the timeout path
        assert s.timeouts >= cluster_mod.QUARANTINE_AFTER
        assert s.recoveries == 1
        assert cl.applied_seq == N_BATCHES - 1
        assert cl.cluster_digest() == reference["cluster_digest"]
        assert cl.metrics.reconciles(cl.pending_by_shard)


def test_kill_shard_guards():
    cl = serving.ServingCluster(dir=None, **PARAMS, device="cpu")
    cl.kill_shard(0)
    with pytest.raises(ValueError, match="already quarantined"):
        cl.kill_shard(0)
    with pytest.raises(ValueError, match="not quarantined"):
        cl.recover_shard(1)
    # an in-memory cluster has no durable state to recover from
    with pytest.raises(ValueError, match="no directory"):
        cl.recover_shard(0)
    cl.close()


# ---------------------------------------------------------------------------
# Subprocess chaos: the driver survives a shard fault; a whole-process
# kill mid-global-batch reconverges on --resume
# ---------------------------------------------------------------------------


def _cluster_cli(dir, fault=None, resume=False, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k not in (faultinject.ENV_FAULT, faultinject.ENV_FAULT_POINT)}
    if fault:
        env[faultinject.ENV_FAULT] = fault
    cmd = [sys.executable, "-m", "redqueen_tpu_torch.serving.stream",
           "--dir", str(dir), "--batches", "10", "--feeds", "16",
           "--shards", "4", "--device", "cpu"]
    if resume:
        cmd.append("--resume")
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cli_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_cluster_ref")
    r = _cluster_cli(d)
    assert r.returncode == 0, r.stderr[-2000:]
    return integrity.read_json(os.path.join(str(d), "final.json"),
                               schema="rq.serving.cluster.final/1")


def test_driver_survives_shard_crash_bit_identically(tmp_path,
                                                     cli_reference):
    """The crash-isolation headline in a real subprocess: one fault
    domain dies mid-stream, the DRIVER keeps running (exit 0), the
    shard recovers in place, and the final cluster state + every
    per-shard decision history equal the uninterrupted run's."""
    d = tmp_path / "crash"
    r = _cluster_cli(d, fault="shard:crash@shard1,batch5")
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
    got = integrity.read_json(os.path.join(str(d), "final.json"),
                              schema="rq.serving.cluster.final/1")
    assert got["cluster_digest"] == cli_reference["cluster_digest"]
    assert got["edge_digest"] == cli_reference["edge_digest"]
    assert [s["decisions"] for s in got["shards"]] == \
        [s["decisions"] for s in cli_reference["shards"]]
    assert got["metrics"]["recoveries"] == 1
    assert got["metrics"]["reconciles"] is True


def test_whole_process_kill_reconverges_on_resume(tmp_path,
                                                  cli_reference):
    """``ingest:crash_after_apply`` inside a cluster kills the WHOLE
    process the instant the first shard journals sub-batch N — shards
    die at DIFFERENT seqs mid-global-batch.  --resume recovers every
    fault domain independently and the retransmit reconverges them to
    the uninterrupted run, bit for bit."""
    d = tmp_path / "whole"
    r = _cluster_cli(d, fault="ingest:crash_after_apply@batch4")
    assert r.returncode == 17, (r.returncode, r.stderr[-2000:])
    assert not os.path.exists(os.path.join(str(d), "final.json"))
    r2 = _cluster_cli(d, resume=True)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert r2.stderr.count("recovered shard") == 4
    got = integrity.read_json(os.path.join(str(d), "final.json"),
                              schema="rq.serving.cluster.final/1")
    assert got["cluster_digest"] == cli_reference["cluster_digest"]
    assert got["edge_digest"] == cli_reference["edge_digest"]
    assert [s["decisions"] for s in got["shards"]] == \
        [s["decisions"] for s in cli_reference["shards"]]


# ---------------------------------------------------------------------------
# Reshard: digest-asserted N -> M state migration
# ---------------------------------------------------------------------------


class TestReshard:
    @pytest.mark.parametrize("n_new", [2, 8])  # merge AND split
    def test_edge_state_preserved_bitwise(self, tmp_path, reference,
                                          n_new):
        src = tmp_path / "src"
        _run_cluster(src).close()
        dst = tmp_path / f"dst{n_new}"
        rep = serving.reshard(str(src), str(dst), n_new, device="cpu")
        assert rep["verified"] is True
        assert rep["n_shards_dst"] == n_new
        assert rep["edge_digest"] == reference["edge_digest"]
        assert sum(rep["edges_per_shard"]) == PARAMS["n_feeds"]
        assert max(rep["edges_per_shard"]) - \
            min(rep["edges_per_shard"]) <= 1
        # the report landed enveloped in the destination
        got = integrity.read_json(os.path.join(str(dst), "reshard.json"),
                                  schema="rq.serving.reshard/1")
        assert got == rep
        # the migrated cluster recovers (per-shard snapshots at the
        # migrated seq — no genesis replay) and keeps the edge digest
        cl, infos = serving.ServingCluster.recover(str(dst), device="cpu")
        with cl:
            assert all(i.snapshot_seq == N_BATCHES - 1 for i in infos)
            assert all(i.replayed == 0 for i in infos)
            assert cl.edge_digest() == reference["edge_digest"]
            assert cl.applied_seq == N_BATCHES - 1

    def test_continuation_is_deterministic(self, tmp_path):
        """Serving after a reshard is a pure function of the migrated
        state + stream: two identical reshards + continuations land
        bit-identical carries and decisions."""
        src = tmp_path / "src"
        _run_cluster(src).close()
        digs, decs = [], []
        more = serving.synthetic_stream(0, 14, PARAMS["n_feeds"],
                                        events_per_batch=6)
        for run in range(2):
            dst = tmp_path / f"dst{run}"
            serving.reshard(str(src), str(dst), 2, device="cpu")
            cl, _ = serving.ServingCluster.recover(str(dst), device="cpu")
            with cl:
                for b in more:
                    cl.submit(b)
                    cl.poll()
                _drain(cl, more)
                assert cl.applied_seq == 13
                digs.append(cl.cluster_digest())
                decs.append([serving.journal_decisions(sd)
                             for sd in cl.shard_dirs])
        assert digs[0] == digs[1]
        assert decs[0] == decs[1]

    def test_nonzero_start_seq_reshards(self, tmp_path):
        """Regression: a cluster created at start_seq > 0 must still
        reshard — the destination runtimes are fresh at applied_seq =
        start_seq - 1 (>= 0), which the install_carry freshness guard
        must not mistake for live serving state."""
        start = 5
        params = dict(PARAMS, start_seq=start)
        src = tmp_path / "src"
        batches = serving.synthetic_stream(0, N_BATCHES,
                                           PARAMS["n_feeds"],
                                           events_per_batch=6,
                                           start_seq=start)
        cl = serving.ServingCluster(dir=str(src), **params, device="cpu")
        for b in batches:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        edge_before = cl.edge_digest()
        cl.close()
        dst = tmp_path / "dst"
        rep = serving.reshard(str(src), str(dst), 2, device="cpu")
        assert rep["verified"] is True
        assert rep["edge_digest"] == edge_before
        assert rep["seq"] == start + N_BATCHES - 1

    def test_divergent_reshard_removes_destination(self, tmp_path,
                                                   monkeypatch):
        """Regression: a digest-divergent reshard must not leave a
        fully-formed (recoverable!) destination holding the unverified
        migrated state — recover(dst) would serve exactly what the
        assert refused."""
        src = tmp_path / "src"
        _run_cluster(src).close()
        dst = tmp_path / "dst"
        real = serving.ServingCluster.edge_digest

        def corrupted(self):  # divergence on the DESTINATION gather
            d = real(self)
            return "0" * 64 if self.dir == str(dst) else d

        monkeypatch.setattr(serving.ServingCluster, "edge_digest",
                            corrupted)
        with pytest.raises(RuntimeError, match="reshard diverged"):
            serving.reshard(str(src), str(dst), 2, device="cpu")
        assert not os.path.exists(dst)
        monkeypatch.undo()
        # src intact: the same reshard succeeds afterwards
        rep = serving.reshard(str(src), str(dst), 2, device="cpu")
        assert rep["verified"] is True

    def test_nonempty_destination_refused(self, tmp_path):
        src = tmp_path / "src"
        _run_cluster(src).close()
        dst = tmp_path / "dst"
        os.makedirs(dst)
        (dst / "junk").write_text("x")
        with pytest.raises(ValueError, match="not empty"):
            serving.reshard(str(src), str(dst), 2, device="cpu")

    def test_undrained_cluster_refuses_edge_digest(self, tmp_path):
        """Shards at different seqs (one recovered behind the others,
        nothing retransmitted yet) must refuse the edge gather — a
        migration from divergent state would be silently wrong."""
        d = tmp_path / "srv"
        batches = _batches()
        cl = serving.ServingCluster(dir=str(d), auto_recover=False,
                                    **PARAMS, device="cpu")
        with cl:
            for b in batches[:4]:
                cl.submit(b)
                cl.poll()
            cl.kill_shard(3)
            for b in batches[4:6]:
                cl.submit(b)
                cl.poll()
            cl.recover_shard(3)  # recovered at seq 3, others at 5
            with pytest.raises(ValueError, match="disagree"):
                cl.edge_digest()


# ---------------------------------------------------------------------------
# Corpus replay: native-loader rows -> sharded ingest
# ---------------------------------------------------------------------------


class TestCorpus:
    def _csv(self, tmp_path, n_users=10, mean=15):
        from redqueen_tpu_torch.data import traces as traces_mod

        rng = np.random.RandomState(7)
        tr = [np.sort(rng.uniform(0, 40, rng.poisson(mean)))
              for _ in range(n_users)]
        path = os.path.join(str(tmp_path), "corpus.csv")
        traces_mod.save_csv(path, tr)
        return path, tr

    def test_merge_is_time_ordered_and_deterministic(self, tmp_path):
        _, tr = self._csv(tmp_path)
        t1, f1 = corpus_mod.merge_traces(tr)
        t2, f2 = corpus_mod.merge_traces(tr)
        assert (t1 == t2).all() and (f1 == f2).all()
        assert (np.diff(t1) >= 0).all()
        assert len(t1) == sum(len(t) for t in tr)
        assert f1.dtype == np.int32
        # max_rows takes a TIME prefix of the merged stream
        t3, f3 = corpus_mod.merge_traces(tr, max_rows=20)
        assert len(t3) == 20 and (t3 == t1[:20]).all()

    def test_batches_are_consecutively_sequenced(self, tmp_path):
        _, tr = self._csv(tmp_path)
        t, f = corpus_mod.merge_traces(tr)
        bs = list(corpus_mod.corpus_batches(t, f, 16))
        assert [b.seq for b in bs] == list(range(len(bs)))
        assert sum(b.n_events for b in bs) == len(t)
        assert all(b.n_events <= 16 for b in bs)

    def test_end_to_end_sharded_serve(self, tmp_path):
        csv, tr = self._csv(tmp_path)
        payload = corpus_mod.serve_corpus(
            csv, os.path.join(str(tmp_path), "srv"), n_shards=4,
            batch_events=24, snapshot_every=4, device="cpu")
        assert payload["reconciles"] is True
        assert payload["rows_served"] == sum(len(t) for t in tr)
        assert payload["corpus_users"] == len(tr)
        assert payload["n_batches"] == payload["applied_seq"] + 1
        assert payload["loader_engine"] in ("native", "python")
        # the artifacts landed enveloped
        got = integrity.read_json(
            os.path.join(str(tmp_path), "srv", "corpus.json"),
            schema="rq.serving.corpus/1")
        assert got == payload
        m = integrity.read_json(
            os.path.join(str(tmp_path), "srv", "metrics.json"),
            schema=serving.CLUSTER_METRICS_SCHEMA)
        assert m["reconciles"] is True and m["version"] == 2

    def test_shard_crash_mid_replay_retransmits_to_full_application(
            self, tmp_path, monkeypatch):
        """Regression: a shard crash during a corpus replay must not
        silently under-serve — the driver retransmits the regenerated
        stream until every batch APPLIES (rows_served means applied),
        or fails loudly."""
        csv, tr = self._csv(tmp_path)
        monkeypatch.setenv(faultinject.ENV_FAULT,
                           "shard:crash@shard1,batch2")
        payload = corpus_mod.serve_corpus(
            csv, os.path.join(str(tmp_path), "srv"), n_shards=4,
            batch_events=24, snapshot_every=4, device="cpu")
        assert payload["reconciles"] is True
        assert payload["rows_served"] == sum(len(t) for t in tr)
        assert payload["n_batches"] == payload["applied_seq"] + 1
        m = integrity.read_json(
            os.path.join(str(tmp_path), "srv", "metrics.json"),
            schema=serving.CLUSTER_METRICS_SCHEMA)
        assert m["crashes"] == 1 and m["recoveries"] == 1

    def test_crashed_replay_regenerates_identical_stream(self, tmp_path):
        """The retransmit model under real data: serve the corpus, then
        serve the REGENERATED stream into a recovered cluster — all
        duplicates, nothing new, digest unchanged."""
        csv, tr = self._csv(tmp_path)
        d = os.path.join(str(tmp_path), "srv")
        corpus_mod.serve_corpus(csv, d, n_shards=2, batch_events=24,
                                device="cpu")
        cl, _ = serving.ServingCluster.recover(d, device="cpu")
        with cl:
            dig = cl.cluster_digest()
            from redqueen_tpu_torch.data import traces as traces_mod

            t, f = corpus_mod.merge_traces(traces_mod.load_csv(csv))
            for b in corpus_mod.corpus_batches(t, f, 24):
                cl.submit(b)
                cl.poll()
            assert cl.cluster_digest() == dig
            rep = cl.metrics.report(cl.pending_by_shard,
                                    cl.health_by_shard)
            assert rep["applied"] == 0
            assert rep["duplicates"] == rep["ingested"]


# ---------------------------------------------------------------------------
# ClusterMetrics unit behavior
# ---------------------------------------------------------------------------


class TestClusterMetrics:
    def test_identity_closes_per_shard_and_cluster(self):
        m = serving.ClusterMetrics(2)
        for _ in range(5):
            m.observe_submitted(0)
            m.observe_submitted(1)
        for _ in range(4):
            m.observe_applied(0, 3, False, 0.001)
        m.observe_shed_queue(0, 4)
        for _ in range(2):
            m.observe_applied(1, 3, True, 0.001)
        m.observe_duplicate(1)
        m.observe_lost_on_crash(1, 3)
        m.observe_rejected(1)
        assert m.reconciles([0, 0])
        rep = m.report([0, 0], ["healthy", "degraded"])
        assert rep["ingested"] == 10
        assert rep["applied"] == 6 and rep["shed"] == 2
        assert rep["reconciles"] is True
        assert rep["shards"][1]["health"] == "degraded"
        # one unaccounted sub-batch breaks it
        m.observe_submitted(0)
        assert not m.reconciles([0, 0])
        assert m.reconciles([1, 0])  # ... unless it is pending

    def test_seq_lists_are_bounded(self):
        from redqueen_tpu_torch.serving import metrics as smetrics

        m = serving.ClusterMetrics(1)
        for i in range(smetrics.MAX_SEQS_PER_SHARD + 10):
            m.observe_shed_queue(0, i)
            m.observe_lost_on_crash(0, i)
        s = m.shards[0]
        assert len(s.shed_seqs) == smetrics.MAX_SEQS_PER_SHARD
        assert len(s.lost_seqs) == smetrics.MAX_SEQS_PER_SHARD
        assert s.shed_queue == s.lost_on_crash == \
            smetrics.MAX_SEQS_PER_SHARD + 10
        assert s.as_dict(0, "healthy")["seqs_truncated"] is True

    def test_report_requires_one_entry_per_shard(self):
        m = serving.ClusterMetrics(3)
        with pytest.raises(ValueError, match="per shard"):
            m.report([0], ["healthy"])
