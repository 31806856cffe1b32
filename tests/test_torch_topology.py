"""Elastic topology of the port (``redqueen_tpu_torch.serving.topology``
on the CPU, case for case the JAX package's ``tests/test_topology.py``):
crash-safe LIVE resharding and follow-graph churn under traffic.

THE chaos acceptance scenario: under live traffic, SIGKILL the source
shard mid-migration and prove (a) the migration resumes from the last
fenced range with the fenced digest asserted bit-identical, (b) zero
acked-record loss (the retransmit model reconverges everything past the
fence watermark), (c) a crash-interrupted migration lands the SAME
final edge state as an uninterrupted one, (d) edges on shards the plan
never touched stay bit-identical to an unmigrated control, and (e) the
cluster accounting identity reconciles through the whole outage —
fenced admissions never enter the ledgers.  All deterministic, on CPU,
driven by the new ``reshard:*`` fault kinds.
"""

import os

import numpy as np
import pytest

from redqueen_tpu_torch import serving
from redqueen_tpu_torch.serving import cluster as cluster_mod
from redqueen_tpu_torch.serving import topology
from redqueen_tpu_torch.runtime import faultinject

PARAMS = dict(n_feeds=16, n_shards=2, q=1.0, seed=0, snapshot_every=3,
              reorder_window=8, queue_capacity=64)
N_PRE = 6     # batches applied before the migration starts
N_POST = 6    # batches applied after (interleaved with) the migration


def _batches(n, start_seq=0):
    return serving.synthetic_stream(0, n + start_seq, PARAMS["n_feeds"],
                                    events_per_batch=6)[start_seq:]


def _drain(cl, batches, rounds=8):
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


def _feed(cl, batches):
    for b in batches:
        cl.submit(b)
        cl.poll()
    _drain(cl, batches)


def _heal_and_finish(cl):
    """Post-interruption convalescence: recover every quarantined
    shard, then drive the journaled plan to completion."""
    for k, h in enumerate(cl.health_by_shard):
        if h == cluster_mod.QUARANTINED:
            cl.recover_shard(k)
    if cl.migration_pending:
        cl.resume_migration().run()


def _migrated_run(dir, monkeypatch=None, fault=None, q=None,
                  n_shards_to=4, interleave=False):
    """One full live-reshard scenario: pre-traffic → begin_reshard →
    drive (a reshard fault may interrupt; heal + resume) → post-traffic
    → drain.  Returns the OPEN cluster — caller closes.

    ``interleave=True`` rides traffic between handoff steps (the
    live-traffic property).  The fault scenarios compare digests
    against the clean run, so both keep the stream OUT of the
    migration window: a batch that applies before vs after a flip
    legitimately lands on a different shard (different posting PRNG) —
    that is expected serving divergence, not a crash-safety bug."""
    params = dict(PARAMS)
    if q is not None:
        params["q"] = q
    cl = serving.ServingCluster(dir=str(dir), **params, device="cpu")
    _feed(cl, _batches(N_PRE))
    if fault is not None:
        monkeypatch.setenv(faultinject.ENV_FAULT, f"reshard:{fault}")
    mig = cl.begin_reshard(n_shards_to)
    post = _batches(N_POST, start_seq=N_PRE)
    try:
        i = 0
        while not mig.done:
            mig.step()
            # Traffic keeps flowing BETWEEN handoffs — the migration
            # never owns the stream.
            if interleave and i < len(post):
                cl.submit(post[i])
                cl.poll()
                i += 1
    except topology.MigrationInterrupted:
        monkeypatch.delenv(faultinject.ENV_FAULT)
        _heal_and_finish(cl)
    except topology.MigrationStalled:
        monkeypatch.delenv(faultinject.ENV_FAULT)
        mig.run()  # same driver: the wedge fault is spent
    if fault is not None:
        monkeypatch.delenv(faultinject.ENV_FAULT, raising=False)
    _feed(cl, post)
    return cl


@pytest.fixture(scope="module")
def clean_migration(tmp_path_factory):
    """The uninterrupted live reshard every fault scenario must
    reproduce bitwise."""
    d = tmp_path_factory.mktemp("topo_clean")
    cl = _migrated_run(d)
    with cl:
        assert cl.applied_seq == N_PRE + N_POST - 1
        return {
            "edge_digest": cl.edge_digest(),
            "edges_per_shard": cl.edges_per_shard,
            "epoch": cl.topology_epoch,
        }


# ---------------------------------------------------------------------------
# Pure planning math (deterministic companions to the hypothesis
# properties in test_topology_properties.py)
# ---------------------------------------------------------------------------


class TestPlanMath:
    def test_plan_moves_balances_within_one(self):
        owned = {0: np.arange(0, 9), 1: np.arange(9, 16)}
        new_feeds, ranges = topology.plan_moves(owned, [2, 3])
        moved = sorted(f for r in ranges for f in r["feeds"])
        kept = {k: [int(f) for f in owned[k] if f not in moved]
                for k in owned}
        sizes = ([len(v) for v in kept.values()]
                 + [len(new_feeds[k]) for k in sorted(new_feeds)])
        assert sum(sizes) == 16
        assert max(sizes) - min(sizes) <= 1
        # existing shards keep a PREFIX of their ascending feeds and
        # shed the tail — the kept range never moves, so its carry
        # never leaves the journaled arrays that prove it
        for k in owned:
            assert kept[k] == [int(f) for f in owned[k][:len(kept[k])]]
        assert sorted(moved + [f for v in kept.values() for f in v]) \
            == list(range(16))
        # every moved feed lands in exactly one new slot's feed set
        assert sorted(f for k in new_feeds for f in new_feeds[k]) \
            == moved

    def test_plan_moves_range_size_splits(self):
        owned = {0: np.arange(0, 16)}
        _, ranges = topology.plan_moves(owned, [1], range_size=3)
        assert all(len(r["feeds"]) <= 3 for r in ranges)
        assert [r["id"] for r in ranges] == list(range(len(ranges)))

    def test_churn_assign_least_loaded_tie_lowest(self):
        assert topology.churn_assign({0: 5, 1: 3, 2: 5}, 2) == [1, 1]
        # ties break to the lowest shard id — deterministic plans
        assert topology.churn_assign({0: 4, 1: 4}, 3) == [0, 1, 0]

    def test_range_digest_is_a_pure_function_of_the_slice(self):
        r = np.arange(4, dtype=np.float32)
        h = np.zeros(4, np.uint32)
        d = topology.range_digest([3, 5, 7, 9], r, h)
        assert d == topology.range_digest([3, 5, 7, 9], r.copy(),
                                          h.copy())
        assert d != topology.range_digest([3, 5, 7, 8], r, h)
        assert d != topology.range_digest([3, 5, 7, 9], r + 1, h)
        assert d != topology.range_digest([3, 5, 7, 9], r, h + 1)


class TestTopologyLog:
    def test_roundtrip_and_unknown_kind_refused(self, tmp_path):
        p = os.path.join(str(tmp_path), topology.TOPOLOGY_LOG)
        with topology.TopologyLog(p) as log:
            log.append({"kind": "plan", "epoch": 1, "plan": "p",
                        "ranges": [], "watermark": 0, "new_slots": []})
            log.append({"kind": "complete", "epoch": 2, "plan": "p"})
            with pytest.raises(ValueError, match="unknown topology"):
                log.append({"kind": "nope", "epoch": 3})
        recs, torn = topology.read_topology_log(p)
        assert [r["kind"] for r in recs] == ["plan", "complete"]
        assert torn is False

    def test_torn_tail_quarantined(self, tmp_path):
        p = os.path.join(str(tmp_path), topology.TOPOLOGY_LOG)
        with topology.TopologyLog(p) as log:
            log.append({"kind": "plan", "epoch": 1, "plan": "p",
                        "ranges": [], "watermark": 0, "new_slots": []})
            log.append({"kind": "complete", "epoch": 2, "plan": "p"})
        topology.tear_topology_tail(p)
        recs, torn = topology.read_topology_log(p)
        assert torn is True
        assert [r["kind"] for r in recs] == ["plan"]


class TestReshardFaultSpecs:
    def test_parse_every_mode(self):
        for i, mode in enumerate(faultinject.RESHARD_MODES):
            f = faultinject.parse_reshard(f"{mode}@range{i}")
            assert f.mode == mode and f.range == i

    @pytest.mark.parametrize("bad", ["kill_src", "boom@range0",
                                     "kill_src@r0", "wedge@range-1"])
    def test_malformed_specs_raise(self, bad):
        with pytest.raises(ValueError):
            faultinject.parse_reshard(bad)

    def test_env_accessor_fires_only_for_reshard_kind(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:kill@s0,batch3")
        assert faultinject.reshard_fault() is None
        monkeypatch.setenv(faultinject.ENV_FAULT,
                           "reshard:kill_dst@range1")
        f = faultinject.reshard_fault()
        assert f.mode == "kill_dst" and f.range == 1


# ---------------------------------------------------------------------------
# The tentpole: live resharding under traffic
# ---------------------------------------------------------------------------


def test_live_reshard_under_traffic_completes_and_recovers(
        tmp_path, clean_migration):
    cl = _migrated_run(tmp_path / "live", interleave=True)
    with cl:
        assert cl.migration_pending is False
        assert cl.edges_per_shard == clean_migration["edges_per_shard"]
        active = [n for n in cl.edges_per_shard if n > 0]
        assert sum(active) == PARAMS["n_feeds"]
        assert max(active) - min(active) <= 1
        topo = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)["topology"]
        assert topo["plans_completed"] == 1
        assert topo["ranges_migrated"] >= 1
        assert topo["epoch"] == cl.topology_epoch > 0
        assert cl.metrics.reconciles(cl.pending_by_shard)
        dig = cl.edge_digest()
    # topology epochs replay like param epochs: a recovered router
    # rebuilds owner/epoch/retired state bit-identically
    rec, _infos = serving.ServingCluster.recover(str(tmp_path / "live"),
                                                 device="cpu")
    with rec:
        assert rec.edge_digest() == dig
        assert rec.migration_pending is False
        assert rec.topology_epoch == cl.topology_epoch
        assert rec.edges_per_shard == clean_migration["edges_per_shard"]


def test_fresh_constructor_refuses_resharded_directory(tmp_path,
                                                       clean_migration):
    d = tmp_path / "refuse"
    _migrated_run(d).close()
    with pytest.raises(ValueError, match="recover"):
        serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")


def test_edge_digest_partition_and_epoch_independent(tmp_path):
    """Post-suppressed traffic (huge q → zero posts, so no shard-wide
    PRNG rank resets): an unmigrated 2-shard control and a live-migrated
    2→4 cluster land the SAME edge digest at the same seq — the digest
    sees feeds, not shards, and not topology epochs."""
    ctrl = serving.ServingCluster(dir=str(tmp_path / "ctrl"),
                                  **{**PARAMS, "q": 1e12}, device="cpu")
    _feed(ctrl, _batches(N_PRE + N_POST))
    mig = _migrated_run(tmp_path / "mig", q=1e12)
    with ctrl, mig:
        assert ctrl.applied_seq == mig.applied_seq
        assert ctrl.topology_epoch == 0 < mig.topology_epoch
        assert ctrl.edge_digest() == mig.edge_digest()


def test_untouched_shard_edges_bit_identical_to_control(tmp_path):
    """Posting couples rank SHARD-WIDE (a post resets every feed on the
    shard), so under q=1.0 the decision stream on edges of shards the
    plan never touched must stay bit-identical to an unmigrated
    control.  ``add_edges(1)`` migrates exactly one shard; the other
    three are the control group."""
    params = dict(PARAMS, n_shards=4)
    pre, post = _batches(N_PRE), _batches(N_POST, start_seq=N_PRE)
    ctrl = serving.ServingCluster(dir=str(tmp_path / "ctrl"), **params,
                                  device="cpu")
    churn = serving.ServingCluster(dir=str(tmp_path / "churn"), **params,
                                   device="cpu")
    _feed(ctrl, pre)
    _feed(churn, pre)
    before = churn.edges_per_shard[:4]
    new = churn.add_edges(1)
    assert new == [PARAMS["n_feeds"]]
    touched = [k for k in range(4) if churn.edges_per_shard[k] !=
               before[k]]
    assert len(touched) == 1
    _feed(ctrl, post)
    _feed(churn, post)
    with ctrl, churn:
        rank_c, health_c, *_ = ctrl._gather_edges()
        rank_m, health_m, *_ = churn._gather_edges()
        moved = np.flatnonzero(churn._owner[:PARAMS["n_feeds"]] ==
                               churn._owner[new[0]])
        untouched = np.setdiff1d(np.arange(PARAMS["n_feeds"]), moved)
        assert len(untouched) == PARAMS["n_feeds"] - before[touched[0]]
        np.testing.assert_array_equal(rank_c[untouched],
                                      rank_m[untouched])
        np.testing.assert_array_equal(health_c[:16], health_m[:16])


def test_begin_reshard_guards(tmp_path):
    cl = serving.ServingCluster(dir=str(tmp_path / "g"), **PARAMS,
                                device="cpu")
    with cl:
        _feed(cl, _batches(2))
        with pytest.raises(topology.TopologyError, match="only grows"):
            cl.begin_reshard(2)
        with pytest.raises(topology.TopologyError, match="no migration"):
            cl.resume_migration()


# ---------------------------------------------------------------------------
# Crash-safety: every reshard:* fault, resumed bit-identically
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["kill_src@range0", "kill_src@range1",
                                   "kill_dst@range0", "wedge@range0"])
def test_faulted_migration_lands_bit_identical(tmp_path, monkeypatch,
                                               clean_migration, fault):
    """SIGKILL of source or destination (or a wedged handoff)
    mid-migration: heal, resume from the last fenced range — the fenced
    digest is re-asserted — and the final cluster is bit-identical to
    the uninterrupted migration.  Zero acked records lost: the drain
    converges to the same applied seq."""
    cl = _migrated_run(tmp_path / "f", monkeypatch=monkeypatch,
                       fault=fault)
    with cl:
        assert cl.applied_seq == N_PRE + N_POST - 1
        assert cl.migration_pending is False
        assert cl.edge_digest() == clean_migration["edge_digest"]
        assert cl.edges_per_shard == clean_migration["edges_per_shard"]
        assert cl.metrics.reconciles(cl.pending_by_shard)


def test_kill_src_fences_traffic_then_retransmit_lands(tmp_path,
                                                       monkeypatch):
    """The fenced window made observable: between the source's death
    and the resumed flip, a NEW batch touching the fenced shard is
    refused with status "fenced" (never enters the ledgers — the
    accounting identity closes through the outage), and the SAME batch
    retransmitted after the flip applies normally."""
    d = tmp_path / "fence"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    monkeypatch.setenv(faultinject.ENV_FAULT, "reshard:kill_src@range0")
    mig = cl.begin_reshard(4)
    with pytest.raises(topology.MigrationInterrupted):
        mig.run()
    monkeypatch.delenv(faultinject.ENV_FAULT)
    # a batch on a feed the fenced SOURCE still owns (pre-flip)
    fenced_feed = int(mig.ranges[0]["feeds"][0])
    b = serving.EventBatch(
        N_PRE, np.asarray([N_PRE + 0.5], np.float64),
        np.asarray([fenced_feed], np.int32))
    adm = cl.submit(b)
    assert adm.status == "fenced"
    assert "fenced" in adm.reason
    assert adm.per_shard == ()  # refused BEFORE fan-out: no ledger entry
    assert cl.metrics.reconciles(cl.pending_by_shard)
    assert cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)["topology"]["fenced_retried"] == 1
    _heal_and_finish(cl)
    with cl:
        assert cl.submit(b).status == "accepted"  # the retransmit lands
        _drain(cl, [b])
        assert cl.applied_seq == N_PRE
        assert cl.metrics.reconciles(cl.pending_by_shard)


def test_router_death_after_fence_resumes_from_journal(tmp_path,
                                                       monkeypatch,
                                                       clean_migration):
    """Router death with a fence on disk: kill the source post-fence,
    then lose the ROUTER too (close everything).  Directory recovery
    replays the topology log — the plan is still pending, the fenced
    range re-asserts its journaled digest, and the resumed migration
    lands bit-identical to the uninterrupted run."""
    d = tmp_path / "router"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    monkeypatch.setenv(faultinject.ENV_FAULT, "reshard:kill_src@range1")
    mig = cl.begin_reshard(4)
    with pytest.raises(topology.MigrationInterrupted):
        mig.run()
    monkeypatch.delenv(faultinject.ENV_FAULT)
    cl.close()
    rec, _infos = serving.ServingCluster.recover(str(d), device="cpu")
    assert rec.migration_pending is True
    _heal_and_finish(rec)
    _feed(rec, _batches(N_POST, start_seq=N_PRE))
    with rec:
        assert rec.migration_pending is False
        assert rec.edge_digest() == clean_migration["edge_digest"]
        assert rec.applied_seq == N_PRE + N_POST - 1


def test_torn_plan_recovers_and_resumes(tmp_path, monkeypatch,
                                        clean_migration):
    """A torn topology-log tail (crash mid-append): recovery quarantines
    the torn record, the plan resumes from the last DURABLE range, and
    the result is still bit-identical."""
    d = tmp_path / "torn"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    monkeypatch.setenv(faultinject.ENV_FAULT, "reshard:torn_plan@range1")
    mig = cl.begin_reshard(4)
    with pytest.raises(topology.MigrationInterrupted):
        mig.run()
    monkeypatch.delenv(faultinject.ENV_FAULT)
    cl.close()
    rec, _infos = serving.ServingCluster.recover(str(d), device="cpu")
    assert rec.migration_pending is True
    _heal_and_finish(rec)
    _feed(rec, _batches(N_POST, start_seq=N_PRE))
    with rec:
        assert rec.edge_digest() == clean_migration["edge_digest"]


def test_wedge_counts_a_stall_then_same_driver_finishes(tmp_path,
                                                        monkeypatch):
    d = tmp_path / "wedge"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    monkeypatch.setenv(faultinject.ENV_FAULT, "reshard:wedge@range0")
    mig = cl.begin_reshard(4)
    with pytest.raises(topology.MigrationStalled):
        mig.run()
    assert cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)["topology"]["migration_stalls"] == 1
    assert mig.run() > 0  # the wedge is spent; same driver finishes
    with cl:
        assert cl.migration_pending is False


# ---------------------------------------------------------------------------
# Graph churn: add_edges / drop_edges, journaled + bit-identical recovery
# ---------------------------------------------------------------------------


def test_add_edges_under_traffic_and_recovery(tmp_path):
    d = tmp_path / "grow"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    new = cl.add_edges(3)
    assert new == [16, 17, 18]
    assert cl.n_feeds == 19
    active = [n for n in cl.edges_per_shard if n > 0]
    assert sum(active) == 19 and max(active) - min(active) <= 1
    # growth IS resharding: the old slots retired, their carry moved
    assert cluster_mod.RETIRED in cl.health_by_shard
    # traffic touching the NEW feeds is routable immediately
    b = serving.EventBatch(
        cl.applied_seq + 1,
        np.asarray([float(N_PRE) + 0.25, float(N_PRE) + 0.5], np.float64),
        np.asarray([16, 18], np.int32))
    assert cl.submit(b).status == "accepted"
    _drain(cl, [b])
    assert cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)["topology"]["edges_added"] == 3
    dig = cl.edge_digest()
    cl.close()
    rec, _infos = serving.ServingCluster.recover(str(d), device="cpu")
    with rec:
        assert rec.n_feeds == 19
        assert rec.edge_digest() == dig
        assert rec.edges_per_shard == cl.edges_per_shard


def test_drop_edges_rejects_traffic_and_recovers(tmp_path):
    d = tmp_path / "drop"
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    cl.drop_edges([2, 5])
    adm = cl.submit(serving.EventBatch(
        N_PRE, np.asarray([N_PRE + 0.25, N_PRE + 0.5], np.float64),
        np.asarray([2, 7], np.int32)))
    assert adm.status == "rejected"
    assert "dropped" in adm.reason
    with pytest.raises(topology.TopologyError, match="already dropped"):
        cl.drop_edges([5])
    assert cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)["topology"]["edges_dropped"] == 2
    assert sum(cl.edges_per_shard) == PARAMS["n_feeds"] - 2
    dig = cl.edge_digest()
    cl.close()
    rec, _infos = serving.ServingCluster.recover(str(d), device="cpu")
    with rec:
        assert rec.edge_digest() == dig
        adm = rec.submit(serving.EventBatch(
            N_PRE, np.asarray([N_PRE + 0.5], np.float64),
            np.asarray([5], np.int32)))
        assert adm.status == "rejected"


def test_drop_then_add_round_trips_the_digest_format(tmp_path):
    """Nothing dropped → the live-feed digest is byte-identical to the
    historical all-feeds format (the fixture digests in other modules
    must keep matching); dropping changes it, deterministically."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    a = serving.ServingCluster(dir=str(d1), **PARAMS, device="cpu")
    b = serving.ServingCluster(dir=str(d2), **PARAMS, device="cpu")
    _feed(a, _batches(N_PRE))
    _feed(b, _batches(N_PRE))
    with a, b:
        before = a.edge_digest()
        assert before == b.edge_digest()
        a.drop_edges([3])
        b.drop_edges([3])
        after = a.edge_digest()
        assert after == b.edge_digest()
        assert after != before  # a dropped edge leaves the digest


# ---------------------------------------------------------------------------
# Satellite: failed offline reshard leaves no destination behind
# ---------------------------------------------------------------------------


def test_failed_reshard_construction_removes_destination(tmp_path,
                                                         monkeypatch):
    """Regression: when the DESTINATION cluster's
    construction itself raises (not just digest divergence), the
    half-written destination directory must be removed before the error
    propagates — a later retry must not find a poisoned dst."""
    src = tmp_path / "src"
    cl = serving.ServingCluster(dir=str(src), **PARAMS, device="cpu")
    _feed(cl, _batches(N_PRE))
    cl.snapshot_all()
    cl.close()
    real = cluster_mod.ServingCluster._fresh_runtime
    calls = {"n": 0}

    def boom(self, slot):
        calls["n"] += 1
        if calls["n"] >= 2:  # let shard 0 open, fail on shard 1
            raise RuntimeError("constructor failure injected")
        return real(self, slot)

    monkeypatch.setattr(cluster_mod.ServingCluster, "_fresh_runtime",
                        boom)
    dst = tmp_path / "dst"
    with pytest.raises(RuntimeError, match="constructor failure"):
        serving.reshard(str(src), str(dst), 4, device="cpu")
    assert not os.path.exists(str(dst))
    monkeypatch.setattr(cluster_mod.ServingCluster, "_fresh_runtime",
                        real)
    rep = serving.reshard(str(src), str(dst), 4,
                          device="cpu")  # retry succeeds clean
    assert rep["verified"] is True


# ---------------------------------------------------------------------------
# The port against the JAX package on the same inputs
# ---------------------------------------------------------------------------

from redqueen_tpu import serving as jserving  # noqa: E402


@pytest.mark.parametrize("n_feeds,n_shards", [
    (1, 1), (5, 5), (7, 3), (16, 4), (33, 2), (1000, 7), (2048, 4),
    (4099, 16)])
def test_partition_and_shard_seed_match_the_reference(n_feeds, n_shards):
    np.testing.assert_array_equal(serving.partition(n_feeds, n_shards),
                                  jserving.partition(n_feeds, n_shards))
    for seed in (0, 1, 12345, 2 ** 31 - 2):
        assert [serving.shard_seed(seed, k) for k in range(n_shards)] == \
            [jserving.shard_seed(seed, k) for k in range(n_shards)]


def test_range_digest_and_planning_match_the_reference():
    rng = np.random.RandomState(3)
    for n in (0, 1, 17, 256):
        feeds = np.sort(rng.choice(10_000, n, replace=False))
        rank = rng.standard_normal(n).astype(np.float32)
        health = rng.randint(0, 4, n).astype(np.uint32)
        assert topology.range_digest(feeds, rank, health) == \
            jserving.range_digest(feeds, rank, health)
    owned = {k: np.arange(s) + 100 * k for k, s in enumerate((40, 41, 39))}
    for size in (None, 5):
        got = topology.plan_moves(owned, [3, 4], range_size=size)
        want = jserving.plan_moves(owned, [3, 4], range_size=size)
        assert {k: list(v) for k, v in got[0].items()} == \
            {k: list(v) for k, v in want[0].items()}
        assert got[1] == want[1]
    counts = {0: 40, 1: 41, 2: 39}
    assert topology.churn_assign(counts, 7) == \
        jserving.churn_assign(counts, 7)


def _live_migration(pkg, d, device_kw):
    """3 shards under traffic, a live 3 -> 4 grow with traffic between
    the handoff steps, then graph churn (add 3 edges, drop 2), more
    traffic, drained.  Returns the topology log's records, the edge
    digest and the cluster digest."""
    params = dict(n_feeds=24, n_shards=3, q=1.0, seed=6, snapshot_every=3,
                  reorder_window=8, queue_capacity=64)
    batches = pkg.synthetic_stream(6, 24, 24, events_per_batch=6)
    with pkg.ServingCluster(dir=d, **params, **device_kw) as cl:
        _feed(cl, batches[:6])
        mig = cl.begin_reshard(4)
        i = 6
        while not mig.done:
            mig.step()
            cl.submit(batches[i])
            cl.poll()
            i += 1
        _feed(cl, batches[:i])
        cl.add_edges(3)
        cl.drop_edges([3, 5])
        for b in batches[i:]:
            m = ~np.isin(b.feeds, [3, 5])
            cl.submit(pkg.EventBatch(b.seq, b.times[m], b.feeds[m]))
            cl.poll()
        cl.poll()
        records, torn = pkg.read_topology_log(
            os.path.join(d, pkg.TOPOLOGY_LOG))
        assert not torn
        return records, cl.edge_digest(), cl.cluster_digest(), \
            cl.health_by_shard


def test_live_migration_matches_the_reference(tmp_path):
    """``begin_reshard`` 3 -> 4 under traffic, then ``add_edges`` and
    ``drop_edges``: the same topology-log records, edge digest, cluster
    digest and shard health in both packages."""
    rj = _live_migration(jserving, str(tmp_path / "jax"), {})
    rt = _live_migration(serving, str(tmp_path / "torch"),
                         dict(device="cpu"))
    assert len(rt[0]) > 4
    assert rt[0] == rj[0]
    assert rt[1:] == rj[1:]
