"""Property-based invariants for the port's elastic-topology planning
math (case for case the JAX package's
``tests/test_topology_properties.py``): partition balance stays within
±1 through arbitrary add/drop churn, and the range/edge digests are pure functions
of the edge slice — independent of which shard holds it and of the
topology epoch that moved it.

Pure host math (no clusters, no device work) so hypothesis can afford
hundreds of examples; the deterministic companions that drive REAL
clusters through the same claims live in test_torch_topology.py
(``test_edge_digest_partition_and_epoch_independent``,
``TestPlanMath``).
"""

import numpy as np
import pytest

# Without the dependency the whole module skips AT COLLECTION (a skip,
# not an error — tier-1 must collect clean on minimal containers).
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from redqueen_tpu_torch.serving import topology  # noqa: E402
from redqueen_tpu_torch.serving.cluster import partition  # noqa: E402

n_feeds_st = st.integers(2, 200)
n_shards_st = st.integers(1, 12)


@settings(max_examples=200, deadline=None)
@given(n_feeds=n_feeds_st, n_shards=n_shards_st)
def test_splitmix64_partition_balanced_within_one(n_feeds, n_shards):
    if n_shards > n_feeds:
        n_shards = n_feeds
    assign = partition(n_feeds, n_shards)
    counts = np.bincount(assign, minlength=n_shards)
    assert counts.sum() == n_feeds
    assert counts.max() - counts.min() <= 1


@settings(max_examples=100, deadline=None)
@given(n_feeds=st.integers(4, 120), n_shards=st.integers(1, 6),
       churn=st.lists(st.tuples(st.booleans(), st.integers(1, 9)),
                      max_size=12),
       grow_to=st.integers(1, 4))
def test_balance_preserved_through_arbitrary_churn(n_feeds, n_shards,
                                                   churn, grow_to):
    """Arbitrary interleaved add/drop churn (adds dealt by
    ``churn_assign``, drops peeled from the currently-largest shard —
    the worst case for balance), then a grow-plan over the survivors:
    ``plan_moves``'s post-migration shard sizes are ±1 balanced, cover
    every live feed exactly once, and existing shards only SHED."""
    if n_shards > n_feeds:
        n_shards = n_feeds
    assign = list(partition(n_feeds, n_shards))
    owned = {k: [f for f, a in enumerate(assign) if a == k]
             for k in range(n_shards)}
    next_feed = n_feeds
    for is_add, n in churn:
        counts = {k: len(v) for k, v in owned.items()}
        if is_add:
            for k in topology.churn_assign(counts, n):
                owned[k].append(next_feed)
                next_feed += 1
            # churn_assign fills least-loaded first: adding never
            # widens the spread beyond the pre-churn spread (and a
            # balanced start stays within ±1)
            sizes = [len(v) for v in owned.values()]
            assert max(sizes) - min(sizes) <= max(
                max(counts.values()) - min(counts.values()), 1)
        else:
            for _ in range(n):
                k = max(owned, key=lambda i: (len(owned[i]), -i))
                if len(owned[k]) > 1:
                    owned[k].pop()
    total = sum(len(v) for v in owned.values())
    new_ids = [n_shards + i for i in range(grow_to)]
    if total < n_shards + grow_to:
        return  # too narrow to grow — begin_reshard refuses this too
    arrs = {k: np.asarray(sorted(v), np.int64)
            for k, v in owned.items()}
    try:
        new_feeds, ranges = topology.plan_moves(arrs, new_ids)
    except topology.TopologyError:
        return  # surplus cannot seed every new shard — refused, not bad
    moved = sorted(f for r in ranges for f in r["feeds"])
    assert len(moved) == len(set(moved))  # each feed moves at most once
    kept = {k: [f for f in arrs[k] if f not in set(moved)]
            for k in arrs}
    sizes = ([len(v) for v in kept.values()]
             + [len(new_feeds[k]) for k in new_ids])
    assert sum(sizes) == total
    assert max(sizes) - min(sizes) <= 1
    for k in arrs:  # shed-only, and always a prefix of the ascending set
        assert kept[k] == [int(f) for f in arrs[k][:len(kept[k])]]
    assert sorted(f for k in new_ids for f in new_feeds[k]) == moved


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_range_digest_partition_and_epoch_independent(data):
    """The digest binds (feeds, rank, health) and NOTHING else: however
    the slice is split across shards (concatenating per-shard slices in
    feed order) and whatever epoch the records carry, the digest of the
    reassembled slice equals the digest of the whole — and any
    single-element perturbation changes it."""
    n = data.draw(st.integers(1, 40))
    feeds = data.draw(st.lists(st.integers(0, 10**6), min_size=n,
                               max_size=n, unique=True))
    feeds = np.asarray(sorted(feeds), np.int64)
    rank = np.asarray(
        data.draw(st.lists(st.floats(0.0, 1e6, allow_nan=False,
                                     width=32),
                           min_size=n, max_size=n)), np.float32)
    health = np.asarray(
        data.draw(st.lists(st.integers(0, 3), min_size=n, max_size=n)),
        np.uint32)
    whole = topology.range_digest(feeds, rank, health)
    # shard-split invariance: digest of the feed-order reassembly of an
    # arbitrary partition equals the digest of the whole slice
    n_shards = data.draw(st.integers(1, min(4, n)))
    assign = partition(n, n_shards)
    gathered_rank = np.zeros(n, np.float32)
    gathered_health = np.zeros(n, np.uint32)
    for k in range(n_shards):
        sel = np.flatnonzero(assign == k)
        gathered_rank[sel] = rank[sel]
        gathered_health[sel] = health[sel]
    assert topology.range_digest(feeds, gathered_rank,
                                 gathered_health) == whole
    # sensitivity: one flipped element anywhere is a different slice
    i = data.draw(st.integers(0, n - 1))
    assert topology.range_digest(feeds, rank, health + np.eye(
        1, n, i, dtype=np.uint32)[0]) != whole
