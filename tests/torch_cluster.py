"""Shared pieces of the port's cluster tests against the JAX package's
``redqueen_tpu.serving`` cluster layer: one stream through both
packages' ``ServingCluster`` (the port's on the CPU), and the per-shard
decision comparison with the near-tie rule of ``torch_serving``.

A shard's decision stream is a pure function of its key
(``PRNGKey(shard_seed(seed, k))``) and the global stream, so a batch
whose post flips between the packages must be a near-tie of that
shard's draw: ``|u - p_post| <= 1e-5 p_post`` with ``p_post = 1 -
exp(-lam dt)``, ``dt`` the shard clock's advance over the batch."""

import os

import numpy as np

from redqueen_tpu import serving as J
from redqueen_tpu_torch import serving as T
from redqueen_tpu_torch.ops import prng
from torch_serving import LAM_RTOL, MAX_NEAR_TIE_SHARE, near_tie

# q at which about one shard decision in six posts on the synthetic
# streams below (a shard sees a quarter of each batch's events).
Q_CLUSTER = 1.0


def serve_cluster(cl, batches, poll_every=1, rounds=8):
    """Submit ``batches`` (polling every ``poll_every``), then retransmit
    everything past the applied position until the cluster converges."""
    for i, b in enumerate(batches):
        cl.submit(b)
        if (i + 1) % poll_every == 0:
            cl.poll()
    for _ in range(rounds):
        cl.poll()
        missing = [b for b in batches if int(b.seq) > cl.applied_seq]
        if not missing:
            break
        for b in missing:
            cl.submit(b)
            cl.poll()
    cl.poll()


def shard_key(seed, k):
    """Shard ``k``'s decision key words (threefry, uint32 as int)."""
    key = prng.PRNGKey(J.shard_seed(seed, k))
    return [int(w) for w in key.tolist()]


def compare_shard_decisions(dj, dt, key):
    """Decisions of one shard in both packages: equal seqs and clocks,
    intensities within LAM_RTOL, posts equal but for near-ties.  Returns
    the number of near-ties."""
    assert [d.seq for d in dj] == [d.seq for d in dt]
    assert [d.post_time for d in dj] == [d.post_time for d in dt]
    np.testing.assert_allclose([d.intensity for d in dt],
                               [d.intensity for d in dj], rtol=LAM_RTOL)
    ties, t_prev = 0, 0.0
    for a, b in zip(dj, dt):
        if a.post != b.post:
            assert near_tie(key, a.seq, a.intensity,
                            float(a.post_time) - t_prev), a.seq
            ties += 1
        t_prev = float(a.post_time)
    return ties


def compare_clusters(cj, ct, seed):
    """Both clusters' per-shard journal decisions (near-ties counted, at
    most MAX_NEAR_TIE_SHARE of them) and digests: a shard without a
    near-tie has the reference's digest, and with no near-tie anywhere
    the cluster and edge digests are the reference's too.  Returns the
    near-tie count."""
    assert cj.n_shards == ct.n_shards
    dig_j, dig_t = cj.shard_digests(), ct.shard_digests()
    ties, n = 0, 0
    for k, (sj, st) in enumerate(zip(cj.shard_dirs, ct.shard_dirs)):
        dj, dt = J.journal_decisions(sj), T.journal_decisions(st)
        t = compare_shard_decisions(dj, dt, shard_key(seed, k))
        if t == 0:
            assert dig_t[k] == dig_j[k], k
        ties += t
        n += len(dj)
    assert n > 0
    assert ties <= MAX_NEAR_TIE_SHARE * n
    if ties == 0:
        assert ct.cluster_digest(dig_t) == cj.cluster_digest(dig_j)
        assert ct.edge_digest() == cj.edge_digest()
    return ties


def posts(cl):
    """How many decisions of the cluster's journals posted."""
    return sum(d.post for sd in cl.shard_dirs
               for d in T.journal_decisions(sd))


def shard_dirs(root):
    return sorted(d for d in os.listdir(root) if d.startswith("shard-"))
