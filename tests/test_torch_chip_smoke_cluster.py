"""``chip_smoke.py`` phase 11 (the serving cluster) rehearsed on the CPU
at small sizes, through the same functions the card runs: the placements'
agreement and accounting, the ``nvidia-smi`` context check fed the
container's form of its output, the kill-one-worker reconvergence, the
offline and live reshards, the card-against-CPU gate (and its failure on
a decision that differs far from a near-tie), and the fit read from the
shard journals."""

import pytest

import chip_smoke


@pytest.fixture
def no_fault(monkeypatch):
    monkeypatch.delenv("RQ_FAULT", raising=False)
    monkeypatch.delenv("RQ_FAULT_POINT", raising=False)


def test_phase11a_placements_agree_and_reconcile(no_fault):
    from redqueen_tpu_torch.smoke import cluster as cs

    batches = cs.bench_stream(256, 96)
    ip = chip_smoke.cluster_bench("cpu", "in-process", 4, batches,
                                  n_feeds=256)
    sk = chip_smoke.cluster_bench("cpu", "sockets", 4, batches, n_feeds=256)
    assert sk["digest"] == ip["digest"] and len(sk["worker_pids"]) == 4
    for r in (ip, sk):
        assert r["reconciles"] and r["applied_seq"] == 96 + 8 - 1
        assert r["events_per_s"] > 0 and r["p99_ms"] is not None
    assert sk["durability"]["tier"] == "quorum"


def test_phase11a_context_check_reads_nvidia_smi(monkeypatch):
    """The container form of ``nvidia-smi --query-compute-apps``: every
    context under one foreign pid.  The count must cover the workers, and
    each worker must hold the card's device node."""
    from redqueen_tpu_torch.smoke import cluster as cs

    class Out:
        returncode, stderr = 0, ""

        def __init__(self, n):
            self.stdout = "1, 2456 MiB\n" * n

    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: Out(4))
    monkeypatch.setattr(cs, "_device_nodes", lambda p: ["/dev/nvidia0"])
    got = chip_smoke.card_contexts([11, 12, 13, 14])
    assert got["method"] == "count" and got["contexts"] == 4
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: Out(3))
    with pytest.raises(SystemExit):
        chip_smoke.card_contexts([11, 12, 13, 14])
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: Out(4))
    monkeypatch.setattr(cs, "_device_nodes", lambda p: [])
    with pytest.raises(SystemExit):
        chip_smoke.card_contexts([11, 12, 13, 14])


def test_phase11c_kill_one_worker_reconverges(no_fault):
    from redqueen_tpu_torch.smoke import cluster as cs

    batches = cs.bench_stream(256, 64)
    want = chip_smoke.cluster_bench("cpu", "in-process", 4, batches,
                                    n_feeds=256)["digest"]
    out = chip_smoke.kill_one_worker("cpu", batches, want, n_feeds=256)
    assert out["crashes"] == 1 and out["reconciles"]
    assert out["replayed"] > 0 and out["mttr_reconverge_ms"] > 0
    assert out["shed_unavailable"] > 0


def test_phase11d_reshard_offline_and_live(no_fault):
    out = chip_smoke.reshard_checks("cpu", n_feeds=256, n_batches=64)
    assert out["offline"]["edges_per_shard"] == [128, 128]
    assert out["live"]["n_shards"] == 4 and out["live"]["ranges"] > 0
    assert {"plan", "add_slot", "fence", "flip", "complete"} <= \
        set(out["record_kinds"])


def test_phase11e_cross_gate(no_fault, monkeypatch):
    out = chip_smoke.cluster_card_against_cpu("cpu", n_feeds=256,
                                              n_batches=48)
    assert out["near_ties"] == [] and out["final_digests_equal"]
    assert 0 < out["posts"] < out["decisions"]
    # a device whose decisions differ far from a near-tie fails the run
    from redqueen_tpu_torch.serving import cluster as cmod

    real = cmod.ServingCluster.poll
    calls = []

    def flip(self, *a, **k):
        out = real(self, *a, **k)
        calls.append(1)
        if len(calls) % 2:
            out = {k: [d._replace(post=not d.post) for d in v]
                   for k, v in out.items()}
        return out

    monkeypatch.setattr(cmod.ServingCluster, "poll", flip)
    with pytest.raises(SystemExit):
        chip_smoke.cluster_card_against_cpu("cpu", n_feeds=256,
                                            n_batches=8)


def test_phase11f_fit_from_shard_journals(no_fault):
    out = chip_smoke.fit_from_journals("cpu", D=8, t_end=300.0)
    assert out["launches"] == 0 and out["iters"] == 5
    assert max(out["gaps"].values()) == 0.0
