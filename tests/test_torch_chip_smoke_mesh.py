"""``chip_smoke.py`` phase 13 (the mesh layer) rehearsed on the CPU at a
tiny size through the same code the card runs, with the checks it makes
there: a world of one rank (gloo here, NCCL on the card) equal to the
unsharded scan run with no event-kernel launch, then two child ranks
started with the ``RQ_*`` environment: the gathered headline equal to
the world of one's by digest, the sharded sweep, config 4 over the feed
axis, config 2 over lanes and lanes x feeds and config 1's preset equal
to the unsharded runs; the comparison's failures shown on crafted
inputs."""

import numpy as np
import pytest
import torch

import chip_smoke
from redqueen_tpu_torch.smoke import mesh as M
from redqueen_tpu_torch.sweep import SweepResult

CPU = torch.device("cpu")
SMALL = dict(headline_B=8, T=10.0, sweep_seeds=2,
             preset1=dict(scale=0.5, end_time=10.0, capacity=64),
             preset1_seeds=4,
             preset2=dict(scale=0.008, end_time=12.0, wall_cap=256,
                          post_cap=512), preset2_seeds=2,
             preset4=dict(scale=0.001, end_time=100.0, q=2.5,
                          post_cap=4096))


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    return M.phase_mesh(CPU, SMALL)


def test_chip_smoke_runs_phase_13():
    assert chip_smoke.phase_mesh is M.phase_mesh


def test_world_of_one_matches_the_unsharded_scan_run(phase):
    a = phase["world_of_one"]
    assert a["backend"] == "gloo" and a["lanes"] == 8 and a["events"] > 0
    assert a["launches"] == {"event_kernel": 0, "pallas": 0}
    # one agreement all-reduce a sharded run, two sharded runs
    assert a["collectives"]["pmax"][0] == 2
    assert len(a["plain_s"]) == len(a["sharded_s"]) == 2


def test_two_ranks_agree_with_the_unsharded_runs(phase):
    assert [r["summary"]["process_index"] for r in phase["ranks"]] == [0, 1]
    for r in phase["ranks"]:
        assert r["summary"]["process_count"] == 2
        assert r["summary"]["backend"] == "gloo"
        assert r["event_kernel_launches"] == 0
    assert phase["pmin_count"] > 0 and phase["pmin_mean_us"] > 0
    assert 0 <= phase["c4_fires_local_s"] <= phase["c4_fires_s"]
    assert phase["launches"] == {"event_kernel": 0, "hawkes_pass": 0}


def _refs():
    grid = SweepResult(*(np.zeros((2, 2), np.float32) for _ in range(5)))
    star = {"own_times": np.arange(3.0), "n_posts": np.array(3),
            "mean": np.array([1.0])}
    return {"sweep": grid, "c4": star, "c2": dict(star),
            "c1": {"events": 5}}


def _got(refs, digest="d"):
    g = {"headline_digest": np.array(digest), "c1_json": np.array(
        '{"events": 5}')}
    g.update({f"sweep_{f}": getattr(refs["sweep"], f)
              for f in SweepResult._fields})
    g.update({f"c4_{k}": v for k, v in refs["c4"].items()})
    for name in ("data", "feed"):
        g.update({f"c2_{name}_{k}": v for k, v in refs["c2"].items()})
    return g


def test_compare_accepts_equal_and_fails_on_any_difference(monkeypatch):
    refs = _refs()
    assert M.compare(_got(refs), refs, "d", SMALL)["c1_events"] == 5
    failures = []

    def fail(msg):
        failures.append(msg)
        raise RuntimeError(msg)

    monkeypatch.setattr(M, "check", lambda ok, msg: ok or fail(msg))
    for mutate in (
            lambda g: g.update(headline_digest=np.array("other")),
            lambda g: g["sweep_n_posts"].__setitem__((0, 0), 1),
            lambda g: g.update(c4_own_times=np.array([0.0, 1.0,
                                                      np.nextafter(2, 3)])),
            lambda g: g.update(c2_feed_n_posts=np.array(4)),
            lambda g: g.update(c1_json=np.array('{"events": 6}'))):
        g = _got(_refs())
        mutate(g)
        with pytest.raises(RuntimeError):
            M.compare(g, refs, "d", SMALL)
    assert len(failures) == 5


def test_a_failing_rank_fails_the_phase():
    """Config 4 with 101 feeds does not divide over two ranks: both ranks
    raise, and the phase exits non-zero instead of passing on one."""
    bad = dict(SMALL, preset4=dict(SMALL["preset4"], scale=0.00101))
    with pytest.raises(SystemExit) as e:
        M.phase_mesh(CPU, bad)
    assert e.value.code == 1
