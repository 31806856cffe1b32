"""The port's BASELINE presets (``redqueen_tpu_torch/presets.py``) and the
synthetic trace corpus (``data/traces.py``) against the JAX package's on
the CPU, at small ``scale`` and the same seeds
(``jax_threefry_partitionable`` pinned to True).

Tolerances: events and posts identical; time-in-top-1 within rtol 1e-5
(the star engine's closed-form sums and the metrics pass in another
order); the synthetic corpus identical (the same numpy draws)."""

import numpy as np
import pytest

from redqueen_tpu import presets as jpresets
from redqueen_tpu.data import synthetic_twitter as j_synthetic_twitter
from redqueen_tpu_torch import presets
from redqueen_tpu_torch.config import ConfigValidationError
from redqueen_tpu_torch.data import pad_traces, synthetic_twitter
from torch_parity import autotune_cache, partitionable  # noqa: F401,E501  (autouse fixtures)

CASES = {
    # preset: (build kwargs, seeds)
    1: (dict(scale=1.0, end_time=8.0, capacity=128), np.arange(5)),
    2: (dict(scale=0.01, end_time=15.0, wall_cap=128, post_cap=512),
        np.array([3])),
    3: (dict(scale=0.005, end_time=8.0, capacity=128), np.array(2)),
    4: (dict(scale=0.0003, end_time=12.0, q=2.0, post_cap=512),
        np.array([1, 4])),
    "power_law": (dict(B=12, max_followers=16, end_time=4.0, seed=3),
                  np.array(5)),
}


def same_out(ot, oj):
    assert ot["events"] == oj["events"]
    np.testing.assert_array_equal(ot["per_seed_posts"], oj["per_seed_posts"])
    np.testing.assert_allclose(ot["per_seed_top_k"], oj["per_seed_top_k"],
                               rtol=1e-5)
    np.testing.assert_allclose(ot["mean_time_in_top_k"],
                               oj["mean_time_in_top_k"], rtol=1e-5)
    assert ot["end_time"] == oj["end_time"]


@pytest.mark.parametrize("which", list(CASES), ids=str)
def test_preset_matches_jax(which):
    kw, seeds = CASES[which]
    dev = {} if which == "power_law" else dict(device="cpu")
    bj = jpresets.build_preset(which, **kw)
    bt = presets.build_preset(which, **kw, **dev)
    assert bt[0] == bj[0]
    oj = jpresets.run_preset(bj, seeds)
    ot = presets.run_preset(bt, seeds, device="cpu")
    same_out(ot, oj)
    assert ot["events"] > 0


def test_config3_lanes_equal_config1_seeds():
    """Config 3 is config 1's component batched: per seed, the same
    results bit for bit."""
    kw = dict(end_time=8.0, capacity=128, device="cpu")
    o3 = presets.run_preset(presets.build_preset(3, scale=0.004, **kw), 0,
                            device="cpu")
    o1 = presets.run_preset(presets.build_preset(1, **kw), np.arange(4),
                            device="cpu")
    assert o3["per_seed_top_k"] == o1["per_seed_top_k"]
    assert o3["per_seed_posts"] == o1["per_seed_posts"]


def test_star_preset_one_seed_equals_its_batch_lane():
    b = presets.build_preset(2, scale=0.01, end_time=10.0, wall_cap=128,
                             post_cap=512, device="cpu")
    one = presets.run_preset(b, [7], device="cpu")
    two = presets.run_preset(b, [5, 7], device="cpu")
    assert one["per_seed_top_k"][0] == two["per_seed_top_k"][1]
    assert one["per_seed_posts"][0] == two["per_seed_posts"][1]


def test_synthetic_twitter_and_padding_equal_jax():
    a = synthetic_twitter(7, 30, 20.0, max_len=16)
    b = j_synthetic_twitter(7, 30, 20.0, max_len=16)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    padded, lens = pad_traces(a)
    assert padded.shape == (30, max(lens.max(), 1))
    with pytest.raises(ValueError, match="refusing to truncate"):
        pad_traces(a, length=int(lens.max()) - 1)


@pytest.mark.parametrize("bad", [
    dict(B=1.5), dict(B=True), dict(B=0), dict(B=10, alpha=0.0),
    dict(B=10, alpha=float("nan")), dict(B=10, max_followers=1),
    dict(B=10, min_followers=0), dict(B=10, min_followers=8,
                                      max_followers=4)])
def test_power_law_validation(bad):
    with pytest.raises(ConfigValidationError):
        presets.build_preset("power_law", **bad)


def test_power_law_counts_equal_jax_and_config5_names_its_item():
    _, ct, _ = presets.build_preset("power_law", B=100, seed=5)
    _, cj, _ = jpresets.build_preset("power_law", B=100, seed=5)
    np.testing.assert_array_equal(ct, cj)
    # Config 5 builds now (ported with the RMTPP policy): a batch bundle
    # whose component is one RMTPP row against Poisson walls.
    b5 = presets.build_preset(5, scale=0.2, hidden=4, train_steps=2,
                              capacity=32, device="cpu")
    assert b5[0] == "batch" and b5[1].present_kinds == (0, 5)
    with pytest.raises(KeyError, match="unknown preset"):
        presets.build_preset("nope")
    # A ragged bundle does not shard: the JAX package's ValueError, before
    # the mesh is looked at.
    with pytest.raises(ValueError, match="ragged presets dispatch through "
                       "parallel.lanes.simulate_ragged, which does not "
                       "shard over a mesh yet"):
        presets.run_preset(("ragged", ct, {}), 0, mesh=object(),
                           device="cpu")


def test_batch_lanes_seeds_and_metrics():
    """``batch_lanes`` stacks a single component once per seed, takes a
    scalar base seed for a stacked bundle and refuses a wrong count;
    ``batch_metrics`` gives the per-lane values ``run_preset`` reports."""
    import torch

    from redqueen_tpu_torch.sim import simulate_batch

    bundle = presets.build_preset(1, end_time=6.0, capacity=64,
                                  device="cpu")
    cfg, params, adj, row, seeds = presets.batch_lanes(bundle, [4, 9],
                                                       "cpu")
    assert params.kind.shape[0] == 2 and list(seeds) == [4, 9]
    stacked = ("batch", cfg, params, adj, row)
    assert list(presets.batch_lanes(stacked, np.array(3), "cpu")[4]) == [3, 4]
    with pytest.raises(ValueError, match="one per component"):
        presets.batch_lanes(stacked, [1, 2, 3], "cpu")
    log = simulate_batch(cfg, params, adj, seeds, device="cpu")
    top, posts, nev = presets.batch_metrics(log, adj, row, cfg.end_time)
    out = presets.run_preset(bundle, [4, 9], device="cpu")
    assert out["events"] == int(nev.sum())
    assert out["per_seed_posts"] == posts.double().tolist()
    assert out["per_seed_top_k"] == top.double().tolist()
    assert isinstance(top, torch.Tensor) and top.shape == (2,)


def test_config5_data_is_the_references_fit_data():
    """Config 5's fit data: the reference preset's ``RandomState(seed)``
    draw of 32 x 24 Exp(mean 0.7) gaps, all valid."""
    for seed in (0, 5):
        taus, mask = presets.config5_data(seed)
        want = np.random.RandomState(seed).exponential(0.7, (32, 24))
        np.testing.assert_array_equal(taus, want.astype(np.float32))
        assert taus.dtype == np.float32 and mask.dtype == bool
        assert mask.shape == (32, 24) and mask.all()
