"""The port's copy of the NumPy oracle
(``redqueen_tpu_torch/oracle/numpy_ref.py``) against the JAX package's
``redqueen_tpu/oracle/numpy_ref.py``: the same managers at the same seeds
give the same event dataframe, exactly (``pd.testing.assert_frame_equal``
with its default exact dtype and value checks: both are NumPy).  The
walls cover every kind the oracle has; the controlled broadcaster every
``create_manager_with_*`` factory."""

import numpy as np
import pandas as pd
import pytest

from redqueen_tpu.oracle import numpy_ref as ref
from redqueen_tpu_torch.oracle import numpy_ref as port

F, T = 4, 25.0


def walls(kind):
    """``other_sources`` for one wall per feed of ``kind`` ("mix": one of
    each kind)."""
    specs = {
        "poisson": ("poisson", dict(rate=1.0)),
        "poisson2": ("poisson2", dict(rate=0.8)),
        "hawkes": ("hawkes", dict(l_0=0.5, alpha=0.8, beta=2.0)),
        "piecewise": ("piecewiseconst",
                      dict(change_times=[0.0, 10.0], rates=[1.0, 0.3])),
        "realdata": ("realdata", dict(times=[1.0, 2.5, 6.0, 14.0, 22.0])),
    }
    kinds = (["poisson", "hawkes", "piecewise", "realdata"] if kind == "mix"
             else [kind] * F)
    out = []
    for i, k in enumerate(kinds):
        name, kw = specs[k]
        kw = dict(kw, src_id=100 + i, sink_ids=[i])
        if name != "realdata":
            kw["seed"] = 4000 + 10 * i
        out.append((name, kw))
    return out


def rmtpp_weights(hidden=8, seed=0):
    """A float64 weight tree in the flax layout, from numpy."""
    rng = np.random.RandomState(seed)
    g = {k: {"kernel": rng.randn(2, hidden) * 0.5, "bias": rng.randn(hidden)
             * 0.1} for k in ("ir", "iz", "in")}
    g.update({k: {"kernel": rng.randn(hidden, hidden) / np.sqrt(hidden)}
              for k in ("hr", "hz", "hn")})
    g["hn"]["bias"] = rng.randn(hidden) * 0.1
    return {"gru": g, "v": {"kernel": rng.randn(hidden, 1) * 0.3,
                            "bias": np.array([0.2])},
            "w": np.array(-0.05)}


CONTROLLED = {
    "opt": lambda so, seed: so.create_manager_with_opt(seed),
    "poisson": lambda so, seed: so.create_manager_with_poisson(seed, 1.5),
    "piecewise": lambda so, seed: so.create_manager_with_piecewise_const(
        seed, [0.0, 5.0, 15.0], [0.5, 2.0, 1.0]),
    "realdata": lambda so, seed: so.create_manager_with_times(
        [0.5, 3.0, 3.0, 9.5, 20.0]),
    "rmtpp": lambda so, seed: so.create_manager_with_rmtpp(
        seed, rmtpp_weights(), 8),
}


def frames(mod, wall_kind, ctrl, seed, q=1.0):
    so = mod.SimOpts(src_id=0, sink_ids=list(range(F)),
                     other_sources=walls(wall_kind), end_time=T, q=q)
    mgr = CONTROLLED[ctrl](so, seed)
    mgr.run_till()
    return mgr.state.get_dataframe()


@pytest.mark.parametrize("wall_kind,ctrl", [
    ("poisson", "opt"), ("hawkes", "opt"), ("mix", "opt"),
    ("poisson2", "opt"), ("piecewise", "poisson"), ("realdata", "opt"),
    ("poisson", "piecewise"), ("hawkes", "realdata"), ("poisson", "rmtpp"),
    ("mix", "rmtpp")])
@pytest.mark.parametrize("seed", [0, 7])
def test_dataframe_equals_the_reference_oracle(wall_kind, ctrl, seed):
    want = frames(ref, wall_kind, ctrl, seed)
    got = frames(port, wall_kind, ctrl, seed)
    assert len(got) > 20
    pd.testing.assert_frame_equal(got, want)


def test_broadcaster_seam_and_hawkes_controller():
    """``create_manager_with_broadcaster`` with a Hawkes broadcaster, and
    the RMTPP broadcaster's own draws, equal the reference's."""
    def run(mod):
        so = mod.SimOpts(src_id=0, sink_ids=list(range(F)),
                         other_sources=walls("poisson"), end_time=T)
        mgr = so.create_manager_with_broadcaster(
            mod.Hawkes(0, 3, l_0=0.7, alpha=0.5, beta=1.5))
        mgr.run_till()
        ob = mod.RMTPP(0, seed=11, weights=rmtpp_weights(4, 2), hidden=4)
        ob.h = np.linspace(-1, 1, 4)
        return mgr.state.get_dataframe(), [ob._sample_delta()
                                           for _ in range(50)]
    (dg, sg), (dw, sw) = run(port), run(ref)
    pd.testing.assert_frame_equal(dg, dw)
    assert sg == sw


def test_same_public_names_and_no_reexports():
    import redqueen_tpu_torch.oracle as pkg

    assert port.__all__ == ref.__all__
    assert [n for n in vars(pkg) if not n.startswith("__")] == ["numpy_ref"]
