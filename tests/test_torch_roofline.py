"""The port's ``utils.roofline``: the H100's peaks (NVIDIA's H100 SXM5
data sheet), the scan engine's traffic model on the port's own
``init_state`` (equal to the JAX package's for the same config), the
result-line fields, and the bounds of the smoke run's kernel rows built
on the same rates (``tests/test_roofline.py``'s cases).  Exact, or
pytest.approx where stated."""

import numpy as np
import pytest
import torch

import redqueen_tpu as J
import redqueen_tpu_torch as rt
from redqueen_tpu.utils import roofline as jroofline
from redqueen_tpu_torch.utils import roofline


def test_hbm_peak_lookup():
    assert roofline.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert roofline.hbm_peak_gbps("nvidia h100 80gb hbm3") == 3350.0
    # The table holds the card's peaks only: no TPU, no CPU denominator.
    for kind in ("TPU v4", "TPU v5p", "cpu", "", None):
        assert roofline.hbm_peak_gbps(kind) is None


def _component(pkg, n_followers=4, **kw):
    gb = pkg.GraphBuilder(n_sinks=n_followers, end_time=10.0)
    gb.add_opt(q=1.0)
    for i in range(n_followers):
        gb.add_poisson(rate=1.0, sinks=[i])
    return gb.build(capacity=64, **kw)


@pytest.mark.parametrize("slab", [1, 3])
def test_traffic_model_equals_the_references(slab):
    cj, pj, aj = _component(J)
    ct, pt, at = _component(rt, device="cpu")
    want = jroofline.scan_step_traffic_bytes(
        cj, *J.stack_components([pj] * slab, [aj] * slab))
    got = roofline.scan_step_traffic_bytes(
        ct, *rt.stack_components([pt] * slab, [at] * slab))
    assert got == want > 0
    # an unbatched component counts as one lane
    assert roofline.scan_step_traffic_bytes(ct, pt, at) == (
        want if slab == 1 else want // slab)


def test_traffic_model_scales_with_batch():
    cfg, p0, a0 = _component(rt, device="cpu")
    b1 = roofline.scan_step_traffic_bytes(
        cfg, *rt.stack_components([p0], [a0]))
    b4 = roofline.scan_step_traffic_bytes(
        cfg, *rt.stack_components([p0] * 4, [a0] * 4))
    assert b4 == 4 * b1


def test_pytree_nbytes_over_tensors_and_dataclasses():
    cfg, p0, a0 = _component(rt, device="cpu")
    want = sum(t.numel() * t.element_size() for t in
               (p0.kind, p0.rate, p0.l0, p0.alpha, p0.beta, p0.pw_times,
                p0.pw_rates, p0.rd_times, p0.q, p0.s_sink))
    assert roofline.pytree_nbytes(p0) == want
    assert roofline.pytree_nbytes({"a": [torch.zeros(3, 2),
                                         np.zeros(5, np.int32)]}) == 44


def test_roofline_fields_arithmetic():
    out = roofline.roofline_fields(1000, 0.5, 1_000_000, "cuda",
                                   "NVIDIA H100 80GB HBM3")
    assert out["steps"] == 1000
    assert out["step_ns"] == pytest.approx(0.5 / 1000 * 1e9)
    assert out["hbm_gbps"] == pytest.approx(2.0)
    assert out["hbm_peak_gbps"] == 3350.0
    assert out["hbm_frac"] == pytest.approx(2.0 / 3350.0, abs=1e-4)
    cpu = roofline.roofline_fields(1000, 0.5, 1_000_000, "cpu", "cpu")
    assert cpu["hbm_peak_gbps"] is None and cpu["hbm_frac"] is None
    assert roofline.roofline_fields(0, 0.5, 1, "cuda", "H100") == {}
    assert roofline.roofline_fields(10, float("inf"), 1, "cuda",
                                    "H100") == {}


def test_kernel_bounds_divide_by_the_roofline_rates():
    """The smoke run's bounds (event kernel, hawkes_pass, serving apply)
    are ``roofline.bound`` of their bytes and operations."""
    from redqueen_tpu_torch.smoke import serving
    from redqueen_tpu_torch.smoke.learn import corpus_bound

    b = roofline.bound(3.35e9, 1e9, 4e8)
    assert b["bytes_ms"] == pytest.approx(1.0)
    assert b["ops_ms"] == pytest.approx(max(1e9 / roofline.ISSUE_PER_S,
                                            4e8 / roofline.INT32_PER_S)
                                        * 1e3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert serving.apply_bound_ms(2048) == pytest.approx(
        20.0 * 2048 / 3.35e12 * 1e3)
    rng = np.random.RandomState(0)
    t = np.sort(rng.uniform(0, 50, 300))
    s = rt.learn.ingest.make_stream(t, rng.randint(0, 3, 300), 3,
                                    t_end=50.0)
    ch = rt.learn.chunk_events(s, chunk_size=128)
    cb = corpus_bound(ch)
    assert {k: cb[k] for k in ("bytes_ms", "ops_ms", "bound_ms",
                               "bound_by")} == roofline.bound(cb["bytes"],
                                                              cb["ops"])
