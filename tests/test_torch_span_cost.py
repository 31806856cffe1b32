"""The traced-batch analysis of ``smoke/span_cost.py`` on synthetic
records: the innermost-span timeline, the idle stretches of a window,
idle time put down to spans (and to no span where none is open), device
operations matched to their launch records through correlation ids, and
the counts a traced batch reports from them.  A real batch's spans on
the CPU make a timeline that covers each root span exactly."""

import numpy as np
import pytest
from torch.autograd import DeviceType

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.runtime import telemetry as T
from redqueen_tpu_torch.smoke import span_cost as sc


def _span(name, a, b, sid, parent=None, **attrs):
    d = {"tid": "t", "sid": sid, "name": name, "t_ns": a,
         "t": round(a / 1e9, 6), "dur": (b - a) / 1e9}
    if parent is not None:
        d["parent"] = parent
    if attrs:
        d["attrs"] = attrs
    return d


class _Ev:
    """A profiler record as ``kineto_results.events()`` yields it."""

    def __init__(self, name, on_device, start, dur, corr):
        self._n, self._d, self._s, self._u, self._c = (
            name, on_device, start, dur, corr)

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


NESTED = [_span("root", 0, 100, 1), _span("a", 10, 40, 2, 1),
          _span("g", 20, 30, 3, 2), _span("b", 50, 90, 4, 1)]


def test_innermost_timeline_of_nested_spans():
    assert sc.innermost(NESTED) == [
        (0, 10, "root"), (10, 20, "a"), (20, 30, "g"), (30, 40, "a"),
        (40, 50, "root"), (50, 90, "b"), (90, 100, "root")]


def test_innermost_cuts_a_child_at_its_parents_end_and_skips_gaps():
    spans = [_span("p", 0, 10, 1), _span("c", 5, 12, 2, 1),
             _span("q", 20, 30, 3)]
    assert sc.innermost(spans) == [(0, 5, "p"), (5, 10, "c"),
                                   (20, 30, "q")]


def test_idle_intervals_of_a_window():
    device = [("k", 5, 15), ("k", 12, 20), ("k", 60, 70), ("k", 95, 140)]
    assert sc.idle_intervals(device, 0, 100) == [(0, 5), (20, 60),
                                                 (70, 95)]
    assert sc.idle_intervals([], 3, 9) == [(3, 9)]


def test_idle_by_span_splits_a_gap_across_stages_and_no_span():
    segments = sc.innermost(NESTED + [_span("late", 150, 160, 5)])
    idle = [(5, 25), (95, 155), (170, 180)]
    got = sc.idle_by_span(idle, segments)
    assert got == pytest.approx({
        "root": 10e-9, "a": 10e-9, "g": 5e-9, sc.NO_SPAN: 60e-9,
        "late": 5e-9})
    assert list(got)[0] == sc.NO_SPAN   # largest first


def test_device_operations_meet_their_launches_by_correlation_id():
    events = [
        _Ev("cudaLaunchKernel", False, 100, 5, 7),
        _Ev("kernel_a", True, 300, 50, 7),
        _Ev("cudaMemcpyAsync", False, 120, 5, 8),
        _Ev("cuLaunchKernel", False, 110, 3, 8),
        _Ev("Memcpy HtoD", True, 400, 10, 8),
        _Ev("kernel_orphan", True, 500, 10, 9),   # no launch record
        _Ev("cudaStreamSynchronize", False, 600, 9, 10),
    ]
    device, launches = sc.profiler_records(events)
    assert device == [("kernel_a", 300, 350), ("Memcpy HtoD", 400, 410),
                      ("kernel_orphan", 500, 510)]
    assert launches == {0: 100, 1: 110}


def test_launched_inside_counts_by_span_and_kernel_name():
    spans = [_span("step", 0, 100, 1), _span("step", 200, 300, 2)]
    device = [("event_kernel", 0, 1), ("other", 0, 1),
              ("event_kernel", 0, 1), ("event_kernel", 0, 1)]
    launches = {0: 50, 1: 150, 2: 250, 3: 300}
    assert sc.launched_inside(launches, spans, "step") == (2, 4)
    assert sc.launched_inside(launches, spans, "step", device,
                              "event_kernel") == (2, 3)
    assert sc.launched_inside(launches, [], "step") == (0, 4)


def _scan_batch():
    """A scan batch's spans: two steps in the drive, then a metrics pass
    of three columns, and six device operations."""
    spans = [
        _span("sim.simulate_batch", 0, 1000, 1, engine="scan", lanes=2),
        _span("sim.checks", 0, 100, 2, 1),
        _span("engine.scan.drive", 100, 900, 3, 1),
        _span("scan.step", 200, 300, 4, 3),
        _span("scan.panel", 210, 240, 5, 4),
        _span("scan.step", 400, 500, 6, 3),
        _span("metrics.feed", 1000, 1400, 7, columns=3),
        _span("metrics.feed.loop", 1100, 1400, 8, 7),
    ]
    # Launches at 220 and 250 (first step), 450 (second), 600 (in the
    # drive, outside a step), 1200 and 1300 (the loop).
    device = [("k", 700 + i, 701 + i) for i in range(6)]
    launches = dict(enumerate([220, 250, 450, 600, 1200, 1300]))
    return spans, device, launches


def test_attribution_of_a_scan_batch():
    spans, device, launches = _scan_batch()
    a = sc.attribution(spans, device, launches, 0, 1500)
    assert a["scan_steps"] == 2 and a["metrics_columns"] == 3
    assert a["scan_launches_per_step"] == 1.5
    assert a["scan_launches_per_step_by_stage"] == {
        "scan.panel": 0.5, "scan.fire": 0.0, "scan.react": 0.0}
    assert a["metrics_launches_per_column"] == pytest.approx(2 / 3)
    assert a["simulate_outside_engine_ms"] == pytest.approx(200e-6)
    assert "event_kernel_launches" not in a
    # Idle: [0, 700) and [706, 1500); the device ran 6 ns.
    assert a["idle_pct"] == pytest.approx(100 * 1494 / 1500)
    by = a["idle_by_span"]
    assert by["sim.checks"] == pytest.approx(100e-9)
    assert by["scan.panel"] == pytest.approx(30e-9)
    assert by["metrics.feed.loop"] == pytest.approx(300e-9)
    assert by[sc.NO_SPAN] == pytest.approx(100e-9)
    # Self time of the two calls: simulate [900, 1000), metrics.feed
    # [1000, 1100).
    assert by["sim.simulate_batch"] == pytest.approx(100e-9)
    assert a["idle_in_call_self_pct"] == pytest.approx(100 * 200 / 1494)


def test_attribution_checks_event_kernel_launches_against_their_spans():
    spans = [
        _span("sim.simulate_batch", 0, 1000, 1, engine="fused", lanes=2),
        _span("engine.pallas.run", 100, 800, 2, 1),
        _span("engine.pallas.launch", 100, 200, 3, 2),
        _span("engine.pallas.launch", 400, 500, 4, 2),
    ]
    device = [("void event_kernel(Params, ...)", 210, 390),
              ("event_kernel", 510, 600), ("cat", 810, 820)]
    launches = {0: 150, 1: 550, 2: 805}
    a = sc.attribution(spans, device, launches, 0, 1000)
    assert a["event_kernel_launches"] == {"inside_launch_span": 1, "of": 2}
    assert a["simulate_outside_engine_ms"] == pytest.approx(300e-6)
    assert "scan_launches_per_step" not in a


def test_attribution_without_launch_records_leaves_the_counts_out():
    spans, device, _ = _scan_batch()
    a = sc.attribution(spans, device, {}, 0, 1500)
    assert a["launch_records"] == 0
    for k in ("scan_launches_per_step", "metrics_launches_per_column"):
        assert k not in a


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_a_cpu_batchs_timeline_covers_each_root_exactly(engine):
    gb = rt.GraphBuilder(n_sinks=3, end_time=2.0)
    gb.add_poisson(rate=2.0)
    opt = gb.add_opt(q=1.0)
    cfg, p, adj = gb.build(capacity=16, device="cpu")
    P, A = rt.stack_components([p] * 3, [adj] * 3)
    T.configure(enabled=True, reset=True)
    try:
        log = rt.simulate_batch(cfg, P, A, np.arange(3), engine=engine,
                                device="cpu")
        rt.feed_metrics_batch(log.times, log.srcs, A, opt, cfg.end_time)
        spans = T.get().drain_spans()
    finally:
        T.configure(enabled=False, reset=True)
    seg = sc.innermost(spans)
    assert all(a < b <= c for (a, b, _), (c, _, _) in zip(seg, seg[1:]))
    roots = [sc.span_interval(s) for s in spans if "parent" not in s
             and s["dur"] > 0]
    assert sum(b - a for a, b, _ in seg) == sum(b - a for a, b in roots)
    names = {n for _, _, n in seg}
    assert "sim.simulate_batch" in names or "sim.checks" in names
