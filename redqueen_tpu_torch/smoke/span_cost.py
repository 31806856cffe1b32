"""What the engines' spans cost: phase 5's headline simulate (10,000 lanes
through the event kernel) timed with CUDA events in one process, the
telemetry sink off and on in alternating runs, and the host time of the
disabled path's per-launch spans timed alone.

Telemetry on records every span the off run skips, so the on run's
extra time bounds what the spans cost when they are off; the disabled
path's own cost is the second number.  Prints one JSON line.

    python -m redqueen_tpu_torch.smoke.span_cost [--pairs 30]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.runtime import telemetry
from redqueen_tpu_torch.smoke.fused import HEADLINE_B, headline_component


def disabled_launch_us(n: int = 200_000) -> dict:
    """Host microseconds of one launch's spans (``engine.pallas.launch``
    and ``engine.pallas.sync``) and of one run's own (its span, the
    dispatch event and the two counters) with telemetry off, each less
    an empty loop's time."""
    telemetry.configure(enabled=False, reset=True)

    def per(body):
        t0 = time.perf_counter()
        body(n)
        return (time.perf_counter() - t0) / n * 1e6

    def empty(k):
        for _ in range(k):
            pass

    def launch(k):
        for _ in range(k):
            with telemetry.span("engine.pallas.launch"):
                pass
            with telemetry.span("engine.pallas.sync"):
                pass

    def run(k):
        for _ in range(k):
            with telemetry.span("engine.pallas.run", k=8, capacity=64,
                                lanes=1) as sp:
                sp.set(dispatches=1)
            telemetry.counter("engine.pallas.launches", 1)
            telemetry.event("engine.dispatch", engine="pallas",
                            requested="fused")
            telemetry.counter("engine.dispatch.pallas")

    base = per(empty)
    return {"per_launch_us": per(launch) - base,
            "per_run_us": per(run) - base, "iterations": n}


def headline_pairs(pairs: int, device) -> dict:
    """``pairs`` alternating (off, on) runs of the headline simulate, each
    timed with CUDA events; the first of each pair alternates too."""
    cfg, params, adj, _opt, mc = headline_component(HEADLINE_B, 100.0,
                                                    device)
    seeds = np.arange(HEADLINE_B) + 10_000

    def once(on: bool) -> float:
        telemetry.configure(enabled=on, reset=True)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                          sync_every=8, engine="fused", device=device)
        b.record()
        b.synchronize()
        spans[on] = len(telemetry.get().spans)
        return a.elapsed_time(b)

    spans = {}
    for on in (False, True):  # warm-up, not kept
        once(on)
    ms = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            ms[on].append(once(on))
    telemetry.configure(enabled=False, reset=True)
    off, on = np.asarray(ms[False]), np.asarray(ms[True])
    diff = on - off
    return {"pairs": pairs, "off_ms": off.tolist(), "on_ms": on.tolist(),
            "off_median_ms": float(np.median(off)),
            "on_median_ms": float(np.median(on)),
            "on_minus_off_median_ms": float(np.median(diff)),
            "on_minus_off_se_ms": float(diff.std(ddof=1)
                                        / np.sqrt(len(diff))),
            "spans_per_run": {"off": spans[False], "on": spans[True]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"card": card, "disabled": disabled_launch_us(),
           "headline": headline_pairs(args.pairs, dev)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
