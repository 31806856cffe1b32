#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``redqueen_tpu_torch``) on one
NVIDIA card: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. the device (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel in ``redqueen_tpu_torch/csrc/`` with nvcc;
3. the kernel's threefry device function against the random123 vectors
   and the plain PyTorch threefry;
4. the event kernel against its plain PyTorch version on the card, from
   the same prepared inputs, on what the headline does not run: the full
   five-kind mix (B=256), a replay-only mix (B=64), two Opt rows at
   non-adjacent indices (B=256), S=32 sources with four Opt rows at a
   lane count that is a multiple of no block width (B=1,001), S=32 with
   every source an Opt row, the most shared memory a block takes, its
   clocks started inside the horizon so that the rows react to each
   other (B=37), and the four-Opt S=32 mix again with one lane poisoned
   under each ``RQ_FAULT`` numeric mode;
5. the headline at full width through the package's entry points,
   ``GraphBuilder`` -> ``stack_components`` -> ``simulate_batch`` ->
   ``feed_metrics_batch``/``num_posts`` (B=10,000 components of one Opt
   broadcaster and 10 Poisson walls of rate 1, T=100, q=1), with the
   kernel's launch count taken around that run and a best-of-3 timing;
   then the kernel and its plain version replay the best run's inputs,
   each launch timed, and are held against each other on every lane.
   The kernel is timed twice: on the device alone (the row's ``ms``),
   and with the wrapper's host work inside the events (the row's
   ``ms_with_host``).  The headline's seeds give 12,300,664
   events, a mean time-in-top-1 of 80.3196 and 230.30 posts per lane;
   any other count fails.

6. the scan engine (``engine="scan"``, PyTorch ops, no hand kernel) on
   the card: (a) the headline at full width, its Poisson walls within
   4 sigma of 100 events and its mean time-in-top-1 within 4 sigma of
   phase 5's fused mean, timed (events/s with and without the metrics,
   dispatches, and the host's time blocked in syncs), and no event-kernel
   launch in that run; (b) the same code on the card and on the CPU
   (B=256 of the headline, B=64 of a mix of every non-neural kind):
   ``srcs``/``n_events`` identical on every lane but those whose first
   difference is a near-tie (the two times at that index within rtol
   1e-5; at most 2% of lanes, counted), ``times`` within rtol 1e-5 on the
   rest; (c) T=50 with ``return_state`` then ``resume`` to T=100 equal to
   the continuous run bit for bit on every lane; (d) ``max_events``: each
   lane stops at exactly its budget with a prefix of the unbounded log;
   (e) ``engine="auto"`` picks the kernel for the headline and the scan
   engine, with its reason, when ``max_events`` is given.

7. the presets and the star engine, at ``benchmarks/run.py``'s full
   settings, through ``build_preset``/``run_preset``: (a) config 1 at
   1,024 seeds (scan engine), its mean time-in-top-1 within 4 sigma of
   phase 5's fused mean; (b) config 3 (1,000 lanes), per seed bit for bit
   config 1's first 1,000 lanes; (c) configs 2 and 4 at a small scale on
   the card against the same code on the CPU (wall streams identical but
   for thinning near-ties, at most 2% of feeds; posts within rtol 1e-5);
   (d) config 2 (1,000 Hawkes feeds) timed with its split into streams,
   fires and metrics, seed 0's mean wall count within 4 sigma of the
   Hawkes closed form; (e) config 4 (100,000 replay feeds, q = 2,500)
   timed and split, seed 0 bit-identical in both fire modes with and
   without compression; (f) power-law ragged lanes (B = 10,000, up to 16
   followers, T = 100) through the event kernel, bucketed against
   dense-padded per lane bit for bit, launches counted; (g) the default
   widths (up to 1,024 followers) through the scan engine at B = 512,
   T = 2, bucketed against dense-padded.

8. the headline bench and config 5: (a) ``python -m
   redqueen_tpu_torch.bench`` at full settings as a subprocess (B =
   10,000, T = 100, 32 oracle components), both engines' time-in-top-1
   within the oracle's 4-sigma gate, ``platform`` the card's name, the
   fused engine through the event kernel; (b) config 5 at
   ``benchmarks/run.py``'s full settings (10 Poisson feeds, T = 100,
   1,024 seeds, hidden 8), its weights fitted on the card (120 Adam
   steps), the fit, simulate and metrics timed apart, mean posts and
   time-in-top-1 within 4 sigma of ``oracle.numpy_ref.RMTPP`` with the
   same weights over 64 oracle seeds; (c) the same weights at B = 64,
   card against CPU (``srcs`` identical but for near-ties, at most 2% of
   lanes); (d) ``rmtpp_stream`` and an RMTPP-controlled star run, card
   against CPU; (e) the committed hidden-16 weights
   (``redqueen_tpu_torch/data/rmtpp_checkpoint0.npz``), one run gated
   against the oracle; (f) ``fit`` on the card against ``fit`` on the
   CPU from the same initial weights, the loss curves within rtol 1e-3
   at every step.

9. the learn path (``redqueen_tpu_torch.learn``) through the
   ``hawkes_pass`` kernel (``csrc/hawkes_pass.cu``): (a) the kernel in
   both modes against its plain version on the same tensors on the card,
   on a D = 5 stream of 3,000 events (padding, chunk boundaries, one
   dimension with mu = 0 and no excitation, whose health bit trips) and a
   D = 64 stream of 8 chunks, every output within 1e-4 of its largest
   magnitude, health equal, and its carries (R and Q at every segment
   start, its phases (A) and (B)) against ``hawkes_carry_plain`` within
   1e-5; (b) the closed-loop world of
   ``experiments/closed_loop.py`` (3 Hawkes walls, T = 600, capacity
   4,096, seed 7) simulated on the card, fitted there with EM (150
   iterations) and FW (300, after 30 EM sweeps), tol 1e-7, each after a
   warm-up fit, every pass one kernel launch, each fit inside closed_loop's
   recovery tolerances and scoring at least the truth's log-likelihood -
   1, and the same fits on the CPU from the same stream, parameters within
   5e-3; (c) the config-4 corpus (``synthetic_twitter(7, 100_000, 100)``,
   256 events a user at most) grouped by hash into 64 dimensions:
   8,581,381 events in chunks [2304, 4096], EM at 1, 1 and 21 iterations
   timed to their ends (seconds per iteration (warm-21 - warm-1) / 20),
   health zero, the EM curve not falling by more than 1e-3 relative, the
   responsibilities summing to the event count within 1e-4 on one pass,
   the kernel against its plain version on the first 8 chunks, and the
   pass timed on the device (10 passes) and split by the profiler into
   its three phases.

Every event-kernel comparison holds every lane bit-identical: ``srcs``,
``n_events``, health, counters and ``times``.

The phases' bodies live in ``redqueen_tpu_torch/smoke/``, one module per
group (``fused``: 1-5, ``scan``: 6, ``presets``: 7, ``config5``: 8,
``learn``: 9, and ``common``); this script runs them in order.

Any failed check exits non-zero.  The last three lines are JSON: every
measurement of the run (``{"measurements": {...}}``), the kernel table
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.  Without
CUDA the script exits with code 2 and prints no result."""

import json
import sys
import time

import numpy as np
import torch

# The phases, and the names the tests reach as ``chip_smoke.<name>``.
from redqueen_tpu_torch.smoke.fused import (
    PARITY_MIXES,
    POISON_MODES,
    compare_runs,
    headline_component,
    parity_prep,
    phase_build,
    phase_device,
    phase_headline,
    phase_parity,
    phase_threefry,
    poisoned,
    s32_all_opt_component,
    started_clocks,
)
from redqueen_tpu_torch.smoke.scan import (
    SCAN_CROSS_B,
    compare_devices,
    joined,
    phase_scan,
    same_prefix,
    scan_auto,
    scan_cross,
    scan_headline,
    scan_max_events,
    scan_mix_component,
    scan_resume,
)
from redqueen_tpu_torch.smoke.presets import (
    PRESET_SEEDS,
    STAR_CROSS_SEEDS,
    hawkes_mean_count,
    phase_presets,
    power_law,
    preset_batch,
    star_config2,
    star_config4,
    star_cross,
    star_feed_divergence,
)
from redqueen_tpu_torch.smoke.config5 import (
    FIT_RTOL,
    bench_run,
    config5_cross,
    config5_full,
    config5_npz,
    fit_cross,
    phase_config5,
    rmtpp_batch,
    rmtpp_stream_cross,
)
from redqueen_tpu_torch.smoke.learn import (
    CARRY_RTOL,
    CORPUS_ITERS,
    PASS_RTOL,
    RECOVER_ITERS,
    RECOVER_TOLERANCES,
    WORLD_ALPHA,
    WORLD_BETA,
    WORLD_MU,
    carry_cross,
    corpus_fit,
    corpus_pass_checks,
    fits_agree,
    pass_cross,
    pass_inputs,
    pass_parity,
    pass_stream,
    phase_learn,
    recover,
    recover_check,
    responsibilities_identity,
)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    result = {"device": phase_device()}
    result["build"] = phase_build()
    result["threefry"] = phase_threefry(dev)
    result["parity"] = phase_parity(dev)
    result["headline"] = hl = phase_headline(dev)
    result["scan"] = phase_scan(
        dev, (hl["mean_top1"], hl["std_top1"], hl["B"]))
    result["presets"] = phase_presets(
        dev, (hl["mean_top1"], hl["std_top1"], hl["B"]))
    result["config5"] = phase_config5(dev)
    result["learn"] = ln = phase_learn(dev)
    n_launch = len(hl["kernel_ms_per_launch"])
    row = {
        "name": "event_kernel", "route": "cuda",
        "source": "redqueen_tpu_torch/csrc/event_kernel.cu",
        "replaces": "redqueen_tpu/ops/pallas_engine.py:311",
        "launches": hl["launches"]["event_kernel"],
        "max_abs_err": hl["parity"]["max_abs_err"],
        "ms": hl["kernel_ms_mean"],
        "ms_with_host": hl["kernel_with_host_ms_mean"],
        "plain_ms": hl["plain_ms_mean"],
        "bound_ms": hl["bound"]["bound_ms"] / n_launch,
        "bound_by": hl["bound"]["bound_by"], "library_ms": None,
    }
    c = ln["corpus"]
    small = ln["parity"]["d5_stats"]
    hawkes_row = {
        "name": "hawkes_pass", "route": "cuda",
        "source": "redqueen_tpu_torch/csrc/hawkes_pass.cu",
        "replaces": "redqueen_tpu/learn/loglik.py:125 (lax.scan; no Pallas "
                    "kernel)",
        "launches": ln["launches"],
        "max_abs_err": max([r["max_abs_err"]
                            for r in ln["parity"].values()]
                           + [c["cross"]["max_abs_err"]]),
        "ms": float(np.mean(c["kernel_ms"])),
        "phase_share": c["phases"] and c["phases"]["share"],
        "plain_ms": small["plain_ms"],
        "bound_ms": c["bound"]["bound_ms"],
        "bound_by": c["bound"]["bound_by"], "library_ms": None,
    }
    result["total_s"] = time.perf_counter() - t_start
    print(f"total {result['total_s']:.1f} s")
    print(json.dumps({"measurements": result}))
    print(json.dumps({"kernels": [row, hawkes_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
