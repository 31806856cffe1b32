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
   magnitude, health equal; (b) the closed-loop world of
   ``experiments/closed_loop.py`` (3 Hawkes walls, T = 600, capacity
   4,096, seed 7) simulated on the card, fitted there with EM (150
   iterations) and FW (300, after 30 EM sweeps), tol 1e-7, each after a
   warm-up fit, every pass one kernel launch, each fit inside closed_loop's
   recovery tolerances and scoring at least the truth's log-likelihood -
   1, and the same fits on the CPU from the same stream, parameters within
   5e-3; (c) the config-4 corpus (``synthetic_twitter(7, 100_000, 100)``,
   256 events a user at most) grouped by hash into 64 dimensions:
   8,581,381 events in chunks [2304, 4096], EM at 1, 1 and 3 iterations
   timed to their ends (seconds per iteration (warm-3 - warm-1) / 2),
   health zero, the EM curve not falling by more than 1e-3 relative, the
   responsibilities summing to the event count within 1e-4 on one pass,
   and the kernel against its plain version on the first 8 chunks.

Every event-kernel comparison holds every lane bit-identical: ``srcs``,
``n_events``, health, counters and ``times``.

Any failed check exits non-zero.  The last three lines are JSON: every
measurement of the run (``{"measurements": {...}}``), the kernel table
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.  Without
CUDA the script exits with code 2 and prints no result."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch import device as rt_device
from redqueen_tpu_torch.models.base import map_weights as rt_map_weights
from redqueen_tpu_torch.ops import event_engine, event_step, kernels
from redqueen_tpu_torch.ops.threefry import (
    from_bits32,
    threefry2x32,
    to_bits32,
)
from redqueen_tpu_torch.runtime import faultinject, numerics

# H100 SXM (NVIDIA data sheet and Hopper architecture paper): HBM3 at
# 3.35 TB/s; 132 SMs at a 1.98 GHz boost clock.  Each SM issues at most
# 128 thread-instructions a clock (four schedulers, one warp instruction
# each), which is the float32 instruction rate: the data sheet's 67
# TFLOP/s counts a fused multiply-add as two.  Integer instructions run
# on 64 INT32 lanes per SM.  Every scalar operation takes an issue slot,
# and every integer one an INT32 lane too; the bound takes the slower.
HBM_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
ISSUE_PER_S = SMS * 128 * CLOCK_HZ
INT32_PER_S = SMS * 64 * CLOCK_HZ

# Operations per unit of work of the event step (the reckoning of the
# bound in PERF.md), as (integer, float), each counted as the instruction
# sm_90 has for it.  A threefry-2x32 block: the parity word (one
# three-input logic op), 2 initial key adds, 20 rounds of add, rotate (one
# funnel shift) and xor, and 5 key injections of one add per word (the
# round constant folds into a three-input add), all integer.  An Exp(1)
# draw from its bits: an integer shift, then convert, scale, negate,
# log1pf (about 20) and negate.
OPS_DRAW = (1 + 2 + 20 * 3 + 5 * 2 + 1, 24)


def ops_per_step(S):
    """Every step, valid or absorbed: the argmin over S (compare, NaN test,
    select) and the lane gating."""
    return 8, 3 * S


# The fired draw, then the Poisson resample, write-back and emit.
OPS_EVENT = (OPS_DRAW[0], OPS_DRAW[1] + 12)


def ops_react_scan(F):
    """Per lane, Opt row and other source, once per launch (the sum does
    not change during one): the rate sum over F feeds (two loads
    multiplied, a division, a sqrt, a multiply and an add)."""
    return 0, 5 * F + 2


OPS_REACT_DRAW = (OPS_DRAW[0], OPS_DRAW[1] + 4)  # draw, candidate and min


# The headline's batch size, at full width.
HEADLINE_B = 10_000
# What the headline's seeds (10,000.. for the timed runs) give at a
# batch size, exactly, as (events, mean time-in-top-1, posts per lane):
# the kernel is bit-identical to its plain version.
HEADLINE_RESULT = {10_000: (12_300_664, 80.3196, 230.30)}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def headline_component(B, T, device):
    """The headline component: one Opt broadcaster (q=1) against 10
    followers, each with one Poisson wall of rate 1, stacked B times."""
    F = 10
    cap, max_chunks = rt.shape_budget(F, T, 1.0)
    gb = rt.GraphBuilder(n_sinks=F, end_time=T)
    opt = gb.add_opt(q=1.0)
    for i in range(F):
        gb.add_poisson(rate=1.0, sinks=[i])
    cfg, p0, a0 = gb.build(capacity=cap, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, opt, max_chunks


def full_mix_component(B, device):
    gb = rt.GraphBuilder(n_sinks=5, end_time=15.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])
    cfg, p0, a0 = gb.build(capacity=64, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def replay_component(B, device):
    gb = rt.GraphBuilder(n_sinks=2, end_time=10.0)
    gb.add_realdata([0.5, 1.25, 2.0, 3.75, 9.5, 11.0], sinks=[0])
    gb.add_realdata([0.1, 4.2, 8.8], sinks=[1])
    cfg, p0, a0 = gb.build(capacity=16, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def two_opt_component(B, device):
    """Opt rows 0 and 3 share feed 1; source 5 shares no feed with row 0."""
    gb = rt.GraphBuilder(n_sinks=4, end_time=15.0)
    gb.add_opt(q=1.0, sinks=[0, 1, 2])
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_opt(q=0.5, sinks=[1, 3])
    gb.add_poisson(rate=0.8, sinks=[2, 3])
    gb.add_poisson(rate=0.6, sinks=[3])
    cfg, p0, a0 = gb.build(capacity=32, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def s32_component(B, device):
    """S = 32 = MAX_S: a Hawkes source first (the numeric faults poison
    source 0), Opt rows at 3, 10, 17 and 31, Poisson walls elsewhere."""
    gb = rt.GraphBuilder(n_sinks=8, end_time=4.0)
    opt = {3: [3, 4], 10: [2, 5], 17: [4, 6], 31: [0, 7]}
    for s in range(kernels.MAX_S):
        if s == 0:
            gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[0])
        elif s in opt:
            gb.add_opt(q=0.5 + 0.1 * s, sinks=opt[s])
        else:
            gb.add_poisson(rate=0.3 + 0.02 * s, sinks=[s % 8])
    cfg, p0, a0 = gb.build(capacity=64, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def s32_all_opt_component(B, device):
    """S = 32 = MAX_S with every source an Opt row on two of 8 feeds (r and
    3r + 1 mod 8), the most shared memory a block takes."""
    gb = rt.GraphBuilder(n_sinks=8, end_time=0.25)
    for r in range(kernels.MAX_S):
        gb.add_opt(q=0.5 + 0.05 * r, sinks=[r % 8, (3 * r + 1) % 8])
    cfg, p0, a0 = gb.build(capacity=64, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def started_clocks(prep, seed=0):
    """``prep`` with every clock drawn uniform on [0, T) from ``seed``: an
    Opt row's clock starts at +inf, so a component of Opt rows alone fires
    only from such a start."""
    t = np.random.RandomState(seed).uniform(
        0.0, prep.spec.end_time, tuple(prep.carry["t_next"].shape))
    t_next = torch.from_numpy(t.astype(np.float32)).to(
        prep.carry["t_next"].device)
    return dataclasses.replace(prep, carry=dict(prep.carry, t_next=t_next))


# Phase 4's mixes, by key: (label, component, batch size, chunks per
# launch, clocks started inside the horizon).
PARITY_MIXES = {
    "full_mix": ("full mix", full_mix_component, 256, 8, False),
    "replay": ("replay-only", replay_component, 64, 8, False),
    "two_opt": ("two Opt rows", two_opt_component, 256, 2, False),
    "s32": ("S=32", s32_component, 1001, 2, False),
    "s32_all_opt": ("S=32, every source Opt", s32_all_opt_component, 37, 1,
                    True),
}
POISON_MODES = ("nan", "inf")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi exited {smi.returncode}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name} | nvidia-smi: {line} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} card(s)")
    return {"nvidia_smi": line, "name": name,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def phase_build():
    _, secs = kernels.build()
    regs = []
    for src, log in sorted(kernels.BUILD_LOG.items()):
        regs += [f"{src}: {ln.strip()}" for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
    print(f"phase 2 build: {secs:.2f} s for {sorted(kernels.BUILD_LOG)}")
    for ln in regs:
        print(f"  ptxas {ln}")
    return {"build_s": secs, "ptxas": regs}


def phase_threefry(dev):
    vec = [((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
           ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
            (0xC4923A9C, 0x483DF7A0))]
    for (k0, k1, x0, x1), want in vec:
        args = [to_bits32(torch.tensor([v])).to(dev) for v in (k0, k1, x0, x1)]
        y0, y1 = kernels.threefry_on_device(*args)
        got = (int(from_bits32(y0.cpu())[0]), int(from_bits32(y1.cpu())[0]))
        check(got == want, f"threefry vector {hex(k0)}: got "
                           f"{[hex(g) for g in got]}, want "
                           f"{[hex(w) for w in want]}")
    rng = np.random.RandomState(0)
    words = [torch.from_numpy(rng.randint(0, 2**32, 1 << 16, dtype=np.uint64)
                              .astype(np.int64)) for _ in range(4)]
    y0, y1 = kernels.threefry_on_device(
        *(to_bits32(w).to(dev) for w in words))
    p0, p1 = threefry2x32(*words)
    same = (torch.equal(from_bits32(y0.cpu()), p0)
            and torch.equal(from_bits32(y1.cpu()), p1))
    check(same, "threefry kernel disagrees with the plain version")
    torch.cuda.synchronize()
    print("phase 3 threefry: random123 vectors ok; 65,536 random blocks "
          "bit-identical to the plain version")
    return {"vectors_ok": True, "random_blocks_identical": 1 << 16}


def bits(x):
    """A tensor's words as int32, so that equality is bit equality."""
    return x.view(torch.int32) if x.is_floating_point() else x


def compare(label, kern, plain):
    """Hold a kernel run against its plain version's run on the same
    prepared inputs (each ``event_engine.drive``'s output): every lane
    bit-identical in srcs, times and the whole carry."""
    (ck, tk, sk, dk), (cp, tp, sp, dp) = kern, plain
    torch.cuda.synchronize()
    check(dk == dp and tk.shape == tp.shape,
          f"{label}: kernel {dk} launches, log {tuple(tk.shape)}; plain "
          f"version {dp} launches, log {tuple(tp.shape)}")
    lane_ok = (sk == sp).all(1) & (bits(tk) == bits(tp)).all(1)
    for nm in event_step.CARRY_NAMES:
        eq = bits(ck[nm]) == bits(cp[nm])
        lane_ok &= eq.all(0) if eq.dim() == 2 else eq
    n_bad = int((~lane_ok).sum())
    fin = torch.isfinite(tp)
    diff = (tk - tp).abs()[fin]
    max_abs = float(diff.max()) if diff.numel() else 0.0
    B = tk.shape[0]
    print(f"{label}: B={B}, lanes not bit-identical {n_bad} of {B}, "
          f"max |dt| {max_abs:.3g}, launches {dk}/{dp}, "
          f"events {int(ck['nev'].sum())}")
    check(n_bad == 0, f"{label}: {n_bad} lanes differ from the plain "
                      f"version")
    return {"lanes": B, "lanes_differing": n_bad, "max_abs_err": max_abs,
            "bit_identical": n_bad == 0, "events": int(ck["nev"].sum())}


def compare_runs(name, prep, max_chunks):
    """Drive one prepared batch through the kernel and through its plain
    version on the card, and :func:`compare` them."""
    kern = event_engine.drive(prep, kernels.launch_event_kernel, max_chunks)
    plain = event_engine.drive(prep, event_step.run_launch, max_chunks)
    return compare(f"phase 4 {name}", kern, plain), kern


def parity_prep(key, dev, fault=None):
    """Phase 4's mix ``key`` prepared on ``dev``, with ``RQ_FAULT`` set
    to ``fault`` while the initial state is prepared (the fault is read
    then): ``(label, prepared inputs, max_chunks)``."""
    label, make, B, k, start = PARITY_MIXES[key]
    cfg, params, adj, mc = make(B, dev)
    old = os.environ.get(faultinject.ENV_FAULT)
    if fault is not None:
        os.environ[faultinject.ENV_FAULT] = fault
    try:
        prep = event_engine.prepare(cfg, params, adj, np.arange(B), k)
    finally:
        if old is None:
            os.environ.pop(faultinject.ENV_FAULT, None)
        else:
            os.environ[faultinject.ENV_FAULT] = old
    return label, started_clocks(prep) if start else prep, mc


def poisoned(mode, dev):
    """The S=32 mix with lane 7 poisoned by ``RQ_FAULT=numeric:<mode>``."""
    label, prep, mc = parity_prep("s32", dev, f"numeric:{mode}@lane7")
    out, kern = compare_runs(f"{label}, lane 7 poisoned ({mode})", prep, mc)
    health = from_bits32(kern[0]["health"]).cpu()
    want = (numerics.BIT_NONFINITE_TIME if mode == "nan"
            else numerics.BIT_NONFINITE_STATE)
    check(bool(health[7] & want) and int((health != 0).sum()) == 1,
          f"poisoned ({mode}): health {health[7].item():#x} on lane 7, "
          f"{int((health != 0).sum())} sick lanes")
    return out


def phase_parity(dev):
    out = {}
    for key in PARITY_MIXES:
        label, prep, mc = parity_prep(key, dev)
        out[key] = compare_runs(label, prep, mc)[0]
    for mode in POISON_MODES:
        out[f"s32_poisoned_{mode}"] = poisoned(mode, dev)
    return out


def run_headline(cfg, params, adj, opt, mc, seeds):
    """The main path once: ``(log, top1, posts, simulate_s, metrics_s)``,
    each of the two wall times ending in a device sync."""
    t0 = time.perf_counter()
    log = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                            sync_every=8, engine="fused")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = rt.feed_metrics_batch(log.times, log.srcs, adj, opt, cfg.end_time)
    top1 = m.mean_time_in_top_k()
    posts = rt.num_posts(log.srcs, opt)
    torch.cuda.synchronize()
    return log, top1, posts, t1 - t0, time.perf_counter() - t1


def timed(launch_fn, ms):
    """``launch_fn`` with a CUDA-event pair around each call, appending
    each call's milliseconds to ``ms``.  The card idles while the host
    prepares the launch, so the time includes the wrapper's host work (the
    kernel row's ``ms_with_host``, and the right measure for the plain
    version, whose many small operations the host issues one by one)."""
    def run(spec, params, carry):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch_fn(spec, params, carry)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        return out
    return run


# Cycles the card sleeps before a launch timed on the device alone: about
# 2 ms, far longer than the wrapper's host work.
SLEEP_CYCLES = 4_000_000


def timed_on_device(launch_fn, ms):
    """``launch_fn`` with a CUDA-event pair around its kernel alone: the
    stream first sleeps on the card, and the host prepares the launch
    meanwhile, so the kernel starts right after the first event.  Fails
    if the host took longer than the sleep."""
    def run(spec, params, carry):
        z = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        z.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        h0 = time.perf_counter()
        out = launch_fn(spec, params, carry)
        host_ms = (time.perf_counter() - h0) * 1e3
        b.record()
        torch.cuda.synchronize()
        check(host_ms < z.elapsed_time(a),
              f"the host took {host_ms:.3f} ms to launch, longer than the "
              f"{z.elapsed_time(a):.3f} ms sleep")
        ms.append(a.elapsed_time(b))
        return out
    return run


def bound_for(prep, carry, n_launches):
    """Least time for the run's kernel work: bytes (each input read once,
    each output written once) over HBM bandwidth, and operations (counted
    from this run's events and react draws) over the issue rate, integer
    ones over the INT32 rate, whichever is slower."""
    spec, B = prep.spec, prep.B
    S, F = spec.S, spec.F
    in_bytes = sum(t.numel() * t.element_size()
                   for t in list(prep.params.values())
                   + list(prep.carry.values()))
    carry_bytes = sum(t.numel() * t.element_size() for t in carry.values())
    log_bytes = n_launches * spec.k * spec.capacity * B * 8
    nbytes = in_bytes + carry_bytes + log_bytes
    steps = n_launches * spec.k * spec.capacity * B
    events = int(carry["nev"].sum())
    draws = int(from_bits32(carry["ctr"]).sum())
    react_draws = draws - events
    pairs = n_launches * B * len(spec.opt_rows) * (S - 1)
    int_ops, float_ops = (
        sum(n * c[i] for n, c in ((steps, ops_per_step(S)),
                                  (events, OPS_EVENT),
                                  (pairs, ops_react_scan(F)),
                                  (react_draws, OPS_REACT_DRAW)))
        for i in (0, 1))
    ops = int_ops + float_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ISSUE_PER_S, int_ops / INT32_PER_S) * 1e3
    return {"bytes": nbytes, "ops": ops, "int_ops": int_ops,
            "float_ops": float_ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "events": events, "react_draws": react_draws,
            "lane_steps": steps}


def phase_headline(dev):
    B, T = HEADLINE_B, 100.0
    t0 = time.perf_counter()
    cfg, params, adj, opt, mc = headline_component(B, T, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    seeds = np.arange(B)

    # The main path, once, with the kernel counts around it.
    kernels.reset_launch_counts()
    log = run_headline(cfg, params, adj, opt, mc, seeds)[0]
    launches = dict(kernels.LAUNCHES)
    check(launches["event_kernel"] > 0, "the main path launched no kernel")
    check(log.engine == "cuda", f"engine {log.engine!r}, expected 'cuda'")
    check(launches["event_kernel"] == log.dispatches,
          f"{launches['event_kernel']} launches vs {log.dispatches} "
          f"dispatches")

    # Best of 3 by total wall time, with that run's two layers.
    runs = [run_headline(cfg, params, adj, opt, mc, seeds + 10_000)
            for _ in range(3)]
    log, top1, posts, sim_s, met_s = min(runs, key=lambda r: r[3] + r[4])
    best = sim_s + met_s

    nev = log.n_events
    events = int(nev.sum())
    check(bool((log.health == 0).all()), "sick lanes in the headline")
    top1_h = top1.cpu().numpy()
    posts_h = posts.cpu().numpy()
    check(np.isfinite(top1_h).all() and (top1_h >= 0).all()
          and (top1_h <= T).all(), "time-in-top-1 outside [0, T]")
    check(tuple(log.times.shape)[0] == B and tuple(log.srcs.shape)[0] == B,
          "log shape")
    srcs = log.srcs
    walls = torch.stack([(srcs == w).sum(-1) for w in range(1, 11)], 1)
    wall = walls.double().cpu().numpy().reshape(-1)
    se = wall.std() / np.sqrt(wall.size)
    check(abs(wall.mean() - T) < 4 * se,
          f"mean events per Poisson wall {wall.mean():.3f} is not "
          f"{T} within 4 sigma ({4 * se:.3f})")
    check(int(nev.sum()) == int((srcs >= 0).sum()), "n_events vs log")
    got = (events, round(float(top1_h.mean()), 4),
           round(float(posts_h.mean()), 2))
    check(got == HEADLINE_RESULT.get(B, got),
          f"(events, mean time-in-top-1, posts per lane) = {got}; the "
          f"headline's seeds give {HEADLINE_RESULT.get(B)}")

    # The kernel and its plain version replay the best run's inputs (the
    # seeds of the timed runs), each launch timed, and are held against
    # each other on every lane.
    prep = event_engine.prepare(cfg, params, adj, seeds + 10_000, 8)
    k_ms, kh_ms, p_ms = [], [], []
    event_engine.drive(prep, timed(kernels.launch_event_kernel, kh_ms), mc)
    kern = event_engine.drive(
        prep, timed_on_device(kernels.launch_event_kernel, k_ms), mc)
    plain = event_engine.drive(prep, timed(event_step.run_launch, p_ms), mc)
    check(torch.equal(kern[0]["nev"], nev) and torch.equal(kern[2], srcs),
          "the timed kernel replay differs from the main path's log")
    parity = compare("phase 5 headline against the plain version", kern,
                     plain)
    bound = bound_for(prep, kern[0], len(k_ms))
    geom = kernels.geometry(prep.spec, B)

    res = {
        "B": B, "F": 10, "T": T, "capacity": cfg.capacity, "k": 8,
        "max_chunks": mc, "component_build_s": build_s,
        "events": events, "best_s": best, "events_per_s": events / best,
        "simulate_s": sim_s, "metrics_s": met_s,
        "events_per_s_simulate_only": events / sim_s,
        "dispatches": log.dispatches, "launches": launches,
        "mean_top1": float(top1_h.mean()),
        "std_top1": float(top1_h.std()),
        "posts_per_lane": float(posts_h.mean()),
        "wall_mean_events": float(wall.mean()), "wall_4se": float(4 * se),
        "kernel_ms_per_launch": k_ms, "plain_ms_per_launch": p_ms,
        "kernel_ms_mean": float(np.mean(k_ms)),
        "kernel_with_host_ms_per_launch": kh_ms,
        "kernel_with_host_ms_mean": float(np.mean(kh_ms)),
        "plain_ms_mean": float(np.mean(p_ms)), "bound": bound,
        "parity": parity, "geometry": dataclasses.asdict(geom),
    }
    print(f"phase 5 headline: B={B} F=10 T={T} capacity={cfg.capacity} "
          f"k=8: {events} events in {best:.4f} s best of 3 "
          f"(simulate+metrics) = {events / best:,.0f} events/s; "
          f"of which simulate {sim_s:.4f} s = {events / sim_s:,.0f} "
          f"events/s and metrics {met_s:.4f} s; "
          f"dispatches {log.dispatches}, event-kernel launches "
          f"{launches['event_kernel']}; mean time-in-top-1 "
          f"{res['mean_top1']:.4f}; posts per lane {res['posts_per_lane']:.2f}; "
          f"mean events per wall {wall.mean():.3f} (100 within 4 sigma "
          f"{4 * se:.3f})")
    print(f"  launch geometry: G = 1 thread per lane, "
          f"{geom.lanes_per_block} lanes per block, {geom.blocks} blocks, "
          f"{geom.smem_bytes} bytes of shared memory per block")
    print(f"  kernel ms per launch on the device {['%.4f' % x for x in k_ms]} "
          f"(mean {res['kernel_ms_mean']:.4f}); with the wrapper's host work "
          f"{['%.4f' % x for x in kh_ms]} (mean "
          f"{res['kernel_with_host_ms_mean']:.4f}); plain version ms per "
          f"launch "
          f"{['%.1f' % x for x in p_ms]} (mean {res['plain_ms_mean']:.1f}); "
          f"bound per launch {bound['bound_ms'] / len(k_ms):.4f} ms by "
          f"{bound['bound_by']} ({bound['int_ops']:.4g} integer and "
          f"{bound['float_ops']:.4g} float ops, {bound['bytes']:.4g} bytes "
          f"for the run); no single PyTorch call computes this function, "
          f"so library_ms is null")
    return res

# ---- phase 6: the scan engine ----

# (b): lanes of the headline and of the every-kind mix run on the card and
# on the CPU.
SCAN_CROSS_B = {"headline": 256, "mix": 64}
# (b): times agree within this on identical lanes; a lane whose first
# difference has its two times within it diverged at a near-tie, and such
# lanes may be at most NEAR_TIE_MAX_SHARE of the batch.
NEAR_TIE_RTOL = 1e-5
NEAR_TIE_MAX_SHARE = 0.02


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class HostSyncTimer:
    """Counts the scan engine's host syncs (``device.host_read``, where
    the host waits for the card) and the seconds spent in them."""

    def __enter__(self):
        self.n, self.seconds = 0, 0.0
        self._read = rt_device.host_read

        def timed_read(x):
            t0 = time.perf_counter()
            try:
                return self._read(x)
            finally:
                self.n += 1
                self.seconds += time.perf_counter() - t0

        rt_device.host_read = timed_read
        return self

    def __exit__(self, *exc):
        rt_device.host_read = self._read


def scan_mix_component(B, device):
    """Every non-neural kind: the full mix of phase 4 with a second Opt
    row on feeds 1 and 3."""
    gb = rt.GraphBuilder(n_sinks=5, end_time=15.0)
    gb.add_opt(q=1.0)
    gb.add_poisson(rate=1.0, sinks=[0])
    gb.add_hawkes(l0=0.5, alpha=0.3, beta=1.0, sinks=[1])
    gb.add_piecewise([0.0, 7.0], [1.0, 0.3], sinks=[2])
    gb.add_realdata([1.0, 2.5, 6.0, 14.0], sinks=[3])
    gb.add_poisson(rate=0.7, sinks=[4])
    gb.add_opt(q=0.5, sinks=[1, 3])
    cfg, p0, a0 = gb.build(capacity=64, device=device)
    params, adj = rt.stack_components([p0] * B, [a0] * B)
    return cfg, params, adj, 100


def scan_run(cfg, params, adj, seeds, mc, dev, **kw):
    return rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                             sync_every=8, engine="scan", device=dev, **kw)


def scan_headline(dev, B, T, fused):
    """(a) The headline through the scan engine; ``fused`` is phase 5's
    (mean, std, lanes) of time-in-top-1.  Returns the result and
    the run's (cfg, params, adj, opt, max_chunks, seeds, log)."""
    cfg, params, adj, opt, mc = headline_component(B, T, dev)
    seeds = np.arange(B)
    warm = dataclasses.replace(cfg, end_time=2.0)
    scan_run(warm, params, adj, seeds, mc, dev)
    sync(dev)
    kernels.reset_launch_counts()
    with HostSyncTimer() as syncs:
        t0 = time.perf_counter()
        log = scan_run(cfg, params, adj, seeds, mc, dev)
        sync(dev)
        t1 = time.perf_counter()
    m = rt.feed_metrics_batch(log.times, log.srcs, adj, opt, cfg.end_time)
    top1 = m.mean_time_in_top_k()
    posts = rt.num_posts(log.srcs, opt)
    sync(dev)
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    sim_s, met_s = t1 - t0, t2 - t1
    check(log.engine == "scan" and log.engine_reason is None,
          f"engine {log.engine!r} ({log.engine_reason}), expected 'scan'")
    check(launches["event_kernel"] == 0,
          f"the scan path launched the event kernel "
          f"{launches['event_kernel']} times")
    check(bool((log.health == 0).all()), "sick lanes in the scan headline")
    nev = log.n_events
    events = int(nev.sum())
    check(events == int((log.srcs >= 0).sum()), "n_events vs log")
    top1_h = top1.double().cpu().numpy()
    check(np.isfinite(top1_h).all() and (top1_h >= 0).all()
          and (top1_h <= T).all(), "time-in-top-1 outside [0, T]")
    walls = torch.stack([(log.srcs == w).sum(-1) for w in range(1, 11)], 1)
    wall = walls.double().cpu().numpy().reshape(-1)
    w_se = wall.std() / np.sqrt(wall.size)
    check(abs(wall.mean() - T) < 4 * w_se,
          f"scan: mean events per Poisson wall {wall.mean():.3f} is not "
          f"{T} within 4 sigma ({4 * w_se:.3f})")
    f_mean, f_std, f_lanes = fused
    se = np.sqrt(top1_h.var() / B + f_std ** 2 / f_lanes)
    diff = top1_h.mean() - f_mean
    check(abs(diff) < 4 * se,
          f"scan mean time-in-top-1 {top1_h.mean():.4f} vs fused "
          f"{f_mean:.4f}: {diff:+.4f} beyond 4 sigma ({4 * se:.4f})")
    steps = int(log.times.shape[1])
    res = {
        "B": B, "T": T, "capacity": cfg.capacity, "sync_every": 8,
        "events": events, "simulate_s": sim_s, "metrics_s": met_s,
        "events_per_s": events / (sim_s + met_s),
        "events_per_s_simulate_only": events / sim_s,
        "dispatches": log.dispatches, "steps": steps,
        "ms_per_step": sim_s / steps * 1e3,
        "host_syncs": syncs.n, "host_sync_s": syncs.seconds,
        "host_sync_share": syncs.seconds / sim_s,
        "steps_share": 1.0 - syncs.seconds / sim_s,
        "launches": launches, "mean_top1": float(top1_h.mean()),
        "std_top1": float(top1_h.std()), "fused_mean_top1": f_mean,
        "top1_diff": float(diff), "top1_4se": float(4 * se),
        "posts_per_lane": float(posts.double().mean()),
        "wall_mean_events": float(wall.mean()), "wall_4se": float(4 * w_se),
    }
    print(f"phase 6 (a) scan headline: B={B} T={T} capacity={cfg.capacity} "
          f"sync_every=8: {events} events; simulate {sim_s:.3f} s = "
          f"{events / sim_s:,.0f} events/s, with metrics "
          f"{events / (sim_s + met_s):,.0f} events/s; {steps} steps at "
          f"{res['ms_per_step']:.3f} ms; dispatches {log.dispatches}; "
          f"{syncs.n} host syncs took {syncs.seconds:.3f} s "
          f"({100 * res['host_sync_share']:.1f}% of simulate); event-kernel "
          f"launches {launches['event_kernel']}; mean time-in-top-1 "
          f"{top1_h.mean():.4f} vs fused {f_mean:.4f} ({diff:+.4f}, 4 sigma "
          f"{4 * se:.4f}); mean events per wall {wall.mean():.3f}")
    return res, (cfg, params, adj, opt, mc, seeds, log)


def first_difference(a, b):
    """Per lane of two [B, E] tensors: whether they differ and the first
    index where they do (0 where they do not)."""
    d = a != b
    return d.any(1), torch.argmax(d.to(torch.int8), 1)


def padded(log, E):
    """``(times, srcs)`` of a log on the host, padded with (+inf, -1) to E
    columns."""
    t, s = log.times.cpu(), log.srcs.cpu()
    pad = E - t.shape[1]
    if pad:
        t = torch.cat([t, torch.full((t.shape[0], pad), float("inf"))], 1)
        s = torch.cat([s, torch.full((s.shape[0], pad), -1,
                                     dtype=s.dtype)], 1)
    return t, s


def compare_devices(label, card, cpu, end_time, tag="phase 6 (b)"):
    """(b) A scan run on the card against the same run on the CPU."""
    E = max(card.times.shape[1], cpu.times.shape[1])
    tc, sc = padded(card, E)
    tp, sp = padded(cpu, E)
    B = tc.shape[0]
    differs, j = first_difference(sc, sp)
    differs |= card.n_events.cpu() != cpu.n_events.cpu()
    a = tc.double().gather(1, j[:, None])[:, 0]
    b = tp.double().gather(1, j[:, None])[:, 0]
    close = (a - b).abs() <= NEAR_TIE_RTOL * b.abs()
    # A tie with the horizon: one side's event fell just past it.
    at_end = ((torch.isinf(a) & ((b - end_time).abs()
                                 <= NEAR_TIE_RTOL * end_time))
              | (torch.isinf(b) & ((a - end_time).abs()
                                   <= NEAR_TIE_RTOL * end_time)))
    near = differs & (close | at_end)
    n_near, n_far = int(near.sum()), int((differs & ~near).sum())
    same = ~differs
    fin = torch.isfinite(tp) & same[:, None]
    rel = ((tc.double() - tp.double()).abs()
           / tp.double().abs().clamp(min=1e-30))[fin]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    print(f"{tag} {label} card vs CPU: B={B}, lanes differing "
          f"{int(differs.sum())} (near-ties {n_near}, others {n_far}), "
          f"max rel |dt| on identical lanes {max_rel:.3g}, events "
          f"{int(card.n_events.sum())}/{int(cpu.n_events.sum())}")
    check(n_far == 0, f"(b) {label}: {n_far} lanes differ from the CPU run "
                      f"at other than a near-tie")
    check(n_near <= NEAR_TIE_MAX_SHARE * B,
          f"(b) {label}: {n_near} near-tie lanes of {B}, more than "
          f"{NEAR_TIE_MAX_SHARE:.0%}")
    check(max_rel <= NEAR_TIE_RTOL,
          f"(b) {label}: times differ by rel {max_rel:.3g} > "
          f"{NEAR_TIE_RTOL} on identical lanes")
    return {"lanes": B, "lanes_differing": int(differs.sum()),
            "near_ties": n_near, "max_rel_err": max_rel,
            "events_card": int(card.n_events.sum()),
            "events_cpu": int(cpu.n_events.sum())}


def scan_cross(key, B, dev):
    """(b) for one mix: the same batch on ``dev`` and on the CPU."""
    if key == "headline":
        cfg, params, adj, _, mc = headline_component(B, 100.0, dev)
    else:
        cfg, params, adj, mc = scan_mix_component(B, dev)
    seeds = np.arange(B)
    card = scan_run(cfg, params, adj, seeds, mc, dev)
    cpu = scan_run(cfg, params.to("cpu"), adj.cpu(), seeds, mc, "cpu")
    return compare_devices(key, card, cpu, cfg.end_time)


def joined(first, second):
    """The valid events of two logs of the same lanes, one after the
    other, as [B, E] tensors on the host."""
    n1 = first.n_events.cpu().long()[:, None]
    n = n1 + second.n_events.cpu().long()[:, None]
    E = max(int(n.max()), 1)
    p = torch.arange(E)[None, :]
    t1, s1 = padded(first, max(E, first.times.shape[1]))
    t2, s2 = padded(second, max(E, second.times.shape[1]))
    i2 = torch.clamp(p - n1, min=0)
    t = torch.where(p < n1, t1[:, :E], t2.gather(1, i2))
    s = torch.where(p < n1, s1[:, :E], s2.gather(1, i2))
    valid = p < n
    return (torch.where(valid, t, torch.full_like(t, float("inf"))),
            torch.where(valid, s, torch.full_like(s, -1)), n[:, 0])


def same_prefix(label, t, s, n, ref):
    """Check that [B, E] host tensors (t, s) with n events per lane are
    the log ``ref`` bit for bit: equal counts, equal entries, and nothing
    in ``ref`` past them."""
    E = t.shape[1]
    tr, sr = padded(ref, max(E, ref.times.shape[1]))
    n_bad = int(((n != ref.n_events.cpu().long())
                 | (sr[:, :E] != s).any(1)
                 | (bits(tr[:, :E]) != bits(t)).any(1)
                 | (sr[:, E:] != -1).any(1)).sum())
    check(n_bad == 0, f"{label}: {n_bad} lanes differ from the reference "
                      f"log")
    return n_bad


def scan_resume(ctx, dev):
    """(c) T/2 with return_state, then resume to T, against the
    continuous run."""
    cfg, params, adj, _, mc, seeds, cont = ctx
    half = dataclasses.replace(cfg, end_time=cfg.end_time / 2)
    log1, state = scan_run(half, params, adj, seeds, mc, dev,
                           return_state=True)
    log2, _ = rt.resume(cfg, params, adj, state, max_chunks=mc)
    t, s, n = joined(log1, log2)
    n_bad = same_prefix("(c) resume", t, s, n, cont)
    B = len(seeds)
    print(f"phase 6 (c) resume: T={half.end_time} then {cfg.end_time}: "
          f"{int(log1.n_events.sum())} + {int(log2.n_events.sum())} "
          f"events, lanes not bit-identical to the continuous run "
          f"{n_bad} of {B}")
    return {"lanes": B, "lanes_differing": n_bad,
            "events_first": int(log1.n_events.sum()),
            "events_resumed": int(log2.n_events.sum())}


def scan_max_events(ctx, dev):
    """(d) A budget per lane, drawn in [0, its unbounded count]."""
    cfg, params, adj, _, mc, seeds, full = ctx
    n_full = full.n_events.cpu().numpy()
    rng = np.random.RandomState(6)
    budget = (rng.uniform(0, 1, n_full.size) * (n_full + 1)).astype(np.int64)
    log = scan_run(cfg, params, adj, seeds, mc, dev, max_events=budget)
    n = log.n_events.cpu().long()
    check(bool((n == torch.from_numpy(budget)).all()),
          f"(d) max_events: {int((n != torch.from_numpy(budget)).sum())} "
          f"lanes did not stop at their budget")
    E = max(int(n.max()), 1)
    t, s = padded(log, max(E, log.times.shape[1]))
    check(bool((s[:, E:] == -1).all()), "(d) events past the budget")
    tf, sf = padded(full, max(E, full.times.shape[1]))
    p = torch.arange(E)[None, :]
    inside = p < n[:, None]
    n_bad = int((inside & ((s[:, :E] != sf[:, :E])
                           | (bits(t[:, :E]) != bits(tf[:, :E])))).any(1)
                .sum())
    check(n_bad == 0, f"(d) max_events: {n_bad} lanes are not a prefix of "
                      f"the unbounded run")
    print(f"phase 6 (d) max_events: {len(budget)} lanes stopped at exactly "
          f"their budgets ({int(budget.sum())} events), every log a prefix "
          f"of the unbounded run; dispatches {log.dispatches}")
    return {"lanes": len(budget), "events": int(budget.sum()),
            "lanes_not_prefix": n_bad, "dispatches": log.dispatches}


def scan_auto(ctx, dev):
    """(e) ``engine="auto"``: the kernel for the headline on the card,
    the scan engine with its reason when ``max_events`` is given."""
    cfg, params, adj, _, mc, seeds, _ = ctx
    want = "cuda" if torch.device(dev).type == "cuda" else "scan"
    kernels.reset_launch_counts()
    log = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                            engine="auto", device=dev)
    launches = kernels.LAUNCHES["event_kernel"]
    check(log.engine == want, f"(e) auto ran {log.engine!r} "
                              f"({log.engine_reason}), expected {want!r}")
    if want == "cuda":
        check(launches == log.dispatches > 0 and log.engine_reason is None,
              f"(e) auto: {launches} launches, {log.dispatches} "
              f"dispatches, reason {log.engine_reason!r}")
    bounded = rt.simulate_batch(cfg, params, adj, seeds, max_chunks=mc,
                                engine="auto", max_events=5, device=dev)
    reason = bounded.engine_reason or ""
    check(bounded.engine == "scan" and "max_events" in reason,
          f"(e) auto with max_events ran {bounded.engine!r} ({reason!r})")
    check(bool((bounded.n_events == 5).all()), "(e) max_events=5 counts")
    print(f"phase 6 (e) auto: headline on {log.engine!r} ({launches} "
          f"event-kernel launches); with max_events on "
          f"{bounded.engine!r}: {reason}")
    return {"headline_engine": log.engine, "launches": launches,
            "bounded_engine": bounded.engine, "bounded_reason": reason}


def phase_scan(dev, fused):
    """Phase 6; ``fused`` is phase 5's (mean, std, lanes) of
    time-in-top-1."""
    t0 = time.perf_counter()
    res = {}
    res["headline"], ctx = scan_headline(dev, HEADLINE_B, 100.0, fused)
    res["cross"] = {key: scan_cross(key, B, dev)
                    for key, B in SCAN_CROSS_B.items()}
    res["resume"] = scan_resume(ctx, dev)
    res["max_events"] = scan_max_events(ctx, dev)
    res["auto"] = scan_auto(ctx, dev)
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 6 scan engine: {res['phase_s']:.1f} s")
    return res


# ---- phase 7: the presets and the star engine ----

# benchmarks/run.py's _FULL settings for configs 1-4 and its seeds: 1,024
# seeds for config 1, lanes 0..999 for config 3, 4 seeds for the star
# configs 2 and 4.
PRESET_FULL = {
    1: dict(scale=1.0, end_time=100.0),
    2: dict(scale=1.0, end_time=100.0, wall_cap=1024, post_cap=8192),
    3: dict(scale=1.0, end_time=100.0),
    4: dict(scale=1.0, end_time=100.0, q=2500.0, post_cap=4096),
}
PRESET_SEEDS = {1: np.arange(1024), 2: np.arange(4), 3: 0, 4: np.arange(4)}
# (c): the star presets at a small scale (config 4's q scaled with its
# feeds), card against CPU, one simulate_star per seed.
STAR_CROSS = {
    2: dict(scale=0.02, end_time=100.0, wall_cap=1024, post_cap=8192),
    4: dict(scale=0.001, end_time=100.0, q=2.5, post_cap=4096),
}
STAR_CROSS_SEEDS = (0, 1)
# (f): power-law ragged lanes through the event kernel.  Bucket widths
# are powers of two and a component has width + 1 sources, so the
# kernel's MAX_S = 32 admits followers up to 16 (31 would make a width-32
# bucket of 33 sources).
POWER_LAW_FUSED = dict(B=10_000, max_followers=16, end_time=100.0)
# (g): the default widths (up to 1,024 followers) through the scan
# engine, B and T cut: a hub lane at full T would take ~10^5 steps.
POWER_LAW_SCAN = dict(B=512, end_time=2.0)
# (c): at most this share of a star run's feeds may have a wall stream
# that left the CPU's at a thinning near-tie.
STAR_NEAR_TIE_MAX_SHARE = 0.02
ENV_AUTOTUNE = "RQ_LANES_AUTOTUNE"


class StageTimer:
    """Seconds spent in each stage of the star kernel with an Opt
    broadcaster (``star_run``'s wall streams, fires and metrics), each
    bracketed by device syncs; restores the stages on exit."""

    STAGES = {"streams": "_wall_streams", "fires": "_opt_fires",
              "metrics": "_feed_metrics_star"}

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        from redqueen_tpu_torch.parallel import star_run

        self._mod = star_run
        self.seconds = {k: 0.0 for k in self.STAGES}
        self._orig = {n: getattr(star_run, n) for n in self.STAGES.values()}
        for k, n in self.STAGES.items():
            setattr(star_run, n, self._wrap(k, self._orig[n]))
        return self

    def _wrap(self, stage, fn):
        def timed_stage(*a, **kw):
            sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.dev)
            self.seconds[stage] += time.perf_counter() - t0
            return out
        return timed_stage

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._mod, n, fn)


def timed_preset(which, kw, seeds, dev, stages=False, **run_kw):
    """Build preset ``which`` on ``dev`` and run it once through
    ``run_preset``: ``(out, build_s, run_s, stage seconds or None)``."""
    from redqueen_tpu_torch.presets import build_preset, run_preset

    t0 = time.perf_counter()
    bundle = build_preset(which, device=dev, **kw)
    sync(dev)
    t1 = time.perf_counter()
    timer = StageTimer(dev) if stages else None
    if timer is not None:
        timer.__enter__()
    try:
        out = run_preset(bundle, seeds, device=dev, **run_kw)
        sync(dev)
    finally:
        if timer is not None:
            timer.__exit__(None, None, None)
    t2 = time.perf_counter()
    check(out["events"] > 0 and np.isfinite(out["per_seed_top_k"]).all(),
          f"config {which}: no events or non-finite time-in-top-1")
    top = np.asarray(out["per_seed_top_k"])
    check(((top >= 0) & (top <= out["end_time"])).all(),
          f"config {which}: time-in-top-1 outside [0, T]")
    return (out, bundle, t1 - t0, t2 - t1,
            None if timer is None else timer.seconds)


def preset_batch(dev, fused, full=PRESET_FULL):
    """(a) config 1 at its 1,024 seeds against phase 5's fused mean
    within 4 sigma; (b) config 3, whose lanes are config 1's component at
    seeds 0..999: per seed bit for bit config 1's first lanes."""
    out1, _, b1, s1, _ = timed_preset(1, full[1], PRESET_SEEDS[1], dev)
    top1 = np.asarray(out1["per_seed_top_k"])
    f_mean, f_std, f_lanes = fused
    se = np.sqrt(top1.var() / top1.size + f_std ** 2 / f_lanes)
    diff = top1.mean() - f_mean
    check(abs(diff) < 4 * se,
          f"(a) config 1 mean time-in-top-1 {top1.mean():.4f} vs fused "
          f"{f_mean:.4f}: {diff:+.4f} beyond 4 sigma ({4 * se:.4f})")
    out3, _, b3, s3, _ = timed_preset(3, full[3], PRESET_SEEDS[3], dev)
    n3 = len(out3["per_seed_top_k"])
    n_bad = int(sum(
        a != b or c != d for a, b, c, d in zip(
            out3["per_seed_top_k"], out1["per_seed_top_k"][:n3],
            out3["per_seed_posts"], out1["per_seed_posts"][:n3])))
    check(n_bad == 0, f"(b) config 3: {n_bad} of {n3} lanes differ from "
                      f"config 1 at the same seed")
    res = {
        "config1": {"seeds": top1.size, "events": out1["events"],
                    "build_s": b1, "run_s": s1,
                    "events_per_s": out1["events"] / s1,
                    "mean_top1": float(top1.mean()),
                    "std_top1": float(top1.std()),
                    "mean_posts": out1["mean_posts"],
                    "fused_mean_top1": f_mean, "top1_diff": float(diff),
                    "top1_4se": float(4 * se)},
        "config3": {"lanes": n3, "events": out3["events"], "build_s": b3,
                    "run_s": s3, "events_per_s": out3["events"] / s3,
                    "mean_top1": out3["mean_time_in_top_k"],
                    "lanes_differing_from_config1": n_bad},
    }
    for key, which in (("config1", 1), ("config3", 3)):
        r = res[key]
        print(f"phase 7 ({'a' if which == 1 else 'b'}) config {which}: "
              f"{r['events']} events in {r['run_s']:.3f} s = "
              f"{r['events_per_s']:,.0f} events/s (scan engine, build "
              f"{r['build_s']:.3f} s); mean time-in-top-1 "
              f"{r['mean_top1']:.4f}")
    print(f"  config 1 against phase 5's fused mean {f_mean:.4f}: "
          f"{diff:+.4f} (4 sigma {4 * se:.4f}); config 3 lanes differing "
          f"from config 1's at the same seed: {n_bad} of {n3}")
    return res


def star_feed_divergence(card, cpu):
    """Per feed of two ``StarResult``s of the same seed: whether the wall
    streams differ (count or times beyond rtol 1e-5)."""
    wc, wp = card.wall_times.cpu().double(), cpu.wall_times.double()
    fin = torch.isfinite(wp)
    close = torch.where(fin, (wc - wp).abs() <= NEAR_TIE_RTOL * wp.abs(),
                        ~torch.isfinite(wc))
    return ~close.all(1) | (card.wall_n.cpu() != cpu.wall_n)


def star_cross(which, kw, dev, seeds=STAR_CROSS_SEEDS):
    """(c) a star preset at a small scale on the card and on the CPU, the
    same port code: wall streams identical but for thinning near-ties (at
    most STAR_NEAR_TIE_MAX_SHARE of the feeds, counted); where no feed
    differs, the posts within rtol 1e-5 and the mean time-in-top-1 within
    rtol 1e-4."""
    from redqueen_tpu_torch.presets import build_preset

    _, cfg, wall, ctrl = build_preset(which, device="cpu", **kw)
    n_feeds_diff, lanes_posts_checked, max_rel, max_top_rel = 0, 0, 0.0, 0.0
    for s in seeds:
        card = rt.simulate_star(cfg, wall.to(dev), ctrl.to(dev), seed=s,
                                device=dev)
        cpu = rt.simulate_star(cfg, wall, ctrl, seed=s, device="cpu")
        diverged = star_feed_divergence(card, cpu)
        n_feeds_diff += int(diverged.sum())
        if diverged.any():
            continue
        lanes_posts_checked += 1
        oc, op = card.own_times.cpu().double(), cpu.own_times.double()
        check(torch.equal(torch.isfinite(oc), torch.isfinite(op)),
              f"(c) config {which} seed {s}: {card.n_posts} posts on the "
              f"card, {cpu.n_posts} on the CPU")
        fin = torch.isfinite(op)
        rel = ((oc - op).abs() / op.abs().clamp(min=1e-30))[fin]
        max_rel = max(max_rel, float(rel.max()) if rel.numel() else 0.0)
        tc = float(card.metrics.mean_time_in_top_k())
        tp = float(cpu.metrics.mean_time_in_top_k())
        max_top_rel = max(max_top_rel, abs(tc - tp) / max(abs(tp), 1e-30))
    n_feeds = cfg.n_feeds * len(seeds)
    check(n_feeds_diff <= STAR_NEAR_TIE_MAX_SHARE * n_feeds,
          f"(c) config {which}: {n_feeds_diff} of {n_feeds} feeds' wall "
          f"streams differ from the CPU's")
    check(max_rel <= NEAR_TIE_RTOL,
          f"(c) config {which}: post times differ by rel {max_rel:.3g}")
    check(max_top_rel <= 1e-4,
          f"(c) config {which}: time-in-top-1 differs by rel "
          f"{max_top_rel:.3g}")
    print(f"phase 7 (c) config {which} at scale {kw['scale']} card vs CPU: "
          f"seeds {list(seeds)}, {cfg.n_feeds} feeds: wall streams differing "
          f"{n_feeds_diff} of {n_feeds}; post times max rel {max_rel:.3g} "
          f"and time-in-top-1 max rel {max_top_rel:.3g} on "
          f"{lanes_posts_checked} lane(s)")
    return {"feeds": n_feeds, "feeds_differing": n_feeds_diff,
            "lanes_compared": lanes_posts_checked, "max_rel_post": max_rel,
            "max_rel_top1": max_top_rel}


def hawkes_mean_count(l0, alpha, beta, T):
    """E[N(T)] of an exponential-kernel Hawkes process started empty: the
    stationary l0*T/(1 - alpha/beta) of
    tests/test_bigf.py::TestStreams::test_hawkes_count_closed_form, less
    its start-up transient."""
    n = alpha / beta
    return (l0 * T / (1 - n)
            - l0 * n * (1 - np.exp(-(beta - alpha) * T))
            / ((1 - n) * (beta - alpha)))


def star_stage_line(label, out, run_s, stages):
    other = run_s - sum(stages.values())
    print(f"phase 7 {label}: {out['events']} events in {run_s:.3f} s = "
          f"{out['events'] / run_s:,.0f} events/s; streams "
          f"{stages['streams']:.3f} s, fires {stages['fires']:.3f} s, "
          f"metrics {stages['metrics']:.3f} s, other {other:.3f} s; mean "
          f"posts {out['mean_posts']:.1f}, mean time-in-top-1 "
          f"{out['mean_time_in_top_k']:.4f}")


def star_config2(dev, kw=PRESET_FULL[2], seeds=PRESET_SEEDS[2]):
    """(d) config 2 at its full settings, timed with its stages; seed 0's
    mean wall count per feed within 4 sigma of the Hawkes closed form."""
    out, bundle, b_s, run_s, stages = timed_preset(2, kw, seeds, dev,
                                                   stages=True)
    _, cfg, wall, ctrl = bundle
    res0 = rt.simulate_star(cfg, wall, ctrl, seed=0, device=dev)
    walls = res0.wall_n.double().cpu().numpy()
    l0, alpha, beta = (float(getattr(wall, f).reshape(-1)[0])
                       for f in ("l0", "alpha", "beta"))
    expect = hawkes_mean_count(l0, alpha, beta, cfg.end_time)
    stationary = l0 * cfg.end_time / (1 - alpha / beta)
    se = walls.std() / np.sqrt(walls.size)
    check(abs(walls.mean() - expect) < 4 * se,
          f"(d) config 2: mean wall count {walls.mean():.3f} vs the closed "
          f"form {expect:.3f} beyond 4 sigma ({4 * se:.3f})")
    star_stage_line("(d) config 2", out, run_s, stages)
    print(f"  seed 0: mean wall count per feed {walls.mean():.3f} against "
          f"the closed form {expect:.3f} (stationary {stationary:.3f}), 4 "
          f"sigma {4 * se:.3f}; {res0.n_posts} posts; build {b_s:.3f} s")
    return {"lanes": len(out["per_seed_top_k"]), "feeds": cfg.n_feeds,
            "events": out["events"], "build_s": b_s, "run_s": run_s,
            "events_per_s": out["events"] / run_s, "stages_s": stages,
            "mean_posts": out["mean_posts"],
            "mean_top1": out["mean_time_in_top_k"],
            "wall_mean": float(walls.mean()), "wall_closed_form": expect,
            "wall_stationary": stationary, "wall_4se": float(4 * se)}


def star_modes(cfg, wall, ctrl, seed, dev):
    """Seed ``seed`` through the star kernel in every (compression, fire
    mode) pair: ``{(compress, mode): outputs}``, each checked free of
    overflow."""
    from redqueen_tpu_torch.parallel import star_run

    keys = rt.sim._as_keys(np.array([seed]), torch.device(dev))
    wb, cb = wall.map(lambda x: x[None]), ctrl.map(lambda x: x[None])
    outs, secs = {}, {}
    for compress in (True, False):
        for mode in ("loop", "doubling"):
            sync(dev)
            t0 = time.perf_counter()
            out = star_run._get_fn(cfg, 1, compress, mode,
                                   torch.device(dev))(wb, cb, keys)
            sync(dev)
            secs[(compress, mode)] = time.perf_counter() - t0
            flags = [bool(f.any()) for f in out[5:8]]
            check(not any(flags), f"(e) compress={compress} {mode}: "
                                  f"overflow flags {flags}")
            outs[(compress, mode)] = out
    return outs, secs


def star_config4(dev, kw=PRESET_FULL[4], seeds=PRESET_SEEDS[4]):
    """(e) config 4 at its full settings, timed with its stages; seed 0 in
    both fire modes, compressed and not: bit-identical."""
    out, bundle, b_s, run_s, stages = timed_preset(4, kw, seeds, dev,
                                                   stages=True)
    _, cfg, wall, ctrl = bundle
    outs, secs = star_modes(cfg, wall, ctrl, 0, dev)
    modes = {f"{'compressed' if c else 'uncompressed'} {m}": v
             for (c, m), v in secs.items()}
    ref = outs[(True, "doubling")]
    n_bad = 0
    for key, o in outs.items():
        same = (torch.equal(bits(o[0]), bits(ref[0]))
                and all(torch.equal(bits(a), bits(b))
                        for a, b in zip(o[4][:3], ref[4][:3])))
        n_bad += not same
    check(n_bad == 0, f"(e) config 4: {n_bad} of 4 (compression, fire "
                      f"mode) runs differ from compressed doubling")
    n_posts = int(ref[1][0])
    star_stage_line("(e) config 4", out, run_s, stages)
    print(f"  seed 0 in 4 (compression, fire mode) runs, "
          + ", ".join(f"{k} {v:.3f} s" for k, v in modes.items())
          + f": bit-identical posts ({n_posts}) and metrics; build "
          f"{b_s:.3f} s for {cfg.n_feeds} feeds, wall_cap {cfg.wall_cap}")
    return {"lanes": len(out["per_seed_top_k"]), "feeds": cfg.n_feeds,
            "wall_cap": cfg.wall_cap, "events": out["events"],
            "build_s": b_s, "run_s": run_s,
            "events_per_s": out["events"] / run_s, "stages_s": stages,
            "mean_posts": out["mean_posts"],
            "mean_top1": out["mean_time_in_top_k"],
            "modes_identical": 4 - n_bad, "modes_s": modes,
            "seed0_posts": n_posts}


def ragged_pair(label, counts, opts, dev, engine):
    """Bucketed (max_buckets=8) against dense-padded (max_buckets=1),
    per lane bit for bit; event-kernel launches counted around the
    bucketed run."""
    from redqueen_tpu_torch.parallel.lanes import simulate_ragged

    seeds = np.arange(len(counts))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rb = simulate_ragged(counts, seeds, engine=engine, max_buckets=8,
                         return_logs=True, device=dev, **opts)
    t1 = time.perf_counter()
    launches = kernels.LAUNCHES["event_kernel"]
    rd = simulate_ragged(counts, seeds, engine=engine, max_buckets=1,
                         return_logs=True, device=dev, **opts)
    t2 = time.perf_counter()
    diffs = {"logs": int(sum(
        not (np.array_equal(tb.view(np.int32), td.view(np.int32))
             and np.array_equal(sb, sd))
        for (tb, sb), (td, sd) in zip(rb.logs, rd.logs)))}
    for f in ("n_events", "top_k", "posts", "health"):
        diffs[f] = int((getattr(rb, f) != getattr(rd, f)).sum())
    n_bad = sum(diffs.values())
    check(n_bad == 0, f"{label}: lanes differing between the bucketed and "
                      f"the dense-padded plan, by field: {diffs}")
    check((rb.health == 0).all(), f"{label}: sick lanes")
    on_card = torch.device(dev).type == "cuda"
    want = "scan" if engine == "scan" else ("cuda" if on_card else "plain")
    check(rb.engine == want, f"{label}: engine {rb.engine!r}, want {want!r}")
    if want == "cuda":
        check(launches == rb.dispatches > 0,
              f"{label}: {launches} event-kernel launches vs "
              f"{rb.dispatches} dispatches")
    else:
        check(launches == 0, f"{label}: the {want} route launched the "
                             f"event kernel {launches} times")
    res = {"lanes": len(counts), "max_count": int(counts.max()),
           "widths": list(rb.plan.widths), "events": rb.events,
           "bucketed_s": t1 - t0, "dense_s": t2 - t1,
           "events_per_s_bucketed": rb.events / (t1 - t0),
           "pad_frac_bucketed": rb.plan.pad_frac_bucketed,
           "pad_frac_dense": rb.plan.pad_frac_dense,
           "dispatches": rb.dispatches, "launches": launches,
           "lanes_differing": n_bad, "engine": rb.engine,
           "mean_top1": float(rb.top_k.mean())}
    print(f"phase 7 {label}: B={len(counts)} widths {list(rb.plan.widths)} "
          f"(max {int(counts.max())} followers), T={opts['end_time']}: "
          f"{rb.events} events; bucketed {t1 - t0:.3f} s "
          f"({rb.events / (t1 - t0):,.0f} events/s, pad "
          f"{rb.plan.pad_frac_bucketed:.1%}) vs dense {t2 - t1:.3f} s (pad "
          f"{rb.plan.pad_frac_dense:.1%}); lanes differing {n_bad}; "
          f"engine {rb.engine!r}, dispatches {rb.dispatches}, event-kernel "
          f"launches {launches}")
    return res


def power_law(dev, fused_kw=POWER_LAW_FUSED, scan_kw=POWER_LAW_SCAN):
    """(f) the kernel route and (g) the scan route of power-law ragged
    lanes."""
    from redqueen_tpu_torch.presets import build_preset

    _, counts, opts = build_preset("power_law", **fused_kw)
    res = {"fused": ragged_pair("(f) power_law, event kernel", counts, opts,
                                dev, "fused")}
    _, counts, opts = build_preset("power_law", **scan_kw)
    res["scan"] = ragged_pair("(g) power_law, scan engine", counts, opts,
                              dev, "scan")
    return res


def phase_presets(dev, fused):
    """Phase 7; ``fused`` is phase 5's (mean, std, lanes) of
    time-in-top-1."""
    t0 = time.perf_counter()
    # The lane layer's autotune cache: a file of this run's own.
    tmp = tempfile.mkdtemp(prefix="rq_autotune_")
    os.environ[ENV_AUTOTUNE] = os.path.join(tmp, "lanes_autotune.json")
    try:
        res = phase_presets_body(dev, fused)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 7 presets and star engine: {res['phase_s']:.1f} s")
    return res


def phase_presets_body(dev, fused):
    res = {"batch": preset_batch(dev, fused)}
    res["star_cross"] = {w: star_cross(w, kw, dev)
                         for w, kw in STAR_CROSS.items()}
    res["config2"] = star_config2(dev)
    res["config4"] = star_config4(dev)
    res["power_law"] = power_law(dev)
    return res


# ---- phase 8: the headline bench and config 5 (RMTPP) ----

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
BENCH_TIMEOUT_S = 600
# Config 5 at benchmarks/run.py's _FULL[5] (scale 1: 10 Poisson feeds of
# rate 1; T = 100; 1,024 seeds) with the preset's hidden 8, 120 fit steps
# and capacity 2,048.
CONFIG5_FULL = dict(scale=1.0, end_time=100.0, hidden=8, capacity=2048)
CONFIG5_SEEDS = 1024
CONFIG5_FIT_STEPS = 120
CONFIG5_ORACLE_SEEDS = 64
# (c): card against CPU; (e): the hidden-16 weights, gated.
CONFIG5_CROSS = dict(B=64, end_time=50.0, capacity=1024)
CONFIG5_NPZ = dict(B=256, end_time=100.0, capacity=2048)
FIT_RTOL = 1e-3


def bench_run(args=(), platform=None, timeout=BENCH_TIMEOUT_S):
    """(a) The bench as a user runs it, in its own process: its last
    stdout line, with both engines inside the oracle's gate."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_DIR)
    wall_s = time.perf_counter() - t0
    for ln in out.stderr.strip().splitlines()[-8:]:
        print(f"  bench: {ln}")
    check(out.returncode == 0, f"(a) the bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    platform = platform or torch.cuda.get_device_name(0)
    check(line["platform"] == platform,
          f"(a) bench platform {line['platform']!r}, expected {platform!r}")
    engines = line["engines"]
    check(set(engines) == {"scan", "fused"}, f"(a) engines {set(engines)}")
    for name, e in engines.items():
        check(e["gate_ok"] is True,
              f"(a) {name}: |engine - oracle| time-in-top-1 {e['gate']} "
              f"beyond {e['gate_tol']}")
    fused = engines["fused"]
    if platform != "cpu":
        check(fused["route"] == "cuda" and fused["launches"] > 0,
              f"(a) the fused engine ran {fused['route']!r} with "
              f"{fused['launches']} event-kernel launches")
    print(f"phase 8 (a) bench: {line['metric']}: {line['value']:,.1f} "
          f"events/s ({line['engine']}), {line['vs_baseline']}x the oracle "
          f"({line['oracle_events_per_sec']:,.1f} events/s); "
          + "; ".join(
              f"{n} {e['events_per_sec']:,.1f} events/s, time-in-top-1 "
              f"{e['top1']} vs oracle {e['oracle_top1']} (|d| {e['gate']} "
              f"<= {e['gate_tol']})" for n, e in engines.items())
          + f"; fused launches {fused['launches']}; {wall_s:.1f} s")
    return dict(line, wall_s=wall_s)


def oracle_rmtpp(weights, hidden, T, n_seeds, n_followers=10):
    """Posts and time-in-top-1 of ``oracle.numpy_ref.RMTPP`` with
    ``weights`` (as float64) over ``n_seeds`` components of the bench's
    oracle (``bench.oracle_components``)."""
    from redqueen_tpu_torch.bench import oracle_components
    from redqueen_tpu_torch.convert import rmtpp_weights_to_jax

    w64 = rt_map_weights(lambda a: np.asarray(a, np.float64),
                         rmtpp_weights_to_jax(weights))
    res = oracle_components(
        n_seeds, n_followers, T, 1.0,
        manager=lambda so, c: so.create_manager_with_rmtpp(
            seed=c, weights=w64, hidden=hidden))
    return res["posts"], res["top1"]


def gate_4se(label, got, want, floor):
    """The bench's 4-sigma gate (``bench.gate``) of the mean of ``got``
    against the oracle's ``want``, independent seeds on both sides."""
    from redqueen_tpu_torch.bench import gate

    d, tol = gate(*((x.mean(), x.std(), x.size) for x in (got, want)),
                  floor=floor)
    check(d <= tol, f"{label}: {got.mean():.4f} vs oracle {want.mean():.4f}"
                    f", |d| {d:.4f} beyond {tol:.4f}")
    return {"mean": float(got.mean()), "oracle_mean": float(want.mean()),
            "diff": float(d), "tol": float(tol)}


def rmtpp_batch(weights, B, end_time, capacity, dev, hidden):
    """Config 5's component with ``weights``, stacked ``B`` times on
    ``dev`` (``presets.batch_lanes``): ``(cfg, params, adj, row)``."""
    from redqueen_tpu_torch.presets import batch_lanes, build_preset

    bundle = build_preset(5, weights=weights, end_time=end_time,
                          capacity=capacity, hidden=hidden, device=dev)
    return batch_lanes(bundle, np.arange(B), dev)[:4]


def rmtpp_run(cfg, params, adj, row, seeds, dev):
    """``run_preset``'s batch run, simulate and metrics each timed to a
    sync: ``(log, top1 [B], posts [B], simulate s, metrics s)``."""
    from redqueen_tpu_torch.presets import batch_metrics

    t0 = time.perf_counter()
    log = rt.simulate_batch(cfg, params, adj, seeds, device=dev)
    sync(dev)
    t1 = time.perf_counter()
    top, posts, _ = batch_metrics(log, adj, row, cfg.end_time)
    sync(dev)
    return (log, top.double().cpu().numpy(), posts.double().cpu().numpy(),
            t1 - t0, time.perf_counter() - t1)


def config5_full(dev, kw=CONFIG5_FULL, n_seeds=CONFIG5_SEEDS,
                 fit_steps=CONFIG5_FIT_STEPS,
                 oracle_seeds=CONFIG5_ORACLE_SEEDS):
    """(b) Config 5 at full width, its weights fitted on ``dev``."""
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()
    t0 = time.perf_counter()
    weights, _, losses = rmtpp.fit(0, taus, mask, hidden=kw["hidden"],
                                   steps=fit_steps, device=dev)
    sync(dev)
    fit_s = time.perf_counter() - t0
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"(b) the fit's loss went {losses[0]:.4f} -> {losses[-1]:.4f}")
    cfg, params, adj, row = rmtpp_batch(weights, n_seeds, kw["end_time"],
                                        kw["capacity"], dev, kw["hidden"])
    log, top, posts, sim_s, met_s = rmtpp_run(cfg, params, adj, row,
                                              np.arange(n_seeds), dev)
    events = int(log.n_events.sum())
    check(log.engine == "scan" and bool((log.health == 0).all()),
          f"(b) engine {log.engine!r}, sick lanes "
          f"{int((log.health != 0).sum())}")
    check(np.isfinite(top).all() and ((top >= 0) & (top <= cfg.end_time))
          .all(), "(b) time-in-top-1 outside [0, T]")
    t1 = time.perf_counter()
    o_posts, o_top = oracle_rmtpp(weights, kw["hidden"], kw["end_time"],
                                  oracle_seeds)
    oracle_s = time.perf_counter() - t1
    g_posts = gate_4se("(b) config 5 mean posts", posts, o_posts,
                       0.02 * o_posts.mean())
    g_top = gate_4se("(b) config 5 mean time-in-top-1", top, o_top,
                     0.02 * kw["end_time"])
    res = {"seeds": n_seeds, "events": events, "fit_s": fit_s,
           "fit_steps": fit_steps, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "simulate_s": sim_s,
           "metrics_s": met_s, "steps": int(log.times.shape[1]),
           "ms_per_step": 1e3 * sim_s / log.times.shape[1],
           "events_per_s": events / (sim_s + met_s),
           "events_per_s_simulate_only": events / sim_s,
           "dispatches": log.dispatches, "posts": g_posts,
           "top1": g_top, "oracle_seeds": oracle_seeds,
           "oracle_s": oracle_s, "losses": losses.tolist()}
    print(f"phase 8 (b) config 5: fit {fit_steps} steps {fit_s:.3f} s "
          f"(loss {losses[0]:.4f} -> {losses[-1]:.4f}); {n_seeds} seeds: "
          f"{events} events, simulate {sim_s:.3f} s ({res['steps']} steps, "
          f"{res['ms_per_step']:.3f} ms each), metrics {met_s:.3f} s = "
          f"{res['events_per_s']:,.0f} events/s "
          f"({events / sim_s:,.0f} simulate only); mean posts "
          f"{g_posts['mean']:.3f} vs oracle {g_posts['oracle_mean']:.3f} "
          f"(tol {g_posts['tol']:.3f}); time-in-top-1 {g_top['mean']:.4f} "
          f"vs oracle {g_top['oracle_mean']:.4f} (tol {g_top['tol']:.4f}); "
          f"oracle {oracle_seeds} seeds {oracle_s:.1f} s")
    return res, weights


def config5_cross(weights, dev, B=None, end_time=None, capacity=None,
                  tag="phase 8 (c)"):
    """(c) The same weights and seeds on the card and on the CPU."""
    c = CONFIG5_CROSS
    B, end_time = B or c["B"], end_time or c["end_time"]
    capacity = capacity or c["capacity"]
    hidden = weights["v"]["kernel"].shape[-2]
    cfg, params, adj, _ = rmtpp_batch(weights, B, end_time, capacity, dev,
                                      hidden)
    card = rt.simulate_batch(cfg, params, adj, np.arange(B), device=dev)
    cpu = rt.simulate_batch(cfg, params.to("cpu"), adj.cpu(), np.arange(B),
                            device="cpu")
    return compare_devices(f"config 5 (hidden {hidden})", card, cpu,
                           end_time, tag=tag)


def rmtpp_stream_cross(weights, dev, n=256, T=100.0, cap=512):
    """(d) ``rmtpp_stream`` and an RMTPP-controlled star run (100 Poisson
    feeds), card against CPU: counts identical but for near-ties at the
    horizon, times within rtol 1e-5."""
    from redqueen_tpu_torch.ops import prng, streams

    hidden = int(weights["v"]["kernel"].shape[-2])
    keys = prng.split(prng.PRNGKey(7), n)
    w_cpu = rt_map_weights(lambda t: t.cpu(), weights)
    sc = streams.rmtpp_stream(weights, keys.to(dev), 0.0, T, cap, hidden)
    sp = streams.rmtpp_stream(w_cpu, keys, 0.0, T, cap, hidden)
    tc, tp = sc.times.cpu().double(), sp.times.double()
    same_n = sc.n.cpu() == sp.n
    fin = torch.isfinite(tp) & same_n[:, None]
    rel = ((tc - tp).abs() / tp.abs().clamp(min=1e-30))[fin]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    n_diff = int((~same_n).sum())
    check(n_diff <= NEAR_TIE_MAX_SHARE * n and max_rel <= NEAR_TIE_RTOL,
          f"(d) rmtpp_stream card vs CPU: {n_diff} of {n} counts differ, "
          f"max rel {max_rel:.3g}")
    sb = rt.StarBuilder(n_feeds=100, end_time=T)
    for f in range(100):
        sb.wall_poisson(f, 1.0)
    sb.ctrl_rmtpp(w_cpu, hidden=hidden)
    cfg, wall, ctrl = sb.build(wall_cap=256, post_cap=cap, device="cpu")
    star = {}
    for s in (0, 1):
        card = rt.simulate_star(cfg, wall.to(dev), ctrl.to(dev), seed=s,
                                device=dev)
        cpu = rt.simulate_star(cfg, wall, ctrl, seed=s, device="cpu")
        oc, op = card.own_times.cpu().double(), cpu.own_times.double()
        check(card.n_posts == cpu.n_posts,
              f"(d) star seed {s}: {card.n_posts} posts on the card, "
              f"{cpu.n_posts} on the CPU")
        fin = torch.isfinite(op)
        r = float(((oc - op).abs() / op.abs().clamp(min=1e-30))[fin].max())
        top_c = float(card.metrics.mean_time_in_top_k())
        top_p = float(cpu.metrics.mean_time_in_top_k())
        check(r <= NEAR_TIE_RTOL and abs(top_c - top_p) <= 1e-4 * top_p,
              f"(d) star seed {s}: post times rel {r:.3g}, time-in-top-1 "
              f"{top_c} vs {top_p}")
        star[s] = {"posts": card.n_posts, "max_rel_post": r,
                   "top1_card": top_c, "top1_cpu": top_p}
    print(f"phase 8 (d) rmtpp_stream card vs CPU: {n} streams, "
          f"{int(sc.n.sum())} events, counts differing {n_diff}, max rel "
          f"{max_rel:.3g}; RMTPP-controlled star (100 feeds): "
          + ", ".join(f"seed {s} {v['posts']} posts (rel "
                      f"{v['max_rel_post']:.3g})" for s, v in star.items()))
    return {"streams": n, "events": int(sc.n.sum()), "counts_differing":
            n_diff, "max_rel": max_rel, "star": star}


def config5_npz(dev, B=None, end_time=None, capacity=None,
                oracle_seeds=CONFIG5_ORACLE_SEEDS, cross=None):
    """(e) The committed hidden-16 weights: one run gated against the
    oracle, and (c)'s card-against-CPU run (``cross``: its ``B``,
    ``end_time`` and ``capacity``), which holds the hidden-16 path far
    tighter than the oracle's spread can."""
    c = CONFIG5_NPZ
    B, end_time = B or c["B"], end_time or c["end_time"]
    capacity = capacity or c["capacity"]
    weights, info = rt.load_rmtpp_npz(device=dev)
    cfg, params, adj, row = rmtpp_batch(weights, B, end_time, capacity, dev,
                                        16)
    log, top, posts, sim_s, met_s = rmtpp_run(cfg, params, adj, row,
                                              np.arange(B), dev)
    o_posts, o_top = oracle_rmtpp(weights, 16, end_time, oracle_seeds)
    g_posts = gate_4se("(e) hidden-16 mean posts", posts, o_posts,
                       0.02 * o_posts.mean())
    g_top = gate_4se("(e) hidden-16 mean time-in-top-1", top, o_top,
                     0.02 * end_time)
    events = int(log.n_events.sum())
    print(f"phase 8 (e) committed hidden-16 weights (held-out NLL "
          f"{float(info['heldout_nll']):.4f}): B={B}, {events} events in "
          f"{sim_s:.3f} s + metrics {met_s:.3f} s; posts {g_posts['mean']:.3f}"
          f" vs oracle {g_posts['oracle_mean']:.3f} (tol {g_posts['tol']:.3f})"
          f"; time-in-top-1 {g_top['mean']:.4f} vs oracle "
          f"{g_top['oracle_mean']:.4f} (tol {g_top['tol']:.4f})")
    xs = config5_cross(weights, dev, tag="phase 8 (e)", **(cross or {}))
    return {"B": B, "events": events, "simulate_s": sim_s,
            "metrics_s": met_s, "posts": g_posts, "top1": g_top,
            "cross": xs}


def fit_cross(card_losses, fit_steps=CONFIG5_FIT_STEPS, hidden=8):
    """(f) The CPU fit from the same initial weights as (b)'s card fit:
    the largest relative gap of the two loss curves."""
    from redqueen_tpu_torch.models import rmtpp
    from redqueen_tpu_torch.presets import config5_data

    taus, mask = config5_data()
    _, _, cpu = rmtpp.fit(0, taus, mask, hidden=hidden, steps=fit_steps,
                          device="cpu")
    card = np.asarray(card_losses)
    gap = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    check(gap <= FIT_RTOL, f"(f) fit card vs CPU: largest relative loss gap "
                           f"{gap:.3g} > {FIT_RTOL}")
    print(f"phase 8 (f) fit card vs CPU over {fit_steps} steps: largest "
          f"relative loss gap {gap:.3g} (last {card[-1]:.6f} vs "
          f"{cpu[-1]:.6f})")
    return {"max_rel_gap": gap, "loss_last_card": float(card[-1]),
            "loss_last_cpu": float(cpu[-1])}


def phase_config5(dev, bench_args=()):
    """Phase 8."""
    t0 = time.perf_counter()
    res = {"bench": bench_run(bench_args)}
    res["config5"], weights = config5_full(dev)
    res["cross"] = config5_cross(weights, dev)
    res["streams"] = rmtpp_stream_cross(weights, dev)
    res["npz"] = config5_npz(dev)
    res["fit"] = fit_cross(res["config5"]["losses"])
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 8 bench and config 5: {res['phase_s']:.1f} s")
    return res


# ---- phase 9: the learn path (the hawkes_pass kernel, EM, FW, corpus) ----

# experiments/closed_loop.py:48-61 (copied: that file imports the JAX
# package): the 3-dim self-exciting world and its recovery tolerances.
WORLD_MU = np.array([0.3, 0.5, 0.4])
WORLD_ALPHA = np.array([0.8, 0.5, 0.6])
WORLD_BETA = np.array([2.0, 1.5, 2.5])
WORLD = dict(end_time=600.0, capacity=4096, seed=7)
RECOVER_TOLERANCES = {"mu_rel_err": 0.40, "branching_abs_err": 0.15,
                      "beta_rel_err": 0.60}
# benchmarks/run.py:283-324: EM 150 iterations, FW 300 after a 30-sweep
# EM warm-up of beta, both at tol 1e-7, each after a warm-up fit.
RECOVER_ITERS = {"em": 150, "fw": 300}
RECOVER_FW_WARMUP = 30
RECOVER_TOL = 1e-7
# The card's fitted parameters against the CPU's (mu, beta relative;
# alpha relative to its largest entry), and final log-likelihoods.  The
# passes differ by float32 ulps (expf/logf, the order of the sum over
# dimensions), and EM's stopping rule can then stop at another sync
# window: the port's CPU fit against the JAX package's stopped at 72
# against 80 iterations with parameters 8.4e-4 apart.
RECOVER_CARD_CPU_RTOL = 5e-3
RECOVER_LL_RTOL = 1e-5
# (c): the config-4 corpus (benchmarks/run.py:326-345, LEARN_BENCH.json):
# 100,000 synthetic users grouped by hash into 64 dimensions, chunks of
# 4,096 events.
CORPUS = dict(seed=7, n_users=100_000, end_time=100.0, mean_rate=1.0,
              max_len=256, n_dims=64)
CORPUS_ROWS = 8_581_381
CORPUS_CHUNK_SHAPE = (2304, 4096)
CORPUS_ITERS = (1, 1, 3)
# Kernel against plain version: every output within PASS_RTOL of its
# largest magnitude (float32 per-chunk sums in another order, expf/logf
# ulps), health equal.
PASS_RTOL = 1e-4
EM_DROP_RTOL = 1e-3          # tests/test_learn.py::test_em_loglik_monotone
RESPONSIBILITY_RTOL = 1e-4   # |sum s0 + sum S - n_events| / n_events
# Operations per (event, dimension) of a pass, as the algorithm needs
# them: stats mode the decay (multiply, exp), Q (3), R (1), alpha_ij R_j,
# the sum, S (divide, add) and W (multiply, divide, add); grad mode the
# decay, R, alpha_ij R_j, the sum and g_alpha (multiply, add).
OPS_PASS = {False: 13, True: 7}


def pass_stream(D, n, K, seed, degenerate=True):
    """A random stream of ``n`` events over ``D`` dimensions in chunks of
    ``K`` (padded; dimension 0 degenerate: mu 0 and no excitation, so its
    health bit trips) and its ``(mu, alpha, beta)``."""
    rng = np.random.RandomState(seed)
    T = 50.0
    times = np.sort(rng.uniform(0, T, n))
    dims = rng.randint(0, D, n)
    mu = rng.uniform(0.1, 1.0, D)
    alpha = rng.uniform(0.0, 0.5, (D, D)) / max(D / 8, 1)
    beta = rng.uniform(0.5, 3.0, D)
    if degenerate:
        mu[0] = 0.0
        alpha[0, :] = 0.0
    ch = rt.learn.chunk_events(
        rt.learn.ingest.make_stream(times, dims, D, t_end=T), K)
    return ch, mu, alpha, beta


def pass_inputs(ch, mu, alpha, beta, dev):
    ev = rt.learn.loglik.to_device(ch, dev)
    f = [torch.as_tensor(np.asarray(x, np.float32)).to(dev)
         for x in (mu, alpha, beta)]
    return (ev.dt, ev.dims, ev.mask, ev.tail, *f)


def pass_cross(label, ch, mu, alpha, beta, dev, grad, reps=1):
    """The kernel and its plain version on the same tensors on ``dev``
    (each run ``reps`` times, the last one timed, host clock around a
    device sync): every per-chunk output within PASS_RTOL of its largest
    magnitude, health equal.  Returns the errors and each side's
    milliseconds."""
    from redqueen_tpu_torch.learn import loglik

    args = pass_inputs(ch, mu, alpha, beta, dev)
    times = {}
    outs = {}
    for name, fn in (("kernel", loglik.hawkes_pass),
                     ("plain", loglik.hawkes_pass_plain)):
        for _ in range(reps):  # the last run is timed warm
            sync(dev)
            t0 = time.perf_counter()
            outs[name] = fn(*args, grad=grad)
            sync(dev)
            times[name] = (time.perf_counter() - t0) * 1e3
    k, p = outs["kernel"], outs["plain"]
    names = ("ll", "a", "b", "w", "e")
    err = {}
    for nm, x, y in zip(names, k[:5], p[:5]):
        x, y = x.double().cpu(), y.double().cpu()
        scale = float(y.abs().max())
        d = float((x - y).abs().max())
        err[nm] = (d, d / max(scale, 1e-30))
        check(bool(torch.isfinite(x).all()) and d <= PASS_RTOL * scale,
              f"{label}: {nm} kernel against plain |d| {d:.3g} beyond "
              f"{PASS_RTOL} x {scale:.3g}")
    hk, hp = k[5].cpu(), p[5].cpu()
    check(torch.equal(hk, hp), f"{label}: health {hk.tolist()} against "
                               f"the plain version's {hp.tolist()}")
    C, K = ch.dt.shape
    print(f"{label}: D={ch.n_dims}, {ch.n_events} events in {C} chunks of "
          f"{K}, {'grad' if grad else 'stats'} mode: largest |d| "
          + ", ".join(f"{n} {e[0]:.3g} ({e[1]:.3g} rel)"
                      for n, e in err.items())
          + f"; health {hk.tolist()[:8]} equal; kernel {times['kernel']:.3f} "
          f"ms, plain {times['plain']:.1f} ms")
    return {"max_abs_err": max(e[0] for e in err.values()),
            "max_rel_err": max(e[1] for e in err.values()),
            "health": hk.tolist(), "kernel_ms": times["kernel"],
            "plain_ms": times["plain"]}


def pass_parity(dev, small=(5, 3000, 1024), wide=(64, 8, 512)):
    """(a): both modes on a D = 5 stream (padding, chunk boundaries, a
    degenerate dimension) and on a D = 64 stream of 8 chunks."""
    D, n, K = small
    ch5 = pass_stream(D, n, K, seed=5)
    check(ch5[0].dt.shape[0] > 1 and not ch5[0].mask.all(),
          "(a) the D = 5 stream has no chunk boundary or no padding")
    D, C, K = wide
    ch64 = pass_stream(D, C * K - K // 2, K, seed=64)
    check(ch64[0].dt.shape[0] == C, f"(a) {ch64[0].dt.shape[0]} chunks")
    out = {}
    for key, ch in (("d5", ch5), ("d64", ch64)):
        for grad in (False, True):
            out[f"{key}_{'grad' if grad else 'stats'}"] = r = pass_cross(
                f"phase 9 (a) {key}", *ch, dev, grad, reps=2)
            if key == "d5":
                check(r["health"][0] != 0 and not any(r["health"][1:]),
                      f"(a) health {r['health']}: dimension 0 should "
                      f"trip alone")
    return out


def world_stream(dev, world=WORLD):
    """The closed-loop world simulated by the port on ``dev`` with the
    scan engine, as a fit stream."""
    gb = rt.GraphBuilder(n_sinks=3, end_time=world["end_time"])
    rows = gb.add_hawkes(WORLD_MU, WORLD_ALPHA, WORLD_BETA)
    cfg, params, adj = gb.build(capacity=world["capacity"], device=dev)
    log = rt.simulate(cfg, params, adj, seed=world["seed"], device=dev)
    return rt.learn.from_event_log(log, sources=rows)


def recover_fit(stream, solver, dev, iters=None, warmup=RECOVER_FW_WARMUP):
    """One timed fit after a warm-up fit: ``(fit, seconds, sweeps)``,
    sweeps counting FW's EM warm-up too."""
    iters = RECOVER_ITERS[solver] if iters is None else iters
    rt.learn.fit_hawkes(stream, solver=solver, max_iters=2,
                        fw_beta_warmup=2, device=dev)
    before = kernels.LAUNCHES["hawkes_pass"]
    t0 = time.perf_counter()
    fit = rt.learn.fit_hawkes(stream, solver=solver, max_iters=iters,
                              tol=RECOVER_TOL, fw_beta_warmup=warmup,
                              device=dev)
    secs = time.perf_counter() - t0
    sweeps = fit.n_iter + (warmup if solver == "fw" else 0)
    if torch.device(dev).type == "cuda":
        # Every pass went through the kernel: one per sweep, FW's G, the
        # final score (and a second score if quarantine changed a value).
        want = sweeps + (1 if solver == "fw" else 0) + 1
        got = kernels.LAUNCHES["hawkes_pass"] - before
        check(got - want in (0, 1),
              f"(b) {solver}: {got} hawkes_pass launches for {want} passes")
    return fit, secs, sweeps


def recover_errors(fit):
    br = np.diag(fit.branching())
    return {
        "mu_rel_err": float(np.max(np.abs(fit.mu - WORLD_MU) / WORLD_MU)),
        "branching_abs_err": float(np.max(np.abs(
            br - WORLD_ALPHA / WORLD_BETA))),
        "beta_rel_err": float(np.max(np.abs(fit.beta - WORLD_BETA)
                                     / WORLD_BETA))}


def recover_check(label, fit, ll_true):
    """closed_loop's recovery gate: health zero, each error within its
    tolerance, and the fit scoring at least the truth's likelihood - 1."""
    errs = recover_errors(fit)
    check(not fit.health.any(), f"{label}: health {fit.health.tolist()}")
    for k, tol in RECOVER_TOLERANCES.items():
        check(errs[k] <= tol, f"{label}: {k} {errs[k]:.4f} beyond {tol}")
    check(fit.final_loglik >= ll_true - 1.0,
          f"{label}: final log-likelihood {fit.final_loglik:.3f} below the "
          f"truth's {ll_true:.3f} - 1")
    return errs


def fits_agree(label, card, cpu):
    """The card's fit against the CPU's from the same stream."""
    gaps = {
        "mu": float(np.max(np.abs(card.mu - cpu.mu) / np.abs(cpu.mu))),
        "beta": float(np.max(np.abs(card.beta - cpu.beta)
                             / np.abs(cpu.beta))),
        "alpha": float(np.max(np.abs(card.alpha - cpu.alpha))
                       / max(float(np.abs(cpu.alpha).max()), 1e-30)),
        "final_loglik": abs(card.final_loglik - cpu.final_loglik)
        / abs(cpu.final_loglik)}
    for k in ("mu", "beta", "alpha"):
        check(gaps[k] <= RECOVER_CARD_CPU_RTOL,
              f"{label}: card {k} {gaps[k]:.3g} from the CPU's, beyond "
              f"{RECOVER_CARD_CPU_RTOL}")
    check(gaps["final_loglik"] <= RECOVER_LL_RTOL,
          f"{label}: final log-likelihood {card.final_loglik} on the card, "
          f"{cpu.final_loglik} on the CPU")
    return gaps


def recover(dev, world=WORLD, iters=None):
    """(b): simulate the world on ``dev``, fit it with EM and FW there
    (the main path, its kernel launches counted from 0) and on the CPU,
    gate each."""
    stream = world_stream(dev, world)
    ll_true = rt.learn.hawkes_loglik(stream, WORLD_MU, np.diag(WORLD_ALPHA),
                                     WORLD_BETA, device=dev).loglik
    out = {"n_events": stream.n_events, "ll_true": ll_true}
    n = {s: None if iters is None else iters[s] for s in ("em", "fw")}
    # The main path, with the counts set to 0 just before it and read
    # just after: both fits on ``dev``.
    kernels.reset_launch_counts()
    card = {s: recover_fit(stream, s, dev, n[s]) for s in ("em", "fw")}
    out["launches"] = kernels.LAUNCHES["hawkes_pass"]
    for solver in ("em", "fw"):
        fit, secs, sweeps = card[solver]
        cpu, cpu_secs, _ = recover_fit(stream, solver, torch.device("cpu"),
                                       n[solver])
        label = f"phase 9 (b) {solver}"
        errs = recover_check(label, fit, ll_true)
        recover_check(f"{label} (CPU)", cpu, ll_true)
        gaps = fits_agree(label, fit, cpu)
        out[solver] = {
            "iters": fit.n_iter, "converged": fit.converged, "secs": secs,
            "sweeps": sweeps,
            "events_per_s": stream.n_events * sweeps / max(secs, 1e-9),
            "cpu_iters": cpu.n_iter, "cpu_secs": cpu_secs,
            "final_loglik": fit.final_loglik, "errors": errs,
            "card_vs_cpu": gaps}
        print(f"{label}: {stream.n_events} events, {fit.n_iter} iterations "
              f"(converged {fit.converged}) + {sweeps - fit.n_iter} warm-up "
              f"sweeps in {secs:.3f} s = "
              f"{out[solver]['events_per_s']:,.0f} events/s; CPU "
              f"{cpu.n_iter} iterations in {cpu_secs:.2f} s; errors "
              + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
              + f"; final log-likelihood {fit.final_loglik:.3f} (truth "
              f"{ll_true:.3f}); card against CPU "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    return out


def corpus_chunks(corpus=CORPUS):
    """The config-4 corpus as the reference's learn bench builds it, cut
    to ``corpus`` (the full one by default)."""
    from redqueen_tpu_torch.data.traces import synthetic_twitter

    t0 = time.perf_counter()
    traces = synthetic_twitter(corpus["seed"], corpus["n_users"],
                               corpus["end_time"],
                               mean_rate=corpus["mean_rate"],
                               max_len=corpus["max_len"])
    stream = rt.learn.from_traces(traces, n_dims=corpus["n_dims"],
                                  assign="hash",
                                  t_end=corpus["end_time"])
    return rt.learn.chunk_events(stream), time.perf_counter() - t0


def corpus_bound(ch, grad=False):
    """Least time of one pass over ``ch``: bytes (every input read once,
    every output written once) over HBM bandwidth, and the operations
    this stream's events need over the float32 issue rate."""
    C, K = ch.dt.shape
    D = ch.n_dims
    in_bytes = C * K * (4 + 4 + 1 + 4) + (2 * D + D * D) * 4
    out_bytes = (C * (1 + 3 * D + D * D) + D) * 4
    ops = ch.n_events * D * OPS_PASS[grad]
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ISSUE_PER_S * 1e3
    return {"bytes": in_bytes + out_bytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed_pass(ch, mu, alpha, beta, dev, reps=2):
    """Milliseconds of one kernel pass over ``ch`` on the device
    (CUDA events around each launch), and the last pass's partials."""
    from redqueen_tpu_torch.learn import loglik

    args = pass_inputs(ch, mu, alpha, beta, dev)
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = loglik.hawkes_pass(*args)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return ms, out


def responsibilities_identity(out, n_events):
    """Each event's p0 + sum_j pr_j is 1, so sum s0 + sum S is the event
    count on a healthy pass."""
    total = float(out[1].double().sum() + out[2].double().sum())
    gap = abs(total - n_events)
    check(gap <= RESPONSIBILITY_RTOL * n_events,
          f"(c) sum s0 + sum S = {total:.1f} against {n_events} events")
    return total, gap


def corpus_fit(dev, corpus=CORPUS, rows=CORPUS_ROWS,
               chunk_shape=CORPUS_CHUNK_SHAPE, iters=CORPUS_ITERS,
               timed=None):
    """(c): EM on the corpus at ``iters`` iterations, each fit timed to
    its end (``fit_hawkes`` returns host values), the marginal seconds
    per iteration (warm-3 - warm-1) / 2 as benchmarks/run.py:336-358
    takes them, and the gates."""
    ch, build_s = corpus_chunks(corpus)
    check(ch.n_events == rows, f"(c) corpus of {ch.n_events} rows, "
                               f"expected {rows}")
    check(tuple(ch.dt.shape) == tuple(chunk_shape),
          f"(c) chunk shape {tuple(ch.dt.shape)}, expected {chunk_shape}")
    walls, fits = [], []
    kernels.reset_launch_counts()  # the main path: counts from 0
    for n in iters:
        t0 = time.perf_counter()
        fits.append(rt.learn.fit_hawkes(ch, solver="em", max_iters=n,
                                        tol=0.0, device=dev))
        walls.append(time.perf_counter() - t0)
    launches = kernels.LAUNCHES["hawkes_pass"]
    fit = fits[-1]
    check(not fit.health.any(), f"(c) health {fit.health.tolist()}")
    curve = fit.loglik
    drops = np.diff(curve)
    check(len(curve) == iters[-1] and (
        drops.min(initial=0.0) >= -abs(curve[-1]) * EM_DROP_RTOL),
        f"(c) the EM curve {curve.tolist()} falls by more than "
        f"{EM_DROP_RTOL} relative")
    per_iter = max((walls[2] - walls[1]) / max(iters[2] - iters[1], 1),
                   1e-9)
    res = {"rows": ch.n_events, "chunk_shape": list(ch.dt.shape),
           "n_dims": ch.n_dims, "build_s": build_s, "walls_s": walls,
           "secs_per_iter": per_iter,
           "events_per_s_fitted": ch.n_events / per_iter,
           "launches": launches, "curve": curve.tolist()}
    return res, ch, fit


def corpus_pass_checks(ch, fit, dev, n_compare=8):
    """(c)'s pass checks at the fitted parameters: the kernel timed on
    the whole corpus, the responsibilities identity, and the kernel
    against its plain version on the first ``n_compare`` chunks."""
    ms, out = timed_pass(ch, fit.mu, fit.alpha, fit.beta, dev)
    total, gap = responsibilities_identity(out, ch.n_events)
    head = ch._replace(dt=ch.dt[:n_compare], dims=ch.dims[:n_compare],
                       mask=ch.mask[:n_compare], tail=ch.tail[:n_compare],
                       n_events=int(ch.mask[:n_compare].sum()))
    cross = pass_cross(f"phase 9 (c) first {n_compare} chunks", head,
                       fit.mu, fit.alpha, fit.beta, dev, grad=False)
    return {"kernel_ms": ms, "responsibility_sum": total,
            "responsibility_gap": gap, "cross": cross,
            "bound": corpus_bound(ch)}


def phase_learn(dev):
    """Phase 9."""
    t0 = time.perf_counter()
    res = {"parity": pass_parity(dev)}
    res["recover"] = recover(dev)
    res["corpus"], ch, fit = corpus_fit(dev)
    res["corpus"].update(corpus_pass_checks(ch, fit, dev))
    c = res["corpus"]
    res["launches"] = res["recover"]["launches"] + c["launches"]
    check(res["launches"] > 0, "phase 9: the fits launched no hawkes_pass")
    print(f"phase 9 (c) corpus: {c['rows']} events x {c['n_dims']} dims in "
          f"chunks {c['chunk_shape']} (built in {c['build_s']:.1f} s); EM "
          f"walls {['%.3f' % w for w in c['walls_s']]} s for "
          f"{list(CORPUS_ITERS)} iterations: {c['secs_per_iter']:.3f} s per "
          f"iteration = {c['events_per_s_fitted']:,.0f} events/s fitted; "
          f"hawkes_pass launches {c['launches']}; kernel "
          f"{['%.2f' % m for m in c['kernel_ms']]} ms per pass against a "
          f"bound of {c['bound']['bound_ms']:.4f} ms by "
          f"{c['bound']['bound_by']}; sum s0 + sum S - n_events "
          f"{c['responsibility_gap']:.3g}; curve {c['curve']}")
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 9 learn: {res['phase_s']:.1f} s, hawkes_pass launches on "
          f"the main path {res['launches']}")
    return res


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
