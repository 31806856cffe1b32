"""Phases 1-5 of the smoke run: the device, the build of every kernel,
threefry, the event kernel against its plain version on every mix, and
the headline through the fused engine (``chip_smoke.py`` lists what each
checks)."""

import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

import redqueen_tpu_torch as rt
from redqueen_tpu_torch.ops import event_engine, event_step, kernels
from redqueen_tpu_torch.ops.threefry import (
    from_bits32,
    threefry2x32,
    to_bits32,
)
from redqueen_tpu_torch.runtime import faultinject, numerics
from redqueen_tpu_torch.utils import roofline
from .common import (
    check,
    timed,
    timed_on_device,
)


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


def bound_for(prep, carry, n_launches):
    """Least time for the run's kernel work: bytes (each input read once,
    each output written once) over HBM bandwidth, and operations (counted
    from this run's events and react draws) over the issue rate, integer
    ones over the INT32 rate, whichever is slower (``utils.roofline``)."""
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
    return {"bytes": nbytes, "ops": ops, "int_ops": int_ops,
            "float_ops": float_ops,
            **roofline.bound(nbytes, ops, int_ops),
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
