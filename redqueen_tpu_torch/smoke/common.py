"""Shared helpers of the smoke run's phases: the card's rates that the
bounds divide by, the check that ends the run, and the CUDA-event
timers."""

import sys
import time

import torch


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


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


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


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
