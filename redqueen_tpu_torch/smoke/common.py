"""Shared helpers of the smoke run's phases: the check that ends the
run, the one timer of a hand kernel (:func:`time_launches`) and the one
builder of a row of the kernel table (:func:`kernel_row`).  The card's
rates that the bounds divide by are ``utils.roofline``'s."""

import statistics
import sys
import time

import torch


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


# Cycles the card sleeps before a call timed on the device alone: about
# 10 ms, longer than any wrapper's host work once its memory comes from
# the allocator's cache.
SLEEP_CYCLES = 20_000_000


def time_launches(fn, *args, reps=1, device_alone=True, **kwargs):
    """``fn(*args, **kwargs)`` once untimed, then ``reps`` times timed
    with CUDA events: ``(device_ms, with_host_ms, last output)``.

    On the device alone, the stream first sleeps ``SLEEP_CYCLES`` and the
    host prepares the launch meanwhile, so the work starts right after
    the first event; the run fails if the host took longer than the
    sleep.  With the host's work, the events are recorded right around
    the call, so the card idles while the host prepares it.  With
    ``device_alone=False`` only the second is taken (for a plain
    version, whose many small operations the host issues one by one) and
    ``device_ms`` is empty."""
    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    device_ms, host_ms = [], []
    for _ in range(reps):
        if device_alone:
            out = None  # the allocator reuses the last output's memory
            z, a, b = events(3)
            z.record()
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            h0 = time.perf_counter()
            out = fn(*args, **kwargs)
            took = (time.perf_counter() - h0) * 1e3
            b.record()
            torch.cuda.synchronize()
            check(took < z.elapsed_time(a),
                  f"the host took {took:.3f} ms to launch, longer than the "
                  f"{z.elapsed_time(a):.3f} ms sleep")
            device_ms.append(a.elapsed_time(b))
        out = None
        a, b = events(2)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        torch.cuda.synchronize()
        host_ms.append(a.elapsed_time(b))
    return device_ms, host_ms, out


def kernel_row(name, replaces, device_ms, with_host_ms, plain_ms, bound,
               max_abs_err, launches_by_phase, plain_shape=None,
               phase_share=None):
    """The kernel table's row of ``csrc/<name>.cu``: ``ms`` and
    ``ms_with_host`` the medians of :func:`time_launches`' two lists,
    ``plain_ms`` the median of the plain version's milliseconds with the
    host's work, taken at ``plain_shape`` where that is not the shape of
    ``ms`` (else null), ``bound`` (``utils.roofline.bound``'s
    ``bound_ms`` and ``bound_by``) at the shape of ``ms``, the launches
    of each phase, and the share of each of the kernel's phases where it
    has more than one (else null)."""
    return {
        "name": name, "route": "cuda",
        "source": f"redqueen_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": sum(launches_by_phase.values()),
        "launches_by_phase": dict(launches_by_phase),
        "max_abs_err": max_abs_err,
        "ms": statistics.median(device_ms),
        "ms_with_host": statistics.median(with_host_ms),
        "plain_ms": statistics.median(plain_ms), "plain_shape": plain_shape,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "phase_share": phase_share, "library_ms": None,
    }


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
