"""Phase 14 of the smoke run: the Hawkes thinning kernel
(``csrc/hawkes_thin.cu``) at the star cell's shape, on one card: 256
lanes x 1,000 config-2 Hawkes sources (``l0`` 0.5, alpha 0.8, beta 2.0)
to T = 100 into rows of 1,024.  Also runs alone:

    python -m redqueen_tpu_torch.smoke.hawkes_thin [--out hawkes_thin.json]

The kernel's launch is timed by ``common.time_launches`` (10 streams
after an untimed one), and so is the plain loop
``streams._hawkes_stream_plain`` on the same keys (with the host's
work), whose streams must equal ``streams.hawkes_stream``'s bit for bit.
The bound counts the work the streams need (every proposal's five
threefry blocks, every event's chain key, each source's first; each row
written once) at ``utils.roofline``'s rates.  Alone, it prints one JSON
line, also written to ``--out``, and exits 2 without a card."""

import argparse
import gc
import json
import sys
import time

import torch

from redqueen_tpu_torch.ops import kernels, prng, streams, threefry
from redqueen_tpu_torch.utils import roofline
from .common import check, time_launches

LANES, FEEDS, T_END, CAP, REPS = 256, 1000, 100.0, 1024, 10
L0, ALPHA, BETA = 0.5, 0.8, 2.0
#: Integer and float instructions of a proposal beyond its five threefry
#: blocks (two uniforms, the inversion, the new time, the intensity, the
#: test) and of an event beyond its chain key (the excitation's update).
BLOCK_OPS, PROPOSAL_FLOPS, EVENT_FLOPS = 74, 56, 24


def bound(sources: int, events: int, cap: int) -> dict:
    """The least time of the streams: at least ``events + sources``
    proposals of five blocks each, a chain key an event and a source,
    and the rows, the parameters and the keys each moved once."""
    E, S = float(events), float(sources)
    int_ops = BLOCK_OPS * (5 * (E + S) + E + S)
    flops = PROPOSAL_FLOPS * (E + S) + EVENT_FLOPS * E
    nbytes = S * cap * 4 + S * (8 + 12) + S * 5
    return roofline.bound(nbytes, ops=int_ops + flops, int_ops=int_ops)


def max_abs_err(got, want) -> float:
    """The largest difference between two streams' times: +inf where one
    holds an event and the other does not, else over the events."""
    fin = torch.isfinite(want.times)
    if not torch.equal(fin, torch.isfinite(got.times)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((got.times[fin] - want.times[fin]).abs().max())


def phase_hawkes_thin(dev):
    """Phase 14: the kernel against the plain loop at the cell's shape,
    timed, with its bound and its launches."""
    t_start = time.perf_counter()
    ptxas = [ln.strip() for ln in kernels.BUILD_LOG.get("hawkes_thin", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    N = LANES * FEEDS
    key = prng.fold_in(prng.PRNGKey(torch.tensor(2 ** 31 + 11)),
                       torch.arange(N)).to(dev)
    l0, alpha, beta = (torch.full((N,), x, device=dev)
                       for x in (L0, ALPHA, BETA))
    bits = threefry.to_bits32(key)
    kernels.reset_launch_counts()

    def launch():
        return kernels.launch_hawkes_thin(bits, l0, alpha, beta, 0.0, T_END,
                                          CAP)

    times, n, trunc, steps = launch()
    # The earlier phases' cached blocks handed back first: the timed rows
    # then come from the allocator's cache, and no timed launch waits for
    # a cudaMalloc or a cudaFree (which would wait for the sleep).
    gc.collect()
    torch.cuda.empty_cache()
    dev_ms, host_ms, _ = time_launches(launch, reps=REPS)
    got = streams.hawkes_stream(key, l0, alpha, beta, 0.0, T_END, CAP)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["hawkes_thin"]
    check(launches == 2 * REPS + 3,
          f"phase 14: {launches} kernel launches for {2 * REPS + 3} streams")
    _, plain_ms, want = time_launches(
        streams._hawkes_stream_plain, key, l0, alpha, beta, 0.0, T_END, CAP,
        device_alone=False)
    check(kernels.LAUNCHES["hawkes_thin"] == launches,
          "phase 14: the plain loop launched the kernel")
    same = (torch.equal(got.times.view(torch.int32),
                        want.times.view(torch.int32))
            and torch.equal(got.n, want.n)
            and torch.equal(got.truncated, want.truncated))
    err = max_abs_err(got, want)
    events = int(n.sum())
    b_ = bound(N, events, CAP)
    res = {
        "card": torch.cuda.get_device_name(0), "sources": N, "cap": CAP,
        "events": events, "truncated": int(trunc.sum()),
        "steps": int(steps.item()), "ptxas": ptxas,
        "ms_device": dev_ms, "ms_with_host": host_ms, "plain_ms": plain_ms,
        "bit_identical": bool(same), "max_abs_err": err,
        "launches": launches, "bound": b_,
    }
    check(same, f"phase 14: the kernel's streams differ from the plain "
                f"loop's (max_abs_err {err})")
    res["phase_s"] = time.perf_counter() - t_start
    print(f"phase 14 hawkes_thin: {N} sources x cap {CAP}, {events} events, "
          f"{res['steps']} steps; ms on the device "
          f"{['%.3f' % x for x in dev_ms]}, with the host's work "
          f"{['%.3f' % x for x in host_ms]}, bound {b_['bound_ms']:.3f} "
          f"({b_['bound_by']}); plain loop {plain_ms[0]:.1f} ms, "
          f"bit-identical; {res['phase_s']:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hawkes_thin: no card", file=sys.stderr)
        return 2
    _, build_s = kernels.build()
    res = phase_hawkes_thin(torch.device("cuda", 0))
    res["build_s"] = build_s
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
