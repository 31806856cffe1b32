"""The card's peaks and the least time the simulate layer's work could
take on it, counted from the run's events and the component's shape only.

Peaks: NVIDIA H100 SXM5 (the "NVIDIA H100 80GB HBM3" card), at its full
700 W power limit.  HBM3 moves 3.35 TB/s (data sheet).  132 SMs at a
1.98 GHz boost clock (Hopper white paper) each issue at most 128
thread-instructions a clock (four schedulers, one warp instruction each),
and integer instructions run on 64 INT32 lanes an SM.

Work: what the algorithm needs for these events, whatever implements
it.  Nothing here depends on how the events were computed: not on
launches, chunk capacity, padded or absorbed steps, or an engine's carry.

- every event: the argmin over the S clocks that picks it (a compare and
  a select a source, the NaN test, the lane's gating);
- every event of a Poisson source: one draw (a threefry-2x32 block and
  the Exp(1) inversion) and its new clock, write-back and log entry;
- every event of an Opt source: its cancel, write-back and log entry;
- every event of another source that posts into a feed an Opt row
  follows: that row's re-draw (a block, the inversion, the candidate and
  the min);
- once a lane: each Opt row's rate sum ``sum_f sqrt(s_f / q)`` with every
  other source;
- bytes: each lane's parameters and seed read once, and each event's log
  entry (a float32 time and an int32 source) written once.

The instruction counts are those of the event kernel's reckoning: a
threefry-2x32 block is the parity word (one three-input logic op), 2
initial key adds, 20 rounds of add, rotate (one funnel shift) and xor,
5 key injections of one add a word, and the word extraction: 74 integer
instructions; the Exp(1) inversion an integer shift, then convert,
scale, negate, ``log1pf`` (about 20) and negate: 24 float."""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "ISSUE_PER_S", "INT32_PER_S", "work",
           "least_s"]

HBM_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
ISSUE_PER_S = SMS * 128 * CLOCK_HZ
INT32_PER_S = SMS * 64 * CLOCK_HZ

#: (integer, float) instructions of one draw: a block and the inversion.
DRAW = (1 + 2 + 20 * 3 + 5 * 2 + 1, 24)
#: The new clock (a divide and an add), its write-back and the log entry.
RESAMPLE = (0, 12)
#: An Opt row's candidate and min beside its draw.
REACT = (0, 4)


def argmin_ops(S: int):
    """The argmin over S clocks that picks one event."""
    return 8, 3 * S


def rate_sum_ops(F: int):
    """One rate sum over F feeds: two loads multiplied, a divide, a
    square root, a multiply and an add a feed, and two more."""
    return 0, 5 * F + 2


def work(kind_is_opt, adj, counts, lanes: int) -> dict:
    """Integer and float instructions and bytes of a batch of ``lanes``
    lanes of one component whose sources fired ``counts`` [S] events in
    all.  ``kind_is_opt`` [S] marks the Opt rows and ``adj`` [S, F] who
    posts into which feed."""
    kind_is_opt = np.asarray(kind_is_opt, bool)
    adj = np.asarray(adj, bool)
    S, F = adj.shape
    L = int(lanes)
    counts = np.asarray(counts, np.float64)
    opt_rows = np.flatnonzero(kind_is_opt)
    # Re-draws: each event of source s makes one for every Opt row r != s
    # that shares a feed with s.
    shares = (adj[opt_rows].astype(np.int64) @ adj.T.astype(np.int64)) > 0
    shares[np.arange(len(opt_rows)), opt_rows] = False
    redraws_per_src = shares.sum(0)
    events = counts.sum()
    poisson_ev = counts[~kind_is_opt].sum()
    opt_ev = counts[kind_is_opt].sum()
    redraws = float((counts * redraws_per_src).sum())
    per = [
        (events, argmin_ops(S)),
        (poisson_ev, (DRAW[0] + RESAMPLE[0], DRAW[1] + RESAMPLE[1])),
        (opt_ev, RESAMPLE),
        (redraws, (DRAW[0] + REACT[0], DRAW[1] + REACT[1])),
        (L * len(opt_rows) * (S - 1), rate_sum_ops(F)),
    ]
    int_ops = sum(n * c[0] for n, c in per)
    float_ops = sum(n * c[1] for n, c in per)
    # Per lane: kind, rate and q of each source (4 bytes each), each
    # feed's significance (4), the adjacency (a byte an entry), the seed.
    param_bytes = L * (S * 12 + F * 4 + S * F + 4)
    log_bytes = events * 8
    return {"events": events, "redraws": redraws, "int_ops": int_ops,
            "float_ops": float_ops, "bytes": param_bytes + log_bytes}


def least_s(w: dict) -> float:
    """The least time of the work: bytes over the HBM rate, all
    instructions over the issue rate and the integer ones over the INT32
    rate, whichever is slowest."""
    return max(w["bytes"] / HBM_BYTES_PER_S,
               (w["int_ops"] + w["float_ops"]) / ISSUE_PER_S,
               w["int_ops"] / INT32_PER_S)
