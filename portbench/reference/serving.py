"""The plain reference of the serving layer: RedQueen's online rule applied
per micro-batch of feed events, in NumPy, and a reader of the journal's
on-disk format.

The carry holds, per follower feed f, the rank of the broadcaster's last
post in that feed.  A batch of wall events (times, feeds) raises each
feed's rank by the events it received; the serving clock moves to the
batch's last event time; the intensity is ``u = sum_f sqrt(s_f / q) *
rank_f`` over the healthy feeds, and the broadcaster posts when its
batch draw ``U`` falls below the survival ``1 - exp(-u * dt)`` over the
clock's advance ``dt``, which puts its post at the top of every healthy
feed (rank 0).  The draw of the batch with sequence number n is word 0 of
``threefry((0, seed); n, 2^31)`` as a 24-bit uniform.  A feed whose rank
stops being finite is marked sick and frozen.

:func:`apply_stream` runs the rule over a stream in the precision it is
given (float32 is what the configuration states; bfloat16 is the
control).  :func:`read_journal` decodes a journal file byte by byte from
its documented layout, with every record's CRC-32 checked, and numbers
its records in the order they were written."""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .precision import rounder
from .threefry import threefry2x32, uniform24

__all__ = ["BIT_SICK", "Apply", "apply_stream", "read_journal"]

#: The health bit of a feed whose rank stopped being finite.
BIT_SICK = 1 << 1

_DRAW_DOMAIN = 0x8000_0000


class Apply:
    """The rule's carry over a fresh start, every operation rounded to
    ``precision``; :meth:`step` applies one batch and returns its
    decision ``(seq, posted, post time, intensity)``.

    Only the feeds whose rank is not 0 enter the intensity's sum (a zero
    term adds exactly nothing), so a batch costs work in the feeds it and
    its predecessors since the last post touched, not in every feed."""

    def __init__(self, n_feeds: int, q: float, s_sink, seed: int,
                 precision: str = "float32"):
        self.rnd = rnd = rounder(precision)
        s_sink = np.broadcast_to(np.asarray(s_sink, np.float64), (n_feeds,))
        self.w = rnd(np.sqrt(rnd(s_sink / q)))
        self.n_feeds = n_feeds
        self.key1 = np.uint32(int(seed) & 0xFFFFFFFF)
        self.rank = np.zeros(n_feeds)
        self.health = np.zeros(n_feeds, np.int64)
        self.nonzero = np.zeros(0, np.int64)   # feeds whose rank may be != 0
        self.t = 0.0
        self.seq = -1
        self.n_batches = self.n_events = self.n_posts = 0

    def step(self, seq: int, times, feeds):
        rnd = self.rnd
        u = uniform24(threefry2x32(0, self.key1, np.uint32(seq),
                                   _DRAW_DOMAIN)[0])
        times = rnd(np.asarray(times, np.float64))
        hit, inc = np.unique(np.asarray(feeds, np.int64), return_counts=True)
        ok = self.health[hit] == 0
        self.rank[hit] = np.where(ok, rnd(self.rank[hit] + inc),
                                  self.rank[hit])
        self.health[hit] = np.where(np.isfinite(self.rank[hit]),
                                    self.health[hit],
                                    self.health[hit] | BIT_SICK)
        nz = self.nonzero = np.union1d(self.nonzero, hit)
        healthy = self.health[nz] == 0
        t_new = max(self.t, float(times.max())) if times.size else self.t
        lam = float(rnd(np.sum(np.where(
            healthy, rnd(self.w[nz] * self.rank[nz]), 0.0))))
        p = float(rnd(np.expm1(rnd(lam * rnd(self.t - t_new)))))
        posted = bool(p < -float(rnd(u)))
        if posted:
            self.rank[nz[healthy]] = 0.0
            self.nonzero = nz[~healthy]
        self.t = t_new
        self.seq = int(seq)
        self.n_batches += 1
        self.n_events += int(times.size)
        self.n_posts += int(posted)
        return (int(seq), posted, t_new, lam)

    def carry(self) -> Dict[str, np.ndarray]:
        return {"rank": self.rank.copy(), "health": self.health.copy(),
                "t": self.t, "seq": self.seq, "n_batches": self.n_batches,
                "n_events": self.n_events, "n_posts": self.n_posts}


def apply_stream(batches: Sequence[Tuple[int, np.ndarray, np.ndarray]],
                 n_feeds: int, q: float, s_sink, seed: int,
                 precision: str = "float32"):
    """Apply ``batches`` (``(seq, times, feeds)`` in the order applied)
    to a fresh carry.  Returns ``(decisions, carry)``: ``decisions``
    ``[n, 4]`` float64 rows of (seq, posted, post time, intensity), and
    the final carry as a dict of NumPy arrays."""
    a = Apply(n_feeds, q, s_sink, seed, precision)
    out = np.array([a.step(*b) for b in batches], np.float64).reshape(-1, 4)
    return out, a.carry()


# The journal's binary layout: a 256-byte header slot that begins with
# b"RQJH", then one frame a record: a big-endian header (magic b"RQJ3",
# body length, CRC-32 of the body, seq or -1) and the body, zero-padded
# to a multiple of 256 bytes.  A group body begins with b"RQGB", a
# big-endian (head length, event count), a JSON head with "seqs",
# "counts" and "decisions", then the times as little-endian float64 and
# the feeds as little-endian int32.  Any other body is one JSON record.
_SLOT = 256
_HEADER_MAGIC = b"RQJH"
_RECORD_MAGIC = b"RQJ3"
_RECORD_HDR = struct.Struct(">4sIIq")
_GROUP_MAGIC = b"RQGB"
_GROUP_HDR = struct.Struct(">II")


def _batches_of(body: bytes) -> List[Tuple[int, np.ndarray, np.ndarray,
                                           Dict]]:
    if body.startswith(_GROUP_MAGIC):
        at = len(_GROUP_MAGIC)
        head_len, n = _GROUP_HDR.unpack_from(body, at)
        at += _GROUP_HDR.size
        head = json.loads(body[at:at + head_len])
        at += head_len
        times = np.frombuffer(body, "<f8", n, at)
        feeds = np.frombuffer(body, "<i4", n, at + 8 * n)
    else:
        head = json.loads(body)
        if "seqs" not in head:
            head = {"seqs": [head["seq"]], "counts": [len(head["times"])],
                    "decisions": [head["decision"]],
                    "times": head["times"], "feeds": head["feeds"]}
        times = np.asarray(head["times"], np.float64)
        feeds = np.asarray(head["feeds"], np.int64)
    out, at = [], 0
    for seq, c, d in zip(head["seqs"], head["counts"], head["decisions"]):
        out.append((int(seq), times[at:at + c], feeds[at:at + c], d))
        at += c
    return out


def read_journal(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray,
                                               Dict, int]]:
    """``{seq: (times, feeds, decision, record)}`` of every whole record
    of a binary journal file, ``record`` counting the file's records from
    1 in the order written; reading stops at the first frame that is not
    whole (a torn tail), and a missing file reads as empty."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return {}
    if not data.startswith(_HEADER_MAGIC):
        return {}
    out = {}
    off, record = _SLOT, 0
    while off + _RECORD_HDR.size <= len(data):
        magic, plen, crc, _seq = _RECORD_HDR.unpack_from(data, off)
        if magic != _RECORD_MAGIC:
            break
        body = data[off + _RECORD_HDR.size:off + _RECORD_HDR.size + plen]
        if len(body) != plen or zlib.crc32(body) & 0xFFFFFFFF != crc:
            break
        record += 1
        for seq, times, feeds, d in _batches_of(body):
            out[seq] = (times, feeds, d, record)
        off += -(-(_RECORD_HDR.size + plen) // _SLOT) * _SLOT
    return out
