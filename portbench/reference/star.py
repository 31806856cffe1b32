"""The plain reference of the star engine: one RedQueen ``Opt``
broadcaster (Zarezade et al., arXiv:1610.05773, Algorithm 1 and section
6's synthetic Hawkes walls) against F follower feeds, each filled by one
self-exciting Hawkes wall, in plain PyTorch on the CPU in float64,
vectorised over lanes and feeds.  Its threefry words come from
:mod:`.threefry`; it imports nothing of the program.

The model.  Feed f's wall is an exponential-kernel Hawkes process of
intensity ``l0_f + sum_{t_i < t} alpha_f exp(-beta_f (t - t_i))`` on
(0, T].  The broadcaster posts into every feed; its intensity is
``sum_f sqrt(s_f / q) r_f(t)``, with ``r_f`` the number of wall events
in feed f since its last post.  By superposition and memorylessness this
is Algorithm 1: every wall event starts an Exp(sqrt(s_f / q)) clock, and
a post at time p answers the least clock started after the post before
it.  The score is the time each feed spends with the broadcaster's post
on top (rank 0), and its mean over the feeds.

The draws (``jax.random``'s layout with ``jax_threefry_partitionable``,
as the program makes them).  A lane's key is ``(0, seed mod 2^32)``;
``fold_in(key, d)`` is ``threefry(key; 0, d)``.  Feed f's wall draws
from ``fold_in(fold_in(key, 101), f)``, and its event j (0-based) from
the chain of proposals that starts at ``fold_in(that key, j)``: each
proposal splits its key in three (``threefry(key; 0, i)``, i = 0, 1, 2:
the next key, the gap's, the test's), each of the last two gives one
word (``w0 ^ w1`` of ``threefry(k; 0, 0)``) and a 23-bit uniform, the gap
is ``Exp(1) / bound``, and the proposal is accepted when ``u * bound <=
intensity there``; the intensity there is the next bound.  The chain of
event j starts at event j - 1 (time 0 for the first) with the intensity
there as its bound.  The fires draw from ``fold_in(fold_in(key, 202),
f)``: the wall event with index i in feed f's ascending list has the
Exp(1) of ``threefry(key_f; 0, i)``'s word.

Judging a program's result (:func:`check_walls`, :func:`check_posts`,
:func:`top1`).  The reference follows the program's own events, as
``reference.sim`` does: each chain starts at the program's event time
and excitation, computed in float64 from the program's times, and the
gap is how far the program's next event lies from the reference's
accepted proposal, or, after the program's last event of a feed, how far
before T the reference's chain accepted one.  Each post is the least
candidate among the wall events after the program's previous post; the
gap is how far the program's post lies from it, or, after its last post,
how far before T one was left.  The time on top is computed from the
program's walls and posts.  The gap of a sound run is float32 rounding.

Departures from the published description, each a choice of the system
that the reference follows:

- The walls are sampled by Ogata thinning on the draws above (the paper
  states the process, not its sampler); one Hawkes source a feed.
- A proposal whose accept test lies within a relative ``TIE`` of its
  bound (float32 rounding of the intensity can decide it either way)
  takes the program's decision: the chain goes on past it, and it counts
  as the acceptance where the program's next event lies nearer to it than
  to the chain's first clear acceptance (after a feed's last event the
  program rejected it).  Chains run to ``T + SLACK`` so that an event
  within rounding of T is followed too.  The count of tied proposals and
  the largest margin of a tie that the program decided otherwise than
  the float64 test are returned as diagnostics.  A program whose accept
  test is biased by more than ``TIE`` flips decisions outside the band,
  and its next event then lies a proposal's gap away.
- An event at exactly time 0 (a first gap of zero) lies outside the
  window (0, T]: it is not listed but excites the feed, as in the
  program (the free run of the control lists nothing at time 0 either
  way).
- The program's cap of a million proposals a chain is not modelled (a
  chain of this configuration ends within tens).
- A feed's count of events is held to the program's buffer only by the
  program (it raises when ``wall_cap`` fills).

:func:`simulate` runs the same model free, every operation rounded to a
precision it is given: the control runs it in bfloat16."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import precision as _precision
from .threefry import threefry2x32, uniform23

__all__ = ["Star", "star_component", "check_walls", "check_posts", "top1",
           "simulate", "rounder", "TIE", "SLACK"]

F64 = torch.float64
INF = float("inf")
#: Relative margin of an accept test within which float32 rounding of
#: the intensity could decide it either way.  A sound program decides no
#: tie otherwise than the float64 test beyond a margin of ~1e-5 (the
#: intensity's float32 error: a time's error of ~1e-5 times beta, and
#: the excitation's recursion); the band is a hundred times that, and
#: narrow enough that an acceptance biased by 0.5% fails.
TIE = 1e-3
#: How far past T chains are followed (a sound time's error is ~2e-4).
SLACK = 2e-3
#: Most proposals one chain of the reference makes.
MAX_CHAIN = 100_000

_WALL, _FIRE = 101, 202
_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class Star:
    """One component's parameters, shared by every lane: each feed's
    Hawkes wall and the broadcaster's clock rate sqrt(s_f / q)."""

    l0: torch.Tensor      # [F]
    alpha: torch.Tensor   # [F]
    beta: torch.Tensor    # [F]
    rate: torch.Tensor    # [F]
    end_time: float
    post_cap: int
    wall_cap: int

    @property
    def F(self) -> int:
        return int(self.l0.shape[0])


def star_component(cfg: dict) -> Star:
    """BASELINE config 2 from a configuration file: ``followers`` feeds,
    each one Hawkes wall of ``l0``, ``alpha``, ``beta``; one ``Opt`` of
    cost ``q``, every feed of significance ``s_sink``."""
    F = int(cfg["followers"])

    def full(v):
        return torch.full((F,), float(v), dtype=F64)

    return Star(l0=full(cfg["l0"]), alpha=full(cfg["alpha"]),
                beta=full(cfg["beta"]),
                rate=torch.sqrt(full(cfg["s_sink"]) / float(cfg["q"])),
                end_time=float(cfg["end_time"]),
                post_cap=int(cfg["post_cap"]), wall_cap=int(cfg["wall_cap"]))


def rounder(precision: str):
    """One operation's result rounded to ``precision`` and held in
    float64: ``precision.rounder`` on a tensor."""
    rnd = _precision.rounder(precision)
    return lambda x: torch.from_numpy(rnd(x.numpy()))


# ---- the draws -------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fold_in(k0, k1, d):
    return threefry2x32(k0, k1, 0, d)


def _lane_keys(seeds):
    k1 = (np.asarray(seeds, np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return np.zeros_like(k1), k1


def _feed_keys(seeds, F: int, domain: int):
    """``[L, F]`` keys: ``fold_in(fold_in(lane key, domain), f)``."""
    a0, a1 = _fold_in(*_lane_keys(seeds), domain)
    f = np.arange(F, dtype=np.uint32)[None, :]
    return _fold_in(a0[:, None], a1[:, None], f)


def _u23(k0, k1) -> torch.Tensor:
    """The 23-bit uniform of a key's one-word draw, exact in float64."""
    w0, w1 = threefry2x32(k0, k1, 0, 0)
    return torch.from_numpy(uniform23(w0 ^ w1))


def _proposal(k0, k1):
    """One thinning proposal's keys and draws: ``(next key, Exp(1),
    uniform)``."""
    nxt = threefry2x32(k0, k1, 0, 0)
    gap = threefry2x32(k0, k1, 0, 1)
    test = threefry2x32(k0, k1, 0, 2)
    return nxt, -torch.log1p(-_u23(*gap)), _u23(*test)


def _exp_draws(k0, k1, idx) -> torch.Tensor:
    """Exp(1) of the word ``threefry(key; 0, idx)``."""
    w0, w1 = threefry2x32(k0, k1, 0, idx)
    return -torch.log1p(-torch.from_numpy(uniform23(w0 ^ w1)))


# ---- judging the walls -----------------------------------------------------


def _well_formed(times: torch.Tensor, n: torch.Tensor, T: float,
                 lo: float = 0.0, strict: bool = False) -> torch.Tensor:
    """``[L]`` True where every row of ``times [L, R, W]`` holds ``n [L,
    R]`` finite ascending times in (lo, T + SLACK] and +inf after
    them."""
    W = times.shape[-1]
    col = torch.arange(W)
    valid = col < n[..., None]
    fin = torch.isfinite(times)
    ok = (n >= 0) & (n <= W)
    ok = ok & (fin == valid).all(-1)
    inside = (times > lo) & (times <= T + SLACK)
    ok = ok & (~valid | inside).all(-1)
    d = times[..., 1:] - times[..., :-1]
    both = valid[..., 1:]
    ok = ok & (~both | ((d > 0) if strict else (d >= 0))).all(-1)
    return ok.reshape(ok.shape[0], -1).all(-1)


def check_walls(star: Star, seeds, wall_times, wall_n):
    """The worst gap of each lane's walls (``wall_times [L, F, W]``
    ascending +inf-padded, ``wall_n [L, F]`` valid events) against the
    reference's thinning anchored at the program's events, in units of
    time (``inf`` for a malformed list), the count of tied proposals, and
    the largest relative margin of a tie that the program decided
    otherwise than the float64 test (0 if none): ``(gap [L], ties,
    flip)``."""
    times = torch.as_tensor(wall_times, dtype=F64)
    n = torch.as_tensor(wall_n, dtype=torch.int64)
    L, F, _ = times.shape
    T = star.end_time
    ok = _well_formed(times, n, T)
    n = torch.where(ok[:, None], n, torch.zeros_like(n))
    W = int(n.max()) if n.numel() else 0
    times = torch.where(ok[:, None, None], times,
                        torch.full_like(times, INF))[..., :W]
    sk0, sk1 = _feed_keys(seeds, F, _WALL)
    l0, al, be = (x[None, :].expand(L, F) for x in
                  (star.l0, star.alpha, star.beta))

    # An event at time 0 (a first gap of exactly zero, one draw in 2^23)
    # lies outside the window (0, T]: the program does not list it, but
    # it excites the feed, and the listed events come from the chains
    # after it.
    _, e0, _ = _proposal(*_fold_in(sk0, sk1, np.uint32(0)))
    hidden = (e0 == 0).to(torch.int64)

    # One task a (lane, feed, slot j): slot j's chain starts at event j
    # (time 0 for j = 0) with the excitation there, and should end at
    # event j + 1, if there is one.
    exc = torch.zeros(L, F, W + 1, dtype=F64)
    exc[..., 0] = al * hidden
    for j in range(1, W + 1):
        dt = times[..., j - 1] - (times[..., j - 2] if j > 1 else 0.0)
        exc[..., j] = exc[..., j - 1] * torch.exp(-be * dt) + al
    starts = torch.cat([torch.zeros(L, F, 1, dtype=F64), times], -1)
    nxt = torch.cat([times, torch.full((L, F, 1), INF, dtype=F64)], -1)
    slot = torch.arange(W + 1)
    live = slot[None, None, :] <= n[..., None]
    li, fi, ji = torch.nonzero(live, as_tuple=True)
    s0 = starts[li, fi, ji]
    x0 = exc[li, fi, ji]
    target = nxt[li, fi, ji]
    has_next = ji < n[li, fi]
    l0_, al_, be_ = l0[li, fi], al[li, fi], be[li, fi]

    k0, k1 = _fold_in(sk0[_np(li), _np(fi)], sk1[_np(li), _np(fi)],
                      _np(ji + hidden[li, fi]).astype(np.uint32))
    tp, lbd = s0.clone(), l0_ + x0
    acc_t = torch.full_like(s0, INF)    # the chain's first clear accept
    tied = torch.full_like(s0, INF)     # its tie nearest the next event
    act = torch.arange(s0.shape[0])
    seen = ([], [], [])                 # every tie: task, time, margin
    for _ in range(MAX_CHAIN):
        if act.numel() == 0:
            break
        a = _np(act)
        (k0[a], k1[a]), e, u = _proposal(k0[a], k1[a])
        t_new = tp[act] + e / lbd[act]
        lbd_new = l0_[act] + x0[act] * torch.exp(-be_[act] * (t_new
                                                             - s0[act]))
        margin = (lbd_new - u * lbd[act]) / lbd[act]
        tie = margin.abs() <= TIE
        accept = ~tie & (margin >= 0)
        at, tt = act[tie], t_new[tie]
        for into, x in zip(seen, (at, tt, margin[tie])):
            into.append(x)
        nearer = (tt - target[at]).abs() < (tied[at] - target[at]).abs()
        tied[at[nearer]] = tt[nearer]
        acc_t[act[accept]] = t_new[accept]
        tp[act], lbd[act] = t_new, lbd_new
        act = act[~accept & (t_new <= T + SLACK) & (lbd_new > 0)]
    # A tie is the program's acceptance where its next event lies nearer
    # to it than to the chain's clear acceptance.
    took = has_next & ((tied - target).abs() < (acc_t - target).abs())
    got = torch.where(took, tied, acc_t)
    gap_task = torch.where(has_next, (target - got).abs(),
                           torch.clamp(T - acc_t, min=0.0))
    gap_task = torch.nan_to_num(gap_task, nan=INF, posinf=INF)
    gap = torch.zeros(L, dtype=F64).scatter_reduce(0, li, gap_task, "amax")
    gap = torch.where(ok, gap, torch.full_like(gap, INF))
    # The ties the program decided otherwise than the float64 test: the
    # one it took with a negative margin, and those it passed (before its
    # next event, or up to T after its last) with a margin of 0 or more.
    # Its decision is read from its events only where the other reading
    # lies more than SLACK away: of two proposals within a time's rounding
    # of each other (or of T), either could be the one it took.
    at, tt, tm = (torch.cat(x) if x else torch.zeros(0, dtype=F64)
                  for x in seen)
    at = at.long()
    took_it = took[at] & (tt == got[at])
    end = torch.where(has_next, got, torch.full_like(got, T))[at]
    event = torch.where(has_next, target, torch.full_like(got, T))[at]
    passed = ~took_it & (tt <= end) & ((event - tt).abs() > SLACK)
    took_it = took_it & ((acc_t[at] - target[at]).abs() > SLACK)
    wrong = (took_it & (tm < 0)) | (passed & (tm >= 0))
    flip = float(tm[wrong].abs().max()) if bool(wrong.any()) else 0.0
    return gap, int(at.numel()), flip


# ---- judging the posts -----------------------------------------------------


def _candidates(star: Star, seeds, times, n):
    """Each lane's wall events ascending ``t_sorted [L, N]`` and their
    candidates ``c_sorted``, +inf-padded."""
    L, F, W = times.shape
    fk0, fk1 = _feed_keys(seeds, F, _FIRE)
    idx = np.arange(W, dtype=np.uint32)[None, None, :]
    e = _exp_draws(fk0[..., None], fk1[..., None], idx)
    valid = torch.arange(W)[None, None, :] < n[..., None]
    cand = torch.where(valid, times + e / star.rate[None, :, None],
                       torch.full_like(times, INF))
    t = torch.where(valid, times, torch.full_like(times, INF))
    t_sorted, order = torch.sort(t.reshape(L, -1), dim=-1, stable=True)
    return t_sorted, torch.gather(cand.reshape(L, -1), -1, order)


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    inf = torch.full(x.shape[:-1] + (1,), INF, dtype=x.dtype)
    s = torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values, [-1])
    return torch.cat([s, inf], -1)


def check_posts(star: Star, seeds, wall_times, wall_n, own_times, n_posts):
    """The worst gap of each lane's posts (``own_times [L, K]``
    ascending +inf-padded, ``n_posts [L]``) against the least candidate
    after the program's previous post, over the program's walls: ``[L]``
    in units of time, ``inf`` for a malformed list."""
    times = torch.as_tensor(wall_times, dtype=F64)
    n = torch.as_tensor(wall_n, dtype=torch.int64)
    own = torch.as_tensor(own_times, dtype=F64)
    n_p = torch.as_tensor(n_posts, dtype=torch.int64)
    T = star.end_time
    ok = _well_formed(own[:, None, :], n_p[:, None], T, strict=True)
    n_p = torch.where(ok, n_p, torch.zeros_like(n_p))
    own = own[:, :int(n_p.max()) if n_p.numel() else 0]
    t_sorted, c_sorted = _candidates(star, seeds, times, n)
    suffix = _suffix_min(c_sorted)
    K = own.shape[1]
    anchors = torch.cat([torch.zeros(own.shape[0], 1, dtype=F64),
                         torch.where(torch.isfinite(own), own,
                                     torch.full_like(own, INF))], -1)
    idx = torch.searchsorted(t_sorted.contiguous(), anchors.contiguous(),
                             right=True)
    ref = torch.gather(suffix, 1, idx)                 # [L, K + 1]
    k = torch.arange(K + 1)[None, :]
    prog = torch.cat([own, torch.full((own.shape[0], 1), INF,
                                      dtype=F64)], -1)
    matched = (prog - ref).abs()
    left = torch.clamp(T - ref, min=0.0)
    g = torch.where(k < n_p[:, None], matched,
                    torch.where(k == n_p[:, None], left,
                                torch.zeros_like(left)))
    gap = torch.nan_to_num(g, nan=INF, posinf=INF).max(-1).values
    return torch.where(ok, gap, torch.full_like(gap, INF))


# ---- the score --------------------------------------------------------------


def top1(star: Star, wall_times, wall_n, own_times, n_posts,
         precision: str = "float64"):
    """Time on top of each feed ``[L, F]`` and its mean over the feeds
    ``[L]``: over each stretch from a post (or time 0) to the next (or
    T), the time until the stretch's first wall event, a wall event at a
    post's own time falling after the post."""
    rnd = rounder(precision)
    times = torch.as_tensor(wall_times, dtype=F64)
    n = torch.as_tensor(wall_n, dtype=torch.int64)
    own = torch.as_tensor(own_times, dtype=F64)
    n_p = torch.as_tensor(n_posts, dtype=torch.int64)
    L, F, W = times.shape
    T = star.end_time
    valid = torch.arange(W)[None, None, :] < n[..., None]
    walls = torch.where(valid, times, torch.full_like(times, INF))
    own = own[:, :int(n_p.max()) if n_p.numel() else 0]
    kp = torch.arange(own.shape[1])[None, :] < n_p[:, None]
    posts = torch.where(kp, own, torch.full_like(own, INF))
    starts = torch.cat([torch.zeros(L, 1, dtype=F64), posts], -1)
    ends = torch.cat([posts, torch.full((L, 1), INF, dtype=F64)], -1)
    starts = torch.clamp(starts, max=T)
    ends = torch.clamp(ends, max=T)
    out = []
    for b in range(0, L, _BLOCK):     # bounds the [lanes, F, posts] terms
        w = walls[b:b + _BLOCK].contiguous()
        s = starts[b:b + _BLOCK]
        q = s[:, None, :].expand(-1, F, -1).contiguous()
        first = torch.searchsorted(w, q, right=False)
        wext = torch.cat([w, torch.full(w.shape[:-1] + (1,), INF,
                                        dtype=F64)], -1)
        fw = torch.gather(wext, -1, first)
        stop = torch.minimum(fw, ends[b:b + _BLOCK, None, :])
        span = torch.clamp(rnd(stop - s[:, None, :]), min=0.0)
        out.append(rnd(span.sum(-1)))
    top = torch.cat(out, 0)
    return top, rnd(top.mean(-1))


# ---- the free run (the control) -------------------------------------------


def _free_walls(star: Star, seeds, rnd):
    """Every feed's wall run free to T, every operation rounded by
    ``rnd``: ``(times [L, F, wall_cap], n [L, F])``; a feed stops at its
    buffer's end."""
    L, F, cap = len(seeds), star.F, star.wall_cap
    T = star.end_time
    sk0, sk1 = _feed_keys(seeds, F, _WALL)
    sk0, sk1 = sk0.reshape(-1), sk1.reshape(-1)
    N = L * F
    l0 = rnd(star.l0.repeat(L))
    al = rnd(star.alpha.repeat(L))
    be = rnd(star.beta.repeat(L))
    out = torch.full((N, cap), INF, dtype=F64)
    cnt = torch.zeros(N, dtype=torch.int64)
    t = torch.zeros(N, dtype=F64)
    exc = torch.zeros(N, dtype=F64)
    k0, k1 = _fold_in(sk0, sk1, np.uint32(0))
    tp, lbd = t.clone(), l0.clone()
    act = torch.arange(N)
    while act.numel():
        a = _np(act)
        (k0[a], k1[a]), e, u = _proposal(k0[a], k1[a])
        t_new = rnd(tp[act] + rnd(e / lbd[act]))
        lbd_new = rnd(l0[act] + rnd(exc[act] * rnd(torch.exp(rnd(
            -be[act] * rnd(t_new - t[act]))))))
        accept = rnd(u * lbd[act]) <= lbd_new
        fired = accept & (t_new <= T)
        tp[act], lbd[act] = t_new, lbd_new
        f = act[fired]
        out[f, cnt[f]] = t_new[fired]
        cnt[f] += 1
        exc[f] = rnd(rnd(exc[f] * rnd(torch.exp(rnd(-be[f] * rnd(
            t_new[fired] - t[f]))))) + al[f])
        t[f] = t_new[fired]
        lbd[f] = rnd(l0[f] + exc[f])
        fa = _np(f)
        k0[fa], k1[fa] = _fold_in(sk0[fa], sk1[fa],
                                  _np(cnt[f]).astype(np.uint32))
        go = (~accept & (t_new <= T) & (lbd_new > 0)) | fired
        act = act[go]
        act = act[cnt[act] < cap]
    return out.reshape(L, F, cap), cnt.reshape(L, F)


def _free_posts(star: Star, seeds, times, n, rnd):
    """The posts run free over the walls: ``(own [L, post_cap], n_posts
    [L])``."""
    L = times.shape[0]
    T, K = star.end_time, star.post_cap
    fk0, fk1 = _feed_keys(seeds, star.F, _FIRE)
    W = times.shape[-1]
    idx = np.arange(W, dtype=np.uint32)[None, None, :]
    e = rnd(_exp_draws(fk0[..., None], fk1[..., None], idx))
    valid = torch.arange(W)[None, None, :] < n[..., None]
    rate = rnd(star.rate)
    cand = torch.where(valid, rnd(times + rnd(e / rate[None, :, None])),
                       torch.full_like(times, INF))
    t = torch.where(valid, times, torch.full_like(times, INF))
    t_sorted, order = torch.sort(t.reshape(L, -1), dim=-1, stable=True)
    suffix = _suffix_min(torch.gather(cand.reshape(L, -1), -1, order))
    own = torch.full((L, K), INF, dtype=F64)
    last = torch.zeros(L, 1, dtype=F64)
    for k in range(K):
        i = torch.searchsorted(t_sorted.contiguous(), last, right=True)
        p = torch.gather(suffix, 1, i)
        p = torch.where(p <= T, p, torch.full_like(p, INF))
        if not torch.isfinite(p).any():
            break
        own[:, k] = p[:, 0]
        last = p
    return own, torch.isfinite(own).sum(-1)


def simulate(star: Star, seeds, precision: str):
    """Lanes of ``seeds`` run free, every operation rounded to
    ``precision``: ``(wall_times, wall_n, own_times, n_posts, top [L,
    F], mean [L])`` in the program's layout."""
    rnd = rounder(precision)
    times, n = _free_walls(star, seeds, rnd)
    own, n_p = _free_posts(star, seeds, times, n, rnd)
    top, mean = top1(star, times, n, own, n_p, precision)
    return times, n, own, n_p, top, mean
