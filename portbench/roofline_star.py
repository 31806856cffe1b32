"""The star engine's work in a batch, for ``roofline.least_s`` (the
card's peaks): counted from the batch's wall events, posts and sources
only.

Every count is a floor of what the algorithm needs for these events,
whatever implements it: nothing here depends on the thinning loop's
steps, a buffer's capacity, the sort or the fire mode, so that a later
implementation (a thinning kernel, say) is read against the same work.

- every wall event: at least one thinning proposal (the key split in
  three and two words: five threefry blocks; the gap's Exp(1) inversion,
  the uniform test, the new time and the intensity there, an ``exp``),
  its chain's key (one block) and the excitation's update (an ``exp``);
- every source: the proposal that ends its stream (past T or not
  accepted) and its stream's and first chain's keys (two blocks);
- every wall event again for the fires: its Exp(1) (a block and the
  inversion) and its candidate (a divide and an add); every post its
  pick (a compare and a select);
- every wall event for the score: its span to the next post (a subtract,
  a clamp, an add);
- bytes: each source's parameters (four floats) and each lane's key read
  once; each wall event's time and each post written once; each feed's
  three rank integrals and each lane's mean written once.

A threefry block is ``roofline.DRAW``'s 74 integer instructions; an
``exp`` or ``log1p`` about 20 float ones, as ``roofline`` reckons."""

from __future__ import annotations

from . import roofline

__all__ = ["work"]

BLOCK = roofline.DRAW[0]
#: One proposal beyond its five blocks: two uniforms (shift, or,
#: subtract), the inversion (negate, log1p, negate), the divide and add of
#: the new time, the intensity there (subtract, multiply, exp, multiply,
#: add) and the test (multiply, compare).
PROPOSAL = (5 * BLOCK, 6 + 22 + 2 + 24 + 2)
#: An event's chain key and the excitation's update (subtract, multiply,
#: exp, multiply, add).
EVENT = (BLOCK, 24)
#: A source's stream and first-chain keys.
SOURCE = (2 * BLOCK, 0)
#: A fire's draw (``roofline.DRAW``) and its candidate.
FIRE = (roofline.DRAW[0], roofline.DRAW[1] + 2)
#: A post's pick.
POST = (0, 2)
#: A wall event's share of the score.
SCORE = (0, 3)


def work(lanes: int, wall_events: int, posts: int, sources: int) -> dict:
    """Integer and float instructions and bytes of a batch of ``lanes``
    lanes whose ``sources`` wall sources fired ``wall_events`` events and
    whose broadcasters posted ``posts`` times."""
    E, P, S = float(wall_events), float(posts), float(sources)
    per = [(E + S, PROPOSAL), (E, EVENT), (S, SOURCE), (E, FIRE),
           (P, POST), (E, SCORE)]
    int_ops = sum(n * c[0] for n, c in per)
    float_ops = sum(n * c[1] for n, c in per)
    nbytes = S * 16 + lanes * 8 + (E + P) * 4 + S * 12 + lanes * 4
    return {"wall_events": E, "posts": P, "sources": S, "int_ops": int_ops,
            "float_ops": float_ops, "bytes": nbytes}

