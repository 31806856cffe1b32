"""The ``numeric`` fault of ``RQ_FAULT``, read the same way as the JAX
package's ``runtime.faultinject``: ``RQ_FAULT=numeric:<nan|inf>@lane<N>``
poisons lane N of the next dispatch (``runtime.numerics.poison_lane``),
so the health paths of both packages can be driven on the same lane.

Only the numeric kind is read here; a spec of any other kind leaves the
port's engines alone.  A dispatch layer that reorders or slices lanes
(``parallel.lanes.simulate_ragged``) runs each dispatch inside
:func:`numeric_scope`, whose ``lane_base`` translates the spec's lane
index into the dispatch's own lanes; a ``,chunkM`` qualifier fires only
inside a scope of that chunk."""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Tuple

from .numerics import POISON_MODES

__all__ = ["ENV_FAULT", "NUMERIC_MODES", "NumericFault", "parse_numeric",
           "numeric_fault", "numeric_scope", "numeric_scope_ctx",
           "active_numeric_lane"]

ENV_FAULT = "RQ_FAULT"
NUMERIC_MODES = POISON_MODES


class NumericFault(NamedTuple):
    """Parsed ``numeric:mode@laneN[,chunkM]`` spec."""

    mode: str
    lane: int
    chunk: Optional[int]


def parse_numeric(arg: Optional[str]) -> NumericFault:
    """Parse the argument of a ``numeric`` fault spec."""
    if not arg or "@" not in arg:
        raise ValueError(
            f"{ENV_FAULT}=numeric needs 'mode@laneN[,chunkM]' "
            f"(mode: {'|'.join(NUMERIC_MODES)})")
    mode, _, where = arg.partition("@")
    mode = mode.strip().lower()
    if mode not in NUMERIC_MODES:
        raise ValueError(f"unknown numeric fault mode {mode!r} "
                         f"(want {'|'.join(NUMERIC_MODES)})")
    lane_s, _, chunk_s = where.partition(",")
    lane_s = lane_s.strip().lower()
    chunk_s = chunk_s.strip().lower()
    if not lane_s.startswith("lane"):
        raise ValueError(f"numeric fault needs 'laneN', got {lane_s!r}")
    try:
        lane = int(lane_s[4:])
    except ValueError as e:
        raise ValueError(f"bad lane in numeric fault: {lane_s!r}") from e
    chunk: Optional[int] = None
    if chunk_s:
        if not chunk_s.startswith("chunk"):
            raise ValueError(
                f"numeric fault qualifier must be 'chunkM', got {chunk_s!r}")
        try:
            chunk = int(chunk_s[5:])
        except ValueError as e:
            raise ValueError(
                f"bad chunk in numeric fault: {chunk_s!r}") from e
    return NumericFault(mode, lane, chunk)


def numeric_fault() -> Optional[NumericFault]:
    """The env-configured numeric fault, or None when ``RQ_FAULT`` is
    unset or names another kind."""
    spec = os.environ.get(ENV_FAULT)
    if not spec:
        return None
    kind, _, arg = spec.strip().partition(":")
    if kind.strip().lower() != "numeric":
        return None
    return parse_numeric(arg)


# (chunk, lane_base) of the dispatch that is running: see numeric_scope.
_NUMERIC_CTX: Tuple[Optional[int], int] = (None, 0)


@contextlib.contextmanager
def numeric_scope(chunk: Optional[int] = None, lane_base: int = 0):
    """Declare the fault-addressing context of the dispatches run inside
    the ``with`` body: the sweep chunk, and the spec lane index that maps
    to lane 0 of the dispatch."""
    global _NUMERIC_CTX
    prev = _NUMERIC_CTX
    _NUMERIC_CTX = (chunk, int(lane_base))
    try:
        yield
    finally:
        _NUMERIC_CTX = prev


def numeric_scope_ctx() -> Tuple[Optional[int], int]:
    """The ``(chunk, lane_base)`` context in effect, so that a layer that
    nests its own scopes keeps the chunk it runs in."""
    return _NUMERIC_CTX


def active_numeric_lane(batch_size: int) -> Optional[Tuple[int, str]]:
    """``(local lane, mode)`` if the env-configured numeric fault lands in
    a dispatch of ``batch_size`` lanes, else None.  A ``chunkM`` spec
    fires only inside a :func:`numeric_scope` of chunk M; the spec's lane
    index is taken relative to the scope's ``lane_base``."""
    nf = numeric_fault()
    if nf is None:
        return None
    chunk, lane_base = _NUMERIC_CTX
    if nf.chunk is not None and nf.chunk != chunk:
        return None
    local = nf.lane - lane_base
    if 0 <= local < batch_size:
        return local, nf.mode
    return None
