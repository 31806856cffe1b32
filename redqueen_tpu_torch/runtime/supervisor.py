"""The part of the JAX package's ``runtime.supervisor`` that the port
calls: :func:`heartbeat` with the :data:`ENV_HEARTBEAT` contract (long
fits), and :class:`RetryPolicy` (the serving cluster's crash-loop
backoff and the socket worker's redial schedule).

A supervisor (a process that runs a fit as its child under a deadline)
names a file in ``RQ_HEARTBEAT_FILE``; the child touches it at each
durable boundary so that the supervisor's staleness bound can tell
"slow but alive" from "wedged".  Without the variable the call is a
no-op.  The supervisor itself (deadlines, supervised retries, the CUDA
to CPU degradation) is ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Optional

__all__ = ["heartbeat", "ENV_HEARTBEAT", "RetryPolicy"]

#: The child touches this file to prove progress.
ENV_HEARTBEAT = "RQ_HEARTBEAT_FILE"


def heartbeat() -> None:
    """Touch the supervisor-provided heartbeat file (no-op when not
    supervised)."""
    path = os.environ.get(ENV_HEARTBEAT)
    if not path:
        return
    try:
        with open(path, "w") as f:
            f.write(f"{time.time():.3f}\n")
    except OSError:
        pass


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter.  ``seed`` makes the jitter — and with
    it the whole backoff schedule — deterministic for tests; None draws
    from the process RNG.  ``delay(n)`` is the sleep after the n-th failed
    attempt (1-based): ``base * multiplier**(n-1)``, capped, then
    stretched by up to ``jitter`` fraction."""

    max_attempts: int = 3
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    def rng(self) -> random.Random:
        return random.Random(self.seed)

    def delay(self, failed_attempt: int, rng: random.Random) -> float:
        base = min(self.base_delay_s * self.multiplier ** (failed_attempt - 1),
                   self.max_delay_s)
        if self.jitter > 0:
            base *= 1.0 + self.jitter * rng.random()
        return base

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
