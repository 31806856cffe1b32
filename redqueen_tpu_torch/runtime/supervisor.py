"""The part of the JAX package's ``runtime.supervisor`` that long fits
call: :func:`heartbeat` and the :data:`ENV_HEARTBEAT` contract.

A supervisor (a process that runs a fit as its child under a deadline)
names a file in ``RQ_HEARTBEAT_FILE``; the child touches it at each
durable boundary so that the supervisor's staleness bound can tell
"slow but alive" from "wedged".  Without the variable the call is a
no-op.  The supervisor itself (deadlines, retries, backoff, the CUDA to
CPU degradation) is ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import os
import time

__all__ = ["heartbeat", "ENV_HEARTBEAT"]

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
