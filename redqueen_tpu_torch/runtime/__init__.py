"""Runtime support of the port: numerics guard, fault injection,
telemetry, crash-consistent and checksummed artifacts, preemption and
the supervisor's heartbeat and retry policy.

Everything here but ``numerics`` is stdlib-only at import time.
``numerics`` imports torch, so a serving worker child
(``RQ_SERVING_WORKER=1``) loads it lazily (PEP 562), when its shard
opens."""

import os as _os

from . import (  # noqa: F401
    artifacts,
    faultinject,
    integrity,
    preempt,
    supervisor,
    telemetry,
)
from .preempt import PreemptedError, check_preempt, preemption_guard  # noqa: F401


def __getattr__(name):
    if name == "numerics":
        import importlib

        return importlib.import_module(".numerics", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if not _os.environ.get("RQ_SERVING_WORKER"):
    from . import numerics  # noqa: F401,E402
