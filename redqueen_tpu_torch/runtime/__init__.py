"""Runtime support of the port: supervised dispatch with retry, backoff
and a recorded CUDA to CPU degradation (``supervisor``), the
self-healing watchdog, preemption safety, fault injection, telemetry,
crash-consistent and checksummed artifacts, and the numerics guard.
The JAX package's ``runtime`` re-exports, under the same names.

Everything here but ``numerics`` is stdlib-only at import time.
``numerics`` imports torch, so a serving worker child
(``RQ_SERVING_WORKER=1``) loads it, and the names it serves, lazily
(PEP 562), when its shard opens."""

import os as _os

from . import (  # noqa: F401
    artifacts,
    faultinject,
    integrity,
    preempt,
    supervisor,
    telemetry,
    watchdog,
)
from .artifacts import (  # noqa: F401
    atomic_savez,
    atomic_write_json,
    atomic_write_lines,
    atomic_write_text,
)
from .integrity import CorruptArtifactError  # noqa: F401
from .preempt import (  # noqa: F401
    PreemptedError,
    check_preempt,
    preempt_requested,
    preemption_guard,
    register_flush,
    unregister_flush,
)
from .supervisor import (  # noqa: F401
    Attempt,
    RetryPolicy,
    RunReport,
    Supervisor,
    SupervisorError,
    backend_alive,
    ensure_backend,
    heartbeat,
    probe_backend,
    run_resilient,
    supervised_run,
)
from .telemetry import FlightRecorder, Telemetry  # noqa: F401
from .watchdog import Lease, LeaseHeldError, Watchdog  # noqa: F401

# Served lazily from ``numerics`` (it imports torch).
_NUMERICS_NAMES = ("NumericalHealthError", "safe_exp", "safe_log",
                   "safe_log1p", "safe_div")


def __getattr__(name):
    if name == "numerics" or name in _NUMERICS_NAMES:
        # import_module, not ``from . import``: the fromlist protocol
        # re-enters this hook before the submodule is bound.
        import importlib

        numerics = importlib.import_module(".numerics", __name__)
        return numerics if name == "numerics" else getattr(numerics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if not _os.environ.get("RQ_SERVING_WORKER"):
    from . import numerics  # noqa: F401,E402
    from .numerics import (  # noqa: F401,E402
        NumericalHealthError,
        safe_div,
        safe_exp,
        safe_log,
        safe_log1p,
    )

__all__ = [
    "Supervisor", "SupervisorError", "RetryPolicy", "Attempt", "RunReport",
    "run_resilient", "supervised_run", "heartbeat",
    "probe_backend", "backend_alive", "ensure_backend",
    "preemption_guard", "preempt_requested", "check_preempt",
    "register_flush", "unregister_flush", "PreemptedError",
    "atomic_write_json", "atomic_write_text", "atomic_write_lines",
    "atomic_savez", "CorruptArtifactError",
    "NumericalHealthError", "safe_exp", "safe_log", "safe_log1p",
    "safe_div",
    "Watchdog", "Lease", "LeaseHeldError",
    "Telemetry", "FlightRecorder",
    "artifacts", "faultinject", "integrity", "numerics", "preempt",
    "supervisor", "telemetry", "watchdog",
]
