"""Runtime support of the port: numerics guard, fault injection,
telemetry, crash-consistent and checksummed artifacts, preemption and
the supervisor's heartbeat."""

from . import (  # noqa: F401
    artifacts,
    faultinject,
    integrity,
    numerics,
    preempt,
    supervisor,
    telemetry,
)
from .preempt import PreemptedError, check_preempt, preemption_guard  # noqa: F401
