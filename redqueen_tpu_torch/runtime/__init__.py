"""Runtime support of the port: numerics guard, fault injection,
telemetry and crash-consistent artifacts."""

from . import artifacts, faultinject, numerics, telemetry  # noqa: F401
