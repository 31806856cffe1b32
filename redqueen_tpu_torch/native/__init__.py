"""Native (C++) components of the port, bound through ctypes: the trace
loader (``loader``).  Nothing here runs a compiler at import; the build
happens at first use."""

from .loader import NativeBuildError, available, build, load_csv_native  # noqa: F401

__all__ = ["NativeBuildError", "available", "build", "load_csv_native"]
