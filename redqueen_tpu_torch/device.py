"""Device resolution shared by every entry point of the port.

Entry points run on the card by default.  A caller that wants the CPU
(the tests, a machine without a card) says so with ``device="cpu"``; a
default run on a machine without CUDA raises instead of quietly
computing on the CPU."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DeviceLike", "host_read"]

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for and torch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available to torch, and redqueen_tpu_torch runs on "
            "the card by default — pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev


def host_read(x: torch.Tensor):
    """``x``'s value on the host as Python objects (``x.tolist()``): the
    one place where the scan engine waits for the card, so that every
    host sync of a run passes through here."""
    return x.tolist()
