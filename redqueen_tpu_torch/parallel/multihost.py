"""Multi-process execution on ``torch.distributed``: the counterpart of
``redqueen_tpu.parallel.multihost``.

Every rank runs the same program; :func:`initialize` joins them into one
process group, :func:`process_mesh` lays them out on a mesh whose
leading axis counts them, and the same ``comm``/``shard``/star code that
runs on a mesh of one rank runs on many: the kernels compute on their
rank's rows, the collectives of ``comm`` carry the few words that cross
ranks (the star engine's fire clock, flags, metric sums), and
:func:`gather_global` assembles a sharded result on every rank.

The one difference from the JAX package by design: a JAX process drives
every device it can address, a PyTorch process drives one (a rank is a
process and a device).  So :func:`process_mesh`'s local axes multiply to
1 (``-1`` resolves to 1) and its leading axis is the world's ranks.

Backend: NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU, chosen from the configuration before the
group forms (never as a retry after a failure).  Every group has a
timeout, so a rank that diverges fails the run instead of hanging it.
A process group that cannot form raises; it never becomes a world of
one."""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "initialize",
    "process_mesh",
    "gather_global",
    "process_summary",
]

# Environment contract for launchers: every process of a run exports the
# same coordinator and count, and its own id.
ENV_COORD = "RQ_COORDINATOR"      # host:port of rank 0 (or an init URL)
ENV_NPROC = "RQ_NUM_PROCESSES"
ENV_PROC_ID = "RQ_PROCESS_ID"

#: Seconds a collective waits for the other ranks before it fails.
TIMEOUT_S = 300.0

# The device this process's rank drives, as ``initialize`` was told.
_RANK_DEVICE: dict = {}


def _dist():
    import torch.distributed as dist

    return dist


def rank_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device this rank drives: ``cuda:{LOCAL_RANK % device_count}``
    for the card (``LOCAL_RANK`` defaults to the rank), or the CPU.
    ``device`` None means the one :func:`initialize` was given (the card
    by default)."""
    if device is None:
        device = _RANK_DEVICE.get("device", "cuda")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dist = _dist()
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def choose_backend(num_processes: int, device: torch.device) -> str:
    """NCCL when every rank of this host has a card of its own, gloo when
    ranks share a card or compute on the CPU."""
    if device.type != "cuda":
        return "gloo"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if per_host <= torch.cuda.device_count() else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = "cuda",
               timeout_s: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join the multi-process run; return ``(rank, world_size)``.

    Arguments fall back to the ``RQ_COORDINATOR``/``RQ_NUM_PROCESSES``/
    ``RQ_PROCESS_ID`` environment.  With neither arguments nor
    environment this is a no-op run of one process without a group.
    ``coordinator`` is ``host:port`` of rank 0 (``tcp://`` is added) or
    an init URL such as ``file:///path``; one coordinator and
    ``num_processes=1`` forms a world of one rank.  ``device`` is what
    this rank computes on (the card by default: :func:`rank_device`); the
    backend follows from it (:func:`choose_backend`).  Raises when the
    group cannot form within ``timeout_s``."""
    dist = _dist()
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PROC_ID):
        process_id = int(os.environ[ENV_PROC_ID])
    _RANK_DEVICE["device"] = resolve_device(device)
    if dist.is_initialized():
        if num_processes not in (None, dist.get_world_size()):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialized; asked for {num_processes}")
        return dist.get_rank(), dist.get_world_size()
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator "
                             f"({ENV_COORD})")
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id "
                         f"({ENV_NPROC}, {ENV_PROC_ID})")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        choose_backend(int(num_processes), _RANK_DEVICE["device"]),
        init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    dev = rank_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dist.get_rank(), dist.get_world_size()


def shutdown():
    """Leave the run: destroy the process group if there is one."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def process_mesh(local_axes: dict, process_axis: str = "dcn"):
    """A mesh whose LEADING axis is the process (rank) dimension.

    ``local_axes`` are the per-process axes; a rank drives one device, so
    their sizes multiply to 1 (``-1`` once resolves to 1).  The result is
    ``Mesh[(process_axis, *local_axes)]`` over every rank, in rank
    order."""
    from . import comm

    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs initialize(...) with a "
                           "coordinator first")
    names = list(local_axes)
    sizes = [int(s) for s in local_axes.values()]
    if -1 in sizes:
        sizes[sizes.index(-1)] = 1
    if int(np.prod(sizes)) != 1:
        raise ValueError(
            f"local axes {dict(zip(names, sizes))} != 1 devices/process "
            f"(a rank drives one device)")
    return comm.make_mesh({process_axis: dist.get_world_size(),
                           **dict(zip(names, sizes))})


def _gather_sharded(x) -> torch.Tensor:
    """A DTensor's global value on every rank: one all-gather per mesh
    dimension that splits it, the innermost first."""
    from torch.distributed.tensor import Shard

    from .comm import all_gather

    out = x.to_local()
    for mdim in reversed(range(len(x.placements))):
        p = x.placements[mdim]
        if isinstance(p, Shard):
            parts = all_gather(out, x.device_mesh.get_group(mesh_dim=mdim))
            out = torch.cat(parts, dim=p.dim)
    return out


def gather_global(tree):
    """Every leaf of ``tree`` whole, as numpy, on every rank.

    Only leaves marked as sharded (``DTensor``, as the sharded entry
    points return them) are all-gathered; a plain tensor or array is
    whole already (a replicated value such as ``StarResult.own_times``)
    and passes through, so its shape never grows by the world size.
    Every rank calls it: the gathers are collectives."""
    from . import comm

    def leaf(x):
        if comm.is_sharded(x):
            x = _gather_sharded(x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return comm.tree_map(leaf, tree)


def process_summary() -> dict:
    """One line of topology facts for logs and artifacts: which rank, how
    many, the devices a rank drives (one) and in all, the platform
    (``"cuda"``/``"cpu"``) and the backend (``"nccl"``/``"gloo"``, None
    without a group)."""
    dist = _dist()
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    dev = _RANK_DEVICE.get("device")
    if dev is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "platform": dev.type,
        "backend": str(dist.get_backend()) if on else None,
    }
