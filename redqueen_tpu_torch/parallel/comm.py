"""The collective layer of the port on ``torch.distributed``: the
counterpart of ``redqueen_tpu.parallel.comm``.  Every cross-rank word of
the port goes through this module, so the kernels stay mesh-agnostic:
outside a bound mesh axis every collective is the identity, inside one
it is one ``all_reduce`` on the axis's process group.

How the JAX package's concepts map:

- A device of the mesh is a **rank**.  Each rank drives one device:
  ``cuda:{LOCAL_RANK % device_count}``, or the CPU when the caller passes
  ``device="cpu"``; with one card every rank shares ``cuda:0``.
- ``Mesh(devices, names)`` from ``make_mesh({name: size})`` is a
  :class:`Mesh` over the world's ranks: a
  ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
  one process group per axis.  The sizes multiply to the rank count
  (``-1`` once for "all remaining").  Its ``repr`` names the axes, their
  sizes and the ranks, nothing else, so that it hashes the same in every
  run.
- ``shard_map`` binds the mesh's axis names while the function runs (a
  ``contextvars.ContextVar``); :func:`axis_present`,
  :func:`axis_size_or_1`, :func:`axis_index` and the collectives read
  that binding.  Inputs are cut to this rank's block by their
  :class:`P` spec, outputs are marked by theirs.
- ``psum``/``pmin``/``pmax``/``pany`` are the identity when the axis is
  unbound and one ``dist.all_reduce`` (SUM, MIN, MAX; ``pany`` MAX of
  int32) on the axis's group when it is bound, at any axis size: a world
  of one rank still runs the collective.  Where the group's backend is
  gloo and the tensor lies on the card, the value goes through the host
  (gloo reduces host memory); on NCCL it stays on the card.
- A global ``jax.Array`` sharded over the mesh is a rank-local tensor
  marked as sharded by its type: ``torch.distributed.tensor.DTensor``
  with a ``Shard(d)`` placement on each mesh dimension that splits it.
  The kernels compute on plain local tensors (:func:`local`), never on
  DTensors; ``multihost.gather_global`` assembles the global array.
- A process of the JAX package is a rank here (PyTorch runs one process
  per device), so a "multi-host" mesh is the same mesh with its leading
  axis counting ranks (``multihost.process_mesh``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "make_mesh",
    "axis_present",
    "axis_size_or_1",
    "psum",
    "pmin",
    "pmax",
    "pany",
    "shard_leading",
    "shard_map",
    "replicate",
    "axis_total",
]

#: Collectives run by this module: ``{name: [count, seconds]}``, the
#: seconds on the host's clock around each call (host staging included).
STATS: dict = {}


def reset_stats():
    STATS.clear()


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, each an axis name, a tuple of axis names, or None
    (not split).  Missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _dist():
    import torch.distributed as dist

    return dist


class Mesh:
    """Ranks laid out on named axes.  ``shape`` maps each axis name to its
    size, in order; ``ranks`` is the numpy grid of ranks.  Build it with
    :func:`make_mesh` on every rank of the world (it forms one process
    group per axis, a collective step)."""

    def __init__(self, ranks: np.ndarray, names: Sequence[str],
                 device_type: str):
        from torch.distributed.device_mesh import DeviceMesh

        self.ranks = np.asarray(ranks, np.int64)
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device_mesh = DeviceMesh(device_type,
                                      torch.as_tensor(self.ranks),
                                      mesh_dim_names=self.axis_names)
        self._groups = {a: self.device_mesh[a].get_group()
                        for a in self.axis_names}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axis: str):
        return self._groups[axis]

    def coordinate(self) -> dict:
        """This rank's index along each axis."""
        rank = _dist().get_rank()
        where = np.argwhere(self.ranks == rank)
        if where.size == 0:
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def __repr__(self):
        return f"Mesh({self.shape!r}, ranks={self.ranks.tolist()!r})"

    def __enter__(self):
        """``with mesh:``, the JAX package's idiom, binds nothing: the
        collectives bind inside ``shard_map`` and the sharded entry
        points."""
        return self

    def __exit__(self, *exc):
        return False


def make_mesh(axes: dict, devices: Optional[Sequence[int]] = None) -> Mesh:
    """A :class:`Mesh` from ``{axis_name: size}`` over ``devices`` (the
    ranks, all of the world's by default); the sizes must multiply to the
    rank count (``-1`` once for "all remaining").  Needs an initialized
    process group (``multihost.initialize``, whose device the ranks
    compute on), and every rank of the world calls it."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "parallel.multihost.initialize(coordinator, num_processes, "
            "process_id) on every rank first")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    names = tuple(axes)
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(ranks) // max(known, 1)
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {len(ranks)} "
                         f"devices")
    from . import multihost

    return Mesh(np.asarray(ranks).reshape(sizes), names,
                multihost.rank_device().type)


# The mesh whose axes are bound while a sharded function runs.
_BOUND: contextvars.ContextVar = contextvars.ContextVar("rq_bound_mesh",
                                                        default=None)


@contextlib.contextmanager
def bind(mesh: Mesh):
    """Bind ``mesh``'s axis names for the collectives inside."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def _bound_mesh(axis_name: str) -> Optional[Mesh]:
    mesh = _BOUND.get()
    if mesh is None or axis_name not in mesh.axis_names:
        return None
    return mesh


def axis_present(axis_name: str) -> bool:
    return _bound_mesh(axis_name) is not None


def axis_size_or_1(axis_name: str) -> int:
    mesh = _bound_mesh(axis_name)
    return 1 if mesh is None else mesh.shape[axis_name]


def axis_index(axis_name: str) -> int:
    """This rank's index along a bound axis (0 when unbound)."""
    mesh = _bound_mesh(axis_name)
    return 0 if mesh is None else mesh.coordinate()[axis_name]


def _wire_device(group) -> torch.device:
    """Where a collective's buffer must lie for ``group``'s backend: host
    memory for gloo, this rank's card for NCCL."""
    dist = _dist()
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _count(name: str, t0: float):
    st = STATS.setdefault(name, [0, 0.0])
    st[0] += 1
    st[1] += time.perf_counter() - t0


def _all_reduce(x, op: str, group, name: str):
    """``x`` reduced over ``group``, a new tensor on ``x``'s device (a card
    tensor goes through the host on a gloo group)."""
    dist = _dist()
    t = torch.as_tensor(x)
    t0 = time.perf_counter()
    buf = t.detach().to(_wire_device(group), copy=True)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op), group=group)
    out = buf.to(t.device)
    _count(name, t0)
    return out


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (equal shapes) over ``group``, in rank order, on
    ``x``'s device (through the host on a gloo group)."""
    dist = _dist()
    t0 = time.perf_counter()
    buf = x.detach().to(_wire_device(group)).contiguous()
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    parts = [p.to(x.device) for p in parts]
    _count("all_gather", t0)
    return parts


def _reduce(x, axis_name: str, op: str, name: str):
    mesh = _bound_mesh(axis_name)
    if mesh is None:
        return x
    return _all_reduce(x, op, mesh.group(axis_name), name)


def mesh_reduce(x, mesh: Mesh, op: str = "SUM", axes=None):
    """``x`` reduced over every rank of ``mesh`` (or of the ranks that
    ``axes`` span): one all-reduce per axis, whatever is bound."""
    for a in (mesh.axis_names if axes is None else _axes(axes)):
        x = _all_reduce(x, op, mesh.group(a), "p" + op.lower())
    return x


def psum(x, axis_name: str = "data"):
    """Sum over the named mesh axis; the identity when the axis is
    unbound, so kernel code never branches on the mesh."""
    return _reduce(x, axis_name, "SUM", "psum")


def pmin(x, axis_name: str = "data"):
    return _reduce(x, axis_name, "MIN", "pmin")


def pmax(x, axis_name: str = "data"):
    return _reduce(x, axis_name, "MAX", "pmax")


def pany(x, axis_name: str = "data"):
    """Logical or across the axis (failure and overflow flags), reduced as
    the MAX of int32: not every backend reduces booleans."""
    if not axis_present(axis_name):
        return x
    return _reduce(torch.as_tensor(x).to(torch.int32), axis_name, "MAX",
                   "pany") > 0


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_total(mesh: Mesh, axis) -> int:
    """Ranks behind ``axis``: a name or a tuple of names."""
    return int(np.prod([mesh.shape[a] for a in _axes(axis)]))


def block_index(mesh: Mesh, axis) -> int:
    """This rank's block along ``axis`` (a tuple of names counts
    row-major, its first name slowest)."""
    coord = mesh.coordinate()
    idx = 0
    for a in _axes(axis):
        idx = idx * mesh.shape[a] + coord[a]
    return idx


def tree_map(fn, tree):
    """``fn`` over every tensor or array leaf of ``tree`` (dicts, lists,
    tuples, NamedTuples and dataclasses; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float,
                         bool)):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def is_sharded(x) -> bool:
    """``x`` is marked as sharded (a DTensor).  Read without importing the
    DTensor module (about a second): no DTensor exists before it is
    imported, so the unsharded paths never pay for it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local(tree):
    """This rank's part of every leaf: a sharded leaf's local tensor, a
    plain leaf as it is."""
    def one(x):
        return x.to_local() if is_sharded(x) else x
    return tree_map(one, tree)


def total(x) -> torch.Tensor:
    """The sum of every element of ``x`` (a 0-dim tensor), over every
    rank that holds a part of it when ``x`` is marked as sharded."""
    if not is_sharded(x):
        return x.sum()
    from torch.distributed.tensor import Shard

    s = x.to_local().sum()
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard):
            s = _all_reduce(s, "SUM", x.device_mesh.get_group(mesh_dim=mdim),
                            "psum")
    return s


def _check_order(mesh: Mesh, axes: tuple):
    pos = [mesh.axis_names.index(a) for a in axes]
    if pos != sorted(pos) or len(set(pos)) != len(pos):
        raise ValueError(f"axes {axes} must appear in the mesh's order "
                         f"{mesh.axis_names}")


def mark(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The local tensor ``x`` marked as its block of a global tensor laid
    out by ``spec`` (a :class:`P`) over ``mesh``; a spec that splits
    nothing leaves ``x`` plain (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate()] * len(mesh.axis_names)
    split = False
    for dim, part in enumerate(tuple(spec)):
        if part is None:
            continue
        axes = _axes(part)
        _check_order(mesh, axes)
        for a in axes:
            placements[mesh.axis_names.index(a)] = Shard(dim)
            split = True
    if not split:
        return x
    return DTensor.from_local(x, mesh.device_mesh, placements,
                              run_check=False)


def _block(x, mesh: Mesh, spec):
    """This rank's block of the global ``x`` under ``spec``."""
    if is_sharded(x):
        return x.to_local()
    x = torch.as_tensor(x)
    for dim, part in enumerate(tuple(spec)):
        if part is None:
            continue
        n = axis_total(mesh, part)
        if x.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {x.shape[dim]} not divisible by "
                f"mesh axis {part}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, block_index(mesh, part) * size, size)
    return x


def block(tree, mesh: Mesh, spec):
    """This rank's block of every tensor of ``tree`` under ``spec`` (one
    :class:`P` for every leaf), as plain contiguous tensors; a leaf
    already marked as sharded gives its local tensor."""
    return tree_map(lambda x: _block(x, mesh, spec).contiguous(), tree)


def shard_leading(tree, mesh: Mesh, axis="data"):
    """Every tensor of ``tree`` with its LEADING dimension split over
    ``axis`` (a name, or a tuple of names in the mesh's order such as
    ``("dcn", "data")``): this rank's rows, marked as sharded.  The
    leading dimension must divide by the axis size."""
    return tree_map(lambda x: mark(_block(x, mesh, P(axis)).contiguous(),
                                   mesh, P(axis)), tree)


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` whole on every rank (a plain tensor is
    read as replicated)."""
    del mesh
    return tree_map(torch.as_tensor, tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``: ``specs`` is one :class:`P` for
    every leaf below it, or a tree of specs shaped like ``tree``."""
    if specs is None:
        specs = P()
    if isinstance(specs, P):
        return tree_map(lambda x: fn(x, specs), tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _zip_map(fn, v, specs[k]))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _zip_map(fn, getattr(tree, f.name),
                             getattr(specs, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, specs)


def shard_map(f, mesh: Mesh, in_specs, out_specs, **kw):
    """``f`` run on this rank's blocks: each input cut by its spec in
    ``in_specs`` (a spec or a tree of specs, one per argument), ``f``
    called with the mesh's axes bound, each output marked by its spec in
    ``out_specs``.  ``check_vma``/``check_rep`` are accepted in either of
    the JAX package's spellings; the port has no replication check for
    them to turn off."""
    kw.pop("check_vma", None)
    kw.pop("check_rep", None)
    if kw:
        raise TypeError(f"shard_map got unexpected keywords {sorted(kw)}")

    def run(*args):
        specs = (in_specs,) * len(args) if isinstance(in_specs, P) \
            else tuple(in_specs)
        blocks = [_zip_map(lambda x, s: _block(x, mesh, s), a, s)
                  for a, s in zip(args, specs)]
        with bind(mesh):
            out = f(*blocks)
        return _zip_map(lambda x, s: mark(x, mesh, s), out, out_specs)
    return run
