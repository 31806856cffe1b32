"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` into a shared library
with a plain C interface on first use (one ``nvcc`` per source, all
started together), cached by the content of the source, the headers and
the flags under ``redqueen_tpu_torch/_build/``, and loaded with
``ctypes`` by one loader, :func:`_library`, which declares each library's
entry points and checks its compile-time bounds from one table,
:data:`_API`.  Three kernels: the event kernel of the fused engine
(``csrc/event_kernel.cu``), the Hawkes event pass of the learn path
(``csrc/hawkes_pass.cu``) and the Hawkes thinning of the star engine's
streams (``csrc/hawkes_thin.cu``).
Nothing here runs when the module is imported, so the CPU tests import it
on machines without ``nvcc``.

The wrappers check device, dtype, shape and contiguity, allocate the
outputs, launch on PyTorch's current stream without synchronising, raise
on a failed launch (``cudaGetLastError``), and count their launches in
:data:`LAUNCHES`."""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..runtime.numerics import DEFAULT_MAX_PROPOSALS
from .event_step import CARRY_NAMES, PARAM_NAMES, KernelSpec

__all__ = ["MAX_S", "HAWKES_MAX_D", "NVCC_FLAGS", "BUILD_DIR", "build",
           "LAUNCHES", "reset_launch_counts", "check_kernel_shape",
           "Geometry", "geometry", "launch_event_kernel",
           "threefry_on_device", "hawkes_segments", "launch_hawkes_pass",
           "launch_hawkes_carry", "launch_hawkes_thin"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: Compile-time bound on sources per component (RQ_MAX_S in the kernel).
MAX_S = 32

#: The most dimensions the Hawkes pass takes (RQ_HAWKES_MAX_D): each
#: warp's [D, D] partial lives in its block's shared memory.
HAWKES_MAX_D = 128

#: sm_90a code for Hopper.  No --use_fast_math, and --fmad=false so that
#: no multiply-add is fused: each operation rounds as the plain version's.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

#: Launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"event_kernel": 0, "threefry": 0,
                            "hawkes_pass": 0, "hawkes_carry": 0,
                            "hawkes_thin": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: Compiler output of the last build, per source (ptxas register report).
BUILD_LOG: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda) — the CUDA kernels are built on first use")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Tuple[Dict[str, Path], float]:
    """Compile every ``csrc/*.cu`` that has no current library yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``({stem: library path}, seconds)``; raises ``RuntimeError`` with the
    compiler output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs: Dict[str, Path] = {}
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        lib = BUILD_DIR / f"lib{src.stem}-{_digest(src)}.so"
        libs[src.stem] = lib
        if lib.exists():
            continue
        # Built under a per-process name and renamed into place, so a
        # concurrent build never loads a half-written library.
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        jobs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        BUILD_LOG[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} (rc "
                          f"{proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0


_VP, _INT = ctypes.c_void_p, ctypes.c_int

#: What each ``csrc/<stem>.cu`` library exports, by stem: its C entry
#: points as ``name: (argtypes, restype)``, its ``const char *(int)``
#: that names a CUDA error code, and its ``int (void)`` compile-time
#: bounds, each with the value it must share with this module, as
#: ``entry: (name here, value)``.
_API = {
    "event_kernel": {
        "entries": {
            "rq_event_kernel_launch": (
                [_VP] * 5                     # params, carry in/out, log
                + [_INT] * 6                  # B, S, F, Kr, Kp, steps
                + [ctypes.c_float, ctypes.c_uint, _INT]  # end, mask, flags
                + [_VP], _INT),               # stream
            "rq_threefry_launch": ([_VP] * 6 + [_INT, _VP], _INT),
            "rq_event_kernel_geometry": (
                [_INT, _INT, ctypes.c_uint] + [ctypes.POINTER(_INT)] * 3,
                None),
        },
        "error": "rq_error_string",
        "bounds": {"rq_max_sources": ("MAX_S", MAX_S)},
    },
    "hawkes_pass": {
        "entries": {
            "rq_hawkes_pass_launch": ([_VP] * 13 + [_INT] * 4 + [_VP] * 2,
                                      _INT),
            "rq_hawkes_carry_launch": ([_VP] * 6 + [_INT] * 5 + [_VP] * 2,
                                       _INT),
            "rq_hawkes_segments": ([_INT], _INT),
            "rq_hawkes_max_segments": ([_INT], _INT),
            "rq_hawkes_workspace_floats": ([_INT] * 3, ctypes.c_longlong),
        },
        "error": "rq_hawkes_error_string",
        "bounds": {"rq_hawkes_max_dims": ("HAWKES_MAX_D", HAWKES_MAX_D)},
    },
    "hawkes_thin": {
        "entries": {
            "rq_hawkes_thin_launch": (
                [_VP] * 4 + [_INT, _INT, ctypes.c_float, ctypes.c_float,
                             _INT] + [_VP] * 5, _INT),
        },
        "error": "rq_hawkes_thin_error_string",
        "bounds": {},
    },
}


def _library(stem: str) -> ctypes.CDLL:
    """``csrc/<stem>.cu``'s library: built on first use (:func:`build`),
    loaded, its entry points declared from :data:`_API` and its
    compile-time bounds checked against this module's; cached."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    api = _API[stem]
    lib = ctypes.CDLL(str(build()[0][stem]))
    entries = {**api["entries"], api["error"]: ([_INT], ctypes.c_char_p),
               **{name: ([], _INT) for name in api["bounds"]}}
    for name, (argtypes, restype) in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    for name, (here, want) in api["bounds"].items():
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(
                f"kernel library bound {name}()={got} disagrees with "
                f"ops.kernels {here}={want}")
    _LIBS[stem] = lib
    return lib


def _raise_on(stem: str, rc: int, what: str) -> None:
    """Raise for a nonzero return ``rc`` of ``stem``'s library, with the
    library's name for the CUDA error."""
    if rc != 0:
        msg = getattr(_library(stem), _API[stem]["error"])(rc)
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({msg.decode(errors='replace')})")


def check_kernel_shape(spec: KernelSpec) -> None:
    """Raise ``ValueError`` naming the limit when a shape exceeds what the
    event kernel takes."""
    if spec.S > MAX_S:
        raise ValueError(
            f"the event kernel takes at most MAX_S={MAX_S} sources per "
            f"component (compile-time bound RQ_MAX_S), got S={spec.S}")
    if spec.k * spec.capacity >= 2**31:
        raise ValueError(
            f"k * capacity = {spec.k * spec.capacity} steps per launch "
            f"exceeds the kernel's int32 step count")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch spreads over the card: one thread per lane,
    ``lanes_per_block`` lanes in each of ``blocks`` blocks, and
    ``smem_bytes`` of dynamic shared memory per block."""

    lanes_per_block: int
    blocks: int
    smem_bytes: int


def _opt_mask(spec: KernelSpec) -> int:
    mask = 0
    for r in spec.opt_rows:
        mask |= 1 << r
    return mask


def geometry(spec: KernelSpec, B: int) -> Geometry:
    """The geometry the event kernel launches ``spec`` over ``B`` lanes
    in, as the kernel's library computes it (building it on first use).
    Each lane keeps its per-source constants, state and react table in
    shared memory."""
    vals = [ctypes.c_int() for _ in range(3)]
    _library("event_kernel").rq_event_kernel_geometry(
        B, spec.S, _opt_mask(spec), *(ctypes.byref(v) for v in vals))
    return Geometry(*(v.value for v in vals))


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _flags(spec: KernelSpec) -> int:
    return ((1 if spec.has_hawkes else 0) | (2 if spec.has_rd else 0)
            | (4 if spec.has_pw else 0))


def launch_event_kernel(spec: KernelSpec, params: Dict[str, torch.Tensor],
                        carry: Dict[str, torch.Tensor]):
    """One launch of the event kernel on CUDA tensors: ``spec.k`` chunks
    of ``spec.capacity`` steps from ``carry``.  Takes and returns what
    ``event_step.run_launch`` does: ``(carry_out, times [k*cap, B] f32,
    srcs [k*cap, B] i32)``; the inputs are not modified."""
    check_kernel_shape(spec)
    dev = params["rate"].device
    if dev.type != "cuda":
        raise ValueError(f"launch_event_kernel takes CUDA tensors, got {dev}")
    S, F = spec.S, spec.F
    B = params["rate"].shape[-1]
    Kr = params["rd_times"].shape[1]
    Kp = params["pw_times"].shape[1]
    f32, i32 = torch.float32, torch.int32
    want = {
        "kind": (i32, (S, B)), "rate": (f32, (S, B)), "k0": (i32, (S, B)),
        "k1": (i32, (S, B)), "q": (f32, (S, B)), "ssink": (f32, (F, B)),
        "adj": (f32, (S, F, B)), "l0": (f32, (S, B)),
        "alpha": (f32, (S, B)), "beta": (f32, (S, B)),
        "rd_times": (f32, (S, Kr, B)), "pw_times": (f32, (S, Kp, B)),
        "pw_rates": (f32, (S, Kp, B)),
        "t_next": (f32, (S, B)), "ctr": (i32, (S, B)), "t": (f32, (B,)),
        "nev": (i32, (B,)), "health": (i32, (B,)), "exc": (f32, (S, B)),
        "exc_t": (f32, (S, B)), "rd_ptr": (i32, (S, B)),
    }
    if spec.has_rd and Kr != spec.Kr:
        raise ValueError(f"rd_times has Kr={Kr}, spec says {spec.Kr}")
    if spec.has_pw and Kp != spec.Kp:
        raise ValueError(f"pw_times has Kp={Kp}, spec says {spec.Kp}")
    for nm in PARAM_NAMES:
        _require(params[nm], nm, *want[nm], dev)
    for nm in CARRY_NAMES:
        _require(carry[nm], nm, *want[nm], dev)
    lib = _library("event_kernel")
    steps = spec.k * spec.capacity
    out = {nm: torch.empty_like(carry[nm]) for nm in CARRY_NAMES}
    times = torch.empty((steps, B), dtype=f32, device=dev)
    srcs = torch.empty((steps, B), dtype=i32, device=dev)
    ptrs = ctypes.c_void_p * 13
    cptrs = ctypes.c_void_p * 8
    p_arr = ptrs(*(params[nm].data_ptr() for nm in PARAM_NAMES))
    ci_arr = cptrs(*(carry[nm].data_ptr() for nm in CARRY_NAMES))
    co_arr = cptrs(*(out[nm].data_ptr() for nm in CARRY_NAMES))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rq_event_kernel_launch(
        ctypes.cast(p_arr, ctypes.c_void_p),
        ctypes.cast(ci_arr, ctypes.c_void_p),
        ctypes.cast(co_arr, ctypes.c_void_p),
        times.data_ptr(), srcs.data_ptr(), B, S, F, Kr, Kp, steps,
        float(spec.end_time), _opt_mask(spec), _flags(spec), stream)
    _raise_on("event_kernel", rc, "event kernel")
    LAUNCHES["event_kernel"] += 1
    return out, times, srcs


def threefry_on_device(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor):
    """The kernel's threefry device function on int32 CUDA tensors of
    equal shape (uint32 bit patterns); returns ``(y0, y1)`` likewise."""
    dev = k0.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_on_device takes CUDA tensors, got {dev}")
    for nm, t in (("k0", k0), ("k1", k1), ("x0", x0), ("x1", x1)):
        _require(t, nm, torch.int32, tuple(k0.shape), dev)
    lib = _library("event_kernel")
    y0, y1 = torch.empty_like(k0), torch.empty_like(k0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rq_threefry_launch(k0.data_ptr(), k1.data_ptr(), x0.data_ptr(),
                                x1.data_ptr(), y0.data_ptr(), y1.data_ptr(),
                                k0.numel(), stream)
    _raise_on("event_kernel", rc, "threefry")
    LAUNCHES["threefry"] += 1
    return y0, y1


def hawkes_segments(D: int) -> int:
    """The segments a chunk (warps a block) the Hawkes pass uses at ``D``
    dimensions, as the kernel's library chooses them (building it on
    first use)."""
    return _library("hawkes_pass").rq_hawkes_segments(D)


def _hawkes_inputs(fn: str, named, by: torch.Tensor):
    """Check the stream's and the parameters' tensors for ``fn``; ``D``
    is ``by``'s length.  Returns ``(C, K, D)``."""
    dt = named[0][1]
    dev = dt.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {dev}")
    if dt.dim() != 2:
        raise ValueError(f"dt must be [C, K], got shape {tuple(dt.shape)}")
    C, K = dt.shape
    D = by.shape[0] if by.dim() == 1 else -1
    if not 1 <= D <= HAWKES_MAX_D:
        raise ValueError(
            f"the hawkes_pass kernel takes 1 to HAWKES_MAX_D="
            f"{HAWKES_MAX_D} dimensions (each warp's [D, D] partial lives "
            f"in its block's shared memory), got "
            f"D={D if D > 0 else tuple(by.shape)}")
    f32 = torch.float32
    want = {"dt": (f32, (C, K)), "dims": (torch.int32, (C, K)),
            "mask": (torch.bool, (C, K)), "tail": (f32, (C, K)),
            "mu": (f32, (D,)), "alpha": (f32, (D, D)), "beta": (f32, (D,))}
    for nm, t in named:
        _require(t, nm, *want[nm], dev)
    return C, K, D


def launch_hawkes_pass(dt: torch.Tensor, dims: torch.Tensor,
                       mask: torch.Tensor, tail: torch.Tensor,
                       mu: torch.Tensor, alpha: torch.Tensor,
                       beta: torch.Tensor, grad: bool = False):
    """One pass of the Hawkes event kernel on CUDA tensors: ``dt``,
    ``tail`` f32 [C, K], ``dims`` i32 [C, K], ``mask`` bool [C, K],
    ``mu``/``beta`` f32 [D], ``alpha`` f32 [D, D].  Returns the per-chunk
    partials ``(ll [C], a [C, D], b [C, D, D], w [C, D], e [C, D])`` and
    ``health`` i32 [D], as ``learn.loglik.hawkes_pass_plain`` does (stats
    mode, or grad mode with ``grad=True``).  A pass is three CUDA launches
    (segment summaries, carries, the pass) and counts once.  Raises
    ``ValueError`` naming the limit for a ``D`` above
    :data:`HAWKES_MAX_D`."""
    C, K, D = _hawkes_inputs("launch_hawkes_pass", (
        ("dt", dt), ("dims", dims), ("mask", mask), ("tail", tail),
        ("mu", mu), ("alpha", alpha), ("beta", beta)), mu)
    lib = _library("hawkes_pass")
    dev, f32 = dt.device, torch.float32
    W = lib.rq_hawkes_segments(D)
    work = torch.empty(lib.rq_hawkes_workspace_floats(C, W, D), dtype=f32,
                       device=dev)
    ll = torch.empty(C, dtype=f32, device=dev)
    a = torch.empty((C, D), dtype=f32, device=dev)
    b = torch.empty((C, D, D), dtype=f32, device=dev)
    w = torch.empty((C, D), dtype=f32, device=dev)
    e = torch.empty((C, D), dtype=f32, device=dev)
    health = torch.zeros(D, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rq_hawkes_pass_launch(
        dt.data_ptr(), dims.data_ptr(), mask.data_ptr(), tail.data_ptr(),
        mu.data_ptr(), alpha.data_ptr(), beta.data_ptr(), ll.data_ptr(),
        a.data_ptr(), b.data_ptr(), w.data_ptr(), e.data_ptr(),
        health.data_ptr(), C, K, D, 1 if grad else 0, work.data_ptr(),
        stream)
    _raise_on("hawkes_pass", rc, "hawkes_pass")
    LAUNCHES["hawkes_pass"] += 1
    return ll, a, b, w, e, health


def launch_hawkes_carry(dt: torch.Tensor, dims: torch.Tensor,
                        mask: torch.Tensor, beta: torch.Tensor,
                        segments: int = None, grad: bool = False):
    """Phases (A) and (B) of the Hawkes pass alone, on CUDA tensors: R and
    Q at the start of every segment, ``(r_in, q_in)`` f32 [C, W, D] with
    ``W = segments`` a chunk (the pass's own by default; ``q_in`` is zero
    in grad mode), as ``learn.loglik.hawkes_carry_plain`` gives them."""
    C, K, D = _hawkes_inputs("launch_hawkes_carry", (
        ("dt", dt), ("dims", dims), ("mask", mask), ("beta", beta)), beta)
    lib = _library("hawkes_pass")
    W = lib.rq_hawkes_segments(D) if segments is None else int(segments)
    top = lib.rq_hawkes_max_segments(D)
    if not 1 <= W <= top:
        raise ValueError(f"launch_hawkes_carry takes 1 to {top} segments a "
                         f"chunk at D={D}, got {W}")
    dev, f32 = dt.device, torch.float32
    work = torch.empty(lib.rq_hawkes_workspace_floats(C, W, D), dtype=f32,
                       device=dev)
    r_in = torch.empty((C, W, D), dtype=f32, device=dev)
    q_in = torch.empty((C, W, D), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rq_hawkes_carry_launch(
        dt.data_ptr(), dims.data_ptr(), mask.data_ptr(), beta.data_ptr(),
        r_in.data_ptr(), q_in.data_ptr(), C, K, D, W, 1 if grad else 0,
        work.data_ptr(), stream)
    _raise_on("hawkes_pass", rc, "hawkes_carry")
    LAUNCHES["hawkes_carry"] += 1
    return r_in, q_in


def launch_hawkes_thin(key: torch.Tensor, l0: torch.Tensor,
                       alpha: torch.Tensor, beta: torch.Tensor, t0: float,
                       T: float, cap: int):
    """The finished Hawkes streams of ``N`` sources in one launch of the
    thinning kernel: ``key`` i32 [N, 2] (uint32 bit patterns), ``l0``,
    ``alpha``, ``beta`` f32 [N], all on one CUDA device.  Returns
    ``(times f32 [N, cap], n i32 [N], truncated bool [N], steps)``, the
    stream ``ops.streams._hawkes_stream_plain`` gives from the same key;
    ``steps`` is an i32 [1] CUDA tensor that will hold the most loop
    steps any source needed.  A chain
    stops after ``numerics.DEFAULT_MAX_PROPOSALS`` proposals, as the
    plain loop's does.  Every input is checked before the library is
    loaded."""
    dev = key.device
    N = key.shape[0] if key.dim() == 2 else -1
    _require(key, "key", torch.int32, (N, 2), dev)
    for nm, t in (("l0", l0), ("alpha", alpha), ("beta", beta)):
        _require(t, nm, torch.float32, (N,), dev)
    if dev.type != "cuda":
        raise ValueError(f"launch_hawkes_thin takes CUDA tensors, got {dev}")
    if cap < 0:
        raise ValueError(f"launch_hawkes_thin takes cap >= 0, got {cap}")
    lib = _library("hawkes_thin")
    times = torch.full((N, cap), float("inf"), dtype=torch.float32,
                       device=dev)
    n = torch.empty(N, dtype=torch.int32, device=dev)
    truncated = torch.empty(N, dtype=torch.bool, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rq_hawkes_thin_launch(
        key.data_ptr(), l0.data_ptr(), alpha.data_ptr(), beta.data_ptr(), N,
        cap, float(t0), float(T), DEFAULT_MAX_PROPOSALS, times.data_ptr(),
        n.data_ptr(), truncated.data_ptr(), steps.data_ptr(), stream)
    _raise_on("hawkes_thin", rc, "hawkes_thin")
    LAUNCHES["hawkes_thin"] += 1
    return times, n, truncated, steps
