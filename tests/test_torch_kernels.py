"""The one loader of the hand kernels' libraries (``ops/kernels.py``:
``_API``, ``_library``, ``_raise_on``) on the CPU, where no library can
be built: the table covers every ``csrc/*.cu`` and nothing else, and the
loader, fed a stand-in library, declares every entry point the table
names, checks the compile-time bounds, caches what it loaded and names
a launch's CUDA error by the library's own error string.  The real
libraries load through it in ``tests/test_torch_cuda.py``."""

import ctypes

import pytest

from redqueen_tpu_torch.ops import kernels


def test_every_source_has_a_loader_entry():
    stems = {p.stem for p in kernels.CSRC_DIR.glob("*.cu")}
    assert stems and stems == set(kernels._API)
    for stem, api in kernels._API.items():
        assert (kernels.CSRC_DIR / f"{stem}.cu").is_file()
        named = [*api["entries"], api["error"], *api["bounds"]]
        assert len(set(named)) == len(named), stem


class _Fn:
    """A stand-in C function: returns ``ret`` and records its calls."""

    def __init__(self, ret):
        self.ret, self.calls = ret, []
        self.argtypes = self.restype = "undeclared"

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Lib:
    """A stand-in for ``stem``'s library, its bounds off by ``off``."""

    def __init__(self, stem, off=0):
        api = kernels._API[stem]
        for name in api["entries"]:
            setattr(self, name, _Fn(0))
        setattr(self, api["error"], _Fn(b"a named error"))
        for name, (_, value) in api["bounds"].items():
            setattr(self, name, _Fn(value + off))


@pytest.fixture
def stand_in(monkeypatch):
    """``kernels`` with an empty cache, a build that compiles nothing,
    and ``ctypes.CDLL`` handing out the stand-in of the library asked
    for; returns ``(set the bound offset, the libraries opened)``."""
    opened, off = [], [0]

    def build():
        return {s: kernels.BUILD_DIR / f"lib{s}.so" for s in kernels._API}, 0.0

    def cdll(path):
        stem = path.rsplit("/lib", 1)[1][:-len(".so")]
        opened.append(_Lib(stem, off[0]))
        return opened[-1]

    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    return off, opened


@pytest.mark.parametrize("stem", sorted(kernels._API))
def test_the_loader_declares_every_entry_once(stand_in, stem):
    _, opened = stand_in
    lib = kernels._library(stem)
    assert kernels._library(stem) is lib and opened == [lib]
    api = kernels._API[stem]
    for name, (argtypes, restype) in api["entries"].items():
        fn = getattr(lib, name)
        assert (fn.argtypes, fn.restype) == (argtypes, restype), name
    err = getattr(lib, api["error"])
    assert (err.argtypes, err.restype) == ([ctypes.c_int], ctypes.c_char_p)
    for name in api["bounds"]:
        fn = getattr(lib, name)
        assert (fn.argtypes, fn.restype) == ([], ctypes.c_int)
        assert fn.calls == [()]


@pytest.mark.parametrize("stem", sorted(
    s for s, api in kernels._API.items() if api["bounds"]))
def test_the_loader_refuses_a_library_whose_bound_disagrees(stand_in,
                                                             stem):
    off, _ = stand_in
    off[0] = 1
    (name, (here, value)), = kernels._API[stem]["bounds"].items()
    with pytest.raises(RuntimeError,
                       match=rf"{name}\(\)={value + 1} .* {here}={value}"):
        kernels._library(stem)
    assert stem not in kernels._LIBS


@pytest.mark.parametrize("stem", sorted(kernels._API))
def test_a_failed_launch_raises_with_the_library_s_error(stand_in, stem):
    kernels._raise_on(stem, 0, "a launch")
    with pytest.raises(RuntimeError, match=r"^a launch launch failed: CUDA "
                                           r"error 700 \(a named error\)$"):
        kernels._raise_on(stem, 700, "a launch")
    err = getattr(kernels._LIBS[stem], kernels._API[stem]["error"])
    assert err.calls == [(700,)]
