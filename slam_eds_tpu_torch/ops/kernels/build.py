"""Lazy builds of the port's native sources into ctypes libraries.

* ``build_library``: a CUDA library from the sources under
  ``slam_eds_tpu_torch/csrc`` with ``nvcc -gencode arch=compute_90a,
  code=sm_90a -O3 -shared -Xcompiler -fPIC``.
* ``build_host_library``: a host library (the event ring, the event-file
  reader, the PNG decoder, the frame loader and the sequence scheduler under
  ``csrc/host``) with the host C++ compiler, ``-O3 -std=c++17 -fPIC -shared
  -lz -lpthread``.

Each goes into ``slam_eds_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed by a hash of the sources, the headers they may include (every
``csrc/*.cuh`` for a CUDA library) and the flags, and is loaded with
``ctypes``. ``load_library`` builds a CUDA library once per process and
declares its functions.
Nothing here runs at import time; a missing compiler or a failed compile
raises.

The kernels' launch counters: an entry point made with ``counted`` (its
``launches`` attribute) or a ``LaunchCount`` joins ``COUNTERS`` when it is
made, which ``graphs.counters`` reads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no multiply-add contraction, so a kernel rounds operation by
# operation as its plain torch version does (each torch op rounds alone)
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
HOST_LIBS = ["-lz", "-lpthread"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "slam_eds_tpu_torch are built with nvcc at first use")


def find_host_compiler() -> str:
    for cand in ("g++", "c++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) found")


class BuiltLibrary:
    """A loaded library with its build record."""

    def __init__(self, lib, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds   # 0.0 when an existing build was loaded
        self.log = log                 # compiler output (registers, spills)


def _build(name: str, sources, compiler: str, flags, libs,
           headers=()) -> BuiltLibrary:
    srcs = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256()
    for s in [*srcs, *headers]:
        h.update(s.read_bytes())
    h.update(" ".join(flags + libs).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private name, then an atomic rename: a concurrent build of the
        # same library never exposes a half-written file
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), *map(str, srcs), *libs]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed building {name} "
                               f"(rc={proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)


def build_library(name: str, sources) -> BuiltLibrary:
    """A CUDA library built with nvcc for ``sm_90a``."""
    return _build(name, sources, find_nvcc(), ARCH_FLAGS + NVCC_FLAGS, [],
                  headers=sorted(CSRC_DIR.glob("*.cuh")))


def build_host_library(name: str, sources) -> BuiltLibrary:
    """A host library built with the host C++ compiler, linked with zlib
    and pthreads."""
    return _build(name, sources, find_host_compiler(), HOST_FLAGS, HOST_LIBS)


# the library of each name that ``load_library`` has loaded
_LOADED = {}


def load_library(name: str, sources, functions, layout=None) -> BuiltLibrary:
    """The CUDA library ``name`` (``build_library``), built and declared at
    its first call in the process: ``functions`` maps each function to its
    ``argtypes`` (every one returns an int, 0 or an error code), and
    ``<name>_error_string`` turns a code into its message. ``layout``
    (what, {function: value}) names constants the library returns that
    must equal this side's: the first call raises where they do not."""
    built = _LOADED.get(name)
    if built is None:
        built = build_library(name, sources)
        lib = built.lib
        what, want = layout or ("", {})
        for fn, argtypes in {**functions, **dict.fromkeys(want, [])}.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        got = tuple(getattr(lib, fn)() for fn in want)
        if got != tuple(want.values()):
            raise RuntimeError(f"{sources[0]}'s {what} {got} are not "
                               f"{tuple(want.values())}")
        _LOADED[name] = built
    return built


# every launch counter in the order it was made; the list only grows at its
# end (``graphs.counters``)
COUNTERS = []


class LaunchCount:
    """A launch counter that is not an entry point (one size of a kernel):
    a ``__name__`` and ``launches``, as a ``counted`` entry point has."""

    def __init__(self, name):
        self.__name__ = name
        self.launches = 0
        COUNTERS.append(self)


def counted(fn):
    """Make the entry point ``fn`` a launch counter: ``fn.launches`` from 0,
    which the caller advances at each launch."""
    fn.launches = 0
    COUNTERS.append(fn)
    return fn
