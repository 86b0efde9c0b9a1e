"""Event ring buffer, packetizer and event-file reader — port of
``slam_eds_tpu.io.event_buffer``.

The native runtime is the port's own copy of the host sources
(``csrc/host/event_runtime.cpp`` and ``csrc/host/dataflow.cpp``), built at
first use into ``slam_eds_tpu_torch/_build/`` by
``ops/kernels/build.build_host_library`` and bound here with ctypes: a
single-producer single-consumer ring with monotonic-timestamp repair and
one-pass packetization into the fixed-capacity padded arrays the event step
consumes, and a streaming ``"t x y p"`` text reader. When the host compiler
or zlib is missing, ``available()`` is False (``build_error()`` says why)
and ``PurePythonRing`` / ``PurePythonReader`` give the same results in
numpy.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..ops.kernels.build import build_host_library

HOST_SOURCES = ["host/event_runtime.cpp", "host/dataflow.cpp"]

_lib = None
_build_error: Optional[str] = None


def _declare(lib) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.event_ring_create.restype = ctypes.c_void_p
    lib.event_ring_create.argtypes = [ctypes.c_int64]
    lib.event_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.event_ring_push.restype = ctypes.c_int64
    lib.event_ring_push.argtypes = [ctypes.c_void_p, f32p, f32p, f64p, f32p,
                                    ctypes.c_int64]
    lib.event_ring_size.restype = ctypes.c_int64
    lib.event_ring_size.argtypes = [ctypes.c_void_p]
    lib.event_ring_free.restype = ctypes.c_int64
    lib.event_ring_free.argtypes = [ctypes.c_void_p]
    lib.event_ring_pop_packet.restype = ctypes.c_int64
    lib.event_ring_pop_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, f32p, f32p, f64p,
        f32p, ctypes.POINTER(ctypes.c_double)]
    lib.event_ring_pop_until.restype = ctypes.c_int64
    lib.event_ring_pop_until.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_int64, f32p, f32p, f64p,
        f32p, ctypes.POINTER(ctypes.c_double)]
    lib.event_ring_dropped.restype = ctypes.c_int64
    lib.event_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.event_ring_nonmonotonic.restype = ctypes.c_int64
    lib.event_ring_nonmonotonic.argtypes = [ctypes.c_void_p]
    lib.event_file_open.restype = ctypes.c_void_p
    lib.event_file_open.argtypes = [ctypes.c_char_p]
    lib.event_file_close.argtypes = [ctypes.c_void_p]
    lib.event_file_read.restype = ctypes.c_int64
    lib.event_file_read.argtypes = [ctypes.c_void_p, f32p, f32p, f64p, f32p,
                                    ctypes.c_int64]
    lib.png_unfilter_rows.argtypes = [u8p, u8p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64]
    lib.event_apply_undistort.argtypes = [f32p, f32p, ctypes.c_int64, f32p,
                                          f32p, ctypes.c_int, ctypes.c_int]


def _load() -> Optional[ctypes.CDLL]:
    """The host library, built at first use; None when it cannot be built
    (the reason stays in ``build_error()``)."""
    global _lib, _build_error
    if _lib is None and _build_error is None:
        try:
            lib = build_host_library("host_runtime", HOST_SOURCES).lib
        except (RuntimeError, OSError) as e:   # no compiler, no zlib, ...
            _build_error = str(e)
            return None
        _declare(lib)
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the host library could not be built (None when it was)."""
    _load()
    return _build_error


def _native_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native event runtime unavailable: {_build_error}")
    return lib


def _alloc(capacity: int):
    return (np.empty(capacity, np.float32), np.empty(capacity, np.float32),
            np.empty(capacity, np.float64), np.empty(capacity, np.float32))


class EventRing:
    """Native SPSC event ring. push() from the reader, pop_packet() /
    pop_until() from the pipeline loop."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = _native_or_raise()
        self._ring = ctypes.c_void_p(self._lib.event_ring_create(capacity))

    def close(self) -> None:
        if getattr(self, "_ring", None):
            self._lib.event_ring_destroy(self._ring)
            self._ring = None

    __del__ = close

    def push(self, xs, ys, ts, ps) -> int:
        xs = np.ascontiguousarray(xs, np.float32)
        ys = np.ascontiguousarray(ys, np.float32)
        ts = np.ascontiguousarray(ts, np.float64)
        ps = np.ascontiguousarray(ps, np.float32)
        return int(self._lib.event_ring_push(self._ring, xs, ys, ts, ps,
                                             len(xs)))

    def __len__(self) -> int:
        return int(self._lib.event_ring_size(self._ring))

    def pop_packet(self, count: int, capacity: int):
        """-> (xs, ys, ts, ps, n_valid, median_t), arrays padded to
        ``capacity`` (last event repeated with zero polarity)."""
        xs, ys, ts, ps = _alloc(capacity)
        med = ctypes.c_double(0.0)
        n = int(self._lib.event_ring_pop_packet(
            self._ring, count, capacity, xs, ys, ts, ps, ctypes.byref(med)))
        return xs, ys, ts, ps, n, med.value

    def pop_until(self, t_end: float, capacity: int):
        """Every event with t < t_end, at most ``capacity``; same return as
        ``pop_packet``."""
        xs, ys, ts, ps = _alloc(capacity)
        med = ctypes.c_double(0.0)
        n = int(self._lib.event_ring_pop_until(
            self._ring, float(t_end), capacity, xs, ys, ts, ps,
            ctypes.byref(med)))
        return xs, ys, ts, ps, n, med.value

    @property
    def free_space(self) -> int:
        """Slots left before push() starts rejecting (and counting drops)."""
        return int(self._lib.event_ring_free(self._ring))

    @property
    def dropped(self) -> int:
        return int(self._lib.event_ring_dropped(self._ring))

    @property
    def nonmonotonic(self) -> int:
        return int(self._lib.event_ring_nonmonotonic(self._ring))


class PurePythonRing:
    """numpy ring with the native ring's semantics, counters included (for
    hosts without a C++ compiler or zlib). Like the native ring, it counts
    an accepted event as non-monotonic when its time is below the repaired
    time before it, and counts nothing for the events it drops (the JAX
    package's numpy ring counts raw backward steps over every event
    offered)."""

    def __init__(self, capacity: int = 1 << 20):
        self._cap = capacity
        self._chunks = []
        self._n = 0
        self.dropped = 0
        self.nonmonotonic = 0
        self._last_t = -1.0            # the native ring's initial time

    def push(self, xs, ys, ts, ps) -> int:
        take = min(len(xs), self._cap - self._n)
        self.dropped += len(xs) - take
        if take <= 0:
            return 0
        ts = np.asarray(ts[:take], np.float64)
        run = np.maximum.accumulate(np.concatenate([[self._last_t], ts]))
        self.nonmonotonic += int(np.count_nonzero(ts < run[:-1]))
        self._chunks.append((np.asarray(xs[:take], np.float32),
                             np.asarray(ys[:take], np.float32), run[1:],
                             np.asarray(ps[:take], np.float32)))
        self._n += take
        self._last_t = float(run[-1])
        return take

    def __len__(self):
        return self._n

    @property
    def free_space(self) -> int:
        return self._cap - self._n

    def _consolidate(self):
        if len(self._chunks) > 1:
            self._chunks = [tuple(np.concatenate([c[i] for c in self._chunks])
                                  for i in range(4))]

    def _pop_n(self, n: int, capacity: int):
        self._consolidate()
        xs_o, ys_o, ts_o, ps_o = _alloc(capacity)
        if n == 0:
            return xs_o, ys_o, ts_o, ps_o, 0, 0.0
        xs, ys, ts, ps = self._chunks[0]
        xs_o[:n], ys_o[:n], ts_o[:n], ps_o[:n] = xs[:n], ys[:n], ts[:n], ps[:n]
        xs_o[n:], ys_o[n:], ts_o[n:] = xs[n - 1], ys[n - 1], ts[n - 1]
        ps_o[n:] = 0.0
        self._chunks[0] = (xs[n:], ys[n:], ts[n:], ps[n:])
        self._n -= n
        return xs_o, ys_o, ts_o, ps_o, n, float(ts_o[n // 2])

    def pop_packet(self, count: int, capacity: int):
        return self._pop_n(min(count, self._n, capacity), capacity)

    def pop_until(self, t_end: float, capacity: int):
        self._consolidate()
        if not self._chunks:
            return self._pop_n(0, capacity)
        ts = self._chunks[0][2]
        n = int(np.searchsorted(ts, t_end, side="left"))
        return self._pop_n(min(n, capacity), capacity)


def make_ring(capacity: int = 1 << 20):
    """Native ring when buildable, the numpy ring otherwise."""
    return EventRing(capacity) if available() else PurePythonRing(capacity)


def _pump(reader, ring, chunk: int) -> int:
    """Feed ``ring`` from ``reader`` while it has room; returns the events
    pushed. An unaccepted tail is kept for the next call (a file reader can
    wait; only a live sensor loses events to ring overflow)."""
    total = 0
    while True:
        if reader._pend is None:
            xs, ys, ts, ps = reader.read(chunk)
            if len(xs) == 0:
                return total
            reader._pend = (xs, ys, ts, ps)
        xs, ys, ts, ps = reader._pend
        room = ring.free_space
        if room == 0:
            return total
        m = min(room, len(xs))
        pushed = ring.push(xs[:m], ys[:m], ts[:m], ps[:m])
        total += pushed
        if pushed < len(xs):
            reader._pend = (xs[pushed:], ys[pushed:], ts[pushed:],
                            ps[pushed:])
            return total
        reader._pend = None


class EventFileReader:
    """Native ASCII event-file reader (``"t x y p"`` lines, ``#`` comments).
    Streams chunks into numpy arrays or into a ring; the parse runs in C++
    with the interpreter lock released."""

    def __init__(self, path: str):
        self._lib = _native_or_raise()
        self._pend = None
        self._h = ctypes.c_void_p(self._lib.event_file_open(
            os.fsencode(path)))
        if not self._h:
            raise FileNotFoundError(path)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.event_file_close(self._h)
            self._h = None

    __del__ = close

    def read(self, max_n: int = 1 << 16):
        """-> (xs, ys, ts, ps) with n <= max_n events; empty at the end of
        the file. Polarity is +-1."""
        xs, ys, ts, ps = _alloc(max_n)
        n = int(self._lib.event_file_read(self._h, xs, ys, ts, ps, max_n))
        return xs[:n], ys[:n], ts[:n], ps[:n]

    def pump(self, ring, chunk: int = 1 << 16) -> int:
        return _pump(self, ring, chunk)


class PurePythonReader:
    """Streaming text reader with ``EventFileReader``'s read/pump API:
    O(chunk) memory however large the file."""

    def __init__(self, path: str):
        self._pend = None
        self._f = open(path, "r")

    def close(self) -> None:
        if getattr(self, "_f", None):
            self._f.close()
            self._f = None

    __del__ = close

    def read(self, max_n: int = 1 << 16):
        xs, ys, ts, ps = _alloc(max_n)
        n = 0
        while n < max_n:
            line = self._f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts[n] = float(parts[0])
            xs[n] = float(parts[1])
            ys[n] = float(parts[2])
            ps[n] = 1.0 if float(parts[3]) > 0 else -1.0
            n += 1
        return xs[:n], ys[:n], ts[:n], ps[:n]

    def pump(self, ring, chunk: int = 1 << 16) -> int:
        return _pump(self, ring, chunk)


def apply_undistort(xs, ys, mapx, mapy, width: int, height: int):
    """Per-event forward-map undistortion on the host in one pass: xs / ys
    (float32, contiguous) are replaced in place by the map's value at their
    rounded pixel; events outside the map move to (-1, -1), which the raster
    drops. The native route and the numpy route round half away from zero
    alike (``std::lround``)."""
    lib = _load()
    if lib is None:
        xi = np.trunc(xs + np.copysign(0.5, xs)).astype(np.int64)
        yi = np.trunc(ys + np.copysign(0.5, ys)).astype(np.int64)
        ok = (xi >= 0) & (yi >= 0) & (xi < width) & (yi < height)
        idx = np.clip(yi * width + xi, 0, width * height - 1)
        xs[:] = np.where(ok, mapx.reshape(-1)[idx], -1.0)
        ys[:] = np.where(ok, mapy.reshape(-1)[idx], -1.0)
        return
    mapx = np.ascontiguousarray(mapx, np.float32).reshape(-1)
    mapy = np.ascontiguousarray(mapy, np.float32).reshape(-1)
    lib.event_apply_undistort(xs, ys, len(xs), mapx, mapy, width, height)
