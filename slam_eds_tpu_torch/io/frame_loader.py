"""ctypes bindings for the native dataflow layer (``csrc/host/dataflow.cpp``)
— port of ``slam_eds_tpu.io.frame_loader``: PNG decode, the prefetching
frame loader and the sequence scheduler.

The loader runs N C++ worker threads that decode the dataset's frames ahead
of the consumer into a fixed pool of recycled slots (bounded prefetch), so
PNG inflate and unfiltering overlap the GPU work instead of serializing with
it in the Python loop; ctypes releases the interpreter lock during the
blocking ``next()``. The scheduler is the runner's frame/event-packet
interleave as a native state machine. ``available()`` is False when the
host library cannot be built, and the runner takes its Python loop.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .event_buffer import _load

_bound = False


def _lib() -> Optional[ctypes.CDLL]:
    global _bound
    lib = _load()
    if lib is None:
        return None
    if not _bound:
        i32 = ctypes.c_int32
        i64 = ctypes.c_int64
        pi32 = ctypes.POINTER(i32)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.png_open.restype = ctypes.c_void_p
        lib.png_open.argtypes = [ctypes.c_char_p]
        lib.png_meta.argtypes = [ctypes.c_void_p, pi32, pi32, pi32, pi32]
        lib.png_take.restype = i64
        lib.png_take.argtypes = [ctypes.c_void_p, u8p, i64]
        lib.frame_loader_create.restype = ctypes.c_void_p
        lib.frame_loader_create.argtypes = [ctypes.c_char_p, i32, i32]
        lib.frame_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.frame_loader_next_meta.restype = i32
        lib.frame_loader_next_meta.argtypes = [ctypes.c_void_p, pi32, pi32,
                                               pi32, pi32]
        lib.frame_loader_take.restype = i64
        lib.frame_loader_take.argtypes = [ctypes.c_void_p, u8p, i64]
        lib.sched_create.restype = ctypes.c_void_p
        lib.sched_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p, f64p,
                                     i64, i64, i64]
        lib.sched_destroy.argtypes = [ctypes.c_void_p]
        lib.sched_next.restype = i32
        lib.sched_next.argtypes = [ctypes.c_void_p, f32p, f32p, f64p, f32p,
                                   ctypes.POINTER(i64),
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.POINTER(i64)]
        _bound = True
    return lib


def available() -> bool:
    return _lib() is not None


def _wrap_pixels(buf: np.ndarray, w: int, h: int, c: int, d: int):
    """Native byte buffer -> the array shape and dtype read_png returns."""
    if d == 16:
        img = buf.view(np.uint16).reshape(h, w, c)
    else:
        img = buf.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def _meta():
    return tuple(ctypes.c_int32() for _ in range(4))


def read_png_native(path: str):
    """One native PNG decode (the subset and output of image_rw.read_png).
    None when the library is unavailable or the decode fails."""
    lib = _lib()
    if lib is None:
        return None
    h = lib.png_open(os.fsencode(path))
    if not h:
        return None
    w, hh, c, d = _meta()
    lib.png_meta(h, *map(ctypes.byref, (w, hh, c, d)))
    n = w.value * hh.value * c.value * (d.value // 8)
    buf = np.empty(n, np.uint8)
    lib.png_take(h, buf, n)
    return _wrap_pixels(buf, w.value, hh.value, c.value, d.value)


class FrameLoader:
    """In-order prefetching PNG decoder over native worker threads.

    ``next()`` returns the decoded frames in dataset order, then None;
    it raises on a file that fails to decode (as read_png does). ``close()``
    joins the workers."""

    def __init__(self, paths: list[str], n_threads: int = 2,
                 depth: int = 4):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native dataflow library unavailable")
        self._lib = lib
        self._paths = list(paths)
        self._h = ctypes.c_void_p(lib.frame_loader_create(
            "\n".join(self._paths).encode(), n_threads, depth))
        self._k = 0

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.frame_loader_destroy(self._h)
            self._h = None

    __del__ = close

    def next(self):
        w, h, c, d = _meta()
        rc = self._lib.frame_loader_next_meta(
            self._h, *map(ctypes.byref, (w, h, c, d)))
        if rc == 0:
            return None
        if rc < 0:
            path = self._paths[self._k]
            # free the failed slot before raising so the loader stays usable
            self._lib.frame_loader_take(self._h, np.empty(0, np.uint8), 0)
            self._k += 1
            raise ValueError(f"PNG decode failed: {path}")
        n = w.value * h.value * c.value * (d.value // 8)
        buf = np.empty(n, np.uint8)
        self._lib.frame_loader_take(self._h, buf, n)
        self._k += 1
        return _wrap_pixels(buf, w.value, h.value, c.value, d.value)


# work-item tags returned by SequenceScheduler.next()
DONE, FRAME, EVENTS = 0, 1, 2


class SequenceScheduler:
    """Native frame/event-packet interleave: FRAME k, then the EVENTS
    packets sliced at t_{k+1} (at most ``cap`` events each; packets under
    ``min_events`` dropped), FRAME k+1, ...

    ``ring`` / ``reader`` are the native ``EventRing`` / ``EventFileReader``
    (``reader`` may be None when every event is already in the ring); both
    are kept alive while the scheduler is."""

    def __init__(self, ring, reader, frame_times, cap: int,
                 min_events: int = 64):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native dataflow library unavailable")
        self._lib = lib
        self._ring = ring
        self._reader = reader
        self._cap = int(cap)
        times = np.ascontiguousarray(frame_times, np.float64)
        self._h = ctypes.c_void_p(lib.sched_create(
            ring._ring, reader._h if reader is not None else None, times,
            len(times), self._cap, int(min_events)))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)
            self._h = None

    __del__ = close

    def next(self):
        """-> (FRAME, k) | (EVENTS, (xs, ys, ts, ps, n, median_t)) |
        (DONE, None)."""
        cap = self._cap
        xs = np.empty(cap, np.float32)
        ys = np.empty(cap, np.float32)
        ts = np.empty(cap, np.float64)
        ps = np.empty(cap, np.float32)
        n = ctypes.c_int64(0)
        med = ctypes.c_double(0.0)
        fk = ctypes.c_int64(-1)
        rc = self._lib.sched_next(self._h, xs, ys, ts, ps, ctypes.byref(n),
                                  ctypes.byref(med), ctypes.byref(fk))
        if rc == FRAME:
            return FRAME, int(fk.value)
        if rc == EVENTS:
            return EVENTS, (xs, ys, ts, ps, int(n.value), med.value)
        return DONE, None


def python_schedule(ring, reader, frame_times, cap: int,
                    min_events: int = 64):
    """``SequenceScheduler``'s interleave as a Python generator, over any
    ring and reader (the pure-Python ones included): yields (FRAME, k),
    then the (EVENTS, (xs, ys, ts, ps, n, median_t)) packets of every event
    before t_{k+1}, at most ``cap`` each, the reader topping the ring up
    before each pop; an interval ends at a packet thinner than
    ``min_events`` (dropped) or shorter than ``cap``. ``ring`` None gives
    the frames alone."""
    for k in range(len(frame_times)):
        yield FRAME, k
        if ring is None or k + 1 >= len(frame_times):
            continue
        t_next = float(frame_times[k + 1])
        while True:
            if reader is not None:
                reader.pump(ring, 1 << 16)
            xs, ys, ts, ps, n, med = ring.pop_until(t_next, cap)
            if n < min_events:
                break
            yield EVENTS, (xs, ys, ts, ps, n, med)
            if n < cap:
                break
