"""One captured program per step: the port's counterpart of ``jax.jit``.

The JAX package runs each hot step (the event packet step, the frame
track, the BA call) as one compiled program with its loops on the device.
Here the same read-free functions are captured once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed, so a step costs one launch of the
graph instead of the host launching every operation.

``GraphCache.run(key, fn, inputs)``:

* ``inputs`` is a pytree (tuples, NamedTuples, lists, dicts) of CUDA
  tensors and ``None``s (an absent option, part of the key);
  ``fn(inputs)`` returns a pytree of tensors. Everything else
  ``fn`` depends on (the camera, the config, the iteration caps, a mode) is
  in its closure and must be in ``key``; the cache adds the leaves' shapes
  and types, so one graph serves every call whose static arguments match,
  as ``jit``'s trace cache does.
* The first call of a key is its warm-up: ``fn`` runs eagerly on a side
  stream on the static input buffers (contiguous copies of its inputs), so
  that the kernels are built, the raster's occupancy query is made and the
  cuBLAS/cuSOLVER handles exist;
  the graph is captured right after it and replayed for the call's result.
  Every later call copies its inputs into the static buffers (device to
  device) and replays the graph. So every result comes from a replay: a
  replay and an eager run of the same function may round differently (the
  libraries may pick other algorithms under capture), and a run must not
  depend on which of its calls came first.
* A replay returns the graph's own output buffers, which the next replay
  of the same graph overwrites: a caller copies out what it keeps
  (``copy_out``).
* The kernel wrappers count launches in Python, which a replay does not
  run: the cache notes each kernel's launches during the capture (and takes
  them back off, the capture launched nothing) and adds them again on every
  replay, so the counts stay the number of launches on the card. The
  warm-up's launches are real and counted too; ``GraphCache.warmups``
  keeps their running total per kernel, for a caller that counts launches
  per step.
* ``sync_check(mode)`` runs every input copy and replay under
  ``torch.cuda.set_sync_debug_mode(mode)``: with ``"error"`` a hidden
  synchronisation inside a replayed step raises. (A warm-up is an eager
  run and may upload a per-device constant once.)

``CACHE`` is the process's cache, which the pipelines use. A capture or
replay failure raises; nothing falls back to the eager loop.
On the CPU nothing is captured: the callers run their functions eagerly
(``GraphCache.run`` needs CUDA tensors).
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.utils import _pytree as pytree

from .ops.kernels.pattern_sample import pattern_sample, pattern_sample_lanes
from .ops.kernels.rasterize import rasterize_bilinear

# the launch counters a replay has to advance
COUNTED = (pattern_sample, pattern_sample_lanes, rasterize_bilinear)

_SYNC_MODE = 0


@contextlib.contextmanager
def sync_check(mode="error"):
    """Run every graph input copy and replay under
    ``torch.cuda.set_sync_debug_mode(mode)`` while the context is open."""
    global _SYNC_MODE
    prev = _SYNC_MODE
    _SYNC_MODE = mode
    try:
        yield
    finally:
        _SYNC_MODE = prev


@contextlib.contextmanager
def _sync_mode():
    if not _SYNC_MODE:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_SYNC_MODE)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _counts():
    return [k.launches for k in COUNTED]


def _signature(leaves):
    """The leaves' part of a program's key: shape, type and device of each
    tensor, None for an absent option."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype, x.device)
                 for x in leaves)


class CapturedProgram:
    """``fn`` captured on static copies of one call's inputs."""

    def __init__(self, fn, inputs):
        leaves, self.spec = pytree.tree_flatten(inputs)
        for x in leaves:
            if not (x is None or (torch.is_tensor(x) and x.is_cuda)):
                raise TypeError("a captured program's inputs must be CUDA "
                                f"tensors or None, got {type(x).__name__}")
        # contiguous buffers, whatever the layout of this first call's
        # inputs: a product or a reduction may take another algorithm (and
        # round otherwise) on a transposed operand, and a replay must not
        # depend on which call captured the program
        full = [None if x is None
                else x.clone(memory_format=torch.contiguous_format)
                for x in leaves]
        self.static = [x for x in full if x is not None]
        static_tree = pytree.tree_unflatten(full, self.spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        before = _counts()
        with torch.cuda.stream(side):
            fn(static_tree)
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_launches = [a - b for a, b in zip(_counts(), before)]
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread-local: another thread of the process (the runner's frame
        # decoders) may use the CUDA API while this one captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(static_tree)
        after = _counts()
        self.launches = [a - b for a, b in zip(after, before)]
        for k, n in zip(COUNTED, before):
            k.launches = n
        self.replays = 0

    def __call__(self, inputs):
        leaves = [x for x in pytree.tree_leaves(inputs) if x is not None]
        if len(leaves) != len(self.static):
            raise ValueError("inputs do not match the captured program")
        with _sync_mode():
            torch._foreach_copy_(self.static, leaves)
            self.graph.replay()
        for k, n in zip(COUNTED, self.launches):
            k.launches += n
        self.replays += 1
        return self.outputs


class GraphCache:
    """Captured programs keyed by their static arguments and input shapes;
    a program's closure holds only what its key names. One thread replays
    them: a replay overwrites the outputs of that program's last one."""

    def __init__(self):
        self.programs = {}
        # warm-up launches per kernel of ``COUNTED``, over every capture,
        # and the host seconds the warm-ups and captures took
        self.warmups = {k.__name__: 0 for k in COUNTED}
        self.capture_s = 0.0

    def run(self, key, fn, inputs):
        leaves, spec = pytree.tree_flatten(inputs)
        full_key = (key, str(spec), _signature(leaves))
        prog = self.programs.get(full_key)
        if prog is None:
            t0 = time.perf_counter()
            prog = CapturedProgram(fn, inputs)
            self.capture_s += time.perf_counter() - t0
            self.programs[full_key] = prog
            for k, n in zip(COUNTED, prog.warmup_launches):
                self.warmups[k.__name__] += n
        return prog(inputs)

    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())


# the process's cache, which every pipeline uses, as jit's trace cache is
# the process's: a program is captured once per process (a capture with its
# warm-up takes about a second on the card), not once per pipeline
CACHE = GraphCache()


def copy_out(tree):
    """A copy of a program's outputs (``None`` leaves kept)."""
    return pytree.tree_map(lambda x: None if x is None else x.clone(), tree)
