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
  run: the cache notes each kernel's launch slots during the capture (and
  takes them back off, the capture launched nothing) and adds them again on
  every replay. Outside a branch a slot is a launch on the card; inside one
  (see below) it is a launch that runs only where the branch is taken, so
  the counts are an upper bound of the launches run; ``launch_ledger()``
  gives both, the launches run from counts the IF nodes keep on the
  device. The warm-up's launches
  are real and counted too; ``GraphCache.warmups`` keeps their running
  total per kernel, for a caller that counts launches per step.
* ``sync_check(mode)`` runs every input copy and replay under
  ``torch.cuda.set_sync_debug_mode(mode)``: with ``"error"`` a hidden
  synchronisation inside a replayed step raises. (A warm-up is an eager
  run and may upload a per-device constant once.)

``CACHE`` is the process's cache, which the pipelines use. A capture or
replay failure raises; nothing falls back to the eager loop.
On the CPU nothing is captured: the callers run their functions eagerly
(``GraphCache.run`` needs CUDA tensors).

Branches on the device (``while_loop``, ``cond``): where JAX keeps a
``lax.while_loop``'s early exit or a ``lax.cond`` on the device, a captured
program holds an IF node of the CUDA graph (``csrc/graph_cond.cu``, built
with nvcc at first use): a one-thread kernel sets the node's condition from
a device ``bool``, and the node's body runs only where it held. The same
Python code runs everywhere:

* ``while_loop(cond_fn, body_fn, carry, n)`` runs ``n`` passes of a loop
  whose body masks itself (a pass where ``cond_fn`` is false returns its
  carry). Eagerly (the CPU, ``capture=False``, ``torch.vmap``) every pass
  runs, masked; while a graph is captured, every pass is an IF node on its
  condition, so the passes after the stop do no work on the device, as
  ``lax.while_loop`` runs none. The two forms give the same bits, because
  a pass after the stop is the identity on the carry.
* ``cond(pred, body_fn, carry)`` runs ``body_fn`` only where ``pred`` holds:
  eagerly a host ``if`` (one read of ``pred``), while capturing an IF node.

A body writes its results into the carry's buffers (one multi-tensor copy
kernel per type), which are allocated before its node (the carry is cloned when a loop or branch
starts), so a skipped body leaves them as they were; nothing a body
allocates is read after it. Its allocations come from a memory pool that
only bodies use. The launch counters count launch *slots* under a branch:
a captured kernel in a body counts on every replay whether the body ran or
not (``CapturedProgram.launches``). Each node's condition kernel also
counts, on the device, the times its body ran, and ``launch_ledger()``
turns these counts and the slots captured in each body into the launches
that ran (``torch.profiler``, which could count them too, faults on the
card over long runs of these graphs).
"""
from __future__ import annotations

import contextlib
import ctypes
import time

import torch
from torch.utils import _pytree as pytree

from .ops.kernels.build import build_library
from .ops.kernels.pattern_sample import pattern_sample, pattern_sample_lanes
from .ops.kernels.lu_solve import lu_substitute
from .ops.kernels.rasterize import rasterize_bilinear

_COND_LIB = None


def set_condition(parent, body, pred, taken):
    """Add an IF node on the bool ``pred`` to the graph ``parent`` (a
    stream) captures, after a launch of the condition kernel, which adds
    one to the int64 ``taken`` where ``pred`` holds, and start capturing
    ``body`` into the node's body (``csrc/graph_cond.cu``).
    ``set_condition.launches`` counts the condition kernel's launches."""
    lib = _cond_lib().lib
    _check_cond(lib, lib.graph_if_begin(parent.cuda_stream, body.cuda_stream,
                                        pred.data_ptr(), taken.data_ptr()),
                "the capture")
    set_condition.launches += 1


set_condition.launches = 0

# the launch counters a replay has to advance
COUNTED = (pattern_sample, pattern_sample_lanes, rasterize_bilinear,
           lu_substitute, set_condition)

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


# Launches run under IF nodes. Every IF node of the process has a number and,
# per device, a counter in ``_TAKEN`` that its condition kernel advances
# each time its body runs; ``_NODE_SLOTS`` keeps per node the launch slots
# captured in its body outside any nested node's. A replay adds to
# ``_REPLAYED`` all its program's slots (what it adds to the counters) and to
# ``_OUTSIDE`` those outside every node (which run on every replay).
MAX_NODES = 1 << 18
_TAKEN = {}
_NODE_SLOTS = {}
_NESTED = []
_REPLAYED = [0] * len(COUNTED)
_OUTSIDE = [0] * len(COUNTED)


def launch_ledger():
    """{kernel: (launch slots, launches run)} so far in the process, per
    kernel of ``COUNTED``: the slots are the counters; the launches run
    are the counters less the slots replays added, plus the launches that
    ran in replays (those outside every IF node, and each node's times its
    taken count). Reads the taken counts back (a synchronising copy).
    Compare two ledgers taken with no change of a counter by hand between
    them."""
    slots = _counts()
    runs = [c - r + o for c, r, o in zip(slots, _REPLAYED, _OUTSIDE)]
    for dev, nodes in _NODE_SLOTS.items():
        taken = _TAKEN[dev][:len(nodes)].tolist()
        for t, direct in zip(taken, nodes):
            if t:
                runs = [r + t * d for r, d in zip(runs, direct)]
    return {k.__name__: (s, r) for k, s, r in zip(COUNTED, slots, runs)}


def ledger_delta(before, after):
    """{kernel: {"slots": ..., "run": ...}} between two ``launch_ledger``s."""
    return {k: {"slots": after[k][0] - before[k][0],
                "run": after[k][1] - before[k][1]} for k in after}

# ---------------------------------------------------------------------------
# branches on the device
# ---------------------------------------------------------------------------

# per device: the body streams, one per nesting depth (a body is captured on
# a stream of its own, made by the library, and a stream keeps its cuBLAS
# workspace), and the memory pool of every body's allocations
_BODY_STREAMS = {}
_BODY_POOLS = {}
_OPEN_BODIES = []


def _cond_lib():
    global _COND_LIB
    if _COND_LIB is None:
        built = build_library("graph_cond", ["graph_cond.cu"])
        lib = built.lib
        lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 4
        lib.graph_if_begin.restype = ctypes.c_int
        lib.graph_if_end.argtypes = [ctypes.c_void_p]
        lib.graph_if_end.restype = ctypes.c_int
        lib.graph_stream_create.argtypes = [ctypes.c_void_p]
        lib.graph_stream_create.restype = ctypes.c_int
        lib.graph_cond_error_string.argtypes = [ctypes.c_int]
        lib.graph_cond_error_string.restype = ctypes.c_char_p
        _COND_LIB = built
    return _COND_LIB


def _check_cond(lib, rc, what):
    if rc != 0:
        step = f" at step {rc // 1000}" if rc >= 1000 else ""
        raise RuntimeError(
            f"{what} of a conditional graph node failed{step}, "
            f"{len(_OPEN_BODIES)} bodies deep: "
            f"{lib.graph_cond_error_string(rc % 1000).decode()} (torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}; IF nodes "
            "under stream capture need CUDA 12.4 or later)")


def prepare_branches(device):
    """Build the IF node's library and make the body memory pool of
    ``device``: done by ``CapturedProgram`` before it captures."""
    _cond_lib()
    dev = torch.device(device)
    if dev not in _BODY_POOLS:
        _BODY_POOLS[dev] = torch.cuda.MemPool()
        _BODY_STREAMS[dev] = []
        _TAKEN[dev] = torch.zeros(MAX_NODES, dtype=torch.int64, device=dev)
        _NODE_SLOTS[dev] = []


def _body_stream(dev, depth):
    streams = _BODY_STREAMS[dev]
    while len(streams) <= depth:
        lib = _cond_lib().lib
        ptr = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _check_cond(lib, lib.graph_stream_create(ctypes.byref(ptr)),
                        "the body stream")
        streams.append(torch.cuda.ExternalStream(ptr.value, device=dev))
    return streams[depth]


def capturing(x) -> bool:
    """Whether work on ``x``'s device is being captured into a graph now."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _if_body(pred):
    """Capture the block's work into an IF node on the device bool
    ``pred``."""
    lib = _cond_lib().lib
    dev = pred.device
    pred = pred.to(torch.bool).contiguous()
    body = _body_stream(dev, len(_OPEN_BODIES))
    nodes = _NODE_SLOTS[dev]
    if len(nodes) >= MAX_NODES:
        raise RuntimeError(f"more than {MAX_NODES} IF nodes in the process")
    node = len(nodes)
    nodes.append(None)
    set_condition(torch.cuda.current_stream(dev), body, pred,
                  _TAKEN[dev][node])
    pool = (torch.cuda.use_mem_pool(_BODY_POOLS[dev], dev)
            if not _OPEN_BODIES else contextlib.nullcontext())
    _OPEN_BODIES.append(body)
    before = _counts()
    _NESTED.append([0] * len(COUNTED))
    with pool, torch.cuda.stream(body):
        yield
    nested = _NESTED.pop()
    total = [a - b for a, b in zip(_counts(), before)]
    nodes[node] = [t - n for t, n in zip(total, nested)]
    if _NESTED:
        _NESTED[-1] = [a + t for a, t in zip(_NESTED[-1], total)]
    _OPEN_BODIES.pop()
    _check_cond(lib, lib.graph_if_end(body.cuda_stream), "the end")


def _write(dst, src):
    # one multi-tensor kernel per type, not a memcpy node per leaf: a
    # device-to-device copy in a body waits on the copy engine
    torch._foreach_copy_(pytree.tree_leaves(dst), pytree.tree_leaves(src))


def _buffers(carry):
    return pytree.tree_map(
        lambda x: x.clone(memory_format=torch.contiguous_format), carry)


def while_loop(cond_fn, body_fn, carry, n: int):
    """``n`` passes of ``carry = body_fn(i, carry)``, where a pass whose
    ``cond_fn(carry)`` (a bool scalar) is false must return its carry (the
    body masks itself, as a masked loop does). Eagerly every pass runs;
    while a graph is captured, each pass is an IF node on ``cond_fn``, one
    after the other in the loop's graph, so the passes after the first
    false condition do no work but their condition kernel, as
    ``lax.while_loop(cond, body, carry)`` with the cap ``n`` does no more
    passes. ``carry`` is a pytree of tensors of fixed shapes.

    (Nesting each pass's node in the pass before ends the loop at one
    skipped node and replays the frame track 5.5% faster on an H100,
    ``tools/cond_form_bench.py``; but ``torch.profiler`` faults at once
    replaying the 50-deep nest of the coarse LM, and the device idle share
    is read from it over a few frames, so the nodes are flat.)"""
    if n <= 0 or not capturing(pytree.tree_leaves(carry)[0]):
        for i in range(n):
            carry = body_fn(i, carry)
        return carry
    carry = _buffers(carry)
    for i in range(n):
        with _if_body(cond_fn(carry)):
            _write(carry, body_fn(i, carry))
    return carry


def cond(pred, body_fn, carry):
    """``body_fn(carry)`` where the bool scalar ``pred`` holds, else
    ``carry`` (``lax.cond(pred, body_fn, lambda c: c, carry)``): eagerly a
    host ``if``, while capturing an IF node."""
    if not capturing(pred):
        return body_fn(carry) if bool(pred) else carry
    carry = _buffers(carry)
    with _if_body(pred):
        _write(carry, body_fn(carry))
    return carry


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
        prepare_branches(self.static[0].device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        before = _counts()
        with torch.cuda.stream(side):
            fn(static_tree)
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_launches = [a - b for a, b in zip(_counts(), before)]
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        _NESTED.append([0] * len(COUNTED))
        # thread-local: another thread of the process (the runner's frame
        # decoders) may use the CUDA API while this one captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(static_tree)
        in_nodes = _NESTED.pop()
        after = _counts()
        self.launches = [a - b for a, b in zip(after, before)]
        self.outside = [a - n for a, n in zip(self.launches, in_nodes)]
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
        for i, (k, n) in enumerate(zip(COUNTED, self.launches)):
            k.launches += n
            _REPLAYED[i] += n
            _OUTSIDE[i] += self.outside[i]
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
