"""One captured program per step: the port's counterpart of ``jax.jit``.

The JAX package runs each hot step (the event packet step, the frame
track, the BA call) as one compiled program with its loops on the device.
Here the same read-free functions are captured once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed, so a step costs one launch of the
graph instead of the host launching every operation.

``run(key, fn, inputs)`` runs every step of the pipelines and alone
chooses how: eagerly on CPU tensors, as the captured program of ``key``
(``CACHE``) on CUDA tensors, and inside ``eagerly()`` eagerly on the card
on the static buffers' layout (``contiguous``), for the checks that hold a
replay against its eager run.

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
* The kernel wrappers count launches in Python (``counters``: every
  counter the kernels made, ``ops/kernels/build.COUNTERS``), which a
  replay does not run: the cache notes each kernel's launch slots during
  the capture (and takes them back off, the capture launched nothing) and
  adds them again on every replay. Outside a branch a slot is a launch on
  the card; inside one (see below) it is a launch that runs only where the
  branch is taken or the loop's pass runs, so the counts are an upper
  bound of the launches run; ``launch_ledger()`` gives both, the launches
  run from counts the conditional nodes keep on the device. The warm-up's
  launches are real and counted too; ``GraphCache.warmups`` keeps their
  running total per kernel, for a caller that counts launches per step.
* ``sync_check(mode)`` runs every input copy and replay under
  ``torch.cuda.set_sync_debug_mode(mode)``: with ``"error"`` a hidden
  synchronisation inside a replayed step raises. (A warm-up is an eager
  run and may upload a per-device constant once.)
* While ``telemetry.TRACE`` is on, a call is the span ``replay.<program>``
  (``<program>`` its key's first element, ``program_name``), its first
  also ``capture.<program>`` around the warm-up and capture, and two CUDA
  events, one after the input copy and one after the replay, time the
  replay on the device.

``CACHE`` is the process's cache, which ``run`` uses. A capture or
replay failure raises; nothing falls back to the eager loop.

Branches and loops on the device (``while_loop``, ``cond``): where JAX
keeps a ``lax.while_loop`` or a ``lax.cond`` on the device, a captured
program holds a conditional node of the CUDA graph (``csrc/graph_cond.cu``,
built with nvcc at first use). The same Python code runs everywhere:

* ``while_loop(done_fn, body_fn, carry, n)`` runs at most ``n`` passes of a
  loop whose body masks itself (a pass whose carry is done returns it).
  Eagerly (the CPU, ``eagerly()``, ``torch.vmap``) every pass runs,
  masked; while a graph is captured, the loop is one WHILE node whose body
  is the pass, captured once and ended by the ``pass_tail`` kernel (it
  writes the carry back, advances the pass index and sets the node's
  condition from the carry's ``done`` flag and the cap), so the passes
  after the stop do not run, as ``lax.while_loop`` runs none. The two forms
  give the same bits, because a pass after the stop is the identity on the
  carry. The pass index is a device int32 scalar in both.
* ``cond(pred, body_fn, carry)`` runs ``body_fn`` only where ``pred`` holds:
  eagerly a host ``if`` (one read of ``pred``), while capturing an IF node.

A body's results go into the carry's buffers, which are allocated before
its node (the carry is cloned when a loop or branch starts), so a skipped
body leaves them as they were; nothing a body allocates is read after it.
Its allocations come from a memory pool that only bodies use. The launch
counters count launch *slots*: a captured kernel in an IF body counts one
on every replay whether the body ran or not, one in a WHILE body ``n``
(a slot per pass the cap allows) (``CapturedProgram.launches``). Each node
also counts on the device the times its body ran (the IF node's condition
kernel, the WHILE body's ``pass_tail``), and ``launch_ledger()`` turns
these counts and the slots captured in each body into the launches that
ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import time
import weakref

import torch
from torch.utils import _pytree as pytree

from .ops.kernels import build
from .ops.kernels.build import counted, load_library
from .telemetry import TRACE

IF, WHILE = 0, 1


@counted
def set_condition(parent, body, kind, pred, taken=None, counter=None):
    """Add a conditional node (``kind`` ``IF`` on the bool ``pred``,
    ``WHILE`` on ``~pred``) to the graph ``parent`` (a stream) captures,
    after a launch of the condition kernel, which for an IF node adds one
    to the int64 ``taken`` where ``pred`` holds and for a WHILE node sets
    the int32 pass ``counter`` to 0; start capturing ``body`` into the
    node's body (``csrc/graph_cond.cu``). Returns the node's handle.
    ``set_condition.launches`` counts the condition kernel's launches."""
    lib = _cond_lib().lib
    handle = ctypes.c_ulonglong()
    _check_cond(lib, lib.graph_node_begin(
        parent.cuda_stream, body.cuda_stream, kind, pred.data_ptr(),
        int(kind == WHILE), None if taken is None else taken.data_ptr(),
        None if counter is None else counter.data_ptr(),
        ctypes.byref(handle)), "the capture")
    set_condition.launches += 1
    return handle.value


@counted
def pass_tail(stream, handle, records, n_leaves, counter, cap, done, taken,
              nbytes):
    """Launch the last kernel of a WHILE body on ``stream``: the carry
    written back from the device array ``records`` of ``n_leaves`` (dst,
    src, bytes) int64 triples (``nbytes`` the largest), the pass
    ``counter`` advanced, the handle set to ``~done & (counter < cap)``,
    ``taken`` advanced (``csrc/graph_cond.cu``). ``pass_tail.launches``
    counts its launches."""
    lib = _cond_lib().lib
    blocks = max(1, min(64, -(-nbytes // (16 * 256))))
    _check_cond(lib, lib.graph_pass_tail(
        stream.cuda_stream, handle, records.data_ptr(), n_leaves,
        counter.data_ptr(), cap, done.data_ptr(), taken.data_ptr(), blocks),
        "the pass tail")
    pass_tail.launches += 1


_SYNC_MODE = 0
_EAGER = False


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
def eagerly():
    """Run every step ``run`` is given eagerly, also on the card, while the
    context is open: the checks that hold a captured program against its
    eager run."""
    global _EAGER
    prev = _EAGER
    _EAGER = True
    try:
        yield
    finally:
        _EAGER = prev


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


def counters():
    """The launch counters a replay has to advance: every counter the
    kernels have made (``build.COUNTERS``: the entry points as their
    modules are imported, the small solve's per number of unknowns at its
    first launch at that size). The tuple only grows at its end, so a list
    of counts taken earlier is a prefix, its missing counts 0 (``_sub``,
    ``_add``)."""
    return tuple(build.COUNTERS)


def _counts():
    return [k.launches for k in counters()]


def _sub(a, b):
    return [x - y for x, y in itertools.zip_longest(a, b, fillvalue=0)]


def _add(a, b, times=1):
    return [x + times * y
            for x, y in itertools.zip_longest(a, b, fillvalue=0)]


# Launches run under conditional nodes. Every node of the process has a
# number and, per device, a counter in ``_TAKEN`` that advances each time
# its body runs (an IF node's condition kernel, a WHILE body's pass tail);
# ``_NODE_SLOTS`` keeps per node the launch slots captured in one run of its
# body outside any nested node's. A replay adds to ``_REPLAYED`` all its
# program's slots (what it adds to the counters) and to ``_OUTSIDE`` those
# outside every node (which run on every replay).
# Node numbers are not reused: the ledger keeps the launches that ran under
# the nodes of programs that are gone, so ``MAX_NODES`` bounds the nodes
# captured over the process's life.
MAX_NODES = 1 << 18
_TAKEN = {}
_NODE_SLOTS = {}
# The pass tails' (dst, src, bytes) records, per device one int64 array
# made outside any capture, with its free rows as (start, count) runs. A
# record array made during a capture would take a block the graph's own
# kernels write on every replay (a temporary freed before it was made), and
# the records written once after the capture would not survive the first
# replay. A program gives its rows back when it is collected, so
# ``MAX_RECORDS`` bounds the carry leaves of the loops alive at once.
MAX_RECORDS = 1 << 18
_RECORDS = {}
_RECORD_FREE = {}
_NESTED = []
_REPLAYED = []
_OUTSIDE = []


def launch_ledger():
    """{kernel: (launch slots, launches run)} so far in the process, per
    counter (``counters``): the slots are the counters; the launches run
    are the counters less the slots replays added, plus the launches that
    ran in replays (those outside every node, and each node's body slots
    times its taken count). Reads the taken counts back (a synchronising
    copy). Compare two ledgers taken with no change of a counter by hand
    between them."""
    slots = _counts()
    runs = _add(_sub(slots, _REPLAYED), _OUTSIDE)
    for dev, nodes in _NODE_SLOTS.items():
        taken = _TAKEN[dev][:len(nodes)].tolist()
        for t, direct in zip(taken, nodes):
            if t:
                runs = _add(runs, direct, t)
    return {k.__name__: (s, r) for k, s, r in zip(counters(), slots, runs)}


def ledger_delta(before, after):
    """{kernel: {"slots": ..., "run": ...}} between two ``launch_ledger``s
    (a counter made between them starts from 0)."""
    return {k: {"slots": s - before.get(k, (0, 0))[0],
                "run": r - before.get(k, (0, 0))[1]}
            for k, (s, r) in after.items()}

# ---------------------------------------------------------------------------
# branches and loops on the device
# ---------------------------------------------------------------------------

# per device: the body streams, one per nesting depth (a body is captured on
# a stream of its own, made by the library, and a stream keeps its cuBLAS
# workspace), and the memory pool of every body's allocations
_BODY_STREAMS = {}
_BODY_POOLS = {}
_OPEN_BODIES = []
# the capture in progress: its conditional nodes by kind, the nodes of its
# bodies' graphs, and the pass tails' rows of ``_RECORDS`` with the records
# to write into them once the capture has ended
_CAPTURE = {}


_COND_FUNCTIONS = {
    "graph_node_begin": ([ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 3),
    "graph_pass_tail": [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    "graph_capture_nodes": [ctypes.c_void_p] * 2,
    "graph_node_end": [ctypes.c_void_p],
    "graph_stream_create": [ctypes.c_void_p]}


def _cond_lib():
    return load_library("graph_cond", ["graph_cond.cu"], _COND_FUNCTIONS)


def _driver_version():
    v = ctypes.c_int()
    try:
        ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(v))
    except OSError:
        return "unknown"
    return f"{v.value // 1000}.{v.value % 1000 // 10}"


def _check_cond(lib, rc, what):
    if rc != 0:
        step = f" at step {rc // 1000}" if rc >= 1000 else ""
        raise RuntimeError(
            f"{what} of a conditional graph node failed{step}, "
            f"{len(_OPEN_BODIES)} bodies deep: "
            f"{lib.graph_cond_error_string(rc % 1000).decode()} (torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}, driver "
            f"{_driver_version()}; IF and WHILE nodes under stream capture "
            "need CUDA 12.4 or later)")


def prepare_branches(device):
    """Build the nodes' library and make the body memory pool of
    ``device``: done by ``CapturedProgram`` before it captures."""
    _cond_lib()
    dev = torch.device(device)
    if dev not in _BODY_POOLS:
        _BODY_POOLS[dev] = torch.cuda.MemPool()
        _BODY_STREAMS[dev] = []
        _TAKEN[dev] = torch.zeros(MAX_NODES, dtype=torch.int64, device=dev)
        _NODE_SLOTS[dev] = []
        _RECORDS[dev] = torch.zeros((MAX_RECORDS, 3), dtype=torch.int64,
                                    device=dev)
        _RECORD_FREE[dev] = [(0, MAX_RECORDS)]


def _take_rows(dev, n):
    """The first run of ``n`` free rows of ``_RECORDS[dev]``: its start."""
    free = _RECORD_FREE[dev]
    for i, (start, count) in enumerate(free):
        if count >= n:
            free[i] = (start + n, count - n)
            return start
    raise RuntimeError(f"more than {MAX_RECORDS} carry leaves in the loops "
                       "of the process's live programs")


def _give_rows(taken):
    """Return the rows ``taken`` ((device, start, count) runs) to their
    device's free runs, merging neighbours."""
    for dev in {d for d, _, _ in taken}:
        runs = sorted(_RECORD_FREE[dev]
                      + [(s, n) for d, s, n in taken if d == dev])
        merged = []
        for start, count in runs:
            if merged and merged[-1][0] + merged[-1][1] == start:
                merged[-1] = (merged[-1][0], merged[-1][1] + count)
            elif count:
                merged.append((start, count))
        _RECORD_FREE[dev] = merged


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


def capture_nodes(stream):
    """The nodes of the graph ``stream`` captures now, at its own level;
    None where the driver does not say (a count for the record only)."""
    n = ctypes.c_ulonglong()
    rc = _cond_lib().lib.graph_capture_nodes(stream.cuda_stream,
                                             ctypes.byref(n))
    return n.value if rc == 0 else None


def capturing(x) -> bool:
    """Whether work on ``x``'s device is being captured into a graph now."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


class _Node:
    def __init__(self, kind, dev, number, handle, body, passes):
        self.kind, self.dev, self.number = kind, dev, number
        self.handle, self.body, self.passes = handle, body, passes

    @property
    def taken(self):
        return _TAKEN[self.dev][self.number]


@contextlib.contextmanager
def _node_body(kind, pred, counter=None, passes=1):
    """Capture the block's work into the body of a conditional node: an IF
    node on the device bool ``pred``, or a WHILE node of at most ``passes``
    passes that starts where ``pred`` (its ``done`` flag) is false and sets
    ``counter`` to 0 first. The launch slots captured in the body count
    ``passes`` times."""
    lib = _cond_lib().lib
    dev = pred.device
    pred = pred.to(torch.bool).contiguous()
    body = _body_stream(dev, len(_OPEN_BODIES))
    nodes = _NODE_SLOTS[dev]
    if len(nodes) >= MAX_NODES:
        raise RuntimeError(f"more than {MAX_NODES} conditional nodes in the "
                           "process")
    number = len(nodes)
    nodes.append(None)
    handle = set_condition(torch.cuda.current_stream(dev), body, kind, pred,
                           taken=_TAKEN[dev][number] if kind == IF else None,
                           counter=counter)
    if _CAPTURE:
        _CAPTURE["nodes"][kind] += 1
    pool = (torch.cuda.use_mem_pool(_BODY_POOLS[dev], dev)
            if not _OPEN_BODIES else contextlib.nullcontext())
    _OPEN_BODIES.append(body)
    before = _counts()
    _NESTED.append([])
    with pool, torch.cuda.stream(body):
        yield _Node(kind, dev, number, handle, body, passes)
    nested = _NESTED.pop()
    total = _sub(_counts(), before)
    nodes[number] = _sub(total, nested)
    for k, t in zip(counters(), total):
        k.launches += (passes - 1) * t
    if _NESTED:
        _NESTED[-1] = _add(_NESTED[-1], total, passes)
    _OPEN_BODIES.pop()
    if _CAPTURE:
        _CAPTURE["body_graph_nodes"].append(capture_nodes(body))
    _check_cond(lib, lib.graph_node_end(body.cuda_stream), "the end")


def _write(dst, src):
    # one multi-tensor kernel per type, not a memcpy node per leaf: a
    # device-to-device copy in a body waits on the copy engine
    torch._foreach_copy_(pytree.tree_leaves(dst), pytree.tree_leaves(src))


def _buffer(x):
    """A copy of the tensor ``x`` in the layout of a captured program's
    buffers, whatever ``x``'s: contiguous. A product or a reduction may take
    another algorithm (and round otherwise) on a transposed operand, so a
    replay must not depend on the layout of the call that captured it, and
    an eager run that is to compute what the replay does runs on this
    layout too (``contiguous``)."""
    return x.clone(memory_format=torch.contiguous_format)


def _buffers(carry):
    return pytree.tree_map(_buffer, carry)


def _overlaps(a, others):
    lo = a.data_ptr()
    hi = lo + a.numel() * a.element_size()
    return any(o is not a and o.data_ptr() < hi
               and lo < o.data_ptr() + o.numel() * o.element_size()
               for o in others)


def _end_pass(node, dst, src, counter, cap, done):
    """The WHILE body's last kernel: ``src`` (the pass's carry leaves) into
    ``dst`` (the carry's buffers, made before the node), the pass index
    advanced and the next pass's condition set from ``done`` (the leaf of
    ``src`` that is the carry's flag). Each leaf is checked here: of its
    buffer's type and shape, contiguous, its bytes apart from every other
    buffer (else it is copied first, which costs a kernel in the pass)."""
    if not _CAPTURE:
        raise RuntimeError("a while_loop is captured only inside a "
                           "graphs.CapturedProgram")
    recs = []
    for d, s in zip(dst, src):
        if s.dtype != d.dtype or s.shape != d.shape or s.device != d.device:
            raise ValueError(
                f"while_loop: a pass returned a {s.dtype} leaf of shape "
                f"{tuple(s.shape)} on {s.device} for a {d.dtype} carry leaf "
                f"of shape {tuple(d.shape)} on {d.device}")
        if not s.is_contiguous() or _overlaps(s, dst):
            s = s.clone(memory_format=torch.contiguous_format)
        recs.append((s, d))
    start = _take_rows(node.dev, len(recs))
    _CAPTURE["rows"].append((node.dev, start, len(recs)))
    records = _RECORDS[node.dev][start:start + len(recs)]
    rows = [[d.data_ptr(), s.data_ptr(), d.numel() * d.element_size()]
            for s, d in recs]
    # written once the capture has ended (a copy from the host cannot be
    # captured)
    _CAPTURE["records"].append((records, rows))
    pass_tail(node.body, node.handle, records, len(rows), counter, cap,
              recs[done][0], node.taken, max(r[2] for r in rows))


def while_loop(done_fn, body_fn, carry, n: int):
    """At most ``n`` passes of ``carry = body_fn(it, carry)`` while
    ``done_fn(carry)`` (a bool scalar leaf of the carry) is false, ``it``
    the pass index (an int32 scalar on the carry's device). A pass whose
    carry is done must return its carry (the body masks itself, as a
    masked loop does). Eagerly every pass runs; while a graph is captured
    the loop is one WHILE node whose body, the pass, is captured once and
    ends in the ``pass_tail`` kernel, so no pass runs after the first done
    carry, as ``lax.while_loop`` with the cap ``n`` runs none. ``carry`` is
    a pytree of tensors of fixed shapes and types, which every pass
    returns."""
    leaves = pytree.tree_leaves(carry)
    if n <= 0 or not capturing(leaves[0]):
        it = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        for _ in range(n):
            carry = body_fn(it, carry)
            it = it + 1
        return carry
    carry = _buffers(carry)
    dst = pytree.tree_leaves(carry)
    done = done_fn(carry)
    j = next((i for i, x in enumerate(dst) if x is done), None)
    if j is None or done.dtype != torch.bool or done.numel() != 1:
        raise ValueError("while_loop: done_fn must return the carry's bool "
                         "scalar leaf")
    it = torch.empty((), dtype=torch.int32, device=done.device)
    with _node_body(WHILE, done, counter=it, passes=n) as node:
        src = pytree.tree_leaves(body_fn(it, carry))
        if len(src) != len(dst):
            raise ValueError("while_loop: a pass returned another carry")
        _end_pass(node, dst, src, it, n, j)
    return carry


def cond(pred, body_fn, carry):
    """``body_fn(carry)`` where the bool scalar ``pred`` holds, else
    ``carry`` (``lax.cond(pred, body_fn, lambda c: c, carry)``): eagerly a
    host ``if``, while capturing an IF node."""
    if not capturing(pred):
        return body_fn(carry) if bool(pred) else carry
    carry = _buffers(carry)
    with _node_body(IF, pred):
        _write(carry, body_fn(carry))
    return carry


def _signature(leaves):
    """The leaves' part of a program's key: shape, type and device of each
    tensor, None for an absent option."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype, x.device)
                 for x in leaves)


class CapturedProgram:
    """``fn`` captured on static copies (``_buffer``) of one call's inputs,
    given flat: ``leaves`` of the tree ``spec``."""

    def __init__(self, fn, leaves, spec):
        for x in leaves:
            if not (x is None or (torch.is_tensor(x) and x.is_cuda)):
                raise TypeError("a captured program's inputs must be CUDA "
                                f"tensors or None, got {type(x).__name__}")
        full = [None if x is None else _buffer(x) for x in leaves]
        self.static = [x for x in full if x is not None]
        static_tree = pytree.tree_unflatten(full, spec)
        prepare_branches(self.static[0].device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        before = _counts()
        with torch.cuda.stream(side):
            fn(static_tree)
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_launches = _sub(_counts(), before)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        _NESTED.append([])
        _CAPTURE.update(nodes={IF: 0, WHILE: 0}, body_graph_nodes=[],
                        records=[], rows=[])
        try:
            # thread-local: another thread of the process (the runner's
            # frame decoders) may use the CUDA API while this one captures
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(static_tree)
                top = capture_nodes(torch.cuda.current_stream())
            capture = dict(_CAPTURE)
        except BaseException:
            _give_rows(_CAPTURE["rows"])
            raise
        finally:
            _CAPTURE.clear()
        # the pass tails' rows go back when the program (its graph) goes
        weakref.finalize(self, _give_rows, capture["rows"])
        # the pass tails' records, now that the pass outputs have their
        # addresses
        self.records = [r for r, _ in capture["records"]]
        for r, rows in capture["records"]:
            r.copy_(torch.tensor(rows, dtype=torch.int64))
        # the graph's nodes: its own level and every body's graph
        counted = [top, *capture["body_graph_nodes"]]
        self.nodes = {"graph": None if None in counted else sum(counted),
                      "if": capture["nodes"][IF],
                      "while": capture["nodes"][WHILE]}
        in_nodes = _NESTED.pop()
        self.launches = _sub(_counts(), before)
        self.outside = _sub(self.launches, in_nodes)
        for k, n in itertools.zip_longest(counters(), before, fillvalue=0):
            k.launches = n
        self.replays = 0

    def __call__(self, leaves):
        """Replay on the inputs' ``leaves`` (flat, ``None``s kept), copied
        into the static buffers."""
        leaves = [x for x in leaves if x is not None]
        if len(leaves) != len(self.static):
            raise ValueError("inputs do not match the captured program")
        timed = TRACE.on
        with _sync_mode():
            torch._foreach_copy_(self.static, leaves)
            if timed:
                stream = torch.cuda.current_stream()
                start = TRACE.device_event(stream)
            self.graph.replay()
            if timed:
                TRACE.time_replay(start, TRACE.device_event(stream))
        for k, n in zip(counters(), self.launches):
            k.launches += n
        _REPLAYED[:] = _add(_REPLAYED, self.launches)
        _OUTSIDE[:] = _add(_OUTSIDE, self.outside)
        self.replays += 1
        return self.outputs


class GraphCache:
    """Captured programs keyed by their static arguments and input shapes;
    a program's closure holds only what its key names. One thread replays
    them: a replay overwrites the outputs of that program's last one."""

    def __init__(self):
        self.programs = {}
        # warm-up launches per counter (``counters``), over every capture,
        # and the host seconds the warm-ups and captures took
        self._warmups = []
        self.capture_s = 0.0

    @property
    def warmups(self):
        """{kernel: its launches in every warm-up so far}, for every
        counter (``counters``)."""
        return {k.__name__: n for k, n in itertools.zip_longest(
            counters(), self._warmups, fillvalue=0)}

    def run(self, key, fn, inputs, flat=None):
        """``fn(inputs)`` as the captured program of ``key`` (captured at
        the key's first call); ``flat`` is ``pytree.tree_flatten(inputs)``
        where the caller has it."""
        leaves, spec = flat or pytree.tree_flatten(inputs)
        # the spec's string: a faster key than the spec itself (its hash and
        # equality walk the tree in Python)
        full_key = (key, str(spec), _signature(leaves))
        prog = self.programs.get(full_key)
        if prog is None:
            name = program_name(key)
            t0 = time.perf_counter()
            with TRACE.span(f"capture.{name}"):
                prog = CapturedProgram(fn, leaves, spec)
            prog.capture_s = time.perf_counter() - t0
            prog.span = f"replay.{name}"
            self.capture_s += prog.capture_s
            self.programs[full_key] = prog
            self._warmups = _add(self._warmups, prog.warmup_launches)
        with TRACE.span(prog.span):
            return prog(leaves)

    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())

    def table(self):
        """Per program name (its key's first element): how many programs,
        the most graph nodes of one (its own level and every body's), WHILE
        and IF nodes of one, the seconds their warm-ups and captures took,
        and their replays."""
        out = {}
        for key, p in self.programs.items():
            row = out.setdefault(program_name(key[0]), {
                "programs": 0, "graph_nodes": 0, "while_nodes": 0,
                "if_nodes": 0, "capture_s": 0.0, "replays": 0})
            row["programs"] += 1
            row["graph_nodes"] = max(row["graph_nodes"],
                                     p.nodes["graph"] or 0)
            row["while_nodes"] = max(row["while_nodes"], p.nodes["while"])
            row["if_nodes"] = max(row["if_nodes"], p.nodes["if"])
            row["capture_s"] += p.capture_s
            row["replays"] += p.replays
        return out


def program_name(key) -> str:
    """A program's name: its key's first element."""
    return str(key[0] if isinstance(key, tuple) else key)


# the process's cache, which ``run`` uses, as jit's trace cache is the
# process's: a program is captured once per process (a capture with its
# warm-up takes about a second on the card), not once per pipeline
CACHE = GraphCache()


def run(key, fn, inputs):
    """``fn(inputs)``, a step of the pipelines: eagerly where the inputs'
    first tensor is on the CPU; on the card the captured program of ``key``
    (``CACHE``), whose outputs the next replay overwrites (``copy_out``
    what is kept); inside ``eagerly()`` eagerly on the card too, on the
    static buffers' layout (``contiguous``). ``fn``'s closure holds only
    what ``key`` names."""
    flat = pytree.tree_flatten(inputs)
    first = next(x for x in flat[0] if torch.is_tensor(x))
    if not first.is_cuda:
        return fn(inputs)
    if _EAGER:
        return fn(contiguous(inputs))
    return CACHE.run(key, fn, inputs, flat)


def copy_out(tree):
    """A copy of a program's outputs (``None`` leaves kept)."""
    return pytree.tree_map(lambda x: None if x is None else x.clone(), tree)


def contiguous(tree):
    """``tree`` with every tensor copied into the layout a captured
    program's static buffers have (``_buffer``): a function run eagerly on
    it computes what its captured program does."""
    return pytree.tree_map(
        lambda x: _buffer(x) if torch.is_tensor(x) else x, tree)
