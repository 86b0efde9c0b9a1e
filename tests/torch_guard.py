"""``no_host_reads``: a context manager under which every Python-level read
of a tensor back to the host raises (``bool``, ``float``, ``int``,
``__index__``, ``item``, ``tolist``, ``cpu``, ``numpy``), and so does making a
tensor from host data (``torch.tensor``, ``torch.as_tensor`` and
``Tensor.new_tensor`` of anything but a tensor, and assigning a host scalar
into a tensor, ``x[i] = 1.0``), which on a card is a host-to-device copy
that a captured CUDA graph cannot hold.

On the CPU this is the proof that a read-free function keeps its loop
conditions on the device: the same function on a card then runs without a
synchronisation and can be captured. Call the function once before the
guard, as the card's warm-up does, so that per-device constants are
uploaded.

``count_host_reads`` counts the same reads instead (``numpy`` aside: it
reads nothing that ``cpu`` has not): on the CPU, the number of
synchronising reads the code would make on a card."""
import contextlib

import torch


class HostRead(AssertionError):
    """A tensor was read back to the host, or made from host data, inside
    ``no_host_reads``."""


_READS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist",
          "cpu", "numpy")


def _raise(name):
    def f(*args, **kwargs):
        raise HostRead(f"host read inside a read-free function: {name}")
    return f


def _from_host(name, fn):
    def f(data, *args, **kwargs):
        if not torch.is_tensor(data):
            raise HostRead(f"tensor from host data inside a read-free "
                           f"function: {name}")
        return fn(data, *args, **kwargs)
    return f


def _setitem(fn):
    def f(self, index, value):
        if not torch.is_tensor(value):
            raise HostRead("a host scalar assigned into a tensor inside a "
                           "read-free function: Tensor.__setitem__ (on a "
                           "card a host-to-device copy; use fill_)")
        return fn(self, index, value)
    return f


def _new_tensor(fn):
    def f(self, data, *args, **kwargs):
        if not torch.is_tensor(data):
            raise HostRead("tensor from host data inside a read-free "
                           "function: Tensor.new_tensor")
        return fn(self, data, *args, **kwargs)
    return f


@contextlib.contextmanager
def no_host_reads():
    saved = [(torch.Tensor, n, getattr(torch.Tensor, n)) for n in _READS]
    saved += [(torch.Tensor, "__setitem__", torch.Tensor.__setitem__),
              (torch, "tensor", torch.tensor),
              (torch, "as_tensor", torch.as_tensor),
              (torch.Tensor, "new_tensor", torch.Tensor.new_tensor)]
    try:
        for n in _READS:
            setattr(torch.Tensor, n, _raise(f"Tensor.{n}"))
        torch.Tensor.__setitem__ = _setitem(saved[-4][2])
        torch.tensor = _from_host("torch.tensor", saved[-3][2])
        torch.as_tensor = _from_host("torch.as_tensor", saved[-2][2])
        torch.Tensor.new_tensor = _new_tensor(saved[-1][2])
        yield
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)


class Reads:
    """The host reads counted inside ``count_host_reads``, by method."""

    def __init__(self):
        self.by_method = {}

    @property
    def n(self):
        return sum(self.by_method.values())


def _counted(reads, name, fn):
    def f(*args, **kwargs):
        reads.by_method[name] = reads.by_method.get(name, 0) + 1
        return fn(*args, **kwargs)
    return f


@contextlib.contextmanager
def count_host_reads():
    reads = Reads()
    names = [n for n in _READS if n != "numpy"]
    saved = [(n, getattr(torch.Tensor, n)) for n in names]
    try:
        for n, fn in saved:
            setattr(torch.Tensor, n, _counted(reads, n, fn))
        yield reads
    finally:
        for n, fn in saved:
            setattr(torch.Tensor, n, fn)


@contextlib.contextmanager
def masked_branches():
    """``graphs.cond`` runs its body whatever the predicate: the read-free
    stand-in on the CPU for the IF node a captured program holds. The
    bodies select their results by the predicate themselves (the packet
    step's retries do), so the result is the host ``if``'s."""
    from slam_eds_tpu_torch import graphs
    orig = graphs.cond
    graphs.cond = lambda pred, body, carry: body(carry)
    try:
        yield
    finally:
        graphs.cond = orig


@contextlib.contextmanager
def skipped_passes():
    """``graphs.while_loop`` with a host ``if`` around every pass: a pass
    whose carry is done does not run, as in a captured loop. Yields a
    list that gets (passes run, passes) for every loop."""
    from slam_eds_tpu_torch import graphs
    orig = graphs.while_loop
    runs = []

    def loop(done_fn, body_fn, carry, n):
        ran = 0
        it = torch.zeros((), dtype=torch.int32,
                         device=done_fn(carry).device)
        for _ in range(n):
            if not bool(done_fn(carry)):
                carry = body_fn(it, carry)
                ran += 1
            it = it + 1
        runs.append((ran, n))
        return carry
    graphs.while_loop = loop
    try:
        yield runs
    finally:
        graphs.while_loop = orig
