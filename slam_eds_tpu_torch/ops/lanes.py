"""Reductions whose ``torch.vmap`` lanes are bitwise the same call on each
lane alone.

Under ``torch.vmap`` a product or a sum over a lane's points becomes one
batched kernel (``mv`` or ``mm`` into ``bmm``, a full sum into a sum over
an axis), which adds in another order than the unbatched kernel, so a
batched lane parts from its single solve at its first reduction and an LM
carries the difference along its weakly determined directions. Each
function here is its torch op outside any map (the single path runs the
same op as before); under a map it goes through one operator whose vmap
rule runs the op on each lane's own copy, so every lane gets the single
call's kernel and its bits (a launch a lane). Element-wise work, gathers
and the small solve (whose kernel solves each system as if alone) stay
batched: they give every lane its single bits already.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _fn(name):
    """The torch op a name stands for: ``matmul``, ``sum``,
    ``vector_norm`` or ``einsum:<equation>``."""
    if name.startswith("einsum:"):
        return functools.partial(torch.einsum, name[len("einsum:"):])
    return {"matmul": torch.matmul, "sum": torch.sum,
            "vector_norm": torch.linalg.vector_norm}[name]


@torch.library.custom_op("slam_eds_tpu_torch::lane_call", mutates_args=())
def _call_op(name: str, xs: list[torch.Tensor]) -> torch.Tensor:
    return _fn(name)(*xs)


@_call_op.register_fake
def _call_fake(name, xs):
    return _fn(name)(*xs)


def _lanes(x, dim, size):
    """The ``size`` lanes of ``x`` mapped at ``dim``, each a fresh copy (its
    storage aligned as the single call's), or ``x`` for every lane where it
    is not mapped."""
    if dim is None:
        return [x] * size
    return [x.select(dim, i).clone() for i in range(size)]


def _call_vmap(info, in_dims, name, xs):
    """Batch rule: the op on each lane alone (the operator again, so that
    an outer map does the same), the lanes' results stacked."""
    n = info.batch_size
    per = [_lanes(x, d, n) for x, d in zip(xs, in_dims[1])]
    return torch.stack([_call_op(name, list(t)) for t in zip(*per)]), 0


torch.library.register_vmap("slam_eds_tpu_torch::lane_call", _call_vmap)


def _call(name, *xs):
    if torch._C._are_functorch_transforms_active():
        return _call_op(name, list(xs))
    return _fn(name)(*xs)


def matmul(a, b):
    """``a @ b``, each ``torch.vmap`` lane bitwise the product alone."""
    return _call("matmul", a, b)


def total(x):
    """``torch.sum(x)``, each ``torch.vmap`` lane bitwise the sum alone."""
    return _call("sum", x)


def norm(x):
    """``torch.linalg.vector_norm(x)``, each lane bitwise the norm alone."""
    return _call("vector_norm", x)


def einsum(equation, a, b):
    """``torch.einsum(equation, a, b)``, each lane bitwise the call
    alone."""
    return _call("einsum:" + equation, a, b)
