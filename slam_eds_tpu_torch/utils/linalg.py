"""``solve``: the small dense solves of the port's LM and GN loops.

The JAX package solves these with ``jnp.linalg.solve`` (LU with partial
pivoting). On the CPU the port calls ``torch.linalg.solve_ex``. On a card a
captured loop runs each pass inside a conditional node of a CUDA graph
(``graphs.while_loop``), where ``torch.linalg.solve_ex`` cannot be held at
every size (for a single system of 9 to 32 unknowns, the event LM's 12x12,
its solve copies to the host). So on a card the solve factors with
``torch.linalg.lu_factor_ex`` (which a body holds) and substitutes with the
``lu_solve`` kernel up to 32 unknowns, in the order torch's solve takes,
or with two triangular solves above (the window BA's reduced system, where
torch takes that route itself): bitwise ``torch.linalg.solve_ex`` at the
loops' sizes on an H100 (``chip_smoke.py``, phase "conditional"). Under
``torch.vmap`` the kernel's operator substitutes all lanes at once. Nothing
is checked: a singular system gives non-finite entries, as in JAX.

The kernel and its two routes exist for bit parity with the loops as they
ran before they could skip a pass, and so with every earlier result of the
port: one route of torch's own (``lu_factor_ex`` and two triangular
solves) can be captured too, but rounds the event LM's 12x12 differently,
which moves the event cell's end state. The routes copy torch 2.11's
dispatch to cuBLAS on CUDA 12.8 (``lu_solve.reciprocal_route``); a torch
whose dispatch differs fails phase "conditional" by name.
"""
from __future__ import annotations

import torch

from ..ops.kernels.lu_solve import MAX_N, lu_op, lu_substitute


def solve(A, b):
    """x with A x = b, batched over leading axes: A [..., n, n], b [..., n]
    -> x [..., n]."""
    if A.device.type == "cpu":
        return torch.linalg.solve_ex(A, b[..., None],
                                     check_errors=False)[0][..., 0]
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    if A.shape[-1] <= MAX_N:
        if any(torch._C._functorch.is_batchedtensor(t) for t in (LU, b)):
            return lu_op(LU, piv, b)
        return lu_substitute(LU, piv, b)
    # P^T b: b's rows in the pivots' order (P from lu_unpack, A = P L U)
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]
    y = torch.linalg.solve_triangular(
        LU, b.gather(-1, P.argmax(-2))[..., None], upper=False,
        unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[..., 0]
