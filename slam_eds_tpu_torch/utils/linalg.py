"""``solve``: the small dense solves of the port's LM and GN loops.

The JAX package solves these with ``jnp.linalg.solve`` (LU with partial
pivoting), batched by ``jax.vmap``. On a card a captured loop runs each
pass inside a conditional node of a CUDA graph (``graphs.while_loop``),
which holds no copy to the host, so ``torch.linalg.solve_ex`` cannot be
held there at every size (for a single system of 9 to 32 unknowns, the
event LM's 12x12, its solve reads its info on the host). The routes, by
device and size:

* CPU: ``torch.linalg.solve_ex``.
* 1 to 32 unknowns on the card (the event LM's 12, the coarse LM's 6 and 8,
  the BA gauge's 7), whatever the leading axes and however many
  ``torch.vmap`` levels the call is under: one launch of
  ``ops.kernels.lu_solve.small_solve`` (a warp per system, the factors in
  registers) for every system of the call, each solved as if alone, in the
  port's own fixed order, chosen equal to cuSOLVER's getrf and torch's
  substitution of one system on torch 2.11 + CUDA 12.8
  (``tools/lu_order_probe.py``): bitwise ``torch.linalg.solve_ex`` on each
  system alone at every n of 1..32 there (``chip_smoke.py``, phase
  "conditional"). The call goes through the kernel's operator
  (``solve_op``), whose ``torch.vmap`` rule gathers the lanes into that
  launch (about 3 us of host time a call more than the wrapper's direct
  call on an H100, ``chip_smoke.py`` phase "conditional").
* Above 32 unknowns (the window BA's reduced system):
  ``torch.linalg.lu_factor_ex`` and two triangular solves, torch's own
  route there.

A torch that rounds otherwise fails phase "conditional" by name but runs
the same kernel. Nothing is checked: a singular system gives non-finite
entries, as in JAX.
"""
from __future__ import annotations

import torch

from ..ops.kernels.lu_solve import MAX_N, solve_op


def solve(A, b):
    """x with A x = b, batched over leading axes: A [..., n, n], b [..., n]
    -> x [..., n]."""
    if A.device.type == "cpu":
        return torch.linalg.solve_ex(A, b[..., None],
                                     check_errors=False)[0][..., 0]
    n = A.shape[-1]
    if n <= MAX_N:
        return solve_op(A, b)
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    # P^T b: b's rows in the pivots' order (P from lu_unpack, A = P L U)
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]
    y = torch.linalg.solve_triangular(
        LU, b.gather(-1, P.argmax(-2))[..., None], upper=False,
        unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[..., 0]
