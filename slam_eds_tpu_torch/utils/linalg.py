"""``solve``: the small dense solves of the port's LM and GN loops.

The JAX package solves these with ``jnp.linalg.solve`` (LU with partial
pivoting). On a card a captured loop runs each pass inside a conditional
node of a CUDA graph (``graphs.while_loop``), which holds no copy to the
host, so ``torch.linalg.solve_ex`` cannot be held there at every size (for
a single system of 9 to 32 unknowns, the event LM's 12x12, its solve reads
its info on the host). The routes, by device, size and system count:

* CPU: ``torch.linalg.solve_ex``.
* One system of 1 to 32 unknowns (A [n, n]; the event LM's 12, the coarse
  LM's 6 and 8, the BA gauge's 7): ``ops.kernels.lu_solve.small_solve``,
  the whole solve in one launch (a warp, the factors in registers), in the
  port's own fixed order, chosen equal to cuSOLVER's getrf and torch's
  substitution on torch 2.11 + CUDA 12.8 (``tools/lu_order_probe.py``):
  bitwise ``torch.linalg.solve_ex`` at every n of 1..32 there
  (``chip_smoke.py``, phase "conditional").
* Several systems of up to 32 unknowns (a leading batch axis, or lanes
  under ``torch.vmap``): ``torch.linalg.lu_factor_ex`` (cuBLAS's batched
  getrf, which rounds otherwise) and the ``lu_substitute`` kernel, in the
  order torch's solve takes for that many systems; under ``torch.vmap``
  the kernel's operator (``lu_op``) substitutes every lane in one launch.
* Above 32 unknowns (the window BA's reduced system):
  ``torch.linalg.lu_factor_ex`` and two triangular solves, torch's own
  route there.

Each route is bitwise ``torch.linalg.solve_ex`` at the loops' sizes on an
H100 with torch 2.11 and CUDA 12.8; a torch that rounds otherwise fails
phase "conditional" by name but runs the same kernels. Nothing is checked:
a singular system gives non-finite entries, as in JAX.
"""
from __future__ import annotations

import torch

from ..ops.kernels.lu_solve import MAX_N, lu_op, lu_substitute, small_solve


def solve(A, b):
    """x with A x = b, batched over leading axes: A [..., n, n], b [..., n]
    -> x [..., n]."""
    if A.device.type == "cpu":
        return torch.linalg.solve_ex(A, b[..., None],
                                     check_errors=False)[0][..., 0]
    n = A.shape[-1]
    lanes = any(torch._C._functorch.is_batchedtensor(t) for t in (A, b))
    if n <= MAX_N and A.dim() == 2 and not lanes:
        return small_solve(A.contiguous(), b.contiguous())
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    if n <= MAX_N:
        return lu_op(LU, piv, b) if lanes else lu_substitute(LU, piv, b)
    # P^T b: b's rows in the pivots' order (P from lu_unpack, A = P L U)
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]
    y = torch.linalg.solve_triangular(
        LU, b.gather(-1, P.argmax(-2))[..., None], upper=False,
        unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[..., 0]
