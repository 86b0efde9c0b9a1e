"""The loops' small dense solves on the card: the ``small_solve`` kernel of
``csrc/lu_solve.cu`` (hand-written for ``sm_90a``, float32 or float64, 1 to
32 unknowns), the one route of ``utils.linalg.solve`` up to 32 unknowns:

* ``small_solve`` (A [..., n, n], b [..., n]): every system over the
  leading axes in one launch, a warp per system, factors and pivots kept in
  registers, each system solved as if alone. It factors in the order of
  cuSOLVER's getrf for one system (the order of
  ``torch.linalg.lu_factor_ex`` on one system, bit for bit at every n of
  1..32 on an H100 with torch 2.11 and CUDA 12.8,
  ``tools/lu_order_probe.py``) and substitutes in the order of torch's own
  solve of one system (``reciprocal_route(n)``), so each system is bitwise
  ``torch.linalg.solve_ex`` on that system alone there.
  ``small_solve_reference`` is its algorithm step by step in torch ops
  (each product rounded before it is subtracted, where the kernel fuses
  them: within kappa n eps of the kernel, kappa the condition number).
* ``solve_op``: ``small_solve`` as a PyTorch operator
  (``slam_eds_tpu_torch::small_solve``) whose ``torch.vmap`` rule sends
  every lane, at any depth of nested maps, to the same single launch.

``small_solve`` dispatches on the device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (every check, build or launch
failure raises; nothing falls back). ``small_solve.launches`` counts kernel
launches and ``SMALL_SOLVE_BY_N[n].launches`` those of n unknowns (a
counter made at the first launch at that n).
"""
from __future__ import annotations

import ctypes

import torch

from .build import LaunchCount, counted, load_library

MAX_N = 32


def reciprocal_route(n: int) -> bool:
    """Whether torch's solve of one system of ``n`` unknowns divides by the
    pivots through their reciprocal: cuBLAS's batched getrs, which torch
    2.11 on CUDA 12.8 takes for 9 to 32 unknowns (measured on an H100,
    ``chip_smoke.py`` phase "conditional"); below it its triangular solves
    divide. The rule is that torch version's, kept for bit parity with
    ``solve_ex`` on each system alone (``utils.linalg``)."""
    return 9 <= n <= 32


# {n: the small solve's launch counter at n}, in the order of first launch
SMALL_SOLVE_BY_N = {}


def small_lu_reference(A, b):
    """The small solve's factorization in torch ops, each system as if
    alone: A [..., n, n], b [..., n] -> ([L\\U | y] [..., n, n + 1], the
    1-based LAPACK pivots [..., n] int32). LU with partial pivoting on
    [A | b], right-looking: the pivot the largest |a_ik| over the rows i >=
    k (ties to the lowest row, a NaN the largest), rows k and p swapped
    whole, the column below scaled by the pivot's reciprocal (left as it is
    where the pivot is 0), the trailing rows and b updated, so the last
    column ends as the forward substitution's y."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], -1)
    lead = M.shape[:-2]
    pivots = []
    for k in range(n):
        p = k + M[..., k:, k].abs().argmax(-1)
        pivots.append(p + 1)
        idx = p[..., None, None].expand(*lead, 1, n + 1)
        row_p = M.gather(-2, idx)
        M.scatter_(-2, idx, M[..., k:k + 1, :].clone())
        M[..., k:k + 1, :] = row_p
        piv = M[..., k, k:k + 1]
        col = M[..., k + 1:, k]
        M[..., k + 1:, k] = torch.where(piv != 0, col * (1 / piv), col)
        M[..., k + 1:, k + 1:] -= M[..., k + 1:, k, None] * M[..., k, None,
                                                             k + 1:]
    return M, torch.stack(pivots, -1).to(torch.int32)


def small_solve_reference(A, b):
    """The small solve's algorithm in torch ops: A [..., n, n], b [..., n]
    -> x [..., n], each system as if alone: ``small_lu_reference``, then
    back substitution, by the reciprocal of each diagonal entry or by
    division as ``reciprocal_route(n)`` says."""
    n = A.shape[-1]
    M, _ = small_lu_reference(A, b)
    y = M[..., n].clone()
    recip = reciprocal_route(n)
    for j in reversed(range(n)):
        u = M[..., j, j]
        y[..., j] = y[..., j] * (1 / u) if recip else y[..., j] / u
        y[..., :j] -= M[..., :j, j] * y[..., j, None]
    return y


_SOLVE_ARGS = ([ctypes.c_void_p] * 3
               + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p])
_FUNCTIONS = {"small_solve_f32": _SOLVE_ARGS, "small_solve_f64": _SOLVE_ARGS}


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record."""
    return load_library("lu_solve", ["lu_solve.cu"], _FUNCTIONS)


def small_solve_cuda(A, b):
    """Launch the small solve, one warp per system over the leading axes;
    every check raises on what it does not take."""
    if not (A.is_cuda and b.is_cuda and A.device == b.device):
        raise ValueError("small_solve_cuda needs A and b on one CUDA device")
    if A.dtype != b.dtype or A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 required, got {A.dtype}, "
                        f"{b.dtype}")
    n = A.shape[-1]
    if (A.dim() < 2 or A.shape[-2] != n or b.shape != A.shape[:-1]
            or not 1 <= n <= MAX_N):
        raise ValueError(f"A must be [..., n, n] and b [..., n] with 1 <= n "
                         f"<= {MAX_N}; got {tuple(A.shape)}, "
                         f"{tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("small_solve_cuda needs contiguous A and b")
    x = torch.empty_like(b)
    lib = load().lib
    fn = lib.small_solve_f32 if A.dtype == torch.float32 \
        else lib.small_solve_f64
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), n, b.numel() // n,
                int(reciprocal_route(n)),
                torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        msg = lib.lu_solve_error_string(rc).decode()
        raise RuntimeError(f"small_solve kernel launch failed: {msg}")
    small_solve.launches += 1
    if n not in SMALL_SOLVE_BY_N:
        SMALL_SOLVE_BY_N[n] = LaunchCount(f"small_solve_n{n}")
    SMALL_SOLVE_BY_N[n].launches += 1
    return x


@counted
def small_solve(A, b):
    """Device dispatch: CPU tensors -> ``small_solve_reference``; CUDA
    tensors -> the kernel (raises on failure)."""
    if b.device.type == "cpu":
        return small_solve_reference(A, b)
    if b.device.type == "cuda":
        return small_solve_cuda(A, b)
    raise ValueError(f"small_solve: unsupported device {b.device}")



@torch.library.custom_op("slam_eds_tpu_torch::small_solve",
                         mutates_args=())
def solve_op(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``small_solve`` as an operator, for ``torch.vmap``."""
    return small_solve(A.contiguous(), b.contiguous())


@solve_op.register_fake
def _solve_fake(A, b):
    return torch.empty_like(b)


def _solve_vmap(info, in_dims, A, b):
    """Batch rule: the mapped axis to the front of A and b (an unmapped one
    expanded), then the operator again over the leading axes: one launch
    for every lane, or the next vmap level's rule where maps nest."""
    B = info.batch_size
    A, b = (x.movedim(d, 0) if d is not None else x.expand(B, *x.shape)
            for x, d in zip((A, b), in_dims))
    return solve_op(A.contiguous(), b.contiguous()), 0


torch.library.register_vmap("slam_eds_tpu_torch::small_solve", _solve_vmap)
