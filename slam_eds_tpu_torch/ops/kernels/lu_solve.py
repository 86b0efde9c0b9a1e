"""The loops' small dense solves on the card: two kernels of
``csrc/lu_solve.cu`` (hand-written for ``sm_90a``, float32 or float64, up
to 32 unknowns). Which route each size and system count takes is
``utils.linalg.solve``'s:

* ``small_solve``, one system (A [n, n], b [n]): the whole solve in one
  launch, a warp per system, factors and pivots kept in registers. It
  factors in the order of cuSOLVER's getrf for one system (the order of
  ``torch.linalg.lu_factor_ex`` on one system, bit for bit at every n of
  1..32 on an H100 with torch 2.11 and CUDA 12.8,
  ``tools/lu_order_probe.py``) and substitutes in the order of torch's own
  solve (``reciprocal_route(n, 1)``), so it is bitwise
  ``torch.linalg.solve_ex`` there. Leading axes are taken too, each system
  solved as if alone (a test over many systems; the path gives one).
  ``small_solve_reference`` is its algorithm step by step in torch ops
  (each product rounded before it is subtracted, where the kernel fuses
  them: within kappa n eps of the kernel, kappa the condition number).
* ``lu_substitute``, several systems (vmapped lanes, through ``lu_op``, or
  a leading batch axis): the substitution half after torch's factorization
  (``torch.linalg.lu_factor_ex``, cuBLAS's batched getrf for several
  systems), one thread per system, in the order of torch's own solve for
  that many systems. ``lu_substitute_reference`` is its plain version,
  ``torch.linalg.lu_solve``.

Each wrapper dispatches on the device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (every check, build or launch
failure raises; nothing falls back). ``small_solve.launches`` and
``lu_substitute.launches`` count kernel launches, and
``SMALL_SOLVE_BY_N[n].launches`` the small solves of n unknowns (a counter
made at the first launch at that n). ``lu_op``
is ``lu_substitute`` as an operator whose ``torch.vmap`` rule substitutes
every lane in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from .build import build_library

_LIB = None
MAX_N = 32


def reciprocal_route(n: int, systems: int) -> bool:
    """Whether torch's solve divides by the pivots through their reciprocal
    for ``systems`` systems of ``n`` unknowns: cuBLAS's batched getrs, which
    torch 2.11 on CUDA 12.8 takes for 9 to 32 unknowns and at most 2
    systems (measured on an H100, ``chip_smoke.py`` phase "conditional");
    elsewhere its triangular solves divide. The rule is that torch
    version's, kept for bit parity with ``solve_ex`` (``utils.linalg``)."""
    return 9 <= n <= 32 and systems <= 2


class LaunchCount:
    """A launch counter of one size of a kernel, kept beside the kernel's
    own and counted by ``graphs.launch_ledger`` as a kernel is."""

    def __init__(self, name):
        self.__name__ = name
        self.launches = 0


# {n: the small solve's launch counter at n}, in the order of first launch
SMALL_SOLVE_BY_N = {}


def lu_substitute_reference(LU, piv, b):
    """Plain torch version: LU [..., n, n], piv [..., n] int32 (1-based),
    b [..., n] -> x [..., n]."""
    return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]


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
    division as ``reciprocal_route(n, 1)`` says."""
    n = A.shape[-1]
    M, _ = small_lu_reference(A, b)
    y = M[..., n].clone()
    recip = reciprocal_route(n, 1)
    for j in reversed(range(n)):
        u = M[..., j, j]
        y[..., j] = y[..., j] * (1 / u) if recip else y[..., j] / u
        y[..., :j] -= M[..., :j, j] * y[..., j, None]
    return y


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record."""
    global _LIB
    if _LIB is None:
        built = build_library("lu_solve", ["lu_solve.cu"])
        for name in ("lu_solve_f32", "lu_solve_f64"):
            fn = getattr(built.lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4
                           + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for name in ("small_solve_f32", "small_solve_f64"):
            fn = getattr(built.lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        built.lib.lu_solve_error_string.argtypes = [ctypes.c_int]
        built.lib.lu_solve_error_string.restype = ctypes.c_char_p
        _LIB = built
    return _LIB


def lu_substitute_cuda(LU, piv, b):
    """Launch the kernel over the leading axes; every check raises on what
    it does not take."""
    if not (LU.is_cuda and piv.is_cuda and b.is_cuda
            and LU.device == piv.device == b.device):
        raise ValueError("lu_substitute_cuda needs LU, piv and b on one CUDA "
                         "device")
    if LU.dtype != b.dtype or LU.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 required, got {LU.dtype}, "
                        f"{b.dtype}")
    n = LU.shape[-1]
    if (LU.dim() < 2 or LU.shape[-2] != n or b.shape != LU.shape[:-1]
            or piv.shape != b.shape or n > MAX_N):
        raise ValueError(f"LU must be [..., n, n], piv and b [..., n], n <= "
                         f"{MAX_N}; got {tuple(LU.shape)}, "
                         f"{tuple(piv.shape)}, {tuple(b.shape)}")
    LU = LU.contiguous()
    b = b.contiguous()
    piv = piv.to(torch.int32).contiguous()
    x = torch.empty_like(b)
    systems = b.numel() // max(n, 1)
    lib = load().lib
    fn = lib.lu_solve_f32 if LU.dtype == torch.float32 else lib.lu_solve_f64
    with torch.cuda.device(LU.device):
        rc = fn(LU.data_ptr(), piv.data_ptr(), b.data_ptr(), x.data_ptr(), n,
                systems, int(reciprocal_route(n, systems)),
                torch.cuda.current_stream(LU.device).cuda_stream)
    if rc != 0:
        msg = lib.lu_solve_error_string(rc).decode()
        raise RuntimeError(f"lu_solve kernel launch failed: {msg}")
    lu_substitute.launches += 1
    return x


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
                int(reciprocal_route(n, 1)),
                torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        msg = lib.lu_solve_error_string(rc).decode()
        raise RuntimeError(f"small_solve kernel launch failed: {msg}")
    small_solve.launches += 1
    if n not in SMALL_SOLVE_BY_N:
        SMALL_SOLVE_BY_N[n] = LaunchCount(f"small_solve_n{n}")
    SMALL_SOLVE_BY_N[n].launches += 1
    return x


def small_solve(A, b):
    """Device dispatch: CPU tensors -> ``small_solve_reference``; CUDA
    tensors -> the kernel (raises on failure)."""
    if b.device.type == "cpu":
        return small_solve_reference(A, b)
    if b.device.type == "cuda":
        return small_solve_cuda(A, b)
    raise ValueError(f"small_solve: unsupported device {b.device}")


small_solve.launches = 0


def lu_substitute(LU, piv, b):
    """Device dispatch: CPU tensors -> ``lu_substitute_reference``; CUDA
    tensors -> the kernel (raises on failure)."""
    if b.device.type == "cpu":
        return lu_substitute_reference(LU, piv, b)
    if b.device.type == "cuda":
        return lu_substitute_cuda(LU, piv, b)
    raise ValueError(f"lu_substitute: unsupported device {b.device}")


lu_substitute.launches = 0


@torch.library.custom_op("slam_eds_tpu_torch::lu_substitute",
                         mutates_args=())
def lu_op(LU: torch.Tensor, piv: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """``lu_substitute`` as an operator, for ``torch.vmap``."""
    return lu_substitute(LU, piv, b)


@lu_op.register_fake
def _lu_fake(LU, piv, b):
    return torch.empty_like(b)


def _lu_vmap(info, in_dims, LU, piv, b):
    """Batch rule: the mapped axis to the front of all three, one launch
    (its route chosen by the real number of systems, as torch's batched
    solve chooses)."""
    B = info.batch_size
    LU, piv, b = (x.movedim(d, 0) if d is not None
                  else x.expand(B, *x.shape)
                  for x, d in zip((LU, piv, b), in_dims))
    return lu_substitute(LU, piv, b), 0


torch.library.register_vmap("slam_eds_tpu_torch::lu_substitute", _lu_vmap)
