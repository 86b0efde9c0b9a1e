"""The substitution half of a small dense LU solve on the card.

The CUDA kernel ``csrc/lu_solve.cu`` (hand-written for ``sm_90a``: one
thread per system, up to 32 unknowns, float32 or float64) takes the factors
and pivots of ``torch.linalg.lu_factor_ex`` and a right-hand side, and
substitutes in the order of torch's own solve (see the header of the .cu
file), so ``utils.linalg.solve`` is bitwise ``torch.linalg.solve_ex`` at
the loops' sizes and can be captured inside a conditional node.
``lu_substitute_reference`` is the plain version, ``torch.linalg.lu_solve``.

``lu_substitute`` dispatches on the device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (a build or launch failure
raises). ``lu_substitute.launches`` counts kernel launches. ``lu_op`` is
the same as an operator whose ``torch.vmap`` rule substitutes every lane in
one launch.
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


def lu_substitute_reference(LU, piv, b):
    """Plain torch version: LU [..., n, n], piv [..., n] int32 (1-based),
    b [..., n] -> x [..., n]."""
    return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]


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
