"""Bilinear (value, gx, gy) pattern sampling of the BA linearization.

Port of the Pallas TPU kernel ``slam_eds_tpu/ops/pallas/sample.py``
(``pattern_pallas_sample``): the CUDA kernel ``csrc/pattern_sample.cu``
(hand-written for ``sm_90a``, one thread per tap, an L2-resident gather of
the planar [F, H, W] intensity the window keeps — see the header of the .cu
file for what bounds it) plus
``pattern_sample_reference``, the plain torch gather with the same
semantics.

``pattern_sample`` dispatches on the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (a build or launch failure
raises — there is no fallback). ``pattern_sample.launches`` counts kernel
launches. ``pattern_sample_lanes`` is the same kernel over a leading lane
axis (taps [B, P, F, K], lane b reading its own [F, H, W] planes), counted
in ``pattern_sample_lanes.launches``; ``sample_op`` is the sampler as a
PyTorch operator whose ``torch.vmap`` rule takes the lane axis, and
``sample`` takes the operator only under ``torch.vmap``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import counted, load_library


def _planes_view(planes):
    """[F, H, W, 3] image stack -> its channel-0 [F, H, W] view (strided, no
    copy); [F, H, W] planes pass through."""
    if planes.dim() == 4:
        return planes[..., 0]
    if planes.dim() != 3:
        raise ValueError(f"planes must be [F, H, W] or [F, H, W, 3], "
                         f"got {tuple(planes.shape)}")
    return planes


def _sample_lanes_reference(pl, u, v):
    """The plain arithmetic on planes [B, F, H, W] and taps [B, P, F, K]."""
    B, F, H, W = pl.shape
    uc = torch.clamp(torch.nan_to_num(u, nan=-8.0), -8.0, W + 8.0)
    vc = torch.clamp(torch.nan_to_num(v, nan=-8.0), -8.0, H + 8.0)
    ok = (uc >= 1.0) & (uc < W - 2.0) & (vc >= 1.0) & (vc < H - 2.0)
    x0f = torch.floor(uc)
    y0f = torch.floor(vc)
    fx = uc - x0f
    fy = vc - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    bi = torch.arange(B, device=u.device)[:, None, None, None]
    fi = torch.arange(F, device=u.device)[None, None, :, None]

    def T(dy, dx):
        yy = y0 + dy
        xx = x0 + dx
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        val = pl[bi, fi, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(inb, val, torch.zeros_like(val))

    p10, p11, p12, p13 = T(0, -1), T(0, 0), T(0, 1), T(0, 2)
    p20, p21, p22, p23 = T(1, -1), T(1, 0), T(1, 1), T(1, 2)
    p01, p02, p31, p32 = T(-1, 0), T(-1, 1), T(2, 0), T(2, 1)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    val = w00 * p11 + w01 * p12 + w10 * p21 + w11 * p22
    gx = 0.5 * (w00 * (p12 - p10) + w01 * (p13 - p11)
                + w10 * (p22 - p20) + w11 * (p23 - p21))
    gy = 0.5 * (w00 * (p21 - p01) + w01 * (p22 - p02)
                + w10 * (p31 - p11) + w11 * (p32 - p12))
    return val, gx, gy, ok


def pattern_sample_reference(planes, u, v):
    """Plain torch version. planes [F, H, W] or [F, H, W, 3] (channel 0);
    u, v [P, F, K] tap pixel coords. Returns (I, gx, gy, ok), each
    [P, F, K]; texels outside the image read as 0, so every output is
    finite for finite planes."""
    out = _sample_lanes_reference(_planes_view(planes)[None], u[None],
                                  v[None])
    return tuple(x[0] for x in out)


def pattern_sample_lanes_reference(planes, u, v):
    """Plain torch version of the lane axis: planes [B, F, H, W] or
    [B, F, H, W, 3] (channel 0), taps u, v [B, P, F, K]; lane b samples its
    own planes. Returns (I, gx, gy, ok), each [B, P, F, K]."""
    return _sample_lanes_reference(_lanes_view(planes), u, v)


def _lanes_view(planes):
    """[B, F, H, W, 3] -> its channel-0 [B, F, H, W] view; [B, F, H, W]
    passes through."""
    if planes.dim() == 5:
        return planes[..., 0]
    if planes.dim() != 4:
        raise ValueError(f"lane planes must be [B, F, H, W] or "
                         f"[B, F, H, W, 3], got {tuple(planes.shape)}")
    return planes


_FUNCTIONS = {"pattern_sample_launch": (
    [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] + [ctypes.c_void_p] * 7)}


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record."""
    return load_library("pattern_sample", ["pattern_sample.cu"], _FUNCTIONS)


def _launch(pl, sB, u, v, lanes):
    """One launch over every tap of u, v (contiguous, CUDA, float32; the
    ``lanes`` lanes one after the other); pl is the [F, H, W] view of lane
    0, sB the element stride between lanes."""
    F, H, W = pl.shape
    K = u.shape[-1]
    lib = load().lib
    out = [torch.empty_like(u) for _ in range(3)]
    ok = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        sF, sH, sW = pl.stride()
        rc = lib.pattern_sample_launch(
            pl.data_ptr(), sB, sF, sH, sW, F, H, W, K, lanes,
            u.numel() // lanes,
            u.data_ptr(), v.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), ok.data_ptr(), stream)
    if rc != 0:
        msg = lib.pattern_sample_error_string(rc).decode()
        raise RuntimeError(f"pattern_sample kernel launch failed: {msg}")
    return out[0], out[1], out[2], ok


def _check_cuda(pl, u, v, what):
    if not (pl.is_cuda and u.is_cuda and v.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    if not (pl.device == u.device == v.device):
        raise ValueError(f"device mismatch: {pl.device}, {u.device}, "
                         f"{v.device}")
    if not (pl.dtype == u.dtype == v.dtype == torch.float32):
        raise TypeError(f"float32 required, got {pl.dtype}, {u.dtype}, "
                        f"{v.dtype}")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u and v must be contiguous")
    if min(pl.stride()) < 0:
        raise ValueError("negative plane strides are not supported")


def pattern_sample_cuda(planes, u, v):
    """Launch the CUDA kernel; every check raises on what it does not take."""
    pl = _planes_view(planes)
    _check_cuda(pl, u, v, "pattern_sample_cuda")
    if u.dim() != 3 or u.shape != v.shape or u.shape[1] != pl.shape[0]:
        raise ValueError(f"u, v must be [P, F, K] with F = {pl.shape[0]}; "
                         f"got {tuple(u.shape)}, {tuple(v.shape)}")
    out = _launch(pl, 0, u, v, 1)
    pattern_sample.launches += 1
    return out


def pattern_sample_lanes_cuda(planes, u, v):
    """Launch the CUDA kernel over a lane axis: planes [B, F, H, W] (or
    [B, F, H, W, 3], channel 0; a lane stride of 0 shares one stack), taps
    [B, P, F, K]. Every check raises on what it does not take."""
    pl = _lanes_view(planes)
    _check_cuda(pl, u, v, "pattern_sample_lanes_cuda")
    if (u.dim() != 4 or u.shape != v.shape or u.shape[0] != pl.shape[0]
            or u.shape[2] != pl.shape[1]):
        raise ValueError(f"u, v must be [B, P, F, K] with B, F = "
                         f"{tuple(pl.shape[:2])}; got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    out = _launch(pl[0], pl.stride(0), u, v, u.shape[0])
    pattern_sample_lanes.launches += 1
    return out


@counted
def pattern_sample(planes, u, v):
    """Device dispatch: CPU tensors -> ``pattern_sample_reference``; CUDA
    tensors -> the kernel (raises on failure)."""
    if u.device.type == "cpu":
        return pattern_sample_reference(planes, u, v)
    if u.device.type == "cuda":
        return pattern_sample_cuda(planes, u, v)
    raise ValueError(f"pattern_sample: unsupported device {u.device}")


@counted
def pattern_sample_lanes(planes, u, v):
    """Device dispatch of the lane axis: CPU tensors ->
    ``pattern_sample_lanes_reference``; CUDA tensors -> the kernel."""
    if u.device.type == "cpu":
        return pattern_sample_lanes_reference(planes, u, v)
    if u.device.type == "cuda":
        return pattern_sample_lanes_cuda(planes, u, v)
    raise ValueError(f"pattern_sample_lanes: unsupported device {u.device}")



# ---------------------------------------------------------------------------
# The sampler as a PyTorch operator, so that ``torch.vmap`` can map a caller
# (``ops.energy.linearize`` under ``eval.batched_ba_windows``) over lanes:
# vmap cannot enter the ctypes launch, so the operator's vmap rule sends the
# whole batch to the lane-axis kernel in one launch.
# ---------------------------------------------------------------------------

@torch.library.custom_op("slam_eds_tpu_torch::pattern_sample",
                         mutates_args=())
def sample_op(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """``pattern_sample`` as an operator (the kernel on the card, the plain
    version on the CPU). Its outputs are fresh tensors, as an operator's
    must be."""
    return pattern_sample(planes, u, v)


@sample_op.register_fake
def _sample_fake(planes, u, v):
    return (torch.empty_like(u), torch.empty_like(u), torch.empty_like(u),
            torch.empty(u.shape, dtype=torch.bool, device=u.device))


def _sample_vmap(info, in_dims, planes, u, v):
    """Batch rule: move (or expand) the mapped axis to the front of the
    planes and the taps and launch once over the lanes."""
    B = info.batch_size
    pd, ud, vd = in_dims
    planes = (planes.movedim(pd, 0) if pd is not None
              else planes.expand(B, *planes.shape))
    u = u.movedim(ud, 0) if ud is not None else u.expand(B, *u.shape)
    v = v.movedim(vd, 0) if vd is not None else v.expand(B, *v.shape)
    out = pattern_sample_lanes(planes, u.contiguous(), v.contiguous())
    return out, (0, 0, 0, 0)


torch.library.register_vmap("slam_eds_tpu_torch::pattern_sample",
                            _sample_vmap)


def sample(planes, u, v):
    """The sampler for a caller that ``torch.vmap`` may map: the operator
    (and so its vmap rule) under a ``torch.vmap``, the wrapper
    ``pattern_sample`` otherwise. The operator's first call in a process
    imports much of torch (its dispatcher machinery, seconds), so the
    unmapped path does not go through it."""
    if torch._C._are_functorch_transforms_active():
        return sample_op(planes, u, v)
    return pattern_sample(planes, u, v)
