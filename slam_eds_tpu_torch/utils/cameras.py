"""Camera models, distortion and undistortion maps — port of
``slam_eds_tpu.utils.cameras``.

Intrinsics are plain Python floats: the pipeline reads them on the host and
every tensor op broadcasts them. A ``CameraModel`` carries its distortion
coefficients as a float32 tensor, and the maps are built on that tensor's
device. Distortion inversion is the JAX module's fixed-count loop in the
same operation order (radtan: 8 fixed-point steps; equidistant: 8 Newton
steps; FOV: closed form).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Pinhole(NamedTuple):
    """Intrinsics K = [[fx,0,cx],[0,fy,cy],[0,0,1]] plus image size."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def K(self, dtype=torch.float32, *, device):
        # fills, not a host-to-device copy (a scalar assignment copies a
        # host tensor), so a captured CUDA graph can build it
        K = torch.zeros((3, 3), dtype=dtype, device=device)
        for (i, j), v in (((0, 0), self.fx), ((0, 2), self.cx),
                          ((1, 1), self.fy), ((1, 2), self.cy),
                          ((2, 2), 1.0)):
            K[i, j].fill_(v)
        return K

    def scaled(self, out_w: int, out_h: int) -> "Pinhole":
        """Intrinsics for a resized image: fx*sx, fy*sy, (cx+0.5)*sx-0.5."""
        sx = out_w / self.width
        sy = out_h / self.height
        return Pinhole(self.fx * sx, self.fy * sy, (self.cx + 0.5) * sx - 0.5,
                       (self.cy + 0.5) * sy - 0.5, out_w, out_h)

    def pyramid_level(self, lvl: int) -> "Pinhole":
        """DSO per-level intrinsics: fx*0.5^l, cx = (cx+0.5)/2^l - 0.5."""
        s = 0.5 ** lvl
        return Pinhole(self.fx * s, self.fy * s, (self.cx + 0.5) * s - 0.5,
                       (self.cy + 0.5) * s - 0.5, self.width >> lvl,
                       self.height >> lvl)


def f32(x) -> float:
    """``x`` rounded to float32, as the JAX package stores intrinsics."""
    return float(np.float32(x))


def project(cam: Pinhole, xyz):
    """3D points [..., 3] -> pixels [..., 2] (no distortion)."""
    inv_z = 1.0 / xyz[..., 2]
    u = cam.fx * xyz[..., 0] * inv_z + cam.cx
    v = cam.fy * xyz[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], -1)


def backproject(cam: Pinhole, uv, inv_depth):
    """Pixels [..., 2] + inverse depth [...] -> 3D points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    z = 1.0 / (inv_depth + 1e-12)
    return torch.stack([x * z, y * z, z], -1)


def normalized_coords(cam: Pinhole, uv):
    """Pixels -> normalized image coords [(u-cx)/fx, (v-cy)/fy]."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], -1)


# ---------------------------------------------------------------------------
# Distortion models; D layouts follow the calib YAML: radtan [k1,k2,p1,p2(,k3)],
# equidistant/KB [k1,k2,k3,k4], FOV [w].
# ---------------------------------------------------------------------------

def _radtan_coeffs(D):
    k3 = D[4] if D.shape[0] > 4 else torch.zeros_like(D[0])
    return D[0], D[1], D[2], D[3], k3


def distort_radtan(xy, D):
    """Normalized coords -> distorted normalized coords (Brown-Conrady)."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(D)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_radtan(xyd, D, iters: int = 8):
    """Fixed-point inverse of radtan distortion, ``iters`` steps."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(D)
    xy = xyd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xyd[..., 0] - dx) / radial,
                          (xyd[..., 1] - dy) / radial], -1)
    return xy


def distort_equidistant(xy, D):
    """Equidistant / Kannala-Brandt fisheye:
    theta_d = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8)."""
    k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y) + 1e-12
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    s = theta_d / r
    return torch.stack([x * s, y * s], -1)


def undistort_equidistant(xyd, D, iters: int = 8):
    """Newton inverse of the equidistant model, ``iters`` steps."""
    k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
    xd, yd = xyd[..., 0], xyd[..., 1]
    theta_d = torch.sqrt(xd * xd + yd * yd) + 1e-12
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3
                                                       + t2 * 9 * k4)))
        theta = theta - f / df
    s = torch.tan(theta) / theta_d
    return torch.stack([xd * s, yd * s], -1)


def distort_fov(xy, D):
    """FOV model (Devernay/Faugeras)."""
    w = D[0]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y) + 1e-12
    rd = torch.atan(2.0 * r * torch.tan(0.5 * w)) / w
    s = rd / r
    return torch.stack([x * s, y * s], -1)


def undistort_fov(xyd, D, iters: int = 0):
    """Closed-form inverse of the FOV model (``iters`` is unused)."""
    w = D[0]
    xd, yd = xyd[..., 0], xyd[..., 1]
    rd = torch.sqrt(xd * xd + yd * yd) + 1e-12
    r = torch.tan(rd * w) / (2.0 * torch.tan(0.5 * w))
    s = r / rd
    return torch.stack([xd * s, yd * s], -1)


_DISTORT = {"none": None, "radtan": distort_radtan,
            "equidistant": distort_equidistant, "kb": distort_equidistant,
            "fov": distort_fov}
_UNDISTORT = {"none": None, "radtan": undistort_radtan,
              "equidistant": undistort_equidistant, "kb": undistort_equidistant,
              "fov": undistort_fov}


class CameraModel(NamedTuple):
    """Pinhole intrinsics + distortion coefficients (a float32 tensor, whose
    device the maps are built on) + model name."""
    pinhole: Pinhole
    D: torch.Tensor
    model: str = "none"   # none | radtan | equidistant | kb | fov


def _pixel_grid(cam: Pinhole, device):
    """Normalized coordinates [H, W, 2] of every pixel of ``cam``."""
    vs, us = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=device),
        torch.arange(cam.width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy], -1)


def undistortion_maps(cam: CameraModel, out: Optional[Pinhole] = None):
    """Inverse maps for remapping an image into ``out`` (default: the
    camera's own pinhole): for each output pixel, the source (distorted)
    pixel. Returns (map_x, map_y), each [H_out, W_out] float32, on
    ``cam.D``'s device."""
    out = out or cam.pinhole
    xy = _pixel_grid(out, cam.D.device)
    if cam.model != "none":
        xy = _DISTORT[cam.model](xy, cam.D)
    pin = cam.pinhole
    return pin.fx * xy[..., 0] + pin.cx, pin.fy * xy[..., 1] + pin.cy


def forward_maps(cam: CameraModel, out: Optional[Pinhole] = None):
    """Forward maps (distorted pixel -> undistorted pixel in ``out``) for
    per-event undistortion by table lookup. Returns (fwd_x, fwd_y), each
    [H_in, W_in] float32, on ``cam.D``'s device."""
    out = out or cam.pinhole
    xy = _pixel_grid(cam.pinhole, cam.D.device)
    if cam.model != "none":
        xy = _UNDISTORT[cam.model](xy, cam.D)
    return out.fx * xy[..., 0] + out.cx, out.fy * xy[..., 1] + out.cy


def remap(img, map_x, map_y):
    """Bilinear image remap, out[v, u] = img(map_x[v, u], map_y[v, u]), with
    ``utils.interp.bilinear``'s per-tap edge clamping and NaN for a
    non-finite map entry."""
    from .interp import bilinear
    H, W = map_x.shape
    return bilinear(img.to(torch.float32), map_x.reshape(-1),
                    map_y.reshape(-1)).reshape(H, W)


def _interp_f32(x, xp, fp):
    """``jnp.interp`` in float32 numpy, formula for formula."""
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = np.where(dx0, fp[i - 1],
                 fp[i - 1] + (delta / np.where(dx0, np.float32(1), dx)) * df)
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f).astype(np.float32)


def gamma_inverse_table(gamma_values):
    """Response G[256] -> (B, Binv), each [256] float32 numpy: B is G
    rescaled to [0, 255], Binv its piecewise-linear inverse."""
    g = np.asarray(gamma_values, np.float32)
    g = (g - g[0]) / (g[-1] - g[0]) * np.float32(255.0)
    xs = np.arange(256, dtype=np.float32)
    return g, _interp_f32(xs, g, xs)


def optimal_k_crop(cam: CameraModel, out_w: int, out_h: int) -> Pinhole:
    """Largest axis-aligned undistorted view fully covered by the input
    image (DSO's makeOptimalK_crop): the input border, sampled densely and
    undistorted, bounds the output rectangle side by side."""
    pin = cam.pinhole
    n = 512
    xs = np.linspace(0, pin.width - 1, n, dtype=np.float32)
    ys = np.linspace(0, pin.height - 1, n, dtype=np.float32)
    sides = {
        "left": np.stack([np.zeros(n, np.float32), ys], -1),
        "right": np.stack([np.full(n, pin.width - 1, np.float32), ys], -1),
        "top": np.stack([xs, np.zeros(n, np.float32)], -1),
        "bottom": np.stack([xs, np.full(n, pin.height - 1, np.float32)], -1),
    }

    def undist_norm(uv):
        uv = torch.as_tensor(uv, device=cam.D.device)
        xy = torch.stack([(uv[:, 0] - pin.cx) / pin.fx,
                          (uv[:, 1] - pin.cy) / pin.fy], -1)
        if cam.model != "none":
            xy = _UNDISTORT[cam.model](xy, cam.D)
        return xy.cpu().numpy()

    b = {k: undist_norm(v) for k, v in sides.items()}
    min_x = float(b["left"][:, 0].max())
    max_x = float(b["right"][:, 0].min())
    min_y = float(b["top"][:, 1].max())
    max_y = float(b["bottom"][:, 1].min())
    fx = (out_w - 1) / (max_x - min_x)
    fy = (out_h - 1) / (max_y - min_y)
    return Pinhole(f32(fx), f32(fy), f32(-min_x * fx), f32(-min_y * fy),
                   out_w, out_h)
