"""EDS KeyFrame — the event side's reference frame with its active point
set; port of ``slam_eds_tpu.models.keyframe``.

One NamedTuple of fixed-capacity parallel tensors with a validity mask.
Creation: min-max normalize -> log(I + log_eps) -> Sobel gradients ->
per-cell candidate selection on |grad| -> the top ``percent_points`` by
score -> normalized coords, per-point gradients -> inverse depth from a
sparse map (nearest neighbour + distance weights) or a constant. Point
lifecycle is mask updates; ``sparse_model``/``model_image`` are the
generative model (``model_image`` rasterizes through the event kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils import image as image_ops
from .ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils.cameras import Pinhole
from ..utils.events import scatter_accumulate
from ..utils.interp import bilinear
from ..utils.lie import SE3
from ..ops.pixel_selector import candidate_points_grid
from ..ops.event_tracker import compute_flow


class KeyFrame(NamedTuple):
    img: torch.Tensor        # [H, W] min-max normalized intensity
    log_img: torch.Tensor    # [H, W] log(I + log_eps)
    grad_img: torch.Tensor   # [H, W, 2] Sobel gradients of the log image
    uv: torch.Tensor         # [P, 2] pixel coords
    norm_coord: torch.Tensor  # [P, 2] normalized camera coords
    grad: torch.Tensor       # [P, 2] log-image gradient at the point
    idepth: torch.Tensor     # [P] inverse depth (filter mean)
    weight: torch.Tensor     # [P] point weight in [0, 1]
    residual: torch.Tensor   # [P] last tracker residuals
    track: torch.Tensor      # [P, 2] track vector into the event frame
    mask: torch.Tensor       # [P] point alive
    n_initial: torch.Tensor  # number of points at creation
    T_w_kf_R: torch.Tensor   # [3, 3]
    T_w_kf_t: torch.Tensor   # [3]
    time: torch.Tensor       # scalar timestamp

    @property
    def pose(self) -> SE3:
        return SE3(self.T_w_kf_R, self.T_w_kf_t)


def to_numpy(kf: KeyFrame) -> dict:
    return tuple_to_numpy(kf)


def from_numpy(d: dict, device="cuda") -> KeyFrame:
    """KeyFrame from a dict of arrays (e.g. a JAX KeyFrame converted field by
    field with ``np.asarray``)."""
    return tuple_from_numpy(KeyFrame, d, device)


def nn_depth_lookup(uv, map_uv, map_idp, map_mask):
    """Brute-force nearest-neighbour inverse-depth association (setDepthMap):
    dense [P, M] squared distances, masked map entries at +inf.
    Returns (idepth [P], weight [P]), weight = 1 - minmax-normalized NN
    distance (all ones when the distances are constant)."""
    d2 = torch.sum((uv[:, None, :] - map_uv[None, :, :]) ** 2, -1)
    d2 = torch.where(map_mask[None, :], d2,
                     torch.full_like(d2, float("inf")))
    dmin2, idx = torch.min(d2, 1)
    dist = torch.sqrt(dmin2)
    idp = map_idp[idx]
    dmin = torch.min(dist)
    dmax = torch.max(dist)
    w = torch.where(dmax > dmin, 1.0 - (dist - dmin) / (dmax - dmin + 1e-12),
                    torch.ones_like(dist))
    return idp, w


def idepth_map_from_depth_image(depth, stride: int = 4,
                                min_depth: float = 1e-3,
                                max_depth: float = math.inf):
    """Sparse inverse-depth map (uv [M, 2], idepth [M], mask [M]) from a
    dense depth image [H, W] on a regular ``stride`` grid; non-finite and
    out-of-range depths are masked."""
    d = depth.to(torch.float32)
    H, W = d.shape
    ys, xs = torch.meshgrid(
        torch.arange(0, H, stride, dtype=torch.float32, device=d.device),
        torch.arange(0, W, stride, dtype=torch.float32, device=d.device),
        indexing="ij")
    z = d[::stride, ::stride]
    mask = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    uv = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    idp = 1.0 / torch.clamp(z.reshape(-1), min=min_depth)
    return uv, idp, mask.reshape(-1)


def idepth_map_from_pointcloud(Xw, T_cw: SE3, cam: Pinhole, mask=None):
    """Sparse inverse-depth map from a world pointcloud [M, 3] seen by the
    camera at worldToCam ``T_cw``; points behind the camera or off the image
    are masked. Returns (uv, idepth, mask)."""
    Xc = T_cw.apply(Xw.to(torch.float32))
    z = Xc[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * Xc[:, 0] / zs + cam.cx
    v = cam.fy * Xc[:, 1] / zs + cam.cy
    ok = (z > 1e-6) & (u >= 0) & (v >= 0) \
        & (u <= cam.width - 1) & (v <= cam.height - 1)
    if mask is not None:
        ok = ok & mask
    return torch.stack([u, v], -1), 1.0 / zs, ok


def create_keyframe(raw_img, cam: Pinhole, capacity: int,
                    percent_points: float = 0.4,
                    patch: int = 8, selection_mode: str = "max",
                    log_eps: float = 0.2, sobel_ksize: int = 3,
                    depth_map=None, init_depth: float = 1.0,
                    T_w_kf: Optional[SE3] = None,
                    time=0.0, *, device) -> KeyFrame:
    """KeyFrame from a raw intensity image [H, W] (numpy or tensor), built on
    ``device``. depth_map: optional (map_uv [M, 2], map_idp [M],
    map_mask [M]) sparse inverse-depth map for nearest-neighbour seeding;
    otherwise constant ``init_depth`` with unit weights."""
    dtype = torch.float32
    img = image_ops.minmax_normalize(
        torch.as_tensor(raw_img, dtype=dtype, device=device))
    log_img = image_ops.log_image(img, log_eps)
    gx, gy = image_ops.sobel(log_img, sobel_ksize)
    gmag = image_ops.gradient_magnitude(gx, gy)

    uv, mask = candidate_points_grid(gmag, patch=patch, capacity=capacity,
                                     mode=selection_mode)
    # keep the top fraction by |grad| (the selection is score-ordered); the
    # count is truncated in float32 as in the JAX module, on the device
    n_target = (percent_points * mask.sum().to(dtype)).to(torch.int32)
    mask = mask & (torch.arange(capacity, device=img.device) < n_target)

    nc = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                      (uv[:, 1] - cam.cy) / cam.fy], -1)
    g_pt = torch.stack([bilinear(gx, uv[:, 0], uv[:, 1]),
                        bilinear(gy, uv[:, 0], uv[:, 1])], -1)
    if depth_map is not None:
        idp, w = nn_depth_lookup(uv, *depth_map)
    else:
        idp = torch.full((capacity,), 1.0 / init_depth, dtype=dtype,
                         device=img.device)
        w = torch.ones((capacity,), dtype=dtype, device=img.device)
    if T_w_kf is None:
        T_w_kf = SE3.identity(dtype, device=img.device)
    return KeyFrame(
        img=img, log_img=log_img, grad_img=torch.stack([gx, gy], -1),
        uv=uv, norm_coord=nc, grad=g_pt,
        idepth=idp, weight=torch.where(mask, w, torch.zeros_like(w)),
        residual=torch.zeros((capacity,), dtype=dtype, device=img.device),
        track=torch.zeros((capacity, 2), dtype=dtype, device=img.device),
        mask=mask, n_initial=mask.sum().to(torch.int32),
        T_w_kf_R=T_w_kf.R, T_w_kf_t=T_w_kf.t,
        time=torch.full((), float(time), dtype=dtype, device=img.device))


def clean_points(kf: KeyFrame, weight_threshold: float = 0.7) -> KeyFrame:
    """Mask off low-weight points (cleanPoints)."""
    return kf._replace(mask=kf.mask & (kf.weight >= weight_threshold))


def event_activity(event_frame, uv, radius: int = 2):
    """max |event frame| over a (2r+1)^2 neighbourhood of each point [P]."""
    offs = torch.arange(-radius, radius + 1, dtype=uv.dtype, device=uv.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    xs = uv[:, 0:1] + dx.reshape(-1)[None, :]
    ys = uv[:, 1:2] + dy.reshape(-1)[None, :]
    return torch.amax(torch.abs(bilinear(event_frame, xs, ys)), -1)


def points_refinement(kf: KeyFrame, event_frame, radius: int = 2,
                      activity_threshold: float = 1e-4) -> KeyFrame:
    """Drop points without nearby event activity (pointsRefinement)."""
    act = event_activity(event_frame, kf.uv, radius)
    return kf._replace(mask=kf.mask & (act > activity_threshold))


def erase_out_of_frame(kf: KeyFrame, uv_warped, cam: Pinhole) -> KeyFrame:
    """Mask points whose warp left the event frame."""
    alive = (uv_warped[:, 0] >= 0) & (uv_warped[:, 0] <= cam.width - 1) \
        & (uv_warped[:, 1] >= 0) & (uv_warped[:, 1] <= cam.height - 1)
    return kf._replace(mask=kf.mask & alive)


def need_new_kf(kf: KeyFrame, percent_loss: float = 0.3):
    """Point-loss criterion (needNewKF): more than percent_loss of the
    initial points died."""
    return kf.mask.sum() < (1.0 - percent_loss) * kf.n_initial


def kf_selection_occlusion(delta_pose: SE3, median_depth,
                           threshold: float = 0.20):
    """Parallax ratio ||t|| / median_depth > threshold."""
    return torch.linalg.vector_norm(delta_pose.t) / median_depth > threshold


def kf_selection_rotation(delta_pose: SE3,
                          threshold: float = 0.174533 / 3.0):
    """Rotation angle of the delta pose > threshold (5 deg / 3)."""
    return torch.linalg.vector_norm(delta_pose.log()[3:]) > threshold


def kf_selection_translation(delta_pose: SE3, threshold: float = 0.05):
    """||t|| > threshold (5 cm)."""
    return torch.linalg.vector_norm(delta_pose.t) > threshold


def sparse_model(kf: KeyFrame, vx, norm_eps: float = 1e-3):
    """Normalized brightness-change model per point, -(grad . flow)/||.||
    (getSparseModel). vx: 6-dof [linear, angular] velocity."""
    flow = compute_flow(kf.norm_coord, vx, kf.idepth)
    model = -(kf.grad[:, 0] * flow[:, 0] + kf.grad[:, 1] * flow[:, 1])
    model = torch.where(kf.mask, model, torch.zeros_like(model))
    return model / torch.sqrt(norm_eps + torch.sum(model * model))


def model_image(kf: KeyFrame, vx, height: int, width: int,
                method: str = "bilinear"):
    """Rasterized model image (getModel)."""
    return scatter_accumulate(kf.uv[:, 0], kf.uv[:, 1], sparse_model(kf, vx),
                              height, width, mask=kf.mask, method=method)


def export_map(kf: KeyFrame, cam: Pinhole):
    """World-frame pointcloud of the points with intensity colours (getMap).
    Returns (xyz [P, 3], color [P], mask [P])."""
    z = 1.0 / torch.clamp(kf.idepth, min=1e-6)
    X = torch.stack([kf.norm_coord[:, 0] * z, kf.norm_coord[:, 1] * z, z], -1)
    color = bilinear(kf.img, kf.uv[:, 0], kf.uv[:, 1])
    return kf.pose.apply(X), color, kf.mask
