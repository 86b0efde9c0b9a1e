"""Event-to-model alignment, the EDS pose tracker — port of the default path
of ``slam_eds_tpu.ops.event_tracker``.

Residual per active point i:
    model_i = -(g_i . flow_i),   flow_i = L_i v (interaction matrix)
    r_i     = w_i (model_i / ||model|| - E(pi(R X_i + t)))
with ||model|| the l2 norm over the whole point set (+1e-3 guard) and E the
Frobenius-normalized event frame sampled bicubically (or, in the NC variant,
the raw frame with the sampled values normalized by their own norm).

State: translation px, unit quaternion qx [w, x, y, z], unit-norm 6-dof
velocity vx. The LM runs over the 12-dof local increment with the analytic
Jacobian (``event_residuals_and_jac``). Where the JAX module loops with
``lax.while_loop``/``lax.scan``, this one loops in Python: one host read of
the LM's ``done`` flag per iteration, counted in ``counters`` when given.
Track refinement (``klt``/``model_klt``/``epiline``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils import lie
from ..utils.lie import SE3
from ..utils.cameras import Pinhole
from ..utils.interp import bicubic, bicubic_with_grad
from ..utils.stats import huber_weight, cauchy_weight, masked_mad, HUBER_K


class TrackerState(NamedTuple):
    px: torch.Tensor    # [3] translation of T_ef_kf
    qx: torch.Tensor    # [4] quaternion [w, x, y, z] of T_ef_kf
    vx: torch.Tensor    # [6] unit-norm [linear(3), angular(3)] velocity


def state_to_numpy(state: TrackerState) -> dict:
    return tuple_to_numpy(state)


def state_from_numpy(d: dict, device="cuda") -> TrackerState:
    """TrackerState from a dict of arrays (e.g. a JAX TrackerState converted
    field by field with ``np.asarray``)."""
    return tuple_from_numpy(TrackerState, d, device)


class TrackerResult(NamedTuple):
    state: TrackerState
    residuals: torch.Tensor    # [P] final weighted residuals
    energy: torch.Tensor       # scalar robust energy
    n_iter: torch.Tensor
    loss_scale: torch.Tensor   # MAD-updated Huber scale for the next solve


def initial_tracker_state(device, dtype=torch.float32) -> TrackerState:
    """Zero pose, velocity (0.1, ...)/|.| (Tracker.cpp:40-47)."""
    v = torch.full((6,), 0.1, dtype=dtype, device=device)
    return TrackerState(px=torch.zeros(3, dtype=dtype, device=device),
                        qx=lie.quat_identity(dtype, device),
                        vx=v / torch.linalg.vector_norm(v))


def compute_flow(norm_coord, vx, idp):
    """Interaction-matrix optical flow [P, 2] at normalized coords [P, 2]
    with inverse depths [P]."""
    x = norm_coord[:, 0]
    y = norm_coord[:, 1]
    v0, v1, v2, w0, w1, w2 = vx.unbind(0)
    fx = -idp * v0 + x * idp * v2 + x * y * w0 - (1.0 + x * x) * w1 + y * w2
    fy = -idp * v1 + y * idp * v2 + (1.0 + y * y) * w0 - x * y * w1 - x * w2
    return torch.stack([fx, fy], -1)


def _project(state: TrackerState, cam: Pinhole, norm_coord, idp):
    """Keyframe points (normalized coords + inverse depth) moved by T_ef_kf:
    returns (R X [P, 3], p = R X + t [P, 3])."""
    z = 1.0 / (idp + 1e-5)
    X = torch.stack([norm_coord[:, 0] * z, norm_coord[:, 1] * z, z], -1)
    RX = X @ lie.quat_to_mat(state.qx).T
    return RX, RX + state.px[None, :]


def event_residuals(state: TrackerState, event_frame, cam: Pinhole,
                    norm_coord, grad, idp, weights, mask,
                    norm_eps: float = 1e-3, norm_event: bool = False):
    """The full residual vector [P] (masked lanes 0). norm_event selects the
    PhotometricErrorNC cost (raw frame, sampled values self-normalized)."""
    flow = compute_flow(norm_coord, state.vx, idp)
    model = -(grad[:, 0] * flow[:, 0] + grad[:, 1] * flow[:, 1])
    zero = torch.zeros_like(model)
    model = torch.where(mask, model, zero)
    model_norm = torch.sqrt(norm_eps + torch.sum(model * model))
    _, p = _project(state, cam, norm_coord, idp)
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    ev = bicubic(event_frame, xp, yp)
    if norm_event:
        ev = torch.where(mask, ev, zero)
        ev = ev / torch.sqrt(norm_eps + torch.sum(ev * ev))
    r = weights * (model / model_norm - ev)
    return torch.where(mask, r, zero)


def interaction_matrix(norm_coord, idp):
    """L [P, 2, 6] with flow = L @ v."""
    x = norm_coord[:, 0]
    y = norm_coord[:, 1]
    z = torch.zeros_like(x)
    row_x = torch.stack([-idp, z, x * idp, x * y, -(1.0 + x * x), y], -1)
    row_y = torch.stack([z, -idp, y * idp, (1.0 + y * y), -x * y, -x], -1)
    return torch.stack([row_x, row_y], -2)


def event_residuals_and_jac(state: TrackerState, event_frame, cam: Pinhole,
                            norm_coord, grad, idp, weights, mask,
                            norm_eps: float = 1e-3,
                            norm_event: bool = False):
    """Residuals [P] + analytic Jacobian [P, 12] wrt the local increment
    (translation additive, quaternion left exp-map, velocity normalized
    addition). With m = A v and ||m|| = sqrt(eps + m.m):

    * d(m/||m||)/dv = (A - (m/||m||)(m^T A)/||m||)/||m||, projected through
      the unit-norm retraction (I - v v^T);
    * dr/d(px, q) = -w gradE . dpi . d(R X + px)/d(delta), with d/dpx = I
      and d/d(dq) = -[R X]_x, gradE the analytic bicubic gradient.

    The norm and m^T A (and e.e and e^T D for NC) are reductions over all
    points: they couple every residual."""
    dtype = norm_coord.dtype
    maskf = mask.to(dtype)

    # ---- model branch (velocity block)
    L = interaction_matrix(norm_coord, idp)                       # [P, 2, 6]
    A = -torch.einsum("pgx,pg->px", L, grad) * maskf[:, None]     # [P, 6]
    v = state.vx
    m = A @ v
    m2 = torch.sum(m * m)
    mTA = m @ A
    norm = torch.sqrt(norm_eps + m2)
    mh = m / norm
    Jv = (A - mh[:, None] * (mTA / norm)[None, :]) / norm
    Jv = Jv @ (torch.eye(6, dtype=dtype, device=v.device)
               - torch.outer(v, v))

    # ---- event-frame branch (pose block)
    RX, p = _project(state, cam, norm_coord, idp)
    inv_z = 1.0 / p[:, 2]
    xp = cam.fx * (p[:, 0] * inv_z) + cam.cx
    yp = cam.fy * (p[:, 1] * inv_z) + cam.cy
    ev, dEdx, dEdy = bicubic_with_grad(event_frame, xp, yp)

    zz = torch.zeros_like(inv_z)
    du = torch.stack([cam.fx * inv_z, zz,
                      -cam.fx * p[:, 0] * inv_z * inv_z], -1)
    dv_ = torch.stack([zz, cam.fy * inv_z,
                       -cam.fy * p[:, 1] * inv_z * inv_z], -1)
    gE = dEdx[:, None] * du + dEdy[:, None] * dv_                 # [P, 3]
    D = torch.cat([gE, -torch.einsum("pi,pij->pj", gE, lie.hat(RX))],
                  -1) * maskf[:, None]                            # [P, 6]

    if norm_event:
        ev = ev * maskf
        e2 = torch.sum(ev * ev)
        s = ev @ D
        en = torch.sqrt(norm_eps + e2)
        eh = ev / en
        Jpose = -(D / en - eh[:, None] * (s / (en * en))[None, :])
        ev_term = eh
    else:
        Jpose = -D
        ev_term = ev

    w = weights * maskf
    r = w * (mh - ev_term)
    J = torch.cat([w[:, None] * Jpose, w[:, None] * Jv], -1)
    return (torch.where(mask, r, torch.zeros_like(r)),
            torch.where(mask[:, None], J, torch.zeros_like(J)))


def _apply_local(state: TrackerState, delta):
    """12-dof local update: translation additive, quaternion exp-map,
    velocity normalized addition."""
    px = state.px + delta[0:3]
    qx = lie.quat_normalize(lie.quat_mul(lie.quat_exp(delta[3:6]), state.qx))
    v = state.vx + delta[6:12]
    vx = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    return TrackerState(px=px, qx=qx, vx=vx)


def _tree_where(cond, a, b):
    """Element-wise select between two NamedTuples of tensors."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _lm_solve(state: TrackerState, event_frame, cam: Pinhole,
              norm_coord, grad, idp, weights, mask,
              max_iterations: int, loss_kind: str, loss_scale,
              function_tolerance: float, norm_event: bool,
              counters=None) -> TrackerResult:
    """LM loop shared by ``optimize`` and ``_pyramid_fused``: at most
    ``max_iterations`` iterations, leaving early once an accepted step moves
    the energy by less than ``function_tolerance`` (relative). One host
    read per iteration (``counters["event_lm_host_reads"]``)."""
    dtype = norm_coord.dtype
    dev = norm_coord.device
    if not torch.is_tensor(loss_scale):
        loss_scale = torch.full((), loss_scale, dtype=dtype, device=dev)
    maskf = mask.to(dtype)

    def residuals(st):
        return event_residuals(st, event_frame, cam, norm_coord, grad, idp,
                               weights, mask, norm_event=norm_event)

    def robust_weights(r):
        if loss_kind == "huber":
            return huber_weight(r, loss_scale)
        if loss_kind == "cauchy":
            return cauchy_weight(r, loss_scale)
        return torch.ones_like(r)

    def energy_of(r):
        return torch.sum(robust_weights(r) * r * r)

    eye = torch.eye(12, dtype=dtype, device=dev)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    energy = energy_of(residuals(state))
    it = 0
    while it < max_iterations:
        r, J = event_residuals_and_jac(state, event_frame, cam, norm_coord,
                                       grad, idp, weights, mask,
                                       norm_event=norm_event)
        Jw = J * (robust_weights(r) * maskf)[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        Hl = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye
        delta = -torch.linalg.solve_ex(Hl, g[:, None])[0][:, 0]
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        new_state = _apply_local(state, delta)
        e_new = energy_of(residuals(new_state))
        accept = e_new < energy
        state = _tree_where(accept, new_state, state)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-7, 1e5)
        e_next = torch.where(accept, e_new, energy)
        rel = torch.abs(energy - e_next) / torch.clamp(energy, min=1e-12)
        energy = e_next
        it += 1
        done = accept & (rel < function_tolerance)
        if counters is not None:
            counters["event_lm_host_reads"] += 1
        if bool(done):
            break

    r_final = residuals(state)
    # MAD re-estimation of the robust scale for the next solve
    mad, _ = masked_mad(r_final, mask)
    return TrackerResult(state=state, residuals=r_final, energy=energy,
                         n_iter=torch.full((), it, dtype=torch.int32,
                                           device=dev),
                         loss_scale=torch.clamp(HUBER_K * mad, min=1e-6))


def optimize(state: TrackerState, event_frame, cam: Pinhole,
             norm_coord, grad, idp, weights, mask,
             max_iterations: int = 20, loss_kind: str = "huber",
             loss_scale=0.2, function_tolerance: float = 1e-6,
             norm_event: bool = False) -> TrackerResult:
    """One pyramid-level solve (Tracker::optimize)."""
    return _lm_solve(state, event_frame, cam, norm_coord, grad, idp,
                     weights, mask, max_iterations, loss_kind, loss_scale,
                     function_tolerance, norm_event)


def _pyramid_fused(state: TrackerState, event_frames, cam: Pinhole,
                   norm_coord, grad, idp, weights, mask,
                   iters_per_level, loss_kind: str, loss_scale,
                   norm_event: bool, counters=None) -> TrackerResult:
    """Coarse-to-fine solve over all levels (stored fine-first), chaining the
    pose state and the MAD loss scale; the function tolerance is fixed at
    1e-6 as in the JAX module. Returns the finest level's result."""
    scale = loss_scale
    for lvl in reversed(range(event_frames.shape[0])):
        res = _lm_solve(state, event_frames[lvl], cam, norm_coord, grad,
                        idp, weights, mask, int(iters_per_level[lvl]),
                        loss_kind, scale, 1e-6, norm_event, counters)
        state, scale = res.state, res.loss_scale
    return res


def optimize_pyramid(state: TrackerState, event_frames, cam: Pinhole,
                     norm_coord, grad, idp, weights, mask,
                     iterations_per_level, loss_kind: str = "huber",
                     loss_scale=0.2, norm_event: bool = False):
    """Coarse-to-fine over the event-frame levels, with the per-level
    iteration caps (the last entry repeats for deeper levels)."""
    n = len(iterations_per_level)
    its = [iterations_per_level[min(lvl, n - 1)]
           for lvl in range(event_frames.shape[0])]
    return _pyramid_fused(state, event_frames, cam, norm_coord, grad, idp,
                          weights, mask, its, loss_kind, loss_scale,
                          norm_event)


def pose_kf_ef(state: TrackerState) -> SE3:
    """T_kf_ef = (T_ef_kf)^-1."""
    return SE3(lie.quat_to_mat(state.qx), state.px).inverse()


def warp_coords(state: TrackerState, cam: Pinhole, norm_coord, idp, mask):
    """Project the keyframe points into the event frame: (uv_ef [P, 2],
    alive [P]); points behind the camera or off the image are dead."""
    _, p = _project(state, cam, norm_coord, idp)
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    alive = mask & (p[:, 2] > 1e-6) & (xp >= 0) & (xp <= cam.width - 1) \
        & (yp >= 0) & (yp <= cam.height - 1)
    return torch.stack([xp, yp], -1), alive


def mean_flow_magnitude(uv_ef, uv_kf, mask):
    """Mean squared per-point displacement (the KF trigger statistic)."""
    d = uv_ef - uv_kf
    d2 = torch.sum(d * d, -1)
    m = mask.to(d2.dtype)
    return torch.sum(d2 * m) / torch.clamp(torch.sum(m), min=1.0)


class PoseFilter(NamedTuple):
    """Ring buffer of recent pose tangents for the Lie-mean smoother (SE3MW).
    ``count`` and ``head`` are device tensors, so a push needs no host
    read."""
    taus: torch.Tensor   # [W, 6]
    count: torch.Tensor  # number of valid entries (int32)
    head: torch.Tensor   # next slot (int32)


def pose_filter_init(window: int, device, dtype=torch.float32) -> PoseFilter:
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return PoseFilter(torch.zeros((window, 6), dtype=dtype, device=device),
                      zero, zero.clone())


def pose_filter_to_numpy(f: PoseFilter) -> dict:
    return tuple_to_numpy(f)


def pose_filter_from_numpy(d: dict, device="cuda") -> PoseFilter:
    return tuple_from_numpy(PoseFilter, d, device)


def pose_filter_push(f: PoseFilter, T: SE3) -> PoseFilter:
    W = f.taus.shape[0]
    taus = f.taus.index_copy(0, f.head.reshape(1).long(), T.log()[None])
    return PoseFilter(taus, torch.clamp(f.count + 1, max=W),
                      (f.head + 1) % W)


def pose_filter_mean(f: PoseFilter) -> SE3:
    W = f.taus.shape[0]
    m = (torch.arange(W, device=f.taus.device) < f.count).to(f.taus.dtype)
    mean = torch.sum(f.taus * m[:, None], 0) / torch.clamp(torch.sum(m),
                                                           min=1.0)
    return SE3.exp(mean)
