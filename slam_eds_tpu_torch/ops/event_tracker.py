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
``lax.while_loop``, this one runs ``graphs.while_loop`` over the same
``(state, lam, energy, it, done)``: captured in a CUDA graph, the loop is
one WHILE node on ``~done``, its pass captured once, so it ends on the
device at its stop;
eagerly (the CPU, ``torch.vmap`` in ``eval.batched_event_solves``, the
sharded solve of ``parallel``) every pass to the cap runs masked, as JAX's
``vmap`` of a ``while_loop`` runs every lane to the last lane's stop. The
solve reads nothing back to the host either way. On the card one unsharded
solve outside ``torch.vmap`` runs ``_lm_solve_fused``: each pass one launch
of the ``event_pass`` kernel (``ops/kernels/event_pass.py``), so a captured
pass is that kernel and the loop's pass tail; everything else runs the
plain pass, ``_lm_solve_plain``, the kernel's plain version.

Track refinement (``refine_tracks_klt`` / ``_model_klt`` / ``_epiline``)
refines the warp-predicted tracks against the event frame before they feed
the depth filter. Each splats per-point values with
``utils.events.scatter_accumulate(..., method="bilinear")``: the raster
kernel on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from . import lanes
from .kernels import event_pass as ep
from ..models.ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils import lie
from ..utils.lie import SE3
from ..utils.cameras import Pinhole
from ..utils import klt as kltmod
from ..utils.events import scatter_accumulate
from ..utils.interp import bicubic, bicubic_with_grad, bilinear
from ..utils.stats import huber_weight, cauchy_weight, masked_mad, HUBER_K
from ..utils.linalg import solve


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
    RX = lanes.matmul(X, lie.quat_to_mat(state.qx).T)
    return RX, RX + state.px[None, :]


def _summed(x, reduce):
    """``torch.sum(x)``, summed over ranks too when ``reduce`` is given."""
    s = lanes.total(x)
    return s if reduce is None else reduce(s)


def event_residuals(state: TrackerState, event_frame, cam: Pinhole,
                    norm_coord, grad, idp, weights, mask,
                    norm_eps: float = 1e-3, norm_event: bool = False,
                    reduce=None):
    """The full residual vector [P] (masked lanes 0). norm_event selects the
    PhotometricErrorNC cost (raw frame, sampled values self-normalized).

    reduce: with the points split over ranks (``parallel.
    sharded_event_tracker``), a callable that sums a tensor over the ranks;
    the model norm (and the NC event norm) then couple every rank's points
    (JAX ``_residuals_sharded``)."""
    flow = compute_flow(norm_coord, state.vx, idp)
    model = -(grad[:, 0] * flow[:, 0] + grad[:, 1] * flow[:, 1])
    zero = torch.zeros_like(model)
    model = torch.where(mask, model, zero)
    model_norm = torch.sqrt(norm_eps + _summed(model * model, reduce))
    _, p = _project(state, cam, norm_coord, idp)
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    ev = bicubic(event_frame, xp, yp)
    if norm_event:
        ev = torch.where(mask, ev, zero)
        ev = ev / torch.sqrt(norm_eps + _summed(ev * ev, reduce))
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
                            norm_event: bool = False, reduce=None):
    """Residuals [P] + analytic Jacobian [P, 12] wrt the local increment
    (translation additive, quaternion left exp-map, velocity normalized
    addition). With m = A v and ||m|| = sqrt(eps + m.m):

    * d(m/||m||)/dv = (A - (m/||m||)(m^T A)/||m||)/||m||, projected through
      the unit-norm retraction (I - v v^T);
    * dr/d(px, q) = -w gradE . dpi . d(R X + px)/d(delta), with d/dpx = I
      and d/d(dq) = -[R X]_x, gradE the analytic bicubic gradient.

    The norm and m^T A (and e.e and e^T D for NC) are reductions over all
    points: they couple every residual, and ``reduce`` (as in
    ``event_residuals``) sums them over ranks (JAX ``axis_name``)."""
    dtype = norm_coord.dtype
    maskf = mask.to(dtype)

    # ---- model branch (velocity block)
    L = interaction_matrix(norm_coord, idp)                       # [P, 2, 6]
    A = -lanes.einsum("pgx,pg->px", L, grad) * maskf[:, None]     # [P, 6]
    v = state.vx
    m = lanes.matmul(A, v)
    m2 = lanes.total(m * m)
    mTA = lanes.matmul(m, A)
    if reduce is not None:
        m2, mTA = reduce(m2), reduce(mTA)
    norm = torch.sqrt(norm_eps + m2)
    mh = m / norm
    Jv = (A - mh[:, None] * (mTA / norm)[None, :]) / norm
    Jv = lanes.matmul(Jv, torch.eye(6, dtype=dtype, device=v.device)
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
    D = torch.cat([gE, -lanes.einsum("pi,pij->pj", gE, lie.hat(RX))],
                  -1) * maskf[:, None]                            # [P, 6]

    if norm_event:
        ev = ev * maskf
        e2 = lanes.total(ev * ev)
        s = lanes.matmul(ev, D)
        if reduce is not None:
            e2, s = reduce(e2), reduce(s)
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
    vx = v / torch.clamp(lanes.norm(v), min=1e-12)
    return TrackerState(px=px, qx=qx, vx=vx)


def _tree_where(cond, a, b):
    """Element-wise select between two NamedTuples of tensors."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


class _PlainLM(NamedTuple):
    """The plain pass's pieces for one level (``_plain_lm``): the
    residuals at a state, the robust energy of residuals, and
    ``lm_pass(it, carry)`` over the carry ``(state, lam, energy, it,
    done)``."""
    residuals: object
    energy_of: object
    lm_pass: object


def _plain_lm(event_frame, cam: Pinhole, norm_coord, grad, idp, weights,
              mask, loss_kind: str, loss_scale, function_tolerance: float,
              norm_event: bool, reduce=None) -> _PlainLM:
    """The torch ops of ``_lm_solve_plain``'s loop, shared with the tests
    that hold the fused route's modes to them. ``loss_scale`` is a
    tensor."""
    dtype = norm_coord.dtype
    dev = norm_coord.device
    maskf = mask.to(dtype)

    def residuals(st):
        return event_residuals(st, event_frame, cam, norm_coord, grad, idp,
                               weights, mask, norm_event=norm_event,
                               reduce=reduce)

    def robust_weights(r):
        if loss_kind == "huber":
            return huber_weight(r, loss_scale)
        if loss_kind == "cauchy":
            return cauchy_weight(r, loss_scale)
        return torch.ones_like(r)

    def energy_of(r):
        return _summed(robust_weights(r) * r * r, reduce)

    eye = torch.eye(12, dtype=dtype, device=dev)

    def lm_pass(_, carry):
        state, lam, energy, it, done = carry
        active = ~done
        r, J = event_residuals_and_jac(state, event_frame, cam, norm_coord,
                                       grad, idp, weights, mask,
                                       norm_event=norm_event, reduce=reduce)
        Jw = J * (robust_weights(r) * maskf)[:, None]
        H = lanes.matmul(Jw.T, J)
        g = lanes.matmul(Jw.T, r)
        if reduce is not None:
            H, g = reduce(H), reduce(g)
        Hl = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye
        delta = -solve(Hl, g)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        new_state = _apply_local(state, delta)
        e_new = energy_of(residuals(new_state))
        accept = e_new < energy
        state = _tree_where(active & accept, new_state, state)
        lam = torch.where(active, torch.clamp(
            torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e5), lam)
        e_next = torch.where(accept, e_new, energy)
        rel = torch.abs(energy - e_next) / torch.clamp(energy, min=1e-12)
        energy = torch.where(active, e_next, energy)
        it = it + active.to(torch.int32)
        done = done | (active & accept & (rel < function_tolerance))
        return state, lam, energy, it, done

    return _PlainLM(residuals, energy_of, lm_pass)


def _loss_tensor(loss_scale, like):
    if torch.is_tensor(loss_scale):
        return loss_scale
    return torch.full((), loss_scale, dtype=like.dtype, device=like.device)


def _fused_route(norm_coord, reduce, gather) -> bool:
    """Whether ``_lm_solve`` takes the ``event_pass`` kernel: a CUDA
    tensor, no collective between the phases of a pass (``reduce``,
    ``gather``) and no ``torch.vmap`` lane axis."""
    return (norm_coord.is_cuda and reduce is None and gather is None
            and not torch._C._are_functorch_transforms_active())


def _lm_solve(state: TrackerState, event_frame, cam: Pinhole,
              norm_coord, grad, idp, weights, mask,
              max_iterations: int, loss_kind: str, loss_scale,
              function_tolerance: float, norm_event: bool,
              reduce=None, gather=None) -> TrackerResult:
    """LM loop shared by ``optimize``, ``_pyramid_fused`` and
    ``parallel.sharded_event_tracker.optimize_sharded``: JAX's
    ``lax.while_loop`` over ``(state, lam, energy, it, done)`` as
    ``graphs.while_loop`` with the cap ``max_iterations``. A pass updates
    the carry only while ``~done`` (``it < max_iterations`` holds on every
    pass), so the result, ``n_iter`` included, is the early-exit loop's:
    the passes after ``done`` select the carry they were given, and a
    captured loop skips them. Nothing is read back to the host.

    The route follows from what the call is: CUDA tensors of one unsharded
    solve outside ``torch.vmap`` run ``_lm_solve_fused`` (a pass is one
    launch of the ``event_pass`` kernel); everything else, CPU tensors,
    ``torch.vmap`` lanes (``eval.batched_event_solves``) and the sharded
    solve (``reduce`` / ``gather``, whose collectives fall between the
    phases of a pass), runs ``_lm_solve_plain``."""
    if _fused_route(norm_coord, reduce, gather):
        return _lm_solve_fused(state, event_frame, cam, norm_coord, grad,
                               idp, weights, mask, max_iterations, loss_kind,
                               loss_scale, function_tolerance, norm_event)
    return _lm_solve_plain(state, event_frame, cam, norm_coord, grad, idp,
                           weights, mask, max_iterations, loss_kind,
                           loss_scale, function_tolerance, norm_event,
                           reduce, gather)


def _lm_solve_plain(state: TrackerState, event_frame, cam: Pinhole,
                    norm_coord, grad, idp, weights, mask,
                    max_iterations: int, loss_kind: str, loss_scale,
                    function_tolerance: float, norm_event: bool,
                    reduce=None, gather=None) -> TrackerResult:
    """``_lm_solve`` in torch ops on any device (the ``event_pass``
    kernel's plain version).

    With the points split over ranks, ``reduce`` sums a tensor over the
    ranks (the norms, the [12, 12] system and the energies, so the LM
    control and ``done`` are the same on every rank) and ``gather``
    concatenates each rank's [P/n] block in rank order (the residuals and
    the mask for one global MAD); the returned residuals are the rank's
    own."""
    dtype = norm_coord.dtype
    dev = norm_coord.device
    loss_scale = _loss_tensor(loss_scale, norm_coord)
    lm = _plain_lm(event_frame, cam, norm_coord, grad, idp, weights, mask,
                   loss_kind, loss_scale, function_tolerance, norm_event,
                   reduce)
    carry = (state, torch.full((), 1e-4, dtype=dtype, device=dev),
             lm.energy_of(lm.residuals(state)),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    state, _, energy, it, _ = graphs.while_loop(
        lambda c: c[4], lm.lm_pass, carry, max_iterations)

    r_final = lm.residuals(state)
    # MAD re-estimation of the robust scale for the next solve
    if gather is None:
        mad, _ = masked_mad(r_final, mask)
    else:
        mad, _ = masked_mad(gather(r_final), gather(mask))
    return TrackerResult(state=state, residuals=r_final, energy=energy,
                         n_iter=it,
                         loss_scale=torch.clamp(HUBER_K * mad, min=1e-6))


def _lm_solve_fused(state: TrackerState, event_frame, cam: Pinhole,
                    norm_coord, grad, idp, weights, mask,
                    max_iterations: int, loss_kind: str, loss_scale,
                    function_tolerance: float,
                    norm_event: bool) -> TrackerResult:
    """``_lm_solve`` by the ``event_pass`` kernel: one launch for the start
    energy, one an LM pass (a captured pass is it and the pass tail), one
    for the final residuals; the MAD in torch ops. The carry is
    (``ep.STATE`` floats: px, qx, vx, lambda, energy; the pass count;
    done)."""
    f32 = torch.float32
    lvl = ep.Level(event_frame.contiguous(), cam, norm_coord.contiguous(),
                   grad.contiguous(), idp.contiguous(), weights.contiguous(),
                   mask.contiguous(),
                   loss_kind, _loss_tensor(loss_scale, norm_coord).to(f32),
                   function_tolerance, norm_event)
    start = tuple(x.contiguous() for x in state)
    carry = graphs.while_loop(lambda c: c[2],
                              lambda _, c: lvl.run("lm", carry=c),
                              lvl.run("init", start), max_iterations)
    f, it, _ = carry
    r_final = lvl.run("final", carry=carry)
    mad, _ = masked_mad(r_final, mask)
    return TrackerResult(
        state=TrackerState(px=f[ep.S_PX:ep.S_QX], qx=f[ep.S_QX:ep.S_VX],
                           vx=f[ep.S_VX:ep.S_LAM]),
        residuals=r_final, energy=f[ep.S_E], n_iter=it,
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
                   norm_event: bool) -> TrackerResult:
    """Coarse-to-fine solve over all levels (stored fine-first), chaining the
    pose state and the MAD loss scale; the function tolerance is fixed at
    1e-6 as in the JAX module. Returns the finest level's result.

    ``iters_per_level`` is a sequence of Python ints, one cap per level. JAX
    traces it as data and scans the levels, each ``while_loop`` bounded by
    its traced cap; here each level runs its own cap's count of masked
    passes, so the caps are static: they fix the shape of the captured
    program and key its graph, as the level count does."""
    scale = loss_scale
    for lvl in reversed(range(event_frames.shape[0])):
        res = _lm_solve(state, event_frames[lvl], cam, norm_coord, grad,
                        idp, weights, mask, iters_per_level[lvl],
                        loss_kind, scale, 1e-6, norm_event)
        state, scale = res.state, res.loss_scale
    return res


def optimize_pyramid(state: TrackerState, event_frames, cam: Pinhole,
                     norm_coord, grad, idp, weights, mask,
                     iterations_per_level, loss_kind: str = "huber",
                     loss_scale=0.2, norm_event: bool = False):
    """Coarse-to-fine over the event-frame levels, with the per-level
    iteration caps (the last entry repeats for deeper levels)."""
    n = len(iterations_per_level)
    its = [int(iterations_per_level[min(lvl, n - 1)])
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


# ---------------------------------------------------------------------------
# Track refinement (Tracker::trackPoints / trackPointsPyr /
# trackPointsAlongEpiline), batched over points.
# ---------------------------------------------------------------------------

def _splat(uv, values, mask, height: int, width: int):
    """Bilinear splat of per-point values at uv [P, 2] into [H, W]; masked
    lanes add nothing (their value is zeroed ahead of the kernel, their
    coordinate may be anything)."""
    return scatter_accumulate(uv[:, 0].contiguous(), uv[:, 1].contiguous(),
                              values.contiguous(), height, width, mask=mask,
                              method="bilinear")


def _splat_gradient_images(uv, grad, mask, height: int, width: int):
    """Rasterize the per-point keyframe gradient values at the warped
    coordinates. Returns (gx_img, gy_img)."""
    return (_splat(uv, grad[:, 0], mask, height, width),
            _splat(uv, grad[:, 1], mask, height, width))


def _klt_flow_from_patches(gx_p, gy_p, ev_p, min_strength: float = 1e-6,
                           rank_ratio: float = 1e-3):
    """One Lucas-Kanade normal-equation solve per point with the event frame
    as the temporal derivative: f = -M^+ b, M = [sum IxIx, sum IxIy; .,
    sum IyIy], b = [sum Ix It, sum Iy It]; patch axes [P, K].

    The 2x2 symmetric pseudo-inverse, by eigendecomposition: a patch with a
    single splatted point has a rank-1 structure tensor, for which this gives
    the minimal-norm solution (the normal flow along the gradient)."""
    Mxx = torch.sum(gx_p * gx_p, -1)
    Mxy = torch.sum(gx_p * gy_p, -1)
    Myy = torch.sum(gy_p * gy_p, -1)
    b = torch.stack([torch.sum(gx_p * ev_p, -1),
                     torch.sum(gy_p * ev_p, -1)], -1)
    tr = Mxx + Myy
    disc = torch.sqrt(torch.clamp((Mxx - Myy) ** 2 + 4.0 * Mxy * Mxy, min=0.0))
    lam1 = 0.5 * (tr + disc)
    lam2 = torch.clamp(0.5 * (tr - disc), min=0.0)
    # principal eigenvector by the better-conditioned of two formulas
    v1a = torch.stack([lam1 - Myy, Mxy], -1)
    v1b = torch.stack([Mxy, lam1 - Mxx], -1)
    use_a = torch.abs(lam1 - Myy) >= torch.abs(lam1 - Mxx)
    v1 = torch.where(use_a[:, None], v1a, v1b)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True),
                          min=1e-20)
    v2 = torch.stack([-v1[:, 1], v1[:, 0]], -1)
    zero = torch.zeros_like(lam1)
    ok = lam1 > min_strength
    c1 = torch.where(ok, torch.sum(v1 * b, -1) / torch.clamp(lam1, min=1e-20),
                     zero)
    c2 = torch.where(lam2 > rank_ratio * lam1,
                     torch.sum(v2 * b, -1) / torch.clamp(lam2, min=1e-20),
                     zero)
    return -(c1[:, None] * v1 + c2[:, None] * v2), ok


def refine_tracks_klt(event_frame, uv_warped, grad, mask,
                      patch_radius: int = 3, num_levels: int = 1):
    """Refine warped tracks by per-point event-based KLT (pyramidal when
    num_levels > 1): the keyframe's per-point gradients are splatted at the
    warped coordinates; a patch of those and of the event frame around each
    warped point feeds one LK solve whose flow is the track increment,
    accumulated coarse to fine with a 1/scale^2 weighting.

    Returns (delta [P, 2], ok [P]); points without a solvable system get
    delta 0."""
    H, W = event_frame.shape
    gx_img, gy_img = _splat_gradient_images(uv_warped, grad, mask, H, W)
    dx, dy = kltmod._patch_grid(patch_radius, uv_warped.dtype,
                                uv_warped.device)
    delta = torch.zeros_like(uv_warped)
    ok_all = torch.zeros_like(mask)
    for lvl in range(num_levels - 1, -1, -1):
        scale = float(2 ** lvl)
        # the full-resolution images sampled with 2^l spacing
        xs = uv_warped[:, 0:1] + scale * dx[None, :]
        ys = uv_warped[:, 1:2] + scale * dy[None, :]
        f, ok = _klt_flow_from_patches(bilinear(gx_img, xs, ys),
                                       bilinear(gy_img, xs, ys),
                                       bilinear(event_frame, xs, ys))
        delta = delta + f / (scale * scale)
        ok_all = ok_all | ok
    # one LK step on a sparse splat can shoot far on a near-degenerate system
    delta = torch.clamp(delta, -2.0 * patch_radius, 2.0 * patch_radius)
    ok_all = mask & ok_all
    return torch.where(ok_all[:, None], delta, torch.zeros_like(delta)), ok_all


def refine_tracks_model_klt(event_frame, uv_warped, model, mask,
                            patch_radius: int = 3, iterations: int = 4,
                            max_delta: float = 3.0):
    """Inverse-compositional LK between the rasterized brightness-change
    model image and the event frame: the model, normalized like the event
    frame, is splatted at the warped positions, so the LK solution is the
    geometric offset in pixels whatever either normalization.

    model: [P] normalized sparse model values. Returns (delta [P, 2],
    ok [P])."""
    H, W = event_frame.shape
    model_img = _splat(uv_warped, model, mask, H, W)
    uv_new, ok, _ = kltmod.klt_track(model_img, event_frame, uv_warped,
                                     radius=patch_radius,
                                     iterations=iterations)
    delta = torch.clamp(uv_new - uv_warped, -max_delta, max_delta)
    ok = ok & mask
    return torch.where(ok[:, None], delta, torch.zeros_like(delta)), ok


def refine_tracks_epiline(event_frame, kf_uv, uv_warped, model, mask,
                          T_kf_ef: SE3, cam: Pinhole,
                          patch_radius: int = 3, search_range: float = 6.0,
                          num_steps: int = 25,
                          consistency_px: float = 5.0):
    """Epipolar template search: each point's patch of the rasterized model
    is searched along its epipolar line in the event frame with two
    similarity measures (zssd, zncc); points where the two matches differ
    by more than ``consistency_px`` (in the norm of the matched position)
    are flagged dead. Returns (uv_refined [P, 2], alive [P])."""
    H, W = event_frame.shape
    model_img = _splat(kf_uv, model, mask, H, W)
    K = cam.K(kf_uv.dtype, device=kf_uv.device)
    F = kltmod.fundamental_from_pose(T_kf_ef.inverse(), K)
    d = kltmod.epiline_directions(F, kf_uv)
    found = [kltmod.search_along_epiline(
        model_img, event_frame, uv_warped, d, search_range,
        radius=patch_radius, num_steps=num_steps, measure=measure,
        uv_tpl=kf_uv)[0] for measure in ("zssd", "zncc")]
    uv_ssd, uv_ncc = found
    dis = torch.abs(torch.linalg.vector_norm(uv_ssd, dim=-1)
                    - torch.linalg.vector_norm(uv_ncc, dim=-1))
    alive = mask & (dis <= consistency_px)
    return torch.where(alive[:, None], uv_ssd, uv_warped), alive
