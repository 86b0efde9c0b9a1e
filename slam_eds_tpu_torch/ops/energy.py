"""Sliding-window photometric bundle adjustment — port of
``slam_eds_tpu.ops.energy`` (DSO's EnergyFunctional stack as dense masked
tensor algebra: ``linearize`` -> ``assemble`` -> ``solve_delta`` ->
``apply_step``, plus FEJ point/frame marginalization).

Differences from the JAX module are of form only:

* ``_host_select`` one-hot dots become index gathers ``table[p_host]``;
* the tap sampler is ``ops.kernels.pattern_sample.sample`` (the CUDA
  kernel for a CUDA tensor, the plain torch gather for a CPU tensor; under
  ``torch.vmap`` the kernel's lane axis, through the sampler's operator);
* ``ba_iterate``'s ``lax.while_loop`` (``break_tol > 0``) is a
  ``graphs.while_loop`` of GN passes carrying the same ``done`` flag, so
  the loop reads nothing back to the host: captured in a CUDA graph it ends
  at the stop (a WHILE node), eagerly (the CPU, ``torch.vmap`` in
  ``eval.batched_ba_windows``, the sharded BA) every pass runs masked;
* ``orthogonalize`` solves its 7x7 Gram system with LU where JAX uses a
  Cholesky factorization: the same projector on a well-conditioned gauge
  basis, finite on a rank-deficient one.

The reduced solve keeps LU, as the JAX code does (the docs say Cholesky).
Both go through ``utils.linalg.solve`` (``torch.linalg.solve_ex``'s LU,
in a form a conditional node of a captured graph holds) and check nothing,
so no host read; a singular system gives non-finite entries, as in JAX. Every block
is assembled with ``torch.cat``/``torch.where`` instead of writes into a
zeroed tensor, so ``torch.vmap`` carries the whole GN loop
(``eval.batched_ba_windows``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..models.ba_state import BAState, CPARS, PT_ACTIVE, PT_MARGINALIZE
from ..utils.lie import SE3
from ..utils.linalg import solve
from ..utils.image import PATTERN_DSO8
from .kernels.pattern_sample import sample


def _hosts(state: BAState):
    return state.p_host.long()


def _pattern_offsets(dtype, device):
    """PATTERN_DSO8 [K, 2] on ``device``, uploaded once per device and type
    (a host-to-device copy cannot run inside a captured program)."""
    key = (dtype, str(device))
    offs = _PATTERN_CACHE.get(key)
    if offs is None:
        offs = torch.as_tensor(PATTERN_DSO8, dtype=dtype, device=device)
        _PATTERN_CACHE[key] = offs
    return offs


_PATTERN_CACHE = {}


def _one_hot(idx, n: int, dtype):
    """one_hot(idx, n) as a comparison: no range check (a host read on a
    card), and mappable by ``torch.vmap``."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _block_diag_pairs(diag_blocks, F: int):
    """[F, F, a, b] with ``diag_blocks[f]`` on the pair diagonal, 0 off it."""
    eye = torch.eye(F, dtype=torch.bool, device=diag_blocks.device)
    return torch.where(eye[:, :, None, None], diag_blocks[:, None],
                       torch.zeros((), dtype=diag_blocks.dtype,
                                   device=diag_blocks.device))


class Linearization(NamedTuple):
    res: torch.Tensor     # [P, F, K]
    JIdx: torch.Tensor    # [P, F, K, 2]
    Jab: torch.Tensor     # [P, F, K, 2]
    Jpdxi: torch.Tensor   # [P, F, 2, 6]
    Jpdc: torch.Tensor    # [P, F, 2, 4]
    Jpdd: torch.Tensor    # [P, F, 2]
    valid: torch.Tensor   # [P, F]
    oob: torch.Tensor     # [P, F]
    energy: torch.Tensor  # [P, F]


def relative_affine(state: BAState, use_zero: bool):
    """a_rel[h, t], b_rel[h, t] (AffLight::fromToVecExposure batched)."""
    aff = state.aff_eval if use_zero else state.current_aff()
    a = aff[:, 0]
    b = aff[:, 1]
    e = state.exposure
    a_rel = torch.exp(a[None, :] - a[:, None]) * (e[None, :] / e[:, None])
    b_rel = b[None, :] - a_rel * b[:, None]
    return a_rel, b_rel


def _pairs(T: SE3) -> SE3:
    """T_th = T_t o T_h^-1 for every (host h, target t): [F_h, F_t]."""
    Th_inv = T.inverse()
    Th = SE3(Th_inv.R[:, None], Th_inv.t[:, None])
    Tt = SE3(T.R[None, :], T.t[None, :])
    return Tt.compose(Th)


def pair_adjoints(state: BAState):
    """AH/AT [F, F, 8, 8] at the FEJ point (setAdjointsF)."""
    F = state.num_frames
    dt, dev = state.delta.dtype, state.delta.device
    adj = _pairs(state.T_eval).adjoint()                 # [F, F, 6, 6]
    a_rel0, _ = relative_affine(state, use_zero=True)    # [F, F]
    z62 = torch.zeros((F, F, 6, 2), dtype=dt, device=dev)
    z26 = torch.zeros((F, F, 2, 6), dtype=dt, device=dev)
    zero = torch.zeros_like(a_rel0)
    ab_h = torch.stack([torch.stack([a_rel0, zero], -1),
                        torch.stack([zero, a_rel0], -1)], -2)
    ab_t = torch.stack([torch.stack([-a_rel0, zero], -1),
                        torch.stack([zero, torch.full_like(a_rel0, -1.0)],
                                    -1)], -2)
    eye6 = torch.eye(6, dtype=dt, device=dev).expand(F, F, 6, 6)
    AH = torch.cat([torch.cat([-adj, z62], -1),
                    torch.cat([z26, ab_h], -1)], -2)
    AT = torch.cat([torch.cat([eye6, z62], -1),
                    torch.cat([z26, ab_t], -1)], -2)
    return AH, AT


def _relative_poses(state: BAState, current: bool):
    T = _pairs(state.current_poses() if current else state.T_eval)
    return T.R, T.t


def linearize(state: BAState, target_images, height: int, width: int,
              huber_th: float = 9.0, outlier_th: float = 144.0,
              outlier_th_sum: float = 2500.0) -> Linearization:
    """Batched PointFrameResidual::linearize over all (point, target) pairs.
    target_images: [F, H, W] intensities (the window's planar plane) or
    [F, H, W, 3] stacks (I, gx, gy), of which channel 0 is read."""
    P = state.num_points
    F = state.num_frames
    K = PATTERN_DSO8.shape[0]
    dtype, dev = state.p_uv.dtype, state.p_uv.device

    calib = state.current_calib()
    fx, fy, cx, cy = calib[0], calib[1], calib[2], calib[3]
    R0, t0 = _relative_poses(state, current=False)
    Rc, tc = _relative_poses(state, current=True)
    a_rel, b_rel = relative_affine(state, use_zero=False)

    host = _hosts(state)
    R0_p, t0_p = R0[host], t0[host]         # [P, F, 3, 3], [P, F, 3]
    Rc_p, tc_p = Rc[host], tc[host]
    a_rel_p, b_rel_p = a_rel[host], b_rel[host]   # [P, F]
    b0_p = state.aff_eval[:, 1][host]             # [P]

    u_pt = state.p_uv[:, 0]
    v_pt = state.p_uv[:, 1]
    KliP = torch.stack([(u_pt - cx) / fx, (v_pt - cy) / fy,
                        torch.ones_like(u_pt)], -1)          # [P, 3]

    # ---- FEJ center projection + geometric jacobians
    ptp0 = torch.einsum("pfij,pj->pfi", R0_p, KliP) \
        + t0_p * state.p_idepth_zero[:, None, None]
    drescale = 1.0 / torch.clamp(ptp0[..., 2], min=1e-12)
    pos_z0 = ptp0[..., 2] > 1e-6
    u = ptp0[..., 0] * drescale
    v = ptp0[..., 1] * drescale
    Ku0 = u * fx + cx
    Kv0 = v * fy + cy
    new_idepth = state.p_idepth_zero[:, None] * drescale
    center_ok = pos_z0 & (Ku0 > 1.1) & (Kv0 > 1.1) \
        & (Ku0 < width - 3) & (Kv0 < height - 3)

    d_d_x = drescale * (t0_p[..., 0] - t0_p[..., 2] * u) * fx
    d_d_y = drescale * (t0_p[..., 1] - t0_p[..., 2] * v) * fy
    Jpdd = torch.stack([d_d_x, d_d_y], -1)

    R00 = R0_p[..., 0, 0]
    R01 = R0_p[..., 0, 1]
    R10 = R0_p[..., 1, 0]
    R11 = R0_p[..., 1, 1]
    R20 = R0_p[..., 2, 0]
    R21 = R0_p[..., 2, 1]
    dcx2 = drescale * (R20 * u - R00)
    dcx3 = fx * drescale * (R21 * u - R01) / fy
    dcy2 = fy * drescale * (R20 * v - R10) / fx
    dcy3 = drescale * (R21 * v - R11)
    k0 = KliP[:, None, 0]
    k1 = KliP[:, None, 1]
    Jpdc = torch.stack([
        torch.stack([k0 * dcx2 + u, k1 * dcx3, dcx2 + 1.0, dcx3], -1),
        torch.stack([k0 * dcy2, k1 * dcy3 + v, dcy2, dcy3 + 1.0], -1),
    ], -2)

    zero = torch.zeros_like(u)
    Jpdxi = torch.stack([
        torch.stack([new_idepth * fx, zero, -new_idepth * u * fx,
                     -u * v * fx, (1 + u * u) * fx, -v * fx], -1),
        torch.stack([zero, new_idepth * fy, -new_idepth * v * fy,
                     -(1 + v * v) * fy, u * v * fy, u * fy], -1),
    ], -2)

    # ---- pattern projection at the current state
    offs = _pattern_offsets(dtype, dev)
    pat = torch.stack([(u_pt[:, None] + offs[None, :, 0] - cx) / fx,
                       (v_pt[:, None] + offs[None, :, 1] - cy) / fy,
                       torch.ones((P, K), dtype=dtype, device=dev)], -1)
    ptp = torch.einsum("pfij,pkj->pfki", Rc_p, pat) \
        + tc_p[:, :, None, :] * state.p_idepth[:, None, None, None]
    inv_z = 1.0 / torch.clamp(ptp[..., 2], min=1e-12)
    Ku = ptp[..., 0] * inv_z * fx + cx
    Kv = ptp[..., 1] * inv_z * fy + cy
    pat_ok = (ptp[..., 2] > 1e-6) & (Ku > 1.1) & (Kv > 1.1) \
        & (Ku < width - 3) & (Kv < height - 3)

    I_t, gx, gy, in_tile = sample(target_images, Ku.contiguous(),
                                  Kv.contiguous())

    color = state.p_color[:, None, :]
    residual = I_t - (a_rel_p[..., None] * color + b_rel_p[..., None])
    finite = in_tile & torch.isfinite(I_t)
    drdA = color - b0_p[:, None, None]
    w_grad = torch.sqrt(torch.full((), outlier_th_sum, dtype=dtype,
                                   device=dev)
                        / (outlier_th_sum + gx * gx + gy * gy))
    w = 0.5 * (w_grad + state.p_weight[:, None, :])
    abs_r = torch.abs(residual)
    hw_e = torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                       torch.full((), huber_th, dtype=dtype, device=dev)
                       / torch.clamp(abs_r, min=1e-12))
    energy_k = w * w * hw_e * residual * residual * (2.0 - hw_e)
    hw = torch.where(hw_e < 1.0, torch.sqrt(hw_e), hw_e) * w

    resF = residual * hw
    JIdx = torch.stack([gx * hw, gy * hw], -1)
    Jab = torch.stack([drdA * hw, hw], -1)

    # ---- validity & outlier gating
    not_host = torch.arange(F, device=dev)[None, :] != host[:, None]
    struct = state.r_active & (state.p_status[:, None] != 0) \
        & state.frame_valid[None, :] & not_host
    tap_ok = pat_ok & finite
    oob = struct & (~center_ok | ~torch.all(tap_ok, -1))
    usable = struct & ~oob

    zf = torch.zeros((), dtype=dtype, device=dev)
    energy = torch.sum(torch.where(tap_ok, energy_k, zf), -1)
    wJI2 = torch.sum(hw * hw * (gx * gx + gy * gy) * tap_ok.to(dtype), -1)
    th = torch.maximum(state.frame_energy_th[host][:, None],
                       state.frame_energy_th[None, :])
    outlier = usable & ((energy > th) | (wJI2 < 2.0))
    valid = usable & ~outlier

    vz = valid[..., None]
    return Linearization(
        res=torch.where(vz, resF, zf),
        JIdx=torch.where(vz[..., None], JIdx, zf),
        Jab=torch.where(vz[..., None], Jab, zf),
        Jpdxi=torch.where(vz[..., None], Jpdxi, zf),
        Jpdc=torch.where(vz[..., None], Jpdc, zf),
        Jpdd=torch.where(vz, Jpdd, zf),
        valid=valid, oob=oob,
        energy=torch.where(usable, energy, zf))


class Assembled(NamedTuple):
    H: torch.Tensor     # [D, D]
    b: torch.Tensor     # [D]
    Hdd: torch.Tensor   # [P]
    bd: torch.Tensor    # [P]
    V: torch.Tensor     # [P, D]


def assemble(state: BAState, lin: Linearization, point_mask=None,
             residual_override=None) -> Assembled:
    """Accumulate the global system: per-(point, frame) 14x14 Gram blocks
    Q = q^T q with q = [Jrel(8) | Jcalib(4) | Jd(1) | res(1)], summed per
    (host, target) pair before the adjoint transforms."""
    P, F = lin.valid.shape
    D = state.dim
    dtype, dev = lin.res.dtype, lin.res.device
    zf = torch.zeros((), dtype=dtype, device=dev)
    res = lin.res if residual_override is None else residual_override
    if point_mask is not None:
        pm = point_mask[:, None]
        res = torch.where(pm[..., None], res, zf)
        vmask = lin.valid & pm
    else:
        vmask = lin.valid

    AH, AT = pair_adjoints(state)
    oh = _one_hot(_hosts(state), F, dtype)             # [P, F_h]

    Jrel_pose = torch.einsum("pfkg,pfgx->pfkx", lin.JIdx, lin.Jpdxi)
    calib4 = torch.einsum("pfkg,pfgc->pfkc", lin.JIdx, lin.Jpdc)
    Jd = torch.einsum("pfkg,pfg->pfk", lin.JIdx, lin.Jpdd)
    q = torch.cat([Jrel_pose, lin.Jab, calib4, Jd[..., None],
                   res[..., None]], -1)
    q = q * vmask[:, :, None, None].to(dtype)
    Q = torch.einsum("pfka,pfkb->pfab", q, q)          # [P, F, 14, 14]

    J, C, d, r = slice(0, 8), slice(8, 12), 12, 13

    # host-grouped pair blocks: one reduction over the point axis (a one-hot
    # contraction, so the summation order is fixed on every device)
    QH = torch.einsum("pfab,ph->hfab", Q, oh)          # [F_h, F_t, 14, 14]
    GJJ = QH[..., J, J]
    GCJ = QH[..., C, J]
    GJr = QH[..., J, r]

    H_hh = torch.einsum("hfxa,hfxy,hfyb->hab", AH, GJJ, AH)
    H_tt = torch.einsum("hfxa,hfxy,hfyb->fab", AT, GJJ, AT)
    H_ht = torch.einsum("hfxa,hfxy,hfyb->hfab", AH, GJJ, AT)
    Hff = _block_diag_pairs(H_hh + H_tt, F)
    Hff = Hff + H_ht + H_ht.transpose(0, 1).transpose(2, 3)

    H_cc = torch.einsum("hfab->ab", QH[..., C, C])
    H_ch = torch.einsum("hfax,hfxb->hab", GCJ, AH)
    H_ct = torch.einsum("hfax,hfxb->fab", GCJ, AT)
    H_cf = H_ch + H_ct

    b_c = torch.einsum("hfa->a", QH[..., C, r])
    b_h = torch.einsum("hfx,hfxa->ha", GJr, AH)
    b_t = torch.einsum("hfx,hfxa->fa", GJr, AT)
    b_f = b_h + b_t

    H_cf_flat = H_cf.permute(1, 0, 2).reshape(CPARS, 8 * F)
    H = torch.cat([
        torch.cat([H_cc, H_cf_flat], 1),
        torch.cat([H_cf_flat.T,
                   Hff.permute(0, 2, 1, 3).reshape(8 * F, 8 * F)], 1)], 0)
    b = torch.cat([b_c, b_f.reshape(8 * F)])

    # point Schur pieces
    QJd = Q[..., J, d]
    Hdd = torch.sum(Q[..., d, d], 1)
    bd = torch.sum(Q[..., d, r], 1)
    V_c = torch.einsum("pfa->pa", Q[..., C, d])
    V_h = torch.einsum("pfx,ph,hfxa->pa", QJd, oh, AH)
    V_t = torch.einsum("pfx,ph,hfxa->pfa", QJd, oh, AT)
    V_f = V_t + V_h[:, None, :] * oh[:, :, None]
    V = torch.cat([V_c, V_f.reshape(P, 8 * F)], -1)

    dF = state.p_idepth - state.p_idepth_zero
    Hdd = Hdd + state.p_prior
    bd = bd + state.p_prior * dF
    return Assembled(H, b, Hdd, bd, V)


def stitched_delta(state: BAState):
    return torch.cat([state.c_delta, state.delta.reshape(-1)])


def nullspaces(state: BAState):
    """Gauge nullspace N [D, 7]: 6 global rigid motions + scale, unit
    columns, zero on calib/affine rows."""
    F = state.num_frames
    dtype, dev = state.delta.dtype, state.delta.device
    T = state.current_poses()
    A = T.adjoint()                                       # [F, 6, 6]
    scale_col = torch.cat([T.t, torch.zeros_like(T.t)], -1)   # [F, 6]
    cols = torch.cat([-A, scale_col[..., None]], -1)     # [F, 6, 7]
    cols = torch.where(state.frame_valid[:, None, None], cols,
                       torch.zeros((), dtype=dtype, device=dev))
    N = torch.cat([cols, torch.zeros((F, 2, 7), dtype=dtype, device=dev)],
                  1)
    N = torch.cat([torch.zeros((CPARS, 7), dtype=dtype, device=dev),
                   N.reshape(8 * F, 7)], 0)
    norms = torch.linalg.vector_norm(N, dim=0)
    return N / torch.clamp(norms, min=1e-12)[None, :]


def orthogonalize(x, N):
    """Project x off span(N): x - N (N^T N + eps I)^-1 N^T x (7x7 LU)."""
    G = N.T @ N + 1e-10 * torch.eye(N.shape[1], dtype=x.dtype,
                                    device=x.device)
    return x - N @ solve(G, N.T @ x)


class SolveResult(NamedTuple):
    x: torch.Tensor           # [D]
    point_step: torch.Tensor  # [P]
    H_final: torch.Tensor
    b_final: torch.Tensor


def solve_delta(state: BAState, asm: Assembled, lam: float = 1e-5,
                use_orth=True, reduce=None) -> SolveResult:
    """Damped Schur solve with the marginalization and frame/calib priors;
    back-substitutes the per-point idepth steps (solveSystemF +
    resubstituteF, FIX_LAMBDA).

    use_orth: the gauge projection, a Python bool or a bool tensor (the GN
    loop's predicate on its device pass index, ORTHOGONALIZE_X_LATER),
    which selects the projected step (JAX ``jnp.where``): the same bits.

    reduce: with the point axis split over ranks (``parallel.sharded_ba``),
    a callable that sums a tensor over the ranks; the point-partial H, b and
    Schur terms go through it (JAX ``axis_name``), so the solve runs
    replicated and each rank back-substitutes its own points. Frame state
    and priors must be replicated."""
    D = state.dim
    F = state.num_frames
    dtype, dev = asm.H.dtype, asm.H.device
    zf = torch.zeros((), dtype=dtype, device=dev)
    H, b = asm.H, asm.b
    if reduce is not None:
        H, b = reduce(H), reduce(b)
    c_prior = 5e9 * (state.c_zero > 0).to(dtype)
    H = H + torch.diag(torch.cat([c_prior,
                                  torch.zeros(8 * F, dtype=dtype,
                                              device=dev)]))
    b = torch.cat([b[:CPARS] + c_prior * state.c_delta, b[CPARS:]])

    fp = state.frame_prior * state.frame_valid[:, None].to(dtype)
    H = H + torch.diag(torch.cat([torch.zeros(CPARS, dtype=dtype,
                                              device=dev), fp.reshape(-1)]))
    dp = state.delta - state.frame_prior_delta0
    b = torch.cat([b[:CPARS], b[CPARS:] + (fp * dp).reshape(-1)])

    H = H + state.HM
    b = b + state.bM + state.HM @ stitched_delta(state)

    active_pt = (state.p_status == PT_ACTIVE) & (asm.Hdd > 1e-10)
    Hdd_l = torch.where(active_pt, asm.Hdd * (1.0 + lam),
                        torch.ones_like(asm.Hdd))
    Vw = asm.V * (active_pt.to(dtype) / Hdd_l)[:, None]
    H_sc = Vw.T @ asm.V
    b_sc = Vw.T @ asm.bd
    if reduce is not None:
        H_sc, b_sc = reduce(H_sc), reduce(b_sc)

    H_f = H + lam * torch.diag(torch.diagonal(H)) - H_sc
    b_f = b - b_sc

    slot_active = torch.cat([torch.ones(CPARS, dtype=torch.bool, device=dev),
                             state.frame_valid.repeat_interleave(8)])
    diag_ok = torch.abs(torch.diagonal(H_f)) > 1e-10
    act = slot_active & diag_ok
    H_f = torch.where(act[:, None] & act[None, :], H_f, zf)
    H_f = H_f + torch.diag(torch.where(act, zf, torch.ones_like(zf)))

    svec_i = 1.0 / torch.sqrt(torch.abs(torch.diagonal(H_f)) + 10.0)
    Hs = H_f * svec_i[:, None] * svec_i[None, :]
    bs = b_f * svec_i
    x = svec_i * solve(
        Hs + 1e-10 * torch.eye(D, dtype=dtype, device=dev), bs)
    x = torch.where(act, x, zf)

    if torch.is_tensor(use_orth):
        x = torch.where(use_orth, orthogonalize(x, nullspaces(state)), x)
    elif use_orth:
        x = orthogonalize(x, nullspaces(state))

    step_d = torch.where(active_pt, (asm.V @ x - asm.bd) / Hdd_l, zf)
    return SolveResult(x=x, point_step=step_d, H_final=H_f, b_final=b_f)


def apply_step(state: BAState, sol: SolveResult,
               step_scale: float = 1.0) -> BAState:
    """Frame/calib/point updates: frame step = -x; idepth kept positive."""
    F = state.num_frames
    xc = -sol.x[:CPARS] * step_scale
    xf = -sol.x[CPARS:].reshape(F, 8) * step_scale
    new_delta = state.delta + xf * state.frame_valid[:, None].to(xf.dtype)
    new_idepth = torch.clamp(state.p_idepth + sol.point_step * step_scale,
                             min=1e-5)
    return state._replace(delta=new_delta, c_delta=state.c_delta + xc,
                          p_idepth=new_idepth)


def ba_iterate(state: BAState, target_images, height: int, width: int,
               iterations: int = 6, lam: float = 1e-5,
               huber_th: float = 9.0, outlier_th_sum: float = 2500.0,
               orth_from_iteration: int = 2,
               min_iterations: int = 1, break_tol: float = 0.0,
               final_linearize: bool = True):
    """GN iterations (FIX_LAMBDA + forceAcceptStep). Returns
    (state, final_energy, lin) — with ``final_linearize=False``
    (state, last pre-step energy, None).

    break_tol > 0 stops between min_iterations and iterations once the
    relative energy improvement falls below break_tol, as JAX's
    ``while_loop``: a ``graphs.while_loop`` whose passes after the stop
    select the state and energy they were given (eagerly every pass runs;
    captured, the loop ends at the stop), so nothing is read back to the
    host. Its pass index is a device scalar, as in JAX: the gauge
    projection from ``orth_from_iteration`` on and the stop from
    ``min_iterations`` on are predicates on it."""
    def gn(it, st):
        lin = linearize(st, target_images, height, width,
                        huber_th=huber_th, outlier_th_sum=outlier_th_sum)
        asm = assemble(st, lin)
        sol = solve_delta(st, asm, lam=lam,
                          use_orth=(it >= orth_from_iteration))
        return apply_step(st, sol), torch.sum(lin.energy)

    dev = state.delta.device
    e_last = torch.full((), float("inf"), device=dev)
    if break_tol <= 0.0:
        for it in range(iterations):
            state, e_last = gn(it, state)
    else:
        def gn_pass(it, carry):
            delta, c_delta, p_idepth, e_last, done = carry
            st = state._replace(delta=delta, c_delta=c_delta,
                                p_idepth=p_idepth)
            new_state, e = gn(it, st)
            active = ~done
            rel = torch.abs(e_last - e) / torch.clamp(e_last, min=1e-12)
            done = done | (active & (rel < break_tol) & torch.isfinite(e)
                           & (it + 1 >= min_iterations))
            return (*(torch.where(active, getattr(new_state, k),
                                  getattr(st, k))
                      for k in ("delta", "c_delta", "p_idepth")),
                    torch.where(active, e, e_last), done)

        delta, c_delta, p_idepth, e_last, _ = graphs.while_loop(
            lambda c: c[4], gn_pass,
            (state.delta, state.c_delta, state.p_idepth, e_last,
             torch.zeros((), dtype=torch.bool, device=dev)), iterations)
        state = state._replace(delta=delta, c_delta=c_delta,
                               p_idepth=p_idepth)

    if not final_linearize:
        return state, e_last, None
    lin = linearize(state, target_images, height, width, huber_th=huber_th,
                    outlier_th_sum=outlier_th_sum)
    return state, torch.sum(lin.energy), lin


def fej_recentered_residuals(state: BAState, lin: Linearization):
    """res_toZero = resF - JI.(Jp*delta) - Jab.delta_ab
    (EFResidual::fixLinearizationF)."""
    AH, AT = pair_adjoints(state)
    host = _hosts(state)
    dh = state.delta[host]                  # [P, 8]
    AH_p = AH[host]
    AT_p = AT[host]
    dp = torch.einsum("px,pfxy->pfy", dh, AH_p) \
        + torch.einsum("fx,pfxy->pfy", state.delta, AT_p)
    dd = (state.p_idepth - state.p_idepth_zero)[:, None]
    Jp_delta = torch.einsum("pfgx,pfx->pfg", lin.Jpdxi, dp[..., :6]) \
        + torch.einsum("pfgc,c->pfg", lin.Jpdc, state.c_delta) \
        + lin.Jpdd * dd[..., None]
    corr = torch.einsum("pfkg,pfg->pfk", lin.JIdx, Jp_delta) \
        + lin.Jab[..., 0] * dp[..., None, 6] \
        + lin.Jab[..., 1] * dp[..., None, 7]
    return lin.res - corr


def marginalize_points(state: BAState, lin: Linearization,
                       marg_weight: float = 0.25,
                       idepth_prior_marg_fac: float = 360000.0,
                       reduce=None) -> BAState:
    """Schur-marginalize all PT_MARGINALIZE points into HM/bM with
    FEJ-recentered residuals; frees their slots. ``reduce`` (as in
    ``solve_delta``) sums the point-partial terms over ranks, so HM/bM come
    out the same on every rank."""
    marg = state.p_status == PT_MARGINALIZE
    res0 = fej_recentered_residuals(state, lin)
    state_m = state._replace(p_prior=torch.where(
        marg, state.p_prior * idepth_prior_marg_fac, state.p_prior))
    asm = assemble(state_m, lin, point_mask=marg, residual_override=res0)
    ok = marg & (asm.Hdd > 1e-10)
    Hdd_i = torch.where(ok, 1.0 / torch.where(ok, asm.Hdd,
                                              torch.ones_like(asm.Hdd)),
                        torch.zeros_like(asm.Hdd))
    Vw = asm.V * Hdd_i[:, None]
    M_sc = Vw.T @ asm.V
    b_sc = Vw.T @ asm.bd
    H_top, b_top = asm.H, asm.b
    if reduce is not None:
        H_top, b_top = reduce(H_top), reduce(b_top)
        M_sc, b_sc = reduce(M_sc), reduce(b_sc)
    HM = state.HM + marg_weight * (H_top - M_sc)
    bM = state.bM + marg_weight * (b_top - b_sc)
    HM = 0.5 * (HM + HM.T)
    new_status = torch.where(marg, torch.zeros_like(state.p_status),
                             state.p_status)
    return state._replace(HM=HM, bM=bM, p_status=new_status,
                          r_active=state.r_active & ~marg[:, None])


def marginalize_frame(state: BAState, slot: int) -> BAState:
    """Schur-eliminate frame slot ``slot`` from HM/bM (marginalizeFrame):
    add its prior, scale-stabilized 8x8 inversion, zero the slot."""
    D = state.dim
    dtype, dev = state.HM.dtype, state.HM.device
    i0 = CPARS + 8 * slot
    idx = torch.arange(D, device=dev)
    in_blk = (idx >= i0) & (idx < i0 + 8)

    pr = state.frame_prior[slot]
    dpr = state.delta[slot] - state.frame_prior_delta0[slot]
    HM = state.HM.clone()
    bM = state.bM.clone()
    HM[i0:i0 + 8, i0:i0 + 8] += torch.diag(pr)
    bM[i0:i0 + 8] += pr * dpr

    svec = torch.sqrt(torch.abs(torch.diagonal(HM)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HM * svec_i[:, None] * svec_i[None, :]
    bs = bM * svec_i

    Hbb = Hs[i0:i0 + 8, i0:i0 + 8]
    Hbb = 0.5 * (Hbb + Hbb.T)
    Hbb_inv = torch.linalg.inv_ex(
        Hbb + 1e-8 * torch.eye(8, dtype=dtype, device=dev),
        check_errors=False)[0]
    Hxb = Hs[:, i0:i0 + 8]
    Hs_new = Hs - Hxb @ Hbb_inv @ Hxb.T
    bs_new = bs - Hxb @ (Hbb_inv @ bs[i0:i0 + 8])

    zf = torch.zeros((), dtype=dtype, device=dev)
    keep = ~in_blk
    HM_new = torch.where(keep[:, None] & keep[None, :],
                         Hs_new * svec[:, None] * svec[None, :], zf)
    bM_new = torch.where(keep, bs_new * svec, zf)
    HM_new = 0.5 * (HM_new + HM_new.T)

    # fills, not host scalars: a captured program holds this too
    fv = state.frame_valid.clone()
    fv[slot].fill_(False)
    ract = state.r_active.clone()
    ract[:, slot].fill_(False)
    return state._replace(HM=HM_new, bM=bM_new, frame_valid=fv,
                          r_active=ract)
