"""Monocular bootstrap: joint pose + per-point inverse-depth initializer —
port of ``slam_eds_tpu.ops.coarse_init`` (DSO's ``CoarseInitializer``).

The pyramid coarse-to-fine LM jointly estimates the relative 8-dof state
(pose + affine) of the newest frame and one inverse depth per selected
first-frame point, with

* per-level grid-max point selection at DSO's densities (``set_first``; on
  the host in numpy, with the JAX package's seeds, so that both packages
  select the same points),
* a 10-nearest-neighbour graph for idepth smoothing and nearest-parent
  indices into the next-coarser level, built once on the device in row
  chunks (``_knn``, ``_parents``),
* the Schur-complement step: the 8x8 reduced camera system, per-point
  idepth back-substitution, neighbour-median regularization,
* the translation "snap" detection with alpha energies: until the camera
  has translated enough, idepths are pulled to 1 and the translation is
  damped; once snapped, idepths couple to their neighbour medians.

Every level is a fixed-capacity masked array. ``_track_level`` runs a fixed
number of LM iterations with ``torch.where``-selected accept/reject and no
host read (JAX's ``fori_loop``: no early exit to port); ``track_frame``
runs ``track_frame_program``, on a card as one captured program, and reads
the device once per frame.

Neighbour order: level coordinates are integers, so equal distances are the
rule. Neighbours are ordered by (distance, index); the JAX package's
``np.argsort`` leaves the order among equal distances unspecified.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .. import graphs
from ..device import resolve_device
from ..utils.lie import SE3
from ..utils.interp import bilinear_3
from ..utils.image import pattern
from ..utils.scatter import order_free_index_add

NUM_NN = 10
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
SNAPPED_THRESHOLD = 5          # frames the solution must stay snapped
# rows of the [rows, P] distance blocks of the neighbour graph
_GRAPH_ROWS = 1024


class InitLevel(NamedTuple):
    """Fixed-capacity point set of one pyramid level."""
    uv: torch.Tensor        # [P, 2] pixel coords at this level
    color: torch.Tensor     # [P, K] reference pattern colors
    idepth: torch.Tensor    # [P]
    iR: torch.Tensor        # [P] regularized idepth (neighbour median target)
    nn: torch.Tensor        # [P, NUM_NN] int32 neighbour indices (self-padded)
    parent: torch.Tensor    # [P] int32 index into the next-coarser level (-1)
    mask: torch.Tensor      # [P] bool
    good: torch.Tensor      # [P] bool, passed the last residual gate


class InitState(NamedTuple):
    levels: List[InitLevel]
    T_10: SE3               # current relative pose (frame1 <- frame0)
    aff: torch.Tensor       # [2] affine a, b
    snapped: torch.Tensor   # bool
    snapped_at: torch.Tensor  # int32 frame counter when first snapped (-1)
    frame_id: torch.Tensor  # int32


def state_to_numpy(state: InitState) -> dict:
    """InitState -> {"levels": [dict of arrays per level], "T_10.R",
    "T_10.t", "aff", "snapped", "snapped_at", "frame_id"}."""
    def arr(x):
        return x.detach().cpu().numpy()
    return {"levels": [{k: arr(v) for k, v in lvl._asdict().items()}
                       for lvl in state.levels],
            "T_10.R": arr(state.T_10.R), "T_10.t": arr(state.T_10.t),
            "aff": arr(state.aff), "snapped": arr(state.snapped),
            "snapped_at": arr(state.snapped_at),
            "frame_id": arr(state.frame_id)}


def state_from_numpy(d: dict, device="cuda") -> InitState:
    """Inverse of ``state_to_numpy``; accepts any array-likes (a JAX
    InitState converted field by field with ``np.asarray``); dtypes are
    kept."""
    device = resolve_device(device)

    def ten(x):
        return torch.as_tensor(np.array(x), device=device)
    return InitState(
        levels=[InitLevel(**{k: ten(lvl[k]) for k in InitLevel._fields})
                for lvl in d["levels"]],
        T_10=SE3(ten(d["T_10.R"]), ten(d["T_10.t"])), aff=ten(d["aff"]),
        snapped=ten(d["snapped"]), snapped_at=ten(d["snapped_at"]),
        frame_id=ten(d["frame_id"]))


def _select_level_points(img_l, density: float, cap: int, rng_seed: int):
    """Grid-max gradient selection at one level, on the host. img_l:
    [H, W, 3] tensor. Returns (uv [cap, 2] float32, mask [cap]) arrays."""
    H, W = img_l.shape[:2]
    g2 = torch.sum(img_l[..., 1:3] ** 2, -1).cpu().numpy()
    n_target = max(16, int(density))
    # potential grid: cell size so that #cells ~ n_target
    pot = max(1, int(np.sqrt(H * W / n_target)))
    gh, gw = H // pot, W // pot
    g2c = g2[:gh * pot, :gw * pot].reshape(gh, pot, gw, pot)
    flat = g2c.transpose(0, 2, 1, 3).reshape(gh, gw, pot * pot)
    arg = flat.argmax(-1)
    best = flat.max(-1)
    ys = (np.arange(gh)[:, None] * pot + arg // pot)
    xs = (np.arange(gw)[None, :] * pot + arg % pot)
    thr = np.median(best) * 0.1
    keep = best > max(thr, 1e-8)
    uv = np.stack([xs[keep], ys[keep]], -1).astype(np.float32)
    m = (uv[:, 0] > 2) & (uv[:, 0] < W - 3) & (uv[:, 1] > 2) \
        & (uv[:, 1] < H - 3)
    uv = uv[m]
    rng = np.random.default_rng(rng_seed)
    if len(uv) > cap:
        uv = uv[rng.choice(len(uv), cap, replace=False)]
    n = len(uv)
    pad = cap - n
    uv_full = np.concatenate([uv, np.zeros((pad, 2), np.float32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return uv_full, mask


def _row_blocks(n: int):
    return ((r, min(r + _GRAPH_ROWS, n)) for r in range(0, n, _GRAPH_ROWS))


def _knn(uv, mask, k: int = NUM_NN):
    """k nearest neighbours of each point among the valid ones (itself
    excluded), ordered by (squared distance, index); where fewer than k
    exist, and for invalid points, the point's own index. uv [P, 2], mask
    [P] tensors; returns [P, k] int32. [rows, P] blocks: the full [P, P]
    matrix of a 640x480 level 0 (P = 13,824) would take 1.5 GB with its
    sort."""
    P = uv.shape[0]
    inf = torch.full((), float("inf"), dtype=uv.dtype, device=uv.device)
    cols = torch.arange(P, device=uv.device)
    out = []
    for r0, r1 in _row_blocks(P):
        d2 = ((uv[r0:r1, None, :] - uv[None, :, :]) ** 2).sum(-1)
        dead = ~mask[r0:r1, None] | ~mask[None, :] \
            | (cols[r0:r1, None] == cols[None, :])
        d2 = torch.where(dead, inf, d2)
        srt, idx = torch.sort(d2, dim=1, stable=True)
        out.append(torch.where(srt[:, :k] < inf, idx[:, :k],
                               cols[r0:r1, None]))
    return torch.cat(out).to(torch.int32)


def _parents(uv_fine, mask_fine, uv_coarse, mask_coarse):
    """Nearest valid coarser-level point of each fine point (the lowest
    index among equally near ones); -1 for invalid fine points."""
    Pc = uv_coarse.shape[0]
    inf = torch.full((), float("inf"), dtype=uv_fine.dtype,
                     device=uv_fine.device)
    cols = torch.arange(Pc, device=uv_fine.device)
    out = []
    for r0, r1 in _row_blocks(uv_fine.shape[0]):
        d2 = ((uv_fine[r0:r1, None, :] * 0.5
               - uv_coarse[None, :, :]) ** 2).sum(-1)
        d2 = torch.where(mask_coarse[None, :], d2, inf)
        near = d2 == d2.min(dim=1, keepdim=True).values
        out.append(torch.where(near, cols[None, :],
                               torch.full_like(cols, Pc - 1)[None, :]).min(1)
                   .values)
    p = torch.cat(out)
    return torch.where(mask_fine, p, torch.full_like(p, -1)).to(torch.int32)


def set_first(pyr_ref, caps: List[int] | None = None,
              densities: List[float] | None = None,
              seed: int = 3141592) -> InitState:
    """Select points on the first frame at every level and build the
    neighbour and parent graphs. pyr_ref: the [H_l, W_l, 3] levels of
    ``utils.image.build_pyramid``; the state lives on their device."""
    n_levels = len(pyr_ref)
    dev = pyr_ref[0].device
    H, W = pyr_ref[0].shape[:2]
    base = [0.03, 0.05, 0.15, 0.5, 1.0]
    # densities[l] * w0 * h0 points at each level, clamped by the level's own
    # pixel count
    densities = densities or [
        min(base[min(l, 4)] * W * H, ((W >> l) * (H >> l)) * 0.25)
        for l in range(n_levels)]
    caps = caps or [max(64, int(1.5 * d)) for d in densities]

    offs = pattern(torch.float32, dev)
    sel = []
    for l in range(n_levels):
        uv, mask = _select_level_points(pyr_ref[l], densities[l], caps[l],
                                        seed + l)
        sel.append((torch.as_tensor(uv, device=dev),
                    torch.as_tensor(mask, device=dev)))
    levels = []
    for l in range(n_levels):
        uv, mask = sel[l]
        col = bilinear_3(pyr_ref[l], uv[:, 0:1] + offs[None, :, 0],
                         uv[:, 1:2] + offs[None, :, 1])[..., 0]
        if l + 1 < n_levels:
            parent = _parents(uv, mask, *sel[l + 1])
        else:
            parent = torch.full((len(uv),), -1, dtype=torch.int32, device=dev)
        ones = torch.ones(len(uv), dtype=torch.float32, device=dev)
        levels.append(InitLevel(uv=uv, color=col, idepth=ones,
                                iR=ones.clone(), nn=_knn(uv, mask),
                                parent=parent, mask=mask, good=mask.clone()))
    return InitState(
        levels=levels, T_10=SE3.identity(device=dev),
        aff=torch.zeros(2, dtype=torch.float32, device=dev),
        snapped=torch.zeros((), dtype=torch.bool, device=dev),
        snapped_at=torch.full((), -1, dtype=torch.int32, device=dev),
        frame_id=torch.zeros((), dtype=torch.int32, device=dev))


def _neighbor_median(idepth, good, nn):
    """Lower median over each point's valid neighbours (the point's own
    idepth where it has none)."""
    vals = idepth[nn]                                    # [P, K]
    okn = good[nn]
    srt = torch.sort(torch.where(okn, vals, torch.full_like(vals, float("inf"))),
                     dim=1).values
    cnt = okn.sum(1)
    mid = torch.clamp((cnt - 1) // 2, 0, NUM_NN - 1)
    med = torch.gather(srt, 1, mid[:, None])[:, 0]
    med = torch.where(cnt > 0, med, idepth)
    return torch.where(torch.isfinite(med), med, idepth)


def _track_level(lvl: InitLevel, img_new, K4, T_10: SE3, aff, snapped,
                 height: int, width: int, iterations: int = 30,
                 huber_th: float = 9.0, lam0: float = 0.1):
    """LM on one level: returns (lvl', T_10', aff', snapped', energy). The
    8-dof system is Schur-reduced over the per-point idepths in every
    iteration. K4: (fx, fy, cx, cy) of the level as floats. A fixed number
    of iterations, each accepted or rejected by ``torch.where``: no host
    read."""
    fx, fy, cx, cy = (float(k) for k in K4)
    dev = lvl.uv.device
    f32 = torch.float32
    offs = pattern(f32, dev)
    mask = lvl.mask
    nn = lvl.nn.long()
    npts = torch.clamp(mask.sum().to(f32), min=1.0)
    u = (lvl.uv[:, 0:1] + offs[None, :, 0] - cx) / fx     # [P, K]
    v = (lvl.uv[:, 1:2] + offs[None, :, 1] - cy) / fy
    eye8 = torch.eye(8, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def linearize(T: SE3, ab, idepth):
        idp = idepth[:, None]
        # X = [u, v, 1] / idp; R X + t = (R [u, v, 1] + t idp) / idp
        R, t = T.R, T.t
        pu = R[0, 0] * u + R[0, 1] * v + R[0, 2] + t[0] * idp
        pv = R[1, 0] * u + R[1, 1] * v + R[1, 2] + t[1] * idp
        pw = R[2, 0] * u + R[2, 1] * v + R[2, 2] + t[2] * idp
        pwc = torch.clamp(pw, min=1e-12)
        un = pu / pwc
        vn = pv / pwc
        Ku = fx * un + cx
        Kv = fy * vn + cy
        inb = (Ku > 1.0) & (Ku < width - 2.0) & (Kv > 1.0) \
            & (Kv < height - 2.0) & (pw > 1e-6)
        hit = bilinear_3(img_new, Ku, Kv)
        gx = hit[..., 1] * fx
        gy = hit[..., 2] * fy
        ea = torch.exp(ab[0])
        res = hit[..., 0] - (ea * lvl.color + ab[1])
        ok = inb & torch.isfinite(res) & mask[:, None]
        ares = torch.abs(res)
        hw = torch.where(ares < huber_th, torch.ones_like(res),
                         huber_th / torch.clamp(ares, min=1e-12))
        energy = torch.sum(torch.where(ok, hw * res * res * (2.0 - hw), zero))
        iz = 1.0 / pwc
        J = torch.stack([
            gx * iz * idp,                                    # tx
            gy * iz * idp,                                    # ty
            -(gx * un + gy * vn) * iz * idp,                  # tz
            -(gx * un * vn + gy * (1 + vn * vn)),             # rx
            (gx * (1 + un * un) + gy * un * vn),              # ry
            (-gx * vn + gy * un),                             # rz
            -ea * lvl.color,                                  # d res / d a
            -torch.ones_like(res),                            # d res / d b
        ], -1)                                                # [P, K, 8]
        # d res / d idepth through (un, vn)
        Jd = gx * (t[0] - t[2] * un) * iz + gy * (t[1] - t[2] * vn) * iz
        return res, J, Jd, torch.where(ok, hw, zero), energy, ok

    def reg_weights(snapped_now):
        """(alpha, coupling): the pre-snap pull of idepths to 1 with the
        translation damping, or the post-snap neighbour coupling."""
        return (torch.where(snapped_now, 0.0, ALPHA_W),
                torch.where(snapped_now, COUPLING_WEIGHT, 0.0))

    def energy_total(T, ab, idepth, iR, snapped_now):
        e = linearize(T, ab, idepth)[4]
        alpha, cw = reg_weights(snapped_now)
        e_reg = torch.sum(torch.where(
            mask, alpha * (idepth - 1.0) ** 2 + cw * (idepth - iR) ** 2, zero))
        return e + e_reg + alpha * npts * torch.sum(T.t * T.t)

    T = T_10
    ab, idepth, iR = aff, lvl.idepth, lvl.iR
    lam = torch.full((), lam0, dtype=f32, device=dev)
    energy = energy_total(T, ab, idepth, iR, snapped)
    for _ in range(iterations):
        res, J, Jd, w, _, _ = linearize(T, ab, idepth)
        snapped_now = snapped | (torch.sum(T.t * T.t) * ALPHA_W > ALPHA_K)
        alpha, cw = reg_weights(snapped_now)

        Jf = J.reshape(-1, 8)
        Jw = (J * w[..., None]).reshape(-1, 8)
        damp = torch.cat([(alpha * npts).expand(3), zero.expand(5)])
        H88 = Jw.T @ Jf + torch.diag(damp)
        b8 = Jw.T @ res.reshape(-1) + damp * torch.cat([T.t, zero.expand(5)])

        Jdw = Jd * w
        Hdd = torch.sum(Jdw * Jd, 1) + alpha + cw
        bd = torch.sum(Jdw * res, 1) + alpha * (idepth - 1.0) \
            + cw * (idepth - iR)
        Hd8 = torch.einsum("pk,pka->pa", Jdw, J)              # [P, 8]

        Hdd_l = Hdd * (1.0 + lam) + 1e-10
        H_sc = H88 * (1.0 + lam) - (Hd8 / Hdd_l[:, None]).T @ Hd8
        b_sc = b8 - Hd8.T @ (bd / Hdd_l)
        dx8 = -torch.linalg.solve_ex(H_sc + 1e-8 * eye8, b_sc[:, None])[0][:, 0]
        dx8 = torch.where(torch.isfinite(dx8), dx8, zero)
        dd = torch.clamp(-(bd + Hd8 @ dx8) / Hdd_l, -2.0, 2.0)

        T_new = SE3.exp(dx8[:6]).compose(T)
        ab_new = ab + dx8[6:8]
        id_new = torch.clamp(torch.where(mask, idepth + dd, idepth),
                             1e-3, 50.0)
        iR_new = REG_WEIGHT * _neighbor_median(id_new, mask, nn) \
            + (1 - REG_WEIGHT) * id_new

        e_new = energy_total(T_new, ab_new, id_new, iR_new, snapped_now)
        accept = e_new < energy
        T = SE3(torch.where(accept, T_new.R, T.R),
                torch.where(accept, T_new.t, T.t))
        ab = torch.where(accept, ab_new, ab)
        idepth = torch.where(accept, id_new, idepth)
        iR = torch.where(accept, iR_new, iR)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-5, 1e4)
        energy = torch.where(accept, e_new, energy)

    snapped_out = snapped | (torch.sum(T.t * T.t) * ALPHA_W > ALPHA_K)
    # the good mask from the final residual gate
    ok_f = linearize(T, ab, idepth)[5]
    good = mask & (ok_f.sum(1) >= 6)
    return (lvl._replace(idepth=idepth, iR=iR, good=good), T, ab,
            snapped_out, energy)


def track_frame_program(x, *, cam, iterations: int):
    """``track_frame``'s device program (JAX: ``_track_level`` under
    ``jax.jit`` per level): the idepths up the pyramid, every level's LM
    coarse to fine with the idepths down, the snap bookkeeping. x = {state
    (InitState), pyr ([H_l, W_l, 3] levels of the new frame)}. Returns
    (state', [snapped, snapped_at, frame_id] int32): nothing is read back,
    so on a card it is one captured program."""
    state, pyr_new = x["state"], x["pyr"]
    n_levels = len(state.levels)
    levels = list(state.levels)

    # idepths up: a coarser point starts from the mean of its children
    for l in range(1, n_levels):
        fine, coarse = levels[l - 1], levels[l]
        P = coarse.uv.shape[0]
        use = fine.mask & (fine.parent >= 0)
        # a parent of -1 adds zero to the last slot (index_add_ takes no
        # negative index); the sums do not depend on the order of additions
        pid = torch.where(fine.parent >= 0, fine.parent, P - 1).long()
        num = order_free_index_add(
            pid, torch.where(use, fine.idepth, torch.zeros_like(fine.idepth)),
            P)
        den = torch.zeros(P, dtype=torch.int64, device=pid.device).index_add_(
            0, pid, use.long())
        prop = torch.where(den > 0, num / torch.clamp(den, min=1).to(num.dtype),
                           coarse.idepth)
        levels[l] = coarse._replace(idepth=prop, iR=prop)

    T, aff, snapped = state.T_10, state.aff, state.snapped
    for l in range(n_levels - 1, -1, -1):
        pin = cam.pyramid_level(l)
        H, W = pyr_new[l].shape[:2]
        levels[l], T, aff, snapped, _ = _track_level(
            levels[l], pyr_new[l], (pin.fx, pin.fy, pin.cx, pin.cy), T, aff,
            snapped, H, W, iterations=iterations)
        if l > 0:
            # idepths down: children take their parent's
            fine, par = levels[l - 1], levels[l]
            use = fine.mask & (fine.parent >= 0)
            prop = par.idepth[torch.clamp(fine.parent, min=0).long()]
            levels[l - 1] = fine._replace(
                idepth=torch.where(use, prop, fine.idepth),
                iR=torch.where(use, prop, fine.iR))

    frame_id = state.frame_id + 1
    snapped_at = torch.where(snapped & (state.snapped_at < 0), frame_id,
                             state.snapped_at)
    flags = torch.stack([snapped.to(torch.int32), snapped_at, frame_id])
    return InitState(levels=levels, T_10=T, aff=aff, snapped=snapped,
                     snapped_at=snapped_at, frame_id=frame_id), flags


def track_frame(state: InitState, pyr_new, cam, iterations: int = 30,
                counters=None) -> tuple[InitState, bool]:
    """One new frame through the coarse-to-fine initializer
    (``track_frame_program`` through ``graphs.run``, keyed on the camera
    and ``iterations``, the level shapes being in the key already). Returns
    (state', initialized): initialized once the solution has stayed snapped
    for SNAPPED_THRESHOLD frames. One host read per frame, of the snap
    flags (``counters["init_host_reads"]`` when given)."""
    state, flags = graphs.copy_out(graphs.run(
        ("coarse_init_track", tuple(cam), iterations),
        lambda x: track_frame_program(x, cam=cam, iterations=iterations),
        {"state": state, "pyr": list(pyr_new)}))
    if counters is not None:
        counters["init_host_reads"] += 1
    is_snapped, at, fid = flags.tolist()
    initialized = bool(is_snapped) and at >= 0 \
        and fid - max(at, 0) >= SNAPPED_THRESHOLD
    return state, initialized


def extract_result(state: InitState):
    """Final (T_10, uv0 [P, 2], idepth0 [P], mask) at level 0, the idepths
    rescaled to mean 1 and the translation with them."""
    l0 = state.levels[0]
    ok = l0.mask & l0.good
    zero = torch.zeros_like(l0.iR)
    mean_id = torch.sum(torch.where(ok, l0.iR, zero)) / torch.clamp(
        ok.sum().to(l0.iR.dtype), min=1.0)
    mean_id = torch.clamp(mean_id, min=1e-6)
    T = SE3(state.T_10.R, state.T_10.t * mean_id)
    return T, l0.uv, torch.where(ok, l0.iR / mean_id, zero), ok
