"""A rendered multi-view BA world made with numpy from a seed, shared by the
port's parity tests (no JAX here, so the card-only tests can use it too):
F=4 frames of a textured surface seen from perturbed poses, P=256 points at
their true inverse depths (the estimate jittered by 3%), pattern colors read
from their host frames, and a small perturbation of every frame but the
first. A well-conditioned window: its BA converges."""
import numpy as np
import torch

from slam_eds_tpu_torch.models.ba_state import PT_ACTIVE, empty_state
from slam_eds_tpu_torch.utils.lie import SE3

F, P, H, W = 4, 256, 96, 128
FX = FY = 110.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5


def _intensity(X, Y):
    return (128.0 + 50.0 * np.sin(2.3 * X + 0.4) * np.cos(1.9 * Y)
            + 35.0 * np.sin(4.1 * X - 3.3 * Y) + 20.0 * np.cos(7.7 * X + 5.1 * Y))


def _surface_z(X, Y):
    return 2.0 + 0.3 * np.sin(1.1 * X) * np.cos(0.9 * Y) + 0.15 * X


def _cast(R, t, u, v):
    """Rays through pixels (u, v) of camera (R, t) (worldToCam) hit the
    surface; returns (world X, Y, camera depth z)."""
    d = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1) @ R
    c = -R.T @ t
    lam = (2.0 - c[2]) / d[..., 2]
    for _ in range(12):
        Xw = c + d * lam[..., None]
        lam = (_surface_z(Xw[..., 0], Xw[..., 1]) - c[2]) / d[..., 2]
    Xw = c + d * lam[..., None]
    return Xw[..., 0], Xw[..., 1], lam


def _bilinear(img, x, y):
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return ((1 - fx) * (1 - fy) * img[y0, x0] + fx * (1 - fy) * img[y0, x0 + 1]
            + (1 - fx) * fy * img[y0 + 1, x0] + fx * fy * img[y0 + 1, x0 + 1])


def world_arrays(seed=11) -> dict:
    """BAState fields (pose as 'T_eval.R'/'T_eval.t') and the [F, H, W, 3]
    target stacks ('images') as numpy arrays."""
    rng = np.random.default_rng(seed)
    taus = np.zeros((F, 6), np.float32)
    taus[1:, :3] = rng.uniform(-0.08, 0.08, (F - 1, 3))
    taus[1:, 3:] = rng.uniform(-0.02, 0.02, (F - 1, 3))
    T = SE3.exp(torch.as_tensor(taus))
    R32, t32 = T.R.numpy(), T.t.numpy()
    R, t = R32.astype(np.float64), t32.astype(np.float64)

    vs, us = np.mgrid[0:H, 0:W].astype(np.float64)
    imgs = []
    for f in range(F):
        X, Y, _ = _cast(R[f], t[f], us, vs)
        I = _intensity(X, Y)
        gx = 0.5 * (np.concatenate([I[:, 1:], I[:, -1:]], 1)
                    - np.concatenate([I[:, :1], I[:, :-1]], 1))
        gy = 0.5 * (np.concatenate([I[1:], I[-1:]], 0)
                    - np.concatenate([I[:1], I[:-1]], 0))
        imgs.append(np.stack([I, gx, gy], -1))
    imgs = np.stack(imgs).astype(np.float32)

    host = rng.integers(0, F, P)
    uv = np.stack([rng.uniform(6, W - 7, P), rng.uniform(6, H - 7, P)], -1)
    idp = np.empty(P)
    for f in range(F):
        m = host == f
        idp[m] = 1.0 / _cast(R[f], t[f], uv[m, 0], uv[m, 1])[2]
    offs = np.array([[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0],
                     [-1, 1], [0, 2]])
    color = np.stack([_bilinear(imgs[host[i], ..., 0], uv[i, 0] + offs[:, 0],
                                uv[i, 1] + offs[:, 1]) for i in range(P)])
    r_act = np.ones((P, F), bool)
    r_act[np.arange(P), host] = False
    delta = np.zeros((F, 8))
    delta[1:, :3] = rng.uniform(-0.004, 0.004, (F - 1, 3))
    delta[1:, 3:6] = rng.uniform(-0.0015, 0.0015, (F - 1, 3))
    delta[1:, 6] = rng.uniform(-0.01, 0.01, F - 1)
    delta[1:, 7] = rng.uniform(-1.0, 1.0, F - 1)
    frame_prior = np.zeros((F, 8))
    frame_prior[0, :6] = 1e8
    frame_prior[:, 6] = 1e10
    frame_prior[:, 7] = 100.0
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return {
        "T_eval.R": R32, "T_eval.t": t32, "images": imgs,
        "frame_valid": np.ones(F, bool), "delta": f32(delta),
        "frame_prior": f32(frame_prior),
        "p_host": host.astype(np.int32), "p_uv": f32(uv),
        "p_idepth": f32(idp * (1 + rng.uniform(-0.03, 0.03, P))),
        "p_idepth_zero": f32(idp), "p_color": f32(color),
        "p_weight": f32(rng.uniform(0.5, 1.0, (P, 8))),
        "p_prior": f32(np.where(rng.uniform(size=P) < 0.2, 50.0, 0.0)),
        "p_status": np.full((P,), PT_ACTIVE, np.int32),
        "r_active": r_act,
    }


def port_world(device, seed=11):
    """(BAState, images) of ``world_arrays`` as the port's tensors."""
    d = world_arrays(seed)
    st = empty_state(F, P, [FX, FY, CX, CY], device=device)
    fields = {k: torch.as_tensor(v, device=device) for k, v in d.items()
              if k not in ("T_eval.R", "T_eval.t", "images")}
    st = st._replace(T_eval=SE3(torch.as_tensor(d["T_eval.R"], device=device),
                                torch.as_tensor(d["T_eval.t"], device=device)),
                     **fields)
    return st, torch.as_tensor(d["images"], device=device)
