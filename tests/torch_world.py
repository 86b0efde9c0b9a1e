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


def _field(x, y):
    return (0.10 * np.sin(0.15 * x) * np.cos(0.12 * y)
            + 0.05 * np.sin(0.05 * x + 0.07 * y))


def event_world(device, seed=7):
    """The event tracker tests' scene (``test_torch_event_tracker.world``),
    made with the port alone: 256 points on a 128x96 camera, a smooth event
    frame and gradients that make a small pose and velocity the cost's
    minimum. Returns (the identity tracker state, the frame, (cam, nc,
    grad, idp, weights, mask))."""
    from slam_eds_tpu_torch.ops import event_tracker as et
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    from slam_eds_tpu_torch.utils.lie import SE3
    Wc, Hc = 128, 96
    rng = np.random.default_rng(seed)
    n = 256
    uv = np.stack([rng.uniform(15, Wc - 15, n), rng.uniform(15, Hc - 15, n)],
                  -1)
    nc = np.stack([(uv[:, 0] - (Wc / 2 - 0.5)) / 110.0,
                   (uv[:, 1] - (Hc / 2 - 0.5)) / 110.0], -1)
    idp = rng.uniform(0.4, 0.7, n)
    vx = np.array([0.3, 0.1, -0.2, 0.05, -0.03, 0.08])
    vx /= np.linalg.norm(vx)
    T = SE3.exp(torch.tensor([0.015, -0.01, 0.008, 0.003, 0.002, -0.004]))
    R, t = T.R.double().numpy(), T.t.double().numpy()
    z = 1.0 / (idp + 1e-5)
    p = np.stack([nc[:, 0] * z, nc[:, 1] * z, z], -1) @ R.T + t
    c = _field(110.0 * p[:, 0] / p[:, 2] + (Wc / 2 - 0.5),
               110.0 * p[:, 1] / p[:, 2] + (Hc / 2 - 0.5))
    cn = np.linalg.norm(c)
    ys, xs = np.mgrid[0:Hc, 0:Wc]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                    device=device)
    flow = et.compute_flow(f32(nc), f32(vx), f32(idp)).double().cpu().numpy()
    f2 = np.maximum(np.sum(flow * flow, -1), 1e-8)
    grad = -(100.0 * (c / cn) / f2)[:, None] * flow
    mask = np.ones(n, bool)
    mask[::17] = False
    cam = Pinhole(110.0, 110.0, Wc / 2 - 0.5, Hc / 2 - 0.5, Wc, Hc)
    state = et.TrackerState(px=f32(np.zeros(3)), qx=f32([1.0, 0, 0, 0]),
                            vx=f32(vx))
    return state, f32(_field(xs, ys) / cn), (
        cam, f32(nc), f32(grad), f32(idp),
        f32(rng.uniform(0.5, 1.0, n)), torch.as_tensor(mask, device=device))
