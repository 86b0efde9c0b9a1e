"""Sliding-window BA state — port of ``slam_eds_tpu.models.ba_state``.

One fixed-capacity NamedTuple of tensors with the JAX field names and
layouts: F frame slots with a validity mask, P point slots owned by host
frames, a dense ``[P, F]`` residual mask, and the dense marginalization
prior HM/bM over ``[CPARS | 8 per frame slot]``. The state is this
system's parameters (there are no weights), so ``from_numpy``/``to_numpy``
move one exact state between the JAX package and the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.lie import SE3

CPARS = 4
PATTERN = 8

PT_EMPTY = 0
PT_ACTIVE = 1
PT_MARGINALIZE = 2
PT_DROP = 3


class BAState(NamedTuple):
    # --- frames [F slots] ---
    T_eval: SE3                # worldToCam at FEJ: R [F,3,3], t [F,3]
    aff_eval: torch.Tensor     # [F, 2]
    delta: torch.Tensor        # [F, 8]
    exposure: torch.Tensor     # [F]
    frame_prior: torch.Tensor  # [F, 8]
    frame_prior_delta0: torch.Tensor  # [F, 8]
    frame_valid: torch.Tensor  # [F] bool
    frame_energy_th: torch.Tensor  # [F]
    # --- calib ---
    c_zero: torch.Tensor       # [4]
    c_delta: torch.Tensor      # [4]
    # --- points [P slots] ---
    p_host: torch.Tensor       # [P] int32
    p_uv: torch.Tensor         # [P, 2]
    p_idepth: torch.Tensor     # [P]
    p_idepth_zero: torch.Tensor  # [P]
    p_color: torch.Tensor      # [P, 8]
    p_weight: torch.Tensor     # [P, 8]
    p_prior: torch.Tensor      # [P]
    p_status: torch.Tensor     # [P] int32
    # --- residuals ---
    r_active: torch.Tensor     # [P, F] bool
    # --- marginalization prior ---
    HM: torch.Tensor
    bM: torch.Tensor

    @property
    def num_frames(self):
        return self.frame_valid.shape[0]

    @property
    def num_points(self):
        return self.p_host.shape[0]

    @property
    def dim(self):
        return CPARS + 8 * self.num_frames

    def current_poses(self) -> SE3:
        """exp(delta[:6]) @ T_eval per frame."""
        return SE3.exp(self.delta[:, :6]).compose(self.T_eval)

    def current_aff(self):
        return self.aff_eval + self.delta[:, 6:8]

    def current_calib(self):
        return self.c_zero + self.c_delta


def empty_state(num_frames: int, num_points: int, calib, device="cuda",
                dtype=torch.float32) -> BAState:
    F, P = num_frames, num_points
    D = CPARS + 8 * F
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    return BAState(
        T_eval=SE3(torch.eye(3, **kw).expand(F, 3, 3).clone(),
                   torch.zeros((F, 3), **kw)),
        aff_eval=torch.zeros((F, 2), **kw),
        delta=torch.zeros((F, 8), **kw),
        exposure=torch.ones((F,), **kw),
        frame_prior=torch.zeros((F, 8), **kw),
        frame_prior_delta0=torch.zeros((F, 8), **kw),
        frame_valid=torch.zeros((F,), dtype=torch.bool, device=device),
        frame_energy_th=torch.full((F,), 1e8, **kw),
        c_zero=torch.as_tensor(calib, **kw).clone(),
        c_delta=torch.zeros((CPARS,), **kw),
        p_host=torch.zeros((P,), dtype=torch.int32, device=device),
        p_uv=torch.zeros((P, 2), **kw),
        p_idepth=torch.ones((P,), **kw),
        p_idepth_zero=torch.ones((P,), **kw),
        p_color=torch.zeros((P, PATTERN), **kw),
        p_weight=torch.ones((P, PATTERN), **kw),
        p_prior=torch.zeros((P,), **kw),
        p_status=torch.zeros((P,), dtype=torch.int32, device=device),
        r_active=torch.zeros((P, F), dtype=torch.bool, device=device),
        HM=torch.zeros((D, D), **kw),
        bM=torch.zeros((D,), **kw),
    )


# ---------------------------------------------------------------------------
# numpy converters: a dict of arrays (field name -> np.ndarray; the pose as
# "T_eval.R"/"T_eval.t") <-> tensors, for any NamedTuple container here.
# ---------------------------------------------------------------------------

def tuple_to_numpy(tup) -> dict:
    """NamedTuple of tensors (SE3 fields flattened as 'name.R'/'name.t')
    -> dict of numpy arrays."""
    out = {}
    for name, v in tup._asdict().items():
        if isinstance(v, SE3):
            out[f"{name}.R"] = v.R.detach().cpu().numpy()
            out[f"{name}.t"] = v.t.detach().cpu().numpy()
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def tuple_from_numpy(cls, d: dict, device="cuda", pose_fields=()):
    """Inverse of ``tuple_to_numpy`` for NamedTuple class ``cls``. Accepts
    any array-likes (e.g. ``np.asarray`` of JAX arrays); dtypes are kept."""
    device = resolve_device(device)
    kw = {}
    for name in cls._fields:
        if name in pose_fields:
            kw[name] = SE3(torch.as_tensor(np.array(d[f"{name}.R"]),
                                           device=device),
                           torch.as_tensor(np.array(d[f"{name}.t"]),
                                           device=device))
        else:
            kw[name] = torch.as_tensor(np.array(d[name]), device=device)
    return cls(**kw)


def to_numpy(state: BAState) -> dict:
    return tuple_to_numpy(state)


def from_numpy(d: dict, device="cuda") -> BAState:
    """BAState from a dict of arrays. ``d`` may also be a JAX ``BAState``
    converted with ``{k: np.asarray(v)}`` over its fields, with the pose
    given as 'T_eval.R'/'T_eval.t'."""
    return tuple_from_numpy(BAState, d, device, pose_fields=("T_eval",))
