"""One pass of the event tracker's LM in one launch: the ``event_pass``
kernel of ``csrc/event_pass.cu`` (hand-written for ``sm_90a``, float32),
the pass of ``ops.event_tracker._lm_solve``'s WHILE loop (linearization,
the damped 12x12 step, the candidate's energy and the LM control) in one
thread-block cluster.

``Level`` holds what every launch of one pyramid level shares (the event
frame, the camera, the keyframe's points, the robust loss and its scale,
the tolerance) and launches the kernel in one of its modes with
``Level.run``:

* ``"init"``: the energy at the start state (px [3], qx [4], vx [6]);
  returns the loop's first carry (``STATE`` floats: px, qx, vx, lambda,
  energy; the pass count int32; done bool).
* ``"lm"``: one LM pass of that carry; a done carry comes back as it was
  given.
* ``"final"``: the residuals [slots] at the carry's state.

The plain version is ``ops.event_tracker._lm_solve_plain`` (what CPU
tensors, ``torch.vmap`` lanes and the sharded solve run), the same loop in
torch ops. Every check raises; a CUDA tensor launches the kernel and
nothing falls back. ``event_pass.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import counted, load_library

MAX_SLOTS = 32 * 2048          # the cluster's 2,048 threads, 32 slots each
STATE = 15                     # the LM carry's floats
# what an "lm" launch leaves on request (``Level.run(..., system=True)``):
# H's 78 upper-triangle sums row by row, g's 12, the candidate's energy,
# the step's 12
SYSTEM = 103
H_UPPER, G, E_NEW, STEP = 0, 78, 90, 91
# where the carry keeps the state, lambda and the energy (csrc/event_pass.cu)
S_PX, S_QX, S_VX, S_LAM, S_E = 0, 3, 7, 13, 14
MODES = {"init": 0, "lm": 1, "final": 2}
LOSSES = {"huber": 0, "cauchy": 1}   # any other kind: no robust weight
NO_LOSS = 2

_PTRS = ("nc", "grad", "idp", "weights", "mask", "frame", "loss_scale", "px",
         "qx", "vx", "f_in", "i_in", "b_in", "f_out", "i_out", "b_out",
         "sys_out")


class _Args(ctypes.Structure):
    """``EventArgs`` of ``csrc/event_pass.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _PTRS]
                + [(name, ctypes.c_int) for name in
                   ("slots", "height", "width", "mode")]
                + [(name, ctypes.c_float) for name in
                   ("fx", "fy", "cx", "cy", "tol")])


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record. Raises where its layout constants are not this
    module's."""
    return load_library(
        "event_pass", ["event_pass.cu"],
        {"event_pass_launch": [ctypes.POINTER(_Args), ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]},
        layout=("slots, state and system",
                {"event_pass_max_slots": MAX_SLOTS,
                 "event_pass_state_floats": STATE,
                 "event_pass_system_floats": SYSTEM}))


def check_level(frame, norm_coord, grad, idp, weights, mask):
    """Raise on what the kernel does not take: an event frame ``[H, W]``
    and the points (``norm_coord``, ``grad`` ``[slots, 2]``, ``idp``,
    ``weights`` ``[slots]``, all float32, ``mask`` ``[slots]`` bool), each
    contiguous, 1 <= slots <= ``MAX_SLOTS``, on one device."""
    fields = (norm_coord, grad, idp, weights)
    if (any(x.dtype != torch.float32 for x in (frame, *fields))
            or mask.dtype != torch.bool):
        raise TypeError("event_pass takes float32 points and frame with a "
                        "bool mask; got "
                        f"{[x.dtype for x in (frame, *fields, mask)]}")
    n = idp.shape[0] if idp.dim() == 1 else -1
    if (any(x.shape != (n, 2) for x in (norm_coord, grad))
            or any(x.shape != (n,) for x in (idp, weights, mask))):
        raise ValueError("event_pass: the points must be [slots, 2] and "
                         "[slots], got "
                         f"{[tuple(x.shape) for x in (*fields, mask)]}")
    if frame.dim() != 2:
        raise ValueError(f"event_pass: the event frame must be [H, W], got "
                         f"{tuple(frame.shape)}")
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"event_pass: {n} slots; the kernel takes 1 to "
                         f"{MAX_SLOTS}")
    if not all(x.is_contiguous() for x in (frame, *fields, mask)):
        raise ValueError("event_pass needs contiguous points and frame")
    if any(x.device != frame.device for x in (*fields, mask)):
        raise ValueError(f"event_pass: the points are on "
                         f"{[str(x.device) for x in (*fields, mask)]}, the "
                         f"frame on {frame.device}")


def _f32(x) -> float:
    return float(np.float32(x))


class Level:
    """The launches of one pyramid level's LM (see the module's
    docstring). ``loss_scale`` is a float32 device scalar."""

    def __init__(self, frame, cam, norm_coord, grad, idp, weights, mask,
                 loss_kind: str, loss_scale, function_tolerance: float,
                 norm_event: bool):
        check_level(frame, norm_coord, grad, idp, weights, mask)
        if frame.device.type != "cuda":
            raise ValueError(f"event_pass launches on a CUDA device, not "
                             f"{frame.device}")
        self.device = frame.device
        loss_scale = self._vector(loss_scale, 1)
        self.loss = LOSSES.get(loss_kind, NO_LOSS)
        self.norm_event = bool(norm_event)
        self.slots = idp.shape[0]
        # the tensors the launches read, kept alive with the level
        self.keep = (frame, norm_coord, grad, idp, weights, mask, loss_scale)
        a = _Args()
        for name, x in (("nc", norm_coord), ("grad", grad), ("idp", idp),
                        ("weights", weights), ("mask", mask),
                        ("frame", frame), ("loss_scale", loss_scale)):
            setattr(a, name, x.data_ptr())
        a.slots, a.height, a.width = self.slots, frame.shape[0], frame.shape[1]
        a.fx, a.fy, a.cx, a.cy = (_f32(x) for x in (cam.fx, cam.fy, cam.cx,
                                                     cam.cy))
        a.tol = _f32(function_tolerance)
        self.args = a

    def _vector(self, x, n):
        """``x`` as ``n`` contiguous float32 values on the level's device."""
        if not (torch.is_tensor(x) and x.dtype == torch.float32
                and x.device == self.device and x.numel() == n
                and x.is_contiguous()):
            raise ValueError(f"event_pass: expected {n} contiguous float32 "
                             f"value(s) on {self.device}, got {x!r}")
        return x

    def run(self, mode: str, state=None, carry=(), system=False):
        """One launch in ``mode``: "init" at ``state`` (px, qx, vx), "lm"
        and "final" on ``carry`` (the loop's (floats, int32, bool)).
        Returns the mode's outputs (module docstring); with ``system`` an
        "lm" launch also returns its ``SYSTEM`` floats (H, g, the
        candidate's energy and the step; left unwritten where the carry is
        done)."""
        dev = self.device
        a = _Args.from_buffer_copy(self.args)
        a.mode = MODES[mode]
        if mode == "init":
            px, qx, vx = (self._vector(x, n)
                          for x, n in zip(state, (3, 4, 6)))
            a.px, a.qx, a.vx = px.data_ptr(), qx.data_ptr(), vx.data_ptr()
        else:
            f_in, i_in, b_in = carry
            if not (f_in.is_contiguous() and f_in.dtype == torch.float32
                    and f_in.numel() == STATE and f_in.device == dev
                    and i_in.dtype == torch.int32 and i_in.device == dev
                    and b_in.dtype == torch.bool and b_in.device == dev):
                raise ValueError("event_pass: the carry must be STATE "
                                 "contiguous float32, an int32 and a bool "
                                 "on the level's device")
            a.f_in, a.i_in, a.b_in = (f_in.data_ptr(), i_in.data_ptr(),
                                      b_in.data_ptr())
        if mode == "final":
            out = torch.empty(self.slots, dtype=torch.float32, device=dev)
            a.f_out = out.data_ptr()
        else:
            out = (torch.empty(STATE, dtype=torch.float32, device=dev),
                   torch.empty((), dtype=torch.int32, device=dev),
                   torch.empty((), dtype=torch.bool, device=dev))
            a.f_out, a.i_out, a.b_out = (x.data_ptr() for x in out)
        if system:
            if mode != "lm":
                raise ValueError("event_pass: only an lm launch leaves its "
                                 "system")
            sys_out = torch.full((SYSTEM,), float("nan"), device=dev)
            a.sys_out = sys_out.data_ptr()
        event_pass(a, self.loss, self.norm_event, dev)
        return (*out, sys_out) if system else out


@counted
def event_pass(args: _Args, loss: int, norm_event: bool, device):
    """Launch the kernel with ``args`` on ``device``'s current stream."""
    lib = load().lib
    with torch.cuda.device(device):
        rc = lib.event_pass_launch(
            ctypes.byref(args), loss, int(norm_event),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"event_pass kernel launch failed: "
                           f"{lib.event_pass_error_string(rc).decode()}")
    event_pass.launches += 1
