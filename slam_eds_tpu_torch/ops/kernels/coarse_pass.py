"""One pass of the coarse tracker's level loops in one launch: the
``coarse_pass`` kernel of ``csrc/coarse_pass.cu`` (hand-written for
``sm_90a``, float32), the linearization of a level template at a pose
(``ops.coarse_tracker.calc_res`` and ``calc_gs``) with the loop's scalar
tail in the grid's last block.

``Level`` holds what every launch of one pyramid level shares (the
template, the image, the camera, the exposures, the thresholds) and
launches the kernel in one of its modes with ``Level.run``:

* ``"sat0"``: the residuals at the start pose and the configured cutoff;
  returns the cutoff doublings' first carry (``[cutoff, saturated share]``,
  doublings int32, stop bool).
* ``"double"``: one cutoff doubling of that carry.
* ``"init"``: the linearization at the start pose; returns the LM's first
  carry (``STATE`` floats: pose, affine, H, b, (E, n), lambda, and the first
  step's candidate pose, affine and norm; passes int32; done bool).
* ``"lm"``: one LM pass of that carry at its candidate.
* ``"final"``: the residuals at the carry's accepted pose; returns
  ``[rms, saturated share]`` and whether enough residuals are visible.

The plain version is ``ops.coarse_tracker.track_level_plain`` (what CPU
tensors run), the same loops in torch ops. Every check raises; a CUDA
tensor launches the kernel and nothing falls back. ``coarse_pass.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import counted, load_library

THREADS = 256
MAX_SLOTS = 64 * THREADS       # the grid's 64 blocks
SUMS = 49                      # float sums and counts a block leaves
STATE = 104                    # the LM carry's floats
# where the LM carry keeps the accepted pose and affine (csrc/coarse_pass.cu)
S_R, S_T, S_AFF, S_H, S_B, S_E, S_N = 0, 9, 12, 14, 78, 86, 87
# and the candidate of the next pass
S_CR, S_CT, S_CAFF, S_CNORM = 89, 98, 101, 103
MODES = {"sat0": 0, "double": 1, "init": 2, "lm": 3, "final": 4}

_PTRS = ("u", "v", "idepth", "color", "mask", "img", "R", "t", "aff",
         "exp_ref", "exp_new", "aff_ref", "cutoff", "f_in", "i_in", "b_in",
         "f_out", "i_out", "b_out", "partials", "ticket")


class _Args(ctypes.Structure):
    """``CoarseArgs`` of ``csrc/coarse_pass.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _PTRS]
                + [(name, ctypes.c_int) for name in
                   ("slots", "height", "width", "mode")]
                + [(name, ctypes.c_float) for name in
                   ("fx", "fy", "cx", "cy", "inv_fx", "inv_fy", "huber",
                    "two_huber", "huber_sq", "cutoff_th", "cutoff_cap",
                    "lambda_init", "extrap_limit")]
                + [("S", ctypes.c_float * 8), ("fix_a", ctypes.c_int),
                   ("fix_b", ctypes.c_int)])


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record. Raises where its layout constants are not this
    module's."""
    return load_library(
        "coarse_pass", ["coarse_pass.cu"],
        {"coarse_pass_launch": [ctypes.POINTER(_Args), ctypes.c_void_p]},
        layout=("slots, sums and state",
                {"coarse_pass_max_slots": MAX_SLOTS,
                 "coarse_pass_sums": SUMS,
                 "coarse_pass_state_floats": STATE}))


# per device: the blocks' partial sums and the last-block ticket, made
# outside any capture (a block of a graph's pool may be a temporary its
# kernels write on every replay) and shared by every launch, which runs in
# stream order
_SCRATCH = {}


def _scratch(dev):
    if dev not in _SCRATCH:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("coarse_pass: the first launch on a device "
                               "must run outside a graph capture (the warm-"
                               "up), which makes its scratch")
        _SCRATCH[dev] = (
            torch.zeros((MAX_SLOTS // THREADS) * SUMS, dtype=torch.float32,
                        device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return _SCRATCH[dev]


def check_level(tpl, img):
    """Raise on what the kernel does not take: a template (``u``, ``v``,
    ``idepth``, ``color`` float32 and ``mask`` bool, each ``[slots]``,
    contiguous, 1 <= slots <= ``MAX_SLOTS``) and an image ``[H, W, 3]``
    float32, contiguous, on the template's device."""
    fields = (tpl.u, tpl.v, tpl.idepth, tpl.color, tpl.mask)
    if (any(x.dtype != torch.float32 for x in (*fields[:4], img))
            or tpl.mask.dtype != torch.bool):
        raise TypeError("coarse_pass takes a float32 template with a bool "
                        "mask and a float32 image; got "
                        f"{[x.dtype for x in fields]}, {img.dtype}")
    n = tpl.u.shape
    if any(x.dim() != 1 or x.shape != n for x in fields):
        raise ValueError(f"coarse_pass: the template's fields must be one "
                         f"[slots] shape, got {[tuple(x.shape) for x in fields]}")
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"coarse_pass: the image must be [H, W, 3], got "
                         f"{tuple(img.shape)}")
    if not 1 <= n[0] <= MAX_SLOTS:
        raise ValueError(f"coarse_pass: {n[0]} slots; the grid takes 1 to "
                         f"{MAX_SLOTS}")
    if not all(x.is_contiguous() for x in (*fields, img)):
        raise ValueError("coarse_pass needs a contiguous template and image")
    if any(x.device != img.device for x in fields):
        raise ValueError(f"coarse_pass: the template is on "
                         f"{[str(x.device) for x in fields]}, the image on "
                         f"{img.device}")


def _f32(x) -> float:
    return float(np.float32(x))


class Level:
    """The launches of one pyramid level (see the module's docstring);
    ``scale`` is the affine parameters' (a, b) scale."""

    def __init__(self, tpl, img, cam, exposures, aff_ref, huber_th: float,
                 cutoff_th: float, lambda_init: float,
                 lambda_extrap_limit: float, fix_a: bool, fix_b: bool,
                 scale=(1.0, 1.0)):
        check_level(tpl, img)
        if img.device.type != "cuda":
            raise ValueError(f"coarse_pass launches on a CUDA device, not "
                             f"{img.device}")
        self.device = img.device
        exp_ref, exp_new = (self._vector(e, 1) for e in exposures)
        aff_ref = self._vector(aff_ref, 2)
        partials, ticket = _scratch(self.device)
        # the tensors the launches read, kept alive with the level
        self.keep = (tpl, img, exp_ref, exp_new, aff_ref, partials, ticket)
        a = _Args()
        for name, x in (("u", tpl.u), ("v", tpl.v), ("idepth", tpl.idepth),
                        ("color", tpl.color), ("mask", tpl.mask),
                        ("img", img), ("exp_ref", exp_ref),
                        ("exp_new", exp_new), ("aff_ref", aff_ref),
                        ("partials", partials), ("ticket", ticket)):
            setattr(a, name, x.data_ptr())
        a.slots, a.height, a.width = tpl.u.shape[0], img.shape[0], img.shape[1]
        a.fx, a.fy, a.cx, a.cy = (_f32(x) for x in (cam.fx, cam.fy, cam.cx,
                                                     cam.cy))
        # torch divides by a Python number through its float reciprocal
        a.inv_fx = _f32(np.float32(1.0) / np.float32(cam.fx))
        a.inv_fy = _f32(np.float32(1.0) / np.float32(cam.fy))
        a.huber, a.two_huber = _f32(huber_th), _f32(2.0 * huber_th)
        a.huber_sq, a.cutoff_th = _f32(huber_th * huber_th), _f32(cutoff_th)
        a.cutoff_cap = _f32(cutoff_th * 50.0)
        a.lambda_init = _f32(lambda_init)
        a.extrap_limit = _f32(lambda_extrap_limit)
        a.S[:] = [1.0] * 6 + [_f32(scale[0]), _f32(scale[1])]
        a.fix_a, a.fix_b = int(fix_a), int(fix_b)
        self.args = a

    def _vector(self, x, n):
        """``x`` as ``n`` contiguous float32 values on the level's device."""
        if not (torch.is_tensor(x) and x.dtype == torch.float32
                and x.device == self.device and x.numel() == n):
            raise ValueError(f"coarse_pass: expected {n} float32 value(s) on "
                             f"{self.device}, got {x!r}")
        return x.contiguous()

    def run(self, mode: str, pose, cutoff=None, carry=()):
        """One launch in ``mode`` at ``pose`` (R [3, 3], t [3], affine [2])
        with ``cutoff`` (a float32 scalar tensor; not read by "sat0" and
        "double") and ``carry`` (the loop's (floats, int32, bool); none for
        "sat0" and "init"). Returns the mode's outputs (module docstring)."""
        R, t, aff = (self._vector(x, n) for x, n in zip(pose, (9, 3, 2)))
        dev = self.device
        size = STATE if mode in ("init", "lm") else 2
        out = (torch.empty(size, dtype=torch.float32, device=dev),
               None if mode == "final"
               else torch.empty((), dtype=torch.int32, device=dev),
               torch.empty((), dtype=torch.bool, device=dev))
        a = _Args.from_buffer_copy(self.args)
        a.mode = MODES[mode]
        a.R, a.t, a.aff = R.data_ptr(), t.data_ptr(), aff.data_ptr()
        if mode not in ("sat0", "double"):
            a.cutoff = self._vector(cutoff, 1).data_ptr()
        if mode not in ("sat0", "init"):
            f_in, i_in, b_in = carry
            if not (f_in.is_contiguous() and f_in.dtype == torch.float32
                    and f_in.device == dev and i_in.dtype == torch.int32
                    and b_in.dtype == torch.bool):
                raise ValueError("coarse_pass: the carry must be contiguous "
                                 "float32, int32 and bool on the level's "
                                 "device")
            a.f_in, a.i_in, a.b_in = (f_in.data_ptr(), i_in.data_ptr(),
                                      b_in.data_ptr())
        a.f_out, a.b_out = out[0].data_ptr(), out[2].data_ptr()
        if out[1] is not None:
            a.i_out = out[1].data_ptr()
        coarse_pass(a, dev)
        return out if mode != "final" else (out[0], out[2])


@counted
def coarse_pass(args: _Args, device):
    """Launch the kernel with ``args`` on ``device``'s current stream."""
    lib = load().lib
    with torch.cuda.device(device):
        rc = lib.coarse_pass_launch(
            ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coarse_pass kernel launch failed: "
                           f"{lib.coarse_pass_error_string(rc).decode()}")
    coarse_pass.launches += 1
