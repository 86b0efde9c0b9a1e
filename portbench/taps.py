"""Records of the steps that ``correct`` judges, taken from the benchmark's
side of the program.

``Taps`` wraps, at class level and from the benchmark's own file, the two
public methods of the port's window layer whose steps run inside a frame
call: ``WindowManager.run_track`` (the coarse track,
``track_frame_program(x, **static)``: returns (TrackResult, T_wc)) and
``WindowManager.run_ba`` (the window BA, ``ba_program(x, **kw)``: returns
(BAState, energy, Linearization)). A wrapper calls the program's method and,
on a call drawn for the check, keeps copies of the step's inputs (the state
it started from) and outputs, by field name. The packet step is read from
the event pipeline's public state around ``process_events`` (``Window``):
the keyframe it ran against before the call, the tracker state and
residuals it adopted after. ``check_layout`` refuses a port whose methods
or fields these reads name are gone, so that a change of the port's layout
stops the run instead of leaving the check nothing to compare.

The draw is seeded: the first call of each kind in the window, then each
call with the traffic's probability, up to its count. Copies are
device-to-device clones, made only on drawn calls.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch
from torch.utils import _pytree as pytree

KINDS = ("track", "ba", "packet")
# what the reads name in the port, checked before a run
LAYOUT = {
    "WindowManager.run_track": ("x", "static"),
    "WindowManager.run_ba": ("x", "kw"),
    "TrackResult": ("pose", "aff", "ok", "residuals", "passes"),
    "BAState": ("T_eval", "delta", "c_delta", "p_idepth", "HM", "bM",
                "frame_prior", "frame_prior_delta0", "p_prior"),
    "Linearization": ("energy", "oob"),
    "KeyFrame": ("norm_coord", "grad", "idepth", "weight", "mask",
                 "residual"),
    "TrackerState": ("px", "qx", "vx"),
}
KF_FIELDS = ("norm_coord", "grad", "idepth", "weight", "mask")


def clone(tree):
    return pytree.tree_map(
        lambda a: a.detach().clone() if torch.is_tensor(a) else a, tree)


def check_layout(types: dict):
    """Raise where a method or field in ``LAYOUT`` is missing from the
    port's ``types`` ({name: class})."""
    missing = []
    for name, fields in LAYOUT.items():
        owner, _, method = name.partition(".")
        cls = types[owner]
        if method:
            fn = getattr(cls, method, None)
            params = (list(inspect.signature(fn).parameters)[1:]
                      if fn is not None else [])
            if params != list(fields):
                missing.append(f"{name}{tuple(params)}")
            continue
        have = set(getattr(cls, "_fields", ()))
        missing += [f"{name}.{f}" for f in fields if f not in have]
    if missing:
        raise RuntimeError("the port's layout changed; the check reads "
                           f"{missing} (portbench/taps.py)")


class Taps:
    def __init__(self, window_cls, seed: int, plan: dict):
        self.window_cls = window_cls
        self.rng = np.random.default_rng(seed)
        # kind -> (probability, most records)
        self.plan = {k: tuple(plan[k]) for k in KINDS}
        self.records = {k: [] for k in KINDS}
        self.calls = dict.fromkeys(KINDS, 0)
        self.active = False
        self.ctx = {}
        self._orig = {}

    def want(self, kind: str) -> bool:
        if not self.active:
            return False
        self.calls[kind] += 1
        p, most = self.plan[kind]
        n = len(self.records[kind])
        if n >= most:
            return False
        return n == 0 or bool(self.rng.random() < p)

    def discard_failed_tracks(self, ctx: dict):
        """Drop the records of the coarse tracks made at ``ctx`` that the
        program marked not ok (a hypothesis of the try-list that failed,
        whose RMS the program does not use), so that the draw goes on.
        Called after the frame call: the read does not fall in it."""
        self.records["track"] = [
            r for r in self.records["track"]
            if r["ctx"] != ctx or bool(r["res"].ok)]

    def packet_before(self, pipe):
        """Before a packet call: draw it, and keep the keyframe's points it
        will run against. Returns the pending record or None."""
        if pipe.kf is None or not self.want("packet"):
            return None
        return {"ctx": dict(self.ctx),
                "kf": clone({k: getattr(pipe.kf, k) for k in KF_FIELDS})}

    def packet_after(self, pending, pipe, pose, options: dict):
        """After a drawn packet call: keep the tracker state and residuals
        the pipeline adopted, where the gate accepted the solve."""
        if pending is None or pose is None:
            return
        self.records["packet"].append(dict(
            pending, options=options, state=clone(pipe.tracker_state),
            residuals=pipe.kf.residual.clone()))

    def install(self):
        W = self.window_cls
        self._orig = {"run_track": W.run_track, "run_ba": W.run_ba}
        taps = self
        orig = self._orig

        def run_track(win, x, static):
            res, T = orig["run_track"](win, x, static)
            if taps.want("track"):
                taps.records["track"].append({
                    "ctx": dict(taps.ctx), "static": static,
                    "x": clone({k: v for k, v in x.items() if k != "img"}),
                    "res": clone(res)})
            return res, T

        def run_ba(win, x, kw):
            state, e, lin = orig["run_ba"](win, x, kw)
            if taps.want("ba"):
                taps.records["ba"].append({
                    "ctx": dict(taps.ctx), "kw": dict(kw),
                    "state_in": clone(x["state"]),
                    "planes": x["planes"].clone(),
                    "delta": state.delta.clone(),
                    "c_delta": state.c_delta.clone(),
                    "p_idepth": state.p_idepth.clone(),
                    "energy": lin.energy.clone(), "oob": lin.oob.clone()})
            return state, e, lin

        W.run_track = run_track
        W.run_ba = run_ba

    def uninstall(self):
        W = self.window_cls
        if self._orig:
            W.run_track = self._orig["run_track"]
            W.run_ba = self._orig["run_ba"]
            self._orig = {}
