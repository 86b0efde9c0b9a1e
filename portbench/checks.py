"""The numbers that decide ``correct``: each drawn step of the window against
the plain reference (``reference``), from the benchmark's own frames and
packets and the state the step started from; each the largest relative gap
over the drawn steps.

* ``track_rms_gap``: the coarse track (the frame's pose): its finest-level
  RMS against the reference's RMS of the same template at the returned
  pose and affine brightness; over the drawn tracks the program marked ok.
* ``ba_energy_gap``: the window BA's per (point, frame) photometric energy
  at the state it returned (its final linearization, which the sampler
  kernel fed) against the reference's, over the pairs both sides find in
  the image.
* ``ba_solve_gap``: the window BA's step: the photometric energy (float64)
  at the state the program returned against the energy at the state the
  reference's own Gauss-Newton (``reference.ba_solve``) reaches from the
  state the BA started from, with DSO's first-estimate Jacobians, priors,
  damping, gauge projection and stop; the least gap to the reference's
  state at its stop or one step either side of it.
* ``event_residual_gap``: the packet step (the event frame the raster made
  and the event LM's pose): its per-point residuals at the tracker state it
  returned against the reference's, which rasterizes the benchmark's own
  packet; over the drawn packets the gate accepted.

Printed beside them, not compared: the share of the coarse track's and of
the event LM's energy that the reference's own solve still takes off the
program's answer (``reference.track_energy_left``, ``event_energy_left``).
Both solvers stop at an iteration cap, so sound runs leave energy behind
that the control does not exceed by the margin a limit needs.

``readings(records, ..., precision)`` gives each number; with the control
precision the reference at that precision stands in for the program: its
outputs at the program's answers, and its own BA solve.
"""
from __future__ import annotations

import torch

from . import reference as ref


def _aff(rec):
    x, res = rec["x"], rec["res"]
    d = torch.float64
    slot = int(x["slot"][0])
    # the track's pose is refToNew (keyframe to frame); the keyframe's
    # affine brightness and exposure come from the window's state
    aff_kf = (x["aff_eval"] + x["delta"][:, 6:8]).to(d)[slot]
    return ref.aff_from_to(x["exposure"].to(d)[slot], aff_kf,
                           x["exp_new"].to(d), res.aff.to(d))


def _track(rec, pool, P, parts):
    res = rec["res"]
    if not bool(res.ok):
        return None
    static = rec["static"]
    img = pool[rec["ctx"]["seq"]].frames[rec["ctx"]["frame"]][1]
    a, b = _aff(rec)
    cutoff = static["cutoff_th"] * 2.0 ** int(res.passes[0, 0])
    tpl = tuple(rec["x"]["templates"][0])
    cam = static["cams"][0]

    def rms(Q):
        return float(ref.track_rms(img, tpl, cam, res.pose.R, res.pose.t, a,
                                   b, static["huber_th"], cutoff, Q))
    if "left" not in rec:
        rec["left"] = ref.track_energy_left(img, tpl, cam, res.pose.R,
                                            res.pose.t, a, b,
                                            static["huber_th"], cutoff)
    prog = float(res.residuals[0]) if P is ref.REFERENCE else rms(P)
    parts["energy_left"] = max(parts.get("energy_left", 0.0), rec["left"])
    return ref.scalar_gap(prog, rms(ref.REFERENCE))


def _ba_state(rec):
    s = rec["state_in"]
    return {"T_eval_R": s.T_eval.R, "T_eval_t": s.T_eval.t,
            "delta": rec["delta"], "aff_eval": s.aff_eval,
            "exposure": s.exposure, "c_zero": s.c_zero,
            "c_delta": rec["c_delta"], "p_uv": s.p_uv,
            "p_idepth": rec["p_idepth"], "p_idepth_zero": s.p_idepth_zero,
            "p_host": s.p_host, "p_color": s.p_color,
            "p_weight": s.p_weight, "p_status": s.p_status,
            "r_active": s.r_active, "frame_valid": s.frame_valid,
            "frame_energy_th": s.frame_energy_th}


def _ba_prior(rec):
    s = rec["state_in"]
    return {"frame_prior": s.frame_prior,
            "frame_prior_delta0": s.frame_prior_delta0, "HM": s.HM,
            "bM": s.bM, "p_prior": s.p_prior}


def _ba(rec, P, info):
    kw = rec["kw"]
    H, W = kw["height"], kw["width"]
    st = _ba_state(rec)
    e64, use64, _ = ref.ba_pair_energy(st, rec["planes"], H, W,
                                       kw["huber_th"], kw["outlier_th_sum"],
                                       ref.REFERENCE)
    s = rec["state_in"]
    host = s.p_host.long()
    not_host = (torch.arange(s.frame_valid.shape[0], device=host.device)
                [None, :] != host[:, None])
    struct = (s.r_active & (s.p_status[:, None] != 0)
              & s.frame_valid[None, :] & not_host)
    if P is ref.REFERENCE:
        prog, use_prog = rec["energy"], struct & ~rec["oob"]
    else:
        prog, use_prog, _ = ref.ba_pair_energy(st, rec["planes"], H, W,
                                               kw["huber_th"],
                                               kw["outlier_th_sum"], P)
    info["ba_pairs"] = info.get("ba_pairs", 0) + int(use64.sum())
    info["ba_pairs_parted"] = (info.get("ba_pairs_parted", 0)
                               + int((use64 ^ use_prog).sum()))
    return ref.rel_gap(prog, e64, use64 & use_prog)


def _ba_solve(rec, P):
    """The BA's step against the reference's own solve from the state the
    BA started from, by the energy each reaches (float64): the least
    relative gap to the reference's state after the step its stop takes or
    one step either side of it (the stop compares a relative energy gain
    with a tolerance, which two precisions may cross a step apart), never
    its start. With the control precision, the control's own solve, at its
    stop, stands in for the program's answer."""
    kw = rec["kw"]
    st = _ba_state(rec)
    s = rec["state_in"]
    H, W = kw["height"], kw["width"]

    def energy(delta, idp):
        return ref.ba_energy(dict(st, delta=delta, p_idepth=idp),
                             rec["planes"], H, W, kw["huber_th"],
                             kw["outlier_th_sum"])
    s_in = dict(st, delta=s.delta, c_delta=s.c_delta, p_idepth=s.p_idepth)
    if "e_ref" not in rec:
        path, stop = ref.ba_solve(s_in, _ba_prior(rec), rec["planes"], H, W,
                                  kw)
        lo = max(stop - 1, kw["min_iterations"], 1)
        rec["e_ref"] = [energy(*path[k - 1])
                        for k in range(lo, min(stop + 1, len(path)) + 1)]

    def gap(e):
        return min(abs(e - r) / max(r, 1e-300) for r in rec["e_ref"])

    if P is ref.REFERENCE:
        return gap(energy(rec["delta"], rec["p_idepth"]))
    ctl, k = ref.ba_solve(s_in, _ba_prior(rec), rec["planes"], H, W, kw, P)
    return gap(energy(*ctl[k - 1]))


def _packet(rec, pool, cam, P, parts):
    opts = rec["options"]
    if opts["interpolation"] != "bilinear" or opts["refinement"] != "none":
        raise ValueError("the reference covers the bilinear event frame "
                         "without track refinement")
    pk = pool[rec["ctx"]["seq"]].packets[rec["ctx"]["packet"]]
    kf, s = rec["kf"], rec["state"]
    dev = rec["residuals"].device
    xs, ys, ps = (torch.as_tensor(a, device=dev)
                  for a in (pk.xs, pk.ys, pk.polarity))
    kf_in = (kf["norm_coord"], kf["grad"], kf["idepth"], kf["weight"],
             kf["mask"])

    def frame(Q):
        return ref.event_frame(xs, ys, ps, int(pk.n_valid), cam.height,
                               cam.width, opts["time_weighted"],
                               opts["blur_ksize"], Q)

    def residuals(Q, fr):
        return ref.event_residuals(fr, cam, *kf_in, s.px, s.qx, s.vx, Q)
    f64 = frame(ref.REFERENCE)
    r64 = residuals(ref.REFERENCE, f64)
    if "left" not in rec:
        rec["left"] = ref.event_energy_left(f64, cam, *kf_in, s.px, s.qx,
                                            s.vx)
    parts["energy_left"] = max(parts.get("energy_left", 0.0), rec["left"])
    prog = (rec["residuals"] if P is ref.REFERENCE
            else residuals(P, frame(P)))
    return ref.rel_gap(prog, r64, kf["mask"])


def readings(records, pool, cam, events: bool, precision=ref.REFERENCE):
    """({number: largest gap over the drawn steps, or None where no drawn
    step could be compared}, {number: steps compared}, info): ``info``
    holds what is printed beside them (the largest energy left by the
    coarse track and by the event LM)."""
    info = {}
    out, counts = {}, {}
    jobs = [("track_rms_gap", records["track"],
             lambda r, p: _track(r, pool, precision, p)),
            ("ba_energy_gap", records["ba"],
             lambda r, p: _ba(r, precision, info)),
            ("ba_solve_gap", records["ba"],
             lambda r, p: _ba_solve(r, precision))]
    if events:
        jobs.append(("event_residual_gap", records["packet"],
                     lambda r, p: _packet(r, pool, cam, precision, p)))
    with torch.no_grad():
        for name, recs, fn in jobs:
            parts = {}
            gaps = [g for g in (fn(r, parts) for r in recs) if g is not None]
            counts[name] = len(gaps)
            out[name] = max(gaps) if gaps else None
            if parts:
                info[name] = parts
    return out, counts, info


def verdict(readings_, limits):
    """(correct, {number: {value, limit}}): correct where every number was
    read and lies within its limit."""
    lines = {name: {"value": v, "limit": limits[name]}
             for name, v in readings_.items()}
    ok = all(v is not None and v <= limits[name]
             for name, v in readings_.items())
    return ok, lines
