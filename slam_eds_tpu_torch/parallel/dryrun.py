"""Entry points of the sharded paths: a single-card event solve and the
multi-rank dry run — port of the JAX package's ``__graft_entry__.py``.

``entry(device)`` returns the flagship step, one event-to-model alignment
solve at 640x480 with 2,048 points, and its example arguments.

``dryrun_multichip(n, device)`` runs two full window-lifecycle cycles (BA ->
point marginalization -> frame marginalization -> activation into freed
slots) with the point axis split over ``n`` ranks at 2,048 points per rank
(window 8, 128x96 images), then the same two cycles on one rank holding all
the points, and holds the two to the JAX dry run's bounds; then one
point-sharded event solve. Every replicated tensor must come out bitwise
equal on all ranks.

    python -m slam_eds_tpu_torch.parallel.dryrun [--ranks N] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import ba_state as bs
from ..ops import energy
from ..ops import event_tracker as et
from ..ops.kernels.pattern_sample import pattern_sample
from ..utils.cameras import Pinhole
from ..utils.lie import SE3
from . import Group, block, default_backend, run_ranks
from .sharded_ba import (ba_iterate_sharded, gather_state,
                         marginalize_points_sharded, shard_state)
from .sharded_event_tracker import optimize_sharded

F, H, W = 8, 96, 128        # small images keep the CPU dry run quick; the
POINTS_PER_RANK = 2048      # per-point program shape is the same
CALIB = [110.0, 110.0, 63.5, 47.5]
CYCLES = 2
BA_ITERATIONS = 2
EVENT_ITERATIONS = 4


def entry(device="cuda"):
    """(fn, example_args): one event solve (``event_tracker.optimize``, 10
    iterations) at 640x480 with P=2,048 points, the JAX entry's inputs."""
    dev = resolve_device(device)
    Hc, Wc, P = 480, 640, 2048
    cam = Pinhole(400.0, 400.0, Wc / 2 - 0.5, Hc / 2 - 0.5, Wc, Hc)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    event_frame = t(rng.normal(size=(Hc, Wc)) * 0.01)
    nc = t(np.stack([(rng.uniform(10, Wc - 10, P) - cam.cx) / cam.fx,
                     (rng.uniform(10, Hc - 10, P) - cam.cy) / cam.fy], -1))
    grad = t(rng.normal(size=(P, 2)) * 20)
    idp = t(rng.uniform(0.3, 1.0, P))
    weights = torch.ones(P, dtype=torch.float32, device=dev)
    mask = torch.ones(P, dtype=torch.bool, device=dev)
    state = et.initial_tracker_state(dev)

    def step(state, event_frame, nc, grad, idp, weights, mask):
        res = et.optimize(state, event_frame, cam, nc, grad, idp, weights,
                          mask, max_iterations=10)
        return res.state, res.energy, res.residuals

    return step, (state, event_frame, nc, grad, idp, weights, mask)


def dryrun_world(n_ranks: int) -> dict:
    """The dry run's seeded inputs as numpy arrays, drawn in the JAX dry
    run's order from ``default_rng(0)``: BAState fields (pose as
    'T_eval.R'/'T_eval.t') at P = 2,048 x n_ranks, the [F, H, W, 3] image
    stack ('images') and the event solve's arrays ('ev_*')."""
    P = POINTS_PER_RANK * n_ranks
    rng = np.random.default_rng(0)
    st = bs.empty_state(F, P, CALIB, device="cpu")
    T = SE3.exp(torch.as_tensor(rng.uniform(-0.02, 0.02, (F, 6)),
                                dtype=torch.float32))
    uv = np.stack([rng.uniform(6, W - 6, P), rng.uniform(6, H - 6, P)], -1)
    hosts = rng.integers(0, F - 1, P)
    r_act = np.ones((P, F), bool)
    r_act[np.arange(P), hosts] = False
    prior = np.zeros((F, 8), np.float32)
    prior[0, :6] = 1e8
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    st = st._replace(
        T_eval=T, frame_valid=torch.ones(F, dtype=torch.bool),
        p_uv=f32(uv), p_idepth=f32(rng.uniform(0.3, 1.0, P)),
        p_idepth_zero=f32(rng.uniform(0.3, 1.0, P)),
        p_color=f32(rng.uniform(20, 200, (P, 8))),
        p_status=torch.full((P,), bs.PT_ACTIVE, dtype=torch.int32),
        p_host=torch.as_tensor(hosts, dtype=torch.int32),
        r_active=torch.as_tensor(r_act), frame_prior=f32(prior))
    world = bs.to_numpy(st)
    world["images"] = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
    world["ev_frame"] = (rng.normal(size=(H, W)) * 0.01).astype(np.float32)
    world["ev_nc"] = np.stack([rng.uniform(-0.4, 0.4, P),
                               rng.uniform(-0.3, 0.3, P)], -1).astype(
                                   np.float32)
    world["ev_grad"] = (rng.normal(size=(P, 2)) * 10).astype(np.float32)
    return world


def _activate(full: bs.BAState, cycle: int, rng) -> bs.BAState:
    """Re-fill up to P/16 freed point slots with new points hosted on the
    next frame: the host-side activation policy's commit, on the whole
    state, as the JAX dry run does it."""
    P = full.num_points
    stat = full.p_status.cpu().numpy().copy()
    free = np.where(stat == bs.PT_EMPTY)[0][: P // 16]
    if not len(free):
        return full
    host_new = cycle + 1
    stat[free] = bs.PT_ACTIVE
    uv = full.p_uv.cpu().numpy().copy()
    uv[free] = np.stack([rng.uniform(6, W - 6, len(free)),
                         rng.uniform(6, H - 6, len(free))], -1)
    ract = full.r_active.cpu().numpy().copy()
    ract[free] = full.frame_valid.cpu().numpy()
    ract[free, host_new] = False
    hosts = full.p_host.cpu().numpy().copy()
    hosts[free] = host_new
    dev = full.p_uv.device
    return full._replace(p_status=torch.as_tensor(stat, device=dev),
                         p_uv=torch.as_tensor(uv, device=dev),
                         p_host=torch.as_tensor(hosts, device=dev),
                         r_active=torch.as_tensor(ract, device=dev))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lifecycle_rank(group: Group, world: dict, event_solve: bool) -> dict:
    """One rank of the dry run: the two cycles on this rank's point block
    (the same seeded host-side mutations on every rank count), then, with
    ``event_solve``, the point-sharded event solve. Returns the whole final
    state, the per-cycle energies and BA seconds, the first post-BA delta,
    the sampler's launches in this rank and the event result."""
    dev, rank, n = group.device, group.rank, group.world_size
    state = bs.from_numpy({k: v for k, v in world.items()
                           if k != "images" and not k.startswith("ev_")},
                          device=dev)
    images = torch.as_tensor(world["images"], device=dev)
    rng = np.random.default_rng(99)
    st = shard_state(state, rank, n)
    energies, ba_seconds, first_delta = [], [], None
    pattern_sample.launches = 0
    for cycle in range(CYCLES):
        _sync(dev)
        t0 = time.perf_counter()
        st, e = ba_iterate_sharded(st, images, group, H, W,
                                   iterations=BA_ITERATIONS)
        _sync(dev)
        ba_seconds.append(time.perf_counter() - t0)
        energies.append(e)
        if first_delta is None:
            first_delta = st.delta.clone()
        # flag a third of the dying frame's points, marginalize them, then
        # Schur-eliminate the frame (replicated math on HM/bM)
        full = gather_state(st, group)
        stat = full.p_status.cpu().numpy().copy()
        act = np.where((stat == bs.PT_ACTIVE)
                       & (full.p_host.cpu().numpy() == cycle))[0]
        stat[act[::3]] = bs.PT_MARGINALIZE
        st = st._replace(p_status=block(torch.as_tensor(stat, device=dev),
                                        rank, n))
        st = marginalize_points_sharded(st, images, group, H, W)
        st = energy.marginalize_frame(st, slot=cycle)
        st = shard_state(_activate(gather_state(st, group), cycle, rng),
                         rank, n)
    launches = pattern_sample.launches
    out = {"state": gather_state(st, group), "energies": energies,
           "ba_seconds": ba_seconds, "first_delta": first_delta,
           "launches": launches, "backend": group.backend}
    if event_solve:
        cam = Pinhole(40.0, 40.0, 23.5, 15.5, W, H)
        t = lambda k: block(torch.as_tensor(world[k], device=dev), rank, n)  # noqa
        P = state.num_points
        res = optimize_sharded(
            et.initial_tracker_state(dev),
            torch.as_tensor(world["ev_frame"], device=dev), cam,
            t("ev_nc"), t("ev_grad"),
            block(torch.full((P,), 0.5, device=dev), rank, n),
            block(torch.ones(P, device=dev), rank, n),
            block(torch.ones(P, dtype=torch.bool, device=dev), rank, n),
            group, max_iterations=EVENT_ITERATIONS)
        out["event"] = {"state": res.state, "energy": res.energy,
                        "n_iter": res.n_iter, "loss_scale": res.loss_scale}
    return out


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _replicated_tensors(out: dict) -> dict:
    """A dry-run rank's tensors that must be equal on every rank."""
    st = out["state"]
    rep = {"delta": st.delta, "c_delta": st.c_delta, "HM": st.HM,
           "bM": st.bM, "first_delta": out["first_delta"],
           "frame_valid": st.frame_valid}
    rep.update({f"energy_{i}": e for i, e in enumerate(out["energies"])})
    if "event" in out:
        ev = out["event"]
        rep.update({"event_energy": ev["energy"],
                    "event_loss_scale": ev["loss_scale"],
                    **{f"event_{k}": v for k, v in ev["state"]._asdict()
                       .items()}})
    return rep


def _check_replicated(outs) -> None:
    """Raise unless every replicated tensor is bitwise equal on all ranks."""
    ref = _replicated_tensors(outs[0])
    for r, out in enumerate(outs[1:], 1):
        for k, v in _replicated_tensors(out).items():
            a, b = np.asarray(ref[k]), np.asarray(v)
            _check(a.shape == b.shape and a.tobytes() == b.tobytes(),
                   f"replicated {k} differs between rank 0 and rank {r}")


def dryrun_multichip(n_ranks: int, device="cuda", store_dir=None) -> dict:
    """The dry run on ``n_ranks`` ranks and on one (see the module
    docstring); raises when a bound is broken. Both runs join over the
    backend that ``n_ranks`` ranks take, so that their times differ in the
    rank count only. Returns a report: energies, BA seconds per call,
    sampler launches per rank and the process group's backend of both runs,
    and the event solve's energy."""
    world = dryrun_world(n_ranks)
    backend = default_backend(n_ranks, device)
    outs_n = run_ranks(lifecycle_rank, n_ranks, world, True, device=device,
                       store_dir=store_dir, backend=backend)
    _check_replicated(outs_n)
    outs_1 = run_ranks(lifecycle_rank, 1, world, False, device=device,
                       store_dir=store_dir, backend=backend)
    st, st1 = outs_n[0]["state"], outs_1[0]["state"]
    es_n = [float(e) for e in outs_n[0]["energies"]]
    es_1 = [float(e) for e in outs_1[0]["energies"]]
    _check(np.isfinite(es_n).all(), f"non-finite BA energy {es_n}")
    _check(np.isfinite(st.HM).all(), "non-finite HM")
    _check(not st.frame_valid[0], "frame 0 was not marginalized")
    # the JAX dry run's bounds (__graft_entry__.py:170-193): in float32 the
    # rank count moves the sums' rounding and the solve's near-gauge
    # directions amplify it, hence deltas scale-relative; the float64 sums
    # of sharded_ba keep the runs far inside them
    d1_n, d1_1 = outs_n[0]["first_delta"], outs_1[0]["first_delta"]
    d1s = np.abs(d1_1).max() + 1e-3
    _check(np.abs(d1_n - d1_1).max() < 0.15 * d1s,
           f"post-BA deltas diverged: {np.abs(d1_n - d1_1).max()} vs {d1s}")
    hm_scale = np.abs(st1.HM).max() + 1.0
    _check(np.allclose(st.HM, st1.HM, atol=2e-4 * hm_scale),
           "sharded HM != single-rank")
    bm_scale = np.abs(st1.bM).max() + 1.0
    bm_diff = np.abs(st.bM - st1.bM).max()
    _check(bm_diff < 1e-3 * bm_scale,
           f"sharded bM != single-rank ({bm_diff} vs scale {bm_scale})")
    dscale = np.abs(st1.delta).max() + 1e-3
    _check(np.abs(st.delta - st1.delta).max() < 0.15 * dscale,
           "sharded frame deltas != single-rank")
    _check(np.allclose(st.p_idepth, st1.p_idepth, atol=2e-2),
           "sharded idepths != single-rank")
    for a, b in zip(es_n, es_1):
        _check(abs(a - b) <= 1e-3 * max(abs(b), 1.0),
               f"sharded energy {a} != single-rank {b}")
    ev_e = float(outs_n[0]["event"]["energy"])
    _check(np.isfinite(ev_e), "non-finite event energy")
    print(f"dryrun_multichip({n_ranks}): OK, energy={es_n[-1]:.3f}, "
          f"event_energy={ev_e:.5f}", flush=True)
    return {"ranks": n_ranks, "backend": outs_n[0]["backend"],
            "backend_1": outs_1[0]["backend"],
            "points": st.p_idepth.shape[0],
            "energies": es_n, "energies_1": es_1,
            "ba_seconds": [o["ba_seconds"] for o in outs_n],
            "ba_seconds_1": outs_1[0]["ba_seconds"],
            "launches": [int(o["launches"]) for o in outs_n],
            "launches_1": int(outs_1[0]["launches"]),
            "event_energy": ev_e,
            "event_n_iter": int(outs_n[0]["event"]["n_iter"])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    fn, args = entry(a.device)
    fn(*args)
    print("entry: OK")
    dryrun_multichip(a.ranks, a.device)
