#!/usr/bin/env python3
"""How far the sharded paths land from their 1-rank runs, on the CPU.

``--cell ba`` (the default) runs the lifecycle of ``parallel/dryrun.py``
(BA, point marginalization, frame marginalization, activation;
``--cycles`` cycles, window 8, 128x96)
on ``dryrun_world``'s seeded world at ``--points`` points per rank, on
``--ranks`` ranks and on one, and prints one JSON line per variant with
the gaps that the JAX dry run bounds (``__graft_entry__.py:170-193``):
bM and HM as a share of their scale, the first and last deltas as a share
of theirs, the largest idepth gap and the energies' relative gap.

* ``--package jax``: the JAX package's ``ba_iterate_sharded`` /
  ``marginalize_points_sharded`` (float32) on meshes of ``--ranks`` and of
  one of 8 virtual CPU devices, in this process.
* ``--package port``: the port's on spawned gloo ranks, once as committed
  (float64 assembly, sums and solve) and once with the float32 assembly,
  sums and solve of the JAX module (``sharded_ba._as`` made the identity
  in every rank).

``--cell event`` runs the port's ``parallel/dryrun.entry`` event solve
(640x480, P=2,048) for each of ``--iterations`` LM iterations, once on one
process with ``--threads`` torch threads and once point-sharded over
``--ranks`` gloo ranks, and prints one JSON line each: the largest px, qx
and vx gaps, |vx|, the residuals' gap and the energy's relative gap (the
quantities ``chip_smoke.py``'s ``parallel`` phase bounds on the card).

    python3 tools/sharded_rank_noise.py --package jax --points 256
    python3 tools/sharded_rank_noise.py --package port --points 256
    python3 tools/sharded_rank_noise.py --cell event --iterations 1 5 10
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gaps(n: dict, one: dict) -> dict:
    """The JAX dry run's compared quantities, as shares of their bounds'
    scales: n-rank run against 1-rank run."""
    rel = lambda a, b, s: float(np.abs(np.asarray(a, np.float64)  # noqa
                                       - np.asarray(b, np.float64)).max() / s)
    return {
        "bM": rel(n["bM"], one["bM"], np.abs(one["bM"]).max() + 1.0),
        "HM": rel(n["HM"], one["HM"], np.abs(one["HM"]).max() + 1.0),
        "first_delta": rel(n["first_delta"], one["first_delta"],
                           np.abs(one["first_delta"]).max() + 1e-3),
        "delta": rel(n["delta"], one["delta"],
                     np.abs(one["delta"]).max() + 1e-3),
        "idepth_abs": rel(n["p_idepth"], one["p_idepth"], 1.0),
        "energy": max(abs(a - b) / max(abs(b), 1.0)
                      for a, b in zip(n["energies"], one["energies"])),
        "bounds": {"bM": 1e-3, "HM": 2e-4, "first_delta": 0.15,
                   "delta": 0.15, "idepth_abs": 2e-2, "energy": 1e-3}}


def _summary(state: dict, energies, first_delta) -> dict:
    return {"bM": state["bM"], "HM": state["HM"], "delta": state["delta"],
            "p_idepth": state["p_idepth"], "energies": energies,
            "first_delta": first_delta}


def jax_lifecycle(world: dict, n_devices: int, cycles: int) -> dict:
    """The JAX dry run's lifecycle on a mesh of ``n_devices``."""
    import jax
    import jax.numpy as jnp
    from slam_eds_tpu.models import ba_state as bs
    from slam_eds_tpu.ops import energy
    from slam_eds_tpu.parallel import sharded_ba
    from slam_eds_tpu.utils.lie import SE3

    F, H, W = world["images"].shape[:3]
    P = world["p_idepth"].shape[0]
    fields = {k: jnp.asarray(v) for k, v in world.items()
              if k in bs.BAState._fields}
    state = bs.BAState(T_eval=SE3(jnp.asarray(world["T_eval.R"]),
                                  jnp.asarray(world["T_eval.t"])), **fields)
    images = jnp.asarray(world["images"])
    mesh = sharded_ba.make_mesh(jax.devices()[:n_devices])
    marg_frame = jax.jit(energy.marginalize_frame, static_argnames=("slot",))
    r2 = np.random.default_rng(99)
    st = sharded_ba.shard_state(state, mesh)
    es, first_delta = [], None
    for cycle in range(cycles):
        st, e = sharded_ba.ba_iterate_sharded(st, images, mesh, H, W,
                                              iterations=2)
        es.append(float(e))
        if first_delta is None:
            first_delta = np.asarray(st.delta).copy()
        stat = np.asarray(st.p_status).copy()
        act = np.where((stat == bs.PT_ACTIVE)
                       & (np.asarray(st.p_host) == cycle))[0]
        stat[act[::3]] = bs.PT_MARGINALIZE
        put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                       st.p_idepth.sharding)
        st = st._replace(p_status=put(stat))
        st = sharded_ba.marginalize_points_sharded(st, images, mesh, H, W)
        st = marg_frame(st, slot=cycle)
        stat = np.array(st.p_status)
        free = np.where(stat == bs.PT_EMPTY)[0][: P // 16]
        if len(free):
            host_new = cycle + 1
            stat[free] = bs.PT_ACTIVE
            uv = np.asarray(st.p_uv).copy()
            uv[free] = np.stack([r2.uniform(6, W - 6, len(free)),
                                 r2.uniform(6, H - 6, len(free))], -1)
            ract = np.asarray(st.r_active).copy()
            ract[free] = np.asarray(st.frame_valid)
            ract[free, host_new] = False
            hosts = np.asarray(st.p_host).copy()
            hosts[free] = host_new
            st = st._replace(p_status=put(stat), p_uv=put(uv),
                             p_host=put(hosts),
                             r_active=jax.device_put(jnp.asarray(ract),
                                                     st.r_active.sharding))
    state = {k: np.asarray(getattr(st, k))
             for k in ("bM", "HM", "delta", "p_idepth")}
    return _summary(state, es, first_delta)


def port_rank(group, world, cycles, float32):
    """One rank of the port's dry-run lifecycle; with ``float32`` the
    sharded BA keeps the JAX module's float32 assembly, sums and solve."""
    from slam_eds_tpu_torch.parallel import dryrun, sharded_ba
    if float32:
        sharded_ba._as = lambda dtype, tup: tup
    dryrun.CYCLES = cycles
    out = dryrun.lifecycle_rank(group, world, False)
    st = out["state"]
    state = {k: getattr(st, k) for k in ("bM", "HM", "delta", "p_idepth")}
    return _summary(state, [float(e) for e in out["energies"]],
                    out["first_delta"])


ENTRY_CAMERA = (400.0, 400.0, 319.5, 239.5, 640, 480)   # dryrun.entry's


def event_rank(group, args, iterations):
    """One rank of the sharded ``entry`` event solve."""
    import torch
    from slam_eds_tpu_torch.ops import event_tracker as et
    from slam_eds_tpu_torch.parallel import block
    from slam_eds_tpu_torch.parallel.sharded_event_tracker import (
        optimize_sharded)
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    state, ef, *points = args
    loc = [block(torch.as_tensor(a), group.rank, group.world_size)
           for a in points]
    res = optimize_sharded(et.state_from_numpy(state, device="cpu"),
                           torch.as_tensor(ef), Pinhole(*ENTRY_CAMERA),
                           *loc, group, max_iterations=iterations)
    return {"state": res.state, "energy": res.energy,
            "residuals": res.residuals}


def event_gaps(a):
    """The sharded entry solve against the single one, per iteration
    count."""
    import torch
    from slam_eds_tpu_torch.ops import event_tracker as et
    from slam_eds_tpu_torch.parallel import dryrun, run_ranks
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    torch.set_num_threads(a.threads)
    step, args = dryrun.entry("cpu")
    args_np = [et.state_to_numpy(args[0])] + [x.numpy() for x in args[1:]]
    for it in a.iterations:
        ref = et.optimize(*args[:2], Pinhole(*ENTRY_CAMERA),
                          *args[2:], max_iterations=it)
        outs = run_ranks(event_rank, a.ranks, args_np, it, device="cpu")
        got = outs[0]
        res = np.concatenate([o["residuals"] for o in outs])
        gap = lambda x, y: float(np.abs(x - y.numpy()).max())  # noqa
        print(json.dumps({
            "cell": "event", "ranks": a.ranks, "threads": a.threads,
            "iterations": it,
            "px": gap(got["state"].px, ref.state.px),
            "qx": gap(got["state"].qx, ref.state.qx),
            "vx": gap(got["state"].vx, ref.state.vx),
            "vx_abs": float(ref.state.vx.abs().max()),
            "residuals": gap(res, ref.residuals),
            "energy_rel": abs(float(got["energy"]) - float(ref.energy))
            / abs(float(ref.energy))}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=("ba", "event"), default="ba")
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--points", type=int, default=2048,
                    help="points per rank")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--iterations", type=int, nargs="+", default=[10])
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args()
    if a.cell == "event":
        return event_gaps(a)

    if a.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    from slam_eds_tpu_torch.parallel import dryrun
    dryrun.POINTS_PER_RANK = a.points
    world = dryrun.dryrun_world(a.ranks)
    base = {"package": a.package, "points_per_rank": a.points,
            "ranks": a.ranks, "cycles": a.cycles}
    if a.package == "jax":
        t0 = time.perf_counter()
        n = jax_lifecycle(world, a.ranks, a.cycles)
        one = jax_lifecycle(world, 1, a.cycles)
        print(json.dumps({**base, "dtype": "float32",
                          "seconds": time.perf_counter() - t0,
                          **gaps(n, one)}), flush=True)
        return
    from slam_eds_tpu_torch.parallel import run_ranks
    for float32 in (True, False):
        t0 = time.perf_counter()
        n = run_ranks(port_rank, a.ranks, world, a.cycles, float32,
                      device="cpu")[0]
        one = run_ranks(port_rank, 1, world, a.cycles, float32,
                        device="cpu")[0]
        print(json.dumps({**base,
                          "dtype": "float32" if float32 else "float64",
                          "seconds": time.perf_counter() - t0,
                          **gaps(n, one)}), flush=True)


if __name__ == "__main__":
    main()
