#!/usr/bin/env python3
"""The port's two kernels against an earlier version of them, in one process
on one card, on the main path's inputs.

``--parent DIR`` names a checkout of the earlier version (its
``slam_eds_tpu_torch/csrc`` sources, with the C interface they had when the
raster used a global int64 scratch and the sampler one thread per tap:
``rasterize_launch(xs, ys, vals, E, H, W, acc, out, stream)`` and
``pattern_sample_launch(planes, sF, sH, sW, F, H, W, K, N, u, v, I, gx, gy,
ok, stream)``). Both are built with the port's nvcc flags. ``--kernels
sampler`` (or ``raster``) times one kernel only, for a parent whose other
kernel has another interface.

Inputs: the sampler's path taps (one ``energy.linearize`` call on
``chip_smoke.py``'s BA world: F=8, P=2048, K=8, 640x480), read from the
[F, H, W, 3] stack's channel 0 in place and from a planar [F, H, W] copy;
the sampler's taps of one rank of the sharded dry run ([2048, 8, 8] on an
[8, 96, 128, 3] stack); the raster's largest packet of the event cell
(65,536 lanes, time weights and mask applied). Each version's device time per call comes from
``torch.profiler`` (every device activity, summed), in the order earlier,
current, current, earlier; the outputs of the two versions must be bitwise
equal (the sampler's on ok taps). One JSON line per kernel and input, and
the card's name and power limit. Imports no JAX.

    python3 tools/kernel_bench.py [--parent DIR] [--kernels sampler|raster]
        [--out f.json]
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import build  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import pattern_sample as ps  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import rasterize as rz  # noqa: E402


def build_parent(parent: Path, name: str):
    src = parent / "slam_eds_tpu_torch" / "csrc" / f"{name}.cu"
    out = parent / "slam_eds_tpu_torch" / "_build" / f"lib{name}-parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                    "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def parent_sampler(lib):
    fn = lib.pattern_sample_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int

    def call(planes, u, v):
        pl = planes[..., 0] if planes.dim() == 4 else planes
        F, H, W = pl.shape
        out = [torch.empty_like(u) for _ in range(3)]
        ok = torch.empty(u.shape, dtype=torch.bool, device=u.device)
        rc = fn(pl.data_ptr(), *pl.stride(), F, H, W, u.shape[2], u.numel(),
                u.data_ptr(), v.data_ptr(), *(o.data_ptr() for o in out),
                ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent sampler launch failed: {rc}")
        return (*out, ok)
    return call


def parent_raster(lib):
    fn = lib.rasterize_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def call(xs, ys, vals, H, W):
        acc = torch.empty(H * W, dtype=torch.int64, device=xs.device)
        out = torch.empty((H, W), dtype=torch.float32, device=xs.device)
        rc = fn(xs.data_ptr(), ys.data_ptr(), vals.data_ptr(), xs.numel(),
                H, W, acc.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent raster launch failed: {rc}")
        return out
    return call


def timed(versions):
    """Device us per call and activities per call of each version, in the
    order a, b, b, a (means of the two)."""
    names = list(versions)
    order = names + names[::-1]
    runs = {n: [] for n in names}
    for n in order:
        runs[n].append(cs.device_profile(versions[n]))
    return {n: {"device_us": sum(r[0] for r in rs) / len(rs),
                "device_us_runs": [r[0] for r in rs],
                "activities_per_call": rs[0][1]} for n, rs in runs.items()}


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--kernels", choices=("both", "sampler", "raster"),
                    default="both")
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args()
    do_sampler = args.kernels in ("both", "sampler")
    do_raster = args.kernels in ("both", "raster")
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: needs a CUDA device")
    dev = cs.phase_device()
    cs.build_kernels()
    old_ps = old_rz = None
    if args.parent and do_sampler:
        old_ps = parent_sampler(build_parent(args.parent, "pattern_sample"))
    if args.parent and do_raster:
        old_rz = parent_raster(build_parent(args.parent, "rasterize"))
    results = {"gpu": cs.gpu_name_and_power_limit()}
    if do_sampler:
        bench_sampler(dev, old_ps, results)
    if do_raster:
        bench_raster(dev, old_rz, results)
    print(results["gpu"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


def rank_taps(dev, ranks=2):
    """(the [F, H, W, 3] stack, Ku, Kv) of one ``linearize`` of rank 0's
    block of the sharded dry run's world (``chip_smoke.py``'s per-rank
    shape)."""
    from slam_eds_tpu_torch.models import ba_state as bs
    from slam_eds_tpu_torch.parallel import dryrun
    from slam_eds_tpu_torch.parallel.sharded_ba import shard_state
    world = dryrun.dryrun_world(ranks)
    images = torch.as_tensor(world.pop("images"), device=dev)
    state = bs.from_numpy({k: v for k, v in world.items()
                           if not k.startswith("ev_")}, device=dev)
    return cs.record_taps(shard_state(state, 0, ranks), images, dryrun.H,
                          dryrun.W)


def bench_sampler(dev, old_ps, results):
    """The main path's taps on the [F, H, W, 3] stack and on the planar
    intensity, then the per-rank taps."""
    planar, pu, pv = cs.linearize_taps(dev)
    stack = cs.build_ba_problem(dev)[1]             # the [F, H, W, 3] stack
    rank = rank_taps(dev)
    for layout, planes, pu, pv in (("stack", stack, pu, pv),
                                   ("planar", planar, pu, pv),
                                   ("per_rank", *rank)):
        n = pu.numel()
        texels = cs.sampler_texels(planes, pu, pv)
        nbytes = n * 8 + n * 13 + texels * 4
        versions = {"current": lambda p=planes: ps.pattern_sample_cuda(
            p, pu, pv)}
        if old_ps:
            versions = {"parent": lambda p=planes: old_ps(p, pu, pv),
                        **versions}
            a, b = old_ps(planes, pu, pv), ps.pattern_sample_cuda(planes, pu,
                                                                  pv)
            ok = a[3]
            if not (torch.equal(ok, b[3]) and all(
                    torch.equal(x[ok], y[ok]) for x, y in zip(a[:3], b[:3]))):
                sys.exit("kernel_bench: the sampler versions disagree")
        t = timed(versions)
        roof = cs.roofline(nbytes, n * cs.SAMPLER_OPS_PER_TAP,
                           t["current"]["device_us"])
        results[f"pattern_sample_{layout}"] = {
            "taps": n, "planes": list(planes.shape), "distinct_texels": texels,
            **t, **roof,
            "share_of_bound_parent": (roof["bound_us"]
                                      / t["parent"]["device_us"]
                                      if "parent" in t else None)}
        print(json.dumps({f"pattern_sample_{layout}":
                          results[f"pattern_sample_{layout}"]}), flush=True)
    lib_call, _ = cs.grid_sample_yardstick(stack, *cs.linearize_taps(dev)[1:])
    results["grid_sample_us"] = cs.device_us(lib_call)
    print(json.dumps({"grid_sample_us": results["grid_sample_us"]}),
          flush=True)


def bench_raster(dev, old_rz, results):
    xs, ys, vals, H, W, _ = cs.raster_cases(dev, cs.eds_inputs(dev)[3])[
        "packet"]
    versions = {"current": lambda: rz.rasterize_bilinear_cuda(xs, ys, vals,
                                                              H, W)}
    if old_rz:
        versions = {"parent": lambda: old_rz(xs, ys, vals, H, W), **versions}
        if not torch.equal(old_rz(xs, ys, vals, H, W),
                           rz.rasterize_bilinear_cuda(xs, ys, vals, H, W)):
            sys.exit("kernel_bench: the raster versions disagree")
    # the current kernel at other geometries: one cluster or as many as
    # the card holds, clusters of 16 or 8, 256 to 1024 threads per block
    lib = rz.load().lib
    for cluster in rz.CLUSTER_SIZES:
        for threads in (256, 512, 1024):
            n = ctypes.c_int(0)
            g1 = rz.launch_geometry(H, W, cluster, threads=threads)
            lib.rasterize_max_active_clusters(
                g1.cluster, g1.bands, g1.threads, g1.bytes_per_block,
                ctypes.byref(n))
            for g in {g1, rz.launch_geometry(H, W, cluster, max(n.value, 1),
                                             threads)}:
                out = torch.empty((H, W), device=dev)

                def call(g=g, out=out):
                    rc = lib.rasterize_launch(
                        xs.data_ptr(), ys.data_ptr(), vals.data_ptr(),
                        xs.numel(), H, W, g.cluster, g.bands,
                        g.rows_per_band, g.slice_px, g.threads,
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"raster launch failed at {g}")
                versions[f"geometry {tuple(g)}, max active {n.value}"] = call
    # the fixed cost: 64 events, and the packet's loads with no tap to add
    few = [a[:64].contiguous() for a in (xs, ys, vals)]
    zero = torch.zeros_like(vals)
    for name, (a, b, c) in (("64 events", few), ("zero values",
                                                (xs, ys, zero))):
        versions[f"current, {name}"] = (
            lambda a=a, b=b, c=c: rz.rasterize_bilinear_cuda(a, b, c, H, W))
        if old_rz:
            versions[f"parent, {name}"] = (
                lambda a=a, b=b, c=c: old_rz(a, b, c, H, W))
    t = timed(versions)
    E = xs.numel()
    roof = cs.roofline(E * 12 + H * W * 4, E * cs.RASTER_OPS_PER_EVENT,
                       t["current"]["device_us"])
    results["rasterize_bilinear"] = {
        "events": E, "geometry": rz.card_geometry(H, W)._asdict(), **t,
        **roof, "share_of_bound_parent": (roof["bound_us"]
                                          / t["parent"]["device_us"]
                                          if "parent" in t else None)}
    print(json.dumps({"rasterize_bilinear": results["rasterize_bilinear"]}),
          flush=True)


if __name__ == "__main__":
    main()
