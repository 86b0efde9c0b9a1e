#!/usr/bin/env python3
"""Which rounding order does ``torch.linalg.lu_factor_ex`` take for one
system on the card (cuSOLVER's getrf)?

1. Lists the kernels that ``lu_factor_ex`` launches for one system at n =
   6, 7, 8 and 12 in float32 and float64 (``torch.profiler`` kernel names,
   launches and device us per call).
2. Factors seeded systems with each candidate order of
   ``tools/lu_order_probe.cu`` (right-looking, left-looking, LAPACK's
   recursive getrf2 and blocked forms; fused, unfused or summed updates;
   reciprocal or division; see the .cu file's header) and compares factors
   and pivots bit for bit with ``lu_factor_ex`` called on each system
   alone, at every n of ``--sizes``, in float32 and float64, on the two
   draws of ``chip_smoke.solve_systems``: ``path`` (``J^T J + lam
   diag(J^T J) + 1e-10 I`` as the LM loops build their systems) and
   ``general`` (``N(0, 1) + 0.05 I``, which needs row swaps).
3. Solves the same systems, with a seeded right-hand side, with the port's
   small solve kernel (``ops.kernels.lu_solve.small_solve_cuda``, all of
   one n in one launch, each system as if alone) and compares x bit for
   bit with ``torch.linalg.solve_ex`` called on each system alone.
4. Times the small solve at n = 6, 7, 8 and 12 (one system, device us per
   launch under the profiler, alternating rounds) as it ships (an
   exact-size instance: n a constant, no predicate) against the generic
   width that would take n without it (``tools/small_solve_instances.cu``:
   the same body unrolled over 8 or 16, each step predicated on n), and
   checks that the two give the same bits.

Prints one line per dtype and draw (per candidate: the sizes where it is
bitwise, its mismatching systems, of those whose pivots differ, and the
largest relative gap where the pivots agree; the kernel's mismatching
systems per n), the instance times, then the card's name and power limit;
writes everything to ``--out`` (JSON). Imports no JAX. Its finding (an
H100 with torch 2.11 and CUDA 12.8: right-looking, fused updates, the
reciprocal, bitwise at every n of 1..32) is the order of
``csrc/lu_solve.cu``'s small solve.

    python3 tools/lu_order_probe.py [--systems 10000] [--sizes 1-32]
        [--out lu_order_probe.json]

``--device cpu --lib LIB`` runs a CPU build of the probe's source (the
candidates against the CPU's LAPACK; steps 1, 3 and 4 need the card), a
rehearsal of the script.
"""
import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_us, solve_systems  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import build  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import lu_solve as lu  # noqa: E402

VARIANTS = ("right_chain_rcp", "right_chain_div", "left_sum_rcp",
            "left_sum_div", "right_unfused_rcp", "right_unfused_div",
            "getrf2_trsm_chain_rcp", "getrf2_trsm_sum_rcp",
            "getrf2_trsm_chain_div", "left_sum_unfused_rcp",
            "blocked_2_rcp", "blocked_4_rcp", "blocked_8_rcp",
            "blocked_16_rcp", "getrf2_ceil_rcp")
NAMED_SIZES = (6, 7, 8, 12)
INSTANCE_ROUNDS = 5


def load(lib_path=None):
    if lib_path:
        lib, log = ctypes.CDLL(lib_path), ""
    else:
        built = build.build_library(
            "lu_order_probe", [str(ROOT / "tools" / "lu_order_probe.cu")])
        lib, log = built.lib, built.log
    for name in ("probe_getrf_f32", "probe_getrf_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.probe_set_stack.argtypes = [ctypes.c_size_t]
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    if lib.probe_variants() != len(VARIANTS):
        raise RuntimeError("the probe's variants and VARIANTS disagree")
    return lib, log


def load_instances():
    """The small solve's generic widths at any n up to 16, built from
    ``tools/small_solve_instances.cu`` (which includes ``csrc/lu_solve.cu``:
    the library's name carries that file's hash, so an edit rebuilds it)."""
    src = build.CSRC_DIR / "lu_solve.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    built = build.build_library(
        f"small_solve_instances_{tag}",
        [str(ROOT / "tools" / "small_solve_instances.cu")])
    for name in ("generic_small_solve_f32", "generic_small_solve_f64"):
        fn = getattr(built.lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return built


def generic_solve(lib, A, b):
    """x from the generic width that takes A's n (up to 16)."""
    x = torch.empty_like(b)
    n = A.shape[-1]
    fn = lib.generic_small_solve_f32 if A.dtype == torch.float32 \
        else lib.generic_small_solve_f64
    rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), n, b.numel() // n,
            int(lu.reciprocal_route(n)),
            torch.cuda.current_stream(A.device).cuda_stream)
    if rc:
        raise RuntimeError(f"generic width launch failed at n = {n}: "
                           f"rc {rc}")
    return x


def kernel_mismatches(A, gen):
    """Systems whose x from the small solve kernel (one launch for all of
    them) is not bitwise ``solve_ex``'s on the system alone; b from
    ``gen``."""
    b = torch.randn(A.shape[:2], generator=gen, dtype=torch.float64).to(
        A.dtype).to(A.device)
    x = lu.small_solve_cuda(A, b)
    want = torch.stack([torch.linalg.solve_ex(
        A[s], b[s][:, None], check_errors=False)[0][:, 0]
        for s in range(A.shape[0])])
    return int((bits(x) != bits(want)).any(1).sum())


def instance_times(dev, gen):
    """{f"{n}_{dtype}": device us per launch of the shipped kernel (its
    exact-size instance) and of the generic width (median, min and max over
    INSTANCE_ROUNDS alternating rounds) and whether their x agree bit for
    bit}."""
    lib = load_instances().lib
    out = {}
    for dt in (torch.float32, torch.float64):
        for n in NAMED_SIZES:
            A = solve_systems("path", n, 1, dt, dev, gen)[0].contiguous()
            b = torch.randn(n, generator=gen, dtype=torch.float64).to(
                dt).to(dev)
            runs = {"shipped": [], "generic": []}
            for _ in range(INSTANCE_ROUNDS):
                runs["shipped"].append(
                    device_us(lambda: lu.small_solve_cuda(A, b), 200))
                runs["generic"].append(
                    device_us(lambda: generic_solve(lib, A, b), 200))
            same = torch.equal(bits(lu.small_solve_cuda(A, b)),
                               bits(generic_solve(lib, A, b)))
            out[f"{n}_{str(dt)[6:]}"] = {
                k: {"median": statistics.median(v), "min": min(v),
                    "max": max(v)} for k, v in runs.items()}
            out[f"{n}_{str(dt)[6:]}"]["bitwise"] = same
    return out


def reference(A):
    """``lu_factor_ex`` on each system alone (one system is cuSOLVER's
    getrf; a batch would be cuBLAS's batched getrf)."""
    LU = torch.empty_like(A)
    piv = torch.empty(A.shape[:2], dtype=torch.int32, device=A.device)
    for s in range(A.shape[0]):
        lu, p, _ = torch.linalg.lu_factor_ex(A[s])
        LU[s] = lu
        piv[s] = p
    return LU, piv


def candidate(lib, A, variant):
    out = A.clone().contiguous()
    piv = torch.empty(A.shape[:2], dtype=torch.int32, device=A.device)
    fn = lib.probe_getrf_f32 if A.dtype == torch.float32 \
        else lib.probe_getrf_f64
    stream = (torch.cuda.current_stream(A.device).cuda_stream
              if A.is_cuda else None)
    rc = fn(out.data_ptr(), piv.data_ptr(), A.shape[-1], A.shape[0],
            variant, stream)
    if rc:
        raise RuntimeError(f"probe launch failed: "
                           f"{lib.probe_error_string(rc).decode()}")
    return out, piv + 1


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def compare(LU, piv, ref_LU, ref_piv):
    """(systems whose factors or pivots differ, of those whose pivots
    differ, the largest |difference| / max |ref| where the pivots agree)."""
    piv_bad = (piv != ref_piv).any(1)
    lu_bad = (bits(LU) != bits(ref_LU)).flatten(1).any(1)
    same = ~piv_bad
    gap = 0.0
    if bool(same.any()):
        d = (LU[same] - ref_LU[same]).abs().flatten(1).amax(1)
        s = ref_LU[same].abs().flatten(1).amax(1).clamp_min(1e-300)
        gap = float((d / s).max())
    return int((piv_bad | lu_bad).sum()), int(piv_bad.sum()), gap


def kernel_names(n, dtype, device, gen, calls=5):
    """{kernel name: [launches per call, device us per call]} of one
    ``lu_factor_ex`` on one system."""
    from torch.profiler import ProfilerActivity, profile
    A = solve_systems("general", n, 1, dtype, device, gen)[0]
    torch.linalg.lu_factor_ex(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.linalg.lu_factor_ex(A)
        torch.cuda.synchronize()
    return {e.key: [e.count / calls, e.self_device_time_total / calls]
            for e in prof.key_averages() if e.self_device_time_total > 0}


def parse_sizes(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--systems", type=int, default=10000)
    ap.add_argument("--sizes", default="1-32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="lu_order_probe.json")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("lu_order_probe: no CUDA device")
        from slam_eds_tpu_torch.device import set_numerics
        set_numerics()
    lib, log = load(args.lib)
    lib.probe_set_stack(4096)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "systems": args.systems, "variants": list(VARIANTS),
              "ptxas": [l.strip() for l in log.splitlines()
                        if "registers" in l or "spill" in l]}
    gen = torch.Generator().manual_seed(args.seed)
    if dev.type == "cuda":
        report["device"] = torch.cuda.get_device_name(0)
        report["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        report["kernels"] = {
            f"{n}_{str(dt)[6:]}": kernel_names(n, dt, dev, gen)
            for n in NAMED_SIZES for dt in (torch.float32, torch.float64)}
        print(json.dumps({"lu_factor_ex_kernels": report["kernels"]}),
              flush=True)
    counts, kernel = {}, {}
    # the right-hand sides from a generator of their own: the systems are
    # the same draws with or without step 3
    bgen = torch.Generator().manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.float64):
        for kind in ("path", "general"):
            key = f"{str(dt)[6:]}_{kind}"
            table = {v: {} for v in VARIANTS}
            for n in parse_sizes(args.sizes):
                A = solve_systems(kind, n, args.systems, dt, dev, gen)
                ref_LU, ref_piv = reference(A)
                for i, v in enumerate(VARIANTS):
                    table[v][n] = compare(*candidate(lib, A, i), ref_LU,
                                          ref_piv)
                if dev.type == "cuda":
                    kernel.setdefault(key, {})[n] = kernel_mismatches(A,
                                                                      bgen)
            counts[key] = table
            print(json.dumps({
                key: {v: [[n for n, c in t.items() if c[0] == 0],
                          sum(c[0] for c in t.values()),
                          sum(c[1] for c in t.values()),
                          float(f"{max(c[2] for c in t.values()):.3g}")]
                      for v, t in table.items()},
                "small_solve_kernel": kernel.get(key),
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    report["counts"] = {k: {v: {n: c for n, c in t.items()}
                            for v, t in table.items()}
                        for k, table in counts.items()}
    exact = {v: [n for n in parse_sizes(args.sizes)
                 if all(counts[k][v][n][0] == 0 for k in counts)]
             for v in VARIANTS}
    report["bitwise_at"] = exact
    print(json.dumps({"bitwise_at": exact}))
    if dev.type == "cuda":
        report["small_solve_kernel_mismatches"] = kernel
        print(json.dumps({"small_solve_kernel_mismatches": {
            k: sum(t.values()) for k, t in kernel.items()},
            "of_systems": args.systems * len(parse_sizes(args.sizes))}))
        report["instances_us"] = instance_times(dev, gen)
        print(json.dumps({"instances_us": report["instances_us"]}),
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    if dev.type == "cuda":
        print(report["nvidia_smi"])


if __name__ == "__main__":
    main()
