"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

Prints the run's set-up split, counts and the numbers compared on standard
error, and the result as one JSON object, the last line of standard
output. With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. ``--control 1`` puts the control
(the reference in TF32) in the program's place for the check: ``correct``
and ``checks`` are the control's, which has to come out not correct, and
the program's are kept under ``program_correct`` and ``program_checks``.
Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernel libraries under its own ``_build``)."""
    cache = ROOT / "portbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # no library the port uses may load JAX behind its back
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))

    import torch
    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.resolve_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; this "
              "benchmark runs on a CUDA card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", control=bool(args.control))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
