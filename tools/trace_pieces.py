#!/usr/bin/env python3
"""One run of a benchmark cell (``portbench/run.py``'s) with the port's
tracer on in the measured window: which piece of a frame or packet call
takes the host's time, makes the host reads and holds the card idle.

    python3 tools/trace_pieces.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> --program-trace <0|1> [--out FILE]

The run is ``portbench.harness.run`` itself; with ``--program-trace 1``
``slam_eds_tpu_torch.telemetry.TRACE`` is enabled for the measured window
only (never in the warm-up), and the harness is given, in this process:

* ``portbench.program_spans.ProgramStretch`` for its profiled stretch, so
  ``breakdown.idle_gaps`` names the innermost program span of each idle
  gap (``keyframe_frame/keyframe.ba``; ``idle_gaps_by_call`` is the
  call-level breakdown, the same total);
* ``SpanReads.counted`` for ``counted_syncs``, so each host read of a
  counted frame call is noted under its innermost span (the per-frame
  total, ``host_reads_per_frame``, is counted as before);
* the program's spans and replay device times in the records its metric
  readers take (``rec["spans"]``, ``rec["replays"]``, ``rec["span_reads"]``,
  ``rec["counted_calls"]``).

Every run computes the cell's end-to-end and per-layer metrics and the
program-span metrics (``keyframe_ms_p50``, ``keyframe_reads_per_kf``,
``track_ms_p50``, ``ba_device_ms_p50``, ``packet_device_ms_p50``), which
read nothing without the tracer. Prints the span table (per span name:
count, total and self ms, host reads, replay device ms) on standard error
and the result as the last line of standard output; ``--out`` writes both
to a file. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPAN_METRICS = (("keyframe_ms_p50", "ms"), ("keyframe_reads_per_kf",
                                             "reads/keyframe"),
                ("track_ms_p50", "ms"), ("ba_device_ms_p50", "ms"),
                ("packet_device_ms_p50", "ms"))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             program_trace: bool, device="cuda"):
    """``harness.run`` of ``cell`` with the program's tracer on in the
    measured window (``program_trace``) and every metric computed; the
    harness is given back as it was. Returns (result, span table)."""
    import torch
    from portbench import harness, program_spans as ps
    from slam_eds_tpu_torch.telemetry import TRACE

    cuda = torch.device(device).type == "cuda"
    every = cell.end_to_end + cell.per_layer + [
        {"name": n, "unit": u} for n, u in SPAN_METRICS]
    cell = harness.Cell(cell.name, cell.chips, cell.config, cell.traffic,
                        every, every)
    reads = ps.SpanReads(TRACE)
    stretches = []
    resolved = {}
    saved = {"Window.run": harness.Window.run, "Stretch": harness.Stretch,
             "counted_syncs": harness.counted_syncs,
             "load_reader": harness.load_reader}
    window_run, load_reader = saved["Window.run"], saved["load_reader"]

    def run(self, pool, deadline=None, sequences=None, on_frame=None):
        # the measured window is the run with a deadline
        if deadline is None or not program_trace:
            return window_run(self, pool, deadline, sequences, on_frame)
        TRACE.enable()
        try:
            return window_run(self, pool, deadline, sequences, on_frame)
        finally:
            TRACE.disable()

    def stretch(ledger=None):
        st = ps.ProgramStretch(ledger, program=lambda: TRACE.spans)
        stretches.append(st)
        return st

    def records(rec):
        if not program_trace:
            return rec
        if "replays" not in resolved:
            if cuda:
                torch.cuda.synchronize()
            resolved["replays"] = TRACE.collect()
        return dict(rec, spans=TRACE.spans, replays=resolved["replays"],
                    span_reads=reads.by_span, counted_calls=reads.calls)

    def reader(name, bench_dir=harness.HERE):
        read = load_reader(name, bench_dir)
        return lambda rec: read(records(rec))

    harness.Window.run = run
    harness.Stretch = stretch
    harness.counted_syncs = reads.counted
    harness.load_reader = reader
    try:
        result = harness.run(cell, seed, seconds, trace, device=device)
    finally:
        harness.Window.run = saved["Window.run"]
        harness.Stretch = saved["Stretch"]
        harness.counted_syncs = saved["counted_syncs"]
        harness.load_reader = saved["load_reader"]
    if stretches and "breakdown" in result:
        st = stretches[0]
        result["breakdown"]["idle_gaps_by_call"] = st.idle_gaps_by_call
        result["breakdown"]["program_spans_on_trace"] = \
            st.program_spans_laid
    table = (ps.span_table(TRACE.spans, resolved.get("replays", ()),
                           reads.by_span) if program_trace else {})
    result["program_trace"] = program_trace
    result["span_count"] = len(TRACE.spans)
    TRACE.clear()
    return result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run
    bench_run._cache_dirs()

    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("trace_pieces: needs a CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    cell = harness.resolve_cell(harness.load_benchmark(ROOT), args.workload,
                                ROOT)
    result, table = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), bool(args.program_trace))
    print(json.dumps({"spans": table}), file=sys.stderr, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed,
                       "trace": args.trace, "result": result,
                       "spans": table}, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
