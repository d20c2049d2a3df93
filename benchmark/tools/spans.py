"""The host's split of a cell's requests by the program's own spans (not
run by the benchmark's runs): for each seed, one traced run of the cell
in this process, as `run.py --trace 1` makes it, read twice: its result
line, and the `eva.` spans of its window (harness/spans.py): each
layer's self ms a request, the span counts a request, the share of the
device's idle time that no span covers, and the window's ms a request
beside the spans' sum.

    python3 benchmark/tools/spans.py --workload sobel90.latency --seeds 1-3

One JSON line a seed. `--cpu` runs the program's plain versions on the
host (a rehearsal; its times are the host's, not the card's)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def traced_run(bench, cell: str, seed: int, seconds: float, device) -> tuple:
    """(result line, SpanReading) of one traced run of `cell`."""
    from harness import cell as cell_mod, trace
    from harness.spans import SpanReading

    kept = []

    def keep(prof):
        events = trace.profiler_events(prof)
        kept.append(events)
        return events

    # run_cell keeps no host event of its trace; keep a copy of what it
    # reads.
    cell_mod.profiler_events = keep
    try:
        res = cell_mod.run_cell(bench, cell, seed, seconds, True, device,
                                time.perf_counter())
    finally:
        cell_mod.profiler_events = trace.profiler_events
    return res, SpanReading(*kept[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-3 or 5,9")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the program on the host (plain versions)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    from harness.loader import Benchmark
    from harness.spans import LAYERS, per_request
    from tools_common import seed_list
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA card (use --cpu for the host)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = Benchmark(ROOT)
    for seed in seed_list(args.seeds):
        res, sp = traced_run(bench, args.workload, seed, args.seconds,
                             device)
        completed = res["attempted"] - res["failed"]
        layers = per_request(sp, completed)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": res["correct"], "device": res["device"],
            "completed": completed,
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "spans": layers,
            "spanned_ms_per_req": sum(layers.get(k, 0.0) for k in LAYERS),
            "window_ms_per_req": (1e3 * sp.window_s / completed
                                  if completed else None),
            "span_count_per_req": {k: v / completed
                                   for k, v in sp.span_count.items()}
            if completed else {},
            "idle_gaps": res["breakdown"]["idle_gaps"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
