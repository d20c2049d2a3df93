"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

For each seed: one short run of the cell in this process (its
set-up, a window of --seconds, the check) gives the program's readings
of each number the check can compare (summarize in harness/cell.py);
and the control, the plain reference computed
at a lower precision in the program's place, gives its readings on the
same pool of images. One JSON line per seed, then a summary line: the
largest program reading (the lower end of a limit) and the smallest
control reading (the upper end) of each number.

    python3 benchmark/tools/readings.py --workload sobel90.latency \\
        --seeds 101-112 --seconds 2 --control float32 bfloat16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def control_reading(bench, cell: str, seed: int, precision: str) -> dict:
    """The check's numbers for the reference at `precision` put in the
    program's place, on the cell's pool of images for `seed`."""
    from harness import seeding
    from harness.cell import control_outputs
    cfg = bench.config(bench.cell(cell)["config"])
    mix = bench.traffic(bench.cell(cell)["traffic"])
    ref = bench.module("reference", cfg["reference"]).reference
    images = seeding.image_pool(seed, mix["pool"], cfg["rows"], cfg["cols"],
                                cfg["slots"])
    return control_outputs(cfg, ref, images, precision)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", nargs="*", default=[])
    ap.add_argument("--cpu", action="store_true",
                    help="run the program on the host (plain versions)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    from harness.cell import run_cell
    from tools_common import seed_list
    from harness.loader import Benchmark
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA card (use --cpu for the host)", file=sys.stderr)
        return 2
    bench = Benchmark(ROOT)
    checks = ["line_p90_err", "p90_err", "rms_err", "max_err"]
    lower = {k: 0.0 for k in checks}
    upper: dict = {}
    for seed in seed_list(args.seeds):
        res = run_cell(bench, args.workload, seed, args.seconds, False,
                       device, time.perf_counter())
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"],
                "program": res["errors"],
                "outputs_checked": res["checks"]["outputs_checked"]["value"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "control": {}}
        for k in checks:
            v = line["program"][k]
            lower[k] = max(lower[k], float("inf") if v is None else v)
        for p in args.control:
            c = control_reading(bench, args.workload, seed, p)
            line["control"][p] = c
            for k in checks:
                upper.setdefault(p, {})[k] = min(
                    upper.get(p, {}).get(k, float("inf")), c[k])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "summary": True,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
