"""Run one cell several times, each run a process of its own, and
report each metric's median and spread
(interquartile distance over the median, statistics.quantiles n=4) in
each set of runs.

    python3 benchmark/tools/spread.py --workload sobel90.latency \\
        --seeds 1-6 --sets 2 --seconds 51 [--trace 1] [--out FILE]

Each set runs the same seeds in order. Every run's result line is
written to --out (JSON lines) when given."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from harness.stats import spread  # noqa: E402
from tools_common import seed_list  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = seed_list(args.seeds)
    runs = []
    for s in range(args.sets):
        for seed in seeds:
            cmd = [sys.executable, os.path.join(HERE, "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            lines = p.stdout.strip().splitlines()
            res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
            if res is None:
                print(f"run failed rc={p.returncode} seed={seed}:\n"
                      f"{p.stderr[-3000:]}", file=sys.stderr)
            rec = {"workload": args.workload, "set": s, "seed": seed,
                   "rc": p.returncode, "result": res}
            runs.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            brief = {k: round(v["value"], 4)
                     for k, v in (res or {}).get("metrics", {}).items()}
            print(json.dumps({"set": s, "seed": seed, "rc": p.returncode,
                              "correct": (res or {}).get("correct"),
                              **brief}), flush=True)
    summary = {}
    for s in range(args.sets):
        got = [r["result"] for r in runs if r["set"] == s and r["result"]]
        names = sorted({k for g in got for k in g["metrics"]})
        for k in names:
            vals = [g["metrics"][k]["value"] for g in got if k in g["metrics"]]
            if len(vals) >= 2:
                summary.setdefault(k, {})[f"set{s}"] = {
                    "median": statistics.median(vals),
                    "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
