"""Benchmark of eva_tpu_torch, the PyTorch/CUDA port of EVA, on one
NVIDIA H100: encrypted image filters served one request at a time, in
batches and pipelined.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's end-to-end metrics
(--trace 0) or per-layer metrics (--trace 1) as the last line of
standard output, one JSON object; the numbers compared by the check,
each beside its limit, are the last lines of standard error. Exits
non-zero, with no result, without a CUDA card, when the program cannot
be loaded, or when JAX or the JAX package was loaded. See README.md."""

from __future__ import annotations

import os
import time


def _seconds_since_process_start() -> float:
    """How long this process has run, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_ORIGIN = time.perf_counter() - _seconds_since_process_start()
# One thread for the host's numerical libraries: the server's host work
# runs on the calling thread, and idle worker threads spinning beside it
# on a shared host made runs spread more.
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from harness import imports
    from harness.cell import run_cell
    from harness.loader import Benchmark

    try:
        bench = Benchmark(ROOT)
        chips = bench.cell(args.workload)["chips"]
        import torch
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: the cell needs {chips} CUDA card(s); "
                  f"cuda available: {torch.cuda.is_available()}, cards: "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_ORIGIN)
    except Exception:
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 1
    bad = imports.forbidden_loaded()
    if bad:
        print(f"no result: loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
