"""A run of a cell on the host, at the cell's own configuration but a
small pool and batch, for the CPU tests (the port's plain PyTorch
versions stand in for the CUDA kernels; outputs are the same bits)."""

import time

import torch

from harness.cell import run_cell
from harness.loader import Benchmark

from conftest import ROOT


# A cell of the batch loop (traffic/execute_batch.py), which no cell of
# BENCHMARK.json runs yet; it reports what harris64.latency reports.
EXTRA = {"harris64.offline": {"name": "harris64.offline", "config": "harris64",
                              "traffic": "offline", "chips": 1}}
EXTRA_MIXES = {"offline": {"loop": "execute_batch", "batch": 8, "pool": 16,
                           "warmup_units": 4, "trace_units": 25}}


class SmallBenchmark(Benchmark):
    """The benchmark with each mix cut to a pool of 2, a batch of 2, one
    warm-up unit and two traced units, and the cells of EXTRA."""

    def cell(self, name):
        return EXTRA.get(name) or super().cell(name)

    def metrics(self, cell, trace):
        return super().metrics("harris64.latency" if cell in EXTRA else cell,
                               trace)

    def traffic(self, name):
        mix = (dict(EXTRA_MIXES[name], name=name) if name in EXTRA_MIXES
               else super().traffic(name))
        mix.update(pool=2, warmup_units=1, trace_units=2)
        if "batch" in mix:
            mix["batch"] = 2
        return mix


def run_small(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 2.0,
              trace: bool = False) -> dict:
    return run_cell(SmallBenchmark(ROOT), cell, seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter())
