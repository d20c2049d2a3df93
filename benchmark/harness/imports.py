"""The benchmark measures the PyTorch/CUDA port only: no JAX, and nothing
of the JAX package or of the repository's older bench scripts may be
loaded in the process that prints a result. Modules are compared by
their whole top-level name (the part before the first dot), so
`eva_tpu_torch` is not taken for `eva_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "eva_tpu", "eva",
                       "bench", "bench_torch", "chip_smoke"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules' names."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
