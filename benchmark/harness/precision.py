"""Arithmetic of the plain references at a stated precision, for the
check and for its control: float64 (what the configurations state),
float32, and bfloat16 (float32 values rounded to 8 significant bits,
round to nearest even, after every operation, as bfloat16 hardware
does)."""

from __future__ import annotations

import numpy as np

PRECISIONS = ("float64", "float32", "bfloat16")


def round_bf16(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def arith(precision: str):
    """(dtype, round): the array type to compute in, and the rounding to
    apply to every operation's result."""
    if precision == "float64":
        return np.float64, lambda x: x
    if precision == "float32":
        return np.float32, lambda x: x
    if precision == "bfloat16":
        return np.float32, round_bf16
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
