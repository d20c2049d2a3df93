"""Standard numeric library. Reference: python/eva/std/numeric.py."""

from .. import py_to_eva


def horizontal_sum(x):
    """Sum all elements of a vector via a log2(vec_size) rotate-and-add
    ladder; the result is replicated in every slot."""
    x = py_to_eva(x)
    step = 1
    while step < x.program.vec_size:
        x = x + (x << step)
        step <<= 1
    return x
