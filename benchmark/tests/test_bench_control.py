"""The control: the plain reference, computed at the precision below
the configuration's (configs/<name>.json "control"), put in the
program's place, fails the check's limit; the reference at the stated
precision reads 0. Here on two images of a seeded pool (on the card the
readings tool takes the cell's 16)."""

import numpy as np
import pytest

from harness.cell import control_outputs, summarize
from harness.seeding import image_pool


@pytest.mark.parametrize("name", ["sobel90", "harris64"])
def test_the_control_fails_the_limit(bench, name):
    cfg = bench.config(name)
    ref = bench.module("reference", name).reference
    limit = cfg["checks"]["line_p90_err"]
    for seed in (1, 2 ** 31 + 5):
        pool = image_pool(seed, 2, cfg["rows"], cfg["cols"], cfg["slots"])
        assert control_outputs(cfg, ref, pool, "float64")["line_p90_err"] == 0
        got = control_outputs(cfg, ref, pool, cfg["control"])["line_p90_err"]
        assert got > limit, (got, limit)


def test_summarize():
    a = np.linspace(-1, 1, 100)
    b = np.zeros(100)
    b[:20] = 5.0  # two of its ten rows wrong: every line through them
    got = summarize([a, b], 10, 10)
    assert got["line_p90_err"] == 5.0 and got["max_err"] == 5.0
    assert got["outputs_checked"] == 2
    assert got["rms_err"] == pytest.approx(
        np.sqrt((np.sum(a * a) + 20 * 25) / 200))
    assert summarize([], 10, 10)["outputs_checked"] == 0
    assert summarize([np.array([np.nan, 0.0])], 1, 2)["max_err"] == np.inf


@pytest.mark.parametrize("where", ["last_row", "first_column", "tail"])
def test_a_fault_in_one_line_moves_the_compared_number(where):
    """A fault confined to one row or column of the image, or to the slots
    after it, touches far under a tenth of the output, so the output's
    own 90th percentile misses it; its line's does not."""
    rows, cols, slots = 20, 20, 440
    err = np.full(slots, 1e-6)
    if where == "last_row":
        err[(rows - 1) * cols:rows * cols] = 1.0
    elif where == "first_column":
        err[:rows * cols:cols] = 1.0
    else:
        err[rows * cols:] = 1.0
    assert np.percentile(err, 90) == pytest.approx(1e-6)
    assert summarize([err], rows, cols)["line_p90_err"] == 1.0
