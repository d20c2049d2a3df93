import numpy as np
import pytest

from harness import stats


def test_union_merges_overlapping_and_nested():
    got = stats.union([(5, 7), (0, 2), (1, 3), (10, 20), (12, 14), (3, 4)])
    assert got == [(0, 4), (5, 7), (10, 20)]
    assert stats.covered([(0, 10), (2, 3), (5, 12)]) == 12


def test_union_rejects_backwards_interval():
    with pytest.raises(ValueError):
        stats.union([(3, 1)])


def test_gaps_are_the_complement_in_the_window():
    assert stats.gaps([(1, 2), (1.5, 3), (5, 9)], 0, 8) == [(0, 1), (3, 5)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_idle_share_by_union_is_never_negative():
    # Programmatic dependent launch: each kernel starts before the last
    # one ends, so the sum of durations (17) exceeds the wall (10).
    kernels = [(0, 4), (3, 7), (6, 10), (1, 8)]
    busy = stats.covered(kernels)
    assert sum(e - s for s, e in kernels) > 10
    assert busy == 10
    assert 1 - busy / 10 == 0


def test_attribute_gives_overlap_to_the_earliest_started():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 2.0, 3.0),
          ("d", 20.0, 21.0)]
    got = stats.attribute(ev)
    assert got == pytest.approx({"a": 10.0, "b": 2.0, "d": 1.0})
    assert sum(got.values()) == pytest.approx(
        stats.covered((s, e) for _, s, e in ev))


def test_innermost_span():
    spans = [("outer", 0, 10), ("inner", 2, 4), ("later", 6, 7)]
    assert stats.innermost(spans, [1, 3, 5, 6.5, 11]) == [
        "outer", "inner", "outer", "later", ""]


def test_percentile_over_all_requests_matches_numpy():
    rng = np.random.default_rng(3)
    lat = list(rng.lognormal(0, 1, 1001))
    for q in (50, 95, 99):
        assert stats.percentile(lat, q) == pytest.approx(
            np.percentile(lat, q))
    # Over all requests, not a median of chunk percentiles.
    chunks = [lat[i:i + 100] for i in range(0, 1000, 100)]
    chunked = np.median([np.percentile(c, 95) for c in chunks])
    assert stats.percentile(lat, 95) != pytest.approx(chunked)


def test_spread_is_iqr_over_median():
    vals = [10, 11, 12, 13, 14, 15]
    import statistics
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
