"""Each traffic loop drives the port for a tiny window on the host, and
its run passes the check; the same seed gives the same outputs."""

import pytest

from bench_small import run_small


@pytest.mark.parametrize("cell", ["sobel90.latency", "harris64.offline",
                                  "sobel90.stream"])
def test_a_loop_runs_and_is_correct(cell):
    res = run_small(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    m = res["metrics"]
    assert m["requests_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert m["latency_p95_ms"]["value"] >= m["latency_p50_ms"]["value"]
    assert res["checks"]["outputs_checked"]["value"] == 2


def test_a_traced_run_reports_per_layer_metrics_it_can_read():
    res = run_small("sobel90.latency", trace=True)
    assert res["correct"] is True
    # On the host there is no device trace: those readers find nothing
    # and their metrics are left out; the timers and counters remain.
    assert set(res["metrics"]) == {"keygen_s", "first_execute_s",
                                   "launches_per_req"}
    assert res["device"]["busy_s"] is None and res["device"]["window_s"] > 0
    assert "breakdown" in res


def test_one_seed_gives_the_same_outputs():
    a = run_small("sobel90.latency", seed=77, seconds=0.5)
    b = run_small("sobel90.latency", seed=77, seconds=0.5)
    c = run_small("sobel90.latency", seed=78, seconds=0.5)
    assert a["errors"] == b["errors"] and a["checks"] == b["checks"]
    assert a["errors"] != c["errors"]
