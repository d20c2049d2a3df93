import pytest

from harness.spans import LAYERS, SpanReading, per_request, self_times
from harness.trace import WINDOW


def _window():
    """Two requests in a window [0, 10] of thread 1: execute spans
    holding a host phase, a stage (the first with a capture inside), a
    launch, a copy, a wait and a result; an eva. span of another thread
    and one before the window, which do not count."""
    host = [(WINDOW, 0.0, 10.0, 1), ("aten::copy_", 0.2, 0.3, 1),
            ("eva.execute", -3.0, -2.0, 1), ("eva.execute", 1.0, 9.0, 2)]
    for t0 in (0.5, 5.0):
        host += [("eva.execute", t0, t0 + 4.0, 1),
                 ("eva.host_phase", t0 + 0.5, t0 + 1.0, 1),
                 ("eva.stage", t0 + 1.0, t0 + 1.5, 1),
                 ("eva.launch", t0 + 1.5, t0 + 2.0, 1),
                 ("eva.copy_out", t0 + 2.0, t0 + 2.25, 1),
                 ("eva.wait", t0 + 2.25, t0 + 3.0, 1),
                 ("eva.result", t0 + 3.0, t0 + 3.5, 1)]
    host.append(("eva.capture", 1.6, 1.8, 1))  # inside the first stage
    # The device: busy [2.0, 3.4] and [6.5, 7.9]; idle 7.2 s, of it
    # [0, 0.5], [9.0, 10] and [4.5, 5.0] outside every span.
    dev = [("k", 2.0, 3.4), ("k", 6.5, 7.9), ("before", -1.0, -0.5)]
    return SpanReading(host, dev)


def test_self_time_leaves_out_the_children():
    got = self_times([("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0),
                      ("b", 5.0, 6.0), ("d", 12.0, 13.0)])
    assert got == pytest.approx({"a": 6.0, "b": 3.0, "c": 1.0, "d": 1.0})


def test_span_reading_of_a_window():
    r = _window()
    assert r.window_s == 10.0
    assert r.span_count == {"eva.execute": 2, "eva.host_phase": 2,
                            "eva.stage": 2, "eva.launch": 2,
                            "eva.copy_out": 2, "eva.wait": 2,
                            "eva.result": 2, "eva.capture": 1}
    assert r.span_self_s == pytest.approx({
        "eva.execute": 2.0, "eva.host_phase": 1.0,
        "eva.stage": 0.8, "eva.capture": 0.2, "eva.launch": 1.0,
        "eva.copy_out": 0.5, "eva.wait": 1.5, "eva.result": 1.0})
    assert r.idle_s == pytest.approx(7.2)
    assert r.idle_unspanned_s == pytest.approx(2.0)


def test_per_request_layers():
    got = per_request(_window(), 2)
    assert set(got) == set(LAYERS) | {"idle_unspanned_pct",
                                      "captures_in_window"}
    assert got["entry_ms_per_req"] == pytest.approx(1000.0)
    assert got["output_ms_per_req"] == pytest.approx(750.0)
    assert got["stage_ms_per_req"] == pytest.approx(400.0)
    assert got["idle_unspanned_pct"] == pytest.approx(100 * 2.0 / 7.2)
    assert got["captures_in_window"] == 1
    # The six layers and the capture cover the spanned host time.
    assert sum(got[k] for k in LAYERS) + 100.0 == pytest.approx(
        1e3 * 8.0 / 2)


def test_a_program_without_spans_reads_nothing():
    r = SpanReading([(WINDOW, 0.0, 1.0, 1), ("aten::add", 0.1, 0.2, 1)],
                    [("k", 0.2, 0.4)])
    assert r.span_count == {} and r.idle_unspanned_s == pytest.approx(0.8)
    assert per_request(r, 5) == {}
    assert per_request(_window(), 0) == {}
    with pytest.raises(RuntimeError):
        SpanReading([], [])


def test_the_tool_reads_the_spans_of_a_run_on_the_host():
    """tools/spans.py's traced run of a cell on the host (small pool):
    one host phase, one result and one call span a request, no
    capture."""
    import importlib.util

    import torch

    from bench_small import SmallBenchmark
    from conftest import BENCH, ROOT

    spec = importlib.util.spec_from_file_location(
        "_spans_tool", f"{BENCH}/tools/spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res, r = tool.traced_run(SmallBenchmark(ROOT), "sobel90.latency",
                             2 ** 31 + 5, 2.0, torch.device("cpu"))
    n = res["attempted"] - res["failed"]
    assert res["correct"] and n == 2
    assert r.span_count == {"eva.execute": n, "eva.host_phase": n,
                            "eva.result": n}
    got = per_request(r, n)
    assert got["captures_in_window"] == 0
    assert got["host_phase_ms_per_req"] > 0
