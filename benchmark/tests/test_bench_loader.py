import json
import os
import re

import pytest

from harness.loader import Benchmark, BenchmarkError

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_finds_each_piece_by_name(bench):
    cell = bench.cell("sobel90.latency")
    assert bench.config(cell["config"])["rows"] == 90
    mix = bench.traffic(cell["traffic"])
    assert mix["loop"] == "execute" and callable(bench.loop(mix).drive)
    assert callable(bench.reader("requests_per_s"))
    assert callable(bench.module("reference", "harris64").reference)
    assert callable(bench.module("programs", "harris64").build)
    assert callable(bench.loop({"loop": "execute_batch"}).drive)


@pytest.mark.parametrize("call", [
    lambda b: b.cell("nosuch.cell"),
    lambda b: b.config("nosuch"),
    lambda b: b.traffic("nosuch"),
    lambda b: b.reader("nosuch_metric"),
    lambda b: b.module("reference", "../run"),
    lambda b: b.traffic("a b"),
    lambda b: b.loop({"loop": "nosuch"}),
    lambda b: b.loop({"pool": 2}),
])
def test_rejects_a_missing_or_malformed_name(bench, call):
    with pytest.raises(BenchmarkError):
        call(bench)


def test_a_new_mix_and_loop_are_found_from_their_files_alone(tmp_path):
    folder = tmp_path / "bench"
    (folder / "traffic").mkdir(parents=True)
    (folder / "traffic" / "burst.json").write_text(
        json.dumps({"loop": "paced", "pool": 4}))
    (folder / "traffic" / "paced.py").write_text(
        "def drive(mix, server, program, requests, window, stop, first=0):\n"
        "    return first\n")
    b = Benchmark(ROOT, str(folder))
    mix = b.traffic("burst")
    assert mix == {"loop": "paced", "pool": 4, "name": "burst"}
    assert b.loop(mix).drive(mix, None, None, [], None, None, 3) == 3


def test_metrics_of_a_cell(bench):
    e2e = {m["name"] for m in bench.metrics("sobel90.stream", False)}
    assert e2e == {"requests_per_s", "latency_p50_ms", "latency_p95_ms",
                   "setup_s"}
    assert len(bench.metrics("sobel90.stream", True)) == 9
    assert bench.metrics("nosuch.cell", False) == [
        m for m in bench.spec["end_to_end"] if "workloads" not in m]


def test_benchmark_json_is_well_formed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        raw = f.read()
    spec = json.loads(raw)
    assert len(raw.encode()) <= 64 * 1024
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    cells = spec["workloads"]
    # A full measurement of 24 cells (2 + 14 runs a cell, each
    # run_seconds + 60 s, 180 s of compiling a cell, 1200 s spare) fits
    # in 12 hours.
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and \
            os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["why"]) <= 200 and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells)
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells) == len({w["name"] for w in cells})
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        loop = Benchmark(ROOT).traffic(w["traffic"])["loop"]
        assert os.path.isfile(os.path.join(BENCH, "traffic", loop + ".py"))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metric_names = []
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            metric_names.append(m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert os.path.isfile(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))
            for w in m.get("workloads", []):
                assert w in {c["name"] for c in cells}
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
                assert set(m) <= {"name", "unit", "better", "bound",
                                  "source", "workloads"}
            else:
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert set(m) <= {"name", "unit", "better", "source",
                                  "layer", "moves", "workloads"}
                assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
                assert 1 <= len(m["layer"]) <= 200
    assert len(set(metric_names)) == len(metric_names)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    b = Benchmark(ROOT)
    for w in cells:
        e2e = {m["name"] for m in b.metrics(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = b.metrics(w["name"], True)
        assert layer
        for m in layer:  # each moves a metric that this cell reports
            assert m["moves"] in e2e


@pytest.mark.parametrize("mix, loop", [
    ({"pool": 0, "warmup_units": 1, "trace_units": 1}, None),
    ({"pool": 2, "warmup_units": 1}, None),
    ({"pool": 2, "warmup_units": 1, "trace_units": 1}, "execute_batch"),
    ({"pool": 2, "warmup_units": 1, "trace_units": 1, "depth": 0},
     "execute_pipelined"),
])
def test_a_mix_missing_a_parameter_is_refused(bench, mix, loop):
    from harness import traffic
    with pytest.raises(ValueError):
        traffic.check_mix(mix)
        bench.loop({"loop": loop}).drive(mix, None, None, [None], None,
                                         lambda w: True)
