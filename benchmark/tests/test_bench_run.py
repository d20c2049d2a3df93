"""The command: no result and a non-zero exit without a CUDA card or
without the program; on a card, one result line with its keys in
order."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

CMD = [sys.executable, "benchmark/run.py", "--workload", "sobel90.latency",
       "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def test_no_result_without_a_card(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_one_result_line_on_the_card(cuda_card, trace):
    p = subprocess.run(CMD[:-1] + [trace], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["metrics"]) == 9
