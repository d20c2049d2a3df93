"""The check fails a run whose timed path is broken underneath: the
harness's look for a card is skipped (the run is on the host) and the
rest of a run is driven with one fault planted in the port's device
program (TorchProgram), which all three entries go through."""

import numpy as np
import pytest

from bench_small import run_small


def _inputs_as_outputs(tp, host_values):
    """The outputs a step that returns its state unchanged gives: each
    output is the program's input ciphertext."""
    cipher = [v for v in host_values.values() if hasattr(v, "polys")]
    return {name: cipher[0] for name in tp.program.outputs}


def plant(monkeypatch, fault):
    from eva_tpu_torch.backend.executor_torch import TorchProgram
    if fault == "state_unchanged":
        monkeypatch.setattr(TorchProgram, "run",
                            lambda self, hv: _inputs_as_outputs(self, hv))
        monkeypatch.setattr(
            TorchProgram, "run_batched",
            lambda self, hvs, mesh=None: [_inputs_as_outputs(self, hv)
                                          for hv in hvs])
        monkeypatch.setattr(
            TorchProgram, "run_pipelined",
            lambda self, it, depth=2: (_inputs_as_outputs(self, hv)
                                       for hv in it))
    elif fault == "half_batch":
        real = TorchProgram.run_batched

        def half(self, hvs, mesh=None):
            keep = (len(hvs) + 1) // 2
            outs = real(self, hvs[:keep], mesh)
            return outs + outs[:len(hvs) - keep]
        monkeypatch.setattr(TorchProgram, "run_batched", half)
    elif fault == "answer_altered":
        real = TorchProgram._result

        def altered(self, out, b=None):
            res = real(self, out, b)
            for ct in res.values():
                ct.polys[0] = ct.polys[0].copy()
                ct.polys[0][0] = (ct.polys[0][0] + 12345) % 65521
            return res
        monkeypatch.setattr(TorchProgram, "_result", altered)


CASES = [(cell, fault)
         for cell in ("sobel90.latency", "harris64.latency",
                      "harris64.offline", "sobel90.stream")
         for fault in ("state_unchanged", "answer_altered")] + [
    ("harris64.offline", "half_batch")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    res = run_small(cell, seconds=1.0)
    assert res["correct"] is False
    assert res["failed"] == 0  # the faults give answers, wrong ones
    line = res["checks"]["line_p90_err"]
    assert line["value"] is None or line["value"] > 10 * line["limit"]
