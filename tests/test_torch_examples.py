"""The port's examples (examples/*_torch.py, through eva_torch) against
the JAX package's (examples/*.py, through eva).

Each example module is loaded by path (`load_example`). Every program
of the examples is built by the JAX example's builder and by the
port's, and held by test_torch_executor.check_against_eva_tpu: both
compiles agree; on eva_tpu's keys and ciphertexts, carried over, the
port's output residues and level equal eva_tpu's numpy backend's and
its decryption is within MSE 0.01. Here the three regressions, at the
example's own sizes (vec_size 2048, 63 features); Sobel and Harris
(N=16384, ~15 s each) are in test_torch_examples_image.py, so that each
file stays under 40 s. The serialization example runs end to end on the
CPU with --cpu; each example refuses to run without a card unless
given --cpu."""

import importlib.util
import os

import pytest
import torch

from test_torch_executor import ROOT, check_against_eva_tpu

torch.set_num_threads(1)

CONFIG = {"warn_vec_size": "false"}


def load_example(name):
    """examples/<name>.py as a module (its main() not run)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("model", ["linear", "polynomial", "multivariate"])
def test_regression_programs(model):
    jax_ex = load_example("regression")
    port_ex = load_example("regression_torch")
    prog_j, inputs_j = getattr(jax_ex, model)()
    prog_t, inputs = getattr(port_ex, model)()
    assert inputs == inputs_j
    check_against_eva_tpu(prog_j, prog_t, inputs, CONFIG)


def test_serialization_example_end_to_end(capsys):
    pytest.importorskip("google.protobuf")
    load_example("serialization_torch").main(["--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("MSE ") and float(lines[0].split()[1]) < 0.01
    assert sorted(line.split(":")[0].strip() for line in lines[1:]) == sorted(
        ["poly.eva", "poly.evaparams", "poly.evasignature", "poly.evapublic",
         "poly.evasecret", "poly_inputs.evavals", "poly_outputs.evavals"])


@pytest.mark.parametrize("name", ["image_processing_torch",
                                  "regression_torch", "serialization_torch"])
def test_example_refuses_to_run_without_a_card(name, monkeypatch, capsys):
    """Without a CUDA device and without --cpu, each example exits
    non-zero with a message and never falls back to the host."""
    example = load_example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        example.main([])
    assert exit_.value.code not in (0, None)
    assert "no CUDA device" in str(exit_.value.code)
    assert "--cpu" in str(exit_.value.code)
    assert capsys.readouterr().out == ""
