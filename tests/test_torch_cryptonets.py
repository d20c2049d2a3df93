"""CryptoNets' MNIST network as an EVA program (examples/cryptonets_torch.py)
against its plain PyTorch reference (examples/cryptonets_reference.py),
and the benchmark's copies of both (benchmark/programs/ and
benchmark/reference/cryptonets_mnist.py), on the CPU:

- at the published widths (28x28, 5 maps, 845 -> 100 -> 10), the
  compiled program's plaintext semantics (eva_tpu_torch.evaluate, every
  HE op the identity) equal the reference: the masks, offsets and
  packing are the network's equations;
- at a small size, encrypted through generate_keys / encrypt / execute
  on the CPU, the decrypted logits equal the reference, and one replay
  adds the key switches the program implies;
- the benchmark's NumPy reference equals the PyTorch one in float64, and
  the benchmark's program the example's;
- one wrong logit fails the benchmark's check.

A full-size encrypted execute takes minutes on the host's plain versions,
so it runs on the card only (tests/test_torch_cuda.py, benchmark/)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from eva_tpu_torch import evaluate
from eva_tpu_torch.ckks import CKKSCompiler
from eva_tpu_torch.runtime import generate_keys

from test_torch_key_switches import ROOT, benchmark, implied, replay_counts

torch.set_num_threads(1)

CONFIG = {"warn_vec_size": "false"}
# The small network: an 8x8 image (a 3x3 convolution output), 2 maps,
# 2 hidden units, 2 classes, 64 slots. At the configuration's scales it
# would compile to N=32768 (over a minute here); input scale 32 is the
# largest that compiles to N=16384 (primes [60, 48, 60 x 5]).
SMALL = dict(rows=8, cols=8, maps=2, hidden=2, classes=2, vec_size=64)
SMALL_SCALE = 32


def _load(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


example = _load("cryptonets_torch")
ref = _load("cryptonets_reference")


def _image(seed, rows=28, cols=28, slots=1024):
    img = np.zeros(slots)
    img[:rows * cols] = np.random.default_rng(seed).uniform(0, 1, rows * cols)
    return img


def test_plaintext_semantics_at_full_widths_equal_the_reference():
    """Compiled at the configuration's scales: N=32768, primes
    [60, 40, 60 x 6], 32 Galois keys; 24 + 1,100 rotations and 6
    relinearizations. Both sides compute in float64 from the same
    weights, in another order of summation: 1e-9 is a million times
    the rounding of ~1,000-term sums of values under 10, and far under
    any logit (~0.01-0.3)."""
    prog = example.build()
    compiled, params, _ = CKKSCompiler(CONFIG).compile(prog)
    assert params.poly_modulus_degree == 32768
    assert list(params.prime_bits) == [60, 40] + [60] * 6
    assert len(params.rotations) == 32
    assert implied(compiled) == {"hoisted_rotation": 24,
                                 "single_rotation": 1100, "relin": 6}
    for seed in (0, 2 ** 33 + 1):
        img = _image(seed)
        got = np.asarray(evaluate(compiled, {"image": img.tolist()})["logits"])
        want = ref.reference(img)["logits"]
        assert np.abs(want).max() > 0.05
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_small_network_encrypted_on_the_cpu():
    """The decrypted logits within 1e-4 of the reference: the CKKS noise
    at these scales reads at most 3.1e-6 (three images, my CPU runs), a
    wrong mask, offset or packing moves a logit by its own size
    (1e-2-1e-1 here). One replay adds 24 hoisted rotations (the 25
    kernel offsets less (0, 0), all of the image), 2 x 6 + 2 x 6 single
    ones (a rotate-and-sum over 64 slots per dense output) and 3
    relinearizations (the two maps' squares and the hidden layer's)."""
    prog = example.build(**SMALL, input_scale=SMALL_SCALE)
    compiled, params, sig = CKKSCompiler(CONFIG).compile(prog)
    assert params.poly_modulus_degree == 16384
    want_ks = {"hoisted_rotation": 24, "single_rotation": 24, "relin": 3}
    assert implied(compiled) == want_ks
    pub, secret = generate_keys(params, device="cpu")
    img = _image(5, SMALL["rows"], SMALL["cols"], SMALL["vec_size"])
    enc = pub.encrypt({"image": img.tolist()}, sig)
    added, out = replay_counts(pub, compiled, enc)
    assert added == want_ks
    got = np.asarray(secret.decrypt(out, sig)["logits"])
    want = ref.reference(img, **SMALL)["logits"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_benchmark_copies_equal_the_examples():
    """At full widths, float64: the benchmark's NumPy reference (one
    operation at a time, as its lower precisions round) against the
    PyTorch one (conv2d and linear), to 1e-12; the benchmark's program
    (configured by its file) against the example's, plaintext."""
    bench = benchmark()
    cfg = bench.config("cryptonets_mnist")
    assert (cfg["rows"], cfg["cols"], cfg["slots"], cfg["maps"],
            cfg["hidden"], cfg["classes"]) == (28, 28, 1024, 5, 100, 10)
    assert cfg["weights_seed"] == example.WEIGHTS_SEED == ref.WEIGHTS_SEED
    assert (cfg["input_scale"], cfg["output_range"]) == (
        example.INPUT_SCALE, example.OUTPUT_RANGE)
    bench_ref = bench.module("reference", cfg["reference"]).reference
    for seed in (1, 2 ** 31 + 7):
        img = _image(seed)
        want = ref.reference(img)["logits"]
        np.testing.assert_allclose(bench_ref(img, cfg)["logits"], want,
                                   rtol=0, atol=1e-12)
    mine = bench.module("programs", cfg["program"]).build(cfg)
    theirs = example.build()
    img = _image(3)
    np.testing.assert_array_equal(
        evaluate(mine, {"image": img.tolist()})["logits"],
        evaluate(theirs, {"image": img.tolist()})["logits"])


@pytest.mark.parametrize("logit", range(10))
def test_one_wrong_logit_fails_the_check(logit):
    """Logit c fills the slots p = c mod 10: about a fifth of the columns
    of its parity, so a fault in it alone moves line_p90_err. Here the
    program's noise (a tenth of the limit) passes, and the same noise
    with one logit off by twice the limit does not."""
    from harness.cell import summarize
    cfg = benchmark().config("cryptonets_mnist")
    limit = cfg["checks"]["line_p90_err"]
    noise = np.random.default_rng(logit).uniform(-0.1, 0.1, cfg["slots"])
    err = noise * limit
    assert summarize([err], cfg["rows"], cfg["cols"])["line_p90_err"] < limit
    err[np.arange(cfg["slots"]) % cfg["classes"] == logit] += 2 * limit
    assert summarize([err], cfg["rows"], cfg["cols"])["line_p90_err"] > limit


def test_example_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        example.main([])
    assert "no CUDA device" in str(exit_.value.code)
    assert "--cpu" in str(exit_.value.code)
    assert capsys.readouterr().out == ""
