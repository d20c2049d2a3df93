"""eva_torch, the port's `import eva` drop-in, against eva (the JAX
package's).

Each eva_torch module exports the names of its eva counterpart; a fresh
interpreter that imports every eva_torch module holds no jax, eva_tpu or
eva module; eva_torch.seal.generate_keys(params) raises without a CUDA
device; and the reference's workflow (README.md's quick start, the
polynomial 3x^2 + 5x - 2) through eva_torch (device="cpu") matches the
same workflow through eva: the plaintext evaluations are equal, and the
HE outputs bit-identical (test_torch_executor.check_against_eva_tpu on
eva's keys and ciphertexts)."""

import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_executor import ROOT, check_against_eva_tpu

torch.set_num_threads(1)

MODULES = ["", ".seal", ".ckks", ".metric", ".std", ".std.numeric"]


@pytest.mark.parametrize("sub", MODULES)
def test_same_names_as_eva(sub):
    ref = importlib.import_module("eva" + sub)
    port = importlib.import_module("eva_torch" + sub)
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    for name in getattr(ref, "__all__", []):
        assert hasattr(port, name), name
        assert type(getattr(port, name)) is type(getattr(ref, name)), name
    assert getattr(port, "__version__", None) == getattr(ref, "__version__",
                                                         None)


def test_imports_neither_jax_nor_eva_tpu_nor_eva():
    code = ("import sys, eva_torch, eva_torch.seal, eva_torch.ckks, "
            "eva_torch.metric, eva_torch.std, eva_torch.std.numeric; "
            "bad = [m for m in sys.modules if m in ('jax', 'eva_tpu', 'eva')"
            " or m.startswith(('jax.', 'eva_tpu.', 'eva.'))]; "
            "print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_generate_keys_needs_a_card(monkeypatch):
    import eva_torch.seal
    from eva_torch.ckks import CKKSParameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eva_torch.seal.generate_keys(CKKSParameters([60, 40, 60], [], 8192))


def _polynomial(eva):
    """The quick start's polynomial, through the package `eva`."""
    poly = eva.EvaProgram("Polynomial", vec_size=1024)
    with poly:
        x = eva.Input("x")
        eva.Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)
    return poly


def test_reference_workflow_matches_eva():
    import eva
    import eva.ckks
    import eva.metric
    import eva_torch
    import eva_torch.ckks
    import eva_torch.metric
    import eva_torch.seal

    inputs = {"x": [i * 0.001 for i in range(1024)]}
    config = {"warn_vec_size": "false"}
    results = {}
    for pkg, ckks, metric in ((eva, eva.ckks, eva.metric),
                              (eva_torch, eva_torch.ckks, eva_torch.metric)):
        poly = _polynomial(pkg)
        ref = pkg.evaluate(poly, inputs)
        compiled, params, signature = ckks.CKKSCompiler(config).compile(poly)
        assert metric.valuation_mse(ref, pkg.evaluate(compiled, inputs)) < \
            1e-10
        results[pkg.__name__] = (ref, pkg.evaluate(compiled, inputs), params)
    for a, b in zip(results["eva"][:2], results["eva_torch"][:2]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    # The HE round trip through eva_torch alone, its own keys, on the CPU.
    poly = _polynomial(eva_torch)
    compiled, params, signature = eva_torch.ckks.CKKSCompiler(
        config).compile(poly)
    public_ctx, secret_ctx = eva_torch.seal.generate_keys(params,
                                                          device="cpu")
    assert isinstance(public_ctx, eva_torch.seal.SEALPublic)
    enc = public_ctx.encrypt(inputs, signature)
    assert isinstance(enc, eva_torch.seal.SEALValuation)
    out = secret_ctx.decrypt(public_ctx.execute(compiled, enc), signature)
    assert eva_torch.metric.valuation_mse(out, results["eva_torch"][0]) < 0.01

    # Bit-identical to eva's numpy backend on eva's keys and ciphertexts.
    check_against_eva_tpu(_polynomial(eva), _polynomial(eva_torch), inputs,
                          config)
