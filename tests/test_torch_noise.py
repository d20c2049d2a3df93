"""eva_tpu_torch.runtime.noise and eva_tpu_torch.std.numeric against the
JAX package.

`estimate_noise` is a host model over the compiled program (no keys, no
encryption): the same program compiled by both packages must give the
same report, float for float. `horizontal_sum` must build the same
program in both packages: the compiled programs serialize to the same
payload. A port round trip holds the estimate to a measured error."""

import random

import numpy as np
import pytest
import torch

import eva_tpu
import eva_tpu_torch
from eva_tpu import serialization as SJ
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu.runtime.noise import estimate_noise as estimate_j
from eva_tpu.std.numeric import horizontal_sum as hsum_j
from eva_tpu_torch import serialization as ST
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT
from eva_tpu_torch.runtime.noise import encode_sigma, estimate_noise
from eva_tpu_torch.std.numeric import horizontal_sum

torch.set_num_threads(1)


def _poly(pkg, hsum):
    prog = pkg.EvaProgram("np30", vec_size=64)
    with prog:
        x = pkg.Input("x")
        pkg.Output("y", 3 * x ** 2 + 5 * x - 2)
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    return prog


def _rotations(pkg, hsum):
    """Rotation-heavy: relinearization, rescales and key switches at two
    levels, and a plaintext input."""
    prog = pkg.EvaProgram("alphan", vec_size=64)
    with prog:
        x = pkg.Input("x")
        w = pkg.Input("w", False)
        acc = None
        for i, t in enumerate((1, 2, 3, 9, 10)):
            term = (x << t) * (0.3 * (i % 3) - 0.3)
            acc = term if acc is None else acc + term
        pkg.Output("y", acc * acc + w)
        pkg.Output("z", x * w)
    prog.set_output_ranges(20)
    prog.set_input_scales(40)
    return prog


def _hsum(pkg, hsum, encrypted=True):
    prog = pkg.EvaProgram("HorizontalSum", vec_size=256)
    with prog:
        x = pkg.Input("x", is_encrypted=encrypted)
        pkg.Output("y", hsum(x))
        pkg.Output("c", hsum([1 for _ in range(prog.vec_size)]))
    prog.set_output_ranges(25)
    prog.set_input_scales(33)
    return prog


def _both(build, **kw):
    """The program built and compiled by each package: (port, JAX)."""
    out = []
    for pkg, compiler, hsum in ((eva_tpu_torch, CompilerT, horizontal_sum),
                                (eva_tpu, CompilerJ, hsum_j)):
        prog = build(pkg, hsum, **kw)
        out.append((prog,) + compiler({"warn_vec_size": "false"}).compile(
            prog))
    return out


@pytest.mark.parametrize("build", [_poly, _rotations, _hsum])
def test_estimate_noise_equal(build):
    (prog, compiled, params, sig), (_, compiled_j, params_j, sig_j) = \
        _both(build)
    rng = random.Random(99)
    inputs = {name: [rng.uniform(-2, 2) for _ in range(prog.vec_size)]
              for name in sig.inputs}
    for values in (inputs, None):
        got = estimate_noise(compiled, params, sig, values)
        want = estimate_j(compiled_j, params_j, sig_j, values)
        assert got == want
        assert set(got) == set(compiled.outputs)


@pytest.mark.parametrize("encrypted", [True, False])
def test_horizontal_sum_compiles_to_the_same_program(encrypted):
    (prog, compiled, params, sig), (_, compiled_j, params_j, sig_j) = \
        _both(_hsum, encrypted=encrypted)
    assert ST.save_to_string(compiled) == SJ.save_to_string(compiled_j)
    assert ST.save_to_string(params) == SJ.save_to_string(params_j)
    assert ST.save_to_string(sig) == SJ.save_to_string(sig_j)
    x = list(np.linspace(0, 1, prog.vec_size))
    ref = eva_tpu_torch.evaluate(prog, {"x": x})
    np.testing.assert_allclose(ref["y"], [sum(x)] * prog.vec_size,
                               rtol=1e-12)
    assert ref["c"] == [float(prog.vec_size)] * prog.vec_size


def test_estimate_against_a_port_round_trip():
    """The estimate within 5x of the error the port's execution makes
    (the JAX package's own bound, tests/test_he.py)."""
    from eva_tpu_torch.runtime import generate_keys
    (prog, compiled, params, sig), _ = _both(_poly)
    rng = random.Random(99)
    inputs = {"x": [rng.uniform(-2, 2) for _ in range(64)]}
    est = estimate_noise(compiled, params, sig, inputs)
    assert est["y"]["verdict"] == "ok"
    pub, sec = generate_keys(params, device="cpu")
    out = sec.decrypt(pub.execute(compiled, pub.encrypt(inputs, sig)), sig)
    ref = eva_tpu_torch.evaluate(prog, inputs)
    measured = float(np.std(np.array(out["y"]) - np.array(ref["y"])))
    ratio = est["y"]["slot_error_std"] / max(measured, 1e-30)
    assert 0.2 < ratio < 5.0, f"estimator off by {ratio}x"


def test_encode_sigma_equal():
    from eva_tpu.runtime.noise import encode_sigma as encode_sigma_j
    for n, scale, rms in ((2048, 2.0 ** 30, 1.0), (16384, 2.0 ** 60, 3.5)):
        assert encode_sigma(n, scale, rms) == encode_sigma_j(n, scale, rms)
