"""The JAX package's random-program oracle (tests/test_fuzz.py) through the
port.

torch_random_programs.random_program and random_config are test_fuzz's
generators with the DSL package passed in. The same seed gives the same
program: test_fuzz's generator, the helper on eva_tpu and the helper on
eva_tpu_torch draw the same programs and configs (same parameters, same
topological op sequence after compiling). The port's compiler preserves
plaintext semantics on test_fuzz's 60 programs (one case each) and on
the lowered-sub regression. The HE sample runs test_fuzz's 6 round-trip
programs through test_torch_executor.check_against_eva_tpu: eva_tpu's
keys and ciphertexts, the port on the CPU, bit-identical to eva_tpu's
numpy backend (test_torch_fuzz_wide.py adds programs of
random_case_wide). Also here: tools/fuzz_cuda.py's checks on the CPU,
and the repair the card's fuzz run found."""

import functools
import random

import pytest
import torch

import eva_tpu
import eva_tpu_torch
import torch_random_programs as R
from eva_tpu_torch import evaluate
from eva_tpu_torch.ckks import CKKSCompiler
from eva_tpu_torch.metric import valuation_mse
from test_fuzz import random_config as fuzz_config
from test_fuzz import random_program as fuzz_program
from test_torch_executor import check_against_eva_tpu, compile_pair

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)


def _twins(rng, index, vec_size=None):
    """The same program from rng's state, built with eva_tpu and with the
    port; rng advances as one draw would advance it."""
    other = random.Random()
    other.setstate(rng.getstate())
    prog_j = R.random_program(eva_tpu, rng, index, vec_size)
    prog_t = R.random_program(eva_tpu_torch, other, index, vec_size)
    assert rng.getstate() == other.getstate()
    return prog_j, prog_t


@pytest.mark.parametrize("seed", [0xE7A, 0xBEEF, 0x7B0])
def test_same_seed_same_program(seed):
    """test_fuzz's generator and the helper, on eva_tpu and on the port,
    draw the same programs and configs from the same seed."""
    rngs = [random.Random(seed) for _ in range(3)]
    for i in range(20):
        ref = fuzz_program(rngs[0], i)
        prog_j = R.random_program(eva_tpu, rngs[1], i)
        prog_t = R.random_program(eva_tpu_torch, rngs[2], i)
        config = fuzz_config(rngs[0])
        assert R.random_config(rngs[1]) == config
        assert R.random_config(rngs[2]) == config
        assert len({r.getstate() for r in rngs}) == 1
        (cr, pr, _), _ = compile_pair(ref, prog_t, config)
        (cj, pj, _), _ = compile_pair(prog_j, prog_t, config)
        assert (pr.prime_bits, pr.rotations, pr.poly_modulus_degree) == \
            (pj.prime_bits, pj.rotations, pj.poly_modulus_degree)
        assert [t.op.name for t in cr.topological_order()] == \
            [t.op.name for t in cj.topological_order()]


@functools.lru_cache(maxsize=None)
def _compile_draws():
    """test_fuzz.test_compile_preserves_semantics's draws: (program,
    inputs, config) for each of its 60 programs, built with the port."""
    rng = random.Random(0xE7A)
    draws = []
    for i in range(60):
        prog = R.random_program(eva_tpu_torch, rng, i)
        inputs = {name: [rng.uniform(-2, 2) for _ in range(prog.vec_size)]
                  for name in prog.inputs}
        draws.append((prog, inputs, R.random_config(rng)))
    return draws


@pytest.mark.parametrize("index", range(60))
def test_compile_preserves_semantics(index):
    prog, inputs, config = _compile_draws()[index]
    compiled, _, _ = CKKSCompiler(dict(config)).compile(prog)
    mse = valuation_mse(evaluate(prog, inputs), evaluate(compiled, inputs))
    assert mse < 1e-10, (index, prog.vec_size, mse)


@pytest.mark.parametrize("rescaler",
                         ["always", "lazy_waterline", "eager_waterline"])
@pytest.mark.parametrize("lazy_relin", ["true", "false"])
def test_lowered_sub_reaches_validation_typed(rescaler, lazy_relin):
    """test_fuzz's regression: BackendLowering's Add(plain, Negate(cipher))
    joining a rescaled branch must reach the checkers typed."""
    prog = eva_tpu_torch.EvaProgram("lowered_sub", vec_size=8)
    with prog:
        p = eva_tpu_torch.Input("p", False)
        x = eva_tpu_torch.Input("x")
        d = -(p - x)
        m = (x + p) * [0.5] * 8
        eva_tpu_torch.Output("y0", d + m)
        eva_tpu_torch.Output("y1", m * ([0.25] * 8))
    prog.set_output_ranges(25)
    prog.set_input_scales(60)
    inputs = {"p": [i * 0.1 for i in range(8)],
              "x": [0.3 - i * 0.05 for i in range(8)]}
    compiled, _, _ = CKKSCompiler(
        {"rescaler": rescaler, "lazy_relinearize": lazy_relin,
         "warn_vec_size": "false"}).compile(prog)
    mse = valuation_mse(evaluate(prog, inputs), evaluate(compiled, inputs))
    assert mse < 1e-10, (rescaler, lazy_relin, mse)


@functools.lru_cache(maxsize=None)
def _he_draws():
    """test_fuzz.test_he_roundtrip_sample's draws: (eva_tpu program, port
    program, inputs, config) for its 6 programs."""
    rng = random.Random(0xBEEF)
    draws = []
    for i in range(6):
        prog_j, prog_t = _twins(rng, 100 + i)
        inputs = {name: [rng.uniform(-1, 1) for _ in range(prog_t.vec_size)]
                  for name in prog_t.inputs}
        draws.append((prog_j, prog_t, inputs, R.random_config(rng)))
    return draws


@pytest.mark.parametrize("index", range(6))
def test_he_roundtrip_sample(index):
    prog_j, prog_t, inputs, config = _he_draws()[index]
    check_against_eva_tpu(prog_j, prog_t, inputs, config)


def test_device_key_layouts_die_with_their_key_set():
    """Repair found by tools/fuzz_cuda.py on the card: the device key
    cache (executor_torch.device_keys) pinned every key set it had seen,
    so the memory allocated after each released program grew by its key
    layouts. The entry now lives as long as its key set."""
    import gc
    import weakref

    from eva_tpu_torch.backend import executor_torch
    from eva_tpu_torch.runtime import generate_keys

    prog = eva_tpu_torch.EvaProgram("rot", vec_size=16)
    with prog:
        x = eva_tpu_torch.Input("x")
        eva_tpu_torch.Output("y", (x << 1) * x)
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    compiled, params, sig = CKKSCompiler({"warn_vec_size": "false"}).compile(
        prog)
    pub, sec = generate_keys(params, device="cpu")
    pub.execute(compiled, pub.encrypt({"x": [0.5] * 16}, sig))
    held = (id(pub._keys), torch.device("cpu"))
    assert held in executor_torch._DEVICE_KEYS_CACHE
    keys = weakref.ref(pub._keys)
    del pub, sec
    gc.collect()
    assert keys() is None
    assert held not in executor_torch._DEVICE_KEYS_CACHE


def _fuzz_tool():
    import os
    import sys
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import fuzz_cuda
    return fuzz_cuda


def test_fuzz_tool_checks_a_program_on_the_cpu():
    """tools/fuzz_cuda.check_program's checks, run on the plain versions
    (device="cpu") for one random_case_wide program with a key switch:
    its record names N, alpha, n_key, the route and the rescaler."""
    fuzz_cuda = _fuzz_tool()
    rng = random.Random(7)
    prog, config, env, compiled = R.random_case_wide(eva_tpu_torch, rng, 0,
                                                     8192)
    inputs = {name: [rng.uniform(-1, 1) for _ in range(prog.vec_size)]
              for name in prog.inputs}
    rec = fuzz_cuda.check_program("cpu", prog, compiled, inputs, env,
                                  config["rescaler"], device="cpu")
    assert (rec["N"], rec["rescaler"]) == (8192, config["rescaler"])
    assert rec["route"] == ("structured" if env.get("EVA_TPU_NO_FUSED_KS")
                            else "fused")
    assert rec["mse"] < 0.01 and rec["n_key"] == 2


def test_fuzz_tool_reports_the_first_difference():
    """A residue that differs raises Mismatch with the record ROADMAP.md
    Queue 3 asks for: N, primes, level, alpha, (row, index), both
    values; a level or scale that differs raises too."""
    import numpy as np

    from eva_tpu_torch.crypto.ciphertext import Ciphertext
    from eva_tpu_torch.crypto.context import get_context

    fuzz_cuda = _fuzz_tool()
    ctx = get_context((60, 40, 60), (), 8192)
    planes = [np.arange(4 * 8192, dtype=np.uint64).reshape(4, 8192)] * 2
    want = {"y": Ciphertext(planes, 0, 2.0 ** 40)}
    bad = [planes[0], planes[1].copy()]
    bad[1][2, 17] += 1
    with pytest.raises(fuzz_cuda.Mismatch, match=r"N=8192 .*level=0 "
                       r"alpha=2.*\(row 2, index 17\).*want 16401 got 16402"):
        fuzz_cuda.compare("t", ctx, 2, "what", want,
                          {"y": Ciphertext(bad, 0, 2.0 ** 40)}, True)
    with pytest.raises(fuzz_cuda.Mismatch, match="scale"):
        fuzz_cuda.compare("t", ctx, 2, "what", want,
                          {"y": Ciphertext(planes, 0, 2.0 ** 41)}, True)
    fuzz_cuda.compare("t", ctx, 2, "what", want,
                      {"y": Ciphertext(planes, 0, 2.0 ** 41)}, False)
    with pytest.raises(fuzz_cuda.Mismatch, match="level 0 against 1"):
        fuzz_cuda.compare("t", ctx, 2, "what", want,
                          {"y": Ciphertext(planes, 1, 2.0 ** 40)}, False)


def test_card_scripts_import_neither_jax_nor_eva_tpu():
    """tools/fuzz_cuda.py, the helper module and chip_smoke.py run on a
    machine without JAX: drawing a wide program and building every
    matrix program with eva_tpu_torch imports no JAX and no eva_tpu."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import random, sys; sys.path[:0] = ['tools', 'tests']; "
        "import chip_smoke, fuzz_cuda, eva_tpu_torch; "
        "import torch_random_programs as R; "
        "R.random_case_wide(eva_tpu_torch, random.Random(1), 0); "
        "[c.build(eva_tpu_torch) for c in R.MATRIX.values()]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'eva_tpu')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
