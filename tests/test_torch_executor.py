"""The whole slice: compiled programs executed by eva_tpu_torch against the
JAX package.

Each program is compiled by both packages (parameters and signature must
agree). eva_tpu generates the keys and encrypts; the key set and the
ciphertexts are carried into the port with eva_tpu_torch.convert; the
port executes with Executor(backend="torch", device="cpu") (the plain
PyTorch versions of the NTT and key-switch kernels). The output
ciphertexts must be
bit-identical to eva_tpu's: its JAX backend for two programs here, its
numpy backend (which the repo's own tests hold bit-identical to JAX) for
the rest (here and in test_torch_programs.py, which uses these
helpers)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import eva_tpu
import eva_tpu_torch
import torch_mesh_ranks as R
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu.runtime import Executor as ExecutorJ
from eva_tpu.runtime import generate_keys as keygen_j
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT
from eva_tpu_torch.runtime import Executor as ExecutorT

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(pkg, name, f, vec, scale, n_inputs=1, plain_w=False):
    prog = pkg.EvaProgram(name, vec_size=vec)
    with prog:
        x = pkg.Input("x")
        if plain_w:
            pkg.Output("y", f(x, pkg.Input("w", False)))
        elif n_inputs == 2:
            pkg.Output("y", f(x, pkg.Input("v")))
        else:
            pkg.Output("y", f(x))
    prog.set_output_ranges(20)
    prog.set_input_scales(scale)
    return prog


def _deep(x):
    y = x
    for _ in range(3):
        y = y * y
    return y + (x << 1) * 2


# name: (program, vec_size, input scale, extra compiler config, build kw)
PROGRAMS = {
    # TestCrossBackendEquivalence
    "xbe": (lambda x, w: (x << 1) * 3 + (x >> 2) * w + x * x - 1, 16, 30,
            {}, {"plain_w": True}),
    # TestFusedRescaleRelin (lazy and eager relinearization adjacency)
    "fused": (lambda x, y: (x * y) * (x * y) + x, 16, 60, {},
              {"n_inputs": 2}),
    "fusedE": (lambda x: (x * x) * (x * x), 16, 60,
               {"lazy_relinearize": "false"}, {}),
    # TestRotationSumFusion
    "hoisted_sum": (lambda x: (x << 1) + (x << 2) + (x << 3) - 2, 16, 30,
                    {}, {}),
    "giants": (lambda x: ((x * x + (x << 1)) + ((x * 1.5 + 1) << 2))
               + ((x * 0.5) << 3), 16, 30, {}, {}),
    "rot_of_sum": (lambda x: ((x << 1) + (x << 2)) << 3, 16, 30, {}, {}),
    "mixed_sub": (lambda x: ((x << 1) + (x << 2)) - (x << 3), 16, 30, {}, {}),
    "babystep": (lambda x: ((x << 1) * 2.0 + (x << 2) * (-0.5)
                            + (x << 3) * 1.25), 16, 30, {}, {}),
    "conv_square": (lambda x: ((x << 1) * 2.0 + (x << 2) * 3.0)
                    * ((x << 1) * 0.5 + (x << 3) * 1.5), 16, 30, {}, {}),
    "babystep_sub": (lambda x: (x << 1) * 2.0 - (x << 2) * 0.5 - x, 16, 30,
                     {}, {}),
    "neg_defer": (lambda x: -((x << 1) * 2.0) + (x << 2), 16, 30, {}, {}),
    "lone": (lambda x: (x << 1) + x * 2.0 + 1, 16, 30, {}, {}),
    "bs_opt": (lambda x: ((x << 1) * 2.0 + (x << 2) * (-1.5)
                          + (x << 3) * 0.5 + 1), 16, 30, {}, {}),
    # TestHoistedPermuteAfter
    "rotk": (lambda x: (x << 1) + (x << 1) * (x << 1), 16, 30, {}, {}),
    "upc": (lambda x: x * [0.5] * 16 + 1, 16, 30, {}, {}),
    # TestTwoEntryKSJax (key_terms=2, alpha=4)
    "deep2p": (_deep, 1024, 40, {"two_entry_ks": "true"}, {}),
    # test_torch_batch.py: hoisted rotations, a lone rotation of a sum, a
    # stacked plaintext input and relinearizations
    "batch": (lambda x, w: (((x << 1) + (x << 2)) << 3) * w + x * x, 16,
              30, {}, {"plain_w": True}),
}


def _compile_both(name):
    f, vec, scale, cfg, kw = PROGRAMS[name]
    config = {"warn_vec_size": "false", **cfg}
    prog_j = _build(eva_tpu, name, f, vec, scale, **kw)
    prog_t = _build(eva_tpu_torch, name, f, vec, scale, **kw)
    got_j, got_t = compile_pair(prog_j, prog_t, config)
    return (prog_j, *got_j), (prog_t, *got_t)


def compile_pair(prog_j, prog_t, config):
    """One program, built with eva_tpu (prog_j) and with the port
    (prog_t), compiled by each package under `config`: the parameters,
    signature and topological op sequence must agree. Returns both
    (program, params, signature) triples."""
    cj, pj, sj = CompilerJ(dict(config)).compile(prog_j)
    ct, pt, st = CompilerT(dict(config)).compile(prog_t)
    assert (pj.prime_bits, pj.rotations, pj.poly_modulus_degree,
            pj.key_terms) == (pt.prime_bits, pt.rotations,
                              pt.poly_modulus_degree, pt.key_terms)
    assert sj.vec_size == st.vec_size
    assert {k: (v.input_type.name, v.scale, v.level)
            for k, v in sj.inputs.items()} == \
        {k: (v.input_type.name, v.scale, v.level)
         for k, v in st.inputs.items()}
    assert [t.op.name for t in cj.topological_order()] == \
        [t.op.name for t in ct.topological_order()]
    return (cj, pj, sj), (ct, pt, st)


def carry_keys(params, ks):
    """The port's context and KeySet holding eva_tpu's key material."""
    return R.port_keys(R.keys_payload(params, ks))


def carry_values(values):
    """The port's valuation holding eva_tpu's ciphertexts, plaintexts and
    raw values."""
    return R.port_values(R.values_payload(values))


def _assert_same(out_ref, out_port):
    assert set(out_ref) == set(out_port)
    for k in out_ref:
        a, b = out_ref[k], out_port[k]
        assert a.level == b.level and a.scale == b.scale, k
        assert len(a.polys) == len(b.polys)
        for pa, pb in zip(a.polys, b.polys):
            np.testing.assert_array_equal(np.asarray(pa).astype(np.uint64),
                                          pb)


def check_against_eva_tpu(prog_j, prog_t, inputs, config, env=None):
    """The oracle of the program matrices (test_torch_fuzz.py,
    test_torch_he.py, test_torch_large.py): one program built with each
    package (prog_j, prog_t), compiled by each under `config`
    (compile_pair), the compile holding plaintext semantics (MSE < 1e-10
    against evaluate). Under `env`: eva_tpu generates the keys and
    encrypts; its numpy backend executes; the port executes on the keys
    and ciphertexts carried over, with Executor(backend="torch",
    device="cpu"). Each output: residues and level equal to the numpy
    backend's, scale equal to eva_tpu's planner value (ROADMAP.md Queue
    3: the numpy backend may differ by one ulp), plaintexts and raw values
    equal; the port's decryption within MSE 0.01 of evaluate. Returns
    (port outputs, port params)."""
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVASecret, EVAValuation
    from torch_random_programs import environment

    (cj, pj, sj), (ct, pt, st) = compile_pair(prog_j, prog_t, config)
    reference = evaluate(prog_t, inputs)
    assert valuation_mse(reference, evaluate(ct, inputs)) < 1e-10
    with environment(env or {}):
        pub, _ = keygen_j(pj, backend="numpy")
        enc = pub.encrypt(inputs, sj)
        ex_j = ExecutorJ(cj, pub.ctx, pub._keys, backend="numpy")
        out_ref = ex_j.run(enc)
        ctx_t, keys_t = carry_keys(pt, pub._keys)
        out_t = ExecutorT(ct, ctx_t, keys_t, backend="torch",
                          device="cpu").run(carry_values(enc))
    assert set(out_ref) == set(out_t)
    for name, a in out_ref.items():
        b = out_t[name]
        if hasattr(a, "polys") or hasattr(a, "poly"):
            planner = ex_j.plan[cj.outputs[name].index]
            assert (b.level, b.scale) == (a.level, planner.scale), name
            pa = a.polys if hasattr(a, "polys") else [a.poly]
            pb = b.polys if hasattr(b, "polys") else [b.poly]
            assert len(pa) == len(pb), name
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(
                    np.asarray(x).astype(np.uint64), y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    out = EVASecret(ctx_t, keys_t, pt).decrypt(EVAValuation(pt, out_t), st)
    mse = valuation_mse(out, reference)
    assert mse < 0.01, f"HE round-trip MSE {mse}"
    return out_t, pt


def _run(name, ref_backend, monkeypatch=None, env=None):
    (prog_j, cj, pj, sj), (prog_t, ct, pt, st) = _compile_both(name)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    pub, sec = keygen_j(pj, backend="numpy")
    rng = np.random.default_rng(sum(map(ord, name)))
    inputs = {k: rng.uniform(-1, 1, sj.vec_size).tolist() for k in sj.inputs}
    enc = pub.encrypt(inputs, sj)
    out_ref = ExecutorJ(cj, pub.ctx, pub._keys, backend=ref_backend).run(enc)
    ctx_t, keys_t = carry_keys(pt, pub._keys)
    ex_t = ExecutorT(ct, ctx_t, keys_t, backend="torch", device="cpu")
    out_t = ex_t.run(carry_values(enc))
    _assert_same(out_ref, out_t)
    return ex_t, out_t, (ctx_t, keys_t, ct, pt, st, prog_t, inputs, enc)


@pytest.mark.parametrize("name", ["xbe", "hoisted_sum"])
def test_bit_identical_to_jax_backend(name):
    _run(name, "jax")


def test_layout_rot_and_upload_cache():
    """Hoisted rotations MAC against the inverse-permuted key layout;
    re-executing an input hits the device-upload cache."""
    ex_t, out1, (ctx_t, keys_t, ct, _, _, _, _, enc) = _run("rotk", "numpy")
    tp = ex_t._get_torch_program()
    g = ctx_t.galois_elt(1)
    ksk = keys_t.galois[g]
    perm = torch.from_numpy(ctx_t.perm_for_elt(g).astype(np.int64))
    for comp_p, comp_r in zip(tp.dkeys.layout(ksk, 0),
                              tp.dkeys.layout_rot(ksk, 0, g)):
        for a, b in zip(comp_p, comp_r):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, torch.index_select(b, -1, perm))
    ex_u, out_u, extra = _run("upc", "numpy")
    tp_u = ex_u._get_torch_program()
    n_cached = len(tp_u._upload_cache)
    assert n_cached >= 1
    vals = carry_values(extra[-1])
    again = [ex_u.run(vals), ex_u.run(vals)]
    assert len(tp_u._upload_cache) == n_cached + 1  # one new cipher input
    _assert_same(again[0], again[1])
    _assert_same(out_u, again[0])


def test_polynomial_round_trip_with_port_keygen():
    """The SKILL.md polynomial, end to end in the port alone: its own key
    generation, encryption, torch execution on the CPU and decryption."""
    from eva_tpu_torch import EvaProgram, Input, Output, evaluate
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    poly = EvaProgram("Polynomial", vec_size=1024)
    with poly:
        x = Input("x")
        Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)
    inputs = {"x": [i * 0.001 for i in range(poly.vec_size)]}
    ref = evaluate(poly, inputs)
    compiled, params, sig = CompilerT({"warn_vec_size": "false"}).compile(
        poly)
    assert valuation_mse(ref, evaluate(compiled, inputs)) < 1e-10
    pub, sec = generate_keys(params, device="cpu")
    enc = pub.encrypt(inputs, sig)
    out = pub.execute(compiled, enc)
    assert valuation_mse(sec.decrypt(out, sig), ref) < 0.01
    host = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")
    _assert_same(host.execute(compiled, enc), out)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pub.execute_batch(compiled, [enc], mesh=object())


def test_generate_keys_refuses_to_fall_back_to_cpu(monkeypatch):
    from eva_tpu_torch.ckks.params import CKKSParameters
    from eva_tpu_torch.runtime import generate_keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = CKKSParameters([60, 40, 60], [], 8192)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_keys(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_keys(params, backend="torch", device=None)


def test_public_context_and_executor_default_to_the_card(monkeypatch):
    """EVAPublic and Executor built directly, with no backend named, run on
    the CUDA device too: without one they raise, and never fall back to
    the host numpy path."""
    from eva_tpu_torch import EvaProgram, Input, Output
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    prog = EvaProgram("Square", vec_size=16)
    with prog:
        x = Input("x")
        Output("y", x * x)
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    compiled, params, _ = CompilerT({"warn_vec_size": "false"}).compile(prog)
    pub, _ = generate_keys(params, backend="numpy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EVAPublic(pub.ctx, pub._keys, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecutorT(compiled, pub.ctx, pub._keys)
    with pytest.raises(ValueError, match="unknown backend"):
        EVAPublic(pub.ctx, pub._keys, params, backend=None)
    assert EVAPublic(pub.ctx, pub._keys, params, backend="numpy").device is None


def test_import_pulls_in_neither_jax_nor_eva_tpu():
    code = ("import sys, eva_tpu_torch, eva_tpu_torch.runtime, "
            "eva_tpu_torch.convert, eva_tpu_torch.backend.executor_torch, "
            "eva_tpu_torch.backend.keygen, eva_tpu_torch.profiling, "
            "eva_tpu_torch.runtime.noise, eva_tpu_torch.std.numeric, "
            "eva_tpu_torch.serialization, eva_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'eva_tpu' or "
            "m.startswith('eva_tpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
