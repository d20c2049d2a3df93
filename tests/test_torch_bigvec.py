"""Sharded big vectors (vec_size > N/2) in the port against the JAX package,
bit for bit.

The program is tests/test_bigvec.py's: x * y plus rotations in both
directions, by steps that do not divide by the shard count and by more
than the slot count, with x rotated twice (the hoisted branch). Scales
keep the ring at N = 4096 (2048 slots), so vec_size 4096 and 8192 shard
across k = 2 and 4 ciphertexts. eva_tpu compiles, generates the keys and
encrypts (numpy seeds); keys and ciphertexts are carried into the port
with eva_tpu_torch.convert (test_torch_executor's helpers); the port
executes on the CPU (the plain versions of the kernels)."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import eva_tpu
import eva_tpu_torch
from eva_tpu.backend.executor_jax import StructDigits as StructDigitsJ
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu.runtime import Executor as ExecutorJ
from eva_tpu.runtime import generate_keys as keygen_j
from eva_tpu_torch.backend.executor_torch import StructDigits
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT
from eva_tpu_torch.runtime import EVAPublic
from eva_tpu_torch.runtime import Executor as ExecutorT
from test_torch_executor import _assert_same, carry_keys, carry_values

torch.set_num_threads(1)


def _program(pkg, vec_size):
    prog = pkg.EvaProgram("bigvec", vec_size=vec_size)
    with prog:
        x = pkg.Input("x")
        y = pkg.Input("y")
        pkg.Output("z", x * y + (x << 3) - (y >> 1)
                   + (x << (vec_size // 2 + 5)))
    prog.set_output_ranges(10)
    prog.set_input_scales(20)
    return prog


@lru_cache(maxsize=None)
def _served(vec, k):
    """(k, eva_tpu compiled program and public context, the port's compiled
    program, keys and params, two encrypted valuations, and their numpy
    backend outputs)."""
    config = {"warn_vec_size": "false"}
    cj, pj, sj = CompilerJ(dict(config)).compile(_program(eva_tpu, vec))
    ct, pt, _ = CompilerT(dict(config)).compile(_program(eva_tpu_torch, vec))
    assert (pj.prime_bits, pj.rotations, pj.poly_modulus_degree) == \
        (pt.prime_bits, pt.rotations, pt.poly_modulus_degree)
    assert pj.poly_modulus_degree == 4096
    assert vec // (pj.poly_modulus_degree // 2) == k
    pub_j, _ = keygen_j(pj, backend="numpy")
    rng = np.random.default_rng(vec)
    encs = [pub_j.encrypt({n: rng.uniform(-2, 2, vec).tolist()
                           for n in sj.inputs}, sj) for _ in range(2)]
    ex_j = ExecutorJ(cj, pub_j.ctx, pub_j._keys, backend="numpy")
    refs = [ex_j.run(e) for e in encs]
    assert refs[0]["z"].polys[0].shape[0] == k  # the shard axis
    ctx_t, keys_t = carry_keys(pt, pub_j._keys)
    return k, (cj, pub_j), (ct, ctx_t, keys_t, pt), encs, refs


@pytest.fixture(params=[(4096, 2), (8192, 4)], ids=["k2", "k4"])
def bigvec(request):
    return _served(*request.param)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "structured"])
def test_bigvec_matches_numpy(bigvec, fused, monkeypatch):
    """execute on both key switches: relinearization through the fused
    or the structured key switch, the sharded rotations (hoisted and
    not) through the structured one."""
    if not fused:
        monkeypatch.setenv("EVA_TPU_NO_FUSED_KS", "1")
    k, _, (ct, ctx_t, keys_t, _), encs, refs = bigvec
    ex = ExecutorT(ct, ctx_t, keys_t, backend="torch", device="cpu")
    tp = ex._get_torch_program()
    assert tp.k == k and tp._hoisted_sources and not tp._rotsum_on
    for enc, ref in zip(encs, refs):
        _assert_same(ref, ex.run(carry_values(enc)))


def test_bigvec_batch_matches_numpy(bigvec):
    """execute_batch of 2: planes [2, k, n_sub, N]."""
    _, _, (ct, ctx_t, keys_t, pt), encs, refs = bigvec
    pub = EVAPublic(ctx_t, keys_t, pt, backend="torch", device="cpu")
    outs = pub.execute_batch(ct, [carry_values(e) for e in encs])
    assert len(outs) == 2
    for out, ref in zip(outs, refs):
        _assert_same(ref, out)


def test_bigvec_matches_jax_backend():
    """The port's output against the JAX backend's own, at k = 2 (its
    trace and compile take ~16 s on the CPU; k = 4 would add as much for
    the same code path)."""
    _, (cj, pub_j), (ct, ctx_t, keys_t, _), encs, _ = _served(4096, 2)
    out_j = ExecutorJ(cj, pub_j.ctx, pub_j._keys, backend="jax").run(encs[0])
    ex = ExecutorT(ct, ctx_t, keys_t, backend="torch", device="cpu")
    _assert_same(out_j, ex.run(carry_values(encs[0])))


@pytest.mark.parametrize("shift,lo,hi", [(0, 0, 4), (1, 0, 3), (1, 3, 4),
                                         (3, 1, 4), (2, 2, 4)])
def test_shard_window_matches_jax(shift, lo, hi):
    """StructDigits.shard_window against the JAX one: own [B, k, n_cur,
    N], a [B, k, n_groups - 1, n_cur, N], b [B, k, n_groups, n_key, N]."""
    rng = np.random.default_rng(100 * shift + 10 * lo + hi)
    own = rng.integers(0, 2 ** 31, (2, 4, 3, 8))
    a = rng.integers(0, 2 ** 31, (2, 4, 2, 3, 8))
    b = rng.integers(0, 2 ** 31, (2, 4, 3, 2, 8))
    got = StructDigits(*(torch.from_numpy(x) for x in (own, a, b)),
                       3).shard_window(shift, lo, hi)
    want = StructDigitsJ(own, a, b, 3).shard_window(shift, lo, hi)
    for g, w in ((got.own, want.own), (got.a, want.a), (got.b, want.b)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = StructDigits(torch.from_numpy(own), None, torch.from_numpy(b),
                       1).shard_window(shift, lo, hi)
    assert one.a is None and one.own.shape[1] == hi - lo
