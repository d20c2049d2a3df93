"""Batched and pipelined execution of the port (EVAPublic.execute_batch,
EVAPublic.execute_pipelined on the torch backend, on the CPU) against
per-element execute and the JAX package's numpy backend, bit for bit.

One program (the "batch" entry of test_torch_executor.PROGRAMS: hoisted
rotations, a lone rotation of a sum, a plaintext input that differs per
valuation, relinearizations) is compiled, keyed and encrypted once by
eva_tpu for four valuations; keys and ciphertexts are carried into the
port with eva_tpu_torch.convert."""

import numpy as np
import pytest
import torch

from eva_tpu.runtime import Executor as ExecutorJ
from eva_tpu.runtime import generate_keys as keygen_j
from eva_tpu_torch.backend import ks
from eva_tpu_torch.runtime import EVAPublic
from test_torch_executor import (_assert_same, _compile_both, carry_keys,
                                 carry_values)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    """(port public context, compiled program, carried valuations, numpy
    backend outputs, per-element port executes)."""
    (_, cj, pj, sj), (_, ct, pt, _) = _compile_both("batch")
    pub_j, _ = keygen_j(pj, backend="numpy")
    rng = np.random.default_rng(5)
    encs = [pub_j.encrypt({k: rng.uniform(-1, 1, sj.vec_size).tolist()
                           for k in sj.inputs}, sj) for _ in range(4)]
    ex_j = ExecutorJ(cj, pub_j.ctx, pub_j._keys, backend="numpy")
    refs = [ex_j.run(e) for e in encs]
    ctx_t, keys_t = carry_keys(pt, pub_j._keys)
    pub = EVAPublic(ctx_t, keys_t, pt, backend="torch", device="cpu")
    vals = [carry_values(e) for e in encs]
    seq = [pub.execute(ct, v) for v in vals]
    for r, s in zip(refs, seq):
        _assert_same(r, s)
    return pub, ct, vals, refs, seq


def test_execute_batch_matches_execute_and_numpy(served):
    pub, ct, vals, refs, seq = served
    calls = ks.PLAIN_CALLS["ks_mac"]
    outs = pub.execute_batch(ct, vals[:3])
    assert ks.PLAIN_CALLS["ks_mac"] > calls  # the fused key switch ran
    assert len(outs) == 3
    for out, s, r in zip(outs, seq, refs):
        _assert_same(s, out)
        _assert_same(r, out)


def test_execute_pipelined_matches_execute_and_numpy(served):
    pub, ct, vals, refs, seq = served
    outs = list(pub.execute_pipelined(ct, iter(vals), depth=2))
    assert len(outs) == 4
    for out, s, r in zip(outs, seq, refs):
        _assert_same(s, out)
        _assert_same(r, out)


def test_batch_refuses_a_mesh_and_the_numpy_backend(served):
    pub, ct, vals, _, _ = served
    with pytest.raises(NotImplementedError, match="multi-device"):
        pub.execute_batch(ct, vals[:2], mesh=object())
    host = EVAPublic(pub.ctx, pub._keys, pub.params, backend="numpy")
    with pytest.raises(ValueError, match="torch backend"):
        host.execute_batch(ct, vals[:2])
    with pytest.raises(ValueError, match="torch backend"):
        next(host.execute_pipelined(ct, iter(vals)))
