"""Compiled programs executed on meshes by the port
(EVAPublic.execute_batch(..., mesh=...) on gloo worlds of CPU processes)
against the JAX package's numpy backend on the same keys and ciphertexts.

eva_tpu compiles each program (the port must compile it to the same
parameters), generates the keys and encrypts; the key set and
ciphertexts travel to the ranks as plain arrays (tests/torch_mesh_ranks.py)
and are carried into the port there with eva_tpu_torch.convert. Every
rank returns every output, which must be bit-identical to eva_tpu's
numpy backend. tests/test_parallel.py already holds the JAX package's
own mesh execution to its single-device path; these tests do not repeat
it. The cases follow tests/test_parallel.py's."""

import functools

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

torch.set_num_threads(1)

# id: (world, make_device_mesh arguments, program, batches of elements,
# the mesh plan that must run: TorchProgram._sharded)
MESHES = {
    "batch2": (2, {}, "dp", [[0, 1, 2, 3]], "batch"),
    "seq2": (2, {"seq_axis": 2}, "dp", [[0, 1]], "seq"),
    "batch2_limb2": (4, {"limb_axis": 2}, "dp", [[0, 1, 2, 3]], "dp"),
    "limb4": (4, {"limb_axis": 4}, "dp", [[0, 1]], "dp"),
    "limb2_seq2": (4, {"limb_axis": 2, "seq_axis": 2}, "dp", [[0, 1]],
                   "dp+seq"),
    "host2_limb2": (4, {"limb_axis": 2, "hosts": 2}, "dp", [[0, 1, 2, 3]],
                    "dp"),
    "hlimb2_limb2": (4, {"limb_axis": 2, "dcn_limb": 2}, "dp", [[0, 1]],
                     "dp+hlimb"),
    "batch2_limb2_seq2": (8, {"limb_axis": 2, "seq_axis": 2}, "dp",
                          [[0, 1, 2, 3]], "dp+seq"),
    # Uneven (5 on 4 batch devices) and empty batches.
    "uneven_empty": (4, {}, "dp", [[0, 1, 2, 3, 4], []], "batch"),
    # A second batch size on the same mesh gets its own plan.
    "two_sizes": (4, {"limb_axis": 2}, "dp", [[0, 1, 2, 3], [0, 1]], "dp"),
    # A plaintext input per valuation, a lone rotation of a sum.
    "plain_input_batch2_limb2": (4, {"limb_axis": 2}, "batch", [[0, 1, 2]],
                                 "dp"),
    "plain_input_seq2": (4, {"seq_axis": 2}, "batch", [[0, 1]], "seq"),
    # Baby-step rotation-mul fusion on limb- and seq-sharded meshes.
    "babystep_limb4": (4, {"limb_axis": 4}, "babystep", [[0, 1]], "dp"),
    "babystep_seq4": (4, {"seq_axis": 4}, "babystep", [[0, 1]], "seq"),
    # Key switches at two levels on limb x seq.
    "deep_limb2_seq2": (4, {"limb_axis": 2, "seq_axis": 2}, "deep",
                        [[0, 1]], "dp+seq"),
}
# id: (world, mesh arguments, program, error the call must raise)
ERRORS = {
    # tests/test_parallel.py:479: a limb axis > 1 on a seq mesh needs key
    # switches to shard.
    "seq_limb_without_key_switches": (
        4, {"limb_axis": 2, "seq_axis": 2}, "plain_only", "key switches"),
    "hlimb_with_seq": (8, {"limb_axis": 2, "seq_axis": 2, "dcn_limb": 2},
                       "dp", "do not compose"),
}
N_ELEMENTS = {"dp": 5, "batch": 3, "babystep": 2, "deep": 2,
              "plain_only": 1}


@functools.lru_cache(maxsize=None)
def _program(name):
    """(keys, [valuations]) as the ranks' payload, and [numpy backend
    outputs] of program `name` (eva_tpu's keys and encryptions), made
    once."""
    config = {"warn_vec_size": "false"}
    cj, pj, sj = CompilerJ(dict(config)).compile(R.build(eva_tpu, name))
    _, pt, st = CompilerT(dict(config)).compile(
        R.build(eva_tpu_torch, name))
    assert (pj.prime_bits, pj.rotations, pj.poly_modulus_degree,
            pj.key_terms) == (pt.prime_bits, pt.rotations,
                              pt.poly_modulus_degree, pt.key_terms)
    pub, _ = keygen_j(pj, backend="numpy")
    rng = np.random.default_rng(sum(map(ord, name)))
    encs = [pub.encrypt({k: rng.uniform(-1, 1, sj.vec_size).tolist()
                         for k in sj.inputs}, sj)
            for _ in range(N_ELEMENTS[name])]
    ex = ExecutorJ(cj, pub.ctx, pub._keys, backend="numpy")
    return (R.keys_payload(pj, pub._keys), [R.values_payload(e) for e in encs],
            [ex.run(e) for e in encs])


@pytest.fixture(scope="module")
def worlds():
    """{case id: [per-rank results]}: every case run once, one world per
    world size."""
    by_world = {}
    for cid, (world, args, prog, *rest) in {**MESHES, **ERRORS}.items():
        batches = MESHES[cid][3] if cid in MESHES else [[0]]
        by_world.setdefault(world, []).append((cid, args, prog, batches))
    out = {}
    for world, items in sorted(by_world.items()):
        cases, sent = [], set()
        for cid, args, prog, batches in items:
            keys, values, _ = _program(prog)
            cases.append({
                "kind": "execute", "program": prog,
                "keys": None if prog in sent else keys,
                "values": values,
                "mesh": {"n_devices": world, **args},
                "batches": batches})
            sent.add(prog)
        res = R.run_world(world, cases)
        for r in res:
            assert r["modules"] == [], r["modules"]
        for i, (cid, *_) in enumerate(items):
            out[cid] = [r["results"][i] for r in res]
    return out


def _assert_same(ref, got):
    """eva_tpu output valuation against a rank's output planes."""
    assert set(ref) == set(got)
    for name, ct in ref.items():
        assert len(ct.polys) == len(got[name])
        for a, b in zip(ct.polys, got[name]):
            assert np.array_equal(np.asarray(a).astype(np.uint64), b)


@pytest.mark.parametrize("cid", list(MESHES))
def test_execute_batch_on_mesh_bit_identical_to_numpy(worlds, cid):
    _, _, prog, batches, plan = MESHES[cid]
    _, _, refs = _program(prog)
    for rank in worlds[cid]:
        # The empty batch returns before any plan is made.
        assert rank["plans"] == [plan], rank["plans"]
        rank_out = rank["outputs"]
        assert len(rank_out) == len(batches)
        for idx, outs in zip(batches, rank_out):
            assert not isinstance(outs, tuple), outs  # no error
            assert len(outs) == len(idx)
            for i, got in zip(idx, outs):
                _assert_same(refs[i], got)


@pytest.mark.parametrize("cid", list(ERRORS))
def test_mesh_error_paths(worlds, cid):
    want = ERRORS[cid][3]
    for rank in worlds[cid]:
        (err,) = rank["outputs"]
        assert isinstance(err, tuple) and err[0] == "ValueError", err
        assert want in err[1]
