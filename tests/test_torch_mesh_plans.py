"""The mesh programs at one rank: TorchProgram._force_plan (private, off
by default) makes a one-rank mesh take the digit-parallel ("dp"),
sequence-parallel ("seq") or combined ("dp+seq") program at one shard,
which the card captures in CUDA graphs with their NCCL collectives
inside. Here, on a one-rank gloo world (tests/torch_mesh_ranks.py),
each forced plan's outputs are held to eva_tpu's numpy backend on the
same keys and ciphertexts: residues and level equal, scale equal to
eva_tpu's planner value (ROADMAP.md Queue 3); the switch is off by
default; the capture cache keys mesh programs by mesh, plan and input
shapes; and a warm mesh program makes no tensor of host data and reads
none on the host, which its capture relies on. The graphs themselves
need the card: chip_smoke.py's mesh phase."""

import functools

import numpy as np
import pytest

import eva_tpu
import eva_tpu_torch
import torch_mesh_ranks as R
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu.runtime import Executor as ExecutorJ
from eva_tpu.runtime import generate_keys as keygen_j
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT

PLANS = ("dp", "seq", "dp+seq")
# Sobel 8x8 (N = 8192) and test_parallel.py's program with a
# relinearization and a hoisted rotation source.
PROGRAMS = ("sobel", "dp")


# Valuations of each program: two for the batch sizes of the capture
# keys case.
VALUATIONS = {"sobel": 1, "dp": 2}


@functools.lru_cache(maxsize=None)
def _program(name):
    """(keys payload, VALUATIONS[name] valuations' payloads, eva_tpu's
    numpy backend outputs, {output: planner scale}) of program `name`."""
    config = {"warn_vec_size": "false"}
    cj, pj, sj = CompilerJ(dict(config)).compile(R.build(eva_tpu, name))
    _, pt, _ = CompilerT(dict(config)).compile(R.build(eva_tpu_torch, name))
    assert (pj.prime_bits, pj.rotations, pj.poly_modulus_degree,
            pj.key_terms) == (pt.prime_bits, pt.rotations,
                              pt.poly_modulus_degree, pt.key_terms)
    pub, _ = keygen_j(pj, backend="numpy")
    rng = np.random.default_rng(sum(map(ord, name)))
    encs = [pub.encrypt({k: rng.uniform(-1, 1, sj.vec_size).tolist()
                         for k in sj.inputs}, sj)
            for _ in range(VALUATIONS[name])]
    ex = ExecutorJ(cj, pub.ctx, pub._keys, backend="numpy")
    scales = {k: ex.plan[t.index].scale for k, t in cj.outputs.items()}
    return (R.keys_payload(pj, pub._keys), [R.values_payload(e) for e in encs],
            [ex.run(e) for e in encs], scales)


# Steps of the capture-key case: (mesh 0 or 1, forced plan, batch size).
# The batch plan's graph is the single-device program's, whatever the
# mesh; every other step of a new (mesh, plan, batch) captures.
STEPS = ((0, None, 1), (0, "dp", 1), (0, "seq", 1), (0, "dp+seq", 1),
         (0, "dp", 2), (1, "dp", 1), (1, None, 1), (0, "dp", 1))
CAPTURED = STEPS[:6]


@pytest.fixture(scope="module")
def rank():
    """Every case's result on the one rank of a gloo world: Sobel on one
    valuation and the "dp" program on two under each forced plan, the
    switch off and a plan name that is none; the capture keys and the
    warm runs on "dp"."""
    sobel_keys, sobel_values, _, _ = _program("sobel")
    dp_keys, dp_values, _, _ = _program("dp")
    cases = [
        {"kind": "forced", "program": "sobel", "keys": sobel_keys,
         "values": sobel_values, "plans": (None,) + PLANS},
        {"kind": "forced", "program": "dp", "keys": dp_keys,
         "values": dp_values, "plans": (None, "hlimb") + PLANS},
        {"kind": "capture_keys", "program": "dp", "keys": None,
         "values": dp_values, "steps": STEPS},
        {"kind": "host_reads", "program": "dp", "keys": None,
         "values": dp_values[:1], "plans": PLANS}]
    (res,) = R.run_world(1, cases)
    assert res["modules"] == [], res["modules"]
    forced = dict(zip(PROGRAMS, res["results"]))
    return {"forced": forced, "keys": res["results"][2],
            "host_reads": res["results"][3]}


def _assert_numpy(name, outputs):
    """A rank's outputs against eva_tpu's numpy backend: residues and
    level equal, scale equal to eva_tpu's planner value."""
    _, _, refs, scales = _program(name)
    assert not isinstance(outputs, tuple), outputs  # no error
    assert outputs and len(outputs) == len(refs)
    for ref, got in zip(refs, outputs):
        assert set(ref) == set(got)
        for k, ct in ref.items():
            polys, level, scale = got[k]
            assert (level, scale) == (ct.level, scales[k]), k
            assert len(polys) == len(ct.polys)
            for a, b in zip(ct.polys, polys):
                np.testing.assert_array_equal(
                    np.asarray(a).astype(np.uint64), b)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_forced_plan_bit_identical_to_numpy(rank, name, plan):
    got = rank["forced"][name][plan]
    assert got["ran"] == [plan]
    _assert_numpy(name, got["outputs"])


@pytest.mark.parametrize("name", PROGRAMS)
def test_switch_off_by_default_takes_the_batch_plan(rank, name):
    got = rank["forced"][name][None]
    assert got["ran"] == ["batch"]
    _assert_numpy(name, got["outputs"])


def test_capture_key_separates_meshes_plans_and_shapes(rank):
    """Each new (mesh, forced plan, batch size) captures once, and a
    repeat replays; the batch plan's graph is the single-device
    program's, shared by both meshes. Every output equals the batch
    without a mesh. Releasing mesh 0 drops its mesh programs' graphs
    and its plans, and keeps the single-device graph and mesh 1's."""
    got = rank["keys"]
    assert got["captured"] == list(CAPTURED)
    assert got["keys"] == [len(CAPTURED), 2]
    assert got["plans"] == [0, 2]
    assert got["equal"]


def test_warm_mesh_programs_upload_and_read_nothing(rank):
    assert rank["host_reads"] == {p: None for p in PLANS}


def test_forced_plan_refuses_another_name(rank):
    got = rank["forced"]["dp"]["hlimb"]
    assert got["outputs"][0] == "ValueError"
    assert "choose dp, seq or dp+seq" in got["outputs"][1]
    assert got["ran"] == []
