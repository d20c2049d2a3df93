"""The port's storage rule, checked on the CPU: every residue tensor that
the executor holds or returns is int32 (the JAX package's uint32 bit
patterns), every index tensor int64, and the host sees uint64 values
read through a uint32 view.

Covered: the key layouts of DeviceKeys (structured, hoisted, dense and
digit-parallel), the program's constant cache, the upload cache, the
level ops' tables and constants, the Galois permutations, `_traced`
outputs, keygen's device planes and its host output, and the payloads of
the collectives of a mesh run (a one-rank gloo world): execute_batch on
a (batch 1, limb 1) mesh, ShardedKeySwitch and ShardedNTT at one shard,
shard_batch and replicated."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from eva_tpu_torch.backend import executor_torch as et
from eva_tpu_torch.backend import tables
from eva_tpu_torch.backend.keygen import DeviceKeygen
from eva_tpu_torch.backend.modmath import upload
from eva_tpu_torch.ckks import CKKSCompiler
from eva_tpu_torch.crypto import keys as K
from eva_tpu_torch.runtime import EVAPublic, generate_keys
from test_torch_capture import _mini_sobel

torch.set_num_threads(1)

# Program constant-cache keys whose tables are indices.
INDEX_CONSTS = ("ks_idx", "ks_owner")


def _tensors(obj):
    """Every tensor inside nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def _all_int32(obj, what):
    found = list(_tensors(obj))
    assert found, what
    bad = [t.dtype for t in found if t.dtype != torch.int32]
    assert not bad, (what, bad)


@pytest.fixture(scope="module")
def program():
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(_mini_sobel(64))
    pub, _ = generate_keys(params, device="cpu")
    rng = np.random.default_rng(5)
    encs = [pub.encrypt({"image": rng.uniform(0, 1, 64).tolist()}, sig)
            for _ in range(2)]
    return pub, compiled, params, encs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "structured"])
def test_executor_state_and_outputs_are_int32(program, fused, monkeypatch):
    if not fused:
        monkeypatch.setenv("EVA_TPU_NO_FUSED_KS", "1")
    pub, compiled, params, encs = program
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    out = tp._traced(*tp._inputs(ex._host_phase(encs[0])[0]))
    _all_int32(out, "_traced outputs")
    for key, t in tp._consts.items():
        want = torch.int64 if key[0] in INDEX_CONSTS else torch.int32
        assert t.dtype == want, key
    assert any(k[0] in INDEX_CONSTS for k in tp._consts)
    _all_int32([v[1] for v in tp.dkeys._cache.values()], "key layouts")
    _all_int32([v[1] for v in tp._upload_cache.values()], "uploads")
    for ops in tables._LEVEL_OPS_CACHE.values():
        _all_int32([ops.q, ops.r2, ops.rinv, ops.one, ops.mst_f, ops.mst_i,
                    ops.ninv], "level tables")
        if ops._consts:
            _all_int32(ops._consts, "level constants")
    for _, perm in et._DEV_PERM_CACHE.values():
        assert perm.table.dtype == torch.int32
    # The host sees the numpy backend's uint64 values.
    host = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")
    want = host.execute(compiled, encs[1])
    got = pub.execute(compiled, encs[1])
    for a, b in zip(want["image"].polys, got["image"].polys):
        assert b.dtype == np.uint64
        np.testing.assert_array_equal(a, b)


def test_digit_parallel_tables_and_keys(program):
    """A digit shard's tables: member indices int64, conversion constants
    and key slices int32."""
    pub, compiled, _, _ = program
    tp = pub._executor_for(compiled)._get_torch_program()
    tabs, keys = tp._dp_materialize(2, 1)
    for member, conv in tabs.values():
        assert member.dtype == torch.int64
        assert conv.dtype == torch.int32
    _all_int32(keys, "digit-shard keys")


def test_keygen_planes_are_int32_and_host_keys_uint64():
    from eva_tpu_torch.crypto.context import CKKSContext
    ctx = CKKSContext([60, 30, 60], [1], 1024)
    rng = np.random.default_rng(2)
    s = K.SecretKey(ctx, rng.integers(-1, 2, ctx.n, dtype=np.int64))
    basis = ctx.all_primes
    groups = ctx.ks_groups(1)
    As = [K.expand_uniform(ctx, basis, rng.bytes(32)) for _ in groups]
    Es = [np.rint(rng.normal(0.0, 3.2, ctx.n)).astype(np.int64)
          for _ in groups]
    facs = rng.integers(0, np.array(basis, dtype=np.uint64),
                        (len(groups), len(basis)), dtype=np.uint64)
    eng = DeviceKeygen(ctx, device="cpu")
    seen = []
    real = eng._compute

    def spy(*args):
        seen.extend(args)
        out = real(*args)
        seen.append(out)
        return out

    eng._compute = spy
    k0, k1 = eng.ksk_compute(s.s, (s.s * s.s) % ctx.qvec(basis), As, Es,
                             facs)
    _all_int32(seen, "keygen planes")
    want = K._ksk_compute(ctx, s.s, (s.s * s.s) % ctx.qvec(basis), As, Es,
                          facs, None)
    for w, g in zip(want[0], k0):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(w, g)


@pytest.fixture
def gloo_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_payloads_are_int32(program, gloo_world, monkeypatch):
    """What the collectives carry on a one-rank gloo world: the output
    planes of execute_batch on a mesh (all_gather), the modular
    all-reduce of ShardedKeySwitch (all_gather) and the four-step
    exchange of ShardedNTT (all_to_all_single); and shard_batch /
    replicated uploads."""
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.parallel import (ShardedKeySwitch, get_sharded_ntt,
                                        make_device_mesh, replicated,
                                        shard_batch)
    payloads = []
    for name in ("all_gather", "all_to_all_single"):
        real = getattr(dist, name)

        def spy(*args, _real=real, **kwargs):
            payloads.extend(_tensors(args))
            return _real(*args, **kwargs)

        monkeypatch.setattr(dist, name, spy)
    pub, compiled, _, encs = program
    mesh = make_device_mesh(1, device_type="cpu")
    want = pub.execute_batch(compiled, encs)
    got = pub.execute_batch(compiled, encs, mesh=mesh)
    for w, g in zip(want, got):
        for a, b in zip(w["image"].polys, g["image"].polys):
            np.testing.assert_array_equal(a, b)
    ctx, keys = pub.ctx, pub._keys
    rng = np.random.default_rng(3)
    poly = np.stack([rng.integers(0, q, ctx.n, dtype=np.uint64)
                     for q in ctx.primes_at_level(0)])
    digit = init_device_mesh("cpu", (1,), mesh_dim_names=("digit",))
    d0, d1 = ShardedKeySwitch(ctx, keys.relin, 0, digit)(poly)
    _all_int32([d0, d1], "ShardedKeySwitch outputs")
    primes = ctx.primes_at_level(0)
    sntt = get_sharded_ntt(tuple(primes), ctx.n, dist.group.WORLD)
    x = upload(poly, "cpu").reshape(len(primes), sntt.n1, sntt.n2)
    _all_int32(sntt.ntt(x), "ShardedNTT output")
    assert len(payloads) >= 3
    _all_int32(payloads, "collective payloads")
    _all_int32([shard_batch(poly[None], mesh), replicated(poly, mesh)],
               "uploads")
