"""The port's multi-device modules (eva_tpu_torch.parallel) against the JAX
package's (eva_tpu.parallel), on gloo worlds of CPU processes.

Each world (2, 4 and 8 ranks; tests/torch_mesh_ranks.py) is started once
and runs every case of its size; the inputs are made here from seeds with
numpy. The JAX side runs on the virtual 8-device CPU mesh of
tests/conftest.py, at small N. All arithmetic is exact modular arithmetic,
so every comparison is bit-identity."""

import functools
import itertools

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R

torch.set_num_threads(1)

# (limb, hosts, seq, dcn_limb) at 8 devices, valid or not.
MESH_ARGS = [c for c in itertools.product((1, 2, 4, 8), repeat=4)
             if c[0] * c[1] * c[2] * c[3] <= 8]
PRIMES_NTT_BITS = [30, 30, 30]
N_NTT = 4096
N_COLL = 256
SKS_BITS = [40, 40, 40]


def _primes(bits, n):
    from eva_tpu.crypto.primes import build_chain
    return [q for e in build_chain(bits, n) for q in e.primes]


def _residues(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64)
                     for q in primes], axis=-2)


def _coll_inputs(world):
    primes = _primes([30, 30], N_COLL)
    return primes, _residues(world, primes, (world, N_COLL))


@functools.lru_cache(maxsize=None)
def _sks_inputs():
    """Context, keys (drawn once: keygen is not seeded) and inputs of the
    key-switch cases."""
    from eva_tpu.crypto import keys as K
    from eva_tpu.crypto.context import CKKSContext
    ctx = CKKSContext(SKS_BITS, [1], N_COLL)
    ks = K.generate_keys(ctx, alpha=2)
    polys = {level: _residues(3 + level, ctx.primes_at_level(level),
                              (N_COLL,)) for level in (0, 1)}
    return ctx, ks, polys


def _seq_ctx():
    from eva_tpu.crypto.context import CKKSContext
    return CKKSContext([30, 30], [1, 5], N_NTT)


@pytest.fixture(scope="module")
def worlds():
    """{world: [per-rank results]} of every case, run once."""
    ctx, ks, polys = _sks_inputs()
    from eva_tpu.ckks.params import CKKSParameters
    keys = R.keys_payload(CKKSParameters(ctx.prime_bits, ctx.rotations,
                                         ctx.n, ctx.key_terms), ks)
    primes = _primes(PRIMES_NTT_BITS, N_NTT)
    x_ntt = _residues(9, primes, (N_NTT,))
    seq_ctx = _seq_ctx()
    x_seq = _residues(11, seq_ctx.primes_at_level(0), (N_NTT,))
    pipe_primes = _primes([30, 30], N_COLL)
    pipe = {k: _residues(20 + i, pipe_primes, (8, N_COLL))
            for i, k in enumerate(("a0", "a1", "b0", "b1"))}
    cases = {}
    for world in (2, 4):
        coll_primes, x = _coll_inputs(world)
        cases[world] = [
            {"kind": "collectives", "x": x, "q": coll_primes,
             "hier": (2, world // 2)},
            {"kind": "sharded_ntt", "primes": primes, "n": N_NTT,
             "x": x_ntt},
            {"kind": "sks", "keys": keys, "level": 0, "poly": polys[0],
             "shape": (1, world)},
            {"kind": "sks", "keys": keys, "level": 1, "poly": polys[1],
             "shape": (1, world)},
        ] + [{"kind": "seq_perm", "ctx": (tuple(seq_ctx.prime_bits),
                                          tuple(seq_ctx.rotations),
                                          N_NTT, 1),
              "g": seq_ctx.galois_elt(s), "x": x_seq} for s in (1, 5)]
    cases[2].append({"kind": "sks", "keys": keys, "level": 0,
                     "poly": polys[0], "shape": (2, 1)})
    cases[8] = [{"kind": "mesh", "args": dict(
        n_devices=8, limb_axis=a[0], hosts=a[1], seq_axis=a[2],
        dcn_limb=a[3])} for a in MESH_ARGS]
    cases[8].append({"kind": "pipeline_step", "primes": pipe_primes,
                     "n": N_COLL, **pipe})
    out = {w: R.run_world(w, c) for w, c in cases.items()}
    return {w: [{"results": dict(enumerate(r["results"])),
                 "modules": r["modules"]} for r in res]
            for w, res in out.items()}


def _case(worlds, world, i):
    return [r["results"][i] for r in worlds[world]]


def test_ranks_import_neither_jax_nor_eva_tpu(worlds):
    for world, ranks in worlds.items():
        for r in ranks:
            assert r["modules"] == [], (world, r["modules"])


@pytest.mark.parametrize("args", MESH_ARGS,
                         ids=lambda a: "l{}h{}s{}d{}".format(*a))
def test_mesh_shapes_and_names_equal_jax(worlds, args):
    from eva_tpu.parallel import make_device_mesh
    limb, hosts, seq, dcn = args
    got = _case(worlds, 8, MESH_ARGS.index(args))
    try:
        mesh = make_device_mesh(8, limb_axis=limb, hosts=hosts,
                                seq_axis=seq, dcn_limb=dcn)
    except AssertionError:
        assert all(g[0] == "ValueError" for g in got), got
        return
    want = (tuple(mesh.devices.shape), tuple(mesh.axis_names))
    assert all(g == want for g in got), (got, want)


def test_check_ici_axes_accepts_and_refuses_as_jax():
    """On fake node ids laid out as tests/test_parallel.py:541 lays out
    its fake devices: axis 0 crosses nodes, axis 1 stays in one."""
    from eva_tpu.parallel.sharding import check_ici_axes as check_j
    from eva_tpu_torch.parallel.sharding import check_ici_axes as check_t

    class Dev:
        def __init__(self, proc):
            self.process_index = proc

    nodes = np.array([[0, 0], [1, 1]])
    grid = np.vectorize(Dev)(nodes)
    for names in (["host", "limb"], ["batch", "limb"], ["limb", "batch"],
                  ["seq", "batch"], ["hlimb", "limb"], ["batch", "seq"]):
        try:
            check_j(grid, names)
            refused = None
        except ValueError:
            refused = "spans multiple hosts"
        if refused:
            with pytest.raises(ValueError, match=refused):
                check_t(nodes, names)
        else:
            check_t(nodes, names)


def test_check_ici_axes_override(monkeypatch):
    from eva_tpu_torch.parallel.sharding import check_ici_axes
    nodes = np.array([[0, 0], [1, 1]])
    with pytest.raises(ValueError, match="EVA_TPU_ALLOW_DCN_LIMB"):
        check_ici_axes(nodes, ["limb", "batch"])
    monkeypatch.setenv("EVA_TPU_ALLOW_DCN_LIMB", "1")
    check_ici_axes(nodes, ["limb", "batch"])


def _jax_collectives(world, x, primes, hier):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from eva_tpu.parallel import ks_shard as J
    from eva_tpu.parallel.sharding import shard_map_compat

    q = jnp.asarray(np.array(primes, dtype=np.uint32).reshape(-1, 1))
    devs = np.array(jax.devices()[:world])
    flat = Mesh(devs, ("a",))
    xs = jnp.asarray(x.astype(np.uint32))   # [world, n_sub, N]

    def run(mesh, spec, body):
        f = jax.jit(shard_map_compat(lambda v: body(v[0])[None], mesh=mesh,
                                     in_specs=P(spec), out_specs=P(spec)))
        return np.asarray(f(xs)).astype(np.uint64)

    n_dcn, n_ici = hier
    hmesh = Mesh(devs.reshape(n_dcn, n_ici), ("d", "i"))
    return {
        "all_reduce": run(flat, "a", lambda v: J._modular_all_reduce(
            v, q, "a", world)),
        "reduce_scatter": run(flat, "a", lambda v: J.modular_reduce_scatter(
            v, q, "a", world)),
        "all_gather": run(flat, "a", lambda v: J.modular_all_gather(
            v, "a", world)),
        "hierarchical": run(hmesh, ("d", "i"),
                            lambda v: J.hierarchical_modular_all_reduce(
                                v, q, "i", n_ici, "d", n_dcn)),
    }


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_jax(worlds, world):
    primes, x = _coll_inputs(world)
    want = _jax_collectives(world, x, primes, (2, world // 2))
    got = _case(worlds, world, 0)
    for name, w in want.items():
        for rank in range(world):
            np.testing.assert_array_equal(
                got[rank][name].astype(np.uint64), w[rank], err_msg=name)
    # The modular sum itself, by numpy.
    total = x.astype(object).sum(axis=0) % np.array(primes,
                                                    dtype=object)[:, None]
    assert np.array_equal(got[0]["all_reduce"], total.astype(np.int64))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ntt_equals_jax_and_ntt(worlds, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from eva_tpu.parallel.ntt_shard import get_sharded_ntt
    from eva_tpu.parallel.sharding import shard_map_compat

    primes = _primes(PRIMES_NTT_BITS, N_NTT)
    x = _residues(9, primes, (N_NTT,))
    sntt = get_sharded_ntt(tuple(primes), N_NTT, "n", world)
    n1, n2 = sntt.n1, sntt.n2
    mesh = Mesh(np.array(jax.devices()[:world]), ("n",))
    fwd = jax.jit(shard_map_compat(
        sntt.ntt, mesh=mesh, in_specs=P(None, None, "n"),
        out_specs=P(None, "n", None)))
    xm = jnp.asarray(x.astype(np.uint32).reshape(len(primes), n1, n2))
    want = np.asarray(fwd(xm)).astype(np.int64)
    nr, nl = n1 // world, n2 // world
    for rank, got in enumerate(_case(worlds, world, 1)):
        np.testing.assert_array_equal(
            got["fwd"], want[:, rank * nr:(rank + 1) * nr])
        np.testing.assert_array_equal(
            got["back"], x.astype(np.int64).reshape(len(primes), n1, n2)
            [..., rank * nl:(rank + 1) * nl])
        assert got["gathered_equals_ntt"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("step", [1, 5])
def test_seq_perm_galois_equals_jax(worlds, world, step):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from eva_tpu.backend.executor_jax import dev_perm
    from eva_tpu.parallel.seq_exec import seq_perm_galois
    from eva_tpu.parallel.sharding import shard_map_compat

    ctx = _seq_ctx()
    x = _residues(11, ctx.primes_at_level(0), (N_NTT,))
    g = ctx.galois_elt(step)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    f = jax.jit(shard_map_compat(
        seq_perm_galois(ctx, g, "seq", world, dev_perm(ctx, g)), mesh=mesh,
        in_specs=P(None, "seq"), out_specs=P(None, "seq")))
    want = np.asarray(f(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(want, x[:, ctx.perm_for_elt(g)])
    nloc = N_NTT // world
    for rank, got in enumerate(_case(worlds, world, 4 + [1, 5].index(step))):
        np.testing.assert_array_equal(
            got, want[:, rank * nloc:(rank + 1) * nloc])


@pytest.mark.parametrize("shards,world,index",
                         [(1, 2, 6), (2, 2, 2), (4, 4, 2), (4, 4, 3)],
                         ids=["1shard", "2shards", "4shards_l0",
                              "4shards_l1"])
def test_sharded_key_switch_equals_jax_and_numpy(worlds, shards, world,
                                                 index):
    """cf. tests/test_parallel.py:126 and :152."""
    import jax
    from jax.sharding import Mesh
    from eva_tpu.crypto import ops as O
    from eva_tpu.parallel import ShardedKeySwitch

    ctx, ks, polys = _sks_inputs()
    level = 1 if index == 3 else 0
    poly = polys[level]
    want0, want1 = O._key_switch(ctx, poly, level, ks.relin)
    mesh = Mesh(np.array(jax.devices()[:shards]), ("digit",))
    j0, j1 = ShardedKeySwitch(ctx, ks.relin, level, mesh)(
        poly.astype(np.uint32))
    np.testing.assert_array_equal(want0, np.asarray(j0).astype(np.uint64))
    np.testing.assert_array_equal(want1, np.asarray(j1).astype(np.uint64))
    for d0, d1 in _case(worlds, world, index):
        np.testing.assert_array_equal(d0.astype(np.uint64), want0)
        np.testing.assert_array_equal(d1.astype(np.uint64), want1)


def test_batch_pipeline_step_equals_jax(worlds):
    """The step on each rank's batch shard of a batch mesh of 8: its c0-c2
    are the JAX step's rows of that shard, its batch sum the JAX step's
    sum over the whole batch."""
    import jax.numpy as jnp
    from eva_tpu.backend.tables import DeviceLevelOps as DevJ
    from eva_tpu.parallel import batch_pipeline_step as step_j

    primes = _primes([30, 30], N_COLL)
    args = [_residues(20 + i, primes, (8, N_COLL)) for i in range(4)]
    want = step_j(DevJ(primes, N_COLL))(
        *[jnp.asarray(a.astype(np.uint32)) for a in args])
    want = [np.asarray(w).astype(np.int64) for w in want]
    got = _case(worlds, 8, len(MESH_ARGS))
    for rank, (c0, c1, c2, total) in enumerate(got):
        for g, w in zip((c0, c1, c2), want[:3]):
            np.testing.assert_array_equal(g, w[rank:rank + 1])
        np.testing.assert_array_equal(total, want[3])


def test_mesh_needs_a_process_group_that_carries_it(monkeypatch, tmp_path):
    """No fallback: a CUDA mesh (the default) needs a CUDA device and the
    NCCL backend, a CPU mesh gloo; the world must be the mesh."""
    import torch.distributed as dist
    from eva_tpu_torch.parallel import make_device_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_device_mesh(device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="needs the nccl backend"):
            make_device_mesh()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_device_mesh()
        with pytest.raises(ValueError, match="the world has 1 ranks"):
            make_device_mesh(2, device_type="cpu")
        mesh = make_device_mesh(device_type="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == \
            ((1, 1), ("batch", "limb"))
    finally:
        dist.destroy_process_group()
