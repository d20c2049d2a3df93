"""Rank harness of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_mesh.py).

`run_world(world, cases)` starts `world` processes of this file, each one
gloo rank of a torch.distributed world on one CPU thread, rendezvousing
through a file store in a temporary directory. Every rank runs every case
(in order, each a dict with a "kind" naming a function of CASES) and
writes its results back; run_world returns them by rank. The parent makes
the inputs with numpy (keys and ciphertexts from eva_tpu, as plain
arrays), so the ranks import torch, numpy and eva_tpu_torch only: no JAX,
no eva_tpu (each rank reports what it imported).

Programs are named, not pickled: each rank compiles the same EVA program
with the port's compiler (PROGRAMS; `build(pkg, name)` builds it with
either package). keys_payload / values_payload and port_keys /
port_values carry eva_tpu's keys and valuations into the port in two
steps, plain arrays between them (test_torch_executor.carry_keys and
carry_values are the two steps in one process)."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (program of x and, with two inputs, a plaintext w; vec_size,
# input scale, plain input w)
PROGRAMS = {
    # tests/test_parallel.py's dp / seq / hlimb program: relinearization
    # and a hoisted rotation source.
    "dp": (lambda x: 3 * x ** 2 + (x << 1) + (x << 3) - 2, 16, 30, False),
    # test_torch_executor.PROGRAMS["batch"]: hoisted rotations, a lone
    # rotation of a sum, a plaintext input per valuation, relins.
    "batch": (lambda x, w: (((x << 1) + (x << 2)) << 3) * w + x * x, 16,
              30, True),
    # TestRotMulFusionOnMesh: baby-step rotation-mul fusion.
    "babystep": (lambda x: ((x << 1) * 2.0 + (x << 2) * (-0.5)
                            + (x << 3) * 1.25), 16, 30, False),
    # test_multi_level_key_switches_limb_x_seq: key switches at two
    # levels.
    "deep": (lambda x: (lambda y: y * y + (y << 2))(x * x + (x << 1)), 16,
             40, False),
    # test_seq_mesh_error_paths: no key switch at all.
    "plain_only": (lambda x: x * 0.5 + 1, 8, 30, False),
}


def build(pkg, name):
    """Program `name` of PROGRAMS built with package `pkg` (eva_tpu or
    eva_tpu_torch)."""
    f, vec, scale, plain_w = PROGRAMS[name]
    prog = pkg.EvaProgram(name, vec_size=vec)
    with prog:
        x = pkg.Input("x")
        pkg.Output("y", f(x, pkg.Input("w", False)) if plain_w else f(x))
    prog.set_output_ranges(20)
    prog.set_input_scales(scale)
    return prog


def compile_port(name):
    import eva_tpu_torch
    from eva_tpu_torch.ckks import CKKSCompiler
    return CKKSCompiler({"warn_vec_size": "false"}).compile(
        build(eva_tpu_torch, name))


# -- payload conversion: plain arrays in, port objects out -------------------

def keys_payload(params, ks):
    """eva_tpu key set -> plain arrays and scalars, with the context's
    parameters (prime_bits, rotations, poly_modulus_degree, key_terms
    attributes of `params`)."""
    def kd(k):
        return dict(k0=[np.asarray(a) for a in k.k0],
                    k1=[np.asarray(a) for a in k.k1], alpha=k.alpha,
                    k1_seeds=k.k1_seeds, xof=k.xof)
    return dict(ctx=(tuple(params.prime_bits), tuple(params.rotations),
                     params.poly_modulus_degree, params.key_terms),
                secret_coeffs=np.asarray(ks.secret.coeffs),
                secret_s=np.asarray(ks.secret.s),
                public_b=np.asarray(ks.public.b),
                public_a=np.asarray(ks.public.a),
                public_seed=ks.public.a_seed, public_xof=ks.public.xof,
                relin=None if ks.relin is None else kd(ks.relin),
                galois={g: kd(k) for g, k in ks.galois.items()})


def values_payload(values):
    """eva_tpu valuation -> {name: ("ct", polys, level, scale, seed,
    seed_xof), ("pt", poly, level, scale, ext) or ("raw", values)}."""
    out = {}
    for name, v in values.items():
        if hasattr(v, "polys"):
            out[name] = ("ct", [np.asarray(p) for p in v.polys], v.level,
                         v.scale, v.seed, v.seed_xof)
        elif hasattr(v, "poly"):
            out[name] = ("pt", np.asarray(v.poly), v.level, v.scale,
                         None if v.ext is None else np.asarray(v.ext))
        else:
            out[name] = ("raw", np.asarray(v))
    return out


def port_keys(kp):
    """keys_payload -> (the port's context, the port's KeySet)."""
    from eva_tpu_torch import convert
    from eva_tpu_torch.crypto.context import get_context
    ctx = get_context(*kp["ctx"])
    keys = convert.keyset_from_numpy(
        ctx, kp["secret_coeffs"], kp["public_b"], kp["public_a"],
        relin=kp["relin"], galois=kp["galois"], secret_s=kp["secret_s"],
        public_seed=kp["public_seed"], public_xof=kp["public_xof"])
    return ctx, keys


def port_values(vp):
    """values_payload -> the port's valuation."""
    from eva_tpu_torch import convert
    out = {}
    for name, v in vp.items():
        if v[0] == "ct":
            out[name] = convert.ciphertext_from_numpy(*v[1:])
        elif v[0] == "pt":
            out[name] = convert.plaintext_from_numpy(*v[1:])
        else:
            out[name] = v[1]
    return out


def planes(result):
    """Port valuation -> {name: [uint64 planes]}."""
    return {k: [np.asarray(p) for p in v.polys] for k, v in result.items()}


# -- cases (run on every rank) -----------------------------------------------

def case_mesh(case):
    """{"kind": "mesh", "args": {...}} -> (shape, names) of
    make_device_mesh(**args) on the CPU, or the error it raised."""
    from eva_tpu_torch.parallel import make_device_mesh
    try:
        mesh = make_device_mesh(device_type="cpu", **case["args"])
    except ValueError as exc:
        return ("ValueError", str(exc))
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def case_collectives(case):
    """The four collectives of parallel/ks_shard on this rank's plane
    x[rank] (uint32 residues [n_sub, N], as int32 bits) with the level ops
    of the primes q: over one axis of all ranks, and hierarchically over
    (dcn, ici) = case["hier"]."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.parallel import ks_shard
    world, rank = dist.get_world_size(), dist.get_rank()
    x = upload(case["x"][rank], "cpu")
    q = level_ops(list(case["q"]), x.shape[-1], "cpu")
    flat = init_device_mesh("cpu", (world,), mesh_dim_names=("a",))
    g = flat.get_group("a")
    n_dcn, n_ici = case["hier"]
    hier = init_device_mesh("cpu", (n_dcn, n_ici),
                            mesh_dim_names=("d", "i"))
    return {
        "all_reduce": ks_shard._modular_all_reduce(x, q, g).numpy(),
        "reduce_scatter": ks_shard.modular_reduce_scatter(x, q, g).numpy(),
        "all_gather": ks_shard.modular_all_gather(x, g).numpy(),
        "hierarchical": ks_shard.hierarchical_modular_all_reduce(
            x, q, hier.get_group("i"), hier.get_group("d")).numpy(),
    }


def case_sharded_ntt(case):
    """ShardedNTT over all ranks: this rank's lane slice of the
    coefficient planes x [n_sub, N] -> its row-sharded NTT planes, and
    back; plus the gathered forward output against the port's
    DeviceLevelOps.ntt of the whole planes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.backend.tables import DeviceLevelOps
    from eva_tpu_torch.parallel import get_sharded_ntt
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("n",))
    primes, n = case["primes"], case["n"]
    sntt = get_sharded_ntt(tuple(primes), n, mesh.get_group("n"))
    x = upload(case["x"], "cpu")
    n1, n2 = sntt.n1, sntt.n2
    nl = n2 // world
    xl = x.reshape(len(primes), n1, n2)[..., rank * nl:(rank + 1) * nl]
    fwd = sntt.ntt(xl.contiguous())
    back = sntt.intt(fwd)
    parts = [torch.empty_like(fwd) for _ in range(world)]
    dist.all_gather(parts, fwd.contiguous())
    whole = torch.cat(parts, dim=-2).reshape(len(primes), n)
    want = DeviceLevelOps(primes, n, "cpu").ntt(x)
    return {"fwd": fwd.numpy(), "back": back.numpy(),
            "gathered_equals_ntt": bool(torch.equal(whole, want))}


def case_seq_perm(case):
    """seq_perm_galois of Galois element g on this rank's slice of x."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.crypto.context import get_context
    from eva_tpu_torch.parallel.seq_exec import seq_perm_galois, seq_slice
    world = dist.get_world_size()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("seq",))
    g = mesh.get_group("seq")
    ctx = get_context(*case["ctx"])
    x = seq_slice(upload(case["x"], "cpu"), g)
    return seq_perm_galois(ctx, case["g"], g, None)(x).numpy()


def case_sks(case):
    """ShardedKeySwitch over the "digit" axis of a mesh of all ranks of
    shape case["shape"] (("rep", "digit") axes)."""
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.parallel import ShardedKeySwitch
    mesh = init_device_mesh("cpu", case["shape"],
                            mesh_dim_names=("rep", "digit"))
    ctx, keys = port_keys(case["keys"])
    sks = ShardedKeySwitch(ctx, keys.relin, case["level"], mesh)
    d0, d1 = sks(case["poly"])
    return d0.numpy(), d1.numpy()


def case_pipeline_step(case):
    """batch_pipeline_step over a batch mesh of all ranks on this rank's
    shard of the batched planes a0, a1, b0, b1 [B, n_sub, N] (uint64
    residues; shard_batch uploads them as int32 bits)."""
    import torch.distributed as dist
    from eva_tpu_torch.backend.tables import DeviceLevelOps
    from eva_tpu_torch.parallel import (batch_pipeline_step,
                                        make_device_mesh, shard_batch)
    mesh = make_device_mesh(dist.get_world_size(), device_type="cpu")
    dev = DeviceLevelOps(case["primes"], case["n"], "cpu")
    args = [shard_batch(case[k], mesh) for k in ("a0", "a1", "b0", "b1")]
    return [t.numpy() for t in batch_pipeline_step(dev, mesh)(*args)]


_PROGRAM_CACHE: dict = {}


def case_execute(case):
    """EVAPublic.execute_batch of program case["program"] on the CPU
    mesh make_device_mesh(**case["mesh"]) over the carried valuations
    case["values"], once for each list of indices in case["batches"].
    Returns {"outputs": the output planes of every element of each
    batch, or the error; "plans": the mesh plans that ran (see
    TorchProgram._sharded)}."""
    from eva_tpu_torch.parallel import make_device_mesh
    from eva_tpu_torch.runtime import EVAPublic
    name = case["program"]
    if name not in _PROGRAM_CACHE:
        compiled, params, _ = compile_port(name)
        ctx, keys = port_keys(case["keys"])
        pub = EVAPublic(ctx, keys, params, backend="torch", device="cpu")
        _PROGRAM_CACHE[name] = (compiled, pub)
    compiled, pub = _PROGRAM_CACHE[name]
    vals = [port_values(v) for v in case["values"]]
    mesh = make_device_mesh(device_type="cpu", **case["mesh"])
    out = []
    for idx in case["batches"]:
        try:
            res = pub.execute_batch(compiled, [vals[i] for i in idx],
                                    mesh=mesh)
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
            continue
        out.append([planes(r) for r in res])
    tp = pub._executor_for(compiled)._get_torch_program()
    plans = sorted({v[1] for v in tp._sharded_cache.values()
                    if v[0] is mesh})
    return {"outputs": out, "plans": plans}


CASES = {"mesh": case_mesh, "collectives": case_collectives,
         "sharded_ntt": case_sharded_ntt, "seq_perm": case_seq_perm,
         "sks": case_sks, "pipeline_step": case_pipeline_step,
         "execute": case_execute}


def run_world(world: int, cases, timeout: float = 180.0):
    """Run `cases` on `world` gloo ranks; returns [rank results], each a
    {"results": [per case], "modules": imported jax/eva_tpu modules}."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cases.pkl"), "wb") as fh:
            pickle.dump(cases, fh)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), tmp, str(r),
             str(world)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode]
        if bad:
            raise RuntimeError(f"ranks failed {bad}:\n"
                               + "\n".join(logs)[-6000:])
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _rank_main(tmp: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "cases.pkl"), "rb") as fh:
            cases = pickle.load(fh)
        results = [CASES[c["kind"]](c) for c in cases]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    modules = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eva_tpu"))
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump({"results": results, "modules": modules}, fh)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
