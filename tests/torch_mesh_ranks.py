"""Rank harness of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_mesh.py,
tests/test_torch_mesh_plans.py).

`run_world(world, cases)` starts `world` processes, forked from a
forkserver that has torch and eva_tpu_torch imported, each one
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

import contextlib
import os
import pickle
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _sobel(x, w=8):
    """Sobel's two 3x3 stencils over a w-wide image, squared and summed:
    hoisted rotations, rotation sums times the filter's constants, a
    relinearization and a rescale."""
    filt = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    ix = iy = None
    for i in range(3):
        for j in range(3):
            rot = x << (i * w + j)
            h, v = rot * filt[i][j], rot * filt[j][i]
            ix, iy = (h, v) if ix is None else (ix + h, iy + v)
    return ix * ix + iy * iy


# name: (program of x and, with two inputs, a plaintext w; vec_size,
# input scale, plain input w)
PROGRAMS = {
    # Sobel 8x8 (N = 8192, prime bits [60, 20, 60, 60]).
    "sobel": (_sobel, 64, 30, False),
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


def ciphertexts(result):
    """Port valuation -> {name: ([uint64 planes], level, scale)}."""
    return {k: ([np.asarray(p) for p in v.polys], v.level, v.scale)
            for k, v in result.items()}


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


def _served(case):
    """(compiled program, EVAPublic on the CPU) of case["program"] with
    the carried keys case["keys"] (sent with a program's first case),
    made once per rank."""
    from eva_tpu_torch.runtime import EVAPublic
    name = case["program"]
    if name not in _PROGRAM_CACHE:
        compiled, params, _ = compile_port(name)
        ctx, keys = port_keys(case["keys"])
        pub = EVAPublic(ctx, keys, params, backend="torch", device="cpu")
        _PROGRAM_CACHE[name] = (compiled, pub)
    return _PROGRAM_CACHE[name]


def case_execute(case):
    """EVAPublic.execute_batch of program case["program"] on the CPU
    mesh make_device_mesh(**case["mesh"]) over the carried valuations
    case["values"], once for each list of indices in case["batches"].
    Returns {"outputs": the output planes of every element of each
    batch, or the error; "plans": the mesh plans that ran (see
    TorchProgram._sharded)}."""
    from eva_tpu_torch.parallel import make_device_mesh
    compiled, pub = _served(case)
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


@contextlib.contextmanager
def _forcing(plan):
    """TorchProgram._force_plan set to `plan` inside the block; None
    leaves the switch as it is."""
    from eva_tpu_torch.backend.executor_torch import TorchProgram
    if plan is None:
        yield
        return
    TorchProgram._force_plan = plan
    try:
        yield
    finally:
        TorchProgram._force_plan = None


def case_forced(case):
    """execute_batch of program case["program"] over the carried
    valuations case["values"] on a one-rank CPU mesh, with
    TorchProgram._force_plan at each of case["plans"] (None: as it is).
    Returns {plan: {"outputs": ciphertexts() of each element, or the
    error; "ran": the plan name _sharded chose}}."""
    from eva_tpu_torch.parallel import make_device_mesh
    compiled, pub = _served(case)
    vals = [port_values(v) for v in case["values"]]
    mesh = make_device_mesh(device_type="cpu")
    tp = pub._executor_for(compiled)._get_torch_program()
    out = {}
    for plan in case["plans"]:
        with _forcing(plan):
            try:
                res = [ciphertexts(r)
                       for r in pub.execute_batch(compiled, vals, mesh=mesh)]
            except ValueError as exc:
                res = ("ValueError", str(exc))
        out[plan] = {"outputs": res,
                     "ran": [v[1] for k, v in tp._sharded_cache.items()
                             if v[0] is mesh and k[1] == plan]}
    return out


def case_capture_keys(case):
    """The mesh programs' capture cache on the CPU: with
    TorchProgram._captures on and _capture_graph replaced by an eager
    stand-in (no CUDA), program case["program"] runs each step (mesh
    0 or 1 of two one-rank meshes, forced plan or None, batch size) of
    case["steps"], then releases mesh 0 (EVAPublic.release_mesh).
    Returns {"captured": the steps that captured, in order; "equal":
    every output equal to the batch without a mesh; "keys": the number
    of entries in _captured before and after the release; "plans": the
    number of checked plans of each mesh after it}."""
    from eva_tpu_torch.backend.executor_torch import TorchProgram
    from eva_tpu_torch.parallel import make_device_mesh
    compiled, pub = _served(case)
    vals = [port_values(v) for v in case["values"]]
    tp = pub._executor_for(compiled)._get_torch_program()
    want = [planes(r) for r in pub.execute_batch(compiled, vals)]
    captured, now = [], []

    class StandIn:
        """What _capture_graph returns, run eagerly: fill stages the
        inputs as _dev_inputs cuts them, replay runs the body."""

        def __init__(self, cipher, plain, consts, sharded):
            self.mesh = None if sharded is None else sharded[0]
            self.body = tp._traced if sharded is None else sharded[2]
            self.seq = None if sharded is None else sharded[3]
            self.consts = consts
            self.fill(cipher, plain)

        def fill(self, cipher, plain):
            self.inputs = tp._dev_inputs(cipher, plain, self.consts,
                                         self.seq)

        def replay(self):
            self.out = self.body(*self.inputs)

    def capture(self, cipher, plain, consts, sharded=None):
        captured.append(now[-1])
        return StandIn(cipher, plain, consts, sharded)

    saved = TorchProgram._captures, TorchProgram._capture_graph
    TorchProgram._captures = lambda self: True
    TorchProgram._capture_graph = capture
    equal = True
    try:
        meshes = [make_device_mesh(device_type="cpu") for _ in range(2)]
        for step in case["steps"]:
            m, plan, batch = step
            now.append(step)
            with _forcing(plan):
                got = pub.execute_batch(compiled, vals[:batch],
                                        mesh=meshes[m])
            equal &= all(np.array_equal(a, b)
                         for w, g in zip(want, got)
                         for k in w for a, b in zip(w[k], planes(g)[k]))
        keys = [len(tp._captured)]
        pub.release_mesh(meshes[0])
        keys.append(len(tp._captured))
    finally:
        TorchProgram._captures, TorchProgram._capture_graph = saved
    return {"captured": captured, "equal": bool(equal), "keys": keys,
            "plans": [sum(v[0] is m for v in tp._sharded_cache.values())
                      for m in meshes]}


# Tensor methods that read a value on the host, and the calls that make
# a tensor of host data (tests/test_torch_capture.py).
HOST_READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
              "__float__", "__index__")
UPLOADS = ("from_numpy", "tensor", "as_tensor")


def case_host_reads(case):
    """What a capture of each forced plan's program relies on: once warm,
    a run of the plan's body (_sharded's run on _dev_inputs) makes no
    tensor of host data (every table, constant, key layout, transform
    and permutation already made) and reads no tensor on the host.
    Returns {plan: None, or the error the refused call raised}."""
    import torch

    from eva_tpu_torch.parallel import make_device_mesh
    compiled, pub = _served(case)
    vals = [port_values(v) for v in case["values"]]
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    mesh = make_device_mesh(device_type="cpu")
    cipher, plain, consts = tp._split(
        [ex._host_phase(v)[0] for v in vals], True)

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} during a warm run")
        return call

    patches = ([(torch.Tensor, n) for n in HOST_READS]
               + [(torch, n) for n in UPLOADS])
    out = {}
    for plan in case["plans"]:
        with _forcing(plan):
            _, _, run, group = tp._sharded(mesh, cipher, plain, consts)
        inputs = tp._dev_inputs(cipher, plain, consts, group)
        run(*inputs)
        saved = [(obj, n, getattr(obj, n)) for obj, n in patches]
        try:
            for obj, n in patches:
                setattr(obj, n, refuse(n))
            run(*inputs)
            out[plan] = None
        except AssertionError as exc:
            out[plan] = str(exc)
        finally:
            for obj, n, f in saved:
                setattr(obj, n, f)
    return out


CASES = {"mesh": case_mesh, "collectives": case_collectives,
         "sharded_ntt": case_sharded_ntt, "seq_perm": case_seq_perm,
         "sks": case_sks, "pipeline_step": case_pipeline_step,
         "execute": case_execute, "forced": case_forced,
         "capture_keys": case_capture_keys, "host_reads": case_host_reads}


# Modules every rank imports, loaded once by the forkserver the ranks are
# forked from (multiprocessing's "forkserver" context, started once per
# test process): a rank then costs a fork, not a fresh interpreter's
# ~4 s of CPU importing torch. The forkserver is a fresh interpreter, so a
# rank's modules are still only what it imports itself, and it runs one
# thread after these imports, so forking it is safe.
PRELOAD = ["numpy", "torch", "torch.distributed", "eva_tpu_torch.parallel",
           "eva_tpu_torch.runtime"]


def _forkserver():
    """The forkserver context, its server started with one intra-op
    thread (OMP_NUM_THREADS=1, for the ranks) and PRELOAD imported."""
    import multiprocessing
    from multiprocessing import forkserver
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        forkserver.ensure_running()
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    return ctx


def run_world(world: int, cases, timeout: float = 180.0):
    """Run `cases` on `world` gloo ranks; returns [rank results], each a
    {"results": [per case], "modules": imported jax/eva_tpu modules}."""
    ctx = _forkserver()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cases.pkl"), "wb") as fh:
            pickle.dump(cases, fh)
        procs = [ctx.Process(target=_rank_entry, args=(tmp, r, world))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            logs = []
            for r in range(world):
                with open(os.path.join(tmp, f"log{r}.txt")) as fh:
                    logs.append(fh.read())
            raise RuntimeError(f"ranks failed {bad}:\n"
                               + "\n".join(logs)[-6000:])
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _rank_entry(tmp: str, rank: int, world: int) -> None:
    """A forked rank: its output to tmp/log<rank>.txt, then _rank_main."""
    with open(os.path.join(tmp, f"log{rank}.txt"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    _rank_main(tmp, rank, world)


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
