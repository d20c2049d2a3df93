#!/usr/bin/env python3
"""Multi-host scaling-efficiency rehearsal on the PyTorch/CUDA port: the
counterpart of tools/bench_scaling.py.

It times the representative homomorphic step of eva_tpu_torch.parallel
(sharding.batch_pipeline_step: ciphertext tensor product, an NTT
round-trip, the batch sum) over a ("host", "batch", "limb") mesh of
torch.distributed ranks, one process per device (make_device_mesh with
hosts=H), against the same step in one process, and reports the scaling
efficiency. Four steps, as bench_scaling.py's:

  par    the step without the batch reduce (no collective),
  red    the step with its batch reduce (the modular all-reduce of the
         batch sums over the batch axes),
  flat   the local sum, then the modular all-reduce over "batch", then
         over "host" (ks_shard._modular_all_reduce),
  hier   the local sum through ks_shard.hierarchical_modular_all_reduce
         ("batch" the intra-node axis, "host" the cross-node one).

    python3 tools/bench_scaling_torch.py --hosts 1            # the card
    python3 tools/bench_scaling_torch.py --cpu [--hosts 2] [--local-devices 1]
        [--n 4096] [--limbs 6] [--batch 16] [--reps 10]

On the card each rank is one NCCL process on its own card (cuda:rank),
so H x local devices ranks need as many cards; NCCL does not put two
ranks of one communicator on one card, and one card runs --hosts 1.
With --cpu the ranks are gloo processes on the host, one thread each, as
tests/torch_mesh_ranks.py starts them: the rehearsal of the multi-host
path. Every process (the one-process baseline and each rank) is pinned
to its own core with taskset where there is one, as bench_scaling.py
pins them. Times: best of three runs of `reps` chained steps, by CUDA
events on the card and by the wall clock on the CPU; the two are never
mixed in one number (`clock`).

The tool checks its result: rank 0's reduced outputs (red, flat, hier)
must equal the one-process step over the whole global batch, and its
local products that step's slice of them, bit for bit; it exits 1 after
the line otherwise.

Prints ONE JSON line from the parent with bench_scaling.py's keys
("metric", "hosts", "devices", "local_devices", "backend", "t1_ct_per_s",
"tH_ct_per_s", "efficiency", ...), plus "clock", the card
(`nvidia-smi --query-gpu=name,power.limit`), "identity" and rank 0's
launches by kernel. Without a card it exits 2, unless given --cpu.
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

def setup(opts, device):
    """(dev, primes): the level ops of bench_scaling.py's chain, `limbs`
    50-bit entries at ring n."""
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.primes import build_chain
    chain = build_chain([50] * opts.limbs, opts.n)
    primes = [q for e in chain for q in e.primes]
    return level_ops(primes, opts.n, device), primes


def local_inputs(primes, n: int, batch: int, rank: int, device):
    """Rank `rank`'s four [batch, primes, n] operands (a0, a1, b0, b1),
    host_planes of seeds 100 * rank + s."""
    from bench_torch import _planes
    return [_planes(primes, n, batch, 100 * rank + s, device)
            for s in range(4)]


def measure(step, args, reps: int, device) -> float:
    """Seconds per step: the best of three runs of `reps` chained calls,
    by CUDA events on a card and the wall clock on the CPU."""
    import torch
    step(*args)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(3):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                step(*args)
            end.record()
            torch.cuda.synchronize(device)
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                step(*args)
            t = time.perf_counter() - t0
        best = min(best, t)
    return best / reps


def _device(opts, rank: int = 0):
    import torch
    if opts.cpu:
        return torch.device("cpu")
    torch.cuda.set_device(rank)
    return torch.device("cuda", rank)


def baseline(opts) -> dict:
    """The one-process step over batch / devices ciphertexts: throughput
    (ct/s) of par, red and the batch sum alone."""
    import torch
    from eva_tpu_torch.parallel import batch_pipeline_step
    torch.set_num_threads(1)
    device = _device(opts)
    dev, primes = setup(opts, device)
    b = opts.batch // (opts.hosts * opts.local_devices)
    args = local_inputs(primes, opts.n, b, 0, device)
    step = batch_pipeline_step(dev)
    per = {"par": measure(lambda *a: step(*a)[:3], args, opts.reps, device),
           "red": measure(step, args, opts.reps, device),
           "sum": measure(lambda *a: step(*a)[3], args, opts.reps, device)}
    return {k: b / v for k, v in per.items()}


def child(opts) -> dict:
    """One rank: the four steps over the mesh, then (rank 0) the identity
    check against the one-process step over the global batch."""
    import torch
    import torch.distributed as dist
    import bench_torch
    from eva_tpu_torch.parallel import batch_pipeline_step, make_device_mesh
    from eva_tpu_torch.parallel.ks_shard import (
        _modular_all_reduce, hierarchical_modular_all_reduce)
    from eva_tpu_torch.parallel.sharding import axis_group

    torch.set_num_threads(1)
    n_dev = opts.hosts * opts.local_devices
    device = _device(opts, opts.proc)
    dist.init_process_group("gloo" if opts.cpu else "nccl",
                            init_method=f"tcp://localhost:{opts.port}",
                            rank=opts.proc, world_size=n_dev)
    try:
        mesh = make_device_mesh(n_dev, limb_axis=1, hosts=opts.hosts,
                                device_type=device.type)
        dev, primes = setup(opts, device)
        local_b = opts.batch // n_dev
        args = local_inputs(primes, opts.n, local_b, opts.proc, device)
        batch_g = axis_group(mesh, "batch")
        host_g = axis_group(mesh, "host")
        local = batch_pipeline_step(dev)
        reduce = batch_pipeline_step(dev, mesh)

        def flat(*a):
            part = _modular_all_reduce(local(*a)[3], dev, batch_g)
            return part if host_g is None else _modular_all_reduce(
                part, dev, host_g)

        def hier(*a):
            part = local(*a)[3]
            if host_g is None:
                return _modular_all_reduce(part, dev, batch_g)
            return hierarchical_modular_all_reduce(part, dev, batch_g,
                                                   host_g)

        steps = {"par": lambda *a: local(*a)[:3], "red": reduce,
                 "flat": flat, "hier": hier}
        bench_torch.reset_counts()
        per = {k: measure(f, args, opts.reps, device)
               for k, f in steps.items()}
        launches = bench_torch.path_launches()
        got = {"red": reduce(*args), "flat": flat(*args),
               "hier": hier(*args)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out = {"ct_per_s": {k: opts.batch / v for k, v in per.items()},
           "launches": launches}
    if opts.proc == 0:
        full = [torch.cat(parts) for parts in zip(*(
            local_inputs(primes, opts.n, local_b, r, device)
            for r in range(n_dev)))]
        want = batch_pipeline_step(dev)(*full)
        out["identity"] = {
            "local": all(torch.equal(g, w[:local_b])
                         for g, w in zip(got["red"][:3], want[:3])),
            **{k: torch.equal(got[k][3] if k == "red" else got[k], want[3])
               for k in ("red", "flat", "hier")}}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "eva_tpu"))
    return out


def _card_line() -> str:
    from bench_torch import card_line
    return card_line()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cmds, timeout: float = 1200):
    """Run the commands together; returns their stdouts, or raises with
    the failures' output."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode]
    if bad:
        raise SystemExit("bench_scaling_torch: processes failed "
                         + "\n".join(f"{i}: {outs[i][1][-3000:]}"
                                     if i < len(outs) else str(i)
                                     for i in bad))
    return [o for o, _ in outs]


def _result(stdout: str, tag: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise SystemExit(f"bench_scaling_torch: no {tag} line in:\n{stdout}")


def run(opts) -> dict:
    """The baseline process, then the H x L ranks; returns the line."""
    n_dev = opts.hosts * opts.local_devices
    ncores = os.cpu_count() or 1
    pin = shutil.which("taskset") is not None
    if n_dev > ncores:
        print(f"bench_scaling_torch: warning: {n_dev} ranks on {ncores} "
              "cores; ranks share compute, efficiency will undercount",
              file=sys.stderr)

    def pinned(cmd, core):
        return (["taskset", "-c", str(core % ncores)] + cmd) if pin else cmd

    me = [sys.executable, os.path.abspath(__file__)]
    flags = [f"--hosts={opts.hosts}", f"--local-devices={opts.local_devices}",
             f"--n={opts.n}", f"--limbs={opts.limbs}",
             f"--batch={opts.batch}", f"--reps={opts.reps}"]
    flags += ["--cpu"] if opts.cpu else []
    base = _result(_run([pinned(me + flags + ["--baseline"], 0)])[0],
                   "BASE_RESULT")
    port = opts.port or free_port()
    outs = _run([pinned(me + flags + [f"--port={port}", f"--proc={r}"], r)
                 for r in range(n_dev)])
    ranks = [_result(o, "CHILD_RESULT") for o in outs]
    head = ranks[0]
    t1, tH = base, head["ct_per_s"]
    return {
        "metric": "scaling_efficiency",
        "hosts": opts.hosts,
        "devices": n_dev,
        "local_devices": opts.local_devices,
        "backend": ("cpu-rehearsal (multi-process torch.distributed, gloo)"
                    if opts.cpu else
                    "cuda (multi-process torch.distributed, nccl)"),
        "clock": "wall" if opts.cpu else "cuda events",
        "card": None if opts.cpu else _card_line(),
        "n": opts.n, "limbs": opts.limbs, "batch": opts.batch,
        "reps": opts.reps, "pinned": pin,
        "t1_ct_per_s": round(t1["par"], 2),
        "tH_ct_per_s": round(tH["par"], 2),
        "efficiency": round(tH["par"] / (n_dev * t1["par"]), 3),
        "t1_reduce_ct_per_s": round(t1["red"], 2),
        "tH_reduce_ct_per_s": round(tH["red"], 2),
        "efficiency_with_reduce": round(tH["red"] / (n_dev * t1["red"]), 3),
        "t1_sum_ct_per_s": round(t1["sum"], 2),
        "tH_flat_modreduce_ct_per_s": round(tH["flat"], 2),
        "efficiency_with_flat_modreduce": round(
            tH["flat"] / (n_dev * t1["sum"]), 3),
        "tH_hier_modreduce_ct_per_s": round(tH["hier"], 2),
        "efficiency_with_hierarchical_reduce": round(
            tH["hier"] / (n_dev * t1["sum"]), 3),
        "hier_vs_flat": round(tH["hier"] / tH["flat"], 3),
        "identity": head["identity"],
        "launches": head["launches"],
        "modules": sorted({m for r in ranks for m in r["modules"]}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the host instead of NCCL ranks on "
                         "the cards")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--port", type=int, default=0,
                    help="rendezvous port (default: a free one)")
    ap.add_argument("--proc", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--baseline", action="store_true",
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.baseline:
        print("BASE_RESULT " + json.dumps(baseline(opts)), flush=True)
        return 0
    if opts.proc is not None:
        print("CHILD_RESULT " + json.dumps(child(opts)), flush=True)
        return 0
    n_dev = opts.hosts * opts.local_devices
    if opts.batch % n_dev:
        print(f"bench_scaling_torch: batch {opts.batch} does not split over "
              f"{n_dev} ranks", file=sys.stderr)
        return 2
    if not opts.cpu:
        import torch
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            print("bench_scaling_torch: torch.cuda.is_available() is false; "
                  "pass --cpu for the gloo rehearsal on the host",
                  file=sys.stderr)
            return 2
        if n_dev > cards:
            print(f"bench_scaling_torch: {n_dev} NCCL ranks need {n_dev} "
                  f"cards (one rank a card), this machine has {cards}; run "
                  f"--hosts {cards} --local-devices 1, or pass --cpu for "
                  "the gloo rehearsal on the host", file=sys.stderr)
            return 2
    line = run(opts)
    print(json.dumps(line), flush=True)
    if not all(line["identity"].values()) or line["modules"]:
        print(f"bench_scaling_torch: FAILED: identity {line['identity']}, "
              f"modules {line['modules']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
