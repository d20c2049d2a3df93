#!/usr/bin/env python3
"""Time the port's CUDA kernels and its Sobel / Harris executes on one GPU,
for one source tree, so that two trees can be compared in one call.

    python3 tools/cuda_ab.py [--root DIR] [--label NAME] [--sweep] [--paths]
                             [--reps N] [--out DIR]

`--root` is the checkout whose `eva_tpu_torch` is imported and built (its
kernels build into DIR/build/eva_tpu_torch); the default is this file's
checkout. The helpers (timing, bounds, programs, profile) come from this
checkout's chip_smoke.py. To compare a parent commit with this one on one
card, unpack the parent into a gitignored directory and run the trees in
turns in one command:

    git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/cuda_ab.py --root $t --label $t --paths; done

The kernel inputs are this checkout's (chip_smoke.ntt_inputs,
ks_kernel_phase): int32 residue planes, which the kernels of a tree from
before the port's 32-bit storage (int64 planes) refuse.

Prints the card line, then one `ab LABEL {json}` line, also written to
OUT/ab_<label>_<n>.json with --out:
  ntt: K1/K2 graph-replay ms at chip_smoke.NTT_SHAPES (N = 16384 only),
       and eager ms per call (host launch cost included), with the bound
       and, where the tree has a cluster chooser, the cluster size
       picked; --sweep adds every forced cluster size, each output
       torch.equal to the plain version first;
  ks:  K4/K5 graph-replay ms at Sobel's level 0, B = 1 and 4 (with x_ntt /
       out_ntt): chip_smoke.ks_kernel_phase, which first holds both to
       their plain versions at every KS_SHAPES shape;
  paths (--paths): Sobel and Harris 90x90 and Sobel 128x128 (two
       shards) wall ms of N warm executes,
       profiled device busy ms, NTT ms and key-switch ms of one execute,
       the device op count, and for a tree that captures the device ms
       of one graph replay (chip_smoke.replay_ms, N times), as the tree
       executes by default
       ("captured": true where it replays a captured CUDA graph); for a
       tree that captures, the same again with its private switch
       TorchProgram._capture off under "eager", so that a capturing and
       an eager tree compare like with like.
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ntt_times(smoke, device, sweep: bool):
    import torch
    from eva_tpu_torch.backend import ntt_cuda

    chooser = hasattr(ntt_cuda, "kernel_info")
    out = {}
    for label, n, lead, n_sub in smoke.NTT_SHAPES:
        if n != 16384:
            continue
        ops, x = smoke.ntt_inputs(device, n, lead, n_sub)
        f_p = ops._fwd_merged(x)
        rows = x.numel() // n
        bms, bby = smoke.ntt_bound_ms(rows, n, n_sub)
        res = {"shape": list(x.shape), "bound_ms": bms, "bound_by": bby}
        sizes = [0] + (smoke.forced_clusters(n, device)
                       if sweep and chooser else [])
        for c in sizes:
            kw = {"_cluster": c} if c else {}
            if c:
                ok = (torch.equal(ntt_cuda.ntt_fwd(x, ops, **kw), f_p)
                      and torch.equal(ntt_cuda.ntt_inv(f_p, ops, **kw), x))
                if not ok:
                    raise AssertionError(f"NTT disagrees: {label} C={c}")
            key = f"C{c}" if c else "chosen"
            fwd = lambda: ntt_cuda.ntt_fwd(x, ops, **kw)
            inv = lambda: ntt_cuda.ntt_inv(f_p, ops, **kw)
            res[key] = {"ntt_fwd": smoke.graph_ms(fwd, 50),
                        "ntt_inv": smoke.graph_ms(inv, 50)}
            if not c:
                res[key].update(fwd_eager=smoke.eager_ms(fwd, 200),
                                inv_eager=smoke.eager_ms(inv, 200))
        if chooser:
            info = ntt_cuda.kernel_info(ops.logn, device)
            res["chosen"]["cluster"] = {
                k: info[f"{k}_kernel"]["cluster"]
                for k in ("ntt_fwd", "ntt_inv")}
        out[label] = res
        print(f"ntt {label} " + json.dumps(res), flush=True)
    return out


def execute_times(smoke, name, pub, compiled, enc, reps: int,
                  captured: bool):
    pub.execute(compiled, enc)
    times = smoke.execute_ms(pub, compiled, enc, reps)
    prof = smoke.profile_execute(name, pub, compiled, enc, top=0)
    res = {"execute_ms_median": statistics.median(times),
           "execute_ms_all": times, **(prof or {})}
    if captured:
        entry = smoke.captured_entry(pub, compiled, [enc])
        res["replay_ms_all"] = [smoke.replay_ms(entry) for _ in range(reps)]
        res["replay_ms"] = statistics.median(res["replay_ms_all"])
    return res


def path_times(smoke, reps: int):
    from eva_tpu_torch.backend.executor_torch import TorchProgram
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    captures = hasattr(TorchProgram, "_capture")

    out = {}
    for name, build, seed in (("sobel", smoke.build_sobel, 11),
                              ("harris", smoke.build_harris, 13),
                              ("sobel128", lambda: smoke.build_sobel(
                                  128, 128), 19)):
        rng = smoke.np.random.default_rng(seed)
        prog = build()
        compiled, params, sig = CKKSCompiler(
            {"warn_vec_size": "false"}).compile(prog)
        pub, _ = generate_keys(params)
        enc = pub.encrypt(
            {"image": rng.uniform(0, 1, prog.vec_size).tolist()}, sig)
        out[name] = {"captured": captures,
                     **execute_times(smoke, name, pub, compiled, enc, reps,
                                     captures)}
        if captures:
            TorchProgram._capture = False
            try:
                out[name]["eager"] = execute_times(smoke, name, pub,
                                                   compiled, enc, reps, False)
            finally:
                TorchProgram._capture = True
        print(f"path {name} " + json.dumps(out[name]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="directory for the JSON result")
    args = ap.parse_args()
    smoke = _smoke()
    import torch
    if not torch.cuda.is_available():
        print("cuda_ab: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from eva_tpu_torch.backend import cuda_lib, ks_cuda, ntt_cuda
    if not ntt_cuda.__file__.startswith(os.path.abspath(args.root)):
        raise AssertionError(f"imported {ntt_cuda.__file__}, not --root")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if hasattr(cuda_lib, "build_all"):
        cuda_lib.build_all(verbose=args.sweep)
    else:
        for lib in (ntt_cuda, ks_cuda):
            lib.build(verbose=args.sweep)
    device = torch.device("cuda", 0)
    res = {"card": card, "root": args.root,
           "ntt": ntt_times(smoke, device, args.sweep),
           "ks": {f"{k}_B{b}": v["ms"]
                  for (k, b), v in smoke.ks_kernel_phase(device).items()}}
    if hasattr(ntt_cuda, "kernel_info"):
        res["ntt_info"] = ntt_cuda.kernel_info(14, device)
    if args.paths:
        res["paths"] = path_times(smoke, args.reps)
    line = json.dumps(res)
    print(f"ab {args.label} {line}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = args.label.strip("./").replace("/", "_") or "change"
        k = 0
        while os.path.exists(os.path.join(args.out, f"ab_{tag}_{k}.json")):
            k += 1
        with open(os.path.join(args.out, f"ab_{tag}_{k}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
