#!/usr/bin/env python3
"""Reproduce the headline measurements of the PyTorch/CUDA port on this
machine's CUDA card: the counterpart of tools/reproduce.py.

Usage:
  python3 tools/reproduce_torch.py quick     # bench_torch.py + the profile
  python3 tools/reproduce_torch.py rotation  # rotation with its key switch
  python3 tools/reproduce_torch.py ks        # key-switch parity + A/B
  python3 tools/reproduce_torch.py e2e       # polynomial end to end
  python3 tools/reproduce_torch.py all

  quick     bench_torch.py (its one JSON line), then eva_tpu_torch.profiling's
            primitive table, roofline and calibration.
  rotation  one rotation with the full (fused) key switch at N=16384, L=0,
            batch 8: a chain of rotations captured as one CUDA graph, timed
            by CUDA events around its replays (sweep_alpha_torch.rotation_us).
  ks        the card's key-switch tests (tests/test_torch_cuda.py -k
            key_switch: K4/K5 against their plain versions) and
            tools/cuda_ab.py --paths (K1/K2/K4/K5 and the programs' replay
            times): the counterparts of verify_ks_tpu.py and
            bench_rotate.py.
  e2e       3x^2 + 5x - 2 over 4096 slots through compile, generate_keys,
            encrypt, execute and decrypt: the first execute (warm-up,
            capture and replay), the steady ms per execute over 10 and the
            MSE against the plaintext reference (exit 1 at 0.01 or more).

The last line is one JSON object: the card, what each mode measured and
the launches by kernel of this process's device work.
On the card by default; without one it exits 2, unless given --cpu,
which runs rotation and e2e on the host (the plain PyTorch versions, the
host clock); quick and ks measure the card only.
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import bench_torch  # noqa: E402

MODES = ("quick", "rotation", "ks", "e2e")
CARD_ONLY = ("quick", "ks")
MSE_LIMIT = 0.01


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


def quick() -> dict:
    subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                   env=_env(), check=True)
    from eva_tpu_torch.profiling import main as profile_main
    argv, sys.argv = sys.argv, ["profiling"]
    try:
        profile_main()
    finally:
        sys.argv = argv
    return {"bench_torch": "ran", "profiling": "ran"}


def rotation(device=None) -> dict:
    """One rotation with the full fused key switch at N=16384, L=0
    (6 data entries, one key entry of 60 bits), batch 8."""
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.crypto.context import get_context
    from sweep_alpha_torch import rotation_us

    ctx = get_context(tuple([60] * 7), (1,), 16384)
    keys = K.generate_keys(ctx)
    med, samples = rotation_us(ctx, keys, 0, device, "fused", batch=8)
    print(f"rotation incl. full key-switch, N=16384 L=0: {med / 1e3:.4f} ms",
          flush=True)
    return {"rotation_ms": med / 1e3,
            "samples_ms": [s / 1e3 for s in samples],
            "launches": bench_torch.path_launches()}


def ks() -> dict:
    for cmd in ([sys.executable, "-m", "pytest", "--noconftest", "-q",
                 "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
                 "key_switch"],
                [sys.executable, "tools/cuda_ab.py", "--paths"]):
        subprocess.run(cmd, cwd=ROOT, env=_env(), check=True)
    return {"key_switch_tests": "passed", "cuda_ab": "ran"}


def e2e(device=None, vec_size: int = 4096, reps: int = 10) -> dict:
    """reproduce.py's e2e: 3x^2 + 5x - 2 over `vec_size` slots (inputs
    uniform in [-2, 2] from random.seed(9)) through compile, generate_keys
    and encrypt on `device` (None: the CUDA device), one first execute
    and `reps` steady ones, decrypt. Returns the first execute's
    seconds, the steady ms per execute and the MSE."""
    import random

    from eva_tpu_torch import EvaProgram, Input, Output, evaluate
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import generate_keys

    device = resolve_device(device)
    random.seed(9)
    poly = EvaProgram("Polynomial", vec_size=vec_size)
    with poly:
        x = Input("x")
        Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)
    inputs = {"x": [random.uniform(-2, 2) for _ in range(vec_size)]}
    ref = evaluate(poly, inputs)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(poly)
    pub, sec = generate_keys(params, device=device)
    enc = pub.encrypt(inputs, sig)
    bench_torch.reset_counts()
    t0 = time.perf_counter()
    out_enc = pub.execute(compiled, enc)
    first_s = time.perf_counter() - t0
    print(f"first exec (incl warm-up and capture): {first_s:.3f}s",
          flush=True)
    t0 = time.perf_counter()
    for _ in range(reps):
        out_enc = pub.execute(compiled, enc)
    steady_ms = (time.perf_counter() - t0) / reps * 1e3
    mse = valuation_mse(sec.decrypt(out_enc, sig), ref)
    print(f"steady-state: {steady_ms:.3f} ms/eval, MSE {mse:.2e}",
          flush=True)
    return {"N": params.poly_modulus_degree, "first_execute_s": first_s,
            "steady_ms_per_eval": steady_ms, "reps": reps, "mse": mse,
            "launches": bench_torch.path_launches()}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="quick",
                    choices=MODES + ("all",))
    ap.add_argument("--cpu", action="store_true",
                    help="run rotation and e2e on the host")
    args = ap.parse_args(argv)
    modes = MODES if args.mode == "all" else (args.mode,)
    if not args.cpu and not torch.cuda.is_available():
        print("reproduce_torch: torch.cuda.is_available() is false; pass "
              "--cpu to run rotation and e2e on the host", file=sys.stderr)
        return 2
    if args.cpu and set(modes) & set(CARD_ONLY):
        print(f"reproduce_torch: {args.mode} measures the card; with --cpu "
              "only rotation and e2e run", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else None
    out = {"mode": args.mode,
           "card": None if args.cpu else bench_torch.card_line()}
    if "quick" in modes:
        out["quick"] = quick()
    if "rotation" in modes:
        out["rotation"] = rotation(device)
    if "ks" in modes:
        out["ks"] = ks()
    if "e2e" in modes:
        out["e2e"] = e2e(device)
    print(json.dumps(out), flush=True)
    if "e2e" in out and not out["e2e"]["mse"] < MSE_LIMIT:
        print(f"reproduce_torch: FAILED: e2e MSE {out['e2e']['mse']} >= "
              f"{MSE_LIMIT}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
