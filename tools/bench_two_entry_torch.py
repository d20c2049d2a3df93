#!/usr/bin/env python3
"""A/B of the two-entry special modulus (P ~ 2^120, alpha = 4 digits)
against the standard single entry (alpha = 2) on the PyTorch/CUDA port:
the counterpart of tools/bench_two_entry.py, on one CUDA card.

For the data chain of bench_two_entry.py (N = 16384, 5 data entries of
60 bits) under one key entry (key_terms 1: two key primes, alpha 2) and
two (key_terms 2: four key primes, alpha 4), it times one full rotation
at levels 0 and entries - 2 on both key-switch routes
(sweep_alpha_torch.level_timings: a chain of rotations captured as one
CUDA graph at batch 8, CUDA events around its replays, the median of
three samples; "fused" is K4 + K5, "structured" is
EVA_TPU_NO_FUSED_KS=1), with the digit groups of each level.

Then the noise leg of bench_two_entry.py: its deep rotation-bearing
program compiled with two_entry_ks "false" and "true", run through
generate_keys, encrypt, execute and decrypt on the card; each output
must equal the port's numpy backend on the same keys and ciphertexts
(residues and level), and the MSE against the plaintext reference is
reported.

Prints ONE JSON line ("backend", "configs" with bench_two_entry.py's
entries, plus the card, the route of each timing and the launches by
kernel). Writes no file. Exits 1 after the line when a noise-leg output
differs from the numpy backend; any other failure raises.

Run on a CUDA card, from the root of a checkout:

    python3 tools/bench_two_entry_torch.py

Without a card it exits 2, unless given --cpu (the plain PyTorch versions
on the host; --n and --batch make it small, e.g. --cpu --n 2048
--batch 2).
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import sweep_alpha_torch as S  # noqa: E402
from sweep_alpha_torch import level_timings  # noqa: E402

N, ENTRIES = 16384, 5  # leaves budget room for the second key entry


def log(msg: str) -> None:
    print(f"bench_two_entry_torch: {msg}", file=sys.stderr, flush=True)


def two_entry_context(key_terms: int, n: int = N, entries: int = ENTRIES):
    """bench_two_entry.py's context: `entries` 60-bit data entries and
    `key_terms` 60-bit key entries at ring n, one rotation step (1)."""
    from eva_tpu_torch.crypto.context import get_context
    return get_context(tuple([60] * entries + [60] * key_terms), (1,), n,
                       key_terms)


def noise_program():
    """bench_two_entry.py:50-66: three squarings and four rotations."""
    from eva_tpu_torch import EvaProgram, Input, Output
    prog = EvaProgram("two_entry_noise", vec_size=4096)
    with prog:
        x = Input("x")
        y = x
        for _ in range(3):
            y = y * y
        acc = None
        for i, t in enumerate((1, 2, 9, 10)):
            term = (x << t) * (0.2 * (i % 5) - 0.4)
            acc = term if acc is None else acc + term
        Output("y", y + acc)
    prog.set_input_scales(40)
    prog.set_output_ranges(20)
    return prog


def run(device=None, n: int = N, batch: int = S.BATCH) -> dict:
    """The A/B on `device` (None: the CUDA device); returns the line."""
    import torch
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.crypto import keys as K

    device = resolve_device(device)
    on_card = device.type == "cuda"
    S.LAUNCHES.clear()
    out = {"backend": device.type,
           "device_kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
           "card": S.bench_torch.card_line() if on_card else None,
           "timing": (S.bench_torch.TIMING if on_card
                      else "host clock (the CPU), one eager step a sample"),
           "batch": batch, "routes": S.ROUTE_TEXT, "configs": []}
    for key_terms in (1, 2):
        ctx = two_entry_context(key_terms, n)
        alpha = len(ctx.key_primes)
        keys = K.generate_keys(ctx, alpha=alpha)
        levels = (0, ENTRIES - 2)
        timed = level_timings(ctx, keys, levels, device, batch,
                              f"key_terms={key_terms} alpha={alpha}")
        for level in levels:
            entry = {"key_terms": key_terms, "alpha": alpha, "level": level,
                     "groups": [len(g) for g in
                                ctx.ks_tables(level, alpha)[0]],
                     **timed[str(level)]}
            out["configs"].append(entry)
            log(json.dumps(entry))

    prog = noise_program()
    for cfg in ("false", "true"):
        compiled, params, sig = CKKSCompiler(
            {"warn_vec_size": "false", "two_entry_ks": cfg}).compile(prog)
        res = S.run_noise(compiled, params, sig, prog, device)
        entry = {"two_entry_ks": cfg, "key_terms": res["key_terms"],
                 "alpha": res["alpha"], "noise_mse": res["noise_mse"],
                 "N": params.poly_modulus_degree,
                 "prime_bits": list(params.prime_bits),
                 "equal_numpy": res["equal"],
                 "first_diff": res["first_diff"]}
        out["configs"].append(entry)
        log(json.dumps(entry))
    out["launches"] = dict(S.LAUNCHES)
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the host")
    ap.add_argument("--n", type=int, default=N,
                    help="ring size of the rotation timings")
    ap.add_argument("--batch", type=int, default=S.BATCH)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_two_entry_torch: torch.cuda.is_available() is false; "
              "pass --cpu to run the plain PyTorch versions on the host",
              file=sys.stderr)
        return 2
    line = run("cpu" if args.cpu else None, args.n, args.batch)
    print(json.dumps(line), flush=True)
    bad = [c for c in line["configs"] if c.get("equal_numpy") is False]
    if bad:
        print(f"bench_two_entry_torch: FAILED: noise-leg output differs "
              f"from the numpy backend: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
