#!/usr/bin/env python3
"""Hybrid key-switch decomposition (alpha) sweep on the PyTorch/CUDA port:
the counterpart of tools/sweep_alpha.py, on one CUDA card.

For the configurations of sweep_alpha.py (N = 16384 with 6 data entries
and N = 8192 with 2, every entry and the key entry 60 bits, one rotation
step) it measures, for alpha in {1, 2, 3, 4}:

  - the digit group shapes ks_groups(alpha) produces. The groups are
    capped at a product of 2P, so with one 60-bit key entry (two ~30-bit
    key primes) alpha 3 and 4 pack into the pairs of alpha 2; such an
    alpha is reported as `same_groups_as_alpha` and not measured again,
    as sweep_alpha.py does. An alpha whose groups are not runs of alpha
    consecutive primes is refused (check_runs): the device key switch
    reads digit j from rows j*alpha .. j*alpha+alpha-1;
  - the time of one full rotation (bench_torch.rotation_step: the
    automorphism, the key switch, E1) at levels {0, entries // 2,
    entries - 1}, on both key-switch routes: "fused" (K4 ks_mac + K5
    ks_epilogue around K1/K2) and "structured" (EVA_TPU_NO_FUSED_KS=1:
    K1/K2, E1's MAC form, E3). Each timing is a chain of bench_torch.ITERS
    rotations captured as one CUDA graph at batch 8, timed by CUDA events
    around back-to-back replays (bench_torch.Chain), the median of PASSES
    samples with its samples and spread; the launch counters of its
    capture must show K4 and K5 on the fused route and neither, but E1's
    MAC form, on the structured one. Before it is timed, one rotation on
    the card must equal (torch.equal) the same rotation by the plain
    PyTorch versions on the host, so every timed shape of K4, K5, E1 and
    E3 is also checked;
  - the noise of sweep_alpha.py's rotation-bearing program (8 rotations,
    one multiply) at alpha 1 and 2: its output ciphertexts on the card
    must equal the port's numpy backend on the same keys and ciphertexts
    (every residue and the level), and the decryption's MSE against the
    plaintext reference is reported.

Prints ONE JSON line with sweep_alpha.py's keys ("backend", "configs",
"noise"), plus the card (`nvidia-smi --query-gpu=name,power.limit`), the
route of each timing, the timing method and the launches by kernel.
Writes no file. Exits 1 after the line when a noise-leg output differs
from the numpy backend; any other failure (a rotation that differs from
its plain version among them) raises.

Run on a CUDA card, from the root of a checkout:

    python3 tools/sweep_alpha_torch.py

Without a card it exits 2, unless given --cpu (the plain PyTorch versions
on the host, timed by the host clock; --ring N:ENTRIES, repeatable, and
--batch make it small, e.g. --cpu --ring 2048:2 --batch 2).
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

PASSES = 3
BATCH = 8
ALPHAS = (1, 2, 3, 4)
# sweep_alpha.py:140-141: (N, data entries).
RINGS = ((16384, 6), (8192, 2))
NOISE_ALPHAS = (1, 2)
ROUTES = ("fused", "structured")
ROUTE_TEXT = {"fused": "fused key switch: K4 ks_mac + K5 ks_epilogue "
                       "around K1/K2, E1",
              "structured": "structured key switch (EVA_TPU_NO_FUSED_KS=1): "
                            "K1/K2, E1 (MAC form), E3"}


def log(msg: str) -> None:
    print(f"sweep_alpha_torch: {msg}", file=sys.stderr, flush=True)


def sweep_context(n: int, entries: int):
    """sweep_alpha.py's context: `entries` 60-bit data entries and one
    60-bit key entry at ring n, one rotation step (1)."""
    from eva_tpu_torch.crypto.context import get_context
    return get_context(tuple([60] * entries + [60]), (1,), n, 1)


def runs_of_alpha(groups, alpha: int) -> bool:
    """Whether every group is the run of alpha consecutive primes the
    device key switch reads (the last may be short)."""
    start = 0
    for j, g in enumerate(groups):
        if g != list(range(start, start + len(g))):
            return False
        if len(g) != alpha and j != len(groups) - 1:
            return False
        start += len(g)
    return True


def check_runs(ctx, alpha: int) -> None:
    """Refuse an alpha whose ks_groups are not runs of alpha primes: both
    packages' device key switch reads digit j's primes from rows
    j*alpha .. j*alpha+alpha-1 of its input, so other groupings would give
    wrong digits (ROADMAP Queue 3, "Digit rows when alpha > n_key")."""
    groups = ctx.ks_groups(alpha)
    if not runs_of_alpha(groups, alpha):
        raise ValueError(
            f"alpha={alpha}: the key-switch groups "
            f"{[len(g) for g in groups]} (the 2P cap of ks_groups with "
            f"{len(ctx.key_primes)} key primes) are not runs of {alpha} "
            f"primes; the device key switch reads digit j from rows "
            f"j*{alpha}..j*{alpha}+{alpha - 1}")


def sweep_entries(ctx, alphas=ALPHAS):
    """sweep_alpha.py's config entries of ctx, one per alpha: "n",
    "entries", "alpha", "group_sizes", and "same_groups_as_alpha" when
    an earlier alpha packs the same groups (not measured again). Every
    alpha to measure passes check_runs."""
    entries = len(ctx.data_entries)
    seen, out = {}, []
    for alpha in alphas:
        shape = tuple(len(g) for g in ctx.ks_groups(alpha))
        entry = {"n": ctx.n, "entries": entries, "alpha": alpha,
                 "group_sizes": list(shape)}
        if shape in seen:
            entry["same_groups_as_alpha"] = seen[shape]
        else:
            check_runs(ctx, alpha)
            seen[shape] = alpha
        out.append(entry)
    return out


def sweep_levels(entries: int):
    """sweep_alpha.py:142: levels {0, entries // 2, entries - 1}."""
    return sorted({0, entries // 2, entries - 1})


@contextlib.contextmanager
def route(name: str):
    """EVA_TPU_NO_FUSED_KS set for the structured route, unset for the
    fused one, restored after."""
    if name not in ROUTES:
        raise ValueError(f"route {name!r} is not one of {ROUTES}")
    old = os.environ.get("EVA_TPU_NO_FUSED_KS")
    if name == "structured":
        os.environ["EVA_TPU_NO_FUSED_KS"] = "1"
    else:
        os.environ.pop("EVA_TPU_NO_FUSED_KS", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("EVA_TPU_NO_FUSED_KS", None)
        else:
            os.environ["EVA_TPU_NO_FUSED_KS"] = old


def routed_step(ctx, keys, level: int, device, route_name: str,
                batch: int = BATCH):
    """(step, x): bench_torch.rotation_step at `level` whose every call
    runs under route(route_name), so a CUDA graph captured from it holds
    that route's kernels."""
    check_runs(ctx, keys.ks_alpha)
    step, x = bench_torch.rotation_step(ctx, keys, device, batch, level)

    def run(p):
        with route(route_name):
            return step(p)

    return run, x


def check_route(counts: dict, route_name: str, on_card: bool) -> None:
    """The rotation's capture (or, on the CPU, its first step) went
    through its route: on the card K2 (the inverse NTT of c1) launched,
    K4 and K5 on the fused route (K4 transforms the digits and K5 returns
    to the NTT domain, so K1 need not run), and on the structured one K1,
    E1's MAC form and no K4 or K5; no plain version called. On the CPU
    the same of the plain versions."""
    if on_card:
        ntt, ks = counts["ntt_launches"], counts["ks_launches"]
        plain = bench_torch.path_launches(counts)["plain_calls"]
        mac = counts["modmath_launches"]["mod_ew_mac"]
    else:
        ntt, ks = counts["plain_calls"], counts["ks_plain_calls"]
        plain, mac = 0, counts["modmath_plain_calls"]["mac"]
    ok = (ntt["ntt_inv"] > 0 and not plain
          and (min(ks.values()) > 0 if route_name == "fused"
               else not any(ks.values()) and mac > 0
               and ntt["ntt_fwd"] > 0))
    if not ok:
        raise AssertionError(f"rotation on the {route_name} route: "
                             f"counts {counts}")


def plain_rotation(ctx, keys, level: int, batch: int = BATCH):
    """One rotation step of routed_step at `level` by the plain PyTorch
    versions on the host (the fused route's: both routes give the same
    residues, which the CPU tests hold to the JAX package bit for bit)."""
    step, x = routed_step(ctx, keys, level, "cpu", "fused", batch)
    return step(x)


def check_plain(got, want, what: str) -> None:
    """got (the card's) equal to want (the host's plain result), or an
    AssertionError naming the first differing (batch, row, index)."""
    import torch
    got = got.cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: the card's rotation has shape "
                             f"{tuple(got.shape)}, the plain version's "
                             f"{tuple(want.shape)}")
    if not torch.equal(got, want):
        at = tuple(int(v[0]) for v in (got != want).nonzero(as_tuple=True))
        raise AssertionError(
            f"{what}: the card's rotation differs from the plain version "
            f"at {list(at)}: {int(got[at])} != {int(want[at])}")


def rotation_us(ctx, keys, level: int, device, route_name: str = "fused",
                batch: int = BATCH, want=None):
    """(median, samples): microseconds of one full rotation at `level` on
    `route_name`. On the card one eager step must first equal `want`
    (plain_rotation's result, computed here when None), then each sample
    is a bench_torch.Chain of bench_torch.ITERS rotations captured as one
    CUDA graph, timed by CUDA events over back-to-back replays; on the CPU
    one eager step by the host clock. The capture's launch counters are
    checked (check_route); the counts are left as the capture set them."""
    from eva_tpu_torch.backend import resolve_device
    device = resolve_device(device)
    on_card = device.type == "cuda"
    step, x = routed_step(ctx, keys, level, device, route_name, batch)
    if on_card:
        if want is None:
            want = plain_rotation(ctx, keys, level, batch)
        check_plain(step(x), want, f"N={ctx.n} alpha={keys.ks_alpha} "
                    f"n_key={len(ctx.key_primes)} L={level} B={batch} "
                    f"{route_name}")
    bench_torch.reset_counts()
    chain = bench_torch.Chain(step, x, bench_torch.ITERS)
    check_route(bench_torch.read_counts(), route_name, on_card)
    samples = [chain.ms() * 1e3 / batch for _ in range(PASSES)]
    return statistics.median(samples), samples


def level_timings(ctx, keys, levels, device, batch: int = BATCH,
                  tag: str = "") -> dict:
    """{str(level): the fused route's timing (sweep_alpha.py's
    "rotation_us" and "samples", with "spread", "route" and, on the card,
    "equal_plain"), with the structured route's under "structured"}, each
    level on both routes, both held on the card to one plain_rotation;
    the launches of every capture are added to LAUNCHES."""
    from eva_tpu_torch.backend import resolve_device
    on_card = resolve_device(device).type == "cuda"
    out = {}
    for lv in levels:
        want = plain_rotation(ctx, keys, lv, batch) if on_card else None
        res = {}
        for r in ROUTES:
            med, samples = rotation_us(ctx, keys, lv, device, r, batch, want)
            add_launches()
            res[r] = {"rotation_us": round(med, 2),
                      "samples": [round(t, 2) for t in samples],
                      "spread": round((max(samples) - min(samples)) / med,
                                      3),
                      "route": r}
            if on_card:
                res[r]["equal_plain"] = True
            log(f"{tag} L={lv} {r}: {res[r]['rotation_us']} us "
                f"{res[r]['samples']}")
        out[str(lv)] = {**res["fused"], "structured": res["structured"]}
    return out


# Launches by kernel over the tool's device work (the captures and the
# noise leg's executes), for chip_smoke.py's tools phase.
LAUNCHES: dict = {}


def add_launches() -> None:
    for k, v in bench_torch.path_launches().items():
        LAUNCHES[k] = LAUNCHES.get(k, 0) + v


# -- the noise leg -------------------------------------------------------------


def noise_program():
    """sweep_alpha.py:127-138: 8 direct taps and one multiply."""
    from eva_tpu_torch import EvaProgram, Input, Output
    prog = EvaProgram("alpha_noise", vec_size=4096)
    with prog:
        x = Input("x")
        acc = None
        for i, t in enumerate((1, 2, 3, 9, 10, 11, 17, 18)):
            term = (x << t) * (0.2 * (i % 5) - 0.4)
            acc = term if acc is None else acc + term
        Output("y", acc * acc)
    prog.set_input_scales(40)
    prog.set_output_ranges(20)
    return prog


def noise_inputs(prog):
    """sweep_alpha.py's inputs: uniform in [-1, 1] from random.seed(17)."""
    import random
    random.seed(17)
    return {"x": [random.uniform(-1, 1) for _ in range(prog.vec_size)]}


def same_as_numpy(pub, compiled, enc, out) -> dict:
    """The port's numpy backend on pub's keys and `enc` against `out`:
    {"equal": every output's level, polynomial count and residues equal,
    "first_diff": (output, poly, row, index, both residues) of the first
    difference, or (output, "level" / "polys", both values), or None}."""
    import numpy as np
    from eva_tpu_torch.runtime import EVAPublic
    want = EVAPublic(pub.ctx, pub._keys, pub.params,
                     backend="numpy").execute(compiled, enc)
    for name in want:
        a, b = want[name], out[name]
        if a.level != b.level:
            return {"equal": False, "first_diff": [name, "level", a.level,
                                                   b.level]}
        if len(a.polys) != len(b.polys):
            return {"equal": False, "first_diff": [
                name, "polys", len(a.polys), len(b.polys)]}
        for i, (pa, pb) in enumerate(zip(a.polys, b.polys)):
            pa, pb = np.asarray(pa, np.uint64), np.asarray(pb, np.uint64)
            if not np.array_equal(pa, pb):
                row, idx = (int(v[0]) for v in np.nonzero(pa != pb))
                return {"equal": False, "first_diff": [
                    name, i, row, idx, int(pa[row, idx]), int(pb[row, idx])]}
    return {"equal": True, "first_diff": None}


def run_noise(compiled, params, sig, prog, device, alpha=None) -> dict:
    """One noise-leg run: keys on `device` (EVA_TPU_KS_ALPHA=alpha when
    given), encrypt, execute, decrypt. Returns {"noise_mse", "alpha",
    "key_terms", "equal", "first_diff"}: the MSE against the plaintext
    reference, and the output held to the numpy backend (same_as_numpy)."""
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import generate_keys

    old = os.environ.get("EVA_TPU_KS_ALPHA")
    if alpha is not None:
        os.environ["EVA_TPU_KS_ALPHA"] = str(alpha)
    try:
        pub, sec = generate_keys(params, device=device)
    finally:
        if old is None:
            os.environ.pop("EVA_TPU_KS_ALPHA", None)
        else:
            os.environ["EVA_TPU_KS_ALPHA"] = old
    check_runs(pub.ctx, pub._keys.ks_alpha)
    inputs = noise_inputs(prog)
    enc = pub.encrypt(inputs, sig)
    bench_torch.reset_counts()
    out = pub.execute(compiled, enc)
    add_launches()
    mse = valuation_mse(sec.decrypt(out, sig), evaluate(prog, inputs))
    return {"noise_mse": mse, "alpha": pub._keys.ks_alpha,
            "key_terms": params.key_terms,
            **same_as_numpy(pub, compiled, enc, out)}


# -- the sweep -----------------------------------------------------------------


def run(device=None, rings=RINGS, batch: int = BATCH) -> dict:
    """The sweep on `device` (None: the CUDA device); returns the line."""
    import torch
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.crypto import keys as K

    device = resolve_device(device)
    on_card = device.type == "cuda"
    LAUNCHES.clear()
    out = {"backend": device.type,
           "device_kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
           "card": bench_torch.card_line() if on_card else None,
           "timing": (bench_torch.TIMING if on_card
                      else "host clock (the CPU), one eager step a sample"),
           "batch": batch, "routes": ROUTE_TEXT, "configs": []}
    for n, entries in rings:
        ctx = sweep_context(n, entries)
        levels = sweep_levels(entries)
        for entry in sweep_entries(ctx):
            if "same_groups_as_alpha" in entry:
                log(f"N={n} alpha={entry['alpha']}: groups "
                    f"{entry['group_sizes']} identical to alpha="
                    f"{entry['same_groups_as_alpha']} (P-cap: group product "
                    f"<= 2P)")
            else:
                keys = K.generate_keys(ctx, alpha=entry["alpha"])
                entry["levels"] = level_timings(
                    ctx, keys, levels, device, batch,
                    f"N={n} alpha={entry['alpha']}")
            out["configs"].append(entry)

    prog = noise_program()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    out["noise"], out["noise_check"] = {}, {}
    for alpha in NOISE_ALPHAS:
        res = run_noise(compiled, params, sig, prog, device, alpha)
        out["noise"][str(alpha)] = res["noise_mse"]
        out["noise_check"][str(alpha)] = {
            "N": params.poly_modulus_degree, "equal_numpy": res["equal"],
            "first_diff": res["first_diff"]}
        log(f"noise: alpha={alpha} mse={res['noise_mse']:.3e} "
            f"equal_numpy={res['equal']}")
    out["launches"] = dict(LAUNCHES)
    return out


def parse_ring(text: str):
    n, entries = text.split(":")
    return int(n), int(entries)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the host")
    ap.add_argument("--ring", type=parse_ring, action="append",
                    metavar="N:ENTRIES",
                    help="a configuration (default: 16384:6 and 8192:2)")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("sweep_alpha_torch: torch.cuda.is_available() is false; pass "
              "--cpu to run the plain PyTorch versions on the host",
              file=sys.stderr)
        return 2
    line = run("cpu" if args.cpu else None, tuple(args.ring or RINGS),
               args.batch)
    print(json.dumps(line), flush=True)
    bad = {a: c for a, c in line["noise_check"].items()
           if not c["equal_numpy"]}
    if bad:
        print(f"sweep_alpha_torch: FAILED: noise-leg output differs from "
              f"the numpy backend: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
