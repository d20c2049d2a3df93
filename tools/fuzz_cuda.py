"""Random programs through eva_tpu_torch on the CUDA card: the counterpart
of tools/fuzz_tpu.py.

The CPU tests (tests/test_torch_fuzz.py and the matrix files) run every
kernel's plain PyTorch version. This script runs random programs of
tests/torch_random_programs.random_case_wide (vector sizes up to 8192,
N = 8192 / 16384 / 32768 in turn, every rescaler, security level, key
switch route and alpha) end to end on the card through the port's entry
points: generate_keys, encrypt, execute (a captured CUDA graph: the
first call warms up, captures and replays; a second call replays),
decrypt. So whole programs go through K1-K5 and E1-E3 at shapes the
kernel checks of chip_smoke.py never chose. For each program it holds

  (a) the card's output to the port's numpy backend on the same keys and
      ciphertexts: every residue and the level;
  (b) the card's output to the same public context on device="cpu" (the
      plain version of every kernel): residues, level and scale, bit for
      bit;
  (c) the decryption to the plaintext reference: MSE below 0.01;

and prints N, the prime bits, alpha, n_key, the route, the rescaler, the
launches by kernel (the card's executes only) and the seconds. A
mismatch raises with its record: program, N, primes, level, alpha, the
first differing (row, index) and both values. Each program's public
context, keys and captured graphs are released before the next; the
peak torch.cuda.max_memory_reserved() is printed at the end.

Usage: python3 tools/fuzz_cuda.py [n_programs] [seed]
Needs a CUDA device; exits 2 without one. chip_smoke.py's fuzz phase
runs check_all over random_cases (its own count and seed) and over
matrix_cases (the programs of tests/test_he.py and tests/test_large.py).
Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import collections
import gc
import json
import os
import random
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_SIZES = (8192, 16384, 32768)
MSE_LIMIT = 0.01


def _path():
    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


class Mismatch(AssertionError):
    """An output of the card differs from its reference."""


def _counters():
    from eva_tpu_torch.backend import (ks, ks_cuda, modmath, modmath_cuda,
                                       ntt_cuda, tables)
    launches = {**ntt_cuda.LAUNCHES, **ks_cuda.LAUNCHES,
                **modmath_cuda.LAUNCHES}
    plain = {**tables.PLAIN_CALLS, **ks.PLAIN_CALLS,
             **{f"modmath {k}": v for k, v in modmath.PLAIN_CALLS.items()}}
    return launches, plain


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def _planes(value):
    """A ciphertext's or plaintext's residue planes as uint64 arrays; a raw
    value as one float array."""
    if hasattr(value, "polys"):
        return [np.asarray(p).astype(np.uint64) for p in value.polys]
    if hasattr(value, "poly"):
        return [np.asarray(value.poly).astype(np.uint64)]
    return [np.asarray(value, dtype=np.float64)]


def compare(test, ctx, alpha, what, want, got, scale: bool):
    """Raise Mismatch at the first output of `got` that differs from
    `want`: its level, its scale (when `scale`), or a residue, with the
    record ROADMAP.md Queue 3 asks for."""
    if set(want) != set(got):
        raise Mismatch(f"{test}: {what}: outputs {sorted(want)} against "
                       f"{sorted(got)}")
    for name in sorted(want):
        a, b = want[name], got[name]
        level = getattr(a, "level", None)
        head = (f"{test}: {what}: output {name}: N={ctx.n} prime_bits="
                f"{ctx.prime_bits} level={level} alpha={alpha}")
        if getattr(b, "level", None) != level:
            raise Mismatch(f"{head}: level {level} against {b.level}")
        if scale and getattr(a, "scale", None) != getattr(b, "scale", None):
            raise Mismatch(f"{head}: scale {a.scale!r} against {b.scale!r}")
        pa, pb = _planes(a), _planes(b)
        if len(pa) != len(pb):
            raise Mismatch(f"{head}: {len(pa)} planes against {len(pb)}")
        for k, (x, y) in enumerate(zip(pa, pb)):
            if x.shape != y.shape:
                raise Mismatch(f"{head}: plane {k} shape {x.shape} against "
                               f"{y.shape}")
            bad = np.argwhere(x != y)
            if len(bad):
                at = tuple(int(i) for i in bad[0])
                row, index = at[-2] if len(at) > 1 else 0, at[-1]
                primes = (ctx.primes_at_level(level)
                          if level is not None else None)
                raise Mismatch(
                    f"{head}: plane {k} primes {primes}: {len(bad)} "
                    f"residues differ, first at (row {row}, index {index}) "
                    f"{at}: want {x[at]} got {y[at]}")


def _key_switches(executor) -> bool:
    """Whether the program relinearizes or rotates a ciphertext (a
    rotation of a plaintext runs on the host)."""
    from eva_tpu_torch.ir import Op, Type
    return any(t.op in (Op.Relinearize, Op.RotateLeftConst,
                        Op.RotateRightConst)
               and executor.types[t] == Type.Cipher
               for t in executor.order)


def check_program(test, prog, compiled, inputs, env=None, rescaler=None,
                  device=None):
    """Run one compiled program on the card (`device` None; "cpu" runs
    the same checks on the plain versions, as the tests do) under `env`
    and hold it to its references ((a)-(c) above); release its context
    and graphs. Returns the program's record."""
    import torch

    from eva_tpu_torch import evaluate
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVAPublic, generate_keys
    from torch_random_programs import environment

    program, params, sig = compiled
    env = env or {}
    route = "structured" if env.get("EVA_TPU_NO_FUSED_KS") else "fused"
    t0 = time.perf_counter()
    with environment(env):
        pub, sec = generate_keys(params, device=device)
        enc = pub.encrypt(inputs, sig)
        launches0, plain0 = _counters()
        out = pub.execute(program, enc)
        again = pub.execute(program, enc)
        if device is None:
            torch.cuda.synchronize()
        launches1, plain1 = _counters()
        t_card = time.perf_counter() - t0
        ctx, alpha = pub.ctx, pub._keys.ks_alpha
        plain = {k: v for k, v in _delta(plain0, plain1).items() if v}
        if plain and device is None:
            raise Mismatch(f"{test}: the card called plain versions {plain}")
        launches = {k: v for k, v in _delta(launches0, launches1).items()
                    if v}
        compare(test, ctx, alpha, "replay against the first execute", out,
                again, True)
        want = EVAPublic(ctx, pub._keys, params, backend="numpy").execute(
            program, enc)
        compare(test, ctx, alpha, "card against the numpy backend", want,
                out, False)
        cpu = EVAPublic(ctx, pub._keys, params, backend="torch",
                        device="cpu").execute(program, enc)
        compare(test, ctx, alpha, "card against the plain versions", cpu,
                out, True)
        mse = valuation_mse(sec.decrypt(out, sig), evaluate(prog, inputs))
    if not mse < MSE_LIMIT:
        raise Mismatch(f"{test}: N={ctx.n} prime_bits={ctx.prime_bits} "
                       f"alpha={alpha}: decrypted MSE {mse} >= {MSE_LIMIT}")
    used = launches if device is None else plain
    ks = used.get("ks_mac", 0) + used.get("ks_epilogue", 0)
    if route == "structured" and ks:
        raise Mismatch(f"{test}: the structured route ran K4/K5 {used}")
    executor = pub._executor_for(program)
    if route == "fused" and _key_switches(executor) and not ks:
        raise Mismatch(f"{test}: the fused route ran no K4/K5 {used}")
    shards = executor._get_torch_program().k
    record = {
        "test": test, "N": ctx.n, "prime_bits": list(ctx.prime_bits),
        "vec_size": prog.vec_size, "shards": shards, "alpha": alpha,
        "n_key": len(ctx.key_primes), "route": route,
        "rescaler": rescaler, "rotations": len(params.rotations),
        "launches": launches, "mse": mse,
        "card_s": round(t_card, 3),
        "s": round(time.perf_counter() - t0, 3)}
    del pub, sec, enc, out, again, want, cpu, executor
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
        record["allocated_after_release"] = torch.cuda.memory_allocated()
    return record


def random_cases(n_programs: int, seed: int, rings=RING_SIZES):
    """`n_programs` random programs of random_case_wide from `seed`, N
    cycling through `rings`: (test, program, compiled, inputs, env,
    config) each."""
    _path()
    import eva_tpu_torch
    from torch_random_programs import random_case_wide
    rng = random.Random(seed)
    for i in range(n_programs):
        prog, config, env, compiled = random_case_wide(
            eva_tpu_torch, rng, i, rings[i % len(rings)])
        # test_fuzz.test_he_roundtrip_sample's inputs
        inputs = {name: [rng.uniform(-1, 1) for _ in range(prog.vec_size)]
                  for name in prog.inputs}
        yield (f"fuzz seed={seed:#x} program={i}", prog, compiled, inputs,
               env, config)


def matrix_cases():
    """Every program of the reference's matrices
    (torch_random_programs.MATRIX: tests/test_he.py, tests/test_large.py)
    with its inputs, as random_cases yields them."""
    _path()
    import eva_tpu_torch
    from eva_tpu_torch.ckks import CKKSCompiler
    from torch_random_programs import MATRIX
    for name, case in MATRIX.items():
        prog = case.build(eva_tpu_torch)
        compiler = CKKSCompiler(dict(case.config))
        yield (f"matrix {name}", prog, compiler.compile(prog),
               case.inputs(prog), {},
               {**case.config, "rescaler": compiler.config.rescaler})


def check_all(cases, log=print, device=None):
    """check_program on each case of random_cases or matrix_cases; a
    mismatch is logged and counted, and the run goes on. Returns
    (records, failures)."""
    records, failures = [], []
    for test, prog, compiled, inputs, env, config in cases:
        try:
            record = check_program(test, prog, compiled, inputs, env,
                                   config["rescaler"], device)
        except Mismatch as exc:
            log(f"fuzz_failure {exc}")
            failures.append(str(exc))
            continue
        record["config"] = {k: config[k] for k in (
            "security_level", "quantum_safe", "two_entry_ks",
            "balance_reductions", "lazy_relinearize") if k in config}
        log("fuzz_program " + json.dumps(record))
        records.append(record)
    return records, failures


def summary(records) -> dict:
    """Counts by N, route, alpha (1 or "default") and rescaler."""
    def count(key):
        return dict(sorted(collections.Counter(map(key, records)).items(),
                           key=str))
    return {
        "programs": len(records),
        "by_N": count(lambda r: r["N"]),
        "by_route": count(lambda r: r["route"]),
        "by_alpha": count(lambda r: "default" if r["alpha"] == r["n_key"]
                          else r["alpha"]),
        "by_rescaler": count(lambda r: r["rescaler"]),
        "by_n_key": count(lambda r: r["n_key"]),
        "sharded": sum(r["shards"] > 1 for r in records),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fuzz_cuda: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    n_programs = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    seed = int(sys.argv[2], 0) if len(sys.argv) > 2 else 0xC0DA
    print(f"device={torch.cuda.get_device_name(0)} programs={n_programs} "
          f"seed={seed:#x}", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    records, failures = check_all(random_cases(n_programs, seed),
                                  lambda s: print(s, flush=True))
    print("fuzz " + json.dumps({
        **summary(records), "failures": len(failures),
        "s": round(time.perf_counter() - t0, 3),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved()}),
        flush=True)
    print("PASS" if not failures else f"FAIL ({len(failures)})", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
