#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one CUDA card: the counterpart of
bench.py (the JAX package's benchmark), with its keys.

Prints ONE JSON line, bench.py's: the headline metric is ct-ct multiply
throughput at N=16384 L=6 (`value`, mults/s on the card, `vs_baseline`
against the port's single-thread host backend); `extras` carries the
same measurements as bench.py's, each device metric the median of
PASSES interleaved passes with its samples and spread:

  ct_mul_per_sec / ct_mul_host_per_sec   E2 (tensor product) at [32, 12,
                                         N], chained on its middle output
  rotation_us / rotation_host_us         a full Galois rotation (K1, K2,
                                         K4, K5, E1) at [8, 12, N], per op
  sobel90_ms / sobel90_host_ms           Sobel 90x90: one replay of the
                                         captured program / the numpy
                                         backend's execute
  sobel90_batched_evals_per_sec          execute_batch of 4: its graph
  sobel90_with_io_ms                     wall of one EVAPublic.execute
  harris_ms / harris_host_ms             Harris 90x90 (host once)
  kernel_sol                             per-step µs, % of the measured
                                         HBM roofline and of the measured
                                         modular-multiply rate (E4)
  sobel_compile_cold_s / _warm_s         nvcc build of the three kernel
                                         sources + the first execute of a
                                         fresh public context / that
                                         first execute alone

plus the card (`nvidia-smi --query-gpu=name,power.limit`), how each
number was taken (`timing`), and the measured int32 data-sheet rate
beside the modular-multiply rate.

Methodology: device time by CUDA events. A chained step (ct-mul,
rotation, the kernel_sol steps, E4) is captured as one CUDA graph of
`iters` steps, each consuming the previous output, whose last output is
copied back into the graph's static input, so every replay continues
the chain; the time per step is the events' span over back-to-back
replays divided by the steps (chip_smoke.graph_ms's method). A program
(Sobel, Harris, the batch) is timed as back-to-back replays of the CUDA
graph that EVAPublic.execute captured for it (replay_ms).
Host numbers are wall clock, single thread.

Run on a CUDA card, from the root of a checkout:

    python3 bench_torch.py

Without CUDA it prints no line and exits 2; any failure raises (non-zero
exit), and a Sobel or Harris MSE at or above MSE_LIMIT exits 1 after the
line. There is no CPU fallback. The sections are functions of (device,
n, levels, batch, passes) so that they run small on the CPU (the plain
versions; host clock) in tests/test_torch_bench.py.

Also the measuring pieces chip_smoke.py shares: the data-sheet peaks,
the Sobel and Harris programs and their MSE limits, the replay timer
and the card's line.

Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N = 16384
L = 6
PASSES = 3  # interleaved measurement rounds per device metric
# Batches: ct-mul, rotation and kernel_sol, the batched Sobel (bench.py's).
BATCH_CT_MUL, BATCH_ROT, BATCH_SOBEL = 32, 8, 4
BATCHES = (BATCH_CT_MUL, BATCH_ROT, BATCH_SOBEL)
# Steps of one chain run: the ct-mul's, E4's, every other chain's.
ITERS_CT_MUL, ITERS_BURN, ITERS = 50, 10, 20
HOST_REPS = 3  # host rotations, and executes of one with-I/O sample
HBM_BYTES = 128 << 20  # the roofline's copy
# H100 SXM peaks: HBM3 3.35 TB/s (NVIDIA data sheet); 32-bit integer
# ALU throughput 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12
# ops/s (Hopper architecture white paper: 64 INT32 units per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit Montgomery multiply as nvcc compiles it for sm_90a: the 64-bit
# product (IMAD.WIDE.U32), m = lo * nqinv (IMAD), the high word of
# m * q plus the product (IMAD.HI.U32), then compare, select and subtract
# for the reduction: 6 instructions (E4's unrolled chain is 16 such runs
# of 6: `python3 tools/sass_ops.py modmath modmul_burn_kernel`).
OPS_PER_MONT_MUL = 6
# Decrypted MSE against the plaintext reference. Sobel's is ~1e-14.
# Harris's outputs reach ~1e4 and its MSE varies with the keys: over 48
# fresh key sets it ran 2.9e-4 (min), 4.1e-4 (median), 1.3e-3 (max)
# (`python3 mse_draws.py harris 48`, host numpy backend, whose
# ciphertexts equal the card's). The limit is about 4x that max.
MSE_LIMIT = {"sobel": 1e-6, "harris": 5e-3, "sobel128": 5e-13}
# The device metrics sampled each pass, as bench.py's _emit writes them:
# (name, factor from the sample to the line's unit, unit); and the keys
# the line holds besides (bench.py's main, then the card and timing).
SAMPLED = (("ct_mul", 1.0, "per_sec"), ("rotation", 1e6, "us"),
           ("sobel90", 1e3, "ms"), ("harris", 1e3, "ms"),
           ("sobel90_batched", 1.0, "evals_per_sec"),
           ("sobel90_with_io", 1e3, "ms"), ("sobel90_host", 1e3, "ms"))
ONCE = ("passes", "baseline", "device_backend", "ct_mul_host_per_sec",
        "rotation_host_us", "sobel90_mse", "sobel90_first_execute_s",
        "harris_mse", "harris_first_execute_s", "harris_host_ms",
        "harris_N", "rotation_vs_host", "sobel90_vs_host", "harris_vs_host",
        "kernel_sol", "sobel_compile_cold_s", "sobel_compile_warm_s",
        "card", "timing")
LINE_EXTRAS = (set(ONCE) | {f"{k}_{u}" for k, _, u in SAMPLED}
               | {f"{k}_samples_{u}" for k, _, u in SAMPLED}
               | {f"{k}_spread" for k, _, _ in SAMPLED})
TIMING = ("cuda events around graph replays: chained steps captured as "
          "one CUDA graph of `iters` steps, programs as the graph "
          "EVAPublic.execute captured; host numbers wall clock")


def _med(samples):
    return statistics.median(samples) if samples else 0.0


def _spread(samples):
    return (max(samples) - min(samples)) / _med(samples) if samples else 0.0


def log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


# -- shared with chip_smoke.py -----------------------------------------------


def build_sobel(h=90, w=90):
    """2x 3x3 convolutions + cubic polynomial on the squared gradient
    magnitude (the reference's image_processing.py Sobel workload)."""
    from eva_tpu_torch import EvaProgram, Input, Output

    prog = EvaProgram("sobel", vec_size=2 ** (math.ceil(math.log2(h * w))))
    with prog:
        image = Input("image")
        filt = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
        a1, a2, a3 = 2.2137874823876622, -1.0984324107372518, \
            0.17254603006834726
        Ix = Iy = None
        for i in range(3):
            for j in range(3):
                rotated = image << (i * w + j)
                horizontal = rotated * filt[i][j]
                vertical = rotated * filt[j][i]
                if Ix is None:
                    Ix, Iy = horizontal, vertical
                else:
                    Ix, Iy = Ix + horizontal, Iy + vertical
        x = Ix ** 2 + Iy ** 2
        Output("image", x * a1 + x ** 2 * a2 + x ** 3 * a3)
    prog.set_input_scales(45)
    prog.set_output_ranges(20)
    return prog


def build_harris(h=90, w=90):
    """Sobel gradients, three 3x3 box sums over their products,
    determinant/trace corner response (the reference's Harris
    workload)."""
    from eva_tpu_torch import EvaProgram, Input, Output

    prog = EvaProgram("harris", vec_size=2 ** (math.ceil(math.log2(h * w))))
    with prog:
        image = Input("image")
        sobel_filter = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
        box = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]
        k = 0.04

        def conv(img, filt, also_transposed=False):
            a = b = None
            for i in range(3):
                for j in range(3):
                    rot = img << (i * w + j)
                    hor = rot * filt[i][j]
                    a = hor if a is None else a + hor
                    if also_transposed:
                        ver = rot * filt[j][i]
                        b = ver if b is None else b + ver
            return (a, b) if also_transposed else a

        Ix, Iy = conv(image, sobel_filter, also_transposed=True)
        Sxx = conv(Ix * Ix, box)
        Syy = conv(Iy * Iy, box)
        Sxy = conv(Ix * Iy, box)
        det = Sxx * Syy - Sxy * Sxy
        trace = Sxx + Syy
        Output("image", det - k * trace * trace)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    return prog


def captured_entry(pub, compiled, encs):
    """The captured graph that `execute` (one valuation in `encs`) or
    `execute_batch` (more, stacked) replays for `encs`."""
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    return tp._captured[tp._capture_key(*tp._split(
        [ex._host_phase(e)[0] for e in encs], len(encs) > 1))]


def replay_ms(entry, reps: int = 20) -> float:
    """Device ms of one replay of a captured graph (`entry.graph`): CUDA
    events around `reps` back-to-back replays (no input staging, no
    output copy)."""
    import torch
    entry.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line: the card's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


# Launch counters of the kernel wrappers and plain-version calls, by
# counter name (read_counts); the NTT rows-per-launch histogram is
# ntt_cuda.ROWS.
COUNTERS = ("ntt_launches", "plain_calls", "ks_launches", "ks_plain_calls",
            "ks_max_batch", "modmath_launches", "modmath_plain_calls",
            "modmath_ops", "probe_launches", "ntt_shard_launches",
            "ntt_shard_plain_calls")
# The counters of the kernels a program's path launches (K1, K2, K4, K5,
# E1 by form, E2, E3; K6, K7 on the seq mesh programs).
PATH_COUNTERS = ("ntt_launches", "ks_launches", "modmath_launches",
                 "ntt_shard_launches")
# The counters of the plain versions' calls.
PLAIN_COUNTERS = ("plain_calls", "ks_plain_calls", "modmath_plain_calls",
                  "ntt_shard_plain_calls")


def _counters():
    from eva_tpu_torch.backend import (ks, ks_cuda, modmath, modmath_cuda,
                                       ntt_cuda, ntt_shard_cuda, tables)
    from eva_tpu_torch.parallel import ntt_shard
    return (ntt_cuda.LAUNCHES, tables.PLAIN_CALLS, ks_cuda.LAUNCHES,
            ks.PLAIN_CALLS, ks_cuda.MAX_BATCH, modmath_cuda.LAUNCHES,
            modmath.PLAIN_CALLS, modmath_cuda.OPS,
            modmath_cuda.PROBE_LAUNCHES, ntt_shard_cuda.LAUNCHES,
            ntt_shard.PLAIN_CALLS)


def reset_counts():
    """Every counter of COUNTERS, and the NTT row histogram, to 0."""
    from eva_tpu_torch.backend import modmath_cuda, ntt_cuda
    for counts in _counters():
        for k in counts:
            counts[k] = 0
    for rows in ntt_cuda.ROWS.values():
        rows.clear()
    modmath_cuda.OPS.clear()


def read_counts():
    """{counter name: {kernel: count}} (see COUNTERS)."""
    return {name: dict(c) for name, c in zip(COUNTERS, _counters())}


def path_launches(counts=None) -> dict:
    """{kernel: launches} of the PATH_COUNTERS in `counts` (read_counts(),
    by default read now), and "plain_calls": every plain-version call
    (NTT, key switch, modmath, sharded NTT) summed."""
    counts = read_counts() if counts is None else counts
    out = {k: v for c in PATH_COUNTERS for k, v in counts[c].items()}
    out["plain_calls"] = sum(v for c in PLAIN_COUNTERS
                             for v in counts[c].values())
    return out


# -- inputs ------------------------------------------------------------------


def host_planes(primes, n, batch, seed):
    """bench.py's _planes: random reduced residues of `primes`, [batch,
    len(primes), n] (batch 0: no batch axis) as uint32."""
    r = np.random.default_rng(seed)
    shape = (batch, len(primes), n) if batch else (len(primes), n)
    out = np.empty(shape, dtype=np.uint32)
    for i, q in enumerate(primes):
        out[..., i, :] = r.integers(0, q, shape[:-2] + (n,), dtype=np.uint64)
    return out


def _planes(primes, n, batch, seed, device):
    from eva_tpu_torch.backend.modmath import upload
    return upload(host_planes(primes, n, batch, seed), device)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Chain:
    """x -> step(x) -> step(step(x)) ...: `iters` steps a run. On the card
    the run is one CUDA graph (`graph`), captured once, whose last output
    is copied back into its static input (so each replay continues the
    chain); ms() is the span of CUDA events around `reps` back-to-back
    replays (replay_ms) over reps x iters. On the CPU, where there is no
    launch latency to spread, one eager step by the host clock."""

    reps = 5

    def __init__(self, step, x, iters: int):
        import torch
        self.step, self.iters = step, iters
        self.device = x.device
        self.x = x.clone()
        if self.device.type != "cuda":
            self.step(self.x)  # warm: every table built
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(3):
                self.step(self.x)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            v = self.x
            for _ in range(iters):
                v = step(v)
            self.x.copy_(v)
        self.graph.replay()
        torch.cuda.synchronize(self.device)

    def ms(self) -> float:
        """Milliseconds per step."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.step(self.x)
            return (time.perf_counter() - t0) * 1e3
        return replay_ms(self, self.reps) / self.iters


def bench_context(n: int = N, levels: int = L):
    """bench.py's context: `levels` 60-bit data entries and one 60-bit
    key entry at ring n, one rotation step (1)."""
    from eva_tpu_torch.crypto.context import get_context
    return get_context(tuple([60] * levels + [60]), (1,), n)


# -- ct-ct multiply -----------------------------------------------------------


def ct_mul_step(device=None, n: int = N, levels: int = L,
                batch: int = BATCH_CT_MUL):
    """(step, x): the chained ct-ct multiply of bench.py's setup_ct_mul on
    the level-0 primes of bench_context(n, levels), [batch, primes, n]
    planes host_planes(seed 0..3): step(a0) is the middle output of
    DeviceLevelOps.tensor_product(a0, a1, b0, b1) (E2 on the card)."""
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.backend.tables import level_ops
    device = resolve_device(device)
    primes = bench_context(n, levels).primes_at_level(0)
    dev = level_ops(primes, n, device)
    x, a1, b0, b1 = (_planes(primes, n, batch, s, device) for s in range(4))

    def step(a0):
        return dev.tensor_product(a0, a1, b0, b1)[1]

    return step, x


def setup_ct_mul(device=None, n: int = N, levels: int = L,
                 batch: int = BATCH_CT_MUL):
    """measure() -> ct-ct multiplies a second on `device`."""
    step, x = ct_mul_step(device, n, levels, batch)
    chain = Chain(step, x, ITERS_CT_MUL)

    def measure() -> float:
        return batch / (chain.ms() / 1e3)

    return measure


def _host_ct(ctx, n, seeds):
    from eva_tpu_torch.crypto.ciphertext import Ciphertext
    primes = ctx.primes_at_level(0)
    return Ciphertext([host_planes(primes, n, 0, s).astype(np.uint64)
                       for s in seeds], 0, 2.0 ** 40)


def bench_ct_mul_host(ctx) -> float:
    """The port's host backend ct-ct multiply (crypto.ops.multiply,
    single thread): multiplies a second over HOST_REPS."""
    from eva_tpu_torch.crypto import ops as O
    a, b = _host_ct(ctx, ctx.n, (0, 1)), _host_ct(ctx, ctx.n, (2, 3))
    O.multiply(ctx, a, b)  # warm caches
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        O.multiply(ctx, a, b)
    return HOST_REPS / (time.perf_counter() - t0)


# -- rotation -----------------------------------------------------------------


def rotation_shim(ctx, keys, device):
    """A TorchProgram of no terms over ctx and keys (as profiling.profile
    builds one), whose _rotate and key-switch stages the bench calls."""
    from eva_tpu_torch.backend.executor_torch import TorchProgram
    from eva_tpu_torch.ir import Program, TermMap, Type
    return TorchProgram(Program("bench", ctx.n // 2), ctx, keys, {},
                        TermMap(Type.Undef), [], device)


def rotation_step(ctx, keys, device=None, batch: int = BATCH_ROT,
                  level: int = 0):
    """(step, x): bench.py's rotation chain at `level`: step(p) is the sum
    of the two outputs of TorchProgram._rotate([p, p], 1, level) (the
    automorphism, the key switch around K1 and K2 (the fused one, K4 +
    K5, unless EVA_TPU_NO_FUSED_KS is set when step runs), and E1), on
    host_planes(seed 7) of `batch` ciphertext components."""
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.backend.tables import level_ops
    device = resolve_device(device)
    primes = ctx.primes_at_level(level)
    shim = rotation_shim(ctx, keys, device)
    dev = level_ops(primes, ctx.n, device)

    def step(p):
        out = shim._rotate([p, p], 1, level, dev)
        return dev.add(out[0], out[1])

    return step, _planes(primes, ctx.n, batch, 7, device)


def setup_rotation(ctx, keys, device=None, batch: int = BATCH_ROT):
    """measure() -> seconds per rotation on `device`."""
    step, x = rotation_step(ctx, keys, device, batch)
    chain = Chain(step, x, ITERS)

    def measure() -> float:
        return chain.ms() / 1e3 / batch

    return measure


def bench_rotation_host(ctx, keys) -> float:
    """The port's host backend rotation (crypto.ops.rotate): seconds per
    op over HOST_REPS."""
    from eva_tpu_torch.crypto import ops as O
    a = _host_ct(ctx, ctx.n, (0, 1))
    O.rotate(ctx, keys, a, 1)  # warm
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        O.rotate(ctx, keys, a, 1)
    return (time.perf_counter() - t0) / HOST_REPS


# -- whole programs -----------------------------------------------------------


def program_timer(pub, compiled, encs):
    """fn() -> device ms of one execution of `compiled` over the
    valuations `encs` (one: execute; more: execute_batch, stacked): on
    the card one replay of the CUDA graph EVAPublic captured for them
    (back-to-back replays between CUDA events; no input staging, no
    output copy), on the CPU the wall of one execute."""
    if len(encs) > 1:
        def execute():
            pub.execute_batch(compiled, encs)
    else:
        def execute():
            pub.execute(compiled, encs[0])
    execute()  # on the card: warm-up and capture
    if pub.device.type == "cuda":
        entry = captured_entry(pub, compiled, encs)
        return lambda: replay_ms(entry)

    def host_ms() -> float:
        t0 = time.perf_counter()
        execute()
        return (time.perf_counter() - t0) * 1e3

    return host_ms


def setup_program(name, build, seed, device=None, batch: int = BATCH_SOBEL,
                  full: bool = True):
    """The program `build()` on an image from seed `seed`, through
    compile, generate_keys on `device`, encrypt, execute and decrypt.
    Returns (measures, once, env): measures maps metric -> per-pass
    callable returning seconds (compute: one replay; with full, also
    `{name}_batched` in evals/s over a batch of `batch`, `{name}_with_io`
    the wall of one execute over HOST_REPS, `{name}_host` the numpy
    backend's execute); once holds the MSE, the first execute's seconds
    and, without full, the host ms measured once; env the objects the
    compile-cost section reuses."""
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    prog = build()
    compiled, params, sig = CKKSCompiler({"warn_vec_size": "false"}).compile(
        prog)
    rng = np.random.default_rng(seed)
    inputs = {"image": rng.uniform(0, 1, prog.vec_size).tolist()}
    ref = evaluate(prog, inputs)
    pub, sec = generate_keys(params, device=device)
    enc = pub.encrypt(inputs, sig)
    t0 = time.perf_counter()
    out = pub.execute(compiled, enc)  # warm-up, capture, replay
    first_s = time.perf_counter() - t0
    mse = valuation_mse(sec.decrypt(out, sig), ref)
    compute_ms = program_timer(pub, compiled, [enc])
    pub_h = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")

    def host() -> float:
        t0 = time.perf_counter()
        pub_h.execute(compiled, enc)
        return time.perf_counter() - t0

    measures = {name: lambda: compute_ms() / 1e3}
    once = {f"{name}_mse": mse, f"{name}_first_execute_s": round(first_s, 3)}
    if full:
        batch_ms = program_timer(pub, compiled, [enc] * batch)

        def with_io() -> float:
            _sync(pub.device)
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                pub.execute(compiled, enc)
            return (time.perf_counter() - t0) / HOST_REPS

        measures.update({f"{name}_batched": lambda: batch / (batch_ms()
                                                             / 1e3),
                         f"{name}_with_io": with_io, f"{name}_host": host})
    else:
        once[f"{name}_host_ms"] = round(host() * 1e3, 1)
        once[f"{name}_N"] = params.poly_modulus_degree
    env = {"compiled": compiled, "params": params, "pub": pub, "enc": enc}
    return measures, once, env


def setup_sobel(device=None, batch: int = BATCH_SOBEL):
    """bench.py's setup_sobel: Sobel 90x90 (seed 11), every measure."""
    return setup_program("sobel90", build_sobel, 11, device, batch)


def setup_harris(device=None):
    """bench.py's setup_harris: Harris 90x90 (seed 13), compute by
    passes, the host baseline once."""
    measures, once, _ = setup_program("harris", build_harris, 13, device,
                                      full=False)
    return measures, once


# -- per-kernel speed of light -----------------------------------------------


def measure_modmul_rate(dev, poly) -> tuple:
    """(modular multiplies a second, ms per launch): E4 (modmul_burn:
    modmath.BURN_K dependent Montgomery multiplies a word, by 3 and 5 in
    turn) on `poly`, chained, the counterpart of bench.py's
    measure_vpu_modmul."""
    from eva_tpu_torch.backend.modmath import BURN_K
    from eva_tpu_torch.backend.modmath_cuda import modmul_burn
    ms = Chain(lambda p: modmul_burn(dev, p), poly, ITERS_BURN).ms()
    return poly.numel() * BURN_K / (ms / 1e3), ms


def setup_kernel_sol(ctx, keys, device=None, batch: int = BATCH_ROT):
    """bench.py's setup_kernel_sol on the port: returns measure(out,
    rotation_s) filling out with hbm_gbs, vpu_modmul_gops (E4) and the
    int32 data-sheet rate in modular multiplies, then for each step
    {us, gbs, sol_pct, compute_pct} (bench.py's bytes and modmul
    models, 4-byte residues), the stage split and the rotation's row."""
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.backend.executor_torch import StructDigits
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.profiling import measure_hbm_roofline

    device = resolve_device(device)
    n = ctx.n
    level = 0
    primes = ctx.primes_at_level(level)
    n_cur = len(primes)
    n_key = len(ctx.key_primes)
    dev = level_ops(primes, n, device)
    poly = _planes(primes, n, batch, 3, device)
    plane_bytes = batch * n_cur * n * 4
    lg = int(math.log2(n))
    shim = rotation_shim(ctx, keys, device)

    n_ext = n_cur + n_key
    alpha = keys.ks_alpha
    n_groups = -(-n_cur // alpha)
    key_bytes = 2 * n_groups * n_ext * n * 4
    # digit stage: read n_cur planes, write n_groups*n_ext digit planes
    digit_bytes = batch * (n_cur + n_groups * n_ext) * n * 4
    # MAC+epilogue: read digit planes + keys once, write 2 output polys
    mac_bytes = batch * (n_groups * n_ext + 2 * n_cur) * n * 4 + key_bytes
    rot_bytes = batch * 4 * n_cur * n * 4 + key_bytes
    epi_bytes = batch * 2 * (n_ext + n_cur) * n * 4

    # Statically-known modmuls per ring element (x N x batch), per step.
    ntt_muls = n_cur * (lg / 2)
    intt_muls = n_cur * (lg / 2 + 1)  # + merged n^-1 twist row
    digit_muls = (intt_muls + n_cur  # input iNTT + y = d*inv
                  + n_groups * alpha * n_ext  # FBE products
                  + ((n_groups - 1) * n_cur + n_groups * n_key) * (lg / 2))
    mac_muls = 2 * (n_cur + (n_groups - 1) * n_cur + n_groups * n_key)
    epi_muls = 2 * (n_ext * (lg / 2 + 1)  # iNTT in the extended basis
                    + n_key * n_cur  # divide-and-round chain
                    + n_cur * (lg / 2))  # output NTT
    full_muls = digit_muls + mac_muls + epi_muls

    g = ctx.galois_elt(1)
    layout = shim.dkeys.layout(keys.galois[g], level)

    def digits_step(p):
        # The structured digit stage (iNTT, FBE, the foreign and key
        # rows' NTTs); own rows are the input planes themselves.
        return shim._ks_digits(p, level).own

    def apply_step(p):
        d0, d1 = shim._ks_apply(shim._ks_digits(p, level), level, layout)
        return dev.add(d0, d1)

    # Two-polynomial P-division epilogue (K5), chained on an
    # extended-basis accumulator block: its first n_cur rows are the
    # epilogue's outputs, the key rows pass through.
    ext_basis = primes + list(ctx.key_primes)
    acc0 = _planes(ext_basis, n, batch, 5, device)

    def epi_step(a):
        import torch
        d0, d1 = shim._ks_div2(a, a, level)
        return torch.cat([dev.add(d0, d1), a[..., n_cur:, :]], dim=-2)

    # MAC + P-division on precomputed digits: the own rows of each step
    # are perturbed by a bit of the previous outputs.
    dig0 = shim._ks_digits(poly, level)

    def mac_step(own):
        d = StructDigits(own, dig0.a, dig0.b, dig0.n_groups)
        d0, d1 = shim._ks_apply(d, level, layout)
        s = (d0[..., :1, :1] ^ d1[..., :1, :1]) & 1
        return own ^ s.expand(own.shape)

    steps = {
        "ntt_fwd": (dev.ntt, 2 * plane_bytes, ntt_muls, poly),
        "intt": (dev.intt, 2 * plane_bytes, intt_muls, poly),
        "ks_digits(intt+fbe+ntt)": (digits_step, digit_bytes, digit_muls,
                                    poly),
        "ks_epilogue(2xPdiv)": (epi_step, epi_bytes, epi_muls, acc0),
        "ks_full(digits+mac+pdiv)": (apply_step, digit_bytes + mac_bytes,
                                     full_muls, poly),
        "ks_mac+pdiv(direct)": (mac_step, mac_bytes + epi_bytes,
                                mac_muls + epi_muls, dig0.own),
    }
    chains = {name: Chain(fn, start, ITERS)
              for name, (fn, _, _, start) in steps.items()}

    def measure(out: dict, rotation_s: float = 0.0) -> dict:
        hbm = measure_hbm_roofline(device, HBM_BYTES)
        out["hbm_gbs"] = round(hbm / 1e9, 1)
        vpu, burn_ms = measure_modmul_rate(dev, poly)
        out["vpu_modmul_gops"] = round(vpu / 1e9, 1)
        out["vpu_modmul_ms"] = burn_ms
        # The data sheet's int32 rate (chip_smoke's bound) in Montgomery
        # multiplies of OPS_PER_MONT_MUL operations.
        out["datasheet_modmul_gops"] = round(
            INT32_OPS_PER_S / OPS_PER_MONT_MUL / 1e9, 1)
        for name, (_, nbytes, muls, _) in steps.items():
            per = chains[name].ms() / 1e3
            out[name] = {"us": round(per / batch * 1e6, 2),
                         "gbs": round(nbytes / per / 1e9, 1),
                         "sol_pct": round(100 * nbytes / per / hbm, 1),
                         "compute_pct": round(
                             100 * muls * batch * n / per / vpu, 1)}
            log(f"kernel {name}: {out[name]}")
        # Stage split (bench.py's): the MAC from the directly measured
        # mac+pdiv step minus the directly measured epilogue.
        dig = out["ks_digits(intt+fbe+ntt)"]["us"]
        epi = out["ks_epilogue(2xPdiv)"]["us"]
        full = out["ks_full(digits+mac+pdiv)"]["us"]
        mac_pdiv = out["ks_mac+pdiv(direct)"]["us"]
        out["ks_mac_epilogue_us"] = round(max(full - dig, 0.0), 2)
        mac = max(mac_pdiv - epi, 0.0)
        out["ks_mac_only_us"] = round(mac, 2)
        # Ratios only when the split is self-consistent (the MAC a
        # non-trivial share of mac+pdiv); else the raw numbers.
        if mac >= 0.05 * mac_pdiv:
            out["bsgs_cost_units"] = {
                "dec": round(dig / mac, 2), "mac": 1.0,
                "epi": round(epi / mac, 2)}
        else:
            out["bsgs_cost_units_unstable"] = {
                "dig_us": dig, "epi_us": epi, "mac_pdiv_us": mac_pdiv}
        if rotation_s:
            per_op_bytes = rot_bytes / batch
            out["rotation"] = {
                "us": round(rotation_s * 1e6, 2),
                "gbs": round(per_op_bytes / rotation_s / 1e9, 1),
                "sol_pct": round(100 * per_op_bytes / rotation_s / hbm, 1),
                "compute_pct": round(
                    100 * full_muls * n / rotation_s / vpu, 1)}
        return out

    return measure


# -- compile cost -------------------------------------------------------------


def measure_compile_cost(env, device) -> dict:
    """Sobel's cost before its first result. Cold: the nvcc build of the
    three kernel sources into an empty directory (one nvcc each, all
    started together, as cuda_lib.build_all; the CPU builds nothing),
    plus the first execute of a fresh public context (its executor, the
    eager warm-up, the capture and a replay). Warm: that first execute
    alone, with the libraries built."""
    from concurrent.futures import ThreadPoolExecutor

    from eva_tpu_torch.backend import cuda_lib, ks_cuda, modmath_cuda, ntt_cuda
    from eva_tpu_torch.runtime import EVAPublic

    pub, compiled, enc = env["pub"], env["compiled"], env["enc"]
    out = {"sobel_compile_cold_build_s": 0.0}
    if device.type == "cuda":
        scratch = os.path.join(cuda_lib.BUILD_DIR, f"cold_{os.getpid()}")
        os.makedirs(scratch)
        try:
            libs = (ntt_cuda, ks_cuda, modmath_cuda)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(libs)) as pool:
                list(pool.map(lambda lib: cuda_lib.build(
                    lib.SOURCE, os.path.join(
                        scratch, os.path.basename(lib.LIB_PATH))), libs))
            out["sobel_compile_cold_build_s"] = round(
                time.perf_counter() - t0, 2)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)

    def first_execute() -> float:
        fresh = EVAPublic(pub.ctx, pub._keys, env["params"],
                          device=pub.device)
        _sync(pub.device)
        t0 = time.perf_counter()
        fresh.execute(compiled, enc)
        return time.perf_counter() - t0

    cold_exec = first_execute()
    out["sobel_compile_cold_execute_s"] = round(cold_exec, 3)
    out["sobel_compile_cold_s"] = round(
        out["sobel_compile_cold_build_s"] + cold_exec, 2)
    out["sobel_compile_warm_s"] = round(first_execute(), 3)
    return out


# -- the line -----------------------------------------------------------------


def assemble(samples: dict, once: dict, passes: int) -> dict:
    """bench.py's _emit: the line from the per-metric samples (medians,
    samples, spreads) and the values taken once."""
    ct_mul = _med(samples.get("ct_mul", []))
    ct_mul_host = once.get("ct_mul_host_per_sec", 0.0)
    extras = dict(once)
    extras["passes"] = passes
    extras["ct_mul_per_sec"] = round(ct_mul, 2)
    for key, scale, unit in SAMPLED:
        got = samples.get(key, [])
        if got:
            extras[f"{key}_{unit}"] = round(_med(got) * scale, 4)
            extras[f"{key}_samples_{unit}"] = [round(s * scale, 4)
                                               for s in got]
            extras[f"{key}_spread"] = round(_spread(got), 3)
    return {
        "metric": "ckks_ct_mul_throughput_N16384_L6",
        "value": round(ct_mul, 2),
        "unit": "mults/s/chip",
        "vs_baseline": round(ct_mul / ct_mul_host, 2) if ct_mul_host else 0.0,
        "extras": extras,
    }


def run(device=None, n: int = N, levels: int = L, batch: tuple = BATCHES,
        passes: int = PASSES) -> dict:
    """Every section on `device` (None: the CUDA device) at ring n with
    `levels` data entries, the batches `batch` (ct-mul, rotation and
    kernel_sol, batched Sobel): pass 1 in bench.py's order, then passes
    2..passes interleaved over the device metrics, then kernel_sol and
    the compile cost; returns the line."""
    import torch
    from eva_tpu_torch.backend import resolve_device
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.native import get_lib

    device = resolve_device(device)
    on_card = device.type == "cuda"
    log(f"device={device} N={n} L={levels} passes={passes}")
    once = {
        "baseline": ("measured single-thread host backend of the port "
                     "(eva_tpu_torch.crypto: numpy"
                     + (" + its C++ NTT" if get_lib() is not None else "")
                     + ", the algorithms SEAL runs) on this machine"),
        "device_backend": "cuda" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
        "card": card_line() if on_card else None,
        "timing": TIMING if on_card else "host clock (the CPU)",
        "torch": torch.__version__,
    }
    ctx = bench_context(n, levels)
    keys = K.generate_keys(ctx)
    samples: dict = {}

    def sample(name, fn):
        v = fn()
        samples.setdefault(name, []).append(v)
        log(f"{name} pass {len(samples[name])}: {v:.6g}")

    batch_ct, batch_rot, batch_sobel = batch
    measures = {"ct_mul": setup_ct_mul(device, n, levels, batch_ct)}
    sample("ct_mul", measures["ct_mul"])
    once["ct_mul_host_per_sec"] = round(bench_ct_mul_host(ctx), 2)

    measures["rotation"] = setup_rotation(ctx, keys, device, batch_rot)
    sample("rotation", measures["rotation"])
    rot_host = bench_rotation_host(ctx, keys)
    once["rotation_host_us"] = round(rot_host * 1e6, 1)

    sobel_measures, sobel_once, sobel_env = setup_sobel(device, batch_sobel)
    once.update(sobel_once)
    measures.update(sobel_measures)
    for name, fn in sobel_measures.items():
        sample(name, fn)

    harris_measures, harris_once = setup_harris(device)
    once.update(harris_once)
    measures.update(harris_measures)
    sample("harris", harris_measures["harris"])

    for _ in range(2, passes + 1):
        for name, fn in measures.items():
            sample(name, fn)

    once["rotation_vs_host"] = round(rot_host / _med(samples["rotation"]), 2)
    once["sobel90_vs_host"] = round(
        _med(samples["sobel90_host"]) / _med(samples["sobel90"]), 2)
    once["harris_vs_host"] = round(
        once["harris_host_ms"] / 1e3 / _med(samples["harris"]), 2)

    sol = once.setdefault("kernel_sol", {})
    setup_kernel_sol(ctx, keys, device, batch_rot)(
        sol, _med(samples["rotation"]))
    once.update(measure_compile_cost(sobel_env, device))
    log(f"compile cold {once['sobel_compile_cold_s']} s, warm "
        f"{once['sobel_compile_warm_s']} s")
    return assemble(samples, once, passes)


def mse_failures(line: dict) -> list:
    """The programs whose MSE is at or above MSE_LIMIT."""
    limits = {"sobel90": MSE_LIMIT["sobel"], "harris": MSE_LIMIT["harris"]}
    return [f"{k}_mse {line['extras'][f'{k}_mse']} >= {v}"
            for k, v in limits.items()
            if not line["extras"][f"{k}_mse"] < v]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; this "
              "benchmark runs only on a CUDA GPU", file=sys.stderr)
        return 2
    line = run()
    print(json.dumps(line), flush=True)
    bad = mse_failures(line)
    if bad:
        print(f"bench_torch: FAILED: {'; '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
