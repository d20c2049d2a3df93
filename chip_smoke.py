#!/usr/bin/env python3
"""Drive the eva_tpu_torch port on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. Card: print the card's name and power limit, build the CUDA kernel
     libraries from eva_tpu_torch/csrc with nvcc (sm_90a), one nvcc per
     source, all started together.
  2. Kernels: each kernel against its plain PyTorch version on the card,
     on random reduced residues from a fixed seed; equality by
     torch.equal (exact modular arithmetic: the tolerance is zero).
     NTT: at the main path's shape [4, 13, 16384] (Sobel's 11 data
     primes + 2 key primes) and at N = 1024, 2048, 32768. Fused key
     switch (MAC, epilogue): at Sobel's level-0 shapes (n_cur 11, n_key
     2, alpha 2) at B = 1 and 4, with and without x_ntt, out_ntt True
     and False, and at N = 1024 and 32768. Device times by CUDA events
     around CUDA-graph replays; eager per-call times beside them.
  3. Main path: Sobel and Harris 90x90 (N=16384) through compile ->
     generate_keys (the card) -> encrypt -> execute -> decrypt, on the
     fused key switch. The output ciphertexts must be bit-identical to
     the port's numpy backend on the same keys and inputs, the
     decryption must match the plaintext reference, and every kernel of
     the path must have been launched (launch counts > 0, plain-version
     calls == 0). `execute` is timed as the median of 5 warm runs. Sobel
     runs once more with EVA_TPU_NO_FUSED_KS=1 (the structured key
     switch) under the same checks; one line compares the two. Then
     execute_batch of 4 Sobel requests and execute_pipelined over 8,
     each output bit-identical to its own sequential execute, with the
     key-switch kernels launched at batch 4.
  4. One JSON line of kernel numbers, then the device line last.

Imports nothing of JAX and nothing of the JAX package eva_tpu."""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20260
# H100 SXM peaks: HBM3 3.35 TB/s (NVIDIA data sheet); 32-bit integer
# ALU throughput 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12
# ops/s (Hopper architecture white paper: 64 INT32 units per SM).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer ops per radix-2 butterfly of the modular arithmetic alone:
# Shoup multiply (mulhi, 2 mul-lo, sub, compare+select: 6), add_mod (4),
# sub_mod (4).
OPS_PER_BUTTERFLY = 14
# 32-bit Montgomery multiply: 64-bit product (2), m = lo * nqinv (1),
# m * q (2), 64-bit add (2), compare + select (2). add_mod: 4. One
# divide-and-round step per residue: add, Shoup multiply (6), sub_mod (4),
# compare: 12.
OPS_PER_MONT_MUL = 9
OPS_PER_ADD_MOD = 4
OPS_PER_DIVIDE = 12
SOBEL_BITS = [60, 20, 60, 60, 60, 60, 60]
# Decrypted MSE against the plaintext reference. Sobel's is ~1e-14.
# Harris's outputs reach ~1e4 and its MSE varies with the keys: over 48
# fresh key sets it ran 2.9e-4 (min), 4.1e-4 (median), 1.3e-3 (max)
# (`python3 mse_draws.py harris 48`, host numpy backend, whose
# ciphertexts equal the card's). The limit is about 4x that max.
MSE_LIMIT = {"sobel": 1e-6, "harris": 5e-3}


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


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn over `iters` back-to-back eager calls,
    between CUDA events: what a caller pays per call today, host launch
    overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Device ms per call of fn: `iters` calls captured in one CUDA graph
    and replayed `reps` times between CUDA events, so no host launch gap
    separates the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(byts: int, ops: int):
    """(ms, "bytes" | "operations"): the larger of the two least times."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_ops(rows: int, n: int) -> int:
    """N/2 log2 N butterflies per row at OPS_PER_BUTTERFLY ops each."""
    return rows * (n // 2) * int(math.log2(n)) * OPS_PER_BUTTERFLY


def ntt_bound_ms(rows: int, n: int, n_sub: int):
    """Least time for one NTT launch: int64 rows read and written once,
    the uint32 Shoup twiddle pair table read once; ntt_ops."""
    return bound(rows * n * 8 * 2 + n_sub * n * 4 * 2, ntt_ops(rows, n))


def kernel_phase(device):
    """Phase 2: the NTT kernels against their plain version; returns the
    per-kernel numbers at the main path's shape."""
    import torch
    from eva_tpu_torch.backend import ntt_cuda
    from eva_tpu_torch.backend.tables import DeviceLevelOps
    from eva_tpu_torch.crypto.context import get_context

    results = {}
    for n, batch in ((16384, 4), (1024, 4), (2048, 4), (32768, 2)):
        ctx = get_context(tuple(SOBEL_BITS), (), n, 1)
        primes = list(ctx.all_primes)
        ops = DeviceLevelOps(primes, n, device)
        rng = np.random.default_rng(SEED + n)
        x = torch.from_numpy(np.stack(
            [rng.integers(0, q, (batch, n)) for q in primes], axis=1)
        ).to(device)
        f_k = ntt_cuda.ntt_fwd(x, ops)
        f_p = ops._fwd_merged(x)
        i_k = ntt_cuda.ntt_inv(f_k, ops)
        i_p = ops._inv_merged(f_k)
        torch.cuda.synchronize()
        checks = {"fwd": torch.equal(f_k, f_p), "inv": torch.equal(i_k, i_p),
                  "roundtrip": torch.equal(i_k, x)}
        print(f"kernels N={n} shape={list(x.shape)} primes={len(primes)} "
              f"{checks}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"NTT kernel disagrees at N={n}: {checks}")
        rows = x.numel() // n
        bms, bby = ntt_bound_ms(rows, n, len(primes))
        for name, kern, plain, arg, got, want in (
                ("ntt_fwd", ntt_cuda.ntt_fwd, ops._fwd_merged, x, f_k, f_p),
                ("ntt_inv", ntt_cuda.ntt_inv, ops._inv_merged, f_k, i_k,
                 i_p)):
            res = {"shape": list(arg.shape),
                   "ms": graph_ms(lambda: kern(arg, ops), 50),
                   "eager_ms": eager_ms(lambda: kern(arg, ops), 200),
                   "plain_ms": graph_ms(lambda: plain(arg), 5, reps=3),
                   "bound_ms": bms, "bound_by": bby,
                   "max_abs_err": int((got - want).abs().max().item())}
            print(f"kernel {name} N={n} " + json.dumps(res), flush=True)
            if n == 16384:  # the main path's ring size
                results[name] = res
    return results


def mac_bound_ms(y, x_ntt, k0, n_ext: int, n: int):
    """Least time for one ks_mac launch. Bytes: y, x_ntt and both key
    stacks read once, both accumulators written once (int64), the
    forward twiddle pairs (uint32) read once. Operations: the FBE of
    every (b, i, j) row the kernel must transform (all but the n_cur own
    rows when x_ntt is given), its NTT, and the MAC of every (b, i, j)."""
    batch, n_groups, alpha = y.shape[:3]
    own = x_ntt.shape[1] if x_ntt is not None else 0
    byts = 8 * (y.numel() + (x_ntt.numel() if x_ntt is not None else 0)
                + 2 * k0.numel() + 2 * batch * n_ext * n) + 8 * n_ext * n
    fbe_rows = batch * (n_ext * n_groups - own)
    ops = (ntt_ops(fbe_rows, n)
           + fbe_rows * n * alpha * (OPS_PER_MONT_MUL + OPS_PER_ADD_MOD)
           + batch * n_ext * n_groups * n * 2
           * (OPS_PER_MONT_MUL + OPS_PER_ADD_MOD))
    return bound(byts, ops)


def epilogue_bound_ms(batch: int, n_ext: int, n_key: int, n: int,
                      out_ntt: bool):
    """Least time for one ks_epilogue call. Bytes: both accumulators read
    and both outputs written once (int64), inverse (and forward) twiddle
    pairs read once. Operations: the inverse NTT of 2B n_ext rows, the
    n_key division steps over the rows each leaves, the forward NTT of
    2B n_out rows with out_ntt."""
    n_out = n_ext - n_key
    byts = (8 * 2 * batch * (n_ext + n_out) * n
            + 8 * n * (n_ext + (n_out if out_ntt else 0)))
    div_rows = sum(n_ext - 1 - d for d in range(n_key))
    ops = 2 * batch * (ntt_ops(n_ext, n) + div_rows * n * OPS_PER_DIVIDE
                       + (ntt_ops(n_out, n) if out_ntt else 0))
    return bound(byts, ops)


def ks_kernel_phase(device):
    """Phase 2, fused key switch: ks_mac and ks_epilogue against their
    plain versions at Sobel's level-0 shapes (N=16384, B = 1 and 4, every
    option) and at N = 1024 and 32768; returns the numbers of the shapes
    one execute launches (B=1, with x_ntt / out_ntt) and those at B=4."""
    import torch
    from eva_tpu_torch.backend import ks, ks_cuda
    from eva_tpu_torch.backend.executor_torch import _ks_dev_tables, _ks_maps
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    results = {}
    level, alpha = 0, 2
    for n, batches in ((16384, (1, 4)), (1024, (4,)), (32768, (1,))):
        ctx = get_context(tuple(SOBEL_BITS), (), n, 1)
        primes = ctx.primes_at_level(level)
        basis = primes + list(ctx.key_primes)
        n_cur, n_key, n_ext = len(primes), len(ctx.key_primes), len(basis)
        ext = level_ops(basis, n, device)
        n_groups, _, conv_mont = _ks_dev_tables(ctx, level, alpha)
        _, owner, _ = _ks_maps(ctx, level, alpha)
        conv = torch.from_numpy(conv_mont[..., 0].astype(np.int64)).to(
            device)
        own = torch.from_numpy(np.concatenate(
            [owner, [-1] * n_key]).astype(np.int64)).to(device)
        for batch in batches:
            rng = np.random.default_rng(SEED + n + batch)

            def planes(lead, qs):
                return torch.from_numpy(np.stack(
                    [rng.integers(0, q, lead + (n,)) for q in qs],
                    axis=len(lead))).to(device)

            y = np.zeros((batch, n_groups * alpha, n), dtype=np.int64)
            for t, q in enumerate(primes):
                y[:, t] = rng.integers(0, q, (batch, n))
            y = torch.from_numpy(y).reshape(batch, n_groups, alpha, n).to(
                device)
            k0, k1 = (torch.stack([planes((), basis)
                                   for _ in range(n_groups)])
                      for _ in range(2))
            x_ntt = planes((batch,), primes)
            acc0, acc1 = planes((batch,), basis), planes((batch,), basis)
            shape = f"N={n} B={batch} n_cur={n_cur} n_key={n_key} " \
                    f"alpha={alpha}"
            for xn in (x_ntt, None):
                got = ks_cuda.ks_mac(y, k0, k1, conv, own, ext, xn)
                want = ks.ks_mac_plain(y, k0, k1, conv, own, ext, xn)
                torch.cuda.synchronize()
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"kernels ks_mac {shape} x_ntt={xn is not None} "
                      f"equal={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"ks_mac disagrees: {shape}")
                if n != 16384 or xn is None:
                    continue
                bms, bby = mac_bound_ms(y, xn, k0, n_ext, n)
                res = {
                    "shape": shape + " x_ntt=True",
                    "ms": graph_ms(lambda: ks_cuda.ks_mac(
                        y, k0, k1, conv, own, ext, xn), 20),
                    "eager_ms": eager_ms(lambda: ks_cuda.ks_mac(
                        y, k0, k1, conv, own, ext, xn), 50),
                    "plain_ms": graph_ms(lambda: ks.ks_mac_plain(
                        y, k0, k1, conv, own, ext, xn), 2, reps=3),
                    "bound_ms": bms, "bound_by": bby,
                    "max_abs_err": max(int((g - w).abs().max().item())
                                       for g, w in zip(got, want))}
                print(f"kernel ks_mac B={batch} " + json.dumps(res),
                      flush=True)
                results[("ks_mac", batch)] = res
            for out_ntt in (True, False):
                got = ks_cuda.ks_epilogue(acc0, acc1, ext, n_key, out_ntt)
                want = ks.ks_epilogue_plain(acc0, acc1, ext, n_key, out_ntt)
                torch.cuda.synchronize()
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"kernels ks_epilogue {shape} out_ntt={out_ntt} "
                      f"equal={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"ks_epilogue disagrees: {shape}")
                if n != 16384 or not out_ntt:
                    continue
                bms, bby = epilogue_bound_ms(batch, n_ext, n_key, n, True)
                res = {
                    "shape": shape + " out_ntt=True",
                    "ms": graph_ms(lambda: ks_cuda.ks_epilogue(
                        acc0, acc1, ext, n_key, True), 20),
                    "eager_ms": eager_ms(lambda: ks_cuda.ks_epilogue(
                        acc0, acc1, ext, n_key, True), 50),
                    "plain_ms": graph_ms(lambda: ks.ks_epilogue_plain(
                        acc0, acc1, ext, n_key, True), 2, reps=3),
                    "bound_ms": bms, "bound_by": bby,
                    "max_abs_err": max(int((g - w).abs().max().item())
                                       for g, w in zip(got, want))}
                print(f"kernel ks_epilogue B={batch} " + json.dumps(res),
                      flush=True)
                results[("ks_epilogue", batch)] = res
    return results


COUNTERS = ("ntt_launches", "plain_calls", "ks_launches", "ks_plain_calls",
            "ks_max_batch")


def _counters():
    from eva_tpu_torch.backend import ks, ks_cuda, ntt_cuda, tables
    return (ntt_cuda.LAUNCHES, tables.PLAIN_CALLS, ks_cuda.LAUNCHES,
            ks.PLAIN_CALLS, ks_cuda.MAX_BATCH)


def reset_counts():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_counts():
    """{counter name: {kernel: count}} (see COUNTERS)."""
    return {name: dict(c) for name, c in zip(COUNTERS, _counters())}


def check_counts(name, counts, fused: bool):
    """Every kernel of the path launched, no plain version called; on the
    structured path (fused False) no key-switch kernel either."""
    ntt, ksl = counts["ntt_launches"], counts["ks_launches"]
    plain = {**counts["plain_calls"], **counts["ks_plain_calls"]}
    ok = min(ntt.values()) > 0 and not any(plain.values()) and (
        min(ksl.values()) > 0 if fused else not any(ksl.values()))
    if not ok:
        raise AssertionError(f"{name}: counts {counts}")


def check_equal(name, want, got):
    """Output ciphertexts bit-identical, output by output."""
    for k in want:
        for a, b in zip(want[k].polys, got[k].polys):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: ciphertext {k} differs")


def execute_ms(pub, compiled, enc, reps: int):
    """Wall ms of `reps` warm executes (each ends in a device->host
    copy)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pub.execute(compiled, enc)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def run_program(name, build, seed, device, reps=5):
    """Phase 3 for one program: the user's path on `device` (None: the
    CUDA device), with the kernel counts reset just before it and read
    just after; then the checks against the port's numpy backend and the
    plaintext reference, and the warm execute times."""
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    rng = np.random.default_rng(seed)
    reset_counts()
    t0 = time.perf_counter()
    prog = build()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    t_compile = time.perf_counter() - t0
    inputs = {"image": rng.uniform(0, 1, prog.vec_size).tolist()}
    t0 = time.perf_counter()
    pub, sec = generate_keys(params, device=device)
    t_keygen = time.perf_counter() - t0
    enc = pub.encrypt(inputs, sig)
    t0 = time.perf_counter()
    out = pub.execute(compiled, enc)
    t_first = time.perf_counter() - t0
    dec = sec.decrypt(out, sig)
    counts = read_counts()

    ref_out = EVAPublic(pub.ctx, pub._keys, params,
                        backend="numpy").execute(compiled, enc)
    check_equal(f"{name} against the numpy backend", ref_out, out)
    ref = evaluate(prog, inputs)
    mse = valuation_mse(dec, ref)
    ref_ms = float(np.mean([np.mean(np.square(v)) for v in ref.values()]))
    times = execute_ms(pub, compiled, enc, reps)
    return {
        "N": params.poly_modulus_degree, "prime_bits": list(params.prime_bits),
        "rotations": len(params.rotations),
        "alpha": pub._keys.ks_alpha, "key_primes": len(pub.ctx.key_primes),
        **counts,
        "compile_s": t_compile, "keygen_s": t_keygen,
        "first_execute_s": t_first, "mse": mse, "ref_mean_square": ref_ms,
        "execute_ms_median": statistics.median(times),
        "execute_ms_all": times,
    }, (compiled, pub, enc, sig, ref_out)


KS_KERNELS = ("ks_mac_kernel", "ks_key_intt_kernel", "ks_epilogue_kernel")


def profile_execute(name, pub, compiled, enc, top: int = 10):
    """Device time by kernel for one warm execute (torch.profiler): a dict
    of device ms, NTT and key-switch kernel ms, wall ms under the
    profiler and device op count (None when the profiler recorded no
    device time); prints the `top` entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pub.execute(compiled, enc)
        wall = (time.perf_counter() - t0) * 1e3
    # Device-side entries only (kernels, copies): the CPU-side aten ops
    # carry the same device time again as their children's.
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    for us, count, key in rows[:top]:
        print(f"profile {name} {us / 1e3:9.3f} ms {count:6d}  {key[:100]}")
    if not rows:
        return None

    def ms(names):
        return sum(r[0] for r in rows if any(k in r[2] for k in names)) / 1e3

    return {"device_ms": sum(r[0] for r in rows) / 1e3,
            "ntt_ms": ms(("ntt_fwd_kernel", "ntt_inv_kernel")),
            "ks_ms": ms(KS_KERNELS),
            "ks_kernel_launches": {k: sum(r[1] for r in rows if k in r[2])
                                   for k in KS_KERNELS},
            "wall_ms": wall, "device_ops": sum(r[1] for r in rows)}


def structured_run(pub, compiled, enc, ref_out, reps=5):
    """Sobel again with EVA_TPU_NO_FUSED_KS=1: the structured key switch,
    held to the numpy backend, with no key-switch kernel launched."""
    os.environ["EVA_TPU_NO_FUSED_KS"] = "1"
    reset_counts()
    out = pub.execute(compiled, enc)
    counts = read_counts()
    check_counts("sobel structured", counts, fused=False)
    check_equal("sobel structured against the numpy backend", ref_out, out)
    times = execute_ms(pub, compiled, enc, reps)
    prof = profile_execute("sobel_structured", pub, compiled, enc)
    del os.environ["EVA_TPU_NO_FUSED_KS"]
    return {**counts, "execute_ms_median": statistics.median(times),
            "execute_ms_all": times, "profile": prof}


def batch_phase(pub, compiled, sig, seed, reps=3):
    """execute_batch of 4 Sobel requests and execute_pipelined over 8,
    each output bit-identical to its own sequential execute; the
    key-switch kernels must have launched at batch 4."""
    import torch
    rng = np.random.default_rng(seed)
    encs = [pub.encrypt({"image": rng.uniform(0, 1, sig.vec_size).tolist()},
                        sig) for _ in range(8)]
    seq, seq_ms = [], []
    for enc in encs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq.append(pub.execute(compiled, enc))
        seq_ms.append((time.perf_counter() - t0) * 1e3)

    reset_counts()
    outs = pub.execute_batch(compiled, encs[:4])
    batch_counts = read_counts()
    check_counts("sobel batch", batch_counts, fused=True)
    if set(batch_counts["ks_max_batch"].values()) != {4}:
        raise AssertionError(f"sobel batch: key-switch kernels launched at "
                             f"batch {batch_counts['ks_max_batch']}, not 4")
    for b, (o, s) in enumerate(zip(outs, seq)):
        check_equal(f"sobel batch element {b}", s, o)
    batch_ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pub.execute_batch(compiled, encs[:4])
        batch_ms.append((time.perf_counter() - t0) * 1e3)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(pub.execute_pipelined(compiled, encs))
    pipe_ms = (time.perf_counter() - t0) * 1e3
    pipe_counts = read_counts()
    check_counts("sobel pipelined", pipe_counts, fused=True)
    if len(outs) != len(seq):
        raise AssertionError(f"sobel pipelined: {len(outs)} outputs")
    for k, (o, s) in enumerate(zip(outs, seq)):
        check_equal(f"sobel pipelined request {k}", s, o)
    return {
        "batch4": {**batch_counts, "ms_per_batch_median":
                   statistics.median(batch_ms), "ms_per_batch_all": batch_ms,
                   "ms_per_request": statistics.median(batch_ms) / 4},
        "pipelined8": {**pipe_counts, "ms_total": pipe_ms,
                       "ms_per_request": pipe_ms / len(encs)},
        "sequential8": {"ms_per_request_median": statistics.median(seq_ms),
                        "ms_all": seq_ms}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from concurrent.futures import ThreadPoolExecutor

    from eva_tpu_torch.backend import ks_cuda, ntt_cuda

    # -- 1. the card and the build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = (ntt_cuda, ks_cuda)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(verbose=True), libs))
    print(f"build_s {time.perf_counter() - t0:.2f} (nvcc sm_90a, in "
          f"parallel: {', '.join(os.path.relpath(lib.SOURCE, root) for lib in libs)})",
          flush=True)

    # -- 2. kernels against their plain version ------------------------------
    kern = kernel_phase(device)
    kern.update(ks_kernel_phase(device))

    # -- 3. the main path ----------------------------------------------------
    paths = {}
    for name, build, seed in (("sobel", build_sobel, 11),
                              ("harris", build_harris, 13)):
        res, (compiled, pub, enc, sig, ref_out) = run_program(
            name, build, seed, None)
        check_counts(name, res, fused=True)
        if not res["mse"] < MSE_LIMIT[name]:
            raise AssertionError(f"{name}: MSE {res['mse']} >= "
                                 f"{MSE_LIMIT[name]}")
        res["profile"] = profile_execute(name, pub, compiled, enc)
        paths[name] = res
        print(f"path {name} " + json.dumps(res), flush=True)
        if name == "sobel":
            sobel = (compiled, pub, enc, sig, ref_out)

    compiled, pub, enc, sig, ref_out = sobel
    structured = structured_run(pub, compiled, enc, ref_out)
    print("path sobel_structured " + json.dumps(structured), flush=True)

    def summary(res):
        prof = res["profile"] or {}
        return {"execute_ms_median": res["execute_ms_median"],
                "device_ms": prof.get("device_ms"),
                "device_ops": prof.get("device_ops")}

    print("fused_vs_structured sobel " + json.dumps(
        {"fused": summary(paths["sobel"]),
         "structured": summary(structured)}), flush=True)
    batch = batch_phase(pub, compiled, sig, 17)
    print("path sobel_batch " + json.dumps(batch), flush=True)
    paths["sobel_batch4"] = batch["batch4"]
    paths["sobel_pipelined8"] = batch["pipelined8"]

    # -- 4. the kernel line, then the device line ----------------------------
    kernels = []
    for name, counter, source, replaces, also in (
            ("ntt_fwd", "ntt_launches", "ntt.cu",
             "pallas_ntt.py:310", "pallas_ntt_v2.py:190"),
            ("ntt_inv", "ntt_launches", "ntt.cu",
             "pallas_ntt.py:326", "pallas_ntt_v2.py:205"),
            ("ks_mac", "ks_launches", "ks.cu", "pallas_ks.py:68", None),
            ("ks_epilogue", "ks_launches", "ks.cu", "pallas_ks.py:145",
             None)):
        k = kern[name] if name in kern else kern[(name, 1)]
        entry = {
            "name": name, "route": "cuda",
            "source": f"eva_tpu_torch/csrc/{source}",
            "replaces": f"eva_tpu/backend/{replaces}",
            "launches": paths["sobel"][counter][name],
            "launches_by_path": {p: paths[p][counter][name] for p in paths},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "eager_ms": k["eager_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "shape": k["shape"]}
        if also:
            entry["also_replaces"] = f"eva_tpu/backend/{also}"
        if (name, 4) in kern:
            entry["batch4"] = {f: kern[(name, 4)][f] for f in (
                "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                "bound_by")}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
