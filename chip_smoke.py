#!/usr/bin/env python3
"""Drive the eva_tpu_torch port on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. Card: print the card's name and power limit, build the CUDA kernel
     libraries from eva_tpu_torch/csrc with nvcc (sm_90a), one nvcc per
     source (ntt.cu, ks.cu, modmath.cu), all started together.
  2. Kernels: each kernel against its plain PyTorch version on the card,
     on random reduced residues from a fixed seed (int32 tensors of
     uint32 bits); equality by torch.equal (exact modular arithmetic:
     the tolerance is zero).
     NTT: at NTT_SHAPES, the main path's shapes at N = 16384 ([11],
     [13], [2] and [4, 13] rows: Sobel's level 0 at batch 1, data plus
     key primes, a deep level, a batch of 4; [6, 13] and [4, 10]:
     keygen's one launch per key at Sobel's and Harris's contexts) and
     N = 1024, 2048, 32768,
     each at the cluster size the kernel library picks and at every size
     it can be forced to (1 to 8 blocks a row); the NTT kernels'
     registers, spill bytes and clusters held are printed first. Fused key
     switch (MAC, epilogue), with and without x_ntt, out_ntt True and
     False, at KS_SHAPES: Sobel's level 0 (n_cur 11, n_key 2, alpha 2:
     six digit groups) at B = 1, 4 and 3, Harris's level 0 (four
     groups), alpha 1 at Sobel's level 0 (11 groups: a cluster rank
     walks two digits), Sobel's deepest level (one group), a context
     with one key prime, and Sobel's level 0 at N = 1024 and 32768.
     The key-switch kernels' registers, spill bytes and the clusters the
     card holds at once are printed first. Elementwise kernels
     (modmath_kernel_phase), with their registers and spills first: E1's
     single form (every op: add, sub, neg, mul_mont, mul, shoup; the
     second operand full, a plaintext shared by the batch, a per-row
     constant; an unreduced first operand for the multiplies; a strided
     first operand), its several-planes form (mul, add, sub, neg over a
     rotation sum's c0, c1, acc0, acc1 in one launch, with a shared
     plaintext, a strided plane and a zero) and E2 (the tensor product)
     at Sobel's level 0 (B = 1 and 4) and Harris's; E1's MAC form (the
     structured key switch's inner product) at MAC_SHAPES (Sobel's and
     Harris's hoisted rotations at B = 1 and 4, alpha 1, one digit group,
     strided digits); E3 (every prime and polynomial of a rescale in one
     launch, with an addend) at E3_SHAPES; E1 reading a strided
     operand in place (one device operation, the kernel: no copy); and
     E4 (modmul_burn: 16 dependent Montgomery multiplies a word,
     bench_torch.py's modular-multiply rate probe) at BURN_SHAPES.
     Device times by CUDA events around CUDA-graph replays; eager
     per-call times beside them; a bound for each timed shape.
  3. Keygen: the key-switching-key arithmetic (DeviceKeygen, K1 at
     [groups, n_all, N]) against the host loop on seeded randomness at
     Sobel's and Harris's contexts, byte-identical, ms per key each way;
     generate_keys seconds with the host loop and on the card, each
     split into that arithmetic (_ksk_compute) and the rest (sampling).
     Main path: Sobel and Harris 90x90 (N=16384) through compile ->
     generate_keys (the card: counted apart, one K1 launch per key) ->
     encrypt -> execute -> decrypt, on the
     fused key switch. `execute` runs each program as one captured CUDA
     graph: its first call warms up eagerly, captures and replays, every
     later call replays. The output ciphertexts must be bit-identical to
     the port's numpy backend on the same keys and inputs, the
     decryption must match the plaintext reference, every output plane
     of the graph must be int32, and every kernel of the path must have
     been launched (K1, K2, K4, K5, E1 in each of its three forms, E2,
     E3: launch counts > 0;
     plain-version calls of every kernel, modmath's included, == 0; a
     replay adds the launches its capture counted; keygen: one K1 and
     five E1 launches per key).
     `execute` is timed as the median of 5 warm runs; one more execute
     counts the NTT launches by row count. Then, for each program, the
     captured execute against the eager one (the private switch
     TorchProgram._capture off), and the device ms of one replay (CUDA
     events around back-to-back replays): bit-identical outputs, both wall
     medians, the device busy time, idle share and device ops of one
     replayed and one eager execute under torch.profiler (device ms by
     kernel class, and by elementwise kernel and form; the replay's
     kernel launches by name, and the eager execute's launch counters,
     must equal the counts of the capture); the capture's seconds and
     graph pool bytes; and the host time of one replayed execute by
     step. Sobel runs once more with
     EVA_TPU_NO_FUSED_KS=1 (the structured key switch, its own graph)
     under the same checks; one line compares the two. Sobel 128x128
     (vec_size 16384 at N=16384: two shards, sharded rotations) runs
     under the same checks and its own MSE limit. Then, all through
     graphs, execute_batch of 4 Sobel requests and execute_pipelined
     over 8, each output bit-identical to its own sequential execute,
     with the key-switch kernels launched at batch 4. Then the mesh
     phase (mesh_phase): a one-rank NCCL world; execute_batch of 4 Sobel
     requests on a (batch 1, limb 1) mesh, bit-identical to the batch
     without a mesh, through the captured program (K1, K2, K4, K5
     launched, counted as path sobel_mesh; no plain version), both timed
     in turns; ShardedKeySwitch and ShardedNTT at one shard against the
     fused key switch and K1, eagerly and as graph replays; the one-rank
     collective overhead; the digit-parallel, seq and dp+seq programs
     forced on the same mesh (TorchProgram._force_plan), each replayed
     from its captured graph with its NCCL collectives inside, over two
     batches bit-identical to the batch without a mesh and to its own
     eager run, captured and eager timed in turns (counted as paths
     sobel_mesh_dp, sobel_mesh_seq and sobel_mesh_dp_seq: only the
     kernels of each plan, no plain version); with more than one card,
     Sobel on {batch, limb} and {seq} meshes of one rank per card
     against one card, each plan through a captured graph (this
     script's --mesh-rank processes, waited for). Then
     eva_tpu_torch.profiling: the measured HBM roofline, profile()'s
     table and calibration, and estimate_program for each program beside
     its captured execute and device busy time. Then the fuzz phase
     (fuzz_phase): FUZZ_PROGRAMS random programs of tools/fuzz_cuda.py
     (N = 8192, 16384, 32768 in turn; every rescaler, security level,
     key-switch route and alpha) and every program of the reference's
     matrices (tests/test_he.py, tests/test_large.py: N = 4096 to 16384)
     through generate_keys, encrypt, execute (a captured graph, then a
     replay) and decrypt on the card, each bit-identical to the numpy
     backend (residues, level) and to the plain versions on the CPU
     (residues, level, scale), its decryption within MSE 0.01; one
     `fuzz {...}` line (counts by N, route, alpha and rescaler, failures,
     seconds, peak reserved memory); its counts appear as
     launches_by_path["fuzz"]. Then the protocol phase
     (protocol_phase): the 4-role protocol of examples/serialization.py
     for Sobel 90x90 (seed 11) through files in a temporary directory,
     saved and loaded by eva_tpu_torch's own wire codec (no protobuf):
     here, compile, save the program, parameters and signature, load the
     parameters, generate_keys on the card, save both contexts, encrypt
     and save the inputs; then the server as `chip_smoke.py --serve DIR`,
     a process of its own (exit 0 required): it loads the program,
     signature, public context (on cuda:0) and inputs, executes twice
     (capture, then a replay with the counts reset just before it and
     read just after: K1, K2, K4, K5, E1 in its three forms, E2, E3
     launched, no plain version), saves the output, times five more
     warm executes, and fails if google.protobuf was imported; back
     here, load the secret context and the output and decrypt: the
     output bit-identical, polynomial by polynomial, to an execute here
     of the same ciphertexts with the original public context, with
     the same level and scale, the MSE below MSE_LIMIT["sobel"], and no
     google.protobuf imported; one `protocol {...}` line (MB of each
     file, save and load seconds per object, the server's CUDA start-up,
     its read and decode of the public context's file alone, first and
     warm execute ms, the capture's seconds, launches per execute); the
     server's counts appear as launches_by_path["protocol"]. Then the
     entry-point phase (entry_phase): examples/image_processing_torch.py,
     examples/regression_torch.py and examples/serialization_torch.py
     as subprocesses on the card (exit 0; each printed MSE of the image
     and serialization examples below 0.01, the regression example
     asserts its own), and bench_torch.run at full size with
     one pass, its counts reset just before it and read just after: the
     line holds every key of bench.py's, every throughput and time is
     positive, every sol_pct and compute_pct at most 105, K1, K2, K4,
     K5, E1 in its three forms, E2, E3 and E4 launched, no plain
     version called; one `bench {...}` line; its counts appear as
     launches_by_path["bench"]. Then the tools phase (tools_phase): the
     port's tools as subprocesses on the card, each to exit 0 with a
     whole last line (check_tool_line): tools/sweep_alpha_torch.py (the
     rotation at every alpha, level and ring size of the sweep on both
     key-switch routes, each first held to the plain versions on the
     host with torch.equal, then timed; its noise leg equal to the numpy
     backend), tools/bench_two_entry_torch.py (the same for one and two
     key entries), tools/bench_scaling_torch.py at a small size on one
     NCCL rank on the card and on two gloo ranks on the host (its reduced
     outputs equal to the one-process step), tools/reproduce_torch.py e2e
     (MSE below 0.01);
     the launches the card tools report appear as
     launches_by_path["tools"]. The kernel phase holds K4 and K5 at the
     sweep's new shapes too (alpha 1 at N = 16384 and 8192, the two-entry
     key's n_key 4 at alpha 4, batch 8), timed, in their `by_shape`.
  4. One JSON line of kernel numbers, K1, K2, K4, K5, E1 (its single,
     several-planes and MAC forms as mod_ew, mod_ew_multi, mod_ew_mac),
     E2, E3 and E4 (its launches those of the bench run)
     (keygen's launches under `launches_keygen`, the mesh phase's under
     launches_by_path "sobel_mesh" and "sobel_mesh_<plan>", the protocol
     server's under "protocol"), then the device line last.

`python3 chip_smoke.py --serve DIR` is the protocol phase's server role
alone, on the files in DIR (PROTOCOL_FILES); main() starts it.

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

import bench_torch
from bench_torch import (HBM_BYTES_PER_S, INT32_OPS_PER_S, MSE_LIMIT,
                         OPS_PER_MONT_MUL, PATH_COUNTERS, build_harris,
                         build_sobel, captured_entry, card_line,
                         path_launches, read_counts, replay_ms,
                         reset_counts)

SEED = 20260
# Integer ops per radix-2 butterfly of the modular arithmetic alone:
# Shoup multiply (mulhi, 2 mul-lo, sub, compare+select: 6), add_mod (4),
# sub_mod (4).
OPS_PER_BUTTERFLY = 14
# add_mod (4). One divide-and-round step per residue: add, Shoup
# multiply (6), sub_mod (4), compare: 12. A 32-bit Montgomery multiply's
# 6: bench_torch.OPS_PER_MONT_MUL.
OPS_PER_ADD_MOD = 4
OPS_PER_DIVIDE = 12
SOBEL_BITS = [60, 20, 60, 60, 60, 60, 60]
HARRIS_BITS = [60, 60, 60, 60, 60]


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
    separates the kernels. The capture refuses unsafe calls of this
    thread only: where fn runs NCCL collectives, the NCCL watchdog
    thread queries CUDA events during it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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


# Bytes one residue moves: 32-bit words (int32 tensors of uint32 bits).
RESIDUE_BYTES = 4


def ntt_bound_ms(rows: int, n: int, n_sub: int):
    """Least time for one NTT launch: 32-bit rows read and written once,
    the uint32 Shoup twiddle pair table read once; ntt_ops."""
    return bound(rows * n * RESIDUE_BYTES * 2 + n_sub * n * 4 * 2,
                 ntt_ops(rows, n))


# NTT shapes held to the plain versions, at the cluster size the kernel
# library picks and at every size it can be forced to: (label, N, leading
# shape, prime count). The first six are the main path's at N = 16384:
# Sobel's level 0 at batch 1 (11 data primes), data plus key primes, a
# deep level, a batch of 4 over the extended basis, and keygen's one
# launch per key-switching key over every digit group and the full basis
# (DeviceKeygen): Sobel's 6 groups x 13 primes, Harris's 4 x 10 (on the
# first 10 of Sobel's primes: the shape is Harris's).
NTT_SHAPES = (
    ("sobel_l0", 16384, (), 11),
    ("data_key", 16384, (), 13),
    ("deep", 16384, (), 2),
    ("batch4", 16384, (4,), 13),
    ("keygen_sobel", 16384, (6,), 13),
    ("keygen_harris", 16384, (4,), 10),
    ("n1024", 1024, (4,), 13),
    ("n2048", 2048, (4,), 13),
    ("n32768", 32768, (2,), 13),
)


def ntt_inputs(device, n: int, lead, n_sub: int):
    """(ops, x): the level ops of the first n_sub primes of Sobel's chain
    at ring n, and random reduced planes lead + [n_sub, n] on device."""
    import torch
    from eva_tpu_torch.backend.tables import DeviceLevelOps
    from eva_tpu_torch.crypto.context import get_context

    primes = list(get_context(tuple(SOBEL_BITS), (), n, 1).all_primes)
    ops = DeviceLevelOps(primes[:n_sub], n, device)
    rng = np.random.default_rng(SEED + n + n_sub + len(lead))
    return ops, residues(rng, ops.primes, tuple(lead) + (n,), device)


def residues(rng, primes, shape, device):
    """Random reduced residues of `primes` [..., len(primes), N] (shape
    = [..., N]) as an int32 tensor of their uint32 bits on `device`."""
    from eva_tpu_torch.backend.modmath import upload
    return upload(np.stack(
        [rng.integers(0, q, shape, dtype=np.uint64) for q in primes],
        axis=len(shape) - 1), device)


def forced_clusters(n: int, device):
    """The cluster sizes the NTT kernels can be forced to at ring n on
    this card (N / C >= 1024 and a cluster of C fits)."""
    from eva_tpu_torch.backend import ntt_cuda
    info = ntt_cuda.kernel_info(int(math.log2(n)), device)["clusters"]
    return [c for c, v in info.items()
            if v["threads"] and v["held_fwd"] and v["held_inv"]]


def kernel_phase(device):
    """Phase 2: the NTT kernels against their plain version at every
    NTT_SHAPES shape, chosen and forced cluster sizes; returns the
    per-kernel numbers by shape label."""
    import torch
    from eva_tpu_torch.backend import ntt_cuda

    for logn in (14, 15):
        print(f"kernels ntt resources logn={logn} "
              + json.dumps(ntt_cuda.kernel_info(logn, device)), flush=True)
    results = {}
    for label, n, lead, n_sub in NTT_SHAPES:
        ops, x = ntt_inputs(device, n, lead, n_sub)
        f_p = ops._fwd_merged(x)
        i_p = ops._inv_merged(f_p)
        rows = x.numel() // n
        info = ntt_cuda.kernel_info(ops.logn, device)
        chosen = {name: info[f"{name}_kernel"]["cluster"]
                  for name in ("ntt_fwd", "ntt_inv")}
        for c in [0] + forced_clusters(n, device):
            f_k = ntt_cuda.ntt_fwd(x, ops, _cluster=c)
            i_k = ntt_cuda.ntt_inv(f_p, ops, _cluster=c)
            torch.cuda.synchronize()
            checks = {"fwd": torch.equal(f_k, f_p),
                      "inv": torch.equal(i_k, i_p),
                      "roundtrip": torch.equal(i_k, x)}
            print(f"kernels ntt {label} shape={list(x.shape)} "
                  f"cluster={c or chosen} {checks}", flush=True)
            if not all(checks.values()):
                raise AssertionError(f"NTT kernel disagrees: {label} "
                                     f"cluster {c or chosen}: {checks}")
        f_k = ntt_cuda.ntt_fwd(x, ops)
        i_k = ntt_cuda.ntt_inv(f_p, ops)
        bms, bby = ntt_bound_ms(rows, n, n_sub)
        for name, kern, plain, arg, got, want in (
                ("ntt_fwd", ntt_cuda.ntt_fwd, ops._fwd_merged, x, f_k, f_p),
                ("ntt_inv", ntt_cuda.ntt_inv, ops._inv_merged, f_p, i_k,
                 i_p)):
            res = {"shape": list(arg.shape), "cluster": chosen[name],
                   "ms": graph_ms(lambda: kern(arg, ops), 50),
                   "eager_ms": eager_ms(lambda: kern(arg, ops), 200),
                   "plain_ms": graph_ms(lambda: plain(arg), 5, reps=3),
                   "bound_ms": bms, "bound_by": bby,
                   "max_abs_err": int((got - want).abs().max().item())}
            print(f"kernel {name} {label} " + json.dumps(res), flush=True)
            results[(name, label)] = res
    return results


def mac_bound_ms(y, x_ntt, k0, n_ext: int, n: int):
    """Least time for one ks_mac launch. Bytes: y, x_ntt and both key
    stacks read once, both accumulators written once (32-bit words), the
    forward twiddle pairs (uint32) read once. Operations: the FBE of
    every (b, i, j) row the kernel must transform (all but the n_cur own
    rows when x_ntt is given), its NTT, and the MAC of every (b, i, j)."""
    batch, n_groups, alpha = y.shape[:3]
    own = x_ntt.shape[1] if x_ntt is not None else 0
    byts = (RESIDUE_BYTES * (y.numel() + (x_ntt.numel() if x_ntt is not None
                                          else 0)
                             + 2 * k0.numel() + 2 * batch * n_ext * n)
            + 8 * n_ext * n)
    fbe_rows = batch * (n_ext * n_groups - own)
    ops = (ntt_ops(fbe_rows, n)
           + fbe_rows * n * alpha * (OPS_PER_MONT_MUL + OPS_PER_ADD_MOD)
           + batch * n_ext * n_groups * n * 2
           * (OPS_PER_MONT_MUL + OPS_PER_ADD_MOD))
    return bound(byts, ops)


def epilogue_bound_ms(batch: int, n_ext: int, n_key: int, n: int,
                      out_ntt: bool):
    """Least time for one ks_epilogue call. Bytes: both accumulators read
    and both outputs written once (32-bit words), inverse (and forward) twiddle
    pairs read once. Operations: the inverse NTT of 2B n_ext rows, the
    n_key division steps over the rows each leaves, the forward NTT of
    2B n_out rows with out_ntt."""
    n_out = n_ext - n_key
    byts = (RESIDUE_BYTES * 2 * batch * (n_ext + n_out) * n
            + 8 * n * (n_ext + (n_out if out_ntt else 0)))
    div_rows = sum(n_ext - 1 - d for d in range(n_key))
    ops = 2 * batch * (ntt_ops(n_ext, n) + div_rows * n * OPS_PER_DIVIDE
                       + (ntt_ops(n_out, n) if out_ntt else 0))
    return bound(byts, ops)


# Fused key-switch shapes held to the plain versions: (label, prime bits,
# key terms, N, level, alpha, batches). Sobel's level 0 (n_cur 11, n_key 2,
# six digit groups) is the main path's and is timed at B = 1 and 4.
KS_SHAPES = (
    ("sobel_l0", SOBEL_BITS, 1, 16384, 0, 2, (1, 4, 3)),
    ("harris_l0", HARRIS_BITS, 1, 16384, 0, 2, (1,)),
    ("sobel_l0_alpha1", SOBEL_BITS, 1, 16384, 0, 1, (1,)),
    ("sobel_deepest", SOBEL_BITS, 1, 16384, 5, 2, (1,)),
    ("n_key1", (60, 40, 60, 30), 1, 16384, 0, 1, (1,)),
    ("sobel_l0", SOBEL_BITS, 1, 1024, 0, 2, (4,)),
    ("sobel_l0", SOBEL_BITS, 1, 32768, 0, 2, (1,)),
    # tools/sweep_alpha_torch.py's and bench_two_entry_torch.py's
    # rotations at their batch of 8: alpha 1 at N = 16384 (12 data primes,
    # twelve digit groups) and N = 8192, and the two-entry key (n_key 4,
    # alpha 4: groups of 4, 4, 2).
    ("sweep_alpha1", [60] * 7, 1, 16384, 0, 1, (8,)),
    ("sweep_alpha1", [60] * 3, 1, 8192, 0, 1, (8,)),
    ("two_entry_alpha4", [60] * 7, 2, 16384, 0, 4, (8,)),
)
# The shapes timed, each keyed f"{label}_N{n}_B{batch}" in K4's and K5's
# `by_shape` (with registers, spills and the MAC's cluster size): the one
# an execute launches (KS_MAIN), Sobel's at B=4 (KS_BATCH4) and the tools'.
KS_MAIN, KS_BATCH4 = "sobel_l0_N16384_B1", "sobel_l0_N16384_B4"
TIMED_KS = {KS_MAIN, KS_BATCH4, "sweep_alpha1_N16384_B8",
            "sweep_alpha1_N8192_B8", "two_entry_alpha4_N16384_B8"}


def ks_kernel_phase(device):
    """Phase 2, fused key switch: ks_mac and ks_epilogue against their
    plain versions at every KS_SHAPES shape (with and without x_ntt,
    out_ntt True and False); returns the numbers of the TIMED_KS shapes
    (with x_ntt / out_ntt), keyed (kernel, f"{label}_N{n}_B{batch}"), each
    with the kernels' registers and spill bytes (and the MAC's cluster
    size) at its ring and key-prime count."""
    import torch
    from eva_tpu_torch.backend import ks, ks_cuda
    from eva_tpu_torch.backend.executor_torch import _ks_dev_tables, _ks_maps
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    for logn in (14, 15):
        print(f"kernels ks resources logn={logn} "
              + json.dumps(ks_cuda.kernel_info(logn, device)), flush=True)
    results = {}
    for label, bits, key_terms, n, level, alpha, batches in KS_SHAPES:
        ctx = get_context(tuple(bits), (), n, key_terms)
        primes = ctx.primes_at_level(level)
        basis = primes + list(ctx.key_primes)
        n_cur, n_key, n_ext = len(primes), len(ctx.key_primes), len(basis)
        ext = level_ops(basis, n, device)
        n_groups, _, conv_mont = _ks_dev_tables(ctx, level, alpha)
        _, owner, _ = _ks_maps(ctx, level, alpha)
        conv = upload(conv_mont[..., 0], device)
        own = torch.from_numpy(np.concatenate(
            [owner, [-1] * n_key]).astype(np.int64)).to(device)
        for batch in batches:
            rng = np.random.default_rng(
                SEED + n + batch + 31 * level + alpha)

            def planes(lead, qs):
                return residues(rng, qs, lead + (n,), device)

            y = np.zeros((batch, n_groups * alpha, n), dtype=np.uint64)
            for t, q in enumerate(primes):
                y[:, t] = rng.integers(0, q, (batch, n), dtype=np.uint64)
            y = upload(y, device).reshape(batch, n_groups, alpha, n)
            k0, k1 = (torch.stack([planes((), basis)
                                   for _ in range(n_groups)])
                      for _ in range(2))
            x_ntt = planes((batch,), primes)
            acc0, acc1 = planes((batch,), basis), planes((batch,), basis)
            shape = f"N={n} B={batch} n_cur={n_cur} n_key={n_key} " \
                    f"alpha={alpha} groups={n_groups}"
            key = f"{label}_N{n}_B{batch}"
            timed = key in TIMED_KS
            info = ks_cuda.kernel_info(ext.logn, device, n_key)
            resources = {
                "ks_mac": {**info["ks_mac_cluster_kernel"],
                           "cluster": ks_cuda.mac_cluster(
                               ext.logn, n_groups, n_ext * batch, device)},
                "ks_epilogue": {
                    "key_kernel": info["ks_epilogue_key_kernel"],
                    "row_kernel": info["ks_epilogue_row_kernel"]}}
            for xn in (x_ntt, None):
                got = ks_cuda.ks_mac(y, k0, k1, conv, own, ext, xn)
                want = ks.ks_mac_plain(y, k0, k1, conv, own, ext, xn)
                torch.cuda.synchronize()
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"kernels ks_mac {label} {shape} "
                      f"x_ntt={xn is not None} equal={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"ks_mac disagrees: {label} {shape}")
                if not timed or xn is None:
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
                                       for g, w in zip(got, want)),
                    **resources["ks_mac"]}
                print(f"kernel ks_mac {key} " + json.dumps(res), flush=True)
                results[("ks_mac", key)] = res
            for out_ntt in (True, False):
                got = ks_cuda.ks_epilogue(acc0, acc1, ext, n_key, out_ntt)
                want = ks.ks_epilogue_plain(acc0, acc1, ext, n_key, out_ntt)
                torch.cuda.synchronize()
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"kernels ks_epilogue {label} {shape} "
                      f"out_ntt={out_ntt} equal={ok}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"ks_epilogue disagrees: {label} {shape}")
                if not timed or not out_ntt:
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
                                       for g, w in zip(got, want)),
                    **resources["ks_epilogue"]}
                print(f"kernel ks_epilogue {key} " + json.dumps(res),
                      flush=True)
                results[("ks_epilogue", key)] = res
    return results


# 32-bit integer operations per output element of each E1 op (the
# compare and select of a reduction: 2): add 4, sub 4, neg 3; Montgomery
# multiply OPS_PER_MONT_MUL; mul two of them; Shoup multiply (mulhi, 2
# mul-lo, sub, compare + select) 6. E2, per element of its three outputs:
# 5 Montgomery multiplies, 2 adds, 2 subs; E3: add, sub, Montgomery
# multiply, compare, sub_mod.
EW_OPS = {"add": 4, "sub": 4, "neg": 3, "mul_mont": OPS_PER_MONT_MUL,
          "mul": 2 * OPS_PER_MONT_MUL, "shoup": 6}
TENSOR_PRODUCT_OPS = 5 * OPS_PER_MONT_MUL + 4 * OPS_PER_ADD_MOD
DIVIDE_OPS = OPS_PER_MONT_MUL + 2 + 2 + OPS_PER_ADD_MOD
# Elementwise kernel shapes at N = 16384: (label, leading dims, primes).
# Sobel's level 0 (11 data primes) at batch 1 and 4: the dyadic ops,
# the tensor product and the rescale's first division; and Harris's (10).
EW_SHAPES = (("sobel_l0", (), 11), ("sobel_l0_b4", (4,), 11),
             ("harris_l0", (), 10))
TIMED_EW = "sobel_l0"


def ew_bound_ms(operands, outputs, ops: int):
    """Least time for one elementwise launch: each distinct input read
    once and each output written once (4 bytes a word), `ops` 32-bit
    integer operations."""
    byts = RESIDUE_BYTES * sum(t.numel() for t in (*operands, *outputs))
    return bound(byts, ops)


# E1's MAC form at the hoisted rotations' shapes: (label, prime bits,
# level, alpha, batches). Sobel's and Harris's level 0 at B = 1 and 4 (the
# main path's; six and four digit groups), alpha 1 (11 groups) and
# Sobel's deepest level (one group: no foreign rows).
MAC_SHAPES = (("sobel_l0", SOBEL_BITS, 0, 2, (1, 4)),
              ("harris_l0", HARRIS_BITS, 0, 2, (1, 4)),
              ("sobel_l0_alpha1", SOBEL_BITS, 0, 1, (1,)),
              ("sobel_deepest", SOBEL_BITS, 5, 2, (1,)))
# E3 shapes at N = 16384: (label, rows in, primes divided by, polynomials,
# addend, leading dims). A rescale of a ciphertext at Sobel's level 0 by
# one and by two primes (B = 1 and 4), the fused relinearize-rescale
# (the key switch's output as the addend), the fused rescale-relinearize
# (three polynomials), the structured key switch's P-division (13 rows by
# the two key primes), and a context's eight-prime limit.
E3_SHAPES = (("sobel_l0", 11, 2, 2, False, ()),
             ("sobel_l0_b4", 11, 2, 2, False, (4,)),
             ("sobel_l0_k1", 11, 1, 2, False, ()),
             ("relin_rescale", 11, 2, 2, True, ()),
             ("rescale_relin", 11, 2, 3, False, ()),
             ("p_division", 13, 2, 2, False, ()),
             ("k8", 13, 8, 1, True, ()))
MAC_OPS = 2 * (OPS_PER_MONT_MUL + OPS_PER_ADD_MOD)  # per digit term


def divide_ops(polys: int, lead: int, n_rows: int, k: int, n: int,
               addend: bool) -> int:
    """Operations of one E3 call: k division steps (DIVIDE_OPS each) for
    each of the n_rows - k output words of a column, k (k - 1) / 2 for
    its lifts, one add_mod per input word with an addend."""
    steps = k * (n_rows - k) + k * (k - 1) // 2
    return polys * lead * n * (steps * DIVIDE_OPS
                               + (n_rows * OPS_PER_ADD_MOD if addend else 0))


def modmath_kernel_phase(device):
    """Phase 2, elementwise kernels: E1's single form (every op; the
    second operand full, broadcast over the batch, and a per-row
    constant; an unreduced first operand for the multiplies; a strided
    first operand), its several-planes form (mul, add, sub, neg at a
    rotation sum's shapes) and E2 at EW_SHAPES; E1's MAC form
    (ew_mac_phase) and E3 (divide_phase); each against its plain version
    (torch.equal), timed at the main path's shapes by graph_ms beside its
    plain version and its bound; and E1's strided operands read in place
    (strided_in_place)."""
    import torch
    from eva_tpu_torch.backend import modmath_cuda
    from eva_tpu_torch.backend import modmath as M
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    print("kernels modmath resources "
          + json.dumps(modmath_cuda.kernel_info(device)), flush=True)
    n = 16384
    primes = list(get_context(tuple(SOBEL_BITS), (), n, 1).all_primes)
    results = {}

    def record(key, label, kern, plain, operands, ops, timed):
        record_form(results, key, label, [list(t.shape) for t in operands],
                    kern, plain, operands, ops, timed)

    for label, lead, n_sub in EW_SHAPES:
        dev = level_ops(primes[:n_sub], n, device)
        rng = np.random.default_rng(SEED + n_sub + len(lead))
        a, b, c, d = (residues(rng, dev.primes, lead + (n,), device)
                      for _ in range(4))
        shared = residues(rng, dev.primes, (n,), device)  # a plaintext
        row = residues(rng, dev.primes, (1,), device)     # [n_sub, 1]
        big = upload(rng.integers(0, 2 ** 32, lead + (n_sub, n),
                                  dtype=np.uint64), device)
        wp = upload(np.stack([M.shoup_pair(M.to_host(b[..., i, :]), q)[1]
                              for i, q in enumerate(dev.primes)],
                             axis=-2), device)
        timed = label == TIMED_EW or label == TIMED_EW + "_b4"
        for op, per in EW_OPS.items():
            # (suffix, first, second operand): dyadic; a plaintext shared
            # by the batch; a per-row constant; an unreduced first operand
            # (the multiplies). Shoup takes only b (w and wp of one
            # table), neg one operand.
            cases = [("", a, b), ("_plaintext", a, shared), ("_row", a, row)]
            if op in ("mul_mont", "mul", "shoup"):
                cases.append(("_unreduced", big, b))
            if op == "shoup":
                cases = [case for case in cases if case[2] is b]
            if op == "neg":
                cases = cases[:1]
            for suffix, x, y in cases:
                if op == "neg":
                    args = (x,)
                elif op == "mul":
                    args = (x, y, dev.r2)
                elif op == "shoup":
                    args = (x, y, wp)
                else:
                    args = (x, y)
                plain = {"add": M.add_mod, "sub": M.sub_mod,
                         "neg": M.neg_mod, "mul_mont": M.mont_mul,
                         "mul": M.mul, "shoup": M.shoup_mul}[op]
                extra = {"mul_mont": (dev.q, dev.rinv),
                         "mul": (dev.q, dev.rinv, dev.r2),
                         "shoup": (dev.q,)}.get(op, (dev.q,))
                pargs = args[:2] if op == "mul" else args
                record(("mod_ew", op), label + suffix,
                       lambda op=op, args=args: modmath_cuda.mod_ew(
                           op, dev, *args),
                       lambda plain=plain, pargs=pargs, extra=extra:
                       plain(*pargs, *extra),
                       args, lambda got, per=per: got[0].numel() * per,
                       timed and not suffix)
        # A strided first operand (rows of a wider batched plane, as a
        # ModSwitch leaves them), read in place.
        wider = residues(rng, primes[:n_sub + 2], lead + (n,), device)
        view = wider[..., :n_sub, :]
        record(("mod_ew", "add"), label + "_strided",
               lambda: modmath_cuda.mod_ew("add", dev, view, b),
               lambda: M.add_mod(view, b, dev.q), (view, b), None, False)
        record(("tensor_product",), label,
               lambda: modmath_cuda.tensor_product(dev, a, b, c, d),
               lambda: M.tensor_product(a, b, c, d, dev.q, dev.rinv, dev.r2),
               (a, b, c, d),
               lambda got: got[0].numel() * TENSOR_PRODUCT_OPS, timed)

        # The several-planes form at a rotation sum's shapes: c0, c1 on
        # the data primes, acc0, acc1 on the extended basis (two key
        # primes more), a plaintext with extended rows shared by the
        # batch, a strided c0 (the data rows of an accumulator) and a
        # zero for a negation inside a subtraction.
        ext = level_ops(primes[:n_sub + 2], n, device)
        c0, c1 = (residues(rng, dev.primes, lead + (n,), device)
                  for _ in range(2))
        acc0, acc1 = (residues(rng, ext.primes, lead + (n,), device)
                      for _ in range(2))
        pt = residues(rng, ext.primes, (n,), device)
        zero = torch.zeros((1, 1), dtype=torch.int32, device=device)
        strided = acc1[..., :n_sub, :]
        for op, planes, inputs in (
                ("mul", [(c0, pt[:n_sub]), (c1, pt[:n_sub]), (acc0, pt),
                         (acc1, pt)], (c0, c1, acc0, acc1, pt)),
                ("add", [(c0, c1), (acc0, acc1), (acc1, acc0),
                         (strided, c0)], (c0, c1, acc0, acc1)),
                ("sub", [(c0, c1), (zero, c1), (acc0, acc1)],
                 (c0, c1, acc0, acc1)),
                ("neg", [(c0,), (acc0,), (acc1,)], (c0, acc0, acc1))):
            rows = [max(t.shape[-2] for t in pl) for pl in planes]
            plain_planes = [
                (pl + ((ext.r2[:r],) if op == "mul" else ()), ext.q[:r],
                 ext.rinv[:r]) for pl, r in zip(planes, rows)]
            record(("mod_ew_multi", op), label,
                   lambda op=op, planes=planes: ext.ew_planes(op, planes),
                   lambda op=op, pp=plain_planes: M.ew_planes(op, pp),
                   inputs, lambda got, op=op: sum(
                       t.numel() for t in got) * EW_OPS[op],
                   timed and op in ("mul", "add"))
    results.update(ew_mac_phase(device))
    results.update(divide_phase(device))
    strided_in_place(device)
    return results


def device_kernels(fn):
    """The device operations one call of fn runs, by name (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages()
                  for _ in range(e.count)
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0)


def strided_in_place(device):
    """E1 reads strided operands in place: a single-form add of a row
    slice of a batched plane and a multi-form add with one launch one
    device operation each, the kernel, and no copy."""
    import torch
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context
    n = 16384
    primes = list(get_context(tuple(SOBEL_BITS), (), n, 1).all_primes)
    dev = level_ops(primes[:11], n, device)
    rng = np.random.default_rng(SEED)
    wide = residues(rng, primes, (4, n), device)
    view, other = wide[:, :11, :], residues(rng, primes[:11], (4, n), device)
    got = {"single": device_kernels(lambda: dev.add(view, other)),
           "multi": device_kernels(lambda: dev.ew_planes(
               "add", [(view, other), (other, view)]))}
    print("kernels strided_in_place " + json.dumps(got), flush=True)
    for form, name in (("single", "mod_ew_kernel"),
                       ("multi", "mod_ew_multi_kernel")):
        if len(got[form]) != 1 or name not in got[form][0]:
            raise AssertionError(f"E1 {form} on a strided operand ran "
                                 f"{got[form]}, not one {name}")
    return got


# E4 shapes at N = 16384: (label, leading dims, primes). bench_torch's
# probe runs at "bench" ([8, 12]: kernel_sol's level-0 planes of its
# L = 6 context); the others are a ct-mul batch of 32 and a batch of 8
# at other prime counts.
BURN_SHAPES = (("bench", (8,), 12), ("b32_p6", (32,), 6), ("b8_p7", (8,), 7))


def burn_phase(device):
    """Phase 2, E4: modmul_burn against its plain version (torch.equal) at
    BURN_SHAPES on reduced and unreduced words, each timed (graph_ms)
    beside its plain version and its bound (8 bytes a word;
    modmath.BURN_K Montgomery multiplies of OPS_PER_MONT_MUL operations
    a word)."""
    from eva_tpu_torch.backend import modmath as M
    from eva_tpu_torch.backend import modmath_cuda
    from eva_tpu_torch.backend.modmath import upload
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    n = 16384
    primes = list(get_context(tuple([60] * 7), (), n, 1).all_primes)
    results = {}
    for label, lead, n_sub in BURN_SHAPES:
        dev = level_ops(primes[:n_sub], n, device)
        rng = np.random.default_rng(SEED + 7 * n_sub + len(lead))
        for suffix, x in (
                ("", residues(rng, dev.primes, lead + (n,), device)),
                ("_unreduced", upload(rng.integers(
                    0, 2 ** 32, lead + (n_sub, n), dtype=np.uint64),
                    device))):
            record_form(results, ("modmul_burn",), label + suffix,
                        list(x.shape),
                        lambda x=x, dev=dev: modmath_cuda.modmul_burn(
                            dev, x),
                        lambda x=x, dev=dev: M.modmul_burn(
                            x, dev.q, dev.rinv),
                        (x,), lambda got: got[0].numel() * M.BURN_K
                        * OPS_PER_MONT_MUL, not suffix)
    return results


def ew_mac_phase(device):
    """E1's MAC form against its plain version (modmath.mont_mac) at
    MAC_SHAPES, also with strided digits (a window of a larger shard
    stack, as a sharded rotation reads them); timed at the main path's
    shapes (B = 1: label, B = 4: label_b4)."""
    import torch
    from eva_tpu_torch.backend import modmath as M
    from eva_tpu_torch.backend.executor_torch import _ks_maps
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    n = 16384
    results = {}
    for label, bits, level, alpha, batches in MAC_SHAPES:
        ctx = get_context(tuple(bits), (), n, 1)
        primes = ctx.primes_at_level(level)
        keyp = list(ctx.key_primes)
        ext = level_ops(primes + keyp, n, device)
        groups, _, _ = _ks_maps(ctx, level, alpha)
        n_cur, n_key = len(primes), len(keyp)
        rng = np.random.default_rng(SEED + 7 * level + alpha)

        def half():
            return (residues(rng, primes, (n,), device),
                    residues(rng, primes, (groups - 1, n), device)
                    if groups > 1 else None,
                    residues(rng, keyp, (groups, n), device))

        keys0, keys1 = half(), half()
        for batch in batches:
            lead = () if batch == 1 else (batch,)
            cases = [("", lead)]
            if batch == 1:
                cases.append(("_strided", (3,)))
            for suffix, dl in cases:
                own = residues(rng, primes, dl + (n,), device)
                a = (residues(rng, primes, dl + (groups - 1, n), device)
                     if groups > 1 else None)
                b = residues(rng, keyp, dl + (groups, n), device)
                if suffix:  # the middle shard of three
                    own, b = own[1], b[1]
                    a = None if a is None else a[1]
                digits = [t for t in (own, a, b) if t is not None]
                key_list = [t for t in (*keys0, *keys1) if t is not None]
                shape = (f"B={batch} n_cur={n_cur} n_key={n_key} "
                         f"groups={groups}{suffix}")
                tag = label + ("" if batch == 1 else f"_b{batch}") + suffix
                record_form(results, ("mod_ew_mac",), tag, shape,
                            lambda: ext.mac(own, a, b, keys0, keys1),
                            lambda: M.mont_mac(own, a, b, keys0, keys1,
                                               ext.q, ext.rinv),
                            digits + key_list,
                            batch * (n_cur + n_key) * groups * n * MAC_OPS,
                            not suffix and label in ("sobel_l0",
                                                     "harris_l0"))
    return results


def divide_phase(device):
    """E3 (every prime and polynomial of a call in one launch) against
    its plain version (ks.divide_last_plain: one prime at a time, the
    JAX package's loop) at E3_SHAPES, each timed."""
    from eva_tpu_torch.backend import ks
    from eva_tpu_torch.backend.tables import level_ops
    from eva_tpu_torch.crypto.context import get_context

    n = 16384
    primes = list(get_context(tuple(SOBEL_BITS), (), n, 1).all_primes)
    results = {}
    for label, n_rows, k, polys, addend, lead in E3_SHAPES:
        prim = primes[:n_rows]
        rest = level_ops(prim[:-1], n, device)
        rng = np.random.default_rng(SEED + 3 * n_rows + k + polys)
        xs = [residues(rng, prim, lead + (n,), device) for _ in range(polys)]
        adds = ([residues(rng, prim, lead + (n,), device)
                 for _ in range(polys)] if addend else None)
        shape = (f"{list(xs[0].shape)} k={k} polys={polys} "
                 f"addend={addend}")
        record_form(results, ("divide_last",), label, shape,
                    lambda: ks.divide_last(xs, prim, k, rest, adds),
                    lambda: ks.divide_last_plain(xs, prim, k, rest, adds),
                    xs + (adds or []),
                    divide_ops(polys, math.prod(lead), n_rows, k, n, addend),
                    True)
    return results


def record_form(results, key, label, shape, kern, plain, inputs, ops,
                timed):
    """Hold kern() to plain() (torch.equal), print it; if timed, time
    both (graph_ms, eager_ms) beside the bound of `inputs` read once, the
    outputs written once and `ops` operations, into results[key +
    (label,)]."""
    import torch
    from eva_tpu_torch.backend.modmath import widen
    got, want = kern(), plain()
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    torch.cuda.synchronize()
    ok = len(got) == len(want) and all(
        g.dtype == torch.int32 and torch.equal(g, w)
        for g, w in zip(got, want))
    print(f"kernels {' '.join(map(str, key))} {label} {shape} equal={ok}",
          flush=True)
    if not ok:
        raise AssertionError(f"{key} disagrees with its plain version at "
                             f"{label} {shape}")
    if not timed:
        return
    bms, bby = ew_bound_ms(inputs, got, ops(got) if callable(ops) else ops)
    res = {"shape": shape, "ms": graph_ms(kern, 50),
           "eager_ms": eager_ms(kern, 200),
           "plain_ms": graph_ms(plain, 5, reps=3),
           "bound_ms": bms, "bound_by": bby,
           "max_abs_err": max(int((widen(g) - widen(w)).abs().max().item())
                              for g, w in zip(got, want))}
    print(f"kernel {' '.join(map(str, key))} {label} " + json.dumps(res),
          flush=True)
    results[key + (label,)] = res


def read_rows():
    """{NTT kernel: {rows: launches}}: the NTT launches by row count."""
    from eva_tpu_torch.backend import ntt_cuda
    return {k: dict(sorted(v.items())) for k, v in ntt_cuda.ROWS.items()}


def _plain(counts):
    return {**counts["plain_calls"], **counts["ks_plain_calls"],
            **{f"modmath {k}": v
               for k, v in counts["modmath_plain_calls"].items()}}


def check_counts(name, counts, fused: bool):
    """Every kernel of the path launched (K1, K2, E1 in each form:
    single, several planes, MAC; E2, E3; K4 and K5 on the fused path), no
    plain version called; on the structured path (fused False) no
    key-switch kernel either."""
    ntt, ksl = counts["ntt_launches"], counts["ks_launches"]
    ok = (min(ntt.values()) > 0
          and min(counts["modmath_launches"].values()) > 0
          and not any(_plain(counts).values())
          and (min(ksl.values()) > 0 if fused else not any(ksl.values())))
    if not ok:
        raise AssertionError(f"{name}: counts {counts}")


def check_keygen_counts(name, counts, n_keys: int):
    """Keygen on the card: one K1 launch and five E1 launches (the
    error's lift, two products, a difference and a sum) per
    key-switching key, no other kernel and no plain version."""
    want = {"ntt_fwd": n_keys, "ntt_inv": 0}
    want_ew = {"mod_ew": 5 * n_keys, "mod_ew_multi": 0, "mod_ew_mac": 0,
               "tensor_product": 0, "divide_last": 0}
    if (counts["ntt_launches"] != want
            or counts["modmath_launches"] != want_ew
            or any(_plain(counts).values())
            or any(counts["ks_launches"].values())):
        raise AssertionError(f"{name} keygen: counts {counts}, want "
                             f"{want} NTT and {want_ew} modmath launches")


def check_int32(name, out):
    """Every output plane of a program is an int32 residue tensor."""
    import torch
    bad = {k: str(c.dtype) for k, planes in out.items() for c in planes
           if c.dtype != torch.int32}
    if bad:
        raise AssertionError(f"{name}: output planes not int32: {bad}")


def check_launches(name, counts, launches):
    """The path kernels' launches in `counts` (read_counts) are those a
    capture counted (`launches`: _Captured.launches)."""
    for counter in PATH_COUNTERS:
        if {k: v for k, v in counts[counter].items() if v} != \
                launches[counter]:
            raise AssertionError(f"{name}: launched {counts[counter]}, the "
                                 f"capture counted {launches[counter]}")


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
    CUDA device). Key generation runs with the counts reset just before
    it and read just after (one K1 launch per key-switching key); the
    rest of the path runs with the counts reset after keygen and read
    just after execute. Then the checks against the port's numpy backend
    and the plaintext reference, and the warm execute times."""
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    prog = build()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    t_compile = time.perf_counter() - t0
    inputs = {"image": rng.uniform(0, 1, prog.vec_size).tolist()}
    reset_counts()
    t0 = time.perf_counter()
    pub, sec = generate_keys(params, device=device)
    t_keygen = time.perf_counter() - t0
    keygen = read_counts()
    check_keygen_counts(name, keygen, 1 + len(pub._keys.galois))
    reset_counts()
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
    reset_counts()
    pub.execute(compiled, enc)
    rows = read_rows()
    return {
        "N": params.poly_modulus_degree, "prime_bits": list(params.prime_bits),
        "rotations": len(params.rotations),
        "alpha": pub._keys.ks_alpha, "key_primes": len(pub.ctx.key_primes),
        **counts,
        "keygen_launches": keygen,
        "compile_s": t_compile, "keygen_s": t_keygen,
        "first_execute_s": t_first, "mse": mse, "ref_mean_square": ref_ms,
        "execute_ms_median": statistics.median(times),
        "execute_ms_all": times, "ntt_rows_per_execute": rows,
    }, (compiled, pub, enc, sig, ref_out)


def ksk_inputs(ctx, seed: int):
    """Seeded inputs of one relinearization key's `_ksk_compute` at `ctx`,
    drawn as crypto/keys._make_kswitch_key draws them (a ternary secret,
    its square as the target, one uniform a, one error and the factor
    P * g_j of every digit group), but from a numpy generator seeded
    with `seed`."""
    from eva_tpu_torch.crypto import keys as K

    rng = np.random.default_rng(seed)
    s = K.SecretKey(ctx, rng.integers(-1, 2, ctx.n, dtype=np.int64))
    basis = ctx.all_primes
    target = (s.s * s.s) % ctx.qvec(basis)
    groups = ctx.ks_groups(K.default_ks_alpha(ctx))
    q_all = math.prod(ctx.data_primes)
    facs = np.empty((len(groups), len(basis)), dtype=np.uint64)
    for j, group in enumerate(groups):
        q_j = math.prod(ctx.data_primes[t] for t in group)
        qhat = q_all // q_j
        factor = ctx.key_product * qhat * pow(qhat % q_j, -1, q_j)
        facs[j] = [factor % q for q in basis]
    As = [K.expand_uniform(ctx, basis, rng.bytes(32)) for _ in groups]
    Es = [np.rint(rng.normal(0.0, K.ERROR_STDDEV, ctx.n)).astype(np.int64)
          for _ in groups]
    return s.s, target, As, Es, facs


def timed_keygen(params, **kw):
    """(seconds of generate_keys(params, **kw), seconds of it inside
    crypto/keys._ksk_compute, the arithmetic an engine takes; the rest
    is sampling, the public key and the automorphisms of s)."""
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.runtime import generate_keys

    inner, spent = K._ksk_compute, []

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        spent.append(time.perf_counter() - t0)
        return out

    K._ksk_compute = timed
    try:
        t0 = time.perf_counter()
        generate_keys(params, **kw)
        total = time.perf_counter() - t0
    finally:
        K._ksk_compute = inner
    return total, sum(spent), len(spent)


def keygen_phase(device, reps=3):
    """Phase 3a: key-switching-key arithmetic on the card (DeviceKeygen,
    one K1 launch at [groups, n_all, N]) against the host loop on seeded
    randomness at Sobel's and Harris's contexts: byte-identical, ms per
    key each way; then generate_keys seconds with the host loop
    (backend "numpy") and on the card, each split into _ksk_compute and
    the rest."""
    from eva_tpu_torch.backend.keygen import DeviceKeygen
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.crypto.context import get_context

    out = {}
    for name, build, seed in (("sobel", build_sobel, 23),
                              ("harris", build_harris, 29)):
        _, params, _ = CKKSCompiler({"warn_vec_size": "false"}).compile(
            build())
        ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                          params.poly_modulus_degree,
                          getattr(params, "key_terms", 1))
        args = ksk_inputs(ctx, SEED + seed)
        engine = DeviceKeygen(ctx, device)
        t0 = time.perf_counter()
        want = K._ksk_compute(ctx, *args, None)
        host_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        t0 = time.perf_counter()
        got = K._ksk_compute(ctx, *args, engine)
        first_ms = (time.perf_counter() - t0) * 1e3
        counts, rows = read_counts(), read_rows()
        for a, b in zip(want[0] + want[1], got[0] + got[1]):
            if not (a.dtype == b.dtype and np.array_equal(a, b)):
                raise AssertionError(f"{name}: DeviceKeygen differs from "
                                     f"the host loop")
        check_keygen_counts(f"{name} ksk_compute", counts, 1)
        device_ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            K._ksk_compute(ctx, *args, engine)
            device_ms.append((time.perf_counter() - t0) * 1e3)
        host_s, host_ksk_s, n_keys = timed_keygen(params, backend="numpy")
        dev_s, dev_ksk_s, _ = timed_keygen(params, device=device)
        out[name] = {
            "N": ctx.n, "n_all": len(ctx.all_primes),
            "groups": len(args[2]), "keys": n_keys,
            "ksk_equal": True, "ntt_rows_per_launch": rows["ntt_fwd"],
            "ksk_ms_per_key": {"host": host_ms,
                               "device_median": statistics.median(device_ms),
                               "device_all": device_ms,
                               "device_first": first_ms},
            "generate_keys_s": {
                "host": host_s, "host_ksk": host_ksk_s,
                "host_rest": host_s - host_ksk_s,
                "device": dev_s, "device_ksk": dev_ksk_s,
                "device_rest": dev_s - dev_ksk_s}}
        print(f"keygen {name} " + json.dumps(out[name]), flush=True)
    return out


def profiling_phase(device, compiled, paths):
    """Phase 3b: eva_tpu_torch.profiling on the card: the HBM roofline,
    profile()'s table at N = 16384 (6 data entries), the calibration it
    gives, and estimate_program for each program (with its committed
    defaults and with this run's calibration) beside the program's
    captured execute and device busy time from phase 3."""
    from eva_tpu_torch import profiling

    t0 = time.perf_counter()
    results, hbm, n_sub = profiling.profile(16384, 6, device)
    print("profiling roofline " + json.dumps(
        {"hbm_bytes_per_s": hbm, "nominal_bytes_per_s": HBM_BYTES_PER_S,
         "share_of_nominal": hbm / HBM_BYTES_PER_S}), flush=True)
    print("profiling table " + json.dumps(
        [{"case": name, "us_per_ct_op": us, "bytes_per_s": achieved,
          "roofline_share": frac, "rows_per_ct_op": n_sub}
         for name, us, achieved, frac in results]), flush=True)
    calib = profiling.calibration(results, hbm, n_sub)
    print("profiling calibration " + json.dumps(calib), flush=True)
    out = {}
    for name, (prog, params) in compiled.items():
        totals, total = profiling.estimate_program(prog, params)
        run, run_total = profiling.estimate_program(prog, params, **calib)
        cap = paths[name]["captured"]
        out[name] = {
            "estimate_ms": total * 1e3, "estimate_ms_this_run": run_total * 1e3,
            "by_class": {c: {"count": n, "ms": t * 1e3, "ms_this_run":
                             run[c][1] * 1e3}
                         for c, (n, t) in totals.items()},
            "captured_execute_ms": cap["execute_ms_median"],
            "device_busy_ms": cap["profile"]["device_ms"]}
        if not (total > 0 and run_total > 0):
            raise AssertionError(f"{name}: estimate {total}, {run_total}")
    print("estimate_vs_measured " + json.dumps(out), flush=True)
    print(f"profiling_s {time.perf_counter() - t0:.2f}", flush=True)
    return out


NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
KS_KERNELS = ("ks_mac_cluster_kernel", "ks_epilogue_key_kernel",
              "ks_epilogue_row_kernel")
MODMATH_KERNELS = ("mod_ew_kernel", "mod_ew_multi_kernel",
                   "mod_ew_mac_kernel", "tensor_product_kernel",
                   "divide_last_kernel")


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
            "ntt_ms": ms(NTT_KERNELS),
            "ks_ms": ms(KS_KERNELS),
            "modmath_ms": ms(MODMATH_KERNELS),
            "modmath_ms_by_kernel": {k: ms((k,)) for k in MODMATH_KERNELS},
            "other_ms": sum(r[0] for r in rows if not any(
                k in r[2] for k in NTT_KERNELS + KS_KERNELS
                + MODMATH_KERNELS)) / 1e3,
            "kernel_launches": {k: sum(r[1] for r in rows if k in r[2])
                                for k in NTT_KERNELS + KS_KERNELS
                                + MODMATH_KERNELS},
            "wall_ms": wall, "device_ops": sum(r[1] for r in rows)}


def check_replay_launches(name, prof, launches):
    """The kernels one replayed execute ran on the device (profiler, by
    name) against the launches its capture counted: equal, and none
    zero."""
    ks = launches["ks_launches"]
    ew = launches["modmath_launches"]
    want = {"ntt_fwd_kernel": launches["ntt_launches"].get("ntt_fwd", 0),
            "ntt_inv_kernel": launches["ntt_launches"].get("ntt_inv", 0),
            "ks_mac_cluster_kernel": ks.get("ks_mac", 0),
            "ks_epilogue_key_kernel": ks.get("ks_epilogue", 0),
            "ks_epilogue_row_kernel": ks.get("ks_epilogue", 0),
            "mod_ew_kernel": ew.get("mod_ew", 0),
            "mod_ew_multi_kernel": ew.get("mod_ew_multi", 0),
            "mod_ew_mac_kernel": ew.get("mod_ew_mac", 0),
            "tensor_product_kernel": ew.get("tensor_product", 0),
            "divide_last_kernel": ew.get("divide_last", 0)}
    got = (prof or {}).get("kernel_launches")
    if got != want or not min(want.values()) > 0:
        raise AssertionError(f"{name}: the replayed execute launched "
                             f"{got}, its capture counted {want}")


def replay_phase(name, pub, compiled, enc, ref_out, reps=5):
    """One program's captured graph: a replay's output against the numpy
    backend, its launch counters against the capture's counts, its wall
    median, its profile (kernel launches by name against the capture's
    counts), and the host time of one replayed execute by step."""
    entry = captured_entry(pub, compiled, [enc])
    check_int32(f"{name} captured graph", entry.out)
    reset_counts()
    out = pub.execute(compiled, enc)
    counts = read_counts()
    check_equal(f"{name} replay against the numpy backend", ref_out, out)
    if any(_plain(counts).values()):
        raise AssertionError(f"{name}: a replay called a plain version: "
                             f"{counts}")
    check_launches(f"{name} replay", counts, entry.launches)
    times = execute_ms(pub, compiled, enc, reps)
    prof = profile_execute(name, pub, compiled, enc)
    check_replay_launches(name, prof, entry.launches)
    wall = statistics.median(times)
    return {"execute_ms_median": wall, "execute_ms_all": times,
            "replay_ms": replay_ms(entry),
            "profile": prof, "idle_share": 1 - prof["device_ms"] / wall,
            "capture_s": entry.capture_s,
            "graph_pool_bytes": entry.pool_bytes,
            "launches_per_execute": entry.launches,
            "host_ms": host_steps(pub, compiled, enc, reps)}


def host_steps(pub, compiled, enc, reps):
    """Medians over `reps` replayed executes of each step's ms on the
    host: the host planner (`_host_phase`: raw values, encode-cache
    look-ups), splitting the valuation into host arrays (`_split`) and
    finding its graph, staging the inputs into the graph's static
    tensors (`fill`), launching the graph (`replay`), enqueueing the
    output copies, waiting for the device, and building the host
    ciphertexts (`_result`)."""
    import torch
    from eva_tpu_torch.backend.executor_torch import _copy_out
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    steps = {k: [] for k in ("host_phase", "split", "fill", "replay",
                             "enqueue_out", "device_wait", "result")}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        hv = ex._host_phase(enc)[0]
        t.append(time.perf_counter())
        parts = tp._split([hv], False)
        entry = tp._captured[tp._capture_key(*parts)]
        t.append(time.perf_counter())
        entry.fill(*parts[:2])
        t.append(time.perf_counter())
        entry.replay()
        t.append(time.perf_counter())
        host, done = _copy_out(entry.out)
        t.append(time.perf_counter())
        done.synchronize()
        t.append(time.perf_counter())
        tp._result(host)
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t, t[1:]):
            steps[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in steps.items()}


def capture_phase(name, pub, compiled, enc, ref_out, reps=5):
    """Captured against eager for one program: the replay phase, then
    the same execute with TorchProgram._capture off (eager launches),
    bit-identical to the replay, with its counts, wall median and
    profile."""
    from eva_tpu_torch.backend.executor_torch import TorchProgram

    res = replay_phase(name, pub, compiled, enc, ref_out, reps)
    captured = pub.execute(compiled, enc)
    TorchProgram._capture = False
    try:
        reset_counts()
        eager = pub.execute(compiled, enc)
        counts = read_counts()
        times = execute_ms(pub, compiled, enc, reps)
        prof = profile_execute(f"{name}_eager", pub, compiled, enc, top=0)
    finally:
        TorchProgram._capture = True
    if prof is None:
        raise AssertionError(f"{name}: the profiler saw no device time")
    check_equal(f"{name}: eager against captured", captured, eager)
    check_launches(f"{name} eager", counts, res["launches_per_execute"])
    wall = statistics.median(times)
    res["eager"] = {"execute_ms_median": wall, "execute_ms_all": times,
                    "profile": prof,
                    "idle_share": 1 - prof["device_ms"] / wall}
    return res


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
    tp = pub._executor_for(compiled)._get_torch_program()
    if not any(key[0][0][2][0] == 4 for key in tp._captured):
        raise AssertionError("sobel batch: no graph captured at batch 4")
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


def _mesh_payload(pub, encs, want):
    """The key set, ciphertexts and single-device outputs as plain arrays
    for the ranks of a multi-card mesh run (mesh_rank_main)."""
    ks = pub._keys

    def kd(k):
        return dict(k0=list(k.k0), k1=list(k.k1), alpha=k.alpha)

    return {
        "keys": dict(secret_coeffs=ks.secret.coeffs, secret_s=ks.secret.s,
                     public_b=ks.public.b, public_a=ks.public.a,
                     relin=kd(ks.relin),
                     galois={g: kd(k) for g, k in ks.galois.items()}),
        "encs": [(e["image"].polys, e["image"].level, e["image"].scale)
                 for e in encs],
        "want": [[np.asarray(p) for p in w["image"].polys] for w in want]}


def mesh_rank_main(rank: int, world: int, port: int, tmp: str) -> int:
    """One rank of a multi-card mesh run (one process per card, NCCL):
    Sobel 90x90 execute_batch on a {batch, limb} and a {seq} mesh against
    the single-device outputs in the payload. Rank 0 writes the
    results."""
    import pickle

    import torch
    import torch.distributed as dist
    from eva_tpu_torch import convert
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.parallel import make_device_mesh, seq_compatible
    from eva_tpu_torch.runtime import EVAPublic

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, device_id=device)
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as fh:
            payload = pickle.load(fh)
        compiled, params, _ = CKKSCompiler(
            {"warn_vec_size": "false"}).compile(build_sobel())
        from eva_tpu_torch.crypto.context import get_context
        ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                          params.poly_modulus_degree, params.key_terms)
        kp = payload["keys"]
        keys = convert.keyset_from_numpy(
            ctx, kp["secret_coeffs"], kp["public_b"], kp["public_a"],
            relin=kp["relin"], galois=kp["galois"], secret_s=kp["secret_s"])
        pub = EVAPublic(ctx, keys, params, device=device)
        encs = [{"image": convert.ciphertext_from_numpy(*e)}
                for e in payload["encs"]]
        meshes = {"batch_limb": {"limb_axis": 2 if world % 2 == 0 else 1}}
        if seq_compatible(ctx.n, world):
            meshes["seq"] = {"seq_axis": world}
        tp = pub._executor_for(compiled)._get_torch_program()
        results = {}
        for label, args in meshes.items():
            mesh = make_device_mesh(world, **args)
            out = pub.execute_batch(compiled, encs, mesh=mesh)
            equal = all(np.array_equal(a, b) for o, w in
                        zip(out, payload["want"])
                        for a, b in zip(o["image"].polys, w))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pub.execute_batch(compiled, encs, mesh=mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(encs)
            (plan,) = {v[1] for v in tp._sharded_cache.values()
                       if v[0] is mesh}
            # The plan ran as a replayed graph: the single-device
            # program's for "batch", else one keyed by this mesh.
            graphs = [e for e in tp._captured.values()
                      if e.mesh is (None if plan == "batch" else mesh)]
            results[label] = {
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "plan": plan, "captured": bool(graphs),
                "capture_s": [e.capture_s for e in graphs],
                "graph_pool_bytes": [e.pool_bytes for e in graphs],
                "bit_identical": equal, "ms_per_request": ms}
            del graphs
            # Its graphs hold NCCL work: the process groups' destroy
            # waits for them.
            pub.release_mesh(mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as fh:
            pickle.dump(results, fh)
    return 0


def multi_card_mesh(pub, encs, want, world: int):
    """Spawn one rank per card (this script with --mesh-rank) and run
    Sobel on {batch, limb} and {seq} meshes against the single-device
    outputs `want`; every process is waited for (or killed)."""
    import pickle
    import tempfile

    from eva_tpu_torch.profiling import _free_port
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as fh:
            pickle.dump(_mesh_payload(pub, encs, want), fh)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), str(world), str(port), tmp], cwd=root)
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"mesh ranks exited {rcs}")
        with open(os.path.join(tmp, "result.pkl"), "rb") as fh:
            results = pickle.load(fh)
    for label, res in results.items():
        if not res["bit_identical"]:
            raise AssertionError(f"sobel on the {label} mesh of {world} "
                                 f"cards differs from one card")
        if not res["captured"]:
            raise AssertionError(f"sobel on the {label} mesh of {world} "
                                 f"cards: plan {res['plan']} ran no "
                                 f"captured graph")
    return results


# The forced one-rank mesh plans (TorchProgram._force_plan) and the
# kernels each launches; every other kernel of the path stays at 0. dp's
# key switches are digit-parallel and structured (digits, all-reduce,
# iNTT, E3, NTT: no K4/K5, no E1 MAC form); seq routes every transform
# through ShardedNTT, whose stages are E1 launches (no K1/K2), and MACs
# structured digits (E1's MAC form); dp+seq takes neither K1/K2 nor the
# MAC form.
MESH_PLANS = {
    "dp": {"ntt_fwd", "ntt_inv", "mod_ew", "mod_ew_multi", "tensor_product",
           "divide_last"},
    "seq": {"mod_ew", "mod_ew_multi", "mod_ew_mac", "tensor_product",
            "divide_last"},
    "dp+seq": {"mod_ew", "mod_ew_multi", "tensor_product", "divide_last"},
}


def check_plan_counts(name, counts, plan):
    """The kernels of MESH_PLANS[plan] launched, no other kernel and no
    plain version."""
    launches = path_launches(counts)
    ran = {k for k, v in launches.items() if v and k != "plain_calls"}
    if ran != MESH_PLANS[plan] or launches["plain_calls"]:
        raise AssertionError(f"{name}: launched {launches}, want "
                             f"{sorted(MESH_PLANS[plan])}")


def mesh_plan_phase(pub, compiled, mesh, batches, wants, plan, reps=3):
    """One forced plan of Sobel's batch of 4 on the one-rank mesh. The
    first call warms up, captures the plan's graph (its collectives
    inside) and replays it on the first batch; a second replay, with
    the counts reset just before and read just after, on another batch:
    the kernels of the plan, as many as the capture counted. Each
    replay bit-identical to its batch without a mesh (`wants`); the
    first batch with TorchProgram._capture off (eager) bit-identical to
    its replay, with the launches the capture counted; ms a request,
    captured and eager in turns; device ms of one replay; the capture's
    seconds and pool bytes."""
    import torch

    from eva_tpu_torch.backend.executor_torch import TorchProgram
    tp = pub._executor_for(compiled)._get_torch_program()
    name = f"sobel mesh {plan}"
    TorchProgram._force_plan = plan
    try:
        got = pub.execute_batch(compiled, batches[0], mesh=mesh)
        (entry,) = [e for k, e in tp._captured.items()
                    if e.mesh is mesh and k[-1] == plan]
        check_int32(name, entry.out)
        for b, (w, g) in enumerate(zip(wants[0], got)):
            check_equal(f"{name} element {b}", w, g)
        reset_counts()
        second = pub.execute_batch(compiled, batches[1], mesh=mesh)
        counts = read_counts()
        check_plan_counts(name, counts, plan)
        check_launches(f"{name} replay", counts, entry.launches)
        for b, (w, g) in enumerate(zip(wants[1], second)):
            check_equal(f"{name} second batch element {b}", w, g)
        TorchProgram._capture = False
        try:
            reset_counts()
            eager = pub.execute_batch(compiled, batches[0], mesh=mesh)
            eager_counts = read_counts()
        finally:
            TorchProgram._capture = True
        check_launches(f"{name} eager", eager_counts, entry.launches)
        for b, (g, e) in enumerate(zip(got, eager)):
            check_equal(f"{name} eager element {b}", g, e)
        ms = {"captured": [], "eager": []}
        for label in ("captured", "eager", "eager", "captured") * reps:
            TorchProgram._capture = label == "captured"
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pub.execute_batch(compiled, batches[0], mesh=mesh)
                ms[label].append((time.perf_counter() - t0) * 1e3
                                 / len(batches[0]))
            finally:
                TorchProgram._capture = True
    finally:
        TorchProgram._force_plan = None
    return {"counts": counts,
            "ms_per_request": {k: statistics.median(v)
                               for k, v in ms.items()},
            "ms_per_request_all": ms,
            "replay_ms": replay_ms(entry),
            "capture_s": entry.capture_s,
            "graph_pool_bytes": entry.pool_bytes,
            "launches_per_replay": entry.launches}


def mesh_phase(device, pub, compiled, sig, seed, reps=3):
    """Multi-device execution at world size 1 over NCCL (the machine has
    one card): execute_batch of 4 Sobel requests on a (batch 1, limb 1)
    mesh, bit-identical to the same batch without a mesh, through the
    captured single-device program (K1, K2, K4, K5 launched, no plain
    version), both timed in turns; ShardedKeySwitch at one shard at
    Sobel's level 0 against the fused key switch, and ShardedNTT at one
    shard at [11, 16384] against K1, bit-identical and timed eagerly and
    as graph replays; the one-rank collective overhead. Then the
    digit-parallel, seq and dp+seq programs forced on the same mesh
    (mesh_plan_phase), each through its captured graph with its NCCL
    collectives inside. With more than one card, Sobel on {batch, limb}
    and {seq} meshes of one rank per card as well."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from eva_tpu_torch import profiling
    from eva_tpu_torch.backend.tables import DeviceLevelOps
    from eva_tpu_torch.parallel import (ShardedKeySwitch, get_sharded_ntt,
                                        make_device_mesh)

    rng = np.random.default_rng(seed)
    encs = [pub.encrypt({"image": rng.uniform(0, 1, sig.vec_size).tolist()},
                        sig) for _ in range(8)]
    encs, encs2 = encs[:4], encs[4:]
    tp = pub._executor_for(compiled)._get_torch_program()
    mesh = None
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{profiling._free_port()}",
        world_size=1, rank=0, device_id=device)
    try:
        mesh = make_device_mesh(1)
        want = pub.execute_batch(compiled, encs)
        reset_counts()
        got = pub.execute_batch(compiled, encs, mesh=mesh)
        counts = read_counts()
        check_counts("sobel mesh", counts, fused=True)
        plans = [v[1] for v in tp._sharded_cache.values() if v[0] is mesh]
        if plans != ["batch"]:
            raise AssertionError(f"sobel mesh: plans {plans}")
        for b, (w, g) in enumerate(zip(want, got)):
            check_equal(f"sobel mesh element {b}", w, g)
        ms = {"no_mesh": [], "mesh": []}
        for label in ("no_mesh", "mesh", "mesh", "no_mesh") * reps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pub.execute_batch(compiled, encs,
                              mesh=mesh if label == "mesh" else None)
            ms[label].append((time.perf_counter() - t0) * 1e3 / len(encs))

        # ShardedKeySwitch, one shard, against the fused key switch.
        ctx, keys = pub.ctx, pub._keys
        n = ctx.n
        primes = ctx.primes_at_level(0)
        poly = residues(rng, primes, (n,), device)
        sks = ShardedKeySwitch(ctx, keys.relin, 0, init_device_mesh(
            "cuda", (1,), mesh_dim_names=("digit",)))
        fused = tp._key_switch(poly, 0, keys.relin)
        sharded = sks(poly)
        for name, a, b in zip(("d0", "d1"), fused, sharded):
            if not torch.equal(a, b):
                raise AssertionError(f"ShardedKeySwitch {name} differs from "
                                     f"the fused key switch")
        ks_ms = {"sharded_1": eager_ms(lambda: sks(poly), 20),
                 "fused": eager_ms(lambda: tp._key_switch(poly, 0,
                                                          keys.relin), 20),
                 "sharded_1_graph": graph_ms(lambda: sks(poly), 20),
                 "fused_graph": graph_ms(
                     lambda: tp._key_switch(poly, 0, keys.relin), 20)}

        # ShardedNTT, one shard, against K1.
        dev = DeviceLevelOps(primes, n, device)
        sntt = get_sharded_ntt(tuple(primes), n, dist.group.WORLD, device)
        x3 = poly.reshape(len(primes), sntt.n1, sntt.n2)
        if not torch.equal(sntt.ntt(x3).reshape(len(primes), n),
                           dev.ntt(poly)):
            raise AssertionError("ShardedNTT differs from K1")
        if not torch.equal(sntt.intt(sntt.ntt(x3)), x3):
            raise AssertionError("ShardedNTT does not round-trip")
        ntt_ms = {"sharded_1": eager_ms(lambda: sntt.ntt(x3), 10),
                  "k1": eager_ms(lambda: dev.ntt(poly), 50),
                  "sharded_1_graph": graph_ms(lambda: sntt.ntt(x3), 10),
                  "k1_graph": graph_ms(lambda: dev.ntt(poly), 50)}
        wants = (want, pub.execute_batch(compiled, encs2))
        forced = {plan: mesh_plan_phase(pub, compiled, mesh, (encs, encs2),
                                        wants, plan)
                  for plan in MESH_PLANS}
        overhead = profiling.measure_collective_overhead_us(device)
        world = torch.cuda.device_count()
        multi = (multi_card_mesh(pub, encs, want, world) if world > 1
                 else None)
    finally:
        # The mesh programs' graphs hold NCCL work of this world's
        # communicators: the communicators' destroy waits for them.
        if mesh is not None:
            pub.release_mesh(mesh)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    return {
        "ranks": 1, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "plans": plans, "batch4": counts,
        "ms_per_request": {k: statistics.median(v) for k, v in ms.items()},
        "ms_per_request_all": ms,
        "sharded_key_switch_ms": ks_ms, "ks_shape": [len(primes), n],
        "sharded_ntt_ms": ntt_ms, "ntt_shape": [len(primes), n],
        "collective_overhead_us": overhead, "cards": world,
        "multi_card": multi, "forced_plans": forced}


# The fuzz phase: random programs of tools/fuzz_cuda.py (N cycling through
# 8192 / 16384 / 32768, so 12 programs at each), then every program of the
# reference's matrices (tests/test_he.py, tests/test_large.py) once.
FUZZ_PROGRAMS = 36
FUZZ_SEED = 0xC0DA


def fuzz_phase():
    """Whole programs at shapes no kernel check chose, each on the card
    against the port's numpy backend (residues, level) and the plain
    versions on the CPU (residues, level, scale), its decryption within
    MSE 0.01 (tools/fuzz_cuda.check_program): FUZZ_PROGRAMS random
    programs from FUZZ_SEED, then the matrix programs. Fails on any
    mismatch, on a kernel never launched, and unless the random programs
    cover each N at least 4 times, both key-switch routes, alpha 1 and
    the default, and all four rescalers. Returns the counts of the phase
    (keygen included)."""
    import torch
    for sub in ("tools", "tests"):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), sub))
    import fuzz_cuda
    from torch_random_programs import RESCALERS

    def log(line):
        print(line, flush=True)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    records, failures = fuzz_cuda.check_all(
        fuzz_cuda.random_cases(FUZZ_PROGRAMS, FUZZ_SEED), log)
    t_random = time.perf_counter() - t0
    matrix, more = fuzz_cuda.check_all(fuzz_cuda.matrix_cases(), log)
    failures += more
    counts = read_counts()
    summary = fuzz_cuda.summary(records)
    out = {"random": {**summary, "seed": FUZZ_SEED, "s": t_random},
           "matrix": {**fuzz_cuda.summary(matrix),
                      "s": time.perf_counter() - t0 - t_random},
           "failures": len(failures), "s": time.perf_counter() - t0,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "allocated_after_bytes": torch.cuda.memory_allocated(),
           "launches": {k: v for c in ("ntt_launches", "ks_launches",
                                       "modmath_launches")
                        for k, v in counts[c].items()}}
    log("fuzz " + json.dumps(out))
    if failures:
        raise AssertionError(f"fuzz: {len(failures)} failures: {failures}")
    unlaunched = [k for k, v in out["launches"].items() if not v]
    if unlaunched:
        raise AssertionError(f"fuzz: kernels never launched: {unlaunched}")
    short = {
        "N": [n for n in fuzz_cuda.RING_SIZES
              if summary["by_N"].get(n, 0) < 4],
        "route": [r for r in ("fused", "structured")
                  if r not in summary["by_route"]],
        "alpha": [a for a in (1, "default") if a not in summary["by_alpha"]],
        "rescaler": [r for r in RESCALERS
                     if r not in summary["by_rescaler"]]}
    if any(short.values()):
        raise AssertionError(f"fuzz: the random programs miss {short}")
    return counts


# The 4-role protocol of examples/serialization.py for Sobel 90x90:
# the files each role hands on, and run_program's seed for Sobel.
PROTOCOL_SEED = 11
PROTOCOL_FILES = {"program": "sobel.eva", "params": "sobel.evaparams",
                  "signature": "sobel.evasignature",
                  "public": "sobel.evapublic", "secret": "sobel.evasecret",
                  "inputs": "sobel_inputs.evavals",
                  "outputs": "sobel_outputs.evavals"}


def _timed(fn, *args, **kw):
    """(fn(*args, **kw), its wall seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def protocol_client(tmp: str, device=None):
    """The compile, key-generation and encrypt roles of the protocol, in
    this process: compile Sobel 90x90, save the program, parameters and
    signature; load the parameters, generate keys on `device` (None: the
    CUDA device), save the public and secret contexts; encrypt seeded
    inputs and save them. Returns (the in-memory objects, save and load
    seconds by object)."""
    from eva_tpu_torch import load, save
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    path = lambda what: os.path.join(tmp, PROTOCOL_FILES[what])
    save_s, load_s = {}, {}
    prog = build_sobel()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    for what, obj in (("program", compiled), ("params", params),
                      ("signature", sig)):
        _, save_s[what] = _timed(save, obj, path(what))
    params, load_s["params"] = _timed(load, path("params"))
    pub, sec = generate_keys(params, device=device)
    for what, obj in (("public", pub), ("secret", sec)):
        _, save_s[what] = _timed(save, obj, path(what))
    rng = np.random.default_rng(PROTOCOL_SEED)
    inputs = {"image": rng.uniform(0, 1, prog.vec_size).tolist()}
    enc = pub.encrypt(inputs, sig)
    _, save_s["inputs"] = _timed(save, enc, path("inputs"))
    objects = {"prog": prog, "compiled": compiled, "sig": sig, "pub": pub,
               "inputs": inputs, "enc": enc}
    return objects, save_s, load_s


def protocol_server(tmp: str, device="cuda:0", reps: int = 5):
    """The server role: load the program, signature, public context (on
    `device`; the process's CUDA start-up timed first, apart) and
    encrypted inputs; execute twice (the first call captures the
    program's graph, the second replays it), the counts reset just
    before the second and read just after it; save the output
    valuation; then `reps` more warm executes, timed. Returns its times
    (with the codec's read and decode of the public context's file
    apart, and the graph capture's seconds inside the first execute),
    counts and the device the public context loaded on."""
    import torch
    from eva_tpu_torch import load, save
    from eva_tpu_torch.serialization import wire

    def cuda_start():
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)

    path = lambda what: os.path.join(tmp, PROTOCOL_FILES[what])
    load_s = {}
    cuda_start_s = (_timed(cuda_start)[1]
                    if torch.device(device).type == "cuda" else None)
    compiled, load_s["program"] = _timed(load, path("program"))
    _, load_s["signature"] = _timed(load, path("signature"))
    pub, load_s["public"] = _timed(load, path("public"), device=device)
    enc, load_s["inputs"] = _timed(load, path("inputs"))

    def execute():
        out = pub.execute(compiled, enc)
        if pub.device.type == "cuda":
            torch.cuda.synchronize()
        return out

    _, first_s = _timed(execute)
    reset_counts()
    out, warm_s = _timed(execute)
    counts = read_counts()
    _, save_s = _timed(save, out, path("outputs"))
    warm_ms = [_timed(execute)[1] * 1e3 for _ in range(reps)]

    def decode_public():
        with open(path("public"), "rb") as f:
            env = wire.decode("KnownType", f.read())
        return wire.decode(wire.any_type_name(env.contents),
                           env.contents.value)

    tp = pub._executor_for(compiled)._get_torch_program()
    return {"device": str(pub.device), "cuda_start_s": cuda_start_s,
            "load_s": load_s, "save_s": {"outputs": save_s},
            "public_read_decode_s": _timed(decode_public)[1],
            "capture_s": [e.capture_s for e in tp._captured.values()],
            "execute_ms": {"first": first_s * 1e3, "warm": warm_s * 1e3,
                           "warm_median": statistics.median(warm_ms),
                           "warm_all": warm_ms},
            "counts": counts}


def serve_main(tmp: str) -> int:
    """`chip_smoke.py --serve DIR`: the server role on the card, in a
    process of its own; fails unless the public context loaded on the
    card, the warm execute launched every kernel of the path with no
    plain version (check_counts), and protobuf was never imported.
    Prints one `serve {...}` line."""
    res = protocol_server(tmp)
    if not res["device"].startswith("cuda"):
        raise AssertionError(f"serve: public context on {res['device']}")
    check_counts("protocol server", res["counts"], fused=True)
    if "google.protobuf" in sys.modules:
        raise AssertionError("serve: google.protobuf was imported")
    print("serve " + json.dumps(res), flush=True)
    return 0


def protocol_check(tmp: str, objects: dict, server: dict, save_s: dict,
                   load_s: dict) -> dict:
    """The client again: load the secret context and the server's
    output, decrypt. Fails unless the output's residues are
    bit-identical (per polynomial) to an execute here of the same
    ciphertexts with the original public context, with the same level
    and scale, and the MSE is below MSE_LIMIT["sobel"]. Returns the
    protocol line."""
    from eva_tpu_torch import evaluate, load
    from eva_tpu_torch.metric import valuation_mse

    path = lambda what: os.path.join(tmp, PROTOCOL_FILES[what])
    sec, load_s["secret"] = _timed(load, path("secret"))
    out, load_s["outputs"] = _timed(load, path("outputs"))
    want = objects["pub"].execute(objects["compiled"], objects["enc"])
    if set(out) != set(want):
        raise AssertionError(f"protocol: outputs {sorted(out)}, want "
                             f"{sorted(want)}")
    for k in want:
        if len(out[k].polys) != len(want[k].polys) or (
                out[k].level, out[k].scale) != (want[k].level,
                                                 want[k].scale):
            raise AssertionError(
                f"protocol: {k} has {len(out[k].polys)} polynomials at "
                f"level {out[k].level}, scale {out[k].scale}; want "
                f"{len(want[k].polys)} at {want[k].level}, "
                f"{want[k].scale}")
    check_equal("protocol: the server's output against this process's "
                "execute", want, out)
    dec = sec.decrypt(out, objects["sig"])
    mse = valuation_mse(dec, evaluate(objects["prog"], objects["inputs"]))
    if not mse < MSE_LIMIT["sobel"]:
        raise AssertionError(f"protocol: MSE {mse} >= {MSE_LIMIT['sobel']}")
    return {
        "program": "sobel", "N": objects["pub"].params.poly_modulus_degree,
        "mb": {what: os.path.getsize(path(what)) / 1e6
               for what in PROTOCOL_FILES},
        "save_s": {**save_s, **server["save_s"]},
        "load_s": {**load_s, **server["load_s"]},
        "server_device": server["device"],
        "server_cuda_start_s": server["cuda_start_s"],
        "server_public_read_decode_s": server["public_read_decode_s"],
        "server_capture_s": server["capture_s"],
        "server_execute_ms": server["execute_ms"],
        "launches_per_execute": path_launches(server["counts"]),
        "mse": mse, "bit_identical": True}


def protocol_phase():
    """The 4-role protocol on the card through files in a temporary
    directory: protocol_client here, the server as `chip_smoke.py
    --serve DIR` (a process of its own; exit 0 required), then
    protocol_check here; fails if this process imported google.protobuf.
    Prints the server's lines and one `protocol {...}` line; returns
    (the line, the server's counts)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        objects, save_s, load_s = protocol_client(tmp)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--serve", tmp],
            capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"server: {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"--serve exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        (line,) = [l for l in proc.stdout.splitlines()
                   if l.startswith("serve ")]
        server = json.loads(line[len("serve "):])
        result = protocol_check(tmp, objects, server, save_s, load_s)
    if "google.protobuf" in sys.modules:
        raise AssertionError("protocol: google.protobuf was imported")
    print("protocol " + json.dumps(result), flush=True)
    return result, server["counts"]


EXAMPLES = ("examples/image_processing_torch.py",
            "examples/regression_torch.py",
            "examples/serialization_torch.py")
# The reference's tolerance for an HE result against the plaintext one
# (examples/regression.py's assert, tests/test_he.py).
EXAMPLE_MSE_LIMIT = 0.01
SOL_PCT_LIMIT = 105


def entry_phase():
    """The user's entry points on the card: the three card examples as
    subprocesses (exit 0; every MSE the image example prints below
    EXAMPLE_MSE_LIMIT, and Sobel's and Harris's both printed; the
    serialization example's one MSE below it), then
    bench_torch.run at full size with one pass, the counts reset just
    before it and read just after. Fails unless the line holds every key
    of bench.py's (bench_torch.LINE_EXTRAS), every sampled metric,
    host baseline, first-execute and compile time is positive, every
    kernel_sol step's us positive and its sol_pct and compute_pct at
    most SOL_PCT_LIMIT, both MSEs below MSE_LIMIT, and K1, K2, K4, K5,
    E1 in its three forms, E2, E3 and E4 launched with no plain version
    called (check_bench_line, check_counts). Returns (the line, the
    counts, the examples' results)."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    examples = {}
    for script in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script], cwd=root,
                              capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"example {script}: {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"{script} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        mse = {name: float(v) for name, v in re.findall(
            r"^(\w+): N=.* MSE=(\S+)$", proc.stdout, re.M)}
        examples[script] = {"s": time.perf_counter() - t0, "mse": mse}
        if "image_processing" in script and (
                set(mse) != {"sobel", "harris"}
                or not max(mse.values()) < EXAMPLE_MSE_LIMIT):
            raise AssertionError(f"{script}: MSE {mse}")
        if "serialization" in script:
            mse = [float(v) for v in
                   re.findall(r"^MSE (\S+)$", proc.stdout, re.M)]
            examples[script]["mse"] = mse
            if len(mse) != 1 or not mse[0] < EXAMPLE_MSE_LIMIT:
                raise AssertionError(f"{script}: MSE {mse}")
    print("examples " + json.dumps(examples), flush=True)

    t0 = time.perf_counter()
    reset_counts()
    line = bench_torch.run(passes=1)
    counts = read_counts()
    bench_s = time.perf_counter() - t0
    print("bench " + json.dumps(line), flush=True)
    check_bench_line(line)
    check_counts("bench", counts, fused=True)
    if not counts["probe_launches"]["modmul_burn"] > 0:
        raise AssertionError(f"bench: E4 never launched: {counts}")
    print(f"bench_s {bench_s:.2f}", flush=True)
    return line, counts, examples


def check_bench_line(line):
    """bench_torch's line: every key of bench.py's, every sampled
    metric, host baseline, first-execute and compile time positive, the
    seven kernel_sol steps' us positive and their sol_pct and compute_pct
    at most SOL_PCT_LIMIT, both MSEs below MSE_LIMIT."""
    extras = line["extras"]
    missing = bench_torch.LINE_EXTRAS - set(extras)
    sol = extras["kernel_sol"]
    steps = [k for k, v in sol.items() if isinstance(v, dict) and "us" in v]
    times = ([extras[f"{k}_{u}"] for k, _, u in bench_torch.SAMPLED]
             + [line["value"]]
             + [extras[k] for k in (
                 "ct_mul_host_per_sec", "rotation_host_us",
                 "harris_host_ms", "sobel90_first_execute_s",
                 "harris_first_execute_s", "sobel_compile_cold_s",
                 "sobel_compile_warm_s")]
             + [sol[k]["us"] for k in steps]
             + [sol["hbm_gbs"], sol["vpu_modmul_gops"]])
    over = {k: sol[k] for k in steps
            if not (sol[k]["sol_pct"] <= SOL_PCT_LIMIT
                    and sol[k]["compute_pct"] <= SOL_PCT_LIMIT)}
    if missing or not min(times) > 0 or over or len(steps) != 7:
        raise AssertionError(f"bench: missing {missing}, times {times}, "
                             f"steps {steps}, over {SOL_PCT_LIMIT}%: {over}")
    bad = bench_torch.mse_failures(line)
    if bad:
        raise AssertionError(f"bench: {bad}")


# The port's tools, run as subprocesses by tools_phase: (name, command,
# the kernels its card run must launch; None for the host rehearsal).
# Each tool checks its own results and exits non-zero on a failure: the
# sweep's and the A/B's rotations against the plain versions and their
# noise legs against the numpy backend, the scaling identity, the e2e
# MSE. The scaling runs are small: they check the path and its identity
# (the full-size timings are the standalone runs').
KS_ROUTES = ("ntt_fwd", "ntt_inv", "ks_mac", "ks_epilogue", "mod_ew_mac",
             "divide_last")
SMALL_SCALING = ["--n", "1024", "--limbs", "2", "--batch", "4", "--reps", "1"]
TOOLS = (
    ("sweep_alpha", ["tools/sweep_alpha_torch.py"], KS_ROUTES),
    ("two_entry", ["tools/bench_two_entry_torch.py"], KS_ROUTES),
    ("scaling_nccl", ["tools/bench_scaling_torch.py", "--hosts", "1"]
     + SMALL_SCALING, ("ntt_fwd", "ntt_inv")),
    ("scaling_gloo", ["tools/bench_scaling_torch.py", "--cpu", "--hosts",
                      "2"] + SMALL_SCALING, None),
    ("reproduce_e2e", ["tools/reproduce_torch.py", "e2e"],
     ("ntt_fwd", "ntt_inv", "ks_mac", "ks_epilogue")),
)


def check_tool_line(name: str, need, line: dict) -> dict:
    """A tool's last line, beyond the checks the tool makes itself: a card
    tool names the card, launched every kernel of `need` and called no
    plain version; the sweep timed alpha 1 and 2 at both rings and
    skipped alpha 3 and 4 as duplicates of alpha 2. Returns the card
    launches the tool reports ({} for the host rehearsal), or raises."""
    bad = []
    launches = (line["e2e"] if "e2e" in line else line)["launches"]
    if need is None:
        launches = {}
    elif (launches["plain_calls"] or not all(launches[k] for k in need)
          or not line["card"]):
        bad.append(f"launches {launches}, card {line['card']}")
    if name == "sweep_alpha":
        timed = {(c["n"], c["alpha"]) for c in line["configs"]
                 if "same_groups_as_alpha" not in c}
        dup = {(c["n"], c["alpha"]): c["same_groups_as_alpha"]
               for c in line["configs"] if "same_groups_as_alpha" in c}
        if timed != {(n, a) for n in (16384, 8192) for a in (1, 2)}:
            bad.append(f"configs {timed}")
        if dup != {(n, a): 2 for n in (16384, 8192) for a in (3, 4)}:
            bad.append(f"duplicates {dup}")
    if bad:
        raise AssertionError(f"tool {name}: {bad}")
    return {k: v for k, v in launches.items() if k != "plain_calls"}


def tools_phase():
    """The port's tools (TOOLS) as subprocesses, each to exit 0 with a
    whole last line (check_tool_line): the alpha sweep, the two-entry
    A/B, the scaling rehearsal on one NCCL rank and on two gloo ranks,
    reproduce_torch.py e2e. The host rehearsal (need None) runs beside
    the card tools, which run one after another. Returns their card
    launches summed, in read_counts()'s form (the path counters)."""
    from eva_tpu_torch.backend import ks_cuda, modmath_cuda, ntt_cuda

    root = os.path.dirname(os.path.abspath(__file__))
    total, seconds = {}, {}

    procs = []

    def start(name, cmd, need):
        procs.append(subprocess.Popen(
            [sys.executable] + cmd, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        return name, need, time.perf_counter(), procs[-1]

    def finish(name, need, t0, proc):
        out, err = proc.communicate(timeout=600)
        seconds[name] = time.perf_counter() - t0
        lines = out.strip().splitlines()
        for line in lines:
            print(f"tool {name}: {line}", flush=True)
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"tool {name} exited {proc.returncode}:\n"
                                 f"{err[-4000:]}")
        for k, v in check_tool_line(name, need,
                                    json.loads(lines[-1])).items():
            total[k] = total.get(k, 0) + v

    host = [start(*tool) for tool in TOOLS if tool[2] is None]
    try:
        for tool in TOOLS:
            if tool[2] is not None:
                finish(*start(*tool))
        for tool in host:
            finish(*tool)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("tools " + json.dumps({"s": seconds, "launches": total}),
          flush=True)
    return {counter: {k: total.get(k, 0) for k in kernels}
            for counter, kernels in (
                ("ntt_launches", ntt_cuda.LAUNCHES),
                ("ks_launches", ks_cuda.LAUNCHES),
                ("modmath_launches", modmath_cuda.LAUNCHES))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from eva_tpu_torch.backend import cuda_lib, modmath_cuda, ntt_cuda

    # -- 1. the card and the build -------------------------------------------
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    sources = cuda_lib.build_all(verbose=True)
    print(f"build_s {time.perf_counter() - t0:.2f} (nvcc sm_90a, in "
          f"parallel: {', '.join(os.path.relpath(s, root) for s in sources)})",
          flush=True)

    # -- 2. kernels against their plain version ------------------------------
    kern = kernel_phase(device)
    kern.update(ks_kernel_phase(device))
    kern.update(modmath_kernel_phase(device))
    kern.update(burn_phase(device))

    # -- 3. keygen on the card, then the main path ---------------------------
    keygen = keygen_phase(device)
    paths, compiled_by_name = {}, {}
    programs = (("sobel", build_sobel, 11), ("harris", build_harris, 13),
                ("sobel128", lambda: build_sobel(128, 128), 19))
    for name, build, seed in programs:
        res, (compiled, pub, enc, sig, ref_out) = run_program(
            name, build, seed, None)
        check_counts(name, res, fused=True)
        if not res["mse"] < MSE_LIMIT[name]:
            raise AssertionError(f"{name}: MSE {res['mse']} >= "
                                 f"{MSE_LIMIT[name]}")
        res["shards"] = pub._executor_for(compiled)._get_torch_program().k
        if res["shards"] != (2 if name == "sobel128" else 1):
            raise AssertionError(f"{name}: {res['shards']} shards")
        compiled_by_name[name] = (compiled, pub.params)
        res["captured"] = capture_phase(name, pub, compiled, enc, ref_out)
        prof = res["profile"] = res["captured"]["profile"]
        if not (prof["ks_ms"] > 0 and prof["ntt_ms"] > 0):
            raise AssertionError(f"{name}: the profile shows no NTT or no "
                                 f"key-switch kernel time: {prof}")
        paths[name] = res
        print(f"path {name} " + json.dumps(res), flush=True)
        if name == "sobel":
            sobel = (compiled, pub, enc, sig, ref_out)

    def both(res):
        cap = res["captured"]
        return {
            "captured": {"execute_ms_median": cap["execute_ms_median"],
                         "replay_ms": cap["replay_ms"],
                         "device_ms": cap["profile"]["device_ms"],
                         "device_ops": cap["profile"]["device_ops"],
                         "idle_share": cap["idle_share"],
                         "capture_s": cap["capture_s"],
                         "graph_pool_bytes": cap["graph_pool_bytes"],
                         "host_ms": cap["host_ms"]},
            "eager": {"execute_ms_median":
                      cap["eager"]["execute_ms_median"],
                      "device_ms": cap["eager"]["profile"]["device_ms"],
                      "device_ops": cap["eager"]["profile"]["device_ops"],
                      "idle_share": cap["eager"]["idle_share"]}}

    print("captured_vs_eager " + json.dumps(
        {name: both(paths[name]) for name, *_ in programs}), flush=True)

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
    t0 = time.perf_counter()
    mesh = mesh_phase(device, pub, compiled, sig, 23)
    print("mesh " + json.dumps(mesh), flush=True)
    print(f"mesh_phase_s {time.perf_counter() - t0:.2f}", flush=True)
    paths["sobel_mesh"] = mesh["batch4"]
    for plan, res in mesh["forced_plans"].items():
        paths["sobel_mesh_" + plan.replace("+", "_")] = res["counts"]
    profiling_phase(device, compiled_by_name, paths)
    paths["fuzz"] = fuzz_phase()
    t0 = time.perf_counter()
    _, paths["protocol"] = protocol_phase()
    print(f"protocol_phase_s {time.perf_counter() - t0:.2f}", flush=True)
    t0 = time.perf_counter()
    _, paths["bench"], _ = entry_phase()
    print(f"entry_phase_s {time.perf_counter() - t0:.2f}", flush=True)
    t0 = time.perf_counter()
    paths["tools"] = tools_phase()
    print(f"tools_phase_s {time.perf_counter() - t0:.2f}", flush=True)

    # -- 4. the kernel line, then the device line ----------------------------
    ntt_info = ntt_cuda.kernel_info(14, device)
    kernels = []
    for name, counter, source, replaces, also in (
            ("ntt_fwd", "ntt_launches", "ntt.cu",
             "pallas_ntt.py:310", "pallas_ntt_v2.py:190"),
            ("ntt_inv", "ntt_launches", "ntt.cu",
             "pallas_ntt.py:326", "pallas_ntt_v2.py:205"),
            ("ks_mac", "ks_launches", "ks.cu", "pallas_ks.py:68", None),
            ("ks_epilogue", "ks_launches", "ks.cu", "pallas_ks.py:145",
             None)):
        ntt = counter == "ntt_launches"
        k = kern[(name, "sobel_l0" if ntt else KS_MAIN)]
        entry = {
            "name": name, "route": "cuda",
            "source": f"eva_tpu_torch/csrc/{source}",
            "replaces": f"eva_tpu/backend/{replaces}",
            "launches": paths["sobel"][counter][name],
            "launches_by_path": {p: paths[p][counter][name] for p in paths},
            "launches_per_execute": {
                p: paths[p]["captured"]["launches_per_execute"][counter].get(
                    name, 0) for p in paths if "captured" in paths[p]},
            "launches_keygen": {
                p: paths[p]["keygen_launches"][counter].get(name, 0)
                for p in paths if "keygen_launches" in paths[p]},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "eager_ms": k["eager_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "shape": k["shape"]}
        if also:
            entry["also_replaces"] = f"eva_tpu/backend/{also}"
        fields = ("shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                  "bound_by")
        if name == "ntt_fwd":
            entry["keygen"] = {
                p: {"keys": keygen[p]["keys"],
                    "rows_per_launch": keygen[p]["ntt_rows_per_launch"],
                    **{f: kern[(name, f"keygen_{p}")][f] for f in fields}}
                for p in keygen}
        if ntt:
            res = ntt_info[f"{name}_kernel"]
            entry.update(cluster=k["cluster"], registers=res["registers"],
                         local_bytes=res["local_bytes"])
            entry["by_shape"] = {
                label: {f: kern[(name, label)][f]
                        for f in fields + ("cluster",)}
                for label, *_ in NTT_SHAPES}
        else:
            entry["batch4"] = {f: kern[(name, KS_BATCH4)][f]
                               for f in fields}
            entry["by_shape"] = {key[1]: v for key, v in kern.items()
                                 if key[0] == name}
        kernels.append(entry)
    ew_info = modmath_cuda.kernel_info(device)
    fields = ("shape", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
              "max_abs_err")
    for name, key, replaces, info in (
            ("mod_ew", ("mod_ew", "mul"), "modmath.py:59",
             [f"mod_ew_{op}" for op in EW_OPS]),
            ("mod_ew_multi", ("mod_ew_multi", "mul"), "modmath.py:59",
             [f"mod_ew_multi_{op}" for op in EW_OPS]),
            ("mod_ew_mac", ("mod_ew_mac",), "executor_jax.py:1052",
             ["mod_ew_mac"]),
            ("tensor_product", ("tensor_product",), "tables.py:172",
             ["tensor_product"]),
            ("divide_last", ("divide_last",), "executor_jax.py:75",
             [f"divide_last_k{k}" for k in (1, 2)])):
        k = kern[key + (TIMED_EW,)]
        counter = "modmath_launches"
        entry = {
            "name": name, "route": "cuda",
            "source": "eva_tpu_torch/csrc/modmath.cu",
            "replaces": f"eva_tpu/backend/{replaces}",
            "launches": paths["sobel"][counter][name],
            "launches_by_path": {p: paths[p][counter][name] for p in paths},
            "launches_per_execute": {
                p: paths[p]["captured"]["launches_per_execute"][counter].get(
                    name, 0) for p in paths if "captured" in paths[p]},
            "launches_keygen": {
                p: paths[p]["keygen_launches"][counter].get(name, 0)
                for p in paths if "keygen_launches" in paths[p]},
            **{f: k[f] for f in fields}, "library_ms": None,
            "batch4": {f: kern[key + (TIMED_EW + "_b4",)][f]
                       for f in fields},
            "resources": {i: ew_info[i] for i in info}}
        if name in ("mod_ew", "mod_ew_multi"):
            entry["by_op"] = {op: {f: kern[(name, op, TIMED_EW)][f]
                                   for f in fields}
                              for op in EW_OPS if (name, op, TIMED_EW) in kern}
        if name == "mod_ew":
            entry["ops_per_execute"] = {
                p: paths[p]["captured"]["launches_per_execute"].get(
                    "modmath_ops", {}) for p in paths
                if "captured" in paths[p]}
        if name in ("mod_ew_mac", "divide_last"):
            entry["by_shape"] = {
                lab: {f: v[f] for f in fields}
                for (kn, *_, lab), v in kern.items()
                if isinstance(v, dict) and kn == name}
        kernels.append(entry)
    k = kern[("modmul_burn", "bench")]
    kernels.append({
        "name": "modmul_burn", "route": "cuda",
        "source": "eva_tpu_torch/csrc/modmath.cu",
        "replaces": "bench.py:540 measure_vpu_modmul",
        "launches": paths["bench"]["probe_launches"]["modmul_burn"],
        "launches_by_path": {p: paths[p]["probe_launches"]["modmul_burn"]
                             for p in paths if "probe_launches" in paths[p]},
        **{f: k[f] for f in fields}, "library_ms": None,
        "by_shape": {key[-1]: {f: v[f] for f in fields}
                     for key, v in kern.items() if key[0] == "modmul_burn"},
        "resources": ew_info["modmul_burn"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of multi_card_mesh
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(mesh_rank_main(*map(int, sys.argv[2:5]), sys.argv[5]))
    if sys.argv[1:2] == ["--serve"]:  # the server role of protocol_phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(serve_main(sys.argv[2]))
    sys.exit(main())
