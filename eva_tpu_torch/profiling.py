"""Per-primitive profiling against the memory-bandwidth speed-of-light
model, on the CUDA device.

Port of eva_tpu/profiling.py. Run on the card:

    python -m eva_tpu_torch.profiling [N] [L]        # profile()
    python -m eva_tpu_torch.profiling estimate [sobel|harris|poly]
    python -m eva_tpu_torch.profiling mesh [sobel|harris|poly] [cards]

Times each ciphertext primitive of the port (the dyadic add and
multiply: the CUDA kernel E1; the CUDA NTT kernels K1/K2; the
automorphism gather (galois_perm); the rescale: E3; and a full rotation
through the fused key-switch kernels K4/K5) with the chained-dependency +
host-read slope method and reports achieved bytes/s against the card's HBM
roofline, measured in the same process with a large elementwise pass.
`mesh` prints recommend_mesh's meshes for a program on that many cards
beside the collective constants (COLLECTIVE_CONSTANTS) and the measured
one-rank NCCL overhead. All three raise without a CUDA device;
`estimate_program` and `recommend_mesh` are host-only.

Byte counts are the port's: residues live on the device as int32
tensors of their uint32 bits, so a residue moves RESIDUE_BYTES = 4 bytes,
as in the JAX package's uint32 planes."""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict

import numpy as np

# Bytes one residue moves on the device: 32-bit storage.
RESIDUE_BYTES = 4


def _slope_time(fn: Callable, x0, red, reps_short=4, reps_long=24) -> float:
    """Seconds per execution: slope between two chained run lengths,
    best-of-2 per length. Each chain ends in a host read of a reduction
    of its result (`float(red(cur))`), which waits for the device; the
    slope removes that fixed cost. Launches are asynchronous, so a
    primitive whose host launch time exceeds its device time is timed
    at its launch rate."""
    def chain(reps):
        best = 1e9
        for _ in range(2):
            cur = x0
            t0 = time.perf_counter()
            for _ in range(reps):
                cur = fn(cur)
            _ = float(red(cur))
            best = min(best, time.perf_counter() - t0)
        return best

    chain(1)  # warm
    d1 = chain(reps_short)
    d2 = chain(reps_long)
    per = (d2 - d1) / (reps_long - reps_short)
    if per <= 0:
        # Noise-negative slope: retry, then fall back to the
        # overhead-inclusive average rather than report a near-zero time.
        d1, d2 = chain(reps_short), chain(reps_long)
        per = (d2 - d1) / (reps_long - reps_short)
        if per <= 0:
            per = d2 / reps_long
    return per


def _red(v):
    """A reduction of a residue tensor whose host read ends a chain."""
    return (v >> 31).sum()


def measure_hbm_roofline(device=None, nbytes: int = 128 << 20) -> float:
    """Achievable HBM bytes/s: the best of 3 slopes of one elementwise
    int32 pass over `nbytes` (one read and one write per element, a
    single kernel). The best (smallest) time is the right statistic for
    a ceiling: noise only ever inflates a slope."""
    import torch
    from .backend import resolve_device

    device = resolve_device(device)
    x = torch.ones(nbytes // 4, dtype=torch.int32, device=device)
    per = min(_slope_time(lambda v: v * 3, x, _red) for _ in range(3))
    return 2 * x.numel() * 4 / per  # read + write


def profile(n: int = 16384, n_entries: int = 6, device=None, *,
            batch: int = 16, roofline_bytes: int = 128 << 20):
    """Time each primitive on `device` (None: the CUDA device; raises
    without one) over a batch of random reduced planes of the data
    primes of a chain of `n_entries` 60-bit entries (plus one key
    entry) at ring N = `n`; the rotation over half the batch. Returns
    ([(name, us per ciphertext op, achieved bytes/s, fraction of the
    roofline)], roofline bytes/s, rows per ciphertext op)."""
    import torch
    import torch.nn.functional as F
    from .backend import resolve_device
    from .backend.executor_torch import DevPerm, TorchProgram
    from .backend.keygen import DeviceKeygen
    from .backend.ks import divide_last_planes
    from .backend.modmath import upload
    from .backend.tables import level_ops
    from .crypto import keys as K
    from .crypto.context import get_context
    from .crypto.primes import build_chain
    from .ir import Program, TermMap, Type

    device = resolve_device(device)
    bits = [60] * n_entries + [60]
    chain = build_chain(bits, n)
    primes = [q for e in chain[:-1] for q in e.primes]
    dev = level_ops(primes, n, device)
    n_sub = len(primes)
    plane_bytes = batch * n_sub * n * RESIDUE_BYTES
    rng = np.random.default_rng(0)

    def planes(rows):
        out = np.empty((rows, n_sub, n), dtype=np.uint32)
        for i, q in enumerate(primes):
            out[:, i, :] = rng.integers(0, q, (rows, n))
        return upload(out, device)

    x = planes(batch)
    other = planes(batch)
    below = level_ops(primes[:-1], n, device)
    reverse = DevPerm(np.arange(n - 1, -1, -1), device)

    def rescale(v):
        # One divide-and-round step (the rescale / key-switch epilogue),
        # padded back to the input shape so executions can chain.
        return F.pad(divide_last_planes(v, primes, below), (0, 0, 0, 1))

    hbm = measure_hbm_roofline(device, roofline_bytes)
    cases = [
        # (name, fn(cur) -> cur, bytes accessed per execution)
        ("dyadic add", lambda v: dev.add(v, other), 3 * plane_bytes),
        ("dyadic mul (2x mont)", lambda v: dev.mul(v, other),
         3 * plane_bytes),
        ("ntt fwd", dev.ntt, 2 * plane_bytes),
        ("intt", dev.intt, 2 * plane_bytes),
        ("automorphism gather", reverse, 2 * plane_bytes),
        ("rescale (divide+round)", rescale, 2 * plane_bytes),
    ]
    results = []
    for name, fn, nbytes in cases:
        per = _slope_time(fn, x, _red)
        achieved = nbytes / per
        results.append((name, per / batch * 1e6, achieved, achieved / hbm))

    # The dominant op: a full Galois rotation (automorphism, fused key
    # switch K4 + K5, P-division) through TorchProgram._rotate. Bytes: 2
    # poly reads + 2 writes and the key planes streamed once per digit.
    ctx = get_context(tuple(bits), (1,), n)
    assert ctx.data_primes == primes
    engine = DeviceKeygen(ctx, device) if device.type == "cuda" else None
    keys = K.generate_keys(ctx, engine=engine)
    prog = Program("profile", n // 2)
    tp = TorchProgram(prog, ctx, keys, {}, TermMap(Type.Undef), [], device)
    rot_batch = batch // 2
    xr = x[:rot_batch].contiguous()
    n_ext = n_sub + len(ctx.key_primes)
    n_groups = -(-n_sub // keys.ks_alpha)
    key_bytes = 2 * n_groups * n_ext * n * RESIDUE_BYTES
    rot_bytes = rot_batch * 4 * n_sub * n * RESIDUE_BYTES + key_bytes

    def rot(p):
        out = tp._rotate([p, p], 1, 0, dev)
        return dev.add(out[0], out[1])

    per = _slope_time(rot, xr, _red)
    achieved = rot_bytes / per
    results.append(("rotation (full KS)", per / rot_batch * 1e6,
                    achieved, achieved / hbm))
    return results, hbm, n_sub


def calibration(results, hbm: float, n_sub: int) -> Dict[str, float]:
    """estimate_program's keyword calibration from one profile():
    ntt_row_us the mean of the forward and inverse NTT per row,
    perm_row_us the automorphism gather per row, hbm_gbs the roofline,
    hbm_eff the mean fraction of it the dyadic add and multiply reach."""
    us = {name: u for name, u, _, _ in results}
    frac = {name: f for name, _, _, f in results}
    return {"ntt_row_us": (us["ntt fwd"] + us["intt"]) / 2 / n_sub,
            "perm_row_us": us["automorphism gather"] / n_sub,
            "hbm_gbs": hbm / 1e9,
            "hbm_eff": (frac["dyadic add"] + frac["dyadic mul (2x mont)"])
            / 2}


# estimate_program's default calibration: calibration() of one
# profile() at N = 16384, 6 data entries, 32-bit residues, on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit (chip_smoke.py's profiling phase;
# `python -m eva_tpu_torch.profiling` prints the same), its perm_row_us
# while the automorphism ran PyTorch's index_select.
H100_CALIBRATION = {"ntt_row_us": 0.1561, "perm_row_us": 0.1148,
                    "hbm_gbs": 2920.6, "hbm_eff": 0.3412}


def estimate_program(compiled, params, *,
                     ntt_row_us: float = H100_CALIBRATION["ntt_row_us"],
                     perm_row_us: float = H100_CALIBRATION["perm_row_us"],
                     hbm_gbs: float = H100_CALIBRATION["hbm_gbs"],
                     hbm_eff: float = H100_CALIBRATION["hbm_eff"],
                     ks_alpha: int = None, return_resources: bool = False):
    """Speed-of-light cost ESTIMATE of one compiled-program execution on
    one device, from the per-primitive roofline model: the budget a
    measured run is compared against to localize overheads (launches,
    transfers, unfused elementwise passes).

    Model (the JAX package's): NTT/iNTT rows cost ntt_row_us each
    (scaled by N log2 N from N = 16384); automorphism rows cost
    perm_row_us; everything elementwise moves RESIDUE_BYTES per residue
    at hbm_eff * hbm_gbs. Hoisted rotations amortize the shared digit
    stack as the executor does; rotation-sum fusion pays the P-division
    once per finalized sum.

    On the card the constants stand for:
      ntt_row_us   device time of one row of the CUDA NTT kernels
                   (K1/K2) at a large launch: profile()'s "ntt fwd" and
                   "intt" per ciphertext op over its rows. An execute
                   launches 2-12 rows at a time, where a launch costs its
                   latency, not rows x this cost, so the model
                   underestimates the NTT time of an execute;
      perm_row_us  one row of the automorphism gather (galois_perm; the
                   default's value was measured with index_select);
      hbm_gbs      the card's HBM roofline, measure_hbm_roofline();
      hbm_eff      the fraction of it the modular add and multiply
                   reach (one E1 launch each).
    Returns (per-class dict {class: (count, seconds)}, total seconds)."""
    from .crypto.context import get_context
    from .crypto.keys import default_ks_alpha
    from .ir import ROTATION, Op, Type
    from .runtime.executor import Executor

    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree,
                      getattr(params, "key_terms", 1))
    if ks_alpha is None:
        ks_alpha = default_ks_alpha(ctx)  # the alpha generate_keys uses
    ex = Executor(compiled, ctx, None, backend="numpy")
    plan, types, order = ex.plan, ex.types, ex.order
    hoisted = ex._hoisted_sources

    # Rotation-sum fusion: the P-division epilogue is paid once per
    # FINALIZED sum, not once per rotation. Use the executor's own
    # policy simulation to scale the per-rotation epilogue contribution
    # (epi_share = epilogues / rotations; 1.0 with fusion off).
    period = max(ctx.n // 2, compiled.vec_size)
    n_rot = sum(1 for t in order
                if t.op == Op.RotateLeftConst and types[t] == Type.Cipher
                and t.get_attr(ROTATION) % period != 0)
    epi_share = 1.0
    if ex._rotsum_on and n_rot:
        marked, fins_a = ex._simulate_rotsum(defer_mul=True)
        _, fins_b = ex._simulate_rotsum(defer_mul=False)
        fins = fins_a if (marked and ex._ext_encodes) else fins_b
        epi_share = min(fins / n_rot, 1.0)

    n = ctx.n
    n_key = len(ctx.key_primes)
    scale_n = (n * max(np.log2(n), 1)) / (16384 * 14)
    row_ntt = ntt_row_us * 1e-6 * scale_n
    row_perm = perm_row_us * 1e-6 * (n / 16384)
    bw = hbm_gbs * 1e9 * hbm_eff
    k = max(1, compiled.vec_size // (n // 2))

    def nc(level):
        return len(ctx.primes_at_level(level))

    def ew(rows):  # elementwise pass over `rows` N-coefficient rows
        return rows * n * RESIDUE_BYTES / bw

    totals: dict = {}
    hoist_done = set()
    # Resource decomposition (for a mesh cost model): NTT rows split
    # into digit-stage rows vs everything else.
    res = {"ntt_rows_digit": 0.0, "ntt_rows_other": 0.0, "perm_rows": 0.0,
           "ew_rows": 0.0, "ks_sites": 0, "ks_reduce_rows": 0.0,
           "transforms": 0}

    def add(cls, sec):
        c, s = totals.get(cls, (0, 0.0))
        totals[cls] = (c + 1, s + sec)

    for term in order:
        op = term.op
        if types[term] != Type.Cipher or term.index not in plan:
            continue
        lv = plan[term.index].level
        cur = nc(lv)
        n_ext = cur + n_key
        n_groups = -(-cur // ks_alpha)
        if op in (Op.Add, Op.Sub):
            add("add/sub", ew(3 * 2 * cur * k))
            res["ew_rows"] += 3 * 2 * cur * k
        elif op == Op.Negate:
            add("negate", ew(2 * 2 * cur * k))
            res["ew_rows"] += 2 * 2 * cur * k
        elif op == Op.Mul:
            if all(types[o] == Type.Cipher for o in term.operands):
                add("mul ct-ct", ew((4 + 3) * cur * k))
                res["ew_rows"] += (4 + 3) * cur * k
            else:
                add("mul plain", ew((3 + 2) * cur * k))
                res["ew_rows"] += (3 + 2) * cur * k
        elif op == Op.Relinearize:
            digits = (cur + (n_groups - 1) * cur + n_groups * n_key)
            epi = 2 * (n_ext + cur)
            mac = 2 * n_groups * n_ext * 2  # digit+key reads, both polys
            add("relinearize", k * (row_ntt * (digits + epi + cur)
                                    + ew(mac)))
            res["ntt_rows_digit"] += k * digits
            res["ntt_rows_other"] += k * (epi + cur)
            res["ew_rows"] += k * mac
            res["ks_sites"] += 1
            res["ks_reduce_rows"] += k * 2 * n_ext
            res["transforms"] += k * (2 + 2 * n_groups)
        elif op == Op.RotateLeftConst:
            src = term.operands[0]
            hoist_cost = 0.0
            if src.index in hoisted and src.index not in hoist_done:
                hoist_done.add(src.index)
                digits = (cur + (n_groups - 1) * cur + n_groups * n_key
                          - cur)  # own rows reuse the input NTT planes
                hoist_cost = k * row_ntt * (digits + cur)  # + intt(c1)
                res["ntt_rows_digit"] += k * digits
                res["ntt_rows_other"] += k * cur
            elif src.index not in hoisted:
                hoist_cost = k * row_ntt * (
                    cur + n_groups * n_ext)  # intt + full digit NTTs
                res["ntt_rows_digit"] += k * n_groups * n_ext
                res["ntt_rows_other"] += k * cur
            epi = 2 * (n_ext + cur) * epi_share
            mac = 2 * n_groups * n_ext * 2
            add("rotate", hoist_cost
                + k * (row_ntt * epi + ew(mac) + row_perm * 2 * cur))
            res["ntt_rows_other"] += k * epi
            res["ew_rows"] += k * mac
            res["perm_rows"] += k * 2 * cur
            res["ks_sites"] += 1
            res["ks_reduce_rows"] += k * 2 * n_ext
            res["transforms"] += k * (3 + 2 * n_groups)
        elif op == Op.Rescale:
            drop = len(ctx.entries_at_level(lv)[-1].primes)
            add("rescale", k * 2 * (row_ntt * (cur + cur - drop)
                                    + ew(drop * cur)))
            res["ntt_rows_other"] += k * 2 * (cur + cur - drop)
            res["ew_rows"] += k * 2 * drop * cur
            res["transforms"] += k * 4
        elif op == Op.ModSwitch:
            add("modswitch", ew(2 * cur * k))
            res["ew_rows"] += 2 * cur * k
    total = sum(s for _, s in totals.values())
    if return_resources:
        res["row_ntt_s"] = row_ntt
        res["row_perm_s"] = row_perm
        res["hbm_bw"] = bw
        res["n"] = n
        return totals, total, res
    return totals, total


# Collective-model constants with provenance. Overridable per call;
# mesh_main prints this table and the one-card measurement next to every
# recommendation. Neither is measurable on a machine with one card.
COLLECTIVE_CONSTANTS = {
    "nvlink_gbs": (450.0, "vendor", "NVIDIA H100 SXM data sheet: NVLink 4, "
                   "900 GB/s per card to the other cards of its node, "
                   "450 GB/s each way"),
    "coll_lat_us": (10.0, "default", "launch and synchronisation of one "
                    "NCCL collective between the cards of one NVLink node, "
                    "an order of magnitude, not measured; the one-card "
                    "probe (measure_collective_overhead_us) bounds only "
                    "the one-rank form"),
}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def measure_collective_overhead_us(device=None, reps: int = 200) -> float:
    """One-card proxy for a collective's fixed cost: the extra device time
    of an NCCL all-reduce over a one-rank world, per call, against the
    same body without it (a 4 MB float32 multiply), each timed with CUDA
    events over `reps` chained calls. Uses the default process group
    when one is initialised (it must have one rank), else makes one over
    localhost and destroys it after. CAVEAT, printed with the result:
    NCCL's one-rank all-reduce is at most a copy, so this bounds the
    framework's overhead, not the launch and synchronisation between
    cards; the model keeps the stated default for that. Raises without a
    CUDA device."""
    import torch
    import torch.distributed as dist
    from .backend import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("measure_collective_overhead_us: needs a CUDA "
                           "device")
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0, device_id=device)
    try:
        if dist.get_world_size() != 1 or "nccl" not in str(
                dist.get_backend()):
            raise RuntimeError("measure_collective_overhead_us: needs a "
                               "one-rank NCCL world")
        x = torch.ones(1 << 20, dtype=torch.float32, device=device)

        def coll(v):
            v = v * 1.0000001
            dist.all_reduce(v)
            return v

        def plain(v):
            return v * 1.0000001

        def per_call_us(fn):
            cur = x
            for _ in range(10):
                cur = fn(cur)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                cur = fn(cur)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e3 / reps

        return max(per_call_us(coll) - per_call_us(plain), 0.0)
    finally:
        if own:
            dist.destroy_process_group()


def recommend_mesh(compiled, params, n_devices: int, *,
                   nvlink_gbs: float = None, coll_lat_us: float = None,
                   throughput: bool = False):
    """Recommend a mesh shape for `compiled` on `n_devices` cards from the
    roofline cost model (eva_tpu.profiling.recommend_mesh's model, over
    the port's estimate_program and residue width).

    Latency model per single execution on a candidate {batch, limb, seq}
    split (collectives over NVLink at nvlink_gbs, coll_lat_us each; the
    per-card compute terms come from estimate_program's resource
    decomposition):

      limb L : digit-stage NTT rows / L  + modular all-reduce of the two
               accumulators per key switch (2(L-1)/L of the plane
               bytes) — everything else replicated
      seq  S : ALL rows and elementwise bytes / S + one all-to-all per
               transform ((S-1)/S of the local plane) + a shard exchange
               per rotation
      batch B: does not change single-execution latency; multiplies
               throughput by B (no per-op collectives)

    Returns (best, table): best = {"batch": B, "limb": L, "seq": S},
    table = [(shape, predicted seconds per execution, executions per
    second)] sorted by the objective: latency (ties toward more batch),
    or with throughput=True executions per second.

    nvlink_gbs / coll_lat_us default to COLLECTIVE_CONSTANTS (their
    provenance printed by mesh_main)."""
    from .parallel.seq_exec import seq_compatible

    if nvlink_gbs is None:
        nvlink_gbs = COLLECTIVE_CONSTANTS["nvlink_gbs"][0]
    if coll_lat_us is None:
        coll_lat_us = COLLECTIVE_CONSTANTS["coll_lat_us"][0]
    _, t1, res = estimate_program(compiled, params, return_resources=True)
    n = res["n"]
    row_ntt, row_perm = res["row_ntt_s"], res["row_perm_s"]
    link = nvlink_gbs * 1e9
    plane = n * RESIDUE_BYTES  # bytes per row

    def predict(limb, seq):
        ntt_d, ntt_o = res["ntt_rows_digit"], res["ntt_rows_other"]
        perm, ew_r = res["perm_rows"], res["ew_rows"]
        comp = (ntt_d * row_ntt / limb
                + (ntt_o * row_ntt + ew_r * plane / res["hbm_bw"]
                   + perm * row_perm) / seq)
        coll = 0.0
        if limb > 1:
            coll += (res["ks_reduce_rows"] * plane / seq
                     * 2 * (limb - 1) / limb) / link
            coll += res["ks_sites"] * np.log2(limb) * coll_lat_us * 1e-6
        if seq > 1:
            a2a_rows = (ntt_d / limb + ntt_o + perm)
            coll += (a2a_rows * plane / seq * (seq - 1) / seq) / link
            coll += res["transforms"] * coll_lat_us * 1e-6
        return comp + coll

    table = []
    for limb in [x for x in (1, 2, 4, 8, 16) if x <= n_devices]:
        for seq in [x for x in (1, 2, 4, 8) if limb * x <= n_devices]:
            if seq > 1 and not seq_compatible(n, seq):
                continue
            if limb > 1 and not res["ks_sites"]:
                continue
            batch = n_devices // (limb * seq)
            t = predict(limb, seq)
            table.append(({"batch": batch, "limb": limb, "seq": seq},
                          t, batch / t))
    if throughput:
        table.sort(key=lambda r: -r[2])
    else:
        table.sort(key=lambda r: (r[1], -r[0]["batch"]))
    return table[0][0], table


def mesh_main(which: str, n_devices: int):
    """Print the collective constants, the one-card collective overhead
    and the recommended meshes of program `which` on n_devices cards."""
    from .ckks import CKKSCompiler

    compiled, params, _ = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(PROGRAMS[which]())
    print("collective-model constants:")
    for key, (val, kind, why) in COLLECTIVE_CONSTANTS.items():
        print(f"  {key} = {val} [{kind}] — {why}")
    lat = measure_collective_overhead_us()
    print(f"  measured one-rank NCCL all-reduce overhead: {lat:.2f} us "
          f"(lower bound on framework cost; the cost between cards needs "
          f"more than one card)")
    for objective in (False, True):
        best, table = recommend_mesh(compiled, params, n_devices,
                                     throughput=objective)
        name = "throughput" if objective else "latency"
        print(f"objective={name}: recommend {best}")
        for shape, t, thr in table[:6]:
            print(f"  {shape}  {t*1e3:8.3f} ms/exec  {thr:8.1f} exec/s")
    return lat


def build_sobel(h=90, w=90):
    """The reference benchmark workload (examples/image_processing.py):
    2x 3x3 convolutions + cubic polynomial on the squared gradient
    magnitude."""
    from . import EvaProgram, Input, Output

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
    """The reference's Harris corner response
    (examples/image_processing.py): Sobel gradients, three 3x3 box sums
    over their products, determinant/trace corner response."""
    from . import EvaProgram, Input, Output

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


def build_poly():
    """The README polynomial at vec_size 4096."""
    from . import EvaProgram, Input, Output

    prog = EvaProgram("poly", vec_size=4096)
    with prog:
        x = Input("x")
        Output("y", 3 * x ** 2 + 5 * x - 2)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    return prog


PROGRAMS = {"sobel": build_sobel, "harris": build_harris, "poly": build_poly}


def estimate_main(which: str, **calib):
    """Print estimate_program's per-class table for one workload."""
    from .ckks import CKKSCompiler

    prog = PROGRAMS[which]()
    compiled, params, _ = CKKSCompiler({"warn_vec_size": "false"}).compile(prog)
    totals, total = estimate_program(compiled, params, **calib)
    print(f"program={prog.name} N={params.poly_modulus_degree} "
          f"prime_bits={list(params.prime_bits)}")
    print(f"{'op class':<16}{'count':>7}{'est ms':>10}")
    for cls, (c, s) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
        print(f"{cls:<16}{c:>7}{s*1e3:>10.3f}")
    print(f"{'TOTAL':<16}{'':>7}{total*1e3:>10.3f}")
    return totals, total


def main():
    from .backend import resolve_device

    device = resolve_device(None)  # the CUDA device; raises without one
    if len(sys.argv) > 1 and sys.argv[1] == "estimate":
        estimate_main(sys.argv[2] if len(sys.argv) > 2 else "sobel")
        return
    if len(sys.argv) > 1 and sys.argv[1] == "mesh":
        mesh_main(sys.argv[2] if len(sys.argv) > 2 else "sobel",
                  int(sys.argv[3]) if len(sys.argv) > 3 else 8)
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    import torch
    print(f"device={torch.cuda.get_device_name(device)}  N={n}  "
          f"entries={levels}x60")
    results, hbm, n_sub = profile(n, levels, device)
    print(f"measured HBM roofline: {hbm/1e9:.0f} GB/s")
    print(f"{'kernel':<24}{'us/ct-op':>10}{'GB/s':>10}{'% of SoL':>10}")
    for name, us, achieved, frac in results:
        print(f"{name:<24}{us:>10.1f}{achieved/1e9:>10.0f}{100*frac:>9.0f}%")
    print("calibration " + " ".join(
        f"{k}={v:.6g}" for k, v in calibration(results, hbm, n_sub).items()))


if __name__ == "__main__":
    main()
