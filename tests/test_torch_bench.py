"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

Its sections run small on device="cpu" (the plain versions, the host
clock): N=2048, three 60-bit data entries, batch 2, one pass, a 1 MiB
roofline copy (the card's 128 MiB takes ~20 s on the CPU), and in place
of Sobel and Harris 90x90 (N=16384) a 3x3 box filter and its square on
an 8x8 image, substituted for the module's builders. The line they
assemble has every key that bench.py's _emit and main write (BENCH_KEYS
below, from bench.py:85-111 and :830-918). Its steps are held to the JAX package on
the same inputs: the ct-mul step to eva_tpu's
DeviceLevelOps.tensor_product, E4's plain version to 16 chained eva_tpu
mul_mont, one rotation step to eva_tpu's JaxProgram._rotate on the same
keys (JAX on the CPU), bit for bit. Without a card, main() exits 2."""

import importlib.util
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from test_torch_executor import ROOT

sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

torch.set_num_threads(1)

n, LEVELS, BATCH = 2048, 3, 2

# bench.py's line: _emit's keys (bench.py:85-111) and main's
# (bench.py:839-918).
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "extras"}
SAMPLED = (("ct_mul", "per_sec"), ("rotation", "us"), ("sobel90", "ms"),
           ("harris", "ms"), ("sobel90_batched", "evals_per_sec"),
           ("sobel90_with_io", "ms"), ("sobel90_host", "ms"))
BENCH_KEYS = (
    {"passes", "ct_mul_per_sec", "baseline", "device_backend",
     "ct_mul_host_per_sec", "rotation_host_us", "sobel90_mse",
     "sobel90_first_execute_s", "harris_mse", "harris_first_execute_s",
     "harris_host_ms", "harris_N", "rotation_vs_host", "sobel90_vs_host",
     "harris_vs_host", "kernel_sol", "sobel_compile_cold_s",
     "sobel_compile_warm_s"}
    | {f"{k}_{u}" for k, u in SAMPLED}
    | {f"{k}_samples_{u}" for k, u in SAMPLED}
    | {f"{k}_spread" for k, _ in SAMPLED})
# bench.py's setup_kernel_sol measure (bench.py:737-791).
SOL_STEPS = ("ntt_fwd", "intt", "ks_digits(intt+fbe+ntt)",
             "ks_epilogue(2xPdiv)", "ks_full(digits+mac+pdiv)",
             "ks_mac+pdiv(direct)", "rotation")
SOL_KEYS = {"hbm_gbs", "vpu_modmul_gops", "ks_mac_epilogue_us",
            "ks_mac_only_us", *SOL_STEPS}


def _bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_jax", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _box(name, square):
    """A 3x3 box filter (and its square) on an 8x8 image: Sobel's and
    Harris's shape of program at a ring the CPU runs quickly."""
    def build():
        from eva_tpu_torch import EvaProgram, Input, Output
        prog = EvaProgram(name, vec_size=64)
        with prog:
            image = Input("image")
            out = None
            for i in range(3):
                for j in range(3):
                    rot = image << (i * 8 + j)
                    out = rot if out is None else out + rot
            Output("image", out * out if square else out * 0.5)
        prog.set_input_scales(25)
        prog.set_output_ranges(10)
        return prog
    return build


def test_sections_assemble_benchs_line(monkeypatch):
    monkeypatch.setattr(bench_torch, "build_sobel", _box("sobel", False))
    monkeypatch.setattr(bench_torch, "build_harris", _box("harris", True))
    monkeypatch.setattr(bench_torch, "HBM_BYTES", 1 << 20)
    line = bench_torch.run(device="cpu", n=n, levels=LEVELS,
                           batch=(BATCH,) * 3, passes=1)
    assert set(line) == TOP_KEYS
    assert line["metric"] == "ckks_ct_mul_throughput_N16384_L6"
    extras = line["extras"]
    assert BENCH_KEYS <= set(extras), BENCH_KEYS - set(extras)
    assert {"card", "timing", "device_kind"} <= set(extras)
    assert BENCH_KEYS | {"card", "timing"} == bench_torch.LINE_EXTRAS
    assert extras["device_backend"] == "cpu" and extras["passes"] == 1
    sol = extras["kernel_sol"]
    assert SOL_KEYS <= set(sol), SOL_KEYS - set(sol)
    assert ("bsgs_cost_units" in sol) != ("bsgs_cost_units_unstable" in sol)
    for step in SOL_STEPS:
        assert set(sol[step]) == {"us", "gbs", "sol_pct", "compute_pct"}
        assert sol[step]["us"] > 0
    for k, u in SAMPLED:
        assert extras[f"{k}_{u}"] > 0
        assert len(extras[f"{k}_samples_{u}"]) == 1
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert extras["sobel90_mse"] < 0.01 and extras["harris_mse"] < 0.01
    assert extras["harris_N"] >= 4096
    assert extras["sobel_compile_cold_build_s"] == 0.0  # nothing to build
    # main() fails on an MSE at or above bench_torch.MSE_LIMIT (Sobel's and
    # Harris's at 90x90).
    extras.update(sobel90_mse=9e-7, harris_mse=4e-3)
    assert not bench_torch.mse_failures(line)
    extras.update(sobel90_mse=1e-6, harris_mse=5e-3)
    assert len(bench_torch.mse_failures(line)) == 2


def test_host_planes_are_benchs():
    primes = bench_torch.bench_context(n, LEVELS).primes_at_level(0)
    np.testing.assert_array_equal(bench_torch.host_planes(primes, n, 2, 3),
                                  _bench_py()._planes(primes, n, 2, 3))


def test_ct_mul_step_matches_eva_tpu():
    from eva_tpu.backend.tables import DeviceLevelOps
    from eva_tpu_torch.backend.modmath import to_host

    step, x = bench_torch.ct_mul_step("cpu", n, LEVELS, BATCH)
    primes = bench_torch.bench_context(n, LEVELS).primes_at_level(0)
    x_j, a1, b0, b1 = (jnp.asarray(bench_torch.host_planes(primes, n, BATCH,
                                                            s))
                       for s in range(4))
    want = DeviceLevelOps(primes, n).tensor_product(x_j, a1, b0, b1)[1]
    np.testing.assert_array_equal(to_host(step(x)), np.asarray(want))


def test_modmul_burn_plain_matches_chained_mul_mont():
    """E4's plain version (K = 16, constants 3 and 5, unreduced inputs
    included) against 16 chained eva_tpu DeviceLevelOps.mul_mont."""
    from eva_tpu.backend.tables import DeviceLevelOps
    from eva_tpu_torch.backend import modmath as M
    from eva_tpu_torch.backend.modmath import to_host, upload
    from eva_tpu_torch.backend.modmath_cuda import modmul_burn
    from eva_tpu_torch.backend.tables import level_ops

    primes = bench_torch.bench_context(n, LEVELS).primes_at_level(0)
    x = np.random.default_rng(5).integers(0, 2 ** 32, (BATCH, len(primes), n),
                                          dtype=np.uint64).astype(np.uint32)
    calls = M.PLAIN_CALLS["modmul_burn"]
    got = modmul_burn(level_ops(primes, n, "cpu"), upload(x, "cpu"))
    assert M.PLAIN_CALLS["modmul_burn"] == calls + 1
    dev = DeviceLevelOps(primes, n)
    c1, c2 = (jnp.asarray(np.full((len(primes), 1), c, np.uint32))
              for c in (3, 5))

    @jax.jit
    def burn(p):
        for _ in range(8):  # 16 multiplies: 3, 5, 3, ...
            p = dev.mul_mont(dev.mul_mont(p, c1), c2)
        return p

    np.testing.assert_array_equal(to_host(got), np.asarray(burn(x)))
    with pytest.raises(ValueError, match="primes"):
        modmul_burn(level_ops(primes, n, "cpu"), upload(x[:, :1], "cpu"))


def test_rotation_step_matches_jax_rotate():
    """One step of the rotation chain (the port's fused key switch, plain
    versions) against bench.py's JaxProgram shim on the same keys."""
    from eva_tpu.backend.executor_jax import (JaxProgram, device_keys,
                                              level_ops)
    from eva_tpu.crypto import keys as KJ
    from eva_tpu.crypto.context import get_context
    from eva_tpu_torch.backend.modmath import to_host

    bits = [60] * LEVELS + [60]
    ctx = get_context(tuple(bits), (1,), n)
    keys = KJ.generate_keys(ctx)
    params = SimpleNamespace(prime_bits=bits, rotations=[1],
                             poly_modulus_degree=n, key_terms=1)
    ctx_t, keys_t = R.port_keys(R.keys_payload(params, keys))
    step, x = bench_torch.rotation_step(ctx_t, keys_t, "cpu", BATCH)

    shim = JaxProgram.__new__(JaxProgram)
    shim.ctx, shim.keys, shim.k = ctx, keys, 1
    shim.dkeys = device_keys(ctx, keys)
    primes = ctx.primes_at_level(0)
    dev = level_ops(primes, n)

    @jax.jit
    def rot(p):
        out = shim._rotate([p, p], 1, 0, dev, None, None)
        return dev.add(out[0], out[1])

    want = rot(jnp.asarray(bench_torch.host_planes(primes, n, BATCH, 7)))
    np.testing.assert_array_equal(to_host(step(x)), np.asarray(want))


def test_main_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
