"""The fused key switch of the port (eva_tpu_torch/backend/ks.py: the plain
versions of the MAC and epilogue kernels, and TorchProgram's fused entry
points) against the JAX package, on the CPU.

Inputs are made from a seed with numpy at N=1024; keys come from
eva_tpu's keygen and are carried into the port with eva_tpu_torch.convert.
All arithmetic is exact modular arithmetic, so every comparison is
bit-for-bit (tolerance zero). The CUDA kernels are held against these
plain versions in tests/test_torch_cuda.py, on a card."""

import types

import numpy as np
import pytest
import torch

from eva_tpu.crypto import keys as KJ
from eva_tpu.crypto import ops as OJ
from eva_tpu.crypto.context import get_context as get_context_j
from eva_tpu_torch.backend import ks, tables
from eva_tpu_torch.backend.executor_torch import (TorchProgram, _ks_dev_tables,
                                                  _ks_maps, device_keys,
                                                  level_ops)
from eva_tpu_torch.crypto.context import get_context as get_context_t
from test_torch_executor import carry_keys

torch.set_num_threads(1)

N = 1024


def _setup(bits, alpha):
    """JAX-package context and keys, and the port's TorchProgram on the
    CPU holding the same keys (only what the key switch reads)."""
    ctx_j = get_context_j(tuple(bits), (), N, 1)
    ks_j = KJ.generate_keys(ctx_j, alpha=alpha)
    params = types.SimpleNamespace(prime_bits=list(bits), rotations=[],
                                   poly_modulus_degree=N, key_terms=1)
    ctx_t, ks_t = carry_keys(params, ks_j)
    tp = TorchProgram.__new__(TorchProgram)
    tp.ctx, tp.keys, tp.device = ctx_t, ks_t, torch.device("cpu")
    tp.dkeys = device_keys(ctx_t, ks_t, tp.device)
    tp._consts = {}
    return ctx_j, ks_j, ctx_t, ks_t, tp


def _coeffs(seed, primes):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, N, dtype=np.uint64)
                     for q in primes])


@pytest.mark.parametrize("bits,alpha,own", [
    ([60, 30, 60], 2, True),    # 3 data primes: a partial last group
    ([60, 30, 60], 2, False),
    ([60, 30, 60], 1, True),
    ([60, 30, 30], 1, False),   # one key prime
])
def test_plain_mac_matches_numpy_ks_mac(bits, alpha, own):
    ctx_j, ks_j, ctx_t, ks_t, tp = _setup(bits, alpha)
    level = 0
    primes = ctx_t.primes_at_level(level)
    n_cur, n_key = len(primes), len(ctx_t.key_primes)
    assert n_key == (2 if bits[-1] == 60 else 1)
    coeffs = _coeffs(7 + alpha, primes)
    want0, want1 = OJ._ks_mac(
        ctx_j, OJ._ks_digits_from_coeffs(ctx_j, coeffs, level, alpha),
        level, ks_j.relin)

    groups, inv, _ = ctx_t.ks_tables(level, alpha)
    n_groups, _, conv_mont = _ks_dev_tables(ctx_t, level, alpha)
    _, owner, _ = _ks_maps(ctx_t, level, alpha)
    assert (n_cur % alpha != 0) == (len(groups[-1]) < alpha)
    y = np.zeros((n_groups * alpha, N), dtype=np.int64)
    for t, q in enumerate(primes):
        y[t] = (coeffs[t] * inv[t]) % np.uint64(q)
    k0, k1 = tp.dkeys.dense_layout(ks_t.relin, level)
    x_ntt = (torch.from_numpy(ctx_j.ntt(coeffs, primes).astype(np.int64))[None]
             if own else None)
    ext = level_ops(primes + ctx_t.key_primes, N, "cpu")
    calls = dict(ks.PLAIN_CALLS)
    acc0, acc1 = ks.ks_mac(
        torch.from_numpy(y).reshape(1, n_groups, alpha, N), k0, k1,
        torch.from_numpy(conv_mont[..., 0].astype(np.int64)),
        torch.from_numpy(np.concatenate([owner, [-1] * n_key])), ext, x_ntt)
    assert ks.PLAIN_CALLS["ks_mac"] == calls["ks_mac"] + 1
    np.testing.assert_array_equal(acc0[0].numpy(), want0.astype(np.int64))
    np.testing.assert_array_equal(acc1[0].numpy(), want1.astype(np.int64))


@pytest.mark.parametrize("bits", [[60, 30, 60], [60, 30, 30]])
@pytest.mark.parametrize("coeff_out", [True, False])
def test_plain_epilogue_matches_numpy_ks_div(bits, coeff_out):
    ctx_j = get_context_j(tuple(bits), (), N, 1)
    ctx_t = get_context_t(tuple(bits), (), N, 1)
    level = 0
    basis = ctx_t.primes_at_level(level) + ctx_t.key_primes
    acc = [_coeffs(s, basis) for s in (3, 4)]
    want = [OJ.ks_div(ctx_j, a, level, coeff_out) for a in acc]
    ext = level_ops(basis, N, "cpu")
    got = ks.ks_epilogue(*(torch.from_numpy(a.astype(np.int64))[None]
                           for a in acc), ext, len(ctx_t.key_primes),
                         out_ntt=not coeff_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w.astype(np.int64))


def test_fused_coeffs_matches_jax_structured_ks_apply():
    """TorchProgram._ks_fused_coeffs (MAC + epilogue, own-row reads on)
    against JaxProgram._ks_apply, the structured reference the JAX
    package's own tests hold its Pallas kernels equal to."""
    import jax
    import jax.numpy as jnp
    from eva_tpu.backend.executor_jax import JaxProgram
    from eva_tpu.backend.executor_jax import device_keys as device_keys_j

    ctx_j, ks_j, ctx_t, ks_t, tp = _setup([60, 30, 60], 2)
    level = 0
    primes = ctx_t.primes_at_level(level)
    rng = np.random.default_rng(11)
    poly = np.stack([rng.integers(0, q, N, dtype=np.uint64)
                     for q in primes]).astype(np.uint32)
    jp = JaxProgram.__new__(JaxProgram)
    jp.ctx, jp.keys = ctx_j, ks_j
    jp.dkeys = device_keys_j(ctx_j, ks_j)
    layout = jp.dkeys.layout(ks_j.relin, level)
    # Jitted: one XLA compile (~7 s) instead of one per eager op (~60 s).
    ref = jax.jit(lambda p: jp._ks_apply(jp._ks_digits(p, level), level,
                                         layout, coeff_out=False))(
        jnp.asarray(poly[None]))

    poly_t = torch.from_numpy(poly.astype(np.int64))[None]
    coeffs_t = level_ops(primes, N, "cpu").intt(poly_t)
    calls = dict(ks.PLAIN_CALLS)
    got = tp._ks_fused_coeffs(coeffs_t, level, ks_t.relin, out_ntt=True,
                              poly_ntt=poly_t)
    assert ks.PLAIN_CALLS == {k: v + 1 for k, v in calls.items()}
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())
    assert tables.PLAIN_CALLS["ntt_fwd"] > 0


@pytest.mark.slow
def test_fused_coeffs_matches_jax_pallas_kernels_interpret():
    """The same against JaxProgram._ks_fused_coeffs itself: the Pallas
    MAC and epilogue kernels in interpret mode (33-71 s on a CPU, hence
    slow)."""
    import jax.numpy as jnp
    from eva_tpu.backend.executor_jax import JaxProgram
    from eva_tpu.backend.executor_jax import device_keys as device_keys_j
    from eva_tpu.backend.executor_jax import level_ops as level_ops_j

    ctx_j, ks_j, ctx_t, ks_t, tp = _setup([60, 30, 60], 2)
    level = 0
    primes = ctx_t.primes_at_level(level)
    rng = np.random.default_rng(12)
    poly = np.stack([rng.integers(0, q, N, dtype=np.uint64)
                     for q in primes]).astype(np.uint32)
    jp = JaxProgram.__new__(JaxProgram)
    jp.ctx, jp.keys = ctx_j, ks_j
    jp.dkeys = device_keys_j(ctx_j, ks_j)
    poly_j = jnp.asarray(poly[None])
    coeffs_j = level_ops_j(primes, N).intt(poly_j)
    ref = jp._ks_fused_coeffs(coeffs_j, level, ks_j.relin, out_ntt=False,
                              poly_ntt=poly_j)

    poly_t = torch.from_numpy(poly.astype(np.int64))[None]
    coeffs_t = level_ops(primes, N, "cpu").intt(poly_t)
    got = tp._ks_fused_coeffs(coeffs_t, level, ks_t.relin, out_ntt=False,
                              poly_ntt=poly_t)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())
