"""eva_tpu_torch.backend.tables (DeviceLevelOps) and the CUDA NTT wrapper
against the JAX package.

Inputs are made from numpy seeds and go through eva_tpu's DeviceLevelOps
(JAX on the CPU, uint32) and the port's on device="cpu" (int32 tensors of
the same bits), where every op runs the plain PyTorch version of its CUDA
kernel. Every comparison is bit-identity of the uint32 values. The plain
NTT is also held against the Pallas NTT kernel in interpret mode. The
CUDA kernels are held against the plain versions in test_torch_cuda.py,
on a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eva_tpu.backend import tables as TJ
from eva_tpu.backend.executor_jax import divide_last_planes as div_jax
from eva_tpu_torch.backend import modmath_cuda, ntt_cuda
from eva_tpu_torch.backend import tables as TT
from eva_tpu_torch.backend.modmath import upload
from eva_tpu_torch.backend.executor_torch import (divide_last_planes,
                                                  level_ops)

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)

PRIMES = [1073668097, 1073815553, 40961]  # NTT-friendly up to N = 4096
SIZES = [64, 256, 1024, 4096]


def _ops(n):
    return TJ.DeviceLevelOps(PRIMES, n), TT.DeviceLevelOps(PRIMES, n, "cpu")


def _planes(seed, n, lead=(2,), primes=PRIMES):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in primes], axis=-2).astype(np.uint32)


def _t(a):
    """Residues (numpy, < 2^32) -> the int32 tensor of their uint32 bits."""
    return upload(np.asarray(a), "cpu")


def _j(a):
    """A JAX uint32 array -> numpy uint32."""
    return np.asarray(a).astype(np.uint32)


def _u(t):
    """A port int32 tensor -> its uint32 values."""
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_ntt_intt_bit_identical(n):
    dj, dt = _ops(n)
    for name in ("mst_f", "mst_i", "ninv"):  # the twiddle tables themselves
        for mine, ref in zip(dt.np_tables[name], getattr(dj, name)):
            np.testing.assert_array_equal(mine, ref)
    x = _planes(n, n, lead=(2, 3))  # arbitrary leading batch dims
    f = dt.ntt(_t(x))
    np.testing.assert_array_equal(_u(f),
                                  _j(jax.jit(dj.ntt)(jnp.asarray(x))))
    back = dt.intt(f)
    np.testing.assert_array_equal(_u(back), _j(jax.jit(dj.intt)(
        jnp.asarray(_u(f)))))
    np.testing.assert_array_equal(_u(back), x)


@pytest.mark.parametrize("n", SIZES)
def test_elementwise_ops_bit_identical(n):
    dj, dt = _ops(n)
    a, b, c, d = (_planes(n + k, n) for k in range(4))
    big = (a.astype(np.uint64) + np.uint64(2 ** 31)).astype(np.uint32)

    def each(ops, a, b, c, d, big):
        return (*ops.tensor_product(a, b, c, d), ops.mul(a, b),
                ops.add(a, b), ops.sub(a, b), ops.neg(a),
                # reduce() takes any a < 2^32; the NTT the reduced planes
                ops.reduce(big), ops.ntt(ops.reduce(big)))

    want = jax.jit(lambda *v: each(dj, *v))(
        *(jnp.asarray(v) for v in (a, b, c, d, big)))
    got = each(dt, *(_t(v) for v in (a, b, c, d, big)))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), _j(w))


@pytest.mark.parametrize("n", [64, 4096])
def test_divide_last_planes_bit_identical(n):
    rest = TJ.DeviceLevelOps(PRIMES[:-1], n)
    rest_t = TT.DeviceLevelOps(PRIMES[:-1], n, "cpu")
    x = _planes(7 * n, n, lead=(3,))
    want = jax.jit(lambda v: div_jax(v, PRIMES, rest))(jnp.asarray(x))
    got = divide_last_planes(_t(x), PRIMES, rest_t)
    np.testing.assert_array_equal(_u(got), _j(want))


def test_plain_ntt_matches_pallas_kernel_interpret():
    """The plain NTT (the CUDA kernel's reference) equals the TPU kernel
    K1/K2 run in Pallas interpret mode."""
    from eva_tpu.backend.pallas_ntt import get_pallas_ntt
    from eva_tpu_torch.crypto.primes import build_chain
    n = 1024
    primes = tuple(q for e in build_chain([60, 40], n) for q in e.primes)
    pn = get_pallas_ntt(primes, n)
    dt = TT.DeviceLevelOps(list(primes), n, "cpu")
    x = _planes(11, n, lead=(), primes=primes)
    f = dt.ntt(_t(x))
    np.testing.assert_array_equal(_u(f), _j(pn.ntt(x)))
    np.testing.assert_array_equal(_u(dt.intt(f)), _j(pn.intt(_u(f))))


def test_level_ops_cache_keyed_by_ring_size_and_device():
    from eva_tpu_torch.crypto.primes import build_chain
    q = build_chain([60], 16384)[0].primes[0]
    a = level_ops([q], 8192, "cpu")
    b = level_ops([q], 16384, "cpu")
    assert a.n == 8192 and b.n == 16384
    assert level_ops([q], 8192, torch.device("cpu")) is a
    x = np.random.default_rng(3).integers(0, q, (1, 8192), dtype=np.uint64)
    np.testing.assert_array_equal(_u(a.intt(a.ntt(_t(x)))), x)


def test_plain_calls_counted_and_cuda_wrapper_refuses_cpu_tensors():
    """On the CPU, ntt/intt take the plain version and count it; the
    kernel wrapper never falls back: a CPU tensor raises before any
    build or launch."""
    _, dt = _ops(64)
    x = _t(_planes(1, 64))
    before = dict(TT.PLAIN_CALLS)
    dt.intt(dt.ntt(x))
    assert TT.PLAIN_CALLS["ntt_fwd"] == before["ntt_fwd"] + 1
    assert TT.PLAIN_CALLS["ntt_inv"] == before["ntt_inv"] + 1
    launches = dict(ntt_cuda.LAUNCHES)
    for fn in (ntt_cuda.ntt_fwd, ntt_cuda.ntt_inv):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            fn(x, dt)
    assert ntt_cuda.LAUNCHES == launches
    launches = dict(modmath_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.mod_ew("add", dt, x, x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.tensor_product(dt, x, x, x, x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.divide_last([x], x[:-1, :1].contiguous(), [PRIMES[-1]],
                                 TT.DeviceLevelOps(PRIMES[:-1], 64, "cpu"))
    assert modmath_cuda.LAUNCHES == launches


def test_galois_perm_table_and_cpu_path():
    """DevPerm's int32 table is the context's NTT-domain permutation; on
    the CPU its planes() permutes each plane by index_select, as the
    numpy backend's apply_automorphism does, and launches nothing; the
    card's wrapper refuses a CPU table; a table that is not a
    permutation is refused."""
    from eva_tpu_torch.backend.executor_torch import DevPerm, dev_perm
    from eva_tpu_torch.crypto.context import get_context
    ctx = get_context((60, 60), (1, 3), 1024, 1)
    rng = np.random.default_rng(21)
    c0 = rng.integers(0, 2 ** 32, (2, 1024), dtype=np.uint64)
    acc = rng.integers(0, 2 ** 32, (3, 4, 1024), dtype=np.uint64)
    launches = dict(modmath_cuda.LAUNCHES)
    for step in (1, 3):
        g = ctx.galois_elt(step)
        perm = dev_perm(ctx, g, "cpu")
        assert perm.table.dtype == torch.int32
        np.testing.assert_array_equal(perm.table.numpy(),
                                      ctx.perm_for_elt(g))
        got = perm.planes(_t(c0), _t(acc)[:, 1:, :])
        np.testing.assert_array_equal(_u(got[0]),
                                      ctx.apply_automorphism(c0, g))
        np.testing.assert_array_equal(
            _u(got[1]), ctx.apply_automorphism(acc[:, 1:, :], g))
        np.testing.assert_array_equal(_u(perm(_t(c0))), _u(got[0]))
        with pytest.raises(ValueError, match="not on a CUDA device"):
            modmath_cuda.galois_perm([_t(c0)], perm.table)
    assert modmath_cuda.LAUNCHES == launches
    with pytest.raises(ValueError, match="not a permutation"):
        DevPerm(np.zeros(1024, dtype=np.int64), "cpu")
