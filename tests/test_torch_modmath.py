"""eva_tpu_torch.backend.modmath against eva_tpu.backend.modmath.

The same residues, made from numpy seeds, go through the JAX package's
32-bit Montgomery/Shoup arithmetic on uint32 (JAX on the CPU) and the
port's plain versions on int32 tensors carrying the same bit patterns;
every result must be bit-identical (exact modular arithmetic: the
tolerance is zero). Unreduced first operands up to 2^32 (negative as
int32) are included where the JAX functions accept them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eva_tpu.backend import modmath as MJ
from eva_tpu.backend.tables import DeviceLevelOps as DevJ
from eva_tpu_torch.backend import modmath as MT
from eva_tpu_torch.backend.tables import DeviceLevelOps as DevT

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)

PRIMES = [1073668097, 1073815553, 40961, 2147352577]
N = 512


def _consts(primes):
    q = np.array(primes, dtype=np.uint32)[:, None]
    nqinv = np.array([MJ.mont_constants(p)[0] for p in primes],
                     dtype=np.uint32)[:, None]
    rinv = np.array([[MT.mont_rinv(p)] for p in primes], dtype=np.uint32)
    return q, nqinv, _t(q), _t(rinv)


def _reduced(rng, primes, shape=(N,)):
    return np.stack([rng.integers(0, p, shape, dtype=np.uint64)
                     for p in primes]).astype(np.uint32)


def _unreduced(rng, primes, shape=(N,)):
    """Values up to 2^32, half of them at or above 2^31."""
    a = rng.integers(0, 2 ** 32, (len(primes),) + shape,
                     dtype=np.uint64).astype(np.uint32)
    a[:, : shape[-1] // 2] |= np.uint32(1 << 31)
    return a


def _t(a):
    """uint32 numpy -> the int32 tensor of its bits (modmath.upload)."""
    return MT.upload(np.asarray(a, dtype=np.uint32), "cpu")


def _u(t):
    """int32 tensor -> its uint32 values."""
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("p", PRIMES)
def test_host_precompute_matches(p):
    assert [int(v) for v in MT.mont_constants(p)] == \
        [int(v) for v in MJ.mont_constants(p)]
    w = np.random.default_rng(p).integers(0, 2 ** 40, 64, dtype=np.uint64)
    for a, b in zip(MT.shoup_pair(w, p), MJ.shoup_pair(w, p)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(MT.shoup_stack(w, p), MJ.shoup_stack(w, p))
    np.testing.assert_array_equal(MT.to_mont(w % p, p), MJ.to_mont(w % p, p))
    rows = np.stack([w % p, (w >> np.uint64(3)) % p])
    np.testing.assert_array_equal(MT.to_mont_rows(rows, [p, p]),
                                  MJ.to_mont_rows(rows, [p, p]))
    assert MT.mont_rinv(p) * (1 << 32) % p == 1


def test_storage_round_trips_uint32_bit_patterns():
    """upload keeps the uint32 bits (values >= 2^31 read negative as
    int32), widen gives the uint32 values as int64, narrow and to_host
    give them back without sign extension."""
    vals = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 40961],
                    dtype=np.uint64)
    t = MT.upload(vals, "cpu")
    assert t.dtype == torch.int32 and int(t[3]) == -2 ** 31
    np.testing.assert_array_equal(MT.widen(t).numpy(), vals.astype(np.int64))
    assert torch.equal(MT.narrow(MT.widen(t)), t)
    back = MT.to_host(t)
    assert back.dtype == np.uint64
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("unreduced", [False, True])
def test_mont_mul_bit_identical(unreduced):
    rng = np.random.default_rng(1 + unreduced)
    q, nqinv, qt, rinv = _consts(PRIMES)
    a = (_unreduced if unreduced else _reduced)(rng, PRIMES)
    b = _reduced(rng, PRIMES)  # Montgomery-form constant < q
    want = np.asarray(MJ.mont_mul(jnp.asarray(a), jnp.asarray(b), q, nqinv))
    got = MT.mont_mul(_t(a), _t(b), qt, rinv)
    np.testing.assert_array_equal(_u(got), want)
    assert (_u(got) < q).all()


@pytest.mark.parametrize("unreduced", [False, True])
def test_shoup_mul_and_reduce_bit_identical(unreduced):
    rng = np.random.default_rng(3 + unreduced)
    q, _, qt, _ = _consts(PRIMES)
    a = (_unreduced if unreduced else _reduced)(rng, PRIMES)
    w = _reduced(rng, PRIMES)
    wp = np.stack([MJ.shoup_pair(w[i], p)[1] for i, p in enumerate(PRIMES)])
    want = np.asarray(MJ.shoup_mul(jnp.asarray(a), w, wp, q))
    got = MT.shoup_mul(_t(a), _t(w), _t(wp), qt)
    np.testing.assert_array_equal(_u(got), want)
    # reduce = Shoup multiply by 1 (DeviceLevelOps.reduce)
    one = [MJ.shoup_pair(np.ones(1, dtype=np.uint64), p) for p in PRIMES]
    ow = np.array([o[0] for o in one]).reshape(-1, 1)
    owp = np.array([o[1] for o in one]).reshape(-1, 1)
    want = np.asarray(MJ.shoup_mul(jnp.asarray(a), ow, owp, q))
    got = MT.shoup_mul(_t(a), _t(ow), _t(owp), qt)
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(
        _u(got),
        a.astype(np.uint64) % np.array(PRIMES, dtype=np.uint64)[:, None])


@pytest.mark.parametrize("case", ["reduced", "a_below_2q"])
def test_add_sub_neg_bit_identical(case):
    """The JAX formulas are reproduced literally, so callers that pass
    unreduced operands (a < 2q) get the same, unreduced, results."""
    primes = PRIMES[:3]  # 3q < 2^32: no uint32 wrap in the reference
    rng = np.random.default_rng(5)
    q, _, qt, _ = _consts(primes)
    a = _reduced(rng, primes)
    if case == "a_below_2q":
        a = (a.astype(np.uint64) + q).astype(np.uint32)
    b = _reduced(rng, primes)
    b[:, :8] = 0
    for fj, ft in ((MJ.add_mod, MT.add_mod), (MJ.sub_mod, MT.sub_mod)):
        want = np.asarray(fj(jnp.asarray(a), jnp.asarray(b), q))
        np.testing.assert_array_equal(_u(ft(_t(a), _t(b), qt)), want)
    want = np.asarray(MJ.neg_mod(jnp.asarray(b), q))
    np.testing.assert_array_equal(_u(MT.neg_mod(_t(b), qt)), want)


def test_add_sub_above_2_to_31_bit_identical():
    """A prime just below 2^31: the sums and the wrapped differences of
    the formulas reach past 2^31 (negative as int32) and the results
    still match the uint32 reference."""
    primes = [PRIMES[3]]
    rng = np.random.default_rng(6)
    q, _, qt, _ = _consts(primes)
    a, b = _reduced(rng, primes), _reduced(rng, primes)
    assert (a.astype(np.uint64) + b >= 1 << 31).any()
    for fj, ft in ((MJ.add_mod, MT.add_mod), (MJ.sub_mod, MT.sub_mod)):
        want = np.asarray(fj(jnp.asarray(a), jnp.asarray(b), q))
        np.testing.assert_array_equal(_u(ft(_t(a), _t(b), qt)), want)


@pytest.mark.parametrize("n", [64, 1024])
def test_level_ops_elementwise_with_broadcasts(n):
    """DeviceLevelOps' elementwise ops (the plain versions of E1 and E2)
    on int32 planes with a batch axis, against eva_tpu's DeviceLevelOps:
    a second operand broadcast over the batch (a plaintext), a per-row
    constant [n_sub, 1], rows broadcast over the primes [.., 1, N]
    (keygen's error lift, the alpha = 1 digit broadcast), and an
    unreduced first operand for the Montgomery and Shoup multiplies."""
    primes = [1073668097, 1073815553, 40961]
    dj, dt = DevJ(primes, n), DevT(primes, n, "cpu")
    rng = np.random.default_rng(n)
    a = np.stack([_reduced(rng, primes, (n,)) for _ in range(3)])  # [3,3,n]
    a2 = np.ascontiguousarray(a[::-1])
    b = _reduced(rng, primes, (n,))                                  # [3, n]
    c = _reduced(rng, primes, (1,))                                  # [3, 1]
    row = rng.integers(0, 30000, (3, 1, n), dtype=np.uint64).astype(
        np.uint32)
    row2 = np.ascontiguousarray(row[::-1])
    big = _unreduced(rng, primes, (n,))
    w = _reduced(rng, primes, (n,))
    wp = np.stack([MJ.shoup_pair(w[i], p)[1] for i, p in enumerate(primes)])

    def each(ops, a, a2, b, c, row, row2, big):
        return (ops.add(a, b), ops.sub(b, a), ops.neg(a), ops.mul(a, b),
                ops.mul_mont(a, c), ops.mul_mont(big, b), ops.reduce(big),
                ops.reduce(row), ops.sub(row, row2),
                *ops.tensor_product(a, a2, b, b))

    args = (a, a2, b, c, row, row2, big)
    want = list(each(dj, *(jnp.asarray(v) for v in args)))
    want.append(MJ.shoup_mul(jnp.asarray(big), w, wp, dj.q))
    got = list(each(dt, *(_t(v) for v in args)))
    got.append(dt.mul_shoup(_t(big), _t(w), _t(wp)))
    assert len(got) == len(want) == 13
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w_))


def test_plain_calls_counted_and_int32_required():
    """Each plain op counts one call; the dispatch refuses what the
    kernels refuse: int64 planes, and a device that is neither CUDA nor
    the CPU."""
    dt = DevT([40961], 64, "cpu")
    x = _t(_reduced(np.random.default_rng(0), [40961], (64,)))
    before = dict(MT.PLAIN_CALLS)
    dt.add(x, x)
    dt.mul(x, x)
    dt.tensor_product(x, x, x, x)
    assert MT.PLAIN_CALLS["add"] == before["add"] + 1
    assert MT.PLAIN_CALLS["mul"] == before["mul"] + 1
    assert MT.PLAIN_CALLS["tensor_product"] == before["tensor_product"] + 1
    with pytest.raises(ValueError, match="int32"):
        dt.add(x.to(torch.int64), x)
    with pytest.raises(ValueError, match="int32"):
        dt.ntt(x.to(torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        dt.sub(x.to("meta"), x.to("meta"))
