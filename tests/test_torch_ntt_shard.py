"""The sharded NTT's local phases (eva_tpu_torch/parallel/ntt_shard.py
ShardPhases: the plain versions of the kernels K6/K7, csrc/ntt_shard.cu)
against the JAX package's stages (eva_tpu/parallel/ntt_shard.py
_sub_dif_rows / _sub_dit_rows with the twiddle multiplies of
ShardedNTT.ntt / .intt, run as plain jnp on the CPU).

Each case is a ring N and a shard count D. Every rank's slices of the
tables are taken as the JAX module's _lane_slice / _row_slice take them;
the JAX reference runs each phase once per ring for every rank of every
D side by side (the vectors of a phase are independent). The port's
phases composed over the D ranks, with the all-to-all done in numpy,
give the JAX package's single-device NTT (its numpy NTT table), and the
inverse ones the input back. Inputs are made with numpy from a seed;
every comparison is bit-identity of the uint32 values. ShardedNTT with
its collectives is held to the JAX package in test_torch_parallel.py,
the kernels to these plain versions in test_torch_cuda.py, on a card."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eva_tpu.backend.modmath import shoup_mul
from eva_tpu.backend.pallas_ntt import PallasNTTTables
from eva_tpu.crypto.ntt import get_table
from eva_tpu.crypto.primes import build_chain
from eva_tpu.parallel.ntt_shard import _sub_dif_rows, _sub_dit_rows
from eva_tpu_torch.backend.modmath import upload
from eva_tpu_torch.parallel.ntt_shard import PLAIN_CALLS, ShardPhases

torch.set_num_threads(1)

RINGS = (1024, 4096, 16384)
SHARDS = (1, 2, 4)
BITS = [30, 30, 30]
# Polynomials a ring: B * n1 is the same at every ring, so the JAX
# stages of every 128-point phase see one shape (its eager ops compile
# once for the whole file).
VECTORS = 128


def _a2a(xs):
    """The tiled all-to-all over the ranks' [..., a, b] planes: rank r
    gets block r of every rank's axis -2, concatenated along axis -1 in
    rank order."""
    d = len(xs)
    return [np.concatenate([np.split(x, d, axis=-2)[r] for x in xs],
                           axis=-1) for r in range(d)]


def _swap(xs):
    return [np.ascontiguousarray(x.swapaxes(-1, -2)) for x in xs]


def _jax_phase(xs, st, q, size, dif, pre=None, post=None):
    """One local phase of eva_tpu's ShardedNTT on every rank at once: the
    ranks' planes xs [B, n_sub, size, cnt] (the transform along -2) side
    by side along the last axis, the twiddle pairs pre / post (each
    rank's slice [n_sub, 2, size, cnt], as _lane_slice / _row_slice cut
    them) with them; the multiplies of ShardedNTT._mul_pair around
    _sub_dif_rows (dif) or _sub_dit_rows. Returns the ranks' outputs."""
    cuts = np.cumsum([x.shape[-1] for x in xs])[:-1]
    b = xs[0].shape[0]

    def flat(a):  # [B, n_sub, size, L] -> [n_sub, size, B * L]
        return a.transpose(1, 2, 0, 3).reshape(a.shape[1], size, -1)

    def mul(v, tabs):
        tab = np.tile(np.concatenate(tabs, axis=-1), (1, 1, 1, b))
        return shoup_mul(v, tab[:, 0], tab[:, 1], q)

    v = jnp.asarray(flat(np.concatenate(xs, axis=-1)))
    if pre is not None:
        v = mul(v, pre)
    v = (_sub_dif_rows if dif else _sub_dit_rows)(v, st[..., None], q, size)
    if post is not None:
        v = mul(v, post)
    v = np.asarray(v)
    out = v.reshape(v.shape[0], size, b, -1).transpose(2, 0, 1, 3)
    return np.split(out, cuts, axis=-1)


@lru_cache(maxsize=None)
def _reference(n):
    """The JAX package's phases at ring n for every rank of every shard
    count: {"x": planes [B, n_sub, n1, n2], "primes", (phase, d): the
    ranks' outputs}, each phase fed the previous one's JAX outputs
    through the all-to-all."""
    primes = [q for e in build_chain(BITS, n) for q in e.primes]
    t = PallasNTTTables(primes, n)
    n1, n2 = t.n1, t.n2
    q = t.q[:, None, None]
    rng = np.random.default_rng(n)
    x = np.stack([rng.integers(0, p, (VECTORS // n1, n1, n2), dtype=np.uint64)
                  for p in primes], axis=1).astype(np.uint32)
    lanes = [slice(r * n2 // d, (r + 1) * n2 // d)
             for d in SHARDS for r in range(d)]
    rows = [slice(r * n1 // d, (r + 1) * n1 // d)
            for d in SHARDS for r in range(d)]

    def per_d(outs):
        it = iter(outs)
        return {d: [next(it) for _ in range(d)] for d in SHARDS}

    def every(dct):
        return [v for d in SHARDS for v in dct[d]]

    ref = {"x": x, "primes": primes}
    fc = per_d(_jax_phase([x[..., c] for c in lanes], t.st1_f, q, n1, True,
                          [t.tw_fwd[..., c] for c in lanes],
                          [t.corr_fwd[..., c] for c in lanes]))
    fr = per_d(_swap(_jax_phase(
        _swap(every({d: _a2a(fc[d]) for d in SHARDS})), t.st2_f, q, n2,
        True)))
    ir = per_d(_jax_phase(_swap(every(fr)), t.st2_i, q, n2, False,
                          post=[t.corr_inv[..., c] for c in rows]))
    ic = per_d(_jax_phase(
        _swap(every({d: _a2a(ir[d]) for d in SHARDS})), t.st1_i, q, n1,
        False, post=[t.tw_inv[..., c] for c in lanes]))
    for d in SHARDS:
        for name, v in (("fwd_cols", fc), ("fwd_rows", fr),
                        ("inv_rows", ir), ("inv_cols", ic)):
            ref[(name, d)] = v[d]
    return ref


def _u(t):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("n", RINGS)
def test_phases_equal_jax(n, d):
    """Each plain phase on each rank bit-identical to the JAX package's,
    the forward phases composed over the ranks the single-device NTT, the
    inverse ones the input."""
    ref = _reference(n)
    x, primes = ref["x"], ref["primes"]
    phases = [ShardPhases(primes, n, d, r) for r in range(d)]
    calls = dict(PLAIN_CALLS)

    def run(name, xs):
        got = [_u(getattr(ph, name)(upload(v, "cpu")))
               for ph, v in zip(phases, xs)]
        for r, (g, w) in enumerate(zip(got, ref[(name, d)])):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {r}")
        return got

    nl = x.shape[-1] // d
    fwd = run("fwd_rows", _a2a(run("fwd_cols", [
        x[..., r * nl:(r + 1) * nl] for r in range(d)])))
    ntt = np.stack([get_table(p, n).ntt(x[:, i].reshape(-1, n))
                    for i, p in enumerate(primes)], axis=1)
    np.testing.assert_array_equal(
        np.concatenate(fwd, axis=-2).reshape(ntt.shape), ntt)
    back = run("inv_cols", _a2a(run("inv_rows", fwd)))
    np.testing.assert_array_equal(np.concatenate(back, axis=-1), x)
    assert {k: PLAIN_CALLS[k] - calls[k] for k in calls} == {
        "ntt_shard_fwd": 2 * d, "ntt_shard_inv": 2 * d}


def test_phase_refuses_other_devices_and_types():
    ph = ShardPhases([1073668097, 1073815553], 1024, 1, 0)
    with pytest.raises(ValueError, match="int32"):
        ph.fwd_cols(torch.zeros((2, 8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="cannot shard"):
        ShardPhases([1073668097], 1024, 16, 0)
