"""The elementwise chains of eva_tpu_torch against the JAX package: E1's
MAC form (the structured key switch's inner product in one launch), its
several-planes form (one op over a rotation sum's or a ciphertext's
components in one launch) and E3 over every prime and polynomial of a
rescale in one launch, with an optional addend.

Inputs are made from numpy seeds at Sobel's context (n_cur 11, n_key 2,
alpha 2: six digit groups) at N = 1024 and 2048, with batch dims () and
(3,). The port runs on device="cpu", where each form runs its plain
PyTorch version (the CUDA kernels are held against those in
test_torch_cuda.py, on a card); the JAX package runs eagerly on the CPU.
Every comparison is bit-identity of the uint32 values."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eva_tpu.backend import executor_jax as EJ
from eva_tpu.backend import tables as TJ
from eva_tpu.crypto.context import get_context as context_j
from eva_tpu_torch.backend import executor_torch as ET
from eva_tpu_torch.backend import ks
from eva_tpu_torch.backend import modmath as M
from eva_tpu_torch.backend.modmath import upload
from eva_tpu_torch.backend.tables import DeviceLevelOps
from eva_tpu_torch.crypto.context import get_context

from test_torch_executor import _run

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)

SOBEL_BITS = (60, 20, 60, 60, 60, 60, 60)
LEADS = [(), (3,)]


def _res(rng, primes, shape):
    """Random residues of `primes` [..., len(primes), N] (shape = [..., N])
    as uint32 numpy."""
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64)
                     for q in primes], axis=len(shape) - 1).astype(np.uint32)


def _t(a):
    return upload(np.asarray(a), "cpu")


def _u(t):
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _j(a):
    return np.asarray(a).astype(np.uint32)


class _JaxMacShim:
    """What eva_tpu's JaxProgram._ks_mac reads of its program: the
    context, its level ops, and no sequence-parallel context."""
    _seq = None

    def __init__(self, ctx):
        self.ctx = ctx

    def _ops_at(self, level):
        return EJ.level_ops(self.ctx.primes_at_level(level), self.ctx.n)

    def _lops(self, primes):
        return EJ.level_ops(list(primes), self.ctx.n)


@pytest.mark.parametrize("n,level,alpha,lead", [
    (n, level, alpha, lead) for n, level, alpha in (
        (1024, 0, 2), (1024, 0, 1), (1024, 5, 2)) for lead in LEADS]
    + [(2048, 0, 2, (3,))])
def test_mac_matches_jax_structured_mac(n, level, alpha, lead):
    """E1's MAC form (plain version) equals the JAX package's structured
    MAC (mul_mont of each digit block, tree_sum over the digits, the
    concatenation), both key halves, at Sobel's level 0 (six groups; 11
    at alpha 1) and its deepest level (one group, no foreign rows); also
    with the digits a strided window of a larger stack."""
    ctx_j = context_j(SOBEL_BITS, (), n, 1)
    ctx = get_context(SOBEL_BITS, (), n, 1)
    primes, keyp = ctx.primes_at_level(level), list(ctx.key_primes)
    groups, _, _ = ET._ks_maps(ctx, level, alpha)
    rng = np.random.default_rng(n + 10 * level + alpha)
    own = _res(rng, primes, lead + (n,))
    a = _res(rng, primes, lead + (groups - 1, n)) if groups > 1 else None
    b = _res(rng, keyp, lead + (groups, n))
    layout = [(_res(rng, primes, (n,)),
               _res(rng, primes, (groups - 1, n)) if groups > 1 else None,
               _res(rng, keyp, (groups, n))) for _ in range(2)]

    def jx(x):
        return None if x is None else jnp.asarray(x)

    want = jax.jit(lambda d, lay: EJ.JaxProgram._ks_mac(
        _JaxMacShim(ctx_j), EJ.StructDigits(*d, groups), level, lay))(
        (jx(own), jx(a), jx(b)),
        tuple(tuple(jx(k) for k in half) for half in layout))

    def tt(x):
        return None if x is None else _t(x)

    ext = DeviceLevelOps(primes + keyp, n, "cpu")
    keys = [tuple(tt(k) for k in half) for half in layout]
    calls = M.PLAIN_CALLS["mac"]
    got = ext.mac(_t(own), tt(a), _t(b), *keys)
    assert M.PLAIN_CALLS["mac"] == calls + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), _j(w))
    # The same digits as the middle shard of a stack of three.
    stack = [np.stack([np.zeros_like(x), x, np.zeros_like(x)], axis=len(lead))
             if x is not None else None for x in (own, a, b)]
    views = [None if x is None else _t(x).select(len(lead), 1)
             for x in stack]
    assert views[0].is_contiguous() == (not lead)
    for g, w in zip(ext.mac(*views, *keys), want):
        np.testing.assert_array_equal(_u(g), _j(w))


_EW_J = {"add": lambda o, x, y: o.add(x, y),
         "sub": lambda o, x, y: o.sub(x, y),
         "neg": lambda o, x: o.neg(x),
         "mul_mont": lambda o, x, y: o.mul_mont(x, y),
         "mul": lambda o, x, y: o.mul(x, y)}


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("op", list(_EW_J))
def test_several_planes_match_jax_ops(op, lead):
    """E1's several-planes form (plain version) over a rotation sum's
    components (c0, c1 on the 11 data primes, acc0, acc1 on the 13 of
    the extended basis, one table) equals the JAX package's op plane by
    plane; with one plane it is the single form."""
    n = 1024
    ctx = get_context(SOBEL_BITS, (), n, 1)
    data, basis = ctx.primes_at_level(0), ctx.primes_at_level(0) + list(
        ctx.key_primes)
    dev_j, ext_j = TJ.DeviceLevelOps(data, n), TJ.DeviceLevelOps(basis, n)
    ext = DeviceLevelOps(basis, n, "cpu")
    rng = np.random.default_rng(len(op) + len(lead))
    c0, c1 = (_res(rng, data, lead + (n,)) for _ in range(2))
    acc0, acc1 = (_res(rng, basis, lead + (n,)) for _ in range(2))
    pt = _res(rng, basis, (n,))  # a plaintext shared by the batch
    if op == "neg":
        planes = [(c0,), (c1,), (acc0,), (acc1,)]
    else:
        planes = [(c0, pt[:len(data)]), (c1, c0), (acc0, pt), (acc1, acc0)]
    calls = dict(M.PLAIN_CALLS)
    got = ext.ew_planes(op, [tuple(_t(x) for x in p) for p in planes])
    single = ext.ew_planes(op, [tuple(_t(x) for x in planes[2])])
    assert M.PLAIN_CALLS["multi"] == calls["multi"] + 1
    assert M.PLAIN_CALLS[op] == calls[op] + 1
    for g, p in zip(got + single, planes + planes[2:3]):
        ops_j = dev_j if p[0].shape[-2] == len(data) else ext_j
        want = _EW_J[op](ops_j, *(jnp.asarray(x) for x in p))
        np.testing.assert_array_equal(_u(g), _j(want))


@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("polys", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_divide_last_matches_jax_loop(k, polys, addend):
    """E3 over k primes and 1-3 polynomials in one call (plain version)
    equals looping the JAX package's divide_last_planes over the primes
    for each polynomial, after the JAX add of the addend where given;
    batch dims (3,)."""
    n = 1024
    ctx = get_context(SOBEL_BITS, (), n, 1)
    prim = ctx.primes_at_level(0) + list(ctx.key_primes)  # 13 rows
    rng = np.random.default_rng(100 * k + 10 * polys + addend)
    xs = [_res(rng, prim, (3, n)) for _ in range(polys)]
    adds = [_res(rng, prim, (3, n)) for _ in range(polys)] if addend \
        else None
    calls = M.PLAIN_CALLS["divide_last"]
    got = ks.divide_last([_t(x) for x in xs], prim, k,
                         DeviceLevelOps(prim[:-1], n, "cpu"),
                         None if adds is None else [_t(d) for d in adds])
    assert M.PLAIN_CALLS["divide_last"] == calls + 1
    for j, g in enumerate(got):
        x = jnp.asarray(xs[j])
        if addend:
            x = TJ.DeviceLevelOps(prim, n).add(x, jnp.asarray(adds[j]))
        p = list(prim)
        for _ in range(k):
            x = EJ.divide_last_planes(x, p, EJ.level_ops(p[:-1], n))
            p = p[:-1]
        assert g.shape == (3, len(prim) - k, n)
        np.testing.assert_array_equal(_u(g), _j(x))


def test_strided_operands_equal_their_copies():
    """Row slices of batched planes (as a ModSwitch or a shard window
    leaves them) give the residues of their contiguous copies, in the
    single and the several-planes form and in E3's addend."""
    n = 1024
    ctx = get_context(SOBEL_BITS, (), n, 1)
    basis = ctx.primes_at_level(0) + list(ctx.key_primes)
    dev = DeviceLevelOps(basis[:11], n, "cpu")
    ext = DeviceLevelOps(basis, n, "cpu")
    rng = np.random.default_rng(7)
    wide = _t(_res(rng, basis, (3, n)))
    view, other = wide[:, :11, :], _t(_res(rng, basis[:11], (3, n)))
    assert not view.is_contiguous()
    copy = view.contiguous()
    assert torch.equal(dev.add(view, other), dev.add(copy, other))
    assert torch.equal(dev.mul(other, view), dev.mul(other, copy))
    for g, w in zip(ext.ew_planes("sub", [(view, other), (wide, wide)]),
                    ext.ew_planes("sub", [(copy, other), (wide, wide)])):
        assert torch.equal(g, w)
    rest = DeviceLevelOps(basis[:10], n, "cpu")
    g, = ks.divide_last([other], basis[:11], 2, rest, [view])
    w, = ks.divide_last([other], basis[:11], 2, rest, [copy])
    assert torch.equal(g, w)


@pytest.mark.parametrize("name,structured", [
    ("rot_of_sum", False), ("babystep", False), ("hoisted_sum", False),
    ("babystep", True)])
def test_hoisted_rotations_take_one_mac_each(name, structured, monkeypatch):
    """On a program with hoisted rotations (bit-identical to eva_tpu's
    numpy backend, as _run checks), each hoisted rotation runs one MAC
    (one plain call: one launch on the card), and the executor's MAC
    neither concatenates nor reduces digit by digit (no tree_sum); with
    the structured key switch every key switch takes the MAC."""
    cats = []
    real_cat = torch.cat

    def cat(*args, **kw):
        cats.append(sys._getframe(1).f_code.co_name)
        return real_cat(*args, **kw)

    monkeypatch.setattr(torch, "cat", cat)
    calls = dict(M.PLAIN_CALLS)
    env = {"EVA_TPU_NO_FUSED_KS": "1"} if structured else {}
    ex_t, _, _ = _run(name, "numpy", monkeypatch, env)
    tp = ex_t._get_torch_program()
    hoisted = [t for t in tp.order if t.op.name.startswith("Rotate")
               and t.operands[0].index in tp._hoisted_sources]
    switches = [t for t in tp.order if t.op.name.startswith("Rotate")
                or t.op.name == "Relinearize"]
    assert hoisted
    macs = M.PLAIN_CALLS["mac"] - calls["mac"]
    assert macs == (len(switches) if structured else len(hoisted))
    assert not {"_ks_mac", "ip", "tree_sum"} & set(cats)
