"""Whole-graph PyTorch executor: runs a compiled EVA program over int64
limb-plane tensors on one torch device.

Port of the single-device part of eva_tpu/backend/executor_jax.py. The
JAX package traces the DAG into one jitted function; PyTorch runs
eagerly, so `_traced` here simply walks the DAG and launches each op.
Every rescale, relinearization and rotation runs the negacyclic NTT
(tables.DeviceLevelOps.ntt/intt: the CUDA kernels on a GPU).

Key switching takes the JAX package's TPU branches: relinearizations,
non-hoisted rotations and both fused relin/rescale pairs run the fused
key switch (ks.ks_mac + ks.ks_epilogue: two CUDA kernels on a GPU), and
every P-division, including the one each hoisted rotation sum pays, runs
the fused epilogue. Hoisted rotations share one digit decomposition in
the structured (own/foreign/key) row layout and MAC it against
inverse-permuted keys. EVA_TPU_NO_FUSED_KS=1 (the JAX package's switch)
selects the structured key switch everywhere instead: digits, MAC
against the structured key layout, then iNTT + P-division + NTT. Both
give ciphertexts bit-identical to the JAX package.

Host/device split follows the protocol roles: encode/encrypt/decrypt are
host-side numpy; `execute` (server role) is this module, one valuation
at a time (`run`), a batch stacked on a leading axis (`run_batched`), or
a stream with the next execution enqueued before the last one's outputs
are fetched (`run_pipelined`). Raw subgraphs stay host-side.

Not ported yet (a program that needs them raises NotImplementedError):
sharded big vectors (vec_size > N/2) and mesh (multi-device)
execution."""

from __future__ import annotations

import os
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..crypto import keys as K
from ..crypto.ciphertext import Ciphertext, Plaintext
from ..crypto.context import CKKSContext
from ..ir import ROTATION, Op, Program, Term, Type
from ..passes import rotation_hoist_sources
from . import resolve_device
from .modmath import to_mont, to_mont_rows as _to_mont_rows
from .ks import MAX_KEY_PRIMES, divide_last_planes, ks_epilogue, ks_mac
from .tables import DeviceLevelOps, level_ops


def _to_dev(arr: np.ndarray, device) -> torch.Tensor:
    """Host residues (uint64/uint32, < 2^32) -> int64 tensor on device."""
    return torch.from_numpy(
        np.ascontiguousarray(arr).astype(np.int64)).to(device)

def _plain_np(pt) -> np.ndarray:
    """Host plaintext planes for upload: the data-prime rows, with the
    extended-basis (key-prime) rows appended when the encode carries them
    (Plaintext.ext; rotation-sum baby-step fusion). The executor detects
    the extra rows by shape — rows :n_cur are exactly the normal
    encoding."""
    arr = pt.poly
    if getattr(pt, "ext", None) is not None:
        arr = np.concatenate([arr, pt.ext], axis=-2)
    return arr


@lru_cache(maxsize=None)
def _ks_dev_tables(ctx, level: int, alpha: int):
    """Montgomery-form fast-base-extension constants for hybrid key-switch
    decomposition (see CKKSContext.ks_tables), as numpy.

    inv_mont: [n_cur, 1] — [(Qg_t/q_t)^-1]_{q_t} in Montgomery form of q_t
    conv_mont: [n_groups*alpha, n_ext, 1] — (Qg_t/q_t) mod basis[i] in
      Montgomery form of basis[i]; padding rows (beyond n_cur) are zero."""
    primes = ctx.primes_at_level(level)
    basis = primes + ctx.key_primes
    groups, inv, conv = ctx.ks_tables(level, alpha)
    n_groups = len(groups)
    n_cur = len(primes)
    inv_mont = np.empty((n_cur, 1), dtype=np.uint32)
    for t, q in enumerate(primes):
        inv_mont[t, 0] = to_mont(np.array([inv[t]], dtype=np.uint64), q)[0]
    conv_mont = np.zeros((n_groups * alpha, len(basis), 1), dtype=np.uint32)
    for i, q in enumerate(basis):
        conv_mont[:n_cur, i, 0] = to_mont(conv[:, i], q)
    return n_groups, inv_mont, conv_mont


@lru_cache(maxsize=None)
def _ks_maps(ctx, level: int, alpha: int):
    """Static digit-layout maps for one (level, alpha).

    owner[t]  = digit index whose group contains data prime t
    sel[k, t] = the k-th digit != owner[t] (foreign-digit enumeration)"""
    groups, _, _ = ctx.ks_tables(level, alpha)
    n_cur = len(ctx.primes_at_level(level))
    n_groups = len(groups)
    owner = np.empty(n_cur, dtype=np.int64)
    for j, g_j in enumerate(groups):
        for t in g_j:
            owner[t] = j
    sel = np.empty((n_groups - 1, n_cur), dtype=np.int64)
    for t in range(n_cur):
        sel[:, t] = [k if k < owner[t] else k + 1
                     for k in range(n_groups - 1)]
    return n_groups, owner, sel


class DevPerm:
    """NTT-domain Galois automorphism applicator for device planes: a
    gather along the last axis with a fixed int64 index (the slot
    permutation inside SEAL's apply_galois). The JAX package's MXU
    one-hot formulation is a TPU artifact and is not ported."""

    def __init__(self, perm: np.ndarray, device):
        self.perm = torch.from_numpy(
            np.asarray(perm).astype(np.int64)).to(device)
        self.n = self.perm.shape[0]

    def __call__(self, arr):
        return torch.index_select(arr, -1, self.perm)


# Values pin the ctx so its id cannot be reused by a new context while
# the cached DevPerm is alive (contexts are few and process-cached).
_DEV_PERM_CACHE: Dict[Tuple, Tuple[CKKSContext, DevPerm]] = {}


def dev_perm(ctx: CKKSContext, g: int, device) -> DevPerm:
    device = resolve_device(device)
    key = (id(ctx), g, device)
    if key not in _DEV_PERM_CACHE:
        _DEV_PERM_CACHE[key] = (ctx, DevPerm(ctx.perm_for_elt(g), device))
    return _DEV_PERM_CACHE[key][1]


class StructDigits:
    """Gadget digits in the structured (own/foreign/key) row layout.

    own: [..., n_cur, N]            row t = digit owner[t] at prime t
    a:   [..., n_groups-1, n_cur, N] foreign data rows (None if 1 digit)
    b:   [..., n_groups, n_key, N]   key-prime rows

    The inner product with a key in the matching layout needs no
    digit-stack gathers or concatenations — the row (j, i) terms are
    simply regrouped; sums are unchanged."""

    def __init__(self, own, a, b, n_groups: int):
        self.own = own
        self.a = a
        self.b = b
        self.n_groups = n_groups


class DeviceKeys:
    """Key material lazily converted to device form (Montgomery, int64)
    in the per-level structured layout matching StructDigits. Only the
    (key, level) pairs a program actually uses are uploaded."""

    def __init__(self, ctx: CKKSContext, keys: K.KeySet, device):
        self.ctx = ctx
        self.keys = keys
        self.device = resolve_device(device)
        self._cache: Dict[Tuple, tuple] = {}

    def layout(self, ksk: K.KSwitchKey, level: int):
        """((k0_own, k0_a, k0_b), (k1_own, k1_a, k1_b)) for one level."""
        # Cache values pin the ksk so its id cannot be reused by a new
        # key while the entry is alive (same hazard as _DEV_PERM_CACHE).
        key = (id(ksk), level)
        if key not in self._cache:
            self._cache[key] = (ksk, self._build_layout(ksk, level))
        return self._cache[key][1]

    def layout_rot(self, ksk: K.KSwitchKey, level: int, g: int):
        """Structured layout with every row INVERSE-permuted by the
        Galois element g's NTT-domain permutation.

        Hoisted rotations MAC the shared (unpermuted) digit stack against
        this layout and apply the automorphism once to the two OUTPUT
        polynomials instead of to every digit row:
        sum_j sigma(D_j)*k_j = sigma(sum_j D_j * sigma^-1(k_j)), and the
        P-division epilogue commutes with sigma exactly (the centered
        divide-and-round is an odd function per coefficient — key primes
        are odd so ties cannot occur — and sigma is a signed coefficient
        permutation). Values are bit-identical."""
        key = ("rot", id(ksk), level, g)
        if key not in self._cache:
            p = self.ctx.perm_for_elt(g)
            inv = np.empty_like(p)
            inv[p] = np.arange(p.shape[0], dtype=p.dtype)
            self._cache[key] = (
                ksk, self._build_layout(ksk, level, col_perm=inv))
        return self._cache[key][1]

    def dense_layout(self, ksk: K.KSwitchKey, level: int):
        """(k0, k1) as dense [n_groups, n_ext, N] Montgomery planes in
        digit order: the layout the fused key switch (ks.ks_mac)
        streams."""
        key = ("dense", id(ksk), level)
        if key not in self._cache:
            self._cache[key] = (ksk, self._build_dense(ksk, level))
        return self._cache[key][1]

    def _build_dense(self, ksk: K.KSwitchKey, level: int):
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        n_cur = len(primes)
        n_key = len(ctx.key_primes)
        n_data_all = len(ctx.data_primes)
        n_groups, _, _ = _ks_maps(ctx, level, ksk.alpha)
        basis = primes + list(ctx.key_primes)

        def build(klist):
            dense = np.empty((n_groups, n_cur + n_key, ctx.n),
                             dtype=np.uint64)
            for j in range(n_groups):
                for t in range(n_cur):
                    dense[j, t] = klist[j][t]
                for kk in range(n_key):
                    dense[j, n_cur + kk] = klist[j][n_data_all + kk]
            return _to_dev(np.stack(
                [_to_mont_rows(dense[j], basis) for j in range(n_groups)]),
                self.device)

        return (build(ksk.k0), build(ksk.k1))

    def _build_layout(self, ksk: K.KSwitchKey, level: int, col_perm=None):
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        n_cur = len(primes)
        n_key = len(ctx.key_primes)
        n_data_all = len(ctx.data_primes)
        n_groups, owner, sel = _ks_maps(ctx, level, ksk.alpha)

        def build(klist):
            own = np.empty((n_cur, ctx.n), dtype=np.uint64)
            a = np.empty((max(n_groups - 1, 0), n_cur, ctx.n),
                         dtype=np.uint64)
            b = np.empty((n_groups, n_key, ctx.n), dtype=np.uint64)
            for t in range(n_cur):
                own[t] = klist[owner[t]][t]
                for k in range(n_groups - 1):
                    a[k, t] = klist[sel[k, t]][t]
            for j in range(n_groups):
                for kk in range(n_key):
                    b[j, kk] = klist[j][n_data_all + kk]
            if col_perm is not None:
                own = own[..., col_perm]
                a = a[..., col_perm]
                b = b[..., col_perm]
            own_m = _to_dev(_to_mont_rows(own, primes), self.device)
            a_m = (_to_dev(np.stack(
                [_to_mont_rows(a[k], primes)
                 for k in range(n_groups - 1)]), self.device)
                if n_groups > 1 else None)
            b_m = _to_dev(np.stack(
                [_to_mont_rows(b[j], ctx.key_primes)
                 for j in range(n_groups)]), self.device)
            return own_m, a_m, b_m

        return (build(ksk.k0), build(ksk.k1))


_DEVICE_KEYS_CACHE: Dict[Tuple, Tuple[K.KeySet, DeviceKeys]] = {}


def device_keys(ctx: CKKSContext, keys: K.KeySet, device) -> DeviceKeys:
    device = resolve_device(device)
    key = (id(keys), device)
    hit = _DEVICE_KEYS_CACHE.get(key)
    if hit is None or hit[0] is not keys:
        hit = _DEVICE_KEYS_CACHE[key] = (keys, DeviceKeys(ctx, keys, device))
    return hit[1]


class TorchProgram:
    """Runs a compiled EVA program eagerly on one torch device."""

    def __init__(self, program: Program, ctx: CKKSContext, keys: K.KeySet,
                 plan, types, order: List[Term], device):
        self.program = program
        self.ctx = ctx
        self.keys = keys
        self.plan = plan
        self.types = types
        self.order = order
        self.device = resolve_device(device)
        if program.vec_size > ctx.n // 2:
            raise NotImplementedError(
                "torch backend: sharded big vectors (vec_size > N/2) are "
                "not ported yet")
        self.dkeys = device_keys(ctx, keys, self.device)
        # Nodes consumed by fused pairs, in both adjacency orders.
        self._fused_rescales = {
            t.operands[0].index for t in order
            if t.op == Op.Relinearize
            and t.operands[0].op == Op.Rescale
            and len(t.operands[0].uses) == 1}
        self._fused_relins = {
            t.operands[0].index for t in order
            if t.op == Op.Rescale
            and t.operands[0].op == Op.Relinearize
            and len(t.operands[0].uses) == 1}
        self._hoisted_sources = rotation_hoist_sources(order)
        # Rotation-sum epilogue fusion: rotations stay in deferred
        # (pre-division accumulator) form until a non-Add consumer, so
        # directly-summed rotations share one P-division.
        # EVA_TPU_NO_ROTSUM_FUSION restores the eager per-rotation form
        # (the host planner reads the same variable).
        self._rotsum_on = not os.environ.get("EVA_TPU_NO_ROTSUM_FUSION")
        # Device-upload cache: program constants (encode-cache Plaintexts)
        # and re-executed input Ciphertexts are uploaded once, not per
        # run(). Keyed by object id; values pin the host object so ids
        # cannot be reused while an entry is alive. Bounded FIFO so
        # arbitrary fresh ciphertexts cannot grow it.
        self._upload_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._upload_cache_cap = 256
        self._consts: Dict[Tuple, torch.Tensor] = {}

    def _const(self, key, arr: np.ndarray) -> torch.Tensor:
        """A static host table (key-switch constants, digit maps) on the
        device, uploaded once per program."""
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = _to_dev(arr, self.device)
        return t

    def _upload(self, host_obj, planes_fn):
        """Cache device copies of a host Plaintext/Ciphertext."""
        key = id(host_obj)
        hit = self._upload_cache.get(key)
        if hit is not None and hit[0] is host_obj:
            self._upload_cache.move_to_end(key)
            return hit[1]
        dev = planes_fn(host_obj)
        self._upload_cache[key] = (host_obj, dev)
        while len(self._upload_cache) > self._upload_cache_cap:
            self._upload_cache.popitem(last=False)
        return dev

    # -- device op helpers ---------------------------------------------------

    def _lops(self, primes) -> DeviceLevelOps:
        return level_ops(list(primes), self.ctx.n, self.device)

    def _aperm(self, g: int) -> DevPerm:
        return dev_perm(self.ctx, g, self.device)

    def _ops_at(self, level: int) -> DeviceLevelOps:
        return self._lops(self.ctx.primes_at_level(level))

    def _ext_ops_at(self, level: int) -> DeviceLevelOps:
        return self._lops(self.ctx.primes_at_level(level)
                          + self.ctx.key_primes)

    def _ks_fbe_y(self, coeffs, level: int, alpha: int):
        """Key-switch prologue: y_t = [d_t * (Qg_t/q_t)^-1]_{q_t},
        zero-padded to n_groups*alpha rows."""
        ctx = self.ctx
        n_groups, inv_mont, _ = _ks_dev_tables(ctx, level, alpha)
        n_cur = len(ctx.primes_at_level(level))
        dev = self._ops_at(level)
        y = dev.mul_mont(coeffs, self._const(("ks_inv", level, alpha),
                                             inv_mont))
        pad = n_groups * alpha - n_cur
        if pad:
            y = torch.cat(
                [y, y.new_zeros(y.shape[:-2] + (pad, y.shape[-1]))],
                dim=-2)
        return y, n_groups

    def _ks_digits(self, poly, level: int,
                   alpha: int = None) -> "StructDigits":
        """Gadget decomposition digits, NTT'd in the extended basis — the
        dominant key-switch cost. Separated so hoisted rotations can
        compute it ONCE per source ciphertext. With the NTT-domain input
        available, each digit's own-group rows are the input planes
        themselves (D_j == x mod q_t for q_t in group j, and the NTT
        output depends only on the residue class), so only foreign rows
        go through the NTT."""
        dev = self._ops_at(level)
        return self._ks_digits_from_coeffs(dev.intt(poly), level,
                                           alpha=alpha, poly_ntt=poly)

    def _ks_digits_from_coeffs(self, coeffs, level: int, alpha: int = None,
                               poly_ntt=None) -> "StructDigits":
        """Digits from COEFFICIENT-domain input, returned in the
        structured own/foreign/key row layout.

        alpha=1: each residue row broadcasts into every basis row, and
        one Shoup-by-1 pass reduces it. alpha>1 (hybrid digits): fast
        base extension D_j mod q_i = sum_t (d_t*inv_t mod q_t) *
        conv[t][i] — a couple of elementwise Montgomery multiplies — then
        alpha-times FEWER rows go through the NTT."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        n_cur = len(primes)
        n_key = len(ctx.key_primes)
        n_ext = n_cur + n_key
        if alpha is None:
            alpha = self.keys.ks_alpha
        n_groups, owner, sel = _ks_maps(ctx, level, alpha)
        ext = self._ext_ops_at(level)
        if alpha == 1:
            # Values are < q_t but possibly >= basis[i], and the
            # merged-twist NTT requires reduced input.
            acc = ext.reduce(coeffs[..., :, None, :].expand(
                coeffs.shape[:-2] + (n_cur, n_ext, coeffs.shape[-1])))
        else:
            _, _, conv_mont = _ks_dev_tables(ctx, level, alpha)
            y, _ = self._ks_fbe_y(coeffs, level, alpha)
            yb = y[..., :, None, :].expand(
                y.shape[:-2] + (n_groups * alpha, n_ext, y.shape[-1]))
            prod = ext.mul_mont(yb, self._const(("ks_conv", level, alpha),
                                                conv_mont))
            g = prod.reshape(
                prod.shape[:-3] + (n_groups, alpha, n_ext, prod.shape[-1]))
            acc = g[..., 0, :, :]
            for k in range(1, alpha):
                acc = ext.add(acc, g[..., k, :, :])

        dev = self._ops_at(level)

        def take_digit_axis(arr, name, idx):
            # gather needs an index of the output's full shape: expand the
            # static [n_dig, n_cur] table over leading dims and N.
            full = self._const(("ks_idx", name, level, alpha), idx)
            full = full[..., None].expand(
                arr.shape[:-3] + idx.shape + (arr.shape[-1],))
            return torch.gather(arr, -3, full)

        if poly_ntt is not None:
            own = poly_ntt
        else:
            own_in = take_digit_axis(acc[..., :, :n_cur, :], "owner",
                                     owner[None, :])
            own = dev.ntt(own_in[..., 0, :, :])
        if n_groups > 1:
            a_in = take_digit_axis(acc[..., :, :n_cur, :], "sel", sel)
            a_ntt = dev.ntt(a_in)  # [..., n_groups-1, n_cur, N]
        else:
            a_ntt = None
        b_ntt = self._lops(list(ctx.key_primes)).ntt(
            acc[..., :, n_cur:, :])  # [..., n_groups, n_key, N]
        return StructDigits(own, a_ntt, b_ntt, n_groups)

    def _ks_mac(self, digits: "StructDigits", level: int, layout):
        """Inner product of structured digits with a key-switch key in
        the matching layout: the pre-division extended-basis
        accumulators. Hoisted rotations pass an INVERSE-permuted key
        layout (DeviceKeys.layout_rot) and apply the automorphism to the
        two accumulators (or outputs)."""
        ctx = self.ctx
        dev = self._ops_at(level)
        key_ops = self._lops(list(ctx.key_primes))

        def tree_sum(ops, t):
            while t.shape[-3] > 1:
                m = t.shape[-3]
                half = m // 2
                lo = t[..., :half, :, :]
                hi = t[..., half:2 * half, :, :]
                rest = t[..., 2 * half:, :, :]
                t = torch.cat([ops.add(lo, hi), rest], dim=-3)
            return t[..., 0, :, :]

        def ip(k_own, k_a, k_b):
            acc_data = dev.mul_mont(digits.own, k_own)
            if digits.a is not None:
                ta = tree_sum(dev, dev.mul_mont(digits.a, k_a))
                acc_data = dev.add(acc_data, ta)
            acc_key = tree_sum(key_ops, key_ops.mul_mont(digits.b, k_b))
            return torch.cat([acc_data, acc_key], dim=-2)

        return ip(*layout[0]), ip(*layout[1])

    def _ks_apply(self, digits: "StructDigits", level: int, layout,
                  coeff_out=False):
        """MAC + P-division (see _ks_mac / _ks_div2)."""
        acc0, acc1 = self._ks_mac(digits, level, layout)
        return self._ks_div2(acc0, acc1, level, coeff_out=coeff_out)

    def _ks_div2(self, acc0, acc1, level: int, coeff_out=False):
        """Division of the two extended-basis key-switch accumulators by
        the special modulus P — the rotation-sum fusion point: summed
        accumulators pay this ONCE (see _rotate_acc)."""
        primes = self.ctx.primes_at_level(level)
        ext = self._ext_ops_at(level)

        if self._fused_ks_ok():
            # The fused iNTT + P-division (+ output NTT) epilogue, also
            # for hoisted rotation sums (JAX executor_jax._ks_div2).
            n = self.ctx.n
            lead = acc0.shape[:-2]
            n_ext = acc0.shape[-2]
            d0, d1 = ks_epilogue(
                acc0.reshape(-1, n_ext, n).contiguous(),
                acc1.reshape(-1, n_ext, n).contiguous(), ext,
                len(self.ctx.key_primes), out_ntt=not coeff_out)
            out_shape = lead + (len(primes), n)
            return d0.reshape(out_shape), d1.reshape(out_shape)

        def div_p(acc):
            coeffs_ext = ext.intt(acc)
            prim = primes + list(self.ctx.key_primes)
            x = coeffs_ext
            for _ in self.ctx.key_primes:
                x = self._divide_last(x, prim)
                prim = prim[:-1]
            return x if coeff_out else self._lops(prim).ntt(x)

        return div_p(acc0), div_p(acc1)

    def _fused_ks_ok(self) -> bool:
        """Use the fused key switch (ks.ks_mac / ks.ks_epilogue) unless
        EVA_TPU_NO_FUSED_KS is set. The JAX package's 12 MB VMEM budget
        does not carry over: each kernel block holds one row in shared
        memory (<= 128 KB at N=32768) whatever n_ext is, so the limits
        are the kernels' ring sizes and key-prime count."""
        if os.environ.get("EVA_TPU_NO_FUSED_KS"):
            return False
        return (1024 <= self.ctx.n <= 32768
                and len(self.ctx.key_primes) <= MAX_KEY_PRIMES)

    def _ks_fused_mac(self, coeffs, level: int, ksk, poly_ntt=None):
        """MAC of the fused key switch from coefficient-domain input:
        FBE + digit NTTs + key MACs in one kernel, returning the
        pre-division extended-basis accumulators (the epilogue runs in
        _ks_div2 — once per rotation SUM). When the caller holds the
        polynomial's NTT planes (poly_ntt), each digit's own rows are
        read from them instead of recomputed."""
        ctx = self.ctx
        alpha = ksk.alpha  # per-key digit grouping (matches dense_layout)
        n_cur = len(ctx.primes_at_level(level))
        n_ext = n_cur + len(ctx.key_primes)
        y, n_groups = self._ks_fbe_y(coeffs, level, alpha)
        lead = y.shape[:-2]
        y = y.reshape(-1, n_groups, alpha, ctx.n).contiguous()
        x_ntt = (None if poly_ntt is None
                 else poly_ntt.reshape(-1, n_cur, ctx.n).contiguous())
        _, _, conv_mont = _ks_dev_tables(ctx, level, alpha)
        _, owner, _ = _ks_maps(ctx, level, alpha)
        conv = self._const(("ks_conv_dense", level, alpha),
                           conv_mont[..., 0])
        owner_ext = self._const(("ks_owner", level, alpha), np.concatenate(
            [owner, np.full(n_ext - n_cur, -1, dtype=np.int64)]))
        k0, k1 = self.dkeys.dense_layout(ksk, level)
        acc0, acc1 = ks_mac(y, k0, k1, conv, owner_ext,
                            self._ext_ops_at(level), x_ntt)
        shape = lead + (n_ext, ctx.n)
        return acc0.reshape(shape), acc1.reshape(shape)

    def _ks_fused_coeffs(self, coeffs, level: int, ksk, out_ntt: bool,
                         poly_ntt=None):
        """Fused key switch from coefficient-domain input: the MAC kernel
        (_ks_fused_mac), then the epilogue kernels (_ks_div2)."""
        acc0, acc1 = self._ks_fused_mac(coeffs, level, ksk, poly_ntt)
        return self._ks_div2(acc0, acc1, level, coeff_out=not out_ntt)

    def _fin(self, v):
        """Finalize a deferred rotation-sum value ("rotsum", level, c0,
        c1, acc0, acc1) to [c0+d0, (c1+)d1] planes; pass anything else
        through. The single P-division here is the whole point of the
        deferral: N summed rotations paid N MACs but share this one
        epilogue."""
        if not (isinstance(v, tuple) and v and v[0] == "rotsum"):
            return v
        _, level, c0, c1, acc0, acc1 = v
        d0, d1 = self._ks_div2(acc0, acc1, level)
        dev = self._ops_at(level)
        return [dev.add(c0, d0), d1 if c1 is None else dev.add(c1, d1)]

    def _fin_at(self, vals, idx: int):
        """Finalize vals[idx] IN PLACE: a multi-use rotsum must pay its
        epilogue once, and later consumers must observe the same
        finalized value as the numpy backend."""
        v = vals[idx]
        f = self._fin(v)
        if f is not v:
            vals[idx] = f
        return f

    def _rotate_acc(self, polys, steps: int, level: int,
                    dev: DeviceLevelOps, hoist=None, src_key=None):
        """Galois rotation in DEFERRED-division form: the rotation-sum
        value ("rotsum", level, sigma(c0), None, acc0, acc1) with
        acc0/acc1 the pre-division extended-basis accumulators of the
        key switch of sigma(c1). Adds merge these exactly; any other
        consumer finalizes (_fin) with one shared P-division."""
        ctx = self.ctx
        g = ctx.galois_elt(steps)
        aperm = self._aperm(g)
        alpha = self.keys.galois[g].alpha
        c0 = aperm(polys[0])
        if hoist is not None and src_key is not None:
            digits = hoist.get(src_key)
            if digits is None:
                digits = self._ks_digits(polys[1], level)
                hoist[src_key] = digits
            layout = self.dkeys.layout_rot(self.keys.galois[g], level, g)
            acc0, acc1 = self._ks_mac(digits, level, layout)
            return ("rotsum", level, c0, None, aperm(acc0), aperm(acc1))
        c1 = aperm(polys[1])
        if self._fused_ks_ok():
            acc0, acc1 = self._ks_fused_mac(dev.intt(c1), level,
                                            self.keys.galois[g], poly_ntt=c1)
        else:
            digits = self._ks_digits(c1, level, alpha)
            acc0, acc1 = self._ks_mac(
                digits, level, self.dkeys.layout(self.keys.galois[g], level))
        return ("rotsum", level, c0, None, acc0, acc1)

    def _key_switch(self, poly, level: int, ksk):
        if self._fused_ks_ok():
            dev = self._ops_at(level)
            return self._ks_fused_coeffs(dev.intt(poly), level, ksk,
                                         out_ntt=True, poly_ntt=poly)
        return self._ks_apply(self._ks_digits(poly, level, ksk.alpha), level,
                              self.dkeys.layout(ksk, level))

    def _divide_last(self, coeffs, primes: List[int]):
        """Divide-and-round coefficient planes by the last prime (see
        divide_last_planes)."""
        return divide_last_planes(coeffs, primes, self._lops(primes[:-1]))

    def _rescale(self, polys, level: int):
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        entry = ctx.entries_at_level(level)[-1]
        dev = self._ops_at(level)
        out = []
        for c in polys:
            x = dev.intt(c)
            prim = list(primes)
            for _ in entry.primes:
                x = self._divide_last(x, prim)
                prim = prim[:-1]
            out.append(self._lops(prim).ntt(x))
        return out

    # -- the program ---------------------------------------------------------

    def _traced(self, cipher_in: Dict[str, List[torch.Tensor]],
                plain_in: Dict[str, torch.Tensor]):
        ctx = self.ctx
        vals: Dict[int, object] = {}
        hoist: Dict[int, StructDigits] = {}  # per-source rotation digits

        for name, term in self.program.inputs.items():
            key = f"t{term.index}"
            if key in cipher_in:
                vals[term.index] = list(cipher_in[key])
            elif key in plain_in:
                vals[term.index] = ("plain", plain_in[key])

        for term in self.order:
            op = term.op
            idx = term.index
            if self.types[term] == Type.Raw or op in (Op.Input, Op.Constant):
                continue
            if op == Op.Encode:
                vals[idx] = ("plain", plain_in[f"t{idx}"])
                continue
            p = self.plan[idx]
            dev = self._ops_at(p.level)
            args = term.operands
            if op in (Op.Add, Op.Sub, Op.Mul):
                vals[idx] = self._binop(term, vals, dev)
            elif op == Op.Negate:
                v = vals[args[0].index]
                if self._is_rotsum(v):
                    vals[idx] = self._rotsum_neg(v, dev)
                else:
                    vals[idx] = [dev.neg(c)
                                 for c in self._fin_at(vals, args[0].index)]
            elif op in (Op.RotateLeftConst, Op.RotateRightConst):
                steps = term.get_attr(ROTATION)
                if op == Op.RotateRightConst:
                    steps = -steps
                src = self._fin_at(vals, args[0].index)
                hk = (args[0].index
                      if args[0].index in self._hoisted_sources else None)
                if self._rotsum_on and steps % (ctx.n // 2) != 0:
                    vals[idx] = self._rotate_acc(
                        src, steps, p.level, dev,
                        hoist if hk is not None else None, hk)
                elif hk is not None:
                    vals[idx] = self._rotate(src, steps, p.level, dev,
                                             hoist, hk)
                else:
                    vals[idx] = self._rotate(src, steps, p.level, dev)
            elif op == Op.Relinearize:
                if idx in self._fused_relins:
                    vals[idx] = self._fin_at(vals, args[0].index)
                elif args[0].index in self._fused_rescales:
                    prev = self.plan[args[0].operands[0].index]
                    vals[idx] = self._rescale_relin(
                        self._fin_at(vals, args[0].index), prev.level)
                else:
                    vals[idx] = self._relin(self._fin_at(vals, args[0].index),
                                            p.level, dev)
            elif op == Op.ModSwitch:
                v = self._fin_at(vals, args[0].index)
                keep = len(ctx.primes_at_level(p.level))
                if isinstance(v, tuple):
                    vals[idx] = ("plain", v[1][..., :keep, :])
                else:
                    vals[idx] = [c[..., :keep, :] for c in v]
            elif op == Op.Rescale:
                if idx in self._fused_rescales:
                    vals[idx] = self._fin_at(vals, args[0].index)
                elif args[0].index in self._fused_relins:
                    prev = self.plan[args[0].operands[0].index]
                    vals[idx] = self._relin_rescale(
                        self._fin_at(vals, args[0].index), prev.level)
                else:
                    prev = self.plan[args[0].index]
                    vals[idx] = self._rescale(
                        self._fin_at(vals, args[0].index), prev.level)
            elif op == Op.Output:
                vals[idx] = self._fin_at(vals, args[0].index)
            else:
                raise RuntimeError(
                    f"unsupported op in torch backend: {op.name}")

        out = {}
        for name, t in self.program.outputs.items():
            if self.types[t] == Type.Raw:
                continue  # raw outputs are computed host-side
            v = self._fin_at(vals, t.index)
            if isinstance(v, tuple):  # plain output: drop any ext rows
                n_cur = len(ctx.primes_at_level(self.plan[t.index].level))
                out[name] = (v[1][..., :n_cur, :],)
            else:
                out[name] = tuple(v)
        return out

    @staticmethod
    def _is_rotsum(v) -> bool:
        return isinstance(v, tuple) and len(v) == 6 and v[0] == "rotsum"

    def _rotsum_add(self, a, b, dev: DeviceLevelOps, sub: bool = False):
        """Merge/fold for Add/Sub when at least one operand is a deferred
        rotation sum. Returns the merged rotsum, or None when the
        combination can't stay deferred (caller finalizes). Modular adds
        are exact and order-independent, so merged results are
        bit-independent of association order; sub merging is sound the
        same way (round(-x/P) = -round(x/P): odd centered rounding)."""
        if self._is_rotsum(a) and self._is_rotsum(b):
            _, level, c0a, c1a, acc0a, acc1a = a
            _, level_b, c0b, c1b, acc0b, acc1b = b
            if level != level_b:  # pragma: no cover - checker prevents
                return None
            ext = self._ext_ops_at(level)
            f, fe = (dev.sub, ext.sub) if sub else (dev.add, ext.add)
            if c1b is None:
                c1 = c1a
            elif c1a is None:
                c1 = dev.neg(c1b) if sub else c1b
            else:
                c1 = f(c1a, c1b)
            return ("rotsum", level, f(c0a, c0b), c1,
                    fe(acc0a, acc0b), fe(acc1a, acc1b))
        if self._is_rotsum(b):
            if sub:  # a - rs: negate every rs component, then add
                b = self._rotsum_neg(b, dev)
                sub = False
            a, b = b, a
        _, level, c0, c1, acc0, acc1 = a
        f = dev.sub if sub else dev.add
        if isinstance(b, tuple):  # ("plain", pt): folds into c0 only
            pt = b[1]
            if pt.shape[-2] != c0.shape[-2]:  # extended-basis rows present
                pt = pt[..., :c0.shape[-2], :]
            return ("rotsum", level, f(c0, pt), c1, acc0, acc1)
        if isinstance(b, list) and len(b) == 2:
            if c1 is None:
                c1 = dev.neg(b[1]) if sub else b[1]
            else:
                c1 = f(c1, b[1])
            return ("rotsum", level, f(c0, b[0]), c1, acc0, acc1)
        return None  # size-3 ciphertext: finalize and add normally

    def _rotsum_mul(self, rs, pt):
        """Baby-step fusion: multiply a deferred rotation sum by a
        plaintext whose upload carries extended-basis rows (shape
        n_cur + n_key). The multiply distributes over the pre-division
        accumulators, so rot(x,s)*w products keep merging through Adds
        and the whole inner sum pays ONE P-division."""
        _, level, c0, c1, acc0, acc1 = rs
        n_cur = len(self.ctx.primes_at_level(level))
        dev = self._ops_at(level)
        ext = self._ext_ops_at(level)
        ptq = pt[..., :n_cur, :]
        return ("rotsum", level, dev.mul(c0, ptq),
                None if c1 is None else dev.mul(c1, ptq),
                ext.mul(acc0, pt), ext.mul(acc1, pt))

    def _rotsum_neg(self, rs, dev: DeviceLevelOps):
        """Negate a deferred rotation sum without finalizing — EXACTLY
        equal to negate-after-finalize (odd centered rounding)."""
        _, level, c0, c1, acc0, acc1 = rs
        ext = self._ext_ops_at(level)
        return ("rotsum", level, dev.neg(c0),
                None if c1 is None else dev.neg(c1),
                ext.neg(acc0), ext.neg(acc1))

    def _binop(self, term: Term, vals, dev: DeviceLevelOps):
        a = vals[term.operands[0].index]
        b = vals[term.operands[1].index]
        op = term.op
        if self._is_rotsum(a) or self._is_rotsum(b):
            if op in (Op.Add, Op.Sub):
                merged = self._rotsum_add(a, b, dev, sub=(op == Op.Sub))
                if merged is not None:
                    return merged
            elif op == Op.Mul:
                rs, other = (a, b) if self._is_rotsum(a) else (b, a)
                if (not self._is_rotsum(other) and isinstance(other, tuple)
                        and other[0] == "plain"
                        and other[1].shape[-2] > len(
                            self.ctx.primes_at_level(rs[1]))):
                    return self._rotsum_mul(rs, other[1])
            a = self._fin_at(vals, term.operands[0].index)
            b = self._fin_at(vals, term.operands[1].index)
        a_plain = isinstance(a, tuple)
        b_plain = isinstance(b, tuple)
        if not a_plain and not b_plain:
            if op == Op.Mul:
                a0, a1 = a
                b0, b1 = b
                return dev.tensor_product(a0, a1, b0, b1)
            f = dev.add if op == Op.Add else dev.sub
            n = max(len(a), len(b))
            out = []
            for i in range(n):
                if i < len(a) and i < len(b):
                    out.append(f(a[i], b[i]))
                elif i < len(a):
                    out.append(a[i])
                else:
                    out.append(b[i] if op == Op.Add else dev.neg(b[i]))
            return out
        if a_plain and not b_plain:
            if op == Op.Sub:
                raise RuntimeError("plain - cipher should have been lowered")
            a, b = b, a
        pt = b[1]
        if pt.shape[-2] != a[0].shape[-2]:  # extended-basis rows present
            pt = pt[..., :a[0].shape[-2], :]
        if op == Op.Add:
            return [dev.add(a[0], pt)] + list(a[1:])
        if op == Op.Sub:
            return [dev.sub(a[0], pt)] + list(a[1:])
        return [dev.mul(c, pt) for c in a]

    def _relin(self, polys, level: int, dev: DeviceLevelOps):
        if len(polys) == 2:
            return list(polys)
        d0, d1 = self._key_switch(polys[2], level, self.keys.relin)
        return [dev.add(polys[0], d0), dev.add(polys[1], d1)]

    def _relin_rescale(self, polys, level: int):
        """Fused Relinearize -> Rescale (eager-relin adjacency): key-switch
        output stays in the coefficient domain, added to the iNTT'd
        c0/c1, then one rescale division + NTT at the new level."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        entry = ctx.entries_at_level(level)[-1]
        new_primes = primes[:len(primes) - len(entry.primes)]
        dev = self._ops_at(level)
        dev_new = self._lops(new_primes)
        coeffs0 = dev.intt(polys[0])
        coeffs1 = dev.intt(polys[1])
        if len(polys) == 3:
            if self._fused_ks_ok():
                d0, d1 = self._ks_fused_coeffs(
                    dev.intt(polys[2]), level, self.keys.relin,
                    out_ntt=False, poly_ntt=polys[2])
            else:
                digits = self._ks_digits(polys[2], level,
                                         self.keys.relin.alpha)
                d0, d1 = self._ks_apply(
                    digits, level, self.dkeys.layout(self.keys.relin, level),
                    coeff_out=True)
            coeffs0 = dev.add(coeffs0, d0)
            coeffs1 = dev.add(coeffs1, d1)

        def div(x):
            prim = list(primes)
            for _ in entry.primes:
                x = self._divide_last(x, prim)
                prim = prim[:-1]
            return dev_new.ntt(x)

        return [div(coeffs0), div(coeffs1)]

    def _rescale_relin(self, polys, level: int):
        """Fused Rescale -> Relinearize: coefficient-domain between steps,
        rescaled c2 feeds digit decomposition directly, correction added
        before the single final NTT (bit-identical to the unfused pair)."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        entry = ctx.entries_at_level(level)[-1]
        new_level = level + 1
        new_primes = primes[:len(primes) - len(entry.primes)]
        dev_new = self._lops(new_primes)
        dev = self._ops_at(level)
        coeffs = []
        for c in polys:
            x = dev.intt(c)
            prim = list(primes)
            for _ in entry.primes:
                x = self._divide_last(x, prim)
                prim = prim[:-1]
            coeffs.append(x)
        if len(polys) == 2:
            return [dev_new.ntt(c) for c in coeffs]
        if self._fused_ks_ok():
            d0, d1 = self._ks_fused_coeffs(coeffs[2], new_level,
                                           self.keys.relin, out_ntt=False)
        else:
            digits = self._ks_digits_from_coeffs(coeffs[2], new_level,
                                                 self.keys.relin.alpha)
            d0, d1 = self._ks_apply(
                digits, new_level,
                self.dkeys.layout(self.keys.relin, new_level),
                coeff_out=True)
        return [dev_new.ntt(dev_new.add(coeffs[0], d0)),
                dev_new.ntt(dev_new.add(coeffs[1], d1))]

    def _rotate(self, polys, steps: int, level: int, dev: DeviceLevelOps,
                hoist=None, src_key=None):
        """Galois rotation (eager P-division form).

        Sources rotated >=2 times use hoisting: the digit decomposition of
        c1 is computed once and shared across rotations; each rotation
        MACs it against the INVERSE-permuted key (DeviceKeys.layout_rot)
        and permutes only the two output polynomials. Single rotations
        permute c1 FIRST and decompose the permuted polynomial. The
        hoist/permute-first decision depends only on the program, so the
        numpy backend makes the identical choice and results stay
        bit-identical."""
        ctx = self.ctx
        if steps % (ctx.n // 2) == 0:
            return list(polys)
        g = ctx.galois_elt(steps)
        aperm = self._aperm(g)
        if hoist is not None and src_key is not None:
            digits = hoist.get(src_key)
            if digits is None:
                digits = self._ks_digits(polys[1], level)
                hoist[src_key] = digits
            layout = self.dkeys.layout_rot(self.keys.galois[g], level, g)
            d0, d1 = self._ks_apply(digits, level, layout)
            return [aperm(dev.add(polys[0], d0)), aperm(d1)]
        c0 = aperm(polys[0])
        c1 = aperm(polys[1])
        if self._fused_ks_ok():
            d0, d1 = self._ks_fused_coeffs(dev.intt(c1), level,
                                           self.keys.galois[g], out_ntt=True,
                                           poly_ntt=c1)
        else:
            digits = self._ks_digits(c1, level, self.keys.galois[g].alpha)
            d0, d1 = self._ks_apply(
                digits, level, self.dkeys.layout(self.keys.galois[g], level))
        return [dev.add(c0, d0), d1]

    # -- run -----------------------------------------------------------------

    def _inputs(self, host_values: Dict[int, object]):
        """Device inputs of one valuation (through the upload cache)."""
        device = self.device
        cipher_in = {}
        plain_in = {}
        for idx, v in host_values.items():
            if isinstance(v, Ciphertext):
                cipher_in[f"t{idx}"] = self._upload(
                    v, lambda ct: [_to_dev(c, device) for c in ct.polys])
            elif isinstance(v, Plaintext):
                plain_in[f"t{idx}"] = self._upload(
                    v, lambda pt: _to_dev(_plain_np(pt), device))
        return cipher_in, plain_in

    def _result(self, out, b=None) -> Dict[str, object]:
        """Host Ciphertext/Plaintext outputs from host (CPU) tensors;
        with b, batch element b of [B, n_sub, N] planes (a plane without
        the batch axis, computed from constants alone, serves every
        element)."""
        result = {}
        for name, t in self.program.outputs.items():
            if self.types[t] == Type.Raw:
                continue
            planes = [c.numpy().astype(np.uint64) for c in out[name]]
            if b is not None:
                planes = [pl[b] if pl.ndim == 3 else pl for pl in planes]
            p = self.plan[t.index]
            if self.types[t] == Type.Plain:
                result[name] = Plaintext(planes[0], p.level, p.scale)
            else:
                result[name] = Ciphertext(planes, p.level, p.scale)
        return result

    def run(self, host_values: Dict[int, object]) -> Dict[str, Ciphertext]:
        """host_values: term index -> Ciphertext (inputs) or Plaintext
        (inputs + encodes, already host-encoded). Returns output name ->
        Ciphertext (numpy, uint64)."""
        out = self._traced(*self._inputs(host_values))
        return self._result({name: [c.cpu() for c in planes]
                             for name, planes in out.items()})

    def run_batched(self, host_values_list) -> List[Dict[str, object]]:
        """Execute the program over a BATCH of valuations in one pass.

        Each cipher input is stacked along a leading batch axis
        ([B, n_sub, N] planes) and every device op broadcasts over it,
        so each kernel launch covers the whole batch (the key-switch
        kernels' batch grid axis). Program constants (cached encodes:
        the same host object in every valuation) are uploaded once and
        broadcast, not stacked B times. Port of
        executor_jax.JaxProgram.run_batched without the mesh branches."""
        batch = len(host_values_list)
        if batch == 0:
            return []
        device = self.device
        cipher_in = {}
        plain_in = {}
        for idx, v in host_values_list[0].items():
            key = f"t{idx}"
            if isinstance(v, Ciphertext):
                cipher_in[key] = [
                    _to_dev(np.stack([hv[idx].polys[k]
                                      for hv in host_values_list]), device)
                    for k in range(v.size)]
            elif isinstance(v, Plaintext):
                if all(hv[idx] is v for hv in host_values_list):
                    plain_in[key] = self._upload(
                        v, lambda pt: _to_dev(_plain_np(pt), device))
                else:
                    plain_in[key] = _to_dev(np.stack(
                        [_plain_np(hv[idx]) for hv in host_values_list]),
                        device)
        out = self._traced(cipher_in, plain_in)
        host = {name: [c.cpu() for c in planes]
                for name, planes in out.items()}
        return [self._result(host, b) for b in range(batch)]

    def run_pipelined(self, host_values_iter, depth: int = 2):
        """Generator over per-execution outputs, in order, with execution
        k+1 enqueued on the device before execution k's outputs are
        collected.

        PyTorch launches are asynchronous on a CUDA device: each
        execution's kernels are enqueued, then its outputs are copied
        into pinned host memory with non-blocking copies on the same
        stream, and a CUDA event marks their end. While the host builds
        and launches the next execution, the device runs the previous
        one; collecting waits on that execution's event only. `depth`
        bounds the executions in flight (device memory: one set of
        outputs each). Port of executor_jax.JaxProgram.run_pipelined."""
        import collections

        pending = collections.deque()
        on_cuda = self.device.type == "cuda"

        def dispatch(host_values):
            out = self._traced(*self._inputs(host_values))
            if not on_cuda:
                return out, None
            host = {}
            for name, planes in out.items():
                host[name] = []
                for c in planes:
                    h = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                    h.copy_(c, non_blocking=True)
                    host[name].append(h)
            done = torch.cuda.Event()
            done.record()
            return host, done

        def collect(item):
            host, done = item
            if done is not None:
                done.synchronize()
            return self._result(host)

        for hv in host_values_iter:
            pending.append(dispatch(hv))
            if len(pending) > depth:
                yield collect(pending.popleft())
        while pending:
            yield collect(pending.popleft())
