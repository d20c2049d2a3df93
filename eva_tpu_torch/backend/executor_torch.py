"""Whole-graph PyTorch executor: runs a compiled EVA program over limb-plane
tensors on one torch device: int32 tensors carrying the JAX package's
uint32 residues (backend/modmath.py), with int64 index tables.

Port of the single-device part of eva_tpu/backend/executor_jax.py. The
JAX package traces the DAG into one jitted executable per input tree
(JaxProgram._jitted). The port's counterpart is one CUDA graph per input
key (_Captured): on a CUDA device the first execute for a key runs
`_traced` once eagerly on a side stream, which builds every lazy table,
constant and kernel library, then captures it into a torch.cuda.CUDAGraph
over static input tensors; every execute copies its inputs into those
tensors and replays the graph. On the CPU `_traced` runs eagerly.
Every rescale, relinearization and rotation runs the negacyclic NTT
(tables.DeviceLevelOps.ntt/intt: the CUDA kernels on a GPU), and every
modular op the elementwise kernels of csrc/modmath.cu on a GPU (E1
through DeviceLevelOps: one op on one plane, on a rotation sum's or a
ciphertext's planes at once (ew_planes), or the structured key switch's
MAC (mac); E2 its tensor_product; E3 ks.divide_last, every prime and
polynomial of a rescale at once).

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

Big vectors (vec_size > N/2) are sharded across k = vec_size / (N/2)
ciphertexts on a shard axis ([..., k, n_sub, N] planes; crypto/bigvec)
and rotated by _rotate_sharded, as in the JAX package: a roll of the
shard axis and at most two structured key switches.

Host/device split follows the protocol roles: encode/encrypt/decrypt are
host-side numpy; `execute` (server role) is this module, one valuation
at a time (`run`), a batch stacked on a leading axis (`run_batched`), or
a stream with the next execution enqueued before the last one's outputs
are fetched (`run_pipelined`). Raw subgraphs stay host-side.

On a mesh (`run_batched(..., mesh=...)`, eva_tpu_torch.parallel), one
process per device runs the program on its shard, as the JAX package's
shard_map does: its batch slice, its key-switch digit shard with a
modular all-reduce of the partial sums (limb / hlimb axes: _ks_dp), and
its slice of the ring axis with one all-to-all per NTT (seq axis:
_lops, _aperm). On the card every plan runs as a captured CUDA graph,
as the JAX package compiles each sharded program whole: the
single-device program on the local batch through its own graph, the
digit-parallel and seq programs through one graph per (mesh, plan,
input key) with their NCCL collectives inside. On the CPU (gloo) they
run eagerly."""

from __future__ import annotations

import gc
import os
import time
import weakref
from collections import Counter, OrderedDict
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..crypto import keys as K
from ..crypto.bigvec import rotation_plan
from ..crypto.ciphertext import Ciphertext, Plaintext
from ..crypto.context import CKKSContext
from ..ir import ROTATION, Op, Program, Term, Type
from ..passes import rotation_hoist_sources
from ..tracing import span
from . import (ks_cuda, modmath_cuda, ntt_cuda, ntt_shard_cuda,
               resolve_device)
from .modmath import to_host, to_mont, to_mont_rows as _to_mont_rows, upload
# divide_last_planes: re-exported for the tests.
from .ks import (MAX_KEY_PRIMES, divide_last, divide_last_planes,  # noqa: F401
                 ks_epilogue, ks_mac)
from .tables import DeviceLevelOps, level_ops


def _to_dev(arr: np.ndarray, device) -> torch.Tensor:
    """A host table on `device`: signed integer arrays are indices (int64
    tensors); residues (unsigned, < 2^32) go up as int32 tensors of their
    uint32 bit patterns (modmath.upload)."""
    if np.asarray(arr).dtype.kind == "i":
        return torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.int64)).to(device)
    return upload(arr, device)

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
def _ks_dp_tables(ctx, level: int, alpha: int, n_dev: int):
    """Digit-parallel decomposition tables for one (level, alpha),
    padded so the digit axis splits evenly over n_dev digit shards.

    member[j, k] = data-prime index of the k-th member of digit group j
                   (0 for padding slots — their conv rows are zero, so
                   they contribute exact zeros to the modular sum)
    conv_m[j, k, i, 0] = (Qg_j/q_member) mod basis[i], Montgomery form"""
    primes = ctx.primes_at_level(level)
    basis = primes + ctx.key_primes
    groups, _, conv = ctx.ks_tables(level, alpha)
    n_groups = len(groups)
    n_dig = n_groups + (-n_groups % n_dev)
    member = np.zeros((n_dig, alpha), dtype=np.int64)
    conv_m = np.zeros((n_dig, alpha, len(basis), 1), dtype=np.uint32)
    for j, g in enumerate(groups):
        for k, t in enumerate(g):
            member[j, k] = t
            for i, q in enumerate(basis):
                conv_m[j, k, i, 0] = to_mont(
                    np.array([conv[t, i]], dtype=np.uint64), q)[0]
    return member, conv_m


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
    gather along the last axis with a fixed index (the slot permutation
    inside SEAL's apply_galois), held as an int32 table on the device,
    which a captured graph reads in place. On a CUDA device the planes a
    rotation permutes go through one galois_perm launch
    (modmath_cuda.galois_perm); on the CPU, torch.index_select. The JAX
    package's MXU one-hot formulation is a TPU artifact and is not
    ported."""

    def __init__(self, perm: np.ndarray, device):
        perm = np.asarray(perm)
        if perm.ndim != 1 or not np.array_equal(np.sort(perm),
                                                np.arange(perm.shape[0])):
            raise ValueError("DevPerm: the table is not a permutation")
        self.table = torch.from_numpy(perm.astype(np.int32)).to(device)
        self.n = perm.shape[0]

    def __call__(self, arr):
        return self.planes(arr)[0]

    def planes(self, *arrs) -> list:
        """The automorphism of each of 1-4 planes: one launch on the
        card."""
        if self.table.is_cuda:
            return modmath_cuda.galois_perm(arrs, self.table)
        return [torch.index_select(a, -1, self.table) for a in arrs]


def _permute(aperm, *arrs) -> list:
    """The automorphism `aperm` (TorchProgram._aperm) of each of 1-4
    planes: one launch on the card for a DevPerm; a seq mesh's
    applicator (parallel/seq_exec.seq_perm_galois) takes one plane at a
    time."""
    if isinstance(aperm, DevPerm):
        return aperm.planes(*arrs)
    return [aperm(a) for a in arrs]


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

    def shard_window(self, shift: int, lo: int, hi: int):
        """Roll the SHARD axis (big-vector ciphertexts; crypto/bigvec) by
        -shift and keep shards [lo, hi): selects the digit stacks of the
        source shards feeding one intra-rotation group. own/b carry the
        shard axis 3/4 dims from the end; a has an extra digit axis."""
        def f(arr, off):
            ax = arr.dim() - off
            if shift:
                arr = torch.roll(arr, -shift, dims=ax)
            return arr.narrow(ax, lo, hi - lo)
        return StructDigits(
            f(self.own, 3),
            None if self.a is None else f(self.a, 4),
            f(self.b, 4),
            self.n_groups)


class DeviceKeys:
    """Key material lazily converted to device form (Montgomery, int32)
    in the per-level structured layout matching StructDigits. Only the
    (key, level) pairs a program actually uses are uploaded."""

    def __init__(self, ctx: CKKSContext, device):
        # Holds no key set: device_keys's cache entry must not keep one
        # alive.
        self.ctx = ctx
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

    def dp_layout(self, ksk: K.KSwitchKey, level: int, n_dev: int,
                  shard: int, seq=None):
        """(k0, k1) of digit shard `shard` of n_dev: [n_dig / n_dev,
        n_ext, N] Montgomery planes, the digit axis zero-padded to a
        multiple of n_dev (padding digits are zero key rows: they add
        exact zeros to the modular sum), and with seq = (index, count)
        this rank's contiguous slice of the ring axis (evaluation-domain
        planes; parallel/seq_exec). The layout the digit-parallel key
        switch reads (TorchProgram._ks_dp).

        NOT inverse-permuted (unlike layout_rot): the dp non-hoisted
        rotation decomposes the PERMUTED polynomial, and decomposing
        sigma(c1) is not value-identical to permuting the digits of c1
        (the fast-base-extension representative is built from standard,
        non-centered residues), so permuted keys would break bit-parity
        with the single-device path."""
        key = ("dp", id(ksk), level, n_dev, shard, seq)
        if key not in self._cache:
            full0, full1 = self._build_dp(ksk, level, n_dev)
            loc = full0.shape[0] // n_dev
            cols = slice(None)
            if seq is not None:
                nloc = self.ctx.n // seq[1]
                cols = slice(seq[0] * nloc, (seq[0] + 1) * nloc)
            self._cache[key] = (ksk, tuple(
                _to_dev(k[shard * loc:(shard + 1) * loc, :, cols],
                        self.device) for k in (full0, full1)))
        return self._cache[key][1]

    def _build_dp(self, ksk: K.KSwitchKey, level: int, n_dev: int):
        """Host (k0, k1) [n_dig, n_ext, N] of dp_layout, every shard."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        basis = primes + list(ctx.key_primes)
        n_groups, _, _ = _ks_maps(ctx, level, ksk.alpha)
        n_dig = n_groups + (-n_groups % n_dev)
        n_data_all = len(ctx.data_primes)
        row_idx = list(range(len(primes))) + [
            n_data_all + i for i in range(len(ctx.key_primes))]

        def pack(klist):
            k = np.zeros((n_dig, len(basis), ctx.n), dtype=np.uint64)
            for j in range(n_groups):
                k[j] = klist[j][row_idx]
            return np.stack([_to_mont_rows(k[j], basis)
                             for j in range(n_dig)])

        return pack(ksk.k0), pack(ksk.k1)

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


_DEVICE_KEYS_CACHE: Dict[Tuple, DeviceKeys] = {}


def device_keys(ctx: CKKSContext, keys: K.KeySet, device) -> DeviceKeys:
    """The device form of `keys`, built once per key set and device. The
    entry lives as long as the key set: dropped with it (so a server that
    serves many key sets frees their device layouts), and so never found
    by a later key set that reuses its id."""
    device = resolve_device(device)
    key = (id(keys), device)
    hit = _DEVICE_KEYS_CACHE.get(key)
    if hit is None:
        hit = _DEVICE_KEYS_CACHE[key] = DeviceKeys(ctx, device)
        weakref.finalize(keys, _DEVICE_KEYS_CACHE.pop, key, None)
    return hit


class TorchProgram:
    """Runs a compiled EVA program on one torch device: through one
    captured CUDA graph per input key on a CUDA device, eagerly on the
    CPU."""

    # Private switch: False runs `_traced` eagerly on a CUDA device too,
    # so that chip_smoke.py, tools/cuda_ab.py and the GPU tests can hold
    # captured runs against eager ones in one process.
    _capture = True
    # Private switch, off by default: a plan ("dp", "seq" or "dp+seq")
    # that a mesh of ONE rank takes instead of "batch", at one digit shard
    # and one ring slice, its collectives over the mesh's one-rank groups
    # (digits over "limb", the ring over "batch"; see _sharded). It lets
    # chip_smoke.py and the tests run, capture and time the mesh programs
    # on one card; the plan a user's mesh takes does not read it.
    _force_plan = None
    # Digit-parallel / sequence-parallel contexts, installed while a
    # mesh program runs (_body_dp, _body_seq); class defaults so that
    # shims built with __new__ take the single-device path.
    _dp = None
    _seq = None

    def __init__(self, program: Program, ctx: CKKSContext, keys: K.KeySet,
                 plan, types, order: List[Term], device):
        self.program = program
        self.ctx = ctx
        self.keys = keys
        self.plan = plan
        self.types = types
        self.order = order
        self.device = resolve_device(device)
        # Shards per logical vector (big-vector extension, crypto/bigvec):
        # ciphertext planes carry a leading shard axis when k > 1.
        self.k = max(1, program.vec_size // (ctx.n // 2))
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
        # (the host planner reads the same variable); sharded big vectors
        # never defer.
        self._rotsum_on = (self.k == 1 and
                           not os.environ.get("EVA_TPU_NO_ROTSUM_FUSION"))
        # Device-upload cache: program constants (encode-cache Plaintexts)
        # and re-executed input Ciphertexts are uploaded once, not per
        # run(). Keyed by object id; values pin the host object so ids
        # cannot be reused while an entry is alive. Bounded FIFO so
        # arbitrary fresh ciphertexts cannot grow it.
        self._upload_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._upload_cache_cap = 256
        self._consts: Dict[Tuple, torch.Tensor] = {}
        # Program constants: the Plaintexts of input-free Encodes, which
        # the host planner's encode cache hands to every request as the
        # same object. A captured graph reads them in place.
        free: Dict[int, bool] = {}
        for t in order:
            free[t.index] = t.op != Op.Input and all(
                free[o.index] for o in t.operands)
        self._const_terms = {t.index for t in order
                             if t.op == Op.Encode and free[t.index]}
        # One captured graph per input key (see _capture_key), the
        # counterpart of JaxProgram._jit_cache.
        self._captured: Dict[Tuple, _Captured] = {}
        # Checked mesh plans by mesh and input shapes (_sharded), the
        # counterpart of JaxProgram._sharded_cache: (mesh, plan name,
        # run, seq group).
        self._sharded_cache: Dict[Tuple, tuple] = {}

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

    # -- digit-parallel and sequence-parallel (mesh) execution ---------------

    def _ks_sites(self):
        """(name, level, alpha) for every key switch the program
        performs; mirrors the _traced dispatch, so that the digit shards'
        tables and keys can be made before a mesh program runs."""
        ctx = self.ctx
        sites = set()
        for term in self.order:
            op = term.op
            if self.types[term] == Type.Raw:
                continue
            idx = term.index
            args = term.operands
            if op in (Op.RotateLeftConst, Op.RotateRightConst):
                steps = term.get_attr(ROTATION)
                if op == Op.RotateRightConst:
                    steps = -steps
                if steps % (self.k * (ctx.n // 2)) == 0:
                    continue
                g = ctx.galois_elt(steps)
                sites.add((f"galois_{g}", self.plan[idx].level,
                           self.keys.galois[g].alpha))
            elif op == Op.Relinearize:
                if idx in self._fused_relins:
                    continue  # key switch happens at the Rescale site
                if args[0].index in self._fused_rescales:
                    # _rescale_relin: KS at the post-rescale level
                    lvl = self.plan[args[0].operands[0].index].level + 1
                else:
                    lvl = self.plan[idx].level
                sites.add(("relin", lvl, self.keys.relin.alpha))
            elif op == Op.Rescale and args[0].index in self._fused_relins:
                # _relin_rescale: KS at the pre-rescale level
                lvl = self.plan[args[0].operands[0].index].level
                sites.add(("relin", lvl, self.keys.relin.alpha))
        return sorted(sites)

    def _ks_dp_digits(self, coeffs, level: int, alpha: int):
        """This rank's gadget digits (FBE + extended-basis NTT) for the
        digit shard it owns. coeffs: [..., n_cur, N] coefficient domain,
        the same on every rank of the digit axis. Returns
        [..., loc, n_ext, N] NTT-domain digit planes."""
        ctx = self.ctx
        dev = self._ops_at(level)
        ext = self._ext_ops_at(level)
        n_ext = len(ctx.primes_at_level(level)) + len(ctx.key_primes)
        member, conv = self._dp["tables"][(level, alpha)]
        _, inv_mont, _ = _ks_dev_tables(ctx, level, alpha)
        y = dev.mul_mont(coeffs, self._const(("ks_inv", level, alpha),
                                             inv_mont))
        loc = member.shape[0]
        nloc = y.shape[-1]  # = ctx.n, or the local shard on a seq mesh
        ym = torch.index_select(y, -2, member.reshape(-1))
        # [..., loc, alpha, 1, nloc] against conv [loc, alpha, n_ext, 1]:
        # the op broadcasts the member rows over the extended basis.
        ym = ym.reshape(y.shape[:-2] + (loc, alpha, 1, nloc))
        prod = ext.mul_mont(ym, conv)
        acc = prod[..., 0, :, :]
        for k in range(1, alpha):
            acc = ext.add(acc, prod[..., k, :, :])
        return ext.ntt(acc)

    def _ks_dp(self, coeffs, level: int, site: str, alpha: int,
               perm=None, out_ntt: bool = True, digits=None,
               defer: bool = False):
        """Digit-parallel key switch: each rank runs the FBE + NTT +
        key-MAC pipeline for ITS digit shard, the partial inner products
        are combined by a modular all-reduce over the digit axis
        (parallel/ks_shard), and the P-division tail runs replicated.
        Bit-identical to the single-device path: modular sums are exact
        and order-independent. `perm` permutes the local digit shard
        (hoisted rotations: the shard axis is the digit axis, so the
        N-axis permutation is rank-local, or a seq-axis exchange)."""
        from ..parallel.ks_shard import (_modular_all_reduce,
                                         hierarchical_modular_all_reduce)
        ctx = self.ctx
        dp = self._dp
        ext = self._ext_ops_at(level)
        if digits is None:
            digits = self._ks_dp_digits(coeffs, level, alpha)
        if perm is not None:
            digits = perm(digits)
        k0, k1 = dp["keys"][f"{site}@L{level}"]     # local [loc, n_ext, N]
        t0 = ext.mul_mont(digits, k0)
        t1 = ext.mul_mont(digits, k1)

        def dig_sum(t):
            s = t[..., 0, :, :]
            for j in range(1, t.shape[-3]):
                s = ext.add(s, t[..., j, :, :])
            return s

        acc0, acc1 = dig_sum(t0), dig_sum(t1)
        if dp["dcn_group"] is not None:
            # Digits sharded over ("hlimb" x "limb"): intra-node
            # reduce-scatter, 1/limb-sized cross-node all-reduce,
            # intra-node gather (bit-identical to a flat all-reduce).
            acc0, acc1 = (hierarchical_modular_all_reduce(
                a, ext, dp["group"], dp["dcn_group"]) for a in (acc0, acc1))
        else:
            acc0, acc1 = (_modular_all_reduce(a, ext, dp["group"])
                          for a in (acc0, acc1))
        if defer:
            # Rotation-sum fusion: the all-reduced accumulators are the
            # same on every rank of the digit axis, like the tail's
            # inputs; _ks_div2 later applies the identical division.
            return acc0, acc1

        primes = ctx.primes_at_level(level)
        d = self._divide([ext.intt(acc0), ext.intt(acc1)],
                         primes + list(ctx.key_primes), len(ctx.key_primes))
        # _lops, not level_ops: on a limb x seq mesh the output NTT must
        # route through the seq-sharded transform.
        return tuple(self._lops(primes).ntt(x) for x in d) if out_ntt \
            else tuple(d)

    def _dp_materialize(self, n_dig_shards: int, shard: int, seq=None):
        """(tables, keys) of digit shard `shard` for every key-switch
        site: {(level, alpha): (member, conv)} and {"site@Llevel": (k0,
        k1)}, on this rank's device; with a seq context the keys are
        this rank's slice of the ring axis."""
        seq_ix = None
        if seq is not None:
            seq_ix = (dist.get_rank(seq["group"]), seq["n_dev"])
        dp_tabs, dp_keys = {}, {}
        for name, level, alpha in self._ks_sites():
            if (level, alpha) not in dp_tabs:
                member, conv = _ks_dp_tables(self.ctx, level, alpha,
                                             n_dig_shards)
                loc = member.shape[0] // n_dig_shards
                mine = slice(shard * loc, (shard + 1) * loc)
                dp_tabs[(level, alpha)] = (
                    _to_dev(member[mine], self.device),
                    _to_dev(conv[mine], self.device))
            ksk = (self.keys.relin if name == "relin"
                   else self.keys.galois[int(name.split("_")[1])])
            dp_keys[f"{name}@L{level}"] = self.dkeys.dp_layout(
                ksk, level, n_dig_shards, shard, seq_ix)
        return dp_tabs, dp_keys

    def _body_dp(self, cipher_in, plain_in, dp_tabs, dp_keys, group,
                 seq=None, dcn_group=None):
        """Run the program with the digit-parallel key-switch context
        installed: dp_tabs/dp_keys are this rank's digit shard, `group`
        the digit axis's process group. `seq` (a seq context, see
        _sharded) installs the sequence-parallel context as well: the
        digit partial sums all-reduce over "limb" while each digit's
        NTTs all-to-all over "seq". `dcn_group` adds a node-spanning
        second digit axis whose accumulation runs hierarchically."""
        self._dp = {"group": group, "tables": dp_tabs, "keys": dp_keys,
                    "dcn_group": dcn_group}
        self._seq = seq
        try:
            return self._traced(cipher_in, plain_in)
        finally:
            self._dp = None
            self._seq = None

    def _body_seq(self, cipher_in, plain_in, seq):
        """Run the program with the sequence-parallel (sharded ring
        axis) context installed; inputs are rank-local evaluation-domain
        planes [..., n_sub, N/n_dev]."""
        self._seq = seq
        try:
            return self._traced(cipher_in, plain_in)
        finally:
            self._seq = None

    def _sharded(self, mesh, cipher, plain, consts):
        """The checked plan of this program on `mesh` for one input key
        (the counterpart of JaxProgram._sharded_jit), cached by mesh,
        the private _force_plan and input shapes: (mesh, plan name, run,
        seq group). run is a function of the rank-local device inputs
        for the digit-parallel and seq programs (see _body_dp,
        _body_seq), None for the single-device program on the local
        batch; the seq group is the process group of the ring axis, or
        None. Every rank calls it with the same shapes.

        With a "limb" axis > 1 (and "hlimb"), the gadget digits of every
        key switch are sharded over the axis and accumulated with a
        modular all-reduce; dyadic ops run replicated across it. With a
        "seq" axis the ring axis of every polynomial is sharded. On a
        one-rank mesh, _force_plan selects these programs at one shard:
        the digit all-reduce over the "limb" axis's group, the ring
        all-to-alls over the "batch" axis's."""
        from ..parallel.seq_exec import seq_compatible
        from ..parallel.sharding import (axis_group, axis_index,
                                         axis_size, check_ici_axes,
                                         mesh_device, node_ids)
        key = ((id(mesh), self._force_plan)
               + self._capture_key(cipher, plain, consts)[:2])
        hit = self._sharded_cache.get(key)
        if hit is not None and hit[0] is mesh:
            return hit
        if mesh_device(mesh) != self.device:
            raise ValueError(f"mesh device {mesh_device(mesh)} is not the "
                             f"program's device {self.device}")
        # Also guards hand-built meshes: collective-bearing axes must
        # not span nodes.
        check_ici_axes(node_ids(mesh), list(mesh.mesh_dim_names or ()))
        forced = self._forced(mesh)
        n_dp = axis_size(mesh, "limb")
        n_seq = axis_size(mesh, "seq")
        n_hl = axis_size(mesh, "hlimb")  # node-spanning digit axis
        n_dig_shards = n_dp * n_hl
        use_dp = ((n_dig_shards > 1 or "dp" in forced) and self.k == 1
                  and (n_dp & (n_dp - 1)) == 0
                  and (n_hl & (n_hl - 1)) == 0
                  and bool(self._ks_sites()))
        if "dp" in forced and not use_dp:
            raise ValueError(
                "forced plan dp: the program has no key switch to shard, "
                "or is a sharded big-vector program")
        if n_hl > 1:
            if n_seq > 1:
                raise ValueError(
                    'mesh axes "hlimb" and "seq" do not compose')
            if not use_dp:
                raise ValueError(
                    'mesh axis "hlimb" > 1 needs power-of-two sizes '
                    "and a program with key switches")
        seq = None
        if n_seq > 1 or "seq" in forced:
            if self.k != 1:
                raise ValueError(
                    "seq mesh axis: sharded big-vector programs "
                    "(vec_size > N/2) are not supported")
            if n_dp > 1 and not use_dp:
                raise ValueError(
                    "limb mesh axis > 1 needs a power-of-two size "
                    "and a program with key switches")
            if not seq_compatible(self.ctx.n, n_seq):
                raise ValueError(
                    f"ring size {self.ctx.n} cannot shard over "
                    f"{n_seq} devices (seq must divide both 128 and "
                    f"N/128 = {self.ctx.n // 128})")
            seq = {"group": axis_group(mesh, "seq" if n_seq > 1
                                       else "batch"),
                   "n_dev": n_seq, "perms": {}}
        run = None
        if use_dp:
            shard = axis_index(mesh, "hlimb") * n_dp + axis_index(mesh, "limb")
            dp_tabs, dp_keys = self._dp_materialize(n_dig_shards, shard, seq)
            group = axis_group(mesh, "limb")
            dcn = axis_group(mesh, "hlimb") if n_hl > 1 else None
            run = lambda c, p: self._body_dp(c, p, dp_tabs, dp_keys, group,
                                             seq=seq, dcn_group=dcn)
        elif seq is not None:
            run = lambda c, p: self._body_seq(c, p, seq)
        # The plan's name: which sharded program runs ("batch", "dp",
        # "dp+hlimb", "seq", "dp+seq").
        plan = "+".join([p for p, on in (("dp", use_dp), ("hlimb", n_hl > 1),
                                         ("seq", seq is not None)) if on])
        hit = self._sharded_cache[key] = (
            mesh, plan or "batch", run, None if seq is None else seq["group"])
        return hit

    def _forced(self, mesh) -> set:
        """The plan parts ({"dp"}, {"seq"} or both) that the private
        switch _force_plan forces on `mesh`; empty when it is off. A
        forced plan takes a make_device_mesh mesh of one rank."""
        if self._force_plan is None:
            return set()
        parts = set(self._force_plan.split("+"))
        if (not parts <= {"dp", "seq"} or mesh.size() != 1
                or not {"batch", "limb"} <= set(mesh.mesh_dim_names or ())):
            raise ValueError(
                f"forced plan {self._force_plan!r}: choose dp, seq or "
                f"dp+seq, on a one-rank make_device_mesh mesh")
        return parts

    def release_mesh(self, mesh) -> None:
        """Drop what this program holds for `mesh`: its checked plans
        and the captured graphs of its mesh programs. NCCL's
        communicator destroy (torch.distributed.destroy_process_group)
        waits until every CUDA graph that holds its collectives is
        freed, so a caller releases each mesh before destroying the
        process groups."""
        for key in [k for k, e in self._captured.items() if e.mesh is mesh]:
            del self._captured[key]
        for key in [k for k, v in self._sharded_cache.items()
                    if v[0] is mesh]:
            del self._sharded_cache[key]
        gc.collect()

    # -- device op helpers ---------------------------------------------------

    def _lops(self, primes) -> DeviceLevelOps:
        """level_ops, sequence-parallel aware: with the seq context
        installed (ring axis N sharded over a mesh axis), transforms
        route through the all-to-all ShardedNTT; elementwise ops are
        unchanged (per-row constants broadcast over the local N/D)."""
        if self._seq is not None:
            from ..parallel.seq_exec import get_seq_ops
            return get_seq_ops(tuple(primes), self.ctx.n,
                               self._seq["group"], self.device)
        return level_ops(list(primes), self.ctx.n, self.device)

    def _aperm(self, g: int):
        """Galois automorphism applicator; in seq mode the N-permutation
        is lifted over the sharded ring axis as one shard exchange plus
        a local lane gather (seq_perm_galois)."""
        base = dev_perm(self.ctx, g, self.device)
        if self._seq is None:
            return base
        perms = self._seq["perms"]
        if g not in perms:
            from ..parallel.seq_exec import seq_perm_galois
            perms[g] = seq_perm_galois(self.ctx, g, self._seq["group"],
                                       base, self.device)
        return perms[g]

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
            # merged-twist NTT requires reduced input. [..., n_cur, 1, N]
            # broadcasts over the n_ext rows of the extended basis.
            acc = ext.reduce(coeffs[..., :, None, :])
        else:
            _, _, conv_mont = _ks_dev_tables(ctx, level, alpha)
            y, _ = self._ks_fbe_y(coeffs, level, alpha)
            prod = ext.mul_mont(y[..., :, None, :],
                                self._const(("ks_conv", level, alpha),
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
        accumulators, both key halves in one E1 MAC launch (the sums over
        digits stay in registers: no tree_sum, no concatenation).
        Hoisted rotations pass an INVERSE-permuted key layout
        (DeviceKeys.layout_rot) and apply the automorphism to the two
        accumulators (or outputs)."""
        if self._seq is not None:
            # Key planes are whole (evaluation domain = contiguous flat
            # layout); each rank MACs its own slice.
            from ..parallel.seq_exec import seq_slice
            group = self._seq["group"]
            layout = tuple(
                tuple(None if k is None else seq_slice(k, group)
                      for k in half)
                for half in layout)
        return self._ext_ops_at(level).mac(digits.own, digits.a, digits.b,
                                           *layout)

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

        if self._fused_ks_ok() and self._dp is None:
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

        d0, d1 = self._divide([ext.intt(acc0), ext.intt(acc1)],
                              primes + list(self.ctx.key_primes),
                              len(self.ctx.key_primes))
        if coeff_out:
            return d0, d1
        out = self._lops(primes)
        return out.ntt(d0), out.ntt(d1)

    def _fused_ks_ok(self) -> bool:
        """Use the fused key switch (ks.ks_mac / ks.ks_epilogue) unless
        EVA_TPU_NO_FUSED_KS is set. The JAX package's 12 MB VMEM budget
        does not carry over: each kernel block holds one row in shared
        memory (<= 128 KB at N=32768) whatever n_ext is, so the limits
        are the kernels' ring sizes and key-prime count."""
        if os.environ.get("EVA_TPU_NO_FUSED_KS"):
            return False
        if self._seq is not None:
            return False  # the kernels see only the local N shard
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
        if c1 is None:
            return [self._ops_at(level).add(c0, d0), d1]
        return self._ops_at(level).ew_planes("add", [(c0, d0), (c1, d1)])

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
        hoisted = hoist is not None and src_key is not None
        KEY_SWITCHES["hoisted_rotation" if hoisted
                     else "single_rotation"] += 1
        if self._dp is not None:
            site = f"galois_{g}"
            if hoisted:
                digits = hoist.get(src_key)
                if digits is None:
                    digits = self._ks_dp_digits(dev.intt(polys[1]), level,
                                                alpha)
                    hoist[src_key] = digits
                c0 = aperm(polys[0])
                acc0, acc1 = self._ks_dp(None, level, site, alpha,
                                         perm=aperm, digits=digits,
                                         defer=True)
            else:
                c0, c1 = _permute(aperm, polys[0], polys[1])
                acc0, acc1 = self._ks_dp(dev.intt(c1), level, site, alpha,
                                         defer=True)
            return ("rotsum", level, c0, None, acc0, acc1)
        if hoisted:
            digits = hoist.get(src_key)
            if digits is None:
                digits = self._ks_digits(polys[1], level)
                hoist[src_key] = digits
            layout = self.dkeys.layout_rot(self.keys.galois[g], level, g)
            acc0, acc1 = self._ks_mac(digits, level, layout)
            # sigma(c0) with the accumulators: one launch for the three.
            c0, acc0, acc1 = _permute(aperm, polys[0], acc0, acc1)
            return ("rotsum", level, c0, None, acc0, acc1)
        c0, c1 = _permute(aperm, polys[0], polys[1])
        if self._fused_ks_ok():
            acc0, acc1 = self._ks_fused_mac(dev.intt(c1), level,
                                            self.keys.galois[g], poly_ntt=c1)
        else:
            digits = self._ks_digits(c1, level, alpha)
            acc0, acc1 = self._ks_mac(
                digits, level, self.dkeys.layout(self.keys.galois[g], level))
        return ("rotsum", level, c0, None, acc0, acc1)

    def _key_switch(self, poly, level: int, ksk, site: str = "relin"):
        if self._dp is not None:
            dev = self._ops_at(level)
            return self._ks_dp(dev.intt(poly), level, site, ksk.alpha)
        if self._fused_ks_ok():
            dev = self._ops_at(level)
            return self._ks_fused_coeffs(dev.intt(poly), level, ksk,
                                         out_ntt=True, poly_ntt=poly)
        return self._ks_apply(self._ks_digits(poly, level, ksk.alpha), level,
                              self.dkeys.layout(ksk, level))

    def _divide(self, xs, primes: List[int], k: int, addends=None):
        """Divide-and-round the coefficient planes xs (1-3 polynomials
        over `primes`, plus `addends`) by their last k primes: one E3
        launch on the card (see ks.divide_last). Elementwise along the
        ring axis, so a seq rank's local slice takes the same tables."""
        return divide_last(xs, primes, k, level_ops(
            primes[:-1], self.ctx.n, self.device), addends)

    def _rescale(self, polys, level: int):
        primes = self.ctx.primes_at_level(level)
        k = len(self.ctx.entries_at_level(level)[-1].primes)
        dev = self._ops_at(level)
        out = self._lops(primes[:len(primes) - k])
        return [out.ntt(x) for x in
                self._divide([dev.intt(c) for c in polys], primes, k)]

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
                    vals[idx] = dev.ew_planes(
                        "neg", [(c,) for c in self._fin_at(vals,
                                                           args[0].index)])
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

    def _zero(self, ops: DeviceLevelOps) -> torch.Tensor:
        """A [1, 1] zero: sub(zero, x) is neg(x) (0 - x mod q is q - x,
        or 0 for x = 0), so a negation joins a subtraction's launch."""
        return ops.const(("zero",), lambda: np.zeros((1, 1), np.uint32))

    def _rotsum_add(self, a, b, dev: DeviceLevelOps, sub: bool = False):
        """Merge/fold for Add/Sub when at least one operand is a deferred
        rotation sum. Returns the merged rotsum, or None when the
        combination can't stay deferred (caller finalizes). Modular adds
        are exact and order-independent, so merged results are
        bit-independent of association order; sub merging is sound the
        same way (round(-x/P) = -round(x/P): odd centered rounding). The
        components' adds (or subs) go in one several-planes launch."""
        op = "sub" if sub else "add"
        if self._is_rotsum(a) and self._is_rotsum(b):
            _, level, c0a, c1a, acc0a, acc1a = a
            _, level_b, c0b, c1b, acc0b, acc1b = b
            if level != level_b:  # pragma: no cover - checker prevents
                return None
            ext = self._ext_ops_at(level)
            planes = [(c0a, c0b), (acc0a, acc0b), (acc1a, acc1b)]
            if c1b is None or (c1a is None and not sub):
                c1 = c1a if c1b is None else c1b  # nothing to compute
            else:
                planes.append((self._zero(ext) if c1a is None else c1a, c1b))
            out = ext.ew_planes(op, planes)
            return ("rotsum", level, out[0], out[3] if len(out) > 3 else c1,
                    out[1], out[2])
        if self._is_rotsum(b):
            if sub:  # a - rs: negate every rs component, then add
                b = self._rotsum_neg(b, dev)
                sub = False
                op = "add"
            a, b = b, a
        _, level, c0, c1, acc0, acc1 = a
        if isinstance(b, tuple):  # ("plain", pt): folds into c0 only
            pt = b[1]
            if pt.shape[-2] != c0.shape[-2]:  # extended-basis rows present
                pt = pt[..., :c0.shape[-2], :]
            f = dev.sub if sub else dev.add
            return ("rotsum", level, f(c0, pt), c1, acc0, acc1)
        if isinstance(b, list) and len(b) == 2:
            if c1 is None and not sub:
                return ("rotsum", level, dev.add(c0, b[0]), b[1], acc0, acc1)
            c0, c1 = dev.ew_planes(op, [
                (c0, b[0]), (self._zero(dev) if c1 is None else c1, b[1])])
            return ("rotsum", level, c0, c1, acc0, acc1)
        return None  # size-3 ciphertext: finalize and add normally

    def _rotsum_mul(self, rs, pt):
        """Baby-step fusion: multiply a deferred rotation sum by a
        plaintext whose upload carries extended-basis rows (shape
        n_cur + n_key). The multiply distributes over the pre-division
        accumulators, so rot(x,s)*w products keep merging through Adds
        and the whole inner sum pays ONE P-division. One several-planes
        launch: c0 and c1 on the data primes, acc0 and acc1 on the
        extended basis (the data primes are its first rows)."""
        _, level, c0, c1, acc0, acc1 = rs
        n_cur = len(self.ctx.primes_at_level(level))
        ptq = pt[..., :n_cur, :]
        cs = [c0] + ([] if c1 is None else [c1])
        out = self._ext_ops_at(level).ew_planes(
            "mul", [(c, ptq) for c in cs] + [(acc0, pt), (acc1, pt)])
        return ("rotsum", level, out[0], None if c1 is None else out[1],
                out[-2], out[-1])

    def _rotsum_neg(self, rs, dev: DeviceLevelOps):
        """Negate a deferred rotation sum without finalizing — EXACTLY
        equal to negate-after-finalize (odd centered rounding); one
        several-planes launch."""
        _, level, c0, c1, acc0, acc1 = rs
        cs = [c0] + ([] if c1 is None else [c1])
        out = self._ext_ops_at(level).ew_planes(
            "neg", [(c,) for c in cs + [acc0, acc1]])
        return ("rotsum", level, out[0], None if c1 is None else out[1],
                out[-2], out[-1])

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
            # The components in one several-planes launch; a component
            # of b alone is copied (Add) or subtracted from zero (Sub).
            out = list(a) + list(b[len(a):])
            slots = [i for i in range(len(out))
                     if i < len(b) and (i < len(a) or op == Op.Sub)]
            planes = [(a[i] if i < len(a) else self._zero(dev), b[i])
                      for i in slots]
            for i, c in zip(slots, dev.ew_planes(
                    "add" if op == Op.Add else "sub", planes)):
                out[i] = c
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
        return dev.ew_planes("mul", [(c, pt) for c in a])

    def _relin(self, polys, level: int, dev: DeviceLevelOps):
        if len(polys) == 2:
            return list(polys)
        KEY_SWITCHES["relin"] += 1
        d0, d1 = self._key_switch(polys[2], level, self.keys.relin)
        return dev.ew_planes("add", [(polys[0], d0), (polys[1], d1)])

    def _relin_rescale(self, polys, level: int):
        """Fused Relinearize -> Rescale (eager-relin adjacency): key-switch
        output stays in the coefficient domain and goes into the rescale
        division as its addend (added to the iNTT'd c0/c1 in the same E3
        launch), then one NTT at the new level."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        k = len(ctx.entries_at_level(level)[-1].primes)
        dev = self._ops_at(level)
        dev_new = self._lops(primes[:len(primes) - k])
        coeffs = [dev.intt(polys[0]), dev.intt(polys[1])]
        addends = None
        if len(polys) == 3:
            KEY_SWITCHES["relin"] += 1
            if self._dp is not None:
                addends = self._ks_dp(dev.intt(polys[2]), level, "relin",
                                      self.keys.relin.alpha, out_ntt=False)
            elif self._fused_ks_ok():
                addends = self._ks_fused_coeffs(
                    dev.intt(polys[2]), level, self.keys.relin,
                    out_ntt=False, poly_ntt=polys[2])
            else:
                digits = self._ks_digits(polys[2], level,
                                         self.keys.relin.alpha)
                addends = self._ks_apply(
                    digits, level, self.dkeys.layout(self.keys.relin, level),
                    coeff_out=True)
        return [dev_new.ntt(x)
                for x in self._divide(coeffs, primes, k, addends)]

    def _rescale_relin(self, polys, level: int):
        """Fused Rescale -> Relinearize: coefficient-domain between steps,
        rescaled c2 feeds digit decomposition directly, correction added
        before the single final NTT (bit-identical to the unfused pair)."""
        ctx = self.ctx
        primes = ctx.primes_at_level(level)
        k = len(ctx.entries_at_level(level)[-1].primes)
        new_level = level + 1
        dev_new = self._lops(primes[:len(primes) - k])
        dev = self._ops_at(level)
        coeffs = self._divide([dev.intt(c) for c in polys], primes, k)
        if len(polys) == 2:
            return [dev_new.ntt(c) for c in coeffs]
        KEY_SWITCHES["relin"] += 1
        if self._dp is not None:
            d0, d1 = self._ks_dp(coeffs[2], new_level, "relin",
                                 self.keys.relin.alpha, out_ntt=False)
        elif self._fused_ks_ok():
            d0, d1 = self._ks_fused_coeffs(coeffs[2], new_level,
                                           self.keys.relin, out_ntt=False)
        else:
            digits = self._ks_digits_from_coeffs(coeffs[2], new_level,
                                                 self.keys.relin.alpha)
            d0, d1 = self._ks_apply(
                digits, new_level,
                self.dkeys.layout(self.keys.relin, new_level),
                coeff_out=True)
        return [dev_new.ntt(c) for c in dev_new.ew_planes(
            "add", [(coeffs[0], d0), (coeffs[1], d1)])]

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
        if steps % (self.k * (ctx.n // 2)) == 0:
            return list(polys)
        if self.k > 1:
            return self._rotate_sharded(polys, steps, level, dev, hoist,
                                        src_key)
        g = ctx.galois_elt(steps)
        aperm = self._aperm(g)
        hoisted = hoist is not None and src_key is not None
        KEY_SWITCHES["hoisted_rotation" if hoisted
                     else "single_rotation"] += 1
        if self._dp is not None:
            site = f"galois_{g}"
            alpha = self.keys.galois[g].alpha
            if hoisted:
                digits = hoist.get(src_key)
                if digits is None:
                    digits = self._ks_dp_digits(dev.intt(polys[1]), level,
                                                alpha)
                    hoist[src_key] = digits
                c0 = aperm(polys[0])
                d0, d1 = self._ks_dp(None, level, site, alpha, perm=aperm,
                                     digits=digits)
            else:
                c0, c1 = _permute(aperm, polys[0], polys[1])
                d0, d1 = self._ks_dp(dev.intt(c1), level, site, alpha)
            return [dev.add(c0, d0), d1]
        if hoisted:
            digits = hoist.get(src_key)
            if digits is None:
                digits = self._ks_digits(polys[1], level)
                hoist[src_key] = digits
            layout = self.dkeys.layout_rot(self.keys.galois[g], level, g)
            d0, d1 = self._ks_apply(digits, level, layout)
            return _permute(aperm, dev.add(polys[0], d0), d1)
        c0, c1 = _permute(aperm, polys[0], polys[1])
        if self._fused_ks_ok():
            d0, d1 = self._ks_fused_coeffs(dev.intt(c1), level,
                                           self.keys.galois[g], out_ntt=True,
                                           poly_ntt=c1)
        else:
            digits = self._ks_digits(c1, level, self.keys.galois[g].alpha)
            d0, d1 = self._ks_apply(
                digits, level, self.dkeys.layout(self.keys.galois[g], level))
        return [dev.add(c0, d0), d1]

    def _rotate_sharded(self, polys, steps: int, level: int,
                        dev: DeviceLevelOps, hoist=None, src_key=None):
        """Rotation of a sharded big-vector ciphertext (strided layout,
        crypto/bigvec): roll the shard axis by c, then key-switch the
        first k-c shards with Galois step `lo` and the rest with `hi` —
        mask-free and exact, at most two keys per logical rotation.
        Hoisted sources share one digit decomposition of the full shard
        stack; the rolled digit windows feed both groups. The key
        switches are structured (digits, MAC, then the P-division of
        _ks_div2), as in the JAX package."""
        ctx = self.ctx
        k = self.k
        c, lo, hi = rotation_plan(steps, k, ctx.n // 2)
        ax = polys[0].dim() - 3  # shard axis of [..., k, n_sub, N] planes
        p0, p1 = ((torch.roll(p, -c, dims=ax) if c else p)
                  for p in polys[:2])
        groups = [(0, k - c, lo)] + ([(k - c, k, hi)] if c else [])

        digits_full = None
        if hoist is not None and src_key is not None:
            digits_full = hoist.get(src_key)
            if digits_full is None:
                digits_full = self._ks_digits(polys[1], level)
                hoist[src_key] = digits_full

        out0, out1 = [], []
        for g_lo, g_hi, amt in groups:
            s0 = p0.narrow(ax, g_lo, g_hi - g_lo)
            s1 = p1.narrow(ax, g_lo, g_hi - g_lo)
            if amt == 0:
                out0.append(s0)
                out1.append(s1)
                continue
            g = ctx.galois_elt(amt)
            aperm = self._aperm(g)
            ksk = self.keys.galois[g]
            KEY_SWITCHES["single_rotation" if digits_full is None
                         else "hoisted_rotation"] += 1
            if digits_full is not None:
                # Permute-after: MAC the shared digits against the
                # inverse-permuted key, automorph only the two outputs.
                dg = digits_full.shard_window(c, g_lo, g_hi)
                d0, d1 = self._ks_apply(
                    dg, level, self.dkeys.layout_rot(ksk, level, g))
                r0, r1 = _permute(aperm, dev.add(s0, d0), d1)
                out0.append(r0)
                out1.append(r1)
                continue
            r0, r1 = _permute(aperm, s0, s1)
            d0, d1 = self._ks_apply(
                self._ks_digits(r1, level, ksk.alpha), level,
                self.dkeys.layout(ksk, level))
            out0.append(dev.add(r0, d0))
            out1.append(d1)
        if len(out0) == 1:
            return [out0[0], out1[0]]
        return [torch.cat(out0, dim=ax), torch.cat(out1, dim=ax)]

    # -- run -----------------------------------------------------------------

    def _captures(self) -> bool:
        """Execute through captured CUDA graphs (a CUDA device, unless
        the private switch _capture is off)."""
        return self._capture and self.device.type == "cuda"

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
                plain_in[f"t{idx}"] = self._upload_plain(v)
        return cipher_in, plain_in

    def _upload_plain(self, pt: Plaintext) -> torch.Tensor:
        return self._upload(pt, lambda p: _to_dev(_plain_np(p), self.device))

    def _split(self, host_values_list, batched: bool, shared=None):
        """Valuations as host arrays: (cipher {key: [planes]}, plain
        {key: planes}, consts {key: Plaintext}). Batched, every input is
        stacked on a leading axis, except a Plaintext that is the same
        object in every valuation (or, given `shared`, whose term index
        is in it: the same in every valuation of a larger list), which
        serves them all unstacked. consts holds the program constants
        (input-free Encodes, the same object in every valuation): they
        are uploaded once and read in place."""
        first = host_values_list[0]
        cipher, plain, consts = {}, {}, {}
        for idx, v in first.items():
            key = f"t{idx}"
            if isinstance(v, Ciphertext):
                cipher[key] = [
                    np.stack([hv[idx].polys[k] for hv in host_values_list])
                    if batched else v.polys[k] for k in range(v.size)]
            elif isinstance(v, Plaintext):
                if (idx in shared if shared is not None else
                        all(hv[idx] is v for hv in host_values_list)):
                    if idx in self._const_terms:
                        consts[key] = v
                    else:
                        plain[key] = _plain_np(v)
                else:
                    plain[key] = np.stack(
                        [_plain_np(hv[idx]) for hv in host_values_list])
        return cipher, plain, consts

    def _capture_key(self, cipher, plain, consts) -> Tuple:
        """The captured graph's key, as JaxProgram._jitted keys its
        cache: input names, plane counts and shapes (the batch size is
        part of the shape); plus the identity of each constant's host
        object, whose device copy the graph reads in place, and the key
        switch that EVA_TPU_NO_FUSED_KS selects when `_traced` runs."""
        return (
            tuple(sorted((k, len(v), tuple(v[0].shape))
                         for k, v in cipher.items())),
            tuple(sorted((k, tuple(v.shape)) for k, v in plain.items())),
            tuple(sorted((k, id(pt)) for k, pt in consts.items())),
            self._fused_ks_ok())

    def _replay(self, host_values_list, batched: bool):
        """Run valuations through their captured graph, capturing it on
        the key's first call: their host arrays (_split) are copied into
        the graph's static tensors, the graph replayed, and the static
        outputs copied into pinned host memory, all enqueued on the
        current stream. Returns (host outputs, CUDA event of their
        end). A capture or replay that fails raises."""
        with span("eva.stage"):
            entry = self._staged(*self._split(host_values_list, batched))
        entry.replay()
        return _copy_out(entry.out)

    def _staged(self, cipher, plain, consts, sharded=None) -> "_Captured":
        """The captured graph of host arrays (see _split), with them
        copied into its static input tensors, captured on the key's
        first call; its static output tensors (.out) are what the next
        replay writes. With `sharded` (a _sharded entry whose run is not
        None), the mesh program of that plan: its own graph, keyed by
        the mesh and the plan name as well."""
        key = self._capture_key(cipher, plain, consts)
        mesh = None
        if sharded is not None:
            mesh, plan = sharded[:2]
            key += (id(mesh), plan)
        entry = self._captured.get(key)
        if entry is None or entry.mesh is not mesh:
            entry = self._captured[key] = self._capture_graph(
                cipher, plain, consts, sharded)
        else:
            entry.fill(cipher, plain)
        return entry

    def _dev_inputs(self, cipher, plain, consts, seq=None):
        """Host arrays (see _split) as device inputs of `_traced`; with a
        seq process group, each plane's slice of the ring axis that
        this rank holds (parallel/seq_exec)."""
        from ..parallel.seq_exec import seq_slice

        def cut(a):
            return a if seq is None else seq_slice(a, seq)

        device = self.device
        return ({k: [_to_dev(cut(a), device) for a in planes]
                 for k, planes in cipher.items()},
                {**{k: _to_dev(cut(a), device) for k, a in plain.items()},
                 **{k: cut(self._upload_plain(pt))
                    for k, pt in consts.items()}})

    def _capture_graph(self, cipher, plain, consts,
                       sharded=None) -> "_Captured":
        """Capture `_traced` for one input key, or with `sharded` (see
        _staged) the mesh program of its plan: static input tensors
        (with a seq group, of this rank's ring slice), filled with this
        request's inputs; one eager warm-up on a side stream, which
        builds every lazy table, constant, kernel library and key
        layout, runs every first-use nvcc build and occupancy query, and
        makes every NCCL communicator the program's collectives use, so
        that the capture uploads nothing and initializes nothing; then
        the capture. A mesh program's collectives are recorded in the
        graph. In a process with NCCL process groups, their watchdog
        thread queries CUDA events while this thread captures, so a
        capture refuses unsafe calls of this thread only
        ("thread_local")."""
        from ..parallel.seq_exec import seq_slice
        body, mesh, seq = self._traced, None, None
        if sharded is not None:
            mesh, _, body, seq = sharded

        def cut(a):
            return a if seq is None else seq_slice(a, seq)

        device = self.device
        with span("eva.capture"), torch.cuda.device(device):
            entry = _Captured(
                {k: [torch.empty(cut(a).shape, dtype=torch.int32,
                                 device=device)
                     for a in planes] for k, planes in cipher.items()},
                {k: torch.empty(cut(a).shape, dtype=torch.int32,
                                device=device)
                 for k, a in plain.items()},
                {k: (pt, cut(self._upload_plain(pt)))
                 for k, pt in consts.items()}, seq=seq, mesh=mesh)
            entry.fill(cipher, plain)
            plain_in = {**entry.plain,
                        **{k: dev for k, (_, dev) in entry.consts.items()}}
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                body(entry.cipher, plain_in)
            stream.wait_stream(side)
            # What torch.cuda.graph does on entry, done first so that the
            # reserved bytes grow by the graph's private pool alone.
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            saved = _take_counts()
            reserved = torch.cuda.memory_reserved(device)
            t0 = time.perf_counter()
            entry.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(entry.graph,
                                  capture_error_mode="thread_local"):
                entry.out = body(entry.cipher, plain_in)
            entry.capture_s = time.perf_counter() - t0
            entry.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            # A capture records launches and runs none: what it counted
            # is what each replay launches (see _Captured.replay).
            entry.launches = _take_counts(saved)
        return entry

    def _result(self, out, b=None) -> Dict[str, object]:
        """Host Ciphertext/Plaintext outputs from host (CPU) int32 tensors
        (uint32 residue bits, read by modmath.to_host); with b, batch
        element b of [B, n_sub, N] planes ([B, k, n_sub, N] for sharded
        big vectors; a plane without the batch axis, computed from
        constants alone, serves every element)."""
        plane_dims = 2 if self.k == 1 else 3
        result = {}
        with span("eva.result"):
            for name, t in self.program.outputs.items():
                if self.types[t] == Type.Raw:
                    continue
                planes = [to_host(c) for c in out[name]]
                if b is not None:
                    planes = [pl[b] if pl.ndim > plane_dims else pl
                              for pl in planes]
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
        if self._captures():
            host, done = self._replay([host_values], False)
            with span("eva.wait"):
                done.synchronize()
            return self._result(host)
        out = self._traced(*self._inputs(host_values))
        return self._result({name: [c.cpu() for c in planes]
                             for name, planes in out.items()})

    def run_batched(self, host_values_list,
                    mesh=None) -> List[Dict[str, object]]:
        """Execute the program over a BATCH of valuations in one pass.

        Each cipher input is stacked along a leading batch axis
        ([B, n_sub, N] planes) and every device op broadcasts over it,
        so each kernel launch covers the whole batch (the key-switch
        kernels' batch grid axis). Program constants (cached encodes:
        the same host object in every valuation) are uploaded once and
        broadcast, not stacked B times. On a CUDA device each batch size
        has its own captured graph. Port of
        executor_jax.JaxProgram.run_batched.

        With a mesh (a DeviceMesh of eva_tpu_torch.parallel; every rank
        calls with the same global list), the batch is sharded over the
        mesh's batch axes: each rank runs its slice, padded with copies
        of the last element when the batch does not divide, and the
        outputs are gathered, so every rank returns the whole list (see
        _run_mesh)."""
        batch = len(host_values_list)
        if batch == 0:
            return []
        if mesh is not None:
            return self._run_mesh(host_values_list, mesh)
        if self._captures():
            host, done = self._replay(host_values_list, True)
            with span("eva.wait"):
                done.synchronize()
        else:
            out = self._traced(*self._dev_inputs(
                *self._split(host_values_list, True)))
            host = {name: [c.cpu() for c in planes]
                    for name, planes in out.items()}
        return [self._result(host, b) for b in range(batch)]

    def _run_mesh(self, host_values_list, mesh) -> List[Dict[str, object]]:
        """run_batched on a mesh. This rank takes its batch slice (the
        batch axes flattened, "host" major), its digit shard (limb,
        hlimb) and its ring slice (seq); runs the program of its plan
        (_sharded: the single-device program on the local batch, or the
        digit-parallel / seq program), on the card through the plan's
        captured graph (_staged), on the CPU eagerly; then
        all-gathers the outputs over the ring axis's group and over the
        batch axes, eagerly. Plaintexts that are the same object in
        every element of the whole list serve every rank unstacked, as
        in JAX."""
        from torch.distributed.device_mesh import DeviceMesh

        from ..parallel.sharding import axis_group, batch_axes, batch_shard
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                "run_batched: mesh must be a torch.distributed DeviceMesh "
                "(eva_tpu_torch.parallel.make_device_mesh), not "
                f"{type(mesh).__name__}")
        batch = len(host_values_list)
        n_shards, shard = batch_shard(mesh)
        padded = (list(host_values_list)
                  + [host_values_list[-1]] * (-batch % n_shards))
        loc = len(padded) // n_shards
        shared = {idx for idx, v in padded[0].items()
                  if isinstance(v, Plaintext)
                  and all(hv[idx] is v for hv in padded)}
        with span("eva.stage"):
            cipher, plain, consts = self._split(
                padded[shard * loc:(shard + 1) * loc], True, shared)
            sharded = self._sharded(mesh, cipher, plain, consts)
            _, _, run, seq = sharded
            if self._captures():
                entry = self._staged(cipher, plain, consts,
                                     None if run is None else sharded)
        if self._captures():
            entry.replay()
            out = entry.out
        else:
            inputs = self._dev_inputs(cipher, plain, consts, seq)
            out = (run or self._traced)(*inputs)
        axes = batch_axes(mesh)
        axes = axes if isinstance(axes, tuple) else (axes,)
        plane_dims = 2 if self.k == 1 else 3
        host = {}
        for name, planes in out.items():
            host[name] = []
            for c in planes:
                if seq is not None:
                    c = _all_gather_cat(c, seq, -1)
                if c.dim() > plane_dims:  # batched (see _result)
                    for ax in reversed(axes):  # "batch", then "host"
                        c = _all_gather_cat(c, axis_group(mesh, ax), 0)
                host[name].append(c.cpu())
        return [self._result(host, b) for b in range(batch)]

    def run_pipelined(self, host_values_iter, depth: int = 2):
        """Generator over per-execution outputs, in order, with execution
        k+1 enqueued on the device before execution k's outputs are
        collected.

        PyTorch launches are asynchronous on a CUDA device: each
        execution's inputs are copied in and its graph replayed, then its
        outputs are copied into pinned host memory with non-blocking
        copies on the same stream, and a CUDA event marks their end.
        Stream order keeps execution k's output copy ahead of execution
        k+1's input copy and replay. While the host prepares the next
        execution, the device runs the previous one; collecting waits on
        that execution's event only. `depth` bounds the executions in
        flight. Port of executor_jax.JaxProgram.run_pipelined."""
        import collections

        pending = collections.deque()
        on_cuda = self.device.type == "cuda"

        def dispatch(host_values):
            if self._captures():
                return self._replay([host_values], False)
            out = self._traced(*self._inputs(host_values))
            return _copy_out(out) if on_cuda else (out, None)

        def collect(item):
            host, done = item
            if done is not None:
                with span("eva.wait"):
                    done.synchronize()
            return self._result(host)

        for hv in host_values_iter:
            pending.append(dispatch(hv))
            if len(pending) > depth:
                yield collect(pending.popleft())
        while pending:
            yield collect(pending.popleft())


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' `x` of `group`, concatenated along `dim` in rank
    order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _copy_out(out):
    """Enqueue non-blocking copies of device outputs {name: planes} into
    pinned host memory on the current stream; returns (host outputs,
    CUDA event recorded after the copies)."""
    with span("eva.copy_out"):
        host = {name: [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                       .copy_(c, non_blocking=True) for c in planes]
                for name, planes in out.items()}
        done = torch.cuda.Event()
        done.record()
    return host, done


# Key switches by kind, counted where `_traced` performs them: a
# "hoisted_rotation" MACs the shared digits of its source (one
# decomposition per source), a "single_rotation" decomposes its own
# permuted c1, a "relin" is a relinearization's. A sharded big vector's
# rotation counts each of its (at most two) key switches. Like the
# launch counters, a replay adds what its capture counted
# (_Captured.launches["key_switches"]).
KEY_SWITCHES = {"hoisted_rotation": 0, "single_rotation": 0, "relin": 0}


def _counters():
    """The kernel wrappers' launch counters and the key switches, by
    name."""
    return {"ntt_launches": ntt_cuda.LAUNCHES,
            "ntt_fwd_rows": ntt_cuda.ROWS["ntt_fwd"],
            "ntt_inv_rows": ntt_cuda.ROWS["ntt_inv"],
            "ks_launches": ks_cuda.LAUNCHES,
            "ks_max_batch": ks_cuda.MAX_BATCH,
            "ks_epilogue_cluster": ks_cuda.EPILOGUE_CLUSTER,
            "modmath_launches": modmath_cuda.LAUNCHES,
            "modmath_ops": modmath_cuda.OPS,
            "ntt_shard_launches": ntt_shard_cuda.LAUNCHES,
            "key_switches": KEY_SWITCHES}


def _take_counts(restore=None) -> Dict[str, dict]:
    """The counters' values, after which they read 0, or, given an
    earlier result, what they counted since it, after which they read it
    again."""
    taken = {}
    for name, c in _counters().items():
        taken[name] = {k: v for k, v in c.items() if v}
        if isinstance(c, Counter):
            c.clear()
        else:
            for k in c:
                c[k] = 0
        if restore is not None:
            c.update(restore[name])
    return taken


class _Captured:
    """A program captured in a CUDA graph for one input key (the
    counterpart of one compiled entry of JaxProgram._jit_cache).

    cipher / plain: the static input tensors the graph reads, rewritten
    before each replay from pinned staging buffers (_stages: sets of
    them, each with the CUDA event of its last copies, reused once that
    has passed); consts: {key: (host Plaintext, device tensor)}
    for the program constants the graph reads in place, held here so
    that the upload cache cannot free a tensor the graph still reads
    (the capture key holds the host objects' ids); out: the static
    output tensors each replay rewrites; launches: the kernel launches of
    one replay by counter (see _counters), counted while capturing;
    capture_s and pool_bytes: the capture's seconds and the device
    memory its private pool reserved; seq: the ring axis's process
    group of a seq program, whose static inputs hold this rank's slice
    of the ring axis (fill cuts it); mesh: the mesh of a mesh program
    (the capture key holds its id), else None. The level tables, key
    layouts, program tables, and a mesh program's digit tables, keys and
    transforms the graph reads are held by their caches (and
    TorchProgram._sharded_cache), which never drop an entry."""

    def __init__(self, cipher, plain, consts, seq=None, mesh=None):
        self.cipher = cipher
        self.plain = plain
        self.consts = consts
        self.seq = seq
        self.mesh = mesh
        self._static = [t for planes in cipher.values() for t in planes]
        self._static += list(plain.values())
        self._stages: List[tuple] = []
        self.graph = None
        self.out = None
        self.launches: Dict[str, dict] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    def fill(self, cipher, plain) -> None:
        """Copy one request's host inputs (TorchProgram._split) into the
        static input tensors, through a set of pinned staging buffers
        that no earlier copy still reads, without blocking the host;
        raises on any other name or shape. (PyTorch's pinned-memory
        cache is no help here: it recycles a block only once every newer
        block's copy has passed, so a pipeline pins new memory on every
        request.)"""
        if (set(cipher) != set(self.cipher) or set(plain) != set(self.plain)
                or any(len(cipher[k]) != len(v)
                       for k, v in self.cipher.items())):
            raise ValueError("captured graph: the inputs differ from the "
                             "captured ones")
        arrays = [a for k in self.cipher for a in cipher[k]]
        arrays += [plain[k] for k in self.plain]
        if self.seq is not None:
            from ..parallel.seq_exec import seq_slice
            arrays = [seq_slice(a, self.seq) for a in arrays]
        for dst, arr in zip(self._static, arrays):
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(
                    f"captured graph: input shape {tuple(arr.shape)} "
                    f"differs from the captured {tuple(dst.shape)}")
        stage = next((st for st in self._stages if st[0].query()), None)
        if stage is None:
            stage = (torch.cuda.Event(),
                     [torch.empty(t.shape, dtype=torch.int32,
                                  pin_memory=True) for t in self._static])
            self._stages.append(stage)
        done, bufs = stage
        for dst, arr, buf in zip(self._static, arrays, bufs):
            # uint64 host residues (< 2^32) into the int32 buffer's bits.
            np.copyto(buf.numpy().view(np.uint32), arr, casting="unsafe")
            dst.copy_(buf, non_blocking=True)
        done.record()

    def replay(self) -> None:
        """Launch the graph on the current stream, and add its kernel
        launches to the wrappers' counters."""
        with span("eva.launch"):
            self.graph.replay()
            for name, c in _counters().items():
                for k, v in self.launches[name].items():
                    c[k] = (max(c[k], v) if name == "ks_max_batch"
                            else c[k] + v)
