"""Sequence-parallel program execution: the ring axis N of every
polynomial sharded over a mesh axis, inside the executor.

Port of eva_tpu/parallel/seq_exec.py (`seq_slice`, `seq_perm`,
`_seq_perm_tables`, `seq_perm_galois`, `SeqLevelOps`, `get_seq_ops`,
`seq_compatible`). Collectives run over the "seq" axis's process group;
every rank holds its own shard.

Sharding layout contract (each rank's local view):

  evaluation (NTT) domain   [..., n_sub, N/D] — row-sharded: the local
      flat slice IS a contiguous slice of the global bit-reversed flat
      layout, so ciphertext planes cross the program boundary (inputs,
      outputs, key material) as contiguous slices of the last axis.
  coefficient domain        lane-sharded [n1, n2/D] kept FLAT as
      [..., n_sub, N/D] — an executor-internal layout produced by intt
      and consumed by ntt/divide; it never crosses the boundary.

Every elementwise op (dyadic arithmetic, FBE, key MACs, rescale
divide-and-round) is pointwise over N and works on either local layout
unchanged; only two things need communication:

  * NTT/iNTT — ONE all-to-all between the two four-step phases
    (ntt_shard.ShardedNTT, bit-exact against the single-device NTT),
  * the Galois automorphism — an N-permutation crossing shards
    (seq_perm_galois: one shard exchange and a local gather).

This is the latency axis: batch sharding keeps one execution on one
device; the seq axis splits the work of a single execution. On the card
a seq program runs as one captured CUDA graph with these exchanges
inside (backend/executor_torch: _capture_graph)."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend.tables import DeviceLevelOps, level_ops
from .ntt_shard import ShardedNTT, get_sharded_ntt


def seq_slice(arr, group):
    """This rank's contiguous shard of a whole last-axis-N array
    (evaluation-domain key planes are row-sharded = flat slices)."""
    n_dev = dist.get_world_size(group)
    nloc = arr.shape[-1] // n_dev
    i = dist.get_rank(group)
    return arr[..., i * nloc:(i + 1) * nloc]


def seq_perm(perm_fn, group):
    """Lift a full-plane N-permutation to seq-sharded evaluation planes
    the GENERIC way: all_gather the N axis, permute on the full plane,
    keep the own slice. For permutations without the
    affine-automorphism shard structure (see seq_perm_galois)."""

    def f(x):
        n_dev = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n_dev)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return seq_slice(perm_fn(torch.cat(parts, dim=-1)), group)

    return f


@lru_cache(maxsize=None)
def _seq_perm_tables(ctx, g: int, n_dev: int):
    """(src, local) shard-exchange tables for the Galois automorphism g
    on a D-way seq sharding, or None if the structure doesn't hold.

    Why one source shard per destination shard: the automorphism is
    affine in natural index order, t' = g*t + (g-1)/2 mod N, and storage
    is bit-reversed, so a flat position's shard (top log2 D bits of the
    bit-reversed index) is determined by the natural index mod D. With
    D | 128 | N and g odd, t' mod D is constant across one destination
    shard and t = g^-1 (t' - c) mod D is then a single value — every
    output position of shard d reads from the SAME source shard
    src[d], and d -> src[d] is a bijection of shards. Checked from the
    permutation table rather than trusted.

    src[d]      source shard whose slice destination shard d needs
    local[d,:]  source-local flat indices within that received slice"""
    perm = np.asarray(ctx.perm_for_elt(g))
    n = perm.shape[0]
    if n % n_dev:
        return None
    nloc = n // n_dev
    src_flat = perm.reshape(n_dev, nloc)
    src_dev = src_flat // nloc
    if not (src_dev == src_dev[:, :1]).all():
        return None
    src = src_dev[:, 0].astype(np.int64)
    local = (src_flat - src[:, None] * nloc).astype(np.int64)
    return src, local


def seq_perm_galois(ctx, g: int, group, fallback_fn, device=None):
    """Galois automorphism on seq-sharded evaluation planes WITHOUT the
    all_gather: each rank sends its whole slice to the one rank that
    needs it and receives the one slice it needs (an all_to_all_single
    with one non-empty block each way; JAX: one ppermute), then gathers
    its lanes locally. Falls back to the generic gather lift if the
    shard-exchange structure doesn't factor (it always does for Galois
    elements under the seq_compatible conditions). Bit-identical either
    way. The exchange's split sizes and the lane index are made here,
    with numpy, so the returned applicator reads nothing on the host:
    the executor makes it once per seq context (TorchProgram._aperm),
    in the eager warm-up before a capture, and the capture records the
    exchange."""
    n_dev = dist.get_world_size(group)
    tabs = _seq_perm_tables(ctx, g, n_dev)
    if tabs is None:  # pragma: no cover - defensive
        return seq_perm(fallback_fn, group)
    src, local = tabs
    me = dist.get_rank(group)
    dst = int(np.flatnonzero(src == me)[0])  # the rank that reads mine
    idx = torch.from_numpy(local[me]).to(device or "cpu")

    def f(x):
        x = x.contiguous()
        recv = torch.empty_like(x)
        size = x.numel()
        dist.all_to_all_single(
            recv.view(-1), x.view(-1),
            output_split_sizes=[size if j == src[me] else 0
                                for j in range(n_dev)],
            input_split_sizes=[size if j == dst else 0
                               for j in range(n_dev)],
            group=group)
        return torch.index_select(recv, -1, idx)

    return f


class SeqLevelOps:
    """DeviceLevelOps facade for seq-sharded local planes.

    Elementwise ops delegate to the single-device ops (per-row modulus
    constants broadcast over any trailing length, so a shorter local N
    needs no new tables); transforms route through the all-to-all
    ShardedNTT."""

    def __init__(self, base: DeviceLevelOps, sntt: ShardedNTT, group):
        self.base = base
        self.sntt = sntt
        self.group = group
        self.n_dev = dist.get_world_size(group)
        self.primes = base.primes
        self.n = base.n
        self.device = base.device
        self.q = base.q
        self.r2 = base.r2
        self.rinv = base.rinv
        self.one = base.one

    # -- elementwise (local-layout agnostic) ----------------------------

    def const(self, key, build):
        return self.base.const(key, build)

    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def mul_mont(self, a, b_mont):
        return self.base.mul_mont(a, b_mont)

    def reduce(self, a):
        return self.base.reduce(a)

    def mul(self, a, b):
        return self.base.mul(a, b)

    def tensor_product(self, a0, a1, b0, b1):
        return self.base.tensor_product(a0, a1, b0, b1)

    def ew_planes(self, op, planes):
        return self.base.ew_planes(op, planes)

    def mac(self, own, a, b, keys0, keys1):
        return self.base.mac(own, a, b, keys0, keys1)

    # -- transforms (one all-to-all each) -------------------------------

    def ntt(self, a):
        """Local lane-sharded coefficient planes [..., n_sub, N/D] ->
        local row-sharded evaluation planes (contiguous flat slices)."""
        lead = a.shape[:-1]
        x = a.reshape(lead + (self.sntt.n1, self.sntt.n2 // self.n_dev))
        return self.sntt.ntt(x).reshape(lead + (a.shape[-1],))

    def intt(self, x):
        lead = x.shape[:-1]
        a = x.reshape(lead + (self.sntt.n1 // self.n_dev, self.sntt.n2))
        return self.sntt.intt(a).reshape(lead + (x.shape[-1],))


@lru_cache(maxsize=None)
def get_seq_ops(primes: Tuple[int, ...], n: int, group,
                device=None) -> SeqLevelOps:
    sntt = get_sharded_ntt(tuple(primes), n, group, device)
    return SeqLevelOps(level_ops(list(primes), n, device), sntt, group)


def seq_compatible(n: int, n_dev: int) -> bool:
    """Whether ring size n can shard over n_dev devices: both four-step
    factors must split evenly (n2 = 128 lanes, n1 = n/128 rows)."""
    if n < 1024:
        return False
    n2 = 128
    n1 = n // n2
    return n1 % n_dev == 0 and n2 % n_dev == 0
