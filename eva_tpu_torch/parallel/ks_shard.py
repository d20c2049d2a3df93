"""Digit-parallel key switching: the gadget digits sharded over a mesh
axis, the partial inner products summed by a modular all-reduce.

Port of eva_tpu/parallel/ks_shard.py (`_modular_all_reduce`,
`modular_reduce_scatter`, `modular_all_gather`,
`hierarchical_modular_all_reduce`, `ShardedKeySwitch`). The JAX
package's collectives are `jax.lax` ones inside `shard_map` over a mesh
axis name; here they are torch.distributed collectives over a process
group (a DeviceMesh axis's group: NCCL on the card, gloo on the CPU).

Each digit needs a fast base extension, n_ext limb NTTs and a
multiply-accumulate against its key slice; the digits are independent
until the final accumulation, a modular sum over digits.

The modular all-reduce: residues are int32 tensors of uint32 bits
(backend/modmath.py), and a raw 32-bit SUM all-reduce would wrap mod
2^32 rather than mod q (the reason the JAX package runs a butterfly of
ppermutes and add_mods). So each rank all-gathers the ranks' planes and
folds them with the level ops' modular add, in rank order: the CUDA
kernel E1 on the card, its plain version on the CPU. A modular sum is
unique, so this equals the JAX butterfly bit for bit. The reduce-scatter
keeps JAX's form: one all_to_all_single and local modular adds.

The post-accumulation tail (extended-basis iNTT, division by P, final
NTT) runs replicated on every rank. The NTTs are the port's
DeviceLevelOps transforms: the CUDA kernels K1/K2 on the card.

In a digit-parallel program on the card these collectives are recorded
in the program's CUDA graph (backend/executor_torch: _capture_graph):
they read nothing on the host, and their receive buffers, made per
call, come from the graph's pool. A group's NCCL communicator must
exist before the capture; the capture's eager warm-up makes it."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend.executor_torch import (DeviceKeys, _ks_dev_tables,
                                      _ks_dp_tables, _to_dev)
from ..backend.ks import divide_last
from ..backend.modmath import upload
from ..backend.tables import DeviceLevelOps, level_ops
from ..crypto.context import CKKSContext
from ..crypto.keys import KSwitchKey
from .sharding import axis_group, axis_index, axis_size, mesh_device


def _modular_all_reduce(x: torch.Tensor, ops: DeviceLevelOps,
                        group) -> torch.Tensor:
    """Modular sum of `x` ([..., n_sub, N] residues of the primes of
    `ops`) over the ranks of `group`, on every rank: an all-gather, then
    the ranks' planes added in rank order with ops.add."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    acc = parts[0]
    for part in parts[1:]:
        acc = ops.add(acc, part)
    return acc


def modular_reduce_scatter(x: torch.Tensor, ops: DeviceLevelOps,
                           group) -> torch.Tensor:
    """Modular reduce-scatter along the LAST (ring) axis: rank i of
    `group` ends with the i-th N/n_dev chunk of the modular sum over the
    group. One all-to-all (each rank keeps 1/n_dev, sends the rest) and
    n_dev - 1 local modular adds."""
    n_dev = dist.get_world_size(group)
    n_last = x.shape[-1]
    if n_last % n_dev:
        raise ValueError(f"ring axis {n_last} does not split over "
                         f"{n_dev} ranks")
    parts = x.reshape(x.shape[:-1] + (n_dev, n_last // n_dev))
    parts = parts.movedim(-2, 0).contiguous()  # [n_dev, ..., N/n_dev]
    recv = torch.empty_like(parts)
    dist.all_to_all_single(recv, parts, group=group)
    acc = recv[0]
    for j in range(1, n_dev):
        acc = ops.add(acc, recv[j])
    return acc


def modular_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Inverse of the scatter: the full ring axis from the per-rank
    chunks (chunk order == rank order in `group`)."""
    n_dev = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n_dev)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts, dim=-2).reshape(
        x.shape[:-1] + (n_dev * x.shape[-1],))


def hierarchical_modular_all_reduce(x: torch.Tensor, ops: DeviceLevelOps,
                                    ici_group, dcn_group) -> torch.Tensor:
    """Two-level modular all-reduce for accumulators sharded over an
    intra-node axis (ici_group, NVLink) x a cross-node axis (dcn_group):

      1. modular reduce-scatter over the intra-node axis (L ranks),
      2. modular all-reduce of the 1/L chunk over the cross-node axis,
      3. all-gather over the intra-node axis,

    so the cross-node hop carries 1/L of the plane bytes. Exact: modular
    adds are associative and commutative, so the grouping is
    bit-identical to a flat all-reduce."""
    n_ici = dist.get_world_size(ici_group)
    n_dcn = dist.get_world_size(dcn_group)
    if n_ici == 1:
        return _modular_all_reduce(x, ops, dcn_group)
    if n_dcn == 1:
        return _modular_all_reduce(x, ops, ici_group)
    chunk = modular_reduce_scatter(x, ops, ici_group)
    chunk = _modular_all_reduce(chunk, ops, dcn_group)
    return modular_all_gather(chunk, ici_group)


class ShardedKeySwitch:
    """One (context, level, key, mesh axis) digit-parallel plan.

    Every rank of `mesh` holds the padded base-extension constants and
    key slices of its own digits (the digit axis zero-padded to a
    multiple of the axis size; padded digits have zero conversion rows
    and zero keys, so they add exact zeros). `__call__` runs the whole
    key switch on NTT-domain input planes and returns NTT-domain
    (d0, d1) at the same level on every rank, equal to the
    single-device crypto/ops._key_switch output."""

    def __init__(self, ctx: CKKSContext, ksk: KSwitchKey, level: int,
                 mesh, axis: str = "digit"):
        self.ctx = ctx
        self.level = level
        self.mesh = mesh
        self.axis = axis
        self.group = axis_group(mesh, axis)
        if self.group is None:
            raise ValueError(f"mesh has no axis {axis!r}")
        n_dev = axis_size(mesh, axis)
        self.n_dev = n_dev
        self.device = device = mesh_device(mesh)
        primes = ctx.primes_at_level(level)
        basis = primes + ctx.key_primes
        self.primes = primes
        self.basis = basis
        # The executor's digit-parallel tables and key layout (the
        # digit axis padded to a multiple of n_dev), this rank's shard.
        n_groups, inv_mont, _ = _ks_dev_tables(ctx, level, ksk.alpha)
        member, conv_m = _ks_dp_tables(ctx, level, ksk.alpha, n_dev)
        self.n_groups = n_groups
        self.n_dig = member.shape[0]
        self.n_pad = self.n_dig - n_groups
        loc = self.n_dig // n_dev
        shard = axis_index(mesh, axis)
        mine = slice(shard * loc, (shard + 1) * loc)

        # inv_mont is replicated (y on every rank); member an int64 index.
        self.inv_mont = _to_dev(inv_mont, device)
        self.member = _to_dev(member[mine], device)
        self.conv_m = _to_dev(conv_m[mine], device)
        self.k0, self.k1 = DeviceKeys(ctx, device).dp_layout(
            ksk, level, n_dev, shard)

        self.dev = level_ops(primes, ctx.n, device)
        self.ext = level_ops(basis, ctx.n, device)

    def _tail(self, acc):
        """Replicated post-accumulation: iNTT, divide by P (one E3 launch
        on the card), final NTT."""
        ctx = self.ctx
        prim = list(self.basis)
        n_out = len(prim) - len(ctx.key_primes)
        x, = divide_last([self.ext.intt(acc)], prim, len(ctx.key_primes),
                         level_ops(prim[:-1], ctx.n, self.device))
        return level_ops(prim[:n_out], ctx.n, self.device).ntt(x)

    def __call__(self, poly) -> Tuple[torch.Tensor, torch.Tensor]:
        """poly: [n_cur, N] NTT-domain residues (uint64 numpy, or an
        int32 tensor; the same on every rank). Returns (d0, d1)
        NTT-domain planes at the same level, on this rank's device."""
        ctx, dev, ext = self.ctx, self.dev, self.ext
        if isinstance(poly, np.ndarray):
            poly = upload(poly, self.device)
        poly = poly.to(self.device)
        y = dev.mul_mont(dev.intt(poly), self.inv_mont)  # [n_cur, N]
        # Local digits: gather member rows, base-extend (the rows
        # broadcast over the extended basis), sum members.
        loc, alpha = self.member.shape
        ym = torch.index_select(y, 0, self.member.reshape(-1))
        ym = ym.reshape(loc, alpha, 1, ctx.n)
        prod = ext.mul_mont(ym, self.conv_m)
        acc = prod[:, 0]
        for k in range(1, alpha):
            acc = ext.add(acc, prod[:, k])
        d = ext.ntt(acc)                              # [loc, n_ext, N]

        def digit_sum(t):
            s = t[0]
            for j in range(1, t.shape[0]):
                s = ext.add(s, t[j])
            return s

        a0 = _modular_all_reduce(digit_sum(ext.mul_mont(d, self.k0)),
                                 ext, self.group)
        a1 = _modular_all_reduce(digit_sum(ext.mul_mont(d, self.k1)),
                                 ext, self.group)
        return self._tail(a0), self._tail(a1)
