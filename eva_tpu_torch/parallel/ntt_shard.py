"""Single-polynomial NTT with the ring dimension N sharded over a mesh
axis: the four-step form with ONE all-to-all between its two phases.

Port of eva_tpu/parallel/ntt_shard.py (`ShardedNTT`, `_sub_dif_rows`,
`_sub_dit_rows`, `get_sharded_ntt`). The four-step tables, which the JAX
package takes from its Pallas kernel's `PallasNTTTables`
(backend/pallas_ntt.py) together with `_sub_dif` / `_sub_dit`, are
rebuilt here as `FourStepTables` (numpy only, the same values): the
port's own NTT is the merged-psi schedule of backend/tables.py and has
no four-step tables.

The four-step decomposition views a polynomial as an [N1, N2] matrix
(N2 = 128 lanes). Each sub-DFT phase needs one matrix axis locally:

  forward:  input sharded on the LANE axis [N1, N2/D]
            -> twist + N1-sub-DIF + correction twiddle (all local)
            -> all-to-all (split rows, concat lanes) -> [N1/D, N2]
            -> N2-sub-DIF (local)
            output sharded on the ROW axis
  inverse:  mirrors the forward (rows-sharded in, lanes-sharded out).

The all-to-all is `dist.all_to_all_single` over the axis's process
group (JAX: `jax.lax.all_to_all`). The butterflies compute the same
modular sums and products as the single-device transforms, so the
gathered output is the port's DeviceLevelOps.ntt output, in global
bit-reversed order (rev(k1 + N1*k2) = rev_N1(k1)*N2 + rev_N2(k2)).

The phases are the JAX module's jnp stages (no TPU kernel stands behind
them): each stage's modular adds, subtracts and Shoup multiplies go
through the level ops of the primes (DeviceLevelOps: the CUDA kernel E1
on the card, its plain version on the CPU), over every block at once
(the JAX module loops over the blocks). Planes are int32 tensors of
uint32 residues (backend/modmath.py).

In a seq program on the card both transforms, all-to-all included, are
recorded in the program's CUDA graph (backend/executor_torch:
_capture_graph): the tables are uploaded when the transform is made
(get_sharded_ntt, first called in the capture's eager warm-up), and a
transform reads nothing on the host."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend.modmath import shoup_stack, upload
from ..backend.tables import _powers, level_ops
from ..crypto.ntt import _bit_reverse_perm, get_table

LANES = 128


class FourStepTables:
    """Per-limb Shoup-pair tables of the four-step NTT (the part of
    eva_tpu's PallasNTTTables that ShardedNTT reads; uint32 numpy).
    tab[limb, 0] = w, tab[limb, 1] = floor(w * 2^32 / q).

    tw_fwd / tw_inv   [n_sub, 2, n1, n2]  twist psi^k / untwist (N^-1 in)
    corr_fwd          [n_sub, 2, n1, n2]  omega^(rev_n1(r) * c)
    corr_inv          [n_sub, 2, n2, n1]  omega^(-rev_n1(c) * r)
    st1_f / st1_i     [n_sub, 2, n1]      packed DIF / DIT stage twiddles
    st2_f / st2_i     [n_sub, 2, n2]      of the size-n1 and size-n2
                                          sub-DFTs (stage with half-block
                                          h at [h-1, 2h-1))"""

    def __init__(self, primes: List[int], n: int):
        if n % LANES or n // LANES < 2:
            raise ValueError(f"four-step NTT needs N a multiple of "
                             f"{LANES} and >= {2 * LANES}, not {n}")
        self.primes = list(primes)
        self.n = n
        self.n1 = n1 = n // LANES
        self.n2 = n2 = LANES
        n_sub = len(primes)
        self.q = np.array(primes, dtype=np.uint32)
        rev1 = _bit_reverse_perm(n1).astype(np.int64)
        lanes = np.arange(n2, dtype=np.int64)
        shapes = {"tw_fwd": (n1, n2), "tw_inv": (n1, n2),
                  "corr_fwd": (n1, n2), "corr_inv": (n2, n1),
                  "st1_f": (n1,), "st1_i": (n1,), "st2_f": (n2,),
                  "st2_i": (n2,)}
        for name, shape in shapes.items():
            setattr(self, name, np.empty((n_sub, 2) + shape,
                                         dtype=np.uint32))

        def packed(sub_n, pw):
            # Stage with half-block h: root^(n/(2h) * i), i < h.
            out = np.zeros(sub_n, dtype=np.uint64)
            h = 1
            while h < sub_n:
                out[h - 1:2 * h - 1] = pw[(n // (2 * h))
                                          * np.arange(h, dtype=np.int64)]
                h <<= 1
            return out

        for li, q in enumerate(primes):
            t = get_table(q, n)
            omega = t.psi * t.psi % q
            pw = _powers(omega, q, n)                 # omega^k, k < n
            pwi = _powers(pow(omega, q - 2, q), q, n)
            self.tw_fwd[li] = shoup_stack(t.twist.reshape(n1, n2), q)
            self.tw_inv[li] = shoup_stack(t.untwist.reshape(n1, n2), q)
            self.corr_fwd[li] = shoup_stack(
                pw[(rev1[:, None] * lanes[None, :]) % n], q)
            self.corr_inv[li] = shoup_stack(
                pwi[(lanes[:, None] * rev1[None, :]) % n], q)
            self.st1_f[li] = shoup_stack(packed(n1, pw), q)
            self.st1_i[li] = shoup_stack(packed(n1, pwi), q)
            self.st2_f[li] = shoup_stack(packed(n2, pw), q)
            self.st2_i[li] = shoup_stack(packed(n2, pwi), q)


def _all_to_all(x: torch.Tensor, group, split: int, concat: int):
    """jax.lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True) over `group`: axis `split` cut into one block per rank,
    block j sent to rank j, the blocks received concatenated along
    `concat` in rank order."""
    n_dev = dist.get_world_size(group)
    split %= x.dim()
    concat %= x.dim()
    shape = list(x.shape)
    parts = x.reshape(shape[:split] + [n_dev, shape[split] // n_dev]
                      + shape[split + 1:])
    parts = parts.movedim(split, 0).contiguous()
    recv = torch.empty_like(parts)
    dist.all_to_all_single(recv, parts, group=group)
    # recv[j]: rank j's block; put the rank axis before `concat`.
    out = recv.movedim(0, concat)
    shape[split] //= n_dev
    shape[concat] *= n_dev
    return out.reshape(shape)


class ShardedNTT:
    """NTT/iNTT over [..., n_sub, N1, N2] planes with one matrix axis
    sharded over the ranks of `group`. Arrays are this rank's shards.

    ntt:  local [..., n_sub, N1, N2/D] (lane-sharded)
          -> local [..., n_sub, N1/D, N2] (row-sharded), bit-rev order
    intt: the exact inverse (row-sharded in, lane-sharded out)."""

    def __init__(self, primes: List[int], n: int, group, device=None):
        t = FourStepTables(primes, n)
        self.primes = list(primes)
        self.n = n
        self.n1, self.n2 = t.n1, t.n2
        self.group = group
        self.n_dev = n_dev = dist.get_world_size(group)
        if self.n2 % n_dev or self.n1 % n_dev:
            raise ValueError(f"N = {n} cannot shard over {n_dev} ranks")
        i = dist.get_rank(group)
        self.device = device = torch.device(device or "cpu")
        nl, nr = self.n2 // n_dev, self.n1 // n_dev
        lanes, rows = slice(i * nl, (i + 1) * nl), slice(i * nr, (i + 1) * nr)

        def pair(arr):
            """A [n_sub, 2, ...] Shoup pair table as (w, wp) on device."""
            return tuple(upload(arr[:, k], device) for k in range(2))

        def stages(arr):
            """A packed [n_sub, 2, size] stage table as {half: (w, wp)},
            each [n_sub, 1, half, 1]: the twiddles of the stage with
            half-block `half`, shared by every block."""
            out, h = {}, 1
            while h < arr.shape[-1]:
                out[h] = pair(arr[:, :, None, h - 1:2 * h - 1, None])
                h <<= 1
            return out

        # The level ops of the primes run every stage's modular arithmetic.
        self.ops = level_ops(self.primes, n, device)
        self.tw_fwd = pair(t.tw_fwd[..., lanes])       # [n_sub, n1, nl]
        self.tw_inv = pair(t.tw_inv[..., lanes])
        self.corr_fwd = pair(t.corr_fwd[..., lanes])
        self.corr_inv = pair(t.corr_inv[..., rows])    # [n_sub, n2, nr]
        self.st1_f = stages(t.st1_f)
        self.st1_i = stages(t.st1_i)
        self.st2_f = stages(t.st2_f)
        self.st2_i = stages(t.st2_i)

    def _mul_pair(self, x, pair):
        """Shoup multiply of [..., n_sub, a, b] planes by a (w, wp) pair
        table [n_sub, a, b]."""
        return self.ops.mul_shoup(x, *pair, prime_dim=-3)

    def ntt(self, x):
        """x: local [..., n_sub, n1, n2/D] coefficient planes (natural
        order, lane-sharded). Returns row-sharded NTT planes."""
        x = self._mul_pair(x, self.tw_fwd)
        x = _sub_dif_rows(self.ops, x, self.st1_f, self.n1)
        x = self._mul_pair(x, self.corr_fwd)
        x = _all_to_all(x, self.group, split=-2, concat=-1)  # [n1/D, n2]
        x = x.transpose(-1, -2)
        x = _sub_dif_rows(self.ops, x, self.st2_f, self.n2)
        return x.transpose(-1, -2).contiguous()

    def intt(self, x):
        """x: local [..., n_sub, n1/D, n2] NTT planes (bit-rev order,
        row-sharded). Returns lane-sharded coefficient planes."""
        x = x.transpose(-1, -2)                  # [.., n2, n1/D]
        x = _sub_dit_rows(self.ops, x, self.st2_i, self.n2)
        x = self._mul_pair(x, self.corr_inv)
        x = _all_to_all(x, self.group, split=-2, concat=-1)  # [n2/D, n1]
        x = x.transpose(-1, -2)                  # [.., n1, n2/D]
        x = _sub_dit_rows(self.ops, x, self.st1_i, self.n1)
        return self._mul_pair(x, self.tw_inv).contiguous()


def _blocks(x, m: int):
    """[..., size, lanes] -> [..., size/m, m, lanes] view of the blocks
    of one butterfly stage."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] // m, m, x.shape[-1]))


# The prime axis of a stage's blocks [..., n_sub, size/m, m, lanes].
_BLOCK_PRIME_DIM = -4


def _sub_dif_rows(ops, x, st, size):
    """Per-limb DIF over axis -2 (natural in, bit-reversed out).
    x: [..., n_sub, size, lanes]; st: {half: (w, wp)} stage tables
    [n_sub, 1, half, 1]; ops: the primes' level ops. Every block of a
    stage uses the same twiddles."""
    dim = _BLOCK_PRIME_DIM
    m = size
    while m >= 2:
        half = m >> 1
        w, wp = st[half]
        xb = _blocks(x, m)
        # The halves once as contiguous planes, which the ops take.
        lo = xb[..., :half, :].contiguous()
        hi = xb[..., half:, :].contiguous()
        d = ops.sub(lo, hi, prime_dim=dim)
        x = torch.cat([ops.add(lo, hi, prime_dim=dim),
                       ops.mul_shoup(d, w, wp, prime_dim=dim)],
                      dim=-2).reshape(x.shape)
        m >>= 1
    return x


def _sub_dit_rows(ops, x, st, size):
    """Per-limb DIT over axis -2 (inverse of _sub_dif_rows)."""
    dim = _BLOCK_PRIME_DIM
    m = 2
    while m <= size:
        half = m >> 1
        w, wp = st[half]
        xb = _blocks(x, m)
        # The halves once as planes whose last dim has stride 1, which
        # the ops take (x may be a transposed view).
        lo = xb[..., :half, :].contiguous()
        hi = ops.mul_shoup(xb[..., half:, :].contiguous(), w, wp,
                           prime_dim=dim)
        x = torch.cat([ops.add(lo, hi, prime_dim=dim),
                       ops.sub(lo, hi, prime_dim=dim)],
                      dim=-2).reshape(x.shape)
        m <<= 1
    return x


@lru_cache(maxsize=None)
def get_sharded_ntt(primes: Tuple[int, ...], n: int, group,
                    device=None) -> ShardedNTT:
    return ShardedNTT(list(primes), n, group, device)
