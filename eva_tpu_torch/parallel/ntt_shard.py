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

The JAX module's local phases are jnp stages that XLA fuses into the
jitted program (no TPU kernel stands behind them). Here each local phase
(ShardPhases: the forward column and row phases, the inverse row and
column phases) is one launch of a hand-written CUDA kernel on the card,
K6 for the forward phases and K7 for the inverse ones
(csrc/ntt_shard.cu via backend/ntt_shard_cuda), with its twiddle
multiplies inside; on the CPU the same phase is its plain version, every
stage over every block at once on widened planes (the JAX module loops
over the blocks). A CUDA tensor goes through the kernel or raises.
Planes are int32 tensors of uint32 residues (backend/modmath.py).

In a seq program on the card both transforms, all-to-all included, are
recorded in the program's CUDA graph (backend/executor_torch:
_capture_graph): the tables are uploaded when the transform is made
(get_sharded_ntt, first called in the capture's eager warm-up), the
kernels read them in place and allocate nothing, and a transform reads
nothing on the host."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend.modmath import (_add_into, _shoup, _sub_into, narrow,
                               shoup_stack, upload, widen)
from ..backend.tables import _powers
from ..crypto.ntt import _bit_reverse_perm, get_table

LANES = 128

# Calls of the plain versions of the local phases (a CPU tensor reached a
# phase), by the kernel each stands for. A run on the card that went
# through the kernels leaves these at 0.
PLAIN_CALLS = {"ntt_shard_fwd": 0, "ntt_shard_inv": 0}


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


class ShardPhases:
    """The four local phases of the sharded four-step NTT on rank `rank`
    of `n_dev`, with this rank's slices of the tables on `device`
    (ShardedNTT puts the all-to-alls between them). Each phase runs the
    kernels of backend/ntt_shard_cuda on a CUDA tensor (K6 forward, K7
    inverse: one launch a phase) and its plain version, a `plain_*`
    method, on a CPU tensor; anything else raises. Planes are contiguous
    int32 tensors of reduced residues:

      fwd_cols  [..., n_sub, n1, n2/D] -> same: twist, n1-sub-DIF down
                each column, correction twiddle
      fwd_rows  [..., n_sub, n1/D, n2] -> same: n2-sub-DIF along each row
      inv_rows  [..., n_sub, n1/D, n2] -> [..., n_sub, n2, n1/D]:
                n2-sub-DIT along each row, correction twiddle, transposed
      inv_cols  [..., n_sub, n2/D, n1] -> [..., n_sub, n1, n2/D]:
                n1-sub-DIT along each row of n1, untwist, transposed

    Tables (int32 uint32 bits, each a (w, wp) Shoup pair): tw_fwd,
    tw_inv, corr_fwd [n_sub, n1, n2/D]; corr_inv [n_sub, n2, n1/D];
    st1_f, st1_i [n_sub, n1] and st2_f, st2_i [n_sub, n2], the packed
    stage twiddles (FourStepTables); q [n_sub]."""

    def __init__(self, primes: List[int], n: int, n_dev: int, rank: int,
                 device=None):
        t = FourStepTables(primes, n)
        self.primes = list(primes)
        self.n = n
        self.n1, self.n2 = t.n1, t.n2
        self.n_dev = n_dev
        if self.n2 % n_dev or self.n1 % n_dev:
            raise ValueError(f"N = {n} cannot shard over {n_dev} ranks")
        self.device = device = torch.device(device or "cpu")
        nl, nr = self.n2 // n_dev, self.n1 // n_dev
        lanes = slice(rank * nl, (rank + 1) * nl)
        rows = slice(rank * nr, (rank + 1) * nr)

        def pair(arr):
            """A [n_sub, 2, ...] Shoup pair table as (w, wp) on device."""
            return tuple(upload(arr[:, k], device) for k in range(2))

        self.q = upload(t.q, device)
        self.tw_fwd = pair(t.tw_fwd[..., lanes])       # [n_sub, n1, nl]
        self.tw_inv = pair(t.tw_inv[..., lanes])
        self.corr_fwd = pair(t.corr_fwd[..., lanes])
        self.corr_inv = pair(t.corr_inv[..., rows])    # [n_sub, n2, nr]
        self.st1_f = pair(t.st1_f)
        self.st1_i = pair(t.st1_i)
        self.st2_f = pair(t.st2_f)
        self.st2_i = pair(t.st2_i)
        self._wide_tables = None

    # -- the phases -------------------------------------------------------

    def _run(self, name: str, x):
        if x.is_cuda:
            from ..backend.ntt_shard_cuda import phase
            return phase(name, x, self)
        if x.device.type != "cpu" or x.dtype != torch.int32:
            raise ValueError(f"sharded NTT {name}: int32 residues on the "
                             f"CPU or a CUDA device, not {x.dtype} on "
                             f"{x.device}")
        return getattr(self, "plain_" + name)(x)

    def fwd_cols(self, x):
        return self._run("fwd_cols", x)

    def fwd_rows(self, x):
        return self._run("fwd_rows", x)

    def inv_rows(self, x):
        return self._run("inv_rows", x)

    def inv_cols(self, x):
        return self._run("inv_cols", x)

    # -- plain versions (any device; int32 in and out) --------------------

    def _wide(self):
        """The plain versions' tables widened to int64 once: q as [n_sub,
        1, 1], the w half of each pair (the plain Shoup multiply needs no
        quotient)."""
        if self._wide_tables is None:
            self._wide_tables = {"q": widen(self.q)[:, None, None]}
            for name in ("tw_fwd", "tw_inv", "corr_fwd", "corr_inv",
                         "st1_f", "st1_i", "st2_f", "st2_i"):
                self._wide_tables[name] = widen(getattr(self, name)[0])
        return self._wide_tables

    def plain_fwd_cols(self, x):
        """Plain version of K6's column phase."""
        PLAIN_CALLS["ntt_shard_fwd"] += 1
        w = self._wide()
        x = _shoup(widen(x), w["tw_fwd"], w["q"])
        x = _sub_dif64(x, w["st1_f"], w["q"], self.n1)
        return narrow(_shoup(x, w["corr_fwd"], w["q"]))

    def plain_fwd_rows(self, x):
        """Plain version of K6's row phase."""
        PLAIN_CALLS["ntt_shard_fwd"] += 1
        w = self._wide()
        x = _sub_dif64(widen(x).transpose(-1, -2), w["st2_f"], w["q"],
                       self.n2)
        return narrow(x.transpose(-1, -2)).contiguous()

    def plain_inv_rows(self, x):
        """Plain version of K7's row phase (output transposed)."""
        PLAIN_CALLS["ntt_shard_inv"] += 1
        w = self._wide()
        x = _sub_dit64(widen(x).transpose(-1, -2), w["st2_i"], w["q"],
                       self.n2)
        return narrow(_shoup(x, w["corr_inv"], w["q"]))

    def plain_inv_cols(self, x):
        """Plain version of K7's column phase (input transposed)."""
        PLAIN_CALLS["ntt_shard_inv"] += 1
        w = self._wide()
        x = _sub_dit64(widen(x).transpose(-1, -2), w["st1_i"], w["q"],
                       self.n1)
        return narrow(_shoup(x, w["tw_inv"], w["q"]))


class ShardedNTT(ShardPhases):
    """NTT/iNTT over [..., n_sub, N1, N2] planes with one matrix axis
    sharded over the ranks of `group`. Arrays are this rank's shards.

    ntt:  local [..., n_sub, N1, N2/D] (lane-sharded)
          -> local [..., n_sub, N1/D, N2] (row-sharded), bit-rev order
    intt: the exact inverse (row-sharded in, lane-sharded out)."""

    def __init__(self, primes: List[int], n: int, group, device=None):
        super().__init__(primes, n, dist.get_world_size(group),
                         dist.get_rank(group), device)
        self.group = group

    def ntt(self, x):
        """x: local [..., n_sub, n1, n2/D] coefficient planes (natural
        order, lane-sharded). Returns row-sharded NTT planes."""
        x = self.fwd_cols(x.contiguous())
        x = _all_to_all(x, self.group, split=-2, concat=-1)  # [n1/D, n2]
        return self.fwd_rows(x)

    def intt(self, x):
        """x: local [..., n_sub, n1/D, n2] NTT planes (bit-rev order,
        row-sharded). Returns lane-sharded coefficient planes."""
        x = self.inv_rows(x.contiguous())                    # [n2, n1/D]
        x = _all_to_all(x, self.group, split=-2, concat=-1)  # [n2/D, n1]
        return self.inv_cols(x)


def _blocks(x, m: int):
    """[..., size, lanes] -> [..., size/m, m, lanes] view of the blocks
    of one butterfly stage."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] // m, m, x.shape[-1]))


def _sub_dif64(x, st, q, size):
    """Per-limb DIF over axis -2 (natural in, bit-reversed out) of
    widened planes x [..., n_sub, size, lanes], every block of a stage at
    once; st: the packed stage twiddles [n_sub, size] (int64 w), q [n_sub,
    1, 1]. The JAX package's _sub_dif_rows."""
    q = q[..., None]                      # against [.., n_sub, b, h, l]
    m = size
    while m >= 2:
        half = m >> 1
        w = st[:, None, half - 1:2 * half - 1, None]
        xb = _blocks(x, m)
        out = xb.new_empty(xb.shape)
        _add_into(out[..., :half, :], xb[..., :half, :], xb[..., half:, :], q)
        d = out[..., half:, :]
        _sub_into(d, xb[..., :half, :], xb[..., half:, :], q)
        d.mul_(w).remainder_(q)           # _shoup
        x = out.reshape(x.shape)
        m >>= 1
    return x


def _sub_dit64(x, st, q, size):
    """Per-limb DIT over axis -2 (inverse of _sub_dif64). The JAX
    package's _sub_dit_rows."""
    q = q[..., None]
    m = 2
    while m <= size:
        half = m >> 1
        w = st[:, None, half - 1:2 * half - 1, None]
        xb = _blocks(x, m)
        lo, hi = xb[..., :half, :], _shoup(xb[..., half:, :], w, q)
        out = xb.new_empty(xb.shape)
        _add_into(out[..., :half, :], lo, hi, q)
        _sub_into(out[..., half:, :], lo, hi, q)
        x = out.reshape(x.shape)
        m <<= 1
    return x


@lru_cache(maxsize=None)
def get_sharded_ntt(primes: Tuple[int, ...], n: int, group,
                    device=None) -> ShardedNTT:
    return ShardedNTT(list(primes), n, group, device)
