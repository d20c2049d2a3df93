"""Precomputed device tables for one RNS prime set (one chain level).

Port of eva_tpu/backend/tables.py. Holds per-row modulus constants and
Shoup-pair NTT twiddle tables, plus the transforms over [..., n_sub, N]
int64 limb planes. The butterfly schedule is identical to the host
tables (crypto/ntt.py), so device results are bit-identical to the numpy
backend and to the JAX package.

`ntt`/`intt` dispatch on the tensor's device: a CUDA tensor goes through
the hand-written CUDA kernels (backend/ntt_cuda.py, csrc/ntt.cu); a CPU
tensor through `_fwd_merged`/`_inv_merged`, the plain PyTorch version of
the same schedule."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..crypto.ntt import _bit_reverse_perm, get_table
from . import resolve_device
from .modmath import (add_mod, mont_constants, mont_mul, mont_rinv,
                      neg_mod, shoup_mul, shoup_pair, sub_mod)

# Calls of the plain NTT (a CPU tensor reached ntt/intt). A run on the
# card that went through the kernels leaves these at 0.
PLAIN_CALLS = {"ntt_fwd": 0, "ntt_inv": 0}

_LEVEL_OPS_CACHE: Dict[tuple, "DeviceLevelOps"] = {}


def level_ops(primes: List[int], n: int, device=None) -> "DeviceLevelOps":
    """The DeviceLevelOps of one prime list, built once per process."""
    # n MUST be part of the key: the same prime can serve two ring sizes
    # (q = 1 mod 2*16384 implies q = 1 mod 2*8192). The device too: the
    # tables live on it.
    device = resolve_device(device)
    key = (tuple(primes), n, device)
    if key not in _LEVEL_OPS_CACHE:
        _LEVEL_OPS_CACHE[key] = DeviceLevelOps(primes, n, device)
    return _LEVEL_OPS_CACHE[key]


def _col(values, device) -> torch.Tensor:
    """[n_sub, 1] int64 per-row constant on `device`."""
    return torch.tensor(np.asarray(values, dtype=np.int64).reshape(-1, 1),
                        device=device)


def _powers(base: int, q: int, n: int) -> np.ndarray:
    """[base^k mod q for k < n] (uint64; q < 2^31 keeps products exact),
    by doubling the filled prefix: pw[m:2m] = pw[:m] * base^m."""
    pw = np.ones(n, dtype=np.uint64)
    m = 1
    while m < n:
        step = np.uint64(pow(base, m, q))
        pw[m:2 * m] = pw[:m] * step % np.uint64(q)
        m <<= 1
    return pw


class DeviceLevelOps:
    """Modular/NTT ops for a fixed prime list on one torch device."""

    def __init__(self, primes: Sequence[int], n: int, device=None):
        self.primes = list(primes)
        self.n = n
        self.device = resolve_device(device)
        n_sub = len(primes)
        self.q = _col(primes, self.device)
        # Montgomery form of R, and R^-1 (what a Montgomery multiply
        # divides out: the plain version's stand-in for -q^-1 mod 2^32).
        self.r2 = _col([mont_constants(q)[2] for q in primes], self.device)
        self.rinv = _col([mont_rinv(q) for q in primes], self.device)

        tables = [get_table(q, n) for q in primes]
        self.logn = tables[0].logn

        def stack_pairs(rows: List[np.ndarray]):
            """Per-row Shoup (w, w') pair for [n_sub, ...] constant planes,
            as uint32 numpy arrays."""
            w = np.stack(rows)
            ws = np.empty(w.shape, dtype=np.uint32)
            wp = np.empty(w.shape, dtype=np.uint32)
            for i, q in enumerate(primes):
                ws[i], wp[i] = shoup_pair(w[i], q)
            return ws, wp

        # Harvey merged-psi tables: the negacyclic twist folds into the
        # stage twiddles (mst_f[i] = psi^rev(i)); the inverse merges the
        # untwist, with N^-1 folded into the LAST stage (lo branch gets
        # a dedicated ninv multiply, hi branch's final twiddle is
        # pre-scaled). Eliminates the separate twist/untwist passes.
        rev = _bit_reverse_perm(n)
        mf = np.empty((n_sub, n), dtype=np.uint64)
        mi = np.empty((n_sub, n), dtype=np.uint64)
        ninv_v = np.empty((n_sub, 1), dtype=np.uint64)
        for i, q in enumerate(primes):
            t = tables[i]
            psi = t.psi
            psi_inv = pow(psi, q - 2, q)
            n_inv = pow(n, q - 2, q)
            mf[i] = _powers(psi, q, n)[rev]
            mi[i] = _powers(psi_inv, q, n)[rev]
            mi[i, 1] = mi[i, 1] * n_inv % q  # last-stage hi twiddle
            ninv_v[i, 0] = n_inv
        # uint32 host tables: the CUDA kernels read these (ntt_cuda).
        self.np_tables = {
            "mst_f": stack_pairs(list(mf)),
            "mst_i": stack_pairs(list(mi)),
            "ninv": stack_pairs(list(ninv_v)),
        }
        dev = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)
        self.one = tuple(dev(a) for a in stack_pairs(
            [np.ones(1, dtype=np.uint64) for _ in primes]))
        self.mst_f = tuple(dev(a) for a in self.np_tables["mst_f"])
        self.mst_i = tuple(dev(a) for a in self.np_tables["mst_i"])
        self.ninv = tuple(dev(a) for a in self.np_tables["ninv"])
        self._consts: Dict[object, torch.Tensor] = {}
        self._kernel_tables = None

    def const(self, key, build) -> torch.Tensor:
        """A host-built numpy constant uploaded once to this device as
        int64 (cached under `key`)."""
        t = self._consts.get(key)
        if t is None:
            t = torch.from_numpy(
                np.ascontiguousarray(build()).astype(np.int64)).to(self.device)
            self._consts[key] = t
        return t

    # -- elementwise --------------------------------------------------------

    def add(self, a, b):
        return add_mod(a, b, self.q)

    def sub(self, a, b):
        return sub_mod(a, b, self.q)

    def neg(self, a):
        return neg_mod(a, self.q)

    def mul_mont(self, a, b_mont):
        """a (standard, may be unreduced) * b (Montgomery form)."""
        return mont_mul(a, b_mont, self.q, self.rinv)

    def reduce(self, a):
        """a mod q (per row) for any a < 2^32: a Shoup multiply by 1."""
        return shoup_mul(a, self.one[0], self.one[1], self.q)

    def mul(self, a, b):
        """Both operands standard-domain (ct-ct dyadic multiply)."""
        return self.mul_mont(self.mul_mont(a, b), self.r2)

    # -- NTT ----------------------------------------------------------------

    def _fwd_merged(self, x):
        """Harvey merged-psi forward (natural in, bit-reversed out): the
        negacyclic twist lives in the stage twiddles, one constant per
        butterfly block. Requires reduced input. Plain PyTorch version
        of the CUDA kernel ntt_fwd."""
        PLAIN_CALLS["ntt_fwd"] += 1
        lead = x.shape[:-1]
        n = self.n
        q3 = self.q[:, None, :]
        wsf, wpf = self.mst_f
        m, t = 1, n
        while m < n:
            t >>= 1
            ww = wsf[:, m:2 * m][:, :, None]
            wp = wpf[:, m:2 * m][:, :, None]
            xr = x.reshape(*lead, m, 2 * t)
            lo = xr[..., :t]
            hi = shoup_mul(xr[..., t:], ww, wp, q3)
            x = torch.cat(
                (add_mod(lo, hi, q3), sub_mod(lo, hi, q3)),
                dim=-1).reshape(*lead, n)
            m <<= 1
        return x

    def _inv_merged(self, x):
        """Harvey merged-psi^-1 inverse (bit-reversed in, natural out)
        with N^-1 folded into the last stage. Plain PyTorch version of
        the CUDA kernel ntt_inv."""
        PLAIN_CALLS["ntt_inv"] += 1
        lead = x.shape[:-1]
        n = self.n
        q3 = self.q[:, None, :]
        wsi, wpi = self.mst_i
        m, t = n >> 1, 1
        while m >= 1:
            ww = wsi[:, m:2 * m][:, :, None]
            wp = wpi[:, m:2 * m][:, :, None]
            xr = x.reshape(*lead, m, 2 * t)
            lo = xr[..., :t]
            hi = xr[..., t:]
            s = add_mod(lo, hi, q3)
            if m == 1:  # fold N^-1 into the final stage's lo branch
                s = shoup_mul(s, self.ninv[0][:, :, None],
                              self.ninv[1][:, :, None], q3)
            x = torch.cat(
                (s, shoup_mul(sub_mod(lo, hi, q3), ww, wp, q3)),
                dim=-1).reshape(*lead, n)
            m >>= 1
            t <<= 1
        return x

    def kernel_tables(self):
        """The CUDA kernels' tables on this (CUDA) device: uint32 bit
        patterns held in int32 tensors, uploaded once. Row r of every
        table belongs to prime r, so the first k rows are the tables of
        primes[:k]."""
        if self._kernel_tables is None:
            def up(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a).view(np.int32)).to(self.device)
            t = self.np_tables
            self._kernel_tables = {
                "q": up(np.array(self.primes, dtype=np.uint32)),
                "nqinv": up(np.array([mont_constants(q)[0]
                                      for q in self.primes], dtype=np.uint32)),
                "wf": up(t["mst_f"][0]), "wpf": up(t["mst_f"][1]),
                "wi": up(t["mst_i"][0]), "wpi": up(t["mst_i"][1]),
                "ninv": up(t["ninv"][0][:, 0]),
                "ninvp": up(t["ninv"][1][:, 0]),
            }
        return self._kernel_tables

    def tensor_product(self, a0, a1, b0, b1):
        """Ciphertext tensor product (a0,a1)x(b0,b1) -> 3 components.

        Karatsuba over the 2x2 product with a one-time Montgomery
        conversion of the a-side: 5 mont_muls instead of the naive 8
        (each standard-domain product costs 2)."""
        a0m = self.mul_mont(a0, self.r2)  # a0*R mod q (Montgomery form)
        a1m = self.mul_mont(a1, self.r2)
        am_sum = self.add(a0m, a1m)
        b_sum = self.add(b0, b1)
        p0 = self.mul_mont(b0, a0m)       # a0*b0 mod q
        p2 = self.mul_mont(b1, a1m)       # a1*b1 mod q
        pm = self.mul_mont(b_sum, am_sum)  # (a0+a1)(b0+b1) mod q
        return [p0, self.sub(self.sub(pm, p0), p2), p2]

    def ntt(self, a):
        """Coefficient -> evaluation (bit-reversed order). REQUIRES
        reduced planes (a < q per row) — the merged-twist butterflies
        have no reducing first pass; call `reduce()` first for raw
        planes. Leading dims are arbitrary; the last two are
        [n_sub, N]."""
        if a.is_cuda:
            from .ntt_cuda import ntt_fwd
            return ntt_fwd(a.contiguous(), self)
        if a.device.type != "cpu":
            raise ValueError(f"ntt: unsupported device {a.device}")
        return self._fwd_merged(a)

    def intt(self, x):
        """Evaluation (bit-reversed) -> coefficient (natural order)."""
        if x.is_cuda:
            from .ntt_cuda import ntt_inv
            return ntt_inv(x.contiguous(), self)
        if x.device.type != "cpu":
            raise ValueError(f"intt: unsupported device {x.device}")
        return self._inv_merged(x)
