"""Precomputed device tables for one RNS prime set (one chain level).

Port of eva_tpu/backend/tables.py. Holds per-row modulus constants and
Shoup-pair NTT twiddle tables, plus the elementwise modular ops and the
transforms over [..., n_sub, N] limb planes: int32 tensors carrying the
uint32 residues of the JAX package (backend/modmath.py). The butterfly
schedule is identical to the host tables (crypto/ntt.py), so device
results are bit-identical to the numpy backend and to the JAX package.

Every op dispatches on the tensor's device: a CUDA tensor goes through
the hand-written CUDA kernels (elementwise ops, several planes of one op,
the structured key-switch MAC and the tensor product: modmath_cuda,
csrc/modmath.cu; ntt/intt: ntt_cuda, csrc/ntt.cu) or raises; a CPU
tensor through the plain PyTorch versions (modmath's, and
`_fwd_merged`/`_inv_merged` for the NTT); any other device raises."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..crypto.ntt import _bit_reverse_perm, get_table
from . import modmath as M
from . import resolve_device
from .modmath import (_add_into, _sub_into, mont_constants, mont_rinv,
                      shoup_pair, upload, widen)

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
    """[n_sub, 1] int32 per-row constant (uint32 bits) on `device`."""
    return upload(np.asarray(values, dtype=np.uint64).reshape(-1, 1),
                  device)


def _check_operands(name: str, operands) -> None:
    """The plain versions take what the kernels take: int32 residues on
    the CPU (a CUDA tensor never reaches them through the dispatch)."""
    for t in operands:
        if t.device.type != "cpu":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 residues, got "
                             f"{t.dtype}")


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
        self.one = tuple(upload(a, self.device) for a in stack_pairs(
            [np.ones(1, dtype=np.uint64) for _ in primes]))
        self.mst_f = tuple(upload(a, self.device)
                           for a in self.np_tables["mst_f"])
        self.mst_i = tuple(upload(a, self.device)
                           for a in self.np_tables["mst_i"])
        self.ninv = tuple(upload(a, self.device)
                          for a in self.np_tables["ninv"])
        self._consts: Dict[object, torch.Tensor] = {}
        self._kernel_tables = None
        self._wide_tables = None

    def const(self, key, build) -> torch.Tensor:
        """A host-built numpy constant (residues, or other values below
        2^32) uploaded once to this device as int32 uint32 bits (cached
        under `key`)."""
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = upload(build(), self.device)
        return t

    def _wide(self):
        """The plain versions' tables, widened to int64 once on this
        device: q, R^-1, and the NTT's twiddles (w only: the plain Shoup
        multiply needs no quotient)."""
        if self._wide_tables is None:
            self._wide_tables = {
                "q": widen(self.q), "mst_f": widen(self.mst_f[0]),
                "mst_i": widen(self.mst_i[0]), "ninv": widen(self.ninv[0])}
        return self._wide_tables

    # -- elementwise --------------------------------------------------------

    def _ew(self, op: str, plain, *operands):
        """Elementwise op `op` (modmath_cuda.OP_CODES) on the operands,
        the primes along the output's second-last dim: E1 on a CUDA tensor
        (strided operands read in place), `plain` on a CPU tensor,
        anything else raises."""
        if operands[0].is_cuda:
            from .modmath_cuda import mod_ew
            return mod_ew(op, self, *operands)
        _check_operands(op, operands)
        return plain(*operands)

    def ew_planes(self, op: str, planes) -> list:
        """`op` on each operand tuple of `planes`, all in one E1 launch on
        the card (the several-planes form; one plane: the single form; 4
        planes a launch). A plane's output is the broadcast of its
        operands, and its rows (the second-last dim) use the first rows
        of this table's primes: a rotation sum's c0 (the level's data
        primes) and acc (the extended basis) go in together on the
        extended basis's ops. "mul" takes (a, b): R^2 is added here."""
        planes = [tuple(p) for p in planes]
        rows = [max(t.shape[-2] for t in p) for p in planes]
        if op == "mul":
            planes = [p + (self.r2[:r],) for p, r in zip(planes, rows)]
        if planes[0][0].is_cuda:
            from .modmath_cuda import MAX_PLANES, mod_ew_multi
            return [out for i in range(0, len(planes), MAX_PLANES)
                    for out in mod_ew_multi(op, self,
                                            planes[i:i + MAX_PLANES])]
        _check_operands(op, [t for p in planes for t in p])
        return M.ew_planes(op, [(p, self.q[:r], self.rinv[:r])
                                for p, r in zip(planes, rows)])

    def mac(self, own, a, b, keys0, keys1):
        """The structured key switch's inner product (the MAC form of E1:
        one launch on the card, modmath.mont_mac on the CPU) of the
        digits own [..., n_cur, N], a [..., groups - 1, n_cur, N] (None for
        one group), b [..., groups, n_key, N] with the key halves keys0,
        keys1 = (k_own, k_a, k_b) in the matching layout; this table is
        the extended basis. Returns acc0, acc1 [..., n_cur + n_key, N]."""
        if own.is_cuda:
            from .modmath_cuda import mod_ew_mac
            return mod_ew_mac(self, own, a, b, keys0, keys1)
        _check_operands("mac", [t for t in (own, a, b, *keys0, *keys1)
                                if t is not None])
        return M.mont_mac(own, a, b, keys0, keys1, self.q, self.rinv)

    def add(self, a, b):
        return self._ew("add", lambda a, b: M.add_mod(a, b, self.q), a, b)

    def sub(self, a, b):
        return self._ew("sub", lambda a, b: M.sub_mod(a, b, self.q), a, b)

    def neg(self, a):
        return self._ew("neg", lambda a: M.neg_mod(a, self.q), a)

    def mul_mont(self, a, b_mont):
        """a (standard, may be unreduced) * b (Montgomery form)."""
        return self._ew("mul_mont",
                        lambda a, b: M.mont_mul(a, b, self.q, self.rinv),
                        a, b_mont)

    def mul_shoup(self, a, w, wp):
        """a (any value below 2^32) * w by the Shoup pair (w, wp): w < q,
        wp = floor(w * 2^32 / q), broadcast like any operand."""
        return self._ew("shoup", lambda a, w, wp: M.shoup_mul(
            a, w, wp, self.q), a, w, wp)

    def reduce(self, a):
        """a mod q (per row) for any a < 2^32: a Shoup multiply by 1."""
        return self.mul_shoup(a, *self.one)

    def mul(self, a, b):
        """Both operands standard-domain (ct-ct dyadic multiply): two
        Montgomery steps, the second by R^2 mod q."""
        return self._ew("mul",
                        lambda a, b, r2: M.mul(a, b, self.q, self.rinv, r2),
                        a, b, self.r2)

    # -- NTT ----------------------------------------------------------------

    def _fwd_merged(self, x):
        """Harvey merged-psi forward (natural in, bit-reversed out): the
        negacyclic twist lives in the stage twiddles, one constant per
        butterfly block. Requires reduced input. Plain PyTorch version
        of the CUDA kernel ntt_fwd: int32 in and out."""
        return self._fwd64(widen(x)).to(torch.int32)

    def _inv_merged(self, x):
        """Harvey merged-psi^-1 inverse (bit-reversed in, natural out)
        with N^-1 folded into the last stage. Plain PyTorch version of
        the CUDA kernel ntt_inv: int32 in and out."""
        return self._inv64(widen(x)).to(torch.int32)

    def _fwd64(self, x):
        """_fwd_merged on widened (int64) planes. Each stage writes its
        two halves into one new tensor, reducing in place (_add_into,
        _sub_into): the same residues as _add / _sub, in fewer passes."""
        PLAIN_CALLS["ntt_fwd"] += 1
        wide = self._wide()
        lead = x.shape[:-1]
        n = self.n
        q3 = wide["q"][:, None, :]
        m, t = 1, n
        while m < n:
            t >>= 1
            ww = wide["mst_f"][:, m:2 * m][:, :, None]
            xr = x.reshape(*lead, m, 2 * t)
            lo = xr[..., :t]
            hi = xr[..., t:] * ww
            hi.remainder_(q3)                     # _shoup
            out = xr.new_empty(xr.shape)
            _add_into(out[..., :t], lo, hi, q3)
            _sub_into(out[..., t:], lo, hi, q3)
            x = out.reshape(*lead, n)
            m <<= 1
        return x

    def _inv64(self, x):
        """_inv_merged on widened (int64) planes (stages as _fwd64's)."""
        PLAIN_CALLS["ntt_inv"] += 1
        wide = self._wide()
        lead = x.shape[:-1]
        n = self.n
        q3 = wide["q"][:, None, :]
        m, t = n >> 1, 1
        while m >= 1:
            ww = wide["mst_i"][:, m:2 * m][:, :, None]
            xr = x.reshape(*lead, m, 2 * t)
            lo = xr[..., :t]
            hi = xr[..., t:]
            out = xr.new_empty(xr.shape)
            s, d = out[..., :t], out[..., t:]
            _add_into(s, lo, hi, q3)
            if m == 1:  # fold N^-1 into the final stage's lo branch
                s.mul_(wide["ninv"][:, :, None]).remainder_(q3)
            _sub_into(d, lo, hi, q3)
            d.mul_(ww).remainder_(q3)             # _shoup
            x = out.reshape(*lead, n)
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
                return upload(a, self.device)
            t = self.np_tables
            self._kernel_tables = {
                "q": up(np.array(self.primes, dtype=np.uint32)),
                "nqinv": up(np.array([mont_constants(q)[0]
                                      for q in self.primes], dtype=np.uint32)),
                "r2": up(np.array([mont_constants(q)[2]
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
        (each standard-domain product costs 2). One E2 launch on a CUDA
        tensor (modmath_cuda.tensor_product), modmath.tensor_product on a
        CPU tensor."""
        operands = (a0, a1, b0, b1)
        if a0.is_cuda:
            from .modmath_cuda import tensor_product
            return tensor_product(self, *(t.contiguous() for t in operands))
        _check_operands("tensor_product", operands)
        return M.tensor_product(*operands, self.q, self.rinv, self.r2)

    def ntt(self, a):
        """Coefficient -> evaluation (bit-reversed order). REQUIRES
        reduced planes (a < q per row) — the merged-twist butterflies
        have no reducing first pass; call `reduce()` first for raw
        planes. Leading dims are arbitrary; the last two are
        [n_sub, N]."""
        if a.is_cuda:
            from .ntt_cuda import ntt_fwd
            return ntt_fwd(a.contiguous(), self)
        _check_operands("ntt", (a,))
        return self._fwd_merged(a)

    def intt(self, x):
        """Evaluation (bit-reversed) -> coefficient (natural order)."""
        if x.is_cuda:
            from .ntt_cuda import ntt_inv
            return ntt_inv(x.contiguous(), self)
        _check_operands("intt", (x,))
        return self._inv_merged(x)
