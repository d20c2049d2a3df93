"""Fused hybrid key switch: the digit MAC and the P-division epilogue.

Port of eva_tpu/backend/pallas_ks.py. Two functions on tensors:

  ks_mac:      per batch element b and extended-basis row i, over the
               digit groups j: fast base extension of digit j's row i
               from y, its forward NTT (or, for a digit's own data rows,
               the given x_ntt row), Montgomery multiplication by the two
               key rows, and modular accumulation -> acc0, acc1
               [B, n_ext, N].
  ks_epilogue: inverse NTT of both accumulators, divide-and-round by each
               key prime (the last first), optional forward NTT of the
               n_out surviving rows -> d0, d1 [B, n_out, N].

Both dispatch on the tensors' device: a CUDA tensor goes through the
hand-written kernels (ks_cuda, csrc/ks.cu) or raises; a CPU tensor goes
through the plain PyTorch versions below (ks_mac_plain,
ks_epilogue_plain), which follow the Pallas kernel bodies. Residues are
int32 tensors of uint32 bits (backend/modmath.py); the plain versions
widen them once to int64, compute, and narrow the results. Every step is
exact modular arithmetic, so the two agree bit for bit with each other
and with the structured key switch of executor_torch (digits, MAC
against the structured key layout, iNTT + P-division + NTT).

divide_last, the rescale's divide-and-round by the last k primes of 1-3
polynomials at once (with an optional addend), dispatches the same way:
the CUDA kernel E3 (modmath_cuda.divide_last, csrc/modmath.cu) or its
plain version here; divide_last_planes is its one-prime, one-polynomial
case, the JAX package's divide_last_planes."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import modmath as M
from .modmath import _add, _mont, _sub, narrow, widen
from .tables import DeviceLevelOps, level_ops

# Calls of the plain versions (a CPU tensor reached ks_mac/ks_epilogue).
# A run on the card that went through the kernels leaves these at 0.
PLAIN_CALLS = {"ks_mac": 0, "ks_epilogue": 0}

# The epilogue kernel keeps one value per key prime in registers.
MAX_KEY_PRIMES = 8


def _pinv_mont(p: int, rest: List[int]) -> np.ndarray:
    """[len(rest), 1] p^-1 mod q_i in Montgomery form (uint32)."""
    out = np.empty((len(rest), 1), dtype=np.uint32)
    for i, q in enumerate(rest):
        inv = pow(p % q, q - 2, q)
        out[i, 0] = (inv << 32) % q
    return out


def _divide_last64(x, p: int, pinv_mont, q, rinv):
    """divide_last_planes on widened (int64) planes and tables."""
    lift = x[..., -1, :]  # [..., N] standard residues < p
    # One expression: the unreduced sum stays below 2^32.
    r = _mont(x[..., :-1, :] + (p - lift)[..., None, :], pinv_mont, q, rinv)
    # When lift <= p/2 we computed (x - lift + p)/p = want + 1.
    corr = (lift <= (p // 2)).to(torch.int64)[..., None, :]
    return _sub(r, corr, q)


def divide_last(xs, primes: List[int], k: int, dev: DeviceLevelOps,
                addends=None) -> list:
    """Divide-and-round each of the 1-3 coefficient planes xs [..., n, N]
    (n = len(primes); plus its addend, added mod q first, where `addends`
    gives one) by its last k primes, the last first -> [..., n - k, N]:
    the JAX package's divide_last_planes looped k times per polynomial
    (the fused relinearize-rescale adds the key-switch output just
    before). `dev` is the level-ops instance for primes[:-1]. One E3
    launch on a CUDA tensor; the plain version on a CPU tensor."""
    xs = list(xs)
    if xs[0].is_cuda:
        from .modmath_cuda import divide_last as kernel
        return kernel([x.contiguous() for x in xs],
                      _pinv_chain(dev, primes, k), primes[::-1][:k], dev,
                      None if addends is None else
                      [None if a is None else a.contiguous()
                       for a in addends])
    for t in xs + [a for a in addends or () if a is not None]:
        _check_cpu(t, "divide_last")
    return divide_last_plain(xs, primes, k, dev, addends)


def divide_last_planes(coeffs, primes: List[int], dev: DeviceLevelOps):
    """Divide-and-round coefficient planes by the last prime.

    r_i = (x_i - centered([x]_p)) / p  mod q_i, computed as
    mont_mul(x_i + p - lift, p^-1) minus 1 when lift was not centered
    up (x_i + p - lift < 2^32 always). `dev` is the level-ops instance
    for primes[:-1]. divide_last of one polynomial by one prime."""
    return divide_last([coeffs], primes, 1, dev)[0]


def _pinv_const(dev: DeviceLevelOps, p: int) -> torch.Tensor:
    """p^-1 R mod each prime of `dev`, [n, 1] int32 on its device."""
    return dev.const(("pinv", p), lambda: _pinv_mont(p, dev.primes))


def _pinv_chain(dev: DeviceLevelOps, primes: List[int], k: int):
    """[k, n - 1] int32 on the device of `dev` (primes[:-1]): row s holds
    p_s^-1 R mod q_i for p_s = primes[n - 1 - s] and i < n - 1 - s, zeros
    past (the primes E3's step s divides by and the rows it leaves)."""
    def build():
        n = len(primes)
        out = np.zeros((k, n - 1), dtype=np.uint32)
        for s in range(k):
            m = n - 1 - s
            out[s, :m] = _pinv_mont(primes[m], primes[:m])[:, 0]
        return out
    return dev.const(("pinv_chain", tuple(primes), k), build)


def divide_last_plain(xs, primes: List[int], k: int, dev: DeviceLevelOps,
                      addends=None) -> list:
    """Plain PyTorch version of the CUDA kernel E3 (divide_last): each
    polynomial (plus its addend) divided by one prime at a time, k times,
    as the JAX package loops divide_last_planes; int32 in and out, on any
    device."""
    M.PLAIN_CALLS["divide_last"] += 1
    n = len(primes)
    q, rinv = widen(dev.q), widen(dev.rinv)
    tab = widen(_pinv_chain(dev, primes, k))
    q_all = widen(dev.const(("and", primes[-1]), lambda: np.array(
        dev.primes + [primes[-1]], dtype=np.uint64).reshape(-1, 1)))
    addends = [None] * len(xs) if addends is None else list(addends)
    outs = []
    for x, add in zip(xs, addends):
        x = widen(x)
        if add is not None:
            x = _add(x, widen(add), q_all)
        for s in range(k):
            m = n - 1 - s
            x = _divide_last64(x, primes[m], tab[s, :m, None], q[:m],
                               rinv[:m])
        outs.append(narrow(x))
    return outs


def _check_cpu(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 residues, got {x.dtype}")


def ks_mac(y, k0, k1, conv, owner, ext_ops: DeviceLevelOps, x_ntt=None):
    """The key switch's MAC (see ks_mac_plain for the arguments): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if y.is_cuda:
        from .ks_cuda import ks_mac as kernel
        return kernel(y, k0, k1, conv, owner, ext_ops, x_ntt)
    _check_cpu(y, "ks_mac")
    return ks_mac_plain(y, k0, k1, conv, owner, ext_ops, x_ntt)


def ks_epilogue(acc0, acc1, ext_ops: DeviceLevelOps, n_key: int,
                out_ntt: bool):
    """The key switch's P-division (see ks_epilogue_plain): the CUDA
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if acc0.is_cuda:
        from .ks_cuda import ks_epilogue as kernel
        return kernel(acc0, acc1, ext_ops, n_key, out_ntt)
    _check_cpu(acc0, "ks_epilogue")
    return ks_epilogue_plain(acc0, acc1, ext_ops, n_key, out_ntt)


def ks_mac_plain(y, k0, k1, conv, owner, ext_ops: DeviceLevelOps,
                 x_ntt=None):
    """Plain PyTorch version of the MAC kernel (Pallas `_mac_kernel`).

    y:      [B, n_groups, alpha, N] int32, y_t = d_t * (Qg_t/q_t)^-1 mod
            q_t per data prime t, zero rows past n_cur
    k0, k1: [n_groups, n_ext, N] int32 key rows, Montgomery form
            (DeviceKeys.dense_layout)
    conv:   [n_groups * alpha, n_ext] int32 (Qg_t/q_t) mod basis[i],
            Montgomery form of basis[i]
    owner:  [n_ext] int64 digit group owning data row i; -1 for key rows
    x_ntt:  optional [B, n_cur, N] int32 NTT planes of the switched
            polynomial, read for a digit's own rows instead of the FBE +
            NTT (equal values: the FBE representative differs from the
            digit by multiples of Qg_j, which vanish mod the own primes)
    Returns acc0, acc1 [B, n_ext, N] int32."""
    PLAIN_CALLS["ks_mac"] += 1
    n_groups, alpha = y.shape[1], y.shape[2]
    q, rinv = widen(ext_ops.q), widen(ext_ops.rinv)
    y, k0, k1, conv = (widen(t) for t in (y, k0, k1, conv))
    if x_ntt is not None:
        x_ntt = widen(x_ntt)
    acc0 = acc1 = None
    for j in range(n_groups):
        d = None
        for k in range(alpha):
            t = _mont(y[:, j, k, None, :], conv[j * alpha + k][:, None],
                      q, rinv)
            d = t if d is None else _add(d, t, q)
        row = ext_ops._fwd64(d)
        if x_ntt is not None:
            n_cur = x_ntt.shape[-2]
            own = (owner[:n_cur] == j)[:, None]
            row = torch.cat([torch.where(own, x_ntt, row[:, :n_cur]),
                             row[:, n_cur:]], dim=1)
        m0 = _mont(row, k0[j], q, rinv)
        m1 = _mont(row, k1[j], q, rinv)
        acc0 = m0 if acc0 is None else _add(acc0, m0, q)
        acc1 = m1 if acc1 is None else _add(acc1, m1, q)
    return narrow(acc0), narrow(acc1)


def ks_epilogue_plain(acc0, acc1, ext_ops: DeviceLevelOps, n_key: int,
                      out_ntt: bool):
    """Plain PyTorch version of the epilogue kernel (Pallas
    `_epilogue_kernel`): acc0, acc1 [B, n_ext, N] int32 in the NTT domain
    -> d0, d1 [B, n_out, N] int32, n_out = n_ext - n_key, in the NTT
    domain of the output primes with out_ntt, else coefficients."""
    PLAIN_CALLS["ks_epilogue"] += 1
    primes, n, device = ext_ops.primes, ext_ops.n, ext_ops.device

    def one(acc):
        x = ext_ops._inv64(widen(acc))
        prim = list(primes)
        for _ in range(n_key):
            rest = level_ops(prim[:-1], n, device)
            x = _divide_last64(x, prim[-1], widen(_pinv_const(rest, prim[-1])),
                               widen(rest.q), widen(rest.rinv))
            prim = prim[:-1]
        if out_ntt:
            x = level_ops(prim, n, device)._fwd64(x)
        return narrow(x)

    return one(acc0), one(acc1)
