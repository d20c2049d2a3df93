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
ks_epilogue_plain), which follow the Pallas kernel bodies. Every step is
exact modular arithmetic, so the two agree bit for bit with each other
and with the structured key switch of executor_torch (digits, MAC
against the structured key layout, iNTT + P-division + NTT)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .modmath import add_mod, mont_mul
from .tables import DeviceLevelOps, level_ops

# Calls of the plain versions (a CPU tensor reached ks_mac/ks_epilogue).
# A run on the card that went through the kernels leaves these at 0.
PLAIN_CALLS = {"ks_mac": 0, "ks_epilogue": 0}

# The epilogue kernel keeps one value per key prime in registers.
MAX_KEY_PRIMES = 8


def divide_last_planes(coeffs, primes: List[int], dev: DeviceLevelOps):
    """Divide-and-round coefficient planes by the last prime.

    r_i = (x_i - centered([x]_p)) / p  mod q_i, computed as
    mont_mul(x_i + p - lift, p^-1) minus 1 when lift was not centered
    up (x_i + p - lift < 2^32 always). `dev` is the level-ops instance
    for primes[:-1]."""
    p = primes[-1]
    rest = primes[:-1]
    lift = coeffs[..., -1, :]  # [..., N] standard residues < p

    def pinv():
        out = np.empty((len(rest), 1), dtype=np.uint32)
        for i, q in enumerate(rest):
            inv = pow(p % q, q - 2, q)
            out[i, 0] = (inv << 32) % q
        return out

    pinv_mont = dev.const(("pinv", p), pinv)
    # One expression: the unreduced sum stays below 2^32.
    r = dev.mul_mont(coeffs[..., :-1, :] + (p - lift)[..., None, :],
                     pinv_mont)
    # When lift <= p/2 we computed (x - lift + p)/p = want + 1.
    corr = (lift <= (p // 2)).to(torch.int64)[..., None, :]
    return dev.sub(r, corr)


def _check_cpu(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")


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

    y:      [B, n_groups, alpha, N] int64, y_t = d_t * (Qg_t/q_t)^-1 mod
            q_t per data prime t, zero rows past n_cur
    k0, k1: [n_groups, n_ext, N] int64 key rows, Montgomery form
            (DeviceKeys.dense_layout)
    conv:   [n_groups * alpha, n_ext] int64 (Qg_t/q_t) mod basis[i],
            Montgomery form of basis[i]
    owner:  [n_ext] int64 digit group owning data row i; -1 for key rows
    x_ntt:  optional [B, n_cur, N] NTT planes of the switched polynomial,
            read for a digit's own rows instead of the FBE + NTT (equal
            values: the FBE representative differs from the digit by
            multiples of Qg_j, which vanish mod the own primes)
    Returns acc0, acc1 [B, n_ext, N] int64."""
    PLAIN_CALLS["ks_mac"] += 1
    n_groups, alpha = y.shape[1], y.shape[2]
    q, rinv = ext_ops.q, ext_ops.rinv
    acc0 = acc1 = None
    for j in range(n_groups):
        d = None
        for k in range(alpha):
            t = mont_mul(y[:, j, k, None, :], conv[j * alpha + k][:, None],
                         q, rinv)
            d = t if d is None else add_mod(d, t, q)
        row = ext_ops._fwd_merged(d)
        if x_ntt is not None:
            n_cur = x_ntt.shape[-2]
            own = (owner[:n_cur] == j)[:, None]
            row = torch.cat([torch.where(own, x_ntt, row[:, :n_cur]),
                             row[:, n_cur:]], dim=1)
        m0 = mont_mul(row, k0[j], q, rinv)
        m1 = mont_mul(row, k1[j], q, rinv)
        acc0 = m0 if acc0 is None else add_mod(acc0, m0, q)
        acc1 = m1 if acc1 is None else add_mod(acc1, m1, q)
    return acc0, acc1


def ks_epilogue_plain(acc0, acc1, ext_ops: DeviceLevelOps, n_key: int,
                      out_ntt: bool):
    """Plain PyTorch version of the epilogue kernel (Pallas
    `_epilogue_kernel`): acc0, acc1 [B, n_ext, N] in the NTT domain ->
    d0, d1 [B, n_out, N], n_out = n_ext - n_key, in the NTT domain of the
    output primes with out_ntt, else coefficients."""
    PLAIN_CALLS["ks_epilogue"] += 1
    primes, n, device = ext_ops.primes, ext_ops.n, ext_ops.device

    def one(acc):
        x = ext_ops._inv_merged(acc)
        prim = list(primes)
        for _ in range(n_key):
            x = divide_last_planes(x, prim, level_ops(prim[:-1], n, device))
            prim = prim[:-1]
        return level_ops(prim, n, device)._fwd_merged(x) if out_ntt else x

    return one(acc0), one(acc1)
