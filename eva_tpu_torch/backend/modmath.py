"""Modular arithmetic on 32-bit residues held in int32 torch tensors.

Port of eva_tpu/backend/modmath.py. The JAX package keeps every residue
plane as uint32; PyTorch's CPU build lacks uint32 arithmetic, comparison
and index_select, so the port holds the same bit patterns in int32
tensors: canonical residues (below q < 2^31) read the same either way,
and an unreduced value in [2^31, 2^32) (a divide-last sum, an alpha = 1
digit broadcast) reads as negative. Index tensors stay int64.

The host boundary (`upload`, `to_host`) moves uint32 bit patterns: numpy
uint64/uint32 residues go up through a uint32 view, and come back with
`.view(np.uint32)`, never a sign-extending cast.

On the card the elementwise ops are hand-written CUDA kernels
(csrc/modmath.cu via modmath_cuda; tables.DeviceLevelOps dispatches by
device). The functions here are their plain PyTorch versions: they widen
each operand to int64 (`widen`: x & 0xFFFFFFFF, the uint32 value),
compute exactly (primes are < 2^31, so every product of a value below
2^32 with a constant below q is below 2^63 and `%` is exact), and narrow
the canonical result back to int32. mont_mul and shoup_mul return the
canonical residue, which is what the 32-bit Montgomery and Shoup
reductions of the JAX package return for every input they accept
(a < 2^32, constant < q). `PLAIN_CALLS` counts the calls of the public
plain ops; the underscored int64 bodies serve the plain NTT and
key-switch versions, which widen once at entry.

The host precompute (Montgomery constants, Shoup pairs) stays numpy and
is unchanged. All helpers broadcast per-row constants: q and friends are
[n_sub, 1] tensors against [..., n_sub, N] data planes."""

from __future__ import annotations

import numpy as np
import torch

R_BITS = 32
MASK32 = 0xFFFFFFFF
# Dependent Montgomery multiplies a word in E4 (modmul_burn; the kernel's
# kBurnK).
BURN_K = 16

# Calls of the plain versions of the elementwise kernels (a CPU tensor
# reached an elementwise op). A run on the card that went through the
# kernels leaves these at 0.
PLAIN_CALLS = {"add": 0, "sub": 0, "neg": 0, "mul_mont": 0, "mul": 0,
               "shoup": 0, "multi": 0, "mac": 0, "tensor_product": 0,
               "divide_last": 0, "modmul_burn": 0}


# -- storage ------------------------------------------------------------------


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 residue bits -> their uint32 values as int64."""
    return x.to(torch.int64) & MASK32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> int32 tensors of their uint32 bits."""
    return x.to(torch.int32)


def upload(arr, device) -> torch.Tensor:
    """Host residues (numpy, uint64 or uint32 values below 2^32) -> an
    int32 tensor of their uint32 bit patterns on `device`."""
    a = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """An int32 residue tensor -> a uint64 numpy array of its uint32
    values (on the host)."""
    return t.cpu().numpy().view(np.uint32).astype(np.uint64)


# -- host precompute ---------------------------------------------------------


def mont_constants(q: int):
    """(nqinv, r1, r2): -q^-1 mod 2^32, R mod q, R^2 mod q."""
    r = 1 << R_BITS
    qinv = pow(q, -1, r)
    nqinv = (r - qinv) % r
    return np.uint32(nqinv), np.uint32(r % q), np.uint32(r * r % q)


def mont_rinv(q: int) -> int:
    """R^-1 mod q: the factor a Montgomery multiply divides out."""
    return pow(1 << R_BITS, -1, q)


def to_mont(x: np.ndarray, q: int) -> np.ndarray:
    """Host-side conversion into Montgomery form (numpy, exact)."""
    return ((x.astype(np.uint64) << np.uint64(32))
            % np.uint64(q)).astype(np.uint32)


def to_mont_rows(arr: np.ndarray, primes) -> np.ndarray:
    """Per-row Montgomery conversion for [n_sub, ...] residue planes."""
    out = np.empty(arr.shape, dtype=np.uint32)
    for i, q in enumerate(primes):
        out[i] = to_mont(arr[i], q)
    return out


def shoup_pair(w, q: int):
    """Host precompute: (w mod q, floor(w * 2^32 / q)) for shoup_mul."""
    w = np.asarray(w, dtype=np.uint64) % np.uint64(q)
    wp = (w << np.uint64(32)) // np.uint64(q)
    return w.astype(np.uint32), wp.astype(np.uint32)


def shoup_stack(w, q: int) -> np.ndarray:
    """[2, ...] stacked (w, w') Shoup pair table for the constant(s) w."""
    return np.stack(shoup_pair(w, q))


# -- int64 bodies (widened operands) ------------------------------------------


def _mont(a, b_mont, q, rinv):
    """a * b mod q, with b in Montgomery form (b_mont = b*R mod q < q).
    Valid for any 0 <= a < 2^32: a * b_mont < 2^63, and the canonical
    result a * b_mont * R^-1 mod q equals the 32-bit Montgomery
    reduction's."""
    return (a * b_mont % q) * rinv % q


def _shoup(a, w, q):
    """a * w mod q for a known constant w < q, any 0 <= a < 2^32. The
    kernels use the precomputed quotient w' = floor(w*2^32/q); the plain
    version needs only w, since a * w < 2^63."""
    return a * w % q


def _add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def _add_into(out, a, b, q):
    """out = _add(a, b, q) (widened), written into `out`: a + b
    - q, plus q where that is negative."""
    torch.add(a, b, out=out)
    out.sub_(q)
    out.add_((out >> 63).bitwise_and_(q))


def _sub_into(out, a, b, q):
    """out = _sub(a, b, q) (widened), written into `out`: a - b,
    plus q where that is negative."""
    torch.sub(a, b, out=out)
    out.add_((out >> 63).bitwise_and_(q))


def _neg(a, q):
    return torch.where(a == 0, a, q - a)


def _tensor_product(a0, a1, b0, b1, q, rinv, r2):
    """The Karatsuba tensor product of DeviceLevelOps.tensor_product on
    widened planes: 5 Montgomery multiplies."""
    a0m = _mont(a0, r2, q, rinv)  # a0*R mod q (Montgomery form)
    a1m = _mont(a1, r2, q, rinv)
    am_sum = _add(a0m, a1m, q)
    b_sum = _add(b0, b1, q)
    p0 = _mont(b0, a0m, q, rinv)        # a0*b0 mod q
    p2 = _mont(b1, a1m, q, rinv)        # a1*b1 mod q
    pm = _mont(b_sum, am_sum, q, rinv)  # (a0+a1)(b0+b1) mod q
    return p0, _sub(_sub(pm, p0, q), p2, q), p2


# -- plain versions of the elementwise kernels (int32 in and out) -------------


def add_mod(a, b, q):
    PLAIN_CALLS["add"] += 1
    return narrow(_add(widen(a), widen(b), widen(q)))


def sub_mod(a, b, q):
    PLAIN_CALLS["sub"] += 1
    return narrow(_sub(widen(a), widen(b), widen(q)))


def neg_mod(a, q):
    PLAIN_CALLS["neg"] += 1
    return narrow(_neg(widen(a), widen(q)))


def mont_mul(a, b_mont, q, rinv):
    """a * b mod q, b in Montgomery form; any a < 2^32 (see _mont)."""
    PLAIN_CALLS["mul_mont"] += 1
    return narrow(_mont(widen(a), widen(b_mont), widen(q), widen(rinv)))


def mul(a, b, q, rinv, r2):
    """a * b mod q, both standard: two Montgomery steps, the second by
    R^2 mod q (DeviceLevelOps.mul)."""
    PLAIN_CALLS["mul"] += 1
    q, rinv = widen(q), widen(rinv)
    return narrow(_mont(_mont(widen(a), widen(b), q, rinv), widen(r2), q,
                        rinv))


def shoup_mul(a, w, wp, q):
    """a * w mod q for a known constant w < q (wp = floor(w*2^32/q), read
    by the kernel only); any a < 2^32."""
    PLAIN_CALLS["shoup"] += 1
    return narrow(_shoup(widen(a), widen(w), widen(q)))


def _ew64(op: str, args, q, rinv):
    """E1's op `op` (modmath_cuda.OP_CODES) on widened operands: "mul"
    takes R^2 mod q as its third operand, "shoup" (w, wp)."""
    if op == "add":
        return _add(args[0], args[1], q)
    if op == "sub":
        return _sub(args[0], args[1], q)
    if op == "neg":
        return _neg(args[0], q)
    if op == "mul_mont":
        return _mont(args[0], args[1], q, rinv)
    if op == "mul":
        return _mont(_mont(args[0], args[1], q, rinv), args[2], q, rinv)
    if op == "shoup":
        return _shoup(args[0], args[1], q)
    raise ValueError(f"unknown elementwise op {op!r}")


def ew_planes(op: str, planes):
    """Plain version of E1's several-planes form: `op` on each plane
    (operands, q, rinv), q and rinv the [rows, 1] constants of that
    plane's rows. Counts as `op` for one plane (the single form), else
    as "multi"."""
    PLAIN_CALLS["multi" if len(planes) > 1 else op] += 1
    return [narrow(_ew64(op, [widen(t) for t in operands], widen(q),
                         widen(rinv))) for operands, q, rinv in planes]


def mont_mac(own, a, b, keys0, keys1, q, rinv):
    """Plain version of E1's MAC form (the structured key switch's inner
    product): for each key half (k_own, k_a, k_b), the data rows
    mont(own, k_own) + sum_j mont(a_j, k_a_j) and the key rows sum_j
    mont(b_j, k_b_j), stacked [..., n_cur + n_key, N]; q, rinv [n_ext, 1]
    of the extended basis. a (and k_a) is None for one digit group."""
    PLAIN_CALLS["mac"] += 1
    n_cur = own.shape[-2]
    q, rinv = widen(q), widen(rinv)
    qd, rd, qk, rk = q[:n_cur], rinv[:n_cur], q[n_cur:], rinv[n_cur:]
    own, b = widen(own), widen(b)
    a = None if a is None else widen(a)

    def half(k_own, k_a, k_b):
        data = _mont(own, widen(k_own), qd, rd)
        if a is not None:
            data = (data + _mont(a, widen(k_a), qd, rd).sum(-3)) % qd
        key = _mont(b, widen(k_b), qk, rk).sum(-3) % qk
        return narrow(torch.cat([data, key], dim=-2))

    return half(*keys0), half(*keys1)


def tensor_product(a0, a1, b0, b1, q, rinv, r2):
    """[d0, d1, d2] of the ciphertext tensor product (see
    _tensor_product)."""
    PLAIN_CALLS["tensor_product"] += 1
    out = _tensor_product(*(widen(t) for t in (a0, a1, b0, b1, q, rinv, r2)))
    return [narrow(t) for t in out]


def modmul_burn(a, q, rinv):
    """Plain version of E4 (modmath_cuda.modmul_burn): BURN_K chained
    Montgomery multiplies of a, by 3 and 5 in turn; any a < 2^32."""
    PLAIN_CALLS["modmul_burn"] += 1
    q, rinv = widen(q), widen(rinv)
    v = widen(a)
    for j in range(BURN_K):
        v = _mont(v, 5 if j % 2 else 3, q, rinv)
    return narrow(v)
