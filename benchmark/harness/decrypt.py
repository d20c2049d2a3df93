"""The benchmark's own CKKS decryption, in plain NumPy, so that the check
turns the port's output ciphertexts into numbers without the port's
decryptor, transforms, CRT or decoder.

What it takes from the port is only what a client holds: the secret
key's ternary coefficients and each output ciphertext's residues, level
primes and scale. It checks each prime before use (prime, below 2^31,
1 mod 2N).

Conventions it follows, those of the scheme's wire format (the port's
`crypto/ntt.py` and `crypto/encoder.py` document them):
  * residues are stored in the evaluation domain, bit-reversed:
    entry j holds m(psi^(2*rev(j)+1)) mod q, psi = g^((q-1)/2N) for the
    smallest g >= 2 for which that has order exactly 2N;
  * slot j of a decoded vector is Re m(zeta^(5^j mod 2N)) / scale with
    zeta = exp(i*pi/N).
The transforms here are a natural-order radix-2 DFT over Z_q, written
apart from the port's."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def check_prime(q: int, n: int) -> None:
    if not (q < 2 ** 31 and is_prime(q) and (q - 1) % (2 * n) == 0):
        raise ValueError(f"decrypt: {q} is not an NTT prime below 2^31 "
                         f"for N={n}")


def psi_of(q: int, n: int) -> int:
    """The scheme's primitive 2N-th root of unity mod q."""
    cof = (q - 1) // (2 * n)
    for g in range(2, 10000):
        root = pow(g, cof, q)
        if pow(root, n, q) == q - 1:
            return root
    raise ValueError(f"no primitive {2 * n}-th root mod {q}")


@lru_cache(maxsize=None)
def bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(w: int, m: int, q: int) -> np.ndarray:
    """[w^0, ..., w^(m-1)] mod q (q < 2^31, so products fit uint64)."""
    out = np.ones(1, dtype=np.uint64)
    while len(out) < m:
        step = np.uint64(pow(w, len(out), q))
        out = np.concatenate([out, out * step % np.uint64(q)])
    return out[:m]


@lru_cache(maxsize=None)
def _tables(q: int, n: int):
    """(twist psi^i, untwist n^-1 psi^-i, stage twiddles forward and
    inverse) for prime q."""
    check_prime(q, n)
    psi = psi_of(q, n)
    psi_inv = pow(psi, q - 2, q)
    w, w_inv = psi * psi % q, pow(psi * psi % q, q - 2, q)
    twist = _powers(psi, n, q)
    untwist = _powers(psi_inv, n, q) * np.uint64(pow(n, q - 2, q)) % np.uint64(q)
    fwd, inv = [], []
    m = 1
    while m < n:
        fwd.append(_powers(pow(w, n // (2 * m), q), m, q))
        inv.append(_powers(pow(w_inv, n // (2 * m), q), m, q))
        m *= 2
    return twist, untwist, fwd, inv


def _dft(a: np.ndarray, q: int, stages) -> np.ndarray:
    """A[k] = sum_i a[i] w^(ik) mod q, natural order in and out
    (iterative decimation in time)."""
    n = a.shape[-1]
    qq = np.uint64(q)
    x = a[..., bitrev(n)].astype(np.uint64)
    m = 1
    for tw in stages:
        blocks = x.reshape(x.shape[:-1] + (n // (2 * m), 2, m))
        u = blocks[..., 0, :]
        v = blocks[..., 1, :] * tw % qq
        x = np.stack([(u + v) % qq, (u + qq - v) % qq], axis=-2)
        x = x.reshape(a.shape)
        m *= 2
    return x


def to_eval(coeffs: np.ndarray, q: int) -> np.ndarray:
    """Small signed coefficients -> the stored (bit-reversed) evaluations
    mod q."""
    n = coeffs.shape[-1]
    twist, _, fwd, _ = _tables(q, n)
    a = (np.asarray(coeffs, dtype=np.int64) % q).astype(np.uint64)
    nat = _dft(a * twist % np.uint64(q), q, fwd)
    return nat[..., bitrev(n)]


def to_coeffs(evals: np.ndarray, q: int) -> np.ndarray:
    """Stored (bit-reversed) evaluations mod q -> coefficients mod q."""
    n = evals.shape[-1]
    _, untwist, _, inv = _tables(q, n)
    nat = np.asarray(evals, dtype=np.uint64)[..., bitrev(n)]
    return _dft(nat, q, inv) * untwist % np.uint64(q)


def crt_centered(residues: Sequence[np.ndarray], primes: Sequence[int]) -> np.ndarray:
    """Coefficients from their residues, centered in (-M/2, M/2], as
    float64."""
    M = 1
    for q in primes:
        M *= q
    x = np.zeros(len(residues[0]), dtype=object)
    for r, q in zip(residues, primes):
        Mq = M // q
        x = x + r.astype(object) * (Mq * pow(Mq % q, -1, q))
    x = x % M
    x = np.where(x > M // 2, x - M, x)
    return x.astype(np.float64)


def decode(coeffs: np.ndarray, scale: float, count: int) -> np.ndarray:
    """The first `count` slot values of real coefficients."""
    n = len(coeffs)
    zeta_i = np.exp(1j * np.pi * np.arange(n) / n)
    evals = n * np.fft.ifft(coeffs * zeta_i)  # m(zeta^(2k+1)) at k
    g = np.empty(count, dtype=np.int64)
    p = 1
    for j in range(count):
        g[j] = p
        p = p * 5 % (2 * n)
    return np.real(evals[(g - 1) // 2]) / scale


class Decryptor:
    """Decrypts ciphertexts under one secret key (ternary coefficients)."""

    def __init__(self, secret_coeffs: np.ndarray):
        self.s = np.asarray(secret_coeffs, dtype=np.int64)
        self.n = len(self.s)
        self._s_eval: dict = {}

    def _s(self, q: int) -> np.ndarray:
        if q not in self._s_eval:
            self._s_eval[q] = to_eval(self.s, q)
        return self._s_eval[q]

    def decrypt(self, polys: Sequence[np.ndarray], primes: Sequence[int],
                scale: float, count: int) -> np.ndarray:
        """Slot values of a ciphertext (c0, c1, ...) whose planes are
        [len(primes), N] stored evaluations."""
        res = []
        for i, q in enumerate(primes):
            qq = np.uint64(q)
            s = self._s(q)
            acc = np.asarray(polys[0][i], dtype=np.uint64) % qq
            s_pow = s
            for c in polys[1:]:
                acc = (acc + np.asarray(c[i], dtype=np.uint64) % qq
                       * s_pow) % qq
                s_pow = s_pow * s % qq
            res.append(to_coeffs(acc, q))
        return decode(crt_centered(res, primes), scale, count)
