"""Key generation, encryption, decryption.

Replaces seal::KeyGenerator / Encryptor / Decryptor (reference call sites
eva/seal/seal.cpp:174-203, 24-102, 124-146).

Secret key: uniform ternary. Errors: centered gaussian sigma=3.2 rounded.
Randomness is seeded from the OS CSPRNG (`secrets`) — never from JAX's
PRNG (keys are host-side secrets; SURVEY.md §7 hard part 6).

Key-switching keys use per-abstract-entry gadget digits with the key
entry (last abstract prime) as the hybrid special modulus P, mirroring
SEAL's one-special-prime design at the abstract level while each digit
and P decompose into machine sub-primes underneath."""

from __future__ import annotations

import hashlib
import os
import secrets
import struct
from typing import Dict, List, Sequence

import numpy as np

from .ciphertext import Ciphertext, Plaintext
from .context import CKKSContext

ERROR_STDDEV = 3.2

# Wire-format XOF identifiers (serialized with every seeded object).
XOF_PCG64 = 0     # legacy: NumPy Generator(PCG64) stream (round 1-3 files)
XOF_SHAKE128 = 1  # SHAKE-128 per-row streams with rejection sampling
_XOF_NAMES = {"pcg64": XOF_PCG64, "shake128": XOF_SHAKE128}


def default_xof() -> int:
    """XOF used for newly generated seeds: EVA_TPU_XOF, default shake128.

    pcg64 exists only to reproduce pre-round-4 artifacts; its stream
    depends on NumPy's PCG64 stability guarantee, while SHAKE-128 is
    defined by FIPS 202 and identical across library versions by
    construction (SURVEY.md §7 hard part 6)."""
    name = os.environ.get("EVA_TPU_XOF", "shake128")
    if name not in _XOF_NAMES:
        raise ValueError(f"Unknown EVA_TPU_XOF {name!r}; "
                         f"choose from {sorted(_XOF_NAMES)}")
    return _XOF_NAMES[name]


def _rng() -> np.random.Generator:
    return np.random.default_rng(secrets.randbits(128))


def _small_poly_residues(ctx: CKKSContext, coeffs: np.ndarray,
                         primes: Sequence[int]) -> np.ndarray:
    """Signed small coefficients -> NTT-domain residue planes."""
    out = np.empty((len(primes), ctx.n), dtype=np.uint64)
    for i, q in enumerate(primes):
        out[i] = (coeffs % q).astype(np.uint64)
    return ctx.ntt(out, list(primes))


class SecretKey:
    def __init__(self, ctx: CKKSContext, coeffs: np.ndarray):
        self.coeffs = coeffs  # ternary int64 [N]
        # NTT residues over the full basis (data + key primes).
        self.s = _small_poly_residues(ctx, coeffs, ctx.all_primes)

    def rows(self, ctx: CKKSContext, primes: List[int]) -> np.ndarray:
        idx = [ctx.all_primes.index(q) for q in primes]
        return self.s[idx]


class PublicKey:
    def __init__(self, b: np.ndarray, a: np.ndarray, a_seed: bytes = None,
                 xof: int = XOF_SHAKE128):
        self.b = b  # [n_data, N] NTT
        self.a = a
        self.a_seed = a_seed  # regenerates `a` via expand_uniform
        self.xof = xof        # XOF id the seed expands under


class KSwitchKey:
    """One key per gadget digit: pairs (k0_j, k1_j) over data+key basis.

    `alpha` is the decomposition group size the key was generated for
    (data sub-primes per digit); the runtime must decompose with the
    same grouping, so it travels with the key material."""

    def __init__(self, k0: List[np.ndarray], k1: List[np.ndarray],
                 k1_seeds: List[bytes] = None, alpha: int = 1,
                 xof: int = XOF_SHAKE128):
        self.k0 = k0  # per digit: [n_all, N] NTT
        self.k1 = k1
        self.k1_seeds = k1_seeds  # per digit seeds regenerating k1
        self.alpha = alpha
        self.xof = xof            # XOF id the seeds expand under


class KeySet:
    def __init__(self, ctx: CKKSContext, secret: SecretKey, public: PublicKey,
                 relin: KSwitchKey, galois: Dict[int, KSwitchKey]):
        self.ctx = ctx
        self.secret = secret
        self.public = public
        self.relin = relin
        self.galois = galois  # galois element -> key

    @property
    def ks_alpha(self) -> int:
        if self.relin is not None:
            return self.relin.alpha
        for k in self.galois.values():
            return k.alpha
        return 1


def _sample_error(ctx: CKKSContext, rng) -> np.ndarray:
    return np.rint(rng.normal(0.0, ERROR_STDDEV, ctx.n)).astype(np.int64)


def _sample_ternary(ctx: CKKSContext, rng) -> np.ndarray:
    return rng.integers(-1, 2, ctx.n, dtype=np.int64)


def _shake_row(seed: bytes, row: int, q: int, n: int,
               _nbytes0: int = None) -> np.ndarray:
    """One uniform residue row from a SHAKE-128 stream, domain-separated
    by row index. Rejection-samples 32-bit words below the largest
    multiple of q so residues are exactly uniform in [0, q). SHAKE
    digests are prefix-consistent across lengths, so growing the buffer
    on a rejection shortfall never changes already-accepted values —
    the output is independent of the starting buffer size (_nbytes0
    exists only so tests can force the growth path)."""
    h = hashlib.shake_128(seed + b"EVA-TPU-XOF1" + struct.pack("<I", row))
    limit = ((1 << 32) // q) * q
    nbytes = _nbytes0 or 4 * (int(n * (1 << 32) / limit * 1.03) + 64)
    while True:
        words = np.frombuffer(h.digest(nbytes), dtype="<u4")
        kept = words[words < limit]
        if len(kept) >= n:
            return (kept[:n] % np.uint32(q)).astype(np.uint64)
        nbytes *= 2


def _expand_rows(n: int, primes: Sequence[int], seed: bytes, xof: int,
                 row0: int = 0) -> np.ndarray:
    """[len(primes), n] uniform residues from `seed` under XOF `xof`.
    `row0` offsets the SHAKE row domain (for multi-shard expansion)."""
    out = np.empty((len(primes), n), dtype=np.uint64)
    if xof == XOF_PCG64:
        rng = np.random.default_rng(np.frombuffer(seed, dtype=np.uint64))
        for i, q in enumerate(primes):
            out[i] = rng.integers(0, q, n, dtype=np.uint64)
    elif xof == XOF_SHAKE128:
        for i, q in enumerate(primes):
            out[i] = _shake_row(seed, row0 + i, q, n)
    else:
        raise ValueError(f"Unknown XOF id {xof}")
    return out


def expand_uniform(ctx: CKKSContext, primes: List[int], seed: bytes,
                   xof: int = None) -> np.ndarray:
    """Deterministically expand a seed into uniform NTT-domain residues.

    Used for the public `a` components of keys and seeded ciphertexts so
    they serialize as 32-byte seeds; the expansion is part of the wire
    format, and the XOF id travels with every serialized seed
    (docs/WIRE_FORMAT.md "Seed expansion")."""
    if xof is None:
        xof = default_xof()
    # uniform residues are uniform in either domain
    return _expand_rows(ctx.n, primes, seed, xof)


def _make_kswitch_key(ctx: CKKSContext, s: SecretKey, target_ntt: np.ndarray,
                      rng, alpha: int = 1, engine=None) -> KSwitchKey:
    """Encrypt P * g_j * target under s, one digit per GROUP of `alpha`
    consecutive data sub-primes (hybrid/"dnum" key switching).

    g_j = Qhat_j * [Qhat_j^-1 mod Q_j] over the FULL data basis is
    level-independent: at lower levels the digit is CRT-composed from the
    group's alive prefix only, which still satisfies D_j == x (mod q_i)
    for every alive q_i of the group — the only congruences the identity
    sum_j D_j * g_j == x (mod alive primes) requires, since q_i | Q_j and
    Qhat_{j'} == 0 (mod q_i) for j' != j. alpha=1 is the per-sub-prime
    scheme (digits < 2^31, decomposition is a raw row re-broadcast).
    target_ntt: [n_all, N] NTT-domain residues of the key being switched
    FROM (s^2 for relinearization, sigma_g(s) for rotations).

    All randomness is sampled here on the host (CSPRNG seeds + the shared
    error stream, one draw per digit in group order); `engine` only
    batches the deterministic arithmetic on device and is byte-identical
    to the host path (backend/keygen.DeviceKeygen)."""
    basis = ctx.all_primes
    P = ctx.key_product
    Q = 1
    for q in ctx.data_primes:
        Q *= q
    groups = ctx.ks_groups(alpha)
    xof = default_xof()
    k1_seeds, As, Es = [], [], []
    facs = np.empty((len(groups), len(basis)), dtype=np.uint64)
    for j, group in enumerate(groups):
        Q_j = 1
        for t in group:
            Q_j *= ctx.data_primes[t]
        Qhat = Q // Q_j
        g_j = Qhat * pow(Qhat % Q_j, -1, Q_j)
        factor = P * g_j
        facs[j] = [factor % q for q in basis]
        a_seed = secrets.token_bytes(32)
        k1_seeds.append(a_seed)
        As.append(expand_uniform(ctx, basis, a_seed, xof))
        Es.append(_sample_error(ctx, rng))
    k0, k1 = _ksk_compute(ctx, s.s, target_ntt, As, Es, facs, engine)
    return KSwitchKey(k0, k1, k1_seeds, alpha=alpha, xof=xof)


def _ksk_compute(ctx: CKKSContext, s_rows: np.ndarray, target_ntt: np.ndarray,
                 As, Es, facs: np.ndarray, engine=None):
    """b_j = fac_j * target - a_j * s + NTT(e_j) for every digit j.
    Host numpy loop, or batched on device when an engine is given —
    exact modular arithmetic either way, so the outputs are
    byte-identical (tested in tests/test_crypto.py)."""
    if engine is not None:
        return engine.ksk_compute(s_rows, target_ntt, As, Es, facs)
    basis = ctx.all_primes
    k0, k1 = [], []
    for a, e, fac in zip(As, Es, facs):
        e_ntt = _small_poly_residues(ctx, e, basis)
        f = np.broadcast_to(fac[:, None], target_ntt.shape)
        b = ctx.add(
            ctx.sub(ctx.mul(f, target_ntt, basis),
                    ctx.mul(a, s_rows, basis), basis),
            e_ntt, basis)
        k0.append(b)
        k1.append(a)
    return k0, k1


def default_ks_alpha(ctx: CKKSContext = None) -> int:
    """Decomposition group size: EVA_TPU_KS_ALPHA, default = the number
    of key sub-primes (2 for the standard one-entry special modulus,
    4 under the compiler's two_entry_ks option).

    Packing alpha sub-primes per digit divides the key-switch NTT and
    MAC work by alpha (fewer digits over the same extended basis) at
    the cost of a larger rounding term — but ks_groups caps every digit
    product at ~2P, so the Q_j/P noise ratio stays bounded regardless:
    matching alpha to the key sub-prime count simply packs digits up to
    the size P can suppress. Measured round-5: alpha>len(key_primes)
    degenerates to the same grouping (the 2P cap binds first)."""
    import os
    env = os.environ.get("EVA_TPU_KS_ALPHA")
    if env:
        return max(1, int(env))
    return len(ctx.key_primes) if ctx is not None else 2


def generate_keys(ctx: CKKSContext, alpha: int = None,
                  engine=None) -> KeySet:
    """engine=None: host numpy. An engine (backend/keygen.DeviceKeygen)
    batches the per-digit KSK arithmetic on device — byte-identical key
    material."""
    if alpha is None:
        alpha = default_ks_alpha(ctx)
    rng = _rng()
    s = SecretKey(ctx, _sample_ternary(ctx, rng))

    # Public key over the data basis.
    pk_seed = secrets.token_bytes(32)
    xof = default_xof()
    a = expand_uniform(ctx, ctx.data_primes, pk_seed, xof)
    e = _small_poly_residues(ctx, _sample_error(ctx, rng), ctx.data_primes)
    qv = ctx.qvec(ctx.data_primes)
    s_data = s.rows(ctx, ctx.data_primes)
    b = (qv - (a * s_data) % qv + e) % qv
    public = PublicKey(b, a, pk_seed, xof=xof)

    # Relinearization key: s^2 -> s.
    s2 = (s.s * s.s) % ctx.qvec(ctx.all_primes)
    relin = _make_kswitch_key(ctx, s, s2, rng, alpha, engine)

    # Galois keys, one per rotation step.
    galois: Dict[int, KSwitchKey] = {}
    for step in ctx.rotations:
        g = ctx.galois_elt(step)
        if g in galois:
            continue
        s_g = ctx.apply_automorphism(s.s, g)
        galois[g] = _make_kswitch_key(ctx, s, s_g, rng, alpha, engine)
    return KeySet(ctx, s, public, relin, galois)


# -- encrypt / decrypt -------------------------------------------------------


def encrypt(ctx: CKKSContext, keys: KeySet, values: Sequence[float],
            scale: float, level: int) -> Ciphertext:
    pt = encode(ctx, values, scale, level)
    return encrypt_plain(ctx, keys, pt)


def encode(ctx: CKKSContext, values: Sequence[float], scale: float,
           level: int, ext_primes: Sequence[int] = None) -> Plaintext:
    """Encode at `scale`, `level`. Vectors shorter than the slot count are
    replicated to fill the slots; vectors LARGER than the slot count are
    sharded round-robin across k = len/slots polynomials (crypto/bigvec
    layout: logical slot s -> shard s mod k, position s div k), returned
    as a [k, n_sub, N] plane stack.

    `ext_primes` (normally ctx.key_primes) additionally reduces the SAME
    rounded integer coefficients into those primes and attaches the NTT
    planes as Plaintext.ext — the extended-basis form the rotation-sum
    baby-step fusion multiplies key-switch accumulators by. Ignored for
    sharded big vectors (fusion is gated off at k > 1)."""
    slots = ctx.n // 2
    v = np.asarray(values, dtype=np.float64)
    primes = ctx.primes_at_level(level)
    if len(v) > slots:
        assert len(v) % slots == 0, "vector size must be a slot-count multiple"
        k = len(v) // slots
        planes = np.empty((k, len(primes), ctx.n), dtype=np.uint64)
        for j in range(k):
            coeffs = ctx.encoder.values_to_coeffs(v[j::k], scale)
            planes[j] = ctx.ntt(
                ctx.encoder.coeffs_to_residues(coeffs, primes), primes)
        return Plaintext(planes, level, float(scale))
    if len(v) != slots:
        assert slots % len(v) == 0, "vector size must divide slot count"
        v = np.tile(v, slots // len(v))
    coeffs = ctx.encoder.values_to_coeffs(v, scale)
    residues = ctx.encoder.coeffs_to_residues(coeffs, primes)
    ext = None
    if ext_primes:
        ext = ctx.ntt(ctx.encoder.coeffs_to_residues(coeffs, list(ext_primes)),
                      list(ext_primes))
    return Plaintext(ctx.ntt(residues, primes), level, float(scale), ext=ext)


def encrypt_plain(ctx: CKKSContext, keys: KeySet, pt: Plaintext) -> Ciphertext:
    if pt.poly.ndim == 3:  # sharded big vector: fresh randomness per shard
        parts = [encrypt_plain(ctx, keys,
                               Plaintext(pt.poly[j], pt.level, pt.scale))
                 for j in range(pt.poly.shape[0])]
        return Ciphertext([np.stack([p.polys[i] for p in parts])
                           for i in range(2)], pt.level, pt.scale)
    rng = _rng()
    primes = ctx.primes_at_level(pt.level)
    n_sub = len(primes)
    u = _small_poly_residues(ctx, _sample_ternary(ctx, rng), primes)
    e0 = _small_poly_residues(ctx, _sample_error(ctx, rng), primes)
    e1 = _small_poly_residues(ctx, _sample_error(ctx, rng), primes)
    b = keys.public.b[:n_sub]
    a = keys.public.a[:n_sub]
    c0 = ctx.add(ctx.add(ctx.mul(b, u, primes), e0, primes), pt.poly, primes)
    c1 = ctx.add(ctx.mul(a, u, primes), e1, primes)
    return Ciphertext([c0, c1], pt.level, pt.scale)


def expand_seeded_c1(ctx: CKKSContext, seed: bytes, level: int,
                     shards: int = 1, xof: int = None) -> np.ndarray:
    """Uniform c1 component for seeded ciphertexts at `level`. For sharded
    big-vector ciphertexts, one seed expands all k shard planes from a
    single deterministic stream — sequential PCG64 draws in the legacy
    XOF, shard-offset SHAKE row domains otherwise (part of the wire
    format)."""
    if xof is None:
        xof = default_xof()
    primes = ctx.primes_at_level(level)
    if shards == 1:
        return expand_uniform(ctx, primes, seed, xof)
    if xof == XOF_PCG64:
        rng = np.random.default_rng(np.frombuffer(seed, dtype=np.uint64))
        out = np.empty((shards, len(primes), ctx.n), dtype=np.uint64)
        for j in range(shards):
            for i, q in enumerate(primes):
                out[j, i] = rng.integers(0, q, ctx.n, dtype=np.uint64)
        return out
    return np.stack([_expand_rows(ctx.n, primes, seed, xof,
                                  row0=j * len(primes))
                     for j in range(shards)])


def encrypt_symmetric(ctx: CKKSContext, keys: KeySet, values, scale: float,
                      level: int) -> Ciphertext:
    """Secret-key encryption with a seeded uniform c1: the ciphertext
    serializes as (c0, seed) — half the size of a public-key ciphertext.
    Only the key holder can produce these (client-role encryption)."""
    pt = encode(ctx, values, scale, level)
    rng = _rng()
    seed = secrets.token_bytes(32)
    xof = default_xof()
    primes = ctx.primes_at_level(level)
    shards = pt.poly.shape[0] if pt.poly.ndim == 3 else 1
    c1 = expand_seeded_c1(ctx, seed, level, shards, xof)
    err = [_sample_error(ctx, rng) for _ in range(shards)]
    if pt.poly.ndim == 3:
        e = np.stack([_small_poly_residues(ctx, ei, primes) for ei in err])
    else:
        e = _small_poly_residues(ctx, err[0], primes)
    s_rows = keys.secret.rows(ctx, primes)
    # c0 = -c1*s + e + m  so that c0 + c1*s = m + e.
    c0 = ctx.add(ctx.sub(e, ctx.mul(c1, s_rows, primes), primes),
                 pt.poly, primes)
    return Ciphertext([c0, c1], level, pt.scale, seed=seed, seed_xof=xof)


def decrypt(ctx: CKKSContext, keys: KeySet, ct: Ciphertext) -> np.ndarray:
    """Decrypt and decode to float slot values: length N/2, or k*N/2 with
    shards interleaved back into logical order for big vectors."""
    primes = ctx.primes_at_level(ct.level)
    if ct.polys[0].ndim == 3:
        k = ct.polys[0].shape[0]
        out = np.empty(k * (ctx.n // 2), dtype=np.float64)
        for j in range(k):
            shard = Ciphertext([p[j] for p in ct.polys], ct.level, ct.scale)
            out[j::k] = decrypt(ctx, keys, shard)
        return out
    s_rows = keys.secret.rows(ctx, primes)
    acc = ct.polys[0].copy()
    s_pow = s_rows
    for c in ct.polys[1:]:
        acc = ctx.add(acc, ctx.mul(c, s_pow, primes), primes)
        s_pow = ctx.mul(s_pow, s_rows, primes)
    coeffs_res = ctx.intt(acc, primes)
    coeffs = ctx.encoder.residues_to_coeffs(coeffs_res, primes)
    return ctx.encoder.coeffs_to_values(coeffs, ct.scale)
