#!/usr/bin/env python3
"""The low-frequency error of the hybrid key switch, measured on the host.

A key-switch digit of a group g of sub-primes comes out of the fast base
extension (crypto/ops._ks_digits_from_coeffs) as
    D = sum_t y_t * (Qg / q_t),   y_t in [0, q_t),
an integer in [0, |g|*Qg) whose mean, |g|*Qg/2, is the same in every
coefficient. The key's error e enters the switched ciphertext as D*e/P,
so that mean adds (|g|*Qg/2P) * u(X)*e(X), with u = 1 + X + ... + X^(N-1).
That polynomial is low-frequency: it decodes into the slots whose roots
lie near 1, slot 0 most, at about (|g|*Qg/2P) * (2N/pi) * sigma*sqrt(N)
over the scale. With alpha = 1 a group is one sub-prime, Qg/P ~ 2^-90,
and the term vanishes; with alpha = n_key (the default) Qg is close to
P. At a 30-bit scale and N = 32768 this puts an error of ~1e-2 into
slot 0 of every relinearized value. The numpy and torch backends and
the card's kernels make the same digits, and so does eva_tpu (the
port's crypto/ is a copy of it).

Centring the digits removes it: D - floor(|g|/2)*Qg is a multiple of Qg
away from D, so it keeps D's residues mod the group's primes and the
switch stays exact (the extra term is a multiple of P*Q). This script
applies that centring to the port's host key switch, inside
`centred_digits()` only, and measures, with the port's digits and with
the centred ones:

  switch    one rescale-relinearize of a product at the context of
            chip_smoke.py's fuzz program 8 (seed 0xC0DA), level 1, scale
            2^30: the key switch's error polynomial (coefficient mean
            and std) and its decoded error in slot 0 against the std of
            the other slots, for alpha 1 and alpha n_key, over
            --switches key sets;
  program   that program, as chip_smoke.py's fuzz phase runs it (its
            route and alpha), end to end on the numpy backend: the
            decrypted MSE against the plaintext over --draws fresh key
            sets per digit form (the fuzz phase fails at MSE >= 0.01)
            and runtime/noise.py's predicted slot error.

Host only (the numpy backend); imports nothing of JAX and nothing of
eva_tpu. Prints one JSON line.

Run:  python3 tools/ks_digit_bias.py [--draws 20] [--switches 3]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools"), os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# chip_smoke.py's FUZZ_SEED, and the program of it whose decrypted MSE
# crosses the fuzz phase's limit in some key draws.
FUZZ_SEED = 0xC0DA
PROGRAM = 8
SWITCH_LEVEL = 1
SWITCH_SCALE_BITS = 30


@contextlib.contextmanager
def centred_digits():
    """Within the block, the port's host key switch (crypto.ops, which
    the numpy backend runs) takes each digit of a group g less
    floor(|g|/2)*Qg, Qg the product of the group's alive sub-primes."""
    from eva_tpu_torch.crypto import ops
    port = ops._ks_digits_from_coeffs

    def centred(ctx, coeffs, level, alpha=1):
        digits = port(ctx, coeffs, level, alpha)
        primes = ctx.primes_at_level(level)
        basis = primes + ctx.key_primes
        groups, _, _ = ctx.ks_tables(level, alpha)
        qv = np.array(basis, dtype=np.uint64)[:, None]
        # The digits are NTT'd: a shift of every coefficient by c is a
        # shift by c * NTT(1 + X + ... + X^(N-1)).
        ones = ctx.ntt(np.ones((len(basis), ctx.n), dtype=np.uint64), basis)
        out = []
        for group, d in zip(groups, digits):
            shift = (len(group) // 2) * math.prod(primes[t] for t in group)
            c = np.array([shift % q for q in basis], dtype=np.uint64)[:, None]
            out.append((d + qv - c * ones % qv) % qv)
        return out

    ops._ks_digits_from_coeffs = centred
    try:
        yield
    finally:
        ops._ks_digits_from_coeffs = port


def switch_error(ctx, keys, level: int, values, scale: float) -> dict:
    """The error one rescale-relinearize adds: values encrypted at `level`
    and `scale`, squared, then rescaled with and without the switch (the
    rescale rounds c0 and c1 the same way in both). Returns the error
    polynomial's coefficient mean and std, and its decoded error in slot
    0 beside the std over the other slots and the slot of the largest."""
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.crypto import ops

    ct = K.encrypt(ctx, keys, values, scale, level)
    product = ops.multiply(ctx, ct, ct)
    three = ops.rescale(ctx, product)
    two = ops.rescale_relinearize(ctx, keys, product)
    primes = ctx.primes_at_level(three.level)
    s = keys.secret.rows(ctx, primes)
    s2 = ctx.mul(s, s, primes)
    with_switch = ctx.add(two.polys[0], ctx.mul(two.polys[1], s, primes),
                          primes)
    without = ctx.add(ctx.add(three.polys[0],
                              ctx.mul(three.polys[1], s, primes), primes),
                      ctx.mul(three.polys[2], s2, primes), primes)
    coeffs = ctx.encoder.residues_to_coeffs(
        ctx.intt(ctx.sub(with_switch, without, primes), primes), primes)
    slots = K.decrypt(ctx, keys, two) - K.decrypt(ctx, keys, three)
    return {"coeff_mean": float(coeffs.mean()),
            "coeff_std": float(coeffs.std()),
            "slot0": float(slots[0]),
            "other_slots_std": float(slots[1:].std()),
            "worst_slot": int(np.argmax(np.abs(slots)))}


def _summary(values):
    values = sorted(values)
    return {"median": statistics.median(values), "max": values[-1],
            "min": values[0]}


def measure_switch(ctx, n_key: int, switches: int) -> list:
    from eva_tpu_torch.crypto import keys as K
    rng = np.random.default_rng(FUZZ_SEED)
    values = rng.uniform(-1, 1, ctx.n // 2)
    rows = []
    for alpha in sorted({1, n_key}):
        for draw in range(switches):
            keys = K.generate_keys(ctx, alpha=alpha)
            port = switch_error(ctx, keys, SWITCH_LEVEL, values,
                                2.0 ** SWITCH_SCALE_BITS)
            with centred_digits():
                centred = switch_error(ctx, keys, SWITCH_LEVEL, values,
                                       2.0 ** SWITCH_SCALE_BITS)
            rows.append({"alpha": alpha, "draw": draw, "port": port,
                         "centred": centred})
    return rows


def measure_program(case, draws: int) -> dict:
    from eva_tpu_torch import evaluate
    from eva_tpu_torch.metric import valuation_mse
    from eva_tpu_torch.runtime import generate_keys
    from eva_tpu_torch.runtime.noise import estimate_noise
    from fuzz_cuda import MSE_LIMIT
    from torch_random_programs import environment

    test, prog, (program, params, sig), inputs, env, config = case
    reference = evaluate(prog, inputs)
    with environment(env):
        estimate = estimate_noise(program, params, sig, inputs)
    forms = {"port": contextlib.nullcontext, "centred": centred_digits}
    out = {name: [] for name in forms}
    alpha = None
    for _ in range(draws):
        for name, form in forms.items():
            with environment(env), form():
                pub, sec = generate_keys(params, backend="numpy")
                enc = pub.encrypt(inputs, sig)
                decrypted = sec.decrypt(pub.execute(program, enc), sig)
            alpha = pub._keys.ks_alpha
            out[name].append(valuation_mse(decrypted, reference))
    result = {"test": test, "env": env, "rescaler": config["rescaler"],
              "alpha": alpha, "mse_limit": MSE_LIMIT,
              "estimated_slot_error_std": {
                  k: v["slot_error_std"] for k, v in estimate.items()}}
    for name, mse in out.items():
        result[name] = {"draws": len(mse), "mse": _summary(mse),
                        "over_limit": sum(m >= MSE_LIMIT for m in mse),
                        "mse_each": mse}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=20)
    parser.add_argument("--switches", type=int, default=3)
    args = parser.parse_args(argv)

    import fuzz_cuda
    from eva_tpu_torch.crypto.context import get_context

    t0 = time.perf_counter()
    for case in fuzz_cuda.random_cases(PROGRAM + 1, FUZZ_SEED):
        pass
    params = case[2][1]
    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree, params.key_terms)
    n_key = len(ctx.key_primes)
    line = {
        "context": {"N": ctx.n, "prime_bits": list(ctx.prime_bits),
                    "n_key": n_key, "level": SWITCH_LEVEL,
                    "scale_bits": SWITCH_SCALE_BITS},
        "switch": measure_switch(ctx, n_key, args.switches),
        "program": measure_program(case, args.draws),
    }
    line["s"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
