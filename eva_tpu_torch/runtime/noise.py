"""Noise-budget estimation for compiled programs.

Predicts the decrypted slot-error standard deviation per output BEFORE
running any encryption, by propagating a CKKS noise model through the
compiled graph alongside plaintext value magnitudes (from the reference
executor). Useful for choosing input scales / output ranges: if the
predicted error is near the application tolerance, raise the scales.

Model (coefficient-domain standard deviations, sigma = 3.2 ternary-secret
RLWE):
  fresh encrypt   sigma_f = sigma * sqrt(1 + 4N/3)   (e0 + u*e_pk + s*e1)
  encode          hypot(0.289, fft_float_term)       (see encode_sigma)
  add/sub         quadrature sum
  ct x ct         |v1|*n2 + |v2|*n1 (+ n1*n2 ignored)
  ct x plain      |p|*n1 + |v1|*rounding
  rescale         n/q + 0.5*sqrt(1 + 2N/3)           (divide + round through s)
  key switch      ~sqrt(2N/3)                        (P-division rounding * s)
Slot error = coeff std * sqrt(N) / true_scale."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from ..ir import CONSTANT_VALUE, Op, Program, Type
from ..reference import ReferenceExecutor
from ..traversal import ProgramTraversal
from .executor import Executor

SIGMA = 3.2

# Measured float64-FFT/decode relative-error coefficient: round-trip slot
# error floors at ~C*sqrt(log2 N) relative to the value magnitude
# (2.4e-16 at N=2048 .. 3.2e-16 at N=32768, tests/test_crypto.py
# TestEncoderPrecision). The Garner decode folds the TOP 53 bits of the
# centered coefficient, so the float path's error stays RELATIVE at any
# scale — it never blows up, it just stops shrinking with 1/scale.
EPS_FFT = 8e-17


def encode_sigma(n: int, scale: float, value_rms: float = 1.0) -> float:
    """Per-coefficient encode/decode error std: quantization rounding
    (+-0.5 -> 0.289) in quadrature with the float64 FFT/Garner term
    (relative floor ~EPS_FFT*sqrt(log2 N) on slot values, expressed
    here in coefficient units so slot error = sigma * sqrt(N)/scale).

    Precision envelope (measured): slot error = max(0.29*sqrt(N)/scale,
    ~3e-16 * |value|). The 0.01 MSE gate is therefore reachable by
    UNDER-scaling (scale < ~2^15 at N=16384) but never by over-scaling:
    scales up to 2^90 round-trip at ~3e-16 relative error."""
    fft = EPS_FFT * math.sqrt(math.log2(n)) * scale * value_rms \
        / math.sqrt(n)
    return math.hypot(0.2887, fft)


def estimate_noise(compiled: Program, params, signature,
                   inputs: Dict[str, Sequence[float]] = None
                   ) -> Dict[str, dict]:
    """Per-output predicted slot-error std and headroom report.

    `inputs` supplies value magnitudes (defaults to all-ones at vec_size);
    no keys or encryption are involved."""
    from ..crypto.context import get_context

    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree,
                      getattr(params, "key_terms", 1))
    n = ctx.n
    if inputs is None:
        inputs = {name: [1.0] * compiled.vec_size
                  for name in compiled.inputs}

    # Value magnitudes from the plaintext reference.
    ref = ReferenceExecutor(compiled)
    ref.set_inputs(inputs)
    ProgramTraversal(compiled).forward_pass(ref)

    # Levels/true scales from the execution plan (keys not needed).
    planner = Executor.__new__(Executor)
    planner.program = compiled
    planner.ctx = ctx
    planner.keys = None
    planner.backend = "numpy"
    from ..passes import TypeDeducer
    from ..ir import TermMap
    planner.types = TermMap(Type.Undef)
    ProgramTraversal(compiled).forward_pass(TypeDeducer(compiled, planner.types))
    planner.order = compiled.topological_order()
    planner.plan = {}
    planner._torch_program = None
    planner._encode_cache = {}
    planner._input_free = {}
    planner._make_plan()

    sigma_fresh = SIGMA * math.sqrt(1 + 4 * n / 3)
    sigma_ks = math.sqrt(2 * n / 3) * 0.5
    noise: Dict[int, float] = {}

    def sigma_keyswitch(level: int) -> float:
        """P-division rounding plus the hybrid-digit term: with grouped
        digits D_j ~ uniform[0, a_j*Qg_j), sum_j D_j*e_j / P contributes
        sigma * sqrt(N/3 * sum_j (a_j*Qg_j/P)^2) per coefficient (for
        alpha=1 digits q_t/P ~ 2^-29 makes this negligible)."""
        from ..crypto.keys import default_ks_alpha
        alpha = default_ks_alpha(ctx)
        P = ctx.key_product
        groups, _, _ = ctx.ks_tables(level, alpha)
        primes = ctx.primes_at_level(level)
        s = 0.0
        for g in groups:
            qg = 1.0
            for t in g:
                qg *= primes[t]
            s += (len(g) * qg / P) ** 2
        digit_term = SIGMA * math.sqrt(n / 3 * s)
        return math.hypot(sigma_ks, digit_term)

    def rms(term):
        try:
            return float(np.sqrt(np.mean(np.asarray(ref.terms.at(term)) ** 2)))
        except KeyError:
            return 1.0

    def encoded_l2(term):
        """L2 norm of the term's ENCODED polynomial: by Parseval
        ||m||_2 = scale * rms(slot values)."""
        plan = planner.plan.get(term.index)
        scale = plan.scale if plan else 1.0
        return scale * rms(term)

    for term in planner.order:
        if planner.types[term] == Type.Raw or term.index not in planner.plan:
            continue
        op = term.op
        args = term.operands
        if op == Op.Input:
            if planner.types[term] == Type.Cipher:
                noise[term.index] = sigma_fresh
            else:
                plan = planner.plan.get(term.index)
                noise[term.index] = encode_sigma(
                    n, plan.scale if plan else 1.0, rms(term))
        elif op == Op.Encode:
            plan = planner.plan.get(term.index)
            noise[term.index] = encode_sigma(
                n, plan.scale if plan else 1.0, rms(term))
        elif op in (Op.Add, Op.Sub):
            ns = [noise.get(o.index, 0.0) for o in args]
            noise[term.index] = math.hypot(*ns)
        elif op == Op.Mul:
            # Polynomial product: each operand's noise convolves with the
            # partner's FIXED encoded polynomial, so per-coefficient
            # sigma(e1 * m2) = n1 * ||m2||_2 (no extra sqrt(N)).
            n1 = noise.get(args[0].index, 0.0)
            n2 = noise.get(args[1].index, 0.0)
            noise[term.index] = math.hypot(
                n1 * encoded_l2(args[1]), n2 * encoded_l2(args[0]))
        elif op == Op.Rescale:
            q = ctx.entries_at_level(planner.plan[args[0].index].level)[-1].product
            noise[term.index] = math.hypot(noise.get(args[0].index, 0.0) / q,
                                           sigma_ks)
        elif op in (Op.RotateLeftConst, Op.RotateRightConst, Op.Relinearize):
            noise[term.index] = math.hypot(
                noise.get(args[0].index, 0.0),
                sigma_keyswitch(planner.plan[args[0].index].level))
        else:  # ModSwitch, Negate, Output
            noise[term.index] = noise.get(args[0].index, 0.0)

    report = {}
    for name, term in compiled.outputs.items():
        if term.index not in planner.plan:
            report[name] = {"slot_error_std": 0.0, "scale_bits": None,
                            "verdict": "raw"}
            continue
        plan = planner.plan[term.index]
        slot_err = noise[term.index] * math.sqrt(n) / plan.scale
        report[name] = {
            "slot_error_std": slot_err,
            "scale_bits": math.log2(plan.scale),
            "level": plan.level,
            "verdict": ("ok" if slot_err < 1e-3 else
                        "marginal" if slot_err < 0.1 else "insufficient"),
        }
    return report
