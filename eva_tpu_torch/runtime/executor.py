"""Graph executor for compiled programs.

Replaces the reference's SEALExecutor (eva/seal/seal_executor.h:31-436):
a forward topological walk dispatching each term's op to ciphertext
kernels, with Raw subgraphs computed on plain doubles.

Two phases:
  1. PLAN (data-free): compute each term's level and TRUE scale. Plaintext
     encodes are scheduled at the exact scale their consumer needs
     (add partners take the cipher's true scale; see crypto/__init__
     docstring for why true-scale tracking replaces SEAL's forced-scale
     bookkeeping). At cipher+cipher additions with a small planned scale
     mismatch, the mismatch is back-propagated into the nearest upstream
     single-use plaintext multiplication, making the addition exact.
  2. EXECUTE: run the ops (numpy kernels here; the torch backend runs
     the same plan on a torch device — see eva_tpu_torch/backend)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..crypto import keys as K, ops as O
from ..crypto.ciphertext import Ciphertext, Plaintext
from ..crypto.context import CKKSContext
from ..ir import (CONSTANT_VALUE, ENCODE_AT_LEVEL, ENCODE_AT_SCALE, ROTATION,
                  Op, Program, Term, TermMap, Type)
from ..passes import TypeDeducer, rotation_hoist_sources
from ..tracing import span
from ..traversal import ProgramTraversal


class TermPlan:
    __slots__ = ("level", "scale")

    def __init__(self, level: int, scale: float):
        self.level = level
        self.scale = scale


class RotSum:
    """Deferred rotation-sum value (numpy backend): sigma(c0) plus the
    pre-division extended-basis key-switch accumulators of sigma(c1).
    Adds merge these exactly; any other consumer finalizes with ONE
    P-division — mirrors the torch backend's "rotsum" tuples bit-for-bit
    (modular adds are order-independent)."""

    __slots__ = ("level", "scale", "c0", "c1", "acc0", "acc1")

    def __init__(self, level, scale, c0, c1, acc0, acc1):
        self.level = level
        self.scale = scale
        self.c0 = c0
        self.c1 = c1  # None until a plain ciphertext is folded in
        self.acc0 = acc0
        self.acc1 = acc1


class Executor:
    def __init__(self, program: Program, ctx: CKKSContext, keys: K.KeySet,
                 backend: str = "torch", device=None):
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r}: choose 'torch' "
                             f"or 'numpy'")
        self.program = program
        self.ctx = ctx
        self.keys = keys
        self.backend = backend
        # torch backend: device=None means the CUDA device (raises if
        # there is none); the host-only numpy backend ignores it.
        if backend == "torch":
            from ..backend import resolve_device
            self.device = resolve_device(device)
        else:
            self.device = None
        self.types = TermMap(Type.Undef)
        ProgramTraversal(program).forward_pass(TypeDeducer(program, self.types))
        self.order = program.topological_order()
        self.plan: Dict[int, TermPlan] = {}
        self._torch_program = None
        self._encode_cache: Dict[int, object] = {}
        self._input_free: Dict[int, bool] = {}
        self._raw_needed = (None, set())  # (encode-cache size, terms)
        self._hoisted_sources = rotation_hoist_sources(self.order)
        import os
        self._rotsum_on = (program.vec_size <= ctx.n // 2 and
                           not os.environ.get("EVA_TPU_NO_ROTSUM_FUSION"))
        # Baby-step extension: Mul(rotation-sum, plaintext) stays in
        # deferred pre-division form when the plaintext carries
        # extended-basis planes (Plaintext.ext). EVA_TPU_NO_ROTMUL_FUSION
        # restores the round-4 behavior (finalize at every multiply).
        self._rotmul_on = (self._rotsum_on and
                           not os.environ.get("EVA_TPU_NO_ROTMUL_FUSION"))
        self._make_plan()
        self._ext_encodes = self._mark_ext_encodes()

    # -- planning ------------------------------------------------------------

    def _entry_product_at(self, level: int) -> int:
        return self.ctx.entries_at_level(level)[-1].product

    def _make_plan(self) -> None:
        plan = self.plan
        for term in self.order:
            op = term.op
            if self.types[term] == Type.Raw:
                continue
            if op == Op.Input:
                plan[term.index] = TermPlan(
                    term.get_attr(ENCODE_AT_LEVEL),
                    2.0 ** term.get_attr(ENCODE_AT_SCALE))
            elif op == Op.Encode:
                plan[term.index] = TermPlan(
                    term.get_attr(ENCODE_AT_LEVEL),
                    2.0 ** term.get_attr(ENCODE_AT_SCALE))
            elif op == Op.Constant:
                continue  # raw until encoded
            elif op == Op.Mul:
                p0 = plan[term.operands[0].index]
                p1 = plan[term.operands[1].index]
                plan[term.index] = TermPlan(p0.level, p0.scale * p1.scale)
            elif op in (Op.Add, Op.Sub):
                self._plan_addition(term)
            elif op == Op.Rescale:
                p0 = plan[term.operands[0].index]
                plan[term.index] = TermPlan(
                    p0.level + 1, p0.scale / self._entry_product_at(p0.level))
            elif op == Op.ModSwitch:
                p0 = plan[term.operands[0].index]
                plan[term.index] = TermPlan(p0.level + 1, p0.scale)
            else:  # Negate, rotations, Relinearize, Output
                p0 = plan[term.operands[0].index]
                plan[term.index] = TermPlan(p0.level, p0.scale)

    def _plan_addition(self, term: Term) -> None:
        plan = self.plan
        cipherish = [o for o in term.operands if self.types[o] != Type.Raw]
        # An Encode partner adopts the other operand's true scale exactly.
        for i, o in enumerate(term.operands):
            if o.op == Op.Encode and len(o.uses) == 1:
                other = term.operands[1 - i]
                if self.types[other] != Type.Raw:
                    plan[o.index].scale = plan[other.index].scale
        scales = [plan[o.index].scale for o in cipherish]
        level = plan[cipherish[0].index].level
        if len(scales) == 2 and scales[0] != scales[1]:
            ratio = scales[0] / scales[1]
            assert abs(math.log2(ratio)) < 0.5, (
                f"addition scale mismatch too large: {scales}")
            if not self._compensate(term.operands[1], ratio):
                if not self._compensate(term.operands[0], 1.0 / ratio):
                    from ..logging_util import warn
                    warn("true-scale mismatch %.3g at t%d %s could not be "
                         "compensated; expect relative error of that order "
                         "on this addition's result", abs(ratio - 1),
                         term.index, term.op.name)
        plan[term.index] = TermPlan(level, plan[cipherish[0].index].scale)

    def _compensate(self, term: Term, ratio: float) -> bool:
        """Scale `term`'s planned true scale by `ratio` by adjusting
        upstream single-use plaintext encodes. Walks single-use subtrees of
        scale-linear ops, descending through BOTH branches of additions
        (each branch must independently absorb the ratio). Two-phase:
        adjustments are gathered first and applied only if the whole
        subtree can be compensated."""
        adjustments: List[Term] = []
        if not self._gather_compensation(term, adjustments, depth=0):
            return False
        for t in adjustments:
            self.plan[t.index].scale *= ratio
        return True

    def _other_uses_unplanned(self, term: Term, child: Optional[Term]) -> bool:
        """A node may be rescaled in the plan if every consumer other than
        the path we arrived from has not been planned yet: later-planned
        consumers read the adjusted upstream scale, so the plan stays
        consistent. An already-planned consumer would be left stale."""
        for use in term.uses:
            if use is child:
                continue
            if use.index in self.plan:
                return False
        return True

    def _gather_compensation(self, term: Term, adjustments: List[Term],
                             depth: int, child: Optional[Term] = None) -> bool:
        if depth > 64:
            return False
        cur = term
        for _ in range(64):
            if not self._other_uses_unplanned(cur, child):
                return False
            adjustments.append(cur)
            if cur.op == Op.Mul:
                enc = None
                for o in cur.operands:
                    if o.op == Op.Encode and self._other_uses_unplanned(o, cur):
                        enc = o
                if enc is not None:
                    adjustments.append(enc)
                    return True
                nxt = [o for o in cur.operands if self.types[o] != Type.Raw]
                if len(nxt) == 1:
                    child, cur = cur, nxt[0]
                    continue
                # ct-ct multiply: scales multiply, so the ratio can be
                # absorbed through EITHER factor; try each transactionally.
                for o in nxt:
                    tmp: List[Term] = []
                    if self._gather_compensation(o, tmp, depth + 1, cur):
                        adjustments.extend(tmp)
                        return True
                return False
            elif cur.op in (Op.Rescale, Op.ModSwitch, Op.Relinearize, Op.Negate):
                child, cur = cur, cur.operands[0]
            elif cur.op in (Op.Add, Op.Sub):
                cipherish = [o for o in cur.operands
                             if self.types[o] != Type.Raw]
                return all(self._gather_compensation(o, adjustments,
                                                     depth + 1, cur)
                           for o in cipherish)
            elif cur.op == Op.Encode:
                # Additive plaintext partner: rescaling its encode scale
                # rescales the encoded value directly.
                return True
            else:
                return False
        return False

    def _mark_ext_encodes(self) -> set:
        """Encode terms whose plaintexts must carry extended-basis
        (key-prime) planes: exactly those an executor will multiply with
        a DEFERRED rotation sum (baby-step fusion).

        Marking is a PROFITABILITY decision, not a reflex: deferring
        rot*const products keeps inner sums in accumulator form, which
        WINS for direct convolutions (one epilogue per sum instead of
        one per rotation) but LOSES for BSGS-factorized programs — there
        the baby rotations are shared across giant groups, and deferral
        moves the P-division from the (few, shared) baby rotations to
        the (more numerous) per-giant inner sums. Both policies are
        simulated and the one with STRICTLY fewer finalization epilogues
        wins (ties prefer eager: at equal division counts the deferred
        multiply touches 2 extended-basis accumulator stacks instead of
        2 data-basis polynomials, and eager keeps lone rotations
        bit-identical to the unfused form). Reference anchor:
        examples/image_processing.py:36-58 conv taps; the BSGS shape is
        this repo's RotationNormalizer."""
        if not self._rotmul_on:
            return set()
        marked_a, fins_a = self._simulate_rotsum(defer_mul=True)
        _, fins_b = self._simulate_rotsum(defer_mul=False)
        return marked_a if fins_a < fins_b else set()

    def _simulate_rotsum(self, defer_mul: bool):
        """Structural simulation of the backends' identical runtime
        rotation-sum decisions — kinds: 'p' plain-from-Encode (ext
        attachable), 'pn' plain without ext, 'c2'/'c3' ciphertexts,
        'rs' deferred rotation sum. Finalization write-backs (_fin_at)
        are mirrored by mutating the kind in place, so multi-use
        decision points line up with both backends. Returns
        (marked encode indices, finalization-epilogue count)."""
        marked: set = set()
        fin_events = [0]
        kinds: Dict[int, str] = {}
        period = max(self.ctx.n // 2, self.program.vec_size)

        def fin(idx):
            if kinds.get(idx) == "rs":
                kinds[idx] = "c2"
                fin_events[0] += 1
            return kinds.get(idx, "c2")

        for term in self.order:
            op = term.op
            idx = term.index
            if self.types[term] == Type.Raw or op == Op.Constant:
                continue
            args = term.operands
            if op == Op.Input:
                kinds[idx] = "c2" if self.types[term] == Type.Cipher else "pn"
            elif op == Op.Encode:
                kinds[idx] = "p"
            elif op in (Op.RotateLeftConst, Op.RotateRightConst):
                fin(args[0].index)
                steps = term.get_attr(ROTATION)
                kinds[idx] = ("rs" if self._rotsum_on and steps % period != 0
                              else "c2")
            elif op == Op.Negate:
                kinds[idx] = kinds.get(args[0].index, "c2")  # rs stays rs
            elif op in (Op.Add, Op.Sub):
                ka = kinds.get(args[0].index, "c2")
                kb = kinds.get(args[1].index, "c2")
                if "rs" in (ka, kb):
                    other = kb if ka == "rs" else ka
                    if other in ("rs", "p", "pn", "c2"):
                        kinds[idx] = "rs"
                        continue
                    ka = fin(args[0].index)
                    kb = fin(args[1].index)
                kinds[idx] = "c3" if "c3" in (ka, kb) else (
                    "c2" if "c2" in (ka, kb) else "p")
            elif op == Op.Mul:
                ka = kinds.get(args[0].index, "c2")
                kb = kinds.get(args[1].index, "c2")
                if "rs" in (ka, kb):
                    other_t = args[1] if ka == "rs" else args[0]
                    other_k = kb if ka == "rs" else ka
                    if (defer_mul and other_k == "p"
                            and other_t.op == Op.Encode):
                        marked.add(other_t.index)
                        kinds[idx] = "rs"
                        continue
                    ka = fin(args[0].index)
                    kb = fin(args[1].index)
                if ka in ("p", "pn") or kb in ("p", "pn"):
                    kinds[idx] = ka if kb in ("p", "pn") else kb
                    if kinds[idx] in ("p", "pn"):  # plain*plain (raw-ish)
                        kinds[idx] = "p"
                else:
                    kinds[idx] = "c3"
            elif op == Op.Relinearize:
                fin(args[0].index)
                kinds[idx] = "c2"
            elif op == Op.ModSwitch:
                k0 = fin(args[0].index)
                kinds[idx] = "pn" if k0 in ("p", "pn") else k0
            elif op == Op.Rescale:
                kinds[idx] = fin(args[0].index)
            elif op == Op.Output:
                kinds[idx] = fin(args[0].index)
        return marked, fin_events[0]

    # -- execution -----------------------------------------------------------

    def run(self, inputs: Dict) -> Dict:
        if self.backend == "torch":
            return self._run_torch(inputs)
        return self._run_numpy(inputs)

    def _get_torch_program(self):
        if self._torch_program is None:
            from ..backend.executor_torch import TorchProgram
            self._torch_program = TorchProgram(
                self.program, self.ctx, self.keys, self.plan, self.types,
                self.order, self.device)
        return self._torch_program

    def _is_input_free(self, term) -> bool:
        """True when no Op.Input occurs in the term's operand cone (the
        term's value is identical across executions/batch elements)."""
        idx = term.index
        cached = self._input_free.get(idx)
        if cached is not None:
            return cached
        if term.op == Op.Input:
            result = False
        else:
            result = all(self._is_input_free(o) for o in term.operands)
        self._input_free[idx] = result
        return result

    def _require_torch(self, what: str) -> None:
        if self.backend != "torch":
            raise ValueError(f"{what} requires the torch backend")

    def run_batch(self, inputs_list, mesh=None):
        """Execute over a batch of valuations (torch backend only):
        host-phase each element, then one device pass over the stacked
        batch (one replay of the batch size's captured graph on the CUDA
        device). With a mesh (eva_tpu_torch.parallel.make_device_mesh),
        every rank calls with the same list, runs its shard and returns
        the whole list (TorchProgram.run_batched)."""
        self._require_torch("batched execution")
        pairs = [self._host_phase(inputs) for inputs in inputs_list]
        results = self._get_torch_program().run_batched(
            [p[0] for p in pairs], mesh=mesh)
        for b, (_, raw_vals) in enumerate(pairs):
            for name, t in self.program.outputs.items():
                if self.types[t] == Type.Raw:
                    results[b][name] = raw_vals[t.operands[0].index]
        return results

    def run_pipelined(self, inputs_iter, depth: int = 2):
        """Generator: one output dict per input valuation, in order,
        with host encode, device compute, and output fetch overlapped
        across consecutive executions (torch backend only)."""
        self._require_torch("pipelined execution")
        import collections

        raw_q: collections.deque = collections.deque()

        def hv_iter():
            for inputs in inputs_iter:
                hv, raws = self._host_phase(inputs)
                raw_q.append(raws)
                yield hv

        tp = self._get_torch_program()
        for outputs in tp.run_pipelined(hv_iter(), depth=depth):
            raw_vals = raw_q.popleft()
            for name, t in self.program.outputs.items():
                if self.types[t] == Type.Raw:
                    outputs[name] = raw_vals[t.operands[0].index]
            yield outputs

    def _raw_terms_needed(self) -> set:
        """Raw and Constant terms whose values `_host_phase` computes: the
        operand cones of the Raw outputs and of the Encodes that the
        encode cache does not hold. Once every constant-only encode is
        cached, the constants behind them are not expanded again (each
        expansion builds a vec_size list on the host)."""
        n_cached, needed = self._raw_needed
        if n_cached != len(self._encode_cache):
            stack = [t for t in self.program.outputs.values()
                     if self.types[t] == Type.Raw]
            stack += [t.operands[0] for t in self.order
                      if t.op == Op.Encode
                      and t.index not in self._encode_cache]
            needed = set()
            while stack:
                t = stack.pop()
                if t.index not in needed and (self.types[t] == Type.Raw
                                              or t.op == Op.Constant):
                    needed.add(t.index)
                    stack.extend(t.operands)
            self._raw_needed = (len(self._encode_cache), needed)
        return needed

    def _host_phase(self, inputs: Dict):
        """Compute Raw subgraphs and plaintext encodes on host; returns
        (host_values for the device program, raw term values)."""
        with span("eva.host_phase"):
            ctx = self.ctx
            vec_size = self.program.vec_size
            host_values: Dict[int, object] = {}
            raw_vals: Dict[int, object] = {}
            needed = self._raw_terms_needed()

            for name, term in self.program.inputs.items():
                if name not in inputs:
                    raise RuntimeError(f"Missing input {name}")
                v = inputs[name]
                if isinstance(v, Ciphertext):
                    p = self.plan[term.index]
                    while v.level < p.level:
                        v = O.mod_switch(ctx, v)
                    host_values[term.index] = v
                elif isinstance(v, Plaintext):
                    host_values[term.index] = v
                else:
                    raw_vals[term.index] = np.asarray(v, dtype=np.float64)

            for term in self.order:
                if term.op == Op.Input:
                    continue
                if ((self.types[term] == Type.Raw
                     or term.op == Op.Constant)
                        and term.index not in needed):
                    continue  # feeds only cached encodes
                if self.types[term] == Type.Raw:
                    raw_vals[term.index] = self._raw_op(term, raw_vals,
                                                        vec_size)
                elif term.op == Op.Constant:
                    raw_vals[term.index] = np.asarray(
                        term.get_attr(CONSTANT_VALUE).expand(vec_size))
                elif term.op == Op.Encode:
                    # Constant-only encodes are identical across executions
                    # and batch elements; cache them (host FFT encode is the
                    # slow host-side step).
                    if term.index in self._encode_cache:
                        host_values[term.index] = \
                            self._encode_cache[term.index]
                        continue
                    p = self.plan[term.index]
                    raw = np.asarray(raw_vals[term.operands[0].index],
                                     dtype=np.float64)
                    ext = term.index in self._ext_encodes
                    pt = K.encode(ctx, raw, p.scale, p.level,
                                  ext_primes=ctx.key_primes if ext else None)
                    host_values[term.index] = pt
                    if self._is_input_free(term):
                        self._encode_cache[term.index] = pt

            return host_values, raw_vals

    def _run_torch(self, inputs: Dict) -> Dict:
        """Host-compute Raw subgraphs and plaintext encodes, then hand the
        cipher DAG to the torch executor on the device."""
        host_values, raw_vals = self._host_phase(inputs)
        outputs = self._get_torch_program().run(host_values)

        for name, t in self.program.outputs.items():
            if self.types[t] == Type.Raw:
                outputs[name] = raw_vals[t.operands[0].index]
        return outputs

    def _fin(self, v):
        """Finalize a deferred RotSum to a Ciphertext (one P-division
        for however many rotations were merged into it)."""
        if not isinstance(v, RotSum):
            return v
        ctx = self.ctx
        primes = ctx.primes_at_level(v.level)
        d0 = O.ks_div(ctx, v.acc0, v.level)
        d1 = O.ks_div(ctx, v.acc1, v.level)
        c0 = ctx.add(v.c0, d0, primes)
        c1 = d1 if v.c1 is None else ctx.add(v.c1, d1, primes)
        return Ciphertext([c0, c1], v.level, v.scale)

    def _fin_at(self, values, idx):
        """Finalize values[idx] in place (multi-use rotsums pay one
        division; later consumers observe the finalized value at the
        same program positions as the torch backend)."""
        v = values[idx]
        f = self._fin(v)
        if f is not v:
            values[idx] = f
        return f

    def _rotsum_add(self, a, b, sub: bool = False):
        """Merge/fold for Add/Sub when at least one operand is a RotSum;
        None when the combination can't stay deferred (mirrors the torch
        backend's _rotsum_add exactly). Sub merging is sound for the
        same reason Add merging is: modular subs distribute over the
        accumulators, and round(-x/P) = -round(x/P) exactly (the
        centered divide-and-round is odd; odd primes, no ties)."""
        ctx = self.ctx
        if isinstance(a, RotSum) and isinstance(b, RotSum):
            if a.level != b.level:  # pragma: no cover - checker prevents
                return None
            primes = ctx.primes_at_level(a.level)
            basis = primes + ctx.key_primes
            f = ctx.sub if sub else ctx.add
            if b.c1 is None:
                c1 = a.c1
            elif a.c1 is None:
                c1 = ctx.neg(b.c1, primes) if sub else b.c1
            else:
                c1 = f(a.c1, b.c1, primes)
            return RotSum(a.level, a.scale,
                          f(a.c0, b.c0, primes), c1,
                          f(a.acc0, b.acc0, basis),
                          f(a.acc1, b.acc1, basis))
        if isinstance(b, RotSum):
            # a (+|-) rs: for Sub, negate every rs component and add.
            primes = ctx.primes_at_level(b.level)
            basis = primes + ctx.key_primes
            if sub:
                b = RotSum(b.level, b.scale, ctx.neg(b.c0, primes),
                           None if b.c1 is None else ctx.neg(b.c1, primes),
                           ctx.neg(b.acc0, basis), ctx.neg(b.acc1, basis))
            a, b = b, a
            sub = False
        primes = ctx.primes_at_level(a.level)
        f = ctx.sub if sub else ctx.add
        if isinstance(b, Plaintext):
            return RotSum(a.level, a.scale, f(a.c0, b.poly, primes),
                          a.c1, a.acc0, a.acc1)
        if isinstance(b, Ciphertext) and b.size == 2:
            if b.polys[1] is None:  # pragma: no cover - defensive
                return None
            if a.c1 is None:
                c1 = ctx.neg(b.polys[1], primes) if sub else b.polys[1]
            else:
                c1 = f(a.c1, b.polys[1], primes)
            return RotSum(a.level, a.scale,
                          f(a.c0, b.polys[0], primes), c1,
                          a.acc0, a.acc1)
        return None  # size-3 ciphertext: finalize and add normally

    def _rotsum_mul(self, a: RotSum, p: Plaintext):
        """Baby-step fusion: multiply a deferred rotation sum by a
        plaintext carrying extended-basis planes (Plaintext.ext). The
        multiply distributes over the pre-division accumulators — the
        product's single P-division rounding replaces the eager form's
        per-rotation roundings SCALED by the plaintext, so the fused
        value is (slightly) LESS noisy. Requires p.ext (key-prime NTT
        planes of the same integer coefficients; see crypto.keys.encode).
        Anchor: reference examples/image_processing.py:36-58 — conv taps
        are exactly rot(x, s)*w sums."""
        ctx = self.ctx
        primes = ctx.primes_at_level(a.level)
        basis = primes + ctx.key_primes
        full = np.concatenate([p.poly, p.ext], axis=-2)
        return RotSum(a.level, a.scale * p.scale,
                      ctx.mul(a.c0, p.poly, primes),
                      None if a.c1 is None else ctx.mul(a.c1, p.poly, primes),
                      ctx.mul(a.acc0, full, basis),
                      ctx.mul(a.acc1, full, basis))

    def _rotsum_neg(self, a: RotSum) -> RotSum:
        """Negate a deferred rotation sum in place of finalizing it —
        EXACTLY equal to negate-after-finalize (odd centered rounding)."""
        ctx = self.ctx
        primes = ctx.primes_at_level(a.level)
        basis = primes + ctx.key_primes
        return RotSum(a.level, a.scale, ctx.neg(a.c0, primes),
                      None if a.c1 is None else ctx.neg(a.c1, primes),
                      ctx.neg(a.acc0, basis), ctx.neg(a.acc1, basis))

    def _run_numpy(self, inputs: Dict) -> Dict:
        values: Dict[int, object] = {}
        hoist: Dict[int, object] = {}  # rotation digit cache per source term
        ctx, keys = self.ctx, self.keys
        vec_size = self.program.vec_size
        # Eager release (the reference's multicore free(); eva/seal/
        # seal_executor.h:406-418): drop values and hoisted digits once the
        # last use has executed.
        remaining: Dict[int, int] = {
            t.index: len(t.uses) for t in self.order}
        output_ids = {t.index for t in self.program.outputs.values()}
        # Nodes consumed by fused pairs, in both adjacency orders.
        fused_rescales = {
            t.operands[0].index for t in self.order
            if t.op == Op.Relinearize
            and t.operands[0].op == Op.Rescale
            and len(t.operands[0].uses) == 1}
        fused_relins = {
            t.operands[0].index for t in self.order
            if t.op == Op.Rescale
            and t.operands[0].op == Op.Relinearize
            and len(t.operands[0].uses) == 1}

        def consume(term):
            for o in term.operands:
                remaining[o.index] -= 1
                if remaining[o.index] <= 0 and o.index not in output_ids:
                    values.pop(o.index, None)
                    hoist.pop(o.index, None)

        for name, term in self.program.inputs.items():
            if name in inputs:
                values[term.index] = inputs[name]

        from ..logging_util import DEBUG, log, verbosity_at_least
        trace = verbosity_at_least(DEBUG)

        for term in self.order:
            op = term.op
            if trace:
                log(DEBUG, "EVA: Execute t%d = %s(%s)", term.index, op.name,
                    ",".join(f"t{o.index}" for o in term.operands))
            if op == Op.Input:
                if term.index not in values:
                    raise RuntimeError("Missing input for program")
                v = values[term.index]
                if isinstance(v, Ciphertext):
                    p = self.plan[term.index]
                    # Align levels in case the valuation was encrypted fresh.
                    while v.level < p.level:
                        v = O.mod_switch(ctx, v)
                    values[term.index] = v
                continue
            args = term.operands
            if self.types[term] == Type.Raw:
                values[term.index] = self._raw_op(term, values, vec_size)
                consume(term)
                continue
            if op == Op.Constant:
                values[term.index] = np.asarray(
                    term.get_attr(CONSTANT_VALUE).expand(vec_size))
                continue
            if op == Op.Encode:
                if term.index in self._encode_cache:
                    values[term.index] = self._encode_cache[term.index]
                    consume(term)
                    continue
                p = self.plan[term.index]
                raw = np.asarray(values[args[0].index], dtype=np.float64)
                values[term.index] = K.encode(
                    ctx, raw, p.scale, p.level,
                    ext_primes=(ctx.key_primes
                                if term.index in self._ext_encodes else None))
                if self._is_input_free(term):
                    self._encode_cache[term.index] = values[term.index]
                consume(term)
                continue
            if op in (Op.Add, Op.Sub, Op.Mul):
                values[term.index] = self._binop(term, values)
            elif op == Op.Negate:
                v = values[args[0].index]
                if isinstance(v, RotSum):
                    values[term.index] = self._rotsum_neg(v)
                else:
                    values[term.index] = O.negate(
                        ctx, self._fin_at(values, args[0].index))
            elif op in (Op.RotateLeftConst, Op.RotateRightConst):
                steps = term.get_attr(ROTATION)
                if op == Op.RotateRightConst:
                    steps = -steps
                src = args[0].index
                ct = self._fin_at(values, src)
                # Logical rotation period: slots for one ciphertext, the
                # full vector length for sharded big vectors.
                period = max(ctx.n // 2, vec_size)
                # Hoist only sources rotated >=2 times (same decision as
                # the torch backend, keeping results bit-identical); single
                # rotations permute-first inside O.rotate.
                if (steps % period != 0 and src not in hoist
                        and src in self._hoisted_sources):
                    hoist[src] = O.hoist_digits(ctx, ct, self.keys.ks_alpha)
                if (self._rotsum_on and steps % period != 0
                        and ct.size == 2 and ct.polys[0].ndim == 2):
                    # Deferred-division form (rotation-sum fusion);
                    # mirrors the torch backend's _rotate_acc.
                    c0, acc0, acc1 = O.rotate_acc(
                        ctx, keys, ct, steps,
                        hoisted_digits=hoist.get(src))
                    values[term.index] = RotSum(ct.level, ct.scale, c0,
                                                None, acc0, acc1)
                else:
                    values[term.index] = O.rotate(
                        ctx, keys, ct, steps, hoisted_digits=hoist.get(src))
            elif op == Op.Relinearize:
                v = self._fin_at(values, args[0].index)
                if term.index in fused_relins:
                    values[term.index] = v  # deferred into the Rescale
                elif args[0].index in fused_rescales:
                    values[term.index] = O.rescale_relinearize(ctx, keys, v)
                else:
                    values[term.index] = O.relinearize(ctx, keys, v)
            elif op == Op.ModSwitch:
                v = self._fin_at(values, args[0].index)
                if isinstance(v, Plaintext):
                    values[term.index] = O.mod_switch_plain(ctx, v)
                else:
                    values[term.index] = O.mod_switch(ctx, v)
            elif op == Op.Rescale:
                if term.index in fused_rescales:
                    # Deferred: the consuming Relinearize applies the fused
                    # rescale+relinearize on this node's INPUT.
                    values[term.index] = self._fin_at(values, args[0].index)
                elif args[0].index in fused_relins:
                    values[term.index] = O.relinearize_rescale(
                        ctx, keys, self._fin_at(values, args[0].index))
                else:
                    values[term.index] = O.rescale(
                        ctx, self._fin_at(values, args[0].index))
            elif op == Op.Output:
                values[term.index] = self._fin_at(values, args[0].index)
            else:
                raise RuntimeError(f"Unhandled op {op.name}")
            consume(term)

        return {name: self._fin_at(values, t.index)
                for name, t in self.program.outputs.items()}

    def _binop(self, term: Term, values: Dict):
        ctx = self.ctx
        a = values[term.operands[0].index]
        b = values[term.operands[1].index]
        op = term.op
        if isinstance(a, RotSum) or isinstance(b, RotSum):
            if op in (Op.Add, Op.Sub):
                merged = self._rotsum_add(a, b, sub=(op == Op.Sub))
                if merged is not None:
                    return merged
            elif op == Op.Mul:
                rs, other = (a, b) if isinstance(a, RotSum) else (b, a)
                if (not isinstance(other, RotSum)
                        and isinstance(other, Plaintext)
                        and other.ext is not None):
                    return self._rotsum_mul(rs, other)
            a = self._fin_at(values, term.operands[0].index)
            b = self._fin_at(values, term.operands[1].index)
        a_ct, b_ct = isinstance(a, Ciphertext), isinstance(b, Ciphertext)
        if a_ct and b_ct:
            same = term.operands[0] is term.operands[1]
            if op == Op.Add:
                return O.add(ctx, a, b)
            if op == Op.Sub:
                return O.sub(ctx, a, b)
            return O.square(ctx, a) if same else O.multiply(ctx, a, b)
        # cipher (+|-|*) plain
        if not a_ct and b_ct:
            if op == Op.Sub:
                raise RuntimeError("plain - cipher should have been lowered")
            a, b = b, a
        assert isinstance(b, Plaintext), (
            f"unencoded raw operand reached cipher op {op.name}")
        if op == Op.Add:
            return O.add_plain(ctx, a, b)
        if op == Op.Sub:
            return O.sub_plain(ctx, a, b)
        return O.multiply_plain(ctx, a, b)

    def _raw_op(self, term: Term, values: Dict, vec_size: int):
        op = term.op
        args = term.operands
        get = lambda i: np.asarray(values[args[i].index], dtype=np.float64)
        if op == Op.Constant:
            return np.asarray(term.get_attr(CONSTANT_VALUE).expand(vec_size))
        if op == Op.Add:
            return get(0) + get(1)
        if op == Op.Sub:
            return get(0) - get(1)
        if op == Op.Mul:
            return get(0) * get(1)
        if op == Op.Negate:
            return -get(0)
        if op == Op.RotateLeftConst:
            return np.roll(get(0), -term.get_attr(ROTATION))
        if op == Op.RotateRightConst:
            return np.roll(get(0), term.get_attr(ROTATION))
        if op == Op.Output:
            return values[args[0].index]
        raise RuntimeError(f"Unhandled raw op {op.name}")
