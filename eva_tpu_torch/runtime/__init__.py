"""Execution runtime: key generation, encryption contexts, and the graph
executor. Replaces the reference's eva/seal/ layer (SEALPublic/SEALSecret/
SEALValuation/generateKeys; reference eva/seal/seal.h:21-92).

`generate_keys(params)` returns (EVAPublic, EVASecret). EVAPublic encrypts
inputs and executes compiled programs; EVASecret decrypts outputs. The
`backend` argument selects the execution engine: "torch" (the default:
the PyTorch compute path on `device`, by default the CUDA device) or
"numpy" (exact host reference)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..ckks.params import CKKSParameters, CKKSSignature
from ..ir import Type
from ..crypto import keys as _keys
from ..crypto.ciphertext import Ciphertext, Plaintext
from ..crypto.context import CKKSContext, get_context
from .executor import Executor

__all__ = ["generate_keys", "EVAPublic", "EVASecret", "EVAValuation"]

# Host-side encryption thread-pool cap; eva_tpu_torch.set_num_threads sets it.
HOST_THREADS = 8


class EVAValuation(dict):
    """Named bundle of encrypted/plain/raw values plus its parameters."""

    def __init__(self, params: CKKSParameters, values: Dict = None):
        super().__init__(values or {})
        self.params = params


def _check_backend(backend) -> None:
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown backend {backend!r}: choose 'torch' or "
                         f"'numpy'")


def _check_params(mine: CKKSParameters, val, where: str) -> None:
    """Reject a valuation produced under different encryption parameters
    before it reaches the executor/decryptor — the analog of the
    reference's context-checked loads
    (eva/serialization/seal_serialization.cpp:86-103), surfaced at use
    time since our load() has no ambient context to check against."""
    theirs = getattr(val, "params", None)
    if theirs is None or theirs == mine:
        return
    diffs = []
    for field in ("poly_modulus_degree", "prime_bits", "rotations",
                  "key_terms"):
        a, b = getattr(mine, field, 1), getattr(theirs, field, 1)
        if list(np.atleast_1d(a)) != list(np.atleast_1d(b)):
            diffs.append(f"{field} {list(np.atleast_1d(b))} != "
                         f"{list(np.atleast_1d(a))}")
    raise RuntimeError(
        f"Parameter mismatch in {where}: the valuation was produced under "
        f"different encryption parameters ({'; '.join(diffs)}). Re-encrypt "
        f"under this context's parameters, or load the matching key set.")


class EVAPublic:
    """Public context: encrypt + execute. Holds no secret material."""

    def __init__(self, ctx: CKKSContext, keys: "_keys.KeySet",
                 params: CKKSParameters, backend: str = "torch",
                 device=None):
        _check_backend(backend)
        self.ctx = ctx
        self._keys = keys
        self.params = params
        self.backend = backend
        self.device = None
        if backend == "torch":
            from ..backend import resolve_device
            self.device = resolve_device(device)
        self._executors: Dict[int, Executor] = {}

    def encrypt(self, inputs: Dict[str, Sequence[float]],
                signature: CKKSSignature) -> EVAValuation:
        """Encode+encrypt all inputs, in parallel across inputs for large
        batches (the reference parallelizes this with Galois do_all;
        reference eva/seal/seal.cpp:40-49 — our native NTT kernels release
        the GIL, so a thread pool gets real concurrency)."""
        slots = self.ctx.n // 2
        if signature.vec_size > slots:
            if signature.vec_size % slots != 0:
                raise RuntimeError(
                    "Vector size must be a multiple of the slot count")
        elif slots % signature.vec_size != 0:
            raise RuntimeError("Vector size must exactly divide the slot count")

        def prepare(item):
            name, values = item
            if len(values) != signature.vec_size:
                raise RuntimeError(
                    f"Input {name} size {len(values)} does not match program "
                    f"vector size {signature.vec_size}")
            info = signature.inputs[name]
            if info.input_type == Type.Cipher:
                return name, _keys.encrypt(
                    self.ctx, self._keys, values, 2.0 ** info.scale, info.level)
            if info.input_type == Type.Plain:
                return name, _keys.encode(
                    self.ctx, values, 2.0 ** info.scale, info.level)
            return name, np.asarray(values, dtype=np.float64)  # Raw

        out = EVAValuation(self.params)
        items = list(inputs.items())
        if len(items) >= 4 and HOST_THREADS > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(HOST_THREADS, len(items))) as pool:
                for name, value in pool.map(prepare, items):
                    out[name] = value
        else:
            for item in items:
                name, value = prepare(item)
                out[name] = value
        return out

    def _executor_for(self, program) -> Executor:
        executor = self._executors.get(id(program))
        if executor is None or executor.program is not program:
            executor = Executor(program, self.ctx, self._keys,
                                backend=self.backend, device=self.device)
            self._executors[id(program)] = executor
            # Bounded LRU: executors hold encode caches and compiled
            # device programs; don't accumulate them for dead programs.
            while len(self._executors) > 8:
                self._executors.pop(next(iter(self._executors)))
        return executor

    def execute(self, program, inputs: EVAValuation) -> EVAValuation:
        _check_params(self.params, inputs, "EVAPublic.execute")
        outputs = self._executor_for(program).run(inputs)
        return EVAValuation(self.params, outputs)

    def execute_batch(self, program, inputs_list, mesh=None):
        """Execute one compiled program over a batch of valuations in one
        device pass (torch backend): cipher inputs are stacked on a
        leading batch axis, so each kernel launch covers the batch.
        Returns one valuation per input, each bit-identical to its own
        `execute`. `mesh` (multi-device) is not ported and raises
        NotImplementedError; so does a program with vec_size > N/2."""
        for v in inputs_list:
            _check_params(self.params, v, "EVAPublic.execute_batch")
        results = self._executor_for(program).run_batch(inputs_list, mesh=mesh)
        return [EVAValuation(self.params, r) for r in results]

    def execute_pipelined(self, program, inputs_iter, depth: int = 2):
        """Stream executions of one compiled program over an iterable of
        input valuations (torch backend), yielding one output valuation
        per input, in order. Execution k+1 is enqueued on the device
        before execution k's outputs are collected (non-blocking copies
        into pinned host memory); `depth` bounds the executions in
        flight. Each output is bit-identical to its own `execute`."""
        ex = self._executor_for(program)

        def checked(it):
            for v in it:
                _check_params(self.params, v, "EVAPublic.execute_pipelined")
                yield v

        for out in ex.run_pipelined(checked(inputs_iter), depth=depth):
            yield EVAValuation(self.params, out)


class EVASecret:
    """Secret context: decryption.

    WARNING: holds the secret key; never share it (or its serialized
    form) with the evaluating party."""

    def __init__(self, ctx: CKKSContext, keys: "_keys.KeySet",
                 params: CKKSParameters):
        self.ctx = ctx
        self._keys = keys
        self.params = params

    def encrypt(self, inputs: Dict[str, Sequence[float]],
                signature: CKKSSignature) -> EVAValuation:
        """Symmetric (secret-key) encryption with SEEDED ciphertexts:
        fresh inputs serialize as (c0, seed) at half the size of
        public-key ciphertexts. Only the key holder can produce these;
        use EVAPublic.encrypt when encrypting with a shared public
        context."""
        slots = self.ctx.n // 2
        if signature.vec_size > slots:
            if signature.vec_size % slots != 0:
                raise RuntimeError(
                    "Vector size must be a multiple of the slot count")
        elif slots % signature.vec_size != 0:
            raise RuntimeError("Vector size must exactly divide the slot count")
        out = EVAValuation(self.params)
        for name, values in inputs.items():
            if len(values) != signature.vec_size:
                raise RuntimeError(
                    f"Input {name} size {len(values)} does not match program "
                    f"vector size {signature.vec_size}")
            info = signature.inputs[name]
            if info.input_type == Type.Cipher:
                out[name] = _keys.encrypt_symmetric(
                    self.ctx, self._keys, values, 2.0 ** info.scale, info.level)
            elif info.input_type == Type.Plain:
                out[name] = _keys.encode(
                    self.ctx, values, 2.0 ** info.scale, info.level)
            else:
                out[name] = np.asarray(values, dtype=np.float64)
        return out

    def decrypt(self, enc_outputs: EVAValuation,
                signature: CKKSSignature) -> Dict[str, list]:
        _check_params(self.params, enc_outputs, "EVASecret.decrypt")
        outputs = {}
        for name, value in enc_outputs.items():
            if isinstance(value, Ciphertext):
                slots = _keys.decrypt(self.ctx, self._keys, value)
                outputs[name] = [float(v) for v in slots[:signature.vec_size]]
            elif isinstance(value, Plaintext):
                primes = self.ctx.primes_at_level(value.level)
                if value.poly.ndim == 3:  # sharded big vector: interleave
                    k = value.poly.shape[0]
                    slots = np.empty(k * (self.ctx.n // 2), dtype=np.float64)
                    for j in range(k):
                        coeffs = self.ctx.encoder.residues_to_coeffs(
                            self.ctx.intt(value.poly[j], primes), primes)
                        slots[j::k] = self.ctx.encoder.coeffs_to_values(
                            coeffs, value.scale)
                else:
                    coeffs = self.ctx.encoder.residues_to_coeffs(
                        self.ctx.intt(value.poly, primes), primes)
                    slots = self.ctx.encoder.coeffs_to_values(
                        coeffs, value.scale)
                outputs[name] = [float(v) for v in slots[:signature.vec_size]]
            else:  # raw numpy vector
                vals = np.asarray(value, dtype=np.float64)
                reps = max(1, signature.vec_size // len(vals))
                outputs[name] = [float(v) for v in np.tile(vals, reps)[:signature.vec_size]]
        return outputs


def generate_keys(params: CKKSParameters, backend: str = "torch",
                  device=None):
    """CKKSParameters -> (EVAPublic, EVASecret).

    Reference: eva/seal/seal.cpp:174-203 (generateKeys): builds the RNS
    chain, samples the ternary secret, RLWE public key, relinearization
    key, and one Galois key per rotation step (host numpy). With the
    torch backend, `device=None` means the CUDA device, and the call
    raises when there is none; pass device="cpu" to execute with the
    plain PyTorch version, or backend="numpy" for the host reference."""
    _check_backend(backend)
    if backend == "torch":
        # Fail before the (slow) host keygen when there is no device.
        from ..backend import resolve_device
        device = resolve_device(device)
    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree,
                      getattr(params, "key_terms", 1))
    keys = _keys.generate_keys(ctx)
    return (EVAPublic(ctx, keys, params, backend=backend, device=device),
            EVASecret(ctx, keys, params))
