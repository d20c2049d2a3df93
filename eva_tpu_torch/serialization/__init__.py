"""Serialization: save/load of the six protocol objects through a
KnownType envelope (reference: eva/serialization/save_load.h:15-62,
known_type.h:29-35). This layer IS the checkpoint system for the 4-role
protocol: compile-time artifacts (Program, CKKSParameters,
CKKSSignature), key material (EVAPublic, EVASecret), and valuations all
stop/resume at every stage boundary.

Program/CKKSParameters/CKKSSignature use the reference-compatible wire
format (format version 2); runtime objects use the evatpu.proto schemas
since there is no SEAL binary format to wrap.

Port of eva_tpu/serialization: the same schemas and bytes, so files
saved by either package load in the other. The messages go through the
proto3 codec of `wire` (no protobuf package), whose bytes are protobuf's
deterministic ones, and `load` of a public context takes the
`backend`/`device` of runtime.EVAPublic."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .wire import Message, any_type_name, decode, encode, pack_any

from .. import __version__ as _version
from ..ir import (DenseConstantValue, Op, Program, SparseConstantValue,
                  Type, VALID_OPS)
from ..ckks.params import CKKSEncodingInfo, CKKSParameters, CKKSSignature

EVA_FORMAT_VERSION = 2

# Attribute wire encoding: key -> which oneof field carries the value.
_U32_KEYS = {1, 5, 6, 7}   # RescaleDivisor, Range, EncodeAtScale, EncodeAtLevel
_I32_KEYS = {2}            # Rotation
_TYPE_KEYS = {4}           # Type
_CONST_KEYS = {3}          # ConstantValue


# -- Program ------------------------------------------------------------------


def _serialize_constant(value) -> Message:
    msg = Message("ConstantValue", size=value.size)
    if isinstance(value, SparseConstantValue):
        msg.sparse_indices = [idx for idx, _ in value.values]
        msg.values = [v for _, v in value.values]
    elif not value.is_zero():
        msg.values = list(value.values)
    return msg


def _deserialize_constant(msg):
    if msg.sparse_indices:
        return SparseConstantValue(
            msg.size, list(zip(msg.sparse_indices, msg.values)))
    if not msg.values:
        return DenseConstantValue(msg.size, [0.0])
    return DenseConstantValue(msg.size, list(msg.values))


def serialize_program(program: Program) -> Message:
    msg = Message("Program", ir_version=EVA_FORMAT_VERSION,
                  name=program.name, vec_size=program.vec_size)
    order = program.topological_order()
    index_of: Dict[int, int] = {}
    for i, term in enumerate(order):
        index_of[term.index] = i
        tmsg = Message("Term", op=int(term.op),
                       operands=[index_of[o.index] for o in term.operands])
        for key in sorted(term.attributes):
            amsg = Message("Attribute", key=key)
            value = term.attributes[key]
            if key in _U32_KEYS:
                amsg.uint32 = int(value)
            elif key in _I32_KEYS:
                amsg.int32 = int(value)
            elif key in _TYPE_KEYS:
                amsg.type = int(value)
            elif key in _CONST_KEYS:
                amsg.constant_value = _serialize_constant(value)
            else:
                raise RuntimeError(f"Unknown attribute key {key}")
            tmsg.attributes.append(amsg)
        msg.terms.append(tmsg)
    msg.inputs = [Message("TermName", term=index_of[term.index], name=name)
                  for name, term in program.inputs.items()]
    msg.outputs = [Message("TermName", term=index_of[term.index], name=name)
                   for name, term in program.outputs.items()]
    return msg


def deserialize_program(msg) -> Program:
    if msg.ir_version != EVA_FORMAT_VERSION:
        raise RuntimeError(
            f"Unsupported program format version {msg.ir_version} "
            f"(expected {EVA_FORMAT_VERSION})")
    program = Program(msg.name, msg.vec_size)
    terms = []
    for tmsg in msg.terms:
        if tmsg.op not in VALID_OPS:
            raise RuntimeError(f"Invalid op code {tmsg.op}")
        term = program.make_term(Op(tmsg.op), [terms[i] for i in tmsg.operands])
        for amsg in tmsg.attributes:
            which = amsg.which("value")
            if which == "uint32":
                term.set_attr(amsg.key, amsg.uint32)
            elif which == "int32":
                term.set_attr(amsg.key, amsg.int32)
            elif which == "type":
                term.set_attr(amsg.key, Type(amsg.type))
            elif which == "constant_value":
                term.set_attr(amsg.key, _deserialize_constant(amsg.constant_value))
        terms.append(term)
    for e in msg.inputs:
        program._inputs[e.name] = terms[e.term]
    for e in msg.outputs:
        program._outputs[e.name] = terms[e.term]
    return program


# -- CKKS objects -------------------------------------------------------------


def serialize_params(params: CKKSParameters) -> Message:
    msg = Message("CKKSParameters", prime_bits=list(params.prime_bits),
                  rotations=list(params.rotations),
                  poly_modulus_degree=params.poly_modulus_degree)
    key_terms = getattr(params, "key_terms", 1)
    if key_terms != 1:  # absent field (0) means 1: pre-round-5 files
        msg.key_terms = key_terms
    return msg


def deserialize_params(msg) -> CKKSParameters:
    return CKKSParameters(list(msg.prime_bits), list(msg.rotations),
                          msg.poly_modulus_degree,
                          key_terms=msg.key_terms or 1)


def serialize_signature(sig: CKKSSignature) -> Message:
    return Message("CKKSSignature", vec_size=sig.vec_size, inputs={
        name: Message("CKKSEncodingInfo", input_type=int(info.input_type),
                      scale=info.scale, level=info.level)
        for name, info in sig.inputs.items()})


def deserialize_signature(msg) -> CKKSSignature:
    inputs = {name: CKKSEncodingInfo(Type(m.input_type), m.scale, m.level)
              for name, m in msg.inputs.items()}
    return CKKSSignature(msg.vec_size, inputs)


# -- runtime objects ----------------------------------------------------------


def _poly_to_msg(arr: np.ndarray) -> Message:
    msg = Message("Poly", data=arr.astype("<u8").tobytes())
    if arr.ndim == 3:  # sharded big-vector planes [shards, n_sub, n]
        msg.shards, msg.n_sub, msg.n = arr.shape
    else:
        msg.n_sub, msg.n = arr.shape
    return msg


def _poly_from_msg(msg) -> np.ndarray:
    flat = np.frombuffer(msg.data, dtype="<u8")
    if msg.shards > 1:
        return flat.reshape(msg.shards, msg.n_sub, msg.n).copy()
    return flat.reshape(msg.n_sub, msg.n).copy()


def serialize_valuation(val) -> Message:
    from ..crypto.ciphertext import Ciphertext, Plaintext
    msg = Message("EVAValuation", params=serialize_params(val.params))
    for name, v in val.items():
        if isinstance(v, Ciphertext):
            c = msg.ciphers[name] = Message("CipherObj", level=v.level,
                                            scale=v.scale)
            if v.seed is not None and v.size == 2:
                from ..crypto.keys import default_xof
                c.seed = v.seed
                c.xof = (v.seed_xof if v.seed_xof is not None
                         else default_xof())
                c.polys = [_poly_to_msg(v.polys[0])]  # c0 only
            else:
                c.polys = [_poly_to_msg(p) for p in v.polys]
        elif isinstance(v, Plaintext):
            msg.plains[name] = Message("PlainObj", poly=_poly_to_msg(v.poly),
                                       level=v.level, scale=v.scale)
        else:
            vals = np.asarray(v, dtype=np.float64)
            msg.raws[name] = Message("RawObj", size=len(vals),
                                     values=vals.tolist())
    return msg


def deserialize_valuation(msg):
    from ..crypto.ciphertext import Ciphertext, Plaintext
    from ..runtime import EVAValuation
    val = EVAValuation(deserialize_params(msg.params))
    for name, c in msg.ciphers.items():
        polys = [_poly_from_msg(p) for p in c.polys]
        seed = bytes(c.seed) if c.seed else None
        if seed is not None and len(polys) == 1:
            from ..crypto.context import get_context
            from ..crypto.keys import expand_seeded_c1
            params = deserialize_params(msg.params)
            ctx = get_context(tuple(params.prime_bits),
                              tuple(params.rotations),
                              params.poly_modulus_degree,
                              getattr(params, "key_terms", 1))
            shards = polys[0].shape[0] if polys[0].ndim == 3 else 1
            polys.append(expand_seeded_c1(ctx, seed, c.level, shards,
                                          xof=c.xof))
        val[name] = Ciphertext(polys, c.level, c.scale, seed=seed,
                               seed_xof=c.xof if seed is not None else None)
    for name, p in msg.plains.items():
        val[name] = Plaintext(_poly_from_msg(p.poly), p.level, p.scale)
    for name, r in msg.raws.items():
        val[name] = np.array(r.values, dtype=np.float64)
    return val


def _ksk_to_msg(ksk) -> Message:
    msg = Message("KSwitchKeyMsg", k0=[_poly_to_msg(d) for d in ksk.k0],
                  ks_alpha=ksk.alpha)
    if ksk.k1_seeds:
        msg.k1_seeds = list(ksk.k1_seeds)
        msg.xof = ksk.xof
    else:
        msg.k1 = [_poly_to_msg(d) for d in ksk.k1]
    return msg


def _ksk_from_msg(msg, ctx):
    from ..crypto.keys import KSwitchKey, expand_uniform
    alpha = msg.ks_alpha or 1  # 0 = pre-hybrid file, per-sub-prime digits
    k0 = [_poly_from_msg(p) for p in msg.k0]
    if msg.k1_seeds:
        seeds = [bytes(sd) for sd in msg.k1_seeds]
        k1 = [expand_uniform(ctx, ctx.all_primes, sd, msg.xof)
              for sd in seeds]
        return KSwitchKey(k0, k1, seeds, alpha=alpha, xof=msg.xof)
    return KSwitchKey(k0, [_poly_from_msg(p) for p in msg.k1], alpha=alpha)


def serialize_public(pub) -> Message:
    keys = pub._keys
    msg = Message("EVAPublicMsg", params=serialize_params(pub.params),
                  pk_b=_poly_to_msg(keys.public.b),
                  relin=_ksk_to_msg(keys.relin),
                  galois={g: _ksk_to_msg(k) for g, k in keys.galois.items()})
    if keys.public.a_seed:
        msg.pk_a_seed = keys.public.a_seed
        msg.pk_xof = keys.public.xof
    else:
        msg.pk_a = _poly_to_msg(keys.public.a)
    return msg


def deserialize_public(msg, backend: str = "torch", device=None):
    """The EVAPublic of `msg` on `backend`/`device` (as EVAPublic: the
    torch backend on device=None means the CUDA device, and raises when
    there is none)."""
    from ..crypto import keys as K
    from ..crypto.context import get_context
    from ..runtime import EVAPublic
    params = deserialize_params(msg.params)
    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree,
                      getattr(params, "key_terms", 1))
    if msg.pk_a_seed:
        seed = bytes(msg.pk_a_seed)
        pk_a = K.expand_uniform(ctx, ctx.data_primes, seed, msg.pk_xof)
        public = K.PublicKey(_poly_from_msg(msg.pk_b), pk_a, seed,
                             xof=msg.pk_xof)
    else:
        public = K.PublicKey(_poly_from_msg(msg.pk_b), _poly_from_msg(msg.pk_a))
    relin = _ksk_from_msg(msg.relin, ctx)
    galois = {g: _ksk_from_msg(k, ctx) for g, k in msg.galois.items()}
    keyset = K.KeySet(ctx, None, public, relin, galois)
    return EVAPublic(ctx, keyset, params, backend=backend, device=device)


def serialize_secret(sec) -> Message:
    return Message("EVASecretMsg", params=serialize_params(sec.params),
                   secret_coeffs=sec._keys.secret.coeffs.astype(
                       np.int8).tobytes())


def deserialize_secret(msg):
    from ..crypto import keys as K
    from ..crypto.context import get_context
    from ..runtime import EVASecret
    params = deserialize_params(msg.params)
    ctx = get_context(tuple(params.prime_bits), tuple(params.rotations),
                      params.poly_modulus_degree,
                      getattr(params, "key_terms", 1))
    coeffs = np.frombuffer(msg.secret_coeffs, dtype=np.int8).astype(np.int64)
    secret = K.SecretKey(ctx, coeffs)
    keyset = K.KeySet(ctx, secret, None, None, {})
    return EVASecret(ctx, keyset, params)


# -- KnownType envelope + save/load ------------------------------------------


def _to_message(obj) -> Message:
    from ..runtime import EVAPublic, EVASecret, EVAValuation
    if isinstance(obj, Program):
        return serialize_program(obj)
    if isinstance(obj, CKKSParameters):
        return serialize_params(obj)
    if isinstance(obj, CKKSSignature):
        return serialize_signature(obj)
    if isinstance(obj, EVAValuation):
        return serialize_valuation(obj)
    if isinstance(obj, EVAPublic):
        return serialize_public(obj)
    if isinstance(obj, EVASecret):
        return serialize_secret(obj)
    raise TypeError(f"Cannot serialize object of type {type(obj)}")


# The envelope's message full name -> its deserializer.
_DESERIALIZERS = {
    "eva.msg.Program": deserialize_program,
    "eva.msg.CKKSParameters": deserialize_params,
    "eva.msg.CKKSSignature": deserialize_signature,
    "eva.msg.EVAValuation": deserialize_valuation,
    "eva.msg.EVAPublicMsg": deserialize_public,
    "eva.msg.EVASecretMsg": deserialize_secret,
}


def save_to_string(obj) -> bytes:
    return encode(Message("KnownType", contents=pack_any(_to_message(obj)),
                          creator=f"EVA-TPU {_version}"))


def save(obj, path: str) -> None:
    data = save_to_string(obj)
    with open(path, "wb") as f:
        f.write(data)


def load_from_string(data: bytes, backend: str = "torch", device=None):
    """The object saved in `data`; a public context is built on
    `backend`/`device` (see deserialize_public)."""
    env = decode("KnownType", data)
    name = any_type_name(env.contents) if env.contents is not None else ""
    fn = _DESERIALIZERS.get(name)
    if fn is None:
        raise RuntimeError(f"Unknown serialized type {name} "
                           f"(created by {env.creator!r})")
    msg = decode(name, env.contents.value)
    if fn is deserialize_public:
        return fn(msg, backend=backend, device=device)
    return fn(msg)


def load(path: str, backend: str = "torch", device=None):
    """The object saved at `path`; a public context is built on
    `backend`/`device` (see deserialize_public)."""
    with open(path, "rb") as f:
        data = f.read()
    return load_from_string(data, backend, device)
