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
saved by either package load in the other. The protoc-generated modules
import each other package-relatively (nothing on sys.path), and
`load` of a public context takes the `backend`/`device` of
runtime.EVAPublic. Needs the `protobuf` package."""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import eva_pb2, ckks_pb2, known_type_pb2, evatpu_pb2

from .. import __version__ as _version
from ..ir import (CONSTANT_VALUE, DenseConstantValue, Op, Program,
                  SparseConstantValue, Term, Type, VALID_OPS)
from ..ckks.params import CKKSEncodingInfo, CKKSParameters, CKKSSignature

EVA_FORMAT_VERSION = 2

# Attribute wire encoding: key -> which oneof field carries the value.
_U32_KEYS = {1, 5, 6, 7}   # RescaleDivisor, Range, EncodeAtScale, EncodeAtLevel
_I32_KEYS = {2}            # Rotation
_TYPE_KEYS = {4}           # Type
_CONST_KEYS = {3}          # ConstantValue


# -- Program ------------------------------------------------------------------


def _serialize_constant(value, msg) -> None:
    msg.size = value.size
    if isinstance(value, SparseConstantValue):
        for idx, v in value.values:
            msg.sparse_indices.append(idx)
            msg.values.append(v)
    else:
        if not value.is_zero():
            msg.values.extend(value.values)


def _deserialize_constant(msg):
    if msg.sparse_indices:
        return SparseConstantValue(
            msg.size, list(zip(msg.sparse_indices, msg.values)))
    if not msg.values:
        return DenseConstantValue(msg.size, [0.0])
    return DenseConstantValue(msg.size, list(msg.values))


def serialize_program(program: Program) -> "eva_pb2.Program":
    msg = eva_pb2.Program()
    msg.ir_version = EVA_FORMAT_VERSION
    msg.name = program.name
    msg.vec_size = program.vec_size
    order = program.topological_order()
    index_of: Dict[int, int] = {}
    for i, term in enumerate(order):
        index_of[term.index] = i
        tmsg = msg.terms.add()
        tmsg.op = int(term.op)
        for o in term.operands:
            tmsg.operands.append(index_of[o.index])
        for key in sorted(term.attributes):
            amsg = tmsg.attributes.add()
            amsg.key = key
            value = term.attributes[key]
            if key in _U32_KEYS:
                amsg.uint32 = int(value)
            elif key in _I32_KEYS:
                amsg.int32 = int(value)
            elif key in _TYPE_KEYS:
                amsg.type = int(value)
            elif key in _CONST_KEYS:
                _serialize_constant(value, amsg.constant_value)
            else:
                raise RuntimeError(f"Unknown attribute key {key}")
    for name, term in program.inputs.items():
        e = msg.inputs.add()
        e.term = index_of[term.index]
        e.name = name
    for name, term in program.outputs.items():
        e = msg.outputs.add()
        e.term = index_of[term.index]
        e.name = name
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
            which = amsg.WhichOneof("value")
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


def serialize_params(params: CKKSParameters):
    msg = ckks_pb2.CKKSParameters()
    msg.prime_bits.extend(params.prime_bits)
    msg.rotations.extend(params.rotations)
    msg.poly_modulus_degree = params.poly_modulus_degree
    key_terms = getattr(params, "key_terms", 1)
    if key_terms != 1:  # absent field (0) means 1: pre-round-5 files
        msg.key_terms = key_terms
    return msg


def deserialize_params(msg) -> CKKSParameters:
    return CKKSParameters(list(msg.prime_bits), list(msg.rotations),
                          msg.poly_modulus_degree,
                          key_terms=msg.key_terms or 1)


def serialize_signature(sig: CKKSSignature):
    msg = ckks_pb2.CKKSSignature()
    msg.vec_size = sig.vec_size
    for name, info in sig.inputs.items():
        m = msg.inputs[name]
        m.input_type = int(info.input_type)
        m.scale = info.scale
        m.level = info.level
    return msg


def deserialize_signature(msg) -> CKKSSignature:
    inputs = {name: CKKSEncodingInfo(Type(m.input_type), m.scale, m.level)
              for name, m in msg.inputs.items()}
    return CKKSSignature(msg.vec_size, inputs)


# -- runtime objects ----------------------------------------------------------


def _poly_to_msg(arr: np.ndarray, msg) -> None:
    if arr.ndim == 3:  # sharded big-vector planes [shards, n_sub, n]
        msg.shards, msg.n_sub, msg.n = arr.shape
    else:
        msg.n_sub, msg.n = arr.shape
    msg.data = arr.astype("<u8").tobytes()


def _poly_from_msg(msg) -> np.ndarray:
    flat = np.frombuffer(msg.data, dtype="<u8")
    if msg.shards > 1:
        return flat.reshape(msg.shards, msg.n_sub, msg.n).copy()
    return flat.reshape(msg.n_sub, msg.n).copy()


def serialize_valuation(val):
    from ..crypto.ciphertext import Ciphertext, Plaintext
    msg = evatpu_pb2.EVAValuation()
    msg.params.CopyFrom(serialize_params(val.params))
    for name, v in val.items():
        if isinstance(v, Ciphertext):
            c = msg.ciphers[name]
            c.level = v.level
            c.scale = v.scale
            if v.seed is not None and v.size == 2:
                from ..crypto.keys import default_xof
                c.seed = v.seed
                c.xof = (v.seed_xof if v.seed_xof is not None
                         else default_xof())
                _poly_to_msg(v.polys[0], c.polys.add())  # c0 only
            else:
                for p in v.polys:
                    _poly_to_msg(p, c.polys.add())
        elif isinstance(v, Plaintext):
            p = msg.plains[name]
            p.level = v.level
            p.scale = v.scale
            _poly_to_msg(v.poly, p.poly)
        else:
            r = msg.raws[name]
            vals = np.asarray(v, dtype=np.float64)
            r.size = len(vals)
            r.values.extend(vals.tolist())
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


def _ksk_to_msg(ksk, msg) -> None:
    for d in ksk.k0:
        _poly_to_msg(d, msg.k0.add())
    if ksk.k1_seeds:
        msg.k1_seeds.extend(ksk.k1_seeds)
        msg.xof = ksk.xof
    else:
        for d in ksk.k1:
            _poly_to_msg(d, msg.k1.add())
    msg.ks_alpha = ksk.alpha


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


def serialize_public(pub):
    msg = evatpu_pb2.EVAPublicMsg()
    msg.params.CopyFrom(serialize_params(pub.params))
    _poly_to_msg(pub._keys.public.b, msg.pk_b)
    if pub._keys.public.a_seed:
        msg.pk_a_seed = pub._keys.public.a_seed
        msg.pk_xof = pub._keys.public.xof
    else:
        _poly_to_msg(pub._keys.public.a, msg.pk_a)
    _ksk_to_msg(pub._keys.relin, msg.relin)
    for g, k in pub._keys.galois.items():
        _ksk_to_msg(k, msg.galois[g])
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


def serialize_secret(sec):
    msg = evatpu_pb2.EVASecretMsg()
    msg.params.CopyFrom(serialize_params(sec.params))
    msg.secret_coeffs = sec._keys.secret.coeffs.astype(np.int8).tobytes()
    return msg


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


def _to_message(obj):
    from ..crypto.ciphertext import Ciphertext  # noqa: F401
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


_DESERIALIZERS = [
    (eva_pb2.Program, deserialize_program),
    (ckks_pb2.CKKSParameters, deserialize_params),
    (ckks_pb2.CKKSSignature, deserialize_signature),
    (evatpu_pb2.EVAValuation, deserialize_valuation),
    (evatpu_pb2.EVAPublicMsg, deserialize_public),
    (evatpu_pb2.EVASecretMsg, deserialize_secret),
]


def save(obj, path: str) -> None:
    env = known_type_pb2.KnownType()
    env.contents.Pack(_to_message(obj))
    env.creator = f"EVA-TPU {_version}"
    with open(path, "wb") as f:
        f.write(env.SerializeToString())


def save_to_string(obj) -> bytes:
    env = known_type_pb2.KnownType()
    env.contents.Pack(_to_message(obj))
    env.creator = f"EVA-TPU {_version}"
    return env.SerializeToString()


def _load_envelope(env, backend: str = "torch", device=None):
    for msg_type, fn in _DESERIALIZERS:
        if env.contents.Is(msg_type.DESCRIPTOR):
            msg = msg_type()
            env.contents.Unpack(msg)
            if fn is deserialize_public:
                return fn(msg, backend=backend, device=device)
            return fn(msg)
    raise RuntimeError(
        f"Unknown serialized type {env.contents.TypeName()} "
        f"(created by {env.creator!r})")


def load(path: str, backend: str = "torch", device=None):
    """The object saved at `path`; a public context is built on
    `backend`/`device` (see deserialize_public)."""
    env = known_type_pb2.KnownType()
    with open(path, "rb") as f:
        env.ParseFromString(f.read())
    return _load_envelope(env, backend, device)


def load_from_string(data: bytes, backend: str = "torch", device=None):
    env = known_type_pb2.KnownType()
    env.ParseFromString(data)
    return _load_envelope(env, backend, device)
