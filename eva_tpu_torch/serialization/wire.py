"""A proto3 wire codec for the serialization schemas, in plain Python
with struct and numpy (no protobuf package).

SCHEMA transcribes the four .proto files beside this module (they stay
the documentation of the schema) and google.protobuf.Any. A Message
carries one message's fields as attributes: scalars (proto3 defaults
when absent), lists for repeated fields, dicts for maps, and a Message
or None for a submessage (None: not set). A oneof member that is not
set reads None; `which(oneof)` names the member that is.

encode() writes what protobuf's SerializeToString(deterministic=True)
writes for the same message, byte for byte:
- fields in ascending field-number order;
- proto3 scalars at their default omitted (0, "", b"", and a double
  whose bits are all zero: -0.0 is written), but a oneof member that is
  set and a submessage that is set are written even when 0 or empty;
- a map entry always carries its key and its value; entries go in the
  order of protobuf's deterministic serializer (upb, protobuf's default
  implementation since 4.21): integer keys in descending order, string
  keys by their UTF-8 bytes, the longer first where one is a prefix of
  the other (_map_order);
- repeated numeric fields packed; int32 negative as a 10-byte
  sign-extended varint; sint32 zigzag.

decode() accepts what protobuf's parser accepts of these schemas:
fields in any order, repeated numeric fields packed or not and split
over several occurrences, the last occurrence of a singular scalar or
oneof member winning, a singular submessage that occurs twice merged.
It skips unknown fields of wire types 0, 1, 2 and 5; they are not kept,
so a re-save drops them where protobuf would keep them. A bytes field
decodes to a memoryview of the input (no copy). Anything else malformed
(a truncated varint, a length past the end, wire type 3, 4, 6 or 7, a
known field on the wrong wire type, a string that is not UTF-8) raises
ValueError naming the message and the field."""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

TYPE_URL_PREFIX = "type.googleapis.com/"

# Each field as "name number type", its type prefixed by "repeated",
# "map <key>" or "oneof <name>" (the .proto files' declarations).
SCHEMA: Dict[str, Tuple[str, ...]] = {
    # google/protobuf/any.proto
    "google.protobuf.Any": ("type_url 1 string", "value 2 bytes"),
    # known_type.proto
    "eva.msg.KnownType": ("contents 1 google.protobuf.Any",
                          "creator 2 string"),
    # eva.proto
    "eva.msg.Term": ("op 1 uint32", "operands 2 repeated uint64",
                     "attributes 3 repeated eva.msg.Attribute"),
    "eva.msg.ConstantValue": ("size 1 uint32", "values 2 repeated double",
                              "sparse_indices 3 repeated uint32"),
    "eva.msg.Attribute": ("key 1 uint32", "uint32 2 oneof value uint32",
                          "int32 3 oneof value sint32",
                          "type 4 oneof value uint32",
                          "constant_value 5 oneof value eva.msg.ConstantValue"),
    "eva.msg.TermName": ("term 1 uint64", "name 2 string"),
    "eva.msg.Program": ("ir_version 1 uint32", "name 2 string",
                        "vec_size 3 uint32",
                        "terms 4 repeated eva.msg.Term",
                        "inputs 5 repeated eva.msg.TermName",
                        "outputs 6 repeated eva.msg.TermName"),
    # ckks.proto
    "eva.msg.CKKSParameters": ("prime_bits 1 repeated uint32",
                               "rotations 2 repeated int32",
                               "poly_modulus_degree 3 uint32",
                               "key_terms 4 uint32"),
    "eva.msg.CKKSEncodingInfo": ("input_type 1 int32", "scale 2 int32",
                                 "level 3 int32"),
    "eva.msg.CKKSSignature": ("vec_size 1 int32",
                              "inputs 2 map string eva.msg.CKKSEncodingInfo"),
    # evatpu.proto
    "eva.msg.Poly": ("n 1 uint32", "n_sub 2 uint32", "data 3 bytes",
                     "shards 4 uint32"),
    "eva.msg.CipherObj": ("polys 1 repeated eva.msg.Poly", "level 2 uint32",
                          "scale 3 double", "seed 4 bytes", "xof 5 uint32"),
    "eva.msg.PlainObj": ("poly 1 eva.msg.Poly", "level 2 uint32",
                         "scale 3 double"),
    "eva.msg.RawObj": ("size 1 uint32", "values 2 repeated double"),
    "eva.msg.EVAValuation": ("params 1 eva.msg.CKKSParameters",
                             "ciphers 2 map string eva.msg.CipherObj",
                             "plains 3 map string eva.msg.PlainObj",
                             "raws 4 map string eva.msg.RawObj"),
    "eva.msg.KSwitchKeyMsg": ("k0 1 repeated eva.msg.Poly",
                              "k1 2 repeated eva.msg.Poly",
                              "k1_seeds 3 repeated bytes",
                              "ks_alpha 4 uint32", "xof 5 uint32"),
    "eva.msg.EVAPublicMsg": ("params 1 eva.msg.CKKSParameters",
                             "pk_b 2 eva.msg.Poly", "pk_a 3 eva.msg.Poly",
                             "relin 4 eva.msg.KSwitchKeyMsg",
                             "galois 5 map uint32 eva.msg.KSwitchKeyMsg",
                             "pk_a_seed 6 bytes", "pk_xof 7 uint32"),
    "eva.msg.EVASecretMsg": ("params 1 eva.msg.CKKSParameters",
                             "secret_coeffs 2 bytes"),
}

# Scalar type -> wire type: 0 varint, 1 fixed64, 2 length-delimited.
SCALARS = {"uint32": 0, "int32": 0, "sint32": 0, "uint64": 0, "double": 1,
           "string": 2, "bytes": 2}
_DEFAULTS = {"double": 0.0, "string": "", "bytes": b""}
_RANGES = {"uint32": (0, 1 << 32), "uint64": (0, 1 << 64),
           "int32": (-1 << 31, 1 << 31), "sint32": (-1 << 31, 1 << 31)}


class Field(NamedTuple):
    name: str
    number: int
    type: str                  # a scalar type or a message's full name
    repeated: bool = False
    key: Optional[str] = None  # a map's key type
    oneof: Optional[str] = None

    @property
    def message(self) -> bool:
        return self.type not in SCALARS


class MessageType:
    """One message of SCHEMA: its fields by name and by number, in
    ascending number order."""

    def __init__(self, full_name: str, decls):
        self.full_name = full_name
        fields = []
        for decl in decls:
            name, number, *rest = decl.split()
            if rest[0] == "repeated":
                f = Field(name, int(number), rest[1], repeated=True)
            elif rest[0] == "map":
                f = Field(name, int(number), rest[2], key=rest[1])
            elif rest[0] == "oneof":
                f = Field(name, int(number), rest[2], oneof=rest[1])
            else:
                f = Field(name, int(number), rest[0])
            fields.append(f)
        self.fields = tuple(sorted(fields, key=lambda f: f.number))
        self.by_name = {f.name: f for f in self.fields}
        self.by_number = {f.number: f for f in self.fields}


TYPES = {name: MessageType(name, decls) for name, decls in SCHEMA.items()}


def _type(name: str) -> MessageType:
    """The MessageType of `name`, a full name or one of package eva.msg."""
    t = TYPES.get(name) or TYPES.get("eva.msg." + name)
    if t is None:
        raise KeyError(f"no message {name!r} in the schema")
    return t


def _default(f: Field):
    if f.key is not None:
        return {}
    if f.repeated:
        return []
    if f.message or f.oneof is not None:
        return None
    return _DEFAULTS.get(f.type, 0)


class Message:
    """One message of SCHEMA: Message("Program", name="p", ...)."""

    __slots__ = ("_type", "_values")

    def __init__(self, type_name: str, **fields):
        t = _type(type_name)
        object.__setattr__(self, "_type", t)
        object.__setattr__(self, "_values",
                           {f.name: _default(f) for f in t.fields})
        for name, value in fields.items():
            setattr(self, name, value)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(
                f"{self._type.full_name} has no field {name!r}") from None

    def __setattr__(self, name, value):
        f = self._type.by_name.get(name)
        if f is None:
            raise AttributeError(
                f"{self._type.full_name} has no field {name!r}")
        if f.oneof is not None and value is not None:
            for other in self._type.fields:
                if other.oneof == f.oneof:
                    self._values[other.name] = None
        self._values[name] = value

    def which(self, oneof: str) -> Optional[str]:
        """The member of `oneof` that is set, or None."""
        for f in self._type.fields:
            if f.oneof == oneof and self._values[f.name] is not None:
                return f.name
        return None

    @property
    def full_name(self) -> str:
        return self._type.full_name

    def __eq__(self, other):
        return (isinstance(other, Message) and self._type is other._type
                and self._values == other._values)

    def __repr__(self):
        shown = ", ".join(f"{k}={v!r}" for k, v in self._values.items()
                          if v not in (None, 0, "", b"", [], {}))
        return f"{self._type.full_name}({shown})"


# -- encoding -----------------------------------------------------------------


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _int_value(f: Field, type_: str, value) -> int:
    value = int(value)
    lo, hi = _RANGES[type_]
    if not lo <= value < hi:
        raise ValueError(f"{f.name}: {value} is out of range for {type_}")
    if type_ == "sint32":
        return ((value << 1) ^ (value >> 31)) & 0xFFFFFFFF
    return value


def _scalar(f: Field, type_: str, value) -> bytes:
    """The wire bytes of one scalar value (a length-delimited one
    without its length)."""
    if type_ == "double":
        return struct.pack("<d", value)
    if type_ == "string":
        return value.encode("utf-8")
    if type_ == "bytes":
        return bytes(value)
    return _varint(_int_value(f, type_, value))


def _is_default(type_: str, value) -> bool:
    if type_ == "double":
        return struct.pack("<d", value) == b"\0" * 8
    return not value


def _map_order(key_type: str, keys) -> list:
    """`keys` in the order upb writes a map's entries deterministically.
    upb sorts integers ascending and strings by descending memcmp of their
    common prefix, then ascending length, and encodes back to front."""
    if key_type == "string":
        return sorted(keys, key=lambda k: tuple(k.encode("utf-8")) + (256,))
    return sorted(keys, reverse=True)


def _put(parts: list, number: int, wt: int, chunk) -> None:
    parts.append(_varint(number << 3 | wt))
    if wt == 2:
        parts.append(_varint(len(chunk)))
    parts.append(chunk)


def _put_message(parts: list, number: int, sub: "Message") -> None:
    """Append `sub` as field `number`: its tag and length go in a slot
    filled once its own parts are in."""
    slot = len(parts)
    parts.append(b"")
    n = _encode_parts(sub, parts)
    parts[slot] = _varint(number << 3 | 2) + _varint(n)


def _encode_parts(msg: Message, parts: list) -> int:
    """Append the wire bytes of `msg` to `parts`; return their length."""
    first = len(parts)
    for f in msg._type.fields:
        value = msg._values[f.name]
        if f.key is not None:  # every map of the schema has message values
            for k in _map_order(f.key, value):
                slot = len(parts)
                parts.append(b"")
                _put(parts, 1, SCALARS[f.key], _scalar(f, f.key, k))
                _put_message(parts, 2, value[k])
                n = sum(len(p) for p in parts[slot + 1:])
                parts[slot] = _varint(f.number << 3 | 2) + _varint(n)
        elif f.repeated:
            if not len(value):
                continue
            if f.message:
                for sub in value:
                    _put_message(parts, f.number, sub)
            elif f.type == "double":
                _put(parts, f.number, 2,
                     np.asarray(value, dtype="<f8").tobytes())
            elif SCALARS[f.type] == 2:
                for v in value:
                    _put(parts, f.number, 2, _scalar(f, f.type, v))
            else:
                _put(parts, f.number, 2,
                     b"".join(_scalar(f, f.type, v) for v in value))
        elif f.message:
            if value is not None:
                _put_message(parts, f.number, value)
        elif value is not None and (f.oneof is not None
                                    or not _is_default(f.type, value)):
            _put(parts, f.number, SCALARS[f.type], _scalar(f, f.type, value))
    return sum(len(p) for p in parts[first:])


def encode(msg: Message) -> bytes:
    """The wire bytes of `msg` (protobuf's deterministic bytes)."""
    parts: list = []
    _encode_parts(msg, parts)
    return b"".join(parts)


# -- decoding -----------------------------------------------------------------


class _Malformed(Exception):
    """A fault in the bytes, before the message and field are named."""


def _read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    value = shift = 0
    for i in range(pos, min(pos + 10, end)):
        b = buf[i]
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value & ((1 << 64) - 1), i + 1
        shift += 7
    raise _Malformed("truncated varint" if end - pos < 10
                     else "varint longer than 10 bytes")


def _packed_varints(chunk) -> np.ndarray:
    """The uint64 values of a packed run of varints, without a Python
    loop over its bytes."""
    b = np.frombuffer(chunk, dtype=np.uint8)
    if not len(b):
        return np.zeros(0, np.uint64)
    ends = np.flatnonzero(b < 0x80)
    if not len(ends) or ends[-1] != len(b) - 1:
        raise _Malformed("truncated varint")
    starts = np.concatenate(([0], ends[:-1] + 1))
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise _Malformed("varint longer than 10 bytes")
    place = np.arange(len(b)) - np.repeat(starts, lengths)
    bits = (b & 0x7F).astype(np.uint64) << (7 * place).astype(np.uint64)
    return np.bitwise_or.reduceat(bits, starts)


def _ints(type_: str, raw: np.ndarray) -> list:
    """Varint payloads as `type_`'s values (protobuf keeps the low 32
    bits of a 32-bit field)."""
    if type_ == "uint64":
        return raw.tolist()
    low = (raw & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if type_ == "uint32":
        return low.tolist()
    if type_ == "int32":
        return low.view(np.int32).tolist()
    return ((low >> np.uint32(1)).astype(np.int64)
            ^ -(low & np.uint32(1)).astype(np.int64)).tolist()  # sint32


def _one_int(type_: str, raw: int) -> int:
    """_ints of one value."""
    if type_ == "uint64":
        return raw
    low = raw & 0xFFFFFFFF
    if type_ == "uint32":
        return low
    if type_ == "int32":
        return low - (1 << 32) if low >> 31 else low
    return (low >> 1) ^ -(low & 1)  # sint32


def _field_value(f: Field, type_: str, wt: int, buf, pos: int, end: int):
    """(one value of scalar type `type_` at `pos`, the position after)."""
    if wt != SCALARS[type_]:
        raise _Malformed(f"wire type {wt}, the schema says {type_}")
    if wt == 0:
        raw, pos = _read_varint(buf, pos, end)
        return _one_int(type_, raw), pos
    if wt == 1:
        if pos + 8 > end:
            raise _Malformed("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    start, stop = _span(buf, pos, end)
    if type_ == "string":
        try:
            return str(buf[start:stop], "utf-8"), stop
        except UnicodeDecodeError as e:
            raise _Malformed(f"string is not UTF-8 ({e.reason})") from None
    return buf[start:stop], stop


def _span(buf, pos: int, end: int) -> Tuple[int, int]:
    n, pos = _read_varint(buf, pos, end)
    if n > end - pos:
        raise _Malformed(f"length {n} past the end of the buffer")
    return pos, pos + n


def _skip(wt: int, buf, pos: int, end: int) -> int:
    if wt == 0:
        return _read_varint(buf, pos, end)[1]
    if wt == 1:
        if pos + 8 > end:
            raise _Malformed("truncated fixed64")
        return pos + 8
    if wt == 2:
        return _span(buf, pos, end)[1]
    if wt == 5:
        if pos + 4 > end:
            raise _Malformed("truncated fixed32")
        return pos + 4
    raise _Malformed(f"wire type {wt} is not supported")


def _decode_into(msg: Message, buf, pos: int, end: int) -> None:
    t, values = msg._type, msg._values
    where = "tag"
    try:
        while pos < end:
            tag, pos = _read_varint(buf, pos, end)
            number, wt = tag >> 3, tag & 7
            if number == 0:
                raise _Malformed("field number 0")
            f = t.by_number.get(number)
            if f is None:
                where = f"unknown field {number}"
                pos = _skip(wt, buf, pos, end)
                continue
            where = f.name
            if f.key is not None:
                if wt != 2:
                    raise _Malformed(f"wire type {wt}, the schema says map")
                start, pos = _span(buf, pos, end)
                k, v = _decode_entry(f, buf, start, pos)
                values[f.name][k] = v
            elif f.message:
                if wt != 2:
                    raise _Malformed(f"wire type {wt}, the schema says "
                                     f"{f.type}")
                start, pos = _span(buf, pos, end)
                if f.repeated:
                    sub = Message(f.type)
                    values[f.name].append(sub)
                else:
                    sub = values[f.name]
                    if sub is None:
                        sub = Message(f.type)
                        setattr(msg, f.name, sub)
                _decode_into(sub, buf, start, pos)
            elif f.repeated and wt == 2 and SCALARS[f.type] != 2:
                start, pos = _span(buf, pos, end)
                if f.type == "double":
                    if (pos - start) % 8:
                        raise _Malformed("packed doubles of "
                                         f"{pos - start} bytes")
                    values[f.name] += np.frombuffer(
                        buf[start:pos], dtype="<f8").tolist()
                else:
                    values[f.name] += _ints(
                        f.type, _packed_varints(buf[start:pos]))
            else:
                v, pos = _field_value(f, f.type, wt, buf, pos, end)
                if f.repeated:
                    values[f.name].append(v)
                else:
                    setattr(msg, f.name, v)
    except _Malformed as e:
        raise ValueError(f"{t.full_name}.{where}: {e}") from None


def _decode_entry(f: Field, buf, pos: int, end: int):
    """(key, value) of one map entry; an absent key or value is its
    default."""
    key = _DEFAULTS.get(f.key, 0)
    value = None
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wt = tag >> 3, tag & 7
        if number == 1:
            key, pos = _field_value(f, f.key, wt, buf, pos, end)
        elif number == 2:
            if wt != 2:
                raise _Malformed(f"wire type {wt}, the schema says {f.type}")
            start, pos = _span(buf, pos, end)
            if value is None:
                value = Message(f.type)
            _decode_into(value, buf, start, pos)
        elif number == 0:
            raise _Malformed("field number 0")
        else:
            pos = _skip(wt, buf, pos, end)
    return key, value if value is not None else Message(f.type)


def decode(type_name: str, data) -> Message:
    """The message of type `type_name` in `data` (bytes-like)."""
    msg = Message(type_name)
    buf = memoryview(data).cast("B")
    _decode_into(msg, buf, 0, len(buf))
    return msg


# -- google.protobuf.Any ------------------------------------------------------


def pack_any(msg: Message) -> Message:
    """An Any holding `msg`, as Any.Pack makes it."""
    return Message("google.protobuf.Any",
                   type_url=TYPE_URL_PREFIX + msg.full_name,
                   value=encode(msg))


def any_type_name(any_msg: Message) -> str:
    """The full name of the message an Any holds (Any.TypeName)."""
    return any_msg.type_url.rpartition("/")[2]
