"""eva_tpu_torch.serialization.wire, the port's proto3 codec, against
protobuf with the JAX package's generated modules.

The codec's schema is the generated descriptors'; each encoding rule is
a case held to protobuf's bytes; random messages of every type encode
to protobuf's deterministic bytes and parse in protobuf to an equal
message, and the codec decodes protobuf's own bytes, fields in any
order, repeated fields packed or not and split, unknown fields and
concatenated (merged) messages as protobuf's parser does. Malformed
buffers raise ValueError naming the message and the field."""

import random
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from google.protobuf import any_pb2, symbol_database
from google.protobuf.descriptor import FieldDescriptor as FD

from eva_tpu.serialization import (ckks_pb2, eva_pb2, evatpu_pb2,
                                   known_type_pb2)
from eva_tpu_torch.serialization import wire as W

MODULES = (any_pb2, known_type_pb2, eva_pb2, ckks_pb2, evatpu_pb2)
SCALAR_TYPES = {FD.TYPE_UINT32: "uint32", FD.TYPE_INT32: "int32",
                FD.TYPE_SINT32: "sint32", FD.TYPE_UINT64: "uint64",
                FD.TYPE_DOUBLE: "double", FD.TYPE_STRING: "string",
                FD.TYPE_BYTES: "bytes"}
TYPE_NAMES = sorted(W.TYPES)
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    suppress_health_check=list(HealthCheck))


def pb_class(full_name: str):
    return symbol_database.Default().GetSymbol(full_name)


def descriptor_fields(desc):
    """The descriptor's fields as wire.Field tuples."""
    out = []
    for fd in desc.fields:
        mt = fd.message_type
        if mt is not None and mt.GetOptions().map_entry:
            key, value = mt.fields_by_name["key"], mt.fields_by_name["value"]
            out.append(W.Field(fd.name, fd.number,
                               value.message_type.full_name,
                               key=SCALAR_TYPES[key.type]))
            continue
        type_ = mt.full_name if mt is not None else SCALAR_TYPES[fd.type]
        oneof = fd.containing_oneof.name if fd.containing_oneof else None
        out.append(W.Field(fd.name, fd.number, type_,
                           repeated=fd.is_repeated,
                           oneof=oneof))
        if out[-1].repeated and not out[-1].message:
            assert fd.is_packed == (type_ not in ("string", "bytes"))
    return tuple(sorted(out, key=lambda f: f.number))


def test_schema_is_the_generated_descriptors():
    """Every message, field name, number, type, label, oneof and map
    entry of the codec's table is the generated modules' (map entries
    are no message of their own in the table)."""
    descs = {d.full_name: d for m in MODULES
             for d in m.DESCRIPTOR.message_types_by_name.values()}
    assert set(descs) == set(W.TYPES)
    for name, desc in descs.items():
        assert W.TYPES[name].fields == descriptor_fields(desc), name


# -- conversion between the codec's messages and protobuf's ------------------


def to_pb(msg: W.Message):
    pb = pb_class(msg.full_name)()
    for f in msg._type.fields:
        value = getattr(msg, f.name)
        target = getattr(pb, f.name) if f.message else None
        if f.key is not None:
            for k, sub in value.items():
                target[k].MergeFrom(to_pb(sub))
        elif f.repeated and f.message:
            for sub in value:
                target.add().MergeFrom(to_pb(sub))
        elif f.repeated:
            getattr(pb, f.name).extend(
                [bytes(v) for v in value] if f.type == "bytes" else value)
        elif f.message:
            if value is not None:
                target.SetInParent()
                target.MergeFrom(to_pb(value))
        elif value is not None:
            setattr(pb, f.name, bytes(value) if f.type == "bytes" else value)
    return pb


def from_pb(pb) -> W.Message:
    msg = W.Message(pb.DESCRIPTOR.full_name)
    for f in msg._type.fields:
        value = getattr(pb, f.name)
        if f.key is not None:
            value = {k: from_pb(v) for k, v in value.items()}
        elif f.repeated:
            value = [from_pb(v) for v in value] if f.message else list(value)
        elif f.message:
            value = from_pb(value) if pb.HasField(f.name) else None
        elif f.oneof is not None and pb.WhichOneof(f.oneof) != f.name:
            value = None
        setattr(msg, f.name, value)
    return msg


# -- the encoding rules, each against protobuf's bytes ----------------------


def _pb_plain_with_empty_poly():
    pb = evatpu_pb2.PlainObj()
    pb.poly.SetInParent()
    return pb


def _pb_default_map_entry():
    pb = ckks_pb2.CKKSSignature()
    pb.inputs[""].SetInParent()
    return pb


def _pb_map(keys, cls, field):
    pb = cls()
    for k in keys:
        getattr(pb, field)[k].SetInParent()
    return pb


GALOIS = [5, 0, 300, 2 ** 32 - 1, 25]
NAMES = ["b", "a", "c", "zz", "x1", "ab", "", "é", "B"]
RULES = {
    "negative_zero_double": (
        W.Message("CipherObj", scale=-0.0), evatpu_pb2.CipherObj(scale=-0.0),
        "190000000000000080"),
    "oneof_member_at_zero": (
        W.Message("Attribute", key=0, uint32=0),
        eva_pb2.Attribute(key=0, uint32=0), "1000"),
    "empty_submessage_set": (
        W.Message("PlainObj", poly=W.Message("Poly")),
        _pb_plain_with_empty_poly(), "0a00"),
    "map_entry_at_defaults": (
        W.Message("CKKSSignature", inputs={"": W.Message("CKKSEncodingInfo")}),
        _pb_default_map_entry(), "12040a001200"),
    "negative_int32_packed": (
        W.Message("CKKSParameters", rotations=[-1, 2]),
        ckks_pb2.CKKSParameters(rotations=[-1, 2]),
        "120bffffffffffffffffff0102"),
    "sint32_zigzag": (
        W.Message("Attribute", key=2, int32=-3),
        eva_pb2.Attribute(key=2, int32=-3), "08021805"),
    "uint64_above_2_32": (
        W.Message("TermName", term=2 ** 40 + 5),
        eva_pb2.TermName(term=2 ** 40 + 5), "08858080808020"),
    "uint32_map_order": (
        W.Message("EVAPublicMsg", galois={
            g: W.Message("KSwitchKeyMsg") for g in GALOIS}),
        _pb_map(GALOIS, evatpu_pb2.EVAPublicMsg, "galois"), None),
    "string_map_order": (
        W.Message("CKKSSignature", inputs={
            k: W.Message("CKKSEncodingInfo") for k in NAMES}),
        _pb_map(NAMES, ckks_pb2.CKKSSignature, "inputs"), None),
    "defaults_omitted": (
        W.Message("CipherObj", level=0, scale=0.0, seed=b"", xof=0),
        evatpu_pb2.CipherObj(), ""),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_encoding_rule(rule):
    msg, pb, want = RULES[rule]
    got = W.encode(msg)
    assert got == pb.SerializeToString(deterministic=True)
    if want is not None:
        assert got.hex() == want
    assert W.decode(msg.full_name, got) == msg


@pytest.mark.parametrize("rule", ["uint32_map_order", "string_map_order"])
def test_decodes_protobufs_default_map_order(rule):
    """protobuf's default serialization writes a map in its hash table's
    order; the codec reads those bytes to the same message."""
    msg, pb, _ = RULES[rule]
    assert W.decode(msg.full_name, pb.SerializeToString()) == msg


# -- random messages of every type --------------------------------------------


SCALAR_STRATEGIES = {
    "uint32": st.integers(0, 2 ** 32 - 1),
    "int32": st.integers(-2 ** 31, 2 ** 31 - 1),
    "sint32": st.integers(-2 ** 31, 2 ** 31 - 1),
    "uint64": st.integers(0, 2 ** 64 - 1),
    "double": st.floats(allow_nan=False),
    "string": st.text(max_size=4),
    "bytes": st.binary(max_size=6),
}


def _scalar(type_):
    return st.one_of(st.just(W._DEFAULTS.get(type_, 0)),
                     SCALAR_STRATEGIES[type_])


def messages(name: str):
    """Random messages of type `name`: every field drawn (a submessage
    set or not, a oneof with one member or none), small sizes."""
    t = W.TYPES[name]
    fields, oneofs = {}, {}
    for f in t.fields:
        if f.key is not None:
            fields[f.name] = st.dictionaries(SCALAR_STRATEGIES[f.key],
                                             st.deferred(lambda f=f: messages(f.type)),
                                             max_size=3)
        elif f.repeated:
            elem = (st.deferred(lambda f=f: messages(f.type)) if f.message
                    else SCALAR_STRATEGIES[f.type])
            fields[f.name] = st.lists(elem, max_size=3)
        elif f.oneof is not None:
            value = (st.deferred(lambda f=f: messages(f.type)) if f.message
                     else _scalar(f.type))
            oneofs.setdefault(f.oneof, []).append(
                st.tuples(st.just(f.name), value))
        elif f.message:
            fields[f.name] = st.none() | st.deferred(
                lambda f=f: messages(f.type))
        else:
            fields[f.name] = _scalar(f.type)
    members = [st.none() | st.one_of(m) for m in oneofs.values()]

    def build(chosen, **kw):
        msg = W.Message(name, **kw)
        for member in chosen:
            if member is not None:
                setattr(msg, *member)
        return msg

    return st.builds(build, st.tuples(*members), **fields)


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_random_messages_match_protobuf(name):
    """The codec's bytes are protobuf's deterministic bytes; protobuf
    parses them to an equal message; the codec decodes protobuf's
    default (hash-ordered) bytes to an equal message; two messages
    concatenated decode as protobuf merges them."""

    @SETTINGS
    @given(messages(name), messages(name))
    def check(msg, other):
        pb = to_pb(msg)
        data = W.encode(msg)
        assert data == pb.SerializeToString(deterministic=True)
        parsed = pb_class(name)()
        parsed.ParseFromString(data)
        assert parsed == pb
        assert W.decode(name, pb.SerializeToString()) == msg
        merged = to_pb(msg)
        merged.MergeFromString(W.encode(other))
        assert W.decode(name, data + W.encode(other)) == from_pb(merged)

    check()


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while value > 0x7F:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    return bytes(out + bytes([value]))


def _unpacked(f: W.Field, values) -> bytes:
    """The elements of a repeated numeric field, one field each."""
    if f.type == "double":
        return b"".join(_varint(f.number << 3 | 1) + struct.pack("<d", v)
                        for v in values)
    return b"".join(_varint(f.number << 3) + _varint(v) for v in values)


def field_chunks(msg: W.Message, rng: random.Random):
    """[(field number, bytes)]: each field of `msg` encoded on its own,
    a repeated numeric field split at random into packed and unpacked
    runs."""
    chunks = []
    for f in msg._type.fields:
        value = getattr(msg, f.name)
        if f.repeated and not f.message and f.type not in ("string", "bytes"):
            i = 0
            while i < len(value):
                j = rng.randint(i + 1, len(value))
                run = value[i:j]
                if rng.random() < 0.5:
                    chunks.append((f.number, _unpacked(f, run)))
                else:
                    chunks.append((f.number, W.encode(
                        W.Message(msg.full_name, **{f.name: run}))))
                i = j
        else:
            only = W.Message(msg.full_name, **{f.name: value})
            chunks.append((f.number, W.encode(only)))
    return chunks


def unknown_field(rng: random.Random) -> bytes:
    number = rng.randint(20, 2 ** 29 - 1)
    wt = rng.choice([0, 1, 2, 5])
    noise = lambda n: bytes(rng.getrandbits(8) for _ in range(n))
    body = {0: _varint(rng.getrandbits(64)), 1: noise(8),
            2: _varint(3) + noise(3), 5: noise(4)}[wt]
    return _varint(number << 3 | wt) + body


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_fields_in_any_order_split_and_unknown(name):
    """Fields in a random order, repeated numeric fields split into
    packed and unpacked runs, unknown fields of wire types 0, 1, 2 and 5
    between them: the codec decodes the message (unknown fields
    dropped), and protobuf parses the same bytes to the same message."""

    @SETTINGS
    @given(messages(name), st.randoms(use_true_random=False))
    def check(msg, rng):
        chunks = field_chunks(msg, rng)
        order = []
        pending = {}
        for number, chunk in chunks:  # keep each field's runs in order
            pending.setdefault(number, []).append(chunk)
        while pending:
            number = rng.choice(sorted(pending))
            order.append(pending[number].pop(0))
            if not pending[number]:
                del pending[number]
            if rng.random() < 0.3:
                order.append(unknown_field(rng))
        data = b"".join(order)
        assert W.decode(name, data) == msg
        pb = pb_class(name)()
        pb.ParseFromString(data)
        pb.DiscardUnknownFields()
        assert pb == to_pb(msg)

    check()


# -- malformed buffers ---------------------------------------------------------


MALFORMED = {
    "truncated_tag": ("Poly", b"\x80", "eva.msg.Poly.tag: truncated varint"),
    "truncated_varint": ("Poly", b"\x08\xff\xff",
                         "eva.msg.Poly.n: truncated varint"),
    "long_varint": ("Poly", b"\x08" + b"\xff" * 10 + b"\x01",
                    "eva.msg.Poly.n: varint longer than 10 bytes"),
    "length_past_end": ("Poly", b"\x1a\x05abc",
                        "eva.msg.Poly.data: length 5 past the end"),
    "nested_length_past_end": ("PlainObj", b"\x0a\x03\x1a\x05a",
                               "eva.msg.Poly.data: length 5 past the end"),
    "wire_type_3": ("Poly", b"\x0b", "eva.msg.Poly.n: wire type 3"),
    "wire_type_4": ("Poly", b"\xa4\x01", "eva.msg.Poly.unknown field 20: "
                    "wire type 4 is not supported"),
    "wire_type_6": ("Poly", b"\xa6\x01", "wire type 6 is not supported"),
    "wire_type_7": ("Poly", b"\x0f", "eva.msg.Poly.n: wire type 7"),
    "scalar_on_wrong_wire_type": ("Poly", b"\x09" + b"\0" * 8,
                                  "eva.msg.Poly.n: wire type 1, the schema "
                                  "says uint32"),
    "message_on_wrong_wire_type": ("PlainObj", b"\x08\x01",
                                   "eva.msg.PlainObj.poly: wire type 0"),
    "map_on_wrong_wire_type": ("CKKSSignature", b"\x10\x01",
                               "eva.msg.CKKSSignature.inputs: wire type 0"),
    "truncated_double": ("CipherObj", b"\x19\0\0",
                         "eva.msg.CipherObj.scale: truncated double"),
    "packed_doubles_cut": ("RawObj", b"\x12\x03abc",
                           "eva.msg.RawObj.values: packed doubles of 3"),
    "packed_varint_cut": ("CKKSParameters", b"\x0a\x02\x01\x80",
                          "eva.msg.CKKSParameters.prime_bits: truncated"),
    "string_not_utf8": ("TermName", b"\x12\x01\xff",
                        "eva.msg.TermName.name: string is not UTF-8"),
    "field_number_zero": ("Poly", b"\x00\x01",
                          "eva.msg.Poly.tag: field number 0"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_buffer_raises(case):
    name, data, message = MALFORMED[case]
    with pytest.raises(ValueError) as err:
        W.decode(name, data)
    assert message in str(err.value)


def test_unknown_fields_are_skipped():
    """Unknown fields of each skippable wire type, before, between and
    after known ones, leave the message as it was."""
    data = (b"\xa0\x01\x05" + b"\x08\x07" + b"\xa9\x01" + b"\0" * 8
            + b"\x1a\x02ab" + b"\xaa\x01\x02zz" + b"\xad\x01abcd")
    assert W.decode("Poly", data) == W.Message("Poly", n=7, data=b"ab")
    pb = evatpu_pb2.Poly()
    pb.ParseFromString(data)
    pb.DiscardUnknownFields()
    assert pb == evatpu_pb2.Poly(n=7, data=b"ab")


def test_encode_refuses_out_of_range():
    with pytest.raises(ValueError, match="n: -1 is out of range"):
        W.encode(W.Message("Poly", n=-1))
    with pytest.raises(ValueError, match="out of range for uint32"):
        W.encode(W.Message("CKKSParameters", prime_bits=[2 ** 32]))
    with pytest.raises(AttributeError, match="no field 'nope'"):
        W.Message("Poly", nope=1)
