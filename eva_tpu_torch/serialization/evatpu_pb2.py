# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: evatpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import ckks_pb2 as ckks__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x65vatpu.proto\x12\x07\x65va.msg\x1a\nckks.proto\">\n\x04Poly\x12\t\n\x01n\x18\x01 \x01(\r\x12\r\n\x05n_sub\x18\x02 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\x12\x0e\n\x06shards\x18\x04 \x01(\r\"b\n\tCipherObj\x12\x1c\n\x05polys\x18\x01 \x03(\x0b\x32\r.eva.msg.Poly\x12\r\n\x05level\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\x01\x12\x0c\n\x04seed\x18\x04 \x01(\x0c\x12\x0b\n\x03xof\x18\x05 \x01(\r\"E\n\x08PlainObj\x12\x1b\n\x04poly\x18\x01 \x01(\x0b\x32\r.eva.msg.Poly\x12\r\n\x05level\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\x01\"&\n\x06RawObj\x12\x0c\n\x04size\x18\x01 \x01(\r\x12\x0e\n\x06values\x18\x02 \x03(\x01\"\x92\x03\n\x0c\x45VAValuation\x12\'\n\x06params\x18\x01 \x01(\x0b\x32\x17.eva.msg.CKKSParameters\x12\x33\n\x07\x63iphers\x18\x02 \x03(\x0b\x32\".eva.msg.EVAValuation.CiphersEntry\x12\x31\n\x06plains\x18\x03 \x03(\x0b\x32!.eva.msg.EVAValuation.PlainsEntry\x12-\n\x04raws\x18\x04 \x03(\x0b\x32\x1f.eva.msg.EVAValuation.RawsEntry\x1a\x42\n\x0c\x43iphersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12!\n\x05value\x18\x02 \x01(\x0b\x32\x12.eva.msg.CipherObj:\x02\x38\x01\x1a@\n\x0bPlainsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.eva.msg.PlainObj:\x02\x38\x01\x1a<\n\tRawsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1e\n\x05value\x18\x02 \x01(\x0b\x32\x0f.eva.msg.RawObj:\x02\x38\x01\"v\n\rKSwitchKeyMsg\x12\x19\n\x02k0\x18\x01 \x03(\x0b\x32\r.eva.msg.Poly\x12\x19\n\x02k1\x18\x02 \x03(\x0b\x32\r.eva.msg.Poly\x12\x10\n\x08k1_seeds\x18\x03 \x03(\x0c\x12\x10\n\x08ks_alpha\x18\x04 \x01(\r\x12\x0b\n\x03xof\x18\x05 \x01(\r\"\xb5\x02\n\x0c\x45VAPublicMsg\x12\'\n\x06params\x18\x01 \x01(\x0b\x32\x17.eva.msg.CKKSParameters\x12\x1b\n\x04pk_b\x18\x02 \x01(\x0b\x32\r.eva.msg.Poly\x12\x1b\n\x04pk_a\x18\x03 \x01(\x0b\x32\r.eva.msg.Poly\x12%\n\x05relin\x18\x04 \x01(\x0b\x32\x16.eva.msg.KSwitchKeyMsg\x12\x31\n\x06galois\x18\x05 \x03(\x0b\x32!.eva.msg.EVAPublicMsg.GaloisEntry\x12\x11\n\tpk_a_seed\x18\x06 \x01(\x0c\x12\x0e\n\x06pk_xof\x18\x07 \x01(\r\x1a\x45\n\x0bGaloisEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.eva.msg.KSwitchKeyMsg:\x02\x38\x01\"N\n\x0c\x45VASecretMsg\x12\'\n\x06params\x18\x01 \x01(\x0b\x32\x17.eva.msg.CKKSParameters\x12\x15\n\rsecret_coeffs\x18\x02 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'eva_tpu_torch.serialization.evatpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EVAVALUATION_CIPHERSENTRY._options = None
  _EVAVALUATION_CIPHERSENTRY._serialized_options = b'8\001'
  _EVAVALUATION_PLAINSENTRY._options = None
  _EVAVALUATION_PLAINSENTRY._serialized_options = b'8\001'
  _EVAVALUATION_RAWSENTRY._options = None
  _EVAVALUATION_RAWSENTRY._serialized_options = b'8\001'
  _EVAPUBLICMSG_GALOISENTRY._options = None
  _EVAPUBLICMSG_GALOISENTRY._serialized_options = b'8\001'
  _POLY._serialized_start=37
  _POLY._serialized_end=99
  _CIPHEROBJ._serialized_start=101
  _CIPHEROBJ._serialized_end=199
  _PLAINOBJ._serialized_start=201
  _PLAINOBJ._serialized_end=270
  _RAWOBJ._serialized_start=272
  _RAWOBJ._serialized_end=310
  _EVAVALUATION._serialized_start=313
  _EVAVALUATION._serialized_end=715
  _EVAVALUATION_CIPHERSENTRY._serialized_start=521
  _EVAVALUATION_CIPHERSENTRY._serialized_end=587
  _EVAVALUATION_PLAINSENTRY._serialized_start=589
  _EVAVALUATION_PLAINSENTRY._serialized_end=653
  _EVAVALUATION_RAWSENTRY._serialized_start=655
  _EVAVALUATION_RAWSENTRY._serialized_end=715
  _KSWITCHKEYMSG._serialized_start=717
  _KSWITCHKEYMSG._serialized_end=835
  _EVAPUBLICMSG._serialized_start=838
  _EVAPUBLICMSG._serialized_end=1147
  _EVAPUBLICMSG_GALOISENTRY._serialized_start=1078
  _EVAPUBLICMSG_GALOISENTRY._serialized_end=1147
  _EVASECRETMSG._serialized_start=1149
  _EVASECRETMSG._serialized_end=1227
# @@protoc_insertion_point(module_scope)
