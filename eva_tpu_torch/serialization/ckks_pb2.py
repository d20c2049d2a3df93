# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ckks.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nckks.proto\x12\x07\x65va.msg\"g\n\x0e\x43KKSParameters\x12\x12\n\nprime_bits\x18\x01 \x03(\r\x12\x11\n\trotations\x18\x02 \x03(\x05\x12\x1b\n\x13poly_modulus_degree\x18\x03 \x01(\r\x12\x11\n\tkey_terms\x18\x04 \x01(\r\"D\n\x10\x43KKSEncodingInfo\x12\x12\n\ninput_type\x18\x01 \x01(\x05\x12\r\n\x05scale\x18\x02 \x01(\x05\x12\r\n\x05level\x18\x03 \x01(\x05\"\x9f\x01\n\rCKKSSignature\x12\x10\n\x08vec_size\x18\x01 \x01(\x05\x12\x32\n\x06inputs\x18\x02 \x03(\x0b\x32\".eva.msg.CKKSSignature.InputsEntry\x1aH\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.eva.msg.CKKSEncodingInfo:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'eva_tpu_torch.serialization.ckks_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CKKSSIGNATURE_INPUTSENTRY._options = None
  _CKKSSIGNATURE_INPUTSENTRY._serialized_options = b'8\001'
  _CKKSPARAMETERS._serialized_start=23
  _CKKSPARAMETERS._serialized_end=126
  _CKKSENCODINGINFO._serialized_start=128
  _CKKSENCODINGINFO._serialized_end=196
  _CKKSSIGNATURE._serialized_start=199
  _CKKSSIGNATURE._serialized_end=358
  _CKKSSIGNATURE_INPUTSENTRY._serialized_start=286
  _CKKSSIGNATURE_INPUTSENTRY._serialized_end=358
# @@protoc_insertion_point(module_scope)
