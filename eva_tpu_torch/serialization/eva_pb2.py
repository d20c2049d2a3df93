# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: eva.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\teva.proto\x12\x07\x65va.msg\"L\n\x04Term\x12\n\n\x02op\x18\x01 \x01(\r\x12\x10\n\x08operands\x18\x02 \x03(\x04\x12&\n\nattributes\x18\x03 \x03(\x0b\x32\x12.eva.msg.Attribute\"E\n\rConstantValue\x12\x0c\n\x04size\x18\x01 \x01(\r\x12\x0e\n\x06values\x18\x02 \x03(\x01\x12\x16\n\x0esparse_indices\x18\x03 \x03(\r\"\x86\x01\n\tAttribute\x12\x0b\n\x03key\x18\x01 \x01(\r\x12\x10\n\x06uint32\x18\x02 \x01(\rH\x00\x12\x0f\n\x05int32\x18\x03 \x01(\x11H\x00\x12\x0e\n\x04type\x18\x04 \x01(\rH\x00\x12\x30\n\x0e\x63onstant_value\x18\x05 \x01(\x0b\x32\x16.eva.msg.ConstantValueH\x00\x42\x07\n\x05value\"&\n\x08TermName\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xa2\x01\n\x07Program\x12\x12\n\nir_version\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x10\n\x08vec_size\x18\x03 \x01(\r\x12\x1c\n\x05terms\x18\x04 \x03(\x0b\x32\r.eva.msg.Term\x12!\n\x06inputs\x18\x05 \x03(\x0b\x32\x11.eva.msg.TermName\x12\"\n\x07outputs\x18\x06 \x03(\x0b\x32\x11.eva.msg.TermNameb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'eva_tpu_torch.serialization.eva_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TERM._serialized_start=22
  _TERM._serialized_end=98
  _CONSTANTVALUE._serialized_start=100
  _CONSTANTVALUE._serialized_end=169
  _ATTRIBUTE._serialized_start=172
  _ATTRIBUTE._serialized_end=306
  _TERMNAME._serialized_start=308
  _TERMNAME._serialized_end=346
  _PROGRAM._serialized_start=349
  _PROGRAM._serialized_end=511
# @@protoc_insertion_point(module_scope)
