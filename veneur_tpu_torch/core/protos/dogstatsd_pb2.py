# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dogstatsd.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x64ogstatsd.proto\x12\tdogstatsd\"\x07\n\x05\x45mpty\"&\n\x0f\x44ogstatsdPacket\x12\x13\n\x0bpacketBytes\x18\x01 \x01(\x0c\x32K\n\rDogstatsdGRPC\x12:\n\nSendPacket\x12\x1a.dogstatsd.DogstatsdPacket\x1a\x10.dogstatsd.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dogstatsd_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=30
  _EMPTY._serialized_end=37
  _DOGSTATSDPACKET._serialized_start=39
  _DOGSTATSDPACKET._serialized_end=77
  _DOGSTATSDGRPC._serialized_start=79
  _DOGSTATSDGRPC._serialized_end=154
# @@protoc_insertion_point(module_scope)
