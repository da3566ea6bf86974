# -*- coding: utf-8 -*-
# Generated by tools/gen_common_pb2.py (protoc-compatible layout).  DO NOT EDIT!
# source: common/common.proto
# drand_tpu_torch copy: imports written as package imports, module names
# under drand_tpu_torch.protogen; the descriptors are unchanged.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13common/common.proto\x12\x06common"b\n\x0bNodeVersion\x12\r\n\x05major\x18\x01 \x01(\r\x12\r\n\x05minor\x18\x02 \x01(\r\x12\r\n\x05patch\x18\x03 \x01(\r\x12\x17\n\nprerelease\x18\x04 \x01(\tH\x00\x88\x01\x01B\r\n\x0b_prerelease"\x93\x01\n\x08Metadata\x12)\n\x0cnode_version\x18\x01 \x01(\x0b2\x13.common.NodeVersion\x12\x10\n\x08beaconID\x18\x02 \x01(\t\x12\x12\n\nchain_hash\x18\x03 \x01(\x0c\x12\x10\n\x08trace_id\x18\x04 \x01(\x0c\x12\x0f\n\x07span_id\x18\x05 \x01(\x0c\x12\x13\n\x0bdeadline_ms\x18\x06 \x01(\x04b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drand_tpu_torch.protogen.common.common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEVERSION._serialized_start=31
  _NODEVERSION._serialized_end=129
  _METADATA._serialized_start=132
  _METADATA._serialized_end=279
# @@protoc_insertion_point(module_scope)
