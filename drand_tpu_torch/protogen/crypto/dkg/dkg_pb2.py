# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: crypto/dkg/dkg.proto
# drand_tpu_torch copy: imports written as package imports, module names
# under drand_tpu_torch.protogen; the descriptors are unchanged.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from drand_tpu_torch.protogen.common import common_pb2 as common_dot_common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14\x63rypto/dkg/dkg.proto\x12\x03\x64kg\x1a\x13\x63ommon/common.proto\"\xb3\x01\n\x06Packet\x12\x1f\n\x04\x64\x65\x61l\x18\x01 \x01(\x0b\x32\x0f.dkg.DealBundleH\x00\x12\'\n\x08response\x18\x02 \x01(\x0b\x32\x13.dkg.ResponseBundleH\x00\x12\x31\n\rjustification\x18\x03 \x01(\x0b\x32\x18.dkg.JustificationBundleH\x00\x12\"\n\x08metadata\x18\x04 \x01(\x0b\x32\x10.common.MetadataB\x08\n\x06\x42undle\"t\n\nDealBundle\x12\x14\n\x0c\x64\x65\x61ler_index\x18\x01 \x01(\r\x12\x0f\n\x07\x63ommits\x18\x02 \x03(\x0c\x12\x18\n\x05\x64\x65\x61ls\x18\x03 \x03(\x0b\x32\t.dkg.Deal\x12\x12\n\nsession_id\x18\x04 \x01(\x0c\x12\x11\n\tsignature\x18\x05 \x01(\x0c\"4\n\x04\x44\x65\x61l\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12\x17\n\x0f\x65ncrypted_share\x18\x02 \x01(\x0c\"n\n\x0eResponseBundle\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12 \n\tresponses\x18\x02 \x03(\x0b\x32\r.dkg.Response\x12\x12\n\nsession_id\x18\x03 \x01(\x0c\x12\x11\n\tsignature\x18\x04 \x01(\x0c\"0\n\x08Response\x12\x14\n\x0c\x64\x65\x61ler_index\x18\x01 \x01(\r\x12\x0e\n\x06status\x18\x02 \x01(\x08\"~\n\x13JustificationBundle\x12\x14\n\x0c\x64\x65\x61ler_index\x18\x01 \x01(\r\x12*\n\x0ejustifications\x18\x02 \x03(\x0b\x32\x12.dkg.Justification\x12\x12\n\nsession_id\x18\x03 \x01(\x0c\x12\x11\n\tsignature\x18\x04 \x01(\x0c\"3\n\rJustification\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12\r\n\x05share\x18\x02 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drand_tpu_torch.protogen.crypto.dkg.dkg_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PACKET._serialized_start=51
  _PACKET._serialized_end=230
  _DEALBUNDLE._serialized_start=232
  _DEALBUNDLE._serialized_end=348
  _DEAL._serialized_start=350
  _DEAL._serialized_end=402
  _RESPONSEBUNDLE._serialized_start=404
  _RESPONSEBUNDLE._serialized_end=514
  _RESPONSE._serialized_start=516
  _RESPONSE._serialized_end=564
  _JUSTIFICATIONBUNDLE._serialized_start=566
  _JUSTIFICATIONBUNDLE._serialized_end=692
  _JUSTIFICATION._serialized_start=694
  _JUSTIFICATION._serialized_end=745
# @@protoc_insertion_point(module_scope)
