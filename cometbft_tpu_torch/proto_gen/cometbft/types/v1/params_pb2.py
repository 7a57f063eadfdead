# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cometbft/types/v1/params.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2
from google.protobuf import wrappers_pb2 as google_dot_protobuf_dot_wrappers__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x63ometbft/types/v1/params.proto\x12\x11\x63ometbft.types.v1\x1a\x1egoogle/protobuf/duration.proto\x1a\x1egoogle/protobuf/wrappers.proto\"\xfa\x02\n\x0f\x43onsensusParams\x12-\n\x05\x62lock\x18\x01 \x01(\x0b\x32\x1e.cometbft.types.v1.BlockParams\x12\x33\n\x08\x65vidence\x18\x02 \x01(\x0b\x32!.cometbft.types.v1.EvidenceParams\x12\x35\n\tvalidator\x18\x03 \x01(\x0b\x32\".cometbft.types.v1.ValidatorParams\x12\x31\n\x07version\x18\x04 \x01(\x0b\x32 .cometbft.types.v1.VersionParams\x12/\n\x04\x61\x62\x63i\x18\x05 \x01(\x0b\x32\x1d.cometbft.types.v1.ABCIParamsB\x02\x18\x01\x12\x35\n\tsynchrony\x18\x06 \x01(\x0b\x32\".cometbft.types.v1.SynchronyParams\x12\x31\n\x07\x66\x65\x61ture\x18\x07 \x01(\x0b\x32 .cometbft.types.v1.FeatureParams\"7\n\x0b\x42lockParams\x12\x11\n\tmax_bytes\x18\x01 \x01(\x03\x12\x0f\n\x07max_gas\x18\x02 \x01(\x03J\x04\x08\x03\x10\x04\"t\n\x0e\x45videnceParams\x12\x1a\n\x12max_age_num_blocks\x18\x01 \x01(\x03\x12\x33\n\x10max_age_duration\x18\x02 \x01(\x0b\x32\x19.google.protobuf.Duration\x12\x11\n\tmax_bytes\x18\x03 \x01(\x03\"(\n\x0fValidatorParams\x12\x15\n\rpub_key_types\x18\x01 \x03(\t\"\x1c\n\rVersionParams\x12\x0b\n\x03\x61pp\x18\x01 \x01(\x04\">\n\x0cHashedParams\x12\x17\n\x0f\x62lock_max_bytes\x18\x01 \x01(\x03\x12\x15\n\rblock_max_gas\x18\x02 \x01(\x03\"q\n\x0fSynchronyParams\x12,\n\tprecision\x18\x01 \x01(\x0b\x32\x19.google.protobuf.Duration\x12\x30\n\rmessage_delay\x18\x02 \x01(\x0b\x32\x19.google.protobuf.Duration\"\x8c\x01\n\rFeatureParams\x12\x42\n\x1dvote_extensions_enable_height\x18\x01 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\x12\x37\n\x12pbts_enable_height\x18\x02 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\"7\n\nABCIParams\x12%\n\x1dvote_extensions_enable_height\x18\x01 \x01(\x03:\x02\x18\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cometbft.types.v1.params_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONSENSUSPARAMS.fields_by_name['abci']._options = None
  _CONSENSUSPARAMS.fields_by_name['abci']._serialized_options = b'\030\001'
  _ABCIPARAMS._options = None
  _ABCIPARAMS._serialized_options = b'\030\001'
  _CONSENSUSPARAMS._serialized_start=118
  _CONSENSUSPARAMS._serialized_end=496
  _BLOCKPARAMS._serialized_start=498
  _BLOCKPARAMS._serialized_end=553
  _EVIDENCEPARAMS._serialized_start=555
  _EVIDENCEPARAMS._serialized_end=671
  _VALIDATORPARAMS._serialized_start=673
  _VALIDATORPARAMS._serialized_end=713
  _VERSIONPARAMS._serialized_start=715
  _VERSIONPARAMS._serialized_end=743
  _HASHEDPARAMS._serialized_start=745
  _HASHEDPARAMS._serialized_end=807
  _SYNCHRONYPARAMS._serialized_start=809
  _SYNCHRONYPARAMS._serialized_end=922
  _FEATUREPARAMS._serialized_start=925
  _FEATUREPARAMS._serialized_end=1065
  _ABCIPARAMS._serialized_start=1067
  _ABCIPARAMS._serialized_end=1122
# @@protoc_insertion_point(module_scope)
