# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cometbft/types/v1/evidence.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import types_pb2 as cometbft_dot_types_dot_v1_dot_types__pb2
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import validator_pb2 as cometbft_dot_types_dot_v1_dot_validator__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n cometbft/types/v1/evidence.proto\x12\x11\x63ometbft.types.v1\x1a\x1fgoogle/protobuf/timestamp.proto\x1a\x1d\x63ometbft/types/v1/types.proto\x1a!cometbft/types/v1/validator.proto\"\xb4\x01\n\x08\x45vidence\x12K\n\x17\x64uplicate_vote_evidence\x18\x01 \x01(\x0b\x32(.cometbft.types.v1.DuplicateVoteEvidenceH\x00\x12T\n\x1clight_client_attack_evidence\x18\x02 \x01(\x0b\x32,.cometbft.types.v1.LightClientAttackEvidenceH\x00\x42\x05\n\x03sum\"\xcd\x01\n\x15\x44uplicateVoteEvidence\x12\'\n\x06vote_a\x18\x01 \x01(\x0b\x32\x17.cometbft.types.v1.Vote\x12\'\n\x06vote_b\x18\x02 \x01(\x0b\x32\x17.cometbft.types.v1.Vote\x12\x1a\n\x12total_voting_power\x18\x03 \x01(\x03\x12\x17\n\x0fvalidator_power\x18\x04 \x01(\x03\x12-\n\ttimestamp\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\xf3\x01\n\x19LightClientAttackEvidence\x12\x38\n\x11\x63onflicting_block\x18\x01 \x01(\x0b\x32\x1d.cometbft.types.v1.LightBlock\x12\x15\n\rcommon_height\x18\x02 \x01(\x03\x12:\n\x14\x62yzantine_validators\x18\x03 \x03(\x0b\x32\x1c.cometbft.types.v1.Validator\x12\x1a\n\x12total_voting_power\x18\x04 \x01(\x03\x12-\n\ttimestamp\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"=\n\x0c\x45videnceList\x12-\n\x08\x65vidence\x18\x01 \x03(\x0b\x32\x1b.cometbft.types.v1.Evidenceb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cometbft.types.v1.evidence_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EVIDENCE._serialized_start=155
  _EVIDENCE._serialized_end=335
  _DUPLICATEVOTEEVIDENCE._serialized_start=338
  _DUPLICATEVOTEEVIDENCE._serialized_end=543
  _LIGHTCLIENTATTACKEVIDENCE._serialized_start=546
  _LIGHTCLIENTATTACKEVIDENCE._serialized_end=789
  _EVIDENCELIST._serialized_start=791
  _EVIDENCELIST._serialized_end=852
# @@protoc_insertion_point(module_scope)
