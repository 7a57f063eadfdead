# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cometbft/types/v1/validator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from cometbft_tpu_torch.proto_gen.cometbft.crypto.v1 import keys_pb2 as cometbft_dot_crypto_dot_v1_dot_keys__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!cometbft/types/v1/validator.proto\x12\x11\x63ometbft.types.v1\x1a\x1d\x63ometbft/crypto/v1/keys.proto\"\x8c\x01\n\x0cValidatorSet\x12\x30\n\nvalidators\x18\x01 \x03(\x0b\x32\x1c.cometbft.types.v1.Validator\x12.\n\x08proposer\x18\x02 \x01(\x0b\x32\x1c.cometbft.types.v1.Validator\x12\x1a\n\x12total_voting_power\x18\x03 \x01(\x03\"\xae\x01\n\tValidator\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\x0c\x12\x32\n\x07pub_key\x18\x02 \x01(\x0b\x32\x1d.cometbft.crypto.v1.PublicKeyB\x02\x18\x01\x12\x14\n\x0cvoting_power\x18\x03 \x01(\x03\x12\x19\n\x11proposer_priority\x18\x04 \x01(\x03\x12\x15\n\rpub_key_bytes\x18\x05 \x01(\x0c\x12\x14\n\x0cpub_key_type\x18\x06 \x01(\t\"W\n\x0fSimpleValidator\x12.\n\x07pub_key\x18\x01 \x01(\x0b\x32\x1d.cometbft.crypto.v1.PublicKey\x12\x14\n\x0cvoting_power\x18\x02 \x01(\x03*s\n\x0b\x42lockIDFlag\x12\x19\n\x15\x42LOCK_ID_FLAG_UNKNOWN\x10\x00\x12\x18\n\x14\x42LOCK_ID_FLAG_ABSENT\x10\x01\x12\x18\n\x14\x42LOCK_ID_FLAG_COMMIT\x10\x02\x12\x15\n\x11\x42LOCK_ID_FLAG_NIL\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cometbft.types.v1.validator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VALIDATOR.fields_by_name['pub_key']._options = None
  _VALIDATOR.fields_by_name['pub_key']._serialized_options = b'\030\001'
  _BLOCKIDFLAG._serialized_start=496
  _BLOCKIDFLAG._serialized_end=611
  _VALIDATORSET._serialized_start=88
  _VALIDATORSET._serialized_end=228
  _VALIDATOR._serialized_start=231
  _VALIDATOR._serialized_end=405
  _SIMPLEVALIDATOR._serialized_start=407
  _SIMPLEVALIDATOR._serialized_end=494
# @@protoc_insertion_point(module_scope)
