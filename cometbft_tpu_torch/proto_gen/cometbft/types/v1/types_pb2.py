# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cometbft/types/v1/types.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2
from cometbft_tpu_torch.proto_gen.cometbft.crypto.v1 import proof_pb2 as cometbft_dot_crypto_dot_v1_dot_proof__pb2
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import validator_pb2 as cometbft_dot_types_dot_v1_dot_validator__pb2
from cometbft_tpu_torch.proto_gen.cometbft.version.v1 import types_pb2 as cometbft_dot_version_dot_v1_dot_types__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x63ometbft/types/v1/types.proto\x12\x11\x63ometbft.types.v1\x1a\x1fgoogle/protobuf/timestamp.proto\x1a\x1e\x63ometbft/crypto/v1/proof.proto\x1a!cometbft/types/v1/validator.proto\x1a\x1f\x63ometbft/version/v1/types.proto\",\n\rPartSetHeader\x12\r\n\x05total\x18\x01 \x01(\r\x12\x0c\n\x04hash\x18\x02 \x01(\x0c\"N\n\x04Part\x12\r\n\x05index\x18\x01 \x01(\r\x12\r\n\x05\x62ytes\x18\x02 \x01(\x0c\x12(\n\x05proof\x18\x03 \x01(\x0b\x32\x19.cometbft.crypto.v1.Proof\"R\n\x07\x42lockID\x12\x0c\n\x04hash\x18\x01 \x01(\x0c\x12\x39\n\x0fpart_set_header\x18\x02 \x01(\x0b\x32 .cometbft.types.v1.PartSetHeader\"\x92\x03\n\x06Header\x12/\n\x07version\x18\x01 \x01(\x0b\x32\x1e.cometbft.version.v1.Consensus\x12\x10\n\x08\x63hain_id\x18\x02 \x01(\t\x12\x0e\n\x06height\x18\x03 \x01(\x03\x12(\n\x04time\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x31\n\rlast_block_id\x18\x05 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12\x18\n\x10last_commit_hash\x18\x06 \x01(\x0c\x12\x11\n\tdata_hash\x18\x07 \x01(\x0c\x12\x17\n\x0fvalidators_hash\x18\x08 \x01(\x0c\x12\x1c\n\x14next_validators_hash\x18\t \x01(\x0c\x12\x16\n\x0e\x63onsensus_hash\x18\n \x01(\x0c\x12\x10\n\x08\x61pp_hash\x18\x0b \x01(\x0c\x12\x19\n\x11last_results_hash\x18\x0c \x01(\x0c\x12\x15\n\revidence_hash\x18\r \x01(\x0c\x12\x18\n\x10proposer_address\x18\x0e \x01(\x0c\"\x13\n\x04\x44\x61ta\x12\x0b\n\x03txs\x18\x01 \x03(\x0c\"\xa9\x02\n\x04Vote\x12.\n\x04type\x18\x01 \x01(\x0e\x32 .cometbft.types.v1.SignedMsgType\x12\x0e\n\x06height\x18\x02 \x01(\x03\x12\r\n\x05round\x18\x03 \x01(\x05\x12,\n\x08\x62lock_id\x18\x04 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12-\n\ttimestamp\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x19\n\x11validator_address\x18\x06 \x01(\x0c\x12\x17\n\x0fvalidator_index\x18\x07 \x01(\x05\x12\x11\n\tsignature\x18\x08 \x01(\x0c\x12\x11\n\textension\x18\t \x01(\x0c\x12\x1b\n\x13\x65xtension_signature\x18\n \x01(\x0c\"\x87\x01\n\x06\x43ommit\x12\x0e\n\x06height\x18\x01 \x01(\x03\x12\r\n\x05round\x18\x02 \x01(\x05\x12,\n\x08\x62lock_id\x18\x03 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12\x30\n\nsignatures\x18\x04 \x03(\x0b\x32\x1c.cometbft.types.v1.CommitSig\"\x9f\x01\n\tCommitSig\x12\x35\n\rblock_id_flag\x18\x01 \x01(\x0e\x32\x1e.cometbft.types.v1.BlockIDFlag\x12\x19\n\x11validator_address\x18\x02 \x01(\x0c\x12-\n\ttimestamp\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x11\n\tsignature\x18\x04 \x01(\x0c\"\xa0\x01\n\x0e\x45xtendedCommit\x12\x0e\n\x06height\x18\x01 \x01(\x03\x12\r\n\x05round\x18\x02 \x01(\x05\x12,\n\x08\x62lock_id\x18\x03 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12\x41\n\x13\x65xtended_signatures\x18\x04 \x03(\x0b\x32$.cometbft.types.v1.ExtendedCommitSig\"\xd7\x01\n\x11\x45xtendedCommitSig\x12\x35\n\rblock_id_flag\x18\x01 \x01(\x0e\x32\x1e.cometbft.types.v1.BlockIDFlag\x12\x19\n\x11validator_address\x18\x02 \x01(\x0c\x12-\n\ttimestamp\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x11\n\tsignature\x18\x04 \x01(\x0c\x12\x11\n\textension\x18\x05 \x01(\x0c\x12\x1b\n\x13\x65xtension_signature\x18\x06 \x01(\x0c\"\xdc\x01\n\x08Proposal\x12.\n\x04type\x18\x01 \x01(\x0e\x32 .cometbft.types.v1.SignedMsgType\x12\x0e\n\x06height\x18\x02 \x01(\x03\x12\r\n\x05round\x18\x03 \x01(\x05\x12\x11\n\tpol_round\x18\x04 \x01(\x05\x12,\n\x08\x62lock_id\x18\x05 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12-\n\ttimestamp\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x11\n\tsignature\x18\x07 \x01(\x0c\"d\n\x0cSignedHeader\x12)\n\x06header\x18\x01 \x01(\x0b\x32\x19.cometbft.types.v1.Header\x12)\n\x06\x63ommit\x18\x02 \x01(\x0b\x32\x19.cometbft.types.v1.Commit\"|\n\nLightBlock\x12\x36\n\rsigned_header\x18\x01 \x01(\x0b\x32\x1f.cometbft.types.v1.SignedHeader\x12\x36\n\rvalidator_set\x18\x02 \x01(\x0b\x32\x1f.cometbft.types.v1.ValidatorSet\"\x89\x01\n\tBlockMeta\x12,\n\x08\x62lock_id\x18\x01 \x01(\x0b\x32\x1a.cometbft.types.v1.BlockID\x12\x12\n\nblock_size\x18\x02 \x01(\x03\x12)\n\x06header\x18\x03 \x01(\x0b\x32\x19.cometbft.types.v1.Header\x12\x0f\n\x07num_txs\x18\x04 \x01(\x03\"T\n\x07TxProof\x12\x11\n\troot_hash\x18\x01 \x01(\x0c\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12(\n\x05proof\x18\x03 \x01(\x0b\x32\x19.cometbft.crypto.v1.Proof*\x86\x01\n\rSignedMsgType\x12\x1b\n\x17SIGNED_MSG_TYPE_UNKNOWN\x10\x00\x12\x1b\n\x17SIGNED_MSG_TYPE_PREVOTE\x10\x01\x12\x1d\n\x19SIGNED_MSG_TYPE_PRECOMMIT\x10\x02\x12\x1c\n\x18SIGNED_MSG_TYPE_PROPOSAL\x10 b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cometbft.types.v1.types_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SIGNEDMSGTYPE._serialized_start=2480
  _SIGNEDMSGTYPE._serialized_end=2614
  _PARTSETHEADER._serialized_start=185
  _PARTSETHEADER._serialized_end=229
  _PART._serialized_start=231
  _PART._serialized_end=309
  _BLOCKID._serialized_start=311
  _BLOCKID._serialized_end=393
  _HEADER._serialized_start=396
  _HEADER._serialized_end=798
  _DATA._serialized_start=800
  _DATA._serialized_end=819
  _VOTE._serialized_start=822
  _VOTE._serialized_end=1119
  _COMMIT._serialized_start=1122
  _COMMIT._serialized_end=1257
  _COMMITSIG._serialized_start=1260
  _COMMITSIG._serialized_end=1419
  _EXTENDEDCOMMIT._serialized_start=1422
  _EXTENDEDCOMMIT._serialized_end=1582
  _EXTENDEDCOMMITSIG._serialized_start=1585
  _EXTENDEDCOMMITSIG._serialized_end=1800
  _PROPOSAL._serialized_start=1803
  _PROPOSAL._serialized_end=2023
  _SIGNEDHEADER._serialized_start=2025
  _SIGNEDHEADER._serialized_end=2125
  _LIGHTBLOCK._serialized_start=2127
  _LIGHTBLOCK._serialized_end=2251
  _BLOCKMETA._serialized_start=2254
  _BLOCKMETA._serialized_end=2391
  _TXPROOF._serialized_start=2393
  _TXPROOF._serialized_end=2477
# @@protoc_insertion_point(module_scope)
