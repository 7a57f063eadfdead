# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cometbft/abci/v1/types.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2
from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2
from cometbft_tpu_torch.proto_gen.cometbft.crypto.v1 import proof_pb2 as cometbft_dot_crypto_dot_v1_dot_proof__pb2
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import params_pb2 as cometbft_dot_types_dot_v1_dot_params__pb2
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import validator_pb2 as cometbft_dot_types_dot_v1_dot_validator__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1c\x63ometbft/abci/v1/types.proto\x12\x10\x63ometbft.abci.v1\x1a\x1fgoogle/protobuf/timestamp.proto\x1a\x1egoogle/protobuf/duration.proto\x1a\x1e\x63ometbft/crypto/v1/proof.proto\x1a\x1e\x63ometbft/types/v1/params.proto\x1a!cometbft/types/v1/validator.proto\"\x1e\n\x0b\x45\x63hoRequest\x12\x0f\n\x07message\x18\x01 \x01(\t\"\x0e\n\x0c\x46lushRequest\"`\n\x0bInfoRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x15\n\rblock_version\x18\x02 \x01(\x04\x12\x13\n\x0bp2p_version\x18\x03 \x01(\x04\x12\x14\n\x0c\x61\x62\x63i_version\x18\x04 \x01(\t\"\xf4\x01\n\x10InitChainRequest\x12(\n\x04time\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x10\n\x08\x63hain_id\x18\x02 \x01(\t\x12<\n\x10\x63onsensus_params\x18\x03 \x01(\x0b\x32\".cometbft.types.v1.ConsensusParams\x12\x35\n\nvalidators\x18\x04 \x03(\x0b\x32!.cometbft.abci.v1.ValidatorUpdate\x12\x17\n\x0f\x61pp_state_bytes\x18\x05 \x01(\x0c\x12\x16\n\x0einitial_height\x18\x06 \x01(\x03\"I\n\x0cQueryRequest\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\x0e\n\x06height\x18\x03 \x01(\x03\x12\r\n\x05prove\x18\x04 \x01(\x08\"O\n\x0e\x43heckTxRequest\x12\n\n\x02tx\x18\x01 \x01(\x0c\x12+\n\x04type\x18\x03 \x01(\x0e\x32\x1d.cometbft.abci.v1.CheckTxTypeJ\x04\x08\x02\x10\x03\"\x0f\n\rCommitRequest\"\x16\n\x14ListSnapshotsRequest\"V\n\x14OfferSnapshotRequest\x12,\n\x08snapshot\x18\x01 \x01(\x0b\x32\x1a.cometbft.abci.v1.Snapshot\x12\x10\n\x08\x61pp_hash\x18\x02 \x01(\x0c\"I\n\x18LoadSnapshotChunkRequest\x12\x0e\n\x06height\x18\x01 \x01(\x04\x12\x0e\n\x06\x66ormat\x18\x02 \x01(\r\x12\r\n\x05\x63hunk\x18\x03 \x01(\r\"I\n\x19\x41pplySnapshotChunkRequest\x12\r\n\x05index\x18\x01 \x01(\r\x12\r\n\x05\x63hunk\x18\x02 \x01(\x0c\x12\x0e\n\x06sender\x18\x03 \x01(\t\"\xa2\x02\n\x16PrepareProposalRequest\x12\x14\n\x0cmax_tx_bytes\x18\x01 \x01(\x03\x12\x0b\n\x03txs\x18\x02 \x03(\x0c\x12?\n\x11local_last_commit\x18\x03 \x01(\x0b\x32$.cometbft.abci.v1.ExtendedCommitInfo\x12\x32\n\x0bmisbehavior\x18\x04 \x03(\x0b\x32\x1d.cometbft.abci.v1.Misbehavior\x12\x0e\n\x06height\x18\x05 \x01(\x03\x12(\n\x04time\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x1c\n\x14next_validators_hash\x18\x07 \x01(\x0c\x12\x18\n\x10proposer_address\x18\x08 \x01(\x0c\"\x95\x02\n\x16ProcessProposalRequest\x12\x0b\n\x03txs\x18\x01 \x03(\x0c\x12:\n\x14proposed_last_commit\x18\x02 \x01(\x0b\x32\x1c.cometbft.abci.v1.CommitInfo\x12\x32\n\x0bmisbehavior\x18\x03 \x03(\x0b\x32\x1d.cometbft.abci.v1.Misbehavior\x12\x0c\n\x04hash\x18\x04 \x01(\x0c\x12\x0e\n\x06height\x18\x05 \x01(\x03\x12(\n\x04time\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x1c\n\x14next_validators_hash\x18\x07 \x01(\x0c\x12\x18\n\x10proposer_address\x18\x08 \x01(\x0c\"\x90\x02\n\x11\x45xtendVoteRequest\x12\x0c\n\x04hash\x18\x01 \x01(\x0c\x12\x0e\n\x06height\x18\x02 \x01(\x03\x12(\n\x04time\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x0b\n\x03txs\x18\x04 \x03(\x0c\x12:\n\x14proposed_last_commit\x18\x05 \x01(\x0b\x32\x1c.cometbft.abci.v1.CommitInfo\x12\x32\n\x0bmisbehavior\x18\x06 \x03(\x0b\x32\x1d.cometbft.abci.v1.Misbehavior\x12\x1c\n\x14next_validators_hash\x18\x07 \x01(\x0c\x12\x18\n\x10proposer_address\x18\x08 \x01(\x0c\"m\n\x1aVerifyVoteExtensionRequest\x12\x0c\n\x04hash\x18\x01 \x01(\x0c\x12\x19\n\x11validator_address\x18\x02 \x01(\x0c\x12\x0e\n\x06height\x18\x03 \x01(\x03\x12\x16\n\x0evote_extension\x18\x04 \x01(\x0c\"\xad\x02\n\x14\x46inalizeBlockRequest\x12\x0b\n\x03txs\x18\x01 \x03(\x0c\x12\x39\n\x13\x64\x65\x63ided_last_commit\x18\x02 \x01(\x0b\x32\x1c.cometbft.abci.v1.CommitInfo\x12\x32\n\x0bmisbehavior\x18\x03 \x03(\x0b\x32\x1d.cometbft.abci.v1.Misbehavior\x12\x0c\n\x04hash\x18\x04 \x01(\x0c\x12\x0e\n\x06height\x18\x05 \x01(\x03\x12(\n\x04time\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x1c\n\x14next_validators_hash\x18\x07 \x01(\x0c\x12\x18\n\x10proposer_address\x18\x08 \x01(\x0c\x12\x19\n\x11syncing_to_height\x18\t \x01(\x03\"\"\n\x11\x45xceptionResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x1f\n\x0c\x45\x63hoResponse\x12\x0f\n\x07message\x18\x01 \x01(\t\"\x0f\n\rFlushResponse\"\x94\x02\n\x0cInfoResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x13\n\x0b\x61pp_version\x18\x03 \x01(\x04\x12\x19\n\x11last_block_height\x18\x04 \x01(\x03\x12\x1b\n\x13last_block_app_hash\x18\x05 \x01(\x0c\x12K\n\x0flane_priorities\x18\x06 \x03(\x0b\x32\x32.cometbft.abci.v1.InfoResponse.LanePrioritiesEntry\x12\x14\n\x0c\x64\x65\x66\x61ult_lane\x18\x07 \x01(\t\x1a\x35\n\x13LanePrioritiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\r:\x02\x38\x01\"\x9a\x01\n\x11InitChainResponse\x12<\n\x10\x63onsensus_params\x18\x01 \x01(\x0b\x32\".cometbft.types.v1.ConsensusParams\x12\x35\n\nvalidators\x18\x02 \x03(\x0b\x32!.cometbft.abci.v1.ValidatorUpdate\x12\x10\n\x08\x61pp_hash\x18\x03 \x01(\x0c\"\xb7\x01\n\rQueryResponse\x12\x0c\n\x04\x63ode\x18\x01 \x01(\r\x12\x0b\n\x03log\x18\x03 \x01(\t\x12\x0c\n\x04info\x18\x04 \x01(\t\x12\r\n\x05index\x18\x05 \x01(\x03\x12\x0b\n\x03key\x18\x06 \x01(\x0c\x12\r\n\x05value\x18\x07 \x01(\x0c\x12/\n\tproof_ops\x18\x08 \x01(\x0b\x32\x1c.cometbft.crypto.v1.ProofOps\x12\x0e\n\x06height\x18\t \x01(\x03\x12\x11\n\tcodespace\x18\n \x01(\t\"\xb0\x01\n\x0f\x43heckTxResponse\x12\x0c\n\x04\x63ode\x18\x01 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12\x0b\n\x03log\x18\x03 \x01(\t\x12\x0c\n\x04info\x18\x04 \x01(\t\x12\x12\n\ngas_wanted\x18\x05 \x01(\x03\x12\x10\n\x08gas_used\x18\x06 \x01(\x03\x12\'\n\x06\x65vents\x18\x07 \x03(\x0b\x32\x17.cometbft.abci.v1.Event\x12\x11\n\tcodespace\x18\x08 \x01(\tJ\x04\x08\t\x10\x0c\"3\n\x0e\x43ommitResponse\x12\x15\n\rretain_height\x18\x03 \x01(\x03J\x04\x08\x01\x10\x02J\x04\x08\x02\x10\x03\"F\n\x15ListSnapshotsResponse\x12-\n\tsnapshots\x18\x01 \x03(\x0b\x32\x1a.cometbft.abci.v1.Snapshot\"N\n\x15OfferSnapshotResponse\x12\x35\n\x06result\x18\x01 \x01(\x0e\x32%.cometbft.abci.v1.OfferSnapshotResult\"*\n\x19LoadSnapshotChunkResponse\x12\r\n\x05\x63hunk\x18\x01 \x01(\x0c\"\x88\x01\n\x1a\x41pplySnapshotChunkResponse\x12:\n\x06result\x18\x01 \x01(\x0e\x32*.cometbft.abci.v1.ApplySnapshotChunkResult\x12\x16\n\x0erefetch_chunks\x18\x02 \x03(\r\x12\x16\n\x0ereject_senders\x18\x03 \x03(\t\"&\n\x17PrepareProposalResponse\x12\x0b\n\x03txs\x18\x01 \x03(\x0c\"R\n\x17ProcessProposalResponse\x12\x37\n\x06status\x18\x01 \x01(\x0e\x32\'.cometbft.abci.v1.ProcessProposalStatus\",\n\x12\x45xtendVoteResponse\x12\x16\n\x0evote_extension\x18\x01 \x01(\x0c\"Z\n\x1bVerifyVoteExtensionResponse\x12;\n\x06status\x18\x01 \x01(\x0e\x32+.cometbft.abci.v1.VerifyVoteExtensionStatus\"\xbe\x02\n\x15\x46inalizeBlockResponse\x12\'\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x17.cometbft.abci.v1.Event\x12\x32\n\ntx_results\x18\x02 \x03(\x0b\x32\x1e.cometbft.abci.v1.ExecTxResult\x12<\n\x11validator_updates\x18\x03 \x03(\x0b\x32!.cometbft.abci.v1.ValidatorUpdate\x12\x43\n\x17\x63onsensus_param_updates\x18\x04 \x01(\x0b\x32\".cometbft.types.v1.ConsensusParams\x12\x10\n\x08\x61pp_hash\x18\x05 \x01(\x0c\x12\x33\n\x10next_block_delay\x18\x06 \x01(\x0b\x32\x19.google.protobuf.Duration\"F\n\nCommitInfo\x12\r\n\x05round\x18\x01 \x01(\x05\x12)\n\x05votes\x18\x02 \x03(\x0b\x32\x1a.cometbft.abci.v1.VoteInfo\"V\n\x12\x45xtendedCommitInfo\x12\r\n\x05round\x18\x01 \x01(\x05\x12\x31\n\x05votes\x18\x02 \x03(\x0b\x32\".cometbft.abci.v1.ExtendedVoteInfo\"K\n\x05\x45vent\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x34\n\nattributes\x18\x02 \x03(\x0b\x32 .cometbft.abci.v1.EventAttribute\";\n\x0e\x45ventAttribute\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\r\n\x05index\x18\x03 \x01(\x08\"\xa7\x01\n\x0c\x45xecTxResult\x12\x0c\n\x04\x63ode\x18\x01 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12\x0b\n\x03log\x18\x03 \x01(\t\x12\x0c\n\x04info\x18\x04 \x01(\t\x12\x12\n\ngas_wanted\x18\x05 \x01(\x03\x12\x10\n\x08gas_used\x18\x06 \x01(\x03\x12\'\n\x06\x65vents\x18\x07 \x03(\x0b\x32\x17.cometbft.abci.v1.Event\x12\x11\n\tcodespace\x18\x08 \x01(\t\"e\n\x08TxResult\x12\x0e\n\x06height\x18\x01 \x01(\x03\x12\r\n\x05index\x18\x02 \x01(\r\x12\n\n\x02tx\x18\x03 \x01(\x0c\x12.\n\x06result\x18\x04 \x01(\x0b\x32\x1e.cometbft.abci.v1.ExecTxResult\"1\n\tValidator\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\x0c\x12\r\n\x05power\x18\x03 \x01(\x03J\x04\x08\x02\x10\x03\"S\n\x0fValidatorUpdate\x12\r\n\x05power\x18\x02 \x01(\x03\x12\x15\n\rpub_key_bytes\x18\x03 \x01(\x0c\x12\x14\n\x0cpub_key_type\x18\x04 \x01(\tJ\x04\x08\x01\x10\x02\"w\n\x08VoteInfo\x12.\n\tvalidator\x18\x01 \x01(\x0b\x32\x1b.cometbft.abci.v1.Validator\x12\x35\n\rblock_id_flag\x18\x03 \x01(\x0e\x32\x1e.cometbft.types.v1.BlockIDFlagJ\x04\x08\x02\x10\x03\"\xb4\x01\n\x10\x45xtendedVoteInfo\x12.\n\tvalidator\x18\x01 \x01(\x0b\x32\x1b.cometbft.abci.v1.Validator\x12\x16\n\x0evote_extension\x18\x03 \x01(\x0c\x12\x1b\n\x13\x65xtension_signature\x18\x04 \x01(\x0c\x12\x35\n\rblock_id_flag\x18\x05 \x01(\x0e\x32\x1e.cometbft.types.v1.BlockIDFlagJ\x04\x08\x02\x10\x03\"\xc4\x01\n\x0bMisbehavior\x12/\n\x04type\x18\x01 \x01(\x0e\x32!.cometbft.abci.v1.MisbehaviorType\x12.\n\tvalidator\x18\x02 \x01(\x0b\x32\x1b.cometbft.abci.v1.Validator\x12\x0e\n\x06height\x18\x03 \x01(\x03\x12(\n\x04time\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x1a\n\x12total_voting_power\x18\x05 \x01(\x03\"Z\n\x08Snapshot\x12\x0e\n\x06height\x18\x01 \x01(\x04\x12\x0e\n\x06\x66ormat\x18\x02 \x01(\r\x12\x0e\n\x06\x63hunks\x18\x03 \x01(\r\x12\x0c\n\x04hash\x18\x04 \x01(\x0c\x12\x10\n\x08metadata\x18\x05 \x01(\x0c*\\\n\x0b\x43heckTxType\x12\x19\n\x15\x43HECK_TX_TYPE_UNKNOWN\x10\x00\x12\x19\n\x15\x43HECK_TX_TYPE_RECHECK\x10\x01\x12\x17\n\x13\x43HECK_TX_TYPE_CHECK\x10\x02*\xef\x01\n\x13OfferSnapshotResult\x12!\n\x1dOFFER_SNAPSHOT_RESULT_UNKNOWN\x10\x00\x12 \n\x1cOFFER_SNAPSHOT_RESULT_ACCEPT\x10\x01\x12\x1f\n\x1bOFFER_SNAPSHOT_RESULT_ABORT\x10\x02\x12 \n\x1cOFFER_SNAPSHOT_RESULT_REJECT\x10\x03\x12\'\n#OFFER_SNAPSHOT_RESULT_REJECT_FORMAT\x10\x04\x12\'\n#OFFER_SNAPSHOT_RESULT_REJECT_SENDER\x10\x05*\x9a\x02\n\x18\x41pplySnapshotChunkResult\x12\'\n#APPLY_SNAPSHOT_CHUNK_RESULT_UNKNOWN\x10\x00\x12&\n\"APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT\x10\x01\x12%\n!APPLY_SNAPSHOT_CHUNK_RESULT_ABORT\x10\x02\x12%\n!APPLY_SNAPSHOT_CHUNK_RESULT_RETRY\x10\x03\x12.\n*APPLY_SNAPSHOT_CHUNK_RESULT_RETRY_SNAPSHOT\x10\x04\x12/\n+APPLY_SNAPSHOT_CHUNK_RESULT_REJECT_SNAPSHOT\x10\x05*\x84\x01\n\x15ProcessProposalStatus\x12#\n\x1fPROCESS_PROPOSAL_STATUS_UNKNOWN\x10\x00\x12\"\n\x1ePROCESS_PROPOSAL_STATUS_ACCEPT\x10\x01\x12\"\n\x1ePROCESS_PROPOSAL_STATUS_REJECT\x10\x02*\x97\x01\n\x19VerifyVoteExtensionStatus\x12(\n$VERIFY_VOTE_EXTENSION_STATUS_UNKNOWN\x10\x00\x12\'\n#VERIFY_VOTE_EXTENSION_STATUS_ACCEPT\x10\x01\x12\'\n#VERIFY_VOTE_EXTENSION_STATUS_REJECT\x10\x02*~\n\x0fMisbehaviorType\x12\x1c\n\x18MISBEHAVIOR_TYPE_UNKNOWN\x10\x00\x12#\n\x1fMISBEHAVIOR_TYPE_DUPLICATE_VOTE\x10\x01\x12(\n$MISBEHAVIOR_TYPE_LIGHT_CLIENT_ATTACK\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cometbft.abci.v1.types_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _INFORESPONSE_LANEPRIORITIESENTRY._options = None
  _INFORESPONSE_LANEPRIORITIESENTRY._serialized_options = b'8\001'
  _CHECKTXTYPE._serialized_start=5465
  _CHECKTXTYPE._serialized_end=5557
  _OFFERSNAPSHOTRESULT._serialized_start=5560
  _OFFERSNAPSHOTRESULT._serialized_end=5799
  _APPLYSNAPSHOTCHUNKRESULT._serialized_start=5802
  _APPLYSNAPSHOTCHUNKRESULT._serialized_end=6084
  _PROCESSPROPOSALSTATUS._serialized_start=6087
  _PROCESSPROPOSALSTATUS._serialized_end=6219
  _VERIFYVOTEEXTENSIONSTATUS._serialized_start=6222
  _VERIFYVOTEEXTENSIONSTATUS._serialized_end=6373
  _MISBEHAVIORTYPE._serialized_start=6375
  _MISBEHAVIORTYPE._serialized_end=6501
  _ECHOREQUEST._serialized_start=214
  _ECHOREQUEST._serialized_end=244
  _FLUSHREQUEST._serialized_start=246
  _FLUSHREQUEST._serialized_end=260
  _INFOREQUEST._serialized_start=262
  _INFOREQUEST._serialized_end=358
  _INITCHAINREQUEST._serialized_start=361
  _INITCHAINREQUEST._serialized_end=605
  _QUERYREQUEST._serialized_start=607
  _QUERYREQUEST._serialized_end=680
  _CHECKTXREQUEST._serialized_start=682
  _CHECKTXREQUEST._serialized_end=761
  _COMMITREQUEST._serialized_start=763
  _COMMITREQUEST._serialized_end=778
  _LISTSNAPSHOTSREQUEST._serialized_start=780
  _LISTSNAPSHOTSREQUEST._serialized_end=802
  _OFFERSNAPSHOTREQUEST._serialized_start=804
  _OFFERSNAPSHOTREQUEST._serialized_end=890
  _LOADSNAPSHOTCHUNKREQUEST._serialized_start=892
  _LOADSNAPSHOTCHUNKREQUEST._serialized_end=965
  _APPLYSNAPSHOTCHUNKREQUEST._serialized_start=967
  _APPLYSNAPSHOTCHUNKREQUEST._serialized_end=1040
  _PREPAREPROPOSALREQUEST._serialized_start=1043
  _PREPAREPROPOSALREQUEST._serialized_end=1333
  _PROCESSPROPOSALREQUEST._serialized_start=1336
  _PROCESSPROPOSALREQUEST._serialized_end=1613
  _EXTENDVOTEREQUEST._serialized_start=1616
  _EXTENDVOTEREQUEST._serialized_end=1888
  _VERIFYVOTEEXTENSIONREQUEST._serialized_start=1890
  _VERIFYVOTEEXTENSIONREQUEST._serialized_end=1999
  _FINALIZEBLOCKREQUEST._serialized_start=2002
  _FINALIZEBLOCKREQUEST._serialized_end=2303
  _EXCEPTIONRESPONSE._serialized_start=2305
  _EXCEPTIONRESPONSE._serialized_end=2339
  _ECHORESPONSE._serialized_start=2341
  _ECHORESPONSE._serialized_end=2372
  _FLUSHRESPONSE._serialized_start=2374
  _FLUSHRESPONSE._serialized_end=2389
  _INFORESPONSE._serialized_start=2392
  _INFORESPONSE._serialized_end=2668
  _INFORESPONSE_LANEPRIORITIESENTRY._serialized_start=2615
  _INFORESPONSE_LANEPRIORITIESENTRY._serialized_end=2668
  _INITCHAINRESPONSE._serialized_start=2671
  _INITCHAINRESPONSE._serialized_end=2825
  _QUERYRESPONSE._serialized_start=2828
  _QUERYRESPONSE._serialized_end=3011
  _CHECKTXRESPONSE._serialized_start=3014
  _CHECKTXRESPONSE._serialized_end=3190
  _COMMITRESPONSE._serialized_start=3192
  _COMMITRESPONSE._serialized_end=3243
  _LISTSNAPSHOTSRESPONSE._serialized_start=3245
  _LISTSNAPSHOTSRESPONSE._serialized_end=3315
  _OFFERSNAPSHOTRESPONSE._serialized_start=3317
  _OFFERSNAPSHOTRESPONSE._serialized_end=3395
  _LOADSNAPSHOTCHUNKRESPONSE._serialized_start=3397
  _LOADSNAPSHOTCHUNKRESPONSE._serialized_end=3439
  _APPLYSNAPSHOTCHUNKRESPONSE._serialized_start=3442
  _APPLYSNAPSHOTCHUNKRESPONSE._serialized_end=3578
  _PREPAREPROPOSALRESPONSE._serialized_start=3580
  _PREPAREPROPOSALRESPONSE._serialized_end=3618
  _PROCESSPROPOSALRESPONSE._serialized_start=3620
  _PROCESSPROPOSALRESPONSE._serialized_end=3702
  _EXTENDVOTERESPONSE._serialized_start=3704
  _EXTENDVOTERESPONSE._serialized_end=3748
  _VERIFYVOTEEXTENSIONRESPONSE._serialized_start=3750
  _VERIFYVOTEEXTENSIONRESPONSE._serialized_end=3840
  _FINALIZEBLOCKRESPONSE._serialized_start=3843
  _FINALIZEBLOCKRESPONSE._serialized_end=4161
  _COMMITINFO._serialized_start=4163
  _COMMITINFO._serialized_end=4233
  _EXTENDEDCOMMITINFO._serialized_start=4235
  _EXTENDEDCOMMITINFO._serialized_end=4321
  _EVENT._serialized_start=4323
  _EVENT._serialized_end=4398
  _EVENTATTRIBUTE._serialized_start=4400
  _EVENTATTRIBUTE._serialized_end=4459
  _EXECTXRESULT._serialized_start=4462
  _EXECTXRESULT._serialized_end=4629
  _TXRESULT._serialized_start=4631
  _TXRESULT._serialized_end=4732
  _VALIDATOR._serialized_start=4734
  _VALIDATOR._serialized_end=4783
  _VALIDATORUPDATE._serialized_start=4785
  _VALIDATORUPDATE._serialized_end=4868
  _VOTEINFO._serialized_start=4870
  _VOTEINFO._serialized_end=4989
  _EXTENDEDVOTEINFO._serialized_start=4992
  _EXTENDEDVOTEINFO._serialized_end=5172
  _MISBEHAVIOR._serialized_start=5175
  _MISBEHAVIOR._serialized_end=5371
  _SNAPSHOT._serialized_start=5373
  _SNAPSHOT._serialized_end=5463
# @@protoc_insertion_point(module_scope)
