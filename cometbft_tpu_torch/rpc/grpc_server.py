"""gRPC services with the reference's protobuf wire format.

Four services (reference: rpc/grpc/server/services/): version, block,
block-results on the public endpoint, plus the privileged pruning service
(the data-companion API).  Requests and responses are the real protobuf
messages from proto/cometbft/services/* — any client built against the
reference's .proto files (grpcurl, Go/Rust data companions) can connect.

Method handlers are registered through grpc's generic-handler API with
protobuf (de)serializers; service code generation is not required.

The port's copy of the JAX package's ``rpc/grpc_server.py``, on the port's
own generated modules.  ``node/node.py`` imports it only for
``grpc.laddr`` or ``grpc.privileged_laddr``; it needs ``grpc`` and
``google.protobuf``.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

from cometbft_tpu_torch.proto_gen.cometbft.services.block.v1 import (
    block_pb2 as block_svc_pb,
)
from cometbft_tpu_torch.proto_gen.cometbft.services.block_results.v1 import (
    block_results_pb2 as block_results_svc_pb,
)
from cometbft_tpu_torch.proto_gen.cometbft.services.pruning.v1 import (
    pruning_pb2 as pruning_pb,
)
from cometbft_tpu_torch.proto_gen.cometbft.services.version.v1 import (
    version_pb2 as version_pb,
)

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.rpc import pb_convert as conv
from cometbft_tpu_torch.version import (
    ABCI_SEMVER,
    BLOCK_PROTOCOL,
    CMT_SEMVER,
    P2P_PROTOCOL,
)

_VERSION_SVC = "cometbft.services.version.v1.VersionService"
_BLOCK_SVC = "cometbft.services.block.v1.BlockService"
_BLOCK_RESULTS_SVC = "cometbft.services.block_results.v1.BlockResultsService"
_PRUNING_SVC = "cometbft.services.pruning.v1.PruningService"


class GRPCServer:
    """Reference: rpc/grpc/server/server.go Serve + ServePrivileged."""

    def __init__(self, node, laddr: str, privileged: bool = False, logger=None):
        import grpc

        self.node = node
        self.privileged = privileged
        self.logger = logger or liblog.nop_logger()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        gcfg = node.config.grpc
        handlers = []
        if privileged:
            if gcfg.pruning_service_enabled:
                handlers.append(self._pruning_service(grpc))
        else:
            if gcfg.version_service_enabled:
                handlers.append(self._version_service(grpc))
            if gcfg.block_service_enabled:
                handlers.append(self._block_service(grpc))
            if gcfg.block_results_service_enabled:
                handlers.append(self._block_results_service(grpc))
        for h in handlers:
            self._server.add_generic_rpc_handlers((h,))
        addr = laddr.replace("tcp://", "")
        self.bound_port = self._server.add_insecure_port(addr)

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _unary(grpc, fn, req_cls, resp_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    @staticmethod
    def _stream(grpc, fn, req_cls, resp_cls):
        return grpc.unary_stream_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    # -- services -----------------------------------------------------------

    def _version_service(self, grpc):
        def get_version(request, context):
            return version_pb.GetVersionResponse(
                node=CMT_SEMVER,
                abci=ABCI_SEMVER,
                p2p=P2P_PROTOCOL,
                block=BLOCK_PROTOCOL,
            )

        return grpc.method_handlers_generic_handler(
            _VERSION_SVC,
            {
                "GetVersion": self._unary(
                    grpc,
                    get_version,
                    version_pb.GetVersionRequest,
                    version_pb.GetVersionResponse,
                )
            },
        )

    def _block_service(self, grpc):
        def get_by_height(request, context):
            h = request.height or self.node.block_store.height()
            block = self.node.block_store.load_block(h)
            meta = self.node.block_store.load_block_meta(h)
            if block is None or meta is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"block {h} not found")
            resp = block_svc_pb.GetByHeightResponse()
            resp.block_id.CopyFrom(conv.block_id_pb(meta.block_id))
            resp.block.CopyFrom(conv.block_pb(block))
            return resp

        def get_latest_height(request, context):
            # Stream of height updates (reference: blockservice
            # GetLatestHeight subscribes to the event bus).  Emit the
            # current height, then follow new blocks until the client
            # disconnects.
            import queue as _queue

            from cometbft_tpu_torch.libs.pubsub import Query

            yield block_svc_pb.GetLatestHeightResponse(
                height=self.node.block_store.height()
            )
            bus = getattr(self.node, "event_bus", None)
            if bus is None:
                return
            sub_id = "grpc-latest-height-%d" % id(context)
            try:
                sub = bus.subscribe(
                    sub_id, Query.parse("tm.event='NewBlock'"), capacity=128
                )
            except Exception:
                return
            try:
                while context.is_active() and not sub.canceled.is_set():
                    try:
                        sub.out.get(timeout=1.0)
                    except _queue.Empty:
                        continue
                    yield block_svc_pb.GetLatestHeightResponse(
                        height=self.node.block_store.height()
                    )
            finally:
                try:
                    bus.unsubscribe_all(sub_id)
                except Exception:
                    pass

        return grpc.method_handlers_generic_handler(
            _BLOCK_SVC,
            {
                "GetByHeight": self._unary(
                    grpc,
                    get_by_height,
                    block_svc_pb.GetByHeightRequest,
                    block_svc_pb.GetByHeightResponse,
                ),
                "GetLatestHeight": self._stream(
                    grpc,
                    get_latest_height,
                    block_svc_pb.GetLatestHeightRequest,
                    block_svc_pb.GetLatestHeightResponse,
                ),
            },
        )

    def _block_results_service(self, grpc):
        from cometbft_tpu_torch.state.execution import fbr_from_json

        def get_block_results(request, context):
            h = request.height or self.node.block_store.height()
            raw = self.node.state_store.load_finalize_block_response(h)
            if raw is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND, f"no results for height {h}"
                )
            res = fbr_from_json(raw)
            resp = block_results_svc_pb.GetBlockResultsResponse(
                height=h, app_hash=res.app_hash
            )
            for r in res.tx_results:
                resp.tx_results.add().CopyFrom(conv.exec_tx_result_pb(r))
            for e in res.events:
                resp.finalize_block_events.add().CopyFrom(conv.event_pb(e))
            for v in res.validator_updates:
                resp.validator_updates.add().CopyFrom(
                    conv.validator_update_pb(v)
                )
            conv.params_to_pb(
                resp.consensus_param_updates, res.consensus_param_updates
            )
            return resp

        return grpc.method_handlers_generic_handler(
            _BLOCK_RESULTS_SVC,
            {
                "GetBlockResults": self._unary(
                    grpc,
                    get_block_results,
                    block_results_svc_pb.GetBlockResultsRequest,
                    block_results_svc_pb.GetBlockResultsResponse,
                )
            },
        )

    def _pruning_service(self, grpc):
        """Data-companion retain heights (reference: pruningservice).
        Every setter persists the heights so a restart cannot drop a
        companion's hold on data it has not yet ingested."""
        node = self.node

        def _persist():
            try:
                node.state_store.save_retain_heights(node.block_exec._retain)
            except Exception:  # noqa: BLE001 — persistence is best-effort
                self.logger.error("failed to persist retain heights")

        def set_block(request, context):
            node.block_exec._retain.companion_retain = request.height
            _persist()
            return pruning_pb.SetBlockRetainHeightResponse()

        def get_block(request, context):
            r = node.block_exec._retain
            return pruning_pb.GetBlockRetainHeightResponse(
                app_retain_height=r.app_retain,
                pruning_service_retain_height=r.companion_retain,
            )

        def set_block_results(request, context):
            node.block_exec._retain.companion_results_retain = request.height
            _persist()
            return pruning_pb.SetBlockResultsRetainHeightResponse()

        def get_block_results(request, context):
            r = node.block_exec._retain
            return pruning_pb.GetBlockResultsRetainHeightResponse(
                pruning_service_retain_height=getattr(
                    r, "companion_results_retain", 0
                )
            )

        def set_tx_indexer(request, context):
            node.block_exec._retain.tx_index_retain = request.height
            _persist()
            return pruning_pb.SetTxIndexerRetainHeightResponse()

        def get_tx_indexer(request, context):
            return pruning_pb.GetTxIndexerRetainHeightResponse(
                height=getattr(node.block_exec._retain, "tx_index_retain", 0)
            )

        def set_block_indexer(request, context):
            node.block_exec._retain.block_index_retain = request.height
            _persist()
            return pruning_pb.SetBlockIndexerRetainHeightResponse()

        def get_block_indexer(request, context):
            return pruning_pb.GetBlockIndexerRetainHeightResponse(
                height=getattr(
                    node.block_exec._retain, "block_index_retain", 0
                )
            )

        def u(fn, name):
            return self._unary(
                grpc,
                fn,
                getattr(pruning_pb, name + "Request"),
                getattr(pruning_pb, name + "Response"),
            )

        return grpc.method_handlers_generic_handler(
            _PRUNING_SVC,
            {
                "SetBlockRetainHeight": u(set_block, "SetBlockRetainHeight"),
                "GetBlockRetainHeight": u(get_block, "GetBlockRetainHeight"),
                "SetBlockResultsRetainHeight": u(
                    set_block_results, "SetBlockResultsRetainHeight"
                ),
                "GetBlockResultsRetainHeight": u(
                    get_block_results, "GetBlockResultsRetainHeight"
                ),
                "SetTxIndexerRetainHeight": u(
                    set_tx_indexer, "SetTxIndexerRetainHeight"
                ),
                "GetTxIndexerRetainHeight": u(
                    get_tx_indexer, "GetTxIndexerRetainHeight"
                ),
                "SetBlockIndexerRetainHeight": u(
                    set_block_indexer, "SetBlockIndexerRetainHeight"
                ),
                "GetBlockIndexerRetainHeight": u(
                    get_block_indexer, "GetBlockIndexerRetainHeight"
                ),
            },
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)


def make_client_channel(target: str):
    import grpc

    return grpc.insecure_channel(target.replace("tcp://", ""))


def grpc_unary(channel, service: str, method: str, request, resp_cls):
    """One protobuf unary call (client side of the generic handlers)."""
    callable_ = channel.unary_unary(
        f"/{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )
    return callable_(request)
