"""The port's gRPC: ``proto_gen``, ``rpc/pb_convert.py``,
``abci/grpc_abci.py`` and ``rpc/grpc_server.py``, held to the JAX package's.

- ``pb_convert`` serialises every stored block, block ID, commit, piece of
  evidence and block result of the seeded chain (``tests/torch_chain.py``,
  driven in each package) to the JAX converter's bytes, and consensus
  params both ways.
- Each package's ``GRPCServer`` over its own copy of that chain answers
  every service call (version, block by height, latest height, block
  results, a missing height, pruning) with equal bytes.
- Every ABCI method runs port client -> JAX server and JAX client -> port
  server (and JAX -> JAX as the reference): a recording app sees equal
  requests and the clients equal responses, each message filled from one
  ``random.Random`` seed; the KVStore app's lifecycle gives equal answers
  across the packages.
- A port node on ``device="cpu"`` with ``grpc.laddr`` and
  ``grpc.privileged_laddr`` passes the JAX ``tests/test_ops.py`` gRPC
  cases, and its gRPC answers equal its JSON-RPC answers at each height.
- Where ``grpc`` or ``google.protobuf`` does not import, the gRPC options,
  and only those, refuse the node, naming the package.

Tolerance: exact bytes and exact answers.  Every server listens on
127.0.0.1, every call has a deadline.
"""

import base64
import dataclasses
import random
import sys
import time
import typing

import grpc
import pytest

import torch_chain

from cometbft_tpu.abci import grpc_abci as jga
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jat
from cometbft_tpu.abci.application import BaseApplication as JBase
from cometbft_tpu.config import config as jcfg
from cometbft_tpu.rpc import grpc_server as jgs
from cometbft_tpu.rpc import pb_convert as jpb
from cometbft_tpu.state.execution import fbr_from_json as jfbr
from cometbft_tpu_torch.abci import grpc_abci as tga
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.abci.application import BaseApplication as TBase
from cometbft_tpu_torch.cmd.main import main as cli_main
from cometbft_tpu_torch.config import config as cfgmod
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.proto_gen.cometbft.services.block.v1 import block_pb2 as block_svc
from cometbft_tpu_torch.proto_gen.cometbft.services.block_results.v1 import (
    block_results_pb2 as br_svc,
)
from cometbft_tpu_torch.proto_gen.cometbft.services.pruning.v1 import pruning_pb2 as prune_svc
from cometbft_tpu_torch.proto_gen.cometbft.services.version.v1 import version_pb2 as ver_svc
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import params_pb2
from cometbft_tpu_torch.rpc import grpc_server as tgs
from cometbft_tpu_torch.rpc import pb_convert as tpb
from cometbft_tpu_torch.rpc.core import Environment
from cometbft_tpu_torch.state.execution import fbr_from_json as tfbr

SEED = 20261027
HEIGHTS = 4
CHAIN = "grpc-diff-chain"
PARAMS = {
    "block": {"max_bytes": 22020096, "max_gas": -1},
    "evidence": {"max_age_num_blocks": 100000, "max_age_duration": 172800000000123,
                 "max_bytes": 1048576},
    "validator": {"pub_key_types": ["ed25519", "secp256k1"]},
    "feature": {"vote_extensions_enable_height": 7, "pbts_enable_height": 9},
}
VERSION = ("cometbft.services.version.v1.VersionService", "GetVersion",
           ver_svc.GetVersionRequest, ver_svc.GetVersionResponse)
BLOCK = ("cometbft.services.block.v1.BlockService", "GetByHeight",
         block_svc.GetByHeightRequest, block_svc.GetByHeightResponse)
RESULTS = ("cometbft.services.block_results.v1.BlockResultsService", "GetBlockResults",
           br_svc.GetBlockResultsRequest, br_svc.GetBlockResultsResponse)
PRUNING = "cometbft.services.pruning.v1.PruningService"


@pytest.fixture(scope="module")
def chains():
    mp = pytest.MonkeyPatch()
    mp.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    try:
        yield (torch_chain.drive("cometbft_tpu", heights=HEIGHTS)[0],
               torch_chain.drive("cometbft_tpu_torch", heights=HEIGHTS)[0])
    finally:
        mp.undo()


# -- pb_convert ------------------------------------------------------------------


def test_pb_convert_serialises_the_stored_chain_as_jax(chains):
    jc, tc = chains
    seen_evidence = 0
    for h in range(1, HEIGHTS + 1):
        jb, tb = jc.block_store.load_block(h), tc.block_store.load_block(h)
        assert tpb.block_pb(tb).SerializeToString() == jpb.block_pb(jb).SerializeToString()
        assert tpb.header_pb(tb.header).SerializeToString() == jpb.header_pb(
            jb.header).SerializeToString()
        jm, tm = jc.block_store.load_block_meta(h), tc.block_store.load_block_meta(h)
        assert tpb.block_id_pb(tm.block_id).SerializeToString() == jpb.block_id_pb(
            jm.block_id).SerializeToString()
        jcm, tcm = jc.block_store.load_seen_commit(h), tc.block_store.load_seen_commit(h)
        assert tpb.commit_pb(tcm).SerializeToString() == jpb.commit_pb(jcm).SerializeToString()
        for jev, tev in zip(jb.evidence, tb.evidence):
            seen_evidence += 1
            assert tpb.evidence_pb(tev).SerializeToString() == jpb.evidence_pb(
                jev).SerializeToString()
        jr = jfbr(jc.state_store.load_finalize_block_response(h))
        tr = tfbr(tc.state_store.load_finalize_block_response(h))
        assert [tpb.exec_tx_result_pb(r).SerializeToString() for r in tr.tx_results] == [
            jpb.exec_tx_result_pb(r).SerializeToString() for r in jr.tx_results]
        assert [tpb.event_pb(e).SerializeToString() for e in tr.events] == [
            jpb.event_pb(e).SerializeToString() for e in jr.events]
        assert [tpb.validator_update_pb(v).SerializeToString()
                for v in tr.validator_updates] == [
            jpb.validator_update_pb(v).SerializeToString() for v in jr.validator_updates]
    assert seen_evidence == 1


def test_pb_convert_params_both_ways_as_jax():
    for params in (PARAMS, {"block": PARAMS["block"]}, None, {}):
        jm, tm = params_pb2.ConsensusParams(), params_pb2.ConsensusParams()
        jpb.params_to_pb(jm, params)
        tpb.params_to_pb(tm, params)
        assert tm.SerializeToString() == jm.SerializeToString()
        assert tpb.params_from_pb(tm) == jpb.params_from_pb(jm)
    assert tpb.params_from_pb(None) is None


# -- the node services over each package's stored chain -----------------------------


class _Node:
    """What ``GRPCServer`` reads of a node, over a chain of torch_chain."""

    def __init__(self, chain, cfgmod_):
        self.config = cfgmod_.default_config()
        self.config.grpc.pruning_service_enabled = True
        self.block_store, self.state_store = chain.block_store, chain.state_store
        self.block_exec, self.event_bus = chain.executor, chain.bus


def _calls(srv, psrv, gs) -> list:
    """Every service call, its answer as bytes or its status code."""
    ch = gs.make_client_channel(f"127.0.0.1:{srv.bound_port}")
    pch = gs.make_client_channel(f"127.0.0.1:{psrv.bound_port}")
    out = []

    def call(channel, service, method, req, resp_cls):
        try:
            resp = channel.unary_unary(
                f"/{service}/{method}", request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)(req, timeout=30)
            out.append((method, resp.SerializeToString()))
        except grpc.RpcError as e:
            out.append((method, e.code().name))

    try:
        call(ch, *VERSION[:2], VERSION[2](), VERSION[3])
        for h in range(HEIGHTS + 2):
            call(ch, *BLOCK[:2], BLOCK[2](height=h), BLOCK[3])
            call(ch, *RESULTS[:2], RESULTS[2](height=h), RESULTS[3])
        stream = ch.unary_stream(
            "/cometbft.services.block.v1.BlockService/GetLatestHeight",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=block_svc.GetLatestHeightResponse.FromString,
        )(block_svc.GetLatestHeightRequest(), timeout=30)
        out.append(("GetLatestHeight", next(iter(stream)).SerializeToString()))
        stream.cancel()
        for k, what in enumerate(("BlockRetainHeight", "BlockResultsRetainHeight",
                                  "TxIndexerRetainHeight", "BlockIndexerRetainHeight")):
            call(pch, PRUNING, "Set" + what,
                 getattr(prune_svc, f"Set{what}Request")(height=k + 1),
                 getattr(prune_svc, f"Set{what}Response"))
            call(pch, PRUNING, "Get" + what, getattr(prune_svc, f"Get{what}Request")(),
                 getattr(prune_svc, f"Get{what}Response"))
        call(pch, *VERSION[:2], VERSION[2](), VERSION[3])
    finally:
        ch.close()
        pch.close()
    return out


def test_grpc_services_answer_as_jax(chains):
    answers = []
    for chain, gs, cfg in zip(chains, (jgs, tgs), (jcfg, cfgmod)):
        node = _Node(chain, cfg)
        srv = gs.GRPCServer(node, "tcp://127.0.0.1:0")
        psrv = gs.GRPCServer(node, "tcp://127.0.0.1:0", privileged=True)
        srv.start()
        psrv.start()
        try:
            answers.append(_calls(srv, psrv, gs))
        finally:
            srv.stop()
            psrv.stop()
    assert answers[1] == answers[0]
    codes = [a for _, a in answers[1] if isinstance(a, str)]
    assert codes == ["NOT_FOUND", "NOT_FOUND", "UNIMPLEMENTED"]  # height 5 twice; no
    # version service on the privileged endpoint


# -- ABCI across the packages -------------------------------------------------------


METHODS = ["info", "query", "check_tx", "init_chain", "prepare_proposal",
           "process_proposal", "extend_vote", "verify_vote_extension", "finalize_block",
           "commit", "list_snapshots", "offer_snapshot", "load_snapshot_chunk",
           "apply_snapshot_chunk"]


def _camel(m: str) -> str:
    return "".join(w.capitalize() for w in m.split("_"))


def _fill(tp, rng: random.Random):
    """A value of ``tp`` from ``rng``: non-negative numbers below 2**30
    (every proto field of the ABCI schema holds them), two items a list."""
    if dataclasses.is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        return tp(**{f.name: _fill(hints[f.name], rng) for f in dataclasses.fields(tp)})
    origin = typing.get_origin(tp)
    if origin is list:
        (elem,) = typing.get_args(tp)
        return [_fill(elem, rng) for _ in range(2)]
    if origin is dict:
        return {"lane%d" % i: rng.randrange(1, 1 << 16) for i in range(2)}
    if origin is typing.Union or tp is dict:
        return {"block": {"max_bytes": rng.randrange(1 << 30), "max_gas": -1},
                "validator": {"pub_key_types": ["ed25519"]},
                "feature": {"pbts_enable_height": rng.randrange(1 << 20)}}
    if tp is bool:
        return rng.random() < 0.5
    if tp is int:
        return rng.randrange(1 << 30)
    if tp is str:
        return "s%d" % rng.randrange(1 << 20)
    if tp is bytes:
        return rng.randbytes(rng.randrange(1, 9))
    raise TypeError(tp)


def _recorder(base, at, seed: int):
    class Recorder(base):
        def __init__(self):
            self.seen, self.rng = [], random.Random(seed)

    for m in METHODS:
        def handler(self, req, _m=m):
            self.seen.append((_m, dataclasses.asdict(req)))
            return _fill(getattr(at, _camel(_m) + "Response"), self.rng)

        setattr(Recorder, m, handler)
    return Recorder()


def _exchange(client_mod, client_at, server_mod, server_base, server_at) -> tuple:
    app = _recorder(server_base, server_at, SEED + 1)
    srv = server_mod.GRPCABCIServer(app, "127.0.0.1:0")
    srv.start()
    client = client_mod.GRPCClient(f"grpc://127.0.0.1:{srv.bound_port}", timeout=30)
    rng = random.Random(SEED)
    answers = []
    try:
        answers.append(client.echo("hello").message)
        client.flush()
        for m in METHODS:
            req = _fill(getattr(client_at, _camel(m) + "Request"), rng)
            answers.append((m, dataclasses.asdict(client.call(m, req))))
        with pytest.raises(ValueError):
            client.call("no_such_method", None)
    finally:
        client.close()
        srv.stop()
    return app.seen, answers


def test_every_abci_method_crosses_the_packages():
    ref = _exchange(jga, jat, jga, JBase, jat)
    port_to_jax = _exchange(tga, tat, jga, JBase, jat)
    jax_to_port = _exchange(jga, jat, tga, TBase, tat)
    assert port_to_jax == ref
    assert jax_to_port == ref
    seen, answers = ref
    assert [m for m, _ in seen] == METHODS and len(answers) == len(METHODS) + 1


def _kvstore_run(client_mod, at, server_mod, app) -> list:
    srv = server_mod.GRPCABCIServer(app, "127.0.0.1:0")
    srv.start()
    client = client_mod.GRPCClient(f"127.0.0.1:{srv.bound_port}", timeout=30)
    out = []
    try:
        out.append(client.init_chain(at.InitChainRequest(
            chain_id=CHAIN, initial_height=1, consensus_params=PARAMS)))
        for h in (1, 2):
            txs = [b"k%d=v%d" % (h, i) for i in range(3)] + [b"bad"]
            out += [client.check_tx(at.CheckTxRequest(tx=tx)) for tx in txs]
            out.append(client.prepare_proposal(at.PrepareProposalRequest(
                max_tx_bytes=1 << 20, txs=txs, height=h)))
            out.append(client.process_proposal(at.ProcessProposalRequest(txs=txs, height=h)))
            out.append(client.finalize_block(at.FinalizeBlockRequest(
                txs=txs, height=h, hash=bytes([h]) * 32, time_unix_ns=10**18 + h)))
            out.append(client.commit())
        out.append(client.query(at.QueryRequest(data=b"k2", path="/store")))
        out.append(client.info(at.InfoRequest(version="1.0.0")))
    finally:
        client.close()
        srv.stop()
    return [dataclasses.asdict(r) for r in out]


def test_kvstore_lifecycle_equal_across_the_packages():
    ref = _kvstore_run(jga, jat, jga, jkv.KVStoreApplication())
    assert _kvstore_run(tga, tat, jga, jkv.KVStoreApplication()) == ref
    assert _kvstore_run(jga, jat, tga, tkv.KVStoreApplication()) == ref
    assert ref[-1]["last_block_height"] == 2


# -- a port node serving GRPCServer ---------------------------------------------


@pytest.fixture(scope="module")
def grpc_node(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    home = str(tmp_path_factory.mktemp("grpc") / "node")
    assert cli_main(["--home", home, "init", "--chain-id", CHAIN]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    cfg.base.db_backend = "sqlite"
    cfg.rpc.laddr = cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.grpc.laddr = cfg.grpc.privileged_laddr = "tcp://127.0.0.1:0"
    cfg.grpc.pruning_service_enabled = True
    cfg.consensus.timeout_commit_ms = 50
    n = Node(cfg, device="cpu")
    n.start()
    try:
        env = Environment(n)
        assert env.broadcast_tx_sync(base64.b64encode(b"grpc=node").decode())["code"] == 0
        deadline = time.monotonic() + 60
        while n.block_store.height() < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert n.block_store.height() >= 3
        yield n
    finally:
        n.stop()
        mp.undo()


def test_jax_ops_grpc_cases_on_a_port_node(grpc_node):
    """``tests/test_ops.py::TestGRPC`` against the port's node."""
    node = grpc_node
    ch = tgs.make_client_channel(f"127.0.0.1:{node.grpc_server.bound_port}")
    pch = tgs.make_client_channel(f"127.0.0.1:{node.grpc_privileged_server.bound_port}")
    try:
        ver = tgs.grpc_unary(ch, *VERSION[:2], VERSION[2](), VERSION[3])
        assert ver.block == 11 and ver.p2p == 9
        blk = tgs.grpc_unary(ch, *BLOCK[:2], BLOCK[2](height=1), BLOCK[3])
        assert blk.block.header.height == 1 and blk.block.header.chain_id == CHAIN
        assert len(blk.block_id.hash) == 32
        stream = ch.unary_stream(
            "/cometbft.services.block.v1.BlockService/GetLatestHeight",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=block_svc.GetLatestHeightResponse.FromString,
        )(block_svc.GetLatestHeightRequest(), timeout=30)
        assert next(iter(stream)).height >= 3
        stream.cancel()
        res = tgs.grpc_unary(ch, *RESULTS[:2], RESULTS[2](height=1), RESULTS[3])
        assert res.height == 1
        tgs.grpc_unary(pch, PRUNING, "SetBlockRetainHeight",
                       prune_svc.SetBlockRetainHeightRequest(height=2),
                       prune_svc.SetBlockRetainHeightResponse)
        got = tgs.grpc_unary(pch, PRUNING, "GetBlockRetainHeight",
                             prune_svc.GetBlockRetainHeightRequest(),
                             prune_svc.GetBlockRetainHeightResponse)
        assert got.pruning_service_retain_height == 2
        tgs.grpc_unary(pch, PRUNING, "SetTxIndexerRetainHeight",
                       prune_svc.SetTxIndexerRetainHeightRequest(height=3),
                       prune_svc.SetTxIndexerRetainHeightResponse)
        ti = tgs.grpc_unary(pch, PRUNING, "GetTxIndexerRetainHeight",
                            prune_svc.GetTxIndexerRetainHeightRequest(),
                            prune_svc.GetTxIndexerRetainHeightResponse)
        assert ti.height == 3
        with pytest.raises(grpc.RpcError):
            tgs.grpc_unary(pch, *VERSION[:2], VERSION[2](), VERSION[3])
    finally:
        ch.close()
        pch.close()


def test_grpc_reads_equal_json_rpc(grpc_node):
    node = grpc_node
    env = Environment(node)
    ch = tgs.make_client_channel(f"127.0.0.1:{node.grpc_server.bound_port}")
    try:
        assert tgs.grpc_unary(ch, *VERSION[:2], VERSION[2](), VERSION[3]).node == env.status()[
            "node_info"]["version"]
        for h in range(1, 4):
            blk = tgs.grpc_unary(ch, *BLOCK[:2], BLOCK[2](height=h), BLOCK[3])
            rj = env.block(h)
            hdr = rj["block"]["header"]
            assert blk.block_id.hash.hex().upper() == rj["block_id"]["hash"]
            assert (str(blk.block.header.height), blk.block.header.chain_id,
                    blk.block.header.app_hash.hex().upper(),
                    blk.block.header.data_hash.hex().upper()) == (
                hdr["height"], hdr["chain_id"], hdr["app_hash"], hdr["data_hash"])
            assert [base64.b64encode(t).decode() for t in blk.block.data.txs] == rj[
                "block"]["data"]["txs"]
            res = tgs.grpc_unary(ch, *RESULTS[:2], RESULTS[2](height=h), RESULTS[3])
            rr = env.block_results(h)
            assert res.app_hash.hex().upper() == rr["app_hash"] and str(res.height) == rr[
                "height"]
            assert [(r.code, base64.b64encode(r.data).decode(), r.log, str(r.gas_used))
                    for r in res.tx_results] == [
                (r["code"], r["data"], r["log"], r["gas_used"]) for r in rr["txs_results"]]
    finally:
        ch.close()


# -- the gRPC options where grpc or protobuf does not import ------------------------


@pytest.mark.parametrize("package", ["grpc", "google.protobuf"])
def test_grpc_options_name_a_missing_package(tmp_path, monkeypatch, package):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setitem(sys.modules, package, None)
    home = str(tmp_path / "node")
    assert cli_main(["--home", home, "init", "--chain-id", CHAIN]) == 0
    for option in ("grpc.laddr", "grpc.privileged_laddr", "base.abci"):
        cfg = cfgmod.load_config(home)
        cfg.base.home = home
        cfg.base.db_backend = "memdb"
        cfg.rpc.laddr = cfg.p2p.laddr = "tcp://127.0.0.1:0"
        section, _, key = option.partition(".")
        setattr(getattr(cfg, section), key,
                "grpc" if option == "base.abci" else "tcp://127.0.0.1:0")
        with pytest.raises(NotImplementedError, match=repr(package)):
            Node(cfg, device="cpu")
    # a node with no gRPC option needs neither package
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    cfg.base.db_backend = "memdb"
    cfg.rpc.laddr = cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_commit_ms = 50
    n = Node(cfg, device="cpu")
    n.start()
    try:
        deadline = time.monotonic() + 30
        while n.block_store.height() < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert n.block_store.height() >= 1
    finally:
        n.stop()
