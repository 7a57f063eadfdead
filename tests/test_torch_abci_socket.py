"""The port's ABCI socket (``abci/codec.py``, ``abci/server.py``,
``abci/client.SocketClient``, ``proxy/multi_app_conn.remote_client_creator``)
held to the JAX package's: the frame bytes of every request and response
type (each filled from one seed), and one scripted run of the KVStore
app through a port client against a JAX server and a JAX client against a
port server, equal response for response to an in-process ``LocalClient``.
Every socket listens on 127.0.0.1 or a unix path, every wait is bounded.
"""

import dataclasses
import io
import os
import random
import tempfile
import threading
import typing

import pytest

from cometbft_tpu.abci import client as jclient
from cometbft_tpu.abci import codec as jcodec
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import server as jserver
from cometbft_tpu.abci import types as jat

from cometbft_tpu_torch.abci import client as tclient
from cometbft_tpu_torch.abci import codec as tcodec
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.abci import server as tserver
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.proxy import multi_app_conn as tproxy

SEED = 20261037


def _fill(tp, rng: random.Random, depth: int = 0):
    """A value of type ``tp`` drawn from ``rng`` (dataclasses field by
    field, two items a list or dict)."""
    if dataclasses.is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        return tp(**{f.name: _fill(hints[f.name], rng, depth + 1)
                     for f in dataclasses.fields(tp)})
    origin = typing.get_origin(tp)
    if origin is list:
        (elem,) = typing.get_args(tp)
        return [_fill(elem, rng, depth + 1) for _ in range(2)]
    if origin is dict:
        _, val = typing.get_args(tp)
        return {"k%d" % i: _fill(val, rng, depth + 1) for i in range(2)}
    if origin is typing.Union:
        (arg,) = [a for a in typing.get_args(tp) if a is not type(None)]
        if arg is dict or typing.get_origin(arg) is dict:
            return {"block": {"max_bytes": str(rng.randrange(1 << 20))}}
        return _fill(arg, rng, depth)
    if tp is dict:
        return {"block": {"max_bytes": str(rng.randrange(1 << 20))}}
    if tp is bool:
        return rng.random() < 0.5
    if tp is int:
        return rng.randrange(-(1 << 40), 1 << 40)
    if tp is str:
        return "s%xé" % rng.randrange(1 << 32)
    if tp is bytes:
        return rng.randbytes(rng.randrange(0, 40))
    raise TypeError(tp)


def _pairs(kind: str):
    jt = jcodec._REQ_TYPES if kind == "request" else jcodec._RESP_TYPES
    tt = tcodec._REQ_TYPES if kind == "request" else tcodec._RESP_TYPES
    assert sorted(jt) == sorted(tt)
    return [(m, jt[m], tt[m]) for m in sorted(tt)]


@pytest.mark.parametrize("kind", ["request", "response"])
def test_every_message_frames_to_the_jax_bytes(kind):
    enc = "encode_request" if kind == "request" else "encode_response"
    read = "read_request" if kind == "request" else "read_response"
    for i, (method, jtp, ttp) in enumerate(_pairs(kind)):
        for seed in (None, SEED + i):
            jmsg = jtp() if seed is None else _fill(jtp, random.Random(seed))
            tmsg = ttp() if seed is None else _fill(ttp, random.Random(seed))
            jb, tb = getattr(jcodec, enc)(method, jmsg), getattr(tcodec, enc)(method, tmsg)
            assert jb == tb, method
            got_m, got = getattr(tcodec, read)(io.BytesIO(jb))
            assert got_m == method and got == tmsg, method
            _, jgot = getattr(jcodec, read)(io.BytesIO(tb))
            assert jgot == jmsg, method


def test_errors_and_bad_frames_equal():
    assert jcodec.encode_error("error", "boom") == tcodec.encode_error("error", "boom")
    with pytest.raises(tcodec.RemoteError, match="boom"):
        tcodec.read_response(io.BytesIO(jcodec.encode_error("error", "boom")))
    for data in (b"", b"\x05abc", b"\xff" * 10):
        errs = []
        for c in (jcodec, tcodec):
            with pytest.raises(Exception) as e:
                c.read_request(io.BytesIO(data))
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]


def _script(at) -> list:
    """(method, request) pairs of one KVStore run: the handshake,
    InitChain, CheckTx one and batched, a block, Commit, a query and the
    snapshot surface (listing, a chunk, offering and applying it back)."""
    txs = [b"a%d=%d" % (i, i) for i in range(6)] + [b"bad"]
    out = [
        ("echo", at.EchoRequest(message="hello")),
        ("info", at.InfoRequest(version="v")),
        ("init_chain", at.InitChainRequest(
            time_unix_ns=1_700_000_000 * 10**9, chain_id="abci-socket-chain",
            validators=[at.ValidatorUpdate("ed25519", bytes(range(32)), 10)])),
        ("check_tx", at.CheckTxRequest(tx=txs[0])),
        ("check_tx", at.CheckTxRequest(tx=b"bad")),
        ("check_txs", at.CheckTxsRequest(requests=[at.CheckTxRequest(tx=t) for t in txs])),
    ]
    for h in range(1, 6):
        out += [("finalize_block", at.FinalizeBlockRequest(
                    txs=txs[:h] + [b"h%d=x" % h], height=h, time_unix_ns=h * 10**9)),
                ("commit", at.CommitRequest())]
    out += [
        ("query", at.QueryRequest(data=b"a1", path="/key")),
        ("info", at.InfoRequest()),
        ("list_snapshots", at.ListSnapshotsRequest()),
        ("load_snapshot_chunk", at.LoadSnapshotChunkRequest(height=5, format=1, chunk=0)),
    ]
    return out


def _run_script(client, at) -> list:
    frames = []
    for method, req in _script(at):
        resp = client.echo(req.message) if method == "echo" else client.call(method, req)
        frames.append(tcodec.encode_response(method, resp))
    snap = client.call("list_snapshots", at.ListSnapshotsRequest()).snapshots[-1]
    chunk = client.call("load_snapshot_chunk", at.LoadSnapshotChunkRequest(
        height=snap.height, format=snap.format, chunk=0)).chunk
    for method, req in (("offer_snapshot", at.OfferSnapshotRequest(snapshot=snap)),
                        ("apply_snapshot_chunk", at.ApplySnapshotChunkRequest(
                            index=0, chunk=chunk))):
        frames.append(tcodec.encode_response(method, client.call(method, req)))
    return frames


def _local_frames():
    return _run_script(tclient.LocalClient(tkv.KVStoreApplication()), tat)


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_script_across_packages(server_pkg):
    """A port client against a JAX server and a JAX client against a port
    server, both over TCP: every response's frame equals the in-process
    run's."""
    want = _local_frames()
    if server_pkg == "jax":
        srv = jserver.ABCIServer(jkv.KVStoreApplication(), "tcp://127.0.0.1:0")
    else:
        srv = tserver.ABCIServer(tkv.KVStoreApplication(), "tcp://127.0.0.1:0")
    srv.start()
    try:
        addr = f"tcp://127.0.0.1:{srv.bound_port}"
        cli = (tclient.SocketClient(addr, timeout=20.0) if server_pkg == "jax"
               else jclient.SocketClient(addr, timeout=20.0))
        try:
            frames = _run_script(cli, tat if server_pkg == "jax" else jat)
        finally:
            cli.close()
    finally:
        srv.stop()
    assert [bytes(f) for f in frames] == want


def test_unix_socket_and_async_check_tx():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "app.sock")
        srv = tserver.ABCIServer(tkv.KVStoreApplication(), f"unix://{path}")
        srv.start()
        try:
            assert srv.bound_port is None
            cli = tclient.SocketClient(f"unix://{path}", timeout=20.0)
            got, done = [], threading.Event()

            def cb(resp):
                got.append(resp)
                if len(got) == 3:
                    done.set()

            for tx in (b"x=1", b"bad", b"y=2"):
                cli.check_tx_async(tat.CheckTxRequest(tx=tx), cb)
            assert done.wait(20)
            assert [r.code for r in got] == [0, 1, 0]
            assert cli.echo("e").message == "e"
            cli.close()
        finally:
            srv.stop()


def test_remote_client_creator():
    srv = tserver.ABCIServer(tkv.KVStoreApplication(), "tcp://127.0.0.1:0")
    srv.start()
    try:
        conns = tproxy.AppConns(tproxy.remote_client_creator(
            f"tcp://127.0.0.1:{srv.bound_port}"))
        conns.start()  # four sockets, the Echo handshake on each
        try:
            for c in (conns.consensus, conns.mempool, conns.query, conns.snapshot):
                assert isinstance(c, tclient.SocketClient)
            assert conns.mempool.check_tx(tat.CheckTxRequest(tx=b"k=v")).code == 0
            assert conns.query.info().last_block_height == 0
        finally:
            conns.stop()
    finally:
        srv.stop()
    for addr, transport in (("grpc://127.0.0.1:1", "socket"), ("tcp://127.0.0.1:1", "grpc")):
        with pytest.raises(NotImplementedError, match="grpc_abci"):
            tproxy.remote_client_creator(addr, transport)
