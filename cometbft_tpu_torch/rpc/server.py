"""JSON-RPC server: HTTP (POST body + GET URI params) and WebSocket
subscriptions.

Reference: rpc/jsonrpc/server — routes resolve against ``core.ROUTES``;
``/websocket`` upgrades to RFC-6455 and supports ``subscribe`` /
``unsubscribe`` / ``unsubscribe_all`` backed by the node's EventBus, pushing
each matching event as a JSON-RPC notification with the subscription query
echoed (reference: rpc/core/events.go + jsonrpc/server/ws_handler.go).

The port's copy of the JAX package's ``rpc/server.py``: the same bytes
over HTTP, URI GET, batches and the websocket.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs.pubsub import Query, QueryError
from cometbft_tpu_torch.rpc import core as rpccore

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _rpc_response(id_, result=None, error=None) -> bytes:
    doc = {"jsonrpc": "2.0", "id": id_}
    if error is not None:
        doc["error"] = error
    else:
        doc["result"] = result
    return json.dumps(doc).encode()


def _route_status(method, payload: bytes) -> int:
    """HTTP status for a JSON-RPC reply.  Everything is 200 except the
    health route, whose errors (fail-stop storage fault) must surface as
    a 503 so liveness probes fail without parsing JSON-RPC envelopes."""
    if method != "health":
        return 200
    try:
        doc = json.loads(payload)
    except ValueError:
        return 200
    return 503 if isinstance(doc, dict) and "error" in doc else 200


def _event_to_json(msg) -> dict:
    """Render a pubsub Message (typed event data) for WS delivery."""
    from cometbft_tpu_torch.types import events as tev

    data = msg.data
    ev_type = msg.tags.get(tev.EVENT_TYPE_KEY, ["?"])[0]
    value: dict = {}
    if isinstance(data, tev.EventDataNewBlock):
        value = {"block": rpccore._block_json(data.block)}
    elif isinstance(data, tev.EventDataNewBlockHeader):
        value = {"header": rpccore._header_json(data.header)}
    elif isinstance(data, tev.EventDataTx):
        value = {
            "TxResult": {
                "height": str(data.height),
                "index": data.index,
                "tx": base64.b64encode(data.tx).decode(),
                "result": rpccore._tx_result_json(data.result),
            }
        }
    elif isinstance(data, tev.EventDataRoundState):
        value = {"height": str(data.height), "round": data.round_, "step": data.step}
    elif isinstance(data, tev.EventDataVote):
        v = data.vote
        value = {
            "vote": {
                "type": v.type_,
                "height": str(v.height),
                "round": v.round_,
                "validator_index": v.validator_index,
            }
        }
    return {
        "type": f"tendermint/event/{ev_type}",
        "value": value,
        "events": msg.tags,
    }


class RPCServer:
    def __init__(self, rpc_config, env: rpccore.Environment, event_bus, logger=None):
        self.config = rpc_config
        self.env = env
        self.event_bus = event_bus
        self.logger = logger or liblog.nop_logger()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.bound_port: Optional[int] = None

    def start(self) -> None:
        addr = self.config.laddr
        hostport = addr[len("tcp://") :] if addr.startswith("tcp://") else addr
        host, port = hostport.rsplit(":", 1)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence default stderr spam
                server.logger.debug("http " + fmt % args)

            def _send_json(self, payload: bytes, status: int = 200):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                cors = server.config.cors_allowed_origins
                if cors:
                    self.send_header("Access-Control-Allow-Origin", cors[0])
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path in ("/websocket", "/v1/websocket"):
                    server._handle_websocket(self)
                    return
                name = url.path.lstrip("/")
                if not name:
                    routes = "\n".join(sorted(rpccore.ROUTES))
                    self._send_json(
                        json.dumps({"available_endpoints": sorted(rpccore.ROUTES)}).encode()
                    )
                    return
                params = dict(parse_qsl(url.query))
                # URI string params arrive quoted: strip the quotes but keep
                # the fact that they were quoted (bytes args decode raw)
                params = {
                    k: rpccore.QuotedString(v[1:-1])
                    if len(v) >= 2 and v[0] == '"' and v[-1] == '"'
                    else v
                    for k, v in params.items()
                }
                self._dispatch(name, params, id_=-1)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > server.config.max_body_bytes:
                    self._send_json(
                        _rpc_response(
                            None, error={"code": -32600, "message": "body too large"}
                        ),
                        413,
                    )
                    return
                body = self.rfile.read(length)
                try:
                    req = json.loads(body)
                except (json.JSONDecodeError, UnicodeDecodeError, ValueError,
                        RecursionError):
                    # non-UTF8 bytes, malformed JSON and parser bombs all
                    # get the spec parse-error reply, never a broken conn
                    self._send_json(
                        _rpc_response(
                            None, error={"code": -32700, "message": "parse error"}
                        )
                    )
                    return
                if isinstance(req, list):  # batch
                    parts = [server._call_route_json(r) for r in req[: server.config.max_request_batch_size]]
                    self._send_json(b"[" + b",".join(parts) + b"]")
                    return
                payload = server._call_route_json(req)
                method = req.get("method") if isinstance(req, dict) else None
                self._send_json(payload, _route_status(method, payload))

            def _dispatch(self, name: str, params: dict, id_):
                payload = server._call_route_json(
                    {"method": name, "params": params, "id": id_}
                )
                self._send_json(payload, _route_status(name, payload))

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.bound_port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self.logger.info("RPC server listening", addr=f"{host}:{self.bound_port}")

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- route dispatch ----------------------------------------------------

    def _call_route_json(self, req: dict) -> bytes:
        if not isinstance(req, dict):
            return _rpc_response(
                None, error={"code": -32600, "message": "invalid request"}
            )
        id_ = req.get("id", -1)
        method = req.get("method", "")
        if not isinstance(method, str):
            return _rpc_response(
                id_, error={"code": -32600, "message": "method must be a string"}
            )
        params = req.get("params")
        if params is None:
            params = {}
        if not isinstance(params, (dict, list)):
            return _rpc_response(
                id_, error={"code": -32602, "message": "params must be an object"}
            )
        if isinstance(params, list):
            return _rpc_response(
                id_,
                error={
                    "code": -32602,
                    "message": "positional params not supported; use named params",
                },
            )
        fn_name = rpccore.ROUTES.get(method)
        if fn_name is None:
            fn_name = rpccore.UNSAFE_ROUTES.get(method)
            if fn_name is not None and not getattr(
                self.config, "unsafe", False
            ):
                return _rpc_response(
                    id_,
                    error={
                        "code": -32601,
                        "message": f"method {method!r} requires rpc.unsafe",
                    },
                )
        if fn_name is None:
            return _rpc_response(
                id_, error={"code": -32601, "message": f"method {method!r} not found"}
            )
        try:
            kwargs = rpccore.coerce_params(params)
            result = getattr(self.env, fn_name)(**kwargs)
            return _rpc_response(id_, result=result)
        except rpccore.RPCError as e:
            return _rpc_response(
                id_, error={"code": e.code, "message": e.message, "data": e.data}
            )
        except TypeError as e:
            return _rpc_response(
                id_, error={"code": -32602, "message": f"invalid params: {e}"}
            )
        except Exception as e:  # noqa: BLE001
            self.logger.error("rpc handler error", method=method, err=repr(e))
            return _rpc_response(
                id_, error={"code": -32603, "message": f"internal error: {e}"}
            )

    # -- WebSocket ---------------------------------------------------------

    def _handle_websocket(self, handler: BaseHTTPRequestHandler) -> None:
        key = handler.headers.get("Sec-WebSocket-Key")
        if not key:
            handler.send_response(400)
            handler.end_headers()
            return
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        handler.send_response(101, "Switching Protocols")
        handler.send_header("Upgrade", "websocket")
        handler.send_header("Connection", "Upgrade")
        handler.send_header("Sec-WebSocket-Accept", accept)
        handler.end_headers()
        conn = handler.connection
        conn.settimeout(None)
        _WSConn(self, conn).run()


def _ws_send(conn: socket.socket, payload: bytes, opcode: int = 1) -> None:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 1 << 16:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    conn.sendall(header + payload)


_WS_MAX_FRAME = 16 * 1024 * 1024  # cap attacker-declared frame lengths


def _ws_recv(conn: socket.socket) -> Optional[tuple[int, bytes]]:
    def read_exact(k: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < k:
            chunk = conn.recv(k - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    hdr = read_exact(2)
    if hdr is None:
        return None
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    n = hdr[1] & 0x7F
    if n == 126:
        ext = read_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = read_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    if n > _WS_MAX_FRAME:
        return None  # oversized frame: drop the connection
    mask = b"\x00" * 4
    if masked:
        mask = read_exact(4)
        if mask is None:
            return None
    payload = read_exact(n) if n else b""
    if payload is None:
        return None
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class _WSConn:
    """One WebSocket client: JSON-RPC over frames + event push."""

    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(self, server: RPCServer, conn: socket.socket):
        self.server = server
        self.conn = conn
        with _WSConn._counter_lock:
            _WSConn._counter += 1
            self.subscriber = f"ws-{_WSConn._counter}"
        self._send_lock = threading.Lock()
        self._pushers: list[threading.Thread] = []
        self._closed = threading.Event()

    def _send(self, payload: bytes, opcode: int = 1) -> None:
        with self._send_lock:
            _ws_send(self.conn, payload, opcode)

    def run(self) -> None:
        try:
            while not self._closed.is_set():
                frame = _ws_recv(self.conn)
                if frame is None:
                    break
                opcode, payload = frame
                if opcode == 8:  # close
                    self._send(b"", opcode=8)
                    break
                if opcode == 9:  # ping
                    self._send(payload, opcode=10)
                    continue
                if opcode not in (1, 2):
                    continue
                try:
                    req = json.loads(payload)
                except json.JSONDecodeError:
                    self._send(
                        _rpc_response(
                            None, error={"code": -32700, "message": "parse error"}
                        )
                    )
                    continue
                self._handle_rpc(req)
        except OSError:
            pass
        finally:
            self._closed.set()
            self.server.event_bus.unsubscribe_all(self.subscriber)
            try:
                self.conn.close()
            except OSError:
                pass

    def _handle_rpc(self, req: dict) -> None:
        method = req.get("method", "")
        id_ = req.get("id", -1)
        params = req.get("params") or {}
        if method == "subscribe":
            self._subscribe(id_, params.get("query", ""))
        elif method == "unsubscribe":
            try:
                q = Query.parse(params.get("query", ""))
                self.server.event_bus.unsubscribe(self.subscriber, q)
                self._send(_rpc_response(id_, result={}))
            except (QueryError, ValueError) as e:
                self._send(
                    _rpc_response(id_, error={"code": -32603, "message": str(e)})
                )
        elif method == "unsubscribe_all":
            self.server.event_bus.unsubscribe_all(self.subscriber)
            self._send(_rpc_response(id_, result={}))
        else:
            self._send(self.server._call_route_json(req))

    def _subscribe(self, id_, query_str: str) -> None:
        try:
            q = Query.parse(query_str)
        except QueryError as e:
            self._send(
                _rpc_response(id_, error={"code": -32602, "message": str(e)})
            )
            return
        try:
            sub = self.server.event_bus.subscribe(
                self.subscriber, q, capacity=100
            )
        except ValueError as e:
            self._send(
                _rpc_response(id_, error={"code": -32603, "message": str(e)})
            )
            return
        self._send(_rpc_response(id_, result={}))

        def pusher():
            while not self._closed.is_set() and not sub.canceled.is_set():
                msg = sub.next(timeout=0.2)
                if msg is None:
                    continue
                payload = _rpc_response(
                    id_,
                    result={
                        "query": query_str,
                        "data": _event_to_json(msg),
                        "events": msg.tags,
                    },
                )
                try:
                    self._send(payload)
                except OSError:
                    self._closed.set()
                    return

        t = threading.Thread(target=pusher, daemon=True)
        t.start()
        self._pushers.append(t)
