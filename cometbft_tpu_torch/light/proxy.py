"""Light-client RPC proxy (reference: light/proxy/).

Serves a JSON-RPC endpoint backed by a full node, with headers VERIFIED
through the light client before being returned: ``commit``, ``header``,
``validators`` come from verified light blocks, and ``block`` is checked
against the verified header hash before relay; other read routes are
forwarded to the primary node untouched (reference proxies the full route
table; merkle-proof verification of query responses is the app's
concern).

The port's copy of the JAX package's ``light/proxy.py``.  Its
``LightClient`` carries the device: on the card each hop's commit goes
through the Ed25519 kernel and each validator-set hash through the tree
kernel.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.light.client import LightClient


class LightProxy:
    """Reference: light/proxy/proxy.go Proxy."""

    def __init__(
        self,
        client: LightClient,
        primary_rpc_url: str,
        laddr: str = "tcp://127.0.0.1:8888",
        logger=None,
    ):
        self.client = client
        self.primary_rpc_url = primary_rpc_url.rstrip("/")
        self.logger = logger or liblog.nop_logger()
        host, _, port = laddr.replace("tcp://", "").rpartition(":")
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, doc, status=200):
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                params = dict(parse_qsl(url.query))
                self._dispatch(url.path.lstrip("/"), params, -1)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                except json.JSONDecodeError:
                    self._reply(
                        {"jsonrpc": "2.0", "id": None,
                         "error": {"code": -32700, "message": "parse error"}},
                        400,
                    )
                    return
                self._dispatch(
                    req.get("method", ""), req.get("params") or {}, req.get("id")
                )

            def _dispatch(self, method, params, id_):
                try:
                    result = proxy.handle(method, params)
                    self._reply({"jsonrpc": "2.0", "id": id_, "result": result})
                except Exception as e:  # noqa: BLE001
                    self._reply(
                        {"jsonrpc": "2.0", "id": id_,
                         "error": {"code": -32603, "message": str(e)}}
                    )

            def log_message(self, *a):  # quiet
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Server((host or "127.0.0.1", int(port)), Handler)
        self.bound_port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- route handling ----------------------------------------------------

    def handle(self, method: str, params: dict):
        if method == "commit":
            return self._verified_commit(params)
        if method == "validators":
            return self._verified_validators(params)
        if method == "block":
            return self._verified_block(params)
        if method == "header":
            from cometbft_tpu_torch.rpc.core import _header_json

            h = self._height_param(params)
            lb = self.client.verify_light_block_at_height(h)
            return {"header": _header_json(lb.signed_header.header)}
        if method == "light_status":
            latest = self.client.trusted_light_block()
            return {
                "trusted_height": str(latest.height if latest else 0),
                "trusted_hash": latest.hash().hex().upper() if latest else "",
                "primary": self.client.primary.id(),
                "witnesses": [w.id() for w in self.client.witnesses],
            }
        # passthrough for everything else
        return self._forward(method, params)

    def _height_param(self, params) -> int:
        h = int(params.get("height", 0) or 0)
        if h == 0:
            lb = self.client.update()
            return lb.height
        return h

    def _verified_commit(self, params):
        from cometbft_tpu_torch.rpc.core import _commit_json, _header_json

        h = self._height_param(params)
        lb = self.client.verify_light_block_at_height(h)
        return {
            "signed_header": {
                "header": _header_json(lb.signed_header.header),
                "commit": _commit_json(lb.signed_header.commit),
            },
            "canonical": True,
        }

    def _verified_block(self, params):
        """Forward the block but check its header hash against the verified
        light block before returning (reference: light/rpc/client.go Block)."""
        h = self._height_param(params)
        lb = self.client.verify_light_block_at_height(h)
        result = self._forward("block", {"height": str(h)})
        got_hash = result.get("block_id", {}).get("hash", "")
        if got_hash.lower() != lb.hash().hex().lower():
            raise RuntimeError(
                f"primary returned block {got_hash} at height {h}, but the "
                f"verified header is {lb.hash().hex().upper()}"
            )
        return result

    def _verified_validators(self, params):
        import base64

        from cometbft_tpu_torch.rpc.core import _hex

        h = self._height_param(params)
        lb = self.client.verify_light_block_at_height(h)
        vals = lb.validator_set
        return {
            "block_height": str(h),
            "validators": [
                {
                    "address": _hex(v.address),
                    "pub_key": {
                        "type": "tendermint/PubKeyEd25519",
                        "value": base64.b64encode(v.pub_key.bytes()).decode(),
                    },
                    "voting_power": str(v.voting_power),
                    "proposer_priority": str(v.proposer_priority),
                }
                for v in vals.validators
            ],
            "count": str(len(vals)),
            "total": str(len(vals)),
        }

    def _forward(self, method: str, params: dict):
        body = json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.primary_rpc_url + "/",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            doc = json.loads(resp.read())
        if "error" in doc:
            raise RuntimeError(doc["error"].get("message", "upstream error"))
        return doc["result"]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="light-proxy", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
