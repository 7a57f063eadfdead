"""Remote signer: validator keys live in a separate process.

Reference: privval/ — the NODE runs a ``SignerListenerEndpoint`` (it
listens; the remote signer dials IN, so the key machine needs no inbound
ports) and wraps it in a ``SignerClient`` satisfying the PrivValidator
interface.  The remote side runs ``SignerServer`` around a FilePV.

The TCP link is wrapped in ``SecretConnection`` (X25519 + HKDF +
ChaCha20-Poly1305 with an Ed25519-signed challenge), exactly as the
reference wraps tcp privval links (privval/socket_listeners.go:79): the
signing channel is encrypted, mutually authenticated, and the listener
pins the first authenticated signer identity — a later connection claiming
a *different* identity is rejected instead of silently hijacking the
signer slot.  Messages are JSON {type, ...} with votes/proposals as hex of
their deterministic proto encoding, framed by the secret connection.

A ``RetrySignerClient`` retries *transport* failures only; errors reported
by the signer itself (e.g. a double-sign refusal) surface immediately
(reference: privval/retry_signer_client.go).

The port's copy of the JAX package's ``privval/signer.py``.  Both ends take
``device``, which their ``SecretConnection`` gets, so the link's X25519
exchange and its frames go to the card (``device=None``): built with no
card they raise unless the caller names the CPU (``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu``; ``types/validation.entry_device``).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Optional

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, pub_key_from_type
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.p2p.secret_connection import (
    SecretConnection,
    SecretConnectionError,
)
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.validation import entry_device
from cometbft_tpu_torch.types.vote import Proposal, Vote


class RemoteSignerError(Exception):
    """An error reported by the remote signer itself (e.g. refusal to
    double-sign).  NOT retried."""


class RemoteSignerTransportError(RemoteSignerError):
    """The signer link failed (connect/io/handshake).  Safe to retry."""


def _send_msg(conn: SecretConnection, doc: dict) -> None:
    conn.write_msg(json.dumps(doc).encode())


def _recv_msg(conn: SecretConnection) -> dict:
    return json.loads(conn.read_msg(max_size=1 << 20).decode())


def _derive_link_key(priv_validator) -> Ed25519PrivKey:
    """Deterministic link identity for a signer: hash of the validator priv
    key bytes (domain-separated).  Stable across restarts so the listener's
    identity pinning re-admits a restarted signer; falls back to a fresh
    key when the privval does not expose raw key bytes."""
    import hashlib

    priv = getattr(priv_validator, "priv_key", None)
    raw = priv.bytes() if priv is not None and hasattr(priv, "bytes") else None
    if not raw:
        return Ed25519PrivKey.generate()
    seed = hashlib.sha256(b"cometbft-tpu/privval-link-key" + raw).digest()
    return Ed25519PrivKey.from_seed(seed)


def _parse_laddr(laddr: str) -> tuple[str, int]:
    s = laddr.split("://", 1)[-1]
    host, _, port = s.rpartition(":")
    return host or "0.0.0.0", int(port)


class SignerListenerEndpoint:
    """Node side: accept ONE authenticated signer connection and serialize
    requests over it (reference: privval/signer_listener_endpoint.go +
    socket_listeners.go SecretConnection wrapping).

    ``conn_key`` is the node's identity for the handshake (an ephemeral key
    is generated when omitted).  ``expected_signer`` optionally pins the
    signer's Ed25519 identity up front (32 raw bytes); otherwise the first
    authenticated identity is pinned and later connections presenting a
    different identity are rejected.
    """

    def __init__(
        self,
        laddr: str,
        timeout: float = 5.0,
        logger=None,
        conn_key: Optional[Ed25519PrivKey] = None,
        expected_signer: Optional[bytes] = None,
        device=None,
    ):
        self.device = entry_device(device)  # the gate open for the handshake
        self.laddr = laddr
        self.timeout = timeout
        self.logger = logger or liblog.nop_logger()
        self.conn_key = conn_key or Ed25519PrivKey.generate()
        self._pinned_signer: Optional[bytes] = expected_signer
        self._lock = threading.Lock()
        self._conn: Optional[SecretConnection] = None
        self._listener: Optional[socket.socket] = None
        self._conn_ready = threading.Event()
        self._stopped = False

    def start(self) -> None:
        host, port = _parse_laddr(self.laddr)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(1)
        self._listener = s
        self.bound_port = s.getsockname()[1]
        threading.Thread(
            target=self._accept_routine, name="privval-accept", daemon=True
        ).start()

    def _accept_routine(self) -> None:
        while not self._stopped:
            try:
                raw, addr = self._listener.accept()
            except OSError:
                return
            # handshake on its own thread: an unauthenticated peer that
            # stalls mid-handshake must not block further accepts (and with
            # them the legitimate signer's reconnect)
            threading.Thread(
                target=self._handshake_routine,
                args=(raw, addr),
                name="privval-handshake",
                daemon=True,
            ).start()

    def _handshake_routine(self, raw: socket.socket, addr) -> None:
        raw.settimeout(self.timeout)
        try:
            conn = SecretConnection(raw, self.conn_key, device=self.device)
        except (OSError, SecretConnectionError) as e:
            self.logger.error(
                "signer handshake failed", addr=str(addr), err=str(e)
            )
            try:
                raw.close()
            except OSError:
                pass
            return
        identity = conn.remote_pub_key.bytes()
        with self._lock:
            if self._pinned_signer is None:
                self._pinned_signer = identity
            elif identity != self._pinned_signer:
                # an authenticated slot must not be hijackable by a
                # different identity (ADVICE r1: privval/signer.py:88)
                self.logger.error(
                    "rejecting signer with unexpected identity",
                    addr=str(addr),
                    got=identity.hex(),
                    want=self._pinned_signer.hex(),
                )
                try:
                    conn.close()
                except OSError:
                    pass
                return
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
            self._conn = conn
        self._conn_ready.set()
        self.logger.info("remote signer connected", addr=str(addr))

    def wait_for_connection(self, timeout: float = 30.0) -> None:
        if not self._conn_ready.wait(timeout=timeout):
            raise RemoteSignerTransportError("no remote signer connected")

    def request(self, doc: dict) -> dict:
        with self._lock:
            conn = self._conn
            if conn is None:
                raise RemoteSignerTransportError("no signer connection")
            try:
                _send_msg(conn, doc)
                res = _recv_msg(conn)
            except (OSError, SecretConnectionError, ValueError) as e:
                self._conn = None
                self._conn_ready.clear()
                raise RemoteSignerTransportError(
                    f"signer io failed: {e}"
                ) from e
        if res.get("error"):
            raise RemoteSignerError(res["error"])
        return res

    def stop(self) -> None:
        self._stopped = True
        for s in (self._conn, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class SignerClient:
    """PrivValidator over a SignerListenerEndpoint (reference:
    privval/signer_client.go)."""

    def __init__(self, endpoint: SignerListenerEndpoint):
        self.endpoint = endpoint
        self._pub = None

    def pub_key(self):
        if self._pub is None:
            res = self.endpoint.request({"type": "pub_key"})
            self._pub = pub_key_from_type(
                res["key_type"], bytes.fromhex(res["pub_key"])
            )
        return self._pub

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False):
        res = self.endpoint.request(
            {
                "type": "sign_vote",
                "chain_id": chain_id,
                "vote": codec.encode_vote(vote).hex(),
                "sign_extension": sign_extension,
            }
        )
        signed = codec.decode_vote(bytes.fromhex(res["vote"]))
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp
        vote.extension_signature = signed.extension_signature

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        res = self.endpoint.request(
            {
                "type": "sign_proposal",
                "chain_id": chain_id,
                "proposal": codec.encode_proposal(proposal).hex(),
            }
        )
        signed = codec.decode_proposal(bytes.fromhex(res["proposal"]))
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp

    def ping(self) -> bool:
        try:
            self.endpoint.request({"type": "ping"})
            return True
        except RemoteSignerError:
            return False


class RetrySignerClient:
    """Reference: privval/retry_signer_client.go.

    Retries only ``RemoteSignerTransportError`` — an error *reported by the
    signer* (e.g. double-sign refusal) is final and surfaces immediately,
    matching the reference's transport/remote error split."""

    def __init__(self, inner: SignerClient, retries: int = 5, wait: float = 0.2):
        self.inner = inner
        self.retries = retries
        self.wait = wait

    def _retry(self, fn, *args, **kw):
        last: Optional[Exception] = None
        for _ in range(self.retries):
            try:
                return fn(*args, **kw)
            except RemoteSignerTransportError as e:
                last = e
                time.sleep(self.wait)
        raise last  # type: ignore[misc]

    def pub_key(self):
        return self._retry(self.inner.pub_key)

    def sign_vote(self, chain_id, vote, sign_extension=False):
        return self._retry(
            self.inner.sign_vote, chain_id, vote, sign_extension
        )

    def sign_proposal(self, chain_id, proposal):
        return self._retry(self.inner.sign_proposal, chain_id, proposal)


class SignerServer:
    """Remote side: dial the node and answer signing requests from a
    FilePV over a SecretConnection (reference: privval/signer_server.go +
    signer_dialer_endpoint).

    ``conn_key`` is the signer's link identity — the node's listener pins
    it, so it must survive signer restarts.  By default it is derived
    deterministically from the validator key (HKDF-style hash of the priv
    key bytes), so a restarted signer presents the same link identity and
    is re-admitted instead of locked out.  ``expected_node`` optionally
    pins the node's identity.
    """

    def __init__(
        self,
        addr: str,
        priv_validator,
        logger=None,
        conn_key: Optional[Ed25519PrivKey] = None,
        expected_node: Optional[bytes] = None,
        device=None,
    ):
        self.device = entry_device(device)  # the gate open for the dial
        self.addr = addr
        self.pv = priv_validator
        self.logger = logger or liblog.nop_logger()
        self.conn_key = conn_key or _derive_link_key(priv_validator)
        self.expected_node = expected_node
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="signer-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _run(self) -> None:
        host, port = _parse_laddr(self.addr)
        while not self._stopped.is_set():
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
            except OSError:
                time.sleep(0.5)
                continue
            try:
                conn = SecretConnection(sock, self.conn_key, device=self.device)
                if (
                    self.expected_node is not None
                    and conn.remote_pub_key.bytes() != self.expected_node
                ):
                    raise SecretConnectionError(
                        "node identity mismatch: "
                        f"{conn.remote_pub_key.bytes().hex()}"
                    )
            except (OSError, SecretConnectionError) as e:
                self.logger.error("node handshake failed", err=str(e))
                try:
                    sock.close()
                except OSError:
                    pass
                time.sleep(0.5)
                continue
            self.logger.info("connected to node", addr=self.addr)
            try:
                self._serve(conn)
            except (OSError, SecretConnectionError, ValueError) as e:
                self.logger.debug("signer connection lost", err=str(e))
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            # backoff before redialing: a connection the listener accepted
            # and then closed (e.g. identity rejected) must not busy-loop
            # full X25519 handshakes against it
            self._stopped.wait(0.5)

    def _serve(self, conn: SecretConnection) -> None:
        conn.settimeout(None)
        while not self._stopped.is_set():
            req = _recv_msg(conn)
            try:
                res = self._handle(req)
            except Exception as e:  # noqa: BLE001 — double-sign etc.
                res = {"error": str(e)}
            _send_msg(conn, res)

    def _handle(self, req: dict) -> dict:
        kind = req.get("type")
        if kind == "ping":
            return {"type": "pong"}
        if kind == "pub_key":
            pub = self.pv.pub_key()
            return {
                "type": "pub_key",
                "key_type": pub.type_,
                "pub_key": pub.bytes().hex(),
            }
        if kind == "sign_vote":
            vote = codec.decode_vote(bytes.fromhex(req["vote"]))
            self.pv.sign_vote(
                req["chain_id"], vote, sign_extension=req.get("sign_extension", False)
            )
            return {"type": "signed_vote", "vote": codec.encode_vote(vote).hex()}
        if kind == "sign_proposal":
            proposal = codec.decode_proposal(bytes.fromhex(req["proposal"]))
            self.pv.sign_proposal(req["chain_id"], proposal)
            return {
                "type": "signed_proposal",
                "proposal": codec.encode_proposal(proposal).hex(),
            }
        raise RemoteSignerError(f"unknown request type {kind!r}")
