"""The port's remote signer (``privval/signer.py``) against the JAX
package's, across packages over real loopback links.

A port ``SignerClient`` (the node's side: ``SignerListenerEndpoint``) talks
to a JAX ``SignerServer`` (the key's side), and the reverse.  Both must
give the signatures a ``FilePV`` gives, leave the same last-sign state on
disk, and refuse a double sign with the same message.  The link is a
``SecretConnection`` in both packages; with ``COMETBFT_TPU_HANDSHAKE=0`` and
``COMETBFT_TPU_AEAD=0`` both run their serial paths (no JAX program, the
port on ``device="cpu"``).  The link identity a signer derives from its
key must be the JAX package's, so a listener that pinned a JAX signer
re-admits a port one.  The device rule: a port ``SignerServer`` or
listener with no card and no CPU asked for raises.
"""

from __future__ import annotations

import importlib
import json

import pytest

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
CHAIN = "signer-chain"


@pytest.fixture(autouse=True)
def _serial_links(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE", "0")
    monkeypatch.setenv("COMETBFT_TPU_AEAD", "0")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg: str) -> dict:
    return {"device": "cpu"} if pkg.endswith("_torch") else {}


SEED = bytes(range(32))


def _file_pv(pkg: str, tmp_path, tag: str):
    fp = _m(pkg, "privval.file_pv")
    priv = _m(pkg, "crypto.keys").Ed25519PrivKey.from_seed(SEED)
    d = tmp_path / f"{tag}-{pkg}"
    d.mkdir()
    pv = fp.FilePV(priv, str(d / "key.json"), str(d / "state.json"))
    pv.save()
    return pv


def _script(pkg: str):
    """The messages a validator signs: a proposal and both votes at heights
    1-2, a nil prevote at round 1, a vote with an extension."""
    b = _m(pkg, "types.basic")
    v = _m(pkg, "types.vote")
    addr = _m(pkg, "crypto.keys").Ed25519PrivKey.from_seed(SEED).pub_key().address()
    bid = b.BlockID(b"\x11" * 32, b.PartSetHeader(3, b"\x22" * 32))
    out = []
    for h in (1, 2):
        ts = b.Timestamp(1_700_000_000 + h, 7 * h)
        out.append(("proposal", v.Proposal(h, 0, -1, bid, ts)))
        out.append(("vote", v.Vote(b.PREVOTE_TYPE, h, 0, bid, ts, addr, 0)))
        out.append(("vote", v.Vote(b.PRECOMMIT_TYPE, h, 0, bid, ts, addr, 0)))
    ts = b.Timestamp(1_700_000_003, 1)
    out.append(("vote", v.Vote(b.PREVOTE_TYPE, 3, 1, b.BlockID(b"", b.PartSetHeader(0, b"")),
                               ts, addr, 0)))
    ext = v.Vote(b.PRECOMMIT_TYPE, 3, 1, bid, ts, addr, 0)
    ext.extension = b"vote extension bytes"
    out.append(("ext", ext))
    return out


def _sign_all(signer, pkg: str) -> list:
    sigs = []
    for kind, msg in _script(pkg):
        if kind == "proposal":
            signer.sign_proposal(CHAIN, msg)
            sigs.append((kind, msg.signature, msg.timestamp.to_ns()))
        else:
            signer.sign_vote(CHAIN, msg, sign_extension=(kind == "ext"))
            sigs.append((kind, msg.signature, msg.extension_signature,
                         msg.timestamp.to_ns()))
    return sigs


def _double_sign(signer, pkg: str) -> str:
    b = _m(pkg, "types.basic")
    v = _m(pkg, "types.vote")
    addr = _m(pkg, "crypto.keys").Ed25519PrivKey.from_seed(SEED).pub_key().address()
    other = b.BlockID(b"\x33" * 32, b.PartSetHeader(1, b"\x44" * 32))
    vote = v.Vote(b.PRECOMMIT_TYPE, 2, 0, other, b.Timestamp(1_700_000_002, 14), addr, 0)
    with pytest.raises(Exception) as ei:
        signer.sign_vote(CHAIN, vote)
    assert type(ei.value).__name__ == "RemoteSignerError"
    return str(ei.value)


def _remote(node_pkg: str, key_pkg: str, tmp_path):
    """(client, stop): ``node_pkg``'s listener and client, ``key_pkg``'s
    server over a FilePV at the seed, joined on 127.0.0.1."""
    ls = _m(node_pkg, "privval.signer")
    ss = _m(key_pkg, "privval.signer")
    ep = ls.SignerListenerEndpoint("tcp://127.0.0.1:0", **_kw(node_pkg))
    ep.start()
    pv = _file_pv(key_pkg, tmp_path, f"remote-{node_pkg}")
    srv = ss.SignerServer(f"tcp://127.0.0.1:{ep.bound_port}", pv, **_kw(key_pkg))
    srv.start()
    ep.wait_for_connection(timeout=30)
    client = ls.RetrySignerClient(ls.SignerClient(ep))

    def stop():
        srv.stop()
        ep.stop()

    return client, pv, stop


def _state(pv) -> dict:
    with open(pv.state_path) as f:
        return json.load(f)


@pytest.mark.parametrize("node_pkg,key_pkg", [
    ("cometbft_tpu_torch", "cometbft_tpu"),
    ("cometbft_tpu", "cometbft_tpu_torch"),
    ("cometbft_tpu_torch", "cometbft_tpu_torch"),
])
def test_remote_signatures_state_and_refusal_equal_a_file_pv(node_pkg, key_pkg, tmp_path):
    local = _file_pv("cometbft_tpu", tmp_path, "local")
    want = _sign_all(local, "cometbft_tpu")
    want_state = _state(local)
    with pytest.raises(Exception) as ei:
        b = _m("cometbft_tpu", "types.basic")
        v = _m("cometbft_tpu", "types.vote")
        addr = local.pub_key().address()
        local.sign_vote(CHAIN, v.Vote(b.PRECOMMIT_TYPE, 2, 0, b.BlockID(
            b"\x33" * 32, b.PartSetHeader(1, b"\x44" * 32)), b.Timestamp(1_700_000_002, 14),
            addr, 0))
    want_refusal = str(ei.value)

    client, pv, stop = _remote(node_pkg, key_pkg, tmp_path)
    try:
        assert client.pub_key().bytes() == local.pub_key().bytes()
        assert _sign_all(client, node_pkg) == want
        assert _state(pv) == want_state
        assert _double_sign(client, node_pkg) == want_refusal
        assert _state(pv) == want_state  # a refusal writes nothing
    finally:
        stop()


def test_link_key_equals_the_jax_package():
    keys = []
    for pkg in PKGS:
        s = _m(pkg, "privval.signer")
        priv = _m(pkg, "crypto.keys").Ed25519PrivKey.from_seed(SEED)
        pv = _m(pkg, "privval.file_pv").FilePV(priv, "/nonexistent/k", "/nonexistent/s")
        keys.append(s._derive_link_key(pv).bytes())
    assert keys[0] == keys[1]


def test_listener_pins_the_jax_signer_identity_for_a_port_signer(tmp_path):
    """A node's listener pins the first signer's identity; a port signer of
    the same key presents the JAX one's (the derived link key), so it is
    re-admitted after the JAX one goes away."""
    ls = _m("cometbft_tpu", "privval.signer")
    ep = ls.SignerListenerEndpoint("tcp://127.0.0.1:0")
    ep.start()
    try:
        for pkg in PKGS:
            pv = _file_pv(pkg, tmp_path, "pin")
            srv = _m(pkg, "privval.signer").SignerServer(
                f"tcp://127.0.0.1:{ep.bound_port}", pv, **_kw(pkg))
            srv.start()
            ep._conn_ready.clear()
            ep.wait_for_connection(timeout=30)
            assert ls.SignerClient(ep).ping()
            srv.stop()
            ep._conn.close()
    finally:
        ep.stop()


def test_signer_ends_follow_the_device_rule(monkeypatch):
    """No card and no CPU asked for: the port's signer ends raise when
    built; with ``device="cpu"`` they build."""
    from cometbft_tpu_torch.privval import signer

    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    pv = object()
    with pytest.raises(RuntimeError):
        signer.SignerServer("tcp://127.0.0.1:1", pv)
    with pytest.raises(RuntimeError):
        signer.SignerListenerEndpoint("tcp://127.0.0.1:0")
    signer.SignerListenerEndpoint("tcp://127.0.0.1:0", device="cpu")
