"""Node key: the p2p identity (reference: p2p/key.go).

The node ID is the hex address (truncated SHA-256) of the node's Ed25519
public key — the same derivation validators use, so peer authentication in
the secret-connection handshake binds directly to the dialed ID.
"""

from __future__ import annotations

import base64
import json
import os

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey


class NodeKey:
    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @property
    def node_id(self) -> str:
        return self.priv_key.pub_key().address().hex()

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {
            "priv_key": {
                "type": "tendermint/PrivKeyEd25519",
                "value": base64.b64encode(self.priv_key.bytes()).decode(),
            }
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)

    @staticmethod
    def load(path: str) -> "NodeKey":
        with open(path) as f:
            doc = json.load(f)
        raw = base64.b64decode(doc["priv_key"]["value"])
        return NodeKey(Ed25519PrivKey.from_seed(raw[:32]))

    @staticmethod
    def load_or_generate(path: str) -> "NodeKey":
        if os.path.exists(path):
            return NodeKey.load(path)
        nk = NodeKey(Ed25519PrivKey.generate())
        nk.save(path)
        return nk
