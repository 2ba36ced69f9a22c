"""Persistent node identity (counterpart of ``cometbft_tpu/p2p/key.py``;
reference: ``p2p/key.go``).  The key file is the JAX package's: each
package loads the other's.

A node's ID is the hex of its ed25519 pubkey address (first 20 bytes of
SHA-256) — self-authenticating: the SecretConnection handshake proves
possession of the key behind the ID.
"""

from __future__ import annotations

import json
import os

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey


def node_id(pub_key: Ed25519PubKey) -> str:
    return pub_key.address().hex()


class NodeKey:
    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @property
    def pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    @property
    def id(self) -> str:
        return node_id(self.pub_key)

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.generate())

    @classmethod
    def from_secret(cls, secret: bytes) -> "NodeKey":
        return cls(Ed25519PrivKey.from_secret(secret))

    # -------------------------------------------------------- persistence

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls.generate()
        nk.save(path)
        return nk

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            doc = json.load(f)
        return cls(Ed25519PrivKey(bytes.fromhex(doc["priv_key"])))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"id": self.id,
                       "priv_key": self.priv_key.bytes().hex()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
