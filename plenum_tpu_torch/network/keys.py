"""Node transport identity keys.

Reference: stp_zmq/zstack.py:183 initLocalKeys — each node has an ed25519
signing keypair whose seed also derives its Curve25519 transport keys,
stored in per-node key directories with public-key allow-lists. Here one
32-byte seed yields the Ed25519 identity used BOTH for message/batch
signing and for transport handshake authentication (crypto_channel);
on-disk layout is a key dir with `<name>.seed` (private) and
`verkeys/<peer>.key` (the allow-list / registry pins).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# the pure-Python RFC 8032 key only: the port needs no `cryptography`
from plenum_tpu_torch.crypto.pure_channel_crypto import (
    Ed25519PrivateKey, serialization)

from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode

_RAW = serialization.Encoding.Raw
_RAW_PUB = serialization.PublicFormat.Raw


class NodeKeys:
    """In-memory transport identity: ed25519 keypair from a 32-byte seed."""

    def __init__(self, seed: Optional[bytes] = None):
        self.seed = seed or os.urandom(32)
        if len(self.seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.sk = Ed25519PrivateKey.from_private_bytes(self.seed)
        self.verkey_raw = self.sk.public_key().public_bytes(_RAW, _RAW_PUB)
        self.verkey = b58encode(self.verkey_raw)

    def sign(self, data: bytes) -> bytes:
        return self.sk.sign(data)

    # ------------------------------------------------------------- disk

    @classmethod
    def init_local_keys(cls, key_dir: str, name: str,
                        seed: Optional[bytes] = None) -> "NodeKeys":
        """Create (or overwrite) this node's key files; → keys."""
        keys = cls(seed)
        os.makedirs(os.path.join(key_dir, "verkeys"), exist_ok=True)
        priv = os.path.join(key_dir, name + ".seed")
        with open(priv, "wb") as f:
            f.write(keys.seed)
        os.chmod(priv, 0o600)
        cls.save_verkey(key_dir, name, keys.verkey)
        return keys

    @classmethod
    def load_local_keys(cls, key_dir: str, name: str) -> "NodeKeys":
        with open(os.path.join(key_dir, name + ".seed"), "rb") as f:
            return cls(f.read())

    @staticmethod
    def save_verkey(key_dir: str, name: str, verkey_b58: str):
        """Pin a peer's verkey into the allow-list directory."""
        os.makedirs(os.path.join(key_dir, "verkeys"), exist_ok=True)
        with open(os.path.join(key_dir, "verkeys", name + ".key"), "w") as f:
            f.write(verkey_b58)

    @staticmethod
    def load_verkeys(key_dir: str) -> Dict[str, bytes]:
        """→ {peer_name: raw_verkey} from the allow-list directory."""
        vdir = os.path.join(key_dir, "verkeys")
        out = {}
        if os.path.isdir(vdir):
            for fn in os.listdir(vdir):
                if fn.endswith(".key"):
                    with open(os.path.join(vdir, fn)) as f:
                        out[fn[:-4]] = b58decode(f.read().strip())
        return out
