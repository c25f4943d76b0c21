"""Identity signers — the reference's Signer seam.

Reference: `stp_core/crypto/signer.py:9` (Signer ABC),
`plenum/common/signer_simple.py:13` (SimpleSigner: identifier = b58 verkey),
`plenum/common/signer_did.py:76` (DidSigner: identifier = b58 of first 16
bytes of verkey, abbreviated verkey with '~' prefix).
The port signs with its copy of the pure-Python RFC 8032 code; Ed25519 is
deterministic, so its signatures are bit-identical to the JAX package's
OpenSSL-backed ones.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Optional

from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.serialization import serialize_msg_for_signing
from . import ed25519


class Signer(ABC):
    @property
    @abstractmethod
    def identifier(self) -> str: ...

    @property
    @abstractmethod
    def verkey(self) -> str: ...

    @abstractmethod
    def sign(self, msg) -> str: ...


class SimpleSigner(Signer):
    """identifier == full b58 verkey."""

    def __init__(self, seed: Optional[bytes] = None):
        self.seed = seed or os.urandom(32)
        if len(self.seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.verraw, _ = ed25519.keypair_from_seed(self.seed)
        self.verstr = b58encode(self.verraw)

    @property
    def identifier(self) -> str:
        return self.verstr

    @property
    def verkey(self) -> str:
        return self.verstr

    def sign_bytes(self, data: bytes) -> bytes:
        return ed25519.sign(data, self.seed)

    def sign(self, msg) -> str:
        """Sign a dict (canonical signing serialization) or bytes → b58."""
        data = msg if isinstance(msg, bytes) else serialize_msg_for_signing(msg)
        return b58encode(self.sign_bytes(data))


class DidSigner(Signer):
    """DID-style: identifier = b58(verkey[:16]), abbreviated verkey =
    '~' + b58(verkey[16:])."""

    def __init__(self, seed: Optional[bytes] = None):
        self._simple = SimpleSigner(seed)
        raw = self._simple.verraw
        self._identifier = b58encode(raw[:16])
        self._abbreviated = "~" + b58encode(raw[16:])

    @property
    def seed(self) -> bytes:
        return self._simple.seed

    @property
    def identifier(self) -> str:
        return self._identifier

    @property
    def verkey(self) -> str:
        return self._abbreviated

    @property
    def full_verkey(self) -> str:
        return self._simple.verstr

    def sign(self, msg) -> str:
        return self._simple.sign(msg)


def verkey_from_identifier(identifier: str, verkey: Optional[str]) -> bytes:
    """Resolve raw 32-byte verkey from (identifier, maybe-abbreviated verkey).

    Reference semantics: a '~'-prefixed verkey is completed by the
    identifier's 16 bytes; a missing verkey means the identifier IS the
    verkey (cryptonym).
    """
    if not verkey:
        return b58decode(identifier)
    if verkey.startswith("~"):
        return b58decode(identifier) + b58decode(verkey[1:])
    return b58decode(verkey)
