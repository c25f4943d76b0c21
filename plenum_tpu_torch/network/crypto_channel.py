"""Authenticated encrypted channel — the CurveZMQ equivalent.

Reference role: stp_zmq/zstack.py uses CurveCP (libsodium) to give every
inter-node link confidentiality + mutual authentication against a
directory of allowed public keys. This module provides the same property
over any byte stream with a SIGMA-I-style handshake built from the
primitives of crypto/pure_channel_crypto.py (X25519 ECDH, Ed25519 identity
signatures, HKDF-SHA256, ChaCha20-Poly1305 AEAD), pure-Python copies of
the `cryptography` (OpenSSL) ones the JAX package prefers:

  M1  I→R:  eph_i                                  (32B X25519 pub)
  M2  R→I:  eph_r || AEAD(kh_r, vk_r || sig_r(transcript))
  M3  I→R:  AEAD(kh_i, vk_i || sig_i(transcript))

where transcript = SHA256(M1 || eph_r), kh_* are handshake keys from
HKDF(DH(eph_i, eph_r)), and vk/sig are the party's static Ed25519 verkey
and its signature over the transcript (role-tagged). Signing-then-
encrypting hides identities from passive observers (SIGMA-I); binding
the static key to the ephemerals via signature gives mutual auth and
forward secrecy. Anonymous initiators (clients) send a zero verkey and
empty signature — accepted only by listeners configured to allow it
(client stack; request-level ed25519 signatures still authenticate every
write, reference plenum/server/client_authn.py).

Traffic protection: per-direction ChaCha20-Poly1305 keys with a 96-bit
counter nonce. Everything here is sans-IO: the stack moves the bytes.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# the pure-Python primitives only (crypto/pure_channel_crypto.py): the
# port needs no `cryptography`, and both ends speak the same bytes
from plenum_tpu_torch.crypto.pure_channel_crypto import (
    ChaCha20Poly1305, Ed25519PrivateKey, Ed25519PublicKey, HKDF,
    InvalidSignature, X25519PrivateKey, X25519PublicKey, hashes,
    serialization)

PROTO_MAGIC = b"PTX1"
ANON_VK = b"\x00" * 32

_RAW = serialization.Encoding.Raw
_RAW_PUB = serialization.PublicFormat.Raw
_RAW_PRIV = serialization.PrivateFormat.Raw
_NOENC = serialization.NoEncryption()


class HandshakeError(Exception):
    pass


def _pub_bytes(key) -> bytes:
    return key.public_key().public_bytes(_RAW, _RAW_PUB)


def _hkdf(secret: bytes, salt: bytes, info: bytes, n: int) -> bytes:
    return HKDF(algorithm=hashes.SHA256(), length=n, salt=salt,
                info=info).derive(secret)


class CipherState:
    """One direction of traffic: AEAD key + 96-bit counter nonce."""

    def __init__(self, key: bytes):
        self._aead = ChaCha20Poly1305(key)
        self._n = 0

    def _next_nonce(self) -> bytes:
        n = self._n
        self._n += 1
        return n.to_bytes(12, "big")

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        return self._aead.encrypt(self._next_nonce(), plaintext, aad)

    def decrypt(self, ciphertext: bytes, aad: bytes = b"") -> bytes:
        try:
            return self._aead.decrypt(self._next_nonce(), ciphertext, aad)
        except Exception as e:
            raise HandshakeError("decrypt failed: {}".format(e))


class Session:
    """Established channel: encrypt/decrypt application frames."""

    def __init__(self, send_key: bytes, recv_key: bytes,
                 peer_verkey: Optional[bytes]):
        self.tx = CipherState(send_key)
        self.rx = CipherState(recv_key)
        # peer's static ed25519 verkey (None = anonymous client)
        self.peer_verkey = peer_verkey if peer_verkey != ANON_VK else None

    def encrypt(self, data: bytes) -> bytes:
        return self.tx.encrypt(data)

    def decrypt(self, data: bytes) -> bytes:
        return self.rx.decrypt(data)


def _derive(dh: bytes, transcript: bytes):
    """→ (kh_i, kh_r, k_i2r, k_r2i): handshake + traffic keys."""
    okm = _hkdf(dh, transcript, b"ptx-keys", 32 * 4)
    return okm[0:32], okm[32:64], okm[64:96], okm[96:128]


class Initiator:
    """Client side of the handshake (the dialing party)."""

    def __init__(self, static_sk: Optional[Ed25519PrivateKey],
                 expected_peer_vk: Optional[bytes]):
        """static_sk None → anonymous. expected_peer_vk: the registry
        verkey the responder MUST prove (None = accept any, record it)."""
        self._static_sk = static_sk
        self._expected_vk = expected_peer_vk
        self._eph = X25519PrivateKey.generate()
        self._m1 = None
        self._keys = None
        self._transcript = None

    def message1(self) -> bytes:
        self._m1 = PROTO_MAGIC + _pub_bytes(self._eph)
        return self._m1

    def consume_message2(self, m2: bytes) -> bytes:
        """Verify the responder, → message3 bytes."""
        if len(m2) < 32:
            raise HandshakeError("short handshake message2")
        eph_r = m2[:32]
        ct = m2[32:]
        dh = self._eph.exchange(X25519PublicKey.from_public_bytes(eph_r))
        transcript = hashlib.sha256(self._m1 + eph_r).digest()
        kh_i, kh_r, k_i2r, k_r2i = _derive(dh, transcript)
        payload = CipherState(kh_r).decrypt(ct)
        vk_r, sig_r = payload[:32], payload[32:]
        try:
            Ed25519PublicKey.from_public_bytes(vk_r).verify(
                sig_r, b"resp" + transcript)
        except InvalidSignature:
            raise HandshakeError("responder signature invalid")
        if self._expected_vk is not None and vk_r != self._expected_vk:
            raise HandshakeError("responder key mismatch")
        self._keys = (k_i2r, k_r2i)
        self._transcript = transcript
        self.peer_verkey = vk_r
        if self._static_sk is None:
            payload3 = ANON_VK
        else:
            vk_i = _pub_bytes(self._static_sk)
            sig_i = self._static_sk.sign(b"init" + transcript)
            payload3 = vk_i + sig_i
        return CipherState(kh_i).encrypt(payload3)

    def session(self) -> Session:
        k_i2r, k_r2i = self._keys
        return Session(send_key=k_i2r, recv_key=k_r2i,
                       peer_verkey=self.peer_verkey)


class Responder:
    """Listener side of the handshake."""

    def __init__(self, static_sk: Ed25519PrivateKey,
                 allowed_vks=None, allow_anonymous: bool = False):
        """allowed_vks: callable(vk_bytes) -> bool, or a set of raw
        verkeys, or None = allow any authenticated peer."""
        self._static_sk = static_sk
        self._allowed = allowed_vks
        self._allow_anon = allow_anonymous
        self._eph = X25519PrivateKey.generate()
        self._kh_i = None
        self._keys = None
        self._transcript = None
        self.peer_verkey = None

    def consume_message1(self, m1: bytes) -> bytes:
        """→ message2 bytes."""
        if len(m1) != 36 or m1[:4] != PROTO_MAGIC:
            raise HandshakeError("bad handshake message1")
        eph_i = m1[4:]
        eph_r = _pub_bytes(self._eph)
        dh = self._eph.exchange(X25519PublicKey.from_public_bytes(eph_i))
        transcript = hashlib.sha256(m1 + eph_r).digest()
        kh_i, kh_r, k_i2r, k_r2i = _derive(dh, transcript)
        self._kh_i = kh_i
        self._keys = (k_i2r, k_r2i)
        self._transcript = transcript
        vk_r = _pub_bytes(self._static_sk)
        sig_r = self._static_sk.sign(b"resp" + transcript)
        return eph_r + CipherState(kh_r).encrypt(vk_r + sig_r)

    def consume_message3(self, m3: bytes) -> None:
        payload = CipherState(self._kh_i).decrypt(m3)
        vk_i = payload[:32]
        if vk_i == ANON_VK:
            if not self._allow_anon:
                raise HandshakeError("anonymous peers not allowed")
            self.peer_verkey = ANON_VK
            return
        sig_i = payload[32:]
        try:
            Ed25519PublicKey.from_public_bytes(vk_i).verify(
                sig_i, b"init" + self._transcript)
        except InvalidSignature:
            raise HandshakeError("initiator signature invalid")
        if self._allowed is not None:
            ok = (self._allowed(vk_i) if callable(self._allowed)
                  else vk_i in self._allowed)
            if not ok:
                raise HandshakeError("initiator key not in allow-list")
        self.peer_verkey = vk_i

    def session(self) -> Session:
        k_i2r, k_r2i = self._keys
        return Session(send_key=k_r2i, recv_key=k_i2r,
                       peer_verkey=self.peer_verkey)
