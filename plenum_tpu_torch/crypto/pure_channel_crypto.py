"""Pure-Python stand-ins for the `cryptography` primitives the
transport layer uses — X25519 (RFC 7748), ChaCha20-Poly1305 (RFC 8439),
HKDF-SHA256 (RFC 5869) and object-style Ed25519 keys over the existing
RFC 8032 implementation in crypto/ed25519.py.

The JAX package prefers `cryptography` (OpenSSL) and falls back here;
the port uses only these, since the card's machine has no `cryptography`.
The wire behaviour is identical, so a port stack talks to a JAX stack.
The API mirrors exactly the slice of `cryptography.hazmat` that
network/crypto_channel.py, network/keys.py and network/stack.py consume.
Scalar Python speed is acceptable for the handshake, and bulk
client-signature verification has its own batched device path
(crypto/batch_verifier). The traffic cipher is not: every frame on the
wire passes through ChaCha20, so its keystream runs in C (csrc/chacha20.c,
built by ops/cuda_lib.load_host at first use) and falls back to the
Python loop below, its reference, when no C compiler is available."""
from __future__ import annotations

import ctypes
import hashlib
import hmac as _hmac
import os
from typing import Callable, Optional

from plenum_tpu_torch.crypto import ed25519 as _ed

_P = 2 ** 255 - 19


class InvalidSignature(Exception):
    pass


# --------------------------------------------------------- Ed25519 objects


class _RawEncoding:
    Raw = "raw"


class _RawFormat:
    Raw = "raw"


class serialization:                          # namespace mirror
    Encoding = _RawEncoding
    PublicFormat = _RawFormat
    PrivateFormat = _RawFormat

    class NoEncryption:
        pass


class _SHA256:
    name = "sha256"
    digest_size = 32


class hashes:                                 # namespace mirror
    SHA256 = _SHA256


class Ed25519PublicKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("ed25519 public key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
        return cls(raw)

    def public_bytes(self, encoding=None, fmt=None) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        if not _ed.verify(bytes(data), bytes(signature), self._raw):
            raise InvalidSignature("ed25519 signature invalid")


class Ed25519PrivateKey:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("ed25519 private key must be 32 bytes")
        self._seed = bytes(seed)
        self._pub = _ed.publickey_from_seed(self._seed)

    @classmethod
    def from_private_bytes(cls, seed: bytes) -> "Ed25519PrivateKey":
        return cls(seed)

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(os.urandom(32))

    def sign(self, data: bytes) -> bytes:
        return _ed.sign(bytes(data), self._seed)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pub)

    def private_bytes(self, encoding=None, fmt=None,
                      encryption_algorithm=None) -> bytes:
        return self._seed


# ------------------------------------------------------------ X25519


def _x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 scalar multiplication on Curve25519."""
    kb = bytearray(k)
    kb[0] &= 248
    kb[31] &= 127
    kb[31] |= 64
    k_int = int.from_bytes(bytes(kb), "little")
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    a24 = 121665
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k_int >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + a24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


class X25519PublicKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("x25519 public key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        return cls(raw)

    def public_bytes(self, encoding=None, fmt=None) -> bytes:
        return self._raw


class X25519PrivateKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, raw: bytes) -> "X25519PrivateKey":
        return cls(raw)

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(_x25519(self._raw, _X25519_BASE))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        shared = _x25519(self._raw, peer.public_bytes())
        if shared == b"\x00" * 32:
            raise ValueError("x25519 all-zero shared secret")
        return shared


# -------------------------------------------------------------- HKDF


def hkdf_sha256(secret: bytes, salt: bytes, info: bytes, n: int) -> bytes:
    """RFC 5869 extract-and-expand with HMAC-SHA256."""
    prk = _hmac.new(salt or b"\x00" * 32, secret, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < n:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:n]


class HKDF:
    """Object-style mirror of cryptography's HKDF (SHA256 only)."""

    def __init__(self, algorithm=None, length: int = 32,
                 salt: Optional[bytes] = None, info: bytes = b""):
        self._length = length
        self._salt = salt or b""
        self._info = info or b""

    def derive(self, secret: bytes) -> bytes:
        return hkdf_sha256(secret, self._salt, self._info, self._length)


# -------------------------------------------- ChaCha20-Poly1305 (RFC 8439)


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
             *key_words, counter & 0xFFFFFFFF, *nonce_words]
    x = list(state)
    for _ in range(10):
        for a, b, c, d in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                           (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                           (2, 7, 8, 13), (3, 4, 9, 14)):
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & 0xFFFFFFFF
            x[b] = _rotl32(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & 0xFFFFFFFF
            x[b] = _rotl32(x[b] ^ x[c], 7)
    out = bytearray()
    for i in range(16):
        out += ((x[i] + state[i]) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def _chacha20_xor(key: bytes, counter: int, nonce: bytes,
                  data: bytes) -> bytes:
    key_words = [int.from_bytes(key[i:i + 4], "little")
                 for i in range(0, 32, 4)]
    nonce_words = [int.from_bytes(nonce[i:i + 4], "little")
                   for i in range(0, 12, 4)]
    out = bytearray(len(data))
    for block_i in range((len(data) + 63) // 64):
        ks = _chacha20_block(key_words, counter + block_i, nonce_words)
        lo = block_i * 64
        chunk = data[lo:lo + 64]
        out[lo:lo + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


def _load_native_xor() -> Optional[Callable[[bytes, int, bytes, bytes],
                                             bytes]]:
    """csrc/chacha20.c's chacha20_xor behind _chacha20_xor's signature, or
    None when it does not build or load."""
    from plenum_tpu_torch.ops.cuda_lib import try_load_host
    lib = try_load_host("chacha20")
    if lib is None:
        return None
    fn = lib.chacha20_xor
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
                   ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    fn.restype = None

    def native_xor(key: bytes, counter: int, nonce: bytes,
                   data: bytes) -> bytes:
        if len(key) != 32 or len(nonce) != 12:
            raise ValueError("chacha20 takes a 32-byte key and a 12-byte "
                             "nonce")
        data = bytes(data)
        out = ctypes.create_string_buffer(len(data))
        fn(key, counter & 0xFFFFFFFF, nonce, data, out, len(data))
        return out.raw

    return native_xor


_xor_impl: Optional[Callable[[bytes, int, bytes, bytes], bytes]] = None


def chacha20_xor(key: bytes, counter: int, nonce: bytes,
                 data: bytes) -> bytes:
    """`data` XOR the ChaCha20 keystream of (key, nonce) from block
    `counter` on: the C keystream once it is built, else the Python loop
    (_chacha20_xor)."""
    global _xor_impl
    if _xor_impl is None:
        _xor_impl = _load_native_xor() or _chacha20_xor
    return _xor_impl(key, counter, nonce, data)


def _poly1305(msg: bytes, key: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        n = int.from_bytes(msg[i:i + 16] + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"\x00" * (16 - rem) if rem else b""


class ChaCha20Poly1305:
    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("chacha20poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = chacha20_xor(self._key, 0, nonce, bytes(32))
        mac_data = (aad + _pad16(aad) + ct + _pad16(ct)
                    + len(aad).to_bytes(8, "little")
                    + len(ct).to_bytes(8, "little"))
        return _poly1305(mac_data, otk)

    def encrypt(self, nonce: bytes, plaintext: bytes,
                aad: Optional[bytes]) -> bytes:
        aad = aad or b""
        ct = chacha20_xor(self._key, 1, nonce, plaintext)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, ciphertext: bytes,
                aad: Optional[bytes]) -> bytes:
        aad = aad or b""
        if len(ciphertext) < 16:
            raise ValueError("ciphertext too short")
        ct, tag = ciphertext[:-16], ciphertext[-16:]
        if not _hmac.compare_digest(tag, self._tag(nonce, ct, aad)):
            raise ValueError("poly1305 tag mismatch")
        return chacha20_xor(self._key, 1, nonce, ct)
