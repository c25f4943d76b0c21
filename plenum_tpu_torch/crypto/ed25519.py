"""Pure-Python ed25519 (RFC 8032) — the scalar floor of the verify path.

The reference binds libsodium via libnacl (`stp_core/crypto/nacl_wrappers.py`,
SURVEY.md §2.9). Here the scalar implementation is self-contained Python
(used for signing, key generation, and single-signature verification);
bulk verification runs on the CUDA kernel behind
plenum_tpu_torch.ops.ed25519, which this module cross-checks.

Implementation is textbook RFC 8032 over extended twisted-Edwards
coordinates; speed is secondary here (the hot path is the device batch).
"""
from __future__ import annotations

import hashlib
from typing import Tuple

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Base point
G_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int:
    """x from y via sqrt((y^2-1)/(d y^2+1)); raises ValueError if none."""
    if y >= P:
        raise ValueError("non-canonical y")
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate root of u/v: u * v^3 * (u * v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        raise ValueError("not a square")
    if x == 0 and sign == 1:
        raise ValueError("invalid sign for x=0")
    if x & 1 != sign:
        x = P - x
    return x


G_X = _recover_x(G_Y, 0)

# Extended coordinates (X, Y, Z, T), T = X*Y/Z
_IDENT = (0, 1, 1, 0)
_G_EXT = (G_X, G_Y, 1, G_X * G_Y % P)


def _pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * 2 * D * t2 % P
    d = z1 * 2 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_double(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = (b - a) % P
    f = (g - c) % P
    h = (-a - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_mul(s: int, p):
    q = _IDENT
    while s > 0:
        if s & 1:
            q = _pt_add(q, p)
        p = _pt_double(p)
        s >>= 1
    return q


def _pt_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _pt_decompress(data: bytes):
    if len(data) != 32:
        raise ValueError("bad point length")
    n = int.from_bytes(data, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    return (x, y, 1, x * y % P)


def _pt_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def publickey_from_seed(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return _pt_compress(_pt_mul(a, _G_EXT))


def keypair_from_seed(seed: bytes) -> Tuple[bytes, bytes]:
    """seed (32B) → (verkey 32B, secret = seed||verkey 64B)."""
    vk = publickey_from_seed(seed)
    return vk, seed + vk


def sign(msg: bytes, seed: bytes) -> bytes:
    """Detached 64-byte signature with secret seed (32 bytes)."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    vk = _pt_compress(_pt_mul(a, _G_EXT))
    r = _sha512_int(prefix, msg) % L
    R = _pt_compress(_pt_mul(r, _G_EXT))
    k = _sha512_int(R, vk, msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(msg: bytes, sig: bytes, verkey: bytes) -> bool:
    """Cofactorless verification: [S]B == R + [k]A."""
    if len(sig) != 64 or len(verkey) != 32:
        return False
    try:
        A = _pt_decompress(verkey)
        R = _pt_decompress(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(sig[:32], verkey, msg) % L
    return _pt_equal(_pt_mul(s, _G_EXT), _pt_add(R, _pt_mul(k, A)))
