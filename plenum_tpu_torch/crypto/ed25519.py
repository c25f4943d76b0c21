"""Pure-Python ed25519 (RFC 8032) — the scalar floor of the verify path.

The reference binds libsodium via libnacl (`stp_core/crypto/nacl_wrappers.py`,
SURVEY.md §2.9). Here the scalar implementation is self-contained Python
(used for signing, key generation, and single-signature verification);
bulk verification runs on the CUDA kernel behind
plenum_tpu_torch.ops.ed25519, which this module cross-checks.

Implementation is textbook RFC 8032 over extended twisted-Edwards
coordinates. Signing and key generation are rare, so their speed is
secondary. One verification is not: a node verifies every request its
peers relay before its own client's copy arrives, one at a time on its
prod loop (server/node.py's propagate gate), so `verify` runs the curve
arithmetic in C (csrc/ed25519_host.c, built by ops/cuda_lib.load_host at
first use) and falls back to the Python below, its reference, when no C
compiler is available.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import Callable, Optional, Tuple

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


def _load_native_check() -> Optional[Callable[[bytes, bytes, bytes, bytes],
                                              int]]:
    """csrc/ed25519_host.c's check of [S]B == R + [k]A on the encodings of
    A and R and the scalars S and k, or None when it does not build or
    load."""
    from plenum_tpu_torch.ops.cuda_lib import try_load_host
    lib = try_load_host("ed25519_host")
    if lib is None:
        return None
    fn = lib.ed25519_verify_host
    fn.argtypes = [ctypes.c_char_p] * 4
    fn.restype = ctypes.c_int
    return fn


_check_impl: Optional[Callable[[bytes, bytes, bytes, bytes], int]] = None


def _check_python(a: bytes, r: bytes, s: bytes, k: bytes) -> bool:
    try:
        A = _pt_decompress(a)
        R = _pt_decompress(r)
    except ValueError:
        return False
    return _pt_equal(_pt_mul(int.from_bytes(s, "little"), _G_EXT),
                     _pt_add(R, _pt_mul(int.from_bytes(k, "little"), A)))


def _verify_with(check, msg: bytes, sig: bytes, verkey: bytes) -> bool:
    if len(sig) != 64 or len(verkey) != 32:
        return False
    if int.from_bytes(sig[32:], "little") >= L:
        return False
    k = (_sha512_int(sig[:32], verkey, msg) % L).to_bytes(32, "little")
    return bool(check(bytes(verkey), bytes(sig[:32]), bytes(sig[32:]), k))


def verify(msg: bytes, sig: bytes, verkey: bytes) -> bool:
    """Cofactorless verification: [S]B == R + [k]A, the points checked in
    C once it is built, else in Python (_check_python)."""
    global _check_impl
    if _check_impl is None:
        _check_impl = _load_native_check() or _check_python
    return _verify_with(_check_impl, msg, sig, verkey)


def verify_python(msg: bytes, sig: bytes, verkey: bytes) -> bool:
    """`verify` with the points checked in Python: the reference that
    csrc/ed25519_host.c is held against."""
    return _verify_with(_check_python, msg, sig, verkey)
