"""ctypes bridge to the native BLS12-381 module — drop-in for the hot
functions of plenum_tpu_torch.crypto.bls12_381 (the pure-Python module remains
the reference implementation and the fallback when no C compiler is
available). The port's own copy of the C source, `csrc/bls12_381.c`, is
built for the host by `ops/cuda_lib.load_host` at first use.

Same point representation at the Python boundary as bls12_381.py:
G1 = (x, y) int tuple / None; G2 = (Fq2, Fq2) / None. Conversion to the
C ABI (48-byte big-endian field elements) costs nanoseconds against
millisecond-scale curve operations.

Reference parity: crypto/bls/indy_crypto/bls_crypto_indy_crypto.py binds
Rust ursa for exactly these operations.
"""
from __future__ import annotations

import ctypes
import logging
import subprocess
from typing import List, Optional, Sequence, Tuple

from plenum_tpu_torch.crypto.bls12_381 import (
    Fq2, G1Point, G2Point, Q, R)

logger = logging.getLogger(__name__)

_lib = None
_build_error: Optional[Exception] = None


def _get_lib():
    global _lib
    if _lib is None:
        from plenum_tpu_torch.ops.cuda_lib import load_host
        lib = load_host("bls12_381")
        lib.b_g1_add.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
        lib.b_g1_mul.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
        lib.b_g2_add.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
        lib.b_g2_mul.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
        lib.b_multi_pairing_is_one.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        lib.b_multi_pairing_is_one.restype = ctypes.c_int
        lib.b_g1_decompress.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.b_g1_decompress.restype = ctypes.c_int
        lib.b_pairing.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
        lib.b_hash_to_g1.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p]
        lib.b_hash_to_g1.restype = ctypes.c_int
        lib.b_prep_size.restype = ctypes.c_int
        lib.b_miller_precompute.argtypes = [ctypes.c_char_p,
                                            ctypes.c_char_p]
        lib.b_miller_precompute.restype = ctypes.c_int
        lib.b_multi_pairing_is_one_prepared.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        lib.b_multi_pairing_is_one_prepared.restype = ctypes.c_int
        lib.b_g1_aggregate.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        lib.b_g1_aggregate.restype = ctypes.c_int
        lib.b_g1_aggregate_affine.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        _lib = lib
    return _lib


def available() -> bool:
    global _build_error
    try:
        _get_lib()
        return True
    except (OSError, AttributeError, ValueError,
            subprocess.SubprocessError) as e:
        # the compile/dlopen/symbol-binding failure surface, narrowed
        # (PT006): cc missing/failing (SubprocessError, FileNotFound),
        # bad .so (OSError), stale lib missing a symbol (AttributeError)
        if _build_error is None:
            logger.debug("native BLS backend unavailable: %s", e)
        _build_error = e
        return False


def build_error() -> Optional[Exception]:
    """Why available() last returned False (None if it never failed)."""
    return _build_error


# ------------------------------------------------------- conversions

def _g1_bytes(p: G1Point) -> bytes:
    if p is None:
        return b"\x00" * 96
    return p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")

def _g1_from(b: bytes) -> G1Point:
    if not any(b):
        return None
    return (int.from_bytes(b[:48], "big"), int.from_bytes(b[48:], "big"))

def _g2_bytes(p: G2Point) -> bytes:
    if p is None:
        return b"\x00" * 192
    x, y = p
    return (x.c0.to_bytes(48, "big") + x.c1.to_bytes(48, "big")
            + y.c0.to_bytes(48, "big") + y.c1.to_bytes(48, "big"))

def _g2_from(b: bytes) -> G2Point:
    if not any(b):
        return None
    return (Fq2(int.from_bytes(b[:48], "big"),
                int.from_bytes(b[48:96], "big")),
            Fq2(int.from_bytes(b[96:144], "big"),
                int.from_bytes(b[144:], "big")))


# --------------------------------------------------------------- ops

def g1_add(p: G1Point, q: G1Point) -> G1Point:
    out = ctypes.create_string_buffer(96)
    _get_lib().b_g1_add(_g1_bytes(p), _g1_bytes(q), out)
    return _g1_from(out.raw)


def g1_mul(p: G1Point, k: int) -> G1Point:
    out = ctypes.create_string_buffer(96)
    _get_lib().b_g1_mul(_g1_bytes(p), (k % R).to_bytes(32, "big"),
                        out)
    return _g1_from(out.raw)


def g2_add(p: G2Point, q: G2Point) -> G2Point:
    out = ctypes.create_string_buffer(192)
    _get_lib().b_g2_add(_g2_bytes(p), _g2_bytes(q), out)
    return _g2_from(out.raw)


def g2_mul(p: G2Point, k: int) -> G2Point:
    out = ctypes.create_string_buffer(192)
    _get_lib().b_g2_mul(_g2_bytes(p), (k % R).to_bytes(32, "big"),
                        out)
    return _g2_from(out.raw)


def g1_aggregate_compressed(sigs: Sequence[bytes]) -> G1Point:
    """Sum of n compressed signatures in ONE call: per-share decompress
    + Jacobian mixed add, a single field inversion at the end (vs one
    inversion per share through repeated g1_add). Raises ValueError on
    any undecodable share, mirroring g1_decompress."""
    n = len(sigs)
    out = ctypes.create_string_buffer(96)
    rc = _get_lib().b_g1_aggregate(n, b"".join(sigs), out)
    if rc != 0:
        raise ValueError("invalid G1 signature in aggregate")
    return _g1_from(out.raw)


def g1_aggregate_points(points: Sequence[G1Point]) -> G1Point:
    """Sum of already-decompressed affine points in ONE call (Jacobian
    accumulation + single inversion). The ordering path uses this with
    the verifier's share-point cache: decompression was paid once at
    COMMIT validation."""
    out = ctypes.create_string_buffer(96)
    _get_lib().b_g1_aggregate_affine(
        len(points), b"".join(_g1_bytes(p) for p in points), out)
    return _g1_from(out.raw)


def multi_pairing_is_one(pairs: Sequence[Tuple[G1Point, G2Point]]) -> bool:
    n = len(pairs)
    g1s = b"".join(_g1_bytes(p) for p, _ in pairs)
    g2s = b"".join(_g2_bytes(q) for _, q in pairs)
    return bool(_get_lib().b_multi_pairing_is_one(n, g1s, g2s))


def hash_to_g1(msg: bytes, dst: bytes = b"PLENUM_TPU_BLS_G1") -> G1Point:
    """Full-native try-and-increment hash-to-curve — bit-identical to
    bls12_381.hash_to_g1 (cross-checked in tests)."""
    out = ctypes.create_string_buffer(96)
    rc = _get_lib().b_hash_to_g1(bytes(msg), len(msg), bytes(dst),
                                 len(dst), out)
    if rc != 0:
        raise ValueError("hash_to_g1 failed")
    return _g1_from(out.raw)


def miller_precompute(q: G2Point) -> bytes:
    """Per-step Miller line coefficients for a FIXED G2 argument —
    opaque blob consumed by multi_pairing_is_one_prepared. A validator
    pairs against the same G2 points on every verify (the generator and
    the pool's aggregated key), so the Q-only half of the Miller loop
    is hoisted out of the per-verify path."""
    lib = _get_lib()
    out = ctypes.create_string_buffer(lib.b_prep_size())
    rc = lib.b_miller_precompute(_g2_bytes(q), out)
    if rc != 0:
        raise ValueError("cannot precompute lines for this G2 point")
    return out.raw


def multi_pairing_is_one_prepared(
        pairs: Sequence[Tuple[G1Point, bytes]]) -> bool:
    """Πᵢ e(Pᵢ, Qᵢ) == 1 with every Qᵢ given as a miller_precompute
    blob. ONE shared fp12 squaring chain for all pairs."""
    n = len(pairs)
    if not 1 <= n <= 8:
        # the C fast path sizes its stack for the verification shapes
        # (2 pairs); outside it, callers must use the plain path
        raise ValueError("prepared multi-pairing supports 1..8 pairs")
    g1s = b"".join(_g1_bytes(p) for p, _ in pairs)
    preps = b"".join(prep for _, prep in pairs)
    return bool(_get_lib().b_multi_pairing_is_one_prepared(n, g1s, preps))


def g1_decompress(data: bytes) -> G1Point:
    if len(data) != 48:
        raise ValueError("bad G1 length")
    out = ctypes.create_string_buffer(96)
    rc = _get_lib().b_g1_decompress(bytes(data), out)
    if rc < 0:
        raise ValueError("invalid compressed G1 point")
    if rc == 1:
        return None
    return _g1_from(out.raw)


def pairing_bytes(p: G1Point, q: G2Point) -> bytes:
    """Final-exponentiated pairing (cube-power convention) — testing."""
    out = ctypes.create_string_buffer(576)
    _get_lib().b_pairing(_g1_bytes(p), _g2_bytes(q), out)
    return out.raw
