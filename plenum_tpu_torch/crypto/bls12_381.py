"""BLS12-381 pairing-friendly curve — scalar Python implementation.

The reference delegates BLS multi-signatures to Hyperledger Ursa (Rust,
`crypto/bls/indy_crypto/bls_crypto_indy_crypto.py`, SURVEY.md §2.9). This
module is a from-scratch implementation of the curve arithmetic and the
optimal ate pairing, used by plenum_tpu_torch.crypto.bls for state-proof
multi-signatures. It is the correctness/scalar path. The hot paths live
elsewhere: csrc/bls12_381.c (pairings, scalar mults, batch
aggregation), built for the host by crypto/bls_native.py; pairings stay on
the host — there are only 2 per verify regardless of signer count.

Scheme layout: signatures in G1 (48 B compressed), public keys in G2
(96 B compressed) — minimal-signature-size variant.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# ------------------------------------------------------------ parameters

# Field modulus
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative: x = -0xd201000000010000)
X_ABS = 0xD201000000010000

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)


# ------------------------------------------------------------ Fq towers

def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


class Fq2:
    """Fq[u] / (u^2 + 1)."""
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        ac, bd = a * c, b * d
        return Fq2(ac - bd, (a + b) * (c + d) - ac - bd)

    __rmul__ = __mul__

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def sq(self):
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def inv(self):
        norm = _inv(self.c0 * self.c0 + self.c1 * self.c1, Q)
        return Fq2(self.c0 * norm, -self.c1 * norm)

    def conj(self):
        return Fq2(self.c0, -self.c1)

    def mul_by_nonresidue(self):
        # ξ = 1 + u
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def sqrt(self) -> Optional["Fq2"]:
        """Square root in Fq2 (q ≡ 3 mod 4 variant algorithm)."""
        if self.is_zero():
            return Fq2(0, 0)
        a1 = self ** ((Q - 3) // 4)
        alpha = a1.sq() * self
        x0 = a1 * self
        if alpha == Fq2(Q - 1, 0):
            return Fq2(-x0.c1, x0.c0)
        b = (alpha + Fq2(1, 0)) ** ((Q - 1) // 2)
        cand = b * x0
        if cand.sq() == self:
            return cand
        return None

    def __pow__(self, e: int):
        result = Fq2(1, 0)
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.sq()
            e >>= 1
        return result

    def __repr__(self):
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"


FQ2_ONE = Fq2(1, 0)
FQ2_ZERO = Fq2(0, 0)


class Fq6:
    """Fq2[v] / (v^3 - ξ), ξ = 1+u."""
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def sq(self):
        return self * self

    def mul_by_nonresidue(self):
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sq() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.sq().mul_by_nonresidue() - a0 * a1
        t2 = a1.sq() - a0 * a2
        denom = (a0 * t0 + (a2 * t1 + a1 * t2).mul_by_nonresidue()).inv()
        return Fq6(t0 * denom, t1 * denom, t2 * denom)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)


class Fq12:
    """Fq6[w] / (w^2 - v)."""
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0, t1 = a0 * b0, a1 * b1
        return Fq12(t0 + t1.mul_by_nonresidue(),
                    (a0 + a1) * (b0 + b1) - t0 - t1)

    def sq(self):
        return self * self

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def inv(self):
        t = (self.c0.sq() - self.c1.sq().mul_by_nonresidue()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def conj(self):
        """x → x^(q^6) (Fq6 coefficients are fixed by Frobenius^6)."""
        return Fq12(self.c0, -self.c1)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        result = FQ12_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.sq()
            e >>= 1
        return result


FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)
FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)


def _fq12_from_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def _fq12_from_int(n: int) -> Fq12:
    return _fq12_from_fq2(Fq2(n, 0))


# ------------------------------------------------------------ groups

# Affine points as tuples (x, y) with None = infinity.
G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Fq2, Fq2]]


def g1_add(p: G1Point, q: G1Point) -> G1Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1, Q) % Q
    else:
        lam = (y2 - y1) * _inv(x2 - x1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def g1_neg(p: G1Point) -> G1Point:
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_mul(p: G1Point, k: int) -> G1Point:
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


def g2_add(p: G2Point, q: G2Point) -> G2Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1.sq() * 3) * (y1 * 2).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.sq() - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def g2_neg(p: G2Point) -> G2Point:
    return None if p is None else (p[0], -p[1])


def g2_mul(p: G2Point, k: int) -> G2Point:
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


G1_GEN: G1Point = (G1_X, G1_Y)
G2_GEN: G2Point = (Fq2(*G2_X), Fq2(*G2_Y))


def g1_is_on_curve(p: G1Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 4) % Q == 0


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    # y^2 = x^3 + 4(1+u)
    return y.sq() == x.sq() * x + Fq2(4, 4)


def g1_in_subgroup(p: G1Point, g1_mul_fn=None) -> bool:
    """On-curve + r-torsion. g1_mul reduces scalars mod r, so mul-by-r
    cannot be used directly (it would be vacuously None); instead check
    (r−1)·p == −p ⇔ r·p = O ⇔ ord(p) | r (r prime).

    g1_mul_fn lets a faster backend (bls_ops) supply the scalar mult
    while keeping this single implementation of the security check."""
    if p is None:
        return True
    mul = g1_mul_fn or g1_mul
    return g1_is_on_curve(p) and mul(p, R - 1) == g1_neg(p)


def g2_in_subgroup(p: G2Point, g2_mul_fn=None) -> bool:
    if p is None:
        return True
    mul = g2_mul_fn or g2_mul
    return g2_is_on_curve(p) and mul(p, R - 1) == g2_neg(p)


# ------------------------------------------------------------ pairing

# w and the untwisting constants: BLS12-381 uses the M-twist
# E': y² = x³ + 4ξ (ξ = 1+u), with Ψ(x', y') = (x'/w², y'/w³) ∈ E(Fq12).
_W = Fq12(FQ6_ZERO, FQ6_ONE)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


def _untwist(q: G2Point) -> Tuple[Fq12, Fq12]:
    x, y = q
    return (_fq12_from_fq2(x) * _W2_INV, _fq12_from_fq2(y) * _W3_INV)


def miller_loop(p: G1Point, q: G2Point) -> Fq12:
    """Generic affine Miller loop over E(Fq12) — correctness-first: the
    twist point is untwisted once and all slopes/lines live in Fq12."""
    if p is None or q is None:
        return FQ12_ONE
    xa = _fq12_from_int(p[0])
    ya = _fq12_from_int(p[1])
    qx, qy = _untwist(q)
    tx, ty = qx, qy
    f = FQ12_ONE
    bits = bin(X_ABS)[2:]
    for b in bits[1:]:
        # doubling step: tangent at T, evaluated at P
        lam = (tx.sq() * _fq12_from_int(3)) * (ty * _fq12_from_int(2)).inv()
        line = (ya - ty) - lam * (xa - tx)
        f = f.sq() * line
        x3 = lam.sq() - tx - tx
        ty = lam * (tx - x3) - ty
        tx = x3
        if b == "1":
            # addition step: chord through T and Q, evaluated at P
            lam = (ty - qy) * (tx - qx).inv()
            line = (ya - ty) - lam * (xa - tx)
            f = f * line
            x3 = lam.sq() - tx - qx
            ty = lam * (tx - x3) - ty
            tx = x3
    # the BLS parameter x is negative: conjugate the result
    return f.conj()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12-1)/r) by plain square-and-multiply (correctness-first;
    there are only 2 pairings per multi-sig verify regardless of n)."""
    return f ** ((Q ** 12 - 1) // R)


def pairing(p: G1Point, q: G2Point) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: Sequence[Tuple[G1Point, G2Point]]) -> Fq12:
    """∏ e(p_i, q_i) with one shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


# ------------------------------------------------------------ serialization
# ZCash-style compressed encodings: 48 B (G1) / 96 B (G2), flag bits in
# the top three bits of the first byte.

def g1_compress(p: G1Point) -> bytes:
    if p is None:
        return bytes([0xC0] + [0] * 47)
    x, y = p
    flag = 0x80 | (0x20 if y > (Q - 1) // 2 else 0)
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flag
    return bytes(b)


def g1_decompress(data: bytes) -> G1Point:
    if len(data) != 48:
        raise ValueError("bad G1 length")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed unsupported")
    if flags & 0x40:
        if any(data[1:]) or data[0] != 0xC0:
            raise ValueError("bad infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= Q:
        raise ValueError("x out of range")
    yy = (x * x * x + 4) % Q
    y = pow(yy, (Q + 1) // 4, Q)
    if y * y % Q != yy:
        raise ValueError("not on curve")
    big = y > (Q - 1) // 2
    if bool(flags & 0x20) != big:
        y = Q - y
    return (x, y)


def g2_compress(p: G2Point) -> bytes:
    if p is None:
        return bytes([0xC0] + [0] * 95)
    x, y = p
    # sign bit: y lexicographically greater than −y, comparing (c1, c0)
    big = (y.c1, y.c0) > ((Q - y.c1) % Q, (Q - y.c0) % Q)
    flag = 0x80 | (0x20 if big else 0)
    b = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    b[0] |= flag
    return bytes(b)


def g2_decompress(data: bytes) -> G2Point:
    if len(data) != 96:
        raise ValueError("bad G2 length")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed unsupported")
    if flags & 0x40:
        if any(data[1:]) or data[0] != 0xC0:
            raise ValueError("bad infinity encoding")
        return None
    c1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    c0 = int.from_bytes(data[48:96], "big")
    if c0 >= Q or c1 >= Q:
        raise ValueError("x out of range")
    x = Fq2(c0, c1)
    yy = x.sq() * x + Fq2(4, 4)
    y = yy.sqrt()
    if y is None:
        raise ValueError("not on curve")
    big = (y.c1, y.c0) > ((Q - y.c1) % Q, (Q - y.c0) % Q)
    if bool(flags & 0x20) != big:
        y = -y
    return (x, y)


def hash_to_g1(msg: bytes, dst: bytes = b"PLENUM_TPU_BLS_G1",
               g1_mul_fn=None) -> G1Point:
    """Deterministic hash-to-curve by try-and-increment over SHA-256.

    Not the IRTF SSWU suite — this framework defines its own wire format
    (no Ursa compatibility requirement); try-and-increment is simple,
    deterministic, and its variable-time nature leaks nothing secret
    (inputs are public consensus data).

    ``g1_mul_fn`` lets the backend dispatch (bls_ops) run the cofactor
    clearing on the native path — ONE construction, consensus-critical:
    every node must hash to the identical point.
    """
    import hashlib as _h
    mul = g1_mul_fn or g1_mul
    ctr = 0
    while True:
        d = _h.sha256(dst + ctr.to_bytes(4, "big") + msg).digest()
        x = int.from_bytes(d + _h.sha256(b"\x01" + d).digest()[:16], "big") % Q
        yy = (x * x * x + 4) % Q
        y = pow(yy, (Q + 1) // 4, Q)
        if y * y % Q == yy:
            # clear cofactor to land in the r-torsion subgroup
            h = ((1 - (-X_ABS)) ** 2) // 3  # G1 cofactor (x-1)^2/3
            p = mul((x, min(y, Q - y)), h)
            if p is not None:
                return p
        ctr += 1
