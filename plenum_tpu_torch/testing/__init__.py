"""Seeded inputs for the port's tests and chip_smoke.py.

`adversarial_signatures` mixes valid ed25519 signatures with every way
the verifier must reject one (or, for small-order keys, the way a
cofactorless verifier accepts one); `nym_requests` builds signed NYM
writes in the shape bench.py's make_requests sends, some of them
tampered; `nym_txn_blobs` the serialized NYM txns of a ledger's history;
`aggregate_jobs` the BLS aggregates' adversarial job sets (with
`off_curve_g1`, `off_curve_g2` and `g2_sign_points`). Everything is
derived from the seed.
"""
import hashlib
import random
from typing import List, Set, Tuple

from plenum_tpu_torch.common.constants import NYM, TARGET_NYM, VERKEY
from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.serialization import (
    ledger_txn_serializer)
from plenum_tpu_torch.crypto import ed25519

P, L = ed25519.P, ed25519.L

KINDS = ("valid", "tampered_msg", "flip_r", "flip_s", "s_ge_l",
         "a_y_ge_p", "r_y_ge_p", "a_undecodable", "r_undecodable",
         "a_small_order", "r_small_order", "a_x0_sign1", "short_sig")


def _encode(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def torsion_points() -> List[bytes]:
    """Encodings of the eight points of order dividing 8 (identity
    first): [L]Q lies in the torsion subgroup for any curve point Q."""
    y = 2
    while True:
        try:
            q = ed25519._pt_decompress(_encode(y))
        except ValueError:
            y += 1
            continue
        t = ed25519._pt_mul(L, q)
        if not ed25519._pt_equal(ed25519._pt_mul(4, t), ed25519._IDENT):
            return [ed25519._pt_compress(ed25519._pt_mul(i, t))
                    for i in range(8)]
        y += 1


def undecodable_y() -> int:
    """The smallest y < p for which no x is on the curve."""
    y = 2
    while True:
        try:
            ed25519._recover_x(y, 0)
        except ValueError:
            return y
        y += 1


def adversarial_signatures(n: int, seed: int, unique: int = 64
                           ) -> Tuple[List[bytes], List[bytes], List[bytes],
                                      List[str]]:
    """n (msg, sig, verkey) rows, row i of kind KINDS[i % len(KINDS)].

    Only `unique` signatures are made with the (slow, pure-Python)
    signer; every row derives from one of them, and most kinds alter
    the message or the signature per row, so rows rarely repeat."""
    rng = random.Random(seed)
    base = []
    for _ in range(max(1, min(unique, n))):
        sk = rng.randbytes(32)
        msg = rng.randbytes(rng.randrange(8, 160))
        base.append((msg, ed25519.sign(msg, sk),
                     ed25519.publickey_from_seed(sk)))
    torsion = torsion_points()
    bad_y = undecodable_y()
    msgs, sigs, vks, kinds = [], [], [], []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        msg, sig, vk = base[i % len(base)]
        r, s = sig[:32], sig[32:]
        if kind == "tampered_msg":
            msg = msg + i.to_bytes(4, "little")
        elif kind == "flip_r":
            b = i % 255
            r = (int.from_bytes(r, "little") ^ (1 << b)).to_bytes(32, "little")
        elif kind == "flip_s":
            b = i % 252
            s = (int.from_bytes(s, "little") ^ (1 << b)).to_bytes(32, "little")
        elif kind == "s_ge_l":
            s = (int.from_bytes(s, "little") + L).to_bytes(32, "little")
        elif kind == "a_y_ge_p":
            vk = _encode(P + i % 19, i & 1)
        elif kind == "r_y_ge_p":
            r = _encode(P + i % 19, i & 1)
        elif kind == "a_undecodable":
            vk = _encode(bad_y, i & 1)
        elif kind == "r_undecodable":
            r = _encode(bad_y, i & 1)
        elif kind == "a_small_order":
            # s = 0: [0]B + [k](-A) is a torsion point, so the verdict is
            # true exactly when it lands on R (always for A = R = identity)
            j = (i // len(KINDS)) % 8
            vk = torsion[j]
            r = torsion[0] if j % 2 == 0 else torsion[j]
            s = bytes(32)
        elif kind == "r_small_order":
            r = torsion[i % 8]
        elif kind == "a_x0_sign1":
            vk = _encode(1, 1)      # y = 1 forces x = 0: sign 1 is invalid
        elif kind == "short_sig":
            s = s[:31]
        msgs.append(msg)
        sigs.append(r + s)
        vks.append(vk)
        kinds.append(kind)
    return msgs, sigs, vks, kinds


def nym_requests(n: int, signer, seed: int, n_bad: int = 0
                 ) -> Tuple[List[dict], Set[int]]:
    """n NYM-creation writes by `signer` (bench.py make_requests' shape)
    and the indices of the `n_bad` among them whose signature no longer
    matches: every other one has its signature bit-flipped, the rest
    their operation changed after signing."""
    rng = random.Random(seed)
    bad = set(rng.sample(range(n), n_bad))
    reqs = []
    for i in range(n):
        dest = b58encode(i.to_bytes(16, "big").rjust(16, b"\x01"))
        req = {"identifier": signer.identifier,
               "reqId": i + 1,
               "protocolVersion": 2,
               "operation": {"type": NYM, TARGET_NYM: dest,
                             VERKEY: "~" + dest}}
        req["signature"] = signer.sign(dict(req))
        if i in bad:
            if len(reqs) % 2:
                raw = bytearray(b58decode(req["signature"]))
                raw[rng.randrange(64)] ^= 1 << rng.randrange(8)
                req["signature"] = b58encode(bytes(raw))
            else:
                req["operation"] = dict(req["operation"],
                                        **{VERKEY: "~" + b58encode(
                                            rng.randbytes(16))})
        reqs.append(req)
    return reqs, bad


def nym_txn_blobs(n: int, seed: int, txn_time: int = 1700000000
                  ) -> List[bytes]:
    """The serialized committed txns seqNo 1..n of a domain ledger of NYM
    writes, as Ledger stores them: reqToTxn's envelope of a signed NYM
    request plus txnMetadata. Digests and signature values are seeded
    stand-ins (committed history is not re-verified; the signatures come
    from a pool of 256), so n = 2^20 takes a minute, not the hours that
    signing would."""
    rng = random.Random(seed)
    author = b58encode(rng.randbytes(32))
    sig_pool = [b58encode(rng.randbytes(64)) for _ in range(256)]
    serialize = ledger_txn_serializer.serialize
    blobs = []
    for i in range(n):
        dest = b58encode(i.to_bytes(16, "big").rjust(16, b"\x01"))
        digest = hashlib.sha256(b"%d:%d" % (seed, i)).hexdigest()
        blobs.append(serialize({
            "txn": {"type": NYM,
                    "data": {TARGET_NYM: dest, VERKEY: "~" + dest},
                    "metadata": {"from": author, "reqId": i + 1,
                                 "digest": digest, "payloadDigest": digest},
                    "protocolVersion": 2},
            "txnMetadata": {"seqNo": i + 1, "txnTime": txn_time},
            "reqSignature": {"type": "ED25519", "values": [
                {"from": author, "value": sig_pool[i & 255]}]},
            "ver": "1"}))
    return blobs


# ------------------------------------------------- BLS aggregate job sets

def off_curve_g1() -> bytes:
    """A valid compressed G1 encoding whose x has no point on the curve."""
    from plenum_tpu_torch.crypto import bls_ops
    q, x = bls_ops.Q, 1
    while pow((x ** 3 + 4) % q, (q - 1) // 2, q) == 1:
        x += 1
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= 0x80
    return bytes(raw)


def off_curve_g2() -> bytes:
    """A valid compressed G2 encoding whose x has no point on the curve."""
    from plenum_tpu_torch.crypto import bls_ops
    x = 1
    while True:
        raw = bytearray(x.to_bytes(96, "big"))
        raw[0] |= 0x80
        try:
            bls_ops.g2_decompress(bytes(raw))
        except ValueError:
            return bytes(raw)
        x += 1


def g2_sign_points() -> List[bytes]:
    """Compressed G2 points whose y has c1 above (q-1)/2 and c0 below, and
    the reverse, each with both sign flags (the point and its negation)."""
    from plenum_tpu_torch.crypto import bls_ops
    half = (bls_ops.Q - 1) // 2
    out, kinds, k = [], set(), 2
    while len(kinds) < 2:
        p = bls_ops.g2_mul(bls_ops.G2_GEN, k)
        k += 1
        kind = (p[1].c1 > half, p[1].c0 > half)
        if kind in ((True, False), (False, True)) and kind not in kinds:
            kinds.add(kind)
            out += [bls_ops.g2_compress(p),
                    bls_ops.g2_compress(bls_ops.g2_neg(p))]
    return out


# the verdicts (ok) of aggregate_jobs' first nine jobs
AGGREGATE_JOBS_OK = [True] * 4 + [False, False, True, False, True]


def aggregate_jobs(group: str, points: List[bytes], n: int
                   ) -> List[List[bytes]]:
    """The BLS aggregates' adversarial jobs over compressed G1 (group
    "g1") or G2 ("g2") points, at least five of them: the first n in one
    job (past a block of the decompression launch when n is large), then
    a point repeated within a job and across jobs, all infinity, an empty
    job, an undecodable encoding shared by two jobs (both void), P + (-P),
    an off-curve x, n = 1 (AGGREGATE_JOBS_OK); for G2 also each point of
    g2_sign_points() in a job of its own."""
    from plenum_tpu_torch.crypto import bls_ops
    from plenum_tpu_torch.ops.bls381 import G1_INF, G2_INF
    if group == "g1":
        inf, bad, off = G1_INF, bytes(48), off_curve_g1()
        neg = bls_ops.g1_compress(bls_ops.g1_neg(bls_ops.g1_decompress(
            points[1])))
    else:
        inf, bad, off = G2_INF, b"\x80" + bytes(95), off_curve_g2()
        neg = bls_ops.g2_compress(bls_ops.g2_neg(bls_ops.g2_decompress(
            points[1])))
    jobs = [list(points[:n]), points[:3] + [points[0]], [inf] * 2, [],
            [points[0], bad], [bad, points[2]], [points[1], neg],
            [points[3], off], [points[4]]]
    if group == "g2":
        jobs += [[r] for r in g2_sign_points()]
    return jobs
