"""BLS multi-signatures over BLS12-381 — the state-proof seam.

Mirrors the reference's pluggable BLS abstractions (SURVEY.md §2.7):
`crypto/bls/bls_crypto.py:15,32` (BlsCryptoSigner / BlsCryptoVerifier) and
`crypto/bls/bls_multi_signature.py:70` (MultiSignature value object). The
concrete backend is our from-scratch BLS12-381 (bls12_381.py) instead of
Ursa: signatures in G1 (48 B), public keys in G2 (96 B), aggregation by
plain point addition, one 2-pairing check per multi-sig verify.

Proof-of-possession guards against rogue-key attacks: a key share ships
with a signature over its own compressed public key under a distinct
domain separation tag.
"""
from __future__ import annotations

import base64
import hashlib
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

from . import bls_ops as bls

_DST_SIG = b"PLENUM_TPU_BLS_SIG"
_DST_POP = b"PLENUM_TPU_BLS_POP"


def b58_encode(data: bytes) -> str:
    """Public codec for the b58 wire form of sigs/keys (tooling and
    benches use these instead of reaching into module privates)."""
    from plenum_tpu_torch.common.serializers.base58 import b58encode
    return b58encode(data)


def b58_decode(s: str) -> bytes:
    """Inverse of ``b58_encode``; raises ValueError on bad input."""
    from plenum_tpu_torch.common.serializers.base58 import b58decode
    return b58decode(s)


# historic internal names, kept for in-module brevity
_b58 = b58_encode
_unb58 = b58_decode


class BlsCryptoVerifier(ABC):
    """Reference seam: crypto/bls/bls_crypto.py:15."""

    @abstractmethod
    def verify_sig(self, signature: str, message: bytes, pk: str) -> bool: ...

    @abstractmethod
    def verify_multi_sig(self, signature: str, message: bytes,
                         pks: Sequence[str]) -> bool: ...

    @abstractmethod
    def create_multi_sig(self, signatures: Sequence[str]) -> str: ...

    @abstractmethod
    def verify_key_proof_of_possession(self, key_proof: str, pk: str) -> bool: ...

    # batch seams with scalar-loop defaults: callers (consensus share
    # unroll, client proof batches) call these unconditionally; backends
    # that can amortize (one device pairing launch per batch) override
    def verify_sigs_batch(
            self, checks: Sequence[tuple]) -> List[bool]:
        """checks: (signature, message, pk) triples → per-item verdicts
        identical to mapping ``verify_sig``."""
        return [self.verify_sig(s, m, pk) for (s, m, pk) in checks]

    def verify_multi_sigs_batch(
            self, checks: Sequence[tuple]) -> List[bool]:
        """checks: (signature, message, pks) triples → per-item verdicts
        identical to mapping ``verify_multi_sig``."""
        return [self.verify_multi_sig(s, m, pks) for (s, m, pks) in checks]


class BlsCryptoSigner(ABC):
    """Reference seam: crypto/bls/bls_crypto.py:32."""

    @abstractmethod
    def sign(self, message: bytes) -> str: ...

    @property
    @abstractmethod
    def pk(self) -> str: ...


def generate_bls_keys(seed: Optional[bytes] = None):
    """→ (sk_int, pk_str, key_proof_str)."""
    if seed is None:
        import os
        seed = os.urandom(32)
    sk = int.from_bytes(hashlib.sha512(b"PLENUM_TPU_BLS_KEYGEN" + seed)
                        .digest(), "big") % bls.R
    if sk == 0:
        sk = 1
    pk_point = bls.g2_mul(bls.G2_GEN, sk)
    pk_bytes = bls.g2_compress(pk_point)
    pop_point = bls.g1_mul(bls.hash_to_g1(pk_bytes, _DST_POP), sk)
    return sk, _b58(pk_bytes), _b58(bls.g1_compress(pop_point))


class BlsCryptoSignerPlenum(BlsCryptoSigner):
    def __init__(self, sk: int, pk: str):
        self._sk = sk
        self._pk = pk

    @classmethod
    def generate(cls, seed: Optional[bytes] = None):
        sk, pk, proof = generate_bls_keys(seed)
        return cls(sk, pk), proof

    @property
    def pk(self) -> str:
        return self._pk

    def sign(self, message: bytes) -> str:
        h = bls.hash_to_g1(message, _DST_SIG)
        return _b58(bls.g1_compress(bls.g1_mul(h, self._sk)))


class BlsCryptoVerifierPlenum(BlsCryptoVerifier):
    """Validator public keys are static pool state — decompression,
    subgroup membership and the aggregate key are cached per key-set
    (the reference's ursa keys are likewise deserialized once)."""

    # Miller-line blob for the FIXED -G2 generator argument of every
    # verification (shared by all instances; computed once per process)
    _neg_g2_prep = None

    def __init__(self, device_pairing: bool = False,
                 pairing_device_min: int = 4, device=None):
        """device_pairing / pairing_device_min: the node's
        BLS_DEVICE_PAIRING and BLS_PAIRING_DEVICE_MIN, which route the
        batch seams below (bls_ops.pairing_device_ready); `device` is where
        a routed batch runs (the node's; None means CUDA, "cpu" the
        pairing kernel's plain version)."""
        self.device_pairing = device_pairing
        self.pairing_device_min = pairing_device_min
        self.device = device
        self._pk_cache = {}        # b58 pk -> (point, in_subgroup)
        self._agg_cache = {}       # tuple(pks) -> aggregate point | None
        # b58 sig -> decompressed G1 point: every share was already
        # decompressed once in validate_commit's verify_sig; ordering
        # must not pay the ~50 us sqrt per share a second time
        self._sig_point_cache = {}
        # G2 point (by id of cached object) -> prepared Miller lines:
        # a validator re-verifies against the same pool key-set every
        # batch, so the Q-only pairing work is paid once per set
        self._prep_cache = {}

    def _prepared(self, key, point):
        """Miller-precompute blob for a cached G2 point (None when the
        backend lacks prepared pairings)."""
        if bls.miller_precompute is None:
            return None
        blob = self._prep_cache.get(key)
        if blob is None:
            try:
                blob = bls.miller_precompute(point)
            except ValueError:
                return None
            if len(self._prep_cache) > 1024:
                self._prep_cache.clear()
            self._prep_cache[key] = blob
        return blob

    def _pairing_is_one(self, sig_point, h_point, q_key, q_point) -> bool:
        """e(sig, -G2)·e(H(m), Q) == 1, through the prepared path when
        the native backend offers it."""
        if bls.multi_pairing_is_one_prepared is not None:
            cls = BlsCryptoVerifierPlenum
            if cls._neg_g2_prep is None and bls.miller_precompute:
                cls._neg_g2_prep = bls.miller_precompute(
                    bls.g2_neg(bls.G2_GEN))
            q_prep = self._prepared(q_key, q_point)
            if cls._neg_g2_prep is not None and q_prep is not None:
                return bls.multi_pairing_is_one_prepared(
                    [(sig_point, cls._neg_g2_prep), (h_point, q_prep)])
        return bls.multi_pairing_is_one(
            [(sig_point, bls.g2_neg(bls.G2_GEN)), (h_point, q_point)])

    def _g1(self, s: str):
        return bls.g1_decompress(_unb58(s))

    def _g2(self, s: str):
        return bls.g2_decompress(_unb58(s))

    def _pk_point(self, pk: str):
        """→ (point, valid) with caching; valid ⇒ on-curve + subgroup."""
        hit = self._pk_cache.get(pk)
        if hit is not None:
            return hit
        try:
            p = self._g2(pk)
            valid = p is not None and bls.g2_in_subgroup(p)
        except (ValueError, KeyError):
            p, valid = None, False
        if len(self._pk_cache) > 4096:
            self._pk_cache.clear()
        self._pk_cache[pk] = (p, valid)
        return p, valid

    def warm_keys(self, pks: Sequence[str]) -> None:
        """Precompute every key-dependent cost for a pool key-set at
        catchup/membership-change time instead of at first verify: G2
        decompression + subgroup check per key, the aggregate key of
        the full set, and its prepared Miller lines (plus the fixed
        -G2 preparation). The per-key subgroup checks (~3.5 ms each —
        the bulk of the lazy cold cost) are warmed for EVERY later
        key-subset; the aggregate key + Miller lines are warmed for the
        full set, so a verify against a fresh n-f participant subset
        still lazily pays that subset's aggregation (microseconds
        native) + one Miller precompute (~0.2 ms). The reference pays
        the equivalent at key-deserialization time (ursa
        VerKey::from_bytes, bls_crypto_indy_crypto.py:84)."""
        cls = BlsCryptoVerifierPlenum
        if cls._neg_g2_prep is None and bls.miller_precompute is not None:
            cls._neg_g2_prep = bls.miller_precompute(bls.g2_neg(bls.G2_GEN))
        for pk in pks:
            self._pk_point(pk)
        key = tuple(pks)
        agg = self._aggregate_pks(key)
        if agg is not None:
            self._prepared(key, agg)

    def _aggregate_pks(self, pks: Sequence[str]):
        key = tuple(pks)
        if key in self._agg_cache:
            return self._agg_cache[key]
        agg = None
        for pk in pks:
            p, valid = self._pk_point(pk)
            if not valid:
                agg = None
                break
            agg = bls.g2_add(agg, p)
        if len(self._agg_cache) > 1024:
            self._agg_cache.clear()
        self._agg_cache[key] = agg
        return agg

    def _sig_cached(self, signature: str):
        """Decompressed share point, memoized (ordering re-reads every
        share create_multi_sig-side; never pay the sqrt twice). May
        raise ValueError/KeyError on undecodable input."""
        sig = self._sig_point_cache.get(signature)
        if sig is None:
            sig = self._g1(signature)
            if len(self._sig_point_cache) > 8192:
                self._sig_point_cache.clear()
            self._sig_point_cache[signature] = sig
        return sig

    def verify_sig(self, signature: str, message: bytes, pk: str) -> bool:
        try:
            sig = self._sig_cached(signature)
        except (ValueError, KeyError):
            return False
        pub, valid = self._pk_point(pk)
        if sig is None or not valid:
            return False
        if not bls.g1_in_subgroup(sig):
            return False
        h = bls.hash_to_g1(message, _DST_SIG)
        # e(sig, G2) == e(H(m), pk)  ⇔  e(sig, -G2)·e(H(m), pk) == 1
        return self._pairing_is_one(sig, h, pk, pub)

    def verify_multi_sig(self, signature: str, message: bytes,
                         pks: Sequence[str]) -> bool:
        if not pks:
            return False
        key = tuple(pks)
        agg_pk = self._aggregate_pks(key)
        try:
            sig = self._g1(signature)
        except (ValueError, KeyError):
            return False
        if sig is None or agg_pk is None:
            return False
        if not bls.g1_in_subgroup(sig):
            return False
        h = bls.hash_to_g1(message, _DST_SIG)
        return self._pairing_is_one(sig, h, key, agg_pk)

    # ------------------------------------------------------ batch verify
    # One device pairing launch per batch (bls_ops.multi_pairing_is_one_jobs
    # on self.device) when device pairing is on and the batch clears
    # pairing_device_min; otherwise the scalar path with its
    # prepared Miller lines. Every host-side pre-check (decode,
    # subgroup, key validity) runs EXACTLY as in the scalar methods, so
    # batch and scalar verdicts agree item-for-item — only the pairing
    # product itself moves to the device.

    _neg_g2_c = None     # compressed -G2: fixed first pair of every job

    @classmethod
    def _neg_g2_bytes(cls) -> bytes:
        if cls._neg_g2_c is None:
            cls._neg_g2_c = bls.g2_compress(bls.g2_neg(bls.G2_GEN))
        return cls._neg_g2_c

    def _job_pairs(self, signature: str, message: bytes, pub):
        """The 2-pair job e(sig,-G2)·e(H(m),pub) in compressed bytes;
        pre-checks already passed, so both pairs decode live on device."""
        h = bls.hash_to_g1(message, _DST_SIG)
        return [(b58_decode(signature), self._neg_g2_bytes()),
                (bls.g1_compress(h), bls.g2_compress(pub))]

    def _job_single(self, signature: str, message: bytes, pk: str):
        """verify_sig's pre-checks → job, or None for an immediate
        False verdict (mirrors the scalar early-outs line for line)."""
        try:
            sig = self._sig_cached(signature)
        except (ValueError, KeyError):
            return None
        pub, valid = self._pk_point(pk)
        if sig is None or not valid or not bls.g1_in_subgroup(sig):
            return None
        return self._job_pairs(signature, message, pub)

    def _job_multi(self, signature: str, message: bytes, pks):
        if not pks:
            return None
        agg_pk = self._aggregate_pks(tuple(pks))
        try:
            sig = self._g1(signature)
        except (ValueError, KeyError):
            return None
        if sig is None or agg_pk is None or not bls.g1_in_subgroup(sig):
            return None
        return self._job_pairs(signature, message, agg_pk)

    def _verify_batch(self, checks, job_of):
        results = [False] * len(checks)
        jobs, live = [], []
        for i, check in enumerate(checks):
            job = job_of(*check)
            if job is not None:
                jobs.append(job)
                live.append(i)
        for i, ok in zip(live, bls.multi_pairing_is_one_jobs(
                jobs, self.device_pairing, self.pairing_device_min,
                self.device)):
            results[i] = bool(ok)
        return results

    def verify_sigs_batch(self, checks) -> List[bool]:
        if not bls.pairing_device_ready(len(checks), self.device_pairing,
                                        self.pairing_device_min):
            return [self.verify_sig(s, m, pk) for (s, m, pk) in checks]
        return self._verify_batch(checks, self._job_single)

    def verify_multi_sigs_batch(self, checks) -> List[bool]:
        if not bls.pairing_device_ready(len(checks), self.device_pairing,
                                        self.pairing_device_min):
            return [self.verify_multi_sig(s, m, pks)
                    for (s, m, pks) in checks]
        return self._verify_batch(checks, self._job_multi)

    def create_multi_sig(self, signatures: Sequence[str]) -> str:
        """One backend call for the whole share-set: Jacobian
        accumulation with a single final inversion, instead of an affine
        add — and its field inversion — per share. Shares this verifier
        already pairing-checked (validate_commit path) aggregate from
        their CACHED decompressed points, skipping the per-share sqrt
        entirely — on the ordering money path aggregation is then pure
        point addition."""
        # NOTE: a cache VALUE of None is legitimate (the infinity
        # encoding decompresses to None), so membership — not just
        # get() — distinguishes a miss
        cache = self._sig_point_cache
        pts = []
        misses = []
        for s in signatures:
            p = cache.get(s)
            if p is None and s not in cache:
                misses.append(s)
            pts.append(p)
        if len(misses) == len(signatures):
            # fully cold (no shares seen): one batched native call
            agg = bls.g1_aggregate_compressed(
                [_unb58(s) for s in signatures])
            return _b58(bls.g1_compress(agg))
        if misses:
            for i, s in enumerate(signatures):
                if pts[i] is None and s not in cache:
                    pts[i] = self._g1(s)
        agg = bls.g1_aggregate_points(pts)
        return _b58(bls.g1_compress(agg))

    def verify_key_proof_of_possession(self, key_proof: str, pk: str) -> bool:
        try:
            proof = self._g1(key_proof)
        except (ValueError, KeyError):
            return False
        pub, valid = self._pk_point(pk)
        if proof is None or not valid:
            return False
        if not bls.g1_in_subgroup(proof):
            return False
        pk_bytes = _unb58(pk)
        h = bls.hash_to_g1(pk_bytes, _DST_POP)
        return self._pairing_is_one(proof, h, pk, pub)


class MultiSignatureValue:
    """What gets BLS-signed on ordering: the batch's roots and 3PC info.
    Reference: crypto/bls/bls_multi_signature.py (MultiSignatureValue)."""

    def __init__(self, ledger_id: int, state_root_hash: str,
                 txn_root_hash: str, pool_state_root_hash: str,
                 timestamp: int):
        self.ledger_id = ledger_id
        self.state_root_hash = state_root_hash
        self.txn_root_hash = txn_root_hash
        self.pool_state_root_hash = pool_state_root_hash
        self.timestamp = timestamp

    def as_dict(self) -> dict:
        return {
            "ledger_id": self.ledger_id,
            "state_root_hash": self.state_root_hash,
            "txn_root_hash": self.txn_root_hash,
            "pool_state_root_hash": self.pool_state_root_hash,
            "timestamp": self.timestamp,
        }

    def as_single_value(self) -> bytes:
        items = sorted(self.as_dict().items())
        return b"|".join(f"{k}={v}".encode() for k, v in items)

    @classmethod
    def from_dict(cls, d: dict) -> "MultiSignatureValue":
        return cls(d["ledger_id"], d["state_root_hash"], d["txn_root_hash"],
                   d["pool_state_root_hash"], d["timestamp"])

    def __eq__(self, other):
        return isinstance(other, MultiSignatureValue) and \
            self.as_dict() == other.as_dict()


class MultiSignature:
    """Aggregated signature + participant names + signed value.
    Reference: crypto/bls/bls_multi_signature.py:70."""

    def __init__(self, signature: str, participants: List[str],
                 value: MultiSignatureValue):
        self.signature = signature
        self.participants = list(participants)
        self.value = value

    def as_dict(self) -> dict:
        return {"signature": self.signature,
                "participants": self.participants,
                "value": self.value.as_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "MultiSignature":
        return cls(d["signature"], d["participants"],
                   MultiSignatureValue.from_dict(d["value"]))

    def __eq__(self, other):
        return isinstance(other, MultiSignature) and \
            self.as_dict() == other.as_dict()
