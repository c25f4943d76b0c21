"""Client request authentication — ed25519 over the signing serialization.

Reference: plenum/server/client_authn.py (`ClientAuthNr` :21, `NaclAuthNr`
:82 authenticate_multi :84, `CoreAuthNr`) + req_authenticator.py
(`ReqAuthenticator` :11); port of plenum_tpu/server/client_authn.py.

Device seam: `CoreAuthNr.dispatch_batch` hands every signature of a batch
of requests to the batch verifier (plenum_tpu_torch.crypto.batch_verifier)
— thousands of signature checks become one device launch — and
`conclude_batch` harvests the verdicts.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence

from plenum_tpu_torch.common.exceptions import (
    CouldNotAuthenticate, InsufficientCorrectSignatures,
    InsufficientSignatures, InvalidSignature)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serializers.base58 import b58decode
from plenum_tpu_torch.common.serializers.serialization import serialize_msg_for_signing
from plenum_tpu_torch.crypto.batch_verifier import CoalescingVerifierHub
from plenum_tpu_torch.crypto.signer import verkey_from_identifier

class ClientAuthNr(ABC):
    @abstractmethod
    def authenticate(self, req: Request) -> List[str]:
        """→ identifiers whose signatures verified; raises on failure."""

    @abstractmethod
    def addIdr(self, identifier: str, verkey: str, role=None): ...

    @abstractmethod
    def getVerkey(self, identifier: str) -> Optional[str]: ...


class CoreAuthNr(ClientAuthNr):
    def __init__(self, verkey_provider=None, verifier=None,
                 prescreen=None):
        """verkey_provider(identifier) → verkey str or None (state-backed
        in the node; local dict fallback for tests). verifier defaults to
        a CoalescingVerifierHub over the CUDA batch verifier. prescreen:
        an advisory verdict cache (see set_prescreen)."""
        self._verkey_provider = verkey_provider
        self._local: Dict[str, str] = {}
        self._verifier = verifier if verifier is not None \
            else CoalescingVerifierHub()
        # (identifier, verkey_str) → raw 32/64 bytes; keyed on BOTH so a
        # rotated verkey can never serve a stale raw key
        self._raw_cache: Dict[tuple, bytes] = {}
        self._prescreen = prescreen

    def set_prescreen(self, cache) -> None:
        """Install an advisory verdict cache (the pipeline's
        PrescreenCache): ``cache.check((ser, sig64, vk32))`` is True
        ONLY for a signature already verified somewhere — a hit skips
        the verify for that item; a miss — or no pre-screen — takes the
        full verifier path, so outcomes are byte-identical either way
        (positive-only filter, never an authority). The authenticator
        also WARMS the cache on every successful verify, so the relayed
        propagate copies of a request cost one verification, not n."""
        self._prescreen = cache

    # ------------------------------------------------------------- keys

    def addIdr(self, identifier: str, verkey: str, role=None):
        self._local[identifier] = verkey

    def getVerkey(self, identifier: str) -> Optional[str]:
        if identifier in self._local:
            return self._local[identifier]
        if self._verkey_provider is not None:
            return self._verkey_provider(identifier)
        return None

    def _raw_verkey(self, identifier: str) -> bytes:
        verkey = self.getVerkey(identifier)
        cache_key = (identifier, verkey)
        raw = self._raw_cache.get(cache_key)
        if raw is None:
            raw = verkey_from_identifier(identifier, verkey)
            if len(self._raw_cache) > 8192:
                self._raw_cache.clear()
            self._raw_cache[cache_key] = raw
        return raw

    # ----------------------------------------------------------- single

    def authenticate(self, req: Request) -> List[str]:
        items, idrs = self._verify_items(req)
        results = self._verify_batch_prescreened(items)
        return self._conclude(req, idrs, results)

    def _verify_batch_prescreened(self, items) -> List[bool]:
        """verify_batch with cached-positive short-circuit: items the
        pre-screen already verified (exact (ser, sig, vk) triple) skip
        the verify; everything else verifies normally."""
        pre = self._prescreen
        if pre is None:
            return self._verifier.verify_batch(items)
        misses = [i for i, it in enumerate(items) if not pre.check(it)]
        if not misses:
            return [True] * len(items)
        verified = self._verifier.verify_batch(
            [items[i] for i in misses])
        results = [True] * len(items)
        for i, ok in zip(misses, verified):
            results[i] = bool(ok)
            if ok:
                pre.add(*items[i])
        return results

    # ------------------------------------------------------------ batch

    def authenticate_batch(self, reqs: Sequence[Request]
                           ) -> List[Optional[List[str]]]:
        """Authenticate many requests in ONE device dispatch. Returns, per
        request, the verified identifier list or None if auth failed."""
        return self.conclude_batch(self.dispatch_batch(reqs))

    def dispatch_batch(self, reqs: Sequence[Request]):
        """Phase 1 (non-blocking): pack every signature on every request
        into one device dispatch and return a pending handle. The caller
        overlaps other work with the device round trip and calls
        conclude_batch later."""
        all_items, spans, idrs_per_req = [], [], []
        prep_errors: List[Optional[Exception]] = []
        for req in reqs:
            try:
                items, idrs = self._verify_items(req)
                prep_errors.append(None)
            except Exception as e:
                items, idrs = [], []
                prep_errors.append(e)
            spans.append((len(all_items), len(items)))
            idrs_per_req.append(idrs)
            all_items.extend(items)
        pending = self._verifier.dispatch(all_items) if all_items else None
        return (list(reqs), spans, idrs_per_req, prep_errors, pending,
                all_items)

    def flush(self) -> None:
        """Start any coalesced device launch now (CoalescingVerifierHub);
        no-op for providers without a coalescing window. A networked
        node calls this right after its tick's dispatch — nothing else
        co-resident will deepen the generation, and without the flush a
        hub pending's ready() could never turn true."""
        fn = getattr(self._verifier, "flush", None)
        if fn is not None:
            fn()

    def batch_ready(self, handle) -> bool:
        """Non-blocking: True when conclude_batch will not block on the
        device (the caller polls this to overlap the round trip with other
        work)."""
        pending = handle[4]
        if pending is None:
            return True
        r = getattr(pending, "ready", None)
        return bool(r()) if r is not None else True

    def conclude_batch(self, handle) -> List[Optional[List[str]]]:
        """Phase 2 (blocking): harvest the device results."""
        reqs, spans, idrs_per_req, prep_errors, pending, all_items = handle
        results = pending.collect() if pending is not None else []
        if self._prescreen is not None:
            # warm the verdict cache from the intake verifies: the
            # propagate copies of these requests then pre-screen clean
            for item, ok in zip(all_items, results):
                if ok:
                    self._prescreen.add(*item)
        out: List[Optional[List[str]]] = []
        for req, (start, count), idrs, err in zip(reqs, spans, idrs_per_req,
                                                  prep_errors):
            if err is not None:
                out.append(None)
                continue
            try:
                out.append(self._conclude(
                    req, idrs, results[start:start + count]))
            except InsufficientCorrectSignatures:
                out.append(None)
        return out

    # ---------------------------------------------------------- internal

    def _verify_items(self, req: Request):
        """→ ([(msg_bytes, sig64, vk32)], [identifier]) for every
        signature on the request."""
        sigs: Dict[str, str] = {}
        if req.signatures:
            sigs.update(req.signatures)
        if req.signature:
            if req.identifier is None:
                raise CouldNotAuthenticate(
                    None, req.reqId, "signature without identifier")
            sigs[req.identifier] = req.signature
        if not sigs:
            raise InsufficientSignatures(0, 1)
        items, idrs = [], []
        for idr, sig in sorted(sigs.items()):
            try:
                sig_raw = b58decode(sig)
            except Exception:
                raise InvalidSignature(
                    idr, req.reqId, "malformed signature from {}".format(idr))
            try:
                vk = self._raw_verkey(idr)
            except Exception:
                vk = None
            if vk is None:
                raise CouldNotAuthenticate(
                    idr, req.reqId, "no verkey for {}".format(idr))
            if idr == req.identifier and req._signing_ser is not None:
                # canonical bytes already built by the C intake pass
                ser = req._signing_ser
            else:
                ser = serialize_msg_for_signing(req.signingPayloadState(idr))
            items.append((ser, sig_raw, vk))
            idrs.append(idr)
        return items, idrs

    @staticmethod
    def _conclude(req: Request, idrs: List[str],
                  results: Sequence[bool]) -> List[str]:
        ok = [i for i, good in zip(idrs, results) if good]
        if len(ok) != len(idrs):
            raise InsufficientCorrectSignatures(len(ok), len(idrs))
        return ok


class ReqAuthenticator:
    """Registry of authenticators (reference req_authenticator.py:11)."""

    def __init__(self):
        self._authenticators: List[ClientAuthNr] = []

    def register_authenticator(self, authnr: ClientAuthNr):
        self._authenticators.append(authnr)

    def authenticate(self, req: Request) -> List[str]:
        identifiers = []
        for a in self._authenticators:
            identifiers.extend(a.authenticate(req))
        return identifiers

    @property
    def core_authenticator(self) -> Optional[CoreAuthNr]:
        for a in self._authenticators:
            if isinstance(a, CoreAuthNr):
                return a
        return None
