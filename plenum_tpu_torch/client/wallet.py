"""Client-side identity: a wallet of DID signers that signs requests.

Reference parity: plenum/client/wallet.py:38 (Wallet — addIdentifier,
signMsg/signRequest/signOp, sign_using_multi_sig, aliases) and :294
(WalletStorageHelper — keyrings dir with restrictive permissions). The
reference encrypts wallets with libsodium SecretBox; here storage holds
raw seeds behind 0600 file permissions, with the encryption seam left to
the deployment (the signing path, not storage crypto, is this layer's
job).
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.serialization import (
    serialize_msg_for_signing)
from plenum_tpu_torch.crypto.signer import DidSigner, Signer, SimpleSigner


class _IdData:
    __slots__ = ("signer", "alias")

    def __init__(self, signer: Signer, alias: Optional[str]):
        self.signer = signer
        self.alias = alias


_last_req_id = 0


def _new_req_id() -> int:
    """Strictly increasing time-derived request id (two requests signed
    in the same microsecond must not share a (identifier, reqId) key)."""
    global _last_req_id
    rid = max(time.time_ns() // 1000, _last_req_id + 1)
    _last_req_id = rid
    return rid


class Wallet:
    """Holds signing identities; knows nothing about transport."""

    def __init__(self, name: str = "wallet"):
        self.name = name
        self._ids: "OrderedDict[str, _IdData]" = OrderedDict()
        self.default_id: Optional[str] = None

    # ------------------------------------------------------- identities

    def add_identifier(self, signer: Signer = None, seed: bytes = None,
                       alias: str = None, did: bool = True
                       ) -> Tuple[str, Signer]:
        """Add (or create) a signing identity; first one becomes default."""
        if signer is None:
            signer = DidSigner(seed=seed) if did else SimpleSigner(seed=seed)
        idr = signer.identifier
        self._ids[idr] = _IdData(signer, alias)
        if self.default_id is None:
            self.default_id = idr
        return idr, signer

    def update_signer(self, identifier: str, signer: Signer):
        if identifier not in self._ids:
            raise KeyError("unknown identifier {}".format(identifier))
        self._ids[identifier].signer = signer

    @property
    def identifiers(self) -> List[str]:
        return list(self._ids)

    def alias_of(self, identifier: str) -> Optional[str]:
        data = self._ids.get(identifier)
        return data.alias if data else None

    def id_by_alias(self, alias: str) -> str:
        for idr, data in self._ids.items():
            if data.alias == alias:
                return idr
        raise KeyError("unknown alias {}".format(alias))

    def required_idr(self, identifier: str = None, alias: str = None) -> str:
        if alias is not None:
            return self.id_by_alias(alias)
        idr = identifier or self.default_id
        if idr is None or idr not in self._ids:
            raise KeyError("no such identifier in wallet: {}".format(idr))
        return idr

    def get_verkey(self, identifier: str = None) -> str:
        return self._ids[self.required_idr(identifier)].signer.verkey

    def _signer(self, identifier: str = None) -> Signer:
        return self._ids[self.required_idr(identifier)].signer

    # ---------------------------------------------------------- signing

    def sign_msg(self, msg, identifier: str = None) -> str:
        """Sign a dict (canonical serialization) or bytes → b58 sig."""
        return self._signer(identifier).sign(msg)

    def sign_request(self, req: Request, identifier: str = None) -> Request:
        """Single-signature: sets req.identifier (if unset) + signature."""
        idr = self.required_idr(identifier or req.identifier)
        if req.identifier is None:
            req.identifier = idr
        elif req.identifier != idr:
            # the server verifies against req.identifier's key; signing
            # as anyone else yields a request that can never authenticate
            raise ValueError(
                "identifier {} does not match request author {}; use "
                "sign_using_multi_sig for extra signatures".format(
                    idr, req.identifier))
        if req.reqId is None:
            req.reqId = _new_req_id()
        payload = serialize_msg_for_signing(req.signingPayloadState(idr))
        req.signature = self._signer(idr).sign(payload)
        return req

    def sign_using_multi_sig(self, req: Request,
                             identifier: str = None) -> Request:
        """Append this identity's signature to req.signatures (the
        multi-sig authn path, server: CoreAuthNr._verify_items)."""
        idr = self.required_idr(identifier)
        if req.reqId is None:
            req.reqId = _new_req_id()
        payload = serialize_msg_for_signing(req.signingPayloadState(idr))
        if req.signatures is None:
            req.signatures = {}
        req.signatures[idr] = self._signer(idr).sign(payload)
        return req

    def sign_op(self, operation: Dict, identifier: str = None,
                taa_acceptance: Dict = None) -> Request:
        """Build + sign a fresh request around an operation dict."""
        req = Request(identifier=self.required_idr(identifier),
                      reqId=_new_req_id(), operation=operation,
                      taaAcceptance=taa_acceptance)
        return self.sign_request(req)


class WalletStorageHelper:
    """Saves/loads wallets under a keyrings dir with restrictive
    permissions (reference WalletStorageHelper: dmode=0o700, fmode=0o600)."""

    def __init__(self, base_dir: str, dmode: int = 0o700,
                 fmode: int = 0o600):
        self.base_dir = os.path.abspath(base_dir)
        self._dmode = dmode
        self._fmode = fmode
        os.makedirs(self.base_dir, mode=dmode, exist_ok=True)
        os.chmod(self.base_dir, dmode)

    def _path(self, name: str) -> str:
        fname = name + ".wallet"
        path = os.path.abspath(os.path.join(self.base_dir, fname))
        # refuse path escapes ("../../etc/passwd" as a wallet name)
        if os.path.dirname(path) != self.base_dir:
            raise ValueError("invalid wallet name {!r}".format(name))
        return path

    def save_wallet(self, wallet: Wallet) -> str:
        data = {
            "name": wallet.name,
            "default": wallet.default_id,
            "ids": [{
                "seed": b58encode(d.signer.seed),
                "alias": d.alias,
                "did": isinstance(d.signer, DidSigner),
            } for d in wallet._ids.values()],
        }
        path = self._path(wallet.name)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                     self._fmode)
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.chmod(path, self._fmode)
        return path

    def load_wallet(self, name: str) -> Wallet:
        with open(self._path(name)) as f:
            data = json.load(f)
        w = Wallet(data["name"])
        for entry in data["ids"]:
            seed = b58decode(entry["seed"])
            w.add_identifier(seed=seed, alias=entry.get("alias"),
                             did=entry.get("did", True))
        if data.get("default"):
            w.default_id = data["default"]
        return w
