"""Client request: operation dict + signature(s) + digests.

Reference: plenum/common/request.py:13 (Request), :42 (digest). The digest is
sha256 over the canonical serialization of all signed fields; payload_digest
excludes signatures (dedup key — seqNoDB maps payload_digest → txn).
"""
from hashlib import sha256
from typing import Dict

from plenum_tpu_torch.common.constants import (
    CURRENT_PROTOCOL_VERSION, IDENTIFIER, OPERATION, REQ_ID, SIGNATURE,
    SIGNATURES, TAA_ACCEPTANCE)
from plenum_tpu_torch.common.serializers.serialization import serialize_msg_for_signing
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext

_fp = try_load_host_ext("fastpath")


class Request:
    def __init__(self,
                 identifier: str = None,
                 reqId: int = None,
                 operation: Dict = None,
                 signature: str = None,
                 signatures: Dict[str, str] = None,
                 protocolVersion: int = CURRENT_PROTOCOL_VERSION,
                 taaAcceptance: Dict = None,
                 endorser: str = None):
        self.identifier = identifier
        self.reqId = reqId
        self.operation = operation or {}
        self.signature = signature
        self.signatures = signatures
        self.protocolVersion = protocolVersion
        self.taaAcceptance = taaAcceptance
        self.endorser = endorser
        # cached: read ~6x per request across intake/apply/commit, and
        # the operation dict never mutates after construction
        self.txn_type = (operation or {}).get('type')
        self._digest = None
        self._payload_digest = None
        self._payload_state = None  # cached signingPayloadState()
        # canonical signing bytes, pre-computed by the C intake path
        # (fastpath.request_intake) — authentication reuses them
        self._signing_ser = None

    @property
    def digest(self) -> str:
        if self._digest is None:
            self._digest = self.getDigest()
        return self._digest

    @property
    def payload_digest(self) -> str:
        if self._payload_digest is None:
            self._payload_digest = self.getPayloadDigest()
        return self._payload_digest

    def getDigest(self) -> str:
        if _fp is not None:
            try:
                return _fp.digest_hex(self.signingState())
            except TypeError:
                pass
        return sha256(serialize_msg_for_signing(self.signingState())).hexdigest()

    def getPayloadDigest(self) -> str:
        if _fp is not None:
            try:
                return _fp.digest_hex(self.signingPayloadState())
            except TypeError:
                pass
        return sha256(serialize_msg_for_signing(
            self.signingPayloadState())).hexdigest()

    def signingState(self, identifier=None) -> Dict:
        # copy: signingPayloadState may hand back its cached dict, and
        # the signature keys added here must not leak into it
        state = dict(self.signingPayloadState(identifier))
        if self.signatures is not None:
            state[SIGNATURES] = self.signatures
        if self.signature is not None:
            state[SIGNATURE] = self.signature
        return state

    def signingPayloadState(self, identifier=None) -> Dict:
        if identifier is None or identifier == self.identifier:
            # hot path: digest, payload digest, and signature prep all
            # build this same dict — once per request, not three times
            state = self._payload_state
            if state is not None:
                return state
        state = {
            IDENTIFIER: identifier or self.identifier,
            REQ_ID: self.reqId,
            OPERATION: self.operation,
        }
        if self.protocolVersion is not None:
            state['protocolVersion'] = self.protocolVersion
        if self.taaAcceptance is not None:
            state[TAA_ACCEPTANCE] = self.taaAcceptance
        if self.endorser is not None:
            state['endorser'] = self.endorser
        if identifier is None or identifier == self.identifier:
            self._payload_state = state
        return state

    @property
    def key(self) -> str:
        return self.digest

    def all_identifiers(self):
        ids = []
        if self.signatures:
            ids.extend(self.signatures.keys())
        if self.identifier is not None and self.identifier not in ids:
            ids.append(self.identifier)
        return sorted(ids)

    def as_dict(self) -> Dict:
        d = {
            IDENTIFIER: self.identifier,
            REQ_ID: self.reqId,
            OPERATION: self.operation,
            'protocolVersion': self.protocolVersion,
        }
        if self.signature is not None:
            d[SIGNATURE] = self.signature
        if self.signatures is not None:
            d[SIGNATURES] = self.signatures
        if self.taaAcceptance is not None:
            d[TAA_ACCEPTANCE] = self.taaAcceptance
        if self.endorser is not None:
            d['endorser'] = self.endorser
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> 'Request':
        return cls(identifier=d.get(IDENTIFIER),
                   reqId=d.get(REQ_ID),
                   operation=d.get(OPERATION),
                   signature=d.get(SIGNATURE),
                   signatures=d.get(SIGNATURES),
                   protocolVersion=d.get('protocolVersion',
                                         CURRENT_PROTOCOL_VERSION),
                   taaAcceptance=d.get(TAA_ACCEPTANCE),
                   endorser=d.get('endorser'))

    def __eq__(self, other):
        return isinstance(other, Request) and self.as_dict() == other.as_dict()

    def __hash__(self):
        return hash(self.digest)

    def __repr__(self):
        return "Request(identifier={}, reqId={}, type={})".format(
            self.identifier, self.reqId, self.txn_type)
