"""Canonical transaction envelope helpers.

Reference: plenum/common/txn_util.py:335 — a committed txn is
{ver, txn: {type, data, metadata, protocolVersion}, txnMetadata: {txnTime,
seqNo, txnId}, reqSignature: {type, values}}.
"""
from typing import Optional

from plenum_tpu_torch.common.constants import (
    TXN_PAYLOAD, TXN_PAYLOAD_TYPE, TXN_PAYLOAD_DATA, TXN_PAYLOAD_METADATA,
    TXN_PAYLOAD_METADATA_FROM, TXN_PAYLOAD_METADATA_REQ_ID,
    TXN_PAYLOAD_METADATA_DIGEST, TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST,
    TXN_PAYLOAD_METADATA_TAA_ACCEPTANCE, TXN_PAYLOAD_METADATA_ENDORSER,
    TXN_PAYLOAD_PROTOCOL_VERSION, TXN_METADATA, TXN_METADATA_TIME,
    TXN_METADATA_SEQ_NO, TXN_METADATA_ID, TXN_SIGNATURE, TXN_SIGNATURE_TYPE,
    TXN_SIGNATURE_VALUES, TXN_SIGNATURE_FROM, TXN_SIGNATURE_VALUE,
    TXN_VERSION, ED25519)


def init_empty_txn(txn_type, protocol_version=None) -> dict:
    txn = {
        TXN_PAYLOAD: {
            TXN_PAYLOAD_TYPE: txn_type,
            TXN_PAYLOAD_DATA: {},
            TXN_PAYLOAD_METADATA: {},
        },
        TXN_METADATA: {},
        TXN_SIGNATURE: {},
        TXN_VERSION: "1",
    }
    if protocol_version is not None:
        txn[TXN_PAYLOAD][TXN_PAYLOAD_PROTOCOL_VERSION] = protocol_version
    return txn


def reqToTxn(req) -> dict:
    """Build the txn envelope from a Request (reference txn_util.py
    reqToTxn). Runs once per write on the apply hot path — the envelope
    is built as one literal instead of init_empty_txn + patching."""
    if isinstance(req, dict):
        from plenum_tpu_torch.common.request import Request
        req = Request(**req) if 'operation' in req else Request(**req.get('req', req))
    op = dict(req.operation)
    txn_type = op.pop('type')
    md = {TXN_PAYLOAD_METADATA_DIGEST: req.digest,
          TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST: req.payload_digest}
    if req.identifier is not None:
        md[TXN_PAYLOAD_METADATA_FROM] = req.identifier
    if req.reqId is not None:
        md[TXN_PAYLOAD_METADATA_REQ_ID] = req.reqId
    if req.taaAcceptance is not None:
        md[TXN_PAYLOAD_METADATA_TAA_ACCEPTANCE] = req.taaAcceptance
    if req.endorser is not None:
        md[TXN_PAYLOAD_METADATA_ENDORSER] = req.endorser
    payload = {TXN_PAYLOAD_TYPE: txn_type,
               TXN_PAYLOAD_DATA: op,
               TXN_PAYLOAD_METADATA: md}
    if req.protocolVersion is not None:
        payload[TXN_PAYLOAD_PROTOCOL_VERSION] = req.protocolVersion
    sig = {}
    if req.signature or req.signatures:
        sig[TXN_SIGNATURE_TYPE] = ED25519
        values = []
        if req.signature:
            values.append({TXN_SIGNATURE_FROM: req.identifier,
                           TXN_SIGNATURE_VALUE: req.signature})
        if req.signatures:
            for frm, value in sorted(req.signatures.items()):
                values.append({TXN_SIGNATURE_FROM: frm,
                               TXN_SIGNATURE_VALUE: value})
        sig[TXN_SIGNATURE_VALUES] = values
    return {TXN_PAYLOAD: payload,
            TXN_METADATA: {},
            TXN_SIGNATURE: sig,
            TXN_VERSION: "1"}


def append_txn_metadata(txn: dict, seq_no: int = None, txn_time: int = None,
                        txn_id: str = None) -> dict:
    md = txn.setdefault(TXN_METADATA, {})
    if seq_no is not None:
        md[TXN_METADATA_SEQ_NO] = seq_no
    if txn_time is not None:
        md[TXN_METADATA_TIME] = txn_time
    if txn_id is not None:
        md[TXN_METADATA_ID] = txn_id
    return txn


def get_type(txn: dict):
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_TYPE]


def get_payload_data(txn: dict) -> dict:
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_DATA]


def get_from(txn: dict) -> Optional[str]:
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_METADATA].get(TXN_PAYLOAD_METADATA_FROM)


def get_req_id(txn: dict) -> Optional[int]:
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_METADATA].get(TXN_PAYLOAD_METADATA_REQ_ID)


def get_digest(txn: dict) -> Optional[str]:
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_METADATA].get(TXN_PAYLOAD_METADATA_DIGEST)


def get_payload_digest(txn: dict) -> Optional[str]:
    return txn[TXN_PAYLOAD][TXN_PAYLOAD_METADATA].get(
        TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST)


def get_seq_no(txn: dict) -> Optional[int]:
    return txn.get(TXN_METADATA, {}).get(TXN_METADATA_SEQ_NO)


def get_txn_time(txn: dict) -> Optional[int]:
    return txn.get(TXN_METADATA, {}).get(TXN_METADATA_TIME)


def get_txn_id(txn: dict) -> Optional[str]:
    return txn.get(TXN_METADATA, {}).get(TXN_METADATA_ID)


def get_version(txn: dict):
    return txn.get(TXN_VERSION)


def get_protocol_version(txn: dict):
    return txn[TXN_PAYLOAD].get(TXN_PAYLOAD_PROTOCOL_VERSION)


def get_req_signature(txn: dict) -> dict:
    return txn.get(TXN_SIGNATURE, {})


class TxnMarker:
    """Sort marker for deterministic txn iteration."""
