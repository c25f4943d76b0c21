"""State-leaf encoding shared by write handlers and verifying clients.

The domain-state MPT stores, per nym, a canonical-JSON envelope
``{"val": <record>, "lsn": seq_no, "lut": txn_time}`` (reference:
plenum/server/request_handlers/utils.py encode_state_value /
decode_state_value). A client checking a state proof must rebuild the
leaf byte-for-byte from the reply's (data, seqNo, txnTime), so the
codec lives here in `common` — imported by both sides — rather than in
the server package.
"""
from __future__ import annotations

import json

from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext

_fp = try_load_host_ext("fastpath")


def nym_to_state_key(nym: str) -> bytes:
    return nym.encode()


def encode_state_value(value: dict, seq_no, txn_time) -> bytes:
    payload = {"val": value, "lsn": seq_no, "lut": txn_time}
    if _fp is not None:
        try:
            return _fp.canonical_json_ascii(payload)
        except TypeError:
            pass
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def decode_state_value(data: bytes):
    if data is None:
        return None, None, None
    parsed = json.loads(bytes(data).decode())
    return parsed.get("val"), parsed.get("lsn"), parsed.get("lut")
