"""Protocol constants the port's write path uses (a copy of the names it
needs from plenum/common/constants.py, as the JAX package keeps them)."""

DOMAIN_LEDGER_ID = 1

# --- Transaction types (numeric strings on the wire, as in the reference)
NYM = "1"

# --- Transaction envelope field names (reference txn_util.py)
TXN_TYPE = "type"
TXN_PAYLOAD = "txn"
TXN_PAYLOAD_TYPE = "type"
TXN_PAYLOAD_DATA = "data"
TXN_PAYLOAD_METADATA = "metadata"
TXN_PAYLOAD_METADATA_FROM = "from"
TXN_PAYLOAD_METADATA_REQ_ID = "reqId"
TXN_PAYLOAD_METADATA_DIGEST = "digest"
TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST = "payloadDigest"
TXN_PAYLOAD_METADATA_TAA_ACCEPTANCE = "taaAcceptance"
TXN_PAYLOAD_METADATA_ENDORSER = "endorser"
TXN_PAYLOAD_PROTOCOL_VERSION = "protocolVersion"
TXN_METADATA = "txnMetadata"
TXN_METADATA_TIME = "txnTime"
TXN_METADATA_ID = "txnId"
TXN_METADATA_SEQ_NO = "seqNo"
TXN_SIGNATURE = "reqSignature"
TXN_VERSION = "ver"
TXN_SIGNATURE_TYPE = "type"
ED25519 = "ED25519"
TXN_SIGNATURE_VALUES = "values"
TXN_SIGNATURE_FROM = "from"
TXN_SIGNATURE_VALUE = "value"

# --- Request fields
IDENTIFIER = "identifier"
REQ_ID = "reqId"
OPERATION = "operation"
SIGNATURE = "signature"
SIGNATURES = "signatures"
CURRENT_PROTOCOL_VERSION = 2
TAA_ACCEPTANCE = "taaAcceptance"

# --- NYM fields
TARGET_NYM = "dest"
VERKEY = "verkey"
ROLE = "role"
