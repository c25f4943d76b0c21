"""Protocol constants (reference: plenum/common/constants.py — ledger ids,
txn types, roles, field keys)."""

# --- Ledger ids (reference constants.py POOL_LEDGER_ID..AUDIT_LEDGER_ID;
# ordering of catchup follows docs/source/catchup.md: audit first)
POOL_LEDGER_ID = 0
DOMAIN_LEDGER_ID = 1
CONFIG_LEDGER_ID = 2
AUDIT_LEDGER_ID = 3

VALID_LEDGER_IDS = (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
                    AUDIT_LEDGER_ID)

# --- Transaction types (numeric strings on the wire, as in the reference)
NODE = "0"
NYM = "1"
AUDIT_TXN = "2"
GET_TXN = "3"
TXN_AUTHOR_AGREEMENT = "4"
TXN_AUTHOR_AGREEMENT_AML = "5"
GET_TXN_AUTHOR_AGREEMENT = "6"
GET_TXN_AUTHOR_AGREEMENT_AML = "7"
TXN_AUTHOR_AGREEMENT_DISABLE = "8"
LEDGERS_FREEZE = "9"
GET_FROZEN_LEDGERS = "10"

# --- Roles
TRUSTEE = "0"
STEWARD = "2"
IDENTITY_OWNER = None  # a NYM with no role

# --- Node services
VALIDATOR = "VALIDATOR"
OBSERVER = "OBSERVER"

# --- Common field keys (wire names kept for parity with the reference)
TXN_TYPE = "type"
TXN_TIME = "txnTime"
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

IDENTIFIER = "identifier"
REQ_ID = "reqId"
OPERATION = "operation"
SIGNATURE = "signature"
SIGNATURES = "signatures"
DIGEST = "digest"
PROTOCOL_VERSION = "protocolVersion"
CURRENT_PROTOCOL_VERSION = 2
TAA_ACCEPTANCE = "taaAcceptance"
TAA_ACCEPTANCE_DIGEST = "taaDigest"
TAA_ACCEPTANCE_MECHANISM = "mechanism"
TAA_ACCEPTANCE_TIME = "time"

# --- TAA txn payload fields (reference plenum/common/constants.py:197-208)
TXN_AUTHOR_AGREEMENT_TEXT = "text"
TXN_AUTHOR_AGREEMENT_VERSION = "version"
TXN_AUTHOR_AGREEMENT_DIGEST = "digest"
TXN_AUTHOR_AGREEMENT_RETIREMENT_TS = "retirement_ts"
TXN_AUTHOR_AGREEMENT_RATIFICATION_TS = "ratification_ts"
AML_VERSION = "version"
AML = "aml"
AML_CONTEXT = "amlContext"

TARGET_NYM = "dest"
VERKEY = "verkey"
ROLE = "role"
ALIAS = "alias"
DATA = "data"
TXN_ID = "txnId"

NODE_IP = "node_ip"
NODE_PORT = "node_port"
CLIENT_IP = "client_ip"
CLIENT_PORT = "client_port"
SERVICES = "services"
BLS_KEY = "blskey"
BLS_KEY_PROOF = "blskey_pop"

# state-proof reply keys (reference plenum/common/constants.py:128-141)
STATE_PROOF = "state_proof"
ROOT_HASH = "root_hash"
PROOF_NODES = "proof_nodes"
MULTI_SIGNATURE = "multi_signature"

# --- Audit txn fields (reference plenum/common/constants.py AUDIT_TXN_*)
AUDIT_TXN_VIEW_NO = "viewNo"
AUDIT_TXN_PP_SEQ_NO = "ppSeqNo"
AUDIT_TXN_LEDGERS_SIZE = "ledgerSize"
AUDIT_TXN_LEDGER_ROOT = "ledgerRoot"
AUDIT_TXN_STATE_ROOT = "stateRoot"
AUDIT_TXN_PRIMARIES = "primaries"
AUDIT_TXN_DIGEST = "digest"
AUDIT_TXN_NODE_REG = "nodeReg"

# --- TAA state keys
TAA_LATEST = "taa:latest"
TAA_VERSION_PREFIX = "taa:v"
TAA_DIGEST_PREFIX = "taa:d"
TAA_AML_LATEST = "taa:aml:latest"
TAA_AML_VERSION_PREFIX = "taa:aml:v"

# --- Frozen ledgers state key
FROZEN_LEDGERS = "frozen_ledgers"

# --- Mode of a node (reference plenum/common/startable.py Mode)
class Mode:
    starting = 100
    discovering = 200    # catching up pool txns
    discovered = 300
    syncing = 400        # catching up other ledgers
    synced = 450
    participating = 500

    @classmethod
    def is_done_discovering(cls, mode):
        return mode is not None and mode >= cls.discovered

    @classmethod
    def is_done_syncing(cls, mode):
        return mode is not None and mode >= cls.synced


# --- Stack auth modes
class AuthMode:
    ALLOW_ANY = 1
    RESTRICTED = 2


# --- Misc protocol constants
BATCH = "BATCH"
OP_FIELD_NAME = "op"
PLUGIN_FIELDS = "plugin_fields"
GENERAL_LIMIT_SIZE = 256

# seed/key sizes
SEED_SIZE = 32
ED25519_SIG_SIZE = 64
ED25519_PK_SIZE = 32

LAST_SENT_PRE_PREPARE = "lastSentPrePrepare"
