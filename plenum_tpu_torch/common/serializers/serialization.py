"""Serializer registry: which codec each subsystem uses (reference:
common/serializers/serialization.py:9-23)."""
from plenum_tpu_torch.common.serializers.serializers import (
    MsgPackSerializer, OrderedJsonSerializer, Base58Serializer,
    Base64Serializer, SigningSerializer)

ledger_txn_serializer = MsgPackSerializer()        # txn log entries
ledger_hash_serializer = MsgPackSerializer()       # tree hash store values
client_req_rep_serializer = OrderedJsonSerializer()
domain_state_serializer = OrderedJsonSerializer()  # MPT values, domain
pool_state_serializer = OrderedJsonSerializer()
config_state_serializer = OrderedJsonSerializer()
node_status_db_serializer = OrderedJsonSerializer()
instance_change_db_serializer = OrderedJsonSerializer()
multi_sig_store_serializer = OrderedJsonSerializer()
state_roots_serializer = Base58Serializer()        # roots on the wire
proof_nodes_serializer = Base64Serializer()        # MPT proof nodes
txn_root_serializer = Base58Serializer()

_signing_serializer = SigningSerializer()


def serialize_msg_for_signing(msg, topLevelKeysToIgnore=None) -> bytes:
    """Canonical bytes whose ed25519 signature all nodes agree on
    (reference serialization.py:27)."""
    return _signing_serializer.serialize(
        msg, topLevelKeysToIgnore=topLevelKeysToIgnore)
