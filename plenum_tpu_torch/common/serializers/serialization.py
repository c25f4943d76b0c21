"""Serializer registry: which codec each subsystem uses (reference:
common/serializers/serialization.py:9-23; the port's write path needs the
ledger's txn codec and the signing serialization)."""
from plenum_tpu_torch.common.serializers.serializers import (
    MsgPackSerializer, SigningSerializer)

ledger_txn_serializer = MsgPackSerializer()        # txn log entries

_signing_serializer = SigningSerializer()


def serialize_msg_for_signing(msg, topLevelKeysToIgnore=None) -> bytes:
    """Canonical bytes whose ed25519 signature all nodes agree on
    (reference serialization.py:27)."""
    return _signing_serializer.serialize(
        msg, topLevelKeysToIgnore=topLevelKeysToIgnore)
