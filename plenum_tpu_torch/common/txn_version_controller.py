"""Transaction payload version control.

Reference: plenum/server/txn_version_controller.py — the base plenum
controller is deliberately minimal (pool version is None; downstream
ledgers like indy-node override it to gate request validation rules on
the pool's upgraded version). Same seam here: WriteRequestManager holds
one and handlers may consult `get_txn_version` when validation rules
differ across payload versions.
"""
from typing import Optional

from plenum_tpu_torch.common.constants import TXN_PAYLOAD, TXN_PAYLOAD_PROTOCOL_VERSION


class TxnVersionController:
    @property
    def version(self) -> Optional[str]:
        return None

    def update_version(self, txn: dict) -> None:
        """Called per committed txn; the base controller tracks nothing."""

    def get_txn_version(self, txn: dict) -> str:
        version = (txn.get(TXN_PAYLOAD) or {}).get(
            TXN_PAYLOAD_PROTOCOL_VERSION)
        return "1" if version is None else str(version)

    def get_pool_version(self, timestamp) -> Optional[str]:
        return None
