"""TxnPoolManager — pool-ledger-driven live membership.

Reference: plenum/server/pool_manager.py:440 (TxnPoolManager: node
add/demote through NODE txns reconfigures the running pool) and
plenum/server/node.py:1260 (adjustReplicas: instance count follows f).

Committed NODE txns are the single source of truth for membership: every
node replays the same pool ledger, so every node derives the same
validator list (ctor seed + ledger order) and the same quorums. Applying
a change touches: every protocol instance's shared data (validators +
Quorums), the primary selectors (future views only — the CURRENT
primary never silently moves, matching the reference's view-stable
primaries), the Replicas collection (f+1 instances), the Propagator's
quorum, and — when the node runs a real transport — the connection set
via the owner's callback.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from plenum_tpu_torch.common.constants import (
    ALIAS, DATA, NODE, POOL_LEDGER_ID, SERVICES, TARGET_NYM, VALIDATOR)
from plenum_tpu_torch.common.txn_util import get_payload_data, get_type

logger = logging.getLogger(__name__)


class TxnPoolManager:
    def __init__(self, initial_validators: List[str], db_manager,
                 on_change: Callable[[List[str]], None] = None):
        """on_change(new_validators) fires AFTER the validator list
        actually changed (never during construction/rescan — the owner
        reads .validators at build time instead)."""
        self._db = db_manager
        self._on_change = on_change or (lambda v: None)
        # alias order is consensus-critical (primary rotation indexes
        # into it): ctor seed order, then pool-ledger commit order
        self._order: List[str] = list(initial_validators)
        self.seed_aliases = frozenset(initial_validators)
        self._info: Dict[str, dict] = {
            alias: {SERVICES: [VALIDATOR]} for alias in initial_validators}
        self._rescan()

    # ---------------------------------------------------------- registry

    @property
    def validators(self) -> List[str]:
        return [alias for alias in self._order
                if VALIDATOR in self._info[alias].get(SERVICES, [])]

    def node_info(self, alias: str) -> Optional[dict]:
        return self._info.get(alias)

    def _rescan(self):
        """Replay all committed pool-ledger NODE txns (node start /
        restart; the ledger includes genesis)."""
        ledger = self._db.get_ledger(POOL_LEDGER_ID)
        if ledger is None:
            return
        for _, txn in ledger.getAllTxn():
            if get_type(txn) == NODE:
                self._apply_payload(get_payload_data(txn))

    def _apply_payload(self, payload: dict) -> bool:
        """Fold one NODE txn payload into the registry. → membership
        changed (validator added/removed)."""
        data = payload.get(DATA) or {}
        alias = data.get(ALIAS)
        if not alias:
            return False
        before = self.validators
        # a NODE txn that omits SERVICES must NOT default to validator —
        # only an explicit services grant changes membership (ctor-seeded
        # aliases keep their [VALIDATOR] default)
        info = self._info.setdefault(alias, {SERVICES: []})
        if alias not in self._order:
            self._order.append(alias)
        if TARGET_NYM in payload:
            info["dest"] = payload[TARGET_NYM]
        for key, value in data.items():
            if key != ALIAS:
                info[key] = value
        return self.validators != before

    # ------------------------------------------------------------- hooks

    def process_committed_txn(self, txn: dict):
        """Owner feeds every committed (or caught-up) pool-ledger txn."""
        if get_type(txn) != NODE:
            return
        if self._apply_payload(get_payload_data(txn)):
            logger.info("pool membership changed: validators=%s",
                        self.validators)
            self._on_change(self.validators)
