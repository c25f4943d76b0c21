"""Per-ledger freshness tracking: which ledgers have gone too long
without an ordered batch, so their signed state (BLS multi-sig over the
state root) is stale for state-proof readers.

Reference: plenum/server/replica_freshness_checker.py:10 (Freshness
:10, FreshnessChecker :23 — update_freshness / check_freshness with
oldest-first ordering). The primary turns stale ledgers into EMPTY 3PC
batches (ordering_service.send_3pc_batch), refreshing root signatures
without any client traffic.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class FreshnessChecker:
    def __init__(self, freshness_timeout: float):
        self.freshness_timeout = freshness_timeout
        self._last_updated: Dict[int, float] = {}

    def register_ledger(self, ledger_id: int, initial_time: float):
        self._last_updated.setdefault(ledger_id, initial_time)

    @property
    def ledger_ids(self) -> List[int]:
        return list(self._last_updated)

    def update_freshness(self, ledger_id: int, ts: float):
        if ledger_id in self._last_updated:
            self._last_updated[ledger_id] = max(
                self._last_updated[ledger_id], ts)

    def get_outdated(self, now: float) -> List[Tuple[int, float]]:
        """→ [(ledger_id, age_seconds)] past the timeout, stalest first."""
        out = [(lid, now - ts) for lid, ts in self._last_updated.items()
               if now - ts >= self.freshness_timeout]
        return sorted(out, key=lambda pair: -pair[1])

    def get_last_update(self, ledger_id: int) -> float:
        return self._last_updated[ledger_id]

    def reset_all(self, now: float):
        """Restart the staleness clocks — on resuming participation
        (catchup done, new view) the old timestamps reflect the node's
        own absence, not the primary's negligence."""
        for lid in self._last_updated:
            self._last_updated[lid] = max(self._last_updated[lid], now)
