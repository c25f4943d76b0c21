"""Timestamp → state-root index: state-at-a-time for reads/proofs.

Reference: storage/state_ts_store.py (StateTsDbStorage — set /
get_equal_or_prev per ledger). Keys are (ledger_id, timestamp) packed
big-endian so KV range iteration is chronological; an in-memory sorted
cache gives O(log n) get_equal_or_prev while the KV store provides
durability (cache is rebuilt from the store on restart).
"""
from __future__ import annotations

import struct
from bisect import bisect_right, insort
from typing import Dict, List, Optional

from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID

_KEY = struct.Struct(">BQ")


class StateTsStore:
    def __init__(self, storage):
        self._storage = storage
        self._ts_cache: Dict[int, List[int]] = {}
        for key, _ in storage.iterator():
            if len(key) != _KEY.size:
                continue
            lid, ts = _KEY.unpack(key)
            insort(self._ts_cache.setdefault(lid, []), ts)

    def set(self, timestamp: int, root_hash: bytes,
            ledger_id: int = DOMAIN_LEDGER_ID):
        timestamp = int(timestamp)
        self._storage.put(_KEY.pack(ledger_id, timestamp), root_hash)
        cache = self._ts_cache.setdefault(ledger_id, [])
        idx = bisect_right(cache, timestamp)
        if idx == 0 or cache[idx - 1] != timestamp:
            cache.insert(idx, timestamp)

    def get(self, timestamp: int,
            ledger_id: int = DOMAIN_LEDGER_ID) -> Optional[bytes]:
        try:
            return self._storage.get(_KEY.pack(ledger_id, int(timestamp)))
        except KeyError:
            return None

    def get_equal_or_prev(self, timestamp: int,
                          ledger_id: int = DOMAIN_LEDGER_ID
                          ) -> Optional[bytes]:
        """Root hash at the latest point not after `timestamp`."""
        cache = self._ts_cache.get(ledger_id)
        if not cache:
            return None
        idx = bisect_right(cache, int(timestamp))
        if idx == 0:
            return None
        return self.get(cache[idx - 1], ledger_id)

    def get_last_ts(self, ledger_id: int = DOMAIN_LEDGER_ID
                    ) -> Optional[int]:
        cache = self._ts_cache.get(ledger_id)
        return cache[-1] if cache else None

    def close(self):
        self._storage.close()
