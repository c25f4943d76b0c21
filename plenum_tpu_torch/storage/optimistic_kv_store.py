"""Uncommitted-batch staging over a KV store (reference:
storage/optimistic_kv_store.py). Writes accumulate per batch; commit flushes
the oldest batch to the underlying store; reject discards the newest."""
from collections import deque
from typing import Dict, List

from plenum_tpu_torch.storage.kv_store import KeyValueStorage, to_bytes


class OptimisticKVStore:
    def __init__(self, store: KeyValueStorage):
        self._store = store
        self._batches = deque()        # deque of dict key->value|None
        self._current: Dict[bytes, bytes] = {}

    def set(self, key, value):
        self._current[to_bytes(key)] = to_bytes(value)

    def remove(self, key):
        self._current[to_bytes(key)] = None

    def get(self, key, is_committed: bool = False) -> bytes:
        key = to_bytes(key)
        if not is_committed:
            if key in self._current:
                val = self._current[key]
                if val is None:
                    raise KeyError(key)
                return val
            for batch in reversed(self._batches):
                if key in batch:
                    val = batch[key]
                    if val is None:
                        raise KeyError(key)
                    return val
        return self._store.get(key)

    def create_batch_from_current(self, state_root=None):
        self._batches.append(self._current)
        self._current = {}

    def first_batch_idr(self):
        return 0 if self._batches else None

    def commit_batch(self):
        if not self._batches:
            raise ValueError("no uncommitted batch")
        batch = self._batches.popleft()
        ops = [('put', k, v) if v is not None else ('remove', k)
               for k, v in batch.items()]
        self._store.do_ops_in_batch(ops)

    def reject_batch(self):
        if self._current:
            self._current = {}
        elif self._batches:
            self._batches.pop()

    @property
    def un_committed_count(self):
        return len(self._batches) + (1 if self._current else 0)
