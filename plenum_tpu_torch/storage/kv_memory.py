"""In-memory KV store (reference: storage/kv_in_memory.py).

Backed by a plain dict: put/get ride the per-trie-node hot path (every
MPT spine persist lands here), so writes must be O(1) C-dict ops.
Ordered range scans are only needed by catchup/recovery iterators, so
keys are sorted lazily per iterator() call instead of on every put.
"""
from typing import Iterable, Tuple

from plenum_tpu_torch.storage.kv_store import KeyValueStorage, to_bytes


class KeyValueStorageInMemory(KeyValueStorage):
    def __init__(self, *args, **kwargs):
        self._dict = {}
        self._closed = False

    def put(self, key, value):
        # hot path: trie-node persists pass bytes already — an exact
        # type check dodges two function calls per put
        self._dict[key if type(key) is bytes else to_bytes(key)] = \
            value if type(value) is bytes else to_bytes(value)

    def get(self, key) -> bytes:
        return self._dict[key if type(key) is bytes else to_bytes(key)]

    def get_or_none(self, key):
        return self._dict.get(key if type(key) is bytes else to_bytes(key))

    def remove(self, key):
        self._dict.pop(key if type(key) is bytes else to_bytes(key), None)

    def setBatch(self, batch: Iterable[Tuple]):
        for key, value in batch:
            self.put(key, value)

    def do_ops_in_batch(self, batch: Iterable[Tuple]):
        for op, key, *rest in batch:
            if op == 'put':
                self.put(key, rest[0])
            elif op == 'remove':
                self.remove(key)
            else:
                raise ValueError("unknown batch op {}".format(op))

    def iterator(self, start=None, end=None, include_value=True):
        start = to_bytes(start) if start is not None else None
        end = to_bytes(end) if end is not None else None
        keys = sorted(k for k in self._dict
                      if (start is None or k >= start)
                      and (end is None or k <= end))
        if include_value:
            return ((k, self._dict[k]) for k in keys)
        return iter(keys)

    def drop(self):
        self._dict.clear()

    def close(self):
        self._closed = True

    @property
    def closed(self):
        return self._closed

    @property
    def size(self):
        return len(self._dict)
