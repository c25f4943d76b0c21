"""Stdlib stand-ins on `bisect` for the three `sortedcontainers` types the
port uses: SortedList (runtime/stashing_router.py's SortedStash: add/pop/
len/iter and a key function), SortedDict (storage/kv_file.py's index:
key-ordered items and irange) and SortedSet (storage/kv_native.py's key
cache: add/discard/irange). O(n) inserts are acceptable at the sizes
involved: stash replay queues and KV iteration indexes."""
import bisect
from typing import Any, Callable, Iterable, Optional


class SortedList:
    """add / pop(0) / len / iter, with an optional key function —
    exactly what SortedStash needs."""

    def __init__(self, iterable: Iterable = (),
                 key: Optional[Callable] = None):
        self._key = key or (lambda x: x)
        self._keys = []
        self._items = []
        for item in iterable:
            self.add(item)

    def add(self, item: Any) -> None:
        k = self._key(item)
        idx = bisect.bisect_right(self._keys, k)
        self._keys.insert(idx, k)
        self._items.insert(idx, item)

    def pop(self, index: int = -1) -> Any:
        self._keys.pop(index)
        return self._items.pop(index)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)


class SortedSet:
    """add / discard / irange / membership over a sorted key list."""

    def __init__(self, iterable: Iterable = ()):
        self._keys = sorted(set(iterable))
        self._set = set(self._keys)

    def add(self, key: Any) -> None:
        if key not in self._set:
            self._set.add(key)
            bisect.insort(self._keys, key)

    def discard(self, key: Any) -> None:
        if key in self._set:
            self._set.remove(key)
            del self._keys[bisect.bisect_left(self._keys, key)]

    def irange(self, minimum=None, maximum=None):
        lo = 0 if minimum is None else bisect.bisect_left(self._keys, minimum)
        hi = len(self._keys) if maximum is None \
            else bisect.bisect_right(self._keys, maximum)
        return iter(self._keys[lo:hi])

    def __contains__(self, key: Any) -> bool:
        return key in self._set

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self):
        return iter(self._keys)


class SortedDict(dict):
    """dict with key-ordered iteration, items() and irange()."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sorted = sorted(super().keys())

    def __setitem__(self, key, value):
        if key not in self:
            bisect.insort(self._sorted, key)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        super().__delitem__(key)
        self._sorted.remove(key)

    def pop(self, key, *default):
        if key in self:
            self._sorted.remove(key)
        return super().pop(key, *default)

    def clear(self):
        super().clear()
        self._sorted = []

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
            return default
        return self[key]

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def irange(self, minimum=None, maximum=None):
        lo = 0 if minimum is None \
            else bisect.bisect_left(self._sorted, minimum)
        hi = len(self._sorted) if maximum is None \
            else bisect.bisect_right(self._sorted, maximum)
        return iter(self._sorted[lo:hi])

    def keys(self):
        return list(self._sorted)

    def items(self):
        return [(k, self[k]) for k in self._sorted]

    def values(self):
        return [self[k] for k in self._sorted]

    def __iter__(self):
        return iter(self._sorted)
