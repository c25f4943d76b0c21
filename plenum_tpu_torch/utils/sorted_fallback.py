"""A stdlib SortedList on `bisect`: the one `sortedcontainers` type the
port uses (runtime/stashing_router.py's SortedStash), with the small API
it exercises (add/pop/len/iter and a key function). O(n) inserts are
acceptable at the sizes involved: stash replay queues."""
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
