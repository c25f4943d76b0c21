"""KeyValueStorage ABC (reference: storage/kv_store.py:5).

get/put/remove/batch/iterator/drop/close. Keys and values are bytes on disk;
str convenience encodes utf-8. Iteration is sorted by key (needed by
int-keyed stores and catchup range scans).
"""
from abc import ABC, abstractmethod
from typing import Iterable, Iterator, Tuple


def to_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode('utf-8')
    if isinstance(v, int):
        return str(v).encode('utf-8')
    raise TypeError("cannot coerce {} to bytes".format(type(v)))


class KeyValueStorage(ABC):
    @abstractmethod
    def put(self, key, value) -> None:
        ...

    @abstractmethod
    def get(self, key) -> bytes:
        """Raises KeyError if absent."""

    def get_or_none(self, key):
        """get() without the exception cost on misses — the dedup
        index probes EVERY incoming request and nearly always misses;
        impls override with a native miss path."""
        try:
            return self.get(key)
        except KeyError:
            return None

    @abstractmethod
    def remove(self, key) -> None:
        ...

    @abstractmethod
    def setBatch(self, batch: Iterable[Tuple]) -> None:
        ...

    @abstractmethod
    def do_ops_in_batch(self, batch: Iterable[Tuple]) -> None:
        """batch of (op, key, value) with op in {'put','remove'}."""

    @abstractmethod
    def iterator(self, start=None, end=None, include_value=True) -> Iterator:
        ...

    @abstractmethod
    def drop(self) -> None:
        ...

    @abstractmethod
    def close(self) -> None:
        ...

    @property
    @abstractmethod
    def closed(self) -> bool:
        ...

    @property
    @abstractmethod
    def size(self) -> int:
        ...

    def has_key(self, key) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def __contains__(self, key):
        return self.has_key(key)

    def get_equal_or_none(self, key, default=None):
        try:
            return self.get(key)
        except KeyError:
            return default

