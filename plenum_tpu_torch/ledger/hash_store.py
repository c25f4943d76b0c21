"""Hash stores: leaf hashes by index + full-subtree hashes by (start, height).

Reference: ledger/hash_stores/hash_store.py (positions of leaves/nodes) —
re-designed here: instead of the reference's sequential node numbering, full
aligned subtrees are keyed directly by (start_leaf, height), which makes the
recursive range-hash/proof algorithms straight lookups.
"""
from abc import ABC, abstractmethod
from typing import Optional


class HashStore(ABC):
    @abstractmethod
    def write_leaf(self, index: int, leaf_hash: bytes) -> None:
        """index is 0-based."""

    @abstractmethod
    def read_leaf(self, index: int) -> bytes:
        ...

    def read_leaves(self, start: int, end: int) -> list:
        """Leaf hashes for indices [start, end) — bulk variant for the
        device-engine catch-up path; stores with cheap range access
        override the per-leaf loop."""
        read = self.read_leaf
        return [read(i) for i in range(start, end)]

    @abstractmethod
    def write_subtree(self, start: int, height: int, node_hash: bytes) -> None:
        ...

    @abstractmethod
    def read_subtree(self, start: int, height: int) -> Optional[bytes]:
        ...

    @property
    @abstractmethod
    def leaf_count(self) -> int:
        ...

    @abstractmethod
    def reset(self) -> None:
        ...

    def close(self):
        pass

    @property
    def is_persistent(self) -> bool:
        return False


class MemoryHashStore(HashStore):
    def __init__(self):
        self._leaves = []
        self._nodes = {}

    def write_leaf(self, index, leaf_hash):
        if index == len(self._leaves):
            self._leaves.append(leaf_hash)
        else:
            # overwrite during recovery replay
            self._leaves[index] = leaf_hash

    def read_leaf(self, index):
        return self._leaves[index]

    def read_leaves(self, start, end):
        return self._leaves[start:end]

    def write_subtree(self, start, height, node_hash):
        self._nodes[(start, height)] = node_hash

    def read_subtree(self, start, height):
        return self._nodes.get((start, height))

    @property
    def leaf_count(self):
        return len(self._leaves)

    def reset(self):
        self._leaves = []
        self._nodes = {}


class NullHashStore(HashStore):
    """Discards everything — used by shadow (uncommitted) tree copies that
    only need root computation, never proofs."""

    def __init__(self):
        self._leaf_count = 0

    def write_leaf(self, index, leaf_hash):
        self._leaf_count = max(self._leaf_count, index + 1)

    def read_leaf(self, index):
        raise KeyError("NullHashStore stores nothing")

    def write_subtree(self, start, height, node_hash):
        pass

    def read_subtree(self, start, height):
        return None

    @property
    def leaf_count(self):
        return self._leaf_count

    def reset(self):
        self._leaf_count = 0

