"""RFC 6962 domain-separated SHA-256 hashing for the merkle transaction log.

Reference: ledger/tree_hasher.py:7 — leaf hash H(0x00||data), node hash
H(0x01||left||right). THE hot hash path (SURVEY.md §2.6): the batch entry
points below are the device seam — `hash_leaves` / `hash_node_pairs` /
`hash_node_levels_array` route to the CUDA SHA-256 kernels
(plenum_tpu_torch.ops.sha256) above a configurable batch threshold, with
the C-backed hashlib loop as the scalar floor.
"""
import hashlib
from typing import List, Sequence, Tuple

import numpy as np


class TreeHasher:
    def __init__(self, hashfunc=hashlib.sha256, batch_backend=None,
                 batch_threshold: int = 256):
        self.hashfunc = hashfunc
        # batch_backend: object with leaf_hashes(list[bytes])->list[bytes]
        # and node_hashes(list[(l,r)])->list[bytes]; see ops/sha256.py
        self._batch_backend = batch_backend
        self._batch_threshold = batch_threshold

    def hash_empty(self) -> bytes:
        return self.hashfunc().digest()

    def hash_leaf(self, data: bytes) -> bytes:
        return self.hashfunc(b"\x00" + data).digest()

    def hash_children(self, left: bytes, right: bytes) -> bytes:
        return self.hashfunc(b"\x01" + left + right).digest()

    # ---- batch entry points (device seam) ----

    def hash_leaves(self, datas: Sequence[bytes]) -> List[bytes]:
        if (self._batch_backend is not None
                and len(datas) >= self._batch_threshold):
            return self._batch_backend.leaf_hashes(datas)
        return [self.hash_leaf(d) for d in datas]

    def hash_leaves_dispatch(self, datas: Sequence[bytes]):
        """Launch-only half of hash_leaves: above the device threshold
        the batch is padded and LAUNCHED without syncing the result, so
        the caller overlaps independent host work (the fused per-3PC-
        batch dispatch) before hash_leaves_collect. On the scalar floor
        the digests are computed eagerly and the handle just carries
        them — dispatch+collect is then exactly hash_leaves."""
        if (self._batch_backend is not None
                and len(datas) >= self._batch_threshold
                and hasattr(self._batch_backend, "leaf_hashes_dispatch")):
            return ("device", self._batch_backend.leaf_hashes_dispatch(
                datas))
        return ("host", [self.hash_leaf(d) for d in datas])

    def hash_leaves_collect(self, handle) -> List[bytes]:
        kind, payload = handle
        if kind == "device":
            return self._batch_backend.leaf_hashes_collect(payload)
        return payload

    def hash_node_pairs(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
        if (self._batch_backend is not None
                and len(pairs) >= self._batch_threshold):
            return self._batch_backend.node_hashes(pairs)
        return [self.hash_children(l, r) for l, r in pairs]

    def hash_node_pairs_array(self, pairs: 'np.ndarray') -> 'np.ndarray':
        """[m, 64] u8 rows (left||right digest bytes) → [m, 32] u8 node
        digests: the array sibling of hash_node_pairs for level-wise
        bulk paths whose output is immediately re-paired — skips the
        per-pair message objects and the per-digest bytes objects."""
        pairs = np.ascontiguousarray(pairs, dtype=np.uint8).reshape(-1, 64)
        m = pairs.shape[0]
        if (self._batch_backend is not None
                and m >= self._batch_threshold
                and hasattr(self._batch_backend, "node_hashes_array")):
            return self._batch_backend.node_hashes_array(pairs)
        out = np.empty((m, 32), dtype=np.uint8)
        hashfunc = self.hashfunc
        flat = pairs.tobytes()
        for i in range(m):
            out[i] = np.frombuffer(
                hashfunc(b"\x01" + flat[i * 64:(i + 1) * 64]).digest(),
                dtype=np.uint8)
        return out

    def hash_node_levels_array(self, level: 'np.ndarray',
                               levels: int) -> List['np.ndarray']:
        """[n, 32] u8 digests → the `levels` tree levels above them,
        [n >> k, 32] u8 each (parent i = H(0x01 || child 2i || child
        2i+1); an odd last child has no parent). When level 0 has at least
        the threshold's pairs and the backend builds levels, the whole
        chain is one backend call; otherwise level by level through
        hash_node_pairs_array (hashlib below the threshold)."""
        level = np.ascontiguousarray(level, dtype=np.uint8).reshape(-1, 32)
        if (self._batch_backend is not None
                and level.shape[0] // 2 >= self._batch_threshold
                and hasattr(self._batch_backend, "node_levels_array")):
            return self._batch_backend.node_levels_array(level, levels)
        out = []
        for _ in range(levels):
            m = level.shape[0] // 2
            level = self.hash_node_pairs_array(level[:2 * m].reshape(m, 64))
            out.append(level)
        return out

    # ---- whole-tree hashing (used by verifier and tests) ----

    def hash_full_tree(self, leaves: Sequence[bytes]) -> bytes:
        """MTH over a list of raw leaf entries (RFC 6962 §2.1)."""
        n = len(leaves)
        if n == 0:
            return self.hash_empty()
        if n == 1:
            return self.hash_leaf(leaves[0])
        k = _largest_pow2_lt(n)
        return self.hash_children(self.hash_full_tree(leaves[:k]),
                                  self.hash_full_tree(leaves[k:]))


def _largest_pow2_lt(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    return 1 << ((n - 1).bit_length() - 1)
