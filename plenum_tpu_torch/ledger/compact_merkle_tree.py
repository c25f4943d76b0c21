"""Append-only Certificate-Transparency-style merkle tree with O(log n)
frontier state, inclusion & consistency proofs.

Reference: ledger/compact_merkle_tree.py:13 — same capabilities, new design:
full aligned subtrees are persisted by (start, height) in the HashStore, so
`merkle_tree_hash(start, end)` resolves any range in O(log² n) lookups and
the RFC 6962 proof algorithms (§2.1.1/§2.1.2) read straight from storage.
Bulk builds and extends hash their leaves and levels through the
TreeHasher device seam. An attached device engine (ops/merkle.py,
DeviceMerkleTree) serves proof batches of proof_min or more and advances
with bulk extends; a failing device call raises, there is no step down to
the host memo path.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np

from plenum_tpu_torch.common.config import Config as _Config
from plenum_tpu_torch.ledger.hash_store import HashStore, MemoryHashStore, NullHashStore
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher, _largest_pow2_lt


def _array_to_digest_list(arr: 'np.ndarray') -> List[bytes]:
    """[B, 32] u8 → 32-byte bytes objects via ONE flat copy (hash-store
    writes are the only consumer that still needs bytes)."""
    flat = np.ascontiguousarray(arr, dtype=np.uint8).tobytes()
    return [flat[i:i + 32] for i in range(0, len(flat), 32)]


class CompactMerkleTree:
    # batches at/above this go level-wise instead of scalar frontier
    # merges (extend), and advance an attached device engine
    BULK_MIN = 1024
    # proof batches below this stay on the host memo path, which wins for
    # small batches (per-batch device latency is the floor). The class
    # defaults come from Config; attach_device_engine takes a node's own.
    _device_proof_min = _Config.MERKLE_DEVICE_PROOF_MIN
    _device_proof_chunk = _Config.MERKLE_DEVICE_PROOF_CHUNK
    _device_pipeline_depth = _Config.MERKLE_DEVICE_PIPELINE_DEPTH
    _device_engine = None

    def __init__(self, hasher: TreeHasher = None,
                 hash_store: HashStore = None):
        self.hasher = hasher or TreeHasher()
        self.hash_store = hash_store if hash_store is not None \
            else MemoryHashStore()
        self._size = 0
        # frontier: maximal full subtrees, descending height,
        # entries (start, height, hash)
        self._frontier: List[Tuple[int, int, bytes]] = []
        # (size, root) — valid while _size matches (appends change _size;
        # reset/load/copy set _size too, so size is the full invalidator)
        self._root_cache: Optional[Tuple[int, bytes]] = None

    # ------------------------------------------------------------ state

    @property
    def tree_size(self) -> int:
        return self._size

    def __len__(self):
        return self._size

    @property
    def hashes(self) -> Tuple[bytes, ...]:
        return tuple(h for _, _, h in self._frontier)

    @property
    def root_hash(self) -> bytes:
        # cached by size: callers re-read the root several times per
        # batch (executor roots, audit txns, state checks) and each
        # recompute is O(log n) hashes
        cached = self._root_cache
        if cached is not None and cached[0] == self._size:
            return cached[1]
        if not self._frontier:
            root = self.hasher.hash_empty()
        else:
            root = self._frontier[-1][2]
            for _, _, h in reversed(self._frontier[:-1]):
                root = self.hasher.hash_children(h, root)
        self._root_cache = (self._size, root)
        return root

    @property
    def root_hash_hex(self) -> str:
        return self.root_hash.hex()

    # ---------------------------------------------------------- appends

    def append(self, new_leaf: bytes) -> List[bytes]:
        """Append a raw leaf entry; returns the audit path of the appended
        leaf in the resulting tree (the pre-merge frontier, smallest subtree
        first) — same contract as the reference's append."""
        return self._append_hash(self.hasher.hash_leaf(new_leaf))

    def _append_hash(self, leaf_hash: bytes,
                     want_path: bool = True) -> List[bytes]:
        # the audit-path copy is skipped on the commit hot path
        # (want_path=False): building a frontier snapshot per txn cost
        # ~12 us x every committed txn and nearly every caller drops it
        audit_path = [h for _, _, h in reversed(self._frontier)] \
            if want_path else []
        index = self._size
        self.hash_store.write_leaf(index, leaf_hash)
        entry = (index, 0, leaf_hash)
        frontier = self._frontier
        hash_children = self.hasher.hash_children
        write_subtree = self.hash_store.write_subtree
        while frontier and frontier[-1][1] == entry[1]:
            s, h, left = frontier.pop()
            merged = hash_children(left, entry[2])
            entry = (s, h + 1, merged)
            write_subtree(s, h + 1, merged)
        frontier.append(entry)
        self._size += 1
        return audit_path

    def extend(self, new_leaves: Sequence[bytes]):
        """Batched append: leaf hashing goes through the device seam;
        large batches additionally hash interior nodes in batches — from
        empty (_bulk_build, all levels in one seam call) OR onto an
        existing tree (_bulk_extend, one seam dispatch per level): ~2n
        hashes instead of n scalar frontier merges."""
        self.extend_hashes(self.hasher.hash_leaves(list(new_leaves)))

    def extend_hashes(self, leaf_hashes: List[bytes]):
        """Append precomputed RFC 6962 leaf digests (same routing as
        extend, for callers that already hold the hashes)."""
        if len(leaf_hashes) >= self.BULK_MIN:
            if self._size == 0:
                self._bulk_build(leaf_hashes)
                eng = self._device_engine
                if eng is not None and eng.tree_size == 0:
                    # keep the engine warm through the big growth event
                    # (recovery, catchup): one build now, so a later proof
                    # batch only syncs the scalar appends after it
                    eng.build_from_leaf_hashes(leaf_hashes)
            else:
                self._bulk_extend(leaf_hashes)
            return
        for leaf_hash in leaf_hashes:
            self._append_hash(leaf_hash, want_path=False)

    def _bulk_build(self, leaf_hashes: List[bytes]):
        """Construct the whole tree from scratch: every level above the
        leaves in ONE hash_node_levels_array call (on the device backend,
        one upload and one copy back), then every full aligned subtree
        persisted exactly as the incremental path would (same hash store
        contents, same frontier)."""
        assert self._size == 0
        n = len(leaf_hashes)
        for i, h in enumerate(leaf_hashes):
            self.hash_store.write_leaf(i, h)
        depth = max(n.bit_length() - 1, 0)     # level `depth` holds one node
        levels = []
        if depth:
            leaves = np.frombuffer(b"".join(leaf_hashes),
                                   dtype=np.uint8).reshape(n, 32)
            levels = self.hasher.hash_node_levels_array(leaves, depth)
        frontier_rev: List[Tuple[int, int, bytes]] = []
        level = leaf_hashes
        for height in range(depth + 1):
            if height:
                level = _array_to_digest_list(levels[height - 1])
                for i, h in enumerate(level):
                    self.hash_store.write_subtree(i << height, height, h)
            if len(level) % 2 == 1:
                # the odd tail (at the top, the lone root of
                # [0, 2^depth)) has no parent: a frontier entry
                frontier_rev.append(((len(level) - 1) << height, height,
                                     level[-1]))
        self._frontier = [entry for entry in reversed(frontier_rev)]
        self._size = n

    def _hash_level_pairs(self, children: List[bytes]) -> List[bytes]:
        """Pair-hash one level: children[2i], children[2i+1] → parent i.
        Large levels go through the ARRAY seam — one flat join + one
        dispatch of one level, skipping the ~n per-pair tuple/message
        objects the list seam would build (the digests here are
        immediately re-consumed by the next level and the hash store)."""
        m = len(children) // 2
        hasher = self.hasher
        if m >= getattr(hasher, "_batch_threshold", 1 << 62) \
                and hasattr(hasher, "hash_node_levels_array"):
            arr = np.frombuffer(b"".join(children[:2 * m]),
                                dtype=np.uint8).reshape(2 * m, 32)
            return _array_to_digest_list(
                hasher.hash_node_levels_array(arr, 1)[0])
        return hasher.hash_node_pairs(
            [(children[i], children[i + 1]) for i in range(0, 2 * m, 2)])

    def _bulk_extend(self, leaf_hashes: List[bytes]):
        """Level-wise batched append onto a NON-empty tree: the same
        ~2n node hashes the scalar frontier merges would compute, one
        seam dispatch per level (or the attached device engine's
        incremental append), with identical hash-store contents and
        frontier. At height h the only pre-existing child a new parent
        can need is the old frontier entry at h (the odd tail node)."""
        old_n = self._size
        new_n = old_n + len(leaf_hashes)
        write_leaf = self.hash_store.write_leaf
        for i, h in enumerate(leaf_hashes):
            write_leaf(old_n + i, h)
        write_subtree = self.hash_store.write_subtree
        fr = {height: value for _, height, value in self._frontier}
        new_levels = {0: leaf_hashes}
        eng = self._device_engine
        if eng is not None and eng.tree_size == old_n:
            # the device-resident append: ~2b hashes in 1 + ceil(levels /
            # K) dispatches; the new complete nodes come back as arrays
            # and are persisted at the same (start, height) keys
            nodes = eng.append_leaf_hashes(
                np.frombuffer(b"".join(leaf_hashes), dtype=np.uint8)
                .reshape(-1, 32), return_nodes=True)
            for height, pos, rows in nodes:
                if height == 0:
                    continue  # leaves were written above
                vals = _array_to_digest_list(rows)
                for i, v in enumerate(vals):
                    write_subtree((pos + i) << height, height, v)
                new_levels[height] = vals
        else:
            level_vals = leaf_hashes
            h = 0
            while True:
                o1, c1 = old_n >> (h + 1), new_n >> (h + 1)
                if c1 == o1:
                    break
                children = ([fr[h]] if (old_n >> h) & 1 else []) \
                    + level_vals
                parents = self._hash_level_pairs(children[:2 * (c1 - o1)])
                for i, ph in enumerate(parents):
                    write_subtree((o1 + i) << (h + 1), h + 1, ph)
                new_levels[h + 1] = parents
                level_vals = parents
                h += 1
        frontier = []
        for height in range(new_n.bit_length() - 1, -1, -1):
            if not (new_n >> height) & 1:
                continue
            idx = (new_n >> height) - 1
            if idx < (old_n >> height):
                value = fr[height]
            else:
                value = new_levels[height][idx - (old_n >> height)]
            frontier.append((idx << height, height, value))
        self._frontier = frontier
        self._size = new_n

    # ------------------------------------------- device proof engine

    def attach_device_engine(self, engine=None, proof_min: int = None,
                             chunk: int = None, pipeline_depth: int = None,
                             fused_levels: int = None, warm: bool = False,
                             device=None):
        """Route large inclusion-proof batches and large extends through a
        device-resident tree (ops/merkle.DeviceMerkleTree on `device`,
        None meaning CUDA; `fused_levels` its levels per append launch).
        Batches below `proof_min` keep the host memo path; the engine
        catches up lazily from the hash store, so scalar appends stay
        O(1). warm=True syncs a non-empty tree now, keeping the one-time
        build off the first serving call. A node passes its own config's
        values for all of these."""
        if engine is None:
            from plenum_tpu_torch.ops.merkle import DeviceMerkleTree
            engine = DeviceMerkleTree(self.hasher, device=device,
                                      fused_levels=fused_levels)
        self._device_engine = engine
        if proof_min is not None:
            self._device_proof_min = proof_min
        if chunk is not None:
            self._device_proof_chunk = chunk
        if pipeline_depth is not None:
            self._device_pipeline_depth = pipeline_depth
        if warm and self._size and not isinstance(self.hash_store,
                                                  NullHashStore):
            self._device_sync()
        return engine

    def _device_sync(self):
        """Catch the attached engine up to the committed tree by appending
        the missing leaf digests from the hash store: complete RFC 6962
        nodes are immutable, so catch-up after b scalar appends costs ~2b
        device hashes, never a rebuild (a first sync builds)."""
        eng = self._device_engine
        if eng.tree_size > self._size:
            eng.reset()  # the host tree was reset/reloaded under us
        if eng.tree_size < self._size:
            missing = self.hash_store.read_leaves(eng.tree_size,
                                                  self._size)
            if eng.tree_size == 0:
                eng.build_from_leaf_hashes(missing)
            else:
                eng.append_leaf_hashes(missing)

    def _device_proofs_batch(self, ms, n: int) -> Optional[List[List[bytes]]]:
        """Serve a proof batch of proof_min or more from the device engine
        (synced first, then ProofPipeline in the configured chunks and
        depth), or None for the host memo path (no engine, a small batch,
        no hash store to sync from)."""
        if (self._device_engine is None
                or len(ms) < self._device_proof_min
                or isinstance(self.hash_store, NullHashStore)
                or self.hash_store.leaf_count < self._size):
            return None
        from plenum_tpu_torch.ops.merkle import ProofPipeline
        self._device_sync()
        return ProofPipeline(self._device_engine,
                             depth=self._device_pipeline_depth,
                             chunk=self._device_proof_chunk).run(ms, n=n)

    def __copy__(self):
        other = CompactMerkleTree(self.hasher, NullHashStore())
        other._size = self._size
        other._frontier = list(self._frontier)
        return other

    def copy_shadow(self) -> 'CompactMerkleTree':
        """A root-only copy for uncommitted staging (no proof support)."""
        return self.__copy__()

    # ------------------------------------------------------ range hashes

    def merkle_tree_hash(self, start: int, end: int) -> bytes:
        """MTH over leaves [start, end) (0-based, end exclusive)."""
        if not 0 <= start <= end <= self._size:
            raise IndexError("{}..{} outside tree of size {}"
                             .format(start, end, self._size))
        return self._mth(start, end)

    def _mth(self, start: int, end: int) -> bytes:
        width = end - start
        if width == 0:
            return self.hasher.hash_empty()
        if width == 1:
            return self.hash_store.read_leaf(start)
        # full aligned subtree? look it up
        if width & (width - 1) == 0 and start % width == 0:
            h = width.bit_length() - 1
            stored = self.hash_store.read_subtree(start, h)
            if stored is not None:
                return stored
        k = _largest_pow2_lt(width)
        return self.hasher.hash_children(self._mth(start, start + k),
                                         self._mth(start + k, end))

    # ----------------------------------------------------------- proofs

    def inclusion_proof(self, m: int, n: int) -> List[bytes]:
        """Audit path for leaf index m in the size-n prefix tree
        (RFC 6962 §2.1.1 PATH(m, D[0:n]))."""
        if not 0 <= m < n <= self._size:
            raise IndexError("invalid inclusion proof request ({}, {}) "
                             "for size {}".format(m, n, self._size))
        return self._path(m, 0, n)

    def _path(self, m: int, start: int, end: int) -> List[bytes]:
        n = end - start
        if n <= 1:
            return []
        k = _largest_pow2_lt(n)
        if m - start < k:
            return self._path(m, start, start + k) + [self._mth(start + k, end)]
        return self._path(m, start + k, end) + [self._mth(start, start + k)]

    def inclusion_proofs_batch(self, ms, n: int) -> List[List[bytes]]:
        """Audit paths for MANY leaves of the same size-n prefix with a
        shared subtree-hash memo. A committed batch's replies all prove
        against the same tree, and contiguous leaves share nearly every
        upper node — the memo collapses per-proof cost to the few
        bottom siblings unique to each leaf (the per-reply
        inclusion_proof was a top-3 cost on the ordering money path)."""
        if not ms:
            return []
        if not (0 <= min(ms) and max(ms) < n <= self._size):
            raise IndexError("invalid inclusion proof batch ({}, {}) "
                             "for size {}".format(min(ms), n, self._size))
        device = self._device_proofs_batch(ms, n)
        if device is not None:
            return device
        memo = {}
        hash_children = self.hasher.hash_children
        read_leaf = self.hash_store.read_leaf
        read_subtree = self.hash_store.read_subtree

        def mth(start, end):
            key = (start, end)
            h = memo.get(key)
            if h is not None:
                return h
            width = end - start
            if width == 1:
                h = read_leaf(start)
            else:
                h = None
                if width & (width - 1) == 0 and start % width == 0:
                    h = read_subtree(start, width.bit_length() - 1)
                if h is None:
                    k = _largest_pow2_lt(width)
                    h = hash_children(mth(start, start + k),
                                      mth(start + k, end))
            memo[key] = h
            return h

        out = []
        for m in ms:
            path = []
            start, end = 0, n
            while end - start > 1:
                k = _largest_pow2_lt(end - start)
                if m - start < k:
                    path.append(mth(start + k, end))
                    end = start + k
                else:
                    path.append(mth(start, start + k))
                    start = start + k
            path.reverse()
            out.append(path)
        return out

    def consistency_proof(self, first: int, second: int) -> List[bytes]:
        """PROOF(m, D[0:n]) (RFC 6962 §2.1.2) that size-`first` tree is a
        prefix of the size-`second` tree."""
        if not 0 < first <= second <= self._size:
            raise IndexError("invalid consistency proof request ({}, {}) "
                             "for size {}".format(first, second, self._size))
        return self._subproof(first, 0, second, True)

    def _subproof(self, m: int, start: int, end: int, complete: bool) -> List[bytes]:
        n = end - start
        if m == n:
            return [] if complete else [self._mth(start, end)]
        k = _largest_pow2_lt(n)
        if m <= k:
            return self._subproof(m, start, start + k, complete) + \
                [self._mth(start + k, end)]
        return self._subproof(m - k, start + k, end, False) + \
            [self._mth(start, start + k)]

    # --------------------------------------------------------- recovery

    def load_from_hash_store(self, tree_size: int):
        """Rebuild the frontier for `tree_size` from persisted subtree
        hashes (reference recoverTreeFromHashStore)."""
        self._frontier = []
        self._size = tree_size
        self._root_cache = None  # content replaced wholesale
        start = 0
        remaining = tree_size
        while remaining > 0:
            h = remaining.bit_length() - 1
            width = 1 << h
            if h == 0:
                node = self.hash_store.read_leaf(start)
            else:
                node = self.hash_store.read_subtree(start, h)
                if node is None:
                    raise ValueError("hash store missing subtree ({}, {})"
                                     .format(start, h))
            self._frontier.append((start, h, node))
            start += width
            remaining -= width

    def verify_consistency(self, expected_leaf_count: int) -> bool:
        return self.hash_store.leaf_count >= expected_leaf_count

    def reset(self):
        self._size = 0
        self._frontier = []
        self._root_cache = None  # size alone can't invalidate a shrink
        if self._device_engine is not None:
            self._device_engine.reset()
        self.hash_store.reset()

    def __repr__(self):
        return "CompactMerkleTree(size={}, root={})".format(
            self._size, self.root_hash.hex()[:16])
