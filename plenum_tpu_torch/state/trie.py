"""Hexary Merkle Patricia Trie over a KV node store, with SPV proofs.

Reference: state/trie/pruning_trie.py:215 (Trie), proof machinery at
:58 (ProofConstructor) and :1105+ (produce/verify). Same capability,
fresh implementation: sha3-256 node hashing (hashlib.sha3_256, as in
state/util/utils.py:7), RLP node encoding, hex-prefix path encoding,
inline references for nodes < 32 bytes.

Node shapes (RLP lists):
  blank     : b''
  leaf      : [hp_encode(nibbles, terminal=True), value]
  extension : [hp_encode(nibbles, terminal=False), ref]
  branch    : [ref0 .. ref15, value]
A ref is the node itself (if its RLP is < 32 bytes) or its sha3 hash.
Nodes are persisted hash → rlp in the KV store; nothing is deleted on
update (history stays readable for old roots — what "pruning" defers to
compaction in the reference as well).
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from plenum_tpu_torch.state import rlp

BLANK_NODE = b""
BLANK_ROOT = hashlib.sha3_256(rlp.encode(b"")).digest()


def sha3(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


_HEXVAL = {c: int(c, 16) for c in "0123456789abcdef"}


def bytes_to_nibbles(key: bytes) -> List[int]:
    # bytes.hex() runs in C; one dict hit per nibble beats two shifts +
    # two appends per byte (this is the hottest pure-Python trie helper)
    return [_HEXVAL[c] for c in key.hex()]


def hp_encode(nibbles: Sequence[int], terminal: bool) -> bytes:
    """Hex-prefix encoding: flags nibble (terminal|odd) + packed nibbles."""
    flags = 2 if terminal else 0
    if len(nibbles) % 2 == 1:
        flags |= 1
        nibbles = [flags, *nibbles]
    else:
        nibbles = [flags, 0, *nibbles]
    return bytes((nibbles[i] << 4) | nibbles[i + 1]
                 for i in range(0, len(nibbles), 2))


def hp_decode(data: bytes) -> Tuple[List[int], bool]:
    nibbles = bytes_to_nibbles(data)
    flags = nibbles[0]
    terminal = bool(flags & 2)
    skip = 1 if flags & 1 else 2
    return nibbles[skip:], terminal


from plenum_tpu_torch.common.config import Config as _Config


class Trie:
    # single-sourced from Config (PT005): ONE place to tune the
    # decoded-node cache alongside the other STATE_* knobs
    _DECODE_CACHE_MAX = _Config.STATE_DECODE_CACHE_MAX

    def __init__(self, store, root_hash: Optional[bytes] = None):
        """store: KeyValueStorage-like (get/put raising KeyError on miss)."""
        self._store = store
        self.root_hash = root_hash if root_hash is not None else BLANK_ROOT
        # hash → decoded node. Nodes are content-addressed and immutable,
        # so the cache never goes stale; it just bounds memory. Kills the
        # dominant RLP re-decode cost on the hot write path.
        self._decoded: dict = {}

    # ----------------------------------------------------------- store IO

    def _load(self, ref):
        """Resolve a ref (inline node or 32-byte hash) to a decoded node."""
        if isinstance(ref, list):
            return ref
        if ref == BLANK_NODE:
            return BLANK_NODE
        if len(ref) == 32:
            cached = self._decoded.get(ref)
            if cached is None:
                try:
                    raw = self._store.get(ref)
                except KeyError:
                    raise KeyError("missing trie node {}".format(ref.hex()))
                cached = rlp.decode(raw)
                self._cache_decoded(ref, cached)
            # shallow copy: _update/_delete overwrite node slots in place
            return list(cached) if isinstance(cached, list) else cached
        return rlp.decode(ref)

    def _ref(self, node) -> rlp.RlpItem:
        """Persist node; return inline node if small, else its hash."""
        if node == BLANK_NODE:
            return BLANK_NODE
        encoded = rlp.encode(node)
        if len(encoded) < 32:
            return node
        h = sha3(encoded)
        self._store.put(h, encoded)
        # seed the decode cache: the next walk will load this node right
        # back (freshly written spine nodes ARE the hot set). Shallow
        # copy — callers overwrite slots of the list they passed in.
        self._cache_decoded(h, list(node))
        return h

    def _cache_decoded(self, ref: bytes, node) -> None:
        """Insert into the decode cache, evicting the older half at the
        cap (dicts iterate in insertion order) so neither the load nor
        the persist path can grow it unbounded."""
        if len(self._decoded) >= self._DECODE_CACHE_MAX:
            for stale in list(self._decoded)[:self._DECODE_CACHE_MAX // 2]:
                del self._decoded[stale]
        self._decoded[ref] = node

    def _root_node(self):
        if self.root_hash == BLANK_ROOT:
            return BLANK_NODE
        return self._load(self.root_hash)

    def _set_root(self, node):
        encoded = rlp.encode(node if node != BLANK_NODE else b"")
        h = sha3(encoded)
        self._store.put(h, encoded)
        self.root_hash = h

    # ------------------------------------------------------------ lookup

    def get(self, key: bytes) -> Optional[bytes]:
        return self._get(self._root_node(), bytes_to_nibbles(key))

    def get_at_root(self, root_hash: bytes, key: bytes) -> Optional[bytes]:
        node = BLANK_NODE if root_hash == BLANK_ROOT else self._load(root_hash)
        return self._get(node, bytes_to_nibbles(key))

    def _get(self, node, nibbles: List[int]) -> Optional[bytes]:
        if node == BLANK_NODE:
            return None
        if len(node) == 17:  # branch
            if not nibbles:
                return bytes(node[16]) or None
            child = self._load(node[nibbles[0]])
            return self._get(child, nibbles[1:])
        path, terminal = hp_decode(bytes(node[0]))
        if terminal:
            return bytes(node[1]) if path == nibbles else None
        if nibbles[:len(path)] != path:
            return None
        return self._get(self._load(node[1]), nibbles[len(path):])

    # ------------------------------------------------------------ update

    def set(self, key: bytes, value: bytes):
        if not value:
            return self.delete(key)
        root = self._update(self._root_node(), bytes_to_nibbles(key),
                            bytes(value))
        self._set_root(root)

    def _update(self, node, nibbles: List[int], value: bytes):
        if node == BLANK_NODE:
            return [hp_encode(nibbles, True), value]
        if len(node) == 17:  # branch
            node = list(node)
            if not nibbles:
                node[16] = value
            else:
                child = self._load(node[nibbles[0]])
                node[nibbles[0]] = self._ref(
                    self._update(child, nibbles[1:], value))
            return node
        # leaf or extension
        path, terminal = hp_decode(bytes(node[0]))
        common = 0
        while common < len(path) and common < len(nibbles) \
                and path[common] == nibbles[common]:
            common += 1
        if terminal and path == nibbles:
            return [node[0], value]
        if not terminal and common == len(path):
            sub = self._update(self._load(node[1]), nibbles[common:], value)
            return [node[0], self._ref(sub)]
        # split: branch at the divergence point
        branch = [BLANK_NODE] * 16 + [BLANK_NODE]
        old_rest = path[common:]
        if terminal:
            if old_rest:
                branch[old_rest[0]] = self._ref(
                    [hp_encode(old_rest[1:], True), node[1]])
            else:
                branch[16] = node[1]
        else:
            if len(old_rest) > 1:
                branch[old_rest[0]] = self._ref(
                    [hp_encode(old_rest[1:], False), node[1]])
            else:
                branch[old_rest[0]] = node[1]
        new_rest = nibbles[common:]
        if new_rest:
            branch[new_rest[0]] = self._ref(
                [hp_encode(new_rest[1:], True), value])
        else:
            branch[16] = value
        if common:
            return [hp_encode(nibbles[:common], False), self._ref(branch)]
        return branch

    # ------------------------------------------------------------ delete

    def delete(self, key: bytes):
        root = self._delete(self._root_node(), bytes_to_nibbles(key))
        self._set_root(root)

    def _delete(self, node, nibbles: List[int]):
        if node == BLANK_NODE:
            return BLANK_NODE
        if len(node) == 17:
            node = list(node)
            if not nibbles:
                node[16] = BLANK_NODE
            else:
                child = self._delete(self._load(node[nibbles[0]]), nibbles[1:])
                node[nibbles[0]] = self._ref(child)
            return self._normalize_branch(node)
        path, terminal = hp_decode(bytes(node[0]))
        if terminal:
            return BLANK_NODE if path == nibbles else node
        if nibbles[:len(path)] != path:
            return node
        sub = self._delete(self._load(node[1]), nibbles[len(path):])
        if sub == BLANK_NODE:
            return BLANK_NODE
        return self._merge_extension(path, sub)

    def _normalize_branch(self, node):
        """Collapse a branch with < 2 occupied slots."""
        occupied = [i for i in range(16) if node[i] != BLANK_NODE]
        has_value = node[16] != BLANK_NODE
        if len(occupied) + (1 if has_value else 0) > 1:
            return node
        if has_value:
            return [hp_encode([], True), node[16]]
        if not occupied:
            return BLANK_NODE
        i = occupied[0]
        child = self._load(node[i])
        return self._merge_extension([i], child)

    def _merge_extension(self, path: List[int], child):
        """Prepend `path` to child, merging leaf/extension paths."""
        if child == BLANK_NODE:
            return BLANK_NODE
        if len(child) == 17:
            return [hp_encode(path, False), self._ref(child)]
        sub_path, terminal = hp_decode(bytes(child[0]))
        return [hp_encode(list(path) + sub_path, terminal), child[1]]

    # ------------------------------------------------------------- proofs

    def produce_spv_proof(self, key: bytes,
                          root_hash: Optional[bytes] = None) -> List[bytes]:
        """Encoded trie nodes along the path root → key (SPV proof;
        reference pruning_trie.py:1105+)."""
        root_hash = root_hash if root_hash is not None else self.root_hash
        proof: List[bytes] = []
        if root_hash == BLANK_ROOT:
            return proof
        node = self._load(root_hash)
        nibbles = bytes_to_nibbles(key)
        while True:
            # every visited node goes in; inline nodes are redundant (they
            # live inside the parent's encoding) but harmless
            proof.append(rlp.encode(node))
            if node == BLANK_NODE:
                return proof
            if len(node) == 17:  # branch
                if not nibbles:
                    return proof
                ref = node[nibbles[0]]
                nibbles = nibbles[1:]
                if ref == BLANK_NODE:
                    return proof
                node = self._load(ref)
                continue
            path, terminal = hp_decode(bytes(node[0]))
            if terminal or nibbles[:len(path)] != path:
                return proof
            nibbles = nibbles[len(path):]
            node = self._load(node[1])

    # -------------------------------------------------------------- misc

    def items(self, root_hash: Optional[bytes] = None):
        """Iterate (key, value) pairs under a root."""
        root_hash = root_hash if root_hash is not None else self.root_hash
        node = BLANK_NODE if root_hash == BLANK_ROOT else self._load(root_hash)
        yield from self._walk(node, [])

    def _walk(self, node, prefix: List[int]):
        if node == BLANK_NODE:
            return
        if len(node) == 17:
            if node[16] != BLANK_NODE:
                yield _nibbles_to_bytes(prefix), bytes(node[16])
            for i in range(16):
                if node[i] != BLANK_NODE:
                    yield from self._walk(self._load(node[i]), prefix + [i])
            return
        path, terminal = hp_decode(bytes(node[0]))
        if terminal:
            yield _nibbles_to_bytes(prefix + path), bytes(node[1])
        else:
            yield from self._walk(self._load(node[1]), prefix + path)


def _nibbles_to_bytes(nibbles: List[int]) -> bytes:
    assert len(nibbles) % 2 == 0
    return bytes((nibbles[i] << 4) | nibbles[i + 1]
                 for i in range(0, len(nibbles), 2))


def verify_proof(root_hash: bytes, key: bytes, value: Optional[bytes],
                 proof_nodes: Sequence[bytes]) -> bool:
    """Stateless SPV verification: replay `proof_nodes` as a node store
    keyed by hash; membership (value == stored) or non-membership
    (value is None) both verifiable."""
    class _Dict:
        def __init__(self, items):
            self._d = {sha3(n): bytes(n) for n in items}

        def get(self, k):
            return self._d[k]

        def put(self, k, v):
            self._d[k] = v

    if root_hash == BLANK_ROOT and not proof_nodes:
        return value is None
    trie = Trie(_Dict(proof_nodes), root_hash)
    try:
        got = trie.get(key)
    except KeyError:
        return False
    return got == value
