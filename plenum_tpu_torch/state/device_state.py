"""Device-resident MPT state engine — batched trie reads, level-wise
SHA3 node hashing, merged multi-state hash resolution, and state
proofs at read scale.

``state/`` was the last pure-Python crypto hot path: the trie walks one
key at a time and hashes every dirty node one ``hashlib.sha3_256`` call
at a time (state/trie.py). This engine attaches BEHIND
``PruningState``/``Trie`` the same way ``DeviceMerkleTree`` attaches
behind ``CompactMerkleTree`` (attach seam + config batch threshold +
host-fallback circuit breaker in pruning_state.py) and serves three
batched operations, each decomposed into per-LEVEL device dispatches
(ops/trie.py → ops/sha3.py → the SHA3-256 kernel csrc/sha3.cu):

 - ``get_batch``: many key walks advance in lockstep; all level-N node
   loads are deduplicated across keys and hash-verified against their
   refs in ONE fused device dispatch per level (only a bool verdict
   crosses back), then HP-decoded on host and advanced one step. A
   corrupted store can never serve a value that does not hash to the
   root — the host path trusts the store, the device path re-verifies
   for free while batching.
 - ``apply_batch``: a whole 3PC batch's writes run through a
 deferred-hash trie (structural inserts/deletes only — no hashing);
   the dirty nodes are then resolved bottom-up, one device SHA3
   dispatch per level, so path nodes shared by the batch hash once,
   not once per request. Returns the new state root and persists
   exactly the final tree's nodes (same contract as the native
   ``set_many``: only the final root is a readable snapshot).
 - ``proof_batch``: SPV ``proof_nodes`` for hundreds of keys in one
   engine call — the same deduplicated level walk as ``get_batch``
   (shared spine nodes load and verify once per level, not once per
   key), emitting per-key proofs byte-identical to
   ``Trie.produce_spv_proof``.

Results are byte-equal to the pure-Python ``Trie`` (roots, values and
proof nodes — randomized equivalence in tests/test_device_state.py);
levels below ``Config.STATE_DEVICE_HASH_FLOOR`` use hashlib on host,
where the scalar path wins on latency (the root level is one node).

The conflict-lane executor (server/executor.py) splits
``apply_batch`` into two halves so MANY states' batches share one set
of hash dispatches per applied 3PC batch:

 - ``begin_apply``: the structural half alone — a whole batch's writes
   merge into the standing trie through ONE recursive bulk merge
   (``_bulk_merge``: sorted keys descend shared path nodes once per
   batch, not once per key — ~2x fewer node visits/copies than per-key
   ``_update`` walks), returning a ``_DeferredApply`` whose dirty
   nodes await hashing.
 - ``resolve_applies``: resolves ANY number of deferred applies (one
   per written state — domain / pool / config in a mixed batch)
   bottom-up with SHARED level-wise SHA3 dispatches: level N of every
   participating trie hashes in the same launch, so lanes and ledgers
   merge at the hash step for free. ``Config.EXEC_MERGED_DEVICE_HASH``
   = "auto" sends those levels to the engine's device (the card unless
   the engine was built with device="cpu"); False keeps them on
   hashlib.

Both halves are byte-equal to ``apply_batch`` (and to the host trie):
the MPT is content-canonical, so the bulk merge and the per-key walk
produce the identical tree for the identical final mapping.
"""
from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from plenum_tpu_torch.observability.tracing import CAT_DEVICE, NullTracer
from plenum_tpu_torch.ops import cuda_lib, resolve_device, trie as trie_ops
from plenum_tpu_torch.ops.sha256 import PinnedStaging
from plenum_tpu_torch.state import rlp
from plenum_tpu_torch.state.trie import (
    BLANK_NODE, BLANK_ROOT, Trie, bytes_to_nibbles, hp_decode, hp_encode)


class CorruptStateError(Exception):
    """A stored trie node does not hash to the ref that points at it."""


class _DeferredTrie(Trie):
    """Trie whose ``_ref`` defers hashing: a batch of updates builds an
    in-memory nested-list node tree (children held inline regardless of
    encoded size); the engine then resolves refs bottom-up with one
    batched SHA3 dispatch per level. Reads during the update (_load)
    still hit the store for untouched subtrees."""

    def _ref(self, node):
        if node == BLANK_NODE:
            return BLANK_NODE
        return node


# ------------------------------------------------ bulk structural merge
#
# One recursive merge of a SORTED key set into the standing trie: every
# shared path node (the root branch, hot spine extensions) is loaded
# and copied once per batch, where per-key ``_update`` walks copy it
# once per key. The MPT is content-canonical — the same final mapping
# yields the same tree whatever the insertion schedule — so the merge
# is byte-equal to per-key updates (randomized equivalence in
# tests/test_executor_lanes.py). Deletes stay on the per-key ``_delete``
# path (branch collapse is order-local and deletes are rare).

def _lcp_sorted(items) -> int:
    """Longest common prefix length over sorted item nibble tuples —
    for a sorted list this is lcp(first, last)."""
    first = items[0][0]
    last = items[-1][0]
    m = 0
    n = min(len(first), len(last))
    while m < n and first[m] == last[m]:
        m += 1
    return m


def _build_subtree(items):
    """Fresh in-memory subtree for sorted (nibbles, value) items under
    a blank slot. Unique keys; at most one item can terminate exactly
    at the common prefix (a prefix sorts before its extensions)."""
    if len(items) == 1:
        nib, val = items[0]
        return [hp_encode(list(nib), True), val]
    m = _lcp_sorted(items)
    branch = [BLANK_NODE] * 16 + [BLANK_NODE]
    i = 0
    n = len(items)
    if len(items[0][0]) == m:
        branch[16] = items[0][1]
        i = 1
    while i < n:
        c = items[i][0][m]
        j = i
        while j < n and items[j][0][m] == c:
            j += 1
        branch[c] = _build_subtree(
            [(nib[m + 1:], val) for nib, val in items[i:j]])
        i = j
    if m:
        return [hp_encode(list(items[0][0][:m]), False), branch]
    return branch


def _bulk_merge(trie, node, items):
    """Merge sorted (nibbles, value) items into ``node`` (in-memory
    form, deferred refs — children held inline). → the new node."""
    if not items:
        return node
    if node == BLANK_NODE:
        return _build_subtree(items)
    if len(node) == 17:  # branch: group items by first nibble
        node = list(node)
        i = 0
        n = len(items)
        if len(items[0][0]) == 0:
            node[16] = items[0][1]
            i = 1
        while i < n:
            c = items[i][0][0]
            j = i
            while j < n and items[j][0][0] == c:
                j += 1
            group = [(nib[1:], val) for nib, val in items[i:j]]
            node[c] = _bulk_merge(trie, trie._load(node[c]), group)
            i = j
        return node
    path, terminal = hp_decode(bytes(node[0]))
    if terminal:
        # absorb the existing leaf as one more item (an exact-match
        # item overwrites it) and rebuild the subtree fresh
        merged = {tuple(path): bytes(node[1])}
        for nib, val in items:
            merged[tuple(nib)] = val
        return _build_subtree(sorted(merged.items()))
    # extension: find the earliest divergence of any item against path
    tp = tuple(path)
    lp = len(tp)
    m = lp
    for nib, _ in items:
        k = 0
        n2 = min(len(nib), lp)
        while k < n2 and nib[k] == tp[k]:
            k += 1
        if k < m:
            m = k
            if m == 0:
                break
    if m == lp:  # every item continues through the extension
        sub = _bulk_merge(trie, trie._load(node[1]),
                          [(nib[lp:], val) for nib, val in items])
        return [node[0], sub]
    # branch at the divergence point; the extension remainder keeps
    # the old child (same shapes per-key _update produces on a split)
    rest = tp[m:]
    branch = [BLANK_NODE] * 16 + [BLANK_NODE]
    if len(rest) == 1:
        branch[rest[0]] = node[1]
    else:
        branch[rest[0]] = [hp_encode(list(rest[1:]), False), node[1]]
    branch = _bulk_merge(trie, branch,
                         [(nib[m:], val) for nib, val in items])
    if m:
        return [hp_encode(list(tp[:m]), False), branch]
    return branch


class _Walk:
    """One key's position in the level-wise batched walk."""

    __slots__ = ("nibbles", "node", "value", "done", "proof")

    def __init__(self, key: bytes, want_proof: bool):
        self.nibbles = bytes_to_nibbles(key)
        self.node = None
        self.value: Optional[bytes] = None
        self.done = False
        self.proof: Optional[List[bytes]] = [] if want_proof else None


class DeviceStateEngine:
    """Batched MPT operations over a trie node store (hash → RLP blob),
    with all level-N node hashing issued as one device dispatch."""

    def __init__(self, store, tracer=None, hash_floor: Optional[int] = None,
                 device=None):
        """store: the SAME KeyValueStorage the host trie persists into
        (both backends write identical hash → RLP blobs, so the engine
        reads either's nodes). hash_floor: per-dispatch batch size
        below which hashlib wins on latency (default from Config).
        device: where the SHA3 levels run — None means CUDA (raises
        without a card), "cpu" runs the kernel's plain version."""
        from plenum_tpu_torch.common.config import Config
        self.device = resolve_device(device)
        # the grow-only pinned buffer every level's bytes reach the card
        # through
        self._staging = PinnedStaging()
        self._store = store
        self.tracer = tracer or NullTracer()
        self.hash_floor = (Config.STATE_DEVICE_HASH_FLOOR
                           if hash_floor is None else hash_floor)
        # stats for validator info / bench
        self.dispatches = 0
        self.host_hash_calls = 0

    # ------------------------------------------------------------ hashing

    def _verify_level(self, blobs: List[bytes], refs: List[bytes]) -> None:
        """Hash-verify a level of loaded blobs against their refs —
        fused hash+compare on device (one bool per node crosses back)."""
        if len(blobs) < self.hash_floor:
            self.host_hash_calls += 1
            for blob, ref in zip(blobs, refs):
                if hashlib.sha3_256(blob).digest() != ref:
                    raise CorruptStateError(
                        "trie node {} does not match its stored "
                        "bytes".format(ref.hex()))
            return
        self.dispatches += 1
        ok = trie_ops.collect_node_verify_batch(
            trie_ops.dispatch_node_verify_batch(blobs, refs, self.device,
                                                self._staging))
        if not ok.all():
            bad = [refs[i].hex() for i in range(len(refs)) if not ok[i]]
            raise CorruptStateError(
                "trie node(s) {} do not match their stored "
                "bytes".format(", ".join(bad)))

    def warm(self) -> None:
        """Build and load the SHA3 library now (on the card), keeping the
        one-time nvcc cost off the first serving batch."""
        if self.device.type == "cuda":
            cuda_lib.load("sha3")

    # ---------------------------------------------------- level-wise walk

    def _load_blob(self, ref: bytes) -> bytes:
        try:
            return bytes(self._store.get(ref))
        except KeyError:
            raise KeyError("missing trie node {}".format(ref.hex()))

    def _walk_batch(self, root_hash: bytes, keys: Sequence[bytes],
                    want_proof: bool) -> List[_Walk]:
        walks = [_Walk(bytes(k), want_proof) for k in keys]
        if root_hash == BLANK_ROOT:
            for w in walks:
                w.done = True
            return walks
        root_blob = self._load_blob(bytes(root_hash))
        self._verify_level([root_blob], [bytes(root_hash)])
        root_node = rlp.decode(root_blob)
        for w in walks:
            w.node = root_node
        active = walks
        decoded: Dict[bytes, object] = {}
        while active:
            # advance every walk until it terminates or needs a stored
            # node; collect the level's unique refs across all keys
            need: Dict[bytes, List[_Walk]] = {}
            for w in active:
                ref = self._advance(w)
                if ref is not None:
                    need.setdefault(ref, []).append(w)
            if not need:
                break
            refs = [r for r in need if r not in decoded]
            if refs:
                blobs = [self._load_blob(r) for r in refs]
                self._verify_level(blobs, refs)
                for r, blob in zip(refs, blobs):
                    decoded[r] = rlp.decode(blob)
            active = []
            for r, waiting in need.items():
                node = decoded[r]
                for w in waiting:
                    w.node = node
                    active.append(w)
        return walks

    def _advance(self, w: _Walk) -> Optional[bytes]:
        """Advance one walk through inline nodes until it finishes
        (w.done) or needs a 32-byte stored ref (returned). Mirrors
        Trie._get and Trie.produce_spv_proof exactly — values, proof
        node sequences and termination conditions are byte-identical."""
        while True:
            node = w.node
            if w.proof is not None:
                w.proof.append(rlp.encode(node))
            if node == BLANK_NODE:
                w.done = True
                return None
            if len(node) == 17:  # branch
                if not w.nibbles:
                    w.value = bytes(node[16]) or None
                    w.done = True
                    return None
                ref = node[w.nibbles[0]]
                w.nibbles = w.nibbles[1:]
                if ref == BLANK_NODE:
                    w.done = True
                    return None
            else:  # leaf or extension
                path, terminal = hp_decode(bytes(node[0]))
                if terminal:
                    if path == w.nibbles:
                        w.value = bytes(node[1])
                    w.done = True
                    return None
                if w.nibbles[:len(path)] != path:
                    w.done = True
                    return None
                w.nibbles = w.nibbles[len(path):]
                ref = node[1]
            # resolve the ref like Trie._load, deferring only store IO
            if isinstance(ref, list):
                w.node = ref
                continue
            ref = bytes(ref)
            if len(ref) == 32:
                return ref
            w.node = rlp.decode(ref)

    # ------------------------------------------------------------- reads

    def get_batch(self, root_hash: bytes, keys: Sequence[bytes]
                  ) -> List[Optional[bytes]]:
        """Values for many keys under one root; all level-N node loads
        are hash-verified in one device dispatch per level."""
        with self.tracer.span("state_get", CAT_DEVICE, n=len(keys)):
            walks = self._walk_batch(root_hash, keys, want_proof=False)
        return [w.value for w in walks]

    def proof_batch(self, root_hash: bytes, keys: Sequence[bytes]
                    ) -> List[List[bytes]]:
        """SPV proof nodes for many keys under one root, byte-identical
        to Trie.produce_spv_proof per key — the shared spine loads and
        hash-verifies once per level, not once per key."""
        with self.tracer.span("state_proof", CAT_DEVICE, n=len(keys)):
            walks = self._walk_batch(root_hash, keys, want_proof=True)
        return [w.proof for w in walks]

    def get_with_proof_batch(self, root_hash: bytes,
                             keys: Sequence[bytes]):
        """→ (values, proofs) for many keys from ONE walk — the proof
        walk resolves every key's value anyway, so the read-serving
        path (value + proof per reply) pays one set of store loads and
        device verifies, not two."""
        with self.tracer.span("state_proof", CAT_DEVICE, n=len(keys)):
            walks = self._walk_batch(root_hash, keys, want_proof=True)
        return [w.value for w in walks], [w.proof for w in walks]

    # ------------------------------------------------------------- apply

    def apply_batch(self, root_hash: bytes,
                    pairs: Sequence[Tuple[bytes, bytes]]) -> bytes:
        """Apply a whole batch of (key, value) writes (empty value =
        delete) on top of `root_hash`: structural trie work on host
        with DEFERRED hashing, then every dirty node hashed level-wise
        on device and persisted. → the new state root (byte-equal to
        applying the same final mapping through the host trie)."""
        with self.tracer.span("state_apply", CAT_DEVICE,
                              n=len(pairs)) as sp:
            d0 = self.dispatches
            trie = _DeferredTrie(self._store, bytes(root_hash))
            node = trie._root_node()
            for k, v in pairs:
                nib = bytes_to_nibbles(bytes(k))
                if v:
                    node = trie._update(node, nib, bytes(v))
                else:
                    node = trie._delete(node, nib)
            root = self._resolve_and_store(node)
            sp.add(dispatches=self.dispatches - d0)
            return root

    def _resolve_and_store(self, root_node) -> bytes:
        """Resolve every in-memory (list) node bottom-up: encode with
        children substituted by their resolved refs; nodes under 32
        encoded bytes stay inline (never persisted — same as _ref),
        larger ones batch into one SHA3 dispatch per level and are
        written through hash → blob. The root is always hashed and
        persisted (Trie._set_root contract). ONE implementation serves
        both the legacy whole-batch apply and the merged multi-state
        path: this is the single-handle case of ``_resolve_applies``,
        with device routing pinned on (this seam's
        own ``hash_floor`` already keeps small levels on hashlib)."""
        return _resolve_applies([_DeferredApply(self, root_node, [])],
                                on_device=True, floor=self.hash_floor)[0]

    # ------------------------------------------- deferred (merged) apply

    def begin_apply(self, root_hash: bytes,
                    pairs: Sequence[Tuple[bytes, bytes]]) -> "_DeferredApply":
        """The structural half of apply_batch: merge the batch's writes
        into the standing trie through ONE recursive bulk merge (sorted
        keys descend shared path nodes once per batch) with hashing
        deferred. The returned handle's dirty nodes are resolved later —
        together with other states' handles — by :func:`resolve_applies`,
        so every lane's and every ledger's batch shares one set of
        level-wise SHA3 dispatches. ``begin_apply`` + single-handle
        ``resolve_applies`` is byte-equal to :meth:`apply_batch` (the
        MPT is content-canonical)."""
        trie = _DeferredTrie(self._store, bytes(root_hash))
        node = trie._root_node()
        sets = sorted((tuple(bytes_to_nibbles(bytes(k))), bytes(v))
                      for k, v in pairs if v)
        node = _bulk_merge(trie, node, sets)
        for k, v in pairs:
            if not v:
                node = trie._delete(node, bytes_to_nibbles(bytes(k)))
        return _DeferredApply(self, node, list(pairs))

    @staticmethod
    def _collect_heights(root_node):
        """Reachable in-memory nodes keyed by id, plus each node's
        height (1 + max child height; stored/inline bytes are height
        0). Iterative — spines can outgrow the recursion limit."""
        nodes: Dict[int, object] = {}
        heights: Dict[int, int] = {}
        stack = [(root_node, False)]
        while stack:
            node, processed = stack.pop()
            nid = id(node)
            if processed:
                h = 0
                for c in node:
                    if type(c) is list:
                        h = max(h, heights[id(c)] + 1)
                heights[nid] = h
                continue
            if nid in nodes:
                continue
            nodes[nid] = node
            stack.append((node, True))
            for c in node:
                if type(c) is list and id(c) not in nodes:
                    stack.append((c, False))
        return nodes, heights

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "hash_floor": self.hash_floor,
            "device_dispatches": self.dispatches,
            "host_hash_calls": self.host_hash_calls,
        }


class _DeferredApply:
    """One state's structural batch update awaiting hash resolution.

    ``pairs`` is the write set the handle was built from; ``state`` is
    set by PruningState.begin_flush_deferred so the resolver can hand
    each new root back to its owner."""

    __slots__ = ("engine", "root_node", "pairs", "state")

    def __init__(self, engine: DeviceStateEngine, root_node, pairs):
        self.engine = engine
        self.root_node = root_node
        self.pairs = pairs
        self.state = None


def merged_hash_on_device(use_device=None) -> bool:
    """Routing policy for the merged resolve's level hashing
    (``Config.EXEC_MERGED_DEVICE_HASH``): "auto" and True send levels at
    or above the floor to the engines' device — the card, unless the
    engines were built with device="cpu" (the JAX package's "auto" took
    hashlib on hosts without an accelerator; the port never steps down
    to the host when the card is missing: building the engine raised);
    False keeps every level on hashlib."""
    if use_device is None:
        from plenum_tpu_torch.common.config import Config
        use_device = getattr(Config, "EXEC_MERGED_DEVICE_HASH", "auto")
    return use_device == "auto" or bool(use_device)


def resolve_applies(applies: Sequence[_DeferredApply],
                    use_device=None) -> List[bytes]:
    """Resolve MANY deferred applies bottom-up with SHARED level-wise
    SHA3 dispatches: level N of every participating trie (one per
    written state — domain / pool / config in a mixed batch) hashes in
    the same launch, so execution lanes and ledgers merge at the hash
    step for free. → the new root per apply, byte-equal to resolving
    each handle alone (node digests are content hashes — independent
    of which launch computed them). Nodes under 32 encoded bytes stay
    inline (never persisted — the ``_ref`` contract); every root is
    hashed and persisted (``Trie._set_root`` contract)."""
    if not applies:
        return []
    on_device = merged_hash_on_device(use_device)
    floor = min(ap.engine.hash_floor for ap in applies)
    tracer = applies[0].engine.tracer
    n_pairs = sum(len(ap.pairs) for ap in applies)
    with tracer.span("state_apply_merged", CAT_DEVICE,
                     n=n_pairs, states=len(applies)) as sp:
        d0 = applies[0].engine.dispatches
        roots = _resolve_applies(applies, on_device, floor)
        sp.add(dispatches=applies[0].engine.dispatches - d0)
    return roots


def _hash_level_merged(applies, blobs, on_device, floor):
    """SHA3-256 one merged level: one device dispatch above the floor
    when routed on-device, hashlib otherwise (stats land on the first
    handle's engine — the launch is shared)."""
    if on_device and len(blobs) >= floor:
        engine = applies[0].engine
        engine.dispatches += 1
        return trie_ops.hash_nodes(blobs, engine.device, engine._staging)
    applies[0].engine.host_hash_calls += 1
    return [hashlib.sha3_256(b).digest() for b in blobs]


def _resolve_applies(applies, on_device, floor) -> List[bytes]:
    roots: List[Optional[bytes]] = [None] * len(applies)
    # collect each handle's in-memory nodes keyed by id + height
    per = []
    by_height = defaultdict(list)   # height -> [(apply_idx, nid, node)]
    for ai, ap in enumerate(applies):
        if ap.root_node == BLANK_NODE:
            encoded = rlp.encode(b"")
            ap.engine._store.put(BLANK_ROOT, encoded)
            roots[ai] = BLANK_ROOT
            per.append(None)
            continue
        nodes, heights = DeviceStateEngine._collect_heights(ap.root_node)
        per.append(nodes)
        for nid, node in nodes.items():
            by_height[heights[nid]].append((ai, nid, node))
    resolved: List[Dict[int, object]] = [{} for _ in applies]
    root_ids = [id(ap.root_node) if per[ai] is not None else None
                for ai, ap in enumerate(applies)]
    root_encoded: List[Optional[bytes]] = [None] * len(applies)
    for h in sorted(by_height):
        level_owner: List[Tuple[int, int]] = []   # (apply_idx, nid)
        level_blobs: List[bytes] = []
        for ai, nid, node in by_height[h]:
            res = resolved[ai]
            subst = [res[id(c)] if type(c) is list else c for c in node]
            encoded = rlp.encode(subst)
            if nid == root_ids[ai]:
                root_encoded[ai] = encoded
            elif len(encoded) < 32:
                res[nid] = subst
            else:
                level_owner.append((ai, nid))
                level_blobs.append(encoded)
        if level_blobs:
            digs = _hash_level_merged(applies, level_blobs,
                                      on_device, floor)
            for (ai, nid), blob, dig in zip(level_owner, level_blobs,
                                            digs):
                applies[ai].engine._store.put(dig, blob)
                resolved[ai][nid] = dig
    for ai, ap in enumerate(applies):
        if roots[ai] is not None:
            continue
        dig = hashlib.sha3_256(root_encoded[ai]).digest()
        ap.engine._store.put(dig, root_encoded[ai])
        roots[ai] = dig
    return roots
