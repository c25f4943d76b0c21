"""State: committed vs uncommitted heads over the trie.

Reference: state/state.py:5 (State ABC), state/pruning_state.py:14
(PruningState). `headHash` moves with every applied-but-uncommitted batch;
`committedHeadHash` moves only on 3PC commit; revert rewinds head to the
committed root (the trie keeps all nodes, so rewinding is just a root
swap — same trick the reference uses).

Device engine seam: `attach_device_engine` routes batched gets, whole
pending-buffer flushes and multi-key proof generation through the
device MPT engine (state/device_state.py): calls below the config batch
threshold keep the host trie path. An engine failure raises — the JAX
package's circuit breaker, which served the host trie after device
faults, is not part of the port: on the card the kernel runs or the
call fails.

Trie backend: the C MPT (state/trie_native.py over csrc/mpt_c.c) when
its extension builds, else the Python trie (state/trie.py); their roots,
proofs and written nodes are byte-equal. The engine writes the nodes of
the batches it hashes into the KV, and the C trie reads them back
through its miss callback.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

from plenum_tpu_torch.common.serializers.base58 import b58encode
from plenum_tpu_torch.state.trie import BLANK_ROOT, Trie, verify_proof

try:
    from plenum_tpu_torch.state.trie_native import NativeTrie as _TrieBackend
except ImportError:          # extension disabled or not built
    _TrieBackend = Trie


class State(ABC):
    @abstractmethod
    def set(self, key: bytes, value: bytes): ...

    @abstractmethod
    def get(self, key: bytes, isCommitted: bool = True) -> Optional[bytes]: ...

    @abstractmethod
    def remove(self, key: bytes): ...

    @property
    @abstractmethod
    def head(self): ...

    @property
    @abstractmethod
    def committedHead(self): ...

    @abstractmethod
    def commit(self, rootHash: Optional[bytes] = None): ...

    @abstractmethod
    def revertToHead(self, headHash: bytes): ...

    @property
    @abstractmethod
    def headHash(self) -> bytes: ...

    @property
    @abstractmethod
    def committedHeadHash(self) -> bytes: ...


from plenum_tpu_torch.common.config import Config as _Config

# read-window miss marker: the window stores None for keys ABSENT at
# the pre-batch root (a hit that must not fall through to a trie walk)
_WINDOW_MISS = object()


class PruningState(State):
    # key under which the committed root hash survives restarts
    rootHashKey = b"\x88\x88committedRoot"

    # device MPT engine routing (state/device_state.py): batched calls
    # at/above this many keys go through the engine; below it the host
    # trie wins on latency. Single-sourced from Config like the
    # MERKLE_DEVICE_* knobs.
    _engine_batch_min = _Config.STATE_DEVICE_BATCH_MIN

    def __init__(self, kv):
        """kv: KeyValueStorage for trie nodes (+ the committed-root key)."""
        self._kv = kv
        try:
            committed = bytes(kv.get(self.rootHashKey))
        except KeyError:
            committed = BLANK_ROOT
        self._trie = _TrieBackend(kv, committed)
        self._committed_root = committed
        # write buffer: set/remove land here; the trie absorbs the whole
        # batch in ONE deferred-hash pass when the head root is actually
        # needed (headHash / commit). Shared path nodes then hash once
        # per batch instead of once per request. Uncommitted gets read
        # through the buffer, so apply-loop read-your-writes holds.
        self._pending: dict = {}
        # bumps on every write; validation memos key on it (cheaper than
        # forcing a flush to compare head roots)
        self.mutation_count = 0
        # prefetched read window (conflict-lane executor): pre-batch
        # values for the batch's DECLARED read keys, served by
        # uncommitted get() after the pending-buffer check — a key
        # written this batch is in _pending (exact), an unwritten key's
        # pre-batch value is the window's (exact), so the window can
        # never serve a stale value. Any flush or rewind drops it.
        self._read_window: Optional[dict] = None
        self._engine = None

    # ----------------------------------------------------- device engine

    def attach_device_engine(self, engine=None, batch_min: int = None,
                             warm: bool = False, device=None,
                             hash_floor: int = None):
        """Route batched gets / whole-batch flushes / multi-key proof
        generation through a device MPT engine
        (state/device_state.DeviceStateEngine, built on `device` — None
        means CUDA — with `hash_floor`, unless one is given). Calls below
        `batch_min` keys keep the host trie path — it wins below the
        routing threshold.
        warm=True builds and loads the SHA3 library now, keeping the
        one-time build off the first serving call."""
        if engine is None:
            from plenum_tpu_torch.state.device_state import DeviceStateEngine
            engine = DeviceStateEngine(self._kv, hash_floor=hash_floor,
                                       device=device)
        self._engine = engine
        if batch_min is not None:
            self._engine_batch_min = batch_min
        if warm:
            engine.warm()
        return engine

    def _engine_call(self, fn):
        """Run one engine operation; None when no engine is attached (the
        caller serves from the host trie). Failures raise."""
        if self._engine is None:
            return None
        return fn(self._engine)

    # ------------------------------------------------------------ writes

    def set(self, key: bytes, value: bytes):
        self._pending[bytes(key)] = bytes(value)
        self.mutation_count += 1

    def remove(self, key: bytes):
        self._pending[bytes(key)] = b""  # empty == delete (trie semantics)
        self.mutation_count += 1

    def _flush_pending(self):
        if not self._pending:
            return
        # the window holds PRE-BATCH values; once the batch's writes
        # land in the trie the pending-first shield is gone, so the
        # window must go with it
        self._read_window = None
        pending, self._pending = self._pending, {}
        if self._engine is not None \
                and len(pending) >= self._engine_batch_min:
            # whole-batch device apply: every dirty node hashed
            # level-wise in one SHA3 dispatch per level; the root is
            # byte-equal to the host path's (content-canonical trie)
            root = self._engine_call(
                lambda eng: eng.apply_batch(self._trie.root_hash,
                                            list(pending.items())))
            if root is not None:
                self._trie.root_hash = root
                return
        self._host_apply_pairs(pending)

    def begin_flush_deferred(self):
        """The structural half of a pending-buffer flush (conflict-lane
        executor): merge the whole buffer into the trie with hashing
        deferred and return a ``_DeferredApply`` handle for the shared
        :func:`flush_states_merged` resolve — so a batch that writes
        several ledgers' states hashes ALL their dirty nodes in one set
        of level-wise dispatches. Returns None when the host path
        already served the flush (no engine, or a buffer below the
        batch threshold — identical routing to ``_flush_pending``)."""
        if not self._pending:
            return None
        if self._engine is None \
                or len(self._pending) < self._engine_batch_min:
            self._flush_pending()
            return None
        self._read_window = None
        pending, self._pending = self._pending, {}
        handle = self._engine.begin_apply(self._trie.root_hash,
                                          list(pending.items()))
        handle.state = self
        return handle

    def _host_apply_pairs(self, pending: dict) -> None:
        """Apply a popped pending buffer through the host trie."""
        set_many = getattr(self._trie, "set_many", None)
        if set_many is not None:
            set_many(list(pending.items()))
            return
        for k, v in pending.items():
            if v:
                self._trie.set(k, v)
            else:
                self._trie.delete(k)

    def get(self, key: bytes, isCommitted: bool = True) -> Optional[bytes]:
        if isCommitted:
            return self._trie.get_at_root(self._committed_root, key)
        k = bytes(key)
        if k in self._pending:
            return self._pending[k] or None
        win = self._read_window
        if win is not None:
            hit = win.get(k, _WINDOW_MISS)
            if hit is not _WINDOW_MISS:
                return hit
        return self._trie.get(k)

    def get_for_root_hash(self, root_hash: bytes, key: bytes
                          ) -> Optional[bytes]:
        return self._trie.get_at_root(root_hash, key)

    # ------------------------------------------------------ batched reads

    def get_batch(self, keys: Sequence[bytes], isCommitted: bool = True
                  ) -> List[Optional[bytes]]:
        """Values for many keys in one call: the device engine walks
        every key level-lockstep with one hash-verify dispatch per
        level; uncommitted reads still see the pending write buffer."""
        if isCommitted:
            return self.get_batch_for_root_hash(self._committed_root,
                                                keys)
        out: List[Optional[bytes]] = [None] * len(keys)
        missing_idx, missing_keys = [], []
        for i, key in enumerate(keys):
            k = bytes(key)
            if k in self._pending:
                out[i] = self._pending[k] or None
            else:
                missing_idx.append(i)
                missing_keys.append(k)
        if missing_keys:
            vals = self.get_batch_for_root_hash(self._trie.root_hash,
                                                missing_keys)
            for i, v in zip(missing_idx, vals):
                out[i] = v
        return out

    def get_batch_for_root_hash(self, root_hash: bytes,
                                keys: Sequence[bytes]
                                ) -> List[Optional[bytes]]:
        if len(keys) >= self._engine_batch_min:
            vals = self._engine_call(
                lambda eng: eng.get_batch(root_hash, keys))
            if vals is not None:
                return vals
        return [self._trie.get_at_root(root_hash, k) for k in keys]

    # -------------------------------------------------------- read window

    def begin_read_window(self, keys: Sequence[bytes]) -> bool:
        """Prefetch pre-batch values for the batch's DECLARED read keys
        into one dict (conflict-lane executor, server/executor.py): the
        per-request validation/apply reads those keys as dict hits
        instead of one trie walk each. Exactness holds for ANY
        interleaving of reads and writes because uncommitted ``get``
        checks the pending write buffer first — the window only ever
        answers for keys untouched so far this batch, where the
        pre-batch value IS the serial value. → True if a window was
        installed."""
        if not keys:
            return False
        root = self._trie.root_hash
        win: dict = {}
        missing: List[bytes] = []
        for k in keys:
            kb = bytes(k)
            if kb not in self._pending:
                missing.append(kb)
        if missing:
            # host walks, one per key: the trie's decode cache holds the
            # hot spine, so this beats the engine's lockstep walk on
            # every measured shape (the walk is host work either way —
            # the device only ever hash-VERIFIES, which own-state apply
            # reads skip under the host trust-the-store contract)
            get_at_root = self._trie.get_at_root
            for k in missing:
                win[k] = get_at_root(root, k)
        self._read_window = win
        return True

    def end_read_window(self) -> None:
        self._read_window = None

    # ------------------------------------------------------- commit/revert

    def commit(self, rootHash: Optional[bytes] = None):
        """Advance the committed head (to `rootHash` if given — must be a
        root previously produced by apply — else to the current head).
        The working head is NOT moved: later uncommitted batches may
        already be staged on top of the committed prefix (3PC pipelines
        several batches in flight)."""
        self._flush_pending()
        root = rootHash if rootHash is not None else self._trie.root_hash
        self._committed_root = root
        self._kv.put(self.rootHashKey, root)

    def revertToHead(self, headHash: bytes):
        self._pending.clear()  # buffered writes belong to the abandoned head
        self._read_window = None
        self.mutation_count += 1
        self._trie.root_hash = headHash

    # ------------------------------------------------------------- heads

    @property
    def head(self):
        self._flush_pending()
        return self._trie

    @property
    def committedHead(self):
        return _TrieBackend(self._kv, self._committed_root)

    @property
    def headHash(self) -> bytes:
        self._flush_pending()
        return self._trie.root_hash

    @property
    def committedHeadHash(self) -> bytes:
        return self._committed_root

    @property
    def committedHeadHash_b58(self) -> str:
        return b58encode(self._committed_root)

    # ------------------------------------------------------------- proofs

    def generate_state_proof(self, key: bytes, root: Optional[bytes] = None,
                             serialize: bool = False):
        """Proof nodes for `key`; serialize=True wraps them in one
        base64-encoded RLP list (the wire form clients receive)."""
        nodes = self._trie.produce_spv_proof(
            key, root if root is not None else self.committedHeadHash)
        if serialize:
            return self.serialize_proof(nodes)
        return nodes

    def generate_state_proof_batch(self, keys: Sequence[bytes],
                                   root: Optional[bytes] = None,
                                   serialize: bool = False) -> List:
        """Proof nodes for MANY keys under one root in one engine call
        (shared spine nodes load and hash-verify once per level, not
        once per key); each entry is byte-identical to
        generate_state_proof for the same key."""
        root = root if root is not None else self.committedHeadHash
        proofs = None
        if len(keys) >= self._engine_batch_min:
            proofs = self._engine_call(
                lambda eng: eng.proof_batch(root, keys))
        if proofs is None:
            proofs = [self._trie.produce_spv_proof(k, root) for k in keys]
        if serialize:
            return [self.serialize_proof(nodes) for nodes in proofs]
        return proofs

    def get_with_proofs_batch(self, keys: Sequence[bytes],
                              root: Optional[bytes] = None,
                              serialize: bool = False):
        """→ (values, proofs) for many keys under one root from ONE
        engine walk (the proof walk resolves values anyway) — the
        read-serving shape, where every reply carries both. Entries
        are byte-identical to get_for_root_hash + generate_state_proof
        per key."""
        root = root if root is not None else self.committedHeadHash
        out = None
        if len(keys) >= self._engine_batch_min:
            out = self._engine_call(
                lambda eng: eng.get_with_proof_batch(root, keys))
        if out is None:
            out = ([self._trie.get_at_root(root, k) for k in keys],
                   [self._trie.produce_spv_proof(k, root) for k in keys])
        values, proofs = out
        if serialize:
            proofs = [self.serialize_proof(nodes) for nodes in proofs]
        return values, proofs

    @staticmethod
    def serialize_proof(nodes: Sequence[bytes]) -> str:
        """Wire form clients receive: one base64-encoded RLP list."""
        import base64
        from plenum_tpu_torch.state import rlp as _rlp
        return base64.b64encode(_rlp.encode(list(nodes))).decode("ascii")

    @staticmethod
    def deserialize_proof(proof: str) -> List[bytes]:
        import base64
        from plenum_tpu_torch.state import rlp as _rlp
        return [bytes(n) for n in _rlp.decode(base64.b64decode(proof))]

    @staticmethod
    def verify_state_proof(root_hash: bytes, key: bytes,
                           value: Optional[bytes],
                           proof_nodes: List[bytes]) -> bool:
        return verify_proof(root_hash, key, value, proof_nodes)

    def close(self):
        self._kv.close()


def flush_states_merged(states, use_device=None, exec_map=None) -> None:
    """Flush MANY states' pending buffers through ONE merged hash
    resolution (conflict-lane executor, server/executor.py): each
    state's structural update runs with hashing deferred
    (``begin_flush_deferred``), then every participating trie's dirty
    nodes resolve together in shared level-wise SHA3 launches
    (state/device_state.resolve_applies). States the engine does not
    serve (no engine, sub-threshold buffers) flush through their host
    path inside ``begin_flush_deferred``; roots are byte-equal on every
    path.

    ``exec_map``: optional order-preserving parallel map (the node
    pipeline's execution pool). Host-path states fan across it — each
    owns its trie, pending buffer and kv store, so their structural
    merges are independent — while engine-routed states stay on the
    calling thread, so every SHA3 launch stays on the prod thread. Roots
    are a pure function of each state's write set, so fan-out cannot
    change them."""
    states = [st for st in states if st is not None]
    fanned = []
    if exec_map is not None and len(states) > 1:
        # the same routing predicate begin_flush_deferred applies: only
        # states it serves on the host path cross to the pool
        host = [st for st in states
                if st._pending and (
                    st._engine is None
                    or len(st._pending) < st._engine_batch_min)]
        if len(host) > 1:
            host_ids = set(map(id, host))
            states = [st for st in states if id(st) not in host_ids]
            fanned = [h for h in exec_map(
                lambda st: st.begin_flush_deferred(), host)
                if h is not None]
    handles = fanned + [
        h for h in (st.begin_flush_deferred() for st in states)
        if h is not None]
    if not handles:
        return
    from plenum_tpu_torch.state.device_state import resolve_applies
    roots = resolve_applies(handles, use_device=use_device)
    for h, root in zip(handles, roots):
        h.state._trie.root_hash = root
