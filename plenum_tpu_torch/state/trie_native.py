"""Native-trie wrapper: the C MPT (csrc/mpt_c.c) behind the same
interface as state/trie.py's Trie, so PruningState can swap backends.

The C module owns the node blobs (sha3 → RLP) and does all per-node
work; this wrapper keeps the durable-KV contract identical to the
Python trie: every node created by an operation is written through to
the KV store before the call returns, and on a node miss (fresh process
over an existing store, or nodes the device state engine wrote) the C
side hydrates lazily through a callback into the same KV. Roots are
bit-identical to the Python implementation (cross-checked in
tests/test_torch_native.py) — they are consensus state.
"""
from __future__ import annotations

from typing import List, Optional

from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext

_mpt = try_load_host_ext("mpt_c")
if _mpt is None:
    # honor the PLENUM_TPU_NO_NATIVE kill-switch (and environments where
    # the extension does not build): PruningState catches this import
    # failure and keeps the Python trie
    raise ImportError("native MPT unavailable or disabled")

BLANK_ROOT = _mpt.blank_root()


class NativeTrie:
    """Drop-in for state/trie.py's Trie over a KeyValueStorage."""

    def __init__(self, store, root_hash: Optional[bytes] = None):
        self._store = store

        def _miss(h: bytes):
            try:
                return bytes(store.get(h))
            except KeyError:
                return None

        self._h = _mpt.new(_miss)
        self.root_hash = bytes(root_hash) if root_hash is not None \
            else BLANK_ROOT

    # ---------------------------------------------------------- write

    def _flush(self):
        put = self._store.put
        for h, blob in _mpt.drain(self._h):
            put(h, blob)

    def set(self, key: bytes, value: bytes):
        self.root_hash = _mpt.set(self._h, self.root_hash, bytes(key),
                                  bytes(value))
        self._flush()

    def set_many(self, pairs):
        """Batched set (empty value deletes): one deferred-hash C pass —
        path nodes shared by the batch hash once, not once per key.
        Only the final root is a readable snapshot."""
        self.root_hash = _mpt.set_many(self._h, self.root_hash,
                                       list(pairs))
        self._flush()

    def delete(self, key: bytes):
        self.root_hash = _mpt.delete(self._h, self.root_hash, bytes(key))
        self._flush()

    # ----------------------------------------------------------- read

    def get(self, key: bytes) -> Optional[bytes]:
        return _mpt.get(self._h, self.root_hash, bytes(key))

    def get_at_root(self, root_hash: bytes, key: bytes) -> Optional[bytes]:
        return _mpt.get(self._h, bytes(root_hash), bytes(key))

    def produce_spv_proof(self, key: bytes,
                          root_hash: Optional[bytes] = None) -> List[bytes]:
        root = root_hash if root_hash is not None else self.root_hash
        return _mpt.proof(self._h, bytes(root), bytes(key))

    def items(self, root_hash: Optional[bytes] = None):
        root = root_hash if root_hash is not None else self.root_hash
        return iter(_mpt.items(self._h, bytes(root)))
