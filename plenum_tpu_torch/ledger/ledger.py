"""Ledger: merkle-hashed append-only transaction log with uncommitted
staging for 3PC apply/revert.

Reference: ledger/ledger.py:17 (base) + plenum/common/ledger.py (staging
subclass) — merged into one class here. Txns are msgpack-serialized into an
int-keyed KV store; each committed txn's leaf hash feeds the
CompactMerkleTree; uncommitted txns extend a shadow tree (root-only) so
state roots for PRE-PREPARE are available before commit.
"""
from typing import Dict, Generator, List, Optional, Tuple

from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.serialization import ledger_txn_serializer
from plenum_tpu_torch.common.txn_util import append_txn_metadata
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import MemoryHashStore
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.storage.kv_store import KeyValueStorage
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory

SEQ_NO_PAD = 20


def _seq_key(seq_no: int) -> bytes:
    return str(seq_no).zfill(SEQ_NO_PAD).encode()


class Ledger:
    def __init__(self,
                 tree: CompactMerkleTree = None,
                 txn_store: KeyValueStorage = None,
                 txn_serializer=None,
                 genesis_txn_initiator=None,
                 tree_hasher: TreeHasher = None):
        hasher = tree_hasher or TreeHasher()
        # `is not None`: an empty tree is falsy (len 0) and must be kept
        self.tree = tree if tree is not None \
            else CompactMerkleTree(hasher, MemoryHashStore())
        self.hasher = self.tree.hasher
        self._store = txn_store if txn_store is not None \
            else KeyValueStorageInMemory()
        self.txn_serializer = txn_serializer or ledger_txn_serializer
        self.genesis_txn_initiator = genesis_txn_initiator
        self.seqNo = 0
        # uncommitted staging (reference plenum/common/ledger.py)
        self.uncommittedTxns: List[dict] = []
        # (serialized, leaf_hash) per staged txn: the bytes that fed the
        # shadow tree ARE the bytes commit must store/hash — reusing
        # them both halves the serialization work and guarantees the
        # committed root equals the root the pool agreed on
        self._uncommitted_blobs: List[Tuple[bytes, bytes]] = []
        self.uncommittedTree: Optional[CompactMerkleTree] = None
        self.uncommittedRootHash: Optional[bytes] = None
        self.recoverTree()
        if self.size == 0 and genesis_txn_initiator is not None:
            for txn in genesis_txn_initiator():
                self.add(txn)

    # --------------------------------------------------------- recovery

    def recoverTree(self):
        """Rebuild tree state from the txn store (reference ledger.py:70)."""
        count = sum(1 for _ in self._store.iterator(include_value=False))
        if count == 0:
            self.seqNo = 0
            return
        try:
            self.tree.load_from_hash_store(count)
            self.seqNo = count
        except (ValueError, IndexError, KeyError):
            # the hash store lacks a frontier node: rebuild from the log
            self.recoverTreeFromTxnLog()

    def recoverTreeFromTxnLog(self):
        """Bulk rebuild: one batched leaf-hash dispatch plus level-wise
        node hashing through the TreeHasher device seam (reference
        ledger.py:70 recoverTree rebuilds leaf-by-leaf on hashlib)."""
        self.tree.reset()
        values = [bytes(v) for _, v in self._store.iterator()]
        self.tree.extend(values)
        self.seqNo = len(values)

    # ---------------------------------------------------------- commits

    def add_quiet(self, txn: dict) -> int:
        """Append a committed txn; returns its seqNo. The commit hot path:
        no merkle-info dict is built — Replies fetch proofs on demand via
        merkleInfo(seq_no), so computing root + audit-path b58 strings
        per append (reference ledger.py:115 does) is wasted work."""
        seq_no = self.seqNo + 1
        append_txn_metadata(txn, seq_no=seq_no)
        serialized = self.serialize_for_tree(txn)
        self.tree._append_hash(self.hasher.hash_leaf(serialized),
                               want_path=False)
        self._store.put(_seq_key(seq_no), serialized)
        self.seqNo = seq_no
        return seq_no

    def add(self, txn: dict) -> dict:
        """Append a committed txn; returns merkle info (seqNo, rootHash,
        auditPath) (reference ledger.py:115)."""
        seq_no = self.seqNo + 1
        append_txn_metadata(txn, seq_no=seq_no)
        serialized = self.serialize_for_tree(txn)
        audit_path = self.tree.append(serialized)
        self._store.put(_seq_key(seq_no), serialized)
        self.seqNo = seq_no
        return {
            'seqNo': seq_no,
            'rootHash': self.hashToStr(self.tree.root_hash),
            'auditPath': [self.hashToStr(h) for h in audit_path],
        }

    append = add

    # ----------------------------------------------- uncommitted staging

    def append_txns_metadata(self, txns: List[dict], txn_time: int = None):
        for i, txn in enumerate(txns):
            seq_no = self.uncommitted_size + i + 1
            append_txn_metadata(txn, seq_no=seq_no, txn_time=txn_time)
        return txns

    def appendTxns(self, txns: List[dict]) -> Tuple[Tuple[int, int], List[dict]]:
        """Stage txns: extend the shadow tree, track uncommitted root.
        Returns ((start, end), txns)."""
        return self.stage_txns_collect(self.stage_txns_dispatch(txns))

    def stage_txns_dispatch(self, txns: List[dict]):
        """Async half of appendTxns: serialize the batch and LAUNCH the
        leaf-hash computation (ONE seam dispatch, device-backed above
        the TreeHasher threshold) without syncing the digests — the
        fused per-3PC-batch dispatch overlaps the MPT pending-apply
        under this launch. No other staging may touch this ledger
        between dispatch and collect (the executor stages one batch at
        a time per ledger)."""
        if self.uncommittedTree is None:
            self.uncommittedTree = self.tree.copy_shadow()
        serialize = self.serialize_for_tree
        serialized_all = [serialize(txn) for txn in txns]
        return (txns, serialized_all,
                self.hasher.hash_leaves_dispatch(serialized_all))

    def stage_txns_collect(self, staged) -> Tuple[Tuple[int, int],
                                                  List[dict]]:
        """Blocking half of appendTxns: collect the launched leaf
        hashes and merge them into the shadow frontier (O(b log n)
        cheap host work)."""
        txns, serialized_all, handle = staged
        first = self.uncommitted_size + 1
        shadow_append = self.uncommittedTree._append_hash
        blob_append = self._uncommitted_blobs.append
        leaf_hashes = self.hasher.hash_leaves_collect(handle)
        for serialized, leaf_hash in zip(serialized_all, leaf_hashes):
            shadow_append(leaf_hash, want_path=False)
            blob_append((serialized, leaf_hash))
        self.uncommittedTxns.extend(txns)
        # root is NOT folded here: staging runs once per request, the
        # root is read once per batch — uncommitted_root_hash computes
        # it on demand (the tree caches by size)
        self.uncommittedRootHash = None
        last = self.uncommitted_size
        return (first, last), txns

    def commitTxns(self, count: int) -> Tuple[Tuple[int, int], List[dict]]:
        """Move the oldest `count` uncommitted txns into the durable log +
        real tree (reference plenum/common/ledger.py commitTxns). Commit
        replays the STAGED bytes/leaf hashes — txns are FIFO, their
        metadata (seq_no, time) was fixed at staging, and the agreed
        uncommitted root was computed from exactly these leaves."""
        committed = []
        first = self.seqNo + 1
        store_put, tree_append = self._store.put, self.tree._append_hash
        for txn, (serialized, leaf_hash) in zip(
                self.uncommittedTxns[:count],
                self._uncommitted_blobs[:count]):
            seq_no = self.seqNo + 1
            tree_append(leaf_hash, want_path=False)
            store_put(_seq_key(seq_no), serialized)
            self.seqNo = seq_no
            committed.append(txn)
        self.uncommittedTxns = self.uncommittedTxns[count:]
        self._uncommitted_blobs = self._uncommitted_blobs[count:]
        if not self.uncommittedTxns:
            self.uncommittedTree = None
            self.uncommittedRootHash = None
        # else: the shadow tree already contains exactly the leaves the
        # committed tree just gained plus the remaining staged txns — its
        # root is unchanged, so no rebuild is needed.
        return (first, self.seqNo), committed

    def discardTxns(self, count: int):
        """Drop the newest `count` uncommitted txns (batch revert)."""
        remaining = self.uncommittedTxns[:-count] if count else self.uncommittedTxns
        self.uncommittedTxns = []
        self._uncommitted_blobs = []
        self.uncommittedTree = None
        self.uncommittedRootHash = None
        if remaining:
            self.appendTxns(remaining)

    @property
    def uncommitted_size(self) -> int:
        return self.seqNo + len(self.uncommittedTxns)

    @property
    def uncommitted_root_hash(self) -> bytes:
        if self.uncommittedTree is not None:
            return self.uncommittedTree.root_hash
        if self.uncommittedRootHash is not None:
            return self.uncommittedRootHash
        return self.tree.root_hash

    # ------------------------------------------------------------ reads

    def getBySeqNo(self, seq_no: int) -> Optional[dict]:
        try:
            raw = self._store.get(_seq_key(seq_no))
        except KeyError:
            return None
        return self.txn_serializer.deserialize(raw)

    def get_by_seq_no_uncommitted(self, seq_no: int) -> Optional[dict]:
        if seq_no <= self.seqNo:
            return self.getBySeqNo(seq_no)
        idx = seq_no - self.seqNo - 1
        if idx < len(self.uncommittedTxns):
            return self.uncommittedTxns[idx]
        return None

    def __getitem__(self, seq_no: int):
        return self.getBySeqNo(seq_no)

    def getAllTxn(self, frm: int = None, to: int = None
                  ) -> Generator[Tuple[int, dict], None, None]:
        start = _seq_key(frm) if frm is not None else None
        end = _seq_key(to) if to is not None else None
        for key, value in self._store.iterator(start=start, end=end):
            yield int(key), self.txn_serializer.deserialize(value)

    def get_last_txn(self) -> Optional[dict]:
        return self.getBySeqNo(self.seqNo) if self.seqNo else None

    def get_last_committed_txn(self) -> Optional[dict]:
        return self.get_last_txn()

    @property
    def size(self) -> int:
        return self.seqNo

    def __len__(self):
        return self.size

    @property
    def root_hash(self) -> str:
        return self.hashToStr(self.tree.root_hash)

    @property
    def root_hash_raw(self) -> bytes:
        return self.tree.root_hash

    # ------------------------------------------------------------ proofs

    def merkleInfo(self, seq_no: int) -> Dict:
        """Inclusion proof of txn `seq_no` in the current tree (reference
        ledger.py:196)."""
        if not 0 < seq_no <= self.seqNo:
            raise ValueError("invalid seqNo {}".format(seq_no))
        path = self.tree.inclusion_proof(seq_no - 1, self.seqNo)
        return {
            'seqNo': seq_no,
            'rootHash': self.hashToStr(self.tree.root_hash),
            'auditPath': [self.hashToStr(h) for h in path],
        }

    def merkleInfoBatch(self, seq_nos) -> List[Dict]:
        """merkleInfo for many txns of one committed batch in one call:
        the audit paths share a subtree-hash memo AND a digest→b58 memo
        (the per-hash b58 string is recomputed across overlapping paths
        otherwise). Order matches `seq_nos`."""
        size = self.seqNo
        for s in seq_nos:
            if not 0 < s <= size:
                raise ValueError("invalid seqNo {}".format(s))
        paths = self.tree.inclusion_proofs_batch(
            [s - 1 for s in seq_nos], size)
        root = self.hashToStr(self.tree.root_hash)
        to_str = self.hashToStr
        str_memo: Dict[bytes, str] = {}

        def enc(h):
            s = str_memo.get(h)
            if s is None:
                s = str_memo[h] = to_str(h)
            return s

        return [{'seqNo': s, 'rootHash': root,
                 'auditPath': [enc(h) for h in path]}
                for s, path in zip(seq_nos, paths)]

    auditProof = merkleInfo

    # -------------------------------------------------------------- util

    def serialize_for_tree(self, txn: dict) -> bytes:
        return self.txn_serializer.serialize(txn)

    @staticmethod
    def hashToStr(h: bytes) -> str:
        return b58encode(h)

    @staticmethod
    def strToHash(s: str) -> bytes:
        return b58decode(s)

    def start(self, loop=None):
        pass

    def stop(self):
        self._store.close()
        self.tree.hash_store.close()

    def reset(self):
        self.tree.reset()
        self._store.drop()
        self.seqNo = 0
        self.uncommittedTxns = []
        self._uncommitted_blobs = []
        self.uncommittedTree = None
        self.uncommittedRootHash = None
