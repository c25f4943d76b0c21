"""The port's Ledger (plenum_tpu_torch/ledger/) over TorchSha256Backend on
the CPU against plenum_tpu's Ledger over JaxSha256Backend, on the same
txns, with the TreeHasher threshold lowered so that both the scalar and
the batch paths run; and carry.ledger_from_arrays, which takes a JAX
ledger's state across without hashing; and the port's CompactMerkleTree
bulk build and extend (all levels in one seam call) against the reference
tree on hashlib. Tolerance: none — roots, hash store contents, frontiers
and audit paths must be byte-equal."""
import hashlib

import numpy as np
import pytest

from plenum_tpu.ledger.compact_merkle_tree import (
    CompactMerkleTree as JaxCompactMerkleTree)
from plenum_tpu.ledger.ledger import Ledger as JaxLedger
from plenum_tpu.ledger.tree_hasher import TreeHasher as JaxTreeHasher
from plenum_tpu.ops.sha256 import JaxSha256Backend
from plenum_tpu.storage.kv_memory import (
    KeyValueStorageInMemory as JaxKV)
from plenum_tpu_torch import carry
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.ops.sha256 import TorchSha256Backend
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory

THRESHOLD = 64
TXN_TIME = 1700000000


def _txns(lo, hi):
    """NYM-shaped txns lo..hi-1 (fresh dicts: ledgers stamp them)."""
    return [{"txn": {"type": "1",
                     "data": {"dest": "d%07d" % i, "verkey": "~v%d" % i},
                     "metadata": {"from": "author", "reqId": i}},
             "txnMetadata": {}, "reqSignature": {}, "ver": "1"}
            for i in range(lo, hi)]


def _port_ledger(store=None):
    hasher = TreeHasher(batch_backend=TorchSha256Backend("cpu"),
                        batch_threshold=THRESHOLD)
    return Ledger(tree_hasher=hasher, txn_store=store)


def _jax_ledger(store=None):
    hasher = JaxTreeHasher(batch_backend=JaxSha256Backend(),
                           batch_threshold=THRESHOLD)
    return JaxLedger(tree_hasher=hasher, txn_store=store)


def _stage(ledger, lo, hi):
    txns = ledger.append_txns_metadata(_txns(lo, hi), txn_time=TXN_TIME)
    return ledger.stage_txns_collect(ledger.stage_txns_dispatch(txns))[0]


def _blobs(ledger):
    return [bytes(v) for _, v in ledger._store.iterator()]


def _assert_same(port, ref, seq_nos):
    assert port.size == ref.size
    assert port.root_hash == ref.root_hash
    assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    assert _blobs(port) == _blobs(ref)
    got = carry.arrays_from_hash_store(port.tree.hash_store, port.size)
    want = carry.arrays_from_hash_store(ref.tree.hash_store, ref.size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port.merkleInfoBatch(seq_nos) == ref.merkleInfoBatch(seq_nos)


@pytest.fixture(scope="module")
def ledgers():
    """Both ledgers after the same history: scalar adds, staged batches
    (above and below the threshold), a partial commit, a discard and a
    final commit — 4,096 committed txns."""
    port, ref = _port_ledger(), _jax_ledger()
    assert isinstance(port.hasher._batch_backend, TorchSha256Backend)
    for txn_p, txn_r in zip(_txns(0, 40), _txns(0, 40)):
        assert port.add(txn_p) == ref.add(txn_r)
    for lo, hi in ((40, 1040), (1040, 1070), (1070, 2070)):
        assert _stage(port, lo, hi) == _stage(ref, lo, hi)
        assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    assert port.commitTxns(1000)[0] == ref.commitTxns(1000)[0]
    port.discardTxns(1000)
    ref.discardTxns(1000)
    assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    for lo, hi in ((1070, 2070), (2070, 3070), (3070, 4070)):
        assert _stage(port, lo, hi) == _stage(ref, lo, hi)
    assert port.commitTxns(port.uncommitted_size - port.size)[0] == \
        ref.commitTxns(ref.uncommitted_size - ref.size)[0]
    for txn_p, txn_r in zip(_txns(4070, 4096), _txns(4070, 4096)):
        assert port.add(txn_p) == ref.add(txn_r)
    return port, ref


SEQ_NOS = [1, 2, 39, 40, 41, 1000, 1071, 2048, 2049, 4095, 4096]


def test_history_matches_jax(ledgers):
    port, ref = ledgers
    assert port.size == 4096
    _assert_same(port, ref, SEQ_NOS)
    verifier = MerkleVerifier(port.hasher)
    root = port.root_hash_raw
    for info in port.merkleInfoBatch(SEQ_NOS):
        leaf = port.serialize_for_tree(port.getBySeqNo(info["seqNo"]))
        assert verifier.verify_leaf_inclusion(
            leaf, info["seqNo"] - 1,
            [port.strToHash(h) for h in info["auditPath"]], port.size,
            root)


@pytest.mark.parametrize("size", [4096, 3001])
def test_recover_from_txn_log_matches_jax(ledgers, size):
    port_src, ref_src = ledgers
    blobs = _blobs(ref_src)[:size]
    store_p, store_r = KeyValueStorageInMemory(), JaxKV()
    for seq_no, blob in enumerate(blobs, start=1):
        key = str(seq_no).zfill(20).encode()
        store_p.put(key, blob)
        store_r.put(key, blob)
    port, ref = _port_ledger(store_p), _jax_ledger(store_r)
    port.recoverTreeFromTxnLog()
    ref.recoverTreeFromTxnLog()
    _assert_same(port, ref, [1, 77, size // 2, size])


def test_carry_ledger_from_arrays_hashes_nothing(ledgers, monkeypatch):
    _, ref = ledgers
    leaves, nodes = carry.arrays_from_hash_store(ref.tree.hash_store,
                                                 ref.size)

    def refuse(*args, **kwargs):
        raise AssertionError("ledger_from_arrays must not hash")

    for name in ("hash_leaf", "hash_children", "hash_leaves",
                 "hash_leaves_dispatch", "hash_node_pairs",
                 "hash_node_pairs_array", "hash_node_levels_array"):
        monkeypatch.setattr(TreeHasher, name, refuse)
    port = carry.ledger_from_arrays(_blobs(ref), leaves, nodes,
                                    device="cpu")
    monkeypatch.undo()
    assert port.size == ref.size
    assert port.root_hash == ref.root_hash
    assert port.merkleInfoBatch(SEQ_NOS) == ref.merkleInfoBatch(SEQ_NOS)
    # later writes hash on the port's backend and stay in step
    _stage(port, 4096, 4200)
    _stage(ref, 4096, 4200)
    assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    ref.discardTxns(104)


def test_carry_rejects_mismatched_arrays(ledgers):
    _, ref = ledgers
    leaves, nodes = carry.arrays_from_hash_store(ref.tree.hash_store,
                                                 ref.size)
    with pytest.raises(ValueError):
        carry.ledger_from_arrays(_blobs(ref), leaves[:-1], nodes,
                                 device="cpu")


def _leaf_hashes(lo, hi):
    return [hashlib.sha256(b"\x00leaf %d" % i).digest() for i in range(lo, hi)]


@pytest.mark.parametrize("first,then", [(1023, 0), (1024, 0), (1025, 0),
                                        (4097, 0), (1025, 1025)])
def test_bulk_build_and_extend_match_reference(first, then, monkeypatch):
    """A port tree over TorchSha256Backend on the CPU (threshold 64, so the
    bulk build's levels go to the backend in one call) against the
    reference tree on hashlib: `first` leaves from empty (_bulk_build),
    then `then` more (_bulk_extend, one level a call). Roots, frontiers
    and every leaf and subtree entry of the hash stores are equal; the
    build makes exactly one hash_node_levels_array call (none below
    BULK_MIN = 1,024 leaves, which append one by one)."""
    calls = []
    levels_array = TreeHasher.hash_node_levels_array

    def counted(self, level, levels):
        calls.append((level.shape[0], levels))
        return levels_array(self, level, levels)
    monkeypatch.setattr(TreeHasher, "hash_node_levels_array", counted)
    port = CompactMerkleTree(TreeHasher(
        batch_backend=TorchSha256Backend("cpu"), batch_threshold=THRESHOLD))
    ref = JaxCompactMerkleTree(JaxTreeHasher())
    port.extend_hashes(_leaf_hashes(0, first))
    ref.extend_hashes(_leaf_hashes(0, first))
    bulk = first >= CompactMerkleTree.BULK_MIN
    assert calls == ([(first, first.bit_length() - 1)] if bulk else [])
    if then:
        port.extend_hashes(_leaf_hashes(first, first + then))
        ref.extend_hashes(_leaf_hashes(first, first + then))
        assert calls[1:] and all(levels == 1 for _, levels in calls[1:])
    size = first + then
    assert port.tree_size == ref.tree_size == size
    assert port.root_hash == ref.root_hash
    assert port._frontier == ref._frontier
    for got, want in zip(carry.arrays_from_hash_store(port.hash_store, size),
                         carry.arrays_from_hash_store(ref.hash_store, size)):
        np.testing.assert_array_equal(got, want)
