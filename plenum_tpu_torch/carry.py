"""Carry a ledger, a device Merkle tree, a state trie, a verkey registry
and BLS signing keys across from the JAX package.

plenum_tpu has no weights: its state is the ledger (committed serialized
txns plus the hash store's leaf and node digests), the device Merkle
tree's levels, the MPT state (the trie's hash → RLP node blobs and its
head root), the verkey registry the authenticator reads and the nodes'
BLS keys. These functions build the port's objects from that state as
plain data, recomputing nothing.
"""
from typing import Dict, Iterable, Sequence, Tuple, Union

import numpy as np

from plenum_tpu_torch.crypto.batch_verifier import (
    CoalescingVerifierHub, TorchBatchVerifier)
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import MemoryHashStore
from plenum_tpu_torch.ledger.ledger import Ledger, _seq_key
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.ops.merkle import DeviceMerkleTree
from plenum_tpu_torch.ops.sha256 import TorchSha256Backend, digests_to_array
from plenum_tpu_torch.server.client_authn import CoreAuthNr
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory


def _node_keys(size: int):
    """The (start, height) keys of every full aligned subtree of a tree of
    `size` leaves, height 1 first, left to right within a height — the
    order of the `node_hashes` rows."""
    height = 1
    while size >> height:
        for i in range(size >> height):
            yield i << height, height
        height += 1


def arrays_from_hash_store(hash_store, size: int) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """(leaf_hashes [size, 32] u8, node_hashes [n, 32] u8) read from any
    hash store with read_leaf / read_subtree (the JAX package's or the
    port's), nodes in `_node_keys` order."""
    leaves = b"".join(hash_store.read_leaf(i) for i in range(size))
    nodes = b"".join(hash_store.read_subtree(s, h)
                     for s, h in _node_keys(size))
    return (np.frombuffer(leaves, dtype=np.uint8).reshape(-1, 32),
            np.frombuffer(nodes, dtype=np.uint8).reshape(-1, 32))


def ledger_from_arrays(txn_blobs: Sequence[bytes], leaf_hashes: np.ndarray,
                       node_hashes: np.ndarray, device=None) -> Ledger:
    """The port's Ledger holding `txn_blobs` (committed serialized txns,
    seqNo 1..n) with the given leaf and node digests in its hash store;
    the tree is loaded with load_from_hash_store, so nothing is hashed.
    Later appends hash through TorchSha256Backend on `device` (None means
    CUDA)."""
    n = len(txn_blobs)
    leaf_hashes = np.ascontiguousarray(leaf_hashes, dtype=np.uint8)
    node_hashes = np.ascontiguousarray(node_hashes, dtype=np.uint8)
    keys = list(_node_keys(n))
    if leaf_hashes.shape != (n, 32) or node_hashes.shape != (len(keys), 32):
        raise ValueError("expected {} leaf and {} node digests of 32 bytes, "
                         "got {} and {}".format(n, len(keys),
                                                leaf_hashes.shape,
                                                node_hashes.shape))
    hash_store = MemoryHashStore()
    for i in range(n):
        hash_store.write_leaf(i, leaf_hashes[i].tobytes())
    for (start, height), row in zip(keys, node_hashes):
        hash_store.write_subtree(start, height, row.tobytes())
    store = KeyValueStorageInMemory()
    for seq_no, blob in enumerate(txn_blobs, start=1):
        store.put(_seq_key(seq_no), bytes(blob))
    hasher = TreeHasher(batch_backend=TorchSha256Backend(device))
    return Ledger(tree=CompactMerkleTree(hasher, hash_store),
                  txn_store=store)


def merkle_tree_from_levels(levels: Sequence[np.ndarray], size: int,
                            device=None,
                            fused_levels: int = None) -> DeviceMerkleTree:
    """The port's DeviceMerkleTree holding a JAX DeviceMerkleTree's node
    hashes: `levels` its level arrays, leaves first (numpy [cap >> h, 8]
    uint32 digest words, np.asarray of each of its `_levels`), `size` its
    tree_size; nothing is hashed. The tree lives on `device` (None means
    CUDA); an empty list gives an empty tree."""
    tree = DeviceMerkleTree(device=device, fused_levels=fused_levels)
    if not levels:
        return tree
    cap = int(levels[0].shape[0])
    if len(levels) != cap.bit_length() or any(
            np.shape(lv) != (cap >> h, 8) for h, lv in enumerate(levels)):
        raise ValueError("expected levels of [cap >> h, 8] words for "
                         "h = 0..log2(cap), got {}".format(
                             [np.shape(lv) for lv in levels]))
    tree.load_levels(np.concatenate([digests_to_array(lv) for lv in levels]),
                     size)
    return tree


def authnr_from_registry(registry: Dict[str, str], verifier=None,
                         device=None) -> CoreAuthNr:
    """The port's CoreAuthNr knowing every identifier → verkey of
    `registry`; `verifier` defaults to a CoalescingVerifierHub over the
    batch verifier on `device` (None means CUDA)."""
    if verifier is None:
        verifier = CoalescingVerifierHub(batch=TorchBatchVerifier(device))
    authnr = CoreAuthNr(verifier=verifier)
    for identifier, verkey in registry.items():
        authnr.addIdr(identifier, verkey)
    return authnr


def state_from_nodes(nodes: Union[Iterable[Tuple[bytes, bytes]],
                                  Tuple[np.ndarray, np.ndarray, np.ndarray]],
                     head_root: bytes, committed_root: bytes = None,
                     device=None) -> PruningState:
    """The port's PruningState over a JAX PruningState's KV contents, its
    head at `head_root`; nothing is hashed. `nodes` is either the store's
    (key, value) bytes pairs (the node blobs under their 32-byte hashes,
    and the committed-root entry if the store has one) or three numpy
    arrays: node hashes [n, 32] u8, the blobs joined as one uint8 array
    and their int64 offsets [n + 1]. `committed_root`, when given, is
    written as the committed head. The state's device MPT engine runs on
    `device` (None means CUDA)."""
    kv = KeyValueStorageInMemory()
    if isinstance(nodes, tuple) and len(nodes) == 3 \
            and isinstance(nodes[0], np.ndarray):
        keys, data, offsets = nodes
        keys = np.ascontiguousarray(keys, dtype=np.uint8)
        offsets = np.asarray(offsets, dtype=np.int64)
        if keys.ndim != 2 or keys.shape[1] != 32 \
                or offsets.shape != (keys.shape[0] + 1,):
            raise ValueError("expected [n, 32] node hashes and [n + 1] "
                             "offsets, got {} and {}".format(keys.shape,
                                                             offsets.shape))
        raw = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
        kv.setBatch((keys[i].tobytes(), raw[offsets[i]:offsets[i + 1]])
                    for i in range(keys.shape[0]))
    else:
        kv.setBatch((bytes(k), bytes(v)) for k, v in nodes)
    if committed_root is not None:
        kv.put(PruningState.rootHashKey, bytes(committed_root))
    state = PruningState(kv)
    state.revertToHead(bytes(head_root))
    state.attach_device_engine(device=device)
    return state


def bls_signers(keys) -> list:
    """The port's BlsCryptoSignerPlenum for each of `keys`: a JAX
    package's BlsCryptoSignerPlenum (its secret scalar and base58 public
    key), or an (sk, pk) pair as crypto/bls.generate_bls_keys gives them.
    Keys and signatures are integers, bytes and base58 in both packages,
    so nothing converts: the port's signer signs byte for byte as the
    JAX package's does."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSignerPlenum
    out = []
    for key in keys:
        if isinstance(key, tuple):
            sk, pk = key[0], key[1]
        else:
            sk, pk = key._sk, key.pk
        out.append(BlsCryptoSignerPlenum(int(sk), str(pk)))
    return out
