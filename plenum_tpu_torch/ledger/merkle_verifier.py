"""Client/catchup-side merkle proof verification (reference:
ledger/merkle_verifier.py — RFC 6962 verification algorithms).

Batch verification of many audit paths (catchup reps) is exposed via
`verify_leaf_inclusion_batch`, which routes the leaf hashing through the
TreeHasher device seam.
"""
from typing import Sequence, Tuple

from plenum_tpu_torch.ledger.tree_hasher import TreeHasher


class ProofError(Exception):
    pass


class MerkleVerifier:
    def __init__(self, hasher: TreeHasher = None):
        self.hasher = hasher or TreeHasher()

    # ------------------------------------------------------- inclusion

    def calculate_root_from_audit_path(self, leaf_hash: bytes,
                                       leaf_index: int, tree_size: int,
                                       audit_path: Sequence[bytes]) -> bytes:
        fn, sn = leaf_index, tree_size - 1
        r = leaf_hash
        for p in audit_path:
            if sn == 0:
                raise ProofError("audit path too long")
            if fn & 1 or fn == sn:
                r = self.hasher.hash_children(p, r)
                if not fn & 1:
                    while fn & 1 == 0 and fn != 0:
                        fn >>= 1
                        sn >>= 1
            else:
                r = self.hasher.hash_children(r, p)
            fn >>= 1
            sn >>= 1
        if sn != 0:
            raise ProofError("audit path too short")
        return r

    def verify_leaf_hash_inclusion(self, leaf_hash: bytes, leaf_index: int,
                                   audit_path: Sequence[bytes],
                                   tree_size: int, root_hash: bytes) -> bool:
        calc = self.calculate_root_from_audit_path(
            leaf_hash, leaf_index, tree_size, audit_path)
        if calc != root_hash:
            raise ProofError(
                "inclusion check failed: calculated {} expected {}"
                .format(calc.hex(), root_hash.hex()))
        return True

    def verify_leaf_inclusion(self, leaf: bytes, leaf_index: int,
                              audit_path: Sequence[bytes],
                              tree_size: int, root_hash: bytes) -> bool:
        return self.verify_leaf_hash_inclusion(
            self.hasher.hash_leaf(leaf), leaf_index, audit_path,
            tree_size, root_hash)

    def verify_leaf_inclusion_batch(
            self, items: Sequence[Tuple[bytes, int, Sequence[bytes]]],
            tree_size: int, root_hash: bytes) -> bool:
        """Verify many (leaf, index, audit_path) against one root — the
        catchup-rep hot path. Leaf hashing batches through the device seam;
        path folding is per-item (paths differ in shape)."""
        leaf_hashes = self.hasher.hash_leaves([leaf for leaf, _, _ in items])
        for leaf_hash, (_, idx, path) in zip(leaf_hashes, items):
            self.verify_leaf_hash_inclusion(leaf_hash, idx, path,
                                            tree_size, root_hash)
        return True

    # ----------------------------------------------------- consistency

    def verify_tree_consistency(self, old_tree_size: int, new_tree_size: int,
                                old_root: bytes, new_root: bytes,
                                proof: Sequence[bytes]) -> bool:
        if old_tree_size < 0 or new_tree_size < 0:
            raise ValueError("negative tree size")
        if old_tree_size > new_tree_size:
            raise ProofError("old size {} > new size {}"
                             .format(old_tree_size, new_tree_size))
        if old_tree_size == new_tree_size:
            if old_root != new_root:
                raise ProofError("inconsistency: same size, different roots")
            return True
        if old_tree_size == 0:
            return True  # anything is consistent with the empty tree
        # RFC 9162 §2.1.4.2 verification
        proof = list(proof)
        if old_tree_size & (old_tree_size - 1) == 0:
            # old tree was a full subtree: its root is an implicit first
            # proof element
            proof = [old_root] + proof
        if not proof:
            raise ProofError("empty consistency proof")
        fn, sn = old_tree_size - 1, new_tree_size - 1
        while fn & 1:
            fn >>= 1
            sn >>= 1
        fr = sr = proof[0]
        for c in proof[1:]:
            if sn == 0:
                raise ProofError("consistency proof too long")
            if fn & 1 or fn == sn:
                fr = self.hasher.hash_children(c, fr)
                sr = self.hasher.hash_children(c, sr)
                while fn & 1 == 0 and fn != 0:
                    fn >>= 1
                    sn >>= 1
            else:
                sr = self.hasher.hash_children(sr, c)
            fn >>= 1
            sn >>= 1
        if fr != old_root:
            raise ProofError("consistency check failed for old root")
        if sr != new_root:
            raise ProofError("consistency check failed for new root")
        if sn != 0:
            raise ProofError("consistency proof too short")
        return True

    @staticmethod
    def audit_path_length(index: int, tree_size: int) -> int:
        length = 0
        last_node = tree_size - 1
        while last_node > 0:
            if index & 1 or index < last_node:
                length += 1
            index >>= 1
            last_node >>= 1
        return length
