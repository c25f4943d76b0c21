from plenum_tpu_torch.ledger.tree_hasher import TreeHasher  # noqa: F401
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree  # noqa: F401
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier  # noqa: F401
from plenum_tpu_torch.ledger.ledger import Ledger  # noqa: F401
