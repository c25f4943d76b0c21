"""State layer: Merkle Patricia Trie with committed/uncommitted heads and
SPV proofs (reference: state/ — State ABC state/state.py:5, PruningState
state/pruning_state.py:14, Trie state/trie/pruning_trie.py:215).
"""
from plenum_tpu_torch.state.trie import Trie, verify_proof
from plenum_tpu_torch.state.pruning_state import PruningState, State
from plenum_tpu_torch.state.device_state import (
    CorruptStateError, DeviceStateEngine)

__all__ = ["Trie", "verify_proof", "PruningState", "State",
           "DeviceStateEngine", "CorruptStateError"]
