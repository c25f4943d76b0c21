"""Batched MPT node hashing on the device — the trie's dispatch seam.

Port of plenum_tpu/ops/trie_jax.py. The state engine
(state/device_state.py) decomposes many key walks, or a whole batch's
dirty-node writes, into LEVELS of independent node blobs; every level
becomes ONE SHA3-256 launch through this module (ops/sha3.py, kernel
csrc/sha3.cu):

 - ``dispatch_node_hash_batch`` / ``collect_node_hash_batch``: hash a
   level of RLP node blobs; digests come back as one [B, 32] uint8
   buffer (apply path — the digests become the child refs of the next
   level up).
 - ``dispatch_node_verify_batch`` / ``collect_node_verify_batch``:
   hash AND compare against expected refs in the same launch; only a
   [B] bool verdict crosses back (read/proof path — a corrupted store
   can never serve a value or proof that does not hash to its ref).

A dispatch uploads the level and launches; it reads nothing back, so
the host goes on while the card hashes (as the JAX seam's dispatch
does). The collect makes the one device→host copy of the launch's
buffer, which also carries the kernel's error word: a level whose
offsets were invalid raises ValueError there, before any of its rows is
used.

The JAX package padded each level's batch to a power of two for XLA's
compile cache and sharded large levels over a device mesh; a launch here
takes exactly the level's rows on one card. The routing gates stay the
callers' (Config.STATE_DEVICE_HASH_FLOOR / STATE_DEVICE_BATCH_MIN send
small levels to hashlib on the host).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from plenum_tpu_torch.ops import resolve_device
from plenum_tpu_torch.ops.sha256 import upload_ragged
from plenum_tpu_torch.ops.sha3 import (
    digests_to_bytes, sha3_ragged, sha3_ragged_eq, to_host)


def dispatch_node_hash_batch(blobs: Sequence[bytes], device=None,
                             staging=None):
    """Start the SHA3-256 of one level of node blobs on `device` (None
    means CUDA), copied through the pinned buffer `staging` (an
    ops.sha256.PinnedStaging, or a fresh one); pair with
    collect_node_hash_batch. Returns once the launch is queued, without
    waiting for the card: the caller builds host work meanwhile."""
    if not blobs:
        return None
    return sha3_ragged(*upload_ragged(blobs, resolve_device(device),
                                      staging=staging))


def collect_node_hash_batch(handle) -> np.ndarray:
    """Await a dispatch_node_hash_batch handle → [B, 32] u8 digests;
    raises ValueError if the kernel found invalid offsets."""
    if handle is None:
        return np.zeros((0, 32), dtype=np.uint8)
    return to_host(handle)


def dispatch_node_verify_batch(blobs: Sequence[bytes],
                               expected: Sequence[bytes], device=None,
                               staging=None):
    """Start the fused hash+compare of node blobs against their 32-byte
    refs; pair with collect_node_verify_batch."""
    if not blobs:
        return None
    if len(expected) != len(blobs):
        raise ValueError("{} blobs but {} refs".format(len(blobs),
                                                       len(expected)))
    return sha3_ragged_eq(*upload_ragged(blobs, resolve_device(device),
                                         expected, staging))


def collect_node_verify_batch(handle) -> np.ndarray:
    """Await a dispatch_node_verify_batch handle → [B] bool verdicts;
    raises ValueError if the kernel found invalid offsets."""
    if handle is None:
        return np.zeros((0,), dtype=bool)
    return to_host(handle)


def hash_nodes(blobs: Sequence[bytes], device=None,
               staging=None) -> List[bytes]:
    """Synchronous convenience: SHA3-256 every blob in one launch."""
    return digests_to_bytes(collect_node_hash_batch(
        dispatch_node_hash_batch(blobs, device, staging)))
