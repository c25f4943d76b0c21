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
compile cache; a launch here takes exactly the level's rows. A level that
clears the mesh gate (ops/mesh.py) is padded (row 0 repeated) to the
mesh's padded size and split over the devices, one launch a shard, each
with its own offsets and its own error word; the collect checks every
shard's word and cuts the rows to the level's. The routing gates stay the
callers' (Config.STATE_DEVICE_HASH_FLOOR / STATE_DEVICE_BATCH_MIN send
small levels to hashlib on the host).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from plenum_tpu_torch.ops import mesh as mesh_mod
from plenum_tpu_torch.ops import resolve_device
from plenum_tpu_torch.ops.sha256 import upload_ragged
from plenum_tpu_torch.ops.sha3 import (
    digests_to_bytes, sha3_ragged, sha3_ragged_eq, to_host)


class ShardedLevel:
    """A level split over the mesh: one launch (or plain result) a shard,
    in mesh order, and the level's real rows."""

    __slots__ = ("shards", "rows")

    def __init__(self, shards: list, rows: int):
        self.shards, self.rows = shards, rows

    def host(self) -> np.ndarray:
        """Every shard's checked copy (each raises on its own error word),
        concatenated and cut to the level's rows."""
        return np.concatenate([to_host(s) for s in self.shards])[:self.rows]


def _sharded(fn, blobs: Sequence[bytes], refs, dev, label: str):
    """The level split over the mesh if it clears the gate, else None (a
    passthrough): blobs (and their 32-byte `refs`) padded by repeating row
    0, each shard uploaded in the ragged layout on its device and passed
    to `fn`."""
    m = mesh_mod.get_mesh()
    b = len(blobs)
    if not m.should_shard(b, dev):
        m.note_passthrough(b)
        return None
    columns = [blobs] + ([refs] if refs is not None else [])
    arrays = []
    for col in columns:
        rows = np.empty(b, dtype=object)
        rows[:] = list(col)
        arrays.append(rows)
    outs = m.dispatch(
        fn, mesh_mod.pad_rows(arrays, m.padded_size(b)), n=b, label=label,
        place=lambda shard, d: upload_ragged(
            list(shard[0]), d, list(shard[1]) if len(shard) > 1 else ()))
    return ShardedLevel(outs, b)


def _host(handle) -> np.ndarray:
    return handle.host() if isinstance(handle, ShardedLevel) \
        else to_host(handle)


def dispatch_node_hash_batch(blobs: Sequence[bytes], device=None,
                             staging=None):
    """Start the SHA3-256 of one level of node blobs on `device` (None
    means CUDA), copied through the pinned buffer `staging` (an
    ops.sha256.PinnedStaging, or a fresh one); pair with
    collect_node_hash_batch. Returns once the launch is queued, without
    waiting for the card: the caller builds host work meanwhile."""
    if not blobs:
        return None
    dev = resolve_device(device)
    sharded = _sharded(sha3_ragged, blobs, None, dev, "state_sha3")
    if sharded is not None:
        return sharded
    return sha3_ragged(*upload_ragged(blobs, dev, staging=staging))


def collect_node_hash_batch(handle) -> np.ndarray:
    """Await a dispatch_node_hash_batch handle → [B, 32] u8 digests;
    raises ValueError if the kernel found invalid offsets."""
    if handle is None:
        return np.zeros((0, 32), dtype=np.uint8)
    return _host(handle)


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
    dev = resolve_device(device)
    sharded = _sharded(sha3_ragged_eq, blobs, expected, dev,
                       "state_sha3_verify")
    if sharded is not None:
        return sharded
    return sha3_ragged_eq(*upload_ragged(blobs, dev, expected, staging))


def collect_node_verify_batch(handle) -> np.ndarray:
    """Await a dispatch_node_verify_batch handle → [B] bool verdicts;
    raises ValueError if the kernel found invalid offsets."""
    if handle is None:
        return np.zeros((0,), dtype=bool)
    return _host(handle)


def hash_nodes(blobs: Sequence[bytes], device=None,
               staging=None) -> List[bytes]:
    """Synchronous convenience: SHA3-256 every blob in one launch."""
    return digests_to_bytes(collect_node_hash_batch(
        dispatch_node_hash_batch(blobs, device, staging)))
