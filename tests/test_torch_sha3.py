"""The port's SHA3-256 (plenum_tpu_torch/ops/sha3.py, the plain PyTorch
side of the CUDA kernel's wrapper) against hashlib and the JAX package's
ops/sha3.py on the same inputs: its padded lanes against
`pad_sha3_messages`' half-lane words, its digests against hashlib and
against `sha3_256_many` (at the 1- and 4-block buckets only: each bucket
is one XLA compile of a couple of seconds on the CPU), the fused compare
against flipped bytes, and ops/trie.py's seams. Tolerance: none — lanes,
digests and verdicts must be equal."""
import hashlib

import numpy as np
import pytest
import torch

from plenum_tpu.ops import sha3 as jsha3
from plenum_tpu_torch.ops import sha3 as tsha3
from plenum_tpu_torch.ops import trie as ttrie
from plenum_tpu_torch.ops.sha256 import upload_ragged

CPU = torch.device("cpu")
BOUNDARY = [0, 1, 135, 136, 137, 271, 272, 273, 530]


def _msgs(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=ln, dtype=np.uint8).tobytes()
            for ln in lens]


def _ragged(n, seed, top=600):
    rng = np.random.RandomState(seed)
    lens = [BOUNDARY[i % len(BOUNDARY)] if i % 2 else int(rng.randint(top))
            for i in range(n)]
    return _msgs(lens, seed + 1)


def _hashlib(msgs):
    return [hashlib.sha3_256(m).digest() for m in msgs]


@pytest.mark.parametrize("msgs", [
    _msgs(BOUNDARY, 1),
    [b"w" * 530] * 5,                  # uniform: a level of branch nodes
    [b""],
    _ragged(129, 2),
], ids=["boundary", "uniform", "empty", "ragged129"])
def test_padding_equals_pad_sha3_messages(msgs):
    """The plain version's padded lanes are the JAX host padding's words:
    lane = hi << 32 | lo, over the blocks the longest message needs (the
    JAX bucket's extra power-of-two blocks are zero)."""
    words, nvalid, nblocks = jsha3.pad_sha3_messages(msgs)
    w = words.astype(np.uint64)
    want = (w[..., 1] << np.uint64(32)) | w[..., 0]
    lanes, need = tsha3._pad_ragged(*upload_ragged(msgs, CPU))
    got = lanes.numpy().view(np.uint64)
    assert np.array_equal(need.numpy(), nvalid.astype(np.int64))
    assert np.array_equal(got, want[:, :got.shape[1]])
    assert not want[:, got.shape[1]:].any()


@pytest.mark.parametrize("msgs", [
    _msgs(BOUNDARY, 3),
    _ragged(1, 4), _ragged(127, 5), _ragged(128, 6), _ragged(129, 7),
    [bytes(range(200)) * 3],
], ids=["boundary", "B1", "B127", "B128", "B129", "one_long"])
def test_plain_equals_hashlib(msgs):
    assert tsha3.sha3_256_many(msgs, device="cpu") == _hashlib(msgs)


@pytest.mark.parametrize("lens", [
    [0, 1, 64, 100, 135],              # 1-block bucket
    [300, 407, 408, 530, 543],         # 4-block bucket (branch nodes)
], ids=["bucket1", "bucket4"])
def test_plain_equals_jax_sha3_256_many(lens):
    msgs = _msgs(lens, 8)
    assert tsha3.sha3_256_many(msgs, device="cpu") == \
        jsha3.sha3_256_many(msgs)


def test_eq_variant_flags_flipped_blob_and_ref_bytes():
    msgs = _ragged(40, 9)
    refs = _hashlib(msgs)
    data, offsets, ref_t = upload_ragged(msgs, CPU, refs)
    assert tsha3.sha3_ragged_eq(data, offsets, ref_t).all()
    bad_ref = ref_t.clone()
    bad_ref[7, 31] ^= 0x01
    blob = data.clone()
    start = int(offsets[12])
    assert int(offsets[13]) > start, "message 12 must not be empty"
    blob[start] ^= 0x80
    ok_ref = tsha3.sha3_ragged_eq(data, offsets, bad_ref)
    ok_blob = tsha3.sha3_ragged_eq(blob, offsets, ref_t)
    assert ok_ref.tolist() == [i != 7 for i in range(40)]
    assert ok_blob.tolist() == [i != 12 for i in range(40)]


def test_wrappers_check_their_arguments():
    data, offsets = upload_ragged([b"abc", b"de"], CPU)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsha3.sha3_ragged(data, torch.tensor([0, 4, 2]))
    with pytest.raises(ValueError, match="refs"):
        tsha3.sha3_ragged_eq(data, offsets,
                             torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha3.sha3_ragged_cuda(data, offsets)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha3.sha3_ragged_eq_cuda(data, offsets,
                                  torch.zeros((2, 32), dtype=torch.uint8))
    assert tsha3.sha3_ragged(data, offsets[:1]).shape == (0, 32)


def test_trie_seams_match_hashlib():
    blobs = _ragged(33, 10)
    refs = _hashlib(blobs)
    assert ttrie.hash_nodes(blobs, device="cpu") == refs
    digs = ttrie.collect_node_hash_batch(
        ttrie.dispatch_node_hash_batch(blobs, device="cpu"))
    assert digs.tobytes() == b"".join(refs)
    refs[4] = bytes(32)
    ok = ttrie.collect_node_verify_batch(
        ttrie.dispatch_node_verify_batch(blobs, refs, device="cpu"))
    assert ok.tolist() == [i != 4 for i in range(33)]
    assert ttrie.hash_nodes([], device="cpu") == []
    assert ttrie.collect_node_verify_batch(
        ttrie.dispatch_node_verify_batch([], [], device="cpu")).shape == (0,)
