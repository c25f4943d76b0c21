"""The port's SHA3-256 (plenum_tpu_torch/ops/sha3.py, the plain PyTorch
side of the CUDA kernel's wrapper) against hashlib and the JAX package's
ops/sha3.py on the same inputs: its padded lanes against
`pad_sha3_messages`' half-lane words, its digests against hashlib and
against `sha3_256_many` (at the 1- and 4-block buckets only: each bucket
is one XLA compile of a couple of seconds on the CPU), the fused compare
against flipped bytes, and ops/trie.py's seams; the collect path's
reading of the kernel's error word; and csrc/sha3.cu itself, built for
the host with g++ behind csrc/cuda_host_shim.h, against hashlib.
Tolerance: none — lanes, digests and verdicts must be equal."""
import hashlib
import os
import shutil
import subprocess

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


# Mixed 1- and 4-block messages (the trie's leaves and branch nodes).
MIXED = [530, 0, 135, 408, 100, 543, 1, 134]


@pytest.mark.parametrize("B", [1, 5, 6, 7, 31, 32, 33])
def test_mixed_blocks_equal_hashlib_and_jax(B):
    """Across the kernel's group (5 lanes, 6 messages a warp) and warp (32)
    boundaries. The JAX side runs in chunks of five, each topped up to
    five with 4-block messages: the one (5, 4-block) bucket that
    test_plain_equals_jax_sha3_256_many compiles."""
    msgs = _msgs([MIXED[i % len(MIXED)] for i in range(B)], 11 + B)
    got = tsha3.sha3_256_many(msgs, device="cpu")
    assert got == _hashlib(msgs)
    filler = _msgs([530] * 4, 12)
    jax = []
    for lo in range(0, B, 5):
        chunk = msgs[lo:lo + 5]
        jax += jsha3.sha3_256_many(chunk + filler[:5 - len(chunk)])[
            :len(chunk)]
    assert got == jax


def _launch_result(rows: np.ndarray, err: int, verdicts: bool):
    """A Sha3Launch as the kernel leaves it, on a CPU buffer: the rows,
    then the tail with the error word."""
    tail = np.zeros(tsha3.TAIL_BYTES, dtype=np.uint8)
    tail[:4] = np.frombuffer(np.uint32(err).tobytes(), dtype=np.uint8)
    flat = rows.reshape(-1).view(np.uint8)
    if verdicts:
        flat = np.concatenate([flat, np.zeros(-len(flat) % 16, np.uint8)])
    buf = torch.from_numpy(np.concatenate([flat, tail]))
    return tsha3.Sha3Launch(buf, rows.shape[0], 99, verdicts)


OFFSETS_MESSAGE = "offsets must be non-decreasing and within the 99 data bytes"


def test_collect_raises_on_the_kernels_error_word():
    """The trie seams' collect copies a launch's buffer once and raises
    before any row is used when the kernel set its error word; the plain
    path raises the same message at once (check_ragged)."""
    digs = np.arange(3 * 32, dtype=np.uint8).reshape(3, 32)
    oks = np.array([True, False, True])
    assert ttrie.collect_node_hash_batch(
        _launch_result(digs, 0, False)).tobytes() == digs.tobytes()
    assert ttrie.collect_node_verify_batch(
        _launch_result(oks, 0, True)).tolist() == [True, False, True]
    with pytest.raises(ValueError, match=OFFSETS_MESSAGE):
        ttrie.collect_node_hash_batch(_launch_result(digs, 1, False))
    with pytest.raises(ValueError, match=OFFSETS_MESSAGE):
        ttrie.collect_node_verify_batch(_launch_result(oks, 1, True))
    data = torch.arange(99, dtype=torch.uint8)
    for offs in ([-1, 3], [5, 2], [0, 100]):
        with pytest.raises(ValueError, match=OFFSETS_MESSAGE):
            tsha3.to_host(tsha3.sha3_ragged(data, torch.tensor(offs)))
        with pytest.raises(ValueError, match=OFFSETS_MESSAGE):
            tsha3.to_host(tsha3.sha3_ragged_eq(
                data, torch.tensor(offs), torch.zeros((1, 32),
                                                      dtype=torch.uint8)))


def test_cuda_wrappers_read_no_offsets_back(monkeypatch):
    """The CUDA wrappers leave the offsets to the kernel: they never call
    check_ragged, whose read-back would wait for the card."""
    def read_back(*_):
        raise AssertionError("check_ragged called")
    monkeypatch.setattr(tsha3, "check_ragged", read_back)
    data = torch.zeros(16, dtype=torch.uint8)
    bad = torch.tensor([5, 2])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha3.sha3_ragged_cuda(data, bad)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha3.sha3_ragged_eq_cuda(data, bad, torch.zeros((1, 32),
                                                         dtype=torch.uint8))
    assert tsha3.lanes_for(tsha3.GROUP_MAX_ROWS) == 5
    assert tsha3.lanes_for(tsha3.GROUP_MAX_ROWS + 1) == 1


def test_host_build_of_the_kernel_equals_hashlib(tmp_path):
    """csrc/sha3.cu's kernel in both layouts (1 and 5 lanes a message) and
    both entries, compiled for the host by g++ behind cuda_host_shim.h
    (a std::thread per CUDA thread, shuffles through barriers): digests
    and verdicts at the absorb boundaries, over the group and warp
    boundaries (33 rows), and the error word for invalid offsets."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel for the host")
    csrc = os.path.join(os.path.dirname(tsha3.__file__), os.pardir, "csrc")
    exe = str(tmp_path / "sha3_host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread",
                    "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-o", exe,
                    os.path.join(csrc, "sha3_host.cpp")], check=True)

    def run(lanes, msgs, offsets=None, refs=None):
        data, offs = (a.numpy() for a in upload_ragged(msgs, CPU))
        data.tofile(tmp_path / "data")
        (offs if offsets is None else np.asarray(offsets, np.int64)) \
            .tofile(tmp_path / "offsets")
        args = [exe, str(lanes), str(int(refs is not None)),
                str(tmp_path / "data"), str(tmp_path / "offsets")]
        if refs is not None:
            np.frombuffer(b"".join(refs), np.uint8).tofile(tmp_path / "refs")
            args.append(str(tmp_path / "refs"))
        subprocess.run(args + [str(tmp_path / "out")], check=True)
        out = np.fromfile(tmp_path / "out", dtype=np.uint8)
        return out[:-16], int(out[-16:-12].view(np.uint32)[0])

    msgs = _msgs([BOUNDARY[i % len(BOUNDARY)] for i in range(33)], 13)
    want = _hashlib(msgs)
    refs = list(want)
    refs[16] = bytes(32)
    for lanes in (1, 5):
        rows, err = run(lanes, msgs)
        assert err == 0 and rows.tobytes() == b"".join(want)
        rows, err = run(lanes, msgs, refs=refs)
        assert err == 0 and rows[:33].tolist() == [i != 16 for i in range(33)]
    n = len(b"".join(msgs[2:4]))
    for offsets in ([-1, 0, n], [0, n, 1], [0, 1, n + 1]):
        assert run(5, msgs[2:4], offsets)[1] == 1
