"""The port's SHA-256 (plenum_tpu_torch/ops/sha256.py) against the JAX
package's on the same inputs: host padding, the plain PyTorch compression
(the CPU side of the CUDA kernel's wrapper) against the Pallas kernel's
own body (`sha256_pallas._sha256_kernel`, run on numpy tiles laid out as
its pallas_call lays them out — the `numpy_field` way of
tests/test_ed25519_pallas.py, since interpret mode compiles for many
minutes on the CPU), against `_sha256_blocks`, the XLA twin of the
kernel, and against hashlib; the TreeHasher batch backend; the Merkle
level build (`sha256_node_levels`) against hashlib, the JAX package's node
hashing and merkle._node_blocks; and csrc/sha256.cu's node-level, ragged
and compress kernels compiled for the host by g++ (the `sha256_host`
fixture, which tests/test_torch_merkle.py shares). Tolerance: none —
arrays and digests must be equal."""
import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plenum_tpu.ops import merkle as jmerkle
from plenum_tpu.ops import sha256 as jsha
from plenum_tpu.ops import sha256_pallas as sp
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.ops import cuda_lib
from plenum_tpu_torch.ops import sha256 as tsha

CAVP = [  # NIST CAVP / FIPS 180-2 known-answer vectors
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (bytes.fromhex("d3"),
     "28969cdfa74a12c82f3bad960b0b000aca2ac329deea5c2328ebc6f2ba9802c1"),
    (bytes.fromhex("11af"),
     "5ca7133fa735326081558ac312c620eeca9970d1e70a4b95533d956f072d1f98"),
    (b"abc",
     "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1"),
    (b"abcdefghbcdefghicdefghijdefghijkefghijklfghijklmghijklmn"
     b"hijklmnoijklmnopjklmnopqklmnopqrlmnopqrsmnopqrstnopqrstu",
     "cf5b16a778af8380036ce59e7b0492370b249b11e8f07a51afac45037afee9d1"),
]

BOUNDARY = [0, 1, 55, 56, 63, 64, 65, 119, 120, 128, 300]


def _ragged(n, seed):
    rng = np.random.RandomState(seed)
    lens = [BOUNDARY[i % len(BOUNDARY)] if i % 3 else int(rng.randint(301))
            for i in range(n)]
    return [rng.randint(0, 256, size=ln, dtype=np.uint8).tobytes()
            for ln in lens]


def _plain(words, nvalid):
    dig = tsha.sha256_blocks(torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(nvalid))
    return dig.numpy().view(np.uint32)


@pytest.mark.parametrize("msgs", [
    [b"x" * 65] * 7,                       # uniform (merkle node shape)
    [b"\x00" + bytes(32)] * 3,
    _ragged(40, 1),                        # ragged, several block counts
    [b""],
])
def test_pad_messages_matches_jax(msgs):
    got = tsha.pad_messages(msgs)
    want = jsha.pad_messages(msgs)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


def test_cavp_vectors():
    msgs = [m for m, _ in CAVP]
    assert tsha.sha256_many(msgs, "cpu") == [bytes.fromhex(d)
                                             for _, d in CAVP]


@pytest.mark.parametrize("n,seed", [(64, 2), (1023, 3), (1024, 8), (1025, 4)])
def test_plain_matches_xla_and_hashlib(n, seed):
    msgs = _ragged(n, seed)
    words, nvalid, nblocks = tsha.pad_messages(msgs)
    got = _plain(words, nvalid)
    xla = np.asarray(jsha._sha256_blocks(jnp.asarray(words),
                                         jnp.asarray(nvalid), nblocks))
    np.testing.assert_array_equal(got, xla)
    want = [hashlib.sha256(m).digest() for m in msgs]
    assert tsha.digests_to_bytes(got) == want


@pytest.fixture
def numpy_kernel(monkeypatch):
    """Run the Pallas module's kernel code on numpy (no jax op dispatch)."""
    monkeypatch.setattr(sp, "jnp", np)


def _pallas_body(words, nvalid, nblocks):
    """sha256_pallas._sha256_kernel(nblocks) over [B, nblocks, 16] u32
    words and [B] i32 block counts, one BLOCK-message grid step at a time
    with _build_sha256's word-major [K, BLOCK_R, BLOCK_L] tiles →
    [B, 8] u32."""
    B = words.shape[0]
    pad = (-B) % sp.BLOCK
    flat = np.concatenate([words.reshape(B, nblocks * 16),
                           np.zeros((pad, nblocks * 16), np.uint32)])
    nv = np.concatenate([nvalid, np.ones(pad, np.int32)])
    kernel = sp._sha256_kernel(nblocks)
    out = []
    for lo in range(0, B + pad, sp.BLOCK):
        w_ref = flat[lo:lo + sp.BLOCK].T.reshape(
            nblocks * 16, sp.BLOCK_R, sp.BLOCK_L)
        nv_ref = nv[lo:lo + sp.BLOCK].reshape(1, sp.BLOCK_R, sp.BLOCK_L)
        out_ref = np.zeros((8, sp.BLOCK_R, sp.BLOCK_L), np.uint32)
        kernel(w_ref, nv_ref, out_ref)
        out.append(out_ref.reshape(8, sp.BLOCK).T)
    return np.concatenate(out)[:B]


@pytest.mark.parametrize("case", ["cavp", "ragged64", "ragged1023",
                                  "ragged1025"])
def test_plain_matches_pallas_kernel_body(numpy_kernel, case):
    msgs = {"cavp": [m for m, _ in CAVP], "ragged64": _ragged(64, 12),
            "ragged1023": _ragged(1023, 13),
            "ragged1025": _ragged(1025, 14)}[case]
    words, nvalid, nblocks = tsha.pad_messages(msgs)
    got = _plain(words, nvalid)
    np.testing.assert_array_equal(got, _pallas_body(words, nvalid, nblocks))
    assert tsha.digests_to_bytes(got) == [hashlib.sha256(m).digest()
                                          for m in msgs]


def test_node_pairs_match_jax():
    rng = np.random.RandomState(5)
    pairs = rng.randint(0, 256, size=(300, 64), dtype=np.uint8)
    got = tsha.sha256_node_pairs_array(pairs, "cpu")
    np.testing.assert_array_equal(got, jsha.sha256_node_pairs_array(pairs))
    words = tsha._node_words_from_digest_pairs(torch.from_numpy(pairs))
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(jsha._node_words_from_digest_pairs(jnp.asarray(pairs))))


def test_backend_matches_jax_backend():
    rng = random.Random(6)
    datas = [bytes(rng.randrange(256) for _ in range(rng.randrange(200)))
             for _ in range(300)]
    pairs = [(bytes(rng.randrange(256) for _ in range(32)),
              bytes(rng.randrange(256) for _ in range(32)))
             for _ in range(257)]
    port, ref = tsha.TorchSha256Backend("cpu"), jsha.JaxSha256Backend()
    assert port.leaf_hashes(datas) == ref.leaf_hashes(datas)
    assert port.leaf_hashes_collect(port.leaf_hashes_dispatch(datas)) == \
        ref.leaf_hashes_collect(ref.leaf_hashes_dispatch(datas))
    assert port.node_hashes(pairs) == ref.node_hashes(pairs)
    arr = np.frombuffer(b"".join(l + r for l, r in pairs),
                        dtype=np.uint8).reshape(-1, 64)
    np.testing.assert_array_equal(port.node_hashes_array(arr),
                                  ref.node_hashes_array(arr))


def _ragged_tensors(msgs):
    data, offsets = tsha.ragged_arrays(msgs)
    return torch.from_numpy(data.copy()), torch.from_numpy(offsets)


def _jax_digests(msgs):
    words, nvalid, nblocks = jsha.pad_messages(msgs)
    return np.asarray(jsha._sha256_blocks(jnp.asarray(words),
                                          jnp.asarray(nvalid), nblocks))


@pytest.mark.parametrize("prefix", [-1, 0x00, 0x01])
@pytest.mark.parametrize("case", ["cavp", "boundary", "ragged", "one_empty"])
def test_ragged_plain_matches_hashlib_and_jax(case, prefix):
    msgs = {"cavp": [m for m, _ in CAVP],
            "boundary": [bytes(i % 251 for i in range(ln)) for ln in BOUNDARY],
            "ragged": _ragged(97, 21), "one_empty": [b""]}[case]
    pre = b"" if prefix < 0 else bytes([prefix])
    got = tsha.sha256_ragged(*_ragged_tensors(msgs), prefix)
    got = got.numpy().view(np.uint32)
    assert tsha.digests_to_bytes(got) == [hashlib.sha256(pre + m).digest()
                                          for m in msgs]
    np.testing.assert_array_equal(got, _jax_digests([pre + m for m in msgs]))
    if case == "cavp" and prefix < 0:
        assert tsha.digests_to_bytes(got) == [bytes.fromhex(d)
                                              for _, d in CAVP]


def test_ragged_plain_offsets_into_a_larger_buffer():
    """Messages need not start at byte 0 nor fill the buffer, and a
    message may be empty between two others."""
    blob = bytes(range(200))
    offsets = torch.tensor([3, 3, 60, 61, 190], dtype=torch.int64)
    got = tsha.sha256_ragged_plain(torch.tensor(list(blob), dtype=torch.uint8),
                                   offsets, 0x00)
    want = [hashlib.sha256(b"\x00" + blob[a:b]).digest()
            for a, b in [(3, 3), (3, 60), (60, 61), (61, 190)]]
    assert tsha.digests_to_bytes(got.numpy().view(np.uint32)) == want


def test_ragged_empty_batch():
    data, offsets = _ragged_tensors([])
    assert tuple(tsha.sha256_ragged(data, offsets, 0).shape) == (0, 8)
    assert tsha.sha256_many([], "cpu") == []


def _launch_result(digests: np.ndarray, err: int, nbytes: int):
    """A Sha256Launch as the kernel leaves it, on a CPU buffer: the [B, 8]
    uint32 digest state, then the tail with the error word."""
    tail = np.zeros(tsha.TAIL_BYTES, dtype=np.uint8)
    tail[:4] = np.frombuffer(np.uint32(err).tobytes(), dtype=np.uint8)
    flat = np.ascontiguousarray(digests, dtype=np.uint32).view(np.uint8)
    buf = torch.from_numpy(np.concatenate([flat.reshape(-1), tail]))
    return tsha.Sha256Launch(buf, nbytes)


@pytest.mark.parametrize("offsets", [[0, 5, 4], [1, 11], [-1, 2], [0, 3, 12]])
def test_ragged_rejects_bad_offsets(offsets):
    """The plain version raises at once (check_ragged). The kernel's
    wrapper reads no offsets back (on CPU tensors it refuses them for
    their device alone); its kernel sets the error word, and the result's
    host copy raises with the same message."""
    data = torch.zeros(10, dtype=torch.uint8)
    off = torch.tensor(offsets, dtype=torch.int64)
    with pytest.raises(ValueError, match="offsets"):
        tsha.sha256_ragged(data, off, 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha.sha256_ragged_cuda(data, off, 0)
    rows = np.zeros((len(offsets) - 1, 8), dtype=np.uint32)
    with pytest.raises(ValueError, match="offsets"):
        tsha.to_host(_launch_result(rows, 1, 10))


def test_ragged_cuda_wrapper_rejects_cpu_tensors_and_bad_arguments():
    data, offsets = _ragged_tensors([b"abc", b"de"])
    with pytest.raises(ValueError, match="CUDA"):
        tsha.sha256_ragged_cuda(data, offsets, 0)
    with pytest.raises(ValueError, match="prefix"):
        tsha.sha256_ragged_cuda(data, offsets, 256)
    with pytest.raises(ValueError):
        tsha.sha256_ragged_cuda(data.to(torch.int32), offsets, 0)
    with pytest.raises(ValueError):
        tsha.sha256_ragged_cuda(data, offsets.to(torch.int32), 0)


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tsha.sha256_blocks_cuda(torch.zeros((2, 1, 15), dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):       # CPU tensors never reach the kernel
        tsha.sha256_blocks_cuda(torch.zeros((2, 1, 16), dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))


def test_ragged_cuda_wrapper_reads_no_offsets_back(monkeypatch):
    """The CUDA wrapper leaves the offsets to the kernel: it never calls
    check_ragged, whose read-back would wait for the card."""
    def read_back(*_):
        raise AssertionError("check_ragged called")
    monkeypatch.setattr(tsha, "check_ragged", read_back)
    data = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha.sha256_ragged_cuda(data, torch.tensor([5, 2]), 0x00)


def test_collect_raises_on_the_kernels_error_word():
    """A launch's digests reach the host through one checked copy: the
    collect of sha256_many, of the backend and of the TreeHasher's staged
    leaves return them while the error word is 0, and raise check_ragged's
    message before any digest is used when the kernel set it."""
    msgs = [b"abc", b"", b"x" * 100]
    words, _, _ = tsha.pad_messages(msgs)
    state = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                      .astype(np.uint32) for m in msgs])
    backend = tsha.TorchSha256Backend("cpu")
    hasher = TreeHasher(batch_backend=backend)
    want = [hashlib.sha256(m).digest() for m in msgs]
    assert tsha.sha256_many_collect(_launch_result(state, 0, 99)) == want
    assert backend.leaf_hashes_collect(_launch_result(state, 0, 99)) == want
    assert hasher.hash_leaves_collect(
        ("device", _launch_result(state, 0, 99))) == want
    message = "offsets must be non-decreasing and within the 99 data bytes"
    for collect in (tsha.sha256_many_collect, backend.leaf_hashes_collect,
                    lambda h: hasher.hash_leaves_collect(("device", h))):
        with pytest.raises(ValueError, match=message):
            collect(_launch_result(state, 1, 99))


def _levels_hashlib(digests: np.ndarray, levels: int):
    """The `levels` levels above `digests` ([n, 32] u8) with hashlib."""
    out, cur = [], [bytes(r) for r in digests]
    for _ in range(levels):
        cur = [hashlib.sha256(b"\x01" + cur[2 * i] + cur[2 * i + 1]).digest()
               for i in range(len(cur) // 2)]
        out.append(b"".join(cur))
    return out


def _digests(n, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(n, 32),
                                               dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 513])
def test_node_levels_plain_equals_hashlib(n):
    """Every level above n digests (levels 1..floor(log2 n), and one for
    n = 1, which has no parent), from the plain version and through the
    array entry on the CPU, against hashlib: an odd last child has no
    parent, and a level of one node ends the chain."""
    digests = _digests(n, 30 + n)
    levels = max(n.bit_length() - 1, 1)
    want = _levels_hashlib(digests, levels)
    flat = tsha.sha256_node_levels(torch.from_numpy(digests), levels)
    assert flat.dtype == torch.uint8
    assert flat.numpy().tobytes() == b"".join(want)
    got = tsha.sha256_node_levels_array(digests, levels, "cpu")
    assert [g.shape for g in got] == [(n >> k, 32)
                                      for k in range(1, levels + 1)]
    assert [g.tobytes() for g in got] == want


def test_node_levels_plain_equals_jax_level_by_level():
    """At 64 rows, each level of the plain version equals the JAX
    package's sha256_node_pairs_array on the level below it."""
    digests = _digests(64, 40)
    got = tsha.sha256_node_levels_array(digests, 6, "cpu")
    below = digests
    for level in got:
        np.testing.assert_array_equal(
            level, jsha.sha256_node_pairs_array(below.reshape(-1, 64)))
        below = level
    assert got[-1].shape == (1, 32)


def test_node_blocks_equal_jax_merkle_node_blocks():
    """The words of H(0x01 || l || r) equal plenum_tpu/ops/merkle.py's
    _node_blocks on 16 pairs of digest words."""
    words = _digests(32, 41).view(">u4").astype(np.uint32).reshape(32, 8)
    left, right = words[0::2], words[1::2]
    got = tsha._node_blocks(torch.from_numpy(left.astype(np.int64)),
                            torch.from_numpy(right.astype(np.int64)))
    want = np.asarray(jmerkle._node_blocks(jnp.asarray(left),
                                           jnp.asarray(right)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n,levels,wave,split", [
    (1 << 20, 20, 528, [2, 9, 9]),     # an H100's wave: 132 SMs x 4 CTAs
    (1 << 20, 20, 1 << 20, [9, 9, 2]),
    (1 << 18, 18, 528, [9, 9]),
    (1025, 10, 528, [9, 1]),
    (1025, 10, 1, [2, 8]),
    (1 << 21, 21, 528, [2, 2, 9, 8]),
    (5, 4, 528, [4]),                  # levels 3 and 4 hold no node
    (4, 4, 0, [2]),                    # no launch above a one-node level
    (1, 1, 528, []),
])
def test_node_level_split(n, levels, wave, split):
    """Two levels a launch while the grid spans more than one wave of
    CTAs, up to nine once it fits in one; no launch once a level holds one
    node."""
    assert tsha.node_level_split(n, levels, wave) == split


def test_node_levels_check_their_arguments():
    """levels >= 1 and [n, 32] uint8 rows; levels past the top are empty;
    the CUDA wrapper refuses CPU tensors (no kernel on the CPU)."""
    digests = torch.from_numpy(_digests(5, 42))
    with pytest.raises(ValueError, match="levels"):
        tsha.sha256_node_levels(digests, 0)
    with pytest.raises(ValueError):
        tsha.sha256_node_levels(digests.view(-1), 1)
    with pytest.raises(ValueError):
        tsha.sha256_node_levels(digests.to(torch.int32), 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha.sha256_node_levels_cuda(digests, 1)
    got = tsha.sha256_node_levels_array(digests.numpy(), 4, "cpu")
    assert [g.shape[0] for g in got] == [2, 1, 0, 0]


HOST_FLAGS = ["-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing",
              "-Wno-unknown-pragmas"]


@pytest.fixture(scope="session")
def sha256_host():
    """csrc/sha256_host.cpp (csrc/sha256.cu's kernels behind
    cuda_host_shim.h) built by g++ once: into plenum_tpu_torch/_build/
    under a hash of its sources and flags, so that both host-build test
    files and every xdist worker share one compile. → the executable."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    src = os.path.join(cuda_lib.CSRC, "sha256_host.cpp")
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    cuda_lib._hash_source(h, src)
    exe = os.path.join(cuda_lib.BUILD_DIR,
                       "sha256_host-" + h.hexdigest()[:16])
    if not os.path.exists(exe):
        os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
        tmp = "{}.{}.tmp".format(exe, os.getpid())
        subprocess.run([gxx] + HOST_FLAGS + ["-o", tmp, src], check=True)
        os.replace(tmp, exe)
    return exe


def test_host_build_of_the_kernels_equals_hashlib(tmp_path, sha256_host):
    """csrc/sha256.cu's node-level kernel, compiled for the host by g++
    behind cuda_host_shim.h (a std::thread per CUDA thread, __syncthreads
    and warp collectives through barriers) and chained as the CUDA wrapper
    chains its launches (node_level_split, with waves of one CTA and of
    many): every level at 1, 513, 1,025 and 2,049 children (CTA edges at
    512, launch edges at two and nine levels) against hashlib; and the
    ragged kernel's digests and its error word for invalid offsets."""
    exe = sha256_host
    for n in (1, 513, 1025, 2049):
        digests = _digests(n, 50 + n)
        levels = max(n.bit_length() - 1, 1)
        digests.tofile(tmp_path / "in")
        want = b"".join(_levels_hashlib(digests, levels))
        # a wave of one CTA: two-level launches while the grid has more
        for wave in (1, 1 << 20):
            split = tsha.node_level_split(n, levels, wave) or [levels]
            subprocess.run([exe, "levels", ",".join(map(str, split)),
                            str(tmp_path / "in"), str(tmp_path / "out")],
                           check=True)
            assert (tmp_path / "out").read_bytes() == want, (n, split)

    msgs = _ragged(40, 51)
    data, offsets = tsha.ragged_arrays(msgs)

    def ragged(offs):
        data.tofile(tmp_path / "data")
        np.asarray(offs, dtype=np.int64).tofile(tmp_path / "offsets")
        subprocess.run([exe, "ragged", "1", str(tmp_path / "data"),
                        str(tmp_path / "offsets"), str(tmp_path / "out")],
                       check=True)
        out = np.fromfile(tmp_path / "out", dtype=np.uint8)
        return out[:-16].view(np.uint32).reshape(-1, 8), \
            int(out[-16:-12].view(np.uint32)[0])

    state, err = ragged(offsets)
    assert err == 0
    assert tsha.digests_to_bytes(state) == [
        hashlib.sha256(b"\x01" + m).digest() for m in msgs]
    n = int(offsets[-1])
    for bad in ([-1] + list(offsets[1:]), list(offsets[:-1]) + [n + 1],
                [0, n, 1] + list(offsets[3:])):
        assert ragged(bad)[1] == 1


@pytest.mark.parametrize("B, nblocks", [(1, 1), (1, 2), (300, 2), (257, 4)])
def test_host_build_of_the_compress_kernel_equals_hashlib(tmp_path,
                                                          sha256_host, B,
                                                          nblocks):
    """csrc/sha256.cu's compress kernel under g++ (one thread a message,
    each loading its own blocks, its adds routed as the card runs them):
    B messages of pre-padded words, a B of one and Bs that are no multiple
    of its 256-thread CTA, some rows with nvalid < nblocks (a shorter
    message padded into a longer bucket; the words of its other blocks
    are noise) and one with nvalid 0 (the initial state), against hashlib
    and sha256_blocks_plain."""
    rng = np.random.RandomState(60 + B + nblocks)
    msgs = [rng.randint(0, 256, size=int(rng.randint(64 * nblocks - 8)),
                        dtype=np.uint8).tobytes() for _ in range(B)]
    words, nvalid, _ = tsha.pad_messages(msgs, nblocks)
    for i in range(B):           # noise past each message's own blocks
        words[i, nvalid[i]:] = rng.randint(0, 2 ** 32, size=(
            nblocks - nvalid[i], 16), dtype=np.uint64).astype(np.uint32)
    if B > 1:
        nvalid[B // 2] = 0
    words.tofile(tmp_path / "words")
    nvalid.tofile(tmp_path / "nvalid")
    subprocess.run([sha256_host, "compress", str(nblocks),
                    str(tmp_path / "words"), str(tmp_path / "nvalid"),
                    str(tmp_path / "out")], check=True)
    got = np.fromfile(tmp_path / "out", dtype=np.uint32).reshape(B, 8)
    np.testing.assert_array_equal(got, _plain(words, nvalid))
    want = [hashlib.sha256(m).digest() for m in msgs]
    iv = tsha.digests_to_bytes(tsha._IV[None, :])[0]
    if B > 1:
        want[B // 2] = iv
    assert tsha.digests_to_bytes(got) == want
