"""The port's SHA-256 (plenum_tpu_torch/ops/sha256.py) against the JAX
package's on the same inputs: host padding, the plain PyTorch compression
(the CPU side of the CUDA kernel's wrapper) against the Pallas kernel's
own body (`sha256_pallas._sha256_kernel`, run on numpy tiles laid out as
its pallas_call lays them out — the `numpy_field` way of
tests/test_ed25519_pallas.py, since interpret mode compiles for many
minutes on the CPU), against `_sha256_blocks`, the XLA twin of the
kernel, and against hashlib; and the TreeHasher batch backend.
Tolerance: none — arrays and digests must be equal."""
import hashlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plenum_tpu.ops import sha256 as jsha
from plenum_tpu.ops import sha256_pallas as sp
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


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tsha.sha256_blocks_cuda(torch.zeros((2, 1, 15), dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):       # CPU tensors never reach the kernel
        tsha.sha256_blocks_cuda(torch.zeros((2, 1, 16), dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))
