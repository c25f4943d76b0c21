"""Batched SHA-256 on the device — the merkle tree's hash path.

Port of plenum_tpu/ops/sha256.py (host padding, digest packing, the
`TreeHasher` batch backend) and plenum_tpu/ops/sha256_pallas.py (the
compression kernel, now csrc/sha256.cu). Message padding happens on the
host (numpy, data-dependent lengths); the device sees [B, nblocks, 16]
big-endian uint32 words plus a per-message block count, and the kernel
hashes each message's own blocks. uint32 words travel in int32 tensors
(the same bit patterns): PyTorch's uint32 support is partial.

`sha256_blocks` launches the CUDA kernel on a CUDA tensor and runs the
plain PyTorch version, `sha256_blocks_plain`, on a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from plenum_tpu_torch.ops import (
    check_arg, cuda_lib, resolve_device, scatter_ragged_rows, to_tensor,
    u32_as_i32)

_IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_M32 = 0xFFFFFFFF


# ------------------------------------------------- the plain version

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: List[torch.Tensor], w: List[torch.Tensor]):
    """One SHA-256 compression on int64 tensors holding uint32 values:
    state is 8 [B] tensors, w the 16 message words (the rolling schedule
    window, extended in place)."""
    a, b, c, d, e, f, g, h = state
    w = list(w)
    for t in range(64):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        s1e = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = (h + s1e + ch + int(_K[t]) + w[t]) & _M32
        s0a = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0a + maj
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                  (t1 + t2) & _M32)
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks_plain(words: torch.Tensor,
                        nvalid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA-256 of pre-padded messages: words [B, nblocks, 16]
    int32 (uint32 bit patterns), nvalid [B] int32 → digest state [B, 8]
    int32. Works on int64 tensors masked to 32 bits; rows whose message has
    fewer blocks keep their state (the TPU kernel's masked loop)."""
    w64 = words.to(torch.int64) & _M32
    nv = nvalid.to(torch.int64)
    B, nblocks = int(words.shape[0]), int(words.shape[1])
    state = [torch.full((B,), int(v), dtype=torch.int64, device=words.device)
             for v in _IV]
    for blk in range(nblocks):
        new = _compress(state, [w64[:, blk, j] for j in range(16)])
        live = blk < nv
        state = [torch.where(live, n_, s_) for n_, s_ in zip(new, state)]
    return u32_as_i32(torch.stack(state, dim=1))


# ------------------------------------------------------- the kernel

def sha256_blocks_cuda(words: torch.Tensor,
                       nvalid: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (csrc/sha256.cu) on CUDA tensors, same arguments and
    result as sha256_blocks_plain. Launches on the current stream without
    synchronising; counts each launch in `sha256_blocks_cuda.launches`."""
    if words.dim() != 3 or words.shape[2] != 16:
        raise ValueError("words must be [B, nblocks, 16], got {}".format(
            tuple(words.shape)))
    B, nblocks = int(words.shape[0]), int(words.shape[1])
    dev = words.device
    if dev.type != "cuda" or nvalid.device != dev:
        raise ValueError("sha256_blocks_cuda needs CUDA tensors on one "
                         "device, got {} and {}".format(dev, nvalid.device))
    check_arg(words, "words", torch.int32, (B, nblocks, 16))
    check_arg(nvalid, "nvalid", torch.int32, (B,))
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = cuda_lib.load("sha256")
    fn = lib.sha256_compress
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(words.data_ptr(), nvalid.data_ptr(), out.data_ptr(),
                 B, nblocks, stream)
    if err != 0:
        raise RuntimeError("sha256_compress launch failed: CUDA error "
                           "{}".format(err))
    sha256_blocks_cuda.launches += 1
    return out


sha256_blocks_cuda.launches = 0


def sha256_blocks(words: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """[B, nblocks, 16] words + [B] block counts → [B, 8] digest state.
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    if words.device.type == "cuda":
        return sha256_blocks_cuda(words, nvalid)
    if words.device.type == "cpu":
        return sha256_blocks_plain(words, nvalid)
    raise ValueError("unsupported device {}".format(words.device))


# --------------------------------------------------- host-side helpers

def pad_messages(msgs: Sequence[bytes], nblocks: int = None
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """SHA-pad `msgs` into ([B, nblocks, 16] u32 big-endian words, [B] i32
    block counts, nblocks); nblocks defaults to the power of two that holds
    the longest message (the JAX package's bucket)."""
    need = [(len(m) + 9 + 63) // 64 for m in msgs]
    maxb = max(need) if need else 1
    if nblocks is None:
        nblocks = 1
        while nblocks < maxb:
            nblocks *= 2
    if maxb > nblocks:
        raise ValueError("a message needs {} blocks, more than {}".format(
            maxb, nblocks))
    ln0 = len(msgs[0]) if msgs else 0
    uniform = bool(msgs) and all(len(m) == ln0 for m in msgs)
    if not msgs or uniform:
        out = np.zeros((len(msgs), nblocks * 64), dtype=np.uint8)
    if uniform:
        # uniform lengths (merkle node hashes, fixed-size leaves): one
        # vectorized fill instead of a per-message loop
        out[:, :ln0] = np.frombuffer(b"".join(msgs), dtype=np.uint8) \
            .reshape(len(msgs), ln0)
        out[:, ln0] = 0x80
        end = need[0] * 64
        out[:, end - 8:end] = np.frombuffer(
            (ln0 * 8).to_bytes(8, "big"), dtype=np.uint8)
    elif msgs:
        # mixed lengths: one flat vectorized scatter; the block count only
        # decides where each row's 64-bit length field lands
        width = nblocks * 64
        out, lens = scatter_ragged_rows(msgs, width)
        flat = out.reshape(-1)
        rows = np.arange(len(msgs), dtype=np.int64)
        flat[rows * width + lens] = 0x80
        ends = np.asarray(need, dtype=np.int64) * 64
        bits = lens * 8
        base = rows * width + ends - 8
        for k in range(8):
            flat[base + k] = (bits >> (8 * (7 - k))) & 0xff
    words = out.reshape(len(msgs), nblocks, 16, 4)
    words = (words[..., 0].astype(np.uint32) << 24
             | words[..., 1].astype(np.uint32) << 16
             | words[..., 2].astype(np.uint32) << 8
             | words[..., 3].astype(np.uint32))
    return words, np.asarray(need, dtype=np.int32), nblocks


def digests_to_bytes(dig: np.ndarray) -> List[bytes]:
    """[B, 8] u32 → list of 32-byte digests."""
    flat = digests_to_array(dig).tobytes()
    return [flat[i:i + 32] for i in range(0, len(flat), 32)]


def digests_to_array(dig: np.ndarray) -> np.ndarray:
    """[B, 8] u32 → [B, 32] u8 big-endian digest bytes."""
    arr = np.ascontiguousarray(np.asarray(dig).astype(">u4"))
    return arr.view(np.uint8).reshape(-1, 32)


def _from_device(dig: torch.Tensor) -> np.ndarray:
    """[B, 8] int32 device digests → [B, 8] u32 numpy (waits for them)."""
    return dig.cpu().numpy().view(np.uint32)


def _node_words_from_digest_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """[m, 64] uint8 rows (left||right digest bytes) → [m, 2, 16] int32
    SHA-padded words of H(0x01 || left || right), built on the pairs'
    device."""
    m = int(pairs.shape[0])
    msg = torch.zeros((m, 128), dtype=torch.int64, device=pairs.device)
    msg[:, 0] = 0x01
    msg[:, 1:65] = pairs
    msg[:, 65] = 0x80
    msg[:, 126] = (65 * 8) >> 8       # 64-bit big-endian bit length 520
    msg[:, 127] = (65 * 8) & 0xff
    b = msg.view(m, 32, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]
    return u32_as_i32(words).view(m, 2, 16)


def sha256_node_pairs_array(pairs: np.ndarray, device=None) -> np.ndarray:
    """[m, 64] u8 rows of left||right digests → [m, 32] u8 node digests
    H(0x01||l||r). Digest bytes stay in arrays end to end."""
    dev = resolve_device(device)
    pairs = np.ascontiguousarray(pairs, dtype=np.uint8).reshape(-1, 64)
    m = pairs.shape[0]
    words = _node_words_from_digest_pairs(to_tensor(pairs, dev))
    nvalid = torch.full((m,), 2, dtype=torch.int32, device=dev)
    return digests_to_array(_from_device(sha256_blocks(words, nvalid)))


def sha256_many(msgs: Sequence[bytes], device=None) -> List[bytes]:
    """Batched SHA-256 over arbitrary same-or-mixed-length messages."""
    return sha256_many_collect(sha256_many_dispatch(msgs, device))


def sha256_many_dispatch(msgs: Sequence[bytes], device=None):
    """Async half of sha256_many: host padding + device LAUNCH, no result
    sync, so the caller can overlap independent host work before
    sha256_many_collect pulls the bytes."""
    dev = resolve_device(device)
    if not msgs:
        return None
    words, nvalid, _ = pad_messages(msgs)
    return sha256_blocks(to_tensor(words, dev), to_tensor(nvalid, dev))


def sha256_many_collect(handle) -> List[bytes]:
    """Blocking half: digests of a sha256_many_dispatch launch."""
    if handle is None:
        return []
    return digests_to_bytes(_from_device(handle))


class TorchSha256Backend:
    """Batch backend for `TreeHasher` (ledger/tree_hasher.py seam) on one
    device: `device=None` means CUDA."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def leaf_hashes(self, datas: Sequence[bytes]) -> List[bytes]:
        return sha256_many([b"\x00" + d for d in datas], self.device)

    def leaf_hashes_dispatch(self, datas: Sequence[bytes]):
        """Launch-only half of leaf_hashes (fused-dispatch seam)."""
        return sha256_many_dispatch([b"\x00" + d for d in datas],
                                    self.device)

    def leaf_hashes_collect(self, handle) -> List[bytes]:
        return sha256_many_collect(handle)

    def node_hashes(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
        return sha256_many([b"\x01" + l + r for l, r in pairs], self.device)

    def node_hashes_array(self, pairs: np.ndarray) -> np.ndarray:
        """[m, 64] u8 (left||right) → [m, 32] u8 — the array seam for
        level-wise bulk tree building."""
        return sha256_node_pairs_array(pairs, self.device)
