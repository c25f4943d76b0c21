"""Batched SHA-256 on the device — the merkle tree's hash path.

Port of plenum_tpu/ops/sha256.py (digest packing, the `TreeHasher` batch
backend), of plenum_tpu/ops/sha256_pallas.py (the compression kernel, now
csrc/sha256.cu) and of the node hashing of plenum_tpu/ops/merkle.py
(`_node_blocks`, `_hash_pairs`, `_build_levels_from_digest_bytes`). uint32
words travel in int32 tensors (the same bit patterns): PyTorch's uint32
support is partial.

Three entries share the kernel's compression:

- `sha256_ragged`: raw messages as one flat uint8 buffer, int64 offsets
  [B + 1] and an optional one-byte domain prefix; the card pads. Leaves,
  node pairs given as bytes and `sha256_many` go through it. The host
  joins the messages once and copies them from a pinned staging buffer.
  On the card it reads nothing back: the kernel checks the offsets and
  the result's `host()` raises for invalid ones.
- `sha256_node_levels`: the RFC 6962 levels above a level of 32-byte
  digests, up to NODE_LEVELS levels a launch, the levels staying on the
  card between launches. The Merkle level build goes through it
  (`sha256_node_levels_array`: one upload, one copy back).
- `sha256_blocks`: pre-padded [B, nblocks, 16] words and per-message block
  counts, the literal counterpart of the TPU kernel; no path of the port
  calls it.

Each launches its CUDA kernel on CUDA tensors and runs its plain PyTorch
version (`sha256_ragged_plain`, `sha256_node_levels_plain`,
`sha256_blocks_plain`) on CPU tensors. `pad_messages`, the JAX package's
host padding, stays for the tests that hold the two packages' padded
words equal.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from plenum_tpu_torch.ops import (
    TAIL_BYTES, check_arg, check_ragged, check_ragged_layout, cuda_lib,
    launch_rows, resolve_device, scatter_ragged_rows, to_tensor, u32_as_i32)

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
NODE_LEVELS = 9          # the most levels a sha256_node_levels launch climbs
NODE_WAVE_LEVELS = 2     # ... while its grid spans more than one wave

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {          # csrc/sha256.cu's C entries, set once at load
    "sha256_compress": [_P, _P, _P, _I, _I, _P],
    "sha256_ragged": [_P, _I64, _P, _I, _P, _P, _I, _I, _P],
    "sha256_node_levels_wave": [ctypes.POINTER(_I)],
    "sha256_node_levels": [_P, _I64, _P, _I, _P],
    "sha256_append_groups": [ctypes.POINTER(_P), ctypes.POINTER(_I64),
                             ctypes.POINTER(_I64), ctypes.POINTER(_I), _I,
                             _P, ctypes.POINTER(_I)],
}


def _lib() -> ctypes.CDLL:
    """libsha256, its entries' argtypes set when it first loads."""
    return cuda_lib.load("sha256", _SIGNATURES)


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
    """The CUDA kernel (csrc/sha256.cu, sha256_compress) on CUDA tensors,
    `words` starting on a 16-byte boundary, same arguments and result as
    sha256_blocks_plain. Launches on the current stream without
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
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary")
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sha256_compress(words.data_ptr(), nvalid.data_ptr(),
                                     out.data_ptr(), B, nblocks, stream)
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


# ------------------------------------------ raw messages: ragged entry

_PAD_CHUNK = 1 << 15        # messages padded at a time by the plain version


def _pad_ragged(data: torch.Tensor, offsets: torch.Tensor, prefix: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SHA-pad prefix || data[offsets[i]:offsets[i + 1]] for each i with
    torch: → ([B, nblocks, 16] int32 big-endian words, [B] int32 block
    counts), nblocks the longest message's."""
    plen = 1 if prefix >= 0 else 0
    start = offsets[:-1].unsqueeze(1)
    lens = (offsets[1:] - offsets[:-1]).unsqueeze(1)
    total = lens + plen
    need = (total + 9 + 63) // 64
    width = 64 * int(need.max())
    p = torch.arange(width, dtype=torch.int64, device=data.device)
    pos = p - plen
    keep = (pos >= 0) & (pos < lens)
    if data.shape[0]:
        src = (start + pos).clamp(0, data.shape[0] - 1)
        msg = torch.where(keep, data[src].to(torch.int64), 0)
    else:
        msg = torch.zeros(keep.shape, dtype=torch.int64, device=data.device)
    if plen:
        msg[:, 0] = prefix
    msg = torch.where(p == total, 0x80, msg)
    bits = total * 8
    end = need * 64
    for k in range(8):
        msg.scatter_(1, end - 8 + k, (bits >> (8 * (7 - k))) & 0xff)
    b = msg.view(msg.shape[0], width // 64, 16, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]
    return u32_as_i32(words), need[:, 0].to(torch.int32)


def _check_out(out: torch.Tensor, rows: int, device) -> None:
    """Raise unless `out` is a contiguous [rows, 32] uint8 tensor on
    `device` starting on a 16-byte boundary: where a kernel writes 32-byte
    big-endian digests in place."""
    check_arg(out, "out", torch.uint8, (rows, 32))
    if out.device != device:
        raise ValueError("out lies on {}, the input on {}".format(
            out.device, device))
    if out.data_ptr() % 16:
        raise ValueError("out must start on a 16-byte boundary")


def sha256_ragged_plain(data: torch.Tensor, offsets: torch.Tensor,
                        prefix: int = -1,
                        out: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch SHA-256 of prefix || data[offsets[i]:offsets[i + 1]]
    (no prefix when prefix is -1): data [n] uint8, offsets [B + 1] int64 →
    digest state [B, 8] int32; or, given `out` ([B, 32] uint8), the digests'
    big-endian bytes written into it, and `out` returned. Pads with torch,
    a chunk of messages at a time, and runs sha256_blocks_plain."""
    B = check_ragged(data, offsets, prefix)
    if out is not None:
        _check_out(out, B, data.device)
    parts = [torch.empty((0, 8), dtype=torch.int32, device=data.device)]
    for lo in range(0, B, _PAD_CHUNK):
        hi = min(lo + _PAD_CHUNK, B)
        parts.append(sha256_blocks_plain(
            *_pad_ragged(data, offsets[lo:hi + 1], prefix)))
    state = torch.cat(parts)
    if out is None:
        return state
    out.copy_(_be_bytes(state.to(torch.int64) & _M32))
    return out


class Sha256Launch:
    """A sha256_ragged launch in flight: `buf`, its output on the card
    (B * 32 digest-state bytes, then TAIL_BYTES whose first uint32 is the
    kernel's error word; the tail alone when the digests went to an `out`
    tensor), and the byte count of the data (for the error's message)."""

    __slots__ = ("buf", "nbytes")

    def __init__(self, buf: torch.Tensor, nbytes: int):
        self.buf, self.nbytes = buf, nbytes

    @property
    def digests(self) -> torch.Tensor:
        """The [B, 8] int32 digest state on the card, unchecked (a row with
        invalid offsets is hashed as empty)."""
        return self.buf[:-TAIL_BYTES].view(torch.int32).view(-1, 8)

    def host(self) -> np.ndarray:
        """One device→host copy (it waits for the launch) → [B, 8] uint32
        digest state. Raises ValueError, with check_ragged's message, when
        a row's offsets were invalid."""
        return launch_rows(self.buf, self.nbytes).view(np.uint32) \
            .reshape(-1, 8)


def sha256_ragged_cuda(data: torch.Tensor, offsets: torch.Tensor,
                       prefix: int = -1,
                       out: torch.Tensor = None) -> Sha256Launch:
    """The CUDA kernel's ragged entry (csrc/sha256.cu, sha256_ragged) on
    CUDA tensors, the function of sha256_ragged_plain. Checks what needs
    no read-back (the ragged layout, CUDA tensors, data on a 16-byte
    boundary), launches on the current stream and returns without
    synchronising; the kernel checks the offsets and the result's host()
    reports them. Given `out` ([B, 32] uint8 on the card), the kernel
    writes the digests' big-endian bytes there (a tree's leaf level in
    place) and the launch's buf is the error tail alone.
    Counts each launch in `sha256_ragged_cuda.launches`."""
    B = check_ragged_layout(data, offsets, prefix)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError("sha256_ragged_cuda needs CUDA tensors, got "
                         "{}".format(dev))
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary")
    if out is not None:
        _check_out(out, B, dev)
    nbytes = int(data.shape[0])
    if B == 0:
        return Sha256Launch(torch.zeros((TAIL_BYTES,), dtype=torch.uint8,
                                        device=dev), nbytes)
    if out is None:
        buf = torch.empty((32 * B + TAIL_BYTES,), dtype=torch.uint8,
                          device=dev)
        rows, tail = buf.data_ptr(), buf.data_ptr() + 32 * B
    else:
        buf = torch.empty((TAIL_BYTES,), dtype=torch.uint8, device=dev)
        rows, tail = out.data_ptr(), buf.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sha256_ragged(data.data_ptr(), nbytes,
                                   offsets.data_ptr(), prefix, rows, tail, B,
                                   int(out is not None), stream)
    if err != 0:
        raise RuntimeError("sha256_ragged launch failed: CUDA error "
                           "{}".format(err))
    sha256_ragged_cuda.launches += 1
    return Sha256Launch(buf, nbytes)


sha256_ragged_cuda.launches = 0


def sha256_ragged(data: torch.Tensor, offsets: torch.Tensor,
                  prefix: int = -1, out: torch.Tensor = None
                  ) -> Union[Sha256Launch, torch.Tensor]:
    """Flat bytes + [B + 1] offsets (+ prefix byte) → [B, 8] digest state
    (or, given `out`, the big-endian digests written into it): a
    Sha256Launch for CUDA tensors (the kernel), a tensor for CPU tensors
    (the plain version). `to_host` takes either."""
    if data.device.type == "cuda":
        return sha256_ragged_cuda(data, offsets, prefix, out)
    if data.device.type == "cpu":
        return sha256_ragged_plain(data, offsets, prefix, out)
    raise ValueError("unsupported device {}".format(data.device))


# ------------------------------------ Merkle levels above 32-byte digests

def _be_words(digests: torch.Tensor) -> torch.Tensor:
    """[m, 32] uint8 digests → [m, 8] int64 big-endian words."""
    b = digests.to(torch.int64).view(-1, 8, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]


def _be_bytes(words: torch.Tensor) -> torch.Tensor:
    """[m, 8] int64 words (uint32 values) → [m, 32] uint8 big-endian."""
    parts = [(words >> s) & 0xff for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=2).reshape(-1, 32).to(torch.uint8)


def _node_blocks(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[m, 8], [m, 8] int64 digest words → [m, 2, 16] int32 SHA-padded
    words of H(0x01 || left || right), as plenum_tpu/ops/merkle.py's
    _node_blocks forms them."""
    l8, lc = left >> 8, (left & 0xff) << 24
    r8, rc = right >> 8, (right & 0xff) << 24
    ws = [(0x01 << 24) | l8[:, 0]]
    ws += [lc[:, i - 1] | l8[:, i] for i in range(1, 8)]
    ws.append(lc[:, 7] | r8[:, 0])
    ws += [rc[:, i - 1] | r8[:, i] for i in range(1, 8)]
    ws.append(rc[:, 7] | (0x80 << 16))
    zeros = torch.zeros_like(ws[0])
    ws += [zeros] * 14 + [torch.full_like(zeros, 65 * 8)]
    return u32_as_i32(torch.stack(ws, dim=1)).view(-1, 2, 16)


def _level_rows(digests: torch.Tensor, levels: int) -> List[int]:
    """Check a level-build input ([n, 32] contiguous uint8, levels >= 1) →
    the node counts of levels 1..levels, n >> k."""
    if digests.dim() != 2:
        raise ValueError("digests must be [n, 32], got {}".format(
            tuple(digests.shape)))
    n = int(digests.shape[0])
    check_arg(digests, "digests", torch.uint8, (n, 32))
    if levels < 1:
        raise ValueError("levels must be at least 1, got {}".format(levels))
    return [n >> k for k in range(1, levels + 1)]


def _hash_pairs_plain(left: torch.Tensor, right: torch.Tensor
                      ) -> torch.Tensor:
    """[m, 8] int64 digest words of left and right children → [m, 8]
    int64 words of their parents H(0x01 || left || right), through
    _node_blocks and sha256_blocks_plain."""
    nvalid = torch.full((left.shape[0],), 2, dtype=torch.int32,
                        device=left.device)
    return sha256_blocks_plain(_node_blocks(left, right),
                               nvalid).to(torch.int64) & _M32


def sha256_node_levels_plain(digests: torch.Tensor, levels: int,
                             out: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch Merkle levels: [n, 32] uint8 digests → levels
    1..levels one after another as [sum of n >> k, 32] uint8 digests,
    parent i of a level being H(0x01 || child 2i || child 2i + 1) (an odd
    last child has no parent), written into `out` when it is given. Forms
    each level's words as _node_blocks does and runs sha256_blocks_plain."""
    rows = _level_rows(digests, levels)
    if out is not None:
        _check_out(out, sum(rows), digests.device)
    cur = _be_words(digests)
    parts = []
    for m in rows:
        cur = _hash_pairs_plain(cur[0:2 * m:2], cur[1:2 * m:2])
        parts.append(_be_bytes(cur))
    if out is None:
        return torch.cat(parts)
    out.copy_(torch.cat(parts))
    return out


def node_level_split(n: int, levels: int, wave: int) -> List[int]:
    """Levels per sha256_node_levels launch for `levels` levels above n
    children, `wave` being the CTAs the card holds at once: a launch's
    CTAs (256 threads, 512 children each) reach their upper levels, where
    few threads work and a level costs its latency, together, once a wave;
    so a launch climbs NODE_WAVE_LEVELS while its grid spans more than one
    wave, and up to NODE_LEVELS once it fits in one. Launches stop at the
    level of one node. 2^20 leaves, 20 levels, 528 CTAs a wave: [2, 9, 9]."""
    split, done = [], 0
    while done < levels and n >> done >= 2:
        ctas = -(-(n >> done >> 1) // 256)
        lv = NODE_WAVE_LEVELS if ctas > wave else NODE_LEVELS
        split.append(min(lv, levels - done))
        done += split[-1]
    return split


_node_waves = {}        # device index → CTAs of the level kernel in a wave


def _node_wave(lib, dev: torch.device) -> int:
    """CTAs of the level kernel that `dev` holds at once (CUDA's occupancy
    for its 256 threads, times the SMs), asked once per device."""
    from plenum_tpu_torch.ops.mesh import device_index
    index = device_index(dev)
    if index not in _node_waves:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.sha256_node_levels_wave(ctypes.byref(ctas))
        if err != 0 or ctas.value < 1:
            raise RuntimeError("sha256_node_levels_wave failed: CUDA error "
                               "{}".format(err))
        _node_waves[index] = ctas.value
    return _node_waves[index]


def sha256_node_levels_cuda(digests: torch.Tensor, levels: int,
                            out: torch.Tensor = None) -> torch.Tensor:
    """The CUDA kernel (csrc/sha256.cu, sha256_node_levels) on a CUDA
    tensor starting on a 16-byte boundary, the function of
    sha256_node_levels_plain (into `out` when it is given, [sum of n >> k,
    32] uint8 on the card). Enqueues the launches of node_level_split on
    the current stream, each fed the last level of the one before inside
    the output, and returns without synchronising. Counts each launch in
    `sha256_node_levels_cuda.launches`."""
    rows = _level_rows(digests, levels)
    dev = digests.device
    if dev.type != "cuda":
        raise ValueError("sha256_node_levels_cuda needs CUDA tensors, got "
                         "{}".format(dev))
    if digests.data_ptr() % 16:
        raise ValueError("digests must start on a 16-byte boundary")
    if out is None:
        out = torch.empty((sum(rows), 32), dtype=torch.uint8, device=dev)
    else:
        _check_out(out, sum(rows), dev)
    lib = _lib()
    fn = lib.sha256_node_levels
    n = int(digests.shape[0])
    src, n_in, at, done = digests.data_ptr(), n, 0, 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lv in node_level_split(n, levels, _node_wave(lib, dev)):
            err = fn(src, n_in, out.data_ptr() + 32 * at, lv, stream)
            if err != 0:
                raise RuntimeError("sha256_node_levels launch failed: CUDA "
                                   "error {}".format(err))
            sha256_node_levels_cuda.launches += 1
            last = at + sum(rows[done:done + lv - 1])
            src, n_in = out.data_ptr() + 32 * last, rows[done + lv - 1]
            at = last + n_in
            done += lv
    return out


sha256_node_levels_cuda.launches = 0


def sha256_node_levels(digests: torch.Tensor, levels: int,
                       out: torch.Tensor = None) -> torch.Tensor:
    """[n, 32] uint8 digests → levels 1..levels, [sum of n >> k, 32] uint8
    (written into `out` when it is given). CUDA tensors go through the
    kernel, CPU tensors through the plain version."""
    if digests.device.type == "cuda":
        return sha256_node_levels_cuda(digests, levels, out)
    if digests.device.type == "cpu":
        return sha256_node_levels_plain(digests, levels, out)
    raise ValueError("unsupported device {}".format(digests.device))


# ------------------------------- appends: new parents of a growing tree

APPEND_LEVELS_MAX = 16    # levels of one group of an append
APPEND_LAUNCH_LEVELS = 9  # levels of one launch: a larger group is split


def _append_windows(child: torch.Tensor, parents: Sequence[torch.Tensor],
                    windows: Sequence[Tuple[int, int]],
                    max_levels: int = APPEND_LEVELS_MAX) -> None:
    """Raise unless `child` and `parents` are contiguous [rows, 32] uint8
    tensors on one device and `windows` [(p0, cnt)], one per parent
    level (1 to max_levels of them), an append's: cnt >= 1 at the first
    level, each window's children inside the window below or stored before
    it (p0 >= p0 below >> 1, 2 (p0 + cnt) <= p0 + cnt below), every row
    inside its level."""
    if not 1 <= len(parents) == len(windows) <= max_levels:
        raise ValueError("expected 1 to {} parent levels with a window "
                         "each, got {} and {}".format(
                             max_levels, len(parents), len(windows)))
    dev = child.device
    below_p0, below_end = 0, 0
    for j, t in enumerate([child] + list(parents)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or not t.is_contiguous():
            raise ValueError("level {}: expected contiguous torch.uint8 "
                             "[rows, 32], got {} {}{}".format(
                                 j, t.dtype, tuple(t.shape),
                                 "" if t.is_contiguous()
                                 else " (not contiguous)"))
        if t.device != dev:
            raise ValueError("the levels lie on {} and {}".format(
                dev, t.device))
        if j == 0:
            below_end = t.shape[0]
            continue
        p0, cnt = windows[j - 1]
        end = p0 + cnt
        if cnt < (1 if j == 1 else 0) or p0 < below_p0 >> 1 \
                or 2 * end > below_end or end > t.shape[0]:
            raise ValueError("window {} of level {} is not an append's "
                             "above [{}, {})".format(
                                 (p0, cnt), j, below_p0, below_end))
        below_p0, below_end = p0, end


def _group_sizes(levels: int, k: int) -> List[int]:
    """The levels of each group of an append of `levels` parent levels, k
    (1..APPEND_LEVELS_MAX) a group, as ops/merkle.py's append_groups makes
    them."""
    if not 1 <= k <= APPEND_LEVELS_MAX:
        raise ValueError("levels a group must be 1 to {}, got {}".format(
            APPEND_LEVELS_MAX, k))
    return [min(k, levels - at) for at in range(0, levels, k)]


def append_launches(group_sizes: Sequence[int]) -> List[int]:
    """The levels of each sha256_append_levels launch of an append made of
    groups of `group_sizes` levels: a group of more than
    APPEND_LAUNCH_LEVELS levels is split (see csrc/sha256.cu)."""
    return [min(APPEND_LAUNCH_LEVELS, g - at) for g in group_sizes
            for at in range(0, g, APPEND_LAUNCH_LEVELS)]


def sha256_append_levels_plain(child: torch.Tensor,
                               parents: Sequence[torch.Tensor],
                               windows: Sequence[Tuple[int, int]]) -> None:
    """Plain PyTorch append: for each parent level j (parents[j - 1], with
    its window (p0, cnt)), parents p0 .. p0 + cnt - 1 are H(0x01 || child
    2p || child 2p + 1) of the level below (`child` for the first),
    written in place, each level's new nodes feeding the next. The words
    are formed by _node_blocks and hashed by sha256_blocks_plain, as
    plenum_tpu/ops/merkle.py::_append_levels_fused does."""
    _append_windows(child, parents, windows)
    below = child
    for parent, (p0, cnt) in zip(parents, windows):
        if cnt:
            pairs = _be_words(below[2 * p0:2 * (p0 + cnt)])
            parent[p0:p0 + cnt] = _be_bytes(_hash_pairs_plain(
                pairs[0::2], pairs[1::2]))
        below = parent


def sha256_append_groups_plain(child: torch.Tensor,
                               parents: Sequence[torch.Tensor],
                               windows: Sequence[Tuple[int, int]],
                               k: int) -> int:
    """A whole append of plain versions: sha256_append_levels_plain on
    each group of k levels in turn (the first group's child `child`, each
    next group's its last parent level). → the launches the kernel makes
    for it (append_launches)."""
    sizes = _group_sizes(len(parents), k)
    _append_windows(child, parents, windows, len(parents))
    at = 0
    for g in sizes:
        sha256_append_levels_plain(child if at == 0 else parents[at - 1],
                                   parents[at:at + g], windows[at:at + g])
        at += g
    return len(append_launches(sizes))


def sha256_append_groups_cuda(child: torch.Tensor,
                              parents: Sequence[torch.Tensor],
                              windows: Sequence[Tuple[int, int]],
                              k: int) -> int:
    """The CUDA kernel (csrc/sha256.cu, sha256_append_groups) on CUDA
    tensors starting on 16-byte boundaries (views into one tree buffer
    are the rule), the function of sha256_append_groups_plain: the
    arguments checked once, then one C call that enqueues every group's
    launch (append_launches) back to back on the current stream, without
    synchronising (the windows are host integers). → the launches, each
    counted in `sha256_append_groups_cuda.launches`."""
    sizes = _group_sizes(len(parents), k)
    _append_windows(child, parents, windows, len(parents))
    dev = child.device
    if dev.type != "cuda":
        raise ValueError("sha256_append_groups_cuda needs CUDA tensors, got "
                         "{}".format(dev))
    ptrs = [child.data_ptr()] + [t.data_ptr() for t in parents]
    if any(p % 16 for p in ptrs):
        raise ValueError("every level must start on a 16-byte boundary")
    L, G = len(parents), len(sizes)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sha256_append_groups(
            (_P * (L + 1))(*ptrs), (_I64 * L)(*[p for p, _ in windows]),
            (_I64 * L)(*[c for _, c in windows]), (_I * G)(*sizes), G,
            stream, ctypes.byref(launches))
    sha256_append_groups_cuda.launches += launches.value
    if err != 0:
        raise RuntimeError("sha256_append_groups launch failed: CUDA error "
                           "{}".format(err))
    return launches.value


sha256_append_groups_cuda.launches = 0


def sha256_append_groups(child: torch.Tensor,
                         parents: Sequence[torch.Tensor],
                         windows: Sequence[Tuple[int, int]], k: int) -> int:
    """The new parents of every level of an append to a growing tree, k
    levels a group, written in place (see sha256_append_levels_plain). CUDA
    tensors go through the kernel (one C call), CPU tensors through the
    plain version group by group. → the launches (append_launches)."""
    if child.device.type == "cuda":
        return sha256_append_groups_cuda(child, parents, windows, k)
    if child.device.type == "cpu":
        return sha256_append_groups_plain(child, parents, windows, k)
    raise ValueError("unsupported device {}".format(child.device))


class PinnedStaging:
    """A grow-only pinned host buffer through which messages reach the
    card: one host→device copy per dispatch, with non_blocking=True. The
    host waits for the previous copy's event before it writes the buffer
    again."""

    def __init__(self):
        self._buf = None
        self._copied = None

    def upload(self, parts: Sequence[np.ndarray], device) -> torch.Tensor:
        """The concatenated bytes of `parts` (uint8 arrays) in a new
        device tensor; the copy is in flight on the current stream."""
        nbytes = sum(int(a.nbytes) for a in parts)
        if self._copied is not None:
            self._copied.synchronize()
        if self._buf is None or self._buf.shape[0] < nbytes:
            self._buf = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                                    pin_memory=True)
        host = self._buf.numpy()
        at = 0
        for a in parts:
            host[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
            at += a.nbytes
        out = torch.empty((nbytes,), dtype=torch.uint8, device=device)
        out.copy_(self._buf[:nbytes], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(device))
        return out


def ragged_arrays(msgs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """→ (the messages joined as one uint8 array, int64 offsets [B + 1])."""
    lens = np.fromiter(map(len, msgs), dtype=np.int64, count=len(msgs))
    offsets = np.zeros(len(msgs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return np.frombuffer(b"".join(msgs), dtype=np.uint8), offsets


def upload_ragged(msgs: Sequence[bytes], device, refs: Sequence[bytes] = (),
                  staging: PinnedStaging = None) -> Tuple[torch.Tensor, ...]:
    """(data, offsets[, refs]) tensors on `device` for `msgs` in the layout
    of `ragged_arrays` (and their 32-byte refs, as [B, 32] uint8). On CUDA
    they travel in one copy from the grow-only pinned buffer `staging` (or
    a fresh one): data first (the kernels read it 16 bytes at a time), then
    offsets and refs each at the next 16-byte boundary."""
    data, offsets = ragged_arrays(msgs)
    ref_arr = np.frombuffer(b"".join(refs), dtype=np.uint8).reshape(-1, 32)
    if device.type != "cuda":
        out = (to_tensor(data, device), to_tensor(offsets, device))
        return out + (to_tensor(ref_arr, device),) if refs else out
    parts, at, spans = [], 0, []
    for a in (data, offsets, ref_arr) if refs else (data, offsets):
        spans.append((at, at + a.nbytes))
        parts.append(a)
        at += a.nbytes
        pad = -at % 16
        parts.append(np.zeros(pad, dtype=np.uint8))
        at += pad
    buf = (staging or PinnedStaging()).upload(parts, device)
    out = [buf[spans[0][0]:spans[0][1]],
           buf[spans[1][0]:spans[1][1]].view(torch.int64)]
    if refs:
        out.append(buf[spans[2][0]:spans[2][1]].view(-1, 32))
    return tuple(out)


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


def to_host(result: Union[Sha256Launch, torch.Tensor]) -> np.ndarray:
    """[B, 8] uint32 numpy digest state of a sha256_ragged result: a
    launch's checked copy (Sha256Launch.host; it waits for the launch), or
    a tensor's copy."""
    if isinstance(result, Sha256Launch):
        return result.host()
    return result.cpu().numpy().view(np.uint32)


def _node_words_from_digest_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """[m, 64] uint8 rows (left||right digest bytes) → [m, 2, 16] int32
    SHA-padded words of H(0x01 || left || right), built on the pairs'
    device: the level step's words before sha256_node_levels, kept to feed
    sha256_blocks in the tests and beside the new step on the card."""
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


class Download:
    """A device→host copy of a tensor in flight: on CUDA into pinned memory
    (PyTorch's caching host allocator, so a repeated size costs no new
    allocation) with non_blocking=True, an event marking its end; on the
    CPU a copy. `wait()` → a numpy view of the host copy."""

    __slots__ = ("host", "done")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.done = t.clone(), None

    def wait(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def sha256_node_levels_array(level: np.ndarray, levels: int, device=None,
                             staging: PinnedStaging = None
                             ) -> List[np.ndarray]:
    """[n, 32] u8 digests → [levels 1..levels above them], [n >> k, 32] u8
    each: on CUDA one upload through the pinned `staging` (or a fresh
    buffer), the launches of sha256_node_levels and one copy back into
    pinned memory."""
    dev = resolve_device(device)
    level = np.ascontiguousarray(level, dtype=np.uint8).reshape(-1, 32)
    if dev.type == "cuda":
        digests = (staging or PinnedStaging()).upload([level], dev)
        flat = Download(sha256_node_levels(digests.view(-1, 32),
                                           levels)).wait()
    else:
        flat = sha256_node_levels(to_tensor(level, dev), levels).numpy()
    out, at = [], 0
    for k in range(1, levels + 1):
        m = level.shape[0] >> k
        out.append(flat[at:at + m])
        at += m
    return out


def sha256_node_pairs_array(pairs: np.ndarray, device=None) -> np.ndarray:
    """[m, 64] u8 rows of left||right digests → [m, 32] u8 node digests
    H(0x01||l||r): one level of sha256_node_levels_array."""
    pairs = np.ascontiguousarray(pairs, dtype=np.uint8)
    return sha256_node_levels_array(pairs.reshape(-1, 32), 1, device)[0]


def sha256_many(msgs: Sequence[bytes], device=None,
                prefix: int = -1) -> List[bytes]:
    """Batched SHA-256 of prefix || msg for same-or-mixed-length messages
    (no prefix when prefix is -1)."""
    return sha256_many_collect(sha256_many_dispatch(msgs, device, prefix))


def sha256_many_dispatch(msgs: Sequence[bytes], device=None,
                         prefix: int = -1, staging: PinnedStaging = None):
    """Async half of sha256_many: one join of the messages, their copy to
    the device (through `staging`, or a fresh pinned buffer) and the LAUNCH,
    so the caller can overlap independent host work before
    sha256_many_collect pulls the bytes."""
    dev = resolve_device(device)
    if not msgs:
        return None
    return sha256_ragged(*upload_ragged(msgs, dev, staging=staging), prefix)


def sha256_many_collect(handle) -> List[bytes]:
    """Blocking half: digests of a sha256_many_dispatch launch."""
    if handle is None:
        return []
    return digests_to_bytes(to_host(handle))


class TorchSha256Backend:
    """Batch backend for `TreeHasher` (ledger/tree_hasher.py seam) on one
    device: `device=None` means CUDA. Leaves are hashed as H(0x00 || data)
    and node pairs given as bytes as H(0x01 || left || right) by the ragged
    entry, node levels given as digest arrays by sha256_node_levels, all
    through one pinned staging buffer that the backend keeps."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._staging = PinnedStaging()

    def leaf_hashes(self, datas: Sequence[bytes]) -> List[bytes]:
        return sha256_many_collect(self.leaf_hashes_dispatch(datas))

    def leaf_hashes_dispatch(self, datas: Sequence[bytes]):
        """Launch-only half of leaf_hashes (fused-dispatch seam)."""
        return sha256_many_dispatch(datas, self.device, 0x00, self._staging)

    def leaf_hashes_collect(self, handle) -> List[bytes]:
        return sha256_many_collect(handle)

    def node_hashes(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
        return sha256_many_collect(sha256_many_dispatch(
            [l + r for l, r in pairs], self.device, 0x01, self._staging))

    def node_hashes_array(self, pairs: np.ndarray) -> np.ndarray:
        """[m, 64] u8 (left||right) → [m, 32] u8: one level of
        node_levels_array."""
        pairs = np.ascontiguousarray(pairs, dtype=np.uint8)
        return self.node_levels_array(pairs.reshape(-1, 32), 1)[0]

    def node_levels_array(self, level: np.ndarray,
                          levels: int) -> List[np.ndarray]:
        """[n, 32] u8 digests → the `levels` tree levels above them,
        [n >> k, 32] u8 each (sha256_node_levels_array through the
        backend's staging buffer)."""
        return sha256_node_levels_array(level, levels, self.device,
                                        self._staging)
