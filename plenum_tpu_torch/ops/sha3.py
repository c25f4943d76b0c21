"""Batched SHA3-256 on the device — the MPT state engine's hash path.

Port of plenum_tpu/ops/sha3.py (`_sha3_blocks` on `_keccak_f`, an XLA
device program) and of the fused compare `_sha3_blocks_eq` of
plenum_tpu/ops/trie_jax.py; the kernel is csrc/sha3.cu. The trie hashes
nodes with SHA3-256 (rate 136 bytes, domain byte 0x06, final bit 0x80),
not the SHA-256 of the Merkle ledger.

Two entries take raw messages as one flat uint8 buffer and int64 offsets
[B + 1] (the layout of `ops/sha256.ragged_arrays`); the card pads:

- `sha3_ragged` → [B, 32] uint8 digests;
- `sha3_ragged_eq`, with [B, 32] uint8 refs → [B] bool, True where the
  digest equals its ref.

Each launches its CUDA kernel on CUDA tensors and runs its plain PyTorch
version (`sha3_ragged_plain`, `sha3_ragged_eq_plain`) on CPU tensors. The
plain version keeps the 25 lanes as int64 tensors holding the 64-bit
patterns, so a rotation masks what the arithmetic right shift drags in,
and the round constants above 2^63 are their signed int64 patterns.

On the card the wrappers read nothing back: they launch and return a
`Sha3Launch`, whose one buffer holds the rows and the kernel's error word
(set for a row whose offsets are invalid). `to_host` copies it once, at
the first point the host needs the rows, and raises ValueError there.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from plenum_tpu_torch.ops import (
    TAIL_BYTES, check_arg, check_ragged, check_ragged_layout, cuda_lib,
    launch_rows, resolve_device)
from plenum_tpu_torch.ops.sha256 import upload_ragged

RATE_BYTES = 136          # SHA3-256: r = 1088 bits
RATE_LANES = RATE_BYTES // 8
DIGEST_BYTES = 32
# Levels of at most this many rows run five lanes per message, larger ones
# one thread per message (csrc/sha3.cu). Measured crossover on an NVIDIA
# H100 80GB HBM3 at 700 W, kernel alone on the pool's 2-block state nodes:
# five lanes 0.0177 ms against 0.0215 at 6,144 rows, 0.0225 against
# 0.0217 at 8,192 (PERF.md).
GROUP_MAX_ROWS = 6144


def _i64(v: int) -> int:
    """The signed int64 with the bit pattern of the uint64 `v`."""
    return v - (1 << 64) if v >= 1 << 63 else v


_RC = [_i64(v) for v in (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)]

# rho rotation offsets, indexed [x][y] for lane x + 5y
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

# rho + pi as one gather: destination lane y + 5 * ((2x + 3y) % 5) takes
# lane x + 5y rotated left by _ROT[x][y]
_PI_SRC = [0] * 25
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y]


# ------------------------------------------------- the plain version

def _rotl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate int64 lanes left by `n` (a tensor of amounts in 0..63,
    broadcast against x). `>>` on int64 is arithmetic: the mask keeps the
    n bits that wrap around, and is 0 where n is 0."""
    mask = (torch.ones_like(n) << n) - 1
    return (x << n) | ((x >> ((64 - n) % 64)) & mask)


def _keccak_f(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on [B, 25] int64 lanes (lane x + 5y at column
    x + 5y) → the permuted lanes."""
    dev = a.device
    src = torch.tensor(_PI_SRC, dtype=torch.long, device=dev)
    rot = torch.tensor(_PI_ROT, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    rc = torch.tensor(_RC, dtype=torch.int64, device=dev)
    for r in range(24):
        s = a.view(-1, 5, 5)                       # [B, y, x]
        c = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3] ^ s[:, 4]
        d = torch.roll(c, 1, dims=1) ^ _rotl(torch.roll(c, -1, dims=1), one)
        a = (s ^ d.unsqueeze(1)).reshape(-1, 25)
        b = _rotl(a[:, src], rot).view(-1, 5, 5)
        a = (b ^ (~torch.roll(b, -1, dims=2) & torch.roll(b, -2, dims=2))) \
            .reshape(-1, 25).clone()
        a[:, 0] ^= rc[r]
    return a


def _pad_ragged(data: torch.Tensor, offsets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keccak-pad data[offsets[i]:offsets[i + 1]] for each i with torch:
    → ([B, nblocks, 17] int64 little-endian lanes, [B] int64 block counts
    len // 136 + 1), nblocks the longest message's."""
    start = offsets[:-1].unsqueeze(1)
    lens = (offsets[1:] - offsets[:-1]).unsqueeze(1)
    need = lens // RATE_BYTES + 1
    width = RATE_BYTES * int(need.max())
    p = torch.arange(width, dtype=torch.int64, device=data.device)
    keep = p < lens
    if data.shape[0]:
        src = (start + p).clamp(0, data.shape[0] - 1)
        msg = torch.where(keep, data[src].to(torch.int64), 0)
    else:
        msg = torch.zeros(keep.shape, dtype=torch.int64, device=data.device)
    msg = msg ^ torch.where(p == lens, 0x06, 0)
    msg = msg ^ torch.where(p == need * RATE_BYTES - 1, 0x80, 0)
    b = msg.view(msg.shape[0], width // RATE_BYTES, RATE_LANES, 8)
    lanes = b[..., 0]
    for k in range(1, 8):
        lanes = lanes | (b[..., k] << (8 * k))
    return lanes, need[:, 0]


def _lanes_to_digests(a: torch.Tensor) -> torch.Tensor:
    """[B, 25] int64 lanes → [B, 32] uint8: lanes 0..3, little-endian."""
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=a.device)
    return ((a[:, :4].unsqueeze(2) >> shifts) & 0xff).reshape(-1, 32) \
        .to(torch.uint8)


def sha3_ragged_plain(data: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA3-256 of data[offsets[i]:offsets[i + 1]]: data [n]
    uint8, offsets [B + 1] int64 → [B, 32] uint8 digests. Rows whose
    message has fewer blocks keep their state after their last block."""
    B = check_ragged(data, offsets)
    if B == 0:
        return torch.empty((0, DIGEST_BYTES), dtype=torch.uint8,
                           device=data.device)
    lanes, need = _pad_ragged(data, offsets)
    a = torch.zeros((B, 25), dtype=torch.int64, device=data.device)
    for blk in range(lanes.shape[1]):
        absorbed = a.clone()
        absorbed[:, :RATE_LANES] ^= lanes[:, blk]
        a = torch.where((blk < need).unsqueeze(1), _keccak_f(absorbed), a)
    return _lanes_to_digests(a)


def _check_refs(refs: torch.Tensor, data: torch.Tensor, B: int) -> None:
    check_arg(refs, "refs", torch.uint8, (B, DIGEST_BYTES))
    if refs.device != data.device:
        raise ValueError("refs lie on {}, data on {}".format(refs.device,
                                                             data.device))


def sha3_ragged_eq_plain(data: torch.Tensor, offsets: torch.Tensor,
                         refs: torch.Tensor) -> torch.Tensor:
    """[B] bool: True where sha3_ragged_plain's digest equals refs' row."""
    _check_refs(refs, data, check_ragged(data, offsets))
    return (sha3_ragged_plain(data, offsets) == refs).all(dim=1)


# ------------------------------------------------------- the kernels

class Sha3Launch:
    """A launch of csrc/sha3.cu in flight: `buf`, its output on the card
    (the rows — B * 32 digest bytes, or B verdict bytes rounded up to 16
    — then TAIL_BYTES whose first uint32 is the kernel's error word), the
    row count, the byte count of the data (for the error's message) and
    whether the rows are verdicts."""

    __slots__ = ("buf", "rows", "nbytes", "verdicts")

    def __init__(self, buf: torch.Tensor, rows: int, nbytes: int,
                 verdicts: bool):
        self.buf, self.rows = buf, rows
        self.nbytes, self.verdicts = nbytes, verdicts

    def host(self) -> np.ndarray:
        """One device→host copy (it waits for the launch) → [B, 32] uint8
        digests or [B] bool verdicts. Raises ValueError, with
        check_ragged's message, when a row's offsets were invalid."""
        rows = launch_rows(self.buf, self.nbytes)
        if self.verdicts:
            return rows[:self.rows].view(bool)
        return rows.reshape(-1, DIGEST_BYTES)


def to_host(result: Union[Sha3Launch, torch.Tensor]) -> np.ndarray:
    """The rows of a sha3_ragged / sha3_ragged_eq result as a numpy array:
    a launch's checked copy (Sha3Launch.host), or the plain version's
    tensor, whose offsets check_ragged checked before it hashed."""
    if isinstance(result, Sha3Launch):
        return result.host()
    return result.numpy()


def lanes_for(rows: int) -> int:
    """Lanes per message for a launch of `rows` rows: 5 up to
    GROUP_MAX_ROWS, then 1."""
    return 5 if rows <= GROUP_MAX_ROWS else 1


def _sha3_args(pointers: int) -> list:
    return [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * pointers \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


# csrc/sha3.cu's C entries: data, nbytes, offsets[, refs], out, B, lanes,
# stream; set once, when the library loads
_SIGNATURES = {"sha3_ragged": _sha3_args(2), "sha3_ragged_eq": _sha3_args(3)}


def _launch(data: torch.Tensor, offsets: torch.Tensor, refs, lanes,
            name: str) -> Sha3Launch:
    """Check what the kernel needs without reading anything back (the
    ragged layout, CUDA tensors, data on a 16-byte boundary, refs on an
    8-byte one, lanes 1 or 5 or None for lanes_for(B)), then launch
    csrc/sha3.cu's sha3_ragged (refs None) or sha3_ragged_eq on the
    current stream. → its Sha3Launch; rows 0 launch nothing."""
    B = check_ragged_layout(data, offsets)
    if data.device.type != "cuda":
        raise ValueError("{} needs CUDA tensors, got {}".format(name,
                                                                data.device))
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary")
    lanes = lanes_for(B) if lanes is None else lanes
    if lanes not in (1, 5):
        raise ValueError("lanes must be 1 or 5, got {}".format(lanes))
    verdicts = refs is not None
    if verdicts:
        _check_refs(refs, data, B)
        if refs.data_ptr() % 8:
            raise ValueError("refs must start on an 8-byte boundary")
    rows_bytes = -(-B // 16) * 16 if verdicts else B * DIGEST_BYTES
    nbytes = int(data.shape[0])
    dev = data.device
    if B == 0:
        return Sha3Launch(torch.zeros((TAIL_BYTES,), dtype=torch.uint8,
                                      device=dev), 0, nbytes, verdicts)
    buf = torch.empty((rows_bytes + TAIL_BYTES,), dtype=torch.uint8,
                      device=dev)
    entry = "sha3_ragged_eq" if verdicts else "sha3_ragged"
    fn = getattr(cuda_lib.load("sha3", _SIGNATURES), entry)
    ptrs = [offsets.data_ptr()] + ([refs.data_ptr()] if verdicts else [])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(data.data_ptr(), nbytes, *ptrs, buf.data_ptr(), B, lanes,
                 stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(entry,
                                                                    err))
    return Sha3Launch(buf, B, nbytes, verdicts)


def sha3_ragged_cuda(data: torch.Tensor, offsets: torch.Tensor,
                     lanes: int = None) -> Sha3Launch:
    """The CUDA kernel (csrc/sha3.cu, sha3_ragged) on CUDA tensors, the
    function of sha3_ragged_plain; `lanes` per message, 1 or 5 (None: by
    B). Launches exactly B rows on the current stream and returns without
    synchronising; the offsets are checked by the kernel and reported by
    the result's host(). Counts each launch in `sha3_ragged_cuda.launches`
    and its rows in `.rows`."""
    out = _launch(data, offsets, None, lanes, "sha3_ragged_cuda")
    if out.rows:
        sha3_ragged_cuda.launches += 1
        sha3_ragged_cuda.rows.append(out.rows)
    return out


sha3_ragged_cuda.launches = 0
sha3_ragged_cuda.rows = []


def sha3_ragged_eq_cuda(data: torch.Tensor, offsets: torch.Tensor,
                        refs: torch.Tensor, lanes: int = None) -> Sha3Launch:
    """The CUDA kernel's fused entry (csrc/sha3.cu, sha3_ragged_eq), the
    function of sha3_ragged_eq_plain; refs must start on an 8-byte
    boundary. As sha3_ragged_cuda, it reads nothing back. Counts each
    launch in `.launches`, its rows in `.rows`."""
    out = _launch(data, offsets, refs, lanes, "sha3_ragged_eq_cuda")
    if out.rows:
        sha3_ragged_eq_cuda.launches += 1
        sha3_ragged_eq_cuda.rows.append(out.rows)
    return out


sha3_ragged_eq_cuda.launches = 0
sha3_ragged_eq_cuda.rows = []


def sha3_ragged(data: torch.Tensor, offsets: torch.Tensor
                ) -> Union[Sha3Launch, torch.Tensor]:
    """Flat bytes + [B + 1] offsets → [B, 32] uint8 digests: a Sha3Launch
    for CUDA tensors (the kernel), a tensor for CPU tensors (the plain
    version). `to_host` takes either."""
    if data.device.type == "cuda":
        return sha3_ragged_cuda(data, offsets)
    if data.device.type == "cpu":
        return sha3_ragged_plain(data, offsets)
    raise ValueError("unsupported device {}".format(data.device))


def sha3_ragged_eq(data: torch.Tensor, offsets: torch.Tensor,
                   refs: torch.Tensor) -> Union[Sha3Launch, torch.Tensor]:
    """Flat bytes + [B + 1] offsets + [B, 32] refs → [B] bool, as
    sha3_ragged: the kernel's launch on CUDA tensors, the plain version's
    tensor on CPU tensors."""
    if data.device.type == "cuda":
        return sha3_ragged_eq_cuda(data, offsets, refs)
    if data.device.type == "cpu":
        return sha3_ragged_eq_plain(data, offsets, refs)
    raise ValueError("unsupported device {}".format(data.device))


# ------------------------------------------------- batches of messages

def sha3_256_many(msgs: Sequence[bytes], device=None) -> List[bytes]:
    """SHA3-256 of every message in one launch on `device` (None means
    CUDA)."""
    if not msgs:
        return []
    dev = resolve_device(device)
    return digests_to_bytes(to_host(sha3_ragged(*upload_ragged(msgs, dev))))


def digests_to_bytes(dig: np.ndarray) -> List[bytes]:
    """[B, 32] uint8 digests → list of 32-byte strings."""
    flat = dig.tobytes()
    return [flat[i:i + DIGEST_BYTES] for i in range(0, len(flat),
                                                     DIGEST_BYTES)]
