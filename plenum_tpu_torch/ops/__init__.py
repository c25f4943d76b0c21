"""Device batch primitives: SHA-256, SHA3-256, ed25519 verify and the
BLS12-381 pairing, aggregates and MSM, each a hand-written CUDA kernel
(csrc/) with a plain version beside it.

A wrapper launches its kernel on a CUDA tensor and runs the plain version
on a CPU tensor; there is no other route between them.
"""
import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device=None` means CUDA. Raises when CUDA is asked for (explicitly
    or by default) and no CUDA device is present: the port never carries
    on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    # the per-call CUDA gate, asked on every call (is_available creates no
    # CUDA context) so that an entry point raises whenever CUDA is absent,
    # whatever the mesh's cached probe said earlier
    if dev.type == "cuda" \
            and not torch.cuda.is_available():  # plenum-lint: disable=PT002
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device {}".format(dev))
    return dev


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy array → tensor on `device`; uint32 arrays travel as int32 of
    the same bit patterns (PyTorch's uint32 support is partial). On CUDA
    the array is staged in pinned memory (PyTorch's caching host
    allocator keeps the block until the copy is done) and copied with
    non_blocking=True on the current stream, so the host never waits
    for the card, as a copy from pageable memory does; the caller may
    reuse the array at once."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch.from_numpy wants a writable array
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def check_arg(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape`: what
    a kernel wrapper checks before it passes the pointer on."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError("{}: expected contiguous {} {}, got {} {}{}".format(
            name, dtype, tuple(shape), t.dtype, tuple(t.shape),
            "" if t.is_contiguous() else " (not contiguous)"))


RAGGED_OFFSETS_ERROR = ("offsets must be non-decreasing and within the {} "
                        "data bytes")
TAIL_BYTES = 16          # after a ragged kernel's rows: the error word, zeros


def launch_rows(buf: torch.Tensor, nbytes: int) -> np.ndarray:
    """One device→host copy of a ragged kernel's output `buf` (it waits
    for the launch) → the bytes before its TAIL_BYTES tail. Raises
    ValueError, with check_ragged's message for `nbytes` data bytes, when
    the kernel set the tail's first uint32, its error word (a row's
    offsets were invalid)."""
    h = buf.cpu().numpy()
    if h[-TAIL_BYTES:][:4].view(np.uint32)[0]:
        raise ValueError(RAGGED_OFFSETS_ERROR.format(nbytes))
    return h[:-TAIL_BYTES]


def check_ragged_layout(data: torch.Tensor, offsets: torch.Tensor,
                        prefix: int = -1) -> int:
    """What check_ragged checks without reading the offsets: data a
    contiguous 1-D uint8 tensor, offsets a contiguous 1-D int64 tensor of
    at least one entry on the same device, prefix -1 or a byte. → B."""
    if data.dim() != 1 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("data must be 1-D and offsets [B + 1], got {} and "
                         "{}".format(tuple(data.shape), tuple(offsets.shape)))
    check_arg(data, "data", torch.uint8, data.shape)
    check_arg(offsets, "offsets", torch.int64, offsets.shape)
    if data.device != offsets.device:
        raise ValueError("data and offsets lie on {} and {}".format(
            data.device, offsets.device))
    if not -1 <= prefix <= 255:
        raise ValueError("prefix must be -1 or a byte, got {}".format(prefix))
    return int(offsets.shape[0]) - 1


def check_ragged(data: torch.Tensor, offsets: torch.Tensor,
                 prefix: int = -1) -> int:
    """Raise unless data is a contiguous 1-D uint8 tensor, offsets a
    contiguous 1-D int64 tensor of non-decreasing offsets into it (one
    reduction, read back) and prefix -1 or a byte. → B."""
    B = check_ragged_layout(data, offsets, prefix)
    bad = (offsets[0] < 0) | (offsets[-1] > data.shape[0]) \
        | (offsets[1:] < offsets[:-1]).any()
    if bool(bad):
        raise ValueError(RAGGED_OFFSETS_ERROR.format(data.shape[0]))
    return B


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) → int32 tensor of the same bit
    patterns (uint32 words travel as int32: PyTorch's uint32 support is
    partial)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def scatter_ragged_rows(msgs, width: int):
    """Scatter variable-length messages into a zero-filled
    ``[len(msgs), width]`` uint8 buffer with ONE flat vectorized
    scatter (the mixed-length host padding of ``ops/sha256.pad_messages``).

    Returns ``(out, lens)``: the row buffer and the per-message byte
    lengths as int64.
    """
    n = len(msgs)
    out = np.zeros((n, width), dtype=np.uint8)
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    joined = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    if joined.shape[0]:
        flat = out.reshape(-1)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        rows = np.arange(n, dtype=np.int64)
        dst = np.repeat(rows * width, lens) \
            + (np.arange(joined.shape[0], dtype=np.int64)
               - np.repeat(starts, lens))
        flat[dst] = joined
    return out, lens


def launch_counts(reset: bool = False) -> dict:
    """{kernel name: launches} of every kernel wrapper in this process
    (each wrapper adds one where it launches its kernel); reset=True
    zeroes the counts after reading them. Node processes and the verify
    daemon report these, so that a harness sees their launches."""
    from . import bls381, bls381_pairing, ed25519, sha256, sha3
    fns = {"ed25519_verify": ed25519.verify_cuda,
           "sha256_compress": sha256.sha256_blocks_cuda,
           "sha256_ragged": sha256.sha256_ragged_cuda,
           "sha256_node_levels": sha256.sha256_node_levels_cuda,
           "sha256_append_levels": sha256.sha256_append_groups_cuda,
           "sha3_ragged": sha3.sha3_ragged_cuda,
           "sha3_ragged_eq": sha3.sha3_ragged_eq_cuda,
           "bls_pairing": bls381_pairing.pairing_cuda,
           "bls_g1_aggregate": bls381.g1_aggregate_cuda,
           "bls_g2_aggregate": bls381_pairing.g2_aggregate_cuda,
           "bls_g1_msm": bls381_pairing.msm_cuda}
    counts = {name: fn.launches for name, fn in fns.items()}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return counts
