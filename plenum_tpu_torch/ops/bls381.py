"""Batched BLS12-381 G1 aggregation on the device, and the packing of
compressed G1 and G2 points that the BLS kernels share.

Port of plenum_tpu/ops/bls381_jax.py (`_aggregate_kernel`, an XLA device
program, and its host plumbing) and of the host half of
plenum_tpu/ops/bls381_tower.py (`pack_g2_compressed`, `_be48_to_limbs`,
`_limbs_lt_q`). The kernels are csrc/bls381.cu (the pairing),
bls381_agg.cu (the aggregates) and bls381_msm.cu (the MSM); the pairing,
the MSM and the G2 aggregate are wrapped in ops/bls381_pairing.py.

A packed coordinate keeps the JAX package's layout: 32 limbs of 12 bits in
int32 ([..., 32], standard domain, x < q checked here), with three flags a
point (sign_big, is_inf, valid). The kernel returns every aggregate as
normalized standard-domain coordinates, (x, y, 1) or the identity
(0, 1, 0), so the card and the plain version give equal tensors.

The aggregates take each distinct encoding once, with a [B, n] index of
each job's points among them (`pack_g1_jobs`). The plain version
(`g1_aggregate_plain`) evaluates each job with the port's host arithmetic
(crypto/bls_ops: g1_decompress, g1_add); the wrapper `g1_aggregate` takes
it for CPU tensors only and launches the kernels (`g1_aggregate_cuda`) for
CUDA tensors. The JAX package pads the job axis to a power of two so that
jit reuses a compiled shape; the port launches the exact B, or splits a
batch that clears the mesh gate over the devices (`aggregate_dispatch`,
ops/mesh.py).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from plenum_tpu_torch.observability import telemetry as _tmy
from plenum_tpu_torch.ops import check_arg, cuda_lib, resolve_device

# ---------------------------------------------------------------- constants

NLIMB = 32
RADIX = 12
MASK = (1 << RADIX) - 1

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_ORD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1_BYTES, G2_BYTES = 48, 96
G1_INF = bytes([0xC0] + [0] * 47)
G2_INF = bytes([0xC0] + [0] * 95)

# ------------------------------------------------------------- the bounds
# A bound counts the function, not a kernel's schedule: the Montgomery
# multiplies (M) and squarings (S) of base-field elements that the function
# needs on a launch's data, with the formulas named below, and the 32-bit
# multiply-adds (O) of the inversion by safegcd, as vectors (M, S, O).
# Additions, subtractions and multiplies by small constants (done as
# additions) are not counted. Each is priced in 32-bit multiply-adds
# (INT32_OPS): a multiply's 12 x 12 word products, low and high halves
# (288), a square's 78 (156), and the reduction's m*q (288) and m (12).
# The kernels do a little more than this (the aggregates' tree of complete
# additions, a G1 decompression per pair, the pairing's G2 square root by
# Alg. 9 and Fermat's inversions in the pairing and the MSM, the fp12
# inverse's cubic norm, the MSM's bucket sums in segments);
# tests/test_torch_bls381.py builds their own schedule from the same pieces
# and holds it against the multiplies and squarings that the host build
# counts.

M = np.array([1, 0, 0])
S = np.array([0, 1, 0])
O = np.array([0, 0, 1])
INT32_OPS = np.array([2 * 144 + 2 * 144 + 12, 2 * 78 + 2 * 144 + 12, 1])
M2, S2 = 3 * M, 2 * M        # in fp2: Karatsuba, the complex squaring
POW_WINDOW = 5               # csrc/bls381_core.cuh POW_WINDOW
POW_WINDOW_FP2 = 4           # csrc/bls381_core.cuh POW_WINDOW_FP2


def pow_cost(e: int, sqr, mul):
    """Square-and-multiply from the top bit of a public exponent."""
    return (e.bit_length() - 1) * sqr + (bin(e).count("1") - 1) * mul


def window_cost(e: int, sqr, mul, w: int = POW_WINDOW):
    """A sliding window of up to w bits over the odd powers (csrc
    pow_window): a^2 and the 2^(w-1) - 1 odd powers above a, then a
    squaring a bit below the first window and a product a window past
    it."""
    sqrs, muls = 1, (1 << (w - 1)) - 1
    bit, started = e.bit_length() - 1, False
    while bit >= 0:
        if not (e >> bit) & 1:
            sqrs, bit = sqrs + 1, bit - 1
            continue
        lo = max(bit - w + 1, 0)
        while not (e >> lo) & 1:
            lo += 1
        if started:
            sqrs, muls = sqrs + bit - lo + 1, muls + 1
        started, bit = True, lo - 1
    return sqrs * sqr + muls * mul


FP_INV_FERMAT = pow_cost(Q - 2, S, M)
# safegcd (csrc fp_inv_var): batches of 30 divsteps, each updating d and e
# with 6 products of 32 x 32 bits a limb of 13 and 2 more (two
# multiply-adds a product); a 381-bit q takes at least 13 batches, since
# the integer matrix of N divsteps has entries within 2^N and the row that
# sends g to 0 is a multiple of (a, -q)
SAFEGCD_MIN_BATCHES = -(-Q.bit_length() // 30)
FP_INV = SAFEGCD_MIN_BATCHES * 2 * (6 * 13 + 2) * O
SQRT_CHAIN = window_cost((Q + 1) // 4, S, M)
COST = {
    # to Montgomery, x^2, x^3, the (q+1)/4 power, y^2 == x^3 + 4, from
    # Montgomery for the sign
    "g1_decompress": 3 * M + 2 * S + SQRT_CHAIN,
    # over fp2 with the root by the norm (one candidate): to Montgomery,
    # x^2, x^3, the norm, its square root, the candidate's (q-3)/4 power,
    # the root's two products, its square against y^2, from Montgomery
    "g2_decompress": 2 * M + S2 + M2 + 2 * S + SQRT_CHAIN
    + window_cost((Q - 3) // 4, S, M) + 2 * M + S2 + 2 * M,
    # Renes-Costello-Batina 2016 for a = 0: complete addition (Alg. 7),
    # mixed addition of an affine point (Alg. 8), doubling (Alg. 9)
    "g1_add": 12 * M, "g1_madd": 11 * M, "g1_dbl": 6 * M + 2 * S,
    "g2_add": 12 * M2, "g2_madd": 11 * M2,
    # the Miller loop: the G2 point's doubling and addition steps with
    # their lines' coefficients; a line at the G1 point (4 M) multiplied
    # into the accumulator in sparse (mul_by_014); a squaring of the fp12
    # accumulator; an fp12 product
    "miller_dbl": 8 * S2 + 3 * M2, "miller_add": 8 * S2 + 7 * M2,
    "line": 4 * M + 13 * M2, "fp12_sqr": 12 * M2, "fp12_mul": 18 * M2,
    # the easy and the hard part (HHT chain, cyclotomic squarings), as the
    # host build counts them, with its one inversion by safegcd
    "final_exp": 7934 * M + 382 * S - FP_INV_FERMAT + FP_INV,
}
MILLER_DOUBLINGS = 63        # |x| = 0xd201000000010000 below its top bit
MILLER_ADDITIONS = 5         # its other set bits
# a normalized result beside the shared inversion: G1 Z from Montgomery,
# x and y; G2 the norm of Z, from Montgomery, 1/Z from its inverse, x, y
G1_STORE = 3 * M
G2_STORE = 2 * S + 3 * M + 2 * M2
# csrc/bls381_agg.cu: the sextets that sum one job (G1, G2)
AGG_SUM_GROUPS = {"g1": 20, "g2": 8}


def int32_ops(cost) -> int:
    """An (M, S, O) count → 32-bit multiply-adds."""
    return int(np.dot(cost, INT32_OPS))


def distinct_points(*coords, finite) -> int:
    """The distinct encodings among the rows where `finite` holds, each
    coordinate [..., k] and flag [...] stacked on its last axis."""
    f = np.asarray(finite, bool).reshape(-1)
    if not f.any():
        return 0
    cols = [np.asarray(c).reshape(f.shape[0], -1)[f] for c in coords]
    return int(np.unique(np.concatenate(cols, axis=1), axis=0).shape[0])


def store_cost(k: int, per):
    """k finite results normalized to (x, y, 1) in the standard domain:
    one inversion for all (Montgomery's trick, 3 (k - 1) products), `per`
    each."""
    if k == 0:
        return 0 * M
    return FP_INV + 3 * (k - 1) * M + k * per


def distinct_rows(raw: np.ndarray):
    """[N, width] uint8 encodings → (the distinct rows [K, width], the
    index [N] int32 of each row among them)."""
    raw = np.ascontiguousarray(raw)
    if raw.shape[0] == 0:
        return raw, np.zeros(0, dtype=np.int32)
    rows = raw.view(np.dtype((np.void, raw.shape[1]))).reshape(-1)
    _, first, inverse = np.unique(rows, return_index=True,
                                  return_inverse=True)
    return raw[first], inverse.reshape(-1).astype(np.int32)


def _int_to_limbs(v: int, n: int = NLIMB) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = v & MASK
        v >>= RADIX
    assert v == 0
    return out


def limbs_to_int(limbs) -> int:
    v = 0
    for i in reversed(range(len(limbs))):
        v = (v << RADIX) | int(limbs[i])
    return v


_Q_L = _int_to_limbs(Q)
_POW2 = np.array([1 << (RADIX * i) for i in range(NLIMB)], dtype=object)


def _limbs_to_ints(arr: np.ndarray) -> np.ndarray:
    """[..., 32] int32 -> [...] Python-int (object) array, vectorized."""
    return (arr.astype(object) * _POW2).sum(axis=-1)


def _ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Python ints < 2^384 → [len, 32] int32 limbs."""
    raw = np.frombuffer(b"".join(int(v).to_bytes(48, "little")
                                 for v in values), dtype=np.uint8)
    return _le_bytes_to_limbs(raw.reshape(-1, 48).astype(np.int32))


def _le_bytes_to_limbs(le: np.ndarray) -> np.ndarray:
    """[N, 48] little-endian byte values (int32) → [N, 32] limbs (3 bytes
    = 2 limbs)."""
    N = le.shape[0]
    groups = le.reshape(N, 16, 3)
    v24 = groups[:, :, 0] + (groups[:, :, 1] << 8) + (groups[:, :, 2] << 16)
    limbs = np.empty((N, NLIMB), dtype=np.int32)
    limbs[:, 0::2] = v24 & MASK
    limbs[:, 1::2] = v24 >> RADIX
    return limbs


# ----------------------------------------------------- host byte plumbing

def _be48_to_limbs(body: np.ndarray) -> np.ndarray:
    """[N, 48] big-endian bytes (flags already masked) -> [N, 32] limbs;
    vectorized, no Python bigints."""
    return _le_bytes_to_limbs(np.asarray(body)[:, ::-1].astype(np.int32))


def _limbs_lt_q(limbs: np.ndarray) -> np.ndarray:
    """[N, 32] limbs → [N] bool, the value < q (compared from the top)."""
    lt = np.zeros(limbs.shape[0], dtype=bool)
    decided = np.zeros(limbs.shape[0], dtype=bool)
    for i in range(NLIMB - 1, -1, -1):
        qi = int(_Q_L[i])
        lt |= (~decided) & (limbs[:, i] < qi)
        decided |= limbs[:, i] != qi
    return lt


def pack_compressed(sigs: np.ndarray):
    """[N, 48] uint8 big-endian compressed G1 -> (x limbs [N, 32] int32,
    sign_big [N], is_inf [N], valid [N]): the compressed bit set, then
    either the infinity encoding (0xC0 and zeros) or x < q. Invalid and
    infinity rows carry zero limbs."""
    sigs = np.asarray(sigs, dtype=np.uint8).reshape(-1, G1_BYTES)
    flags = sigs[:, 0]
    compressed = (flags & 0x80) != 0
    is_inf = (flags & 0x40) != 0
    sign_big = (flags & 0x20) != 0
    body = sigs.copy()
    body[:, 0] &= 0x1F
    limbs = _be48_to_limbs(body)
    inf_ok = is_inf & (flags == 0xC0) & ~np.any(sigs[:, 1:], axis=1)
    valid = compressed & (inf_ok | (~is_inf & _limbs_lt_q(limbs)))
    limbs[~valid | is_inf] = 0
    return limbs, sign_big & ~is_inf, is_inf & valid, valid


def pack_g2_compressed(raws: np.ndarray):
    """[N, 96] uint8 big-endian compressed G2 -> (c1 limbs [N, 32], c0
    limbs [N, 32], sign_big [N], is_inf [N], valid [N]): the 96-byte
    encoding x.c1 || x.c0, its flags in the first byte of the c1 half,
    both halves < q."""
    raws = np.asarray(raws, dtype=np.uint8).reshape(-1, G2_BYTES)
    flags = raws[:, 0]
    compressed = (flags & 0x80) != 0
    is_inf = (flags & 0x40) != 0
    sign_big = (flags & 0x20) != 0
    b1 = raws[:, :48].copy()
    b1[:, 0] &= 0x1F
    c1 = _be48_to_limbs(b1)
    c0 = _be48_to_limbs(raws[:, 48:])
    inf_ok = is_inf & (flags == 0xC0) & ~np.any(raws[:, 1:], axis=1)
    valid = compressed & (inf_ok
                          | (~is_inf & _limbs_lt_q(c1) & _limbs_lt_q(c0)))
    bad = ~valid | is_inf
    c1[bad] = 0
    c0[bad] = 0
    return c1, c0, sign_big & ~is_inf, is_inf & valid, valid


def raw_points(points: Sequence[Sequence[bytes]], n: int,
               width: int) -> np.ndarray:
    """B jobs of compressed points (`width` bytes each) → [B, n, width]
    uint8, short jobs padded with the infinity encoding."""
    raw = np.zeros((len(points), n, width), dtype=np.uint8)
    raw[:, :, 0] = 0xC0
    for i, job in enumerate(points):
        if job:
            raw[i, :len(job)] = np.frombuffer(b"".join(job),
                                              dtype=np.uint8).reshape(-1,
                                                                      width)
    return raw


def g1_bytes(x_limbs, sign_big: bool) -> bytes:
    """The compressed encoding of a valid finite packed G1 point."""
    b = bytearray(limbs_to_int(x_limbs).to_bytes(48, "big"))
    b[0] |= 0x80 | (0x20 if sign_big else 0)
    return bytes(b)


def g2_bytes(c1_limbs, c0_limbs, sign_big: bool) -> bytes:
    """The compressed encoding of a valid finite packed G2 point."""
    b = bytearray(limbs_to_int(c1_limbs).to_bytes(48, "big")
                  + limbs_to_int(c0_limbs).to_bytes(48, "big"))
    b[0] |= 0x80 | (0x20 if sign_big else 0)
    return bytes(b)


def _proj_to_affine(x: int, y: int, z: int) -> Optional[Tuple[int, int]]:
    if z == 0:
        return None
    zi = pow(z, Q - 2, Q)
    return (x * zi % Q, y * zi % Q)


# --------------------------------------------------------- tensor plumbing

def upload(arrays: Sequence[np.ndarray], device,
           staging=None) -> List[torch.Tensor]:
    """numpy arrays (int32, or bool/uint8 flags, which travel as uint8) →
    tensors of their shapes on `device`. On CUDA in one copy from the
    pinned buffer `staging` (ops/sha256.PinnedStaging, or a fresh one),
    non-blocking, each array at a 16-byte boundary."""
    arrays = [np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool
                                   else a) for a in arrays]
    if device.type != "cuda":
        return [torch.from_numpy(a.copy()) for a in arrays]
    from plenum_tpu_torch.ops.sha256 import PinnedStaging
    parts, spans, at = [], [], 0
    for a in arrays:
        spans.append((at, at + a.nbytes))
        parts.append(a.reshape(-1).view(np.uint8))
        at += a.nbytes
        pad = -at % 16
        parts.append(np.zeros(pad, dtype=np.uint8))
        at += pad
    buf = (staging or PinnedStaging()).upload(parts, device)
    dtypes = {np.dtype(np.int32): torch.int32, np.dtype(np.uint8): torch.uint8}
    return [buf[lo:hi].view(dtypes[a.dtype]).view(a.shape)
            for a, (lo, hi) in zip(arrays, spans)]



def _check(ref: torch.Tensor, shape, dtype, **tensors) -> None:
    """Each tensor of `dtype` and `shape`, on `ref`'s device."""
    for name, t in tensors.items():
        check_arg(t, name, dtype, shape)
        if t.device != ref.device:
            raise ValueError("{} lies on {}, not on {}".format(
                name, t.device, ref.device))


def _need_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError("{} needs CUDA tensors, got {}".format(name,
                                                                t.device))


def _route(cuda_fn, plain_fn, ref: torch.Tensor, *args):
    """The kernel's wrapper for CUDA tensors, its plain version for CPU
    tensors."""
    if ref.device.type == "cuda":
        return cuda_fn(*args)
    if ref.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError("unsupported device {}".format(ref.device))


def _ptrs(*tensors) -> List[int]:
    return [t.data_ptr() for t in tensors]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_P = ctypes.c_void_p
_I = ctypes.c_int
# the C entries of csrc/bls381.cu (the pairing, the field core's chains),
# csrc/bls381_agg.cu (the aggregates) and csrc/bls381_msm.cu (the MSM),
# three libraries built at once; set once, when a library loads
SIGNATURES = {
    "bls381": {
        "bls_pairing_stages": [_P] * 10 + [_I, _I, _I] + [_P] * 3
        + [_I, _I, _P],
        "bls_pairing_scratch_bytes": [_I, _I, _I],
        "bls_fp_chain": [_I, _I, _I] + [_P] * 5,
    },
    "bls381_agg": {
        "bls_g1_aggregate": [_P] * 4 + [_I, _P, _I, _I] + [_P] * 5
        + [_I, _I, _P],
        "bls_g2_aggregate": [_P] * 5 + [_I, _P, _I, _I] + [_P] * 5
        + [_I, _I, _P],
        "bls_g1_aggregate_scratch_bytes": [_I, _I],
        "bls_g2_aggregate_scratch_bytes": [_I, _I],
    },
    "bls381_msm": {
        "bls_g1_msm": [_P] * 4 + [_I] + [_P] * 2 + [_I, _I] + [_P] * 6,
        "bls_msm_scratch_bytes": [_I, _I, _I],
    },
}


def library(name: str = "bls381") -> ctypes.CDLL:
    return cuda_lib.load(name, SIGNATURES[name])


def launch_error(entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(entry,
                                                                    err))


def store_points(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine G1 points (x, y) or None → normalized standard-domain
    (X, Y, Z) limbs [len, 32] each: (x, y, 1), or (0, 1, 0)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return _ints_to_limbs(xs), _ints_to_limbs(ys), _ints_to_limbs(zs)


def affine_or_none(x: int, y: int, z: int) -> Optional[Tuple[int, int]]:
    """A normalized result (x, y, 1) → (x, y); (0, 1, 0) → None."""
    if z not in (0, 1):
        raise ValueError("a normalized point has Z 0 or 1, not {}".format(z))
    return (x, y) if z else None


def agg_stages_arg(stages) -> Tuple[int, int]:
    first, last = (int(v) for v in stages)
    if not 0 <= first <= last <= 2:
        raise ValueError("stages must be (first, last) within 0..2, got "
                         "{}".format(stages))
    return first, last


# ------------------------------------------------------- G1 aggregation

def _check_g1_args(x, sign_big, is_inf, valid, index, D, B, n):
    _check(x, (D, NLIMB), torch.int32, x=x)
    _check(x, (D,), torch.uint8, sign_big=sign_big, is_inf=is_inf,
           valid=valid)
    _check(x, (B, n), torch.int32, index=index)


def decompressed_table(valid, is_inf, decode) -> list:
    """Each distinct packed point decompressed once (decode(d)): the
    point, None at infinity, or False for one that is not a valid encoding
    or not on the curve."""
    table = []
    for d in range(len(valid)):
        if not valid[d]:
            table.append(False)
        elif is_inf[d]:
            table.append(None)
        else:
            try:
                table.append(decode(d))
            except ValueError:
                table.append(False)
    return table


def job_sums(table: list, idx: np.ndarray, add):
    """Each job's sum of the table rows its index row names → (points,
    ok [B]): a point, or None for the identity and for a job that names a
    bad row or a row outside the table (ok False)."""
    points, ok = [], np.ones(len(idx), dtype=bool)
    for b, row in enumerate(idx):
        agg = None
        for d in row:
            p = table[d] if 0 <= d < len(table) else False
            if p is False:
                ok[b] = False
            elif p is not None:
                agg = add(agg, p)
        points.append(agg if ok[b] else None)
    return points, ok


def g1_aggregate_plain(x: torch.Tensor, sign_big: torch.Tensor,
                       is_inf: torch.Tensor, valid: torch.Tensor,
                       index: torch.Tensor):
    """The G1 aggregate kernel's function with the port's host arithmetic:
    D distinct packed shares ([D, 32] int32 limbs, [D] uint8 flags) and the
    [B, n] index of each job's shares among them → (X, Y, Z [B, 32] int32,
    ok [B] bool). Each distinct share is decompressed once (crypto/bls_ops
    g1_decompress) and each job sums its finite shares (g1_add); a job
    with a share that is not a valid encoding or not on the curve, or with
    an index outside [0, D), gives ok False and the identity."""
    from plenum_tpu_torch.crypto import bls_ops
    D, (B, n) = int(x.shape[0]), tuple(index.shape)
    _check_g1_args(x, sign_big, is_inf, valid, index, D, B, n)
    idx = index.cpu().numpy()
    xs, sg = x.cpu().numpy(), sign_big.cpu().numpy()
    table = decompressed_table(
        valid.cpu().numpy(), is_inf.cpu().numpy(),
        lambda d: bls_ops.g1_decompress(g1_bytes(xs[d], sg[d])))
    points, ok = job_sums(table, idx, bls_ops.g1_add)
    X, Y, Z = (torch.from_numpy(a).to(x.device) for a in store_points(points))
    return X, Y, Z, torch.from_numpy(ok).to(x.device)


def g1_aggregate_scratch(B: int, D: int, device) -> torch.Tensor:
    """The device scratch of a G1 aggregate launch: the decompressed
    points, their status, the jobs' sums and flags."""
    return torch.empty((library("bls381_agg").bls_g1_aggregate_scratch_bytes(
        B, D),), dtype=torch.uint8, device=device)


def g1_aggregate_cuda(x: torch.Tensor, sign_big: torch.Tensor,
                      is_inf: torch.Tensor, valid: torch.Tensor,
                      index: torch.Tensor, scratch=None, stages=(0, 2)):
    """The CUDA kernels (csrc/bls381_agg.cu, bls_g1_aggregate: each
    distinct share decompressed once, each job summed on sextets, each sum
    normalized by one inversion) on CUDA tensors, the function of
    g1_aggregate_plain. Launches on the current stream and returns without
    synchronising; counts each call in `g1_aggregate_cuda.launches`.
    `stages` (first, last of 0 decompression, 1 sums, 2 normalization)
    with a `scratch` from g1_aggregate_scratch that an earlier call filled
    runs part of a launch, for timing."""
    D, (B, n) = int(x.shape[0]), tuple(index.shape)
    _check_g1_args(x, sign_big, is_inf, valid, index, D, B, n)
    _need_cuda(x, "g1_aggregate_cuda")
    first, last = agg_stages_arg(stages)
    dev = x.device
    X, Y, Z = (torch.empty((B, NLIMB), dtype=torch.int32, device=dev)
               for _ in range(3))
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return X, Y, Z, ok
    if scratch is None:
        scratch = g1_aggregate_scratch(B, D, dev)
    fn = library("bls381_agg").bls_g1_aggregate
    with torch.cuda.device(dev):
        err = fn(*_ptrs(x, sign_big, is_inf, valid), D, index.data_ptr(), B,
                 n, *_ptrs(scratch, X, Y, Z, ok), first, last, _stream(dev))
    launch_error("bls_g1_aggregate", err)
    g1_aggregate_cuda.launches += 1
    return X, Y, Z, ok


g1_aggregate_cuda.launches = 0


def g1_aggregate(x, sign_big, is_inf, valid, index):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(g1_aggregate_cuda, g1_aggregate_plain, x, x, sign_big,
                  is_inf, valid, index)


def pack_g1_raw(raw: np.ndarray):
    """[B, n, 48] compressed shares → the kernel's five numpy arrays: the D
    distinct encodings' limbs [D, 32] and flags [D] (sign, infinity,
    valid), and the [B, n] index of each job's shares among them."""
    B, n = raw.shape[:2]
    distinct, index = distinct_rows(raw.reshape(B * n, G1_BYTES))
    return tuple(pack_compressed(distinct)) + (index.reshape(B, n),)


def pack_g1_jobs(jobs: Sequence[Sequence[bytes]], n: int):
    """B jobs of at most n compressed shares → pack_g1_raw's five arrays;
    short jobs padded with the infinity encoding (the identity under
    addition), which is one row too."""
    return pack_g1_raw(raw_points(jobs, n, G1_BYTES))


def g1_aggregate_cost(x, sign_big, is_inf, valid, index, ok, Z):
    """The (M, S, O) that one G1 aggregate launch's function needs, from
    its packed inputs ([D, 32] limbs, [D] flags, [B, n] index) and its
    outputs ok [B] and Z [B, 32] (numpy): each distinct valid finite share
    decompressed once; in each job that decoded, a mixed addition for each
    finite share past the first; the finite aggregates normalized."""
    finite = np.asarray(valid, bool) & ~np.asarray(is_inf, bool)
    ok = np.asarray(ok, bool)
    per_job = finite[np.asarray(index)].sum(axis=1)
    stores = int((ok & np.asarray(Z).any(axis=-1)).sum())
    return distinct_points(x, sign_big, finite=finite) \
        * COST["g1_decompress"] \
        + int(np.maximum(per_job[ok] - 1, 0).sum()) * COST["g1_madd"] \
        + store_cost(stores, G1_STORE)


def aggregate_dispatch(jobs: Sequence[Sequence[bytes]], n: int, device=None):
    """Enqueue the aggregation of B share-sets (each at most n compressed
    G1 signatures) on `device` (None means CUDA): one upload and one call
    of exactly B jobs, nothing read back. → the handles for
    aggregate_collect.

    A job batch that clears the mesh gate (ops/mesh.py) is padded to the
    mesh's padded size with all-infinity jobs (each aggregates to the
    identity) and split over the mesh's devices; each shard packs its own
    distinct shares and index, and its results are gathered onto `device`
    and cut to B."""
    dev = resolve_device(device)
    B = len(jobs)
    from plenum_tpu_torch.ops import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    sharded = m.should_shard(B, dev)
    Bp = m.padded_size(B, min_per_device=1) if sharded else B
    # job-axis lane accounting: real shares against the Bp x n grid
    _tmy.get_seam_hub().record_launch(
        _tmy.SEAM_BLS, sum(len(j) for j in jobs), Bp * n, shape=(Bp, n))
    if sharded:
        raw = raw_points(list(jobs) + [[]] * (Bp - B), n, G1_BYTES)
        outs = m.dispatch(g1_aggregate, [raw], n=B,
                          label="aggregate_dispatch",
                          place=lambda shard, d: upload(pack_g1_raw(shard[0]),
                                                        d))
        return tuple(t[:B] for t in m.gather(outs, dev))
    m.note_passthrough(B)
    return g1_aggregate(*upload(pack_g1_jobs(jobs, n), dev))


def aggregate_collect(handles) -> Tuple[List[Optional[Tuple[int, int]]],
                                        np.ndarray]:
    """The one read-back of an aggregate_dispatch → (points, valid):
    points[i] the affine aggregate (x, y), or None for the identity or a
    job with an undecodable share; valid[i] False for such a job. The
    results come normalized: (x, y) is read as it is."""
    X, Y, Z, ok = (h.cpu().numpy() for h in handles)
    xs, ys, zs = _limbs_to_ints(X), _limbs_to_ints(Y), _limbs_to_ints(Z)
    pts = [affine_or_none(int(xs[i]), int(ys[i]), int(zs[i]))
           if ok[i] else None for i in range(len(ok))]
    return pts, ok.astype(bool)


def aggregate_g1_jobs(jobs: Sequence[Sequence[bytes]], device=None):
    """Aggregate B independent share-sets in one call → (points, valid)
    as aggregate_collect gives them."""
    if len(jobs) == 0:
        return [], np.zeros(0, dtype=bool)
    n = max(1, max(len(j) for j in jobs))
    return aggregate_collect(aggregate_dispatch(jobs, n, device))
