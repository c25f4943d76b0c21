"""Batched BLS12-381 pairing-product checks, G1 multi-scalar multiplication
and G2 aggregation on the device.

Port of plenum_tpu/ops/bls381_pairing.py (`_pairing_kernel`, `_msm_kernel`
and `_g2_aggregate_kernel`, XLA device programs, and their dispatch and
collect); the kernels are csrc/bls381.cu. The mesh branches of the JAX
package stay out (ROADMAP A5), and so does its padding of the job and pair
axes to powers of two, which only let jit reuse a compiled shape: a launch
takes exactly B jobs of P pairs (the most pairs of any job; shorter jobs
are padded with infinity pairs, which are neutral).

- `pairing_*`: B jobs of (compressed G1 48 B, compressed G2 96 B) pairs →
  verdict[B] (the product of the pairings is 1 and every pair decoded),
  decode_ok[B]. A pair with both points at infinity is neutral, one at
  infinity fails its job. No subgroup checks: crypto/bls.py makes them
  before it builds jobs. The contract is crypto/bls_ops.pairing_job_host.
- `msm_*`: Σ sᵢ·Pᵢ over compressed G1 points, scalars mod r as 64 base-16
  digits (most significant first).
- `g2_aggregate_*`: B sets of compressed G2 points (public keys), each
  summed.

Each kernel has its plain version here, on the port's host arithmetic
(crypto/bls_ops: the pairing check of pairing_job_host, g1_decompress,
g1_mul, g1_add, g2_decompress, g2_add), taking the same packed tensors
and giving tensors of the kernel's shapes and types; the wrapper takes it
for CPU tensors only. A dispatch uploads and launches and reads nothing
back; its collect is the one synchronisation.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from plenum_tpu_torch.observability import telemetry as _tmy
from plenum_tpu_torch.ops import resolve_device
from plenum_tpu_torch.ops.bls381 import (
    COST, FP2_INV, FP_INV, G1_BYTES, G2_BYTES, M, M2, MILLER_ADDITIONS,
    MILLER_DOUBLINGS, NLIMB, Q, R_ORD, _check, _ints_to_limbs,
    _limbs_to_ints, _need_cuda, _proj_to_affine, _ptrs, _route, _stream,
    distinct_points, g1_bytes, g2_bytes, int32_ops, launch_error, library,
    pack_compressed, pack_g2_compressed, raw_points, store_points,
    store_cost, upload)

MSM_DIGITS = 64

# ---------------------------------------------------------------- packing


def _pack_pair_arrays(jobs, B: int, P: int):
    """B jobs of at most P (G1, G2) byte pairs → the pairing kernel's nine
    numpy arrays: G1 limbs [B, P, 32] and flags [B, P] (sign, infinity,
    valid), G2 c1 and c0 limbs and flags; short jobs padded with
    infinity pairs."""
    g1raw = raw_points([[p[0] for p in j] for j in jobs], P, G1_BYTES)
    g2raw = raw_points([[p[1] for p in j] for j in jobs], P, G2_BYTES)
    l1, s1, i1, v1 = pack_compressed(g1raw.reshape(B * P, G1_BYTES))
    c1, c0, s2, i2, v2 = pack_g2_compressed(g2raw.reshape(B * P, G2_BYTES))
    return (l1.reshape(B, P, NLIMB), s1.reshape(B, P), i1.reshape(B, P),
            v1.reshape(B, P), c1.reshape(B, P, NLIMB),
            c0.reshape(B, P, NLIMB), s2.reshape(B, P), i2.reshape(B, P),
            v2.reshape(B, P))


# ---------------------------------------------------------------- pairing

def pairing_plain(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v):
    """The pairing kernel's function with the port's host arithmetic:
    packed [B, P] pairs → (verdict [B] bool, decode_ok [B] bool), per job
    the semantics of crypto/bls_ops.pairing_job_host (a both-infinity pair
    neutral, a one-sided infinity or an undecodable point failing the
    job, else the product of the live pairs' pairings equal to 1). G2
    decompressions are memoized within the call (jobs repeat keys)."""
    from plenum_tpu_torch.crypto import bls_ops
    B, P = int(g1x.shape[0]), int(g1x.shape[1])
    _check_pairing_args(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v, B, P)
    a = [t.cpu().numpy() for t in (g1x, g1s, g1i, g1v, g2c1, g2c0, g2s,
                                   g2i, g2v)]
    x1, s1, i1, v1, c1, c0, s2, i2, v2 = a
    g2_memo = {}
    verdict = np.zeros(B, dtype=bool)
    decode_ok = np.zeros(B, dtype=bool)
    for b in range(B):
        ok, live = True, []
        for p in range(P):
            if not (v1[b, p] and v2[b, p]) or i1[b, p] != i2[b, p]:
                ok = False
                continue
            if i1[b, p]:
                continue
            try:
                g1 = bls_ops.g1_decompress(g1_bytes(x1[b, p], s1[b, p]))
                raw2 = g2_bytes(c1[b, p], c0[b, p], s2[b, p])
                if raw2 not in g2_memo:
                    g2_memo[raw2] = bls_ops.g2_decompress(raw2)
                live.append((g1, g2_memo[raw2]))
            except ValueError:
                ok = False
        decode_ok[b] = ok
        if ok:
            try:
                verdict[b] = not live or bls_ops.multi_pairing_is_one(live)
            except (ValueError, ZeroDivisionError):
                # the pure-Python backend's degenerate inversion on an
                # adversarial point (pairing_job_host's rule)
                verdict[b] = False
    dev = g1x.device
    return torch.from_numpy(verdict).to(dev), \
        torch.from_numpy(decode_ok).to(dev)


def _check_pairing_args(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v, B, P):
    _check(g1x, (B, P, NLIMB), torch.int32, g1x=g1x, g2c1=g2c1, g2c0=g2c0)
    _check(g1x, (B, P), torch.uint8, g1s=g1s, g1i=g1i, g1v=g1v, g2s=g2s,
           g2i=g2i, g2v=g2v)


def pairing_cuda(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v):
    """The CUDA kernels (csrc/bls381.cu, bls_pairing: a thread per pair for
    the decompressions and the Miller loop, then a thread per job for the
    product and the final exponentiation) on CUDA tensors, the function of
    pairing_plain. Launches on the current stream, reads nothing back;
    counts each call in `pairing_cuda.launches`."""
    B, P = int(g1x.shape[0]), int(g1x.shape[1])
    _check_pairing_args(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v, B, P)
    _need_cuda(g1x, "pairing_cuda")
    dev = g1x.device
    verdict = torch.empty((B,), dtype=torch.bool, device=dev)
    decode_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0 or P == 0:
        return verdict.fill_(True), decode_ok.fill_(True)
    f = torch.empty((B * P, 12 * 6), dtype=torch.int64, device=dev)
    state = torch.empty((B * P,), dtype=torch.uint8, device=dev)
    fn = library().bls_pairing
    with torch.cuda.device(dev):
        err = fn(*_ptrs(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v), B, P,
                 *_ptrs(f, state, verdict, decode_ok), _stream(dev))
    launch_error("bls_pairing", err)
    pairing_cuda.launches += 1
    return verdict, decode_ok


pairing_cuda.launches = 0


def pairing(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(pairing_cuda, pairing_plain, arrays[0], *arrays)


def pairing_cost(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v, decode_ok):
    """The (M, S) that one pairing launch's function needs, from its packed
    inputs (numpy) and its decode_ok [B]: each distinct valid finite G1
    and G2 point decompressed once; the lines of each distinct G2 point of
    a live pair (its doubling and addition steps); in each job that
    decoded with a live pair, one Miller accumulator (its squarings past
    the first, of one), each live pair's lines evaluated and multiplied
    in, and one final exponentiation."""
    m = COST
    g1f = np.asarray(g1v, bool) & ~np.asarray(g1i, bool)
    g2f = np.asarray(g2v, bool) & ~np.asarray(g2i, bool)
    live = g1f & g2f & np.asarray(decode_ok, bool)[:, None]
    jobs = int(live.any(axis=1).sum())
    lines = MILLER_DOUBLINGS * m["miller_dbl"] \
        + MILLER_ADDITIONS * m["miller_add"]
    return distinct_points(g1x, g1s, finite=g1f) * m["g1_decompress"] \
        + distinct_points(g2c1, g2c0, g2s, finite=g2f) * m["g2_decompress"] \
        + distinct_points(g2c1, g2c0, g2s, finite=live) * lines \
        + int(live.sum()) * (MILLER_DOUBLINGS + MILLER_ADDITIONS) \
        * m["line"] \
        + jobs * ((MILLER_DOUBLINGS - 1) * m["fp12_sqr"] + m["final_exp"])


def pairing_dispatch(jobs: Sequence[Sequence[Tuple[bytes, bytes]]],
                     device=None):
    """Enqueue one batched pairing-product check of B jobs, each a list of
    (compressed G1, compressed G2) pairs, on `device` (None means CUDA):
    one upload, one launch, nothing read back. → handles for
    pairing_collect."""
    dev = resolve_device(device)
    B = len(jobs)
    P = max(1, max((len(j) for j in jobs), default=1))
    _tmy.get_seam_hub().record_launch(
        _tmy.SEAM_BLS_PAIR, sum(len(j) for j in jobs), B * P, shape=(B, P))
    return pairing(*upload(_pack_pair_arrays(jobs, B, P), dev))


def pairing_collect(handles) -> Tuple[np.ndarray, np.ndarray]:
    """The one read-back of a pairing_dispatch → (verdict[B],
    decode_ok[B]) numpy bools."""
    verdict, ok = (h.cpu().numpy() for h in handles)
    return verdict, ok


def pairing_jobs(jobs, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch and collect in one call, on `device` (None means CUDA)."""
    if len(jobs) == 0:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=bool)
    return pairing_collect(pairing_dispatch(jobs, device))


# -------------------------------------------------------------------- MSM

def scalar_digits(scalars: Sequence[int], n: int = None) -> np.ndarray:
    """Scalars mod r → [n, 64] int32 base-16 digits, most significant
    first (rows past the scalars zero)."""
    n = len(scalars) if n is None else n
    sb = np.zeros((n, 32), dtype=np.uint8)
    if scalars:
        sb[:len(scalars)] = np.frombuffer(b"".join(
            (int(s) % R_ORD).to_bytes(32, "big") for s in scalars),
            dtype=np.uint8).reshape(-1, 32)
    digits = np.zeros((n, MSM_DIGITS), dtype=np.int32)
    digits[:, 0::2] = sb >> 4
    digits[:, 1::2] = sb & 0xF
    return digits


def _digits_to_int(row) -> int:
    v = 0
    for d in row:
        v = (v << 4) | int(d)
    return v


def _check_msm_args(x, s, i, v, digits, N):
    _check(x, (N, NLIMB), torch.int32, x=x)
    _check(x, (N,), torch.uint8, sign_big=s, is_inf=i, valid=v)
    _check(x, (N, MSM_DIGITS), torch.int32, digits=digits)


def msm_plain(x, sign_big, is_inf, valid, digits):
    """The MSM kernel's function with the port's host arithmetic: [N, 32]
    limbs, [N] flags, [N, 64] digits → (X, Y, Z [32] int32 normalized,
    ok bool scalar tensor): Σ sᵢ·Pᵢ by g1_decompress, g1_mul and g1_add
    over the finite points; a point that is not a valid encoding or not
    on the curve gives ok False and the identity."""
    from plenum_tpu_torch.crypto import bls_ops
    N = int(x.shape[0])
    _check_msm_args(x, sign_big, is_inf, valid, digits, N)
    xs, sg, inf, val, dig = (t.cpu().numpy() for t in
                             (x, sign_big, is_inf, valid, digits))
    agg, ok = None, True
    for k in range(N):
        if not val[k]:
            ok = False
            continue
        if inf[k]:
            continue
        try:
            p = bls_ops.g1_decompress(g1_bytes(xs[k], sg[k]))
        except ValueError:
            ok = False
            continue
        agg = bls_ops.g1_add(agg, bls_ops.g1_mul(p, _digits_to_int(dig[k])))
    X, Y, Z = (torch.from_numpy(a[0]).to(x.device)
               for a in store_points([agg if ok else None]))
    return X, Y, Z, torch.tensor(ok, device=x.device)


def msm_cuda(x, sign_big, is_inf, valid, digits):
    """The CUDA kernels (csrc/bls381.cu, bls_g1_msm: a thread per point and
    a tree sum per block, then one block over the blocks' sums) on CUDA
    tensors, the function of msm_plain. Counts each call in
    `msm_cuda.launches`; reads nothing back."""
    N = int(x.shape[0])
    _check_msm_args(x, sign_big, is_inf, valid, digits, N)
    _need_cuda(x, "msm_cuda")
    dev = x.device
    X, Y, Z = (torch.empty((NLIMB,), dtype=torch.int32, device=dev)
               for _ in range(3))
    ok = torch.empty((), dtype=torch.bool, device=dev)
    if N == 0:
        X.zero_(), Z.zero_(), Y.zero_()
        Y[0] = 1
        return X, Y, Z, ok.fill_(True)
    lib = library()
    blocks = lib.bls_msm_blocks(N)
    # the blocks' partial sums (3 x 48 bytes each), then the flag word
    scratch = torch.zeros((blocks * 144 + 16,), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.bls_g1_msm(*_ptrs(x, sign_big, is_inf, valid, digits), N,
                             *_ptrs(scratch, X, Y, Z, ok), _stream(dev))
    launch_error("bls_g1_msm", err)
    msm_cuda.launches += 1
    return X, Y, Z, ok


msm_cuda.launches = 0


def msm(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(msm_cuda, msm_plain, arrays[0], *arrays)


def msm_cost(x, sign_big, is_inf, valid, digits, ok, Z):
    """The (M, S) that one MSM call's function needs, from its packed
    inputs and its outputs ok and Z [32] (numpy): each distinct valid
    finite point decompressed once, then the bucket method at the window
    width c that needs least: in each of the ceil(255 / c) windows a mixed
    addition for each finite point whose digit there is not zero, the
    running sum of the 2^c - 1 buckets (2^(c+1) - 4 additions), and
    between windows c doublings and an addition; the result normalized."""
    m = COST
    finite = np.asarray(valid, bool) & ~np.asarray(is_inf, bool)
    if not bool(ok):
        return distinct_points(x, sign_big, finite=finite) \
            * m["g1_decompress"]
    nib = np.asarray(digits)[finite].astype(np.uint8)
    bits = np.unpackbits(((nib[:, 0::2] << 4) | nib[:, 1::2])[:, :, None],
                         axis=2).reshape(len(nib), -1)[:, 1:]   # 255 bits
    best = None
    for c in range(1, 17):
        W = -(-255 // c)
        padded = np.zeros((len(nib), W * c), dtype=np.uint8)
        padded[:, W * c - 255:] = bits
        nonzero = int(padded.reshape(len(nib), W, c).any(axis=2).sum())
        cost = nonzero * m["g1_madd"] \
            + W * (2 ** (c + 1) - 4) * m["g1_add"] \
            + (W - 1) * (c * m["g1_dbl"] + m["g1_add"])
        if best is None or int32_ops(cost) < int32_ops(best):
            best = cost
    store = int(bool(np.asarray(Z).any()))
    return distinct_points(x, sign_big, finite=finite) * m["g1_decompress"] \
        + best + store_cost(store, FP_INV, M, 2 * M)


def msm_dispatch(points: Sequence[bytes], scalars: Sequence[int],
                 device=None):
    """Enqueue Σ sᵢ·Pᵢ over compressed G1 points on `device` (None means
    CUDA), exactly N points; nothing read back."""
    dev = resolve_device(device)
    N = len(points)
    _tmy.get_seam_hub().record_launch(_tmy.SEAM_BLS_MSM, N, N, shape=(N,))
    raw = np.frombuffer(b"".join(points), dtype=np.uint8).reshape(-1,
                                                                  G1_BYTES)
    limbs, sign_big, is_inf, valid = pack_compressed(raw)
    return msm(*upload([limbs, sign_big, is_inf, valid,
                        scalar_digits(scalars, N)], dev))


def msm_collect(handles) -> Tuple[Optional[Tuple[int, int]], bool]:
    """The one read-back of an msm_dispatch → (affine (x, y) ints or None
    for the identity, decode_ok); the point is None when an input did not
    decode."""
    X, Y, Z, ok = (h.cpu().numpy() for h in handles)
    if not bool(ok):
        return None, False
    xi, yi, zi = (int(_limbs_to_ints(a[None])[0]) for a in (X, Y, Z))
    return _proj_to_affine(xi, yi, zi), True


def msm_g1(points: Sequence[bytes], scalars: Sequence[int], device=None):
    """Dispatch and collect: (affine point | None, decode_ok)."""
    if len(points) == 0:
        return None, True
    return msm_collect(msm_dispatch(points, scalars, device))


# ------------------------------------------------------- G2 aggregation

def _check_g2agg_args(c1, c0, s, i, v, B, n):
    _check(c1, (B, n, NLIMB), torch.int32, c1=c1, c0=c0)
    _check(c1, (B, n), torch.uint8, sign_big=s, is_inf=i, valid=v)


def g2_aggregate_plain(c1, c0, sign_big, is_inf, valid):
    """The G2 aggregate kernel's function with the port's host arithmetic:
    [B, n, 32] c1 and c0 limbs and [B, n] flags → (X, Y, Z [B, 2, 32]
    int32, c0 then c1, normalized; ok [B] bool): each job the sum of its
    finite points (g2_decompress, g2_add), or the identity with ok False
    when a point is not a valid encoding or not on the curve."""
    from plenum_tpu_torch.crypto import bls_ops
    B, n = int(c1.shape[0]), int(c1.shape[1])
    _check_g2agg_args(c1, c0, sign_big, is_inf, valid, B, n)
    a1, a0, sg, inf, val = (t.cpu().numpy() for t in
                            (c1, c0, sign_big, is_inf, valid))
    out = np.zeros((3, B, 2, NLIMB), dtype=np.int32)
    ok = np.ones(B, dtype=bool)
    memo = {}
    for b in range(B):
        agg = None
        for j in range(n):
            if not val[b, j]:
                ok[b] = False
                continue
            if inf[b, j]:
                continue
            raw = g2_bytes(a1[b, j], a0[b, j], sg[b, j])
            try:
                if raw not in memo:
                    memo[raw] = bls_ops.g2_decompress(raw)
            except ValueError:
                ok[b] = False
                continue
            agg = bls_ops.g2_add(agg, memo[raw])
        if agg is None or not ok[b]:
            coords = ((0, 0), (1, 0), (0, 0))
        else:
            coords = ((agg[0].c0, agg[0].c1), (agg[1].c0, agg[1].c1), (1, 0))
        for k, (v0, v1) in enumerate(coords):
            out[k, b] = _ints_to_limbs([v0, v1])
    X, Y, Z = (torch.from_numpy(out[k]).to(c1.device) for k in range(3))
    return X, Y, Z, torch.from_numpy(ok).to(c1.device)


def g2_aggregate_cuda(c1, c0, sign_big, is_inf, valid):
    """The CUDA kernel (csrc/bls381.cu, bls_g2_aggregate: a block per job,
    a thread per point, a tree sum in shared memory) on CUDA tensors, the
    function of g2_aggregate_plain. Counts each launch in
    `g2_aggregate_cuda.launches`; reads nothing back."""
    B, n = int(c1.shape[0]), int(c1.shape[1])
    _check_g2agg_args(c1, c0, sign_big, is_inf, valid, B, n)
    _need_cuda(c1, "g2_aggregate_cuda")
    dev = c1.device
    X, Y, Z = (torch.empty((B, 2, NLIMB), dtype=torch.int32, device=dev)
               for _ in range(3))
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return X, Y, Z, ok
    fn = library().bls_g2_aggregate
    with torch.cuda.device(dev):
        err = fn(*_ptrs(c1, c0, sign_big, is_inf, valid), B, n,
                 *_ptrs(X, Y, Z, ok), _stream(dev))
    launch_error("bls_g2_aggregate", err)
    g2_aggregate_cuda.launches += 1
    return X, Y, Z, ok


g2_aggregate_cuda.launches = 0


def g2_aggregate(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(g2_aggregate_cuda, g2_aggregate_plain, arrays[0], *arrays)


def pack_g2_jobs(jobs: Sequence[Sequence[bytes]], n: int):
    """B jobs of at most n compressed G2 points → the G2 kernel's five
    numpy arrays, short jobs padded with infinity points."""
    B = len(jobs)
    raw = raw_points(jobs, n, G2_BYTES)
    c1, c0, sg, inf, valid = pack_g2_compressed(raw.reshape(B * n, 96))
    return (c1.reshape(B, n, NLIMB), c0.reshape(B, n, NLIMB),
            sg.reshape(B, n), inf.reshape(B, n), valid.reshape(B, n))


def g2_aggregate_cost(c1, c0, sign_big, is_inf, valid, ok, Z):
    """The (M, S) that one G2 aggregate launch's function needs, as
    bls381.g1_aggregate_cost counts them over fp2 (Z [B, 2, 32])."""
    finite = np.asarray(valid, bool) & ~np.asarray(is_inf, bool)
    ok = np.asarray(ok, bool)
    per_job = finite.sum(axis=1)
    stores = int((ok & np.asarray(Z).reshape(len(ok), -1).any(axis=-1))
                 .sum())
    return distinct_points(c1, c0, sign_big, finite=finite) \
        * COST["g2_decompress"] \
        + int(np.maximum(per_job[ok] - 1, 0).sum()) * COST["g2_madd"] \
        + store_cost(stores, FP2_INV, M2, 4 * M)


def g2_aggregate_dispatch(jobs: Sequence[Sequence[bytes]], n: int,
                          device=None):
    """Enqueue B sets of at most n compressed G2 points (public keys) on
    `device` (None means CUDA); nothing read back."""
    dev = resolve_device(device)
    B = len(jobs)
    _tmy.get_seam_hub().record_launch(
        _tmy.SEAM_BLS, sum(len(j) for j in jobs), B * n, shape=(B, n))
    return g2_aggregate(*upload(pack_g2_jobs(jobs, n), dev))


def g2_aggregate_collect(handles):
    """The one read-back of a g2_aggregate_dispatch → (points, valid):
    points[i] = affine ((x.c0, x.c1), (y.c0, y.c1)) ints, or None for the
    identity or a job with an undecodable point."""
    X, Y, Z, ok = (h.cpu().numpy() for h in handles)
    out: List[Optional[Tuple[Tuple[int, int], Tuple[int, int]]]] = []
    for i in range(len(ok)):
        x0, x1 = (int(v) for v in _limbs_to_ints(X[i]))
        y0, y1 = (int(v) for v in _limbs_to_ints(Y[i]))
        z0, z1 = (int(v) for v in _limbs_to_ints(Z[i]))
        if not ok[i] or (z0 == 0 and z1 == 0):
            out.append(None)
            continue
        den = (z0 * z0 + z1 * z1) % Q
        di = pow(den, Q - 2, Q)
        iz = (z0 * di % Q, (-z1) * di % Q)

        def fq2mul(a, b):
            return ((a[0] * b[0] - a[1] * b[1]) % Q,
                    (a[0] * b[1] + a[1] * b[0]) % Q)

        out.append((fq2mul((x0, x1), iz), fq2mul((y0, y1), iz)))
    return out, ok.astype(bool)
