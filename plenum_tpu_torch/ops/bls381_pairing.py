"""Batched BLS12-381 pairing-product checks, G1 multi-scalar multiplication
and G2 aggregation on the device.

Port of plenum_tpu/ops/bls381_pairing.py (`_pairing_kernel`, `_msm_kernel`
and `_g2_aggregate_kernel`, XLA device programs, and their dispatch and
collect); the kernels are csrc/bls381.cu (the pairing), bls381_msm.cu
and bls381_agg.cu. The JAX package's padding of the job and pair axes to
powers of two, which only let jit reuse a compiled shape, stays out: a
launch takes exactly B jobs of P pairs (the most pairs of any job; shorter
jobs are padded with infinity pairs, which are neutral). Its mesh branches
are here (ops/mesh.py): a pairing batch that clears the gate splits its
jobs over the devices; the MSM and the G2 aggregate never shard and count
a passthrough.

- `pairing_*`: B jobs of (compressed G1 48 B, compressed G2 96 B) pairs →
  verdict[B] (the product of the pairings is 1 and every pair decoded),
  decode_ok[B]. A pair with both points at infinity is neutral, one at
  infinity fails its job. No subgroup checks: crypto/bls.py makes them
  before it builds jobs. The contract is crypto/bls_ops.pairing_job_host.
  The host packs each distinct G2 encoding once (a launch's jobs share a
  handful of keys) with an index a pair, so the card decompresses each
  key and runs its Miller lines once.
- `msm_*`: Σ sᵢ·Pᵢ over compressed G1 points, scalars mod r as 64 base-16
  digits (most significant first); each distinct point packed once, with
  an index a scalar.
- `g2_aggregate_*`: B sets of compressed G2 points (public keys), each
  summed; each distinct encoding packed once, with a [B, n] index.

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
    COST, G1_BYTES, G1_STORE, G2_BYTES, G2_STORE, MILLER_ADDITIONS,
    MILLER_DOUBLINGS, NLIMB, R_ORD, _check, _ints_to_limbs, _limbs_to_ints,
    _need_cuda, _proj_to_affine, _ptrs, _route, _stream, agg_stages_arg,
    decompressed_table, distinct_points, distinct_rows, g1_bytes, g2_bytes,
    int32_ops, job_sums, launch_error, library, pack_compressed,
    pack_g2_compressed, raw_points, store_cost, store_points, upload)

MSM_DIGITS = 64

# ---------------------------------------------------------------- packing


def _pair_raw(jobs, B: int, P: int):
    """B jobs of at most P (G1, G2) byte pairs → ([B, P, 48], [B, P, 96])
    uint8 encodings, short jobs padded with infinity pairs."""
    return (raw_points([[p[0] for p in j] for j in jobs], P, G1_BYTES),
            raw_points([[p[1] for p in j] for j in jobs], P, G2_BYTES))


def _pack_pair_raw(g1raw: np.ndarray, g2raw: np.ndarray):
    """[B, P, 48] and [B, P, 96] encodings → the pairing kernel's ten numpy
    arrays: G1 limbs [B, P, 32] and flags [B, P] (sign, infinity, valid),
    the index [B, P] int32 of each pair's G2 key, then the K distinct keys'
    c1 and c0 limbs [K, 32] and flags [K]."""
    B, P = g1raw.shape[:2]
    l1, s1, i1, v1 = pack_compressed(g1raw.reshape(B * P, G1_BYTES))
    keys, kidx = distinct_rows(g2raw.reshape(B * P, G2_BYTES))
    return (l1.reshape(B, P, NLIMB), s1.reshape(B, P), i1.reshape(B, P),
            v1.reshape(B, P), kidx.reshape(B, P)) \
        + tuple(pack_g2_compressed(keys))


def _pack_pair_arrays(jobs, B: int, P: int):
    """B jobs of at most P (G1, G2) byte pairs → _pack_pair_raw's ten
    arrays."""
    return _pack_pair_raw(*_pair_raw(jobs, B, P))


def expand_keys(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v):
    """The pairing's packed arrays (numpy) with each pair's key written
    out: the nine [B, P] arrays of the JAX package's layout, which
    pairing_cost counts from."""
    k = np.asarray(kidx)
    return (g1x, g1s, g1i, g1v) + tuple(np.asarray(a)[k] for a in
                                        (g2c1, g2c0, g2s, g2i, g2v))


# ---------------------------------------------------------------- pairing

def pairing_plain(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v):
    """The pairing kernel's function with the port's host arithmetic:
    packed [B, P] pairs (each pair's G2 key by its index into [K] key
    rows) → (verdict [B] bool, decode_ok [B] bool), per job the semantics
    of crypto/bls_ops.pairing_job_host (a both-infinity pair neutral, a
    one-sided infinity or an undecodable point failing the job, else the
    product of the live pairs' pairings equal to 1). Each key is
    decompressed once a call."""
    from plenum_tpu_torch.crypto import bls_ops
    B, P = int(g1x.shape[0]), int(g1x.shape[1])
    K = int(g2c1.shape[0])
    _check_pairing_args(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v,
                        B, P, K)
    x1, s1, i1, v1, ki, c1, c0, s2, i2, v2 = (
        t.cpu().numpy() for t in (g1x, g1s, g1i, g1v, kidx, g2c1, g2c0,
                                  g2s, g2i, g2v))
    if ((ki < 0) | (ki >= K)).any():
        raise ValueError("kidx holds a key index outside [0, {})".format(K))
    g2_memo = {}
    verdict = np.zeros(B, dtype=bool)
    decode_ok = np.zeros(B, dtype=bool)
    for b in range(B):
        ok, live = True, []
        for p in range(P):
            k = ki[b, p]
            if not (v1[b, p] and v2[k]) or i1[b, p] != i2[k]:
                ok = False
                continue
            if i1[b, p]:
                continue
            try:
                g1 = bls_ops.g1_decompress(g1_bytes(x1[b, p], s1[b, p]))
                if k not in g2_memo:
                    g2_memo[k] = bls_ops.g2_decompress(
                        g2_bytes(c1[k], c0[k], s2[k]))
                live.append((g1, g2_memo[k]))
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


def _check_pairing_args(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v,
                        B, P, K):
    _check(g1x, (B, P, NLIMB), torch.int32, g1x=g1x)
    _check(g1x, (B, P), torch.uint8, g1s=g1s, g1i=g1i, g1v=g1v)
    _check(g1x, (B, P), torch.int32, kidx=kidx)
    _check(g1x, (K, NLIMB), torch.int32, g2c1=g2c1, g2c0=g2c0)
    _check(g1x, (K,), torch.uint8, g2s=g2s, g2i=g2i, g2v=g2v)


def pairing_scratch(B: int, P: int, K: int, device) -> torch.Tensor:
    """The device scratch of a pairing launch: the keys' line tables, the
    decompressed G1 points, the jobs' Miller values and flags."""
    return torch.empty((library().bls_pairing_scratch_bytes(B, P, K),),
                       dtype=torch.uint8, device=device)


def pairing_cuda(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v,
                 scratch=None, stages=(0, 2)):
    """The CUDA kernels (csrc/bls381.cu, bls_pairing: the keys' Miller
    lines and the G1 decompressions, one Miller accumulator a job on six
    lanes, the final exponentiation on six lanes a job) on CUDA tensors,
    the function of pairing_plain. Launches on the current stream, reads
    nothing back; counts each call in `pairing_cuda.launches`. `stages`
    (first, last of 0 lines, 1 Miller, 2 final exponentiation) with a
    `scratch` from pairing_scratch that an earlier call filled runs part
    of a launch, for timing."""
    B, P = int(g1x.shape[0]), int(g1x.shape[1])
    K = int(g2c1.shape[0])
    _check_pairing_args(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v,
                        B, P, K)
    _need_cuda(g1x, "pairing_cuda")
    # the kernel keeps one bit a pair in a 32-bit mask (csrc/bls381.cu):
    # a limit of the kernel, not the verifier's batch threshold
    if P > 32:  # plenum-lint: disable=PT005
        raise ValueError("pairing_cuda takes at most 32 pairs a job")
    dev = g1x.device
    verdict = torch.empty((B,), dtype=torch.bool, device=dev)
    decode_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0 or P == 0:
        return verdict.fill_(True), decode_ok.fill_(True)
    if scratch is None:
        scratch = pairing_scratch(B, P, K, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.bls_pairing_stages(
            *_ptrs(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i, g2v), B,
            P, K, *_ptrs(scratch, verdict, decode_ok), stages[0], stages[1],
            _stream(dev))
    launch_error("bls_pairing", err)
    pairing_cuda.launches += 1
    return verdict, decode_ok


pairing_cuda.launches = 0


def pairing(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(pairing_cuda, pairing_plain, arrays[0], *arrays)


def pairing_cost(g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i, g2v, decode_ok):
    """The (M, S, O) that one pairing launch's function needs, from its packed
    inputs (numpy; each pair's key written out, expand_keys) and its
    decode_ok [B]: each distinct valid finite G1 and G2 point decompressed
    once; the lines of each distinct G2 point of a live pair (its doubling
    and addition steps); in each job that decoded with a live pair, one
    Miller accumulator (its squarings past the first, of one), each live
    pair's lines evaluated and multiplied in, and one final
    exponentiation."""
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
    pairing_collect.

    A job batch that clears the mesh gate (ops/mesh.py) is padded to the
    mesh's padded size with all-infinity jobs (neutral) and split over the
    mesh's devices; each shard packs its own distinct keys, so its lines
    launch computes the lines of its own keys, and the verdicts are
    gathered onto `device` and cut to B."""
    dev = resolve_device(device)
    B = len(jobs)
    P = max(1, max((len(j) for j in jobs), default=1))
    from plenum_tpu_torch.ops import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    sharded = m.should_shard(B, dev)
    Bp = m.padded_size(B, min_per_device=1) if sharded else B
    _tmy.get_seam_hub().record_launch(
        _tmy.SEAM_BLS_PAIR, sum(len(j) for j in jobs), Bp * P, shape=(Bp, P))
    if sharded:
        raw = _pair_raw(list(jobs) + [[]] * (Bp - B), Bp, P)
        outs = m.dispatch(
            pairing, raw, n=B, label="pairing_dispatch",
            place=lambda shard, d: upload(_pack_pair_raw(*shard), d))
        return tuple(t[:B] for t in m.gather(outs, dev))
    m.note_passthrough(B)
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


def msm_window(N: int) -> int:
    """The bucket method's window width for N scalars: the c that
    msm_cost picks when every window of every scalar is nonzero."""
    best, best_c = None, 1
    for c in range(1, 17):
        W = -(-255 // c)
        cost = int32_ops(N * W * COST["g1_madd"]
                         + W * (2 ** (c + 1) - 4) * COST["g1_add"]
                         + (W - 1) * (c * COST["g1_dbl"] + COST["g1_add"]))
        if best is None or cost < best:
            best, best_c = cost, c
    return best_c


def _check_msm_args(x, s, i, v, index, digits, D, N):
    _check(x, (D, NLIMB), torch.int32, x=x)
    _check(x, (D,), torch.uint8, sign_big=s, is_inf=i, valid=v)
    _check(x, (N,), torch.int32, index=index)
    _check(x, (N, MSM_DIGITS), torch.int32, digits=digits)


def msm_plain(x, sign_big, is_inf, valid, index, digits):
    """The MSM kernel's function with the port's host arithmetic: D
    distinct points ([D, 32] limbs, [D] flags), the [N] index of each
    scalar's point among them, [N, 64] digits → (X, Y, Z [32] int32
    normalized, ok bool scalar tensor): Σ sᵢ·P_index[i] by g1_decompress,
    g1_mul and g1_add over the finite points; a point that is not a valid
    encoding or not on the curve gives ok False and the identity."""
    from plenum_tpu_torch.crypto import bls_ops
    D, N = int(x.shape[0]), int(index.shape[0])
    _check_msm_args(x, sign_big, is_inf, valid, index, digits, D, N)
    xs, sg, inf, val, idx, dig = (t.cpu().numpy() for t in
                                  (x, sign_big, is_inf, valid, index, digits))
    if ((idx < 0) | (idx >= D)).any():
        raise ValueError("index holds a point outside [0, {})".format(D))
    points, ok = {}, True
    for d in range(D):
        if not val[d]:
            ok = False
        elif not inf[d]:
            try:
                points[d] = bls_ops.g1_decompress(g1_bytes(xs[d], sg[d]))
            except ValueError:
                ok = False
    agg = None
    for k in range(N):
        if ok and idx[k] in points:
            agg = bls_ops.g1_add(agg, bls_ops.g1_mul(
                points[idx[k]], _digits_to_int(dig[k])))
    X, Y, Z = (torch.from_numpy(a[0]).to(x.device)
               for a in store_points([agg if ok else None]))
    return X, Y, Z, torch.tensor(ok, device=x.device)


def msm_cuda(x, sign_big, is_inf, valid, index, digits):
    """The CUDA kernels (csrc/bls381_msm.cu, bls_g1_msm: each distinct point
    decompressed and each scalar cut into windows of msm_window(N) bits,
    the buckets by mixed additions, the windows' bucket sums in segments,
    then one block over the segments and windows) on CUDA tensors, the
    function of msm_plain. Counts each call in `msm_cuda.launches`; reads
    nothing back."""
    D, N = int(x.shape[0]), int(index.shape[0])
    _check_msm_args(x, sign_big, is_inf, valid, index, digits, D, N)
    _need_cuda(x, "msm_cuda")
    dev = x.device
    X, Y, Z = (torch.empty((NLIMB,), dtype=torch.int32, device=dev)
               for _ in range(3))
    ok = torch.empty((), dtype=torch.bool, device=dev)
    if N == 0 or D == 0:
        X.zero_(), Z.zero_(), Y.zero_()
        Y[0] = 1
        return X, Y, Z, ok.fill_(True)
    lib = library("bls381_msm")
    c = msm_window(N)
    scratch = torch.empty((lib.bls_msm_scratch_bytes(N, D, c),),
                          dtype=torch.uint8, device=dev)
    scratch[:16].zero_()                 # the undecodable-point flag
    with torch.cuda.device(dev):
        err = lib.bls_g1_msm(*_ptrs(x, sign_big, is_inf, valid), D,
                             *_ptrs(index, digits), N, c,
                             *_ptrs(scratch, X, Y, Z, ok), _stream(dev))
    launch_error("bls_g1_msm", err)
    msm_cuda.launches += 1
    return X, Y, Z, ok


msm_cuda.launches = 0


def msm(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(msm_cuda, msm_plain, arrays[0], *arrays)


def msm_cost(x, sign_big, is_inf, valid, digits, ok, Z):
    """The (M, S, O) that one MSM call's function needs, from its packed
    inputs (a point row for each scalar: expand_points) and its outputs ok
    and Z [32] (numpy): each distinct valid finite point decompressed
    once, then the bucket method at the window width c that needs least:
    in each of the ceil(255 / c) windows a mixed addition for each finite
    point whose digit there is not zero, the running sum of the 2^c - 1
    buckets (2^(c+1) - 4 additions), and between windows c doublings and
    an addition; the result normalized."""
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
        + best + store_cost(store, G1_STORE)


def expand_points(x, sign_big, is_inf, valid, index, digits):
    """The MSM's packed arrays (numpy) with each scalar's point written
    out: (x, sign_big, is_inf, valid, digits), [N] rows, as msm_cost
    counts from."""
    k = np.asarray(index)
    return tuple(np.asarray(a)[k] for a in (x, sign_big, is_inf, valid)) \
        + (digits,)


def pack_msm(points: Sequence[bytes], scalars: Sequence[int]):
    """N compressed G1 points and N scalars → the MSM kernel's six numpy
    arrays: the D distinct points' limbs [D, 32] and flags [D], the index
    [N] of each scalar's point, the digits [N, 64]."""
    raw = np.frombuffer(b"".join(points), dtype=np.uint8).reshape(-1,
                                                                  G1_BYTES)
    distinct, index = distinct_rows(raw)
    return tuple(pack_compressed(distinct)) + (
        index, scalar_digits(scalars, len(points)))


def msm_dispatch(points: Sequence[bytes], scalars: Sequence[int],
                 device=None):
    """Enqueue Σ sᵢ·Pᵢ over compressed G1 points on `device` (None means
    CUDA), exactly N points; nothing read back."""
    dev = resolve_device(device)
    N = len(points)
    _tmy.get_seam_hub().record_launch(_tmy.SEAM_BLS_MSM, N, N, shape=(N,))
    # the sum crosses the point axis: this seam never shards
    from plenum_tpu_torch.ops import mesh as mesh_mod
    mesh_mod.get_mesh().note_passthrough(N)
    return msm(*upload(pack_msm(points, scalars), dev))


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

def _check_g2agg_args(c1, c0, s, i, v, index, D, B, n):
    _check(c1, (D, NLIMB), torch.int32, c1=c1, c0=c0)
    _check(c1, (D,), torch.uint8, sign_big=s, is_inf=i, valid=v)
    _check(c1, (B, n), torch.int32, index=index)


def g2_aggregate_plain(c1, c0, sign_big, is_inf, valid, index):
    """The G2 aggregate kernel's function with the port's host arithmetic:
    D distinct packed points ([D, 32] c1 and c0 limbs, [D] flags) and the
    [B, n] index of each job's points among them → (X, Y, Z [B, 2, 32]
    int32, c0 then c1, normalized; ok [B] bool): each distinct point
    decompressed once (g2_decompress), each job the sum of its finite
    points (g2_add), or the identity with ok False when a point is not a
    valid encoding or not on the curve, or an index lies outside [0, D)."""
    from plenum_tpu_torch.crypto import bls_ops
    D, (B, n) = int(c1.shape[0]), tuple(index.shape)
    _check_g2agg_args(c1, c0, sign_big, is_inf, valid, index, D, B, n)
    idx = index.cpu().numpy()
    a1, a0, sg = (t.cpu().numpy() for t in (c1, c0, sign_big))
    table = decompressed_table(
        valid.cpu().numpy(), is_inf.cpu().numpy(),
        lambda d: bls_ops.g2_decompress(g2_bytes(a1[d], a0[d], sg[d])))
    points, ok = job_sums(table, idx, bls_ops.g2_add)
    out = np.zeros((3, B, 2, NLIMB), dtype=np.int32)
    for b, agg in enumerate(points):
        if agg is None:
            coords = ((0, 0), (1, 0), (0, 0))
        else:
            coords = ((agg[0].c0, agg[0].c1), (agg[1].c0, agg[1].c1), (1, 0))
        for k, (v0, v1) in enumerate(coords):
            out[k, b] = _ints_to_limbs([v0, v1])
    X, Y, Z = (torch.from_numpy(out[k]).to(c1.device) for k in range(3))
    return X, Y, Z, torch.from_numpy(ok).to(c1.device)


def g2_aggregate_scratch(B: int, D: int, device) -> torch.Tensor:
    """The device scratch of a G2 aggregate launch (as
    bls381.g1_aggregate_scratch)."""
    return torch.empty((library("bls381_agg").bls_g2_aggregate_scratch_bytes(
        B, D),), dtype=torch.uint8, device=device)


def g2_aggregate_cuda(c1, c0, sign_big, is_inf, valid, index, scratch=None,
                      stages=(0, 2)):
    """The CUDA kernels (csrc/bls381_agg.cu, bls_g2_aggregate: each
    distinct key decompressed once on a pair of lanes, each job summed on
    sextets of trios, each sum normalized by one inversion) on CUDA
    tensors, the function of g2_aggregate_plain. Counts each call in
    `g2_aggregate_cuda.launches`; reads nothing back. `scratch` and
    `stages` as bls381.g1_aggregate_cuda takes them."""
    D, (B, n) = int(c1.shape[0]), tuple(index.shape)
    _check_g2agg_args(c1, c0, sign_big, is_inf, valid, index, D, B, n)
    _need_cuda(c1, "g2_aggregate_cuda")
    first, last = agg_stages_arg(stages)
    dev = c1.device
    X, Y, Z = (torch.empty((B, 2, NLIMB), dtype=torch.int32, device=dev)
               for _ in range(3))
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return X, Y, Z, ok
    if scratch is None:
        scratch = g2_aggregate_scratch(B, D, dev)
    fn = library("bls381_agg").bls_g2_aggregate
    with torch.cuda.device(dev):
        err = fn(*_ptrs(c1, c0, sign_big, is_inf, valid), D,
                 index.data_ptr(), B, n, *_ptrs(scratch, X, Y, Z, ok), first,
                 last, _stream(dev))
    launch_error("bls_g2_aggregate", err)
    g2_aggregate_cuda.launches += 1
    return X, Y, Z, ok


g2_aggregate_cuda.launches = 0


def g2_aggregate(*arrays):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return _route(g2_aggregate_cuda, g2_aggregate_plain, arrays[0], *arrays)


def pack_g2_jobs(jobs: Sequence[Sequence[bytes]], n: int):
    """B jobs of at most n compressed G2 points → the G2 kernel's six
    numpy arrays: the D distinct encodings' c1 and c0 limbs [D, 32] and
    flags [D], and the [B, n] index of each job's points among them; short
    jobs padded with the infinity encoding."""
    B = len(jobs)
    distinct, index = distinct_rows(raw_points(jobs, n, G2_BYTES).reshape(
        B * n, G2_BYTES))
    return tuple(pack_g2_compressed(distinct)) + (index.reshape(B, n),)


def g2_aggregate_cost(c1, c0, sign_big, is_inf, valid, index, ok, Z):
    """The (M, S, O) that one G2 aggregate launch's function needs, as
    bls381.g1_aggregate_cost counts them over fp2 (Z [B, 2, 32])."""
    finite = np.asarray(valid, bool) & ~np.asarray(is_inf, bool)
    ok = np.asarray(ok, bool)
    per_job = finite[np.asarray(index)].sum(axis=1)
    stores = int((ok & np.asarray(Z).reshape(len(ok), -1).any(axis=-1))
                 .sum())
    return distinct_points(c1, c0, sign_big, finite=finite) \
        * COST["g2_decompress"] \
        + int(np.maximum(per_job[ok] - 1, 0).sum()) * COST["g2_madd"] \
        + store_cost(stores, G2_STORE)


def g2_aggregate_dispatch(jobs: Sequence[Sequence[bytes]], n: int,
                          device=None):
    """Enqueue B sets of at most n compressed G2 points (public keys) on
    `device` (None means CUDA); nothing read back."""
    dev = resolve_device(device)
    B = len(jobs)
    _tmy.get_seam_hub().record_launch(
        _tmy.SEAM_BLS, sum(len(j) for j in jobs), B * n, shape=(B, n))
    # never sharded, as in the JAX package: counted as a passthrough
    from plenum_tpu_torch.ops import mesh as mesh_mod
    mesh_mod.get_mesh().note_passthrough(B)
    return g2_aggregate(*upload(pack_g2_jobs(jobs, n), dev))


def g2_aggregate_collect(handles):
    """The one read-back of a g2_aggregate_dispatch → (points, valid):
    points[i] = affine ((x.c0, x.c1), (y.c0, y.c1)) ints, or None for the
    identity or a job with an undecodable point. The results come
    normalized: (x, y) is read as it is."""
    X, Y, Z, ok = (h.cpu().numpy() for h in handles)
    out: List[Optional[Tuple[Tuple[int, int], Tuple[int, int]]]] = []
    for i in range(len(ok)):
        x0, x1 = (int(v) for v in _limbs_to_ints(X[i]))
        y0, y1 = (int(v) for v in _limbs_to_ints(Y[i]))
        z0, z1 = (int(v) for v in _limbs_to_ints(Z[i]))
        if z1 or z0 not in (0, 1):
            raise ValueError("a normalized G2 point has Z 0 or 1, not "
                             "({}, {})".format(z0, z1))
        out.append(((x0, x1), (y0, y1)) if ok[i] and z0 else None)
    return out, ok.astype(bool)
