"""The BLS12-381 device family of the port (plenum_tpu_torch/ops/bls381.py,
ops/bls381_pairing.py, csrc/bls381.cu) against the JAX package's on the
CPU, on seeded inputs: the packing of compressed G1 and G2 points against
pack_compressed / pack_g2_compressed on valid, out-of-range, bad-flag and
infinity encodings; the pairing kernel's plain version against the JAX
package's pairing_job_host on the adversarial job set of
tests/test_bls381_pairing.py; the G1 and G2 aggregates and the MSM against
the JAX package's host sums; and the host build of bls381.cu (g++ behind
cuda_host_shim.h) against the plain versions, its Montgomery multiplies
and squarings against the kernels' schedule built from the pieces that the
bounds count; the bounds' own counts of the function on shapes whose
least work is known. The JAX package's XLA kernels are not
called (a warm launch is ~17 s on one core). Tolerance: none, verdicts
and points are exact."""
import hashlib
import json
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from plenum_tpu.crypto import bls12_381 as JB
from plenum_tpu.crypto import bls_ops as jops
from plenum_tpu.ops import bls381_jax as jagg
from plenum_tpu.ops import bls381_tower as jtower
from plenum_tpu_torch.crypto import bls12_381 as B
from plenum_tpu_torch.crypto import bls_ops
from plenum_tpu_torch.ops import bls381, bls381_pairing as bp, cuda_lib

CPU = torch.device("cpu")
# inputs are made with the port's native scalar multiplies (the same bytes
# as the JAX package's pure-Python ones, tests/test_torch_bls.py), the
# references are the JAX package's
G1_INF, G2_INF = bls381.G1_INF, bls381.G2_INF
HOST_FLAGS = ["-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing",
              "-Wno-unknown-pragmas"]


def _good_pair_job(sk=7, msg=b"m"):
    pk = bls_ops.g2_mul(JB.G2_GEN, sk)
    h = JB.hash_to_g1(msg)
    sig = bls_ops.g1_mul(h, sk)
    return [(JB.g1_compress(sig), JB.g2_compress(JB.g2_neg(JB.G2_GEN))),
            (JB.g1_compress(h), JB.g2_compress(pk))]


def _non_subgroup_g1():
    x = 3
    while True:
        yy = (x * x * x + 4) % JB.Q
        y = pow(yy, (JB.Q + 1) // 4, JB.Q)
        if y * y % JB.Q == yy and not JB.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def _adversarial_jobs():
    """tests/test_bls381_pairing.py's job set, with ragged and three-pair
    jobs, undecodable bytes and the G2 side flipped as well."""
    rng = random.Random(17)
    good = _good_pair_job(sk=rng.randrange(2, JB.R))
    flip = bytearray(good[0][0])
    flip[19] ^= 0x10
    g2flip = bytearray(good[1][1])
    g2flip[30] ^= 0x04
    ns = _non_subgroup_g1()
    cp = bls_ops.g1_mul(JB.G1_GEN, 5)
    cancel = [(JB.g1_compress(cp), JB.g2_compress(JB.G2_GEN)),
              (JB.g1_compress(JB.g1_neg(cp)), JB.g2_compress(JB.G2_GEN))]
    return [
        good,                                            # True
        [good[0], _good_pair_job(msg=b"z")[1]],          # wrong message
        [(bytes(flip), good[0][1]), good[1]],            # bit-flipped G1
        [good[0], (good[1][0], bytes(g2flip))],          # bit-flipped G2
        [(G1_INF, JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, 5)))],  # one-sided
        [(JB.g1_compress(JB.G1_GEN), G2_INF)],           # one-sided
        cancel,                                          # e(P,Q)e(-P,Q)=1
        [(JB.g1_compress(ns), JB.g2_compress(JB.G2_GEN))],    # non-subgroup
        [good[1], (G1_INF, G2_INF)],                     # neutral + != 1
        [(G1_INF, G2_INF), (G1_INF, G2_INF)],            # all neutral
        good + [(G1_INF, G2_INF)],                       # three pairs
        [(b"\x00" * 48, JB.g2_compress(JB.G2_GEN))],     # undecodable
    ]


# ---------------------------------------------------------------- packing

def _g1_encodings():
    rng = random.Random(3)
    valid = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
             for _ in range(6)]
    q = bytearray(JB.Q.to_bytes(48, "big"))
    q[0] |= 0x80
    qm1 = bytearray((JB.Q - 1).to_bytes(48, "big"))
    qm1[0] |= 0xA0
    big = bytearray(b"\xff" * 48)
    big[0] = 0x9F
    return {
        "valid": valid,
        "out_of_range": [bytes(q), bytes(big), bytes(qm1)],
        "bad_flags": [bytes([v[0] & 0x7F]) + v[1:] for v in valid[:2]]
        + [bytes([0xE0]) + bytes(47), bytes([0xC0]) + b"\x01" + bytes(46),
           bytes(48)],
        "infinity": [G1_INF, G1_INF],
    }


def _g2_encodings():
    rng = random.Random(4)
    valid = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN,
                                           rng.randrange(1, 1 << 64)))
             for _ in range(4)]
    q = JB.Q.to_bytes(48, "big")
    hi = bytearray(q + bytes(48))
    hi[0] |= 0x80
    lo = bytearray(bytes(47) + b"\x01" + q)
    lo[0] |= 0x80
    return {
        "valid": valid,
        "out_of_range": [bytes(hi), bytes(lo)],
        "bad_flags": [bytes([valid[0][0] & 0x7F]) + valid[0][1:],
                      bytes([0xE0]) + bytes(95),
                      bytes([0xC0]) + bytes(94) + b"\x01"],
        "infinity": [G2_INF],
    }


@pytest.mark.parametrize("kind", ["valid", "out_of_range", "bad_flags",
                                  "infinity"])
def test_pack_compressed_equals_the_jax_packages(kind):
    raw = np.frombuffer(b"".join(_g1_encodings()[kind]),
                        dtype=np.uint8).reshape(-1, 48)
    got, want = bls381.pack_compressed(raw), jagg.pack_compressed(raw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3].all() == (kind in ("valid", "infinity"))


@pytest.mark.parametrize("kind", ["valid", "out_of_range", "bad_flags",
                                  "infinity"])
def test_pack_g2_compressed_equals_the_jax_packages(kind):
    raw = np.frombuffer(b"".join(_g2_encodings()[kind]),
                        dtype=np.uint8).reshape(-1, 96)
    got, want = bls381.pack_g2_compressed(raw), \
        jtower.pack_g2_compressed(raw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[4].all() == (kind in ("valid", "infinity"))


# ------------------------------------------------------- plain versions

def test_plain_pairing_equals_the_jax_packages_pairing_job_host():
    jobs = _adversarial_jobs()
    want = [jops.pairing_job_host(j) for j in jobs]
    assert want == [True, False, False, False, False, False, True, False,
                    False, True, True, False]
    verdict, decode_ok = bp.pairing_jobs(jobs, "cpu")
    assert verdict.tolist() == want
    assert decode_ok.tolist() == [_decodes(j) for j in jobs]
    assert decode_ok.tolist()[2] is False and decode_ok.tolist()[4] is False


def _decodes(job):
    """Every pair decodes with the JAX package's host decompression, and
    no pair has one point at infinity."""
    try:
        return all((JB.g1_decompress(a) is None)
                   == (JB.g2_decompress(b) is None) for a, b in job)
    except ValueError:
        return False


def test_g1_aggregate_equals_the_jax_packages_host_sum():
    rng = random.Random(5)
    shares = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
              for _ in range(9)]
    jobs = [shares[:4], shares[4:], [shares[0], G1_INF], [G1_INF], [],
            [shares[1], JB.g1_compress(JB.g1_neg(JB.g1_decompress(
                shares[1])))],
            [shares[2], b"\x00" * 48]]
    points, ok = bls381.aggregate_g1_jobs(jobs, device="cpu")
    assert ok.tolist() == [True] * 6 + [False]
    for job, point, good in zip(jobs, points, ok):
        if good:
            assert point == jops.g1_aggregate_compressed(job)
        else:
            with pytest.raises(ValueError):
                jops.g1_aggregate_compressed(job)
            assert point is None


def test_g2_aggregate_equals_the_jax_packages_g2_add():
    keys = [bls_ops.g2_mul(JB.G2_GEN, k) for k in (3, 5, 9, 11, 13)]
    sets = [[JB.g2_compress(k) for k in keys[:2]],
            [JB.g2_compress(keys[2]), G2_INF],
            [JB.g2_compress(k) for k in keys],
            [JB.g2_compress(keys[0]), JB.g2_compress(JB.g2_neg(keys[0]))],
            [b"\x80" + bytes(95)]]
    pts, ok = bp.g2_aggregate_collect(bp.g2_aggregate_dispatch(sets, 5,
                                                               "cpu"))
    assert ok.tolist() == [True, True, True, True, False]
    for s, got in zip(sets[:4], pts):
        want = None
        for raw in s:
            want = JB.g2_add(want, JB.g2_decompress(raw))
        assert got == (None if want is None else
                       ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1)))
    assert pts[4] is None


def test_msm_equals_the_jax_packages_host_path():
    """Seven points, below the JAX package's BLS_MSM_DEVICE_MIN (8), so
    its g1_msm takes the host double-and-add; the port's runs the MSM
    kernel's plain version (device pairing on, minimum 2, on the CPU)."""
    rng = random.Random(23)
    ks = [rng.randrange(1, JB.R) for _ in range(6)]
    pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, k)) for k in ks] + [G1_INF]
    ss = [rng.randrange(1, JB.R) for _ in range(6)] + [12345]
    got = bls_ops.g1_msm(pts, ss, device_pairing=True, device_min=2,
                         device="cpu")
    assert got == jops.g1_msm(pts, ss) == JB.g1_mul(
        JB.G1_GEN, sum(k * s for k, s in zip(ks, ss)) % JB.R)
    zero = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, 9))] * 2
    assert bls_ops.g1_msm(zero, [JB.R, 0], device_pairing=True,
                          device_min=2, device="cpu") is None
    with pytest.raises(ValueError):
        bls_ops.g1_msm([b"\x00" * 48] * 2, [1, 2], device_pairing=True,
                       device_min=2, device="cpu")


def _g2_sign_points():
    """Compressed G2 points whose y has c1 above (q-1)/2 and c0 below, and
    the reverse, each with both sign flags (the point and its negation)."""
    half = (JB.Q - 1) // 2
    out, kinds = [], set()
    k = 2
    while len(kinds) < 2:
        p = bls_ops.g2_mul(JB.G2_GEN, k)
        k += 1
        kind = (p[1].c1 > half, p[1].c0 > half)
        if kind in ((True, False), (False, True)) and kind not in kinds:
            kinds.add(kind)
            out += [JB.g2_compress(p), JB.g2_compress(JB.g2_neg(p))]
    return out


def test_g2_decompression_keeps_the_sign_rule():
    raws = _g2_sign_points()
    assert len({r[0] & 0x20 for r in raws}) == 2
    pts, ok = bp.g2_aggregate_collect(bp.g2_aggregate_dispatch(
        [[r] for r in raws], 1, "cpu"))
    assert ok.all()
    for raw, got in zip(raws, pts):
        want = JB.g2_decompress(raw)
        assert got == ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1))
        assert B.g2_compress(B.g2_decompress(raw)) == raw


# --------------------------------------------- the host build of bls381.cu

@pytest.fixture(scope="session")
def bls381_host():
    """csrc/bls381_host.cpp (bls381.cu's C entries behind
    cuda_host_shim.h) built by g++ once, into plenum_tpu_torch/_build/
    under a hash of its sources and flags. → the executable."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    src = os.path.join(cuda_lib.CSRC, "bls381_host.cpp")
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    cuda_lib._hash_source(h, src)
    exe = os.path.join(cuda_lib.BUILD_DIR, "bls381_host-" + h.hexdigest()[:16])
    if not os.path.exists(exe):
        os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
        tmp = "{}.{}.tmp".format(exe, os.getpid())
        subprocess.run([gxx] + HOST_FLAGS + ["-o", tmp, src], check=True)
        os.replace(tmp, exe)
    return exe


def _run_host(exe, tmp_path, mode, header, arrays):
    """Run one entry of the host build → (its output bytes, the (M, S)
    it made: multiplies that are not squarings, squarings)."""
    with open(tmp_path / "in", "wb") as f:
        f.write(np.asarray(header, dtype=np.int32).tobytes())
        for a in arrays:
            f.write(np.ascontiguousarray(
                a.astype(np.uint8) if a.dtype == bool else a).tobytes())
    proc = subprocess.run([exe, mode, str(tmp_path / "in"),
                           str(tmp_path / "out")], check=True,
                          capture_output=True, text=True)
    counts = json.loads(proc.stdout)
    muls = np.array([counts["fp_muls"] - counts["fp_sqrs"],
                     counts["fp_sqrs"]])
    return (tmp_path / "out").read_bytes(), muls


def _split(raw, shapes):
    out, at = [], 0
    for dtype, shape in shapes:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out.append(np.frombuffer(raw[at:at + n], dtype=dtype).reshape(shape))
        at += n
    assert at == len(raw)
    return out


# The kernels' own schedule (csrc/bls381.cu) from the bounds' pieces:
# complete additions with their two multiplies by 3b, the aggregates' tree
# padded to the 128-thread block, the MSM's w = 4 table and Horner walk per
# point over 64-point blocks, a Miller loop and both decompressions per
# pair, an inversion per stored result.
AGG_THREADS, MSM_THREADS = 128, 64
C = bls381.COST
K_G1_ADD, K_G2_ADD = 14 * bls381.M, 14 * bls381.M2
K_G1_STORE = bls381.FP_INV + 4 * bls381.M
K_G2_STORE = bls381.FP2_INV + 2 * bls381.M2 + 4 * bls381.M
K_MILLER = 63 * (C["fp12_sqr"] + C["miller_dbl"] + C["line"]) \
    + 5 * (C["miller_add"] + C["line"])


def _finite(is_inf, valid):
    return np.asarray(valid, bool) & ~np.asarray(is_inf, bool)


def _kernel_pairing(g1i, g1v, g2i, g2v, decode_ok):
    g1f, g2f = _finite(g1i, g1v), _finite(g2i, g2v)
    live = (g1f & g2f).sum(axis=1)
    jobs = np.asarray(decode_ok, bool) & (live > 0)
    return int(g1f.sum()) * C["g1_decompress"] \
        + int(g2f.sum()) * C["g2_decompress"] + int(live.sum()) * K_MILLER \
        + int(jobs.sum()) * C["final_exp"] \
        + int((live[jobs] - 1).sum()) * C["fp12_mul"]


def _kernel_aggregate(is_inf, valid, stores, dec, add, store):
    return int(_finite(is_inf, valid).sum()) * (dec + add) \
        + valid.shape[0] * (AGG_THREADS - 1) * add + stores * store


def _kernel_msm(is_inf, valid, store):
    blocks = -(-valid.shape[0] // MSM_THREADS)
    return int(_finite(is_inf, valid).sum()) \
        * (C["g1_decompress"] + (14 + 64 * 5) * K_G1_ADD) \
        + (blocks * MSM_THREADS + MSM_THREADS - 1) * K_G1_ADD \
        + store * K_G1_STORE


def test_host_build_pairing_equals_the_plain_version(bls381_host, tmp_path):
    jobs = _adversarial_jobs()
    Bj, P = len(jobs), 3
    arrays = bp._pack_pair_arrays(jobs, Bj, P)
    raw, muls = _run_host(bls381_host, tmp_path, "pairing", [Bj, P], arrays)
    verdict, decode_ok = _split(raw, [(np.uint8, (Bj,)), (np.uint8, (Bj,))])
    want_v, want_ok = bp.pairing_plain(*bls381.upload(arrays, CPU))
    assert verdict.astype(bool).tolist() == want_v.tolist()
    assert decode_ok.astype(bool).tolist() == want_ok.tolist()
    ok = decode_ok.astype(bool)
    assert np.array_equal(muls, _kernel_pairing(arrays[2], arrays[3],
                                                arrays[7], arrays[8], ok))
    need = bp.pairing_cost(*arrays, ok)
    assert (need > 0).all() and bls381.int32_ops(need) \
        < bls381.int32_ops(muls)


def _aggregate_jobs(rng, n):
    shares = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
              for _ in range(n)]
    return [shares, shares[:3], [G1_INF] * 2, [shares[0], b"\x00" * 48],
            [shares[1], JB.g1_compress(JB.g1_neg(JB.g1_decompress(
                shares[1])))]]


@pytest.mark.parametrize("n", [5, 130])     # one share a thread; past 128
def test_host_build_g1_aggregate_equals_the_plain_version(bls381_host,
                                                         tmp_path, n):
    jobs = _aggregate_jobs(random.Random(n), n)
    arrays = bls381.pack_g1_jobs(jobs, n)
    raw, muls = _run_host(bls381_host, tmp_path, "g1agg", [len(jobs), n],
                          arrays)
    L = bls381.NLIMB
    X, Y, Z, ok = _split(raw, [(np.int32, (len(jobs), L))] * 3
                         + [(np.uint8, (len(jobs),))])
    want = bls381.g1_aggregate_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert ok.tolist() == [1, 1, 1, 0, 1]
    stores = int((ok.astype(bool) & Z.any(axis=-1)).sum())
    assert np.array_equal(muls, _kernel_aggregate(
        arrays[2], arrays[3], stores, C["g1_decompress"], K_G1_ADD,
        K_G1_STORE))
    need = bls381.g1_aggregate_cost(*arrays, ok.astype(bool), Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)


def test_host_build_g2_aggregate_equals_the_plain_version(bls381_host,
                                                         tmp_path):
    keys = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, k)) for k in (3, 5, 9)]
    sets = [keys, [keys[0], G2_INF], [b"\x80" + bytes(95)],
            _g2_sign_points()]
    n = 4
    arrays = bp.pack_g2_jobs(sets, n)
    raw, muls = _run_host(bls381_host, tmp_path, "g2agg", [len(sets), n],
                          arrays)
    shape = (len(sets), 2, bls381.NLIMB)
    X, Y, Z, ok = _split(raw, [(np.int32, shape)] * 3
                         + [(np.uint8, (len(sets),))])
    want = bp.g2_aggregate_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert ok.tolist() == [1, 1, 0, 1]
    stores = int((ok.astype(bool) & Z.reshape(len(ok), -1).any(axis=-1))
                 .sum())
    assert np.array_equal(muls, _kernel_aggregate(
        arrays[3], arrays[4], stores, C["g2_decompress"], K_G2_ADD,
        K_G2_STORE))
    need = bp.g2_aggregate_cost(*arrays, ok.astype(bool), Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)


@pytest.mark.parametrize("n", [8, 70])      # one block; two and a tail
def test_host_build_msm_equals_the_plain_version(bls381_host, tmp_path, n):
    rng = random.Random(n)
    pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
           for _ in range(n - 1)] + [G1_INF]
    ss = [rng.randrange(0, 1 << 256) for _ in range(n)]
    raw_pts = np.frombuffer(b"".join(pts), dtype=np.uint8).reshape(-1, 48)
    arrays = list(bls381.pack_compressed(raw_pts)) + [bp.scalar_digits(ss)]
    raw, muls = _run_host(bls381_host, tmp_path, "msm", [n, 0], arrays)
    L = bls381.NLIMB
    X, Y, Z, ok = _split(raw, [(np.int32, (L,))] * 3 + [(np.uint8, ())])
    want = bp.msm_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert np.array_equal(muls, _kernel_msm(arrays[2], arrays[3],
                                            int(bool(ok) and Z.any())))
    need = bp.msm_cost(*arrays, bool(ok), Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)
    xy = [bls381.limbs_to_int(a) for a in (X, Y, Z)]
    assert bls381._proj_to_affine(*xy) == jops.g1_msm(pts[:7], ss[:7]) \
        if n == 8 else True


# ------------------------------------------------ the bounds' own counts

def test_pairing_bound_counts_shared_g2_points_and_accumulators_once():
    """Four two-pair verify jobs against one key: two distinct G2 points
    (-G2 and the key), so two G2 decompressions and two sets of Miller
    lines; one accumulator and one final exponentiation a job; a job that
    does not decode needs only its decompressions."""
    rng = random.Random(41)
    sk = rng.randrange(2, JB.R)
    jobs = [_good_pair_job(sk=sk, msg=b"root-%d" % i) for i in range(4)]
    bad = [(b"\x00" * 48, jobs[0][0][1]), jobs[0][1]]
    arrays = bp._pack_pair_arrays(jobs + [bad], 5, 2)
    ok = np.array([True] * 4 + [False])
    lines = 63 * C["miller_dbl"] + 5 * C["miller_add"]
    want = 8 * C["g1_decompress"] + 2 * C["g2_decompress"] + 2 * lines \
        + 8 * 68 * C["line"] + 4 * (62 * C["fp12_sqr"] + C["final_exp"])
    assert np.array_equal(bp.pairing_cost(*arrays, ok), want)
    assert bls381.int32_ops(want) == int(np.dot(want, [588, 456]))


def test_aggregate_bounds_decompress_each_share_once_and_add_n_minus_1():
    rng = random.Random(43)
    shares = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
              for _ in range(5)]
    jobs = [shares, shares, shares[:2] + [G1_INF], [shares[0], b"\x00" * 48]]
    arrays = bls381.pack_g1_jobs(jobs, 5)
    X, Y, Z, ok = (t.numpy() for t in bls381.g1_aggregate_plain(
        *bls381.upload(arrays, CPU)))
    assert ok.tolist() == [True, True, True, False]
    want = 5 * C["g1_decompress"] + (4 + 4 + 1) * C["g1_madd"] \
        + bls381.FP_INV + 3 * 2 * bls381.M + 3 * 4 * bls381.M
    assert np.array_equal(bls381.g1_aggregate_cost(*arrays, ok, Z), want)
    keys = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, k)) for k in (3, 5, 7)]
    g2 = bp.pack_g2_jobs([keys[:1], keys, keys[:2]], 3)
    X, Y, Z, ok = (t.numpy() for t in bp.g2_aggregate_plain(
        *bls381.upload(g2, CPU)))
    want = 3 * C["g2_decompress"] + (0 + 2 + 1) * C["g2_madd"] \
        + bls381.FP2_INV + 2 * 3 * bls381.M2 \
        + 3 * (2 * bls381.M2 + 4 * bls381.M)
    assert np.array_equal(bp.g2_aggregate_cost(*g2, ok, Z), want)


def test_msm_bound_takes_the_bucket_methods_best_window():
    """The bound's bucket count, from the packed digits, against the same
    count made from the scalars as integers, at the window that needs
    least."""
    rng = random.Random(47)
    n = 96
    pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
           for _ in range(6)]
    pts = [pts[i % 6] for i in range(n)]
    ss = [rng.randrange(JB.R) for _ in range(n - 1)] + [0]
    raw = np.frombuffer(b"".join(pts), dtype=np.uint8).reshape(-1, 48)
    arrays = list(bls381.pack_compressed(raw)) + [bp.scalar_digits(ss)]
    X, Y, Z, ok = (t.numpy() for t in bp.msm_plain(
        *bls381.upload(arrays, CPU)))
    best = None
    for c in range(1, 17):
        W = -(-255 // c)
        nonzero = sum(1 for s in ss for w in range(W)
                      if (s >> (w * c)) & ((1 << c) - 1))
        cost = nonzero * C["g1_madd"] + W * (2 ** (c + 1) - 4) * C["g1_add"] \
            + (W - 1) * (c * C["g1_dbl"] + C["g1_add"])
        if best is None or bls381.int32_ops(cost) < bls381.int32_ops(best):
            best, best_c = cost, c
    assert 4 <= best_c <= 8
    want = 6 * C["g1_decompress"] + best + bls381.FP_INV + 4 * bls381.M
    assert np.array_equal(bp.msm_cost(*arrays, bool(ok), Z), want)
