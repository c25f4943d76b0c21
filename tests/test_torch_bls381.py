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
bounds count, its fixed powers and its inversion by safegcd against
Python's pow; the bounds' own counts of the function on shapes whose
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
from plenum_tpu_torch import testing
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
    bad = b"\x00" * 48
    jobs = [shares[:4], shares[4:], [shares[0], G1_INF], [G1_INF], [],
            [shares[1], JB.g1_compress(JB.g1_neg(JB.g1_decompress(
                shares[1])))],
            [shares[2], bad],
            [shares[0], shares[3], shares[0]],   # repeated, within and across
            [bad, shares[5]]]                    # the bad share, shared
    points, ok = bls381.aggregate_g1_jobs(jobs, device="cpu")
    assert ok.tolist() == [True] * 6 + [False, True, False]
    for job, point, good in zip(jobs, points, ok):
        if good:
            assert point == jops.g1_aggregate_compressed(job)
        else:
            with pytest.raises(ValueError):
                jops.g1_aggregate_compressed(job)
            assert point is None


def test_g2_aggregate_equals_the_jax_packages_g2_add():
    keys = [bls_ops.g2_mul(JB.G2_GEN, k) for k in (3, 5, 9, 11, 13)]
    bad = b"\x80" + bytes(95)
    sets = [[JB.g2_compress(k) for k in keys[:2]],
            [JB.g2_compress(keys[2]), G2_INF],
            [JB.g2_compress(k) for k in keys],
            [JB.g2_compress(keys[0]), JB.g2_compress(JB.g2_neg(keys[0]))],
            [bad],
            [JB.g2_compress(k) for k in (keys[0], keys[1], keys[0])],
            [JB.g2_compress(keys[3]), bad]]
    pts, ok = bp.g2_aggregate_collect(bp.g2_aggregate_dispatch(sets, 5,
                                                               "cpu"))
    assert ok.tolist() == [True, True, True, True, False, True, False]
    for s, got, good in zip(sets, pts, ok):
        if not good:
            assert got is None
            continue
        want = None
        for raw in s:
            want = JB.g2_add(want, JB.g2_decompress(raw))
        assert got == (None if want is None else
                       ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1)))


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


def test_g2_decompression_keeps_the_sign_rule():
    raws = testing.g2_sign_points()
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
    """Run one entry of the host build (header: three int32) → (its output
    bytes, the (M, S, O) it made: multiplies that are not squarings,
    squarings, the inversions' 32-bit multiply-adds)."""
    header = list(header) + [0] * (3 - len(header))
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
                     counts["fp_sqrs"], counts["int_mads"]])
    return (tmp_path / "out").read_bytes(), muls


def _split(raw, shapes):
    out, at = [], 0
    for dtype, shape in shapes:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out.append(np.frombuffer(raw[at:at + n], dtype=dtype).reshape(shape))
        at += n
    assert at == len(raw)
    return out


# The kernels' own schedule (csrc/bls381*.cu) from the bounds' pieces: a G2
# key's decompression (Alg. 9 in fp2 on a trio) and lines once a launch, a
# G1 decompression a pair, one Miller accumulator a job (the host's fp12
# squaring, line and final exponentiation with Fermat's inversion, the
# inverse by the cubic norm: 13 multiplies above the host's 105); the
# aggregates' decompression once a distinct point (G2 on a pair of lanes:
# each lane the norm route's work), a sextet's mixed additions over its
# share of a job's points, the tree of the 20 (G1) or 8 (G2) sextets'
# sums by complete additions, a normalization by safegcd a stored result;
# the MSM's bucket method: mixed additions into the buckets, each window's
# buckets summed in segments (a running sum of complete additions), the
# segments and then the windows combined (a doubling's two squarings done
# as products there), Fermat's inversion for the result.
G1_SUM_GROUPS = bls381.AGG_SUM_GROUPS["g1"]
G2_SUM_GROUPS = bls381.AGG_SUM_GROUPS["g2"]
SAFEGCD_BATCH_MADS = 2 * (6 * 13 + 2) + 2 * 4 * 13
C = bls381.COST
M, S, M2, S2 = bls381.M, bls381.S, bls381.M2, bls381.S2
K_G2_ADD = C["g2_add"]
K_G1_STORE = bls381.FP_INV_FERMAT + 4 * M
K_G1_DBL = 8 * M         # the six-lane doubling: its squarings as products
K_LINES = 63 * C["miller_dbl"] + 5 * C["miller_add"]
K_MILLER_JOB = 62 * C["fp12_sqr"]
K_LINE = C["line"]
K_FINAL_EXP = C["final_exp"] - bls381.FP_INV + bls381.FP_INV_FERMAT + 13 * M
K_G2_DEC_ALG9 = 4 * M + 3 * S2 + 4 * M2 \
    + bls381.window_cost((JB.Q - 3) // 4, S2, M2, bls381.POW_WINDOW_FP2) \
    + bls381.window_cost((JB.Q - 1) // 2, S2, M2, bls381.POW_WINDOW_FP2)


def _finite(is_inf, valid):
    return np.asarray(valid, bool) & ~np.asarray(is_inf, bool)


def _kernel_pairing(arrays, key_on_curve, decode_ok):
    g1x, g1s, g1i, g1v, kidx, c1, c0, g2s, g2i, g2v = arrays
    keys = _finite(g2i, g2v)
    live = (_finite(g1i, g1v) & keys[kidx]).sum(axis=1)
    jobs = np.asarray(decode_ok, bool) & (live > 0)
    return int(_finite(g1i, g1v).sum()) * C["g1_decompress"] \
        + int(keys.sum()) * K_G2_DEC_ALG9 \
        + int((keys & key_on_curve).sum()) * K_LINES \
        + int(jobs.sum()) * (K_MILLER_JOB + K_FINAL_EXP) \
        + int(live[jobs].sum()) * 68 * K_LINE


def _key_on_curve(arrays):
    """The keys whose encoding is valid and decompresses."""
    c1, c0, g2s, g2i, g2v = arrays[5:]
    out = np.zeros(len(g2v), dtype=bool)
    for k in range(len(g2v)):
        if g2v[k] and not g2i[k]:
            try:
                bls_ops.g2_decompress(bls381.g2_bytes(c1[k], c0[k], g2s[k]))
                out[k] = True
            except ValueError:
                pass
    return out


def _kernel_aggregate(arrays, on_curve, stores, groups, dec, madd, add,
                      store):
    """The aggregates' schedule: the distinct valid finite points'
    decompressions, each sextet's mixed additions past its first point,
    the tree's groups - 1 complete additions a job, the stores."""
    is_inf, valid, index = arrays[-3:]
    live = _finite(is_inf, valid) & on_curve
    madds = sum(max(int(live[index[b, g::groups]].sum()) - 1, 0)
                for b in range(index.shape[0]) for g in range(groups))
    return int(_finite(is_inf, valid).sum()) * dec + madds * madd \
        + index.shape[0] * (groups - 1) * add + stores * store


def _on_curve(arrays, decompress, to_bytes):
    """The rows whose encoding is valid and finite and decompresses."""
    *coords, sign, is_inf, valid, _ = arrays
    out = np.zeros(len(valid), dtype=bool)
    for d in range(len(valid)):
        if valid[d] and not is_inf[d]:
            try:
                decompress(to_bytes(*(c[d] for c in coords), sign[d]))
                out[d] = True
            except ValueError:
                pass
    return out


def _kernel_msm(x, sign, is_inf, valid, index, digits, c, store):
    """The MSM kernel's multiplies at window width c."""
    W, seg = -(-255 // c), (16 if c >= 4 else 1 << c)
    L = (1 << c) // seg
    fin = _finite(is_inf, valid)
    windows = np.zeros((len(index), W), dtype=np.int64)
    for i, row in enumerate(digits):
        v = bp._digits_to_int(row)
        windows[i] = [(v >> (c * w)) & ((1 << c) - 1) for w in range(W)]
    madds = int(((windows != 0) & fin[index][:, None]).sum())
    adds = W * (seg * 2 * L - 1) + W * (2 * (seg - 1) + seg) + (W - 1)
    dbls = W * (L.bit_length() - 1) + (W - 1) * c
    return int(fin.sum()) * C["g1_decompress"] + madds * C["g1_madd"] \
        + adds * C["g1_add"] + dbls * K_G1_DBL + store * K_G1_STORE


def test_host_build_pairing_equals_the_plain_version(bls381_host, tmp_path):
    jobs = _adversarial_jobs()
    Bj, P = len(jobs), 3
    arrays = bp._pack_pair_arrays(jobs, Bj, P)
    K = arrays[5].shape[0]
    raw, muls = _run_host(bls381_host, tmp_path, "pairing", [Bj, P, K],
                          arrays)
    verdict, decode_ok = _split(raw, [(np.uint8, (Bj,)), (np.uint8, (Bj,))])
    want_v, want_ok = bp.pairing_plain(*bls381.upload(arrays, CPU))
    assert verdict.astype(bool).tolist() == want_v.tolist()
    assert decode_ok.astype(bool).tolist() == want_ok.tolist()
    ok = decode_ok.astype(bool)
    assert np.array_equal(muls, _kernel_pairing(arrays, _key_on_curve(arrays),
                                                ok))
    need = bp.pairing_cost(*bp.expand_keys(*arrays), ok)
    assert (need > 0).all() and bls381.int32_ops(need) \
        < bls381.int32_ops(muls)


def _shared_key_jobs():
    """Verify jobs over three keys, repeated and mixed within and across
    jobs, with an undecodable key (a valid encoding off the curve) shared
    by two jobs, a wrong message and a job holding one key twice."""
    keys = [bls_ops.g2_mul(JB.G2_GEN, k) for k in (3, 5, 7)]
    neg = JB.g2_compress(JB.g2_neg(JB.G2_GEN))
    x = 1
    while True:                          # a G2 x with no point on the curve
        raw = bytearray((x).to_bytes(96, "big"))
        raw[0] |= 0x80
        try:
            B.g2_decompress(bytes(raw))
        except ValueError:
            break
        x += 1
    off = bytes(raw)

    def job(sk, msg, key=None):
        h = JB.hash_to_g1(msg)
        pk = JB.g2_compress(key if key is not None else keys[sk])
        sig = bls_ops.g1_mul(h, (3, 5, 7)[sk])
        return [(JB.g1_compress(sig), neg), (JB.g1_compress(h), pk)]
    j = [job(i % 3, b"root-%d" % i) for i in range(6)]
    h = JB.hash_to_g1(b"twice")          # e(15 h, -g) e(2 h, 5 g) e(h, 5 g)
    both = [(JB.g1_compress(bls_ops.g1_mul(h, 15)), neg),
            (JB.g1_compress(bls_ops.g1_mul(h, 2)), JB.g2_compress(keys[1])),
            (JB.g1_compress(h), JB.g2_compress(keys[1]))]
    return j + [
        [j[0][0], j[1][1]],                          # wrong key: False
        [j[2][0], (j[2][1][0], off)],                # undecodable key
        [(j[3][1][0], off)],                         # ... shared by two
        [(JB.g1_compress(JB.G1_GEN), neg),
         (JB.g1_compress(JB.G1_GEN), JB.g2_compress(JB.G2_GEN))],
        both,                                        # one key twice
    ]


def test_host_build_pairing_on_shared_keys_equals_pairing_job_host(
        bls381_host, tmp_path):
    jobs = _shared_key_jobs()
    want = [jops.pairing_job_host(j) for j in jobs]
    assert want == [True] * 6 + [False] * 3 + [True] * 2
    Bj, P = len(jobs), 3
    arrays = bp._pack_pair_arrays(jobs, Bj, P)
    K = arrays[5].shape[0]
    assert K == 7       # -g2, three keys, g2, the bad key, the padding
    raw, muls = _run_host(bls381_host, tmp_path, "pairing", [Bj, P, K],
                          arrays)
    verdict, decode_ok = _split(raw, [(np.uint8, (Bj,)), (np.uint8, (Bj,))])
    plain_v, plain_ok = bp.pairing_plain(*bls381.upload(arrays, CPU))
    assert verdict.astype(bool).tolist() == want == plain_v.tolist()
    assert decode_ok.astype(bool).tolist() == plain_ok.tolist() \
        == [True] * 7 + [False, False] + [True] * 2
    assert np.array_equal(muls, _kernel_pairing(
        arrays, _key_on_curve(arrays), decode_ok.astype(bool)))


def test_host_build_pairing_schedule_is_near_the_bound_on_shared_keys(
        bls381_host, tmp_path):
    """Config 3's shape at B = 6: honest two-pair verify jobs over one
    aggregate key (-G2 and the key: two distinct G2 points), every G1
    point distinct. The counted schedule is within 1.1x of the bound."""
    rng = random.Random(53)
    sk = rng.randrange(2, JB.R)
    jobs = [_good_pair_job(sk=sk, msg=b"commit-%d" % i) for i in range(6)]
    arrays = bp._pack_pair_arrays(jobs, len(jobs), 2)
    assert arrays[5].shape[0] == 2
    raw, muls = _run_host(bls381_host, tmp_path, "pairing",
                          [len(jobs), 2, 2], arrays)
    verdict, decode_ok = _split(raw, [(np.uint8, (6,)), (np.uint8, (6,))])
    assert verdict.all() and decode_ok.all()
    need = bp.pairing_cost(*bp.expand_keys(*arrays), decode_ok.astype(bool))
    ratio = bls381.int32_ops(muls) / bls381.int32_ops(need)
    assert 1.0 < ratio <= 1.1


def _fp_words(values):
    return np.frombuffer(b"".join(int(v).to_bytes(48, "little")
                                  for v in values), dtype=np.uint32)


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_host_build_field_core_equals_python_integers(bls381_host, tmp_path,
                                                      op):
    """The 12 x 32-bit Montgomery core (the card's carry chains, emulated)
    against a b R^-1 mod q on random operands and the edges 0, 1, q - 1
    and R mod q."""
    q, R = JB.Q, 1 << 384
    rng = random.Random(59)
    edges = [0, 1, q - 1, R % q]
    xs = [e for e in edges for _ in edges] + [rng.randrange(q)
                                              for _ in range(200)]
    ys = [e for _ in edges for e in edges] + [rng.randrange(q)
                                              for _ in range(200)]
    n = len(xs)
    raw, muls = _run_host(bls381_host, tmp_path, "fp", [n],
                          [_fp_words(xs), _fp_words(ys)])
    got = [int.from_bytes(raw[48 * i:48 * i + 48], "little")
           for i in range(2 * n)]
    rinv = pow(R, -1, q)
    if op == "mul":
        assert got[:n] == [x * y * rinv % q for x, y in zip(xs, ys)]
    else:
        assert got[n:] == [x * x * rinv % q for x in xs]
    assert muls.tolist() == [n, n, 0]


def _agg_store_check(muls, ok, Z, inversions_min):
    """The stored results' inversions by safegcd: at least 13 batches
    each, whole batches."""
    stores = int((ok.astype(bool) & Z.reshape(len(ok), -1).any(axis=-1))
                 .sum())
    assert muls[2] % SAFEGCD_BATCH_MADS == 0
    assert muls[2] >= stores * bls381.SAFEGCD_MIN_BATCHES \
        * SAFEGCD_BATCH_MADS
    assert stores >= inversions_min
    return stores


@pytest.mark.parametrize("n", [5, 130])     # a few a sextet; past a block
def test_host_build_g1_aggregate_equals_the_plain_version(bls381_host,
                                                         tmp_path, n):
    rng = random.Random(n)
    shares = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
              for _ in range(n)]
    jobs = testing.aggregate_jobs("g1", shares, n)
    arrays = bls381.pack_g1_jobs(jobs, n)
    D, Bj = arrays[0].shape[0], len(jobs)
    assert D == n + 4                    # the shares, bad, -P, off, infinity
    raw, muls = _run_host(bls381_host, tmp_path, "g1agg", [Bj, n, D], arrays)
    L = bls381.NLIMB
    X, Y, Z, ok = _split(raw, [(np.int32, (Bj, L))] * 3
                         + [(np.uint8, (Bj,))])
    want = bls381.g1_aggregate_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert ok.astype(bool).tolist() == testing.AGGREGATE_JOBS_OK
    assert not Z[2:4].any() and not Z[6].any()
    stores = _agg_store_check(muls, ok, Z, 3)
    on_curve = _on_curve(arrays, bls_ops.g1_decompress, bls381.g1_bytes)
    assert np.array_equal(muls[:2], _kernel_aggregate(
        arrays, on_curve, stores, G1_SUM_GROUPS, C["g1_decompress"],
        C["g1_madd"], C["g1_add"], bls381.G1_STORE)[:2])
    need = bls381.g1_aggregate_cost(*arrays, ok.astype(bool), Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)


def test_host_build_g2_aggregate_equals_the_plain_version(bls381_host,
                                                         tmp_path):
    """34 distinct keys (past a block of the decompression launch, 32),
    then the cases of the G1 test, and each point of g2_sign_points() in
    a job of its own (the sign rule under the norm route)."""
    keys = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, k)) for k in range(3, 37)]
    n = len(keys)
    sets = testing.aggregate_jobs("g2", keys, n)
    arrays = bp.pack_g2_jobs(sets, n)
    D, Bj = arrays[0].shape[0], len(sets)
    raw, muls = _run_host(bls381_host, tmp_path, "g2agg", [Bj, n, D], arrays)
    shape = (Bj, 2, bls381.NLIMB)
    X, Y, Z, ok = _split(raw, [(np.int32, shape)] * 3
                         + [(np.uint8, (Bj,))])
    want = bp.g2_aggregate_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert ok.astype(bool).tolist() == testing.AGGREGATE_JOBS_OK + [True] * 4
    stores = _agg_store_check(muls, ok, Z, 7)
    on_curve = _on_curve(arrays, bls_ops.g2_decompress, bls381.g2_bytes)
    assert np.array_equal(muls[:2], _kernel_aggregate(
        arrays, on_curve, stores, G2_SUM_GROUPS, 2 * C["g2_decompress"],
        C["g2_madd"], K_G2_ADD, bls381.G2_STORE)[:2])
    need = bp.g2_aggregate_cost(*arrays, ok.astype(bool), Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_build_aggregate_voids_a_job_whose_index_leaves_the_table(
        bls381_host, tmp_path, group):
    """An index past the D distinct points and a negative one: the sum
    reads no row for them and voids their jobs (ok False, the identity),
    as the plain version does."""
    rng = random.Random(73)
    if group == "g1":
        pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(
            1, JB.R))) for _ in range(5)]
        pack, plain, shape = (bls381.pack_g1_jobs, bls381.g1_aggregate_plain,
                              (bls381.NLIMB,))
    else:
        pts = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, k))
               for k in range(3, 8)]
        pack, plain, shape = (bp.pack_g2_jobs, bp.g2_aggregate_plain,
                              (2, bls381.NLIMB))
    jobs = testing.aggregate_jobs(group, pts, 5)
    arrays = list(pack(jobs, 5))
    D, Bj = arrays[0].shape[0], len(jobs)
    arrays[-1] = arrays[-1].copy()
    arrays[-1][1, 0], arrays[-1][2, 1] = D, -1
    raw, _ = _run_host(bls381_host, tmp_path, group + "agg", [Bj, 5, D],
                       arrays)
    X, Y, Z, ok = _split(raw, [(np.int32, (Bj,) + shape)] * 3
                         + [(np.uint8, (Bj,))])
    want = plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert ok.astype(bool).tolist()[:9] == [True, False, False] \
        + testing.AGGREGATE_JOBS_OK[3:]
    assert not Z[1:3].any()


def test_host_build_inversion_equals_fermat(bls381_host, tmp_path):
    """fp_inv_var (safegcd) against pow(a, q - 2, q) on the edges 1, 2,
    q - 1, q - 2, (q + 1) / 2, 2^380 and random values; each at least 13
    batches."""
    q = JB.Q
    rng = random.Random(67)
    xs = [1, 2, q - 1, q - 2, (q + 1) // 2, 1 << 380] \
        + [rng.randrange(1, q) for _ in range(100)]
    raw, muls = _run_host(bls381_host, tmp_path, "inv", [len(xs)],
                          [_fp_words(xs)])
    got = [int.from_bytes(raw[48 * i:48 * i + 48], "little")
           for i in range(len(xs))]
    assert got == [pow(x, q - 2, q) for x in xs]
    assert muls[:2].tolist() == [0, 0]
    assert muls[2] >= len(xs) * 13 * SAFEGCD_BATCH_MADS


@pytest.mark.parametrize("chain", [0, 1, 2, 3])
def test_host_build_window_chains_equal_python_pow(bls381_host, tmp_path,
                                                   chain):
    """pow_window's fixed powers (Montgomery in and out) against Python's
    pow, and their products against window_cost: fp (q+1)/4 (the square
    roots), fp (q-3)/4 (the norm route's candidate), fp2 (q-3)/4 and
    (q-1)/2 (Alg. 9, the pairing's keys)."""
    q, R = JB.Q, 1 << 384
    e = ((q + 1) // 4, (q - 3) // 4, (q - 3) // 4, (q - 1) // 2)[chain]
    rng = random.Random(71 + chain)
    rinv = pow(R, -1, q)
    if chain < 2:
        xs = [0, 1, q - 1, R % q] + [rng.randrange(q) for _ in range(12)]
        raw, muls = _run_host(bls381_host, tmp_path, "pow", [len(xs), chain],
                              [_fp_words(xs)])
        got = [int.from_bytes(raw[48 * i:48 * i + 48], "little")
               for i in range(len(xs))]
        assert got == [pow(x * rinv % q, e, q) * R % q for x in xs]
        assert np.array_equal(muls, len(xs) * bls381.window_cost(e, S, M))
        return
    xs = [(0, 1), (R % q, 0)] + [(rng.randrange(q), rng.randrange(q))
                                 for _ in range(6)]
    raw, muls = _run_host(bls381_host, tmp_path, "pow", [len(xs), chain],
                          [_fp_words([v for x in xs for v in x])])
    got = [(int.from_bytes(raw[96 * i:96 * i + 48], "little"),
            int.from_bytes(raw[96 * i + 48:96 * i + 96], "little"))
           for i in range(len(xs))]
    want = []
    for a0, a1 in xs:
        z = JB.Fq2(a0 * rinv % q, a1 * rinv % q) ** e
        want.append((z.c0 * R % q, z.c1 * R % q))
    assert got == want
    assert np.array_equal(muls, len(xs) * bls381.window_cost(
        e, S2, M2, bls381.POW_WINDOW_FP2))


def _run_msm(exe, tmp_path, pts, ss, c=None):
    arrays = bp.pack_msm(pts, ss)
    N, D = len(pts), arrays[0].shape[0]
    c = bp.msm_window(N) if c is None else c
    raw, muls = _run_host(exe, tmp_path, "msm", [N, D, c], arrays)
    L = bls381.NLIMB
    X, Y, Z, ok = _split(raw, [(np.int32, (L,))] * 3 + [(np.uint8, ())])
    want = bp.msm_plain(*bls381.upload(arrays, CPU))
    for got, w in zip((X, Y, Z, ok.astype(bool)), want):
        assert np.array_equal(got, w.numpy())
    assert np.array_equal(muls, _kernel_msm(
        *arrays, c, int(bool(ok) and Z.any())))
    return arrays, (X, Y, Z, bool(ok)), muls


@pytest.mark.parametrize("n", [8, 70])      # the small call; a wider one
def test_host_build_msm_equals_the_plain_version(bls381_host, tmp_path, n):
    rng = random.Random(n)
    pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
           for _ in range(n - 1)] + [G1_INF]
    pts[1] = pts[0]                      # a repeated point, packed once
    ss = [rng.randrange(0, 1 << 256) for _ in range(n)]
    arrays, (X, Y, Z, ok), muls = _run_msm(bls381_host, tmp_path, pts, ss)
    assert arrays[0].shape[0] == n - 1
    need = bp.msm_cost(*bp.expand_points(*arrays), ok, Z)
    assert bls381.int32_ops(need) < bls381.int32_ops(muls)
    xy = [bls381.limbs_to_int(a) for a in (X, Y, Z)]
    assert bls381._proj_to_affine(*xy) == jops.g1_msm(pts, ss)


@pytest.mark.parametrize("case", ["below_buckets", "zero_windows",
                                  "infinity_only", "invalid"])
def test_host_build_msm_edges_equal_the_plain_version(bls381_host, tmp_path,
                                                      case):
    """Fewer scalars than buckets (c = 8 at N = 5), scalars whose upper
    windows are all zero (and a zero scalar), only points at infinity,
    and an undecodable point (ok False, the identity)."""
    rng = random.Random(61)
    pts = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
           for _ in range(5)]
    ss = [rng.randrange(JB.R) for _ in range(5)]
    c = None
    if case == "below_buckets":
        c = 8
    elif case == "zero_windows":
        ss = [3, 0, 1 << 17, 255, 12345]
    elif case == "infinity_only":
        pts = [G1_INF] * 3
        ss = ss[:3]
    else:
        pts[2] = b"\x00" * 48
    arrays, (X, Y, Z, ok), _ = _run_msm(bls381_host, tmp_path, pts, ss, c)
    assert ok == (case != "invalid")
    if case in ("infinity_only", "invalid"):
        assert not Z.any()
    else:
        xy = [bls381.limbs_to_int(a) for a in (X, Y, Z)]
        assert bls381._proj_to_affine(*xy) == jops.g1_msm(pts, ss)


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
    arrays = bp.expand_keys(*bp._pack_pair_arrays(jobs + [bad], 5, 2))
    ok = np.array([True] * 4 + [False])
    lines = 63 * C["miller_dbl"] + 5 * C["miller_add"]
    want = 8 * C["g1_decompress"] + 2 * C["g2_decompress"] + 2 * lines \
        + 8 * 68 * C["line"] + 4 * (62 * C["fp12_sqr"] + C["final_exp"])
    assert np.array_equal(bp.pairing_cost(*arrays, ok), want)
    assert bls381.int32_ops(want) == int(np.dot(want, [588, 456, 1]))


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
        + bls381.FP_INV + 3 * 2 * M + 3 * 3 * M
    assert np.array_equal(bls381.g1_aggregate_cost(*arrays, ok, Z), want)
    keys = [JB.g2_compress(bls_ops.g2_mul(JB.G2_GEN, k)) for k in (3, 5, 7)]
    g2 = bp.pack_g2_jobs([keys[:1], keys, keys[:2]], 3)
    X, Y, Z, ok = (t.numpy() for t in bp.g2_aggregate_plain(
        *bls381.upload(g2, CPU)))
    want = 3 * C["g2_decompress"] + (0 + 2 + 1) * C["g2_madd"] \
        + bls381.FP_INV + 2 * 3 * M + 3 * (2 * S + 3 * M + 2 * M2)
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
    packed = bp.pack_msm(pts, ss)
    X, Y, Z, ok = (t.numpy() for t in bp.msm_plain(
        *bls381.upload(packed, CPU)))
    arrays = bp.expand_points(*packed)
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
    want = 6 * C["g1_decompress"] + best + bls381.FP_INV + 3 * M
    assert np.array_equal(bp.msm_cost(*arrays, bool(ok), Z), want)
