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
    """Run one entry of the host build (header: three int32) → (its output
    bytes, the (M, S) it made: multiplies that are not squarings,
    squarings)."""
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


# The kernels' own schedule (csrc/bls381.cu) from the bounds' pieces: a G2
# key's decompression and lines once a launch, a G1 decompression a pair,
# one Miller accumulator a job (the host's fp12 squaring, line and final
# exponentiation, the inverse by the cubic norm: 13 multiplies above the
# host's 105); complete additions with the multiply by 3b as additions,
# the aggregates' tree padded to the 128-thread block; the MSM's bucket
# method: mixed additions into the buckets, each window's buckets summed
# in segments (a running sum of complete additions), the segments and
# then the windows combined (a doubling's two squarings done as products
# there); an inversion per stored result.
AGG_THREADS = 128
C = bls381.COST
M, S, M2 = bls381.M, bls381.S, bls381.M2
K_G1_ADD, K_G2_ADD = C["g1_add"], C["g2_add"]
K_G1_STORE = bls381.FP_INV + 4 * M
K_G2_STORE = bls381.FP2_INV + 2 * M2 + 4 * M
K_G1_DBL = 8 * M         # the six-lane doubling: its squarings as products
K_LINES = 63 * C["miller_dbl"] + 5 * C["miller_add"]
K_MILLER_JOB = 62 * C["fp12_sqr"]
K_LINE = C["line"]
K_FINAL_EXP = C["final_exp"] + 13 * M


def _finite(is_inf, valid):
    return np.asarray(valid, bool) & ~np.asarray(is_inf, bool)


def _kernel_pairing(arrays, key_on_curve, decode_ok):
    g1x, g1s, g1i, g1v, kidx, c1, c0, g2s, g2i, g2v = arrays
    keys = _finite(g2i, g2v)
    live = (_finite(g1i, g1v) & keys[kidx]).sum(axis=1)
    jobs = np.asarray(decode_ok, bool) & (live > 0)
    return int(_finite(g1i, g1v).sum()) * C["g1_decompress"] \
        + int(keys.sum()) * C["g2_decompress"] \
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


def _kernel_aggregate(is_inf, valid, stores, dec, add, store):
    return int(_finite(is_inf, valid).sum()) * (dec + add) \
        + valid.shape[0] * (AGG_THREADS - 1) * add + stores * store


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
    assert muls.tolist() == [n, n]


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
    want = 6 * C["g1_decompress"] + best + bls381.FP_INV + 4 * bls381.M
    assert np.array_equal(bp.msm_cost(*arrays, bool(ok), Z), want)
