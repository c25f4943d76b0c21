"""BLS multi-signatures of the port (plenum_tpu_torch/crypto/bls*.py, its
own copy of the native C code in csrc/bls12_381.c) against the JAX
package's, on the same seeded keys: keys, signatures and multi-signatures
byte-equal, the same verdicts on valid, wrong-message and bit-flipped
inputs, the native backend equal to the pure-Python one point for point,
and the host halves of the batch seams equal to the JAX package's.

Also pins two reads of the Config class that the port replaced by the
caller's config (ROADMAP C): the BLS batch routing reads the node's
BLS_DEVICE_PAIRING / BLS_PAIRING_DEVICE_MIN (and runs on the node's
device, the pairing kernel's plain version on the CPU), and the verify
daemon's worker pool its PIPELINE_WORKERS. Tolerance: none."""
import pytest

from plenum_tpu.crypto import bls as jbls
from plenum_tpu.crypto import bls_ops as jops
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.crypto import bls, bls12_381 as B, bls_native, bls_ops

MSG = b"ledger_id=1|state_root_hash=abc"


def _keys(n, mod):
    return [mod.generate_bls_keys(bytes([i + 1]) * 32) for i in range(n)]


def _flip(sig: str) -> str:
    raw = bytearray(bls.b58_decode(sig))
    raw[-1] ^= 1
    return bls.b58_encode(bytes(raw))


@pytest.mark.parametrize("n", [4, 25])
def test_scheme_is_byte_equal_to_the_jax_package(n):
    keys, jkeys = _keys(n, bls), _keys(n, jbls)
    assert keys == jkeys
    signers = [bls.BlsCryptoSignerPlenum(sk, pk) for sk, pk, _ in keys]
    jsigners = [jbls.BlsCryptoSignerPlenum(sk, pk) for sk, pk, _ in jkeys]
    sigs = [s.sign(MSG) for s in signers]
    assert sigs == [s.sign(MSG) for s in jsigners]
    pks = [pk for _, pk, _ in keys]
    v, jv = bls.BlsCryptoVerifierPlenum(), jbls.BlsCryptoVerifierPlenum()
    multi = v.create_multi_sig(sigs)
    assert multi == jv.create_multi_sig(sigs)
    for verifier in (v, jv):
        assert verifier.verify_multi_sig(multi, MSG, pks)
        assert not verifier.verify_multi_sig(multi, MSG + b"x", pks)
        assert not verifier.verify_multi_sig(_flip(multi), MSG, pks)
        assert verifier.verify_sig(sigs[0], MSG, pks[0])
        assert not verifier.verify_sig(sigs[0], MSG + b"x", pks[0])
        assert not verifier.verify_sig(_flip(sigs[0]), MSG, pks[0])
        assert verifier.verify_key_proof_of_possession(keys[1][2], pks[1])
        assert not verifier.verify_key_proof_of_possession(keys[1][2],
                                                           pks[2])


def test_multi_signature_values_round_trip_as_the_jax_package_writes_them():
    value = bls.MultiSignatureValue(1, "s", "t", "p", 1600000000)
    jvalue = jbls.MultiSignatureValue(1, "s", "t", "p", 1600000000)
    assert value.as_single_value() == jvalue.as_single_value()
    multi = jbls.MultiSignature("sig", ["Beta", "Alpha"], jvalue)
    assert bls.MultiSignature.from_dict(multi.as_dict()) == \
        bls.MultiSignature("sig", ["Beta", "Alpha"], value)


H = B.hash_to_g1(b"cross-check")


@pytest.mark.parametrize("k", [0, 1, 2, 7, 2 ** 128 + 5, B.R - 1, B.R + 9])
def test_native_scalar_mults_equal_the_python_backend(k):
    assert bls_ops.BACKEND == "native"
    assert bls_native.g1_mul(H, k) == B.g1_mul(H, k)
    assert bls_native.g2_mul(B.G2_GEN, k % 1000) == \
        B.g2_mul(B.G2_GEN, k % 1000)


def test_native_adds_hash_and_pairings_equal_the_python_backend():
    p2 = B.g1_mul(H, 2)
    assert bls_native.g1_add(H, p2) == B.g1_add(H, p2)
    assert bls_native.g1_add(H, H) == B.g1_add(H, H)
    assert bls_native.g1_add(H, B.g1_neg(H)) is None
    q2 = B.g2_mul(B.G2_GEN, 2)
    assert bls_native.g2_add(B.G2_GEN, q2) == B.g2_add(B.G2_GEN, q2)
    for msg in (b"", b"x", b"state-root" * 7):
        assert bls_native.hash_to_g1(msg) == B.hash_to_g1(msg)
    a = 987654321987654321
    good = [(B.g1_mul(H, a), B.G2_GEN), (B.g1_neg(H), B.g2_mul(B.G2_GEN, a))]
    bad = [(B.g1_mul(H, a), B.G2_GEN), (H, B.g2_mul(B.G2_GEN, a))]
    for pairs, want in ((good, True), (bad, False)):
        assert bls_native.multi_pairing_is_one(pairs) is want
        assert (B.multi_pairing(pairs) == B.FQ12_ONE) is want
        prepared = [(p, bls_native.miller_precompute(q)) for p, q in pairs]
        assert bls_native.multi_pairing_is_one_prepared(prepared) is want


def test_backend_switch_is_the_jax_packages(monkeypatch):
    monkeypatch.setenv("PLENUM_TPU_BLS", "python")
    assert bls_ops._pick_backend() is None
    monkeypatch.setenv("PLENUM_TPU_BLS", "native")
    assert bls_ops._pick_backend() is bls_native


def _jobs():
    keys = _keys(3, bls)
    neg_g2 = B.g2_compress(B.g2_neg(B.G2_GEN))
    jobs = []
    for i, (sk, pk, _) in enumerate(keys):
        h = bls_ops.hash_to_g1(MSG, b"PLENUM_TPU_BLS_SIG")
        sig = B.g1_compress(bls_ops.g1_mul(h, sk + (i == 1)))
        jobs.append([(sig, neg_g2), (B.g1_compress(h), bls.b58_decode(pk))])
    jobs.append([(b"\x00" * 48, neg_g2)])           # undecodable G1
    jobs.append([(B.g1_compress(None), B.g2_compress(None))])  # neutral
    return jobs


def test_host_batch_seams_equal_the_jax_packages():
    jobs = _jobs()
    verdicts = bls_ops.multi_pairing_is_one_jobs(jobs)
    assert verdicts == [True, False, True, False, True]
    assert verdicts == jops.multi_pairing_is_one_jobs(jobs)
    points = [B.g1_compress(B.g1_mul(H, k)) for k in (1, 2, 3)]
    scalars = [5, 2 ** 200 + 1, B.R - 1]
    assert bls_ops.g1_msm(points, scalars) == jops.g1_msm(points, scalars)
    assert bls_ops.g1_msm([], []) is None
    with pytest.raises(ValueError):
        bls_ops.g1_msm(points, scalars[:2])


def test_device_branch_raises_instead_of_stepping_down(monkeypatch):
    """The device branch runs the pairing and MSM kernels' plain versions
    on device="cpu", with the host path's verdicts; when the kernel's
    wrapper raises, the error reaches the caller and the next batch goes
    to the device branch again (the JAX package steps the family down and
    serves host verdicts, bls_ops.py:167-176)."""
    from plenum_tpu_torch.ops import bls381_pairing as bp
    jobs = _jobs()
    want = bls_ops.multi_pairing_is_one_jobs(jobs)
    launched = []
    real = bp.pairing
    monkeypatch.setattr(bp, "pairing", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    assert bls_ops.multi_pairing_is_one_jobs(
        jobs, device_pairing=True, device_min=len(jobs), device="cpu") == want
    assert launched == [len(jobs)]
    assert bls_ops.multi_pairing_is_one_jobs(
        jobs, device_pairing=True, device_min=len(jobs) + 1,
        device="cpu") == want
    assert launched == [len(jobs)]
    points = [B.g1_compress(B.g1_mul(H, k)) for k in range(1, 9)]
    assert bls_ops.g1_msm(points, list(range(8)), device_pairing=True,
                          device_min=8, device="cpu") == \
        bls_ops.g1_msm(points, list(range(8)))

    def induced(*args):
        raise RuntimeError("induced kernel failure")

    monkeypatch.setattr(bp, "pairing", induced)
    monkeypatch.setattr(bp, "msm", induced)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="induced kernel failure"):
            bls_ops.multi_pairing_is_one_jobs(
                jobs, device_pairing=True, device_min=len(jobs),
                device="cpu")
    with pytest.raises(RuntimeError, match="induced kernel failure"):
        bls_ops.g1_msm(points, [1] * 8, device_pairing=True, device_min=8,
                       device="cpu")
    assert not hasattr(bls_ops, "DEVICE_HALF_NOT_PORTED")


def test_bls_routing_reads_the_nodes_config_not_the_class(monkeypatch):
    """ROADMAP C: the JAX package's bls_ops reads
    Config.BLS_PAIRING_DEVICE_MIN from the class (bls_ops.py:118); the
    port's node hands its own value to its verifier."""
    from tests.test_torch_guards import _node
    monkeypatch.setattr(Config, "BLS_PAIRING_DEVICE_MIN", 99)
    signer, _ = bls.BlsCryptoSignerPlenum.generate(b"\x01" * 32)
    node = _node(device="cpu", bls_signer=signer,
                 config=Config(BLS_PAIRING_DEVICE_MIN=3))
    verifier = node.bls_bft_replica._verifier
    assert (verifier.device_pairing, verifier.pairing_device_min,
            verifier.device) == (True, 3, node.device)
    assert node.db_manager.bls_store is node.bls_bft_replica.bls_store
    # the value routes the batch seam: at 3 checks and more the batch goes
    # to the pairing kernel (its plain version on the node's CPU), below
    # it to the host's scalar checks; the verdicts are the same
    from plenum_tpu_torch.ops import bls381_pairing as bp
    launched = []
    real = bp.pairing
    monkeypatch.setattr(bp, "pairing", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    checks = [(signer.sign(MSG), MSG, signer.pk)] * 2
    assert verifier.verify_sigs_batch(checks) == [True, True]
    assert launched == []
    checks.append((signer.sign(MSG), MSG + b"x", signer.pk))
    checks.append((_flip(signer.sign(MSG)), MSG, signer.pk))
    assert verifier.verify_sigs_batch(checks) == [True, True, False, False]
    assert launched == [3]        # the flipped signature fails its decode


def test_daemon_workers_read_the_daemons_config_not_the_class(monkeypatch):
    """ROADMAP C: the JAX package's verify daemon sizes its pool from
    Config.PIPELINE_WORKERS on the class (verify_daemon.py:81)."""
    from plenum_tpu_torch.server.verify_daemon import VerifyDaemon
    monkeypatch.setattr(Config, "PIPELINE_WORKERS", 7)
    assert VerifyDaemon(backend="cpu",
                        config=Config(PIPELINE_WORKERS=3)).workers == 3
    assert VerifyDaemon(backend="cpu",
                        config=Config(PIPELINE_WORKERS=None)).workers == 1
