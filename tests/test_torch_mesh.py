"""The port's device-mesh dispatcher (plenum_tpu_torch/ops/mesh.py) and its
shard branches, on the CPU, in the shapes of tests/test_mesh.py.

The port's mesh shards over the device list it is given, here the CPU
eight times (the part XLA's forced host device count plays for the JAX
package, whose mesh conftest puts on 8 virtual CPU devices), with
cpu_shard on. The pure parts (enumeration and its power-of-two cap,
padded_size, the gate, MeshPipeline, the stats keys) are held against the
JAX package's own DeviceMesh under the same arguments; each sharded seam
(ed25519 verify at ragged sizes, the hub and the daemon, the G1 aggregate,
the pairing, the Merkle build from leaves and from digests, the proof
gather and an append after a sharded build, the trie's hash and verify
levels) against its unsharded launch and the JAX package's host oracles
(RFC 8032, CompactMerkleTree, hashlib, the BLS host library), with each
plain version called once a shard. The JAX package's XLA programs are not
called. Tolerance: none; verdicts, digests, points and proofs are exact."""
import hashlib

import numpy as np
import pytest
import torch

from plenum_tpu.crypto import bls_ops as jops
from plenum_tpu.crypto import ed25519 as jed
from plenum_tpu.ledger.compact_merkle_tree import (
    CompactMerkleTree as JaxCompactMerkleTree)
from plenum_tpu.ledger.hash_store import MemoryHashStore as JaxHashStore
from plenum_tpu.ledger.tree_hasher import TreeHasher as JaxTreeHasher
from plenum_tpu.ops import mesh as jmesh
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.crypto.fixtures import make_signed_batch
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.observability.tracing import Tracer
from plenum_tpu_torch.ops import (
    bls381, bls381_pairing as bp, ed25519 as ed, mesh, sha256 as sha, sha3,
    trie)
from plenum_tpu_torch.ops.merkle import DeviceMerkleTree

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
H = TreeHasher()


@pytest.fixture
def m():
    """The process-wide mesh on the CPU eight times with cpu_shard on;
    every setting restored afterwards."""
    pm = mesh.get_mesh()
    prior = (pm.enabled, pm.max_devices, pm.shard_min, pm.cpu_shard,
             pm.min_per_device, pm._given, pm.tracer)
    mesh.configure(enabled=True, max_devices=0, cpu_shard=True,
                   devices=CPU8, min_per_device=8)
    yield pm
    mesh.configure(enabled=prior[0], max_devices=prior[1],
                   shard_min=prior[2], cpu_shard=prior[3],
                   min_per_device=prior[4], devices=prior[5] or [],
                   tracer=prior[6])


@pytest.fixture
def calls(monkeypatch):
    """Count each plain version's calls (one a shard on a sharded
    dispatch), wrapping the names the wrappers route through."""
    counts = {}

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((ed, "verify_plain"), (sha, "sha256_ragged_plain"),
                      (sha, "sha256_node_levels_plain"),
                      (sha3, "sha3_ragged_plain"),
                      (sha3, "sha3_ragged_eq_plain"),
                      (bls381, "g1_aggregate_plain"),
                      (bp, "pairing_plain")):
        wrap(mod, name)
    return counts


def _signed(n, tamper=()):
    msgs, sigs, vks = make_signed_batch(n, seed=3, msg_prefix=b"mesh")
    sigs = list(sigs)
    for i in tamper:
        sigs[i] = bytes(64)
    return msgs, sigs, vks


# ------------------------------------------------- the pure parts vs JAX

def test_enumerates_the_given_cpu_mesh(m):
    assert m.n_devices == 8 == jmesh.get_mesh().n_devices
    assert m.device_type == "cpu"
    assert mesh.probe_platform() == jmesh.probe_platform() == "cpu"
    assert not mesh.is_accelerator() and not jmesh.is_accelerator()
    assert mesh.default_device() == CPU


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 6, 8, 100])
def test_max_devices_cap_rounds_down_to_pow2_as_the_jax_package(cap):
    ours = mesh.DeviceMesh(max_devices=cap, devices=CPU8)
    ref = jmesh.DeviceMesh(max_devices=cap)
    assert ours.n_devices == ref.n_devices
    assert ours.devices == CPU8[:ours.n_devices]


def test_without_cuda_the_host_mesh_is_one_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh, "_PROBE", {"platform": None,
                                         "device_count": None})
    host = mesh.DeviceMesh(shard_min=1, cpu_shard=True)
    assert host.devices == [CPU] and host.n_devices == 1
    assert not host.should_shard(10 ** 6)


@pytest.mark.parametrize("n, mpd", [(3, None), (64, None), (65, None),
                                    (100, None), (3, 1), (1, 1), (9, 1),
                                    (2048, None), (10005, 1)])
@pytest.mark.parametrize("cap", [0, 2])
def test_padded_size_equals_the_jax_packages(n, mpd, cap):
    ours = mesh.DeviceMesh(max_devices=cap, devices=CPU8)
    ref = jmesh.DeviceMesh(max_devices=cap)
    assert ours.padded_size(n, mpd) == ref.padded_size(n, mpd)


def test_padded_size_buckets(m):
    assert m.padded_size(3) == 64
    assert m.padded_size(65) == 128
    assert m.padded_size(3, min_per_device=1) == 8


@pytest.mark.parametrize("enabled, shard_min, cap, cpu_shard, n", [
    (True, 16, 0, True, 16), (True, 16, 0, True, 15),
    (False, 16, 0, True, 10 ** 6), (True, 16, 1, True, 10 ** 6),
    (True, 2048, 0, True, 2047), (True, 1, 2, True, 1),
    (True, 16, 0, False, 16)])
def test_should_shard_gate_equals_the_jax_packages(enabled, shard_min, cap,
                                                   cpu_shard, n):
    kw = dict(enabled=enabled, shard_min=shard_min, max_devices=cap,
              cpu_shard=cpu_shard)
    assert mesh.DeviceMesh(devices=CPU8, **kw).should_shard(n) \
        == jmesh.DeviceMesh(**kw).should_shard(n)


def test_gate_keeps_the_callers_device_type():
    cpu_mesh = mesh.DeviceMesh(shard_min=1, cpu_shard=True, devices=CPU8)
    assert cpu_mesh.should_shard(64, "cpu")
    assert not cpu_mesh.should_shard(64, "cuda")
    card_mesh = mesh.DeviceMesh(shard_min=1,
                                devices=[torch.device("cuda", 0)] * 2)
    assert card_mesh.should_shard(64)
    assert not card_mesh.should_shard(64, "cpu")


def test_pad_rows_equals_the_jax_packages():
    rng = np.random.RandomState(1)
    arrays = [rng.randint(0, 9, size=(5, 3)), rng.randint(0, 9, size=5)]
    for padded in (5, 8, 13):
        for a, b in zip(mesh.pad_rows(arrays, padded),
                        jmesh.pad_rows(arrays, padded)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_mesh_pipeline_orders_and_bounds_inflight_as_the_jax_package(depth):
    def run(pipeline_cls):
        inflight = {"now": 0, "max": 0}

        def dispatch(batch):
            inflight["now"] += 1
            inflight["max"] = max(inflight["max"], inflight["now"])
            return batch * 10

        def collect(handle):
            inflight["now"] -= 1
            return handle + 1

        out = pipeline_cls(dispatch, collect, depth=depth).run(range(7))
        return out, inflight["max"], inflight["now"]

    ours = run(mesh.MeshPipeline)
    assert ours == run(jmesh.MeshPipeline)
    assert ours == ([i * 10 + 1 for i in range(7)], depth, 0)


def test_stats_keys_equal_the_jax_packages():
    mesh.probe_platform()
    jmesh.probe_platform()
    ours = mesh.DeviceMesh(devices=CPU8)
    ref = jmesh.DeviceMesh()
    assert set(ours.stats()) == set(ref.stats())
    assert "n_devices" not in ours.stats()   # nothing enumerated yet
    assert ours.n_devices == ref.n_devices
    assert set(ours.stats()) == set(ref.stats())
    assert ours.stats()["n_devices"] == 8
    assert set(mesh.mesh_stats()) <= set(ours.stats())


def test_dispatch_splits_records_and_gathers(m):
    """A dispatch of 64 rows over 8 devices calls fn once a shard on 8
    contiguous rows, records the span and counters of the JAX package's
    dispatch, and gather concatenates the outputs in mesh order."""
    tracer = Tracer(name="mesh")
    mesh.configure(tracer=tracer)
    before = m.sharded_dispatches
    seen = []

    def fn(a, b):
        seen.append(a.tolist())
        return a * 2, b + 1

    rows = np.arange(64, dtype=np.int64)
    outs = m.dispatch(fn, [rows, rows * 3], n=37)
    assert seen == [list(range(8 * i, 8 * i + 8)) for i in range(8)]
    doubled, plus = m.gather(outs)
    assert doubled.tolist() == list(range(0, 128, 2))
    assert plus.tolist() == [3 * i + 1 for i in range(64)]
    st = mesh.mesh_stats()
    assert st["sharded_dispatches"] == before + 1
    assert st["last_batch"] == 64 and st["last_per_device_batch"] == 8
    spans = [s for s in tracer.spans() if s[1] == "mesh_dispatch"]
    assert spans and spans[-1][6] == {"n": 37, "padded": 64, "devices": 8,
                                      "per_device": 8}
    counters = {s[1]: s[6] for s in tracer.spans() if s[0] == "C"}
    assert set(counters) >= {"mesh_devices", "mesh_per_device_batch"}
    with pytest.raises(ValueError, match="does not divide"):
        m.dispatch(fn, [rows[:60], rows[:60]])


# ------------------------------------------------------- ed25519 verify

@pytest.fixture(scope="module")
def unsharded_37():
    """The unsharded port's verdicts on 37 signatures, the first and last
    tampered (the default mesh: one CPU, a passthrough)."""
    msgs, sigs, vks = _signed(37, tamper={0, 36})
    return ed.verify_batch(msgs, sigs, vks, device="cpu")


@pytest.mark.parametrize("n", [3, 37])
def test_sharded_verify_equals_unsharded_and_rfc8032(m, calls, unsharded_37,
                                                     n):
    """Sizes below the device count and sizes that do not divide over it;
    two devices (each plain call costs ~1.4 s here); a tampered signature
    stays rejected in its slot."""
    mesh.configure(shard_min=1, max_devices=2)
    msgs, sigs, vks = _signed(37, tamper={0, 36})
    msgs, sigs, vks = msgs[:n], sigs[:n], vks[:n]
    ok, valid, got_n = ed.verify_batch_async(msgs, sigs, vks, device="cpu")
    assert got_n == n and tuple(ok.shape) == (n,)
    sharded = ok.numpy() & valid
    per = {3: 8, 37: 32}[n]         # power-of-two buckets, at least 8
    assert calls["verify_plain"] == 2
    assert m.stats()["last_per_device_batch"] == per
    assert ed.launch_lanes(n, "cpu") == 2 * per
    assert sharded.tolist() == unsharded_37[:n].tolist()
    assert sharded.tolist() == [jed.verify(a, b, c)
                                for a, b, c in zip(msgs, sigs, vks)]


@pytest.mark.parametrize("setting", [{"shard_min": 1000},
                                     {"enabled": False, "shard_min": 1}])
def test_verify_passes_through_below_shard_min_and_when_disabled(
        m, calls, unsharded_37, setting):
    mesh.configure(**setting)
    before = (m.sharded_dispatches, m.passthrough_dispatches)
    msgs, sigs, vks = _signed(37, tamper={0, 36})
    assert ed.verify_batch(msgs, sigs, vks, device="cpu").tolist() \
        == unsharded_37.tolist()
    assert calls["verify_plain"] == 1
    assert (m.sharded_dispatches, m.passthrough_dispatches) \
        == (before[0], before[1] + 1)
    assert ed.launch_lanes(37, "cpu") == 37


def test_daemon_and_hub_under_the_mesh(m, calls):
    """The daemon's bucket scales by the device count when the scaled
    launch clears the gate: 20 items, bucket 12, two devices → one chunk
    of 20 through the hub, split in two shards of 16 (the hub accounts
    the 32 lanes the launch pays for); verdicts exact after the padding
    is cut."""
    from plenum_tpu_torch.server.verify_daemon import VerifyDaemon
    conf = Config(MESH_SHARD_MIN=16, MESH_MAX_DEVICES=2, MESH_CPU_SHARD=True)
    daemon = VerifyDaemon(backend="torch_hub", bucket=12, cpu_floor=1,
                          config=conf, device="cpu")
    try:
        assert (m.shard_min, m.n_devices) == (16, 2)
        msgs, sigs, vks = _signed(20, tamper={4, 11})
        results = daemon._verify_bucketed(list(zip(msgs, sigs, vks)))
    finally:
        daemon._pool.shutdown(wait=False)
    assert results == [jed.verify(a, b, c) for a, b, c in
                       zip(msgs, sigs, vks)]
    assert not results[4] and not results[11] and sum(results) == 18
    assert daemon._verifier.launches == [(20, 32)]
    assert calls["verify_plain"] == 2
    assert m.stats()["last_per_device_batch"] == 16


# ----------------------------------------------------------------- BLS

def _g1_jobs():
    import random
    from plenum_tpu.crypto import bls12_381 as JB
    from plenum_tpu_torch.crypto import bls_ops
    rng = random.Random(5)
    shares = [JB.g1_compress(bls_ops.g1_mul(JB.G1_GEN, rng.randrange(1, JB.R)))
              for _ in range(9)]
    bad = b"\x00" * 48
    return [shares[:4], shares[4:], [shares[0], bls381.G1_INF],
            [bls381.G1_INF], [], [shares[2], bad],
            [shares[0], shares[3], shares[0]], [bad, shares[5]],
            shares[1:3]]


def test_sharded_g1_aggregate_equals_unsharded_and_the_host_library(m,
                                                                    calls):
    """Nine jobs over eight devices (padded to 16 with all-infinity jobs,
    two a shard): each shard packs its own distinct shares; an undecodable
    share shared by two jobs fails both."""
    jobs = _g1_jobs()
    mesh.configure(shard_min=1)
    points, ok = bls381.aggregate_g1_jobs(jobs, device="cpu")
    assert calls["g1_aggregate_plain"] == 8
    assert m.stats()["last_batch"] == 16
    mesh.configure(enabled=False)
    points_1, ok_1 = bls381.aggregate_g1_jobs(jobs, device="cpu")
    assert ok.tolist() == ok_1.tolist() \
        == [True] * 5 + [False, True, False, True]
    assert points == points_1
    for job, point, good in zip(jobs, points, ok):
        if good:
            assert point == jops.g1_aggregate_compressed(job)
        else:
            assert point is None


def test_sharded_pairing_equals_unsharded_and_pairing_job_host(m, calls):
    """tests/test_bls381_pairing.py's adversarial jobs (twelve, padded to
    16 over eight devices): each shard packs its own distinct keys."""
    from test_torch_bls381 import _adversarial_jobs
    jobs = _adversarial_jobs()
    mesh.configure(shard_min=1)
    verdict, decode_ok = bp.pairing_jobs(jobs, "cpu")
    assert calls["pairing_plain"] == 8
    mesh.configure(enabled=False)
    verdict_1, decode_ok_1 = bp.pairing_jobs(jobs, "cpu")
    assert verdict.tolist() == verdict_1.tolist() \
        == [jops.pairing_job_host(j) for j in jobs]
    assert decode_ok.tolist() == decode_ok_1.tolist()


def test_msm_and_g2_aggregate_count_a_passthrough(m):
    from plenum_tpu.crypto import bls12_381 as JB
    mesh.configure(shard_min=1)
    before = (m.sharded_dispatches, m.passthrough_dispatches)
    point, ok = bp.msm_g1([JB.g1_compress(JB.G1_GEN)] * 16, list(range(16)),
                          device="cpu")
    assert ok and point == JB.g1_mul(JB.G1_GEN, sum(range(16)))
    bp.g2_aggregate_collect(bp.g2_aggregate_dispatch(
        [[bls381.G2_INF]] * 16, 1, device="cpu"))
    assert (m.sharded_dispatches, m.passthrough_dispatches) \
        == (before[0], before[1] + 2)


# --------------------------------------------------------------- Merkle

def _host_tree(leaves):
    t = JaxCompactMerkleTree(JaxTreeHasher(), JaxHashStore())
    for leaf in leaves:
        t.append(leaf)
    return t


def test_sharded_merkle_builds_equal_unsharded_and_the_host_tree(m, calls):
    """100 leaves (capacity 128) over four devices, 32 a shard: four
    shards hash leaves, each builds its subtree's five levels, and the top
    two levels are built on the tree's device; the whole buffer is
    byte-equal to an unsharded build's, from raw leaves and from digests."""
    leaves = [b"leaf-%05d" % i for i in range(100)]
    digests = [H.hash_leaf(x) for x in leaves]
    host = _host_tree(leaves)
    mesh.configure(shard_min=16, max_devices=4)
    t_s = DeviceMerkleTree(device="cpu")
    assert t_s.build(leaves) == host.root_hash
    assert calls["sha256_ragged_plain"] == 4
    assert calls["sha256_node_levels_plain"] == 4 + 1
    assert m.stats()["last_per_device_batch"] == 32
    t_d = DeviceMerkleTree(device="cpu")
    assert t_d.build_from_leaf_hashes(digests) == host.root_hash
    mesh.configure(enabled=False)
    t_1 = DeviceMerkleTree(device="cpu")
    t_1.build(leaves)
    assert torch.equal(t_s._buf, t_1._buf) and torch.equal(t_d._buf,
                                                           t_1._buf)
    idx = list(range(0, 100, 3))
    assert t_s.inclusion_proofs(idx) == host.inclusion_proofs_batch(idx, 100)


def test_tiny_tree_below_device_count_stays_unsharded(m):
    """A capacity that does not divide over the mesh (4 rows, 8 devices)
    builds on one device however low the gate."""
    mesh.configure(shard_min=2)
    before = m.sharded_dispatches
    want = H.hash_children(H.hash_children(H.hash_leaf(b"a"),
                                           H.hash_leaf(b"b")),
                           H.hash_leaf(b"c"))
    assert DeviceMerkleTree(device="cpu").build([b"a", b"b", b"c"]) == want
    t2 = DeviceMerkleTree(device="cpu")
    assert t2.build_from_leaf_hashes(
        [H.hash_leaf(x) for x in (b"a", b"b", b"c")]) == want
    assert m.sharded_dispatches == before


def test_sharded_gather_and_append_equal_unsharded_and_the_host_tree(m):
    """With _TOP_CACHE lowered the bottom levels are gathered on the
    device: a batch over the gate splits its indices over the mesh, each
    shard gathering from the tree's levels (the tree's own buffer: every
    entry is the tree's device); a second batch reuses the snapshot, an
    append past it copies again, and the proofs after the append equal
    the never-sharded tree's and the host tree's."""
    leaves = [b"g-%05d" % i for i in range(200)]
    extra = [H.hash_leaf(b"extra-%d" % i) for i in range(37)]
    idx = list(range(0, 200, 2))

    def tree():
        t = DeviceMerkleTree(device="cpu")
        t._TOP_CACHE = 8
        t.build(leaves)
        return t

    mesh.configure(shard_min=16, max_devices=4)
    t_s = tree()
    assert t_s._n_low() > 0
    before = m.sharded_dispatches
    proofs_s = t_s.inclusion_proofs(idx)
    assert m.sharded_dispatches == before + 1
    assert m.stats()["last_batch"] == 128        # 100 indices, padded
    broadcasts = t_s.dispatch_stats["replica_broadcasts"]
    assert broadcasts == t_s._n_low()
    assert t_s.inclusion_proofs(idx) == proofs_s
    assert t_s.dispatch_stats["replica_broadcasts"] == broadcasts
    t_s.append_leaf_hashes(extra)
    idx2 = list(range(0, 237, 3))
    proofs_s2 = t_s.inclusion_proofs(idx2)
    assert t_s.dispatch_stats["replica_broadcasts"] > broadcasts
    mesh.configure(enabled=False)
    t_1 = tree()
    assert t_1.inclusion_proofs(idx) == proofs_s
    t_1.append_leaf_hashes(extra)
    assert t_s.root_hash == t_1.root_hash
    assert t_1.inclusion_proofs(idx2) == proofs_s2
    host = JaxCompactMerkleTree(JaxTreeHasher(), JaxHashStore())
    for leaf in leaves:
        host.append(leaf)
    assert proofs_s == host.inclusion_proofs_batch(idx, 200)
    for h in extra:
        host._append_hash(h, want_path=False)
    assert proofs_s2 == host.inclusion_proofs_batch(idx2, 237)


# ----------------------------------------------------------------- trie

def test_sharded_trie_levels_equal_unsharded_and_hashlib(m, calls):
    rng = np.random.RandomState(9)
    blobs = [rng.randint(0, 256, size=int(rng.randint(0, 300)),
                         dtype=np.uint8).tobytes() for _ in range(100)]
    want = [hashlib.sha3_256(b).digest() for b in blobs]
    refs = list(want)
    refs[7] = bytes(32)
    mesh.configure(shard_min=16)
    dig = trie.collect_node_hash_batch(trie.dispatch_node_hash_batch(
        blobs, "cpu"))
    assert calls["sha3_ragged_plain"] == 8
    ok = trie.collect_node_verify_batch(trie.dispatch_node_verify_batch(
        blobs, refs, "cpu"))
    assert calls["sha3_ragged_eq_plain"] == 8
    assert m.stats()["last_batch"] == 128
    assert sha3.digests_to_bytes(dig) == want
    assert ok.tolist() == [i != 7 for i in range(100)]
    mesh.configure(enabled=False)
    assert np.array_equal(trie.collect_node_hash_batch(
        trie.dispatch_node_hash_batch(blobs, "cpu")), dig)
    assert np.array_equal(trie.collect_node_verify_batch(
        trie.dispatch_node_verify_batch(blobs, refs, "cpu")), ok)


# ------------------------------------------------------- configuration

def test_node_config_reaches_the_mesh(m):
    """A Node applies its config's MESH_* keys to the process-wide mesh,
    as the JAX package's does."""
    from tests.torch_two_packages import NAMES, PORT, pkg
    p = pkg(PORT)
    timer = p.MockTimer()
    net = p.SimNetwork(timer, p.Random(0))
    p.Node("Alpha", NAMES, timer, net.create_peer("Alpha"),
           config=Config(MESH_ENABLED=False, MESH_SHARD_MIN=4096),
           device="cpu")
    assert m.enabled is False and m.shard_min == 4096
    assert m.n_devices == 8         # the device list is not a config key


def test_daemon_applies_its_own_config_unlike_the_jax_packages(m):
    """The port's verify daemon applies its config's MESH_* keys; the JAX
    package's daemon never calls configure_from, so its mesh keeps what it
    had (the Config class defaults in a daemon process): a deliberate
    difference (ROADMAP C)."""
    from plenum_tpu.server.verify_daemon import VerifyDaemon as JaxDaemon
    from plenum_tpu_torch.server.verify_daemon import VerifyDaemon
    daemon = VerifyDaemon(backend="cpu", config=Config(
        MESH_ENABLED=False, MESH_SHARD_MIN=4096, MESH_MAX_DEVICES=4))
    daemon._pool.shutdown(wait=False)
    assert (m.enabled, m.shard_min, m.n_devices) == (False, 4096, 4)
    jm = jmesh.get_mesh()
    prior = (jm.enabled, jm.shard_min)
    jmesh.configure(shard_min=1234)
    try:
        JaxDaemon(backend="adaptive")._pool.shutdown(wait=False)
        assert (jm.enabled, jm.shard_min) == (prior[0], 1234)
    finally:
        jmesh.configure(enabled=prior[0], shard_min=prior[1])
