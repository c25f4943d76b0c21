"""The port's device Merkle tree (plenum_tpu_torch/ops/merkle.py) and its
append kernel's plain version (ops/sha256.py, sha256_append_levels_plain,
sha256_append_groups_plain) on the
CPU, against the JAX package: its _append_levels_fused on the same levels
and windows (its own jit on the CPU backend, "plain" compression), its
DeviceMerkleTree carried across by carry.merkle_tree_from_levels, its host
CompactMerkleTree (proofs, hash-store contents) and MerkleVerifier; the
CompactMerkleTree routing, the Node's attach with the node's own config
values, the catchup seeder against the JAX package's, and the host build of
the append kernel (csrc/sha256.cu under g++, the `sha256_host` fixture
of tests/test_torch_sha256.py) through its grouped entry against
hashlib. Inputs come from numpy seeds. Tolerance: none — digests, roots,
proofs and reps must be byte-equal."""
import hashlib
import random
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenum_tpu.common.messages.node_messages import (
    CatchupReq as JaxCatchupReq)
from plenum_tpu.ledger.compact_merkle_tree import (
    CompactMerkleTree as JaxCompactMerkleTree)
from plenum_tpu.ledger.hash_store import MemoryHashStore as JaxHashStore
from plenum_tpu.ledger.ledger import Ledger as JaxLedger
from plenum_tpu.ledger.tree_hasher import TreeHasher as JaxTreeHasher
from plenum_tpu.ops import merkle as jmerkle
from plenum_tpu.server.catchup import SeederService as JaxSeederService
from plenum_tpu.server.database_manager import (
    DatabaseManager as JaxDatabaseManager)
from plenum_tpu_torch import carry
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.messages.node_messages import CatchupReq
from plenum_tpu_torch.common.serializers.serializers import MsgPackSerializer
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import MemoryHashStore
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.observability.tracing import Tracer
from plenum_tpu_torch.ops import sha256 as tsha
from plenum_tpu_torch.ops.merkle import (
    DeviceMerkleTree, ProofPipeline, append_groups)
from test_torch_sha256 import sha256_host  # noqa: F401 (a shared fixture)

H = TreeHasher()
V = MerkleVerifier(H)


def _digests(n, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(n, 32),
                                               dtype=np.uint8)


def _host_levels(leaves: np.ndarray, depth: int):
    """Levels 0..depth above `leaves` ([n, 32] u8) with hashlib: level h
    holds the n >> h complete nodes."""
    out = [[bytes(r) for r in leaves]]
    for _ in range(depth):
        c = out[-1]
        out.append([hashlib.sha256(b"\x01" + c[2 * i] + c[2 * i + 1])
                    .digest() for i in range(len(c) // 2)])
    return out


def _host_tree(leaves):
    t = JaxCompactMerkleTree(JaxTreeHasher(), JaxHashStore())
    for leaf in leaves:
        t.append(leaf)
    return t


# ------------------------------ sha256_append_levels_plain against JAX

@pytest.mark.parametrize("n0, b, k", [(37, 29, 4), (1023, 5, 4), (6, 3, 2)])
def test_append_levels_plain_equals_the_jax_fused_append(n0, b, k):
    """The plain version of the append kernel and the JAX package's
    _append_levels_fused on the same level arrays and windows (odd
    window starts among them: 37 → 66 starts levels 2 and 5 at odd
    indices, 1023 → 1028 every level), group by group; the complete rows
    of every level equal each other and hashlib."""
    n1 = n0 + b
    cap = 1 << (n1 - 1).bit_length()
    depth = cap.bit_length() - 1
    leaves = _digests(n1, n0)
    want = _host_levels(leaves, depth)
    # both sides start from the n0-leaf tree plus the new leaves
    port = [torch.zeros((cap >> h, 32), dtype=torch.uint8)
            for h in range(depth + 1)]
    for h in range(depth + 1):
        m = n0 >> h if h else n1
        if m:
            port[h][:m] = torch.from_numpy(np.frombuffer(
                b"".join(want[h][:m]), dtype=np.uint8).reshape(m, 32).copy())
    jax_levels = [jnp.asarray(jmerkle._digest_words(jnp.asarray(p.numpy())))
                  for p in port]
    for h, group in append_groups(n0, n1, k):
        tsha.sha256_append_levels_plain(
            port[h], [port[lv] for lv, _, _ in group],
            [(p0, cnt) for _, p0, cnt in group])
        buckets = tuple(1 << (c - 1).bit_length() for _, _, c in group)
        outs, _ = jmerkle._append_levels_fused(
            jax_levels[h], tuple(jax_levels[lv] for lv, _, _ in group),
            jnp.asarray([p for _, p, _ in group], dtype=jnp.int32),
            jnp.asarray([c for _, _, c in group], dtype=jnp.int32),
            buckets, "plain")
        for (lv, _, _), out in zip(group, outs):
            jax_levels[lv] = out
    for h in range(1, depth + 1):
        m = n1 >> h
        jax_rows = tsha.digests_to_array(np.asarray(jax_levels[h]))[:m]
        assert port[h][:m].numpy().tobytes() == jax_rows.tobytes() \
            == b"".join(want[h][:m]), h


@pytest.mark.parametrize("bad", [
    [(0, 0)],                         # no new parent at the first level
    [(3, 2)],                         # children past the child level
    [(1, 2), (2, 1)],                 # level 2's window starts too late
    [(1, 2), (0, 2)],                 # ... needs children not yet new
])
def test_append_levels_refuses_windows_that_are_not_an_appends(bad):
    child = torch.zeros((8, 32), dtype=torch.uint8)
    parents = [torch.zeros((4 >> j, 32), dtype=torch.uint8)
               for j in range(len(bad))]
    with pytest.raises(ValueError, match="not an append's|window"):
        tsha.sha256_append_levels_plain(child, parents, bad)


def _host_append(exe, tmp_path, n0, b, k, seed):
    """An append of b leaves onto n0 with k levels a group, through the
    host build's grouped entry (sha256_host append: every launch of
    sha256_append_groups on a tree buffer in DeviceMerkleTree's layout, as
    sha256_append_groups_cuda makes them) → (the tree after it, the
    hashlib levels of the n0 + b leaves, cap)."""
    n1 = n0 + b
    cap = 1 << (n1 - 1).bit_length()
    depth = cap.bit_length() - 1
    want = _host_levels(_digests(n1, seed), depth)
    tree = np.zeros((2 * cap - 1, 32), dtype=np.uint8)
    for h in range(depth + 1):
        m = n0 >> h if h else n1
        o = 2 * cap - 2 * (cap >> h)
        if m:
            tree[o:o + m] = np.frombuffer(b"".join(want[h][:m]),
                                          dtype=np.uint8).reshape(m, 32)
    groups = append_groups(n0, n1, k)
    spec = [0]                                         # level 0's first row
    for _, group in groups:
        for lv, p0, cnt in group:
            spec += [2 * cap - 2 * (cap >> lv), p0, cnt]
    tree.tofile(tmp_path / "tree")
    subprocess.run([exe, "append", ",".join(str(len(g)) for _, g in groups),
                    ":".join(map(str, spec)), str(tmp_path / "tree"),
                    str(tmp_path / "out")], check=True)
    return np.fromfile(tmp_path / "out", dtype=np.uint8).reshape(-1, 32), \
        want, cap


def test_host_build_of_the_append_kernel_equals_hashlib(tmp_path, sha256_host):
    """csrc/sha256.cu's append kernel, compiled for the host by g++ behind
    cuda_host_shim.h (a std::thread per CUDA thread, __syncthreads a
    barrier) and driven through its grouped entry over a whole append as
    sha256_append_groups_cuda drives it: appends of 1, 2, 3, 255, 257 and
    1,025 leaves onto trees of 2^k ± 1 leaves with K = 1 and K = 4 (odd
    window starts, several CTAs, single levels), every level's complete
    nodes against hashlib; and the ragged kernel's big-endian store."""
    exe = sha256_host
    for n0, b, k in ((1, 1, 4), (3, 2, 1), (7, 3, 4), (255, 257, 4),
                     (257, 255, 1), (511, 1025, 4)):
        tree, want, cap = _host_append(exe, tmp_path, n0, b, k, b)
        for h in range(len(want)):
            o, m = 2 * cap - 2 * (cap >> h), (n0 + b) >> h
            assert tree[o:o + m].tobytes() == b"".join(want[h][:m]), \
                (n0, b, k, h)

    msgs = [bytes([i]) * (i * 7 % 90) for i in range(40)]
    data, offsets = tsha.ragged_arrays(msgs)
    data.tofile(tmp_path / "data")
    offsets.tofile(tmp_path / "offsets")
    subprocess.run([exe, "ragged_be", "0", str(tmp_path / "data"),
                    str(tmp_path / "offsets"), str(tmp_path / "out")],
                   check=True)
    out = np.fromfile(tmp_path / "out", dtype=np.uint8)
    assert out[:-16].tobytes() == b"".join(
        hashlib.sha256(b"\x00" + m).digest() for m in msgs)
    assert not out[-16:].any()


@pytest.mark.parametrize("k", [1, 4, 9, 16])
def test_host_build_of_the_grouped_append_equals_hashlib(tmp_path,
                                                         sha256_host, k):
    """The grouped entry at K = 1, 4, 9 and 16 levels a group (16: groups
    split into launches of nine): appends of 1, 255, 257 and 1,025 leaves
    onto 2^k ± 1 leaves (odd and even window starts at every level, one
    CTA and several), every level's complete nodes against hashlib."""
    for n0 in ((1 << 9) - 1, (1 << 9) + 1, (1 << 11) - 1, (1 << 11) + 1):
        for b in (1, 255, 257, 1025):
            tree, want, cap = _host_append(sha256_host, tmp_path, n0, b, k,
                                           n0 + b + k)
            for h in range(len(want)):
                o, m = 2 * cap - 2 * (cap >> h), (n0 + b) >> h
                assert tree[o:o + m].tobytes() == b"".join(want[h][:m]), \
                    (n0, b, k, h)


@pytest.mark.parametrize("bad", [
    [(0, 0)],                         # no new parent at the first level
    [(3, 2)],                         # children past the child level
    [(1, 2), (2, 1)],                 # level 2's window starts too late
    [(1, 2), (0, 2)],                 # ... needs children not yet new
])
def test_append_groups_refuses_what_an_appends_windows_refuse(bad):
    """sha256_append_groups and its CUDA wrapper check the whole append
    once, as _append_windows does, before anything else (the CUDA wrapper
    refuses CPU tensors only after that); and K outside 1..16."""
    child = torch.zeros((8, 32), dtype=torch.uint8)
    parents = [torch.zeros((4 >> j, 32), dtype=torch.uint8)
               for j in range(len(bad))]
    with pytest.raises(ValueError, match="not an append's|window"):
        tsha._append_windows(child, parents, bad)
    for fn in (tsha.sha256_append_groups, tsha.sha256_append_groups_cuda):
        with pytest.raises(ValueError, match="not an append's|window"):
            fn(child, parents, bad, 4)
    good = [(0, 4), (0, 2)][:len(bad)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsha.sha256_append_groups_cuda(child, parents, good, 4)
    for k in (0, 17):
        with pytest.raises(ValueError, match="levels a group"):
            tsha.sha256_append_groups(child, parents, good, k)


def test_ragged_entry_writes_big_endian_digests_in_place():
    msgs = [b"", b"a", b"x" * 200]
    data, offsets = (torch.from_numpy(a.copy())
                     for a in tsha.ragged_arrays(msgs))
    out = torch.zeros((4, 32), dtype=torch.uint8)
    tsha.sha256_ragged(data, offsets, 0x00, out=out[1:])
    assert out[1:].numpy().tobytes() == b"".join(
        hashlib.sha256(b"\x00" + m).digest() for m in msgs)
    assert not out[0].any()


# ------------------------------------------------------- the device tree

@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 33, 129, 257])
def test_ragged_proofs_equal_the_jax_packages_and_verify(n):
    leaves = [b"leaf-%d" % i for i in range(n)]
    host = _host_tree(leaves)
    tree = DeviceMerkleTree(device="cpu")
    root = tree.build(leaves)
    assert root == host.root_hash
    idx = list(range(n))
    paths = tree.audit_path_batch(idx)
    assert paths == host.inclusion_proofs_batch(idx, n)
    for m in idx:
        assert V.verify_leaf_inclusion(leaves[m], m, paths[m], n, root), m
    half = max(1, n // 2)          # a prefix tree off the same levels
    assert tree.inclusion_proofs(range(half), half) == \
        host.inclusion_proofs_batch(list(range(half)), half)


def test_incremental_append_equals_the_host_tree_interleaved():
    """Appends of random sizes onto a growing tree (capacity doubling
    with preserved mirrors: _TOP_CACHE is lowered so that the bottom
    levels are gathered and the top ones mirrored): the root, and the
    returned nodes, equal the JAX package's host tree and its hash store;
    proof batches interleaved."""
    rng = random.Random(77)
    host = JaxCompactMerkleTree(JaxTreeHasher(), JaxHashStore())
    tree = DeviceMerkleTree(device="cpu")
    tree._TOP_CACHE = 16
    total = 0
    for step in range(16):
        b = rng.choice([1, 2, 3, 7, 16, 33, 100, 250])
        hashes = [H.hash_leaf(b"i-%d-%d" % (step, i)) for i in range(b)]
        for h in hashes:
            host._append_hash(h, want_path=False)
        nodes = tree.append_leaf_hashes(hashes, return_nodes=True)
        total += b
        assert tree.tree_size == host.tree_size == total
        assert tree.root_hash == host.root_hash, step
        for height, pos, rows in nodes:
            for i in range(rows.shape[0]):
                want = host.hash_store.read_leaf(pos + i) if height == 0 \
                    else host.hash_store.read_subtree((pos + i) << height,
                                                      height)
                assert rows[i].tobytes() == want, (step, height)
        if step % 3 == 0:
            idx = rng.sample(range(total), min(total, 40))
            assert tree.inclusion_proofs(idx, total) == \
                host.inclusion_proofs_batch(idx, total), step


@pytest.mark.parametrize("k", [1, 4])
def test_append_dispatches_at_most_one_plus_levels_over_k(k):
    """1,024 leaves + 256 more: 8 levels gain nodes, so an append costs 1
    + ceil(8 / K) dispatches (the leaf placement, then one launch per
    group of K levels), counted from the flight recorder's spans and the
    dispatch stats; the result equals a tree built at once."""
    base, app = _digests(1024, 5), _digests(256, 6)
    tree = DeviceMerkleTree(device="cpu", fused_levels=k)
    tree.build_from_leaf_hashes(base)
    tracer = Tracer("t")
    tree.attach_tracer(tracer)
    tree.append_leaf_hashes(app)
    spans = sum(1 for r in tracer.spans()
                if r[1] == "merkle_append_dispatch")
    assert spans == tree.dispatch_stats["append_dispatches"] \
        == 1 + -(-8 // k)
    whole = DeviceMerkleTree(device="cpu")
    assert tree.root_hash == whole.build_from_leaf_hashes(
        np.concatenate([base, app]))


def test_growth_keeps_the_mirrors_and_the_proofs():
    """Growth copies the levels and keeps the host mirrors: the first
    proof batch after an append that doubles the capacity downloads only
    the new top level; later batches download nothing and gather once
    each; proofs stay equal to the host tree's and verify."""
    leaves = [b"txn-%08d" % i for i in range(1 << 10)]
    tree = DeviceMerkleTree(device="cpu")
    tree._TOP_CACHE = 256
    tree.build(leaves)
    idx = list(range(0, 1 << 10, 3))[:32]
    tree.audit_path_batch(idx)                      # warm the mirrors
    warm = tree.dispatch_stats["mirror_level_downloads"]
    extra = [b"extra-%04d" % i for i in range(37)]
    tree.append_leaf_hashes([H.hash_leaf(d) for d in extra])
    n = tree.tree_size
    check = idx + [n - 1, n - 37]
    host = _host_tree(leaves + extra)
    paths = tree.inclusion_proofs(check, n)
    assert tree.dispatch_stats["mirror_level_downloads"] - warm == 1
    assert paths == host.inclusion_proofs_batch(check, n)
    for m, p in zip(check, paths):
        assert V.verify_leaf_inclusion((leaves + extra)[m], m, p, n,
                                       host.root_hash)
    after = dict(tree.dispatch_stats)
    for _ in range(3):
        tree.inclusion_proofs(check, n)
    assert tree.dispatch_stats["gather_dispatches"] == \
        after["gather_dispatches"] + 3
    assert tree.dispatch_stats["mirror_level_downloads"] == \
        after["mirror_level_downloads"]


def test_proof_pipeline_equals_the_one_shot_path():
    n = 777
    leaves = [b"p-%d" % i for i in range(n)]
    tree = DeviceMerkleTree(device="cpu")
    tree._TOP_CACHE = 64
    tree.build(leaves)
    idx = list(range(n))
    one_shot = tree.inclusion_proofs(idx, n)
    assert one_shot == _host_tree(leaves).inclusion_proofs_batch(idx, n)
    for depth in (1, 2, 3):
        for chunk in (1, 50, 777, 1000):
            assert ProofPipeline(tree, depth=depth).run(
                idx, n=n, chunk=chunk) == one_shot, (depth, chunk)
    dense = DeviceMerkleTree(device="cpu")
    dense._TOP_CACHE = 64
    dense.build(leaves[:512])
    got = list(ProofPipeline(dense, depth=2, dense=True).stream(
        [list(range(0, 512, 7)), list(range(3, 512, 11))]))
    assert [a.tolist() for a in got] == [
        dense.audit_path_batch_array(list(range(0, 512, 7))).tolist(),
        dense.audit_path_batch_array(list(range(3, 512, 11))).tolist()]


def test_carried_tree_equals_the_jax_trees_proofs():
    """A JAX DeviceMerkleTree (its own jits on the CPU backend) built from
    100 leaf digests and grown past its capacity by 29 appended ones:
    carry takes its level
    arrays across; root and every proof equal, and the carried tree
    appends on as the JAX one does."""
    base, app = _digests(100, 7), _digests(29, 8)
    jtree = jmerkle.DeviceMerkleTree()
    jtree.build_from_leaf_hashes(base)
    jtree.append_leaf_hashes(app)
    n = jtree.tree_size
    tree = carry.merkle_tree_from_levels(
        [np.asarray(lv) for lv in jtree._levels], n, device="cpu")
    assert tree.root_hash == jtree.root_hash
    idx = list(range(n))
    assert tree.inclusion_proofs(idx, n) == jtree.inclusion_proofs(idx, n)
    assert tree.inclusion_proofs(idx[:77], 77) == \
        jtree.inclusion_proofs(idx[:77], 77)
    more = _digests(3, 9)
    tree.append_leaf_hashes(more)
    host = _host_tree([])
    for d in np.concatenate([base, app, more]):
        host._append_hash(d.tobytes(), want_path=False)
    assert tree.root_hash == host.root_hash
    with pytest.raises(ValueError, match="cap >> h"):
        carry.merkle_tree_from_levels([np.zeros((4, 8), np.uint32)], 3,
                                      device="cpu")


# ------------------------------------- the ledger routing and the node

def _routed(proof_min=64, chunk=100, depth=2, k=4, n=300):
    tree = CompactMerkleTree(TreeHasher(), MemoryHashStore())
    for d in _digests(n, 11):
        tree._append_hash(d.tobytes(), want_path=False)
    tree.attach_device_engine(proof_min=proof_min, chunk=chunk,
                              pipeline_depth=depth, fused_levels=k,
                              device="cpu")
    return tree


def test_routing_serves_large_batches_from_the_engine():
    """Batches of proof_min or more go through the engine (synced from
    the hash store, then gathered in chunks), smaller ones through the
    host memo path; both equal the host tree's proofs."""
    tree = _routed()
    host = _routed()
    host._device_engine = None
    eng = tree._device_engine
    eng._TOP_CACHE = 64                   # gather the bottom levels
    small, large = list(range(0, 300, 5)), list(range(7, 290))
    assert tree.inclusion_proofs_batch(small, 300) == \
        host.inclusion_proofs_batch(small, 300)
    assert eng.tree_size == 0
    assert tree.inclusion_proofs_batch(large, 290) == \
        host.inclusion_proofs_batch(large, 290)
    assert eng.tree_size == 300
    assert eng.dispatch_stats["gather_dispatches"] == 3   # 283 in 100s
    for d in _digests(5, 12):                       # a scalar append
        tree._append_hash(d.tobytes(), want_path=False)
        host._append_hash(d.tobytes(), want_path=False)
    assert tree.inclusion_proofs_batch(large, 305) == \
        host.inclusion_proofs_batch(large, 305)
    assert eng.tree_size == 305 and \
        eng.dispatch_stats["build_dispatches"] == 1


def test_bulk_extend_advances_the_engine_and_equals_the_host_path():
    """extend() onto a non-empty tree with an engine in step appends on
    the card (the engine's nodes persisted at the same keys): hash store,
    frontier and root equal the host level-wise path's."""
    leaves = [b"e-%d" % i for i in range(40)]
    more = [b"m-%d" % i for i in range(33)]
    trees = []
    for engine in (True, False):
        t = CompactMerkleTree(TreeHasher(), MemoryHashStore())
        t.BULK_MIN = 8
        if engine:
            t.attach_device_engine(device="cpu")
        t.extend(leaves)
        t.extend(more)
        trees.append(t)
    eng = trees[0]._device_engine
    assert eng.tree_size == 73 and eng.dispatch_stats["build_dispatches"] == 1
    assert trees[0].root_hash == trees[1].root_hash == eng.root_hash
    assert trees[0]._frontier == trees[1]._frontier
    assert trees[0].hash_store._leaves == trees[1].hash_store._leaves
    assert trees[0].hash_store._nodes == trees[1].hash_store._nodes


def test_a_failing_engine_raises_and_serves_nothing_from_the_host():
    tree = _routed()

    def broken(*args, **kw):
        raise RuntimeError("sha256_append_levels launch failed")

    tree.inclusion_proofs_batch(list(range(100)), 300)   # builds
    tree._device_engine.append_leaf_hashes = broken
    tree._append_hash(bytes(32), want_path=False)
    with pytest.raises(RuntimeError, match="launch failed"):
        tree.inclusion_proofs_batch(list(range(100)), 301)


def _node(config):
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    timer = MockTimer()
    net = SimNetwork(timer, DefaultSimRandom(0))
    return Node("Alpha", ["Alpha", "Beta", "Gamma", "Delta"], timer,
                net.create_peer("Alpha"), config=config, device="cpu")


def test_node_attaches_a_device_tree_with_its_own_config():
    """ROADMAP C 9 and 10: the JAX package's tree reads
    MERKLE_FUSED_LEVELS, and its ProofPipeline.run its default chunk,
    from the Config class; the port's Node hands its own values down. A
    node configured with K = 1 and chunk = 1,024 serves a batch of 2,048
    proofs in two gathers and appends one level a launch."""
    assert Config.MERKLE_DEVICE_PROOFS
    node = _node(Config(MERKLE_FUSED_LEVELS=1,
                        MERKLE_DEVICE_PROOF_CHUNK=1024))
    for lid in (0, 1, 2, 3):
        eng = node.db_manager.get_ledger(lid).tree._device_engine
        assert isinstance(eng, DeviceMerkleTree)
        assert eng.device == torch.device("cpu") and eng.fused_levels == 1
    tree = node.domain_ledger.tree
    assert tree._device_proof_chunk == 1024
    for d in _digests(2100, 13):
        tree._append_hash(d.tobytes(), want_path=False)
    eng = tree._device_engine
    eng._TOP_CACHE = 256                  # gather the bottom levels
    paths = tree.inclusion_proofs_batch(list(range(2048)), 2100)
    assert eng.dispatch_stats["gather_dispatches"] == 2
    assert paths[5] == tree._path(5, 0, 2100)
    for d in _digests(12, 14):                # 2,112 leaves: 6 levels gain
        tree._append_hash(d.tobytes(), want_path=False)
    before = eng.dispatch_stats["append_dispatches"]
    tree.inclusion_proofs_batch(list(range(2048)), 2112)
    assert eng.dispatch_stats["append_dispatches"] - before == 1 + 6


def _nym_txns(n):
    return [{"txn": {"type": "1",
                     "data": {"dest": "d%07d" % i, "verkey": "~v%d" % i},
                     "metadata": {"from": "author", "reqId": i}},
             "txnMetadata": {}, "reqSignature": {}, "ver": "1"}
            for i in range(n)]


class _Net:
    """The seeders' network: subscriptions dropped, sends captured."""

    def __init__(self):
        self.sent = []

    def subscribe(self, *args):
        pass

    def send(self, msg, dst=None):
        self.sent.append(msg.to_dict())


def _served(seeder, req):
    seeder._network = net = _Net()
    seeder.process_catchup_req(req, "Beta")
    return net.sent


def test_catchup_seeder_serves_5000_txns_equal_to_the_jax_seeders():
    """A port node (device="cpu", MERKLE_DEVICE_PROOFS on) serves a
    CatchupReq of 5,000 txns: its groups of 2,048 go through the device
    tree, the rest through the host memo path, and its reps are
    byte-equal (msgpack) to the JAX package's seeder's on the same ledger.
    MSG_LEN_LIMIT is raised on both so that the port sends whole chunks
    as the JAX package does (the split of a rep past the limit is
    test_torch_bls_pool's test_catchup_replies_fit_the_frame_limit)."""
    n = 5000
    node = _node(Config(MSG_LEN_LIMIT=1 << 24))
    jledger = JaxLedger()
    for txn, jtxn in zip(_nym_txns(n), _nym_txns(n)):
        node.domain_ledger.add(txn)
        jledger.add(jtxn)
    jdb = JaxDatabaseManager()
    jdb.register_new_database(DOMAIN_LEDGER_ID, jledger, None)
    jseeder = JaxSeederService(jdb, _Net(), name="Alpha")
    eng = node.domain_ledger.tree._device_engine
    eng._TOP_CACHE = 1024                 # gather the bottom three levels
    reps = _served(node.seeder, CatchupReq(
        ledgerId=DOMAIN_LEDGER_ID, seqNoStart=1, seqNoEnd=n,
        catchupTill=n))
    assert eng.tree_size == n and eng.dispatch_stats["gather_dispatches"] == 2
    jreps = _served(jseeder, JaxCatchupReq(
        ledgerId=DOMAIN_LEDGER_ID, seqNoStart=1, seqNoEnd=n,
        catchupTill=n))
    wire = MsgPackSerializer()
    assert [len(r["txns"]) for r in reps] == [1000, 1000, 48] * 2 + [904]
    assert [wire.serialize(r) for r in reps] == \
        [wire.serialize(r) for r in jreps]


def test_seeder_groups_proofs_by_the_nodes_proof_min():
    """The seeder materializes proofs per group of max(CATCHUP_REP_CHUNK,
    MERKLE_DEVICE_PROOF_MIN) from the node's config (the JAX package's
    reads the key from the node's config too; the port's used a constant
    before the key was ported)."""
    node = _node(Config(MERKLE_DEVICE_PROOF_MIN=300, CATCHUP_REP_CHUNK=100,
                        MSG_LEN_LIMIT=1 << 24))
    for txn in _nym_txns(700):
        node.domain_ledger.add(txn)
    tree = node.domain_ledger.tree
    tree._device_engine._TOP_CACHE = 64
    sizes = []
    batch = tree.inclusion_proofs_batch
    tree.inclusion_proofs_batch = lambda ms, n: (sizes.append(len(ms)),
                                                 batch(ms, n))[1]
    reps = _served(node.seeder, CatchupReq(
        ledgerId=DOMAIN_LEDGER_ID, seqNoStart=1, seqNoEnd=700,
        catchupTill=700))
    assert sizes == [300, 300, 100] and len(reps) == 7
    assert tree._device_engine.dispatch_stats["gather_dispatches"] == 2
