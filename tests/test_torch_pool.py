"""A 4-node pool of the port's Nodes (plenum_tpu_torch/server/node.py, on
the CPU: every kernel in its plain PyTorch version) against a 4-node pool
of the JAX package's Nodes, both built as tests/test_node_e2e.py builds
its pool (SimNetwork seed 77, Max3PCBatchSize=10) and fed the same signed
NYM writes — two pipelined client chunks through each package's
pipelined intake (plenum_tpu_torch.testing.pool and bench.py), then a
batch that mixes tampered requests with valid ones.

The port lowers its floors (SHA256_BATCH_THRESHOLD, STATE_DEVICE_HASH_FLOOR,
VERIFIER_BATCH_THRESHOLD) so that the plain ed25519, SHA-256 and SHA3
paths really run; the JAX side runs no XLA program (scalar SHA-256, the
"cpu" verifier, host state hashing, its engine's warm-up skipped).
Tolerance: none — domain, audit and state roots must be byte-equal on
every node, replies and nacks equal, every audit path must verify."""
import pytest

import bench
from plenum_tpu.common.config import Config as JaxConfig
from plenum_tpu.crypto.signer import SimpleSigner as JaxSigner
from plenum_tpu.runtime.sim_random import DefaultSimRandom as JaxRandom
from plenum_tpu.server.node import Node as JaxNode
from plenum_tpu.state import device_state as jax_device_state
from plenum_tpu.testing.mock_timer import MockTimer as JaxTimer
from plenum_tpu.testing.sim_network import SimNetwork as JaxNetwork
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.crypto.batch_verifier import create_verifier
from plenum_tpu_torch.crypto.signer import SimpleSigner
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.ops import ed25519 as ted
from plenum_tpu_torch.ops import sha256 as tsha
from plenum_tpu_torch.ops import sha3 as tsha3
from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
from plenum_tpu_torch.server.node import Node
from plenum_tpu_torch.testing import pool
from plenum_tpu_torch.testing.mock_timer import MockTimer
from plenum_tpu_torch.testing.sim_network import SimNetwork

SIM_EPOCH = 1600000000
N_REQS = 40
CHUNK = 20
FIXTURE_CONF = dict(Max3PCBatchSize=10, Max3PCBatchWait=0.2, CHK_FREQ=5,
                    LOG_SIZE=15)
SEED = b"\x52" * 32


class ClientSink:
    def __init__(self):
        self.messages = []

    def __call__(self, client_id, msg):
        self.messages.append((client_id, type(msg).__name__, msg.to_dict()))


def _build(node_cls, conf, timer_cls, net_cls, random_cls, **node_kw):
    timer = timer_cls()
    timer.set_time(SIM_EPOCH)
    net = net_cls(timer, random_cls(77))
    sinks = [ClientSink() for _ in pool.NAMES]
    nodes = [node_cls(name, pool.NAMES, timer, net.create_peer(name),
                      config=conf, client_reply_handler=sink, **node_kw)
             for name, sink in zip(pool.NAMES, sinks)]
    return nodes, sinks, timer


def _pump(nodes, timer, target, max_iters=400):
    for _ in range(max_iters):
        for n in nodes:
            n.service()
        timer.run_for(0.01)
        if all(n.domain_ledger.size >= target for n in nodes):
            return
    raise AssertionError("pool stalled at {}".format(
        [n.domain_ledger.size for n in nodes]))


def _drive(nodes, timer, intake, reqs, mixed):
    chunks = [reqs[i:i + CHUNK] for i in range(0, len(reqs), CHUNK)]
    intake(nodes, timer, chunks, "client1")
    batch = [(r, "client2") for r in mixed]
    for n in nodes:
        n.process_client_batch(batch)
    _pump(nodes, timer, N_REQS + len(mixed) // 2)


@pytest.fixture(scope="module")
def pools():
    signer = SimpleSigner(seed=SEED)
    reqs = pool.make_requests(N_REQS, signer)
    assert reqs == bench.make_requests(N_REQS, JaxSigner(seed=SEED))
    # four valid writes and four tampered ones, interleaved
    extra = pool.make_requests(8, signer, first_req_id=N_REQS + 1)
    bad = {1, 3, 5, 7}
    for i in bad:
        if i % 4 == 1:      # signature no longer matches the operation
            extra[i]["operation"] = dict(extra[i]["operation"],
                                         verkey="~" + "1" * 22)
        else:               # a flipped signature character
            sig = extra[i]["signature"]
            extra[i]["signature"] = sig[:-1] + ("2" if sig[-1] != "2"
                                                else "3")

    counts = {"ed25519": 0, "sha256": 0, "sha3": 0}
    patched = []

    def count(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args):
            counts[key] += 1
            return fn(*args)
        patched.append((mod, name, fn))
        setattr(mod, name, counted)

    count(ted, "verify_plain", "ed25519")
    count(tsha, "sha256_ragged_plain", "sha256")
    count(tsha3, "sha3_ragged_plain", "sha3")
    warm = jax_device_state.DeviceStateEngine.warm
    jax_device_state.DeviceStateEngine.warm = lambda self: None
    try:
        port_conf = Config(SHA256_BATCH_THRESHOLD=2,
                           STATE_DEVICE_HASH_FLOOR=2,
                           VERIFIER_BATCH_THRESHOLD=2, **FIXTURE_CONF)
        port = _build(Node, port_conf, MockTimer, SimNetwork,
                      DefaultSimRandom, device="cpu")
        hub = create_verifier("torch_hub", device="cpu", threshold=2)
        for n in port[0]:
            n.authnr._verifier = hub
        _drive(port[0], port[2], pool.pipelined_intake, reqs, extra)

        jax_conf = JaxConfig(SHA256_BACKEND="scalar",
                             MERKLE_DEVICE_PROOFS=False,
                             EXEC_MERGED_DEVICE_HASH=False,
                             VERIFIER_PROVIDER="cpu", **FIXTURE_CONF)
        ref = _build(JaxNode, jax_conf, JaxTimer, JaxNetwork, JaxRandom)
        _drive(ref[0], ref[2], bench.pipelined_intake, reqs, extra)
    finally:
        jax_device_state.DeviceStateEngine.warm = warm
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return port, ref, counts, extra, bad


def test_plain_kernel_paths_ran(pools):
    _, _, counts, _, _ = pools
    assert all(v > 0 for v in counts.values()), counts


@pytest.mark.parametrize("lid", [DOMAIN_LEDGER_ID, AUDIT_LEDGER_ID,
                                 POOL_LEDGER_ID, CONFIG_LEDGER_ID])
def test_ledger_roots_equal_on_every_node(pools, lid):
    (port, _, _), (ref, _, _), _, _, _ = pools
    roots = {n.db_manager.get_ledger(lid).root_hash for n in port}
    assert roots == {n.db_manager.get_ledger(lid).root_hash for n in ref}
    assert len(roots) == 1
    assert port[0].db_manager.get_ledger(lid).size == \
        ref[0].db_manager.get_ledger(lid).size


@pytest.mark.parametrize("lid", [DOMAIN_LEDGER_ID, POOL_LEDGER_ID,
                                 CONFIG_LEDGER_ID])
def test_state_roots_equal_on_every_node(pools, lid):
    (port, _, _), (ref, _, _), _, _, _ = pools
    roots = {(n.db_manager.get_state(lid).headHash,
              n.db_manager.get_state(lid).committedHeadHash) for n in port}
    assert roots == {(n.db_manager.get_state(lid).headHash,
                      n.db_manager.get_state(lid).committedHeadHash)
                     for n in ref}
    assert len(roots) == 1


def test_replies_and_nacks_equal(pools):
    (port, port_sinks, _), (ref, ref_sinks, _), _, extra, bad = pools
    for ps, rs in zip(port_sinks, ref_sinks):
        assert ps.messages == rs.messages
    kinds = [k for _, k, _ in port_sinks[0].messages]
    assert kinds.count("Reply") == N_REQS + len(extra) - len(bad)
    nacked = {m["reqId"] for c, k, m in port_sinks[0].messages
              if k == "RequestNack"}
    assert nacked == {extra[i]["reqId"] for i in bad}
    assert port[0].domain_ledger.size == N_REQS + len(extra) - len(bad)


def test_every_reply_audit_path_verifies(pools):
    """Each reply's audit path proves its txn under the root it names, at
    the tree size at which the ledger had that root."""
    (port, port_sinks, _), _, _, _, _ = pools
    ledger = port[0].domain_ledger
    size_of_root = {ledger.tree.merkle_tree_hash(0, size): size
                    for size in range(1, ledger.size + 1)}
    verifier = MerkleVerifier(TreeHasher())
    for sink in port_sinks:
        for _, kind, msg in sink.messages:
            if kind != "Reply":
                continue
            info = msg["result"]
            seq_no = info["txnMetadata"]["seqNo"]
            root = ledger.strToHash(info["rootHash"])
            assert verifier.verify_leaf_inclusion(
                ledger.serialize_for_tree(ledger.getBySeqNo(seq_no)),
                seq_no - 1, [ledger.strToHash(h) for h in info["auditPath"]],
                size_of_root[root], root)


def test_pool_latency_summary_counts_every_ordered_request(pools):
    (port, _, _), _, _, extra, bad = pools
    p50, p99, count = pool.pool_latency_summary(port)
    assert count == len(port) * (N_REQS + len(extra) - len(bad))
    assert 0 < p50 <= p99
