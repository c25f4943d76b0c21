"""A simulated pool of the port's Nodes, driven the way bench.py drives the
JAX package's headline pool (bench.py make_requests, make_sim_pool,
pipelined_intake, pool_latency_summary).

    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.testing import pool
    nodes, timer = pool.make_sim_pool(pool.NAMES, "torch_hub",
                                      device="cpu")
    reqs = pool.make_requests(40, SimpleSigner(seed=b"\\x52" * 32))
    pool.pipelined_intake(nodes, timer, [reqs[:20], reqs[20:]], "client")

Four Nodes on SimNetwork and MockTimer order signed NYM writes through
the normal entry points: dispatch_client_batch / conclude_client_batch,
service() and the timer. `device=None` runs every kernel on the card;
device="cpu" runs their plain versions.
"""
from collections import deque
from typing import List, Optional

from plenum_tpu_torch.common.constants import NYM, TARGET_NYM, VERKEY
from plenum_tpu_torch.common.serializers.base58 import b58encode

NAMES = ["Alpha", "Beta", "Gamma", "Delta"]
SIM_EPOCH = 1600000000
CLIENT_BATCH = 2000          # bench.py CLIENT_BATCH
PIPELINE_LAG = 2             # bench.py BENCH_PIPELINE_LAG's default


def make_requests(n: int, signer, first_req_id: int = 1) -> List[dict]:
    """n unique NYM-creation writes by one authenticated author (request
    i has reqId first_req_id + i and a destination derived from it)."""
    reqs = []
    for i in range(first_req_id - 1, first_req_id - 1 + n):
        dest = b58encode(i.to_bytes(16, "big", signed=False)
                         .rjust(16, b"\x01"))
        req = {
            "identifier": signer.identifier,
            "reqId": i + 1,
            "protocolVersion": 2,
            "operation": {"type": NYM, TARGET_NYM: dest,
                          VERKEY: "~" + dest},
        }
        req["signature"] = signer.sign(dict(req))
        reqs.append(req)
    return reqs


def make_sim_pool(names, verifier_name: str, batch: Optional[int] = None,
                  extra_conf: dict = None, device=None,
                  bls_signers: dict = None):
    """An n-node sim pool with bench.py make_sim_pool's settings (network
    seed 7, telemetry and flat wire on) whose nodes verify client
    signatures with `verifier_name`: "torch_hub" shares ONE
    CoalescingVerifierHub among all nodes (the per-node dispatches of a
    chunk fuse into one launch), any other provider name gives each node
    its own. `bls_signers` ({name: BlsCryptoSignerPlenum}) makes it a BLS
    pool: each node signs its batches' roots, its public key stands in the
    pool genesis (as `bls_genesis` writes it), and reads carry state
    proofs with multi-signatures. → (nodes, timer)."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.batch_verifier import create_verifier
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.sim_network import SimNetwork

    timer = MockTimer()
    timer.set_time(SIM_EPOCH)
    net = SimNetwork(timer, DefaultSimRandom(7), min_latency=0.001,
                     max_latency=0.005)
    overrides = dict(Max3PCBatchSize=batch or CLIENT_BATCH,
                     Max3PCBatchWait=0.05,
                     CHK_FREQ=10, LOG_SIZE=30, HEARTBEAT_FREQ=10 ** 6,
                     TELEMETRY_ENABLED=True, FLAT_WIRE=True)
    overrides.update(extra_conf or {})
    conf = Config(**overrides)
    bls = {}
    if bls_signers:
        bls = dict(genesis_txns=bls_genesis(names, bls_signers))
    nodes = [Node(name, names, timer, net.create_peer(name), config=conf,
                  device=device,
                  bls_signer=(bls_signers or {}).get(name), **bls)
             for name in names]

    def provider():
        if verifier_name in ("torch_hub", "torch_batch"):
            return create_verifier(verifier_name, device=nodes[0].device)
        return create_verifier(verifier_name)

    if verifier_name == "torch_hub":
        hub = provider()
        for n in nodes:
            n.authnr._verifier = hub
    else:
        for n in nodes:
            n.authnr._verifier = provider()
    return nodes, timer


def bls_genesis(names, bls_signers: dict) -> List[dict]:
    """Pool genesis txns of `names` with each node's BLS public key (the
    sim network's nodes need no addresses)."""
    from plenum_tpu_torch.bootstrap import node_genesis_txn
    return [node_genesis_txn(n, verkey="v%d" % i, node_ip="127.0.0.1",
                             node_port=1, client_ip="127.0.0.1",
                             client_port=2, steward_nym="S%d" % i,
                             bls_key=bls_signers[n].pk)
            for i, n in enumerate(names)]


def _pump(nodes, timer, target_size, max_iters=400):
    """Service every node and advance the timer until every node's domain
    ledger reaches target_size (bench.py drain_chunk without a chunk)."""
    for _ in range(max_iters):
        for nd in nodes:
            nd.service()
        timer.run_for(0.01)
        if all(nd.domain_ledger.size >= target_size for nd in nodes):
            break


def pipelined_intake(nodes, timer, chunks, client_id, expected=None):
    """bench.py's pipelined intake loop: dispatch and flush chunk i's
    fused verify launch, harvest the chunk PIPELINE_LAG iterations back
    (so its launch overlapped the pumps in between), then pump its
    consensus rounds. `expected(injected)` gives the domain ledger size
    the pump waits for (default: every injected request ordered).
    Returns the injected-request count."""
    expected = expected or (lambda injected: injected)
    hub = nodes[0].authnr._verifier
    injected = 0
    in_flight: deque = deque()  # (handles, chunk_len), oldest first
    for chunk in chunks:
        batch = [(r, client_id) for r in chunk]
        in_flight.append(([n.dispatch_client_batch(batch) for n in nodes],
                          len(chunk)))
        if hasattr(hub, "flush"):
            hub.flush()
        if len(in_flight) > PIPELINE_LAG:
            old_handles, old_len = in_flight.popleft()
            for n, h in zip(nodes, old_handles):
                n.conclude_client_batch(h)
            injected += old_len
        if injected:
            _pump(nodes, timer, expected(injected))
    while in_flight:
        old_handles, old_len = in_flight.popleft()
        for n, h in zip(nodes, old_handles):
            n.conclude_client_batch(h)
        injected += old_len
        _pump(nodes, timer, expected(injected))
    return injected


def pool_latency_summary(nodes):
    """Merge a pool's per-node telemetry hubs → (ordered_p50_ms,
    ordered_p99_ms, e2e_count) from the intake→reply histograms; Nones
    when telemetry was off or nothing ordered."""
    from plenum_tpu_torch.observability.export import pool_telemetry
    from plenum_tpu_torch.observability.telemetry import TM, merged_snapshot
    hubs = pool_telemetry(nodes)
    if not hubs:
        return None, None, 0
    snap = merged_snapshot(hubs)
    h = (snap.get("histograms") or {}).get(TM.ORDERED_E2E_MS) or {}
    return h.get("p50"), h.get("p99"), h.get("count", 0)
