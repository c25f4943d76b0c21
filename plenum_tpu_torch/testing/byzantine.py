"""Byzantine pools of the port's Nodes, driven through the adversary
harness (testing/adversary/):

* the recovery scenario of bench.py's bench_recovery (bench.py:2362-2548),
  at its sizes, seeds, config and SLOs: failover under a silent primary,
  the ex-primary's catchup, then a laggard's catchup under a garbling and
  a stalling seeder while a third peer churns;
* a BLS pool under attack: a poisoned-share committer and a propagate
  tamperer among the validators, signed NYM writes sent to every node in
  chunks. A poisoned share fails the batch's aggregate check, so each
  honest node unrolls its shares (consensus/bls_bft_replica.py) and, above
  BLS_PAIRING_DEVICE_MIN shares, checks them in one pairing launch.

    from plenum_tpu_torch.testing import byzantine
    report, nodes = byzantine.run_recovery(7, device="cpu")
    attack = byzantine.run_bls_attack(7, writes=40, chunk=20, device="cpu")

`drive_recovery` and `drive_bls_attack` only touch the timer, network,
nodes and adversary classes they are given, so a test can drive the JAX
package's pool through its own harness with the same schedule.
`device=None` runs every kernel of the nodes on the card; device="cpu"
runs their plain versions.
"""
from collections import Counter
from typing import Dict, List

SIM_EPOCH = 1600000000

# bench_recovery's pool: SimNetwork(DefaultSimRandom(77)), latency
# 0.001-0.01 s, AdversaryController(seed=7), and this Config (its
# VERIFIER_PROVIDER "cpu" aside: the port's nodes keep their own default)
RECOVERY_NODES = 25
RECOVERY_NET_SEED = 77
RECOVERY_ADV_SEED = 7
RECOVERY_CONF = dict(Max3PCBatchSize=5, Max3PCBatchWait=0.2, CHK_FREQ=5,
                     LOG_SIZE=15, ToleratePrimaryDisconnection=4,
                     NEW_VIEW_TIMEOUT=8, STATE_FRESHNESS_UPDATE_INTERVAL=3,
                     CATCHUP_TXN_TIMEOUT=2, TRACING_ENABLED=True,
                     HEARTBEAT_FREQ=10 ** 6)
TRACE_EVENTS = ("catchup_start", "catchup_done", "catchup_retry",
                "catchup_bad_peer", "view_change_start", "view_change_done",
                "vc_timeout_escalated")

# tests/test_adversary.py build_pool's Config, with 3PC batches of 50
ATTACK_CONF = dict(Max3PCBatchSize=50, Max3PCBatchWait=0.2, CHK_FREQ=5,
                   LOG_SIZE=15, ToleratePrimaryDisconnection=4,
                   NEW_VIEW_TIMEOUT=8, STATE_FRESHNESS_UPDATE_INTERVAL=3)
ATTACK_NET_SEED = 39
ATTACK_ADV_SEED = 5
ATTACK_AUTHOR_SEED = b"\x61" * 32
CHUNK_WITHIN = 60.0          # sim seconds for every honest node to order
SETTLE = 10.0                # sim seconds for late shares to backfill


def recovery_names(n: int) -> List[str]:
    return ["B%02d" % i for i in range(n)]


def attack_names(n: int) -> List[str]:
    return ["N%02d" % i for i in range(n)]


def make_recovery_pool(n_nodes: int = RECOVERY_NODES, device=None):
    """bench_recovery's pool of `n_nodes` Nodes. → (timer, net, nodes)."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    timer = MockTimer()
    timer.set_time(SIM_EPOCH)
    net = SimNetwork(timer, DefaultSimRandom(RECOVERY_NET_SEED),
                     min_latency=0.001, max_latency=0.01)
    conf = Config(**RECOVERY_CONF)
    names = recovery_names(n_nodes)
    nodes = [Node(n, names, timer, net.create_peer(n), config=conf,
                  device=device) for n in names]
    return timer, net, nodes


def recovery_request(i: int, req_id: int) -> dict:
    """bench_recovery's i-th write: a signer's NYM of itself."""
    from plenum_tpu_torch.common.constants import NYM, TARGET_NYM, VERKEY
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    signer = SimpleSigner(seed=bytes([0x41 + i % 60]) * 32)
    req = {"identifier": signer.identifier, "reqId": req_id,
           "protocolVersion": 2,
           "operation": {"type": NYM, TARGET_NYM: signer.identifier,
                         VERKEY: signer.verkey}}
    req["signature"] = signer.sign(dict(req))
    return req


def drive_recovery(timer, net, nodes, adversary,
                   failover_slo: float, catchup_slo: float) -> dict:
    """bench_recovery's two measurements on a built pool. `adversary` is
    a namespace of the harness's classes (AdversaryController,
    LivenessViolation, LyingCatchupSeeder, Scenario, SilentNode,
    SLOViolation): the port's testing.adversary module, or the JAX
    package's. A liveness failure or an SLO miss lands in "violations"
    (as in bench_recovery: the report comes out the more complete the
    worse things get). → bench_recovery's report without its latency
    and lane figures."""
    def submit(to_nodes, i, req_id):
        req = recovery_request(i, req_id)
        for nd in to_nodes:
            nd.process_client_request(dict(req), "bench-recovery")

    adv = adversary.AdversaryController(timer, seed=RECOVERY_ADV_SEED)
    adv.set_pool(nodes)
    out = {"nodes": len(nodes), "unit": "sim-seconds",
           "failover_slo_s": failover_slo, "catchup_slo_s": catchup_slo}
    violations = []

    def gated_measure(scn, name, cond, within, slo):
        try:
            val = scn.measure(cond, within=within, desc=name)
        except adversary.LivenessViolation as e:
            violations.append(str(e))
            return None
        try:
            scn.check_slo(name, val, slo)
        except adversary.SLOViolation as e:
            violations.append(str(e))
        return val

    # ---- failover: the primary goes silent under load
    primary = next(nd for nd in nodes if nd.replica.data.is_primary)
    sc = adversary.Scenario(
        timer, nodes, adversary=adv,
        honest=[nd.name for nd in nodes if nd is not primary])
    submit(nodes, 0, 1)
    sc.run(3)
    behavior = adversary.SilentNode()
    adv.corrupt(primary, behavior)
    honest = sc.honest
    submit(honest, 1, 2)
    base = {nd.name: nd.last_ordered[1] for nd in honest}

    def ordering_resumed():
        return all(nd.view_no >= 1
                   and not nd.replica.data.waiting_for_new_view
                   and nd.last_ordered[1] > base[nd.name]
                   for nd in honest)

    failover_s = gated_measure(sc, "failover", ordering_resumed,
                               4 * failover_slo + 60, failover_slo)
    out["failover_s"] = round(failover_s, 2) \
        if failover_s is not None else None
    # the crashed primary restarts: release, then catch up into the pool
    adv.release(primary, behavior)
    primary.start_catchup()
    try:
        sc.run_until(lambda: not primary.leecher.in_progress, 120,
                     "ex-primary rejoins via catchup")
    except adversary.LivenessViolation as e:
        violations.append(str(e))

    # ---- catchup under a garbling and a stalling seeder, with churn
    laggard = nodes[-1]
    net.disconnect(laggard.name)
    live = [nd for nd in nodes if nd is not laggard]
    sc_live = adversary.Scenario(timer, live, adversary=adv,
                                 honest=[nd.name for nd in live])
    for i in range(4):
        submit(live, 2 + i, 3 + i)
        sc_live.run(3)
    non_primaries = [nd for nd in live if not nd.replica.data.is_primary]
    liar, staller, churner = non_primaries[:3]
    adv.corrupt(liar, adversary.LyingCatchupSeeder())
    adv.corrupt(staller, adversary.LyingCatchupSeeder(
        lie_cons_proofs=False, garble_reps=False, stall_every=1))
    net.reconnect(laggard.name)
    laggard.start_catchup()
    adv.at(0.2, lambda: net.disconnect(churner.name), "churner leaves")
    adv.at(3.0, lambda: net.reconnect(churner.name), "churner rejoins")
    target = live[0]
    sc2 = adversary.Scenario(
        timer, nodes, adversary=adv,
        honest=[nd.name for nd in nodes
                if nd not in (liar, staller, churner)])

    def caught_up():
        return (not laggard.leecher.in_progress
                and laggard.domain_ledger.size == target.domain_ledger.size)

    catchup_s = gated_measure(sc2, "catchup", caught_up,
                              4 * catchup_slo + 60, catchup_slo)
    out["catchup_s"] = round(catchup_s, 2) if catchup_s is not None else None
    out["catchup_bad_peers"] = sorted(laggard.leecher.bad_peers)
    out["roles"] = {"primary": primary.name, "laggard": laggard.name,
                    "liar": liar.name, "staller": staller.name,
                    "churner": churner.name}
    out["honest"] = sc2.honest_names

    counts = Counter()
    for nd in nodes:
        counts.update(rec[1] for rec in nd.tracer.spans())
    out["trace_events"] = {name: counts[name] for name in TRACE_EVENTS}
    wrapped = [nd.name for nd in nodes
               if nd.tracer.stats().get("dropped", 0) > 0]
    if wrapped:
        out["trace_events"]["ring_wrapped_nodes"] = len(wrapped)
    out["slo_ok"] = not violations
    if violations:
        out["violations"] = violations
    return out


def run_recovery(n_nodes: int = RECOVERY_NODES, device=None):
    """bench_recovery on the port: the pool, the drive against the
    Config's SLOs, and the pool's ordered-latency tail. → (report,
    nodes)."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.testing import adversary
    from plenum_tpu_torch.testing.pool import pool_latency_summary
    timer, net, nodes = make_recovery_pool(n_nodes, device)
    report = drive_recovery(timer, net, nodes, adversary,
                            Config.RECOVERY_FAILOVER_SLO_S,
                            Config.RECOVERY_CATCHUP_SLO_S)
    p50, p99, count = pool_latency_summary(nodes)
    report.update(ordered_p50_ms=p50, ordered_p99_ms=p99,
                  e2e_samples=count)
    return report, nodes


def bls_seed(i: int) -> bytes:
    """The BLS key seed of the i-th node (tests/test_adversary.py's)."""
    return bytes([i + 1]) * 32


def make_bls_pool(n_nodes: int, device=None):
    """tests/test_adversary.py build_pool(bls=True) at `n_nodes` names:
    each node signs with its own BLS key, every key in the pool genesis.
    → (timer, net, nodes, signers)."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.bls import BlsCryptoSignerPlenum
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.pool import bls_genesis
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    timer = MockTimer()
    timer.set_time(SIM_EPOCH)
    net = SimNetwork(timer, DefaultSimRandom(ATTACK_NET_SEED))
    conf = Config(**ATTACK_CONF)
    names = attack_names(n_nodes)
    signers = {n: BlsCryptoSignerPlenum.generate(bls_seed(i))[0]
               for i, n in enumerate(names)}
    genesis = bls_genesis(names, signers)
    nodes = [Node(n, names, timer, net.create_peer(n), config=conf,
                  client_reply_handler=lambda c, m: None,
                  bls_signer=signers[n], genesis_txns=genesis,
                  device=device) for n in names]
    return timer, net, nodes, signers


def proofless_batches(node) -> List[str]:
    """State roots of the node's ordered batches with no stored
    multi-signature."""
    store = node.bls_bft_replica.bls_store
    return [o.stateRootHash for o in node.replica.ordered_log
            if o.stateRootHash is not None
            and store.get(o.stateRootHash) is None]


def run_bls_attack(n_nodes: int, writes: int, chunk: int,
                   device=None) -> dict:
    """A BLS pool of `n_nodes` (make_bls_pool) driven by
    drive_bls_attack with the port's adversary harness."""
    from plenum_tpu_torch.testing import adversary
    timer, _net, nodes, _signers = make_bls_pool(n_nodes, device)
    return drive_bls_attack(timer, nodes, adversary, writes, chunk)


def drive_bls_attack(timer, nodes, adversary, writes: int,
                     chunk: int) -> dict:
    """PoisonedBlsShare on one non-primary of a built BLS pool and
    TamperedPropagate on another. `writes` signed NYM writes go to every
    node in chunks of `chunk` (one process_client_batch a node, so each
    node's intake flushes the chunk at once); each chunk is pumped under
    the invariant checker until every honest node has ordered it
    (CHUNK_WITHIN sim seconds at most), then the pool settles SETTLE sim
    seconds for late shares to backfill. Every call of an honest node's
    BLS verifier's verify_sigs_batch (the share unroll) is recorded with
    its verdicts (testing/spy.py). `adversary` is a namespace of the
    harness's classes (AdversaryController, PoisonedBlsShare, Scenario,
    TamperedPropagate): the port's testing.adversary module, or the JAX
    package's, so a test can drive either package's pool the same way.
    → {"nodes", "honest", "adversaries", "scenario", "controller",
    "requests", "unrolls": [(node name, checks, verdicts)], "chunks":
    [{"views", "last_ordered", "sim_s"} after each chunk], "sim_s"}."""
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.testing.pool import make_requests
    from plenum_tpu_torch.testing.spy import spy_on
    primary = next(n for n in nodes if n.replica.data.is_primary)
    poisoner, tamperer = [n for n in nodes if n is not primary][:2]
    adv = adversary.AdversaryController(timer, seed=ATTACK_ADV_SEED)
    adv.set_pool(nodes)
    adv.corrupt(poisoner, adversary.PoisonedBlsShare())
    adv.corrupt(tamperer, adversary.TamperedPropagate())
    sc = adversary.Scenario(timer, nodes, adversary=adv)
    logs: Dict[str, list] = {
        n.name: spy_on(n.bls_bft_replica._verifier, "verify_sigs_batch")
        for n in sc.honest}
    reqs = make_requests(writes, SimpleSigner(seed=ATTACK_AUTHOR_SEED))
    t0 = timer.get_current_time()
    chunks = []
    for i, lo in enumerate(range(0, writes, chunk)):
        t_chunk = timer.get_current_time()
        batch = [(r, "attack-client") for r in reqs[lo:lo + chunk]]
        for n in nodes:
            n.process_client_batch(list(batch))
        want = min(lo + chunk, writes)
        sc.run_until(lambda: all(n.domain_ledger.size >= want
                                 for n in sc.honest),
                     CHUNK_WITHIN, "chunk {} ordered".format(i))
        chunks.append({
            "views": sorted({n.view_no for n in sc.honest}),
            "last_ordered": sorted({tuple(n.last_ordered)
                                    for n in sc.honest}),
            "sim_s": timer.get_current_time() - t_chunk})
    sc.run(SETTLE)
    unrolls = []
    for name, log in logs.items():
        unrolls.extend((name, call.args[0], call.result) for call in log)
    return {"nodes": nodes, "honest": sc.honest,
            "adversaries": {"poison": poisoner.name,
                            "tamper": tamperer.name,
                            "primary": primary.name},
            "scenario": sc, "controller": adv, "requests": reqs,
            "unrolls": unrolls, "chunks": chunks,
            "sim_s": timer.get_current_time() - t0}
