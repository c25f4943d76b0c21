"""The gateway tier driven open-loop, as bench.py's gateway_open_loop
drives the JAX package's (bench.py:2056-2323), for the port.

    from plenum_tpu_torch.testing import gateway_load
    run = gateway_load.run_open_loop(device="cpu", rate=200, secs=1.5)
    print(gateway_load.summary(run))

Poisson arrivals (seeded) of a read/write mix with hot-key skew go
through the client-facing Gateway (gateway/) into a BLS sim pool of
Nodes, one tick of `TICK_S` simulated seconds at a time: reads hit the
signed-read cache or the primary, writes are pre-screened by the
gateway's CoalescingVerifierHub (ed25519 on the gateway's device) and
forwarded as FLAT_WIRE envelopes that every node re-authenticates.
The backlog (admitted writes not yet ordered) feeds the admission
ladder each tick. `replay_pool` feeds what the gateway forwarded
straight to a fresh pool, the shape of the JAX package's end-to-end
gateway test: its roots must equal the gateway-fed pool's.

The pieces are split so that a test can drive the JAX package's
Gateway and pool with the same schedule and envelopes (`schedule`,
`tick_envelopes`, `drive` only touch the objects they are given).
"""
import random
import time
from typing import Callable, List, Optional, Tuple

from plenum_tpu_torch.common.constants import NYM, TARGET_NYM, VERKEY
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.serializers.msgpack_codec import packb

SIM_EPOCH = 1600000000
TICK_S = 0.05               # bench.py gateway_open_loop tick_dt
ENVELOPE_REQS = 64          # requests per client envelope
SENDERS = 4                 # load-balancer senders ("lb-0".."lb-3")
HOT_N = 16                  # hot-key set for reads and touch updates
N_NODES = 4
READ_PCT = 0.3              # of arrivals: GET_NYM reads
SCHEDULE_SEED = 4242
DUP_PCT = 0.02              # client retries the dedup window absorbs
TOUCH_PCT = 0.10            # of writes: updates to a hot dest (lanes)
HOT_READ_PCT = 0.8          # of reads: on the hot set
BAD_SEED = 4343             # where the bad-signature writes fall
BAD_REQ_ID = 900000         # their reqIds start above this
WALL_BUDGET_S = 150.0       # bench.py's wall budget for the open loop
P99_EVERY = 20              # ticks between reads of the pool's p99

# bench.py gateway_open_loop's pool and ladder settings
POOL_CONF = dict(Max3PCBatchSize=200, Max3PCBatchWait=0.05, CHK_FREQ=10,
                 LOG_SIZE=30, HEARTBEAT_FREQ=10 ** 6,
                 GATEWAY_BACKLOG_HIGH=150.0, GATEWAY_BACKLOG_LOW=75.0,
                 GATEWAY_BACKLOG_HARD=1000.0)


def node_names() -> List[str]:
    return ["G%02d" % i for i in range(N_NODES)]


def bls_seeds() -> List[bytes]:
    """The BLS key seed of each node (bench.py's)."""
    return [bytes([0x30 + i]) * 32 for i in range(N_NODES)]


def hot_dests() -> List[str]:
    return ["gwhot-%04d" % i + "h" * 12 for i in range(HOT_N)]


def seed_requests(author, hot: List[str]) -> List[dict]:
    """The writes that create the hot-key set before the open loop."""
    reqs = []
    for i, dest in enumerate(hot):
        req = {"identifier": author.identifier, "reqId": i + 1,
               "protocolVersion": 2,
               "operation": {"type": NYM, TARGET_NYM: dest}}
        req["signature"] = author.sign(dict(req))
        reqs.append(req)
    return reqs


def schedule(author, hot: List[str], rate: float, secs: float,
             n_bad: int = 0) -> List[Tuple[float, dict]]:
    """bench.py's open-loop arrival schedule [(t_rel, request dict)]:
    Poisson arrivals at `rate` per simulated second for `secs` seconds
    from random.Random(SCHEDULE_SEED), 2% retries of earlier writes, 30%
    GET_NYM reads (80% on the hot set), 10% of writes updates of a hot
    dest. `n_bad` writes whose signatures do not match (one
    character changed) are added at times from random.Random(BAD_SEED),
    without touching the stream above."""
    rng = random.Random(SCHEDULE_SEED)
    sched = []
    req_id = 1000
    write_history = []
    t = 0.0
    hot_n = len(hot)
    while True:
        t += rng.expovariate(rate)
        if t >= secs:
            break
        req_id += 1
        draw = rng.random()
        if write_history and draw < DUP_PCT:
            sched.append((t, rng.choice(write_history)))   # a retry
            continue
        if draw < DUP_PCT + READ_PCT:
            if rng.random() < HOT_READ_PCT:
                dest = hot[min(int(rng.expovariate(0.5)), hot_n - 1)]
            elif write_history:
                dest = rng.choice(write_history)["operation"][TARGET_NYM]
            else:
                dest = hot[0]
            sched.append((t, {"identifier": author.identifier,
                              "reqId": req_id,
                              "operation": {"type": "105",
                                            TARGET_NYM: dest}}))
            continue
        if rng.random() < TOUCH_PCT:
            dest = hot[rng.randrange(hot_n)]   # conflicting update
            op = {"type": NYM, TARGET_NYM: dest}
        else:
            dest = "gw-%06d" % req_id + "u" * 10
            op = {"type": NYM, TARGET_NYM: dest, VERKEY: "~" + dest[:22]}
        req = {"identifier": author.identifier, "reqId": req_id,
               "protocolVersion": 2, "operation": op}
        req["signature"] = author.sign(dict(req))
        sched.append((t, req))
        write_history.append(req)
    bad_rng = random.Random(BAD_SEED)
    for i in range(n_bad):
        dest = "gwbad-%04d" % i + "b" * 12
        req = {"identifier": author.identifier, "reqId": BAD_REQ_ID + i,
               "protocolVersion": 2,
               "operation": {"type": NYM, TARGET_NYM: dest,
                             VERKEY: "~" + dest[:22]}}
        sig = author.sign(dict(req))
        req["signature"] = sig[:-1] + ("2" if sig[-1] != "2" else "3")
        sched.append((bad_rng.uniform(0.0, secs), req))
    sched.sort(key=lambda e: e[0])
    return sched


def tick_envelopes(due: List[Tuple[float, dict]]
                   ) -> List[Tuple[bytes, str, float]]:
    """One tick's arrivals as client envelopes of ENVELOPE_REQS requests
    from SENDERS load-balancer senders: [(bytes, sender, arrival)]."""
    envs = []
    for lo in range(0, len(due), ENVELOPE_REQS):
        group = due[lo:lo + ENVELOPE_REQS]
        blobs = [packb(m) for _, m in group]
        clients = ["c%d" % (i & 7) for i in range(len(group))]
        envs.append((flat_wire.encode_propagate_envelope(blobs, clients),
                     "lb-%d" % ((lo // ENVELOPE_REQS) % SENDERS),
                     group[0][0]))
    return envs


def seed_pool(nodes, timer, author, hot: List[str]) -> int:
    """Order the hot-key set on every node; → the domain ledger size the
    open loop starts from."""
    reqs = seed_requests(author, hot)
    for n in nodes:
        n.process_client_batch([(dict(r), "seed") for r in reqs])
    for _ in range(200):
        for n in nodes:
            n.service()
        timer.run_for(TICK_S)
        if all(n.domain_ledger.size >= len(hot) for n in nodes):
            break
    return min(n.domain_ledger.size for n in nodes)


def drive(nodes, timer, gw, outbound: list, sched, base_size: int,
          pool_p99: Optional[Callable[[], Optional[float]]] = None) -> dict:
    """The open loop (bench.py's): each tick the due arrivals go to
    `gw.pump` as envelopes with the backlog (admitted − ordered) and,
    when `pool_p99` is given, the pool's ordered p99 read every
    P99_EVERY ticks; what the gateway forwarded (`outbound`, its
    forward_writes list) goes to every node's process_gateway_envelope;
    every node is serviced and the timer advanced. Ends when every
    arrival is in and every admitted write ordered. → {"stats", "ticks":
    one dict a tick, "envelopes": what was forwarded, per tick, "levels":
    the levels seen, "completed", "wall_s"}."""
    t0 = time.perf_counter()
    stats = {"arrivals": 0, "reads_arrived": 0, "writes_arrived": 0,
             "admitted_writes": 0, "shed_reads": 0, "shed_writes": 0,
             "cache_hits": 0, "sig_rejects": 0}
    ticks, envelopes, levels = [], [], []
    p99 = None
    now_rel = 0.0
    idx = tick_i = 0
    completed = True
    while True:
        if time.perf_counter() - t0 > WALL_BUDGET_S:
            completed = False
            break
        ordered = min(n.domain_ledger.size for n in nodes) - base_size
        if idx >= len(sched) and ordered >= stats["admitted_writes"]:
            break
        if idx >= len(sched) and tick_i > len(sched) + 2000:
            completed = False
            break
        now_rel += TICK_S
        tick_i += 1
        due = []
        while idx < len(sched) and sched[idx][0] <= now_rel:
            due.append(sched[idx])
            idx += 1
        for _, msg in due:
            stats["arrivals"] += 1
            if msg["operation"]["type"] == "105":
                stats["reads_arrived"] += 1
            else:
                stats["writes_arrived"] += 1
        backlog = stats["admitted_writes"] - ordered
        tick = gw.pump(tick_envelopes(due), now=now_rel, backlog=backlog,
                       pool_p99_ms=p99)
        if tick.level not in levels:
            levels.append(tick.level)
        stats["admitted_writes"] += len(tick.admitted_writes)
        stats["shed_reads"] += tick.shed_reads
        stats["shed_writes"] += tick.shed_writes
        stats["cache_hits"] += tick.cache_hits
        stats["sig_rejects"] += tick.sig_rejects
        ticks.append({"level": tick.level, "backlog": backlog,
                      "admitted": [(m["reqId"], c)
                                   for m, c in tick.admitted_writes],
                      "shed_reads": tick.shed_reads,
                      "shed_writes": tick.shed_writes,
                      "cache_hits": tick.cache_hits,
                      "sig_rejects": tick.sig_rejects,
                      "replies": len(tick.replies)})
        envelopes.append(list(outbound))
        for env in outbound:
            for n in nodes:
                n.process_gateway_envelope(env, "gw-front")
        del outbound[:]
        for n in nodes:
            n.service()
        timer.run_for(TICK_S)
        if pool_p99 is not None and tick_i % P99_EVERY == 0:
            p99 = pool_p99()
    return {"stats": stats, "ticks": ticks, "envelopes": envelopes,
            "levels": levels, "completed": completed,
            "wall_s": time.perf_counter() - t0}


def make_pool(device=None, extra_conf: dict = None):
    """bench.py gateway_open_loop's BLS sim pool of the port's Nodes on
    `device` (None means CUDA; each node's own verifier hub, SHA-256 and
    SHA3 kernels there). → (nodes, timer, bls signers by name, conf)."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.bls import BlsCryptoSignerPlenum
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.pool import bls_genesis
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    names = node_names()
    signers = {name: BlsCryptoSignerPlenum.generate(seed)[0]
               for name, seed in zip(names, bls_seeds())}
    timer = MockTimer()
    timer.set_time(SIM_EPOCH)
    net = SimNetwork(timer, DefaultSimRandom(77), min_latency=0.001,
                     max_latency=0.005)
    conf = Config(**dict(POOL_CONF, **(extra_conf or {})))
    genesis = bls_genesis(names, signers)
    nodes = [Node(name, names, timer, net.create_peer(name), config=conf,
                  bls_signer=signers[name], genesis_txns=genesis,
                  device=device)
             for name in names]
    return nodes, timer, signers, conf


def author_signer():
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    return SimpleSigner(seed=b"\x71" * 32)


def run_open_loop(device=None, rate: float = 600.0, secs: float = 8.0,
                  n_bad: int = 0, extra_conf: dict = None,
                  feed_p99: bool = True, verifier=None) -> dict:
    """bench.py's gateway_open_loop on the port: the pool and, unless a
    `verifier` is given, the gateway's pre-screen hub on `device` (None
    means CUDA), `n_bad` bad-signature writes added to the schedule,
    `extra_conf` over the pool's config. `feed_p99` feeds the pool's ordered
    p99 (wall clock) to the ladder every 20 ticks, as bench.py does;
    without it only the backlog moves the ladder, so a run is a pure
    function of the schedule. → drive()'s dict with "nodes", "gateway",
    "telemetry", "base_size" and "schedule" added."""
    from plenum_tpu_torch.client.client import PoolClient
    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.gateway import Gateway
    from plenum_tpu_torch.observability.telemetry import TelemetryHub
    from plenum_tpu_torch.testing.pool import pool_latency_summary

    nodes, timer, signers, conf = make_pool(device, extra_conf)
    author = author_signer()
    hot = hot_dests()
    base_size = seed_pool(nodes, timer, author, hot)
    sched = schedule(author, hot, rate, secs, n_bad)

    wallet = Wallet()
    wallet.add_identifier(signer=SimpleSigner(seed=b"\x72" * 32))
    proof_client = PoolClient(
        wallet, list(signers), send_fn=lambda n, m: None,
        bls_verifier=BlsCryptoVerifierPlenum(),
        bls_key_provider=lambda n: signers[n].pk)
    primary = nodes[0]

    def serve_read(msg, _client):
        try:
            return primary.read_manager.get_result(
                Request.from_dict(dict(msg)))
        except Exception:
            return None

    gw_hub = TelemetryHub(name="gateway")
    outbound = []
    gw = Gateway(forward_writes=outbound.append, serve_read=serve_read,
                 check_proof=proof_client.check_proof_dict,
                 verifier=verifier, config=conf, telemetry=gw_hub,
                 device=device)
    p99 = (lambda: pool_latency_summary(nodes)[1]) if feed_p99 else None
    run = drive(nodes, timer, gw, outbound, sched, base_size, pool_p99=p99)
    run.update(nodes=nodes, gateway=gw, telemetry=gw_hub,
               base_size=base_size, schedule=sched)
    return run


def forwarded_stream(run) -> List[List[Tuple[dict, str]]]:
    """Per tick, the requests the gateway forwarded, in wire order (each
    conflict lane's run together), as the nodes unpacked them."""
    out = []
    for envs in run["envelopes"]:
        batch = []
        for env in envs:
            for sec in flat_wire.parse_envelope(env).sections:
                batch.extend((sec.request(i), sec.client(i))
                             for i in range(sec.n))
        out.append(batch)
    return out


def replay_pool(stream, device=None, extra_conf: dict = None):
    """A fresh pool of the same genesis fed `stream` (forwarded_stream's
    per-tick batches) straight through process_client_batch on the open
    loop's tick cadence, after the same hot-key seeding; pumped until
    every fed write is ordered. → the nodes."""
    nodes, timer, _, _ = make_pool(device, extra_conf)
    base = seed_pool(nodes, timer, author_signer(), hot_dests())
    fed = 0
    for batch in stream:
        if batch:
            for n in nodes:
                n.process_client_batch([(dict(m), c) for m, c in batch])
        fed += len(batch)
        for n in nodes:
            n.service()
        timer.run_for(TICK_S)
    for _ in range(len(stream) + 2000):
        if min(n.domain_ledger.size for n in nodes) - base >= fed:
            break
        for n in nodes:
            n.service()
        timer.run_for(TICK_S)
    return nodes


def summary(run) -> dict:
    """bench.py gateway_open_loop's result fields from a run."""
    from plenum_tpu_torch.observability.telemetry import TM
    from plenum_tpu_torch.testing.pool import pool_latency_summary
    stats, nodes = run["stats"], run["nodes"]
    ordered = min(n.domain_ledger.size for n in nodes) - run["base_size"]
    snap = run["telemetry"].snapshot()
    e2e = (snap.get("histograms") or {}).get(TM.GATEWAY_E2E_MS) or {}
    dedup_hits = (snap.get("counters") or {}).get(TM.GATEWAY_DEDUP_HITS, 0)
    p50_pool, p99_pool, _ = pool_latency_summary(nodes)
    shed = stats["shed_reads"] + stats["shed_writes"]
    return dict(
        stats, nodes=len(nodes), wall_s=run["wall_s"],
        completed=run["completed"], ordered_writes=ordered,
        dedup_hits=dedup_hits, shed_levels_seen=sorted(run["levels"]),
        gateway_p50_ms=e2e.get("p50"), gateway_p99_ms=e2e.get("p99"),
        gateway_p999_ms=e2e.get("p999"), e2e_samples=e2e.get("count", 0),
        gateway_shed_pct=round(100.0 * shed / max(1, stats["arrivals"]), 2),
        gateway_cache_hit_pct=round(
            100.0 * stats["cache_hits"] / max(1, stats["reads_arrived"]), 2),
        ordered_p50_ms=p50_pool, ordered_p99_ms=p99_pool)


def gate(result: dict) -> List[str]:
    """bench.py gateway_gate's conditions on a summary(): the headline
    fields present, p99 not negative with samples, the percentages in
    [0, 100], and no write shed while reads arrived and none was shed
    (reads degrade first). → the failures."""
    failures = []
    for field in ("gateway_p99_ms", "gateway_p999_ms", "gateway_shed_pct",
                  "gateway_cache_hit_pct"):
        if result.get(field) is None:
            failures.append("%s missing" % field)
    samples = result.get("e2e_samples") or 0
    p99 = result.get("gateway_p99_ms")
    if samples and isinstance(p99, (int, float)) and p99 < 0:
        failures.append("gateway_p99_ms %.3f negative with %d samples"
                        % (p99, samples))
    for field in ("gateway_shed_pct", "gateway_cache_hit_pct"):
        value = result.get(field)
        if isinstance(value, (int, float)) and not 0.0 <= value <= 100.0:
            failures.append("%s %.2f outside [0, 100]" % (field, value))
    if (result.get("shed_writes") or 0) > 0 \
            and (result.get("reads_arrived") or 0) > 0 \
            and (result.get("shed_reads") or 0) == 0:
        failures.append("writes were shed while no read was shed")
    return failures
