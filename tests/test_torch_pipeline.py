"""The port's pipeline runtime (plenum_tpu_torch/runtime/pipeline.py) and
its Node wiring, in the shapes of tests/test_pipeline.py, on device="cpu":

* unit — the bounded queue (FIFO, close, back-pressure), the worker
  sizing rule, the positive-only pre-screen cache, drain order, a worker
  exception delivered to the prod thread, the dead-worker step-down,
  the order-preserving execution map and exec_fanout (equal to the JAX
  package's), the merged state flush fanned across that map, the
  authenticator's pre-screen, and the ordering intake's owner guard;
* against the JAX package — bench.py's `_pipeline_parity_roots` pool
  (4 nodes, fixed latency, 12 NYMs, Max3PCBatchSize 5, flat wire) with
  the pipeline on and off and the sanitizer armed: domain, audit and
  state roots byte-equal on every node, across both packages and both
  modes; the adversarial injection stream of tests/test_pipeline.py at
  seeds 0-2, equal across both packages; the view-change drain; and
  complete causal journeys with the pipeline on;
* the pipelined pool's kernels (plain versions here) run on the prod
  thread only, never on the parse worker or the execution pool.

Tolerance: none. The JAX side runs on the host (scalar SHA-256, the
"cpu" verifier, host state hashing): no XLA program, no Pallas kernel.
"""
import importlib
import os
import random
import threading
import time

import pytest

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import (
    ViewChangeStarted)
from plenum_tpu_torch.common.messages.node_messages import (
    Commit, FlatBatch, Prepare)
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.serializers.base58 import b58encode
from plenum_tpu_torch.runtime.pipeline import (
    BoundedQueue, NodePipeline, PrescreenCache, resolve_queue_depth,
    resolve_workers)

NAMES = ["Alpha", "Beta", "Gamma", "Delta"]
SIM_EPOCH = 1600000000
ROOT58 = b58encode(b"\x11" * 32)
# the JAX package's nodes stay on the host: no XLA program runs
JAX_HOST_CONF = dict(SHA256_BACKEND="scalar", MERKLE_DEVICE_PROOFS=False,
                     EXEC_MERGED_DEVICE_HASH=False, VERIFIER_PROVIDER="cpu")


# ------------------------------------------------------------------ unit


def test_bounded_queue_fifo_and_close():
    q = BoundedQueue(8)
    for i in range(5):
        q.put(i)
    assert len(q) == 5
    assert [q.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    assert q.get(timeout=0.01) is None          # empty + timeout
    q.close()
    assert q.get() is None                      # closed, no block


def test_bounded_queue_backpressure_blocks_producer():
    """put() on a full queue blocks until the consumer drains."""
    q = BoundedQueue(2)
    q.put("a")
    q.put("b")
    got = []

    def consume():
        time.sleep(0.05)
        got.append(q.get())

    t = threading.Thread(target=consume)
    t.start()
    t0 = time.perf_counter()
    q.put("c")                       # full: must wait for the consumer
    waited = time.perf_counter() - t0
    t.join()
    assert got == ["a"]
    assert waited >= 0.02
    assert [q.get(), q.get()] == ["b", "c"]


def test_resolve_workers_single_rule():
    assert resolve_workers(3) == 3
    assert resolve_workers(0) == 1
    assert resolve_workers(None, fallback=1) == 1
    assert resolve_workers(2, fallback=1) == 2
    cores = os.cpu_count() or 1
    assert resolve_workers() == max(1, min(4, cores - 1))
    assert resolve_queue_depth() == 256
    assert resolve_queue_depth(0) == 1


def test_prescreen_cache_exact_triple_only():
    c = PrescreenCache()
    c.add(b"ser", b"sig", b"vk")
    assert c.check((b"ser", b"sig", b"vk"))
    assert not c.check((b"ser", b"sig", b"vk2"))
    assert not c.check((b"ser", b"sig2", b"vk"))
    assert not c.check(None)
    assert not c.check((b"ser",))


def test_prescreen_cache_wholesale_eviction():
    c = PrescreenCache(max_entries=4)
    for i in range(4):
        c.add(b"s%d" % i, b"g", b"v")
    assert len(c) == 4
    c.add(b"s4", b"g", b"v")
    assert len(c) == 1
    assert c.check((b"s4", b"g", b"v"))
    assert not c.check((b"s0", b"g", b"v"))


def _make_pipeline(delivered, workers=2, depth=8):
    conf = Config(PIPELINE_WORKERS=workers, PIPELINE_QUEUE_DEPTH=depth)
    return NodePipeline(
        lambda job: delivered.append((job.msg, job.result, job.error)),
        config=conf)


def test_drain_delivers_in_submission_order():
    delivered = []
    pipe = _make_pipeline(delivered)
    try:
        pipe.submit(lambda: "r0", "m0", "A")
        pipe.submit(None, "m1", "B")
        pipe.submit(lambda: "r2", "m2", "C")
        assert pipe.depth == 3
        assert pipe.drain() == 3
        assert pipe.depth == 0
        assert delivered == [("m0", "r0", None), ("m1", None, None),
                             ("m2", "r2", None)]
    finally:
        pipe.stop()


def test_worker_exception_is_delivered_not_raised():
    delivered = []
    pipe = _make_pipeline(delivered)
    try:
        boom = ValueError("bad envelope")
        pipe.submit(lambda: (_ for _ in ()).throw(boom), "m", "A")
        pipe.drain()
        assert len(delivered) == 1
        assert delivered[0][2] is boom
    finally:
        pipe.stop()


def test_dead_worker_steps_down_to_inline_parse():
    delivered = []
    pipe = _make_pipeline(delivered)
    pipe.stop()
    pipe._worker.join(timeout=2)
    assert not pipe._worker.is_alive()
    pipe.submit(lambda: "inline", "m", "A")
    assert pipe.drain() == 1
    assert delivered == [("m", "inline", None)]


def test_exec_map_preserves_order():
    pipe = _make_pipeline([], workers=3)
    try:
        assert pipe.exec_map(lambda x: x * 2, range(7)) == \
            [0, 2, 4, 6, 8, 10, 12]
        assert pipe.exec_map(lambda x: x + 1, [41]) == [42]  # inline
    finally:
        pipe.stop()


@pytest.mark.parametrize("n_states,workers", [
    (0, None), (1, None), (8, 3), (2, 3), (5, 1), (3, None)])
def test_exec_fanout_equals_the_jax_packages(n_states, workers):
    from plenum_tpu.server.execution_lanes import exec_fanout as jax_fanout
    from plenum_tpu_torch.server.execution_lanes import exec_fanout
    assert exec_fanout(n_states, workers) == jax_fanout(n_states, workers)


def test_exec_fanout_sizing():
    from plenum_tpu_torch.server.execution_lanes import exec_fanout
    assert exec_fanout(0) == 1
    assert exec_fanout(1) == 1
    assert exec_fanout(8, workers=3) == 3
    assert exec_fanout(2, workers=3) == 2


def _states(n, writes):
    from plenum_tpu_torch.state.pruning_state import PruningState
    from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
    states = [PruningState(KeyValueStorageInMemory()) for _ in range(n)]
    for i, st in enumerate(states):
        for k in range(writes):
            st.set(b"key-%d-%d" % (i, k), b"value-%d" % (i * k))
    return states


def test_flush_states_merged_fans_host_states_across_the_map():
    """Host-path states cross the execution map, their roots equal the
    serial flush's; a state with no pending write stays out of it."""
    from plenum_tpu_torch.state.pruning_state import flush_states_merged
    serial = _states(3, 6)
    flush_states_merged(serial)
    fanned = _states(3, 6) + _states(1, 0)
    mapped = []

    def exec_map(fn, items):
        mapped.append(len(items))
        return [fn(x) for x in items]

    flush_states_merged(fanned, exec_map=exec_map)
    assert mapped == [3]
    assert [s.headHash for s in fanned[:3]] == [s.headHash for s in serial]


def test_authenticator_prescreen_skips_cached_and_warms_on_verify():
    """A cached positive skips the verify; a miss verifies and warms the
    cache; a rotated verkey (another triple) misses."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.batch_verifier import ScalarVerifier
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.server.client_authn import CoreAuthNr
    from plenum_tpu_torch.testing.pool import make_requests

    calls = []

    class Counting(ScalarVerifier):
        def verify_batch(self, items):
            calls.append(len(items))
            return super().verify_batch(items)

    cache = PrescreenCache()
    authnr = CoreAuthNr(verifier=Counting(), prescreen=cache)
    signer = SimpleSigner(seed=b"\x61" * 32)
    authnr.addIdr(signer.identifier, signer.verkey)
    req = Request(**make_requests(1, signer)[0])
    assert authnr.authenticate(req) == [signer.identifier]
    assert calls == [1] and len(cache) == 1
    assert authnr.authenticate(req) == [signer.identifier]
    assert calls == [1]                          # the cached positive
    other = CoreAuthNr(verifier=Counting())
    other.set_prescreen(cache)
    other.addIdr(signer.identifier,
                 SimpleSigner(seed=b"\x62" * 32).verkey)
    with pytest.raises(Exception):
        other.authenticate(req)                  # another triple: verifies
    assert calls == [1, 1]
    handle = authnr.dispatch_batch(
        [Request(**r) for r in make_requests(2, signer, first_req_id=5)])
    assert authnr.conclude_batch(handle) == [[signer.identifier]] * 2
    assert len(cache) == 3                       # warmed from the batch


def test_ordering_intake_owner_guard():
    """bind_owner_thread turns prod-thread ownership of 3PC intake into
    a hard RuntimeError off that thread."""
    node = _pool("plenum_tpu_torch", Config(), 1)[0][0]
    o = node.replica.ordering
    o.bind_owner_thread(threading.get_ident())
    o.process_commit_batch([], "Gamma")
    errs = []

    def off_thread():
        try:
            o.process_commit_batch(
                [Commit(instId=0, viewNo=0, ppSeqNo=1)], "Gamma")
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=off_thread)
    t.start()
    t.join()
    assert len(errs) == 1
    assert "prod thread" in str(errs[0])


# ------------------------------------------- pools of either package


def _pkg(name):
    """The classes a sim pool needs, from the port or the JAX package."""
    mod = lambda m: importlib.import_module(name + "." + m)  # noqa: E731
    return {"Node": mod("server.node").Node,
            "Config": mod("common.config").Config,
            "MockTimer": mod("testing.mock_timer").MockTimer,
            "SimNetwork": mod("testing.sim_network").SimNetwork,
            "Random": mod("runtime.sim_random").DefaultSimRandom,
            "Signer": mod("crypto.signer").SimpleSigner}


def _conf(name, **over):
    extra = dict(JAX_HOST_CONF) if name == "plenum_tpu" else {}
    extra.update(over)
    return _pkg(name)["Config"](**extra)


def _pool(name, conf, n_nodes=4, net_seed=77, latency=0.003):
    """4 Nodes of package `name` on SimNetwork (fixed latency) and
    MockTimer; the port's on device="cpu"."""
    p = _pkg(name)
    timer = p["MockTimer"]()
    timer.set_time(SIM_EPOCH)
    kw = dict(min_latency=latency, max_latency=latency) if latency else {}
    net = p["SimNetwork"](timer, p["Random"](net_seed), **kw)
    node_kw = {"device": "cpu"} if name == "plenum_tpu_torch" else {}
    nodes = [p["Node"](n, NAMES, timer, net.create_peer(n), config=conf,
                       **node_kw) for n in NAMES[:n_nodes]]
    return nodes, timer


def _stop(nodes):
    for n in nodes:
        if n._pipeline is not None:
            n._pipeline.stop()


def _roots(nodes):
    out = []
    for n in nodes:
        state = n.db_manager.get_state(1)
        out.append((n.domain_ledger.root_hash, n.audit_ledger.root_hash,
                    bytes(state.committedHeadHash).hex()))
    return out


@pytest.fixture(scope="module")
def jax_warm_off():
    """The JAX package's state engine compiles nothing at attach."""
    from plenum_tpu.state import device_state
    warm = device_state.DeviceStateEngine.warm
    device_state.DeviceStateEngine.warm = lambda self: None
    yield
    device_state.DeviceStateEngine.warm = warm


def _parity_roots(name, pipeline, sanitizer):
    """bench.py `_pipeline_parity_roots`: 12 NYMs on a 4-node
    fixed-latency pool, Max3PCBatchSize 5, flat wire. → every node's
    (domain, audit, state) roots."""
    import bench
    conf = _conf(name, Max3PCBatchSize=5, Max3PCBatchWait=0.2,
                 FLAT_WIRE=True, PIPELINE_ENABLED=pipeline,
                 SANITIZER_ENABLED=sanitizer)
    nodes, timer = _pool(name, conf)
    assert (nodes[0]._pipeline is not None) == pipeline
    n_reqs = 12
    signer = _pkg(name)["Signer"](seed=b"\x71" * 32)
    for req in bench.make_requests(n_reqs, signer):
        for nd in nodes:
            nd.process_client_request(dict(req), "parity-client")
    for _ in range(400):
        for nd in nodes:
            nd.service()
        timer.run_for(0.01)
        if all(nd.domain_ledger.size >= n_reqs for nd in nodes):
            break
    _stop(nodes)
    assert all(nd.domain_ledger.size == n_reqs for nd in nodes)
    return _roots(nodes)


@pytest.fixture(scope="module")
def parity(jax_warm_off):
    return {(name, pipeline): _parity_roots(name, pipeline, True)
            for name in ("plenum_tpu", "plenum_tpu_torch")
            for pipeline in (True, False)}


@pytest.mark.parametrize("pipeline", [True, False])
def test_parity_roots_equal_the_jax_packages(parity, pipeline):
    """Every node's domain, audit and state roots, pipeline on and off
    with the sanitizer armed, byte-equal to the JAX package's."""
    port = parity[("plenum_tpu_torch", pipeline)]
    assert len(set(port)) == 1
    assert port == parity[("plenum_tpu", pipeline)]


def test_pipeline_on_off_byte_equal_roots(parity):
    assert parity[("plenum_tpu_torch", True)] == \
        parity[("plenum_tpu_torch", False)]


def _pool_snapshot(node, suspicions):
    """Observable consensus state of one pool node (test_pipeline.py's
    snapshot)."""
    o = node.replica.ordering
    stashes = {}
    for (typ, code), stash in o._stasher._stashes.items():
        items = sorted(repr(item) for item in stash)
        if items:
            stashes[(typ.__name__, code)] = items
    return {
        "prepares": {k: {s: p.digest for s, p in v.items()}
                     for k, v in o.prepares.items() if v},
        "commits": {k: sorted(v) for k, v in o.commits.items() if v},
        "prepare_count": {k: v for k, v in o._prepare_vote_count.items()
                          if v},
        "commit_count": {k: v for k, v in o._commit_vote_count.items()
                         if v},
        "ordered": sorted(o.ordered),
        "stashes": stashes,
        "suspicions": sorted(
            (s.ex.code, s.ex.node) for s in suspicions),
        "suspicion_counts": dict(node.blacklister.suspicion_counts),
        "blacklisted": sorted(node.blacklister.blacklisted),
        "view_no": node.replica.data.view_no,
        "last_ordered": node.replica.data.last_ordered_3pc,
    }


def _adversarial_payloads(rng):
    """test_pipeline.py's injection stream, as raw flat-wire bytes (the
    port's encoder; the bytes are the same in both packages)."""
    def prep(view, seq, digest):
        return Prepare(instId=0, viewNo=view, ppSeqNo=seq,
                       ppTime=1600000000, digest=digest,
                       stateRootHash=ROOT58, txnRootHash=ROOT58)

    payloads = [
        bytes([rng.randrange(256) for _ in range(40)]),
        flat_wire.encode_three_pc(
            [], [prep(0, 1, "forged-" + "f" * 20)], []),
        flat_wire.encode_three_pc([], [prep(3, 1, "d" * 8)], []),
        flat_wire.encode_three_pc(
            [], [], [Commit(instId=0, viewNo=0, ppSeqNo=10 ** 6)]),
        flat_wire.encode_three_pc(
            [], [], [Commit(instId=5, viewNo=0, ppSeqNo=1)]),
    ]
    rng.shuffle(payloads)
    return payloads


def _run_adversarial_pool(name, pipeline, seed, n_reqs=10):
    """test_pipeline.py's `_run_adversarial_pool` on package `name`."""
    from plenum_tpu_torch.common.constants import NYM, TARGET_NYM, VERKEY
    bus = importlib.import_module(name + ".common.messages.internal_messages")
    fb = importlib.import_module(name + ".common.messages.node_messages")
    conf = _conf(name, Max3PCBatchSize=5, Max3PCBatchWait=0.2,
                 FLAT_WIRE=True, PIPELINE_ENABLED=pipeline)
    nodes, timer = _pool(name, conf)
    sus = {n.name: [] for n in nodes}
    for n in nodes:
        n.replica.internal_bus.subscribe(
            bus.RaisedSuspicion, lambda m, _s=sus[n.name]: _s.append(m))
    signer = _pkg(name)["Signer"](seed=b"\x33" * 32)
    for i in range(n_reqs):
        dest = "adv-%06d" % i + "x" * 12
        req = {"identifier": signer.identifier, "reqId": i + 1,
               "protocolVersion": 2,
               "operation": {"type": NYM, TARGET_NYM: dest,
                             VERKEY: "~" + dest[:22]}}
        req["signature"] = signer.sign(dict(req))
        for n in nodes:
            n.process_client_request(dict(req), "adv-client")
    rng = random.Random(seed)
    inject_steps = sorted(rng.sample(range(1, 30), 4))
    for step in range(400):
        if step in inject_steps:
            for i, n in enumerate(nodes):
                frm = NAMES[(i + 1) % len(NAMES)]
                for payload in _adversarial_payloads(
                        random.Random(seed * 1000 + step)):
                    n.network.process_incoming(
                        fb.FlatBatch(payload=payload), frm)
        for n in nodes:
            n.service()
        timer.run_for(0.01)
        if step > max(inject_steps) \
                and all(n.domain_ledger.size >= n_reqs for n in nodes):
            break
    _stop(nodes)
    assert all(n.domain_ledger.size == n_reqs for n in nodes)
    seq = [txn["txn"]["data"]["dest"]
           for _, txn in nodes[0].domain_ledger.getAllTxn()]
    snaps = {n.name: _pool_snapshot(n, sus[n.name]) for n in nodes}
    return _roots(nodes), seq, snaps


@pytest.mark.parametrize("seed", range(3))
def test_adversarial_stream_equals_the_jax_packages(jax_warm_off, seed):
    """Byte-equal roots, ordered sequence and per-node suspicion /
    stash / vote-store snapshots: the port with the pipeline on against
    the JAX package with it on, and the port with it off."""
    port_on = _run_adversarial_pool("plenum_tpu_torch", True, seed)
    jax_on = _run_adversarial_pool("plenum_tpu", True, seed)
    port_off = _run_adversarial_pool("plenum_tpu_torch", False, seed)
    assert port_on == jax_on
    assert port_on == port_off
    assert any(s["suspicion_counts"] for s in port_on[2].values())


def test_view_change_drains_pipeline_mid_stream():
    """ViewChangeStarted on the internal bus drains every queued job
    before the view change proceeds."""
    conf = Config(Max3PCBatchSize=5, Max3PCBatchWait=0.2, FLAT_WIRE=True,
                  PIPELINE_ENABLED=True)
    nodes, _ = _pool("plenum_tpu_torch", conf, latency=None, net_seed=7)
    node = nodes[0]
    try:
        assert node._pipeline is not None
        payload = flat_wire.encode_three_pc(
            [], [], [Commit(instId=0, viewNo=0, ppSeqNo=10 ** 6)])
        node.network.process_incoming(FlatBatch(payload=payload), "Beta")
        assert node._pipeline.depth >= 1
        node.replica.internal_bus.send(ViewChangeStarted(view_no=1))
        assert node._pipeline.depth == 0
    finally:
        _stop(nodes)


def _traced_report(name):
    """test_journey.py's traced pool (3 requests from three clients,
    flat wire, trace context) with the pipeline on; → the journey
    report."""
    import tests.test_node_e2e as e2e
    journey = importlib.import_module(name + ".observability.journey")
    export = importlib.import_module(name + ".observability.export")
    conf = _conf(name, Max3PCBatchSize=5, Max3PCBatchWait=0.2, CHK_FREQ=5,
                 LOG_SIZE=15, TRACING_ENABLED=True,
                 TRACE_CONTEXT_ENABLED=True, PIPELINE_ENABLED=True)
    nodes, timer = _pool(name, conf, latency=None, net_seed=19)
    for i in range(3):
        client = _pkg(name)["Signer"](seed=bytes([0x41 + i]) * 32)
        req = e2e.signed_nym_request(client, req_id=500 + i)
        for n in nodes:
            n.process_client_request(dict(req), "client1")
        e2e.pump(timer, nodes, 2)
    e2e.pump(timer, nodes, 6)
    _stop(nodes)
    assert all(n.domain_ledger.size == 3 for n in nodes)
    return journey.journeys_from_tracers(export.pool_tracers(nodes)), \
        journey


@pytest.mark.parametrize("name", ["plenum_tpu_torch", "plenum_tpu"])
def test_journeys_stay_complete_with_pipeline_on(jax_warm_off, name):
    """The worker-side parse keeps the wire stamps: every request's
    journey is complete, causally ordered, with its propagate closer
    and its batch's critical path named."""
    report, journey = _traced_report(name)
    assert not report["degraded"]
    assert report["complete_requests"] == 3
    assert journey.causal_violations(report) == []
    for r in report["requests"].values():
        assert r["intake"] is not None
        assert r["propagate_close"]["closer"]
        assert r["batch"] in report["batches"]
    for b in report["batches"].values():
        assert b["critical_path"]["node"]


def test_pipelined_pool_launches_kernels_on_the_prod_thread_only(
        monkeypatch):
    """A pipelined pool with the sanitizer armed and its floors lowered
    runs every kernel's plain version, each on the thread that services
    the nodes, never on the parse worker or the execution pool; its
    roots equal the serial pool's."""
    from plenum_tpu_torch.crypto.batch_verifier import create_verifier
    from plenum_tpu_torch.ops import ed25519, sha256, sha3
    from plenum_tpu_torch.testing import pool

    threads = []
    for mod, fn in ((ed25519, "verify_plain"),
                    (sha256, "sha256_ragged_plain"),
                    (sha3, "sha3_ragged_plain")):
        real = getattr(mod, fn)

        def wrapped(*a, _real=real, _fn=fn):
            threads.append((_fn, threading.get_ident()))
            return _real(*a)
        monkeypatch.setattr(mod, fn, wrapped)

    def run(pipeline, floor):
        conf = Config(Max3PCBatchSize=4, Max3PCBatchWait=0.2, CHK_FREQ=5,
                      LOG_SIZE=15, FLAT_WIRE=True, PIPELINE_ENABLED=pipeline,
                      SANITIZER_ENABLED=True, PIPELINE_WORKERS=3,
                      SHA256_BATCH_THRESHOLD=floor,
                      STATE_DEVICE_HASH_FLOOR=floor,
                      STATE_DEVICE_BATCH_MIN=floor,
                      VERIFIER_BATCH_THRESHOLD=floor)
        nodes, timer = _pool("plenum_tpu_torch", conf, latency=None)
        hub = create_verifier("torch_hub", device="cpu", threshold=floor)
        for n in nodes:
            n.authnr._verifier = hub
        reqs = pool.make_requests(8, _pkg("plenum_tpu_torch")["Signer"](
            seed=b"\x52" * 32))
        pool.pipelined_intake(nodes, timer, [reqs[:4], reqs[4:]], "c")
        _stop(nodes)
        assert all(n.domain_ledger.size == 8 for n in nodes)
        return _roots(nodes)

    on = run(True, 2)
    assert {fn for fn, _ in threads} == {
        "verify_plain", "sha256_ragged_plain", "sha3_ragged_plain"}
    assert {t for _, t in threads} == {threading.get_ident()}
    # the serial pool on the host floors: the same roots
    assert on == run(False, 10 ** 6)
