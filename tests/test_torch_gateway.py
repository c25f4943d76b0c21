"""The port's gateway tier (plenum_tpu_torch/gateway/) and its hub, in the
shapes of tests/test_gateway.py, on device="cpu":

* the CoalescingVerifierHub built standalone, its SEAM_HUB accounting in
  the injected telemetry hub, its hub_flush / hub_collect spans and
  hub_queue_depth counter in the injected tracer;
* the intake's wire guard (never raises; strikes and sheds structural
  offenders; over-length, garbage entries, non-PROPAGATE sections),
  dedup and the pre-screen;
* the admission ladder's hysteresis (and its levels equal to the JAX
  package's on seeded random walks), live pressure from pool hubs, the
  signed-read cache, check_proof_dict's named failures (the same names
  as the JAX package's on the same proof), the helpers, the lane router
  and the write envelopes (byte-equal to the JAX package's);
* the gateway reads its limits from its own config, not the Config
  class (the JAX package's Gateway builds its sender registry, intake
  and read cache from the class: ROADMAP C);
* one open-loop run through both packages: plenum_tpu_torch.testing.
  gateway_load's schedule (4 BLS nodes, 200 req/s for 1.5 simulated s,
  bench.py's mix and seeds, 4 bad-signature writes, the backlog marks
  lowered so the ladder moves) through the JAX package's Gateway and
  pool and through the port's: every tick's level, admitted writes,
  shed counts, cache hits and signature rejects, the forwarded
  envelopes byte for byte, and the final roots equal; the port's roots
  equal to a fresh pool fed the forwarded stream.

Tolerance: none. The JAX side stays on the host (its gateway verifies
with OpenSSL, its nodes with the "cpu" verifier and hashlib).
"""
import copy
import functools
import random

import msgpack
import pytest

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import (
    MULTI_SIGNATURE, NYM, PROOF_NODES, ROOT_HASH, STATE_PROOF, TARGET_NYM,
    VERKEY)
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.crypto.batch_verifier import (
    CoalescingVerifierHub, ScalarVerifier, TorchBatchVerifier,
    create_verifier)
from plenum_tpu_torch.crypto.signer import SimpleSigner
from plenum_tpu_torch.gateway import (
    ADMIT_ALL, SHED_READS, SHED_WRITES, AdmissionController, Gateway,
    GatewayIntake, SenderRegistry, SignedReadCache, cache_key_for, is_read,
    pack_write_envelopes, plan_write_lanes, route_by_lane, touched_keys_for)
from plenum_tpu_torch.observability.telemetry import (
    SEAM_HUB, TM, TelemetryHub, get_seam_hub)
from plenum_tpu_torch.observability.tracing import Tracer
from plenum_tpu_torch.testing import gateway_load as gl

RATE, SECS, N_BAD = 200.0, 1.5, 4
# backlog marks low enough that the short run climbs the whole ladder
MARKS = dict(GATEWAY_BACKLOG_HIGH=6.0, GATEWAY_BACKLOG_LOW=3.0,
             GATEWAY_BACKLOG_HARD=20.0)
JAX_HOST_CONF = dict(SHA256_BACKEND="scalar", MERKLE_DEVICE_PROOFS=False,
                     EXEC_MERGED_DEVICE_HASH=False, VERIFIER_PROVIDER="cpu")


def _write_req(author, rid, dest=None, verkey=None):
    op = {"type": NYM, TARGET_NYM: dest or author.identifier}
    if verkey is not None:
        op[VERKEY] = verkey
    req = {"identifier": author.identifier, "reqId": rid,
           "protocolVersion": 2, "operation": op}
    req["signature"] = author.sign(dict(req))
    return req


def _read_req(idr, rid, dest):
    return {"identifier": idr, "reqId": rid,
            "operation": {"type": "105", TARGET_NYM: dest}}


def _envelope(msgs, clients=None):
    raw = [msgpack.packb(m, use_bin_type=True) for m in msgs]
    return flat_wire.encode_propagate_envelope(
        raw, clients or ["c%d" % i for i in range(len(msgs))])


def _signed_items(n, bad=()):
    """n (message, signature, verkey) items of one key; the signatures
    at the indices in `bad` have a flipped first byte."""
    signer = SimpleSigner(seed=b"\x5a" * 32)
    out = []
    for i in range(n):
        msg = b"hub item %d" % i
        sig = signer.sign_bytes(msg)
        if i in bad:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        out.append((msg, sig, signer.verraw))
    return out


# ------------------------------------------------------------------ hub


def test_hub_standalone_construction_and_injected_telemetry():
    """The hub builds with every collaborator injected — no Node, no
    process seam hub — and its SEAM_HUB launch accounting lands in the
    injected telemetry hub."""
    tm = TelemetryHub(name="gw-hub-test")
    hub = CoalescingVerifierHub(batch=ScalarVerifier(),
                                scalar=ScalarVerifier(), threshold=2,
                                telemetry=tm)
    assert hub.telemetry is tm
    pending = hub.dispatch(_signed_items(5, bad={3}))
    hub.flush()
    assert pending.collect() == [True, True, True, False, True]
    seams = tm.snapshot()["seams"]
    assert SEAM_HUB in seams and seams[SEAM_HUB]["launches"] == 1
    assert CoalescingVerifierHub(batch=ScalarVerifier()).telemetry \
        is get_seam_hub()


def test_hub_records_flush_and_collect_spans():
    """hub_flush (items, unique) and hub_collect (n) spans on the device
    category, and the hub_queue_depth counter at each dispatch."""
    tracer = Tracer(name="hub")
    hub = CoalescingVerifierHub(batch=ScalarVerifier(), threshold=2,
                                tracer=tracer,
                                telemetry=TelemetryHub(name="t"))
    items = _signed_items(3)
    a = hub.dispatch(items)
    b = hub.dispatch(items[:2])                 # duplicates dedup
    assert a.collect() == [True] * 3 and b.collect() == [True] * 2
    recs = tracer.spans()
    flush = [r for r in recs if r[1] == "hub_flush"]
    collect = [r for r in recs if r[1] == "hub_collect"]
    counters = [r[6] for r in recs if r[1] == "hub_queue_depth"]
    assert [r[0] for r in flush] == ["X"] and flush[0][2] == "device"
    assert flush[0][6] == {"items": 5, "unique": 3}
    assert sorted(r[6]["n"] for r in collect) == [2, 3]
    assert counters == [{"hub_queue_depth": 3}, {"hub_queue_depth": 5}]


def test_torch_hub_provider_takes_tracer_and_telemetry():
    """create_verifier("torch_hub") hands tracer and telemetry to the hub;
    a launch of the kernel (its plain version here) is one SEAM_HUB
    launch of exactly the unique items with its round trip recorded."""
    tm = TelemetryHub(name="t")
    tracer = Tracer(name="hub")
    hub = create_verifier("torch_hub", device="cpu", threshold=2,
                          tracer=tracer, telemetry=tm)
    assert hub.tracer is tracer and hub.telemetry is tm
    assert hub.verify_batch(_signed_items(4, bad={0})) == \
        [False, True, True, True]
    seam = tm.snapshot()["seams"][SEAM_HUB]
    assert seam["launches"] == 1 and seam["useful_rows"] == 4 \
        and seam["lane_rows"] == 4
    assert seam["roundtrip_ms"]["count"] == 1
    assert hub.launches == [(4, 4)]


# --------------------------------------------------------------- intake


def test_intake_never_raises_and_sheds_structural_offenders():
    tm = TelemetryHub(name="intake-adv")
    intake = GatewayIntake(
        verifier=ScalarVerifier(),
        senders=SenderRegistry(strikes=3, telemetry=tm), telemetry=tm)
    good = _envelope([_read_req("idr1", 1, "someone")])
    out = intake.unpack_client(good, "friendly")
    assert len(out) == 1 and out[0][0]["reqId"] == 1
    skew = bytearray(good)
    skew[2] ^= 0x07
    assert intake.unpack_client(bytes(skew), "attacker") is None
    assert intake.unpack_client(good[:-3], "attacker") is None
    assert intake.unpack_client(b"\x00" * 40, "attacker") is None
    assert intake.senders.is_shed("attacker")
    assert intake.unpack_client(good, "attacker") is None
    snap = tm.snapshot()["counters"]
    assert snap[TM.WIRE_MALFORMED] == 3
    assert snap[TM.GATEWAY_SHED_SENDERS] == 1
    out = intake.unpack_client(
        _envelope([_read_req("idr1", 2, "someone")]), "friendly2")
    assert len(out) == 1


def test_intake_over_length_envelope_strikes_sender():
    intake = GatewayIntake(verifier=ScalarVerifier(),
                           senders=SenderRegistry(strikes=1),
                           max_envelope_bytes=64)
    big = _envelope([_read_req("idr1", i, "d" * 40) for i in range(8)])
    assert len(big) > 64
    assert intake.unpack_client(big, "flooder") is None
    assert intake.senders.is_shed("flooder")
    intake2 = GatewayIntake(verifier=ScalarVerifier(),
                            max_envelope_bytes=len(big))
    assert intake2.unpack_client(big, "ok") is not None


def test_intake_entry_garbage_costs_only_that_entry():
    intake = GatewayIntake(verifier=ScalarVerifier())
    good_raw = msgpack.packb(_read_req("idr1", 7, "x"), use_bin_type=True)
    env = flat_wire.encode_propagate_envelope(
        [good_raw, b"\xc1\xff\x00"], ["a", "b"])
    out = intake.unpack_client(env, "mixed")
    assert [m["reqId"] for m, _ in out] == [7]
    assert not intake.senders.is_shed("mixed")
    assert not intake.senders._counts.get("mixed")


def test_intake_non_propagate_section_is_sender_attributable():
    from plenum_tpu_torch.common.messages.node_messages import Commit
    tm = TelemetryHub(name="intake-3pc")
    intake = GatewayIntake(
        verifier=ScalarVerifier(),
        senders=SenderRegistry(strikes=1, telemetry=tm), telemetry=tm)
    env = flat_wire.encode_three_pc(
        [], [], [Commit(instId=0, viewNo=0, ppSeqNo=1)])
    assert intake.unpack_client(env, "sneaky") is None
    assert intake.senders.is_shed("sneaky")


def test_intake_dedup_and_prescreen_rejects_bad_signature():
    tm = TelemetryHub(name="intake-screen")
    intake = GatewayIntake(verifier=ScalarVerifier(), telemetry=tm)
    a = SimpleSigner(seed=b"\x91" * 32)
    b = SimpleSigner(seed=b"\x92" * 32)
    w1 = _write_req(a, 1, verkey=a.verkey)
    w2 = _write_req(b, 1, verkey=b.verkey)
    msgs = intake.fresh_only([(w1, "c1"), (w2, "c2"),
                              (dict(w1), "c1-retry")])
    assert [m["reqId"] for m, _ in msgs] == [1, 1]
    assert intake.fresh_only([(dict(w1), "c1")]) == []
    assert tm.snapshot()["counters"][TM.GATEWAY_DEDUP_HITS] == 2
    forged = dict(w2)
    forged["signature"] = w1["signature"]
    read = _read_req(a.identifier, 9, b.identifier)
    handle = intake.screen_dispatch(
        [(w1, "c1"), (forged, "evil"), (read, "r")])
    intake.screen_flush()
    kept = intake.screen_conclude(handle)
    assert [(m.get("reqId"), c) for m, c in kept] == [(1, "c1"), (9, "r")]
    assert tm.snapshot()["counters"][TM.GATEWAY_SIG_REJECTS] == 1


def test_intake_defaults_to_a_hub_on_its_device():
    """verifier=None builds a CoalescingVerifierHub over the ed25519
    kernel on the intake's device, with the intake's telemetry."""
    tm = TelemetryHub(name="gw")
    intake = GatewayIntake(telemetry=tm, device="cpu")
    hub = intake._verifier
    assert isinstance(hub, CoalescingVerifierHub) and hub.telemetry is tm
    assert isinstance(hub._batch, TorchBatchVerifier)
    assert hub._batch.device.type == "cpu"


# ------------------------------------------------------------ admission


def test_admission_ladder_degrades_reads_first_with_hysteresis():
    conf = Config(GATEWAY_BACKLOG_HIGH=100, GATEWAY_BACKLOG_LOW=50,
                  GATEWAY_BACKLOG_HARD=1000, GATEWAY_P99_HIGH_MS=400.0,
                  GATEWAY_P99_LOW_MS=200.0, GATEWAY_P99_HARD_MS=1200.0)
    ac = AdmissionController(conf)
    assert ac.level == ADMIT_ALL and ac.admits_read() and ac.admits_write()
    assert ac.observe(150, None) == SHED_READS
    assert not ac.admits_read() and ac.admits_write()
    ac.observe(10, None)
    assert ac.level == ADMIT_ALL
    assert ac.observe(0, 500.0) == SHED_READS
    assert ac.observe(2000, None) == SHED_WRITES
    assert not ac.admits_write()
    assert AdmissionController(conf).observe(0, 5000.0) == SHED_WRITES
    assert ac.observe(70, 300.0) == SHED_WRITES
    assert ac.observe(10, 100.0) == SHED_READS
    assert ac.admits_write() and not ac.admits_read()
    assert ac.observe(10, 100.0) == ADMIT_ALL
    assert ac.snapshot() == {"level": "admit_all", "backlog": 10.0,
                             "ordered_p99_ms": 100.0}


@pytest.mark.parametrize("seed", range(3))
def test_admission_ladder_equals_the_jax_packages(seed):
    from plenum_tpu.common.config import Config as JaxConfig
    from plenum_tpu.gateway import AdmissionController as JaxAdmission
    marks = dict(GATEWAY_BACKLOG_HIGH=100, GATEWAY_BACKLOG_LOW=50,
                 GATEWAY_BACKLOG_HARD=1000, GATEWAY_P99_HIGH_MS=400.0,
                 GATEWAY_P99_LOW_MS=200.0, GATEWAY_P99_HARD_MS=1200.0)
    port, ref = AdmissionController(Config(**marks)), \
        JaxAdmission(JaxConfig(**marks))
    rng = random.Random(seed)
    for _ in range(300):
        backlog = rng.choice([0, 20, 60, 99, 100, 150, 999, 1000, 5000])
        p99 = rng.choice([None, 0.0, 150.0, 250.0, 400.0, 800.0, 1300.0])
        assert port.observe(backlog, p99) == ref.observe(backlog, p99)
        assert port.snapshot() == ref.snapshot()
        assert (port.admits_read(), port.admits_write()) == \
            (ref.admits_read(), ref.admits_write())


def test_pump_reads_live_pressure_from_pool_hubs():
    t = [0.0]
    hub1 = TelemetryHub(name="n1", clock=lambda: t[0])
    hub2 = TelemetryHub(name="n2", clock=lambda: t[0])
    conf = Config(GATEWAY_BACKLOG_HIGH=100, GATEWAY_BACKLOG_LOW=50,
                  GATEWAY_BACKLOG_HARD=1000, GATEWAY_P99_HIGH_MS=400.0,
                  GATEWAY_P99_LOW_MS=200.0, GATEWAY_P99_HARD_MS=1200.0)
    gw = Gateway(forward_writes=lambda env: None, config=conf,
                 pool_hubs=lambda: [hub1, hub2], verifier=ScalarVerifier())
    assert gw.pump([], now=0.0).level == "admit_all"
    t[0] = 1.0
    hub1.gauge(TM.BACKLOG_DEPTH, 150)
    assert gw.pump([], now=1.0).level == "shed_reads"
    assert gw.admission.snapshot()["backlog"] == 150.0
    t[0] = 2.0
    hub2.gauge(TM.BACKLOG_DEPTH, 5)
    assert gw.pump([], now=2.0).level == "admit_all"
    for _ in range(50):
        hub1.observe(TM.ORDERED_E2E_MS, 500.0)
    tick = gw.pump([], now=3.0)
    assert tick.level == "shed_reads"
    p99 = gw.admission.snapshot()["ordered_p99_ms"]
    assert p99 is not None and p99 >= 400.0
    t[0] = 3.0
    hub1.gauge(TM.BACKLOG_DEPTH, 5000)
    assert gw.pump([], now=4.0).level == "shed_writes"
    gw.pump([], now=5.0, backlog=0.0, pool_p99_ms=0.0)
    assert gw.admission.snapshot() == {"level": "shed_reads",
                                       "backlog": 0.0,
                                       "ordered_p99_ms": 0.0}
    gw.pump([], now=6.0, backlog=0.0)
    assert gw.admission.snapshot()["ordered_p99_ms"] == pytest.approx(p99)


def test_pump_live_pressure_defaults_to_own_hub():
    tm = TelemetryHub(name="gw")
    conf = Config(GATEWAY_BACKLOG_HIGH=100, GATEWAY_BACKLOG_LOW=50,
                  GATEWAY_BACKLOG_HARD=1000)
    gw = Gateway(forward_writes=lambda env: None, config=conf,
                 telemetry=tm, verifier=ScalarVerifier())
    assert gw.pump([], now=0.0).level == "admit_all"
    tm.gauge(TM.BACKLOG_DEPTH, 2000)
    assert gw.pump([], now=1.0).level == "shed_writes"
    bare = Gateway(forward_writes=lambda env: None, config=conf,
                   verifier=ScalarVerifier())
    assert bare.pump([], now=0.0).level == "admit_all"
    assert bare.admission.snapshot()["ordered_p99_ms"] is None


# ---------------------------------------------------- signed-read cache


def _sp_stub(root, ts):
    return {ROOT_HASH: root, PROOF_NODES: "pn",
            MULTI_SIGNATURE: {"value": {"timestamp": ts}}}


def test_signed_read_cache_verifies_ages_and_pins_roots():
    verdict = {"err": None}
    seen = []

    def check(sp, key, value, ledger_id=None, max_age=None, now=None):
        seen.append((key, value, ledger_id, max_age, now))
        return verdict["err"]

    tm = TelemetryHub(name="cache")
    cache = SignedReadCache(check, fresh_s=30.0, max_entries=2,
                            telemetry=tm)
    r1 = {"data": {"x": 1}, STATE_PROOF: _sp_stub("rootA", 100.0)}
    assert cache.put(1, b"k1", b"v1", r1, now=101.0) is None
    assert seen[-1] == (b"k1", b"v1", 1, 30.0, 101.0)
    assert cache.get(1, b"k1", now=105.0) is r1
    assert cache.get(1, b"k1", now=100.0 + 31.0) is None
    assert len(cache) == 0
    verdict["err"] = "root mismatch: forged"
    assert cache.put(1, b"k1", b"v1", r1, 101.0) == "root mismatch: forged"
    assert len(cache) == 0
    verdict["err"] = None
    assert cache.put(1, b"k", None, {"data": 1}, 0.0) == \
        "no state proof attached"
    assert cache.put(1, b"k", None, {STATE_PROOF: {ROOT_HASH: "r"}},
                     0.0) == "malformed state proof: no usable timestamp/root"
    ra = {STATE_PROOF: _sp_stub("rootA", 100.0)}
    rb = {STATE_PROOF: _sp_stub("rootB", 120.0)}
    assert cache.put(1, b"k1", b"v", ra, 101.0) is None
    assert cache.put(1, b"k2", b"v", rb, 121.0) is None
    assert cache.get(1, b"k1", 122.0) is None
    assert cache.get(1, b"k2", 122.0) is rb
    assert cache.put(1, b"k3", b"v", {STATE_PROOF: _sp_stub("rootB", 121.0)},
                     122.0) is None
    assert cache.put(1, b"k4", b"v", {STATE_PROOF: _sp_stub("rootB", 122.0)},
                     123.0) is None
    assert len(cache) == 2
    counters = tm.snapshot()["counters"]
    assert counters[TM.GATEWAY_CACHE_HITS] >= 2
    assert counters[TM.GATEWAY_CACHE_MISSES] >= 2


# ------------------------------------------------------------- helpers


def test_gateway_helpers_classify_reads_and_cache_keys():
    a = SimpleSigner(seed=b"\x93" * 32)
    read = _read_req(a.identifier, 1, a.identifier)
    write = _write_req(a, 2, verkey=a.verkey)
    assert is_read(read) and not is_read(write)
    key = cache_key_for(read)
    assert key is not None and key[0] == 1
    ts_read = _read_req(a.identifier, 3, a.identifier)
    ts_read["operation"]["timestamp"] = 12345
    assert cache_key_for(ts_read) is None
    assert cache_key_for(write) is None


@functools.lru_cache(maxsize=None)
def _schedule():
    return tuple(gl.schedule(gl.author_signer(), gl.hot_dests(), RATE, SECS,
                             n_bad=N_BAD))


def _schedule_writes():
    return [copy.deepcopy(m) for _, m in _schedule() if not is_read(m)]


def test_lane_router_equals_the_jax_packages():
    """touched_keys_for, plan_write_lanes and route_by_lane give the JAX
    package's answers on the schedule's writes (hot-key updates share a
    lane) and on requests they cannot plan."""
    from plenum_tpu.gateway import lane_router as jax_lr
    writes = _schedule_writes()[:120] + [{"operation": "x"}, {},
                                         {"operation": {"type": NYM}}]
    for m in writes:
        mine, ref = touched_keys_for(m), jax_lr.touched_keys_for(m)
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert (list(mine.reads), list(mine.writes)) == \
                (list(ref.reads), list(ref.writes))
    plan, ref = plan_write_lanes(writes), jax_lr.plan_write_lanes(writes)
    assert list(plan.lanes) == list(ref.lanes)
    assert plan.n_lanes == ref.n_lanes
    routed = route_by_lane(plan)
    assert routed == jax_lr.route_by_lane(ref)
    assert any(len(idx) > 1 for lane, idx in routed if lane >= 0)


def test_write_envelopes_equal_the_jax_packages():
    """The gateway repacks client blobs with the port's codec: the
    envelope equals msgpack.packb(use_bin_type=True)'s (the JAX
    package's) on every request shape of the schedule."""
    from plenum_tpu.gateway import gateway as jax_gw
    from plenum_tpu_torch.gateway.gateway import _Rec
    writes = _schedule_writes()
    admitted = [(m, _Rec("c%d" % (i & 7), 0.0))
                for i, m in enumerate(writes)]
    admitted.append(({"identifier": "x", "reqId": 2 ** 40, "operation": {
        "type": NYM, TARGET_NYM: "d", "raw": b"\x00\xff", "n": -7,
        "f": 0.5, "t": True, "z": None, "l": [1, [2, {"k": "v"}]]}},
        _Rec("c", 0.0)))
    order = route_by_lane(plan_write_lanes([m for m, _ in admitted]))
    assert pack_write_envelopes(admitted, order) == \
        jax_gw.pack_write_envelopes(admitted, order)


def test_gateway_reads_its_limits_from_its_config():
    """The sender strikes and registry size, the envelope limit and the
    read cache's freshness and size come from the gateway's config (the
    JAX package's Gateway reads them from the Config class)."""
    conf = Config(GATEWAY_SENDER_STRIKES=1, GATEWAY_SENDER_REGISTRY_MAX=7,
                  MSG_LEN_LIMIT=64, GATEWAY_CACHE_FRESH_S=12.5,
                  GATEWAY_CACHE_MAX=3)
    gw = Gateway(forward_writes=lambda env: None, config=conf,
                 check_proof=lambda *a, **k: None, verifier=ScalarVerifier())
    assert gw.intake.senders.strikes == 1 != Config.GATEWAY_SENDER_STRIKES
    assert gw.intake.senders.max_senders == 7
    assert gw.intake.max_envelope_bytes == 64
    assert gw.cache.fresh_s == 12.5 and gw.cache.max_entries == 3
    big = _envelope([_read_req("idr1", i, "d" * 40) for i in range(8)])
    gw.pump([(big, "flooder", 0.0)], now=0.0)
    assert gw.intake.senders.is_shed("flooder")    # one strike, shed
    plain = Gateway(forward_writes=lambda env: None,
                    check_proof=lambda *a, **k: None,
                    verifier=ScalarVerifier())
    assert plain.intake.senders.strikes == Config.GATEWAY_SENDER_STRIKES
    assert plain.intake.max_envelope_bytes == Config.MSG_LEN_LIMIT
    assert plain.cache.fresh_s == Config.GATEWAY_CACHE_FRESH_S
    assert plain.cache.max_entries == Config.GATEWAY_CACHE_MAX


# ------------------------------------- one open loop through both packages


def _jax_open_loop():
    """gateway_load's schedule through the JAX package's Gateway and BLS
    pool, driven by gateway_load.drive (which touches only the objects
    it is given). The JAX side stays on the host."""
    from plenum_tpu.bootstrap import node_genesis_txn
    from plenum_tpu.client.client import PoolClient
    from plenum_tpu.client.wallet import Wallet
    from plenum_tpu.common.config import Config as JaxConfig
    from plenum_tpu.common.request import Request
    from plenum_tpu.crypto.batch_verifier import OpenSSLVerifier
    from plenum_tpu.crypto.bls import (
        BlsCryptoSignerPlenum, BlsCryptoVerifierPlenum)
    from plenum_tpu.crypto.signer import SimpleSigner as JaxSigner
    from plenum_tpu.gateway import Gateway as JaxGateway
    from plenum_tpu.observability.telemetry import TelemetryHub as JaxHub
    from plenum_tpu.runtime.sim_random import DefaultSimRandom
    from plenum_tpu.server.node import Node
    from plenum_tpu.testing.mock_timer import MockTimer
    from plenum_tpu.testing.sim_network import SimNetwork

    names = gl.node_names()
    signers = {n: BlsCryptoSignerPlenum.generate(s)[0]
               for n, s in zip(names, gl.bls_seeds())}
    timer = MockTimer()
    timer.set_time(gl.SIM_EPOCH)
    net = SimNetwork(timer, DefaultSimRandom(77), min_latency=0.001,
                     max_latency=0.005)
    conf = JaxConfig(**dict(gl.POOL_CONF, **MARKS, **JAX_HOST_CONF))
    genesis = [node_genesis_txn(
        n, verkey="v%d" % i, node_ip="127.0.0.1", node_port=1,
        client_ip="127.0.0.1", client_port=2, steward_nym="S%d" % i,
        bls_key=signers[n].pk) for i, n in enumerate(names)]
    nodes = [Node(n, names, timer, net.create_peer(n), config=conf,
                  bls_signer=signers[n], genesis_txns=genesis)
             for n in names]
    base = gl.seed_pool(nodes, timer, gl.author_signer(), gl.hot_dests())
    sched = gl.schedule(gl.author_signer(), gl.hot_dests(), RATE, SECS,
                        n_bad=N_BAD)
    wallet = Wallet()
    wallet.add_identifier(signer=JaxSigner(seed=b"\x72" * 32))
    client = PoolClient(wallet, names, send_fn=lambda n, m: None,
                        bls_verifier=BlsCryptoVerifierPlenum(),
                        bls_key_provider=lambda n: signers[n].pk)

    def serve_read(msg, _client):
        try:
            return nodes[0].read_manager.get_result(
                Request.from_dict(dict(msg)))
        except Exception:
            return None

    outbound = []
    gw = JaxGateway(forward_writes=outbound.append, serve_read=serve_read,
                    check_proof=client.check_proof_dict,
                    verifier=OpenSSLVerifier(), config=conf,
                    telemetry=JaxHub(name="gateway"))
    run = gl.drive(nodes, timer, gw, outbound, sched, base)
    run.update(nodes=nodes, client=client, base_size=base)
    return run


@pytest.fixture(scope="module")
def open_loops():
    from plenum_tpu.state import device_state
    warm = device_state.DeviceStateEngine.warm
    device_state.DeviceStateEngine.warm = lambda self: None
    try:
        ref = _jax_open_loop()
    finally:
        device_state.DeviceStateEngine.warm = warm
    # one tick's generation reaches this: one launch of the plain kernel
    hub = CoalescingVerifierHub(batch=TorchBatchVerifier("cpu"),
                                threshold=15)
    port = gl.run_open_loop(device="cpu", rate=RATE, secs=SECS,
                            n_bad=N_BAD, extra_conf=MARKS, feed_p99=False,
                            verifier=hub)
    port["hub"] = hub
    return port, ref


def test_open_loop_ticks_equal_the_jax_packages(open_loops):
    """Every tick's level, admitted writes (reqId, client) in order, shed
    counts, cache hits, signature rejects and replies; the run climbed
    the ladder to shed writes and came back."""
    port, ref = open_loops
    assert port["completed"] and ref["completed"]
    assert port["ticks"] == ref["ticks"]
    assert port["stats"] == ref["stats"]
    assert set(port["levels"]) == {"admit_all", "shed_reads", "shed_writes"}
    assert port["stats"]["cache_hits"] > 0
    assert port["hub"].launches                  # the plain kernel ran


def test_open_loop_forwarded_envelopes_equal_the_jax_packages(open_loops):
    port, ref = open_loops
    assert port["envelopes"] == ref["envelopes"]
    assert sum(map(len, port["envelopes"])) > 10


@pytest.mark.parametrize("which", ["domain", "audit", "state"])
def test_open_loop_roots_equal_the_jax_packages(open_loops, which):
    port, ref = open_loops

    def roots(nodes):
        if which == "domain":
            return [n.domain_ledger.root_hash for n in nodes]
        if which == "audit":
            return [n.audit_ledger.root_hash for n in nodes]
        return [bytes(n.db_manager.get_state(1).committedHeadHash)
                for n in nodes]
    mine = roots(port["nodes"])
    assert len(set(mine)) == 1
    assert mine == roots(ref["nodes"])


def test_open_loop_bad_signatures_rejected_and_never_written(open_loops):
    port, _ = open_loops
    written = {txn["txn"]["metadata"]["reqId"]
               for _, txn in port["nodes"][0].domain_ledger.getAllTxn()}
    assert not written & set(range(gl.BAD_REQ_ID, gl.BAD_REQ_ID + N_BAD))
    screened = port["stats"]["sig_rejects"]
    assert 0 < screened <= N_BAD
    assert sum(t["sig_rejects"] for t in port["ticks"]) == screened
    assert len(written) == port["base_size"] \
        + port["stats"]["admitted_writes"]


def test_open_loop_roots_equal_a_pool_fed_the_forwarded_stream(open_loops):
    port, _ = open_loops
    stream = gl.forwarded_stream(port)
    admitted = [sorted(t["admitted"]) for t in port["ticks"]]
    assert [sorted((m["reqId"], c) for m, c in b) for b in stream] == \
        admitted
    replay = gl.replay_pool(stream, device="cpu", extra_conf=MARKS)
    for a, b in zip(port["nodes"], replay):
        assert a.domain_ledger.root_hash == b.domain_ledger.root_hash
        assert a.db_manager.get_state(1).committedHeadHash == \
            b.db_manager.get_state(1).committedHeadHash


def test_open_loop_summary_passes_the_gate(open_loops):
    port, _ = open_loops
    result = gl.summary(port)
    assert gl.gate(result) == []
    assert result["e2e_samples"] > 0 and result["gateway_p999_ms"] >= 0
    assert result["shed_reads"] > 0 and result["shed_writes"] > 0


def _proof_checks(client, sp, key, value):
    """check_proof_dict's verdict on the honest proof and on each way to
    break it (tests/test_gateway.py's list)."""
    from plenum_tpu_torch.common.serializers.base58 import b58encode
    out = [client.check_proof_dict(sp, key, value),
           client.check_proof_dict(None, key, value),
           client.check_proof_dict({ROOT_HASH: sp[ROOT_HASH],
                                    PROOF_NODES: sp[PROOF_NODES]},
                                   key, value)]
    bad_ms = copy.deepcopy(sp)
    bad_ms[MULTI_SIGNATURE] = {"garbage": 1}
    wrong_root = copy.deepcopy(sp)
    wrong_root[ROOT_HASH] = b58encode(b"\x37" * 32)
    dup = copy.deepcopy(sp)
    dup[MULTI_SIGNATURE]["participants"][-1] = \
        dup[MULTI_SIGNATURE]["participants"][0]
    thin = copy.deepcopy(sp)
    thin[MULTI_SIGNATURE]["participants"] = \
        thin[MULTI_SIGNATURE]["participants"][:1]
    stranger = copy.deepcopy(sp)
    stranger[MULTI_SIGNATURE]["participants"][0] = "NodeX"
    forged = copy.deepcopy(sp)
    forged[MULTI_SIGNATURE]["signature"] = \
        forged[MULTI_SIGNATURE]["signature"][:-4] + "1111"
    mangled = copy.deepcopy(sp)
    mangled[PROOF_NODES] = "!!!not-a-proof!!!"
    ts = sp[MULTI_SIGNATURE]["value"]["timestamp"]
    for bad in (bad_ms, wrong_root, dup, thin, stranger, forged, mangled):
        out.append(client.check_proof_dict(bad, key, value))
    out += [client.check_proof_dict(sp, key, value, ledger_id=0),
            client.check_proof_dict(sp, key, value, max_age=300,
                                    now=ts + 10),
            client.check_proof_dict(sp, key, value, max_age=300,
                                    now=ts + 10000),
            client.check_proof_dict(sp, key, b"forged-value"),
            client.check_proof_dict(sp, key, None)]
    return out


def test_check_proof_dict_names_each_failed_check(open_loops):
    """A GET_NYM reply of the open loop's pool and every way to break its
    proof: each failure names its check, in the JAX package's words on
    the JAX pool's reply (the same root: the pools are equal)."""
    from plenum_tpu.common.request import Request as JaxRequest
    from plenum_tpu_torch.client.client import PoolClient
    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.state_codec import (
        encode_state_value, nym_to_state_key)
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
    port, ref = open_loops
    dest = gl.hot_dests()[0]
    read = _read_req(gl.author_signer().identifier, 77, dest)
    result = port["nodes"][0].read_manager.get_result(
        Request.from_dict(dict(read)))
    ref_result = ref["nodes"][0].read_manager.get_result(
        JaxRequest.from_dict(dict(read)))
    signers = {n: s for n, s in zip(
        gl.node_names(), [__import__(
            "plenum_tpu_torch.crypto.bls", fromlist=["x"])
            .BlsCryptoSignerPlenum.generate(seed)[0]
            for seed in gl.bls_seeds()])}
    wallet = Wallet()
    wallet.add_identifier(signer=SimpleSigner(seed=b"\x84" * 32))
    client = PoolClient(wallet, list(signers), send_fn=lambda n, m: None,
                        bls_verifier=BlsCryptoVerifierPlenum(),
                        bls_key_provider=lambda n: signers[n].pk)
    key = nym_to_state_key(result["dest"])
    value = encode_state_value(result["data"], result["seqNo"],
                               result["txnTime"])
    got = _proof_checks(client, result["state_proof"], key, value)
    want = _proof_checks(ref["client"], ref_result["state_proof"], key,
                         value)
    assert got == want
    assert got[0] is None and got[-4] is None
    assert got[1] == "malformed state proof: not a dict with a " \
                     "multi-signature"
    assert got[5] == "multi-sig invalid: duplicate participants"
    assert got[7] == "multi-sig invalid: unregistered signer 'NodeX'"
    assert all(g for g in got[1:-4] + got[-3:])
    plain = PoolClient(wallet, list(signers), send_fn=lambda n, m: None)
    assert plain.check_proof_dict(result["state_proof"], key, value) == \
        "no BLS verifier/keys configured"
    assert client.verify_proof_dict(result["state_proof"], key, value)
    assert not client.verify_proof_dict(result["state_proof"], key,
                                        b"forged-value")
