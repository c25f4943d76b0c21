"""The gateway proper — glue from intake to pool (port of
plenum_tpu/gateway/gateway.py).

One ``pump()`` per service tick takes the tick's raw client envelopes
and runs the full front-door pipeline:

    admission.observe ──┐
    unpack_client ──────┤  (wire guard: strikes/shedding per sender)
    fresh_only ─────────┤  (dedup before any signature work)
    split reads/writes ─┤
    reads:  cache → serve → put   (shed FIRST under pressure;
                                   cache hits always served)
    writes: screen → lane-route → pack → forward
                                  (shed only past the HARD marks)

The gateway owns no consensus state and holds no keys the pool trusts:
``forward_writes`` delivers packed PROPAGATE envelopes to nodes that
re-authenticate everything (``Node.process_gateway_envelope``), and
``serve_read`` returns proof-bearing results the cache re-verifies
before storing. A compromised gateway can therefore deny service but
never forge admission or serve an unproven read.

Time is injected (``now`` plus per-envelope arrival stamps) — the
gateway is clock-free and deterministic for a given arrival schedule,
which is what lets a load generator run it open-loop on a mock timer
(testing/gateway_load.py).

Every limit comes from the gateway's ``config``: the admission marks,
and also the sender strikes and registry size, the envelope limit
(``MSG_LEN_LIMIT``) and the read cache's freshness and size, which the
JAX package's Gateway reads from the Config class.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.serializers.msgpack_codec import packb
from plenum_tpu_torch.gateway.admission import AdmissionController, _cfg
from plenum_tpu_torch.gateway.intake import GatewayIntake, SenderRegistry
from plenum_tpu_torch.gateway.lane_router import plan_write_lanes, route_by_lane
from plenum_tpu_torch.gateway.read_cache import SignedReadCache
from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub

# read op types the gateway recognizes (mirrors the pool's registered
# ReadRequestHandlers; anything unrecognized is treated as a write and
# settled by the pool's own validation)
GET_NYM_TYPE = "105"
READ_TYPES = frozenset({GET_NYM_TYPE, "3", "6", "7", "10"})

_UNCACHEABLE = object()   # leaf_value_for failed: serve, don't cache


class _Rec:
    """One in-flight request: the parsed dict plus the routing facts
    the intake treats as opaque (client id, arrival stamp)."""
    __slots__ = ("client", "arrived")

    def __init__(self, client: str, arrived: float):
        self.client = client
        self.arrived = arrived


class GatewayTick:
    """What one pump() did — counts plus the admitted/answered work,
    so tests can replay the admitted stream against a gateway-less
    pool and assert byte-equal roots."""

    def __init__(self):
        self.admitted_writes: List[Tuple[dict, str]] = []
        self.replies: List[Tuple[str, dict]] = []
        self.shed_reads = 0
        self.shed_writes = 0
        self.cache_hits = 0
        self.sig_rejects = 0
        self.level = "admit_all"


def is_read(msg: dict) -> bool:
    op = msg.get("operation") if isinstance(msg, dict) else None
    return isinstance(op, dict) and op.get("type") in READ_TYPES


def cache_key_for(msg: dict) -> Optional[Tuple[int, bytes]]:
    """(ledger_id, state_key) for reads the cache can serve: current-
    state GET_NYM only. Timestamped (state-at-a-time) reads bypass the
    cache — their answer depends on the asked-for time, not the newest
    signed root."""
    from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID, TARGET_NYM
    from plenum_tpu_torch.common.state_codec import nym_to_state_key
    op = msg.get("operation")
    if not isinstance(op, dict) or op.get("type") != GET_NYM_TYPE \
            or op.get("timestamp") is not None:
        return None
    dest = op.get(TARGET_NYM)
    if not isinstance(dest, str) or not dest:
        return None
    return (DOMAIN_LEDGER_ID, nym_to_state_key(dest))


def leaf_value_for(result: dict) -> Optional[bytes]:
    """The state-trie leaf bytes a GET_NYM result claims — the same
    (data, seqNo, txnTime) re-encode the client does before checking
    the proof, so the cache verifies the value it will later serve.
    None = the result claims absence."""
    from plenum_tpu_torch.common.state_codec import encode_state_value
    if result.get("data") is None:
        return None
    return encode_state_value(result["data"], result.get("seqNo"),
                              result.get("txnTime"))


def pack_write_envelopes(admitted: List[Tuple[dict, "_Rec"]],
                         lane_order: List[Tuple[int, List[int]]]
                         ) -> bytes:
    """One PROPAGATE FLAT_WIRE envelope with each conflict lane's
    requests as a contiguous run (serial lane last) — the gateway→node
    wire format."""
    raw: List[bytes] = []
    names: List[str] = []
    for _lane, idxs in lane_order:
        for i in idxs:
            msg, rec = admitted[i]
            raw.append(packb(msg))
            names.append(rec.client)
    return flat_wire.encode_propagate_envelope(raw, names)


class Gateway:
    def __init__(self, forward_writes: Callable[[bytes], None],
                 serve_read: Callable[[dict, str], Optional[dict]] = None,
                 check_proof=None, verifier=None, verkey_provider=None,
                 config=None, telemetry=None, pool_hubs=None,
                 tracer=None, device=None):
        """``forward_writes(envelope_bytes)`` delivers a packed write
        envelope to the pool; ``serve_read(msg, client)`` performs one
        pool read and returns the proof-bearing result dict (None =
        unavailable); ``check_proof`` is ``PoolClient.check_proof_dict``
        (enables the signed-read cache when given). ``pool_hubs`` is an
        iterable of pool TelemetryHubs — or a callable returning one —
        that ``pump()`` self-sources pressure from when the caller does
        not measure backlog/p99 itself (defaults to the gateway's own
        hub). ``device`` serves the default pre-screen hub's ed25519
        kernel (None means CUDA; see GatewayIntake)."""
        self._tm = telemetry if telemetry is not None \
            else NullTelemetryHub()
        self._pool_hubs = pool_hubs
        self.intake = GatewayIntake(
            verifier=verifier, verkey_provider=verkey_provider,
            senders=SenderRegistry(
                strikes=_cfg(config, "GATEWAY_SENDER_STRIKES"),
                max_senders=_cfg(config, "GATEWAY_SENDER_REGISTRY_MAX"),
                telemetry=self._tm),
            telemetry=self._tm, tracer=tracer,
            max_envelope_bytes=_cfg(config, "MSG_LEN_LIMIT"),
            device=device)
        self.admission = AdmissionController(config)
        self.cache = SignedReadCache(
            check_proof, fresh_s=_cfg(config, "GATEWAY_CACHE_FRESH_S"),
            max_entries=_cfg(config, "GATEWAY_CACHE_MAX"),
            telemetry=self._tm) if check_proof is not None else None
        self._forward = forward_writes
        self._serve_read = serve_read

    # ---------------------------------------------------- service tick

    def pump(self, arrivals: List[Tuple[bytes, str, float]], now: float,
             backlog: Optional[float] = None,
             pool_p99_ms: Optional[float] = None) -> GatewayTick:
        """Serve one tick's arrivals ``[(envelope bytes, sender,
        arrival time)]`` under the current pool pressure. A caller that
        measures pressure itself passes ``backlog``/``pool_p99_ms``;
        left None, each is read live from the pool hubs (newest
        ``TM.BACKLOG_DEPTH`` sample, p99 of the merged
        ``TM.ORDERED_E2E_MS`` histograms). Never raises on
        sender-controlled input."""
        tick = GatewayTick()
        if backlog is None or pool_p99_ms is None:
            live_backlog, live_p99 = self._live_pressure()
            if backlog is None:
                backlog = live_backlog
            if pool_p99_ms is None:
                pool_p99_ms = live_p99
        self.admission.observe(backlog, pool_p99_ms)
        tick.level = self.admission.level_name()
        self._tm.gauge(TM.GATEWAY_BACKLOG, backlog)

        work: List[Tuple[dict, _Rec]] = []
        for data, sender, arrived in arrivals:
            unpacked = self.intake.unpack_client(data, sender)
            if not unpacked:
                continue
            for msg, client in unpacked:
                work.append((msg, _Rec(client, arrived)))
        work = self.intake.fresh_only(work)

        pending_reads = [w for w in work if is_read(w[0])]
        pending_writes = [w for w in work if not is_read(w[0])]
        self._serve_reads(pending_reads, now, tick)
        self._admit_writes(pending_writes, now, tick)
        return tick

    # ----------------------------------------------------------- reads

    def _serve_reads(self, pending: List[Tuple[dict, "_Rec"]],
                     now: float, tick: GatewayTick) -> None:
        for msg, rec in pending:
            key = cache_key_for(msg)
            if key is not None and self.cache is not None:
                hit = self.cache.get(key[0], key[1], now)
                if hit is not None:
                    # always served, whatever the shed level: a cache
                    # hit costs the pool nothing and carries its proof
                    tick.replies.append((rec.client, hit))
                    tick.cache_hits += 1
                    self._mark_done(rec, now)
                    continue
            if not self.admission.admits_read():
                self._tm.count(TM.GATEWAY_SHED_READS, 1)
                tick.shed_reads += 1
                self._mark_done(rec, now)
                continue
            result = self._serve_read(msg, rec.client) \
                if self._serve_read is not None else None
            if result is not None:
                if key is not None and self.cache is not None:
                    try:
                        value = leaf_value_for(result)
                    except (KeyError, TypeError, ValueError):
                        value = _UNCACHEABLE
                    if value is not _UNCACHEABLE:
                        self.cache.put(key[0], key[1], value, result,
                                       now)
                tick.replies.append((rec.client, result))
            self._mark_done(rec, now)

    # ---------------------------------------------------------- writes

    def _admit_writes(self, pending: List[Tuple[dict, "_Rec"]],
                      now: float, tick: GatewayTick) -> None:
        if not pending:
            return
        if not self.admission.admits_write():
            self._tm.count(TM.GATEWAY_SHED_WRITES, len(pending))
            tick.shed_writes += len(pending)
            for _msg, rec in pending:
                self._mark_done(rec, now)
            return
        n_before = len(pending)
        handle = self.intake.screen_dispatch(pending)
        self.intake.screen_flush()
        admitted = self.intake.screen_conclude(handle)
        tick.sig_rejects = n_before - len(admitted)
        for _msg, rec in pending:
            self._mark_done(rec, now)
        if not admitted:
            return
        plan = plan_write_lanes([msg for msg, _ in admitted])
        self._tm.observe(TM.GATEWAY_LANES_PER_BATCH, plan.n_lanes)
        env = pack_write_envelopes(admitted, route_by_lane(plan))
        self._forward(env)
        self._tm.count(TM.GATEWAY_ADMITTED, len(admitted))
        tick.admitted_writes.extend(
            (msg, rec.client) for msg, rec in admitted)

    # ------------------------------------------------------- telemetry

    def _live_pressure(self) -> Tuple[float, Optional[float]]:
        """(backlog, ordered_p99_ms) read from the live pool hubs with
        the same merge semantics ``merged_snapshot`` applies: the
        newest ``BACKLOG_DEPTH`` gauge sample wins, ``ORDERED_E2E_MS``
        histograms add before the quantile. No hub has recorded either
        → (0.0, None), the pre-pressure defaults."""
        from plenum_tpu_torch.observability.telemetry import LogLinearHistogram
        hubs = self._pool_hubs() if callable(self._pool_hubs) \
            else self._pool_hubs
        if not hubs:
            hubs = (self._tm,)
        backlog_ts, backlog = None, 0.0
        scratch = None
        for hub in hubs:
            s = hub.gauge_sample(TM.BACKLOG_DEPTH)
            if s is not None and (backlog_ts is None or s[0] >= backlog_ts):
                backlog_ts, backlog = s
            h = hub.histogram(TM.ORDERED_E2E_MS)
            if h is not None:
                if scratch is None:
                    scratch = LogLinearHistogram()
                scratch.merge(h)
        p99 = scratch.quantile(0.99) if scratch is not None else None
        return float(backlog), p99

    def _mark_done(self, rec: "_Rec", now: float) -> None:
        self._tm.observe(TM.GATEWAY_E2E_MS,
                         max(0.0, (now - rec.arrived) * 1000.0))
