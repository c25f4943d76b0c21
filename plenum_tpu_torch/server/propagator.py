"""Propagator — client-request propagation and finalization.

Reference: plenum/server/propagator.py — `Requests` (:62, digest →
request + votes), `Propagator` (:195): on a new client request, broadcast
PROPAGATE; once f+1 nodes propagated identical requests the request is
"finalised" and forwarded to the ordering queues.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Set

from plenum_tpu_torch.common.messages.node_messages import (
    FlatBatch, Propagate, PropagateBatch)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.serializers.msgpack_codec import packb
from plenum_tpu_torch.common.serializers.serializers import MsgPackSerializer
from plenum_tpu_torch.consensus.quorums import Quorums
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext
from plenum_tpu_torch.observability.tracing import CAT_PROPAGATE, NullTracer
from plenum_tpu_torch.observability.telemetry import TM, get_seam_hub
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector

_wire_serializer = MsgPackSerializer()
_fp = try_load_host_ext("fastpath")

logger = logging.getLogger(__name__)


def _payload_size(payload: dict) -> int:
    """Serialized size estimate for batch budgeting (exact when the C
    canonical packer is available; real msgpack size otherwise — a flat
    guess would under-count multi-KB ATTRIB raws, letting a batch exceed
    the transport frame limit and be dropped wholesale)."""
    if _fp is not None:
        try:
            return len(_fp.canonical_msgpack(payload)) + 16
        except TypeError:
            pass
    try:
        return len(packb(payload)) + 16
    except Exception:
        # unpackable oddity: assume the worst entry the budget accepts
        # 40 of rather than dropping the propagate entirely
        return 3 * 1024


def _strict_deep_eq_py(a, b) -> bool:
    """Deep equality that also requires identical types at every node —
    digest-faithful for the canonical serializers (which encode True,
    1, and 1.0 differently while Python `==` conflates them)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        if len(a) != len(b):
            return False
        for k, v in a.items():
            if k not in b or not _strict_deep_eq_py(v, b[k]):
                return False
        return True
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            _strict_deep_eq_py(x, y) for x, y in zip(a, b))
    return a == b


if _fp is not None:
    def _strict_deep_eq(a, b, _c=_fp.deep_eq):
        try:
            return _c(a, b)
        except TypeError:  # structure too deep for the C guard
            return _strict_deep_eq_py(a, b)
else:
    _strict_deep_eq = _strict_deep_eq_py


class ReqState:
    def __init__(self, request: Request):
        self.request = request
        self.propagates: Set[str] = set()
        self.finalised = False
        self.forwarded = False
        self.executed = False
        self.payload = None      # canonical as_dict(), built on first use


class Requests(dict):
    """digest → ReqState (reference propagator.py:62).

    A (identifier, reqId) side-index lets the propagate path recognise a
    request it already holds WITHOUT recomputing the digest — computing
    the key costs a canonical serialization + sha256, and with n nodes
    gossiping every request arrives n-1 times (the dominant per-request
    cost at 25 nodes). On an index hit the incoming payload is compared
    to the stored request's dict (plain dict equality, no hashing); a
    mismatch (byzantine reuse of a reqId with different content) falls
    back to the full digest path."""

    def __init__(self):
        super().__init__()
        # (identifier, reqId) → ReqState, straight to the state object:
        # the propagate hot path must not pay a second dict hop through
        # the digest
        self._by_ref: dict = {}

    def add(self, req: Request) -> ReqState:
        key = req.key
        state = self.get(key)
        if state is None:
            state = self[key] = ReqState(req)
        # first writer wins: a later same-(identifier, reqId) variant
        # must not hijack the fast-path index and starve the request
        # that is already collecting votes — but a still-live state
        # DOES re-claim a slot vacated by free(), or every later gossip
        # copy would pay the full digest + auth path the index avoids
        self._by_ref.setdefault((req.identifier, req.reqId), state)
        return state

    def ref_state(self, payload: dict) -> Optional[ReqState]:
        """Raw (identifier, reqId) index hit WITHOUT the deep-equality
        check — only valid for decisions that don't depend on payload
        content (e.g. 'already forwarded, nothing to do')."""
        return self._by_ref.get((payload.get("identifier"),
                                 payload.get("reqId")))

    def lookup_state(self, payload: dict) -> Optional[ReqState]:
        """Cheap pre-digest lookup: the stored ReqState if `payload` is
        bit-for-bit the request we already hold, else None. Equality is
        TYPE-STRICT deep comparison — the digest's canonical
        serialization distinguishes True/1/1.0, so plain dict equality
        (which conflates them) would let a byzantine re-gossip count as
        a vote for the original digest; any mismatch falls back to the
        full digest path."""
        state = self._by_ref.get((payload.get("identifier"),
                                  payload.get("reqId")))
        if state is None:
            return None
        if state.payload is None:
            state.payload = state.request.as_dict()
        return state if _strict_deep_eq(state.payload, payload) else None

    def votes(self, req_key: str) -> int:
        state = self.get(req_key)
        return len(state.propagates) if state else 0

    def is_finalised(self, req_key: str) -> bool:
        state = self.get(req_key)
        return state.finalised if state else False

    def set_finalised(self, req_key: str):
        if req_key in self:
            self[req_key].finalised = True

    def free(self, req_key: str):
        state = self.pop(req_key, None)
        if state is not None:
            ref = (state.request.identifier, state.request.reqId)
            if self._by_ref.get(ref) is state:
                del self._by_ref[ref]


class Propagator:
    # upper bound on entries per PROPAGATE_BATCH; the size budget below
    # is the real wire guard
    BATCH_LIMIT = 200
    # serialized-payload budget per batch: MSG_LEN_LIMIT (128 KiB) minus
    # generous envelope/AEAD headroom — chunking by count alone would
    # let large operations (multi-KB ATTRIB raws) build a frame the
    # stack drops wholesale, silently losing every propagate in it
    BATCH_SIZE_BUDGET = 128 * 1024 - 8 * 1024

    def __init__(self, name: str, quorums: Quorums, network,
                 forward_handler: Callable[[Request], None],
                 authenticator: Callable[[Request], bool] = None,
                 forward_batch_handler: Callable[[list], None] = None,
                 flat_wire_enabled: bool = False):
        """network: ExternalBus; forward_handler: called exactly once per
        finalised request (feeds ordering queues). authenticator(request)
        → bool gates requests FIRST LEARNED from a peer's PROPAGATE: a
        node must never echo-vote (or forward) content it cannot
        authenticate — otherwise a single byzantine relay plus the
        honest echo reaches the f+1 quorum with a forged payload (found
        by the TamperedPropagate adversary scenario). Requests from the
        client intake path were authenticated there already.
        forward_batch_handler(requests): optional columnar forward — all
        requests finalised by ONE inbound PROPAGATE_BATCH go to the
        ordering queues as one contiguous digest column (one downstream
        stash-replay per batch instead of per request)."""
        self.name = name
        self.quorums = quorums
        self._network = network
        self._forward = forward_handler
        self._forward_batch = forward_batch_handler
        self._authenticator = authenticator
        # flat zero-copy wire (common/serializers/flat_wire.py): each
        # queued payload is packed ONCE at queue time — the same bytes
        # feed the size budget AND the envelope, so the old pack-for-
        # sizing-then-discard cost disappears. Degrades to the typed
        # Propagate/PropagateBatch wire while an adversary tap is
        # installed (per-message granularity IS the fault-injection
        # seam) or when the flag is off.
        self._flat = flat_wire_enabled
        self.requests = Requests()
        self.metrics = NullMetricsCollector()   # node injects the real one
        self.tracer = NullTracer()              # node injects the real one
        # journey plane: node enables trace_context from config; stamps
        # flow only while the tracer is live, so the default NullTracer
        # keeps this seam free
        self.trace_context = False
        self._flush_seq = 0
        # queued outgoing propagates, flushed as PROPAGATE_BATCH once
        # per tick: at n validators every request is otherwise its own
        # message n-1 times per node — batching is what lets wide pools
        # (25 nodes) drain instead of drowning in per-message overhead
        self._out: list = []

    def update_quorums(self, quorums: Quorums):
        self.quorums = quorums

    def _next_stamp(self):
        """Advisory causal stamp for ONE outgoing envelope, or None
        when trace context is off. The clock pair is sampled HERE, at
        the flush seam — flat_wire's encode half is a PT012 consensus
        root and only ever sees the timestamps as plain arguments."""
        if not (self.trace_context and self.tracer.enabled):
            return None
        self._flush_seq += 1
        perf, wall = self.tracer.clock_pair()
        return flat_wire.TraceStamp(self.name, self._flush_seq,
                                    perf, wall)

    def _note_send(self, stamp, n: int, nbytes: int) -> None:
        """Send-side anchor for the journey joiner / Perfetto flow
        arrows: one instant per stamped envelope, keyed by flush seq."""
        if stamp is not None:
            self.tracer.instant("wire_send", CAT_PROPAGATE,
                                key=str(stamp.seq), seq=stamp.seq,
                                n=n, nbytes=nbytes)

    # ----------------------------------------------------------- sending

    def propagate(self, request: Request, client_name: Optional[str]):
        """Queue our PROPAGATE for this request (reference :204 sends
        immediately; here it rides the next flush's batch)."""
        state = self.requests.add(request)
        if self.name in state.propagates:
            return
        state.propagates.add(self.name)
        self._queue_out(request.as_dict(), client_name)
        self._try_finalise(request.key)

    def _queue_out(self, payload: dict, client_name) -> None:
        if self._flat:
            try:
                raw = _wire_serializer.serialize(payload)
                # estimate covers the client-id string + per-entry
                # offset-table overhead too; the post-encode split in
                # _send_flat_chunk backstops any remaining lag
                self._out.append((payload, client_name,
                                  len(raw) + len(client_name or "") + 24,
                                  raw))
                return
            except Exception:
                # unpackable oddity: ride the typed fallback below
                pass
        self._out.append((payload, client_name, _payload_size(payload),
                          None))

    def flush(self) -> int:
        """Send everything queued since the last flush, chunked under
        BOTH an entry-count cap and a serialized-size budget so no batch
        can exceed the transport frame limit. Called once per prod tick
        (and right after a client intake batch concludes). → messages
        queued count."""
        if not self._out:
            return 0
        with self.metrics.measure_time(MetricsName.PROPAGATE_FLUSH_TIME), \
                self.tracer.span("propagate_flush", CAT_PROPAGATE,
                                 n=len(self._out)):
            return self._flush()

    def _flush(self) -> int:
        out, self._out = self._out, []
        flat = self._flat and not getattr(self._network, "has_tap",
                                          False)

        def send_chunk(chunk):
            if flat and all(e[3] is not None for e in chunk):
                try:
                    self._send_flat_chunk(chunk)
                    return
                except flat_wire.FlatWireUnencodable as e:
                    # cannot ride the flat layout: typed fallback below
                    logger.debug("propagator: flat encode fell back "
                                 "(%s)", e)
            if len(chunk) == 1:
                # bare single-request sends carry no stamp — the
                # context is advisory and the batch forms carry it
                self._network.send(Propagate(request=chunk[0][0],
                                             senderClient=chunk[0][1]))
            else:
                stamp = self._next_stamp()
                self._network.send(PropagateBatch(
                    requests=[r for r, _, _, _ in chunk],
                    clients=[c or "" for _, c, _, _ in chunk],
                    traceCtx=stamp.as_list() if stamp else None))
                self._note_send(stamp, len(chunk), 0)

        chunk, chunk_size = [], 0
        for entry in out:
            size = entry[2]
            if chunk and (len(chunk) >= self.BATCH_LIMIT
                          or chunk_size + size > self.BATCH_SIZE_BUDGET):
                send_chunk(chunk)
                chunk, chunk_size = [], 0
            chunk.append(entry)
            chunk_size += size
        if chunk:
            send_chunk(chunk)
        return len(out)

    def _send_flat_chunk(self, chunk) -> None:
        """One flat envelope from the chunk's already-packed request
        blobs — the payload bytes computed for the size budget ARE the
        wire bytes; no second serialization happens."""
        stamp = self._next_stamp()
        trace = None
        if stamp is not None:
            trace = flat_wire.encode_trace_stamp(
                stamp.origin, stamp.seq, stamp.perf_ts, stamp.wall_ts)
        with self.tracer.span("wire_pack", CAT_PROPAGATE, n=len(chunk)):
            payload = flat_wire.encode_propagate_envelope(
                [raw for _, _, _, raw in chunk],
                [c or "" for _, c, _, _ in chunk],
                trace=trace)
        if len(payload) > self.BATCH_SIZE_BUDGET and len(chunk) > 1:
            # estimate lagged (same backstop as ThreePCOutbox): split
            # rather than build a frame the transport drops wholesale
            half = len(chunk) // 2
            self._send_flat_chunk(chunk[:half])
            self._send_flat_chunk(chunk[half:])
            return
        hub = get_seam_hub()
        hub.count(TM.WIRE_BYTES_SENT, len(payload))
        hub.observe(TM.WIRE_ENV_BYTES_PROPAGATE, len(payload))
        self._note_send(stamp, len(chunk), len(payload))
        self._network.send(FlatBatch(payload=payload))

    # ---------------------------------------------------------- receiving

    def process_propagate(self, msg: Propagate, frm: str):
        with self.metrics.measure_time(MetricsName.PROPAGATE_PROCESS_TIME):
            self._process_one(msg.request, msg.senderClient, frm)

    def process_propagate_batch(self, msg: PropagateBatch, frm: str):
        self.note_wire_stamp(getattr(msg, "traceCtx", None), frm)
        with self.metrics.measure_time(MetricsName.PROPAGATE_PROCESS_TIME):
            self._process_propagate_batch(msg, frm)

    def note_wire_stamp(self, ctx, frm: str) -> None:
        """Advisory typed-fallback stamp intake: decode the nullable
        traceCtx field and record a receive-side anchor instant. Every
        failure mode is swallowed into 'no journey hop' — the stamp can
        never affect propagate handling (plenum-lint PT015 pins this
        unreachability from consensus)."""
        if ctx is None or not self.tracer.enabled:
            return
        stamp = flat_wire.TraceStamp.from_wire(ctx)
        if stamp is None:
            return
        recv_perf, recv_wall = self.tracer.clock_pair()
        self.tracer.instant(
            "wire_recv", CAT_PROPAGATE,
            key="%s:%d" % (stamp.origin, stamp.seq),
            origin=stamp.origin, seq=stamp.seq, frm=frm,
            sent_perf=stamp.perf_ts, sent_wall=stamp.wall_ts,
            recv_wall=recv_wall)

    def _process_propagate_batch(self, msg: PropagateBatch, frm: str):
        clients = msg.clients or [""] * len(msg.requests)
        if len(clients) != len(msg.requests):
            # malformed (byzantine?) batch: dropping it silently via zip
            # truncation would make a protocol violation invisible
            logger.warning(
                "%s: PROPAGATE_BATCH from %s with %d requests but %d "
                "clients — discarded", self.name, frm,
                len(msg.requests), len(clients))
            return
        if self._forward_batch is None:
            for payload, client in zip(msg.requests, clients):
                self._process_one(payload, client or None, frm)
            return
        # columnar finalisation: requests that reach quorum inside this
        # batch collect into one forward call — their digests stay a
        # contiguous column all the way into the ordering queues
        finalised: list = []
        for payload, client in zip(msg.requests, clients):
            self._process_one(payload, client or None, frm,
                              finalise_sink=finalised)
        if finalised:
            self._forward_batch([s.request for s in finalised])

    def process_propagate_columns(self, cols, frm: str):
        """Flat-wire PROPAGATE intake: the parsed section hands each
        request payload over as raw msgpack bytes, unpacked straight
        into the dict ``_process_one`` needs — no Propagate message
        object, no envelope schema validation, no per-field canonical
        re-sort on the receive path. Finalisation stays columnar: all
        requests reaching quorum inside this envelope forward as one
        contiguous digest column."""
        with self.metrics.measure_time(MetricsName.PROPAGATE_PROCESS_TIME):
            self._process_propagate_columns(cols, frm)

    def _process_propagate_columns(self, cols, frm: str):
        sink = [] if self._forward_batch is not None else None
        for i in range(cols.n):
            try:
                payload = cols.request(i)
            except Exception:
                # one bad entry costs ONE propagate, never the envelope
                logger.warning(
                    "%s: bad PROPAGATE entry in flat envelope from %s "
                    "— ignored", self.name, frm)
                continue
            self._process_one(payload, cols.client(i) or None, frm,
                              finalise_sink=sink)
        if sink:
            self._forward_batch([s.request for s in sink])

    def _process_one(self, payload: dict, sender_client, frm: str,
                     finalise_sink=None):
        # ONE state lookup per propagate: at n validators this handler
        # runs (n-1) times per request per node — every extra dict hop
        # or digest-property access in here is multiplied by that
        quick = self.requests.ref_state(payload)
        if quick is not None and quick.forwarded:
            # already queued for ordering: no propagate — matching OR
            # byzantine-variant — can change anything, so skip the
            # deep-equality check entirely. At 25 nodes most of the
            # (n-1) gossip copies of every request land here.
            return
        state = self.requests.lookup_state(payload)
        if state is None:
            # first sighting of this exact content — it must
            # authenticate before it may collect votes or be echoed
            try:
                request = Request.from_dict(payload)
            except Exception:
                logger.warning("%s: malformed PROPAGATE payload from %s "
                               "— ignored", self.name, frm)
                return
            if self._authenticator is not None \
                    and not self._authenticator(request):
                logger.warning(
                    "%s: PROPAGATE from %s fails authentication "
                    "(identifier=%s reqId=%s) — ignored, not echoed",
                    self.name, frm, payload.get("identifier"),
                    payload.get("reqId"))
                return
            state = self.requests.add(request)
        propagates = state.propagates
        n0 = len(propagates)
        propagates.add(frm)
        # echo our own propagate if we haven't yet (so slow clients still
        # reach quorum via node-to-node gossip)
        if self.name not in propagates:
            propagates.add(self.name)
            self._queue_out(payload, sender_client)
        if not state.forwarded and \
                self.quorums.propagate.is_reached(len(propagates)):
            closer = frm
            if self.tracer.enabled and len(propagates) > n0 + 1 \
                    and not self.quorums.propagate.is_reached(n0 + 1):
                # both the relay's vote and our own echo landed in this
                # call and the relay's alone did not reach f+1: our own
                # echo supplied the closing vote
                closer = self.name
            self._finalise(state, finalise_sink, closer=closer)

    def _try_finalise(self, req_key: str):
        state = self.requests.get(req_key)
        if state is None or state.forwarded:
            return
        if self.quorums.propagate.is_reached(len(state.propagates)):
            self._finalise(state, closer=self.name)

    def _finalise(self, state: ReqState, sink=None, closer=None):
        """Quorum reached: mark, record the lifecycle marker (naming
        the relay whose vote supplied the f+1'th — the journey plane's
        propagate-close attribution), forward exactly once. The digest
        access is free here — forwarding hands request.key to the
        ordering queues anyway. With a `sink` the caller owns
        forwarding (batch path: one columnar forward per inbound
        PROPAGATE_BATCH)."""
        state.finalised = True
        state.forwarded = True
        self.tracer.instant("propagate_quorum", CAT_PROPAGATE,
                            key=state.request.key,
                            votes=len(state.propagates),
                            closer=closer or self.name)
        if sink is not None:
            sink.append(state)
        else:
            self._forward(state.request)
