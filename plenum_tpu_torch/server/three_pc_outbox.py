"""ThreePCOutbox — per-node coalescing of broadcast 3PC votes.

One node broadcasts a PRE-PREPARE (primary), a PREPARE and a COMMIT per
in-flight batch PER PROTOCOL INSTANCE (f+1 RBFT instances); before this
every vote was its own ExternalBus send — its own transport delivery and
its own receive-side handler dispatch on every peer. The outbox collects
every instance's broadcast votes during a prod tick and flushes them as
ONE wire message per peer: a flat zero-copy ``FlatBatch`` envelope
(common/serializers/flat_wire.py — PREPARE/COMMIT votes as contiguous
typed columns, PRE-PREPAREs as a length-prefixed section; one pack for
the whole tick) when ``Config.FLAT_WIRE`` is on, else the typed
``ThreePCBatch`` envelope (one msgpack pack on the socket path). The
receiving node routes flat envelopes into the columnar
``process_*_columns`` intake with zero intermediate message objects,
typed envelopes into ``process_*_batch``.

Correctness notes:

* FIFO send order is preserved inside the envelope — a sender enqueues
  PRE-PREPARE before its own PREPARE before its own COMMIT, so per-
  sender causality on the wire is identical to the per-message path
  (the receiver processes each envelope phase-major per instance, and
  no sender emits a vote before its own earlier-phase vote for the
  same key).
* Only BROADCAST sends coalesce (3PC votes are always broadcast);
  directed messages (OldViewPrePrepareReply, MessageRep, ...) never
  enter the outbox.
* While a fault-injection tap is installed on the bus
  (testing/adversary), flush degrades to per-message sends: the
  adversary behaviors match and rewrite individual Prepare/Commit/
  PrePrepare messages, and hiding them inside an envelope would blind
  the fault injector — per-message wire granularity IS the seam there.
* Batches are chunked under a serialized-size budget so a full tick of
  votes can never build a frame the transport would drop wholesale
  (same rule as Propagator.BATCH_SIZE_BUDGET). The per-vote byte
  estimates are MEASURED: an EWMA per vote type updated from the
  actual packed section sizes of every flat flush (seeded from the
  legacy hand-tuned constants), with a hard post-encode split when an
  estimate lags — the chunking budget tracks whatever the wire layout
  actually costs, it is never hand-tuned again. The measured sizes
  also land in the process seam hub as per-vote-type histograms
  (TM.WIRE_VOTE_BYTES_*) next to the wire byte counters.
"""
from __future__ import annotations

import logging
from typing import List

from plenum_tpu_torch.common.messages.node_messages import (
    Commit, FlatBatch, PrePrepare, ThreePCBatch)
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.observability.tracing import CAT_3PC, NullTracer
from plenum_tpu_torch.observability.telemetry import TM, get_seam_hub

logger = logging.getLogger(__name__)

# seed estimates per vote type (bytes) — the starting point of the
# rolling measured model below, NOT the operating values: after the
# first flat flush every estimate is an EWMA of actual packed bytes
_PREPARE_SEED = 640
_COMMIT_SEED = 384
_PP_BASE_SEED = 1024
# wire bytes one request digest adds to a PRE-PREPARE (the reqIdr
# entry); kept constant — it is bounded by digest length + framing
_PP_PER_DIGEST_EST = 72


class EnvelopeSizeModel:
    """Rolling measured per-vote packed sizes. ``estimate`` drives the
    chunking budget; ``note_*`` feed it the actual section payload
    sizes each flat flush produces (EWMA, alpha=0.25) and record the
    per-vote byte histograms into the process seam hub."""

    ALPHA = 0.25

    def __init__(self):
        self.prepare = float(_PREPARE_SEED)
        self.commit = float(_COMMIT_SEED)
        self.pp_base = float(_PP_BASE_SEED)

    def _ewma(self, cur: float, measured: float) -> float:
        return cur + self.ALPHA * (measured - cur)

    def note_prepares(self, payload_len: int, count: int) -> None:
        per = payload_len / count
        self.prepare = self._ewma(self.prepare, per)
        get_seam_hub().observe(TM.WIRE_VOTE_BYTES_PREPARE, per)

    def note_commits(self, payload_len: int, count: int) -> None:
        per = payload_len / count
        self.commit = self._ewma(self.commit, per)
        get_seam_hub().observe(TM.WIRE_VOTE_BYTES_COMMIT, per)

    def note_preprepares(self, payload_len: int, count: int,
                         digests: int) -> None:
        per = payload_len / count
        base = max(64.0, per - _PP_PER_DIGEST_EST * (digests / count))
        self.pp_base = self._ewma(self.pp_base, base)
        get_seam_hub().observe(TM.WIRE_VOTE_BYTES_PREPREPARE, per)

    def estimate(self, msg) -> int:
        if isinstance(msg, PrePrepare):
            return int(self.pp_base
                       + _PP_PER_DIGEST_EST * len(msg.reqIdr))
        if isinstance(msg, Commit):
            return int(self.commit)
        return int(self.prepare)


class ThreePCOutbox:
    # entry-count cap per envelope; the size budget is the real guard
    BATCH_LIMIT = 300

    def __init__(self, network, msg_len_limit: int = 128 * 1024,
                 flat_wire_enabled: bool = True):
        self._network = network
        # generous envelope/AEAD headroom, like the propagator's budget
        self._size_budget = msg_len_limit - 8 * 1024
        self._out: List = []
        self._flat = flat_wire_enabled
        self.size_model = EnvelopeSizeModel()
        self.tracer = NullTracer()   # node injects the real one
        # journey plane: node sets origin + trace_context from config;
        # stamps flow only when the node's tracer is live, so the
        # default NullTracer keeps this seam free
        self.origin = ""
        self.trace_context = False
        self._flush_seq = 0
        self.flushed_batches = 0
        self.flushed_msgs = 0

    def _next_stamp(self):
        """Advisory causal stamp for ONE outgoing envelope, or None
        when trace context is off. The clock pair is sampled HERE, at
        the flush seam (called only from the node's service loop, never
        from consensus logic) — flat_wire's encode half is a PT012
        consensus root and only ever sees the timestamps as plain
        arguments."""
        if not (self.trace_context and self.tracer.enabled):
            return None
        self._flush_seq += 1
        perf, wall = self.tracer.clock_pair()
        return flat_wire.TraceStamp(self.origin, self._flush_seq,
                                    perf, wall)

    def _note_send(self, stamp, n: int, nbytes: int) -> None:
        """Send-side anchor for the journey joiner / Perfetto flow
        arrows: one instant per stamped envelope, keyed by flush seq."""
        if stamp is not None:
            self.tracer.instant("wire_send", CAT_3PC,
                                key=str(stamp.seq), seq=stamp.seq,
                                n=n, nbytes=nbytes)

    def queue(self, msg) -> None:
        """Collect one broadcast 3PC vote for the next flush."""
        self._out.append(msg)

    def __len__(self) -> int:
        return len(self._out)

    def flush(self) -> int:
        """Ship everything queued since the last flush. → votes sent."""
        if not self._out:
            return 0
        out, self._out = self._out, []
        with self.tracer.span("three_pc_flush", CAT_3PC, n=len(out)):
            self._flush(out)
        self.flushed_msgs += len(out)
        return len(out)

    def _flush(self, out: List) -> None:
        send = self._network.send
        if getattr(self._network, "has_tap", False):
            # fault injection installed: keep per-message granularity
            for m in out:
                send(m)
            return
        if self._flat:
            self._flush_flat(out, send)
            return
        self._flush_typed(out, send)

    # ------------------------------------------------------- flat wire

    def _flush_flat(self, out: List, send) -> None:
        for chunk in self._chunks(out):
            try:
                self._send_flat_chunk(chunk, send)
            except flat_wire.FlatWireUnencodable as e:
                # a field value the flat layout cannot carry: THIS
                # chunk rides the validated typed fallback (already-
                # sent chunks stay sent — chunking is FIFO-safe)
                logger.debug("3PC outbox: flat encode fell back (%s)", e)
                self._flush_typed(chunk, send)

    def _chunks(self, out: List):
        estimate = self.size_model.estimate
        chunk, chunk_size = [], 0
        for m in out:
            size = estimate(m)
            if chunk and (len(chunk) >= self.BATCH_LIMIT
                          or chunk_size + size > self._size_budget):
                yield chunk
                chunk, chunk_size = [], 0
            chunk.append(m)
            chunk_size += size
        if chunk:
            yield chunk

    def _send_flat_chunk(self, chunk: List, send) -> None:
        stamp = self._next_stamp()
        with self.tracer.span("wire_pack", CAT_3PC, n=len(chunk)):
            payload, sections = self._encode_chunk(chunk, stamp)
        if len(payload) > self._size_budget and len(chunk) > 1:
            # an estimate lagged the measured sizes: split and re-pack
            # rather than building a frame the transport drops. The
            # oversize attempt's sizes are NOT noted — only envelopes
            # that actually ship feed the model/histograms, or every
            # re-split would count the same votes twice
            half = len(chunk) // 2
            self._send_flat_chunk(chunk[:half], send)
            self._send_flat_chunk(chunk[half:], send)
            return
        self._note_sections(sections)
        hub = get_seam_hub()
        hub.count(TM.WIRE_BYTES_SENT, len(payload))
        hub.observe(TM.WIRE_ENV_BYTES_3PC, len(payload))
        self._note_send(stamp, len(chunk), len(payload))
        send(FlatBatch(payload=payload))
        self.flushed_batches += 1

    def _encode_chunk(self, chunk: List, stamp=None):
        """→ (envelope bytes, [(kind, count, payload_len, digests)])
        — measurement is deferred to _note_sections so only SENT
        envelopes feed the size model."""
        pps = [m for m in chunk if isinstance(m, PrePrepare)]
        commits = [m for m in chunk if isinstance(m, Commit)]
        prepares = [m for m in chunk
                    if not isinstance(m, (PrePrepare, Commit))]
        sections = []
        if pps:
            payload = flat_wire.encode_preprepares(pps)
            sections.append((flat_wire.KIND_PREPREPARE, len(pps),
                             payload, sum(len(p.reqIdr) for p in pps)))
        if prepares:
            sections.append((flat_wire.KIND_PREPARE, len(prepares),
                             flat_wire.encode_prepares(prepares), 0))
        if commits:
            sections.append((flat_wire.KIND_COMMIT, len(commits),
                             flat_wire.encode_commits(commits), 0))
        trace = None
        if stamp is not None:
            trace = flat_wire.encode_trace_stamp(
                stamp.origin, stamp.seq, stamp.perf_ts, stamp.wall_ts)
        return flat_wire.build_envelope(
            [(kind, count, payload)
             for kind, count, payload, _ in sections],
            trace=trace), sections

    def _note_sections(self, sections) -> None:
        model = self.size_model
        for kind, count, payload, digests in sections:
            if kind == flat_wire.KIND_PREPARE:
                model.note_prepares(len(payload), count)
            elif kind == flat_wire.KIND_COMMIT:
                model.note_commits(len(payload), count)
            elif kind == flat_wire.KIND_PREPREPARE:
                model.note_preprepares(len(payload), count, digests)

    # --------------------------------------------- typed-object fallback

    def _flush_typed(self, out: List, send) -> None:
        for chunk in self._chunks(out):
            if len(chunk) == 1:
                # bare single-vote sends carry no stamp — the context
                # is advisory and the envelope kinds are its carriers
                send(chunk[0])
            else:
                stamp = self._next_stamp()
                send(ThreePCBatch(
                    messages=chunk,
                    traceCtx=stamp.as_list() if stamp else None))
                self._note_send(stamp, len(chunk), 0)
                self.flushed_batches += 1
