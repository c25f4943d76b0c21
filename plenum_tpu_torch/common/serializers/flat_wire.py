"""Flat zero-copy wire format for the 3PC / propagate money path.

Every THREE_PC_BATCH envelope used to round-trip each inner vote
through per-field msgpack of a Python message object: one canonical
``_sort_deep`` + packb per vote on the send side, one
``node_message_factory.get_instance`` (full schema validation + object
construction) per vote on the receive side — only for the columnar
intake to strip the objects back down to digest/view/seq columns.
This module replaces that with ONE pack and ONE parse per envelope:

* **PREPARE / COMMIT votes become contiguous typed columns** — instId,
  viewNo, ppSeqNo (little-endian unsigned ints), ppTime (f64), digest
  (32 raw bytes, hex-decoded) packed as flat buffers and parsed back
  as ``np.frombuffer`` views over the envelope bytes. No intermediate
  Python message objects exist on the receive path: the parsed columns
  go straight into the ordering service's vectorized precheck,
  ``digest_match_mask`` and the incremental ``_prepare_vote_count`` /
  ``_commit_vote_count`` counters; a typed ``Prepare``/``Commit``
  object is materialized ONLY for the votes that actually enter a vote
  store, a stash bucket, or a suspicion report.
* **Ragged payloads ride the same envelope as length-prefixed
  sections**: PRE-PREPAREs (ragged reqIdr) and PROPAGATE request
  payloads are stored as msgpack blobs behind a u32 offset table —
  still one wire message, one parse, with per-item unpacking deferred
  to the consumer.
* **The typed-object path stays as validated fallback** — the codec
  slots into the serializer registry boundary exactly like
  MsgPackSerializer does; ``Config.FLAT_WIRE = False`` (or an
  installed adversary tap) restores the per-message / THREE_PC_BATCH
  wire unchanged, and ``to_legacy_messages`` re-materializes a flat
  envelope into typed messages so fault-injection taps keep seeing
  per-type granularity.

Envelope layout (all integers little-endian; see docs/wire.md):

    magic   2 bytes  b"PW"
    version u8       1
    nsect   u8       number of sections
    section*  kind u8 | count u32 | payload_len u32 | payload

Section payloads:

    PREPARE (kind 1), n votes:
        instId   n × u32
        viewNo   n × u64
        ppSeqNo  n × u64
        ppTime   n × f64
        digest   n × 32 bytes      (raw sha256; lowercase-hex decode)
        flags    n × u8            bit0 stateRootHash present
                                   bit1 txnRootHash present
                                   bit2 auditTxnRootHash present
                                   bit3 digest in string table (not a
                                        canonical 64-char hex digest)
                                   bit4 ppTime was an int
        offsets  (4n+1) × u32      string-table boundaries, column-
                                   major: state roots, txn roots,
                                   audit roots, odd digests
        blob     offsets[-1] bytes

    COMMIT (kind 2), n votes:
        instId   n × u32
        viewNo   n × u64
        ppSeqNo  n × u64
        flags    n × u8            bit0 blsSig present
                                   bit1 blsSigs present
        offsets  (2n+1) × u32      blsSig strings, blsSigs msgpack
        blob     offsets[-1] bytes

    PREPREPARE (kind 3), n messages:
        offsets  (n+1) × u32
        blob                        canonical msgpack of to_dict()

    PROPAGATE (kind 4), n requests:
        offsets  (2n+1) × u32      request msgpack blobs, client ids
        blob

    TRACE (kind 5, version 2 only), advisory causal stamp:
        name_len u8 | origin utf-8 (≤ 64 bytes)
        flush_seq u64              sender's per-seam flush counter
        perf_ts   f64              sender perf-counter at flush
        wall_ts   f64              sender wall clock at flush

The TRACE section is **advisory observability context**: it is decoded
by :func:`decode_trace_stamp` into ``ParsedEnvelope.stamp`` and never
enters ``ParsedEnvelope.sections`` — consensus consumers iterate
sections and cannot see it. Any CONTENT problem inside the stamp
(bad length, non-finite floats, undecodable name) yields ``stamp =
None`` and the rest of the envelope parses normally; only the shared
structural framing (payload bounds) can fail the envelope. Version 1
envelopes reject kind 5 like any unknown kind, so the golden byte
vectors for version 1 are unchanged. plenum-lint PT015 enforces that
no consensus path can reach the stamp decode.

A structurally invalid envelope (bad magic/version, truncated or
over-length payload, non-monotonic offsets, counts that do not fit)
raises :class:`FlatWireError` — the node handler converts that into a
per-sender suspicion and drops the envelope; it can never crash the
prod loop. Entry-LEVEL garbage (a root string failing schema
validation, an unparseable PRE-PREPARE blob) costs only that entry,
exactly like a bad entry in a legacy THREE_PC_BATCH.
"""
from __future__ import annotations

import logging
import math
import struct
from typing import List, Optional, Tuple

import numpy as np

from plenum_tpu_torch.common.serializers.msgpack_codec import packb, unpackb

logger = logging.getLogger(__name__)

MAGIC = b"PW"
VERSION = 1
# version 2 = version 1 + an optional advisory TRACE section; the
# sender only bumps the byte when a stamp actually rides the envelope,
# so version-1 peers (and the version-1 golden vectors) never see it
VERSION_TRACE = 2

KIND_PREPARE = 1
KIND_COMMIT = 2
KIND_PREPREPARE = 3
KIND_PROPAGATE = 4
KIND_TRACE = 5

# advisory-stamp bounds: origin name capped (encode truncates, decode
# rejects over-length into stamp=None) so the section can never exceed
# 1 + 64 + 8 + 8 + 8 = 89 payload bytes
TRACE_NAME_MAX = 64

# PREPARE flag bits
F_STATE = 1
F_TXN = 2
F_AUDIT = 4
F_ODD_DIGEST = 8
F_TIME_INT = 16
# COMMIT flag bits
F_BLSSIG = 1
F_BLSSIGS = 2

# structural sanity cap: votes per section. The senders chunk far below
# this (ThreePCOutbox.BATCH_LIMIT=300 / Propagator.BATCH_LIMIT=200);
# the cap only bounds what a hostile count field can make the parser
# believe before the fits-in-payload check runs.
SECTION_COUNT_MAX = 1 << 16

_U32 = np.dtype("<u4")
_U64 = np.dtype("<u8")
_F64 = np.dtype("<f8")
_U8 = np.dtype("u1")


class FlatWireError(Exception):
    """Structurally invalid flat envelope (attributable to the sender)."""


class FlatWireUnencodable(Exception):
    """A message whose field values the flat layout cannot carry
    (e.g. an out-of-range integer); the sender falls back to the
    typed-object wire for that chunk."""


def _serializer():
    # late import: this module must stay importable without the full
    # serializer registry loaded (and vice versa)
    from plenum_tpu_torch.common.serializers.serializers import MsgPackSerializer
    return MsgPackSerializer()


def _check_uint(value, bits: int, what: str) -> int:
    if not isinstance(value, int) or isinstance(value, bool) \
            or value < 0 or value >> bits:
        raise FlatWireUnencodable(
            "%s=%r does not fit u%d" % (what, value, bits))
    return value


def _ragged_table(columns: List[List[bytes]]) -> Tuple[bytes, bytes]:
    """Column-major string table → (offsets_bytes, blob). ``columns``
    is a list of per-item byte-string lists, all the same length."""
    pieces: List[bytes] = []
    for col in columns:
        pieces.extend(col)
    lens = np.fromiter((len(p) for p in pieces), dtype=np.int64,
                       count=len(pieces))
    offs = np.zeros(len(pieces) + 1, dtype=_U32)
    if len(pieces):
        total = np.cumsum(lens)
        if int(total[-1]) >> 32:
            raise FlatWireUnencodable("string table exceeds u32 offsets")
        offs[1:] = total
    return offs.tobytes(), b"".join(pieces)


class TraceStamp:
    """Advisory causal stamp carried by a version-2 envelope (and by
    the typed THREE_PC_BATCH / PROPAGATE fallback as a plain list).
    Pure data — the timestamp VALUES are produced at the sender's
    flush seam and passed in as arguments; nothing in this module
    reads a clock."""

    __slots__ = ("origin", "seq", "perf_ts", "wall_ts")

    def __init__(self, origin: str, seq: int, perf_ts: float,
                 wall_ts: float):
        self.origin = origin
        self.seq = seq
        self.perf_ts = perf_ts
        self.wall_ts = wall_ts

    def as_list(self) -> list:
        """Typed-fallback wire form (rides a nullable message field)."""
        return [self.origin, self.seq, self.perf_ts, self.wall_ts]

    @classmethod
    def from_wire(cls, value) -> Optional["TraceStamp"]:
        """Typed-fallback decode: ANY content problem → None (the
        stamp is advisory; it can never fail the carrying message)."""
        try:
            origin, seq, perf_ts, wall_ts = value
            origin = str(origin)
            if len(origin.encode("utf-8")) > TRACE_NAME_MAX:
                return None
            seq = int(seq)
            perf_ts = float(perf_ts)
            wall_ts = float(wall_ts)
            if seq < 0 or seq >> 64 \
                    or not math.isfinite(perf_ts) \
                    or not math.isfinite(wall_ts):
                return None
            return cls(origin, seq, perf_ts, wall_ts)
        except Exception:
            return None

    def __repr__(self):
        return ("TraceStamp(origin=%r, seq=%d, perf_ts=%r, wall_ts=%r)"
                % (self.origin, self.seq, self.perf_ts, self.wall_ts))


def encode_trace_stamp(origin: str, flush_seq: int, perf_ts: float,
                       wall_ts: float) -> bytes:
    """TRACE section payload. Deliberately total: the stamp is
    advisory, so an odd origin name or counter is clamped rather than
    failing the envelope it rides on."""
    name = str(origin).encode("utf-8", "replace")[:TRACE_NAME_MAX]
    return b"".join((
        bytes((len(name),)), name,
        (int(flush_seq) & ((1 << 64) - 1)).to_bytes(8, "little"),
        struct.pack("<dd", float(perf_ts), float(wall_ts))))


def decode_trace_stamp(payload: bytes) -> Optional[TraceStamp]:
    """TRACE section payload → TraceStamp, or None on ANY content
    problem — the stamp is advisory and must never fail the envelope."""
    try:
        if len(payload) < 1:
            return None
        nl = payload[0]
        if nl > TRACE_NAME_MAX or len(payload) != 1 + nl + 24:
            return None
        origin = payload[1:1 + nl].decode("utf-8")
        seq = int.from_bytes(payload[1 + nl:9 + nl], "little")
        perf_ts, wall_ts = struct.unpack_from("<dd", payload, 9 + nl)
        if not math.isfinite(perf_ts) or not math.isfinite(wall_ts):
            return None
        return TraceStamp(origin, seq, perf_ts, wall_ts)
    except Exception:
        return None


# ================================================================ encode

def encode_prepares(msgs) -> bytes:
    """PREPARE section payload from typed Prepare messages."""
    n = len(msgs)
    inst = np.empty(n, dtype=_U32)
    view = np.empty(n, dtype=_U64)
    seq = np.empty(n, dtype=_U64)
    tim = np.empty(n, dtype=_F64)
    digest = np.zeros((n, 32), dtype=_U8)
    flags = np.zeros(n, dtype=_U8)
    states: List[bytes] = []
    txns: List[bytes] = []
    audits: List[bytes] = []
    odds: List[bytes] = []
    for i, m in enumerate(msgs):
        inst[i] = _check_uint(m.instId, 32, "instId")
        view[i] = _check_uint(m.viewNo, 64, "viewNo")
        seq[i] = _check_uint(m.ppSeqNo, 64, "ppSeqNo")
        f = 0
        t = m.ppTime
        if isinstance(t, int) and not isinstance(t, bool):
            if int(float(t)) != t:
                raise FlatWireUnencodable("ppTime int exceeds f64")
            f |= F_TIME_INT
        tim[i] = float(t)
        d = m.digest
        hb = None
        if isinstance(d, str) and len(d) == 64:
            try:
                hb = bytes.fromhex(d)
            except ValueError:
                hb = None
            if hb is not None and hb.hex() != d:   # non-canonical hex
                hb = None
        if hb is not None:
            digest[i] = np.frombuffer(hb, dtype=_U8)
            odds.append(b"")
        else:
            f |= F_ODD_DIGEST
            odds.append(str(d).encode("utf-8"))
        for attr, bit, col in (("stateRootHash", F_STATE, states),
                               ("txnRootHash", F_TXN, txns),
                               ("auditTxnRootHash", F_AUDIT, audits)):
            v = getattr(m, attr, None)
            if v is None:
                col.append(b"")
            else:
                f |= bit
                col.append(str(v).encode("utf-8"))
        flags[i] = f
    offs, blob = _ragged_table([states, txns, audits, odds])
    return b"".join((inst.tobytes(), view.tobytes(), seq.tobytes(),
                     tim.tobytes(), digest.tobytes(), flags.tobytes(),
                     offs, blob))


def encode_commits(msgs) -> bytes:
    """COMMIT section payload from typed Commit messages."""
    n = len(msgs)
    inst = np.empty(n, dtype=_U32)
    view = np.empty(n, dtype=_U64)
    seq = np.empty(n, dtype=_U64)
    flags = np.zeros(n, dtype=_U8)
    sigs: List[bytes] = []
    sig_maps: List[bytes] = []
    for i, m in enumerate(msgs):
        inst[i] = _check_uint(m.instId, 32, "instId")
        view[i] = _check_uint(m.viewNo, 64, "viewNo")
        seq[i] = _check_uint(m.ppSeqNo, 64, "ppSeqNo")
        f = 0
        sig = getattr(m, "blsSig", None)
        if sig is None:
            sigs.append(b"")
        else:
            f |= F_BLSSIG
            sigs.append(str(sig).encode("utf-8"))
        sig_map = getattr(m, "blsSigs", None)
        if sig_map is None:
            sig_maps.append(b"")
        else:
            f |= F_BLSSIGS
            sig_maps.append(packb(dict(sig_map)))
        flags[i] = f
    offs, blob = _ragged_table([sigs, sig_maps])
    return b"".join((inst.tobytes(), view.tobytes(), seq.tobytes(),
                     flags.tobytes(), offs, blob))


def encode_blobs(blobs: List[bytes]) -> bytes:
    """Length-prefixed-section payload (PREPREPARE / one column of
    PROPAGATE encoded elsewhere): u32 offset table + concatenated
    blobs."""
    offs, blob = _ragged_table([list(blobs)])
    return offs + blob


def encode_preprepares(msgs) -> bytes:
    ser = _serializer()
    return encode_blobs([ser.serialize(m.to_dict()) for m in msgs])


def encode_propagates(raw_requests: List[bytes],
                      clients: List[str]) -> bytes:
    """PROPAGATE section payload: already-packed request payload blobs
    (the sender packs each request exactly once — the same bytes feed
    the size budget) + client-id strings ("" = unknown)."""
    offs, blob = _ragged_table(
        [list(raw_requests),
         [(c or "").encode("utf-8") for c in clients]])
    return offs + blob


def build_envelope(sections: List[Tuple[int, int, bytes]],
                   trace: Optional[bytes] = None) -> bytes:
    """(kind, count, payload) sections → one flat envelope. ``trace``
    is an already-encoded TRACE payload (encode_trace_stamp) — when
    present the envelope is version 2 and the stamp rides as a
    trailing advisory section; when absent the bytes are version 1,
    identical to the pre-trace wire (golden vectors pin this)."""
    version = VERSION if trace is None else VERSION_TRACE
    nsect = len(sections) + (0 if trace is None else 1)
    if nsect > 255:
        raise FlatWireUnencodable("too many sections")
    out = [MAGIC, bytes((version, nsect))]
    for kind, count, payload in sections:
        out.append(bytes((kind,)))
        out.append(int(count).to_bytes(4, "little"))
        out.append(len(payload).to_bytes(4, "little"))
        out.append(payload)
    if trace is not None:
        out.append(bytes((KIND_TRACE,)))
        out.append((1).to_bytes(4, "little"))
        out.append(len(trace).to_bytes(4, "little"))
        out.append(trace)
    return b"".join(out)


def encode_three_pc(pps, prepares, commits,
                    trace: Optional[bytes] = None) -> bytes:
    """One sender's tick of broadcast 3PC votes → one flat envelope.
    Raises FlatWireUnencodable when a field value cannot ride the flat
    layout (the caller falls back to the typed envelope)."""
    sections = []
    if pps:
        sections.append((KIND_PREPREPARE, len(pps),
                         encode_preprepares(pps)))
    if prepares:
        sections.append((KIND_PREPARE, len(prepares),
                         encode_prepares(prepares)))
    if commits:
        sections.append((KIND_COMMIT, len(commits),
                         encode_commits(commits)))
    return build_envelope(sections, trace=trace)


def encode_propagate_envelope(raw_requests: List[bytes],
                              clients: List[str],
                              trace: Optional[bytes] = None) -> bytes:
    return build_envelope([
        (KIND_PROPAGATE, len(raw_requests),
         encode_propagates(raw_requests, clients))], trace=trace)


# ================================================================ parse

class _Reader:
    """Bounds-checked cursor over the envelope bytes; every numpy view
    aliases the original buffer (zero copies until materialization)."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int, end: int):
        self.buf = buf
        self.pos = pos
        self.end = end

    def take(self, nbytes: int) -> int:
        start = self.pos
        if nbytes < 0 or start + nbytes > self.end:
            raise FlatWireError("section payload truncated")
        self.pos = start + nbytes
        return start

    def view(self, dtype: np.dtype, count: int) -> np.ndarray:
        start = self.take(count * dtype.itemsize)
        return np.frombuffer(self.buf, dtype=dtype, count=count,
                             offset=start)

    def view2d(self, count: int, width: int) -> np.ndarray:
        start = self.take(count * width)
        return np.frombuffer(self.buf, dtype=_U8, count=count * width,
                             offset=start).reshape(count, width)


def _ragged_views(r: _Reader, n_pieces: int):
    """Offset table + blob for a section's string table → (offs view,
    blob_start). Offsets must start at 0, be monotone, and the blob
    must consume the rest of the section exactly."""
    offs = r.view(_U32, n_pieces + 1)
    # unsigned elementwise compare: one fused pass, no temporaries
    # beyond the bool array (diff+astype measured 3x the whole parse
    # at wire-typical sizes)
    if offs[0] != 0 or bool((offs[:-1] > offs[1:]).any()):
        raise FlatWireError("non-monotonic string-table offsets")
    blob_len = int(offs[-1])
    blob_start = r.take(blob_len)
    if r.pos != r.end:
        raise FlatWireError("trailing bytes after section blob")
    return offs, blob_start


class _Section:
    __slots__ = ("n", "_buf", "_offs", "_blob0")

    def _piece(self, col: int, i: int) -> bytes:
        """String-table piece for column ``col``, item ``i``."""
        p = col * self.n + i
        a = self._blob0 + int(self._offs[p])
        b = self._blob0 + int(self._offs[p + 1])
        return self._buf[a:b]


class PrepareColumns(_Section):
    """Parsed PREPARE columns: numpy views over the envelope."""

    kind = KIND_PREPARE
    __slots__ = ("inst", "view", "seq", "time", "digest", "flags")

    def __init__(self, r: _Reader, n: int):
        self.n = n
        self._buf = r.buf
        self.inst = r.view(_U32, n)
        self.view = r.view(_U64, n)
        self.seq = r.view(_U64, n)
        self.time = r.view(_F64, n)
        self.digest = r.view2d(n, 32)
        self.flags = r.view(_U8, n)
        self._offs, self._blob0 = _ragged_views(r, 4 * n)

    def digest_hex(self, i: int) -> str:
        if self.flags[i] & F_ODD_DIGEST:
            return self._piece(3, i).decode("utf-8", "replace")
        return self.digest[i].tobytes().hex()

    def _root(self, i: int, col: int, bit: int) -> Optional[str]:
        if not (self.flags[i] & bit):
            return None
        return self._piece(col, i).decode("utf-8")

    def materialize(self, i: int):
        """Typed, fully validated Prepare for vote-store / stash /
        suspicion insertion; None (logged) when the entry fails schema
        validation — the same fate a bad entry meets on the typed
        envelope path."""
        from plenum_tpu_torch.common.messages.node_messages import Prepare
        t = float(self.time[i])
        if self.flags[i] & F_TIME_INT:
            t = int(t)
        try:
            return Prepare(
                instId=int(self.inst[i]),
                viewNo=int(self.view[i]),
                ppSeqNo=int(self.seq[i]),
                ppTime=t,
                digest=self.digest_hex(i),
                stateRootHash=self._root(i, 0, F_STATE),
                txnRootHash=self._root(i, 1, F_TXN),
                auditTxnRootHash=self._root(i, 2, F_AUDIT))
        except Exception as e:
            logger.warning("flat wire: bad PREPARE entry: %s", e)
            return None


class CommitColumns(_Section):
    """Parsed COMMIT columns: numpy views over the envelope."""

    kind = KIND_COMMIT
    __slots__ = ("inst", "view", "seq", "flags")

    def __init__(self, r: _Reader, n: int):
        self.n = n
        self._buf = r.buf
        self.inst = r.view(_U32, n)
        self.view = r.view(_U64, n)
        self.seq = r.view(_U64, n)
        self.flags = r.view(_U8, n)
        self._offs, self._blob0 = _ragged_views(r, 2 * n)

    def materialize(self, i: int):
        from plenum_tpu_torch.common.messages.node_messages import Commit
        sig = None
        sig_map = None
        try:
            if self.flags[i] & F_BLSSIG:
                sig = self._piece(0, i).decode("utf-8")
            if self.flags[i] & F_BLSSIGS:
                sig_map = unpackb(self._piece(1, i))
            return Commit(instId=int(self.inst[i]),
                          viewNo=int(self.view[i]),
                          ppSeqNo=int(self.seq[i]),
                          blsSig=sig, blsSigs=sig_map)
        except Exception as e:
            logger.warning("flat wire: bad COMMIT entry: %s", e)
            return None


class BlobSection(_Section):
    """Length-prefixed ragged section (PREPREPARE)."""

    kind = KIND_PREPREPARE
    __slots__ = ()

    def __init__(self, r: _Reader, n: int):
        self.n = n
        self._buf = r.buf
        self._offs, self._blob0 = _ragged_views(r, n)

    def raw(self, i: int) -> bytes:
        return self._piece(0, i)

    def materialize(self, i: int):
        """→ typed PrePrepare (validated) or None on a bad entry."""
        from plenum_tpu_torch.common.messages.message_factory import (
            node_message_factory)
        from plenum_tpu_torch.common.messages.node_messages import PrePrepare
        try:
            d = unpackb(self.raw(i))
            msg = node_message_factory.get_instance(**d)
        except Exception as e:
            logger.warning("flat wire: bad PREPREPARE entry: %s", e)
            return None
        if not isinstance(msg, PrePrepare):
            logger.warning("flat wire: non-PREPREPARE entry %s in "
                           "PREPREPARE section — dropped",
                           type(msg).__name__)
            return None
        return msg


class PropagateColumns(_Section):
    """Parsed PROPAGATE section: per-item msgpack request blobs +
    client-id strings, unpacked lazily by the consumer."""

    kind = KIND_PROPAGATE
    __slots__ = ()

    def __init__(self, r: _Reader, n: int):
        self.n = n
        self._buf = r.buf
        self._offs, self._blob0 = _ragged_views(r, 2 * n)

    def request_raw(self, i: int) -> bytes:
        return self._piece(0, i)

    def request(self, i: int) -> dict:
        """Unpacked request payload dict; raises on a bad entry (the
        propagator logs + skips that entry)."""
        d = unpackb(self._piece(0, i))
        if not isinstance(d, dict):
            raise FlatWireError("PROPAGATE entry is not a map")
        return d

    def client(self, i: int) -> str:
        return self._piece(1, i).decode("utf-8", "replace")


_SECTION_TYPES = {
    KIND_PREPARE: PrepareColumns,
    KIND_COMMIT: CommitColumns,
    KIND_PREPREPARE: BlobSection,
    KIND_PROPAGATE: PropagateColumns,
}


class ParsedEnvelope:
    __slots__ = ("sections", "nbytes", "stamp")

    def __init__(self, sections, nbytes, stamp=None):
        self.sections = sections
        self.nbytes = nbytes
        # advisory TraceStamp (or None) — deliberately OUTSIDE
        # ``sections`` so consensus consumers iterating sections can
        # never observe it; only the observability receive hook reads it
        self.stamp = stamp


def parse_envelope(data, max_bytes: Optional[int] = None
                   ) -> ParsedEnvelope:
    """One flat envelope → parsed sections (numpy views, zero copies).
    Raises FlatWireError on ANY structural violation.

    ``max_bytes`` bounds the whole envelope BEFORE any section header
    is trusted — client-facing intakes (the gateway tier) pass their
    wire limit (Config.MSG_LEN_LIMIT) so an over-length envelope is a
    sender-attributable FlatWireError, not a memory bill. Node-to-node
    callers already ride the transport's frame limit and pass None."""
    if isinstance(data, (bytearray, memoryview)):
        data = bytes(data)
    if not isinstance(data, bytes):
        raise FlatWireError("envelope is not bytes")
    if max_bytes is not None and len(data) > max_bytes:
        raise FlatWireError(
            "envelope of %d bytes exceeds the %d-byte limit"
            % (len(data), max_bytes))
    if len(data) < 4 or data[:2] != MAGIC:
        raise FlatWireError("bad magic")
    version = data[2]
    if version not in (VERSION, VERSION_TRACE):
        raise FlatWireError("unsupported version %d" % version)
    nsect = data[3]
    pos = 4
    sections = []
    stamp = None
    for _ in range(nsect):
        if pos + 9 > len(data):
            raise FlatWireError("section header truncated")
        kind = data[pos]
        count = int.from_bytes(data[pos + 1:pos + 5], "little")
        payload_len = int.from_bytes(data[pos + 5:pos + 9], "little")
        pos += 9
        if pos + payload_len > len(data):
            raise FlatWireError("section payload truncated")
        if kind == KIND_TRACE and version >= VERSION_TRACE:
            # advisory: content problems (decode → None) and duplicate
            # stamps are silently tolerated; only the structural
            # payload-bounds check above can fail the envelope
            if stamp is None:
                stamp = decode_trace_stamp(data[pos:pos + payload_len])
            pos += payload_len
            continue
        cls = _SECTION_TYPES.get(kind)
        if cls is None:
            raise FlatWireError("unknown section kind %d" % kind)
        if count == 0 or count > SECTION_COUNT_MAX:
            raise FlatWireError("bad section count %d" % count)
        r = _Reader(data, pos, pos + payload_len)
        sections.append(cls(r, count))
        pos += payload_len
    if pos != len(data):
        raise FlatWireError("trailing bytes after last section")
    if not sections:
        raise FlatWireError("empty envelope")
    return ParsedEnvelope(sections, len(data), stamp)


def unwrap_for_tap(payload) -> Optional[list]:
    """The fault-injection unwrap policy, shared by BOTH tap seams
    (ExternalBus taps and SimNetwork processors): a flat envelope's
    typed per-message contents, or None when the envelope should be
    delivered WHOLE — malformed (the receiving node's evidence to
    judge: per-sender suspicion) or all-entries-invalid (the node's
    own intake does the per-entry dropping and its warn accounting,
    not the tap)."""
    try:
        inner = to_legacy_messages(payload)
    except FlatWireError:
        return None
    return inner or None


def to_legacy_messages(data) -> List:
    """Re-materialize a flat envelope into the typed messages the
    per-message wire would have carried (FIFO section order): 3PC
    sections become individual votes, a PROPAGATE section becomes the
    legacy Propagate / PropagateBatch. Used by the fault-injection
    unwrap seams (ExternalBus tap, SimNetwork processors) so adversary
    behaviors keep matching on per-type messages; entries that fail
    validation are dropped exactly as the typed intake would drop
    them."""
    from plenum_tpu_torch.common.messages.node_messages import (
        Propagate, PropagateBatch)
    env = parse_envelope(data)
    out: List = []
    for sec in env.sections:
        if sec.kind == KIND_PROPAGATE:
            reqs, clients = [], []
            for i in range(sec.n):
                try:
                    reqs.append(sec.request(i))
                except Exception:
                    logger.warning("flat wire: bad PROPAGATE entry "
                                   "— dropped")
                    continue
                clients.append(sec.client(i))
            if not reqs:
                continue
            if len(reqs) == 1:
                out.append(Propagate(request=reqs[0],
                                     senderClient=clients[0] or None))
            else:
                out.append(PropagateBatch(requests=reqs,
                                          clients=clients))
        else:
            for i in range(sec.n):
                msg = sec.materialize(i)
                if msg is not None:
                    out.append(msg)
    return out
