"""Metrics collection: named events, accumulators, KV-backed storage.

Reference: plenum/common/metrics_collector.py (MetricsName :19,
MetricsCollector :331, KvStoreMetricsFormat :388,
KvStoreMetricsCollector :428, measure_time :348). Same model — cheap
in-memory accumulation per metric, periodic flush of compact records to
a KV store keyed by (timestamp, seq) — with a smaller, load-bearing
name set and a built-in reader that aggregates stats back out.
"""
from __future__ import annotations

import math
import struct
import time
from abc import ABC, abstractmethod
from collections import deque
from contextlib import contextmanager
from enum import IntEnum
from typing import Deque, Dict, Iterator, Optional, Tuple


class MetricsName(IntEnum):
    """~50 load-bearing ids wrapping every prod stage, the 3PC money
    path, transport, storage commits, and device dispatch — the subset
    of the reference's ~300-name MetricsName IntEnum
    (plenum/common/metrics_collector.py:19-326) that locates
    bottlenecks. scripts/metrics_stats renders the per-stage breakdown
    offline."""
    # ---- prod loop stages (reference node.py:1036-1076 wraps each)
    NODE_PROD_TIME = 1            # seconds per Node.service tick
    NODE_RX_TIME = 2              # nodestack recv+decode+route per tick
    CLIENT_RX_TIME = 3            # clientstack recv + intake dispatch
    TIMER_SERVICE_TIME = 4        # TimerService callbacks per tick
    TRANSPORT_FLUSH_TIME = 5      # outbox coalesce+seal+send per tick
    LIFECYCLE_TIME = 6            # reconnects/pings per tick
    # ---- ordering pipeline (per 3PC batch, not per request)
    ORDERED_BATCH_COMMITTED = 11  # txns committed per batch
    BACKUP_ORDERED = 13           # batches ordered by backup instances
    THREE_PC_BATCH_SIZE = 14      # digests per PrePrepare sent
    PP_CREATE_TIME = 15           # send_3pc_batch: pop+apply+build
    PP_PROCESS_TIME = 16          # process_preprepare incl. batch apply
    PREPARE_PROCESS_TIME = 17
    COMMIT_PROCESS_TIME = 18
    ORDER_TIME = 19               # _order: Ordered emit + BLS aggregate
    # ---- client intake / request pipeline
    CLIENT_AUTH_BATCH_SIZE = 20   # signatures per device dispatch
    CLIENT_AUTH_TIME = 21         # device-harvest (conclude) seconds
    REQUEST_INTAKE_TIME = 22      # process_client_request per request
    PROPAGATE_PROCESS_TIME = 24   # PROPAGATE receive path per message
    PROPAGATE_FLUSH_TIME = 25     # propagator outbox flush per tick
    BATCH_APPLY_TIME = 26         # executor.apply_batch (uncommitted)
    BATCH_COMMIT_TIME = 27        # executor.commit_batch (ledger+state)
    REPLY_TIME = 28               # reply construct + merkle audit path
    # ---- catchup
    CATCHUP_TXNS_RECEIVED = 30
    CATCHUP_TIME = 31             # start_catchup -> caught up, seconds
    # ---- view change
    VIEW_CHANGE_TIME = 40         # NeedViewChange -> NewView accepted
    INSTANCE_CHANGE_SENT = 41
    # ---- transport
    TRANSPORT_BATCH_SIZE = 50     # messages per outbox flush
    TRANSPORT_BYTES_SENT = 51     # wire bytes per sealed frame batch
    TRANSPORT_BYTES_RECV = 52
    TRANSPORT_MSGS_RECV = 53
    WIRE_ENCODE_TIME = 54         # serialize+seal per outbox flush
    WIRE_DECODE_TIME = 55         # open+decode per service() call
    # ---- garbage collector (reference gc_trackers.py GcTimeTracker):
    # the three *_TIME names MUST stay consecutive — the tracker
    # indexes them as GC_GEN0_TIME + generation
    GC_GEN0_TIME = 60             # seconds paused in a gen-0 collection
    GC_GEN1_TIME = 61
    GC_GEN2_TIME = 62
    GC_COLLECTED_OBJECTS = 63     # objects freed per collection
    GC_UNCOLLECTABLE_OBJECTS = 64
    # ---- device dispatch + crypto
    DEVICE_DISPATCH_TIME = 70     # host-side launch cost per dispatch
    BLS_AGGREGATE_TIME = 72       # process_order share aggregation
    BLS_VALIDATE_TIME = 73        # validate_commit pairing check
    # ---- storage commits (inside BATCH_COMMIT_TIME)
    LEDGER_COMMIT_TIME = 75       # merkle append + txn log write
    STATE_COMMIT_TIME = 76        # MPT commit to new root
    AUDIT_BATCH_TIME = 77         # audit txn build + append
    # ---- monitor observations
    MASTER_THROUGHPUT = 80
    MASTER_AVG_LATENCY = 81
    MONITOR_CHECK_TIME = 82


class ValueAccumulator:
    """count/sum/sumsq/min/max running stats for one metric between
    flushes. Keeping the SUM OF SQUARES (not a running variance) is
    what makes `merge` exact: variances don't add across windows, but
    (count, sum, sumsq) triples do — merged-then-read stddev equals
    recording everything into one accumulator. `sumsq` is None for
    records decoded from the pre-variance on-disk format (their
    squares are unrecoverable), and merging any such record poisons
    the merged stddev to None rather than inventing a number."""

    __slots__ = ("count", "sum", "min", "max", "sumsq")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.sumsq: Optional[float] = 0.0

    def add(self, value: float):
        self.count += 1
        self.sum += value
        if self.sumsq is not None:
            self.sumsq += value * value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    @property
    def avg(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    @property
    def stddev(self) -> Optional[float]:
        """Population standard deviation; None when empty or when any
        merged-in record predates the sumsq format."""
        if not self.count or self.sumsq is None:
            return None
        mean = self.sum / self.count
        var = self.sumsq / self.count - mean * mean
        return math.sqrt(var) if var > 0.0 else 0.0

    def merge(self, other: "ValueAccumulator"):
        if (self.count and self.sumsq is None) or \
                (other.count and other.sumsq is None):
            self.sumsq = None
        else:
            self.sumsq = (self.sumsq or 0.0) + (other.sumsq or 0.0)
        self.count += other.count
        self.sum += other.sum
        for v in (other.min, other.max):
            if v is None:
                continue
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)


class MetricsCollector(ABC):
    """add_event accumulates in memory; flush_accumulated persists."""

    def __init__(self, get_time=time.time):
        self._get_time = get_time
        self._acc: Dict[int, ValueAccumulator] = {}

    def add_event(self, name: MetricsName, value: float):
        acc = self._acc.get(int(name))
        if acc is None:
            acc = self._acc[int(name)] = ValueAccumulator()
        acc.add(float(value))

    def flush_accumulated(self):
        ts = self._get_time()
        for name, acc in self._acc.items():
            self._store(ts, name, acc)
        self._acc.clear()

    @abstractmethod
    def _store(self, ts: float, name: int, acc: ValueAccumulator): ...

    @contextmanager
    def measure_time(self, name: MetricsName):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_event(name, time.perf_counter() - start)


class NullMetricsCollector(MetricsCollector):
    def add_event(self, name, value):
        pass

    def _store(self, ts, name, acc):
        pass


_RECORD = struct.Struct(">dHIdddd")  # ts, name, count, sum, min, max, sumsq
# the pre-variance record layout (no sumsq); still decoded on read so
# stores written by earlier builds keep parsing — their stddev reads
# as unknown (None), never as a fabricated 0
_RECORD_V1 = struct.Struct(">dHIddd")  # ts, name, count, sum, min, max


class KvStoreMetricsCollector(MetricsCollector):
    """Flushes accumulator records to a KeyValueStorage. Key = 8-byte
    big-endian microsecond timestamp + 4-byte seq (sortable, unique);
    value = packed (ts, name, count, sum, min, max, sumsq). Records in
    the old sumsq-less layout are decoded transparently."""

    def __init__(self, storage, get_time=time.time,
                 max_records: Optional[int] = 100_000):
        """max_records=None disables retention entirely — the mode for
        READ-ONLY consumers (scripts/metrics_stats): a reporting tool
        must never trim a live node's history on open."""
        super().__init__(get_time)
        self._storage = storage
        self._seq = 0
        self._max_records = max_records
        # insertion order (keys sort by flush timestamp), for retention
        self._record_keys: Deque[bytes] = deque()
        # running per-metric totals so summary() is O(metrics), not
        # O(stored history); BOTH the totals and the retention index are
        # seeded from whatever is already on disk — an unseeded index
        # would make the max_records cap count only this run's records,
        # letting prior-run history survive every restart untrimmed
        self._totals: Dict[int, ValueAccumulator] = {}
        for key, _ts, name, acc in self._iter_records():
            self._totals.setdefault(name, ValueAccumulator()).merge(acc)
            self._record_keys.append(key)
        self._trim()   # cap may have shrunk since the records landed

    def _store(self, ts: float, name: int, acc: ValueAccumulator):
        key = struct.pack(">QI", int(ts * 1e6), self._seq)
        self._seq = (self._seq + 1) & 0xFFFFFFFF
        value = _RECORD.pack(ts, name, acc.count, acc.sum,
                             acc.min if acc.min is not None else 0.0,
                             acc.max if acc.max is not None else 0.0,
                             acc.sumsq if acc.sumsq is not None
                             else float("nan"))
        self._storage.put(key, value)
        self._totals.setdefault(name, ValueAccumulator()).merge(acc)
        # retention: drop oldest records past the cap (totals keep the
        # all-time aggregate; only the per-flush history is trimmed)
        self._record_keys.append(key)
        self._trim()

    def _trim(self):
        if self._max_records is None:
            return
        while len(self._record_keys) > self._max_records:
            old = self._record_keys.popleft()
            try:
                self._storage.remove(old)
            except Exception:
                # a store that refuses removal keeps the record AND its
                # index entry — retrying next flush beats losing track
                self._record_keys.appendleft(old)
                break

    def _iter_records(self) -> Iterator[
            Tuple[bytes, float, int, ValueAccumulator]]:
        """Decode every stored record — the ONE place that understands
        the on-disk format (restart seeding and events() both ride it)."""
        for key, value in self._storage.iterator():
            if len(value) == _RECORD.size:
                ts, name, count, total, mn, mx, sumsq = \
                    _RECORD.unpack(value)
                if sumsq != sumsq:      # NaN sentinel → unknown
                    sumsq = None
            elif len(value) == _RECORD_V1.size:
                # old 4-tuple (count/sum/min/max) record: parses fine,
                # stddev unknown
                ts, name, count, total, mn, mx = _RECORD_V1.unpack(value)
                sumsq = None
            else:
                continue
            acc = ValueAccumulator()
            acc.count, acc.sum = count, total
            acc.min, acc.max = mn, mx
            acc.sumsq = sumsq
            yield bytes(key), ts, name, acc

    def events(self) -> Iterator[Tuple[float, int, ValueAccumulator]]:
        for _key, ts, name, acc in self._iter_records():
            yield ts, name, acc

    def summary(self) -> Dict[str, dict]:
        """All-time per-metric stats (incl. unflushed) from the running
        totals — O(number of metrics), never walks stored history."""
        totals: Dict[int, ValueAccumulator] = {}
        for name, acc in self._totals.items():
            merged = ValueAccumulator()
            merged.merge(acc)
            totals[name] = merged
        for name, acc in self._acc.items():
            totals.setdefault(name, ValueAccumulator()).merge(acc)
        out = {}
        for name, acc in sorted(totals.items()):
            try:
                label = MetricsName(name).name
            except ValueError:
                label = str(name)
            out[label] = {"count": acc.count, "sum": acc.sum,
                          "avg": acc.avg, "min": acc.min, "max": acc.max,
                          "stddev": acc.stddev}
        return out


