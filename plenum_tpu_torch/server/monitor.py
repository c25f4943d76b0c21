"""Monitor — performance watchdog and primary-failure detection.

Reference: plenum/server/monitor.py (Monitor :136, RequestTimeTracker :30,
isMasterDegraded :425, instance_throughput_ratio :456), pluggable
throughput strategies (plenum/common/throughput_measurements.py: EMA
:25, revival-spike-resistant :99), and
plenum/server/consensus/monitoring/primary_connection_monitor_service.py
(primary disconnected > ToleratePrimaryDisconnection → vote view change).

RBFT's core idea: backup protocol instances exist only to benchmark the
master — if the master's throughput ratio vs the best backup drops below
Δ, the master primary is assumed malicious/slow and a view change fires.
With a single instance (this round), degradation falls back to latency:
requests ordered too slowly (> Λ) trigger the same vote.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Dict, List, Optional

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import (
    PrimaryDisconnected, VoteForViewChange)
from plenum_tpu_torch.runtime.bus import ExternalBus
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService

logger = logging.getLogger(__name__)


class EMAThroughputMeasurement:
    """Exponential-moving-average req/s (reference
    throughput_measurements.py:25)."""

    def __init__(self, window_size: int = 15, min_cnt: int = 16,
                 first_ts: float = 0.0):
        self.window_size = window_size
        self.alpha = 2 / (min_cnt + 1)
        self.throughput = 0.0
        self.reqs_in_window = 0
        self.window_start_ts = first_ts

    def add_request(self, ts: float):
        self._update_time(ts)
        self.reqs_in_window += 1

    def add_requests(self, ts: float, n: int):
        """Bulk variant: one window roll for a whole ordered batch."""
        self._update_time(ts)
        self.reqs_in_window += n

    def get_throughput(self, ts: float) -> Optional[float]:
        self._update_time(ts)
        return self.throughput

    def _update_time(self, ts: float):
        while ts >= self.window_start_ts + self.window_size:
            rate = self.reqs_in_window / self.window_size
            self.throughput = (self.alpha * rate
                               + (1 - self.alpha) * self.throughput)
            self.window_start_ts += self.window_size
            self.reqs_in_window = 0


class RevivalSpikeResistantEMAThroughputMeasurement(EMAThroughputMeasurement):
    """Ignores the throughput spike right after an idle period (reference
    :99 — a revived node bursts through its backlog and would look
    artificially fast)."""

    def __init__(self, window_size: int = 15, min_cnt: int = 16,
                 first_ts: float = 0.0):
        super().__init__(window_size, min_cnt, first_ts)
        self._idle_windows = 0
        self._suppress_windows = 0

    def _update_time(self, ts: float):
        while ts >= self.window_start_ts + self.window_size:
            rate = self.reqs_in_window / self.window_size
            if self.reqs_in_window == 0:
                self._idle_windows += 1
            else:
                if self._idle_windows >= 2:
                    # first active windows after idling: don't learn the
                    # spike
                    self._suppress_windows = 2
                self._idle_windows = 0
            if self._suppress_windows > 0:
                self._suppress_windows -= 1
            else:
                self.throughput = (self.alpha * rate
                                   + (1 - self.alpha) * self.throughput)
            self.window_start_ts += self.window_size
            self.reqs_in_window = 0


class RequestTimeTracker:
    """digest → submission time of requests awaiting ordering (reference
    monitor.py:30)."""

    def __init__(self):
        self._started: Dict[str, float] = {}

    def start(self, digest: str, ts: float):
        self._started.setdefault(digest, ts)

    def order(self, digest: str, ts: float) -> Optional[float]:
        t0 = self._started.pop(digest, None)
        return None if t0 is None else ts - t0

    def peek(self, digest: str, ts: float) -> Optional[float]:
        """Latency if ordered at `ts`, WITHOUT consuming the entry —
        backup instances observe latency but only the master's ordering
        completes a request."""
        t0 = self._started.get(digest)
        return None if t0 is None else ts - t0

    def unordered(self, now: float) -> List[float]:
        return [now - t0 for t0 in self._started.values()]

    def reset(self):
        self._started.clear()


class ClientLatencyMeasurement:
    """Per-client EMA latency (reference latency_measurements.py:17
    EMALatencyMeasurementForEachClient + MedianHighStrategy): one EMA
    per client identifier; the pool-level figure is the high median
    across clients so a single fast client can't mask slow service to
    the rest."""

    MAX_CLIENTS = 1000  # LRU bound: identifiers are client-chosen, so
    # an unbounded map is an attacker-controlled allocation

    def __init__(self, min_latency_count: int = 10):
        from collections import OrderedDict
        self.min_latency_count = min_latency_count
        self.alpha = 1.0 / (min_latency_count + 1)
        # identifier → (ordered_count, ema_latency_seconds), LRU-ordered
        self.avg_latencies: "OrderedDict[str, tuple]" = OrderedDict()
        self.total_reqs = 0

    def add_duration(self, identifier: str, duration: float):
        cnt, ema = self.avg_latencies.get(identifier, (0, 0.0))
        self.avg_latencies[identifier] = (
            cnt + 1, ema * (1 - self.alpha) + duration * self.alpha)
        self.avg_latencies.move_to_end(identifier)
        while len(self.avg_latencies) > self.MAX_CLIENTS:
            self.avg_latencies.popitem(last=False)
        self.total_reqs += 1

    def get_avg_latency(self) -> Optional[float]:
        if self.total_reqs < self.min_latency_count:
            return None
        lats = sorted(ema for _, ema in self.avg_latencies.values())
        return lats[len(lats) // 2]  # high median

    # display bound, not a consensus tunable — the 100 here only shares
    # a value with CHK_FREQ by coincidence
    def per_client(self, limit: int = 100  # plenum-lint: disable=PT005
                   ) -> Dict[str, dict]:
        """Snapshot of the busiest `limit` clients (full map stays
        internal — validator-info dumps must stay bounded)."""
        busiest = sorted(self.avg_latencies.items(),
                         key=lambda kv: -kv[1][0])[:limit]
        return {ident: {"count": cnt, "avg": round(ema, 6)}
                for ident, (cnt, ema) in busiest}

    def reset(self):
        self.avg_latencies.clear()
        self.total_reqs = 0


class Monitor:
    def __init__(self, name: str, timer: TimerService, bus,
                 config: Optional[Config] = None,
                 num_instances_source: Callable[[], int] = lambda: 1):
        self.name = name
        self._timer = timer
        self._bus = bus
        self.config = config or Config()
        self._num_instances = num_instances_source
        # per-instance throughput, instance 0 = master
        self.throughputs: Dict[int, EMAThroughputMeasurement] = {}
        self.request_tracker = RequestTimeTracker()
        self.client_latencies = ClientLatencyMeasurement(
            self.config.MIN_LATENCY_COUNT)
        self.latencies = deque(maxlen=50)
        # per-backup-instance observed latencies for the reference's
        # Ω check (monitor.py:425-490 isMasterAvgReqLatencyTooHigh):
        # a master that keeps ordering — slowly — never trips the
        # throughput ratio, but backups ordering the same requests much
        # faster expose it here
        self.backup_latencies: Dict[int, deque] = {}
        self.total_ordered = 0
        self._warm = False
        from plenum_tpu_torch.utils.metrics import NullMetricsCollector
        self.metrics = NullMetricsCollector()  # node injects the real one

    def _throughput(self, inst_id: int) -> EMAThroughputMeasurement:
        if inst_id not in self.throughputs:
            self.throughputs[inst_id] = \
                RevivalSpikeResistantEMAThroughputMeasurement(
                    window_size=self.config.ThroughputWindowSize,
                    first_ts=self._timer.get_current_time())
        return self.throughputs[inst_id]

    # ------------------------------------------------------------ inputs

    def request_received(self, digest: str):
        self.request_tracker.start(digest,
                                   self._timer.get_current_time())

    def requests_ordered_bulk(self, digest_idr_pairs, inst_id: int = 0):
        """request_ordered for a whole committed batch in one call:
        one clock read, one throughput-window roll, hoisted locals —
        the per-digest variant was a top-10 site on the ordering money
        path (it runs once per request per instance)."""
        now = self._timer.get_current_time()
        self._throughput(inst_id).add_requests(now, len(digest_idr_pairs))
        if inst_id != 0:
            peek = self.request_tracker.peek
            lat_q = self.backup_latencies.setdefault(
                inst_id, deque(maxlen=50))
            for digest, _idr in digest_idr_pairs:
                lat = peek(digest, now)
                if lat is not None:
                    lat_q.append(lat)
            return
        order = self.request_tracker.order
        latencies = self.latencies
        add_dur = self.client_latencies.add_duration
        ordered = 0
        for digest, identifier in digest_idr_pairs:
            latency = order(digest, now)
            if latency is not None:
                latencies.append(latency)
                if identifier:
                    add_dur(identifier, latency)
                ordered += 1
        self.total_ordered += ordered
        self._warm = self._warm or \
            self.total_ordered >= self.config.MIN_LATENCY_COUNT

    def request_ordered(self, digest: str, inst_id: int = 0,
                        identifier: str = None):
        now = self._timer.get_current_time()
        self._throughput(inst_id).add_request(now)
        if inst_id != 0:
            # backups feed the throughput comparison and the Ω latency
            # comparison; the tracker entry must survive (peek, not
            # order) until the MASTER orders it
            lat = self.request_tracker.peek(digest, now)
            if lat is not None:
                self.backup_latencies.setdefault(
                    inst_id, deque(maxlen=50)).append(lat)
            return
        latency = self.request_tracker.order(digest, now)
        if latency is not None:
            self.latencies.append(latency)
            if identifier:
                self.client_latencies.add_duration(identifier, latency)
            self.total_ordered += 1
            self._warm = self._warm or \
                self.total_ordered >= self.config.MIN_LATENCY_COUNT

    def reset(self):
        """View change happened: measurements restart."""
        self.throughputs.clear()
        self.request_tracker.reset()
        self.latencies.clear()
        self.backup_latencies.clear()
        self.client_latencies.reset()

    # --------------------------------------------------------- judgments

    def instance_throughput(self, inst_id: int) -> Optional[float]:
        """Current EMA throughput of one instance (None = no data)."""
        t = self.throughputs.get(inst_id)
        if t is None:
            return None
        return t.get_throughput(self._timer.get_current_time())

    def instance_throughput_ratio(self, inst_id: int = 0) -> Optional[float]:
        """master throughput / best backup throughput (reference :456)."""
        now = self._timer.get_current_time()
        others = [t.get_throughput(now)
                  for i, t in self.throughputs.items() if i != inst_id]
        others = [t for t in others if t]
        if not others:
            return None
        mine = self._throughput(inst_id).get_throughput(now) or 0.0
        return mine / max(others)

    def master_latency_excess(self) -> Optional[float]:
        """Master avg latency minus the best backup's avg latency —
        the reference's Ω divergence (isMasterAvgReqLatencyTooHigh,
        monitor.py:466-490). None until BOTH sides have at least
        MIN_LATENCY_COUNT samples — a single fast backup observation
        against a backlogged master's average must not read as
        divergence (the reference gates both sides the same way)."""
        min_n = self.config.MIN_LATENCY_COUNT
        backup_avgs = [sum(d) / len(d)
                       for d in self.backup_latencies.values()
                       if len(d) >= min_n]
        if not backup_avgs or len(self.latencies) < min_n:
            return None
        master_avg = sum(self.latencies) / len(self.latencies)
        return master_avg - min(backup_avgs)

    def is_master_degraded(self) -> bool:
        """RBFT check (reference isMasterDegraded :425): throughput
        ratio below Δ, master-vs-backup avg latency diverging beyond Ω,
        or (single-instance fallback) requests stuck unordered beyond
        Λ."""
        from plenum_tpu_torch.utils.metrics import MetricsName
        with self.metrics.measure_time(MetricsName.MONITOR_CHECK_TIME):
            return self._is_master_degraded()

    def _is_master_degraded(self) -> bool:
        from plenum_tpu_torch.utils.metrics import MetricsName
        ratio = self.instance_throughput_ratio(0)
        mine = self.instance_throughput(0)
        if mine is not None:
            self.metrics.add_event(MetricsName.MASTER_THROUGHPUT, mine)
        lat = self.avg_latency()
        if lat is not None:
            self.metrics.add_event(MetricsName.MASTER_AVG_LATENCY, lat)
        if ratio is not None and ratio < self.config.DELTA:
            return True
        excess = self.master_latency_excess()
        if excess is not None and self._warm \
                and excess > self.config.OMEGA:
            return True
        now = self._timer.get_current_time()
        stuck = [age for age in self.request_tracker.unordered(now)
                 if age > self.config.LAMBDA]
        return bool(stuck)

    def avg_latency(self) -> Optional[float]:
        if not self.latencies:
            return None
        return sum(self.latencies) / len(self.latencies)


class PrimaryConnectionMonitorService:
    """Votes for a view change when the master primary stays disconnected
    longer than ToleratePrimaryDisconnection (reference
    primary_connection_monitor_service.py)."""

    def __init__(self, data, timer: TimerService, bus,
                 network: ExternalBus, config: Optional[Config] = None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self._primary_disconnected_at: Optional[float] = None
        network.subscribe(ExternalBus.Connected, self._connection_changed)
        network.subscribe(ExternalBus.Disconnected, self._connection_changed)
        # events alone miss the join-while-primary-dead case: a node
        # that starts (or changes views) with the primary already absent
        # never receives a Disconnected event — poll current state too
        self._check_timer = RepeatingTimer(
            timer, max(1.0, self._config.ToleratePrimaryDisconnection / 4),
            self._check)

    def _primary_absent(self) -> bool:
        primary = self._data.primary_name
        return (primary is not None
                and primary != self._data.name
                and primary not in self._network.connecteds)

    def stop(self):
        self._check_timer.stop()

    def _connection_changed(self, msg, frm: str):
        if frm != self._data.primary_name:
            return
        if isinstance(msg, ExternalBus.Disconnected):
            self._primary_disconnected_at = self._timer.get_current_time()
            self._bus.send(PrimaryDisconnected(inst_id=self._data.inst_id))
        else:
            self._primary_disconnected_at = None

    def _check(self):
        if self._primary_disconnected_at is None:
            if self._primary_absent():
                # primary was already gone when we (re)started — begin
                # the tolerance clock now
                self._primary_disconnected_at = \
                    self._timer.get_current_time()
            return
        if not self._primary_absent():
            self._primary_disconnected_at = None
            return
        if self._data.is_primary:
            return
        elapsed = self._timer.get_current_time() \
            - self._primary_disconnected_at
        if elapsed >= self._config.ToleratePrimaryDisconnection:
            logger.info("%s primary %s disconnected for %.0fs — voting "
                        "view change", self._data.name,
                        self._data.primary_name, elapsed)
            self._primary_disconnected_at = self._timer.get_current_time()
            self._bus.send(VoteForViewChange(
                suspicion="PRIMARY_DISCONNECTED"))
