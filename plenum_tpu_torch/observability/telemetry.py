"""Always-on telemetry plane — latency histograms, device-efficiency
accounting, pool health.

The third instrument next to the metrics accumulators (utils/metrics.py
— aggregate count/sum/min/max, no percentiles) and the flight recorder
(observability/tracing.py — causal span timelines, off by default).
This plane is ON by default and cheap enough to stay on in production
(bench.py ``telemetry_overhead`` A/Bs the identical 4-node pool with it
on vs off and gates the cost under 2%): a serving tier is judged on
tail latency, and a padding-efficiency regression at a device seam is
the consensus-stack analog of an MFU drop — both must be *recorded
trajectories*, not post-hoc debugging.

Three metric families:

* **End-to-end latency histograms** on the money path: intake→reply
  per ordered request (``TM.ORDERED_E2E_MS``) plus per-stage
  durations (propagate-quorum wait, 3PC, fused dispatch window,
  execute, reply), keyed by the same request digests the flight
  recorder stamps.
* **Device-efficiency accounting** at every dispatch half: each seam
  that bucket-pads its batches (verifier hub/daemon ed25519, sha256 /
  sha3 block buckets, mesh shard padding, merkle append levels, BLS
  job axis, trie_jax levels) records useful rows vs padded lanes per
  launch — ``lane_occupancy`` = useful/lanes — plus dispatch→collect
  round-trip and inter-dispatch idle-gap histograms, and compile
  events (a new bucket shape per seam is counted and its first-call
  latency recorded, so a shape explosion reads as a number instead of
  a mystery stall).
* **Pool health**: backlog depth, stash sizes, request-queue depth
  gauges, and view-change / catchup counters bridged from the
  recovery lane.

Design constraints:

* **Preallocated log-linear histograms.** One fixed numpy int64
  bucket array per histogram: SUB linear sub-buckets per power-of-two
  octave from ``lo`` up, so any recorded value lands in a bucket whose
  relative width is at most 1/SUB — quantile readout (p50/p95/p99/
  p999) has bounded relative error by construction, and two nodes'
  histograms merge by adding count arrays (pool-wide percentiles are
  exact merges, not approximations of approximations).
* **Lock-cheap record.** One uncontended lock around a handful of
  scalar updates (~100 ns); no allocation, no I/O, no string
  formatting on the hot path.
* **Registry-constant names.** Every metric name is a ``TM`` constant
  and every seam name a ``SEAM_*`` constant; lint rule PT009 flags
  dynamically-built names at record sites (unbounded cardinality),
  and the dead-name test pins every registry entry to a live
  recording site under plenum_tpu_torch/.

Exposition: ``snapshot()`` (node-local dict), ``merge`` (pool-wide
aggregation in sim), ``prometheus_text`` / ``write_prometheus``
(Prometheus text format, written per flush interval when
``Config.TELEMETRY_PROM_DIR`` is set), a ``Telemetry`` section in
``ValidatorNodeInfoTool.info``, counter tracks on the merged Perfetto
timeline (observability/export.py), and the ``scripts/telemetry_stats``
table renderer.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np


class TM:
    """Telemetry metric name registry. Record sites MUST use these
    constants — a dynamically-built name at a record site is unbounded
    cardinality (lint PT009) and invisible to the dead-name test."""

    # ---- end-to-end latency (money path; milliseconds, wall clock)
    ORDERED_E2E_MS = "ordered_e2e_ms"          # intake accept -> reply
    STAGE_PROPAGATE_MS = "stage_propagate_ms"  # accept -> quorum forward
    STAGE_3PC_MS = "stage_3pc_ms"              # PP create/process -> order
    STAGE_DISPATCH_MS = "stage_dispatch_ms"    # fused device window
    STAGE_EXECUTE_MS = "stage_execute_ms"      # batch apply (speculative)
    STAGE_COMMIT_MS = "stage_commit_ms"        # batch commit (durable)
    STAGE_REPLY_MS = "stage_reply_ms"          # reply construct + proofs

    # ---- conflict-lane executor (server/executor.py): per-batch lane
    # accounting — how parallel the declared-key partition actually is
    EXEC_LANES_PER_BATCH = "exec_lanes_per_batch"    # hist: lane count
    EXEC_CONFLICT_PCT = "exec_conflict_pct"          # hist: 0..100
    EXEC_SERIAL_FALLBACK = "exec_serial_fallback_reqs"  # counter

    # ---- wire plane (flat zero-copy codec; recorded into the SEAM
    # hub — the wire is a process-shared resource like the device
    # seams, and pool-wide reports merge it the same way)
    WIRE_BYTES_SENT = "wire_bytes_sent"        # counter: flat payload B
    WIRE_BYTES_RECV = "wire_bytes_recv"        # counter: flat payload B
    WIRE_ENV_BYTES_3PC = "wire_env_bytes_three_pc"      # hist: env size
    WIRE_ENV_BYTES_PROPAGATE = "wire_env_bytes_propagate"
    WIRE_VOTE_BYTES_PREPARE = "wire_vote_bytes_prepare"  # hist: B/vote
    WIRE_VOTE_BYTES_COMMIT = "wire_vote_bytes_commit"
    WIRE_VOTE_BYTES_PREPREPARE = "wire_vote_bytes_preprepare"
    WIRE_MALFORMED = "wire_malformed"          # counter: rejected envs

    # ---- gateway tier (plenum_tpu_torch/gateway/): the client-facing front
    # door — admission verdicts, shed ladder, signed-read cache and the
    # gateway-side tail the open-loop bench gates on
    GATEWAY_E2E_MS = "gateway_e2e_ms"            # hist: arrive→outcome
    GATEWAY_ADMITTED = "gateway_admitted"        # counter: entered pool
    GATEWAY_SHED_READS = "gateway_shed_reads"    # counter: degraded 1st
    GATEWAY_SHED_WRITES = "gateway_shed_writes"  # counter: degraded 2nd
    GATEWAY_DEDUP_HITS = "gateway_dedup_hits"    # counter: dup payloads
    GATEWAY_SIG_REJECTS = "gateway_sig_rejects"  # counter: pre-screen
    GATEWAY_CACHE_HITS = "gateway_cache_hits"    # counter: signed reads
    GATEWAY_CACHE_MISSES = "gateway_cache_misses"  # counter
    GATEWAY_SHED_SENDERS = "gateway_shed_senders"  # counter: wire abuse
    GATEWAY_BACKLOG = "gateway_backlog"          # gauge: in-flight
    GATEWAY_LANES_PER_BATCH = "gateway_lanes_per_batch"  # hist

    # ---- journey plane (observability/journey.py): quorum critical-
    # path attribution on the money path. The margin histogram records,
    # per ordered batch and phase, how late the LAST counted straggler
    # vote landed after the quorum had already closed (0 = the closing
    # vote was also the last); the lateness family is the same signal
    # split per peer (labeled histogram — the label is a VALUE, the
    # family name stays a registry constant, PT009-clean), naming which
    # peers consistently trail the quorum.
    QUORUM_CLOSE_MARGIN_MS = "quorum_close_margin_ms"
    PEER_VOTE_LATENESS_MS = "peer_vote_lateness_ms"  # labeled by peer

    # ---- pool health
    BACKLOG_DEPTH = "backlog_depth"            # gauge: in-flight requests
    REQUEST_QUEUE_DEPTH = "request_queue_depth"  # gauge: finalised queue
    STASH_DEPTH = "stash_depth"                # gauge: ordering stashes
    VIEW_CHANGES = "view_changes"              # counter (recovery lane)
    CATCHUPS = "catchups"                      # counter (recovery lane)
    ORDERED_REQUESTS = "ordered_requests"      # counter
    E2E_DROPPED = "e2e_dropped"                # counter: intake-ts map full

    # ---- pipeline runtime (runtime/pipeline.py). Stage histograms are
    # wall-clock per job on the worker side; queue_wait is the
    # enqueue→prod-delivery handoff latency (the budget's `queue_wait`
    # stage — handoff cost stays attributable instead of smearing into
    # 3PC); depth gauges are the backpressure signals the admission
    # ladder folds into BACKLOG_DEPTH.
    PIPELINE_QUEUE_DEPTH = "pipeline_queue_depth"        # gauge: jobs
    PIPELINE_EXEC_QUEUE_DEPTH = "pipeline_exec_queue_depth"  # gauge
    PIPELINE_PARSE_MS = "pipeline_parse_ms"              # histogram
    PIPELINE_PRESCREEN_MS = "pipeline_prescreen_ms"      # histogram
    PIPELINE_QUEUE_WAIT_MS = "pipeline_queue_wait_ms"    # histogram


# ---- device seams (lane accounting). One constant per bucket-padding
# dispatch half; the seam string becomes the `seam` label in snapshots
# and Prometheus exposition.
SEAM_MESH = "mesh"                    # ops/mesh.py shard padding
SEAM_ED25519 = "ed25519"              # verify_batch_async pow2 bucket
SEAM_HUB = "hub_ed25519"              # CoalescingVerifierHub launches
SEAM_DAEMON = "daemon_ed25519"        # verify daemon fixed buckets
SEAM_SHA256 = "sha256"                # SHA-256 block buckets
SEAM_SHA3 = "sha3"                    # SHA3 block buckets
SEAM_TRIE = "trie_jax"                # MPT level batch-axis buckets
SEAM_MERKLE_APPEND = "merkle_append"  # per-level append buckets
SEAM_MERKLE_BUILD = "merkle_build"    # pow2 capacity builds
SEAM_BLS = "bls_jobs"                 # BLS job-axis identity padding
SEAM_BLS_PAIR = "bls_pairing"         # pairing verify (job, pair) buckets
SEAM_BLS_MSM = "bls_msm"              # windowed MSM point-axis buckets


def _cfg(name: str, default):
    from plenum_tpu_torch.common.config import Config
    return getattr(Config, name, default)


# ------------------------------------------------------------ histogram

# shared bucket-edge arrays, one per (lo, octaves, sub) configuration
_EDGE_CACHE: Dict[Tuple[float, int, int], np.ndarray] = {}


def _edges(lo: float, octaves: int, sub: int) -> np.ndarray:
    """Bucket LOWER edges: edge[0]=0 (underflow), then lo·2^o·(1+s/sub)
    for o in [0, octaves), s in [0, sub), then the overflow bucket at
    lo·2^octaves. len == n_buckets == 2 + octaves·sub."""
    key = (lo, octaves, sub)
    cached = _EDGE_CACHE.get(key)
    if cached is None:
        scale = lo * np.power(2.0, np.arange(octaves))[:, None]
        lin = 1.0 + np.arange(sub)[None, :] / sub
        body = (scale * lin).reshape(-1)
        cached = _EDGE_CACHE[key] = np.concatenate(
            [[0.0], body, [lo * 2.0 ** octaves]])
    return cached


class LogLinearHistogram:
    """Preallocated log-linear histogram with bounded-relative-error
    quantiles.

    Buckets: one underflow bucket below ``lo``, then ``sub`` linear
    sub-buckets per power-of-two octave for ``octaves`` octaves, then
    one overflow bucket. A value v >= lo lands in a bucket whose width
    relative to its lower edge is at most 1/sub, so any quantile
    estimate is within a factor (1 + 1/sub) of the true order
    statistic. Defaults (lo=1 µs in ms units, 30 octaves, 16
    sub-buckets) cover 1 µs .. ~18 min at <= 6.25% relative error in
    482 int64 buckets (~4 KB).

    ``merge`` adds count arrays — pool-wide quantiles from per-node
    histograms are exactly the quantiles of recording into one hub.
    """

    __slots__ = ("lo", "octaves", "sub", "counts", "count", "total",
                 "vmin", "vmax", "_lock")

    def __init__(self, lo: float = None, octaves: int = None,
                 sub: int = None):
        self.lo = float(_cfg("TELEMETRY_HIST_LO_MS", 0.001)
                        if lo is None else lo)
        self.octaves = int(_cfg("TELEMETRY_HIST_OCTAVES", 30)
                           if octaves is None else octaves)
        self.sub = int(_cfg("TELEMETRY_HIST_SUB_BUCKETS", 16)
                       if sub is None else sub)
        self.counts = np.zeros(2 + self.octaves * self.sub,
                               dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._lock = threading.Lock()

    def _index(self, value: float) -> int:
        r = value / self.lo
        if r < 1.0:
            return 0
        # r = m · 2^e with m in [0.5, 1) → octave e-1, linear position
        # within the octave = 2m - 1 in [0, 1)
        m, e = math.frexp(r)
        octave = e - 1
        if octave >= self.octaves:
            return len(self.counts) - 1
        return 1 + octave * self.sub + int((m + m - 1.0) * self.sub)

    def record(self, value: float) -> None:
        value = float(value)
        if value < 0.0 or value != value:      # negative / NaN: drop
            return
        idx = self._index(value)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.total += value
            if self.vmin is None or value < self.vmin:
                self.vmin = value
            if self.vmax is None or value > self.vmax:
                self.vmax = value

    def quantile(self, q: float) -> Optional[float]:
        """q in [0, 1] → bucket representative (midpoint) holding the
        nearest-rank order statistic; None when empty."""
        with self._lock:
            n = self.count
            if n == 0:
                return None
            rank = min(n, max(1, int(math.ceil(q * n))))
            cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank))
        edges = _edges(self.lo, self.octaves, self.sub)
        lo_edge = edges[idx]
        hi_edge = edges[idx + 1] if idx + 1 < len(edges) else edges[idx]
        # clamp into the observed range: a single-bucket distribution
        # must not report a quantile outside [min, max]
        mid = (lo_edge + hi_edge) / 2.0
        if self.vmax is not None:
            mid = min(mid, self.vmax)
        if self.vmin is not None:
            mid = max(mid, self.vmin)
        return float(mid)

    def merge(self, other: "LogLinearHistogram") -> None:
        assert (self.lo, self.octaves, self.sub) == \
            (other.lo, other.octaves, other.sub), \
            "histogram configs must match to merge"
        with other._lock:
            counts = other.counts.copy()
            count, total = other.count, other.total
            vmin, vmax = other.vmin, other.vmax
        with self._lock:
            self.counts += counts
            self.count += count
            self.total += total
            if vmin is not None:
                self.vmin = vmin if self.vmin is None \
                    else min(self.vmin, vmin)
            if vmax is not None:
                self.vmax = vmax if self.vmax is None \
                    else max(self.vmax, vmax)

    def snapshot(self, buckets: bool = False) -> dict:
        with self._lock:
            out = {
                "count": self.count,
                "sum": round(self.total, 6),
                "min": self.vmin,
                "max": self.vmax,
            }
            if buckets:
                nz = np.nonzero(self.counts)[0]
                out["buckets"] = {int(i): int(self.counts[i]) for i in nz}
                out["lo"] = self.lo
                out["sub"] = self.sub
                out["octaves"] = self.octaves
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99),
                         ("p999", 0.999)):
            v = self.quantile(q)
            out[label] = round(v, 6) if v is not None else None
        return out


# ----------------------------------------------------------- seam stats

class _SeamStats:
    """Device-efficiency accounting for one dispatch seam."""

    __slots__ = ("launches", "useful_rows", "lane_rows", "shapes",
                 "compile_events", "last_launch_t", "idle_gap",
                 "roundtrip", "first_call")

    def __init__(self):
        self.launches = 0
        self.useful_rows = 0
        self.lane_rows = 0
        self.shapes = set()      # distinct bucket shapes seen (capped)
        self.compile_events = 0
        self.last_launch_t: Optional[float] = None
        self.idle_gap = LogLinearHistogram()
        self.roundtrip = LogLinearHistogram()
        self.first_call = LogLinearHistogram()

    def merge(self, other: "_SeamStats") -> None:
        self.launches += other.launches
        self.useful_rows += other.useful_rows
        self.lane_rows += other.lane_rows
        self.shapes |= other.shapes
        self.compile_events += other.compile_events
        if other.last_launch_t is not None:
            self.last_launch_t = other.last_launch_t \
                if self.last_launch_t is None \
                else max(self.last_launch_t, other.last_launch_t)
        self.idle_gap.merge(other.idle_gap)
        self.roundtrip.merge(other.roundtrip)
        self.first_call.merge(other.first_call)

    def snapshot(self) -> dict:
        occ = (self.useful_rows / self.lane_rows) if self.lane_rows \
            else None
        return {
            "launches": self.launches,
            "useful_rows": self.useful_rows,
            "lane_rows": self.lane_rows,
            "lane_occupancy": round(occ, 4) if occ is not None else None,
            "shapes": len(self.shapes),
            "compile_events": self.compile_events,
            "roundtrip_ms": self.roundtrip.snapshot(),
            "idle_gap_ms": self.idle_gap.snapshot(),
            "first_call_ms": self.first_call.snapshot(),
        }


# ------------------------------------------------------------- the hub

class _TimerCtx:
    __slots__ = ("_hub", "_name", "_t0")

    def __init__(self, hub: "TelemetryHub", name: str):
        self._hub = hub
        self._name = name

    def __enter__(self):
        self._t0 = self._hub._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._hub.observe(self._name,
                          (self._hub._clock() - self._t0) * 1e3)
        return False


class TelemetryHub:
    """Per-node (or per-process, for the shared device seams) telemetry
    recorder: counters, gauges, log-linear histograms and per-seam
    device-efficiency accounting, mergeable across nodes."""

    enabled = True

    def __init__(self, name: str = "", clock=time.perf_counter):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Tuple[float, float]] = {}   # name→(t, v)
        self._hists: Dict[str, LogLinearHistogram] = {}
        # family → label → histogram (observe_labeled); label count
        # capped per family — overflow folds into "_other" so a
        # hostile/huge label set can never grow the registry unbounded
        self._labeled: Dict[str, Dict[str, LogLinearHistogram]] = {}
        self._seams: Dict[str, _SeamStats] = {}
        history = int(_cfg("TELEMETRY_FLUSH_HISTORY", 512))
        self._flush_history: deque = deque(maxlen=history)

    # ---------------------------------------------------------- recording

    def clock(self) -> float:
        return self._clock()

    def _hist(self, name: str) -> LogLinearHistogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, LogLinearHistogram())
        return h

    def observe(self, name: str, value_ms: float) -> None:
        """Record one histogram observation (milliseconds for *_MS
        metrics)."""
        self._hist(name).record(value_ms)

    def timer(self, name: str) -> _TimerCtx:
        """Context manager observing the block's wall duration (ms)."""
        return _TimerCtx(self, name)

    def observe_labeled(self, name: str, label: str,
                        value_ms: float) -> None:
        """Record into the labeled-histogram family ``name`` under
        ``label`` (e.g. a peer node name). The FAMILY name must be a
        TM registry constant (PT009: dynamic names at record sites are
        unbounded cardinality); the label is a value, capped per family
        at TELEMETRY_LABELS_MAX distinct entries — later labels fold
        into "_other" instead of growing the registry."""
        fam = self._labeled.get(name)
        if fam is None:
            with self._lock:
                fam = self._labeled.setdefault(name, {})
        h = fam.get(label)
        if h is None:
            with self._lock:
                if label not in fam and \
                        len(fam) >= int(_cfg("TELEMETRY_LABELS_MAX", 64)):
                    label = "_other"
                h = fam.setdefault(label, LogLinearHistogram())
        h.record(value_ms)

    def labeled(self, name: str) -> dict:
        """The live label → histogram map for one family ({} if never
        recorded). Read-only for callers, like ``histogram``."""
        return self._labeled.get(name) or {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        sample = (self._clock(), float(value))
        with self._lock:
            self._gauges[name] = sample

    def _seam(self, seam: str) -> _SeamStats:
        s = self._seams.get(seam)
        if s is None:
            with self._lock:
                s = self._seams.setdefault(seam, _SeamStats())
        return s

    def record_launch(self, seam: str, useful: int, lanes: int,
                      shape=None) -> bool:
        """Account one device launch at a bucket-padding seam:
        ``useful`` real rows out of ``lanes`` launched lanes (padding =
        lanes - useful). Records the inter-dispatch idle gap, and when
        ``shape`` (the compile-relevant bucket shape) is new for this
        seam, counts a compile event. → True iff the shape was new (the
        caller can route its round-trip measurement to the first-call
        histogram)."""
        s = self._seam(seam)
        now = self._clock()
        new_shape = False
        with self._lock:
            s.launches += 1
            s.useful_rows += int(useful)
            s.lane_rows += int(lanes)
            if s.last_launch_t is not None:
                gap = (now - s.last_launch_t) * 1e3
            else:
                gap = None
            s.last_launch_t = now
            if shape is not None and shape not in s.shapes:
                new_shape = True
                s.compile_events += 1
                if len(s.shapes) < int(_cfg("TELEMETRY_SHAPE_CAP", 4096)):
                    s.shapes.add(shape)
        if gap is not None:
            s.idle_gap.record(gap)
        return new_shape

    def record_roundtrip(self, seam: str, ms: float,
                         first_call: bool = False) -> None:
        """Record one dispatch→collect round trip for a seam; with
        ``first_call`` (a launch whose bucket shape was new) the
        latency also lands in the seam's first-call histogram — the
        compile cost trajectory."""
        s = self._seam(seam)
        s.roundtrip.record(ms)
        if first_call:
            s.first_call.record(ms)

    # ------------------------------------------------------------ reading

    def merge(self, other: "TelemetryHub") -> "TelemetryHub":
        """Fold another hub's state into this one (pool-wide
        aggregation): counters and histograms add, gauges keep the
        newest sample, seams add. → self."""
        if not getattr(other, "enabled", False):
            return self
        with other._lock:
            counters = dict(other._counters)
            gauges = dict(other._gauges)
            hists = list(other._hists.items())
            labeled = [(name, list(fam.items()))
                       for name, fam in other._labeled.items()]
            seams = list(other._seams.items())
        for name, n in counters.items():
            self.count(name, n)
        with self._lock:
            for name, (t, v) in gauges.items():
                cur = self._gauges.get(name)
                if cur is None or t >= cur[0]:
                    self._gauges[name] = (t, v)
        for name, hist in hists:
            self._hist(name).merge(hist)
        for name, fam in labeled:
            with self._lock:
                mine = self._labeled.setdefault(name, {})
                # merge is aggregation-time: peers' label sets are
                # already capped at their record sites, so no re-cap
                for label, _h in fam:
                    mine.setdefault(label, LogLinearHistogram())
            for label, hist in fam:
                mine[label].merge(hist)
        for seam, stats in seams:
            self._seam(seam).merge(stats)
        return self

    def gauge_sample(self, name: str):
        """The (timestamp, value) sample of a gauge, or None if it was
        never set — read seam for live pressure consumers (the gateway
        admission ladder) that must not pay a full snapshot per tick."""
        with self._lock:
            return self._gauges.get(name)

    def histogram(self, name: str):
        """The live histogram recorded under ``name`` (None if never
        recorded). Read-only for callers: mergers fold it into their
        own scratch histogram (LogLinearHistogram.merge is add-only)."""
        return self._hists.get(name)

    def snapshot(self, buckets: bool = False) -> dict:
        """Node-local state dump. With ``buckets`` the histograms carry
        their sparse bucket arrays (what Prometheus exposition needs)."""
        with self._lock:
            # copy the registries under the lock: a concurrent first
            # record of a new name must not resize a dict mid-iteration
            # (the seam hub is recorded into from the verify-daemon
            # worker while validator info snapshots it)
            counters = dict(self._counters)
            gauges = {k: v for k, (_t, v) in self._gauges.items()}
            hists = sorted(self._hists.items())
            labeled = sorted((name, sorted(fam.items()))
                             for name, fam in self._labeled.items())
            seams = sorted(self._seams.items())
        return {
            "node": self.name,
            "enabled": True,
            "t": self._clock(),
            "counters": counters,
            "gauges": gauges,
            "histograms": {name: h.snapshot(buckets=buckets)
                           for name, h in hists},
            "labeled": {name: {label: h.snapshot(buckets=buckets)
                               for label, h in fam}
                        for name, fam in labeled},
            "seams": {seam: s.snapshot() for seam, s in seams},
        }

    def flush(self) -> dict:
        """Take a timestamped sample of the headline series (counter
        totals, gauges, histogram p50/p99, per-seam occupancy) into the
        bounded flush history — the time axis the Perfetto exporter
        renders as counter tracks. → the sample."""
        t = self._clock()
        sample: Dict[str, float] = {}
        with self._lock:
            for name, n in self._counters.items():
                sample[name] = n
            for name, (_t, v) in self._gauges.items():
                sample[name] = v
            hists = sorted(self._hists.items())
            labeled = sorted((name, sorted(fam.items()))
                             for name, fam in self._labeled.items())
            seams = sorted(self._seams.items())
        for name, fam in labeled:
            for label, h in fam:
                p99 = h.quantile(0.99)
                if p99 is not None:
                    sample[name + "." + label + ".p99"] = round(p99, 4)
        for name, h in hists:
            p50, p99 = h.quantile(0.50), h.quantile(0.99)
            if p50 is not None:
                sample[name + ".p50"] = round(p50, 4)
            if p99 is not None:
                sample[name + ".p99"] = round(p99, 4)
        for seam, s in seams:
            if s.lane_rows:
                sample["lane_occupancy." + seam] = round(
                    s.useful_rows / s.lane_rows, 4)
        self._flush_history.append((t, sample))
        return sample

    def flush_history(self):
        return list(self._flush_history)

    # --------------------------------------------------------- exposition

    def to_prometheus(self) -> str:
        return prometheus_text(self.snapshot(buckets=True))

    def write_prometheus(self, path: str) -> str:
        """Atomic write of the Prometheus text exposition; → path."""
        text = self.to_prometheus()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return path


class NullTelemetryHub:
    """The disabled default: every record call is a no-op attribute
    call (Config.TELEMETRY_ENABLED=False restores the pre-telemetry
    cost exactly)."""

    __slots__ = ("name",)
    enabled = False

    def __init__(self, name: str = ""):
        self.name = name

    def clock(self) -> float:
        return 0.0

    def observe(self, name, value_ms) -> None:
        pass

    def observe_labeled(self, name, label, value_ms) -> None:
        pass

    def labeled(self, name) -> dict:
        return {}

    def timer(self, name):
        return _NULL_TIMER

    def count(self, name, n=1) -> None:
        pass

    def gauge(self, name, value) -> None:
        pass

    def record_launch(self, seam, useful, lanes, shape=None) -> bool:
        return False

    def record_roundtrip(self, seam, ms, first_call=False) -> None:
        pass

    def gauge_sample(self, name):
        return None

    def histogram(self, name):
        return None

    def merge(self, other):
        return self

    def snapshot(self, buckets: bool = False) -> dict:
        return {"node": self.name, "enabled": False}

    def flush(self) -> dict:
        return {}

    def flush_history(self):
        return []


class _NullTimerCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_TIMER = _NullTimerCtx()


# -------------------------------------------------- process-wide seam hub

# The device seams (mesh, kernels, shared verifier hub/daemon) are
# process-wide resources shared by every co-resident node — exactly
# like the mesh tracer attach, their lane accounting lands in ONE
# process hub rather than an arbitrary node's. Pool-wide reports merge
# it with the per-node hubs.
_SEAM_HUB: Optional[object] = None
_SEAM_HUB_LOCK = threading.Lock()


def get_seam_hub():
    """The process-wide hub the ops/ dispatch seams record into.
    Created lazily from the Config class default (TELEMETRY_ENABLED
    False → a NullTelemetryHub, zero cost)."""
    global _SEAM_HUB
    hub = _SEAM_HUB
    if hub is None:
        with _SEAM_HUB_LOCK:
            if _SEAM_HUB is None:
                if _cfg("TELEMETRY_ENABLED", True):
                    _SEAM_HUB = TelemetryHub(name="device-seams")
                else:
                    _SEAM_HUB = NullTelemetryHub(name="device-seams")
            hub = _SEAM_HUB
    return hub


def set_seam_hub(hub):
    """Swap the process seam hub (tests / bench configs isolate their
    lane accounting); → the previous hub."""
    global _SEAM_HUB
    with _SEAM_HUB_LOCK:
        prev = _SEAM_HUB
        _SEAM_HUB = hub
    return prev


# --------------------------------------------------- prometheus rendering

def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "plenum_" + "".join(out)


def prometheus_text(snapshot: dict) -> str:
    """Render a hub snapshot (``snapshot(buckets=True)``) as Prometheus
    text exposition: counters as ``counter``, gauges as ``gauge``,
    histograms as native prom histograms (cumulative ``le`` buckets at
    the log-linear upper edges, sparse — only edges with occupancy),
    per-seam lane accounting as labeled counters/gauges. Deterministic
    output for a given snapshot."""
    node = snapshot.get("node", "")
    label = '{node="%s"}' % node if node else ""

    def seam_label(seam: str) -> str:
        if node:
            return '{node="%s",seam="%s"}' % (node, seam)
        return '{seam="%s"}' % seam

    lines = []
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        pn = _prom_name(name) + "_total"
        lines.append("# TYPE %s counter" % pn)
        lines.append("%s%s %d" % (pn, label, value))
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        pn = _prom_name(name)
        lines.append("# TYPE %s gauge" % pn)
        lines.append("%s%s %g" % (pn, label, value))
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        pn = _prom_name(name)
        lines.append("# TYPE %s histogram" % pn)
        # JSON round trips stringify bucket indices (telemetry_stats
        # --prom on a snapshot file) — normalize before use
        buckets = {int(k): v for k, v in (h.get("buckets") or {}).items()}
        if buckets:
            edges = _edges(h["lo"], h["octaves"], h["sub"])
            cum = 0
            for idx in sorted(buckets):
                cum += buckets[idx]
                if idx + 1 >= len(edges):
                    # overflow bucket: covered by the single +Inf line
                    # below — emitting it here too would duplicate the
                    # le="+Inf" series and invalidate the exposition
                    continue
                lines.append('%s_bucket{%sle="%g"} %d' % (
                    pn, ('node="%s",' % node) if node else "",
                    edges[idx + 1], cum))
        lines.append('%s_bucket{%sle="+Inf"} %d' % (
            pn, ('node="%s",' % node) if node else "", h.get("count", 0)))
        lines.append("%s_sum%s %g" % (pn, label, h.get("sum") or 0.0))
        lines.append("%s_count%s %d" % (pn, label, h.get("count", 0)))
    for name, fam in sorted((snapshot.get("labeled") or {}).items()):
        pn = _prom_name(name)
        lines.append("# TYPE %s summary" % pn)
        for lab, h in sorted(fam.items()):
            ll = ('{node="%s",label="%s"}' % (node, lab)) if node \
                else '{label="%s"}' % lab
            for q in ("p50", "p99"):
                if h.get(q) is not None:
                    lines.append('%s%s %g' % (
                        pn + "_" + q, ll, h[q]))
            lines.append("%s_sum%s %g" % (pn, ll, h.get("sum") or 0.0))
            lines.append("%s_count%s %d" % (pn, ll, h.get("count", 0)))
    for seam, s in sorted((snapshot.get("seams") or {}).items()):
        sl = seam_label(seam)
        lines.append("plenum_lane_useful_rows_total%s %d"
                     % (sl, s.get("useful_rows", 0)))
        lines.append("plenum_lane_rows_total%s %d"
                     % (sl, s.get("lane_rows", 0)))
        occ = s.get("lane_occupancy")
        if occ is not None:
            lines.append("plenum_lane_occupancy%s %g" % (sl, occ))
        lines.append("plenum_seam_launches_total%s %d"
                     % (sl, s.get("launches", 0)))
        lines.append("plenum_seam_compile_events_total%s %d"
                     % (sl, s.get("compile_events", 0)))
        rt = s.get("roundtrip_ms") or {}
        for q in ("p50", "p99"):
            if rt.get(q) is not None:
                lines.append("plenum_seam_roundtrip_ms_%s%s %g"
                             % (q, sl, rt[q]))
    return "\n".join(lines) + "\n"


def merged_snapshot(hubs, name: str = "pool", buckets: bool = False
                    ) -> dict:
    """Merge any iterable of hubs (per-node + the process seam hub)
    into one pool-wide snapshot."""
    merged = TelemetryHub(name=name)
    for hub in hubs:
        if hub is not None and getattr(hub, "enabled", False):
            merged.merge(hub)
    return merged.snapshot(buckets=buckets)
