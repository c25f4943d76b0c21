"""Per-node span tracer — the flight-recorder core.

The metrics accumulators (utils/metrics.py) answer "how much time does
stage X cost in aggregate"; this tracer answers the CAUSAL question —
where one specific 3PC batch spent its time across the pool, and
whether the device seams were pipelined or idle between dispatches.

Design constraints (why this is not just `logging` with timestamps):

* Fixed cost per record. Every span is one tuple written into a slot of
  a PREALLOCATED ring buffer — no allocation growth, no I/O, no
  serialization on the hot path. When the buffer wraps, the oldest
  records are overwritten: a flight recorder keeps the newest history,
  which is the part that explains the failure/stall you just observed.
* Off by default, free when off. Instrumented call sites hold a
  `NullTracer` whose `span()` returns one shared no-op context manager —
  the disabled cost is a single attribute call, bench-gated to low
  single-digit percent even when enabled (bench.py tracing_overhead).
* Thread-safe. The verify daemon records from a worker thread while its
  asyncio loop coalesces; slot claims take a lock (the write itself is
  one tuple store, so the critical section is tiny).
* Injectable clock. Tests pin a fake clock for deterministic export;
  production uses `perf_counter`, which is shared by every tracer in a
  process — so a sim pool's per-node buffers merge into one coherent
  pool-wide timeline with no clock alignment step.
* Dual clocks for cross-process alignment. `clock_pair()` samples the
  perf-counter AND an injectable wall clock in one call; the exporter
  records the pair as a `clock_sync` event at flush so FILE-mode
  consumers (scripts/pool_journey over Chrome dumps from different
  processes) can re-anchor each node's perf timeline onto shared wall
  time. In-process merges never need it, and `NullTracer` stays free.

Record shape (one tuple per event, fixed arity):

    (kind, name, category, t0, t1, key, args)

    kind: "X" complete span | "i" instant | "C" counter sample
    key:  correlation key — request digest for intake/propagate spans,
          "viewNo:ppSeqNo" for 3PC phases (see docs/observability.md)
    args: payload dict (batch sizes, queue depths) or None

Categories below become per-node tracks in the Perfetto export.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

# span categories: one Perfetto track per category per node
CAT_INTAKE = "intake"        # client request validation + acceptance
CAT_PROPAGATE = "propagate"  # PROPAGATE gossip + quorum finalisation
CAT_3PC = "3pc"              # PrePrepare/Prepare/Commit/Order
CAT_EXECUTE = "execute"      # batch apply + durable commit
CAT_DEVICE = "device"        # accelerator dispatch/collect seams
CAT_BLS = "bls"              # BLS share aggregation
CAT_REPLY = "reply"          # reply construction + audit paths
CAT_RECOVERY = "recovery"    # view change / catchup / breaker lifecycle

Record = Tuple[str, str, str, float, Optional[float], Optional[str],
               Optional[dict]]


class _SpanCtx:
    """One open span: records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_key", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 key: Optional[str], args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._key = key
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tracer = self._tracer
        tracer._record((
            "X", self._name, self._cat, self._t0, tracer._clock(),
            self._key, self._args))
        return False

    def add(self, **args) -> None:
        """Attach payload discovered mid-span (e.g. a batch size known
        only after validation)."""
        if self._args is None:
            self._args = {}
        self._args.update(args)


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def add(self, **args) -> None:
        pass


_NULL_CTX = _NullCtx()


class NullTracer:
    """The default every instrumented component holds: the hot path is a
    no-op attribute call returning one shared context manager."""

    __slots__ = ("name",)
    enabled = False

    def __init__(self, name: str = ""):
        self.name = name

    def span(self, name, cat="", key=None, **args) -> _NullCtx:
        return _NULL_CTX

    def instant(self, name, cat="", key=None, **args) -> None:
        pass

    def counter(self, name, value, cat="") -> None:
        pass

    def clock_pair(self) -> Tuple[float, float]:
        return (0.0, 0.0)

    def spans(self) -> List[Record]:
        return []

    def clear(self) -> None:
        pass

    def stats(self) -> dict:
        return {"enabled": False, "capacity": 0, "recorded": 0,
                "buffered": 0, "dropped": 0}


class Tracer:
    """Ring-buffer span recorder for one node (or one daemon)."""

    __slots__ = ("name", "_capacity", "_buf", "_idx", "_written",
                 "_clock", "_wall_clock", "_lock")
    enabled = True

    def __init__(self, name: str = "", capacity: int = 1 << 16,
                 clock=time.perf_counter, wall_clock=time.time):
        self.name = name
        self._capacity = max(1, int(capacity))
        self._buf: List[Optional[Record]] = [None] * self._capacity
        self._idx = 0           # next slot to overwrite
        self._written = 0       # total records ever (>= buffered)
        self._clock = clock
        self._wall_clock = wall_clock
        self._lock = threading.Lock()

    # ------------------------------------------------------------ record

    def _record(self, rec: Record) -> None:
        with self._lock:
            self._buf[self._idx] = rec
            self._idx = (self._idx + 1) % self._capacity
            self._written += 1

    def span(self, name: str, cat: str = "", key: Optional[str] = None,
             **args) -> _SpanCtx:
        """Context manager timing one complete span."""
        return _SpanCtx(self, name, cat, key, args or None)

    def instant(self, name: str, cat: str = "",
                key: Optional[str] = None, **args) -> None:
        """Zero-duration marker (quorum reached, request accepted)."""
        t = self._clock()
        self._record(("i", name, cat, t, t, key, args or None))

    def counter(self, name: str, value, cat: str = "") -> None:
        """Counter sample (queue depth, batch size) — rendered by
        Perfetto as a stacked counter track."""
        self._record(("C", name, cat, self._clock(), None, None,
                      {name: value}))

    def clock_pair(self) -> Tuple[float, float]:
        """(perf_counter, wall) sampled back to back — the anchor pair
        wire stamps and flush-time `clock_sync` events carry so
        cross-process consumers can align this tracer's perf timeline
        onto wall time."""
        return (self._clock(), self._wall_clock())

    # -------------------------------------------------------------- read

    def spans(self) -> List[Record]:
        """Buffered records, oldest → newest. After a wrap only the
        newest `capacity` records survive — flight-recorder semantics."""
        with self._lock:
            if self._written < self._capacity:
                return list(self._buf[:self._idx])
            return list(self._buf[self._idx:]) + list(self._buf[:self._idx])

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self._capacity
            self._idx = 0
            self._written = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "capacity": self._capacity,
                "recorded": self._written,
                "buffered": min(self._written, self._capacity),
                "dropped": max(0, self._written - self._capacity),
            }
