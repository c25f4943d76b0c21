"""GC and process-memory observability.

Reference: plenum/common/gc_trackers.py — GcTimeTracker (:80) hooks
``gc.callbacks`` to record per-generation pause time and collected /
uncollectable object counts into the metrics collector; validator-info
surfaces process memory. Redesign: ONE process-wide gc callback fanning
out to weakly-referenced collectors (the reference registers one
callback per tracker and never removes it — with several nodes in one
process, dead nodes' callbacks would pile up forever), and RSS read
straight from /proc (no psutil in this image).
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Dict, Optional

from plenum_tpu_torch.utils.metrics import MetricsCollector, MetricsName


class GcTimeTracker:
    """Process-wide GC pause/throughput tracker.

    ``attach(metrics)`` subscribes a collector to GC events; references
    are weak, so a collector (and the node owning it) dying is enough to
    unsubscribe. The single gc callback is installed lazily on first
    attach and then stays for the life of the process: the singleton's
    running totals feed validator-info's snapshot() even when no
    per-node collector is attached, and with an empty WeakSet the
    per-collection cost is a few counter updates.
    """

    _instance: Optional["GcTimeTracker"] = None

    def __init__(self):
        self._collectors: "weakref.WeakSet[MetricsCollector]" = \
            weakref.WeakSet()
        self._starts: Dict[int, float] = {}
        self._installed = False
        # running totals, cheap to snapshot for validator-info
        self.total_time = 0.0
        self.total_collected = 0
        self.total_uncollectable = 0
        self.collections = 0

    @classmethod
    def instance(cls) -> "GcTimeTracker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def attach(self, metrics: MetricsCollector):
        self._collectors.add(metrics)
        if not self._installed:
            gc.callbacks.append(self._on_gc)
            self._installed = True

    def detach(self, metrics: MetricsCollector):
        self._collectors.discard(metrics)

    def _on_gc(self, action: str, info: dict):
        gen = info.get("generation", 0)
        if action == "start":
            self._starts[gen] = time.perf_counter()
            return
        start = self._starts.pop(gen, None)
        elapsed = (time.perf_counter() - start) if start is not None \
            else None
        collected = info.get("collected", 0)
        uncollectable = info.get("uncollectable", 0)
        self.collections += 1
        self.total_collected += collected
        self.total_uncollectable += uncollectable
        if elapsed is not None:
            self.total_time += elapsed
        if not self._collectors:
            return
        for m in list(self._collectors):
            if elapsed is not None:
                m.add_event(MetricsName.GC_GEN0_TIME + gen, elapsed)
            if collected:
                m.add_event(MetricsName.GC_COLLECTED_OBJECTS, collected)
            if uncollectable:
                m.add_event(MetricsName.GC_UNCOLLECTABLE_OBJECTS,
                            uncollectable)

    def snapshot(self) -> dict:
        counts = gc.get_count()
        return {
            "collections_observed": self.collections,
            "total_gc_time_s": round(self.total_time, 6),
            "total_collected_objects": self.total_collected,
            "total_uncollectable_objects": self.total_uncollectable,
            "current_counts": list(counts),
            "thresholds": list(gc.get_threshold()),
        }


def process_memory_info() -> dict:
    """RSS / peak-RSS / VM size for this process, in KiB. Linux /proc
    first (exact), resource.getrusage fallback (peak only)."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmHWM:", "VmSize:")):
                    key, val = line.split(":", 1)
                    out[{"VmRSS": "rss_kb", "VmHWM": "peak_rss_kb",
                         "VmSize": "vm_size_kb"}[key]] = \
                        int(val.strip().split()[0])
    except OSError:
        pass
    if "rss_kb" not in out or "peak_rss_kb" not in out:
        # a restricted /proc (e.g. gVisor) may expose VmRSS without VmHWM
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)  # KiB on Linux
        out.setdefault("peak_rss_kb", max(ru.ru_maxrss,
                                          out.get("rss_kb", 0)))
        out.setdefault("rss_kb", ru.ru_maxrss)
    return out
