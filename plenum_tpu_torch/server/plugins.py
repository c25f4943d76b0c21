"""Plugin seams: notifier event push + directory-loaded typed plugins.

Two extension points the reference exposes and operators rely on:

* **Notifier plugins** push operational events (cluster degraded, node
  restart, suspicious request/throughput spikes) to external systems —
  reference: plenum/server/notifier_plugin_manager.py:24 (PluginManager,
  pip-discovered by the ``indynotifier`` name prefix) with EMA-based
  spike detection at :55 (sendMessageUponSuspiciousSpike). A notifier
  plugin is anything with ``send_message(topic, message)``.

* **Typed plugins** are classes loaded from a directory whose
  ``plugin_type`` attribute names a seam — reference:
  plenum/server/plugin_loader.py:25 (PluginLoader scans ``plugin*.py``
  files for classes with a ``pluginType`` attr) and
  plenum/common/plugin_helper.py:12 (loadPlugins by explicit name).
  VERIFICATION plugins veto client operations (their ``verify(op)``
  raises to reject); STATS_CONSUMER plugins receive periodic stats.

Redesign vs the reference: no module-level singleton (the manager is
node-owned so tests and multi-node processes don't share state), no
``sys.path`` mutation (modules load via importlib specs), and discovery
is directory/explicit-object based — this image has no pip entry-point
ecosystem to scan.
"""
from __future__ import annotations

import importlib.util
import logging
import math
import re
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

PLUGIN_TYPE_VERIFICATION = "VERIFICATION"
PLUGIN_TYPE_STATS_CONSUMER = "STATS_CONSUMER"
VALID_PLUGIN_TYPES = (PLUGIN_TYPE_VERIFICATION, PLUGIN_TYPE_STATS_CONSUMER)

# canonical topic strings (reference notifierPluginTriggerEvents)
TOPIC_CLUSTER_DEGRADED = "ClusterDegraded"
TOPIC_CLUSTER_RESTART = "ClusterRestart"
TOPIC_NODE_REQUEST_SPIKE = "NodeRequestSuspiciousSpike"
TOPIC_CLUSTER_THROUGHPUT_SPIKE = "ClusterThroughputSuspiciousSpike"


def _load_module_from_file(path: Path):
    """Import one file as a uniquely-named module without touching
    sys.path (plugin dirs must not shadow stdlib names)."""
    # crc32, not hash(): str hashes are PYTHONHASHSEED-salted, so the
    # module name would differ per process (PT012 audit; the
    # catchup-jitter precedent) — crc32 keeps names stable across
    # replicas and restarts
    mod_name = "plenum_tpu_plugin_%s_%x" % (
        path.stem, zlib.crc32(str(path).encode()))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError("cannot build import spec for %s" % path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


class SpikeDetector:
    """EMA anomaly detector for one metric stream (reference
    notifier_plugin_manager.py:55 sendMessageUponSuspiciousSpike keeps
    the same state inline): tracks an exponential moving average; a new
    sample outside ``[ema/coeff, ema*coeff]`` after warm-up is a spike.
    With ``use_weighted_bounds_coeff`` the band narrows as log10(cnt)
    grows — long-lived averages earn tighter alarms."""

    def __init__(self, min_cnt: int = 15, bounds_coeff: float = 10,
                 min_activity_threshold: float = 10,
                 use_weighted_bounds_coeff: bool = True,
                 enabled: bool = True):
        self.min_cnt = min_cnt
        self.bounds_coeff = bounds_coeff
        self.min_activity_threshold = min_activity_threshold
        self.use_weighted_bounds_coeff = use_weighted_bounds_coeff
        self.enabled = enabled
        self.value = 0.0
        self.cnt = 0

    @classmethod
    def from_config(cls, cfg: Dict) -> "SpikeDetector":
        return cls(min_cnt=cfg.get("min_cnt", 15),
                   bounds_coeff=cfg.get("bounds_coeff", 10),
                   min_activity_threshold=cfg.get(
                       "min_activity_threshold", 10),
                   use_weighted_bounds_coeff=cfg.get(
                       "use_weighted_bounds_coeff", True),
                   enabled=cfg.get("enabled", True))

    def observe(self, new_val: float) -> Optional[Dict]:
        """Feed one sample. Returns a spike-description dict when the
        sample breaks the adaptive bounds, else None. The EMA absorbs
        the sample either way (an alarm must not freeze the average the
        way skipping the update would)."""
        if not self.enabled:
            return None
        prev = self.value
        alpha = 2.0 / (self.min_cnt + 1)
        self.value = prev * (1 - alpha) + new_val * alpha
        self.cnt += 1
        if self.cnt <= self.min_cnt:
            return None  # still warming up
        if prev < self.min_activity_threshold:
            return None  # too quiet for bounds to mean anything
        coeff = self.bounds_coeff
        if self.use_weighted_bounds_coeff and self.cnt > 10:
            coeff /= math.log10(self.cnt)
        lo, hi = prev / coeff, prev * coeff
        if lo <= new_val <= hi:
            return None
        return {"actual": new_val, "expected": prev,
                "bounds": [lo, hi], "cnt": self.cnt}


class NotifierPluginManager:
    """Fans operational events out to registered notifier plugins.

    A plugin is any object (usually a module) exposing
    ``send_message(topic: str, message: str)``. A failing plugin is
    logged and skipped — observers must never take the node down.
    Reference: plenum/server/notifier_plugin_manager.py:139
    (_sendMessage fan-out with the same isolation guarantee).
    """

    def __init__(self, node_name: str = "", enabled: bool = True,
                 spike_configs: Optional[Dict[str, Dict]] = None):
        self.node_name = node_name
        self.enabled = enabled
        self.plugins: List[Any] = []
        self._detectors: Dict[str, SpikeDetector] = {}
        for topic, cfg in (spike_configs or {}).items():
            self._detectors[topic] = SpikeDetector.from_config(cfg)
        self.sent = 0  # events delivered (sum over plugins)

    # ------------------------------------------------------- registration

    def register(self, plugin: Any) -> None:
        if not callable(getattr(plugin, "send_message", None)):
            raise TypeError(
                "notifier plugin %r has no send_message(topic, message)"
                % (plugin,))
        self.plugins.append(plugin)

    def load_from_dir(self, path) -> int:
        """Import every ``notifier*.py`` / ``plugin*.py`` file in `path`
        that exposes a module-level send_message. → count loaded."""
        p = Path(path)
        if not p.is_dir():
            return 0
        n = 0
        pat = re.compile(r"^(notifier|plugin).*\.py$", re.IGNORECASE)
        for f in sorted(p.iterdir()):
            if not (f.is_file() and pat.match(f.name)):
                continue
            try:
                module = _load_module_from_file(f)
            except Exception:
                logger.error("notifier plugin %s failed to import", f,
                             exc_info=True)
                continue
            if callable(getattr(module, "send_message", None)):
                self.plugins.append(module)
                n += 1
                logger.info("loaded notifier plugin %s", f.name)
        return n

    # ------------------------------------------------------------- events

    def send(self, topic: str, message: str) -> int:
        """Deliver to every plugin; → successful deliveries."""
        if not self.enabled:
            return 0
        ok = 0
        for plugin in self.plugins:
            try:
                plugin.send_message(topic, message)
                ok += 1
            except Exception:
                logger.error("notifier plugin %r failed on %s",
                             plugin, topic, exc_info=True)
        self.sent += ok
        return ok

    def send_cluster_degraded(self, reason: str = "") -> int:
        return self.send(
            TOPIC_CLUSTER_DEGRADED,
            "Cluster performance degraded on node %s at %s: %s"
            % (self.node_name, time.time(), reason or "master throughput "
               "below threshold; voting for view change"))

    def send_cluster_restart(self, detail: str = "") -> int:
        return self.send(
            TOPIC_CLUSTER_RESTART,
            "Node %s restarted from persisted state at %s. %s"
            % (self.node_name, time.time(), detail))

    def send_spike_check(self, topic: str, new_val: float) -> int:
        """Feed one periodic sample to the topic's detector; pushes an
        event only when the detector flags it (reference :55)."""
        det = self._detectors.get(topic)
        if det is None or not self.enabled:
            return 0
        spike = det.observe(new_val)
        if spike is None:
            return 0
        return self.send(
            topic,
            "%s on node %s at %s. Actual: %s. Expected: %s. "
            "Bounds: [%s, %s]." % (topic, self.node_name, time.time(),
                                   spike["actual"], spike["expected"],
                                   spike["bounds"][0], spike["bounds"][1]))


class PluginLoader:
    """Loads typed plugin classes from a directory.

    Scans for ``plugin*.py`` files, imports each, instantiates every
    class carrying a ``plugin_type`` attribute naming a valid seam, and
    groups instances by type. Reference: plenum/server/plugin_loader.py:25
    (same file-pattern + class-attribute discovery contract; this one
    imports via specs instead of sys.path insertion and accepts the
    reference's camelCase ``pluginType`` spelling too).
    """

    def __init__(self, path):
        if not path:
            raise ValueError("plugin path is required")
        self.path = Path(path)
        self.plugins: Dict[str, List[Any]] = {}
        self._load()

    def get(self, type_name: str) -> List[Any]:
        return self.plugins.get(type_name, [])

    def _load(self):
        if not self.path.is_dir():
            logger.warning("plugin dir %s does not exist", self.path)
            return
        pat = re.compile(r"^[pP]lugin.*\.py$")
        for f in sorted(self.path.iterdir()):
            if not (f.is_file() and pat.match(f.name)):
                continue
            try:
                module = _load_module_from_file(f)
            except Exception:
                logger.error("plugin module %s failed to import", f,
                             exc_info=True)
                continue
            for obj in vars(module).values():
                if not isinstance(obj, type):
                    continue
                if obj.__module__ != module.__name__:
                    continue  # imported, not defined here — a shared
                    # base class must not be instantiated per importer
                ptype = getattr(obj, "plugin_type",
                                getattr(obj, "pluginType", None))
                if ptype is None:
                    continue
                if ptype not in VALID_PLUGIN_TYPES:
                    logger.warning(
                        "skipping plugin class %s: invalid plugin_type "
                        "%r (valid: %s)", obj.__name__, ptype,
                        VALID_PLUGIN_TYPES)
                    continue
                try:
                    inst = obj()
                except Exception:
                    logger.error("plugin class %s failed to construct",
                                 obj.__name__, exc_info=True)
                    continue
                self.plugins.setdefault(ptype, []).append(inst)
                logger.info("loaded %s plugin %s from %s", ptype,
                            obj.__name__, f.name)
