"""Validator status snapshot — the operator's one-stop node dump
(port of plenum_tpu/server/validator_info.py).

Reference: plenum/server/validator_info_tool.py:54
(ValidatorNodeInfoTool — alias/did, pool counts, ledger sizes + root
hashes, per-replica status, mode, metrics averages, periodic JSON
dump). Same shape here, reading the live Node aggregate.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID, POOL_LEDGER_ID)

_LEDGER_NAMES = {
    POOL_LEDGER_ID: "pool",
    DOMAIN_LEDGER_ID: "domain",
    CONFIG_LEDGER_ID: "config",
    AUDIT_LEDGER_ID: "audit",
}


class ValidatorNodeInfoTool:
    def __init__(self, node, metrics=None, get_time=time.time):
        self._node = node
        self._metrics = metrics
        self._get_time = get_time
        self._started_at = get_time()

    # ------------------------------------------------------------- info

    @property
    def info(self) -> dict:
        node = self._node
        return {
            "alias": node.name,
            "timestamp": int(self._get_time()),
            "uptime_s": int(self._get_time() - self._started_at),
            "Node_info": {
                "Name": node.name,
                "Mode": ("participating" if node.mode_participating
                         else ("syncing" if node.leecher.in_progress
                               else "stalled")),
                "View_no": node.view_no,
                "Last_ordered_3PC": list(node.last_ordered),
                "Master_primary": node.master_primary_name,
                "Count_of_replicas": node.replicas.num_instances,
                "Replicas_status": self._replicas_status(),
                "Committed_ledger_root_hashes": self._ledger_roots(),
                "Committed_state_root_hashes": self._state_roots(),
                "Ledger_sizes": self._ledger_sizes(),
            },
            "Pool_info": self._pool_info(),
            "View_change_info": self._view_change_info(),
            "Catchup_status": self._catchup_status(),
            "Freshness_status": self._freshness_status(),
            "Uncommitted_info": self._uncommitted_info(),
            "Software": {"plenum_tpu_torch": _version(),
                         "python": _python_version(),
                         "torch": _dep_version("torch")},
            "Hardware_info": self._hardware_info(),
            "Config_info": self._config_info(),
            "Memory_info": self._memory_info(),
            "Latencies": self._latencies(),
            "Extractions": self._extractions(),
            "Tracing": self._tracing_info(),
            "Telemetry": self._telemetry_info(),
            "Device_mesh": self._device_mesh_info(),
            "Metrics": (self._metrics.summary()
                        if self._metrics is not None
                        and hasattr(self._metrics, "summary") else {}),
        }

    def _view_change_info(self) -> dict:
        """Reference validator_info_tool View_change_status: whether a
        view change is in flight + the vote state feeding the next."""
        data = self._node.replica.data
        out = {
            "View_No": data.view_no,
            "VC_in_progress": bool(data.waiting_for_new_view),
            "Last_complete_view_no": data.view_no
            if not data.waiting_for_new_view else data.view_no - 1,
        }
        trigger = getattr(self._node.replica, "vc_trigger", None)
        cache = getattr(trigger, "_cache", None)
        if cache is not None and hasattr(cache, "votes_summary"):
            out["IC_queue"] = cache.votes_summary()
        return out

    def _catchup_status(self) -> dict:
        """Per-ledger sync state (reference Catchup_status block)."""
        leecher = getattr(self._node, "leecher", None)
        if leecher is None:
            return {}
        out = {"In_progress": bool(leecher.in_progress),
               "Number_txns_in_catchup": getattr(
                   self._node, "catchup_txns_total", None),
               "Ledger_statuses": {}}
        for lid, name in _LEDGER_NAMES.items():
            ledger = self._node.db_manager.get_ledger(lid)
            if ledger is not None:
                out["Ledger_statuses"][name] = {
                    "size": ledger.size,
                    "root": str(ledger.root_hash)}
        return out

    def _freshness_status(self) -> dict:
        """Last signed-state update per ledger + staleness (reference
        FreshnessChecker view in validator info)."""
        checker = getattr(self._node, "freshness_checker", None)
        if checker is None:
            return {}
        now = self._get_time()
        out = {}
        last = getattr(checker, "_last_updated", {})
        timeout = getattr(checker, "_timeout",
                          getattr(checker, "freshness_timeout", None))
        for lid, ts in last.items():
            name = _LEDGER_NAMES.get(lid, str(lid))
            out[name] = {
                "Last_updated_time": ts,
                "Age_s": round(now - ts, 1),
                "Has_write_consensus": timeout is None
                or (now - ts) <= timeout,
            }
        return out

    def _uncommitted_info(self) -> dict:
        """Staged-but-unordered work: uncommitted txns per ledger and
        ordering queue depths — the numbers that say where a wedged
        pool is stuck."""
        out = {"Uncommitted_txns": {}, "Request_queues": {}}
        for lid, name in _LEDGER_NAMES.items():
            ledger = self._node.db_manager.get_ledger(lid)
            if ledger is not None:
                out["Uncommitted_txns"][name] = len(
                    getattr(ledger, "uncommittedTxns", ()) or ())
        ordering = getattr(self._node.replica, "ordering", None)
        if ordering is not None:
            for lid, queue in getattr(ordering, "requestQueues",
                                      {}).items():
                out["Request_queues"][
                    _LEDGER_NAMES.get(lid, str(lid))] = len(queue)
        reqs = getattr(self._node.propagator, "requests", None)
        if reqs is not None:
            out["In_flight_requests"] = len(reqs)
        return out

    def _tracing_info(self) -> dict:
        """Flight-recorder state (observability/): whether tracing is
        on, ring capacity, records ever written and how many of those
        wrapped out of the buffer — the numbers that say if a dumped
        timeline still covers the window you care about."""
        tracer = getattr(self._node, "tracer", None)
        stats = getattr(tracer, "stats", None)
        return stats() if stats is not None else {}

    def _telemetry_info(self) -> dict:
        """Telemetry-plane snapshot (observability/telemetry.py): the
        node's latency histograms (ordered p50/p99), pool-health gauges
        and recovery counters, plus the process-wide device-seam lane
        accounting (shared across co-resident nodes, like the mesh) —
        the numbers a serving tier is judged on, readable without
        attaching a profiler."""
        hub = getattr(self._node, "telemetry", None)
        if hub is None or not getattr(hub, "enabled", False):
            return {"enabled": False}
        out = hub.snapshot()
        try:
            from plenum_tpu_torch.observability.telemetry import get_seam_hub
            seam = get_seam_hub()
            if getattr(seam, "enabled", False):
                out["device_seams"] = seam.snapshot().get("seams", {})
        except Exception:
            pass
        return out

    def _device_mesh_info(self) -> dict:
        """Device-mesh dispatcher stats (ops/mesh.py): enabled and gate
        keys, sharded and passthrough dispatch counts, last per-device
        batch. mesh_stats probes no device and creates no CUDA context, so
        this dump stays safe inside an ordering tick."""
        try:
            from plenum_tpu_torch.ops.mesh import mesh_stats
            return mesh_stats()
        except Exception:
            return {}

    def _hardware_info(self) -> dict:
        out = {}
        try:
            st = os.statvfs(".")
            out["HDD_free_Mb"] = st.f_bavail * st.f_frsize // (1 << 20)
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        out["RAM_available_Mb"] = \
                            int(line.split()[1]) // 1024
                        break
        except OSError:
            pass
        return out

    def _config_info(self) -> dict:
        """The consensus-relevant knobs (reference dumps the whole
        config; the load-bearing subset keeps the file greppable)."""
        cfg = self._node.config
        keys = ("Max3PCBatchSize", "Max3PCBatchWait",
                "Max3PCBatchesInFlight", "CHK_FREQ", "LOG_SIZE",
                "DELTA", "LAMBDA", "OMEGA", "MSG_LEN_LIMIT")
        return {k: getattr(cfg, k, None) for k in keys}

    def _extractions(self) -> dict:
        """Derived rates (reference Extractions block): lifetime write
        throughput from the ordered-txn counter."""
        uptime = max(1e-9, self._get_time() - self._started_at)
        monitor = getattr(self._node, "monitor", None)
        total = getattr(monitor, "total_ordered", 0) if monitor else 0
        return {
            "Total_ordered_requests": total,
            "Avg_write_throughput_rps": round(total / uptime, 2),
            "Master_throughput": (monitor.instance_throughput(0)
                                  if monitor else None),
        }

    def _memory_info(self) -> dict:
        """Process RSS + GC behavior (reference gc_trackers.py; the
        reference's validator-info memory section reads psutil — here
        it's /proc + the process-wide GcTimeTracker totals)."""
        from plenum_tpu_torch.utils.gc_tracker import (
            GcTimeTracker, process_memory_info)
        out = dict(process_memory_info())
        out["gc"] = GcTimeTracker.instance().snapshot()
        return out

    def _latencies(self) -> dict:
        """Pool- and per-client request latency (reference
        latency_measurements.py:17 — per-client EMAs, high-median
        aggregate)."""
        monitor = getattr(self._node, "monitor", None)
        if monitor is None:
            return {}
        cl = monitor.client_latencies
        return {
            "Avg_latency_s": monitor.avg_latency(),
            "Clients_avg_latency_s": cl.get_avg_latency(),
            "Per_client": cl.per_client(),
        }

    def _replicas_status(self) -> dict:
        out = {}
        for replica in self._node.replicas:
            data = replica.data
            out[str(data.inst_id)] = {
                "Primary": data.primary_name,
                "Watermarks": "{}:{}".format(data.low_watermark,
                                             data.high_watermark),
                "Last_ordered_3PC": list(data.last_ordered_3pc),
            }
        return out

    def _ledger_roots(self) -> dict:
        out = {}
        for lid, name in _LEDGER_NAMES.items():
            ledger = self._node.db_manager.get_ledger(lid)
            if ledger is not None:
                out[name] = str(ledger.root_hash)
        return out

    def _state_roots(self) -> dict:
        out = {}
        for lid, name in _LEDGER_NAMES.items():
            state = self._node.db_manager.get_state(lid)
            if state is not None:
                from plenum_tpu_torch.common.serializers.base58 import b58encode
                out[name] = b58encode(state.committedHeadHash)
        return out

    def _ledger_sizes(self) -> dict:
        out = {}
        for lid, name in _LEDGER_NAMES.items():
            ledger = self._node.db_manager.get_ledger(lid)
            if ledger is not None:
                out[name] = ledger.size
        return out

    def _pool_info(self) -> dict:
        node = self._node
        validators = list(node.replica.data.validators)
        quorums = node.replica.data.quorums
        info = {
            "Total_nodes_count": len(validators),
            "f_value": quorums.f,
            "Quorums": repr(quorums),
            "Validators": validators,
        }
        bus = node.network
        connecteds = getattr(bus, "connecteds", None)
        if connecteds is not None:
            reachable = sorted(set(connecteds) | {node.name})
            info["Reachable_nodes"] = reachable
            info["Unreachable_nodes"] = sorted(
                set(validators) - set(reachable))
        return info

    # ------------------------------------------------------------- dump

    def dump_json_file(self, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            "{}_info.json".format(self._node.name.lower()))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.info, f, indent=2, default=str)
        os.replace(tmp, path)
        return path


def _version() -> str:
    try:
        from plenum_tpu_torch import __version__
        return __version__
    except ImportError:
        return "dev"


def _python_version() -> str:
    import sys
    return sys.version.split()[0]


def _dep_version(name: str):
    """Installed version WITHOUT importing the package — importing
    torch inside the periodic info dump would stall an ordering tick
    (and can initialize a device runtime as a side effect)."""
    try:
        from importlib.metadata import version
        return version(name)
    except Exception:
        return None
