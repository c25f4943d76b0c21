"""Chrome trace-event export — Perfetto-loadable pool timelines.

Converts any set of Tracer ring buffers (one per node, plus standalone
tracers like the verify daemon's) into the Trace Event Format that
chrome://tracing and https://ui.perfetto.dev load directly:

* one "pid" row per tracer (the node name, via process_name metadata),
* one "tid" track per span category within a node (thread_name
  metadata) — intake / propagate / 3pc / execute / device / bls /
  reply render as parallel lanes per node,
* complete events ("X") for spans, instants ("i") for quorum markers,
  counter events ("C") for queue depths and batch sizes,
* every event's args carry its correlation key ("key": request digest
  or "viewNo:ppSeqNo"), so Perfetto's search/flow UI groups one batch's
  whole lifecycle across all nodes,
* flow events ("s"/"f") pairing each stamped envelope's ``wire_send``
  with every ``wire_recv`` it produced — Perfetto draws the arrow from
  the sender's flush to each receiver's parse, which is what makes a
  cross-node journey READABLE on the timeline. The flow id is the
  stamp identity "origin:flushSeq" (the receive instants' key), so
  send and receives bind with no extra bookkeeping.

Timestamps are the tracers' shared perf_counter clock in microseconds;
within one process (the sim pool, the e2e harness) that makes the
merged timeline causally consistent with no alignment step. Output is
deterministic for a given set of buffers: pids follow tracer order,
tids follow first-appearance order, and the timeline is sorted by
(ts, pid, tid, name).
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional


def trace_events(tracers: Iterable, telemetry: Iterable = ()) -> List[dict]:
    """→ Trace Event Format event list (metadata first, then the
    time-sorted merged timeline). ``telemetry`` hubs
    (observability/telemetry.py) contribute their flush-history samples
    as counter tracks — histogram p50/p99, pool-health gauges and
    per-seam lane occupancy line up on the same perf_counter time axis
    as the spans, one "telemetry" lane per hub."""
    meta: List[dict] = []
    timeline: List[dict] = []
    pid_of: dict = {}
    for tracer in tracers:
        if tracer is None:
            continue
        recs = tracer.spans()
        if not recs:
            continue
        pname = tracer.name or "node"
        pid = pid_of.get(pname)
        if pid is None:
            pid = pid_of[pname] = len(pid_of) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
        tids: dict = {}
        for kind, name, cat, t0, t1, key, args in recs:
            track = cat or "main"
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": track}})
            ts = int(round(t0 * 1e6))
            payload = dict(args) if args else {}
            if key is not None:
                payload["key"] = key
            if kind == "X":
                timeline.append({
                    "name": name, "cat": track, "ph": "X", "pid": pid,
                    "tid": tid, "ts": ts,
                    "dur": max(0, int(round((t1 - t0) * 1e6))),
                    "args": payload})
            elif kind == "i":
                timeline.append({
                    "name": name, "cat": track, "ph": "i", "pid": pid,
                    "tid": tid, "ts": ts, "s": "t", "args": payload})
                # journey flow arrows: one "s" per stamped envelope
                # send, one "f" per receive; both share the stamp
                # identity as the flow id (a broadcast send fans out
                # to one arrow per receiver)
                if name == "wire_send" and key is not None:
                    timeline.append({
                        "name": "wire", "cat": track, "ph": "s",
                        "id": "%s:%s" % (pname, key), "pid": pid,
                        "tid": tid, "ts": ts, "args": {}})
                elif name == "wire_recv" and key is not None:
                    timeline.append({
                        "name": "wire", "cat": track, "ph": "f",
                        "bp": "e", "id": key, "pid": pid,
                        "tid": tid, "ts": ts, "args": {}})
            else:  # "C"
                timeline.append({
                    "name": name, "ph": "C", "pid": pid, "tid": tid,
                    "ts": ts, "args": payload})
    for hub in telemetry or ():
        if hub is None or not getattr(hub, "enabled", False):
            continue
        history = hub.flush_history()
        if not history:
            continue
        pname = hub.name or "telemetry"
        pid = pid_of.get(pname)
        if pid is None:
            pid = pid_of[pname] = len(pid_of) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
        # one dedicated counter lane per hub, after any span tracks the
        # same pid already claimed
        tid = 1000
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": "telemetry"}})
        for t, sample in history:
            ts = int(round(t * 1e6))
            for name in sorted(sample):
                timeline.append({
                    "name": name, "ph": "C", "pid": pid, "tid": tid,
                    "ts": ts, "args": {name: sample[name]}})
    timeline.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    return meta + timeline


def chrome_trace(tracers: Iterable, telemetry: Iterable = ()) -> dict:
    """→ the full JSON-object trace document."""
    return {"traceEvents": trace_events(tracers, telemetry=telemetry),
            "displayTimeUnit": "ms"}


def export_chrome_trace(tracers: Iterable, path: str,
                        telemetry: Iterable = ()) -> str:
    """Write the merged timeline to `path`; → path."""
    doc = chrome_trace(tracers, telemetry=telemetry)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def pool_telemetry(nodes: Iterable) -> List:
    """Collect every node's TelemetryHub (skipping nodes without one or
    with telemetry off) — the counter-track set for a pool timeline and
    the merge set for pool-wide snapshots."""
    out = []
    for node in nodes:
        hub = getattr(node, "telemetry", None)
        if hub is not None and getattr(hub, "enabled", False):
            out.append(hub)
    return out


def pool_tracers(nodes: Iterable) -> List:
    """Collect every node's tracer (skipping nodes without one) — the
    merge set for a pool-wide timeline."""
    out = []
    for node in nodes:
        tracer = getattr(node, "tracer", None)
        if tracer is not None:
            out.append(tracer)
    return out


def summarize(doc: dict) -> dict:
    """Compact summary of a trace document (the `trace_view` CLI's
    validation/reporting half): event counts per phase kind, span-name
    histogram per node, counter-track value ranges, wall span of the
    timeline."""
    events = doc.get("traceEvents", [])
    pid_names = {e["pid"]: e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    by_ph: dict = {}
    by_node: dict = {}
    counters: dict = {}
    t_min: Optional[int] = None
    t_max: Optional[int] = None
    for e in events:
        ph = e.get("ph")
        by_ph[ph] = by_ph.get(ph, 0) + 1
        if ph == "M":
            continue
        ts = e.get("ts", 0)
        end = ts + e.get("dur", 0)
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = end if t_max is None else max(t_max, end)
        node = pid_names.get(e["pid"], str(e["pid"]))
        names = by_node.setdefault(node, {})
        names[e["name"]] = names.get(e["name"], 0) + 1
        if ph == "C":
            # counter tracks: keep the value envelope per series so the
            # file-mode summary reports them instead of dropping them
            for v in (e.get("args") or {}).values():
                if not isinstance(v, (int, float)):
                    continue
                cur = counters.get(e["name"])
                if cur is None:
                    counters[e["name"]] = {
                        "points": 1, "min": v, "max": v, "last": v}
                else:
                    cur["points"] += 1
                    cur["min"] = min(cur["min"], v)
                    cur["max"] = max(cur["max"], v)
                    cur["last"] = v
    return {
        "events": len(events),
        "by_ph": by_ph,
        "nodes": sorted(by_node),
        "span_counts": by_node,
        "counters": counters,
        "wall_us": (t_max - t_min) if t_min is not None else 0,
    }
