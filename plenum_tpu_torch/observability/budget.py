"""Per-stage host-millisecond budget from flight-recorder spans.

The columnar 3PC refactor's contract is attributability: every
host-side millisecond on the ordering money path belongs to a named
stage, so a throughput regression shows up as ONE stage's budget
moving, not a vague end-to-end slowdown. This module turns a set of
recorded spans — either live ``Tracer`` ring buffers or an exported
Chrome trace document — into ``host-ms per ordered request`` per
stage:

* ``intake``    — client batch auth dispatch/conclude + read batches
* ``propagate`` — PROPAGATE flush + quorum bookkeeping
* ``queue_wait`` — pipeline handoff: prod-thread time blocked on a
                  parse worker at the drain (runtime/pipeline.py)
* ``3pc``       — PRE-PREPARE build/process, columnar prepare/commit
                  intake, ordering, the per-tick vote flush
* ``dispatch_wait`` — device seams (fused per-batch window, verifier
                  hub flush/collect, BLS aggregation)
* ``execute``   — batch apply/commit MINUS the device window nested
                  inside it (exclusive time: nested spans are charged
                  to their own stage exactly once)
* ``reply``     — reply construction + audit paths

Span time is EXCLUSIVE: a ``fused_dispatch`` nested inside
``batch_apply`` counts toward ``dispatch_wait``, and only the
remaining apply time counts toward ``execute`` — stages sum to real
host time, double counting nothing. Ordered-request volume is taken
from the master executor's ``batch_apply`` spans (``batch_size``
arg), the one span family that fires exactly once per applied batch
per node.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from plenum_tpu_torch.observability.telemetry import TM as _TM

# stage order is the money-path order; reports preserve it
STAGES = ("intake", "propagate", "serialize", "parse", "queue_wait",
          "3pc", "dispatch_wait", "execute", "reply")

# named sub-stages of the execute budget line (conflict-lane executor,
# server/executor.py): plan+prefetch / per-request validate-apply /
# merged hash resolution. They carry the execute category, so their
# exclusive time already lands in the execute stage — the sub-stage
# report says WHICH of the three owns it. (The device work nested
# inside hash_resolve keeps charging dispatch_wait, exactly like the
# fused window always has.)
EXECUTE_SUBSTAGES = ("exec_validate", "lane_apply", "hash_resolve")

# span names whose category alone would misfile them: the intake auth
# seams are device dispatches, but they are the INTAKE stage's cost;
# the wire pack/parse spans sit inside 3PC/propagate flush handlers but
# are the SERIALIZE/PARSE stages' cost (the flat-wire A/B reads the
# before/after host-ms off these two rows instead of inferring it from
# an end-to-end delta)
_INTAKE_NAMES = frozenset({"auth_dispatch", "auth_conclude",
                           "read_batch"})
_NAME_TO_STAGE = {
    "wire_pack": "serialize",
    "wire_parse": "parse",
    # pipeline handoff: prod-thread time spent blocked on a parse
    # worker (runtime/pipeline.py drain). Its own stage so handoff
    # latency is attributable instead of smearing into the consuming
    # 3PC stage — a mis-sized queue shows up as THIS row moving.
    "queue_wait": "queue_wait",
}
_CAT_TO_STAGE = {
    "intake": "intake",
    "propagate": "propagate",
    "3pc": "3pc",
    "device": "dispatch_wait",
    "bls": "dispatch_wait",
    "execute": "execute",
    "reply": "reply",
}


def stage_of(name: str, cat: str) -> Optional[str]:
    """Stage for one span; None = unbudgeted (recovery, counters)."""
    if name in _INTAKE_NAMES:
        return "intake"
    stage = _NAME_TO_STAGE.get(name)
    if stage is not None:
        return stage
    return _CAT_TO_STAGE.get(cat)


def _exclusive_ms(spans: List[Tuple[float, float, str, str]]
                  ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(t0, t1, stage, name) spans from ONE single-threaded recorder →
    (per-stage, per-execute-sub-stage) EXCLUSIVE milliseconds. Nested
    spans (device windows inside an apply, batch intakes inside a
    flush) are charged to their own stage and subtracted from the
    enclosing span's stage; the named executor sub-stages additionally
    accumulate their own exclusive time so the execute line splits
    into validate / lane-apply / hash-resolve populations."""
    out: Dict[str, float] = {s: 0.0 for s in STAGES}
    subs: Dict[str, float] = {s: 0.0 for s in EXECUTE_SUBSTAGES}
    # parents sort before their children; among equal starts the longer
    # span is the parent
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack: List[List] = []   # [t0, t1, stage, name, child_time]
    def _close(entry):
        t0, t1, stage, name, child = entry
        excl = max(0.0, (t1 - t0) - child) * 1e3
        if stage is not None:
            out[stage] += excl
        if name in subs:
            subs[name] += excl
        if stack:
            stack[-1][4] += t1 - t0
    for t0, t1, stage, name in spans:
        while stack and t0 >= stack[-1][1]:
            _close(stack.pop())
        stack.append([t0, t1, stage, name, 0.0])
    while stack:
        _close(stack.pop())
    return out, subs


def budget_from_tracers(tracers: Iterable) -> dict:
    """Live ``Tracer`` buffers (one per node) → the budget report (see
    :func:`_report`)."""
    per_node: List[Dict[str, float]] = []
    per_node_subs: List[Dict[str, float]] = []
    ordered: List[int] = []
    for tracer in tracers:
        if tracer is None:
            continue
        spans, n_ordered = [], 0
        for kind, name, cat, t0, t1, key, args in tracer.spans():
            if kind != "X":
                continue
            spans.append((t0, t1, stage_of(name, cat), name))
            if name == "batch_apply" and args:
                n_ordered += int(args.get("batch_size", 0))
        if spans:
            stage_ms, sub_ms = _exclusive_ms(spans)
            per_node.append(stage_ms)
            per_node_subs.append(sub_ms)
            ordered.append(n_ordered)
    return _report(per_node, ordered, per_node_subs)


def budget_from_chrome(doc: dict) -> dict:
    """Exported Chrome trace document (``trace_view`` / scenario
    dumps) → the budget report. Timestamps are microseconds."""
    by_pid: Dict[int, List[Tuple[float, float, Optional[str], str]]] = {}
    ordered_by_pid: Dict[int, int] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        pid = e.get("pid", 0)
        t0 = e.get("ts", 0) * 1e-6
        t1 = t0 + e.get("dur", 0) * 1e-6
        name = e.get("name", "")
        by_pid.setdefault(pid, []).append(
            (t0, t1, stage_of(name, e.get("cat", "")), name))
        if name == "batch_apply":
            ordered_by_pid[pid] = ordered_by_pid.get(pid, 0) + \
                int((e.get("args") or {}).get("batch_size", 0))
    per_node, per_node_subs = [], []
    for spans in by_pid.values():
        stage_ms, sub_ms = _exclusive_ms(spans)
        per_node.append(stage_ms)
        per_node_subs.append(sub_ms)
    ordered = [ordered_by_pid.get(pid, 0) for pid in by_pid]
    return _report(per_node, ordered, per_node_subs)


def _report(per_node: List[Dict[str, float]], ordered: List[int],
            per_node_subs: List[Dict[str, float]] = None) -> dict:
    """Merge per-node stage totals into the budget report:

    * ``ordered_reqs`` — requests applied (max across nodes: every
      node applies every batch, stragglers just show fewer),
    * ``stage_ms_per_node`` — average total host-ms per stage per node,
    * ``host_ms_per_ordered_req`` — per-stage average host-ms one
      ordered request costs ONE node, plus ``total``,
    * ``execute_substages`` — the execute line split into the lane
      executor's validate / lane-apply / hash-resolve populations
      (ms per ordered request; absent when nothing recorded them).
    """
    n_nodes = len(per_node)
    n_ordered = max(ordered) if ordered else 0
    totals = {s: sum(node[s] for node in per_node) for s in STAGES} \
        if per_node else {s: 0.0 for s in STAGES}
    avg = {s: totals[s] / n_nodes for s in STAGES} if n_nodes else totals
    per_req = {s: (avg[s] / n_ordered if n_ordered else 0.0)
               for s in STAGES}
    per_req["total"] = sum(per_req[s] for s in STAGES)
    report = {
        "nodes": n_nodes,
        "ordered_reqs": n_ordered,
        "stage_ms_per_node": {s: round(avg[s], 2) for s in STAGES},
        "host_ms_per_ordered_req": {
            s: round(v, 4) for s, v in per_req.items()},
    }
    if per_node_subs and n_nodes and any(
            any(v for v in subs.values()) for subs in per_node_subs):
        sub_avg = {s: sum(subs.get(s, 0.0) for subs in per_node_subs)
                   / n_nodes for s in EXECUTE_SUBSTAGES}
        report["execute_substages"] = {
            s: round(sub_avg[s] / n_ordered if n_ordered else 0.0, 4)
            for s in EXECUTE_SUBSTAGES}
    return report


# telemetry stage-latency histogram feeding each budget stage's
# measured-p99 column (observability/telemetry.py TM names): the
# budget's exclusive-ms MEANS say where host time goes; the telemetry
# p99 next to them says what the TAIL of that stage looks like — a
# stage can be cheap on average and still own the latency SLO miss
_STAGE_TELEMETRY = {
    "propagate": _TM.STAGE_PROPAGATE_MS,
    "queue_wait": _TM.PIPELINE_QUEUE_WAIT_MS,
    "3pc": _TM.STAGE_3PC_MS,
    "dispatch_wait": _TM.STAGE_DISPATCH_MS,
    "execute": _TM.STAGE_EXECUTE_MS,
    "reply": _TM.STAGE_REPLY_MS,
}


def stage_p99s(telemetry_snapshot: Optional[dict]) -> Dict[str, float]:
    """Per-budget-stage measured p99 (ms) out of a telemetry snapshot
    (hub.snapshot() / the validator-info Telemetry section); stages
    without a telemetry histogram are absent."""
    if not telemetry_snapshot:
        return {}
    hists = telemetry_snapshot.get("histograms") or {}
    out: Dict[str, float] = {}
    for stage, metric in _STAGE_TELEMETRY.items():
        p99 = (hists.get(metric) or {}).get("p99")
        if p99 is not None:
            out[stage] = p99
    return out


def format_table(report: dict, telemetry_snapshot: dict = None) -> str:
    """Human-readable per-stage table (the ``trace_budget`` CLI). With
    a telemetry snapshot, each stage's measured p99 latency prints next
    to its exclusive-ms mean — budget and tail read together."""
    p99s = stage_p99s(telemetry_snapshot)
    header = "%-14s %14s %18s %6s" % (
        "stage", "host-ms/node", "ms/ordered-req", "share")
    if p99s:
        header += " %12s" % "p99-ms"
    lines = [header]
    per_req = report["host_ms_per_ordered_req"]
    total = per_req.get("total") or 0.0
    substages = report.get("execute_substages") or {}
    for stage in STAGES:
        share = (per_req[stage] / total * 100.0) if total else 0.0
        line = "%-14s %14.2f %18.4f %5.1f%%" % (
            stage, report["stage_ms_per_node"][stage], per_req[stage],
            share)
        if p99s:
            line += " %12s" % (("%.3f" % p99s[stage])
                               if stage in p99s else "-")
        lines.append(line)
        if stage == "execute" and substages:
            # the conflict-lane executor's split of the execute budget
            for name in EXECUTE_SUBSTAGES:
                lines.append("  %-12s %14s %18.4f" % (
                    name.replace("exec_", ""), "",
                    substages.get(name, 0.0)))
    lines.append("%-14s %14s %18.4f" % (
        "total", "", total))
    if p99s and telemetry_snapshot:
        e2e = ((telemetry_snapshot.get("histograms") or {})
               .get(_TM.ORDERED_E2E_MS) or {})
        if e2e.get("p99") is not None:
            lines.append("ordered e2e: p50=%.3f ms  p99=%.3f ms  "
                         "(telemetry, n=%d)" % (
                             e2e.get("p50") or 0.0, e2e["p99"],
                             e2e.get("count", 0)))
    lines.append("nodes=%d ordered_reqs=%d" % (
        report["nodes"], report["ordered_reqs"]))
    return "\n".join(lines)
