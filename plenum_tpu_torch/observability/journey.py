"""Journey plane — per-request cross-node causal records and quorum
critical-path attribution.

The flight recorder (tracing.py) answers "what did THIS node spend its
time on"; the telemetry plane answers "what are the distributions".
Neither answers the question that decides where pipeline work goes
next: for one ordered request, WHERE did its wall-clock go ACROSS the
pool — the wire, waiting for the slowest quorum voter, or local
stages?  This module joins the per-node tracer buffers (or an exported
Chrome trace document — both forms carry the same records) with the
wire-carried trace stamps (flat_wire KIND_TRACE / typed ``traceCtx``)
into:

* **per-request journeys**, keyed by request digest and joined to the
  owning 3PC batch through the ``order`` span's ``digests`` arg:
  client intake (``request_accepted``) → propagate-quorum close
  (``propagate_quorum``, naming the relay whose vote supplied the
  f+1'th) → per-node PRE-PREPARE receive (``pp_process``) → prepare/
  commit quorum close (``prepare_quorum``/``commit_quorum``, naming
  the closing voter) → ``order`` → ``reply``, per node;
* **per-directed-link clock model**: every stamped envelope yields one
  (send perf/wall, receive perf/wall) sample; per-node wall offsets
  (median of ``wall − perf`` across wire samples) align timelines
  recorded by different processes, and the remaining per-link offset
  asymmetry — ``skew(a→b) = (median Δ(a→b) − median Δ(b→a)) / 2`` —
  separates residual clock skew from one-way delay, so each hop gets a
  defensible one-way delay estimate even without synchronised clocks;
* **per-batch critical path**: the node whose ``order`` completed
  last, the phase chain that fed it, and the last hop (peer → node,
  with its delay estimate) that closed the final quorum — plus a
  breakdown of the ordered end-to-end time into wire / straggler-wait
  / local-stage shares (the pool25 bench headline and the input to
  the pipeline-parallel roadmap item).

Everything here is ADVISORY read-side joinery: it consumes recorded
events after the fact and touches no consensus state. A pool run with
stripped or corrupted stamps (adversary taps degrade the outbox to
per-message sends, which carry no stamps) simply yields journeys with
no link samples — per-node phase records survive, hop delays read 0,
and nothing fails.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# journey phases in nominal money-path order. NOTE: only a subset of
# pairwise orderings is causally guaranteed (quorum closes can precede
# a node's own pp_recv under out-of-order delivery) — see
# causal_violations for the exact DAG that is checked
PHASES = ("intake", "propagate_close", "pp_recv", "prepare_close",
          "commit_close", "order", "reply")


# --------------------------------------------------- event normalization

def _events_from_tracers(tracers: Iterable) -> Dict[str, List[tuple]]:
    """Live Tracer buffers → node → [(kind, name, t0, t1, key, args)].
    Timestamps stay in the tracers' perf_counter seconds."""
    by_node: Dict[str, List[tuple]] = {}
    for tracer in tracers:
        if tracer is None:
            continue
        recs = tracer.spans()
        if not recs:
            continue
        out = by_node.setdefault(tracer.name or "node", [])
        for kind, name, _cat, t0, t1, key, args in recs:
            out.append((kind, name, t0, t1, key, args or {}))
    return by_node


def _events_from_chrome(doc: dict) -> Dict[str, List[tuple]]:
    """Exported Chrome trace document → the same per-node event lists
    (microsecond ts → seconds)."""
    events = doc.get("traceEvents", [])
    pid_names = {e["pid"]: e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    by_node: Dict[str, List[tuple]] = {}
    for e in events:
        ph = e.get("ph")
        if ph not in ("X", "i"):
            continue
        node = pid_names.get(e.get("pid"), str(e.get("pid")))
        t0 = e.get("ts", 0) * 1e-6
        t1 = t0 + e.get("dur", 0) * 1e-6
        args = dict(e.get("args") or {})
        key = args.pop("key", None)
        by_node.setdefault(node, []).append(
            (ph, e.get("name", ""), t0, t1, key, args))
    return by_node


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


# ----------------------------------------------------- clock/link model

class _ClockModel:
    """Per-node wall alignment + per-directed-link skew/delay, built
    solely from ``wire_recv`` instants (each carries the SENDER's
    perf/wall pair out of the stamp next to the receiver's own)."""

    def __init__(self, by_node: Dict[str, List[tuple]]):
        offset_samples: Dict[str, List[float]] = {}
        link_raw: Dict[Tuple[str, str], List[float]] = {}
        recv_index: Dict[str, List[tuple]] = {}
        for node, events in by_node.items():
            for kind, name, t0, _t1, _key, args in events:
                if kind != "i" or name != "wire_recv":
                    continue
                origin = args.get("origin")
                sent_perf = args.get("sent_perf")
                sent_wall = args.get("sent_wall")
                recv_wall = args.get("recv_wall")
                if origin is None or sent_perf is None:
                    continue
                if sent_wall:
                    offset_samples.setdefault(origin, []).append(
                        sent_wall - sent_perf)
                if recv_wall:
                    offset_samples.setdefault(node, []).append(
                        recv_wall - t0)
                link_raw.setdefault((origin, node), []).append(
                    (t0, sent_perf))
                recv_index.setdefault(node, []).append(
                    (t0, origin, args.get("frm", origin)))
        self.wall_offset: Dict[str, float] = {
            n: _median(s) for n, s in offset_samples.items()}
        # nodes never seen on the wire align to the pool median (exact
        # for single-process traces, where every offset is equal)
        self._default_offset = _median(list(self.wall_offset.values()))
        # aligned send→recv deltas per directed link
        deltas: Dict[Tuple[str, str], List[float]] = {}
        for (a, b), samples in link_raw.items():
            deltas[(a, b)] = [
                (t_recv + self.offset(b)) - (sp + self.offset(a))
                for t_recv, sp in samples]
        medians = {lk: _median(ds) for lk, ds in deltas.items()}
        self.skew: Dict[Tuple[str, str], float] = {}
        self.delay: Dict[Tuple[str, str], float] = {}
        self.samples: Dict[Tuple[str, str], int] = {}
        for (a, b), med in medians.items():
            rev = medians.get((b, a))
            skew = (med - rev) / 2.0 if rev is not None else 0.0
            self.skew[(a, b)] = skew
            self.delay[(a, b)] = max(0.0, med - skew)
            self.samples[(a, b)] = len(deltas[(a, b)])
        for node, idx in recv_index.items():
            idx.sort()
        self._recv_index = recv_index

    def offset(self, node: str) -> float:
        return self.wall_offset.get(node, self._default_offset)

    def aligned(self, node: str, t: Optional[float]) -> Optional[float]:
        return None if t is None else t + self.offset(node)

    def hop_delay(self, frm: str, to: str) -> float:
        """Median one-way delay estimate for a directed link, seconds
        (0.0 when the link never carried a stamp — degraded mode)."""
        return self.delay.get((frm, to), 0.0)

    def last_hop_before(self, node: str, frm: str,
                        t_local: float) -> Optional[float]:
        """Receive time (local clock) of the last stamped envelope
        ``frm → node`` at or before ``t_local`` — the envelope that
        plausibly carried the event closing a quorum at ``t_local``."""
        best = None
        for t_recv, origin, sender in self._recv_index.get(node, ()):
            if t_recv > t_local + 1e-9:
                break
            if origin == frm or sender == frm:
                best = t_recv
        return best

    def links_report(self) -> Dict[str, dict]:
        out = {}
        for (a, b), d in sorted(self.delay.items()):
            out["%s->%s" % (a, b)] = {
                "samples": self.samples[(a, b)],
                "delay_ms": round(d * 1e3, 4),
                "skew_ms": round(self.skew[(a, b)] * 1e3, 4),
            }
        return out


# ------------------------------------------------------------- the join

def _phase_records(by_node: Dict[str, List[tuple]]):
    """One pass over every node's events → the join indexes."""
    intake: Dict[str, List[Tuple[float, str]]] = {}       # digest
    prop: Dict[str, Dict[str, dict]] = {}                 # digest→node
    digest_to_batch: Dict[str, str] = {}
    batches: Dict[str, dict] = {}
    # (viewNo:ppSeqNo) → [(pp digest, observer, sender, t)] — every
    # PRE-PREPARE a node processed, INCLUDING ones it went on to
    # discard as conflicting: the raw material for equivocation
    # evidence (an equivocating primary's second digest never lands in
    # any prePrepares store, but its pp_process span is on the record)
    pp_obs: Dict[str, List[tuple]] = {}

    def batch(key: str) -> dict:
        return batches.setdefault(key, {
            "key": key, "digests": [], "primary": None,
            "pp_create": None, "nodes": {}, "stragglers": []})

    def node_rec(key: str, node: str) -> dict:
        return batch(key)["nodes"].setdefault(node, {})

    gateway: Dict[str, List[Tuple[float, str]]] = {}      # digest

    for node, events in by_node.items():
        for kind, name, t0, t1, key, args in events:
            if name == "request_accepted" and key:
                intake.setdefault(key, []).append((t0, node))
            elif name == "gateway_admit" and key:
                gateway.setdefault(key, []).append((t0, node))
            elif name == "propagate_quorum" and key:
                prop.setdefault(key, {})[node] = {
                    "t": t0, "closer": args.get("closer"),
                    "votes": args.get("votes")}
            elif name == "pp_create" and key:
                b = batch(key)
                b["primary"] = node
                b["pp_create"] = {"node": node, "t0": t0, "t1": t1}
                node_rec(key, node)["pp_recv"] = t1
            elif name == "pp_process" and key:
                node_rec(key, node).setdefault("pp_recv", t0)
                if args.get("digest"):
                    pp_obs.setdefault(key, []).append(
                        (args["digest"], node, args.get("frm"), t0))
            elif name in ("prepare_quorum", "commit_quorum") and key:
                phase = name.split("_")[0]
                rec = node_rec(key, node)
                rec[phase + "_close"] = t0
                rec[phase + "_closer"] = args.get("closer")
            elif name in ("prepare_vote_late", "commit_vote_late") and key:
                batch(key)["stragglers"].append({
                    "phase": name.split("_")[0], "node": node,
                    "frm": args.get("frm"), "t": t0})
            elif name == "order" and key:
                # the ordering DECISION anchors at span start: the
                # executor's commit + reply run nested inside this
                # span, so its end is after the reply and would break
                # the causal chain
                rec = node_rec(key, node)
                rec.setdefault("order", t0)
                rec["order_end"] = t1
                for d in args.get("digests") or ():
                    digest_to_batch[d] = key
                    b = batch(key)
                    if d not in b["digests"]:
                        b["digests"].append(d)
            elif name == "ordered" and key:
                # replica-level Ordered emission — the preferred order
                # anchor when present (fires before the commit/reply
                # work the order span encloses)
                node_rec(key, node)["order"] = t0
            elif name == "reply" and key:
                node_rec(key, node)["reply"] = t1
    return intake, prop, digest_to_batch, batches, pp_obs, gateway


def _equivocations(pp_obs: Dict[str, List[tuple]],
                   clocks: _ClockModel) -> List[dict]:
    """(viewNo:ppSeqNo) slots where the pool processed CONFLICTING
    PRE-PREPARE digests → the evidence chain: which digests, observed
    by whom, from whom, when (aligned clock). Two distinct digests for
    one slot is the definition of primary equivocation — the exact
    artifact an invariant-failure dump needs to pin the culprit."""
    out: List[dict] = []
    for key, obs in sorted(pp_obs.items()):
        digests = sorted({d for d, _, _, _ in obs})
        if len(digests) < 2:
            continue
        chain = {}
        for d in digests:
            chain[d] = [
                {"observed_by": node, "frm": frm,
                 "t": clocks.aligned(node, t)}
                for dd, node, frm, t in sorted(
                    obs, key=lambda o: o[3]) if dd == d]
        out.append({"key": key, "digests": digests, "evidence": chain})
    return out


def _critical_path(b: dict, intake_t: Optional[Tuple[float, str]],
                   prop_close: Optional[dict],
                   clocks: _ClockModel) -> Optional[dict]:
    """The per-batch attribution: last node, its phase chain, the last
    hop, and the wire/straggler/local breakdown of ordered e2e."""
    nodes = b["nodes"]
    done = [(clocks.aligned(n, r["order"]), n) for n, r in nodes.items()
            if r.get("order") is not None]
    if not done:
        return None
    _t_last, last = max(done)
    rec = nodes[last]
    primary = b["primary"]
    al = clocks.aligned

    hops: List[dict] = []

    def hop(frm: Optional[str], phase: str) -> float:
        if not frm or frm == last:
            return 0.0
        d = clocks.hop_delay(frm, last)
        hops.append({"from": frm, "to": last, "phase": phase,
                     "delay_ms": round(d * 1e3, 4)})
        return d

    # chain timestamps on the last node (aligned domain)
    t_intake = intake_t[0] if intake_t else None
    t_prop = (prop_close or {}).get("t")
    t_pp_sent = al(primary, (b["pp_create"] or {}).get("t1")) \
        if primary else None
    t_pp = al(last, rec.get("pp_recv"))
    t_prep = al(last, rec.get("prepare_close"))
    t_com = al(last, rec.get("commit_close"))
    t_order = al(last, rec.get("order"))
    t_reply = al(last, rec.get("reply"))

    wire = 0.0
    if prop_close and prop_close.get("closer") and primary:
        wire += clocks.hop_delay(prop_close["closer"], primary) \
            if prop_close["closer"] != primary else 0.0
    if last != primary and primary:
        wire += hop(primary, "pp")
    prep_hop = hop(rec.get("prepare_closer"), "prepare")
    com_hop = hop(rec.get("commit_closer"), "commit")
    wire += prep_hop + com_hop

    def seg(name: str, a: Optional[float], z: Optional[float]):
        if a is None or z is None:
            return None
        return {"name": name, "ms": round(max(0.0, z - a) * 1e3, 4)}

    segments = [s for s in (
        seg("intake->propagate_close", t_intake, t_prop),
        seg("propagate_close->pp_sent", t_prop, t_pp_sent),
        seg("pp_sent->pp_recv", t_pp_sent, t_pp),
        seg("pp_recv->prepare_close", t_pp, t_prep),
        seg("prepare_close->commit_close", t_prep, t_com),
        seg("commit_close->order", t_com, t_order),
        seg("order->reply", t_order, t_reply),
    ) if s is not None]

    straggler = 0.0
    if t_pp is not None and t_prep is not None:
        straggler += max(0.0, (t_prep - t_pp) - prep_hop)
    if t_prep is not None and t_com is not None:
        straggler += max(0.0, (t_com - t_prep) - com_hop)

    t_end = t_reply if t_reply is not None else t_order
    e2e = (t_end - t_intake) if (t_intake is not None
                                 and t_end is not None) else None
    breakdown = None
    if e2e and e2e > 0:
        wire_pct = min(100.0, wire / e2e * 100.0)
        strag_pct = min(100.0 - wire_pct, straggler / e2e * 100.0)
        breakdown = {
            "e2e_ms": round(e2e * 1e3, 4),
            "wire_pct": round(wire_pct, 2),
            "straggler_pct": round(strag_pct, 2),
            "local_pct": round(100.0 - wire_pct - strag_pct, 2),
        }
    return {
        "node": last,
        "phase": "reply" if t_reply is not None else "order",
        "last_hop": hops[-1] if hops else None,
        "hops": hops,
        "segments": segments,
        "breakdown": breakdown,
    }


def _build(by_node: Dict[str, List[tuple]]) -> dict:
    clocks = _ClockModel(by_node)
    intake, prop, digest_to_batch, batches, pp_obs, gateway = \
        _phase_records(by_node)

    requests: Dict[str, dict] = {}
    degraded = not clocks.delay   # no stamped envelope anywhere
    for digest in sorted(set(intake) | set(prop) | set(digest_to_batch)
                         | set(gateway)):
        arrivals = sorted(
            (clocks.aligned(n, t), n) for t, n in intake.get(digest, ()))
        closes = sorted(
            ((clocks.aligned(n, rec["t"]), n, rec)
             for n, rec in prop.get(digest, {}).items()))
        bkey = digest_to_batch.get(digest)
        admits = sorted(
            (clocks.aligned(n, t), n) for t, n in gateway.get(digest, ()))
        requests[digest] = {
            "digest": digest,
            "batch": bkey,
            "gateway": ({"node": admits[0][1],
                         "t": admits[0][0]} if admits else None),
            "intake": ({"node": arrivals[0][1],
                        "t": arrivals[0][0]} if arrivals else None),
            "propagate_close": ({"node": closes[0][1], "t": closes[0][0],
                                 "closer": closes[0][2].get("closer"),
                                 "votes": closes[0][2].get("votes")}
                                if closes else None),
            "propagate_nodes": {n: clocks.aligned(n, rec["t"])
                                for n, rec in prop.get(digest, {}).items()},
        }

    for key, b in batches.items():
        first_intake = None
        prop_close_primary = None
        for digest in b["digests"]:
            r = requests.get(digest) or {}
            it = r.get("intake")
            if it and (first_intake is None or it["t"] < first_intake[0]):
                first_intake = (it["t"], it["node"])
            # the batch cannot form before its LAST digest finalises on
            # the primary — that propagate close gates pp_create
            pn = r.get("propagate_nodes") or {}
            t_primary = pn.get(b["primary"]) if b["primary"] else None
            if t_primary is not None and (
                    prop_close_primary is None
                    or t_primary > prop_close_primary["t"]):
                pc = (prop.get(digest) or {}).get(b["primary"]) or {}
                prop_close_primary = {"t": t_primary,
                                      "closer": pc.get("closer")}
        b["critical_path"] = _critical_path(
            b, first_intake, prop_close_primary, clocks)

    complete = sum(
        1 for r in requests.values()
        if r["batch"] and r["intake"] and r["propagate_close"]
        and all(rec.get("order") is not None
                for rec in batches[r["batch"]]["nodes"].values()))
    return {
        "nodes": sorted(by_node),
        "requests": requests,
        "batches": batches,
        "links": clocks.links_report(),
        "wall_offsets": {n: round(v, 6)
                         for n, v in sorted(clocks.wall_offset.items())},
        "complete_requests": complete,
        "degraded": degraded,
        "breakdown": pool_breakdown(batches),
        "equivocations": _equivocations(pp_obs, clocks),
        "_clocks": clocks,
    }


def pool_breakdown(batches: Dict[str, dict]) -> Optional[dict]:
    """Average the per-batch critical-path breakdowns → the pool-level
    wire / straggler / local shares (the bench headline)."""
    rows = [b["critical_path"]["breakdown"] for b in batches.values()
            if b.get("critical_path")
            and b["critical_path"].get("breakdown")]
    if not rows:
        return None
    n = len(rows)
    return {
        "batches": n,
        "e2e_ms_mean": round(sum(r["e2e_ms"] for r in rows) / n, 4),
        "wire_pct": round(sum(r["wire_pct"] for r in rows) / n, 2),
        "straggler_pct": round(
            sum(r["straggler_pct"] for r in rows) / n, 2),
        "local_pct": round(sum(r["local_pct"] for r in rows) / n, 2),
    }


def journeys_from_tracers(tracers: Iterable) -> dict:
    """Live per-node Tracer buffers → the journey report."""
    return _build(_events_from_tracers(tracers))


def journeys_from_chrome(doc: dict) -> dict:
    """Exported Chrome trace document (trace_view / scenario dumps) →
    the same journey report, reconstructed from the file."""
    return _build(_events_from_chrome(doc))


# -------------------------------------------------------------- checks

def causal_violations(report: dict) -> List[str]:
    """Check the report against what the money path genuinely
    guarantees, per node in the ALIGNED clock domain:

    * gateway admit ≤ intake ≤ propagate close (per request);
    * on the primary, the batch's gating propagate close ≤ pp_create
      (the batch cannot form before its last digest finalises);
    * pp_recv ≤ order, prepare_close ≤ order, commit_close ≤ order
      (ordering requires the PRE-PREPARE and both quorums);
    * order ≤ reply.

    Deliberately a DAG, not a chain: peers' PREPARE/COMMIT votes can
    land — and close a counted quorum — BEFORE this node's own copy of
    the PRE-PREPARE arrives (out-of-order delivery), so quorum closes
    are ordered only against ``order``, not against ``pp_recv`` or each
    other. → human-readable violation list; empty = the recorded
    history is causally consistent."""
    out: List[str] = []
    clocks = report.get("_clocks")
    eps = 1e-9
    for key, b in sorted((report.get("batches") or {}).items()):
        t_gate = None
        for digest in b["digests"]:
            r = (report.get("requests") or {}).get(digest) or {}
            it, pc = r.get("intake"), r.get("propagate_close")
            gw = r.get("gateway")
            if gw and it and it["t"] < gw["t"] - eps:
                out.append("%s: intake before gateway admit" % digest)
            if it and pc and pc["t"] < it["t"] - eps:
                out.append("%s: propagate close before intake" % digest)
            if pc and (t_gate is None or pc["t"] > t_gate):
                t_gate = pc["t"]
        for node, rec in sorted(b["nodes"].items()):
            al = (lambda t: clocks.aligned(node, t)) if clocks \
                else (lambda t: t)
            t_order = al(rec.get("order"))
            t_reply = al(rec.get("reply"))
            if node == b["primary"] and t_gate is not None:
                t_pp = al(rec.get("pp_recv"))
                if t_pp is not None and t_pp < t_gate - eps:
                    out.append(
                        "%s@%s: pp_create (%.6f) before propagate_close "
                        "(%.6f)" % (key, node, t_pp, t_gate))
            if t_order is not None:
                for name in ("pp_recv", "prepare_close", "commit_close"):
                    t = al(rec.get(name))
                    if t is not None and t_order < t - eps:
                        out.append(
                            "%s@%s: order (%.6f) before %s (%.6f)" % (
                                key, node, t_order, name, t))
            if t_reply is not None and t_order is not None \
                    and t_reply < t_order - eps:
                out.append("%s@%s: reply (%.6f) before order (%.6f)" % (
                    key, node, t_reply, t_order))
    return out


# ---------------------------------------------------------- exposition

def format_table(report: dict) -> str:
    """Human-readable journey report (the ``pool_journey`` CLI)."""
    lines = []
    reqs = report.get("requests") or {}
    lines.append("journeys: %d request(s), %d complete, %d batch(es)%s"
                 % (len(reqs), report.get("complete_requests", 0),
                    len(report.get("batches") or {}),
                    "  [DEGRADED: no wire stamps]"
                    if report.get("degraded") else ""))
    links = report.get("links") or {}
    if links:
        lines.append("links (median one-way delay, skew-corrected):")
        for name, l in links.items():
            lines.append("  %-22s %8.3f ms  (skew %+.3f ms, n=%d)" % (
                name, l["delay_ms"], l["skew_ms"], l["samples"]))
    for eq in report.get("equivocations") or ():
        lines.append("EQUIVOCATION at %s: %d conflicting digests" % (
            eq["key"], len(eq["digests"])))
        for d in eq["digests"]:
            obs = eq["evidence"][d]
            lines.append("  %s observed by %s" % (
                d[:16], ", ".join(sorted(
                    {"%s (from %s)" % (o["observed_by"], o["frm"])
                     for o in obs}))))
    for key, b in sorted((report.get("batches") or {}).items()):
        cp = b.get("critical_path") or {}
        bd = cp.get("breakdown") or {}
        lines.append("batch %-8s primary=%s digests=%d last=%s/%s" % (
            key, b.get("primary"), len(b["digests"]),
            cp.get("node"), cp.get("phase")))
        hop = cp.get("last_hop")
        if hop:
            lines.append("  last hop: %s -> %s (%s, %.3f ms)" % (
                hop["from"], hop["to"], hop["phase"], hop["delay_ms"]))
        for s in cp.get("segments") or ():
            lines.append("  %-28s %10.3f ms" % (s["name"], s["ms"]))
        if bd:
            lines.append("  e2e %.3f ms = wire %.1f%% + straggler %.1f%%"
                         " + local %.1f%%" % (
                             bd["e2e_ms"], bd["wire_pct"],
                             bd["straggler_pct"], bd["local_pct"]))
    bd = report.get("breakdown")
    if bd:
        lines.append(
            "pool critical path (%d batches): e2e %.3f ms mean = "
            "wire %.1f%% + straggler %.1f%% + local %.1f%%" % (
                bd["batches"], bd["e2e_ms_mean"], bd["wire_pct"],
                bd["straggler_pct"], bd["local_pct"]))
    return "\n".join(lines)


def to_json(report: dict) -> dict:
    """The report minus the internal clock model (JSON-safe)."""
    return {k: v for k, v in report.items() if not k.startswith("_")}
