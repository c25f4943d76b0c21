"""PT016 cross-region-mutable-state.

The whole-program successor to the PT004 heuristic, built on the
engine's thread-region analysis (engine/summaries.compute_regions).
The pipelined node broke the reference's single-thread model with
a worker parse stage, a prescreen cache and an exec pool, and the
analyzer, not review, enforces the ownership contract at those
seams. PT004 could only see spawns and writes
inside ONE class — but the pipeline hands ``lambda:
self._pipeline_parse(...)`` across a queue from `server/node.py` into
`runtime/pipeline.py`, so the worker side of the program is a
cross-module call closure only the engine can compute.

Encoding: every function symbol carries the set of thread regions it
can execute in (``prod`` / ``worker`` / ``daemon`` — forward closure
from resolved ``Thread(target=...)`` / ``pool.submit`` /
``run_in_executor`` targets, lambda spawn bodies included). Per
class, self-attribute rebinds are bucketed by the writing method's
region (``__init__`` excluded: construction happens before any thread
exists; subscript stores excluded: the sanctioned Tracer fixed-slot
pattern). Two defect shapes, both requiring an unlocked site:

* a **consensus-named attribute** (the OrderingService/Propagator
  vocabulary shared with PT004) written from the worker/daemon side —
  flagged even with no prod-side co-writer, because the pipeline
  ownership contract says workers parse and the prod thread counts;
* any attribute written from **both** a worker-region method and a
  prod-region method with no lock in evidence.

Messages are byte-identical to PT004's, the fallback that runs when
the engine cannot build, so one finding reads the same under either
rule. The runtime twin of this rule is ``runtime/sanitizer.py``: a PT016-clean
seam needs no region pin, and every pinned label names state in this
rule's consensus-owned vocabulary.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from plenum_tpu_torch.analysis.core import Finding, ProgramRule
from plenum_tpu_torch.analysis.rules.pt004_threads import _consensus_attr

# regions whose code runs off the prod thread
OFF_PROD = frozenset({"worker", "daemon"})


class CrossRegionMutableStateRule(ProgramRule):
    code = "PT016"
    name = "cross-region-mutable-state"
    subsumes = "PT004"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check_program(self, engine, rel_paths) -> List[Finding]:
        # class key -> region bucket -> attr -> [(method, line, col,
        # locked)]; bucketing mirrors PT004 (a multi-region method
        # lands on the worker side: that is where its writes can race)
        classes: Dict[Tuple[str, str], Dict[str, Dict[str, List]]] = {}
        for sym, fn in engine.graph.functions.items():
            cls = fn.get("cls")
            if not cls or fn["name"] == "__init__":
                continue
            writes = fn.get("attr_writes", ())
            if not writes:
                continue
            regions = engine.regions.get(sym, set())
            side = "worker" if regions & OFF_PROD else "prod"
            path = engine.path_of(sym)
            buckets = classes.setdefault((path, cls), {})
            per_attr = buckets.setdefault(side, {})
            for w in writes:
                per_attr.setdefault(w["attr"], []).append(
                    (fn["name"], w["line"], w["col"], w["locked"]))
        out: List[Finding] = []
        for (path, cls), buckets in sorted(classes.items()):
            worker_writes = buckets.get("worker", {})
            prod_writes = buckets.get("prod", {})
            dual = set(worker_writes) & set(prod_writes)
            for attr in sorted(set(worker_writes) - dual):
                if not _consensus_attr(attr):
                    continue
                unlocked = [s for s in worker_writes[attr] if not s[3]]
                if not unlocked:
                    continue
                name, line, col, _ = unlocked[0]
                out.append(Finding(
                    rule=self.code, severity=self.severity, path=path,
                    line=line, col=col,
                    message="self.%s (consensus state) is written from "
                    "the worker-thread path (%s) — consensus state is "
                    "owned by the prod thread; workers may only parse "
                    "and hand immutable results back over the queue" % (
                        attr,
                        "/".join(sorted({s[0]
                                         for s in worker_writes[attr]}))),
                    symbol="%s.%s" % (cls.rsplit(".", 1)[-1], name)))
            for attr in sorted(dual):
                w_sites = worker_writes[attr]
                p_sites = prod_writes[attr]
                unlocked = [s for s in w_sites + p_sites if not s[3]]
                if not unlocked:
                    continue
                name, line, col, _ = unlocked[0]
                out.append(Finding(
                    rule=self.code, severity=self.severity, path=path,
                    line=line, col=col,
                    message="self.%s is written from both the "
                    "worker-thread path (%s) and loop code (%s) without "
                    "a lock — use a lock or the Tracer fixed-slot "
                    "pattern" % (
                        attr,
                        "/".join(sorted({s[0] for s in w_sites})),
                        "/".join(sorted({s[0] for s in p_sites}))),
                    symbol="%s.%s" % (cls.rsplit(".", 1)[-1], name)))
        return out
