"""PT013 dispatch-without-collect.

The ops/ seams are split into async halves — ``X_dispatch`` /
``dispatch_X`` / ``begin_X`` enqueue device work and hand back a
generation (un-awaited arrays, deferred tries, read windows); the
matching ``X_collect`` / ``collect_X`` / ``end_X`` / ``resolve_X``
materializes it. The fused batch window and the merged hash resolve
hand generations ACROSS functions (the dispatch half returns
its handle; a frame several calls up resolves it), which is exactly
what a per-function rule cannot check: a dropped handle means device
work launched and never awaited — results silently discarded (the
state the caller thinks it wrote never materializes) and every
overlapped launch behind the seam leaks its slot.

Interprocedural encoding, on the engine's effect summaries:

* a call to a dispatch-shaped name opens its family at the site;
* a call to a function whose SUMMARY ``returns_open`` a family opens
  that family too (the handed-across-functions case);
* the site is clean when the handle is collected locally (family-
  matched closer, the seam alias table, or a materializer like
  ``np.asarray``/``.results()``), returned onward (the caller
  inherits), stored (``self.*`` / containers — pipeline objects own
  their generations), or passed to another call (delegated);
* it LEAKS when the result is discarded outright or bound to locals
  that are never used.

Dispatch halves themselves may return open generations — that is
their contract; obligations attach to call sites, so the top frame
that drops the generation is the one named in the finding.
"""
from __future__ import annotations

from typing import List

from plenum_tpu_torch.analysis.core import Finding, ProgramRule
from plenum_tpu_torch.analysis.engine.summaries import (
    site_families, site_verdict)


class DispatchWithoutCollectRule(ProgramRule):
    code = "PT013"
    name = "dispatch-without-collect"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check_program(self, engine, rel_paths) -> List[Finding]:
        out: List[Finding] = []
        graph = engine.graph
        for sym in sorted(graph.functions):
            fn = graph.functions[sym]
            path = graph.fn_path[sym]
            summary = engine.summaries.get(sym)
            closes = summary.closes if summary else set()
            resolved = {id(call): callee
                        for callee, call in graph.edges[sym]}
            for call in fn["calls"]:
                callee = resolved.get(id(call))
                families = site_families(call, callee,
                                         engine.summaries)
                if not families:
                    continue
                verdict, fams = site_verdict(call, families, fn,
                                             closes)
                if verdict != "leak":
                    continue
                for fam in fams:
                    via = families[fam]
                    out.append(Finding(
                        rule=self.code, severity=self.severity,
                        path=path, line=call["line"],
                        col=call["col"],
                        message=(
                            "dispatch generation '%s' opened via %s "
                            "is never collected: the device work is "
                            "launched and its results dropped — "
                            "collect/resolve it, return the handle "
                            "to the caller, or store it on the "
                            "owning pipeline object" % (
                                fam,
                                via if ":" not in via
                                else graph.display(via) + "()")),
                        symbol=fn["qname"]))
        return out
