"""Per-function summaries, computed bottom-up over the SCC condensation.

A summary is the whole-program rules' unit of composition: what a
function *does* to its callers, independent of how it does it.

* ``nondet`` — transitive nondeterminism-taint kinds (PT012 reports at
  the concrete source sites via forward reach; the summary powers
  ``--callgraph`` triage and the engine tests).
* ``pure`` — no attribute/global/subscript writes in the function or
  any resolved callee (advisory: unresolved calls don't poison it).
* ``returns_open`` — dispatch families whose un-collected generation
  this function hands BACK to its caller (the ``*_dispatch`` /
  ``begin_*`` effect system of PT013): a dispatch half returning its
  handle transfers the collect obligation up one frame.
* ``closes`` — families this function collect/resolve-calls.
* ``routes_bucket`` — bucket-shape evidence for PT014: the function
  itself (or a direct callee, one level deep — full transitivity would
  let any distant pow2 call excuse a raw local launch) calls one of
  the sanctioned bounded-shape helpers.

Cycles: every SCC is iterated to a true fixpoint — passes repeat
until no member's summary changes (the domain is finite and every
update monotone, so termination is bounded by the component's total
fact count; a fixed pass count is NOT enough when taint must cross
several hops against the component's processing order).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from plenum_tpu_torch.analysis.engine.callgraph import CallGraph
from plenum_tpu_torch.analysis.engine.symtab import (
    collect_families, dispatch_family)

# irregular closers: seams whose collect half doesn't follow the
# X_collect / collect_X / end_X / resolve_X naming (the merged device
# hash resolve closes BOTH deferred-apply families)
ALIAS_CLOSERS = {
    "resolve_applies": ("apply", "applies", "flush_deferred"),
    "flush_states_merged": ("flush_deferred",),
    "_resolve_and_store": ("apply",),
}

# materializing calls: handing a handle to one of these awaits it —
# numpy's, torch's device→host copies and the port's own collect
# halves (to_host of ops/sha256.py and ops/sha3.py, ops/sha256.py's
# Download and its wait)
GENERIC_CLOSERS = frozenset({
    "asarray", "array", "results", "result", "collect",
    "cpu", "tolist", "item", "numpy", "synchronize",
    "to_host", "Download", "wait",
})


def closer_closes(closer: str, family: str) -> bool:
    if family in collect_families(closer):
        return True
    if family in ALIAS_CLOSERS.get(closer, ()):
        return True
    return closer in GENERIC_CLOSERS


class FunctionSummary:
    __slots__ = ("sym", "nondet", "pure", "returns_open", "closes",
                 "routes_bucket", "opens_local",
                 "launches_param_shapes", "regions")

    def __init__(self, sym: str):
        self.sym = sym
        self.nondet: Set[str] = set()
        self.pure = True
        # family -> (line, col, via) of the site whose open generation
        # this function returns to its caller
        self.returns_open: Dict[str, Tuple[int, int, str]] = {}
        self.closes: Set[str] = set()
        self.routes_bucket = False
        # locally opened families (any disposition) — debugging aid
        self.opens_local: Set[str] = set()
        # PT014 pass-through seam: this function launches compiled
        # work whose operand shapes come in verbatim through its own
        # parameters — callers carry the bucket obligation
        self.launches_param_shapes = False
        # thread regions this function can execute in (PT016/PT017):
        # subset of {"prod", "worker", "daemon"} — filled in by
        # compute_regions after the callee-first fixpoint
        self.regions: Set[str] = set()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return ("FunctionSummary(%s nondet=%r pure=%r returns_open=%r "
                "closes=%r buckets=%r)" % (
                    self.sym, sorted(self.nondet), self.pure,
                    sorted(self.returns_open), sorted(self.closes),
                    self.routes_bucket))


def site_families(call: dict, callee: Optional[str],
                  summaries: Dict[str, FunctionSummary]
                  ) -> Dict[str, str]:
    """Families whose generation this call site OPENS, mapped to a
    'via' description: the syntactic ``*_dispatch``/``begin_*`` name,
    or the resolved callee's ``returns_open`` (a generation handed
    across functions)."""
    out: Dict[str, str] = {}
    term = call["chain"][-1] if call["chain"] else ""
    fam = dispatch_family(term)
    if fam:
        out[fam] = term
    if callee is not None:
        csum = summaries.get(callee)
        if csum:
            for f in csum.returns_open:
                out.setdefault(f, callee)
    return out


def site_verdict(call: dict, families: Dict[str, str], fn: dict,
                 local_closes: Set[str]) -> Tuple[str, List[str]]:
    """('leak'|'returned'|'ok', leaked_families) for one opening site.

    * discarded result → every family leaks;
    * bound to locals that are never used (no closer call, not
      returned, never escaping) → leaks, unless the function closes
      the family through another path (split-handle idioms);
    * returned (or produced inside a lambda) → the caller inherits;
    * anything else (stored on self, passed onward, tuple-embedded)
      escapes this frame's responsibility.
    """
    flow = call["flow"]
    if call.get("in_lambda"):
        return "ok", []
    if flow == "returned":
        return "returned", sorted(families)
    if flow == "discarded":
        leaked = [f for f in families if f not in local_closes]
        return ("leak", leaked) if leaked else ("ok", [])
    if flow == "named":
        flows = fn.get("name_flows", {})
        used = returned = False
        closers: List[str] = []
        for nm in call.get("names", ()):
            nf = flows.get(nm)
            if not nf:
                continue
            used = True
            returned = returned or nf.get("returned", False)
            closers.extend(nf.get("closers", ()))
            if nf.get("escapes"):
                return "ok", []
        if returned:
            return "returned", sorted(families)
        leaked = []
        for f in sorted(families):
            if f in local_closes:
                continue
            if any(closer_closes(c, f) for c in closers):
                continue
            if closers:
                # handed to some call we can't pair — delegated, not
                # provably leaked
                continue
            if not used:
                leaked.append(f)
        return ("leak", leaked) if leaked else ("ok", [])
    return "ok", []


def _local_closes(fn: dict) -> Set[str]:
    out: Set[str] = set()
    for call in fn["calls"]:
        term = call["chain"][-1] if call["chain"] else ""
        out.update(collect_families(term))
        out.update(ALIAS_CLOSERS.get(term, ()))
    return out


def _fingerprint(s: Optional[FunctionSummary]):
    if s is None:
        return None
    return (len(s.nondet), s.pure, tuple(sorted(s.returns_open)),
            len(s.closes), s.routes_bucket, len(s.opens_local),
            s.launches_param_shapes)


def compute_summaries(graph: CallGraph) -> Dict[str, FunctionSummary]:
    summaries: Dict[str, FunctionSummary] = {}
    for comp in graph.sccs():
        # iterate the component to a TRUE fixpoint: a fact may need
        # several passes to cross the component against its member
        # order (finite monotone domain -> guaranteed termination)
        while True:
            before = [_fingerprint(summaries.get(sym))
                      for sym in comp]
            for sym in comp:
                _summarize(graph, summaries, sym)
            if len(comp) == 1 or before == [
                    _fingerprint(summaries.get(sym))
                    for sym in comp]:
                break
    return summaries


THREAD_REGION_LABELS = ("worker", "daemon")

# terminal names that shadow builtin-container methods: the callgraph's
# unique-name fallback may bind ``some_list.extend(...)`` to the one
# project symbol named ``extend``, and region labels spread through the
# transitive closure — one bad edge mislabels a whole subsystem as
# worker-side. Region propagation therefore refuses fallback-resolved
# edges for these names; precisely resolved edges still traverse.
_CONTAINER_SHADOWS = frozenset({
    "append", "appendleft", "extend", "add", "update", "pop", "popleft",
    "get", "put", "put_nowait", "clear", "remove", "discard", "insert",
    "sort", "copy", "keys", "values", "items", "setdefault", "run",
    "send", "close", "submit", "start", "stop", "reset", "extend_hashes",
})


def _region_callees(graph: CallGraph, sym: str) -> Set[str]:
    """Callees for region propagation: precise resolution always,
    unique-name fallback only for terminals that cannot be builtin
    container/handle methods."""
    out: Set[str] = set()
    for call in graph.functions[sym].get("calls", ()):
        chain = call["chain"]
        if not chain:
            continue
        callee = graph.resolve_call(sym, chain, fallback=False)
        if callee is None and chain[-1] not in _CONTAINER_SHADOWS:
            callee = graph.resolve_call(sym, chain)
        if callee is not None:
            out.add(callee)
    return out


def _region_reach(graph: CallGraph, seeds: List[str]) -> Set[str]:
    seen: Set[str] = set()
    frontier = [s for s in seeds if s in graph.functions]
    while frontier:
        sym = frontier.pop()
        if sym in seen:
            continue
        seen.add(sym)
        frontier.extend(c for c in _region_callees(graph, sym)
                        if c not in seen)
    return seen


def spawn_roots(graph: CallGraph) -> Dict[str, str]:
    """Resolved spawn-target symbols → thread-region label.

    A function handed to ``Thread(target=...)``, ``pool.submit(...)``
    or ``loop.run_in_executor(...)`` seeds a non-prod region. The
    label is ``daemon`` when either end of the spawn lives in a
    *daemon* module/class (the verify daemon's device worker),
    ``worker`` otherwise (pipeline parse stage, exec pool)."""
    roots: Dict[str, str] = {}
    for sym, fn in graph.functions.items():
        for spawn in fn.get("spawns", ()):
            for chain in spawn.get("targets", ()):
                callee = graph.resolve_call(sym, chain, fallback=False)
                if callee is None \
                        and chain[-1] not in _CONTAINER_SHADOWS:
                    callee = graph.resolve_call(sym, chain)
                if callee is None:
                    continue
                label = "daemon" if (
                    "daemon" in sym.lower()
                    or "daemon" in callee.lower()) else "worker"
                # daemon is the more specific label — keep it if any
                # spawn site says so
                if roots.get(callee) != "daemon":
                    roots[callee] = label
    return roots


def compute_regions(graph: CallGraph) -> Dict[str, Set[str]]:
    """Executing-region sets for every function symbol.

    Forward closure from the spawn roots labels the worker/daemon
    side; everything NOT reachable from a spawn root seeds ``prod``,
    and prod's own forward closure then re-adds ``prod`` to shared
    helpers — a function called from both sides ends up
    ``{"prod", "worker"}``, which is exactly the multi-region evidence
    PT016 keys on. Functions only ever entered from a spawned thread
    (worker loops, their private callees) stay single-region."""
    regions: Dict[str, Set[str]] = {
        sym: set() for sym in graph.functions}
    roots = spawn_roots(graph)
    for label in THREAD_REGION_LABELS:
        seeds = [s for s, r in roots.items() if r == label]
        if not seeds:
            continue
        for sym in _region_reach(graph, seeds):
            regions[sym].add(label)
    prod_seeds = [sym for sym, regs in regions.items() if not regs]
    for sym in _region_reach(graph, prod_seeds):
        regions[sym].add("prod")
    return regions


def _summarize(graph: CallGraph,
               summaries: Dict[str, FunctionSummary],
               sym: str) -> None:
    fn = graph.functions[sym]
    s = summaries.get(sym) or FunctionSummary(sym)
    summaries[sym] = s
    s.nondet |= {rec["kind"] for rec in fn["nondet"]}
    s.pure = s.pure and not fn["mutates"]
    s.closes |= _local_closes(fn)
    s.routes_bucket = s.routes_bucket or fn["buckets"]
    resolved = {id(call): callee for callee, call in graph.edges[sym]}
    for call in fn["calls"]:
        callee = resolved.get(id(call))
        csum = summaries.get(callee) if callee is not None else None
        if csum:
            s.nondet |= csum.nondet
            s.pure = s.pure and csum.pure
            if graph.functions[callee]["buckets"]:
                s.routes_bucket = True
        launcher = call.get("builder") or call.get("captured") \
            or (csum is not None and csum.launches_param_shapes) \
            or graph.is_jit_callee(sym, call["chain"])
        if launcher and call.get("arg_param_only") \
                and not call.get("arg_bucketed") \
                and not fn["buckets"]:
            s.launches_param_shapes = True
        families = site_families(call, callee, summaries)
        if not families:
            continue
        s.opens_local |= set(families)
        verdict, fams = site_verdict(call, families, fn, s.closes)
        if verdict == "returned":
            for f in fams:
                s.returns_open.setdefault(
                    f, (call["line"], call["col"], families[f]))
