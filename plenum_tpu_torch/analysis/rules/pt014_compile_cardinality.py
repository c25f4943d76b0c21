"""PT014 unbounded-compile-cardinality.

A compiled torch boundary builds one program per distinct operand
SHAPE: ``torch.compile`` with static shapes recompiles (and, past its
cache limit, falls back to eager), ``torch.jit.trace`` bakes the
traced shapes in, and a CUDA graph (``torch.cuda.graph`` capture,
``torch.cuda.make_graphed_callables``) replays only the shapes it was
captured at. A launch whose batch axis is the raw input length
therefore pays a fresh compile or capture for every distinct size that
ever arrives — the bug class of the per-distinct-size Keccak compiles
(unbucketed trie level sizes) and of a benchmark regression that a
conditionally bucketed batch axis caused. The fix discipline is a
handful of sanctioned bounded-shape helpers (``pow2_at_least``,
``launch_lanes``, ``Mesh.padded_size``, ``pad_messages``): every shape
that reaches a compiled callable must route through one, so the
compile cache is bounded by O(log sizes) buckets.

The port's kernels are built once per process by ``nvcc``
(``ops/cuda_lib.py``) and launched through ctypes with the shape as an
argument: such a launch compiles nothing per shape and is not a
boundary. So ``padded_size(B) if sharded else B`` before a ctypes
launch (the BLS seams) is no finding here.

Encoding, per launch site (a call resolving to a ``@torch.compile``
function, a ``torch.compile(...)`` / ``torch.jit.trace(...)`` /
``make_graphed_callables(...)`` assignment, a call inside a
``with torch.cuda.graph(...)`` capture, or the ``_build_*(...)(...)``
cached-builder idiom):

* operands CONDITIONALLY bucketed — ``padded_size(B) if sharded else
  B`` and every value derived from it — always flag: one branch pays
  per-distinct-shape compiles while the other hides it;
* otherwise the site needs bucket EVIDENCE: a bucket helper in the
  operand expressions themselves, anywhere in the enclosing function,
  or in a direct callee (one level — a distant pow2 call must not
  excuse a raw local launch);
* all-constant operands are exempt (warm-up calls with literal
  bucket shapes), as are launches inside compiled functions (traced
  inline: the outer boundary owns the shape) and ``ops/mesh.py``
  (the bucketing layer itself).
"""
from __future__ import annotations

from typing import List

from plenum_tpu_torch.analysis.core import Finding, ProgramRule

MESH_PATH = "plenum_tpu_torch/ops/mesh.py"


class CompileCardinalityRule(ProgramRule):
    code = "PT014"
    name = "unbounded-compile-cardinality"

    @staticmethod
    def _ancestor_buckets(graph, sym: str) -> bool:
        """Nested defs (merkle's `launch` closures) share the
        enclosing function's scope — its bucket calls are evidence."""
        mod, q = sym.split(":", 1)
        while "." in q:
            q = q.rsplit(".", 1)[0]
            anc = graph.functions.get("%s:%s" % (mod, q))
            if anc and anc["buckets"]:
                return True
        return False

    @staticmethod
    def _class_buckets(graph, sym: str, fn: dict) -> bool:
        cls = fn.get("cls")
        if not cls:
            return False
        mod = sym.split(":", 1)[0]
        prefix = "%s:%s." % (mod, cls)
        return any(other["buckets"]
                   for osym, other in graph.functions.items()
                   if osym.startswith(prefix))

    def applies(self, rel_path: str) -> bool:
        return (rel_path.startswith("plenum_tpu_torch/")
                and rel_path != MESH_PATH)

    def check_program(self, engine, rel_paths) -> List[Finding]:
        out: List[Finding] = []
        graph = engine.graph
        for sym in sorted(graph.functions):
            fn = graph.functions[sym]
            if fn.get("jitted"):
                continue
            path = graph.fn_path[sym]
            if path == MESH_PATH:
                continue
            summary = engine.summaries.get(sym)
            resolved = {id(call): callee
                        for callee, call in graph.edges[sym]}
            for call in fn["calls"]:
                callee = resolved.get(id(call))
                csum = engine.summaries.get(callee) \
                    if callee is not None else None
                launcher = call.get("builder") or call.get("captured") \
                    or (csum is not None
                        and csum.launches_param_shapes) \
                    or graph.is_jit_callee(sym, call["chain"])
                if not launcher:
                    continue
                name = call["chain"][-1]
                if call.get("arg_cond_bucketed"):
                    out.append(Finding(
                        rule=self.code, severity=self.severity,
                        path=path, line=call["line"],
                        col=call["col"],
                        message=(
                            "compiled launch %s() with CONDITIONALLY "
                            "bucketed operand shapes (bucketed on one "
                            "branch, raw on another) — the unbucketed "
                            "branch pays one compile per distinct size "
                            "(the conditional-bucketing shape); route "
                            "every branch through pow2_at_least/"
                            "launch_lanes/padded_size" % name),
                        symbol=fn["qname"]))
                    continue
                if call.get("args_all_const") \
                        or call.get("arg_static"):
                    # literal or module-constant operands: fixed
                    # shapes per process, no cardinality to bound
                    continue
                if call.get("arg_param_only"):
                    # pass-through seam: every operand came in through
                    # the function's own parameters — the summary
                    # lifts the obligation to this function's callers
                    # (launches_param_shapes), so no local finding
                    continue
                if call.get("arg_bucketed") or fn["buckets"] \
                        or (summary and summary.routes_bucket) \
                        or self._ancestor_buckets(graph, sym):
                    continue
                if call.get("arg_self_rooted") \
                        and self._class_buckets(graph, sym, fn):
                    # operands live on the object; the owning class
                    # shaped its arrays (pow2 capacities at build /
                    # growth), which any of its methods evidences
                    continue
                out.append(Finding(
                    rule=self.code, severity=self.severity,
                    path=path, line=call["line"], col=call["col"],
                    message=(
                        "compiled launch %s() with no bucket-routing "
                        "evidence — operand shapes that don't route "
                        "through pow2_at_least/launch_lanes/"
                        "padded_size pay one compile per distinct "
                        "batch size (the per-distinct-size Keccak "
                        "incident)" % name),
                    symbol=fn["qname"]))
        return out
