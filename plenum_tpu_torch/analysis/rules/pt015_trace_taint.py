"""PT015 trace-context-taint-into-consensus-path.

The wire trace stamp (flat_wire ``KIND_TRACE`` section / the typed
envelopes' ``traceCtx`` field) is ADVISORY by contract
(docs/wire.md): a peer controls every byte of it, a corrupt stamp
decodes to ``None``, and message handling must proceed identically
with or without it. That contract only holds if stamp CONTENT is
provably unreachable from consensus decisions — the moment a digest,
ordering, view-change or lane-planning path reads a parsed stamp, a
byzantine peer steers honest-replica state through an "observability"
field and the PT012 determinism story collapses with it.

This rule pins the boundary from both directions:

* **parse-in-consensus-closure** — a function inside the transitive
  call closure of the PT012 consensus roots (execution lanes,
  flat-wire encode half, view change, primary selection, ordering
  digests, gateway lane router) calls the trace-section parse surface
  (``decode_trace_stamp`` / ``TraceStamp.from_wire``). Stamp content
  would flow straight into a consensus decision.
* **parse-reaches-consensus** — the parse surface's own call closure
  contains a consensus root: stamp handling calling back into
  consensus is the same taint flowing the other way (e.g. a decode
  helper that "helpfully" triggers an ordering step).

The receive seams that legitimately parse stamps (node/propagator
``wire_recv`` recording) live outside both closures — they only feed
the tracer ring buffer, which nothing on a consensus path reads.
"""
from __future__ import annotations

import re
from typing import List

from plenum_tpu_torch.analysis.core import Finding, ProgramRule
from plenum_tpu_torch.analysis.rules.pt012_nondeterminism import DEFAULT_ROOTS

# the trace-section parse surface: the only places wire-controlled
# stamp bytes become Python values
_PARSE_TERMINALS = frozenset({"decode_trace_stamp"})
_PARSE_CLASS = "TraceStamp"
_PARSE_CLASS_METHOD = "from_wire"


def _is_parse_call(chain) -> bool:
    if not chain:
        return False
    terminal = chain[-1]
    if terminal in _PARSE_TERMINALS:
        return True
    return terminal == _PARSE_CLASS_METHOD and _PARSE_CLASS in chain


def _is_parse_symbol(fn) -> bool:
    if fn["name"] in _PARSE_TERMINALS:
        return True
    return (fn["name"] == _PARSE_CLASS_METHOD
            and fn.get("cls") == _PARSE_CLASS)


class TraceContextTaintRule(ProgramRule):
    code = "PT015"
    name = "trace-context-taint-into-consensus-path"
    roots = DEFAULT_ROOTS

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check_program(self, engine, rel_paths) -> List[Finding]:
        specs = [(path, re.compile(rx)) for path, rx in self.roots]
        root_syms = engine.roots_matching(specs)
        closure = engine.reachable(root_syms)
        out: List[Finding] = []

        # direction 1: consensus closure must not PARSE stamps
        for sym in sorted(closure):
            fn = engine.function(sym)
            if fn is None:
                continue
            for call in fn["calls"]:
                if not _is_parse_call(call["chain"]):
                    continue
                out.append(Finding(
                    rule=self.code, severity=self.severity,
                    path=engine.path_of(sym),
                    line=call["line"], col=call["col"],
                    message=(
                        "wire trace-context parse (%s) reachable from a "
                        "consensus root — the stamp is peer-controlled "
                        "advisory data; consensus paths must never read "
                        "it (decode at the observability receive seams "
                        "only)" % ".".join(call["chain"])),
                    symbol=fn["qname"]))

        # direction 2: the parse surface must not REACH consensus
        parse_syms = [sym for sym, fn in engine.graph.functions.items()
                      if _is_parse_symbol(fn)]
        root_set = set(root_syms)
        for sym in sorted(parse_syms):
            reached = engine.reachable([sym]) & root_set
            for root_sym in sorted(reached):
                fn = engine.function(sym)
                out.append(Finding(
                    rule=self.code, severity=self.severity,
                    path=engine.path_of(sym),
                    line=fn["line"], col=fn["col"],
                    message=(
                        "trace-stamp parse surface calls into consensus "
                        "root %s — stamp handling must stay advisory "
                        "(record-and-return), never trigger consensus "
                        "work" % engine.symbol_display(root_sym)),
                    symbol=fn["qname"]))
        return out
