"""PT012 nondeterminism-reachable-from-consensus-path.

RBFT safety rests on every honest replica computing byte-identical
state from the same ordered input (PAPER.md §1). The bug class: a
nondeterminism source — something whose value differs across replica
*processes* fed the same messages — sitting anywhere in the transitive
call closure of a consensus-critical decision. The canonical incident
is the catchup jitter: retry delays derived from
``hash(...)`` — and CPython salts str/bytes hashes per process via
PYTHONHASHSEED — were replaced by a ``zlib.crc32`` salt precisely so
seeded simulations still replay and honest nodes stay analyzable; the
crc32 shape is this rule's good fixture.

Sources (extracted per function by engine/symtab.py):

* ``hash()`` of a provably str/bytes value — per-process salted;
* unseeded module-level ``random.*`` (seeded ``Random`` instances
  resolve to a different receiver and stay out);
* ``time.time()``/``monotonic()``/``perf_counter()`` whose VALUE is
  returned to the caller (timer deltas that never escape are fine);
* ``id()`` — CPython address, different every process;
* iteration over a set (hash order; dict iteration is
  insertion-ordered and stays out) not wrapped in ``sorted()``.

Roots: lane planning (``server/execution_lanes.py``), flat-wire pack
(``common/serializers/flat_wire.py`` encode half), view-change
computation, primary selection, and the digest/ordering decisions in
``consensus/ordering_service.py``. A source is reported at ITS OWN
site (stable baseline coordinates) whenever any root reaches it
through the call graph — use ``scripts/plenum_lint --callgraph
<symbol>`` to walk the path.
"""
from __future__ import annotations

import re
from typing import List

from plenum_tpu_torch.analysis.core import Finding, ProgramRule

DEFAULT_ROOTS = (
    ("plenum_tpu_torch/server/execution_lanes.py", r".*"),
    ("plenum_tpu_torch/common/serializers/flat_wire.py",
     r"^(encode_|build_envelope|_ragged_table)"),
    ("plenum_tpu_torch/consensus/view_change_service.py", r".*"),
    ("plenum_tpu_torch/consensus/primary_selector.py", r".*"),
    ("plenum_tpu_torch/consensus/ordering_service.py",
     r"(digest|_order$|_send_batch_of)"),
    # the gateway's lane pre-planning must agree with the node-side
    # planner on the identical admitted stream — same determinism bar
    ("plenum_tpu_torch/gateway/lane_router.py", r".*"),
)

_MESSAGES = {
    "hash-salted": (
        "hash() of a str/bytes value reachable from a consensus-"
        "critical path — PYTHONHASHSEED salts str hashes per process, "
        "so replicas diverge on the same ordered input; use zlib.crc32 "
        "or hashlib (the catchup-jitter fix)"),
    "random": (
        "unseeded random.* call reachable from a consensus-critical "
        "path — module-level entropy differs per replica; derive "
        "pseudo-randomness deterministically from ordered input (the "
        "crc32-salted jitter pattern) or use a seeded Random"),
    "time-value": (
        "wall-clock value escapes into a consensus-critical path — "
        "time.* returned as a VALUE (not a timer delta) differs per "
        "replica; clock readings may only enter consensus as signed "
        "proposer input, never computed independently per node"),
    "id": (
        "id() reachable from a consensus-critical path — CPython "
        "object addresses differ per process and per run; key on a "
        "deterministic identity instead"),
    "set-iter": (
        "iteration over a set reachable from a consensus-critical "
        "path — set order follows the per-process str hash salt; "
        "iterate sorted(...) or keep the collection a dict/list "
        "(insertion-ordered)"),
}


class NondeterminismRule(ProgramRule):
    code = "PT012"
    name = "nondeterminism-reachable-from-consensus-path"
    roots = DEFAULT_ROOTS

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check_program(self, engine, rel_paths) -> List[Finding]:
        specs = [(path, re.compile(rx)) for path, rx in self.roots]
        roots = engine.roots_matching(specs)
        out: List[Finding] = []
        seen = set()
        for sym in sorted(engine.reachable(roots)):
            fn = engine.function(sym)
            path = engine.path_of(sym)
            for rec in fn["nondet"]:
                key = (path, rec["line"], rec["col"], rec["kind"])
                if key in seen:
                    continue
                seen.add(key)
                out.append(Finding(
                    rule=self.code, severity=self.severity, path=path,
                    line=rec["line"], col=rec["col"],
                    message="%s (%s)" % (_MESSAGES[rec["kind"]],
                                         rec["detail"]),
                    symbol=fn["qname"]))
        return out
