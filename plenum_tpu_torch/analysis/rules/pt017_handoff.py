"""PT017 handoff-discipline.

The pipeline's thread boundary (runtime/pipeline.py) is safe because
of a contract, not a lock: values crossing the SPSC queues are
immutable (bytes, numpy views, frozen job records), and once a payload
is ``put()`` the producer stops touching it. This rule checks the
contract at every handoff site the engine extracted:

* **fresh-mutable payload** — a ``put``/``put_nowait`` whose argument
  is a freshly built mutable container (dict/list/set literal,
  comprehension, or ``dict()``-style constructor call) hands the
  consumer state the producer can still reach. Same shape and message
  as PT004's queue check (its engine-less fallback);
* **mutate-after-put** — the payload name is mutated *after* the
  handoff line while the producer retains the alias (attribute or
  subscript store rooted at the name, or an in-place mutator method
  call: append/update/…). Only queue-ish receivers are held to this
  (``*queue*``, ``_in``/``_out``, inbox/outbox): a KV-store ``put``
  persists a copy, it does not share the object with another thread;
* **consensus capture** — a closure handed to ``Thread(target=...)``,
  ``pool.submit`` or ``run_in_executor`` closes over a consensus-named
  ``self`` attribute (the PT004/PT016 vocabulary). That is a
  consensus-owned object escaping into a worker region — the exact
  bug class the pipeline's "workers parse, prod counts" contract
  forbids. Reading a method off ``self`` to *call* it is not a
  capture; reading prod-owned state is.

Runtime twin: the sanitizer's ``HandoffToken`` enforces release/
acquire at the same queues this rule checks statically.
"""
from __future__ import annotations

from typing import List

from plenum_tpu_torch.analysis.core import Finding, ProgramRule
from plenum_tpu_torch.analysis.rules.pt004_threads import _consensus_attr

# receiver names that mean "this put() crosses a thread boundary" —
# KV-store puts (self._store.put(key, val)) stay out of the
# mutate-after check: they persist a snapshot, not a shared reference
_QUEUEISH_TERMINALS = frozenset({"_in", "_out", "q", "inbox", "outbox"})


def _queueish(recv: str) -> bool:
    low = recv.lower()
    if "queue" in low:
        return True
    return low.rsplit(".", 1)[-1] in _QUEUEISH_TERMINALS


class HandoffDisciplineRule(ProgramRule):
    code = "PT017"
    name = "handoff-discipline"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check_program(self, engine, rel_paths) -> List[Finding]:
        out: List[Finding] = []
        seen = set()

        def report(path, line, col, message, symbol):
            key = (path, line, col, message)
            if key in seen:
                return
            seen.add(key)
            out.append(Finding(
                rule=self.code, severity=self.severity, path=path,
                line=line, col=col, message=message, symbol=symbol))

        for sym in sorted(engine.graph.functions):
            fn = engine.graph.functions[sym]
            path = engine.path_of(sym)
            for h in fn.get("handoffs", ()):
                if h["arg_mutable"]:
                    report(
                        path, h["line"], h["col"],
                        "a freshly built mutable %s crosses a thread "
                        "queue via %s() — queue payloads must be "
                        "immutable (bytes, numpy views, frozen "
                        "records): the consumer would share state the "
                        "producer can still mutate" % (
                            h["mutable_kind"], h["op"]),
                        fn["qname"])
                elif h["mutated_after"] and _queueish(h["recv"]):
                    report(
                        path, h["line"], h["col"],
                        "queue payload %s is mutated after %s() while "
                        "the producer retains the alias — the consumer "
                        "may already be reading it; hand over an "
                        "immutable snapshot (bytes, tuple, frozen "
                        "record) and drop the reference" % (
                            "/".join(h["mutated_after"]), h["op"]),
                        fn["qname"])
            for spawn in fn.get("spawns", ()):
                owned = sorted(a for a in spawn.get("captured_attrs", ())
                               if _consensus_attr(a))
                if owned:
                    report(
                        path, spawn["line"], spawn["col"],
                        "consensus-owned state (self.%s) is captured "
                        "into a thread-spawned closure (%s) — prod-"
                        "owned consensus objects must not escape into "
                        "a worker region; pass immutable inputs and "
                        "hand results back over the queue" % (
                            "/self.".join(owned), spawn["kind"]),
                        fn["qname"])
        return out
