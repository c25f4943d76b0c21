"""PT003 quorum-before-auth.

Historical bug: the early propagate path (server/propagator.py)
counted quorum votes — and echo-voted — for requests first learned from
a peer's PROPAGATE without authenticating them. One byzantine relay
plus the honest echo then reached the f+1 propagate quorum with a
forged payload (found by the TamperedPropagate adversary scenario).
The fix gates first-sighting payloads on the request authenticator
BEFORE they may enter the vote-collecting state.

Encoding: in ``server/`` and ``consensus/``, any function that receives
a peer sender (a parameter named ``frm`` / ``sender`` — the node-message
handler convention throughout this repo) and mutates propagate-quorum
state (``*.propagates.add(...)``, ``*requests.add(...)``) must
reference an authenticator seam (a name containing ``authenticat``, or
``verify_signature``) on a line at or before the first mutation. Client
-intake paths (no ``frm`` parameter) authenticate at intake and are out
of scope.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, attr_parts, dotted,
    walk_skipping_nested_defs)

SENDER_PARAMS = {"frm", "sender", "frm_name", "from_name"}
AUTH_MARKERS = ("authenticat", "verify_signature")


def _is_vote_mutation(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "add"):
        return False
    receiver = attr_parts(call.func.value)
    return any(p == "propagates" or p.endswith("requests")
               for p in receiver)


def _is_auth_ref(node: ast.AST) -> Optional[str]:
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    if name is None:
        return None
    low = name.lower()
    if any(m in low for m in AUTH_MARKERS):
        return name
    return None


class QuorumBeforeAuthRule(Rule):
    code = "PT003"
    name = "quorum-before-auth"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/server/",
                                    "plenum_tpu_torch/consensus/"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in fn.args.args
                      + fn.args.posonlyargs + fn.args.kwonlyargs}
            if not params & SENDER_PARAMS:
                continue
            first_mutation = None
            first_auth_line = None
            for sub in walk_skipping_nested_defs(fn):
                if isinstance(sub, ast.Call) and _is_vote_mutation(sub):
                    if first_mutation is None \
                            or sub.lineno < first_mutation.lineno:
                        first_mutation = sub
                auth = _is_auth_ref(sub)
                if auth is not None:
                    if first_auth_line is None \
                            or sub.lineno < first_auth_line:
                        first_auth_line = sub.lineno
            if first_mutation is None:
                continue
            if first_auth_line is None \
                    or first_auth_line > first_mutation.lineno:
                out.append(ctx.finding(
                    self, first_mutation,
                    "peer-message handler %s() mutates quorum/vote state "
                    "(%s) without an authenticator check before the "
                    "mutation — a byzantine relay could forge f+1 "
                    "propagate votes (the unauthenticated-propagate hole)" % (
                        fn.name,
                        dotted(first_mutation.func) or "vote state")))
        return out
