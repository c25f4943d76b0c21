"""PT010 per-message-serializer-call-in-hot-wire-path.

Historical bug class: the wire layers under ``network/`` and
``server/`` invoking a serializer once PER ITEM inside a send/receive
handler's loop. The incident is the THREE_PC_BATCH receive path:
every inner vote of every envelope went through
``node_message_factory.get_instance`` (full schema validation + object
construction) only for the columnar intake to strip the object back
down to digest/view/seq columns — per-message deserialization was the
single largest host-ms population left on the ordering money path
after the counting went columnar. The fix is the
flat zero-copy wire (common/serializers/flat_wire.py): ONE pack and
ONE parse per envelope, columns handed straight to the vectorized
intake, typed objects materialized only for votes that enter a store.

Encoding: inside a HOT wire handler — a function whose name matches
``process_*``/``_process_*``/``flush*``/``_flush*``/``send*``/
``receive*``/``unpack*``/``enqueue*``/``read*`` (send/receive shaped)
in a file under ``plenum_tpu_torch/network/``, ``server/`` or
``gateway/`` —
any serializer invocation (``serialize``/``deserialize``/``packb``/
``unpackb``/``to_dict``/``get_instance``) inside a ``for`` loop or
comprehension that iterates a per-item wire collection (``messages``/
``msgs``/``entries``/``requests``/``reqs``/``out``/``items``/
``chunk``/``rx``/``payloads``/``blobs``) is flagged. One serializer
call per ENVELOPE is the design; one per item is the quadratic wire
shape this rule exists to keep dead. Deliberately per-message paths —
the adversary-tap degrade (fault injection needs per-type wire
granularity) and untrusted client-batch unwrapping (one bad entry
must cost one message) — carry justified baseline entries.
"""
from __future__ import annotations

import ast
import re
from typing import List

from plenum_tpu_torch.analysis.core import Finding, ModuleContext, Rule

HANDLER_NAME = re.compile(
    r"^_?(process|flush|send|receive|unpack|enqueue|read)")
SERIALIZER_CALLS = frozenset({
    "serialize", "deserialize", "packb", "unpackb", "to_dict",
    "get_instance"})
COLLECTION = re.compile(
    r"^(messages|msgs|entries|requests|reqs|out|items|chunk|rx|"
    r"payloads|blobs)$", re.IGNORECASE)

_ITER_METHODS = {"items", "keys", "values", "get"}


def _collection_name(node: ast.AST) -> str:
    """Terminal name of an iterable expression (PT008's resolution):
    ``msg.messages``, ``msg.get("messages", [])``, ``out[i:j]`` all
    resolve to the collection identifier the loop walks."""
    if isinstance(node, ast.Call):
        callee = node.func
        if isinstance(callee, ast.Attribute) \
                and callee.attr in _ITER_METHODS:
            # msg.get("messages", []) walks the literal collection key
            if callee.attr == "get" and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                return node.args[0].value
            return _collection_name(callee.value)
        return ""
    if isinstance(node, ast.Subscript):
        return _collection_name(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _serializer_calls(node: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in SERIALIZER_CALLS:
            out.append(sub)
    return out


class WireSerializerLoopRule(Rule):
    code = "PT010"
    name = "per-message-serializer-call-in-hot-wire-path"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/network/",
                                    "plenum_tpu_torch/server/",
                                    "plenum_tpu_torch/gateway/"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        # one finding per serializer CALL: nested matching loops
        # (`for chunk in out: for m in chunk: ser.serialize(m)`) walk
        # the same call once per enclosing loop — dedupe by location
        # so one defect never needs two baseline entries
        seen: set = set()
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not HANDLER_NAME.match(func.name):
                continue
            for node in ast.walk(func):
                if isinstance(node, ast.For):
                    iters = [node.iter]
                    bodies = node.body
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    iters = [g.iter for g in node.generators]
                    bodies = [node]
                else:
                    continue
                coll = ""
                for it in iters:
                    name = _collection_name(it)
                    if name and COLLECTION.match(name):
                        coll = name
                        break
                if not coll:
                    continue
                for body in bodies:
                    for call in _serializer_calls(body):
                        loc = (call.lineno, call.col_offset)
                        if loc in seen:
                            continue
                        seen.add(loc)
                        out.append(ctx.finding(
                            self, call,
                            "serializer call '%s' inside a per-item "
                            "loop over '%s' in wire handler %s — one "
                            "pack/parse per ITEM is the per-message "
                            "wire shape; pack and parse whole "
                            "envelopes (flat_wire) and hand columns "
                            "to the batch intake, or hoist the "
                            "serializer call out of the loop"
                            % (call.func.attr, coll, func.name)))
        return out
