"""PT001 blocking-call-in-loop-path.

Historical bug class: the node runs single-threaded cooperative loops
(runtime/looper.py prod ticks, asyncio in the verify daemon and
networked node). One synchronous sleep / subprocess / Future.result()
inside a handler stalls every co-scheduled node in the process — the
view-change fix (`_vc_started_at` stamped off a blocking path) and
the daemon's run-in-executor design exist precisely to keep these out
of the loop.

Scope: ``server/`` and ``consensus/``. Contexts checked: any ``async
def``, plus synchronous handler-shaped functions (process_*/handle_*/
on_*/prod/serve). Sync file I/O (bare ``open``) is only flagged inside
``async def`` — handlers may legitimately touch files via injected
storage seams, but an event-loop coroutine never should.
"""
from __future__ import annotations

import ast
import re
from typing import List

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, dotted, walk_skipping_nested_defs)

HANDLER_NAME = re.compile(r"^_{0,2}(process|handle|on)_")
HANDLER_EXACT = {"prod", "serve"}

BLOCKING_CALLS = {"time.sleep", "os.system", "os.popen", "os.wait",
                  "os.waitpid"}
BLOCKING_ROOTS = {"subprocess"}


class BlockingCallRule(Rule):
    code = "PT001"
    name = "blocking-call-in-loop-path"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/server/",
                                    "plenum_tpu_torch/consensus/",
                                    "plenum_tpu_torch/gateway/"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            is_async = isinstance(node, ast.AsyncFunctionDef)
            if not (is_async or isinstance(node, ast.FunctionDef)):
                continue
            if not is_async and not (HANDLER_NAME.match(node.name)
                                     or node.name in HANDLER_EXACT):
                continue
            ctx_label = ("async def %s" if is_async
                         else "handler %s") % node.name
            for sub in walk_skipping_nested_defs(node):
                if not isinstance(sub, ast.Call):
                    continue
                msg = self._blocking(sub, is_async)
                if msg:
                    out.append(ctx.finding(
                        self, sub,
                        "%s inside %s — the cooperative loop (and every "
                        "co-scheduled node) stalls with it" % (
                            msg, ctx_label)))
        return out

    @staticmethod
    def _blocking(call: ast.Call, is_async: bool):
        name = dotted(call.func)
        if name in BLOCKING_CALLS:
            return "blocking call %s()" % name
        if name and name.split(".", 1)[0] in BLOCKING_ROOTS:
            return "blocking call %s()" % name
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "result":
            return "blocking Future.result() harvest"
        if is_async and name == "open":
            return "synchronous file I/O (open())"
        return None
