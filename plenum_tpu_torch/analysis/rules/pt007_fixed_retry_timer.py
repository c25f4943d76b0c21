"""PT007 fixed-period-retry-timer.

Historical bug class: retry/re-request machinery armed as a
``RepeatingTimer`` with a fixed period. The incident is the
catchup leecher (`server/catchup.py`): a `RepeatingTimer(timer,
CATCHUP_TXN_TIMEOUT, self._retry)` re-assigned chunks to
`sorted(connecteds)` at a constant cadence — a dead or lying peer
received the same chunk forever, every leecher in the pool re-requested
in lockstep, and a congested seeder was hammered at exactly the period
that congested it. The fix is one-shot self-rescheduling with capped
exponential backoff + jitter (see `LedgerLeecher._schedule_retry`).

Encoding: a ``RepeatingTimer(...)`` construction on a RETRY PATH whose
interval argument is a numeric literal is flagged. A retry path is one
where either the enclosing function name or the assignment target the
timer lands in mentions retry/resend/resubmit/rearm/backoff/re-request.
The interval must at minimum route through Config (an operator-tunable
name), and retry logic should prefer backoff-aware one-shot
rescheduling over any fixed period — a literal gives the operator no
knob and the fleet no jitter. Periodic NON-retry work (metrics flushes,
watchdog sweeps) is out of scope: a fixed cadence is correct there.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from plenum_tpu_torch.analysis.core import Finding, ModuleContext, Rule

RETRY_NAME = re.compile(
    r"(retry|retries|resend|re_send|resubmit|re_submit|rearm|re_arm|"
    r"backoff|re_request|rerequest)", re.IGNORECASE)


def _is_numeric_literal(node: ast.AST) -> bool:
    """A literal period: 5, 2.0, -1, or literal-only arithmetic like
    60 * 5 — anything carrying no name the operator could override."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_numeric_literal(node.left) \
            and _is_numeric_literal(node.right)
    return False


class FixedRetryTimerRule(Rule):
    code = "PT007"
    name = "fixed-period-retry-timer"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/server/",
                                    "plenum_tpu_torch/consensus/",
                                    "plenum_tpu_torch/client/"))

    @staticmethod
    def _interval_arg(call: ast.Call) -> Optional[ast.AST]:
        """RepeatingTimer(timer, interval, callback, ...) — second
        positional, or the `interval` keyword."""
        for kw in call.keywords:
            if kw.arg == "interval":
                return kw.value
        if len(call.args) >= 2:
            return call.args[1]
        return None

    @staticmethod
    def _target_name(ctx: ModuleContext, call: ast.Call) -> str:
        """The name the constructed timer is bound to (assignment
        target attribute/variable), '' when unbound."""
        parent = ctx.parent(call)
        if isinstance(parent, ast.Assign):
            names = []
            for tgt in parent.targets:
                if isinstance(tgt, ast.Attribute):
                    names.append(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    names.append(tgt.id)
            return " ".join(names)
        return ""

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            func_is_retry = bool(RETRY_NAME.search(func.name))
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                callee = node.func
                name = callee.attr if isinstance(callee, ast.Attribute) \
                    else callee.id if isinstance(callee, ast.Name) \
                    else ""
                if name != "RepeatingTimer":
                    continue
                interval = self._interval_arg(node)
                if interval is None or not _is_numeric_literal(interval):
                    continue
                target = self._target_name(ctx, node)
                if not (func_is_retry or RETRY_NAME.search(target)):
                    continue
                out.append(ctx.finding(
                    self, node,
                    "RepeatingTimer with a literal period on a retry "
                    "path (%s) — retries need a Config-sourced, "
                    "backoff-aware schedule (capped exponential + "
                    "jitter, see LedgerLeecher._schedule_retry), not a "
                    "fixed cadence that hammers dead peers in lockstep"
                    % (("function %s" % func.name) if func_is_retry
                       else ("target %s" % target))))
        return out
