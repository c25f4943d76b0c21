"""Call spying for tests (reference @spyable/SpyLog,
plenum/test/testable.py:110): wrap a bound method so every call is
recorded with args and result, assert "the node ordered K batches" /
"catchup was triggered once" style facts without touching production
code.

Caveat: bus subscriptions capture bound methods at construction, so a
spy attached afterwards does NOT see bus-routed deliveries — observe
those at the wire with sim_network.Tap instead. spy_on works for
methods invoked through attribute lookup (node.service, executor
hooks, storage calls, ...).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple


class SpyCall(NamedTuple):
    args: tuple
    kwargs: dict
    result: Any
    error: Any


class SpyLog(List[SpyCall]):
    def count(self) -> int:
        return len(self)

    def last(self) -> SpyCall:
        return self[-1]

    def results(self) -> list:
        return [c.result for c in self]


def spy_on(obj, method_name: str) -> SpyLog:
    """Replace obj.method with a recording wrapper; returns the log.
    Restore with unspy(obj, method_name)."""
    original = getattr(obj, method_name)
    log = SpyLog()

    def wrapper(*args, **kwargs):
        try:
            result = original(*args, **kwargs)
        except Exception as e:
            log.append(SpyCall(args, kwargs, None, e))
            raise
        log.append(SpyCall(args, kwargs, result, None))
        return result

    wrapper._spy_original = original
    wrapper._spy_log = log
    setattr(obj, method_name, wrapper)
    return log


def unspy(obj, method_name: str) -> None:
    wrapper = getattr(obj, method_name)
    original = getattr(wrapper, "_spy_original", None)
    if original is not None:
        setattr(obj, method_name, original)
