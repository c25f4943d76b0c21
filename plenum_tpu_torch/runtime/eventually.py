"""Async polling-with-timeout, used pervasively by integration tests.

Reference: stp_core/loop/eventually.py:124 (eventually), :50 (eventuallyAll).
"""
import asyncio
import inspect
import time
from typing import Callable


async def eventually(coro_func: Callable, *args,
                     retry_wait: float = 0.1,
                     timeout: float = 5.0,
                     acceptable_fails: int = None) -> object:
    """Poll `coro_func(*args)` until it stops raising, up to `timeout` sec.
    If `acceptable_fails` is given, raise after that many failed attempts
    even when time remains."""
    assert timeout > 0
    start = time.perf_counter()
    fails = 0
    while True:
        try:
            res = coro_func(*args)
            if inspect.isawaitable(res):
                res = await res
            return res
        except Exception:
            fails += 1
            remaining = timeout - (time.perf_counter() - start)
            if remaining <= 0:
                raise
            if acceptable_fails is not None and fails > acceptable_fails:
                raise
            await asyncio.sleep(min(retry_wait, remaining))


async def eventuallyAll(*coro_funcs, total_timeout: float = 10.0,
                        retry_wait: float = 0.1):
    """Each check gets whatever remains of the shared budget (reference
    eventually.py:50) — one slow check may use most of it."""
    deadline = time.perf_counter() + total_timeout
    results = []
    for f in coro_funcs:
        remaining = max(0.001, deadline - time.perf_counter())
        results.append(await eventually(f, retry_wait=retry_wait,
                                        timeout=remaining))
    return results
