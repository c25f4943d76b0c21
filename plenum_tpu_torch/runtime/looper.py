"""Looper: owns the asyncio loop and repeatedly prods registered Prodables.

Reference: stp_core/loop/looper.py:64 (Looper), :142 (prodAllOnce),
:204 (runOnceNicely), :222 (runForever). The entire node is cooperative
multitasking driven from here — no threads (SURVEY.md §1 execution model).
"""
import asyncio
import logging
import signal
import sys
import time
from typing import List, Optional

from plenum_tpu_torch.runtime.motor import Prodable

logger = logging.getLogger(__name__)


class Looper:
    def __init__(self, prodables: Optional[List[Prodable]] = None,
                 loop: Optional[asyncio.AbstractEventLoop] = None,
                 autoStart: bool = True):
        self.prodables: List[Prodable] = []
        self.loop = loop or self._new_loop()
        self.protected_loop = loop is not None
        self.running = True
        if autoStart:
            for p in (prodables or []):
                self.add(p)
        else:
            for p in (prodables or []):
                if p.name in [q.name for q in self.prodables]:
                    raise RuntimeError(
                        "Prodable {} already added".format(p.name))
                self.prodables.append(p)
        # larger sleep when nothing happened, to not spin the CPU
        # (reference looper.py:200-218)
        self._min_sleep = 0.0
        self._max_sleep = 0.01
        self.runFut = self.loop.create_task(self.runForever()) if autoStart else None
        if not self.protected_loop and sys.platform != 'win32':
            try:
                self.loop.add_signal_handler(signal.SIGTERM, self._handle_sig)
            except (NotImplementedError, RuntimeError):
                pass

    def _new_loop(self):
        try:
            loop = asyncio.get_event_loop()
            if loop.is_closed():
                raise RuntimeError("closed")
            return loop
        except RuntimeError:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            return loop

    def _handle_sig(self):
        self.running = False

    def add(self, prodable: Prodable) -> None:
        if prodable.name in [p.name for p in self.prodables]:
            raise RuntimeError("Prodable {} already added".format(prodable.name))
        self.prodables.append(prodable)
        prodable.start(self.loop)

    def removeProdable(self, prodable: Prodable) -> None:
        if prodable in self.prodables:
            self.prodables.remove(prodable)
            prodable.stop()

    async def prodAllOnce(self) -> int:
        """One scheduling pass over all prodables (reference looper.py:142)."""
        count = 0
        for p in list(self.prodables):
            count += await p.prod()
        return count

    async def runOnceNicely(self) -> int:
        count = await self.prodAllOnce()
        sleep = self._min_sleep if count > 0 else self._max_sleep
        await asyncio.sleep(sleep)
        return count

    async def runFor(self, seconds: float):
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            await self.runOnceNicely()

    async def runForever(self):
        while self.running:
            await self.runOnceNicely()

    def run(self, *coros):
        """Run coroutines to completion while servicing prodables."""
        async def wrapper():
            results = []
            for coro in coros:
                results.append(await coro)
            return results[0] if len(results) == 1 else results
        if coros:
            return self.loop.run_until_complete(wrapper())
        return self.loop.run_until_complete(self.runForever())

    async def shutdown(self):
        self.running = False
        if self.runFut is not None:
            try:
                await self.runFut
            except asyncio.CancelledError:
                pass
        for p in self.prodables:
            p.stop()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.loop.run_until_complete(self.shutdown())
        if not self.protected_loop:
            self.loop.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, exc_type, exc, tb):
        await self.shutdown()
