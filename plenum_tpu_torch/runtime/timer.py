"""Timer service: abstract clock + ordered callback queue.

Reference: plenum/common/timer.py:13 (TimerService), :27 (QueueTimer),
:60 (RepeatingTimer). This is the *only* clock consensus services see, so a
MockTimer (plenum_tpu_torch/testing/mock_timer.py) makes the whole consensus layer
deterministically testable with no real time or sockets (SURVEY.md §4 rung 2).
"""
import heapq
import time
from abc import ABC, abstractmethod
from typing import Callable


class TimerService(ABC):
    @abstractmethod
    def get_current_time(self) -> float:
        ...

    @abstractmethod
    def schedule(self, delay: float, callback: Callable) -> None:
        ...

    @abstractmethod
    def cancel(self, callback: Callable) -> None:
        """Cancel all scheduled occurrences of callback."""


class QueueTimer(TimerService):
    """Production timer: events fire from `service()` which the owning loop
    calls every prod tick (reference plenum/common/timer.py:27).

    Heap entries are ``[timestamp, seq, callback]``: the seq breaks ties so
    equal-timestamp events fire FIFO and callbacks are never compared.
    cancel() tombstones entries in place (callback → None); peeks/pops skip
    tombstones lazily, keeping every operation O(log n) on the timer-driven
    hot loop (this is the single clock under all consensus services)."""

    def __init__(self, get_current_time: Callable[[], float] = time.perf_counter):
        self._get_current_time = get_current_time
        self._heap = []
        self._seq = 0
        self._live = 0

    def queue_size(self) -> int:
        return self._live

    def get_current_time(self) -> float:
        return self._get_current_time()

    def schedule(self, delay: float, callback: Callable) -> None:
        self._seq += 1
        heapq.heappush(self._heap,
                       [self.get_current_time() + delay, self._seq, callback])
        self._live += 1

    def cancel(self, callback: Callable) -> None:
        for entry in self._heap:
            if entry[2] == callback:
                entry[2] = None
                self._live -= 1
        # schedule/cancel churn (watchdogs rescheduled per message) can
        # leave long-delay tombstones resident for their full horizon;
        # compact when they outnumber live entries so cancel() scans and
        # heap pushes stay proportional to real load
        if len(self._heap) > 2 * self._live + 8:
            self._heap = [e for e in self._heap if e[2] is not None]
            heapq.heapify(self._heap)

    def _peek(self):
        """Next live entry ([timestamp, seq, callback]) or None."""
        heap = self._heap
        while heap and heap[0][2] is None:
            heapq.heappop(heap)
        return heap[0] if heap else None

    def _pop(self):
        """Remove and return the next live entry, or None."""
        entry = self._peek()
        if entry is not None:
            heapq.heappop(self._heap)
            self._live -= 1
        return entry

    def service(self) -> int:
        """Fire all due events; returns count fired."""
        count = 0
        now = self.get_current_time()
        while True:
            entry = self._peek()
            if entry is None or entry[0] > now:
                break
            heapq.heappop(self._heap)
            self._live -= 1
            entry[2]()
            count += 1
        return count

    def next_wakeup_in(self):
        entry = self._peek()
        if entry is None:
            return None
        return max(0.0, entry[0] - self.get_current_time())


class RepeatingTimer:
    """Re-schedules callback every `interval` until stopped (reference
    plenum/common/timer.py:60)."""

    def __init__(self, timer: TimerService, interval: float,
                 callback: Callable, active: bool = True):
        assert interval > 0
        self._timer = timer
        self._interval = interval
        self._callback = callback
        self._active = False
        # Distinct bound wrapper so cancel() of one RepeatingTimer never
        # cancels another timer using the same raw callback.
        def _wrapped():
            if self._active:
                self._callback()
                # the callback may have called stop(); don't reschedule then
                if self._active:
                    self._timer.schedule(self._interval, _wrapped)
        self._wrapped = _wrapped
        if active:
            self.start()

    def start(self) -> None:
        if not self._active:
            self._active = True
            self._timer.schedule(self._interval, self._wrapped)

    def stop(self) -> None:
        if self._active:
            self._active = False
            self._timer.cancel(self._wrapped)

    def update_interval(self, interval: float) -> None:
        assert interval > 0
        self._interval = interval
