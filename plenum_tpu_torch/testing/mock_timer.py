"""Manually advanced clock driving QueueTimer callbacks — the backbone of
deterministic consensus tests (reference: plenum/test/helper.py:1369 MockTimer).
"""
from typing import Callable

from plenum_tpu_torch.runtime.timer import QueueTimer


class MockTimer(QueueTimer):
    def __init__(self, start_time: float = 0.0):
        self._current_time = start_time
        super().__init__(get_current_time=lambda: self._current_time)

    def set_time(self, value: float):
        """Advance to `value`, firing every due event in timestamp order.
        Events scheduled while firing are honored if they fall before value."""
        while True:
            entry = self._peek()
            if entry is None or entry[0] > value:
                break
            self._pop()
            self._current_time = max(self._current_time, entry[0])
            entry[2]()
        self._current_time = max(self._current_time, value)

    def sleep(self, seconds: float):
        self.set_time(self._current_time + seconds)

    def advance(self):
        """Fire just the next scheduled event (if any)."""
        entry = self._pop()
        if entry is not None:
            self._current_time = max(self._current_time, entry[0])
            entry[2]()

    def advance_until(self, value: float):
        while True:
            entry = self._peek()
            if entry is None or entry[0] > value:
                break
            self.advance()

    def run_for(self, seconds: float):
        self.set_time(self._current_time + seconds)

    def wait_for(self, condition: Callable[[], bool], timeout: float = None,
                 max_iterations: int = 10000):
        """Advance through scheduled events until condition() holds.
        Raises TimeoutError if events run out or timeout exceeded."""
        deadline = (self._current_time + timeout) if timeout is not None else None
        for _ in range(max_iterations):
            if condition():
                return
            entry = self._peek()
            if entry is None:
                raise TimeoutError(
                    "Condition not reached and no more timer events at t={}"
                    .format(self._current_time))
            if deadline is not None and entry[0] > deadline:
                raise TimeoutError(
                    "Condition not reached before t={}".format(deadline))
            self.advance()
        raise TimeoutError("Condition not reached in {} timer events"
                           .format(max_iterations))
