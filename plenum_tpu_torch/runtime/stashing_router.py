"""StashingRouter: route messages through handlers that return verdicts;
stash-and-replay on state change.

Reference: plenum/common/stashing_router.py:93 (StashingRouter),
:43 (UnsortedStash), :69 (SortedStash). A handler returns
(PROCESS|DISCARD|STASH, reason); stashed messages are replayed when the
owner signals the relevant state change via process_all_stashed/
process_stashed_until_first_restash.
"""
import logging
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple, Type

from plenum_tpu_torch.utils.sorted_fallback import SortedList

logger = logging.getLogger(__name__)

PROCESS = 0
DISCARD = 1
STASH = 2

# Verdict helper: handlers return None (== PROCESS) or (code, reason)
Verdict = Optional[Tuple[int, Any]]


class UnsortedStash:
    def __init__(self, limit: int):
        self._limit = limit
        self._data = deque()

    def push(self, item) -> bool:
        if len(self._data) >= self._limit:
            return False
        self._data.append(item)
        return True

    def pop(self):
        return self._data.popleft() if self._data else None

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data)


class SortedStash:
    def __init__(self, limit: int, key: Callable):
        self._limit = limit
        self._key = key
        self._data = SortedList(key=lambda item: key(*item))

    def push(self, item) -> bool:
        if len(self._data) >= self._limit:
            return False
        self._data.add(item)
        return True

    def pop(self):
        return self._data.pop(0) if self._data else None

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data)


class StashingRouter:
    def __init__(self, limit: int, buses, unstash_handler: Callable = None,
                 sort_key: Callable = None):
        """buses: iterable of Router-like objects (InternalBus/ExternalBus) to
        subscribe on. sort_key(msg, *extra) orders replay within a stash."""
        self._limit = limit
        self._buses = list(buses)
        self._unstash_handler = unstash_handler
        self._sort_key = sort_key
        self._handlers: Dict[Type, Callable] = {}
        self._stashes: Dict[Tuple[Type, int], Any] = {}
        self._unsubscribers = []

    def subscribe(self, message_type: Type, handler: Callable):
        self._handlers[message_type] = handler
        for bus in self._buses:
            self._unsubscribers.append(
                bus.subscribe(message_type, self._create_bus_handler(handler)))

    def unsubscribe_all(self):
        """Detach every bus subscription (backup replica removal)."""
        for unsub in self._unsubscribers:
            try:
                unsub()
            except ValueError:
                pass
        self._unsubscribers = []

    def _create_bus_handler(self, handler):
        def bus_handler(message, *args):
            return self._process(handler, message, *args)
        return bus_handler

    def _process(self, handler, message, *args) -> bool:
        verdict = handler(message, *args)
        if verdict is None:
            return True
        code, reason = verdict
        if code == PROCESS:
            return True
        if code == DISCARD:
            self.discard(message, reason)
            return True
        self._stash(code, handler, message, *args)
        return False

    def _stash(self, code, handler, message, *args):
        key = (type(message), code)
        stash = self._stashes.get(key)
        if stash is None:
            if self._sort_key is not None:
                stash = SortedStash(self._limit, self._sort_key)
            else:
                stash = UnsortedStash(self._limit)
            self._stashes[key] = stash
        if not stash.push((message, *args)):
            logger.warning("Cannot stash %s with code %s: stash is full "
                           "(limit %s) — dropping", type(message).__name__,
                           code, self._limit)
            self.discard(message, "stash overflow")

    def discard(self, message, reason):
        pass  # subclass/metric hook

    # ------------------------------------------------- batch-intake seams

    def stash(self, code: int, message, *args):
        """Stash one message directly under `code` WITHOUT running its
        handler first — the columnar 3PC intake decides whole-batch
        verdicts up front and routes the must-wait items here; replay
        goes through the normal subscribed per-message handler."""
        handler = self._handlers.get(type(message))
        self._stash(code, handler, message, *args)

    def route(self, message, *args) -> bool:
        """Run the subscribed handler for `message` with full verdict
        processing (stash/discard), exactly as a bus delivery would —
        used by batch intake paths to feed individual messages through
        the same machinery as singles. → True if processed/discarded."""
        handler = self._handlers.get(type(message))
        if handler is None:
            return True
        return self._process(handler, message, *args)

    def stash_size(self, code: int = None) -> int:
        return sum(len(s) for (t, c), s in self._stashes.items()
                   if code is None or c == code)

    def process_all_stashed(self, code: int = None):
        """Replay all stashed messages (for given stash code); messages that
        stash again go back (possibly under a different code)."""
        for (t, c), stash in list(self._stashes.items()):
            if code is not None and c != code:
                continue
            items = []
            while len(stash):
                items.append(stash.pop())
            for item in items:
                self._resolve_and_process(item)

    def process_stashed_until_first_restash(self, code: int = None):
        for (t, c), stash in list(self._stashes.items()):
            if code is not None and c != code:
                continue
            while len(stash):
                item = stash.pop()
                if not self._resolve_and_process(item):
                    break

    def _resolve_and_process(self, item) -> bool:
        message, *args = item
        # an unstash_handler REPLACES processing — it re-routes the message
        # into the owner's inbox for handling on the next tick (reference
        # stashing_router.py:193-197); the two paths are mutually exclusive
        if self._unstash_handler is not None:
            self._unstash_handler(message, *args)
            return True
        handler = self._handlers.get(type(message))
        if handler is None:
            return True
        return self._process(handler, message, *args)
