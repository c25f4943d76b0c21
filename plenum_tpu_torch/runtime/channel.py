"""Tx/Rx channel abstraction used by catchup services.

Reference: plenum/common/channel.py:13 (TxChannel), :23 (RxChannel),
:54 (create_direct_channel). Direct channels dispatch synchronously; a
queued service drains on prod (QueuedChannelService reference channel.py:71).
"""
from abc import ABC, abstractmethod
from collections import deque
from typing import Any, Callable, Tuple


class TxChannel(ABC):
    @abstractmethod
    def put_nowait(self, msg: Any) -> None:
        ...


class RxChannel(ABC):
    @abstractmethod
    def set_handler(self, handler: Callable[[Any], None]) -> None:
        ...


class _DirectRouter(RxChannel):
    def __init__(self):
        self._handlers = []

    def set_handler(self, handler):
        self._handlers.append(handler)

    def _dispatch(self, msg):
        for h in self._handlers:
            h(msg)


class _DirectTx(TxChannel):
    def __init__(self, router: _DirectRouter):
        self._router = router

    def put_nowait(self, msg):
        self._router._dispatch(msg)


def create_direct_channel() -> Tuple[TxChannel, RxChannel]:
    router = _DirectRouter()
    return _DirectTx(router), router


class QueuedChannelService:
    """Buffers messages; `service()` drains them into handlers (call from
    the prod loop)."""

    def __init__(self):
        self._router = _DirectRouter()
        self._queue = deque()

    @property
    def tx(self) -> TxChannel:
        svc = self
        class _Tx(TxChannel):
            def put_nowait(self, msg):
                svc._queue.append(msg)
        return _Tx()

    @property
    def rx(self) -> RxChannel:
        return self._router

    def service(self, limit: int = None) -> int:
        count = 0
        while self._queue and (limit is None or count < limit):
            self._router._dispatch(self._queue.popleft())
            count += 1
        return count
