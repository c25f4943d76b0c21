"""Prodable lifecycle + Motor state machine.

Reference: stp_core/loop/looper.py:21 (Prodable), stp_core/loop/motor.py:10
(Motor), stp_core/loop/startable.py (Status).
"""
from abc import ABC, abstractmethod
from enum import IntEnum


class Status(IntEnum):
    stopped = 0
    starting = 1
    started = 2
    started_hungry = 3
    stopping = 4

    @classmethod
    def going(cls):
        return (cls.starting, cls.started, cls.started_hungry)


class Prodable(ABC):
    """Anything the Looper services every tick."""

    @property
    @abstractmethod
    def name(self) -> str:
        ...

    @abstractmethod
    async def prod(self, limit: int = None) -> int:
        """Do up to `limit` units of work; return units done."""

    @abstractmethod
    def start(self, loop) -> None:
        ...

    @abstractmethod
    def stop(self) -> None:
        ...


class Motor(Prodable):
    """Prodable with a Status state machine (reference motor.py:10)."""

    def __init__(self):
        self._status = Status.stopped

    def get_status(self) -> Status:
        return self._status

    def set_status(self, value: Status):
        self._status = value

    status = property(fget=get_status, fset=set_status)

    def isReady(self) -> bool:
        return self.status == Status.started

    def isGoing(self) -> bool:
        return self.status in Status.going()

    def start(self, loop) -> None:
        old = self._status
        self._status = Status.starting
        self.onStarting(old)

    def stop(self, *args, **kwargs):
        if self.status in (Status.stopping, Status.stopped):
            return
        self._status = Status.stopping
        self.onStopping(*args, **kwargs)
        self._status = Status.stopped

    def onStarting(self, old_status: Status):
        pass

    def onStopping(self, *args, **kwargs):
        pass

    async def prod(self, limit: int = None) -> int:
        return 0
