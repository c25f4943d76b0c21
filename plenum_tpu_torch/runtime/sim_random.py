"""Seeded deterministic randomness for simulation tests.

Reference: plenum/test/simulation/sim_random.py:34 (DefaultSimRandom).
Lives in the runtime package (not tests) because randomized simulation is a
first-class determinism tool (SURVEY.md §5.2).
"""
import random
from abc import ABC, abstractmethod
from typing import Any, Iterable, List


class SimRandom(ABC):
    @abstractmethod
    def integer(self, min_value: int, max_value: int) -> int:
        ...

    @abstractmethod
    def float(self, min_value: float, max_value: float) -> float:
        ...

    @abstractmethod
    def string(self, min_len: int, max_len: int = None) -> str:
        ...

    @abstractmethod
    def choice(self, *args) -> Any:
        ...

    @abstractmethod
    def sample(self, population: Iterable, k: int) -> List:
        ...

    @abstractmethod
    def shuffle(self, items: List) -> List:
        ...


class DefaultSimRandom(SimRandom):
    def __init__(self, seed: int = 0):
        self._seed = seed
        self._random = random.Random(seed)

    @property
    def seed(self) -> int:
        return self._seed

    def integer(self, min_value: int, max_value: int) -> int:
        return self._random.randint(min_value, max_value)

    def float(self, min_value: float, max_value: float) -> float:
        return self._random.uniform(min_value, max_value)

    def string(self, min_len: int, max_len: int = None) -> str:
        alpha = 'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789'
        length = self.integer(min_len, max_len if max_len is not None else min_len)
        return ''.join(self.choice(*alpha) for _ in range(length))

    def choice(self, *args) -> Any:
        return self._random.choice(args)

    def sample(self, population, k: int) -> List:
        return self._random.sample(list(population), k)

    def shuffle(self, items: List) -> List:
        items = list(items)
        self._random.shuffle(items)
        return items
