"""Deterministic primary selection.

Reference: plenum/server/consensus/primary_selector.py:22
(RoundRobinConstantNodesPrimariesSelector), :52
(RoundRobinNodeRegPrimariesSelector). Every node computes the same
primaries for a view from the same inputs — no election protocol needed.
"""
from typing import List


class RoundRobinConstantNodesPrimariesSelector:
    """Primaries from a fixed validator list: master primary rotates with
    the view; backup instance i takes the (view+i)-th node."""

    def __init__(self, validators: List[str]):
        self.validators = list(validators)

    def select_master_primary(self, view_no: int) -> str:
        return self.validators[view_no % len(self.validators)]

    def select_primaries(self, view_no: int, instance_count: int
                         ) -> List[str]:
        n = len(self.validators)
        return [self.validators[(view_no + i) % n]
                for i in range(instance_count)]


class RoundRobinNodeRegPrimariesSelector:
    """Same rotation, but the validator list comes from a node-registry
    provider (pool membership can change at runtime; reference
    primary_selector.py:52 reads it from the audit ledger)."""

    def __init__(self, node_reg_provider):
        """node_reg_provider: callable () -> List[str] (committed node reg)."""
        self._provider = node_reg_provider

    @property
    def validators(self) -> List[str]:
        return list(self._provider())

    def select_master_primary(self, view_no: int) -> str:
        validators = self.validators
        return validators[view_no % len(validators)]

    def select_primaries(self, view_no: int, instance_count: int
                         ) -> List[str]:
        validators = self.validators
        n = len(validators)
        return [validators[(view_no + i) % n] for i in range(instance_count)]
