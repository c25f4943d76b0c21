"""Every quorum formula in one place.

Reference: plenum/server/quorums.py:15 (Quorums), f formula
plenum/common/util.py:220: f = ⌊(n-1)/3⌋.
"""


def faulty(n: int) -> int:
    if n < 1:
        return 0
    return (n - 1) // 3


class Quorum:
    def __init__(self, value: int):
        self.value = value

    def is_reached(self, count: int) -> bool:
        return count >= self.value

    def __repr__(self):
        return "Quorum({})".format(self.value)

    def __eq__(self, other):
        return isinstance(other, Quorum) and self.value == other.value


class Quorums:
    def __init__(self, n: int):
        f = faulty(n)
        self.n = n
        self.f = f
        self.weak = Quorum(f + 1)
        self.strong = Quorum(n - f)
        self.propagate = Quorum(f + 1)
        self.prepare = Quorum(n - f - 1)
        self.commit = Quorum(n - f)
        self.reply = Quorum(f + 1)
        self.view_change = Quorum(n - f)
        self.election = Quorum(n - f)
        self.view_change_ack = Quorum(n - f - 1)
        self.view_change_done = Quorum(n - f)
        self.same_consistency_proof = Quorum(f + 1)
        self.consistency_proof = Quorum(f + 1)
        self.ledger_status = Quorum(n - f - 1)
        self.checkpoint = Quorum(n - f - 1)
        self.timestamp = Quorum(f + 1)
        self.bls_signatures = Quorum(n - f)
        self.observer_data = Quorum(f + 1)
        self.backup_instance_faulty = Quorum(f + 1)

    def __repr__(self):
        return "Quorums(n={}, f={})".format(self.n, self.f)
