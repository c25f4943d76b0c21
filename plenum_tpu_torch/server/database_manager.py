"""DatabaseManager — ledger_id → (ledger, state) registry + named stores.

Reference: plenum/server/database_manager.py:11 (register_new_database :23).
"""
from typing import Dict, Optional

from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.state.pruning_state import State


class Database:
    def __init__(self, ledger: Ledger, state: Optional[State],
                 taa_acceptance_required: bool = True):
        self.ledger = ledger
        self.state = state
        self.taa_acceptance_required = taa_acceptance_required


class DatabaseManager:
    def __init__(self):
        from plenum_tpu_torch.utils.metrics import NullMetricsCollector
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.databases: Dict[int, Database] = {}
        self.stores: Dict[str, object] = {}
        self._init_hooks = []
        # state_root → MultiSignature store, set by the Node when BLS is
        # enabled; read handlers attach it to state proofs (reference
        # plenum/server/database_manager.py:112 bls_store property)
        self.bls_store = None
        # lid → committed state root pinned for read serving while the
        # node recovers (catchup / view change): roots committed txn-by-
        # txn during catchup carry no BLS multi-sig yet, so serving them
        # would strip the proof's multi_signature mid-recovery. The MPT
        # keeps history, so the pinned (pre-recovery, BLS-signed) root
        # stays readable and provable until the node unpins.
        self._pinned_read_roots: Dict[int, bytes] = {}

    def pin_read_roots(self):
        """Pin every state's current committed root: proof-bearing reads
        keep answering from it until unpin_read_roots (graceful read
        degradation during view change / catchup). Already-pinned
        ledgers are left alone — a view change starting MID-catchup
        must not overwrite the pre-recovery signed pin with an unsigned
        intermediate root catchup just committed."""
        for lid, db in self.databases.items():
            if db.state is not None and lid not in self._pinned_read_roots:
                root = db.state.committedHeadHash
                if root is not None:
                    self._pinned_read_roots[lid] = bytes(root)

    def unpin_read_roots(self):
        self._pinned_read_roots.clear()

    def pinned_read_root(self, lid) -> Optional[bytes]:
        return self._pinned_read_roots.get(lid)

    @property
    def reads_degraded(self) -> bool:
        """True while reads serve pinned (pre-recovery) roots."""
        return bool(self._pinned_read_roots)

    def register_new_database(self, lid: int, ledger: Ledger,
                              state: Optional[State] = None,
                              taa_acceptance_required: bool = True):
        if lid in self.databases:
            raise ValueError("ledger {} already registered".format(lid))
        self.databases[lid] = Database(ledger, state,
                                       taa_acceptance_required)

    def get_database(self, lid) -> Optional[Database]:
        return self.databases.get(lid)

    def get_ledger(self, lid) -> Optional[Ledger]:
        db = self.databases.get(lid)
        return db.ledger if db else None

    def get_state(self, lid) -> Optional[State]:
        db = self.databases.get(lid)
        return db.state if db else None

    def register_new_store(self, label: str, store):
        self.stores[label] = store

    def get_store(self, label: str):
        return self.stores.get(label)

    @property
    def ledger_ids(self):
        return list(self.databases.keys())

    def is_taa_acceptance_required(self, lid: int) -> bool:
        db = self.databases.get(lid)
        return db.taa_acceptance_required if db else False
