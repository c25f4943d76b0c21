"""ThreePcBatch — the unit of consensus execution.

Reference: plenum/server/batch_handlers/three_pc_batch.py.
"""
from typing import List, Optional


class ThreePcBatch:
    def __init__(self, ledger_id: int, inst_id: int, view_no: int,
                 pp_seq_no: int, pp_time: int, state_root: str,
                 txn_root: str, valid_digests: List[str],
                 pp_digest: str,
                 primaries: Optional[List[str]] = None,
                 node_reg: Optional[List[str]] = None,
                 original_view_no: Optional[int] = None,
                 has_audit_txn: bool = True):
        self.ledger_id = ledger_id
        self.inst_id = inst_id
        self.view_no = view_no
        self.pp_seq_no = pp_seq_no
        self.pp_time = pp_time
        self.state_root = state_root
        self.txn_root = txn_root
        self.valid_digests = list(valid_digests)
        self.pp_digest = pp_digest
        self.primaries = primaries or []
        self.node_reg = node_reg
        self.original_view_no = original_view_no \
            if original_view_no is not None else view_no
        self.has_audit_txn = has_audit_txn

    @property
    def three_pc_key(self):
        return (self.view_no, self.pp_seq_no)

    def __repr__(self):
        return "ThreePcBatch(ledger={}, 3pc=({}, {}), reqs={})".format(
            self.ledger_id, self.view_no, self.pp_seq_no,
            len(self.valid_digests))
