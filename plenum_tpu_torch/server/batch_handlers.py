"""Batch handlers — per-ledger batch lifecycle, chained per ledger.

Reference: plenum/server/batch_handlers/ — `BatchRequestHandler` ABC with
post_batch_applied / commit_batch / post_batch_rejected, and the concrete
chain: AuditBatchHandler (audit_batch_handler.py:20, _create_audit_txn_data
:83 — the recovery backbone: one audit txn per ordered batch recording all
ledger/state roots, view_no, primaries, node_reg), Domain/Pool/Config
handlers (ledger+state staging), TsStoreBatchHandler (timestamp → state
root index), PrimaryBatchHandler / NodeRegHandler (node registry
snapshots inside the audit data).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, AUDIT_TXN, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID,
    POOL_LEDGER_ID)
from plenum_tpu_torch.common.txn_util import get_payload_data, init_empty_txn
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.three_pc_batch import ThreePcBatch

# audit txn payload fields (reference plenum/common/constants.py AUDIT_TXN_*)
AUDIT_TXN_VIEW_NO = "viewNo"
AUDIT_TXN_PP_SEQ_NO = "ppSeqNo"
AUDIT_TXN_LEDGERS_SIZE = "ledgerSize"
AUDIT_TXN_LEDGER_ROOT = "ledgerRoot"
AUDIT_TXN_STATE_ROOT = "stateRoot"
AUDIT_TXN_PRIMARIES = "primaries"
AUDIT_TXN_NODE_REG = "nodeReg"
AUDIT_TXN_DIGEST = "digest"


class BatchRequestHandler(ABC):
    def __init__(self, database_manager: DatabaseManager, ledger_id: int):
        self.database_manager = database_manager
        self.ledger_id = ledger_id

    @property
    def ledger(self):
        return self.database_manager.get_ledger(self.ledger_id)

    @property
    def state(self):
        return self.database_manager.get_state(self.ledger_id)

    @abstractmethod
    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None): ...

    @abstractmethod
    def post_batch_rejected(self, ledger_id: int, prev_result=None): ...

    @abstractmethod
    def commit_batch(self, batch: ThreePcBatch, prev_result=None): ...


class LedgerBatchHandler(BatchRequestHandler):
    """Generic ledger+state staging for a writable ledger (the common
    behavior of Domain/Pool/ConfigBatchHandler in the reference)."""

    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None):
        # txns were staged by WriteRequestManager.apply_request; nothing
        # further until commit
        return None

    def post_batch_rejected(self, ledger_id: int, prev_result=None):
        # reverts are driven centrally by WriteRequestManager, which
        # knows each staged batch's ledger and size
        return None

    def commit_batch(self, batch: ThreePcBatch, prev_result=None):
        count = len(batch.valid_digests)
        _, committed = self.ledger.commitTxns(count)
        if self.state is not None:
            from plenum_tpu_torch.utils.metrics import MetricsName
            root = (self.ledger.strToHash(batch.state_root)
                    if batch.state_root else None)
            with self.database_manager.metrics.measure_time(
                    MetricsName.STATE_COMMIT_TIME):
                self.state.commit(rootHash=root)
        return committed


class DomainBatchHandler(LedgerBatchHandler):
    def __init__(self, dm):
        super().__init__(dm, DOMAIN_LEDGER_ID)


class PoolBatchHandler(LedgerBatchHandler):
    def __init__(self, dm):
        super().__init__(dm, POOL_LEDGER_ID)


class ConfigBatchHandler(LedgerBatchHandler):
    def __init__(self, dm):
        super().__init__(dm, CONFIG_LEDGER_ID)


class TsStoreBatchHandler(BatchRequestHandler):
    """Records (pp_time → committed state root) per batch so reads can
    resolve state-at-a-timestamp (reference
    plenum/server/batch_handlers/ts_store_batch_handler.py). Registered
    on the AUDIT chain, which runs for every ordered batch regardless of
    its target ledger."""

    def __init__(self, dm):
        super().__init__(dm, AUDIT_LEDGER_ID)

    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None):
        return None

    def post_batch_rejected(self, ledger_id: int, prev_result=None):
        return None

    def commit_batch(self, batch: ThreePcBatch, prev_result=None):
        store = self.database_manager.get_store("state_ts")
        state = self.database_manager.get_state(batch.ledger_id)
        if store is None or state is None:
            return None
        store.set(batch.pp_time, state.committedHeadHash, batch.ledger_id)
        return None


class AuditBatchHandler(BatchRequestHandler):
    """One audit txn per ordered batch — the recovery backbone
    (reference audit_batch_handler.py:20, docs/source/audit_ledger.md)."""

    def __init__(self, dm: DatabaseManager):
        super().__init__(dm, AUDIT_LEDGER_ID)

    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None):
        txn = self._create_audit_txn(batch)
        self.ledger.append_txns_metadata([txn], batch.pp_time)
        self.ledger.appendTxns([txn])
        return txn

    def post_batch_rejected(self, ledger_id: int, prev_result=None):
        # reverts are driven centrally by WriteRequestManager
        return None

    def commit_batch(self, batch: ThreePcBatch, prev_result=None):
        _, committed = self.ledger.commitTxns(1)
        return committed[0] if committed else None

    def _create_audit_txn(self, batch: ThreePcBatch) -> dict:
        """reference audit_batch_handler.py:83 _create_audit_txn_data.

        Every field must depend only on batch-original data (original
        view, primaries of the ORIGINAL view, pp digest, roots) so that
        re-applying the same old-view PrePrepare after a view change
        yields a bit-identical audit txn — the re-apply root comparison
        in the ordering service depends on it."""
        txn = init_empty_txn(AUDIT_TXN)
        data = get_payload_data(txn)
        data[AUDIT_TXN_VIEW_NO] = batch.original_view_no
        data[AUDIT_TXN_PP_SEQ_NO] = batch.pp_seq_no
        data[AUDIT_TXN_DIGEST] = batch.pp_digest
        sizes, ledger_roots, state_roots = {}, {}, {}
        for lid in sorted(self.database_manager.ledger_ids):
            if lid == AUDIT_LEDGER_ID:
                continue
            ledger = self.database_manager.get_ledger(lid)
            state = self.database_manager.get_state(lid)
            sizes[str(lid)] = ledger.uncommitted_size
            ledger_roots[str(lid)] = ledger.hashToStr(
                ledger.uncommitted_root_hash)
            if state is not None:
                state_roots[str(lid)] = ledger.hashToStr(state.headHash)
        data[AUDIT_TXN_LEDGERS_SIZE] = sizes
        data[AUDIT_TXN_LEDGER_ROOT] = ledger_roots
        data[AUDIT_TXN_STATE_ROOT] = state_roots
        data[AUDIT_TXN_PRIMARIES] = self._fill_primaries(batch)
        if batch.node_reg is not None:
            data[AUDIT_TXN_NODE_REG] = batch.node_reg
        return txn

    def _fill_primaries(self, batch: ThreePcBatch):
        """Delta-encode primaries (reference _fill_primaries): store the
        list only when it changed; otherwise an int = how many audit txns
        back the last stored list is. Keeps every steady-state audit txn
        identical in shape AND lets recovery resolve primaries at any
        seq_no."""
        last_seq = self.ledger.uncommitted_size
        last_txn = self.ledger.get_by_seq_no_uncommitted(last_seq) \
            if last_seq else None
        if last_txn is None:
            return batch.primaries
        last_value = get_payload_data(last_txn).get(AUDIT_TXN_PRIMARIES)
        if isinstance(last_value, int):
            anchor_seq = last_seq - last_value
            anchor = self.ledger.get_by_seq_no_uncommitted(anchor_seq)
            anchor_primaries = get_payload_data(anchor).get(
                AUDIT_TXN_PRIMARIES) if anchor else None
            if anchor_primaries == batch.primaries:
                return last_value + 1
            return batch.primaries
        if last_value == batch.primaries:
            return 1
        return batch.primaries

    def primaries_at(self, seq_no: int):
        """Resolve the primaries list effective at audit seq_no (follows
        the delta chain) — recovery/catchup helper."""
        txn = self.ledger.get_by_seq_no_uncommitted(seq_no)
        if txn is None:
            return None
        value = get_payload_data(txn).get(AUDIT_TXN_PRIMARIES)
        if isinstance(value, int):
            anchor = self.ledger.get_by_seq_no_uncommitted(seq_no - value)
            return get_payload_data(anchor).get(AUDIT_TXN_PRIMARIES) \
                if anchor else None
        return value

    def audit_root_for_pre_prepare(self) -> str:
        return self.ledger.hashToStr(self.ledger.uncommitted_root_hash)
