"""Observer framework: validators push committed batches to
non-validating followers that mirror ledgers/state without running
consensus.

Reference: plenum/server/observer/observable.py:11 (Observable — the
node-side policy fanning ObservedData out to registered observers) and
observer_sync_policy_each_batch.py (ObserverSyncPolicyEachBatch — the
observer side: f+1 identical copies of a batch from distinct validators
before applying, strictly in seq-no order).
"""
from __future__ import annotations

import json
import logging
from typing import Callable, Dict, List, Optional, Tuple

from plenum_tpu_torch.common.messages.fields import (
    AnyMapField, LimitedLengthStringField)
from plenum_tpu_torch.common.messages.message_base import MessageBase
from plenum_tpu_torch.common.messages.message_factory import node_message_factory
from plenum_tpu_torch.common.txn_util import get_seq_no, get_type

logger = logging.getLogger(__name__)


class ObservedData(MessageBase):
    """One committed batch as seen by a validator (reference
    plenum/common/messages/node_messages.py ObservedData; policy type
    EACH_BATCH)."""
    typename = "OBSERVED_DATA"
    schema = (
        ("msg_type", LimitedLengthStringField()),
        ("msg", AnyMapField()),
    )


node_message_factory.set_message_class(ObservedData)

BATCH_COMMITTED = "BatchCommitted"


def make_observed_data(ledger_id: int, txns: List[dict]) -> ObservedData:
    return ObservedData(msg_type=BATCH_COMMITTED,
                        msg={"ledgerId": ledger_id, "txns": txns})


class Observable:
    """Validator side: registry of observers + fan-out on commit.
    Policies beyond EACH_BATCH are future work, as in the reference."""

    def __init__(self):
        self._observers: Dict[str, Callable[[ObservedData], None]] = {}

    def add_observer(self, observer_id: str,
                     send_fn: Callable[[ObservedData], None]):
        self._observers[observer_id] = send_fn

    def remove_observer(self, observer_id: str):
        self._observers.pop(observer_id, None)

    @property
    def observer_ids(self) -> List[str]:
        return list(self._observers)

    def batch_committed(self, ledger_id: int, txns: List[dict]):
        if not self._observers or not txns:
            return
        msg = make_observed_data(ledger_id, [dict(t) for t in txns])
        for observer_id, send in list(self._observers.items()):
            try:
                send(msg)
            except Exception:
                logger.warning("observer %s send failed", observer_id,
                               exc_info=True)


class ObserverSyncPolicyEachBatch:
    """Observer side: apply each batch once f+1 distinct validators sent
    an identical copy, strictly in ledger-seq order."""

    def __init__(self, write_manager, database_manager, quorums):
        self._write_manager = write_manager
        self._db = database_manager
        self._quorums = quorums
        # fingerprint -> set of senders, keyed per (ledger, first seq_no)
        self._votes: Dict[Tuple[int, int], Dict[str, set]] = {}
        self._payloads: Dict[str, dict] = {}

    def apply_data(self, msg: ObservedData, sender: str) -> bool:
        """→ True when the batch was applied by this call."""
        if msg.msg_type != BATCH_COMMITTED:
            return False
        data = msg.msg or {}
        txns = data.get("txns") or []
        ledger_id = data.get("ledgerId")
        if not txns or ledger_id is None:
            return False
        first_seq = get_seq_no(txns[0])
        if first_seq is None:
            return False
        ledger = self._db.get_ledger(ledger_id)
        if ledger is None:
            return False
        if first_seq <= ledger.size:
            return False    # already applied
        fp = json.dumps(data, sort_keys=True, default=str)
        key = (int(ledger_id), int(first_seq))
        votes = self._votes.setdefault(key, {})
        votes.setdefault(fp, set()).add(sender)
        self._payloads[fp] = data
        if not self._quorums.observer_data.is_reached(len(votes[fp])):
            return False
        if first_seq != ledger.size + 1:
            return False    # out of order: wait for the gap to fill
        self._apply(int(ledger_id), txns)
        self._forget(key)
        self._try_apply_next(int(ledger_id))
        return True

    def _forget(self, key: Tuple[int, int]):
        """Drop a decided batch's votes AND every variant payload —
        losing fingerprints (forgeries, equivocations) must not
        accumulate for the observer's lifetime."""
        for fp in self._votes.pop(key, {}):
            self._payloads.pop(fp, None)

    def _apply(self, ledger_id: int, txns: List[dict]):
        ledger = self._db.get_ledger(ledger_id)
        state = self._db.get_state(ledger_id)
        for txn in txns:
            ledger.add(dict(txn))
            handler = self._write_manager.request_handlers.get(
                get_type(txn))
            if handler is not None and handler.ledger_id == ledger_id:
                handler.update_state(txn, None, None, is_committed=True)
        if state is not None:
            state.commit()

    def _try_apply_next(self, ledger_id: int):
        """A gap just filled may unblock queued later batches."""
        ledger = self._db.get_ledger(ledger_id)
        while True:
            key = (ledger_id, ledger.size + 1)
            votes = self._votes.get(key)
            if not votes:
                return
            ready_fp = next(
                (fp for fp, senders in votes.items()
                 if self._quorums.observer_data.is_reached(len(senders))),
                None)
            if ready_fp is None:
                return
            data = self._payloads.get(ready_fp)
            if data is None:
                return
            self._apply(ledger_id, data["txns"])
            self._forget(key)


class NodeObserver:
    """A standalone follower: its own storage + handlers, fed
    ObservedData from validators (the reference runs this inside a node
    in observer mode; the aggregate here is independently usable)."""

    def __init__(self, n_validators: int, storage_factory=None,
                 config=None, genesis_txns: Optional[List[dict]] = None):
        from plenum_tpu_torch.consensus.quorums import Quorums
        from plenum_tpu_torch.server.node import NodeBootstrap
        self.db_manager = NodeBootstrap.init_storage(storage_factory,
                                                     config)
        self.write_manager, self.read_manager = \
            NodeBootstrap.init_managers(self.db_manager, config)
        if genesis_txns:
            for txn in genesis_txns:
                handler = self.write_manager.request_handlers.get(
                    get_type(txn))
                if handler is not None:
                    handler.ledger.add(dict(txn))
                    handler.update_state(txn, None, None,
                                         is_committed=True)
                    if handler.state is not None:
                        handler.state.commit()
        self.policy = ObserverSyncPolicyEachBatch(
            self.write_manager, self.db_manager, Quorums(n_validators))

    def apply_data(self, msg: ObservedData, sender: str) -> bool:
        return self.policy.apply_data(msg, sender)
