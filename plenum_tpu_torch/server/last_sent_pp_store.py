"""Persist the last PrePrepare a BACKUP primary sent, restore on
restart.

Reference: plenum/server/last_sent_pp_store_helper.py:10. The master
primary recovers its 3PC position through catchup (the audit ledger),
but backup instances carry no ledger — a restarted backup primary
would reuse pp_seq_nos from 1 and be ignored by peers until a view
change. Persisting (inst_id, view_no, pp_seq_no) in the node status DB
lets it resume where it left off.
"""
from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

LAST_SENT_PP_KEY = b"lastSentPrePrepare"


class LastSentPpStoreHelper:
    def __init__(self, node_status_db):
        self._db = node_status_db

    def store_last_sent(self, inst_id: int, view_no: int,
                        pp_seq_no: int) -> None:
        self._db.put(LAST_SENT_PP_KEY,
                     json.dumps([inst_id, view_no, pp_seq_no]).encode())

    def erase_last_sent(self) -> None:
        try:
            self._db.remove(LAST_SENT_PP_KEY)
        except KeyError:
            pass

    def load_last_sent(self) -> Optional[Tuple[int, int, int]]:
        try:
            raw = self._db.get(LAST_SENT_PP_KEY)
        except KeyError:
            return None
        try:
            inst_id, view_no, pp_seq_no = json.loads(raw.decode())
            return int(inst_id), int(view_no), int(pp_seq_no)
        except (ValueError, TypeError):
            logger.warning("malformed lastSentPrePrepare record %r", raw)
            return None

    def try_restore(self, node) -> bool:
        """Restore a backup primary's 3PC position (reference
        try_restore_last_sent_pp_seq_no + _can_restore conditions:
        instance exists, this node is its primary, never the master).

        Must run AFTER the master adopted its view from the audit
        ledger: the stored view is compared against the MASTER's view
        (backups are constructed at view 0 and only aligned here), and
        the restore mirrors the reference's _restore_last_stored —
        lastPrePrepareSeqNo AND last_ordered_3pc AND watermarks — else
        the in-flight gate and strict-sequential ordering stall the
        instance right after restart."""
        stored = self.load_last_sent()
        if stored is None:
            return False
        inst_id, view_no, pp_seq_no = stored
        if inst_id == 0:
            logger.warning("%s: ignoring stored %s — the master primary "
                           "restores via catchup", node.name, stored)
            return False
        if inst_id not in [r.data.inst_id for r in node.replicas]:
            logger.info("%s: ignoring stored %s — no instance %d",
                        node.name, stored, inst_id)
            return False
        master_view = node.view_no
        if view_no != master_view:
            logger.info("%s: ignoring stored %s — pool view is %d",
                        node.name, stored, master_view)
            return False
        replica = node.replicas[inst_id]
        # align the backup (built at view 0) with the adopted view so
        # the primary check runs against the RIGHT selection
        replica.reset_for_view(master_view)
        if replica.data.primary_name != node.name:
            logger.info("%s: ignoring stored %s — not primary of "
                        "instance %d", node.name, stored, inst_id)
            return False
        replica.ordering.lastPrePrepareSeqNo = pp_seq_no
        replica.ordering._last_applied_seq = pp_seq_no
        replica.data.pp_seq_no = pp_seq_no
        replica.data.last_ordered_3pc = (master_view, pp_seq_no)
        replica.checkpointer.caught_up_till_3pc((master_view, pp_seq_no))
        logger.info("%s: restored backup instance %d to pp_seq_no %d",
                    node.name, inst_id, pp_seq_no)
        return True
