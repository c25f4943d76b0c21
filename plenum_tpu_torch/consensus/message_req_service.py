"""MessageReqService — re-request missing protocol messages.

Reference: plenum/server/consensus/message_request/ (MessageReqService +
per-type handlers, 471 LoC). Lost PRE-PREPARE/PREPARE/COMMIT messages
would otherwise stall a replica forever (no transport retransmission);
this service periodically detects gaps and asks peers, who answer from
their 3PC logs with MESSAGE_RESPONSE.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import MissingMessage
from plenum_tpu_torch.common.messages.node_messages import (
    Commit, MessageRep, MessageReq, PrePrepare, Prepare)
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService

logger = logging.getLogger(__name__)

PREPREPARE = "PREPREPARE"
PREPARE = "PREPARE"
COMMIT = "COMMIT"


class MessageReqService:
    def __init__(self, data: ConsensusSharedData, timer: TimerService,
                 bus, network, ordering,
                 config: Optional[Config] = None,
                 check_interval: float = 1.0):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._ordering = ordering
        self._config = config or Config()
        self._unsubscribers = [
            network.subscribe(MessageReq, self.process_message_req),
            network.subscribe(MessageRep, self.process_message_rep)]
        bus.subscribe(MissingMessage, self.process_missing_message)
        # (msg_type, view_no, pp_seq_no) -> last request time (throttle)
        self._requested: Dict[Tuple, float] = {}
        self._gap_timer = RepeatingTimer(timer, check_interval,
                                         self._check_gaps)

    # ------------------------------------------------------ gap detection

    def _check_gaps(self):
        if self._data.waiting_for_new_view \
                or not self._data.node_mode_participating:
            return
        # prune the throttle map: anything ordered or long-expired
        now = self._timer.get_current_time()
        last_ordered = self._data.last_ordered_3pc[1]
        for tkey in [k for k, ts in self._requested.items()
                     if k[2] <= last_ordered or now - ts > 30.0]:
            del self._requested[tkey]
        o = self._ordering
        view_no = self._data.view_no
        next_seq = self._data.last_ordered_3pc[1] + 1
        horizon = max([k[1] for k in o.prePrepares] +
                      [k[1] for k in o.prepares] +
                      [k[1] for k in o.commits] + [0])
        for seq in range(next_seq, horizon + 1):
            key = (view_no, seq)
            if key in o.ordered:
                continue
            if key not in o.prePrepares:
                # peers clearly know about this batch; fetch the PP
                if len(o.prepares.get(key, {})) > 0 \
                        or len(o.commits.get(key, {})) > 0:
                    self._request(PREPREPARE, key)
                continue
            if not o._has_prepared(key):
                self._request(PREPARE, key)
            elif not o._has_committed(key):
                self._request(COMMIT, key)

    def _request(self, msg_type: str, key: Tuple[int, int],
                 dst=None):
        now = self._timer.get_current_time()
        tkey = (msg_type, *key)
        if now - self._requested.get(tkey, -1e9) < 2.0:
            return
        self._requested[tkey] = now
        self._network.send(MessageReq(
            msg_type=msg_type,
            params={"instId": self._data.inst_id,
                    "viewNo": key[0], "ppSeqNo": key[1]}), dst)

    def process_missing_message(self, msg: MissingMessage):
        if msg.inst_id != self._data.inst_id:
            return
        self._request(msg.msg_type, msg.key, msg.dst)

    # ---------------------------------------------------------- answering

    def process_message_req(self, req: MessageReq, frm: str):
        params = req.params or {}
        if params.get("instId") != self._data.inst_id:
            return
        key = (params.get("viewNo"), params.get("ppSeqNo"))
        if None in key:
            return
        o = self._ordering
        msg = None
        if req.msg_type == PREPREPARE:
            pp = o.sent_preprepares.get(key) or o.prePrepares.get(key)
            if pp is not None:
                msg = pp.as_dict()
        elif req.msg_type == PREPARE:
            prepare = o.prepares.get(key, {}).get(self._data.name)
            if prepare is not None:
                msg = prepare.as_dict()
        elif req.msg_type == COMMIT:
            commit = o.commits.get(key, {}).get(self._data.name)
            if commit is not None:
                msg = commit.as_dict()
        if msg is not None:
            self._network.send(
                MessageRep(msg_type=req.msg_type, params=params, msg=msg),
                [frm])

    def process_message_rep(self, rep: MessageRep, frm: str):
        if rep.msg is None:
            return
        params = rep.params or {}
        if params.get("instId") != self._data.inst_id:
            return
        # only accept replies we actually asked for — an unsolicited
        # MESSAGE_RESPONSE is a forgery vector (esp. PRE-PREPAREs, which
        # get re-attributed to the primary below)
        tkey = (rep.msg_type, params.get("viewNo"), params.get("ppSeqNo"))
        if tkey not in self._requested:
            logger.debug("%s ignoring unsolicited MESSAGE_RESPONSE %s "
                         "from %s", self._data.name, tkey, frm)
            return
        try:
            if rep.msg_type == PREPREPARE:
                msg = PrePrepare(**rep.msg)
                # a PRE-PREPARE is only acceptable as coming from the
                # primary that created it
                primary = self._data.primary_name
                self._network.process_incoming(msg, primary)
            elif rep.msg_type == PREPARE:
                self._network.process_incoming(Prepare(**rep.msg), frm)
            elif rep.msg_type == COMMIT:
                self._network.process_incoming(Commit(**rep.msg), frm)
        except Exception as e:  # malformed reply from a byzantine peer
            logger.warning("%s bad MESSAGE_RESPONSE from %s: %s",
                           self._data.name, frm, e)

    def stop(self):
        """Stop the gap timer and detach network subscriptions.

        Called on backup replica removal (server/replicas.py); without the
        timer stop, a removed backup would leak a live RepeatingTimer that
        keeps firing _check_gaps on the shared TimerService forever.
        """
        self._gap_timer.stop()
        for unsub in self._unsubscribers:
            try:
                unsub()
            except ValueError:
                pass
        self._unsubscribers = []
