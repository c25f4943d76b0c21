"""Replicas — the RBFT redundant-protocol-instance collection.

Reference: plenum/server/replicas.py:19 (Replicas, add_replica :32,
service_inboxes :100), plenum/server/node.py:1248 (checkInstances /
adjustReplicas), plenum/server/backup_instance_faulty_processor.py.

RBFT's defining mechanism: beside the master instance (inst 0) the node
runs f backup protocol instances ordering the SAME finalized requests
under DIFFERENT primaries. Backups never execute — their whole purpose
is to benchmark the master: if the master's throughput falls below Δ ×
the best backup's, the master primary is presumed slow/malicious and the
Monitor fires a view change (the ratio path, reference monitor.py:425).

All instances share the node's ExternalBus; 3PC/checkpoint/MessageReq
messages carry instId and each service discards other instances'
traffic, so no explicit routing layer is needed. On the master's
NewViewAccepted backups restart clean in the new view with their rotated
primaries.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import NewViewAccepted
from plenum_tpu_torch.common.messages.node_messages import Ordered
from plenum_tpu_torch.consensus.replica_service import ReplicaService
from plenum_tpu_torch.runtime.timer import TimerService

logger = logging.getLogger(__name__)


def num_instances_for(n_validators: int) -> int:
    """f + 1 protocol instances (reference plenum/common/util.py
    getMaxFailures + replicas growth rule)."""
    f = (n_validators - 1) // 3
    return f + 1


class Replicas:
    def __init__(self, node_name: str, validators: List[str],
                 timer: TimerService, network,
                 master: ReplicaService,
                 config: Optional[Config] = None,
                 on_backup_ordered: Callable[[Ordered], None] = None,
                 on_backup_pp_sent: Callable[[int, int, int], None] = None):
        self._node_name = node_name
        self._validators = list(validators)
        self._timer = timer
        self._network = network
        self.config = config or Config()
        self._on_backup_ordered = on_backup_ordered or (lambda o: None)
        self._on_backup_pp_sent = on_backup_pp_sent
        self._suspicion_handlers: List[Callable] = []
        self._outbox = None
        self._replicas: Dict[int, ReplicaService] = {0: master}
        master.internal_bus.subscribe(NewViewAccepted,
                                      self._on_master_new_view)
        self.adjust_replicas()

    # ------------------------------------------------------- collection

    @property
    def master(self) -> ReplicaService:
        return self._replicas[0]

    @property
    def num_instances(self) -> int:
        return len(self._replicas)

    @property
    def backup_ids(self) -> List[int]:
        return sorted(i for i in self._replicas if i != 0)

    def __iter__(self):
        return iter(self._replicas.values())

    def __getitem__(self, inst_id: int) -> ReplicaService:
        return self._replicas[inst_id]

    def adjust_replicas(self, validators: Optional[List[str]] = None) -> int:
        """Grow/shrink backups to f+1 total instances (reference
        node.py:1260 adjustReplicas). → delta added (negative=removed)."""
        if validators is not None:
            self._validators = list(validators)
        wanted = num_instances_for(len(self._validators))
        delta = 0
        while self.num_instances < wanted:
            self._add_backup(max(self._replicas) + 1)
            delta += 1
        while self.num_instances > wanted:
            self.remove_backup(max(self._replicas))
            delta -= 1
        return delta

    def _add_backup(self, inst_id: int):
        replica = ReplicaService(
            self._node_name, self._validators, self._timer, self._network,
            inst_id=inst_id, is_master=False, config=self.config)
        # align with the master's current view
        replica.reset_for_view(self.master.view_no)
        replica.internal_bus.subscribe(Ordered, self._on_backup_ordered)
        if self._on_backup_pp_sent is not None:
            replica.ordering.on_pp_sent = (
                lambda view_no, pp_seq_no, iid=inst_id:
                self._on_backup_pp_sent(iid, view_no, pp_seq_no))
        from plenum_tpu_torch.common.messages.internal_messages import (
            RaisedSuspicion)
        for handler in self._suspicion_handlers:
            replica.internal_bus.subscribe(RaisedSuspicion, handler)
        replica.ordering.outbox = self._outbox
        self._replicas[inst_id] = replica
        logger.info("%s: added backup instance %d (primary %s)",
                    self._node_name, inst_id, replica.data.primary_name)

    def remove_backup(self, inst_id: int):
        """Remove a (faulty) backup instance (reference
        replicas.py remove_replica; master is never removable)."""
        if inst_id == 0:
            raise ValueError("cannot remove the master instance")
        replica = self._replicas.pop(inst_id, None)
        if replica is not None:
            replica.stasher.unsubscribe_all()
            replica.message_req.stop()
            logger.info("%s: removed backup instance %d",
                        self._node_name, inst_id)

    def subscribe_suspicions(self, handler: Callable) -> None:
        """Route RaisedSuspicion from EVERY protocol instance (master +
        current and future backups) to the node-level reporter."""
        from plenum_tpu_torch.common.messages.internal_messages import (
            RaisedSuspicion)
        self._suspicion_handlers.append(handler)
        for replica in self._replicas.values():
            replica.internal_bus.subscribe(RaisedSuspicion, handler)

    # --------------------------------------------------------- fan-out

    def set_outbox(self, outbox) -> None:
        """Attach one node-wide coalescing 3PC outbox to every protocol
        instance — current AND future backups (all instances' broadcast
        votes ride the same per-tick THREE_PC_BATCH)."""
        self._outbox = outbox
        for replica in self._replicas.values():
            replica.ordering.outbox = outbox

    def get(self, inst_id: int) -> Optional[ReplicaService]:
        """Instance by id, None when this node runs fewer instances than
        the sender (membership skew) — batch routing drops those."""
        return self._replicas.get(inst_id)

    def submit_request(self, digest: str, ledger_id: int = 1):
        for replica in self._replicas.values():
            replica.submit_request(digest, ledger_id)

    def submit_requests(self, digests, ledger_id: int = 1):
        """One finalized propagate batch into every instance's proposal
        queue — the stash replay inside runs once per (instance, batch)
        instead of once per (instance, request)."""
        for replica in self._replicas.values():
            replica.submit_requests(digests, ledger_id)

    def service(self) -> int:
        return sum(r.service() for r in list(self._replicas.values()))

    def _on_master_new_view(self, msg: NewViewAccepted):
        for inst_id in self.backup_ids:
            self._replicas[inst_id].reset_for_view(self.master.view_no)


class BackupInstanceFaultyProcessor:
    """Detects dead/unproductive backup instances and removes them
    (reference plenum/server/backup_instance_faulty_processor.py;
    REPLICAS_REMOVING_WITH_DEGRADATION='local' strategy: a backup whose
    throughput stays at zero while the master makes progress is removed
    locally — no pool vote needed since backups carry no state)."""

    def __init__(self, replicas: Replicas, monitor,
                 config: Optional[Config] = None):
        self._replicas = replicas
        self._monitor = monitor
        self.config = config or Config()
        self._strikes: Dict[int, int] = {}
        self.removed: List[int] = []

    def check(self):
        if self.config.REPLICAS_REMOVING_WITH_DEGRADATION != "local":
            return
        now_tput = {}
        for inst_id in list(self._replicas.backup_ids):
            tput = self._monitor.instance_throughput(inst_id)
            master_tput = self._monitor.instance_throughput(0)
            if master_tput and not tput:
                self._strikes[inst_id] = self._strikes.get(inst_id, 0) + 1
            else:
                self._strikes.pop(inst_id, None)
            now_tput[inst_id] = tput
        for inst_id, strikes in list(self._strikes.items()):
            if strikes >= 3:
                logger.warning("backup instance %d faulty (no throughput "
                               "for %d checks) — removing", inst_id, strikes)
                self._replicas.remove_backup(inst_id)
                self.removed.append(inst_id)
                self._strikes.pop(inst_id)
