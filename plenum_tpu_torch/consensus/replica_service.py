"""ReplicaService — the clean aggregate of all consensus services.

Reference: plenum/server/consensus/replica_service.py:33 — "the intended
plenum 2.0 Replica". One protocol instance on one node: shared data + the
ordering/checkpoint/view-change services wired over one InternalBus, one
ExternalBus (the network), one TimerService and one StashingRouter. This
is also the unit the simulation tests drive (SURVEY.md §4 rung 2).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import (
    NeedViewChange, NewViewAccepted, RaisedSuspicion, VoteForViewChange)
from plenum_tpu_torch.common.messages.node_messages import Ordered
from plenum_tpu_torch.consensus.checkpoint_service import CheckpointService
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.consensus.ordering_service import (
    BatchExecutor, OrderingService, SimExecutor)
from plenum_tpu_torch.consensus.primary_selector import (
    RoundRobinConstantNodesPrimariesSelector)
from plenum_tpu_torch.consensus.view_change_service import ViewChangeService
from plenum_tpu_torch.consensus.view_change_trigger_service import (
    ViewChangeTriggerService)
from plenum_tpu_torch.observability.tracing import CAT_3PC, NullTracer
from plenum_tpu_torch.runtime.bus import InternalBus
from plenum_tpu_torch.runtime.stashing_router import StashingRouter
from plenum_tpu_torch.runtime.timer import TimerService


class ReplicaService:
    def __init__(self, name: str, validators: List[str],
                 timer: TimerService, network,
                 inst_id: int = 0, is_master: bool = True,
                 executor: Optional[BatchExecutor] = None,
                 config: Optional[Config] = None,
                 bls_bft_replica=None,
                 internal_bus: Optional[InternalBus] = None,
                 checkpoint_digest_source: Optional[Callable] = None,
                 freshness_checker=None, vc_vote_store=None):
        self.name = name
        self.config = config or Config()
        self.internal_bus = internal_bus or InternalBus()
        self.network = network
        self.timer = timer
        self.executor = executor or SimExecutor()
        self.tracer = NullTracer()   # node injects the real one

        self._data = ConsensusSharedData(
            name, validators, inst_id, is_master,
            log_size=self.config.LOG_SIZE)
        self.selector = RoundRobinConstantNodesPrimariesSelector(validators)
        self._data.primary_name = self.selector.select_primaries(
            0, inst_id + 1)[inst_id]

        self.stasher = StashingRouter(
            limit=self.config.MAX_REQUEST_QUEUE_SIZE,
            buses=[self.internal_bus, network])

        self.ordering = OrderingService(
            data=self._data, timer=timer, bus=self.internal_bus,
            network=network, executor=self.executor, stasher=self.stasher,
            config=self.config, bls_bft_replica=bls_bft_replica,
            freshness_checker=freshness_checker if is_master else None)
        self.checkpointer = CheckpointService(
            data=self._data, bus=self.internal_bus, network=network,
            stasher=self.stasher, config=self.config,
            digest_source=checkpoint_digest_source)
        # view change is a node-level protocol driven by the MASTER
        # instance only (reference: backup replicas follow the master's
        # NewViewAccepted; they never build/collect VIEW_CHANGE msgs)
        if is_master:
            self.view_changer = ViewChangeService(
                data=self._data, timer=timer, bus=self.internal_bus,
                network=network, stasher=self.stasher, config=self.config,
                primaries_selector=self.selector,
                digest_source=checkpoint_digest_source)
            self.vc_trigger = ViewChangeTriggerService(
                data=self._data, timer=timer, bus=self.internal_bus,
                network=network, config=self.config,
                vote_store=vc_vote_store)
            from plenum_tpu_torch.consensus.monitoring import (
                ForcedViewChangeService, FreshnessMonitorService)
            self.freshness_monitor = FreshnessMonitorService(
                data=self._data, timer=timer, bus=self.internal_bus,
                freshness_checker=freshness_checker, config=self.config)
            self.forced_vc = ForcedViewChangeService(
                timer=timer, bus=self.internal_bus, config=self.config)
        else:
            self.view_changer = None
            self.vc_trigger = None
            self.freshness_monitor = None
            self.forced_vc = None
        from plenum_tpu_torch.consensus.message_req_service import MessageReqService
        self.message_req = MessageReqService(
            data=self._data, timer=timer, bus=self.internal_bus,
            network=network, ordering=self.ordering, config=self.config)

        self.internal_bus.subscribe(Ordered, self._on_ordered)
        self.internal_bus.subscribe(NewViewAccepted, self._on_new_view)
        self.internal_bus.subscribe(RaisedSuspicion, self._on_suspicion)
        self.ordered_log: List[Ordered] = []

    # ------------------------------------------------------------- state

    @property
    def data(self) -> ConsensusSharedData:
        return self._data

    @property
    def view_no(self) -> int:
        return self._data.view_no

    @property
    def is_primary(self) -> bool:
        return self._data.is_primary

    @property
    def last_ordered(self):
        return self._data.last_ordered_3pc

    # ------------------------------------------------------------ inputs

    def submit_request(self, digest: str, ledger_id: int = 1):
        """Feed a finalized (quorum-propagated) request digest."""
        self.ordering.add_finalized_request(digest, ledger_id)

    def submit_requests(self, digests, ledger_id: int = 1):
        """Feed a whole finalized batch in one call (one stash replay)."""
        self.ordering.add_finalized_requests(digests, ledger_id)

    def service(self):
        """One prod tick: send batches if primary."""
        return self.ordering.send_3pc_batch()

    def start_view_change(self, view_no: Optional[int] = None):
        """Vote for a view change (broadcast INSTANCE_CHANGE); the view
        change itself starts when a strong quorum of votes accumulates."""
        self.internal_bus.send(VoteForViewChange(suspicion="external",
                                                 view_no=view_no))

    # -------------------------------------------------- interception seam

    def install_network_tap(self, tap) -> None:
        """The ONLY supported seam for fault-injection tooling
        (testing/adversary): every message this replica sends or
        receives flows through ``tap`` (see ExternalBus.set_tap for the
        protocol). Behavior lives entirely in the tap — this class and
        the services it aggregates stay byzantine-logic-free."""
        self.network.set_tap(tap)

    def uninstall_network_tap(self) -> None:
        self.network.clear_tap()

    # ------------------------------------------------------------- hooks

    def _on_ordered(self, ordered: Ordered):
        # the Ordered emission itself: separates "3PC decided" from the
        # executor's durable-commit span that follows on this timeline
        self.tracer.instant("ordered", CAT_3PC,
                            key="%d:%d" % (ordered.viewNo,
                                           ordered.ppSeqNo),
                            batch_size=len(ordered.valid_reqIdr))
        self.ordered_log.append(ordered)
        self.executor.commit_batch(ordered)

    def _on_new_view(self, msg: NewViewAccepted):
        if msg.checkpoint:
            self.checkpointer.on_view_change_completed(
                msg.checkpoint["seqNoEnd"])
        self.ordering.on_view_change_completed()

    def _on_suspicion(self, msg: RaisedSuspicion):
        # route byzantine suspicions into view-change votes (master only)
        if self._data.is_master:
            self.internal_bus.send(VoteForViewChange(suspicion=msg.ex))

    # ------------------------------------------------- backup lifecycle

    def reset_for_view(self, view_no: int):
        """Backup instances restart clean in the new view chosen by the
        master (reference: backups get new primaries from
        select_primaries and begin ordering from (view_no, 0) — their
        batches carry no execution state to preserve)."""
        assert not self._data.is_master
        d = self._data
        d.view_no = view_no
        d.waiting_for_new_view = False
        d.primary_name = self.selector.select_primaries(
            view_no, d.inst_id + 1)[d.inst_id]
        d.pp_seq_no = 0
        d.last_ordered_3pc = (view_no, 0)
        d.preprepared = []
        d.prepared = []
        d.low_watermark = 0
        d.stable_checkpoint = 0
        d.checkpoints = [d.initial_checkpoint]
        o = self.ordering
        o.sent_preprepares.clear()
        o.prePrepares.clear()
        o.prepares.clear()
        o.commits.clear()
        o._prepare_vote_count.clear()
        o._commit_vote_count.clear()
        o.batches.clear()
        o.ordered.clear()
        o.old_view_preprepares.clear()
        o.lastPrePrepareSeqNo = 0
        o._last_applied_seq = 0
        o._new_view_bids_to_reorder = []
        self.executor.revert_unordered_batches()
