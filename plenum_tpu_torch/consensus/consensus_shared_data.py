"""ConsensusSharedData — all 3PC state shared by the per-instance services.

Reference: plenum/server/consensus/consensus_shared_data.py:19. One
instance per replica; OrderingService, CheckpointService and
ViewChangeService read/write it, so it is the single source of truth for
view number, watermarks, batch lists and quorums.
"""
from typing import List, Optional

from plenum_tpu_torch.common.messages.node_messages import Checkpoint, PrePrepare
from plenum_tpu_torch.consensus.batch_id import BatchID
from plenum_tpu_torch.consensus.quorums import Quorums

# in-flight window size: watermark H = h + LOG_SIZE
# (reference plenum/config.py:276; 3 * CHK_FREQ)
DEFAULT_LOG_SIZE = 300
DEFAULT_CHK_FREQ = 100


class ConsensusSharedData:
    def __init__(self, name: str, validators: List[str], inst_id: int,
                 is_master: bool = True, log_size: int = DEFAULT_LOG_SIZE):
        self.name = name
        self.inst_id = inst_id
        self.is_master = is_master
        self.log_size = log_size

        self.view_no = 0
        self.waiting_for_new_view = False
        self.primary_name: Optional[str] = None
        # all currently known validator node names (pool membership)
        self.validators: List[str] = []
        self.quorums: Quorums = Quorums(0)
        self.set_validators(validators)

        self.pp_seq_no = 0  # last created (primary) pp_seq_no
        self.last_ordered_3pc = (0, 0)
        self.last_batch_prepared: Optional[BatchID] = None

        # batches this replica has pre-prepared / prepared (BatchIDs,
        # ordered by pp_seq_no) — the evidence sent in VIEW_CHANGE
        self.preprepared: List[BatchID] = []
        self.prepared: List[BatchID] = []

        # watermarks [low, high]
        self.low_watermark = 0
        self.stable_checkpoint = 0
        # always holds at least the latest stable checkpoint; seeded with
        # the initial one so NEW_VIEW can be built before any real
        # checkpoint exists (reference consensus_shared_data.py initial)
        self.checkpoints: List[Checkpoint] = [self.initial_checkpoint]

        # PrePrepares requested from old view during re-ordering
        self.new_view_votes = {}
        self.prev_view_prepare_cert: Optional[int] = None

        # requests being 3PC-processed: digest -> request (fed by node)
        self.requests = {}
        # digest -> request object queues per ledger are owned by ordering

        self.node_mode_participating = True

    @property
    def initial_checkpoint(self) -> Checkpoint:
        return Checkpoint(instId=self.inst_id, viewNo=0, seqNoStart=0,
                          seqNoEnd=0, digest="INITIAL_CHECKPOINT")

    # ------------------------------------------------------------- views

    def set_validators(self, validators: List[str]):
        self.validators = list(validators)
        self.quorums = Quorums(len(validators))

    @property
    def total_nodes(self) -> int:
        return len(self.validators)

    @property
    def is_primary(self) -> bool:
        return self.primary_name == self.name

    @property
    def high_watermark(self) -> int:
        return self.low_watermark + self.log_size

    def is_in_watermarks(self, pp_seq_no: int) -> bool:
        return self.low_watermark < pp_seq_no <= self.high_watermark

    # ----------------------------------------------------------- batches

    def preprepared_contains(self, pp_seq_no: int) -> bool:
        return any(b.pp_seq_no == pp_seq_no for b in self.preprepared)

    def add_preprepared(self, bid: BatchID):
        if bid not in self.preprepared:
            self.preprepared.append(bid)

    def add_prepared(self, bid: BatchID):
        if bid not in self.prepared:
            self.prepared.append(bid)

    def clear_batches_below(self, pp_seq_no: int):
        self.preprepared = [b for b in self.preprepared
                            if b.pp_seq_no > pp_seq_no]
        self.prepared = [b for b in self.prepared if b.pp_seq_no > pp_seq_no]

    def clear_all_batches(self):
        self.preprepared = []
        self.prepared = []
