"""CheckpointService — periodic stabilization and watermark advance.

Reference: plenum/server/consensus/checkpoint_service.py (process_checkpoint
:77, _mark_checkpoint_stable :177, set_watermarks :216). Every CHK_FREQ
ordered batches the replica emits a CHECKPOINT whose digest commits to the
batch history (the reference derives it from the audit ledger; here the
owner supplies a digest source — the audit root of the checkpointed batch).
A quorum (n-f-1) of matching checkpoints from OTHER nodes stabilizes it:
watermarks advance and 3PC logs are GC'd via CheckpointStabilized.
"""
from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import (
    CheckpointStabilized, NeedMasterCatchup)
from plenum_tpu_torch.common.messages.node_messages import Checkpoint, Ordered
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.runtime.stashing_router import DISCARD, StashingRouter

logger = logging.getLogger(__name__)


class CheckpointService:
    def __init__(self, data: ConsensusSharedData, bus, network,
                 stasher: Optional[StashingRouter] = None,
                 config: Optional[Config] = None,
                 digest_source: Optional[Callable[[int], str]] = None):
        """digest_source(pp_seq_no) → digest string binding history up to
        that batch (audit root in the full node; test stubs elsewhere)."""
        self._data = data
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self._digest_source = digest_source or (lambda s: "chk-%d" % s)
        self._stasher = stasher or StashingRouter(limit=10000,
                                                  buses=[bus, network])
        self._stasher.subscribe(Checkpoint, self.process_checkpoint)
        bus.subscribe(Ordered, self.process_ordered)

        # (seqNoEnd, digest) -> set of sender names
        self._received: Dict[Tuple[int, str], set] = defaultdict(set)
        self._own: Dict[int, Checkpoint] = {}

    @property
    def _chk_freq(self) -> int:
        return self._config.CHK_FREQ

    # ---------------------------------------------------------- creation

    def process_ordered(self, ordered: Ordered):
        if ordered.instId != self._data.inst_id:
            return
        seq = ordered.ppSeqNo
        if seq % self._chk_freq != 0:
            return
        self._create_checkpoint(seq)

    def _create_checkpoint(self, seq_no_end: int):
        digest = self._digest_source(seq_no_end)
        chk = Checkpoint(
            instId=self._data.inst_id,
            viewNo=self._data.view_no,
            seqNoStart=max(0, seq_no_end - self._chk_freq),
            seqNoEnd=seq_no_end,
            digest=digest,
        )
        self._own[seq_no_end] = chk
        self._data.checkpoints.append(chk)
        self._network.send(chk)
        self._try_stabilize(seq_no_end, digest)

    # --------------------------------------------------------- reception

    def process_checkpoint(self, chk: Checkpoint, frm: str):
        if chk.instId != self._data.inst_id:
            return (DISCARD, "wrong instance")
        if chk.seqNoEnd <= self._data.stable_checkpoint:
            return (DISCARD, "already stable")
        self._received[(chk.seqNoEnd, chk.digest)].add(frm)
        self._try_stabilize(chk.seqNoEnd, chk.digest)
        # lagging detection: quorum of checkpoints we haven't produced and
        # can't (we're more than LOG_SIZE behind) → need catchup
        if self._is_lagging(chk):
            self._bus.send(NeedMasterCatchup())
        return None

    def _is_lagging(self, chk: Checkpoint) -> bool:
        reached = self._data.quorums.checkpoint.is_reached(
            len(self._received[(chk.seqNoEnd, chk.digest)]))
        return reached and chk.seqNoEnd > \
            self._data.last_ordered_3pc[1] + self._config.LOG_SIZE

    def _try_stabilize(self, seq_no_end: int, digest: str):
        if seq_no_end <= self._data.stable_checkpoint:
            return
        if seq_no_end not in self._own:
            return  # must have our own matching checkpoint
        if self._own[seq_no_end].digest != digest:
            return
        others = self._received[(seq_no_end, digest)]
        others.discard(self._data.name)
        if not self._data.quorums.checkpoint.is_reached(len(others)) \
                and self._data.total_nodes > 1:
            return
        self._mark_stable(seq_no_end)

    def _mark_stable(self, seq_no_end: int):
        self._data.stable_checkpoint = seq_no_end
        self.set_watermarks(seq_no_end)
        # drop obsolete evidence
        for key in [k for k in self._received if k[0] <= seq_no_end]:
            del self._received[key]
        for seq in [s for s in self._own if s <= seq_no_end]:
            del self._own[seq]
        # keep the stable checkpoint itself — it is the VIEW_CHANGE evidence
        self._data.checkpoints = [c for c in self._data.checkpoints
                                  if c.seqNoEnd >= seq_no_end]
        self._data.clear_batches_below(seq_no_end)
        self._bus.send(CheckpointStabilized(
            last_stable_3pc=(self._data.view_no, seq_no_end)))
        logger.debug("%s stabilized checkpoint %d", self._data.name,
                     seq_no_end)

    def set_watermarks(self, low: int):
        self._data.low_watermark = low

    # ------------------------------------------------------------ resets

    def on_view_change_completed(self, stable_checkpoint: int):
        """After NEW_VIEW: adopt the agreed stable checkpoint."""
        if stable_checkpoint > self._data.stable_checkpoint:
            self._data.stable_checkpoint = stable_checkpoint
            self.set_watermarks(stable_checkpoint)

    def caught_up_till_3pc(self, last_3pc: Tuple[int, int]):
        """Catchup completed: fast-forward watermarks to the EXACT
        caught-up position (reference checkpoint_service
        caught_up_till_3pc / update_watermark_from_3pc).  Rounding down
        to a CHK_FREQ multiple would leave a window of already-ordered
        seq nos in which replayed PrePrepares re-apply, fail root
        comparison, and raise spurious suspicions against the primary."""
        seq = last_3pc[1]
        self._data.stable_checkpoint = seq
        self.set_watermarks(seq)
        self._own.clear()
