"""RBFT consensus services (reference: plenum/server/consensus/).

The clean service decomposition the reference was migrating toward
("plenum 2.0", SURVEY.md §7 design stance): per protocol instance, an
OrderingService (3PC), CheckpointService, ViewChangeService and
ViewChangeTriggerService share one ConsensusSharedData and coordinate
over an InternalBus; network IO is an ExternalBus; time is a
TimerService — all mockable, fully deterministic.
"""
from plenum_tpu_torch.consensus.quorums import Quorum, Quorums
from plenum_tpu_torch.consensus.batch_id import BatchID
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData

__all__ = ["Quorum", "Quorums", "BatchID", "ConsensusSharedData"]
