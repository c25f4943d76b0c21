"""Internal bus messages — lightweight NamedTuples, never on the wire.

Reference: plenum/common/messages/internal_messages.py.
"""
from typing import Any, List, NamedTuple, Optional


class RaisedSuspicion(NamedTuple):
    inst_id: int
    ex: Any  # SuspiciousNode


class VoteForViewChange(NamedTuple):
    suspicion: Any  # Suspicion
    view_no: Optional[int] = None


class NodeNeedViewChange(NamedTuple):
    view_no: int


class NeedViewChange(NamedTuple):
    view_no: Optional[int] = None


class ViewChangeStarted(NamedTuple):
    view_no: int


class NewViewAccepted(NamedTuple):
    view_no: int
    view_changes: List
    checkpoint: Any
    batches: List


class NewViewCheckpointsApplied(NamedTuple):
    view_no: int
    view_changes: List
    checkpoint: Any
    batches: List


class ReOrderedInNewView(NamedTuple):
    pass


class CatchupDone(NamedTuple):
    ledger_id: int


class CatchupFinished(NamedTuple):
    last_caught_up_3pc: tuple
    master_last_ordered: tuple


class NeedMasterCatchup(NamedTuple):
    pass


class NeedBackupCatchup(NamedTuple):
    inst_id: int
    caught_up_till_3pc: tuple


class CheckpointStabilized(NamedTuple):
    last_stable_3pc: tuple


class PrimaryDisconnected(NamedTuple):
    inst_id: int


class PrimarySelected(NamedTuple):
    pass


class MissingMessage(NamedTuple):
    msg_type: str
    key: Any
    inst_id: int
    dst: Optional[List[str]]
    stash_data: Optional[Any] = None


class RequestPropagates(NamedTuple):
    bad_requests: List


class PreSigVerification(NamedTuple):
    cmsg: Any


class BackupSetupLastOrdered(NamedTuple):
    inst_id: int


class MasterReorderedAfterVC(NamedTuple):
    pass


class Cleanup(NamedTuple):
    pass


class StartViewChange(NamedTuple):
    view_no: int


class ApplyNewView(NamedTuple):
    view_no: int
