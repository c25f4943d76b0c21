"""BatchID — the identity of a 3PC batch across view changes.

Reference: plenum/server/consensus/batch_id.py. `view_no` is the view the
batch is being ordered in; `pp_view_no` the view its PrePrepare was
created in (survives re-ordering after view change); `pp_digest` binds
the content.
"""
from typing import NamedTuple


class BatchID(NamedTuple):
    view_no: int
    pp_view_no: int
    pp_seq_no: int
    pp_digest: str

    def as_list(self):
        return list(self)


def batch_id_from(obj) -> BatchID:
    """Accept BatchID, list/tuple, or dict wire forms."""
    if isinstance(obj, BatchID):
        return obj
    if isinstance(obj, (list, tuple)):
        return BatchID(*obj)
    if isinstance(obj, dict):
        return BatchID(obj["view_no"], obj["pp_view_no"],
                       obj["pp_seq_no"], obj["pp_digest"])
    raise TypeError("cannot build BatchID from {}".format(type(obj)))
