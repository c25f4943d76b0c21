"""Deterministic gateway-side conflict-lane pre-planning (port of
plenum_tpu/gateway/lane_router.py).

The executor partitions each ORDERED batch into execution lanes
from the handlers' declared ``touched_keys``. The gateway runs the
same pure planner one tier earlier, on raw operation dicts it has not
parsed into ``Request`` objects yet: hot-key write traffic (many
clients hammering one NYM record) is recognized **before the pool
sees it**, so the intake can route each conflict lane's requests into
its own contiguous run of the outbound PROPAGATE envelope instead of
interleaving them — the node-side planner then rediscovers the same
partition from the same declarations and its serial spans stay dense.

Everything here is a pure function of the request list (``plan_lanes``
reuse, first-appearance lane normalization, no clocks, no set
iteration) — a gateway restart, a replica of the gateway, and
the node-side planner all compute the identical routing for the same
admitted stream.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from plenum_tpu_torch.server.execution_lanes import (
    SERIAL_LANE, LanePlan, TouchedKeys, plan_lanes)


def touched_keys_for(msg: dict) -> Optional[TouchedKeys]:
    """Declared state touches computable from a raw client request
    dict ALONE — the gateway-side mirror of
    ``WriteRequestHandler.touched_keys``. Only NYM (the only write
    type whose key set is statically declarable; NODE txns scan pool
    state and are inherently serial) resolves; anything else → None
    (serial lane), exactly the node planner's conservative answer."""
    from plenum_tpu_torch.common.constants import NYM, TARGET_NYM
    from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.state_codec import nym_to_state_key
    op = msg.get("operation")
    if not isinstance(op, dict) or op.get("type") != NYM:
        return None
    dest = op.get(TARGET_NYM)
    if not isinstance(dest, str) or not dest:
        return None
    key = nym_to_state_key(dest)
    reads = [(DOMAIN_LEDGER_ID, key)]
    idr = msg.get("identifier")
    if isinstance(idr, str) and idr:
        reads.append((DOMAIN_LEDGER_ID, nym_to_state_key(idr)))
    return TouchedKeys(reads=reads, writes=((DOMAIN_LEDGER_ID, key),))


def plan_write_lanes(msgs: Sequence[dict]) -> LanePlan:
    """Conflict-lane plan for a gateway write batch (request dicts in
    arrival order). Pure ``plan_lanes`` reuse — the identical
    union-find the executor runs on the ordered batch."""
    return plan_lanes([touched_keys_for(m) for m in msgs])


def route_by_lane(plan: LanePlan) -> List[Tuple[int, List[int]]]:
    """→ [(lane_id, [request indices])] with lanes ordered by first
    appearance in the batch and the serial lane last; indices inside a
    lane keep arrival order. This is the outbound envelope order: each
    lane's requests travel as one contiguous run."""
    by_lane: Dict[int, List[int]] = {}
    order: List[int] = []
    serial: List[int] = []
    for i, lane in enumerate(plan.lanes):
        if lane == SERIAL_LANE:
            serial.append(i)
            continue
        bucket = by_lane.get(lane)
        if bucket is None:
            bucket = by_lane[lane] = []
            order.append(lane)
        bucket.append(i)
    out = [(lane, by_lane[lane]) for lane in order]
    if serial:
        out.append((SERIAL_LANE, serial))
    return out
