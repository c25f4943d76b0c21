"""Deterministic execution-lane planning for ordered batches.

The conflict-lane executor (server/executor.py) partitions every
ordered 3PC batch into **execution lanes** keyed by the requests'
declared state touches (``WriteRequestHandler.touched_keys``): two
requests share a lane iff they are connected through keys where at
least one side WRITES — read-read sharing (every request in a loaded
pool reads a handful of hot author records) never serializes anything.
Requests whose handler cannot statically declare its key set (NODE
txns scan the whole pool state for alias uniqueness; TAA writes chase
digest chains through state) join one designated **serial lane** that
conservatively conflicts with every other lane.

Determinism: the plan is a pure function of the ordered batch — the
declared key sets in batch order, a union-find with
first-request-index representatives, and lane ids normalized by first
appearance. Every honest node computes the identical partition from
the identical PRE-PREPARE, so lane telemetry and scheduling decisions
are pool-comparable. The plan can never diverge *state*: the executor
applies requests in batch order regardless (docs/execution.md has the
full argument), so the lanes drive the batched read prefetch, the
merged hash resolve and the conflict accounting — a planning bug can
cost performance, never a root mismatch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# (ledger_id, state_key) — the coordinate every declaration speaks
LaneKey = Tuple[int, bytes]

# lane id of the designated serial lane (undeclared requests)
SERIAL_LANE = -1


class TouchedKeys:
    """One request's declared state touches: the key sets its handler
    promises to confine every ``state.get``/``state.set`` to during
    ``dynamic_validation`` + ``update_state`` (a SUPERSET is always
    safe — extra keys only make lane grouping more conservative).
    Handlers that cannot declare return None instead (serial lane)."""

    __slots__ = ("reads", "writes")

    def __init__(self, reads: Sequence[LaneKey] = (),
                 writes: Sequence[LaneKey] = ()):
        self.reads = tuple(reads)
        self.writes = tuple(writes)

    def with_reads(self, extra: Sequence[LaneKey]) -> "TouchedKeys":
        return TouchedKeys(self.reads + tuple(extra), self.writes)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "TouchedKeys(reads=%r, writes=%r)" % (self.reads,
                                                     self.writes)


class LanePlan:
    """The partition of one ordered batch into execution lanes."""

    __slots__ = ("lanes", "n_lanes", "serial_requests", "conflict_ratio",
                 "read_keys_by_ledger", "write_keys_by_ledger",
                 "lane_sizes")

    def __init__(self, lanes: List[int], n_lanes: int,
                 serial_requests: int, conflict_ratio: float,
                 read_keys_by_ledger: Dict[int, List[bytes]],
                 write_keys_by_ledger: Dict[int, List[bytes]],
                 lane_sizes: Dict[int, int]):
        self.lanes = lanes                  # per-request lane id
        self.n_lanes = n_lanes              # declared lanes + serial
        self.serial_requests = serial_requests
        self.conflict_ratio = conflict_ratio
        self.read_keys_by_ledger = read_keys_by_ledger
        self.write_keys_by_ledger = write_keys_by_ledger
        self.lane_sizes = lane_sizes        # lane id -> request count


def plan_lanes(touches: Sequence[Optional[TouchedKeys]]) -> LanePlan:
    """Partition one ordered batch (its per-request ``TouchedKeys`` in
    batch order; None = undeclared) into execution lanes.

    Union rule: all touchers of a key merge once ANY of them writes it
    — writer/writer, writer-then-reader and reader-then-writer all
    serialize (the reader must observe exactly the writes ordered
    before it); keys nobody writes never merge lanes. Undeclared
    requests take SERIAL_LANE. Pure function of its input: identical
    on every honest node."""
    n = len(touches)
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i: int, j: int) -> None:
        ri, rj = find(i), find(j)
        if ri != rj:
            # smaller (earlier) index wins: representatives are stable
            # first-request indices, independent of union order
            if ri < rj:
                parent[rj] = ri
            else:
                parent[ri] = rj

    # key -> representative of its (write-involved) group
    write_groups: Dict[LaneKey, int] = {}
    # key -> reader indices seen before any writer of that key
    pending_readers: Dict[LaneKey, List[int]] = {}
    read_keys: Dict[int, Dict[bytes, None]] = {}
    write_keys: Dict[int, Dict[bytes, None]] = {}
    serial = 0
    for i, tk in enumerate(touches):
        if tk is None:
            serial += 1
            continue
        for key in tk.writes:
            grp = write_groups.get(key)
            if grp is not None:
                union(i, grp)
            else:
                for r in pending_readers.pop(key, ()):
                    union(i, r)
            write_groups[key] = find(i)
            write_keys.setdefault(key[0], {})[key[1]] = None
        for key in tk.reads:
            grp = write_groups.get(key)
            if grp is not None:
                union(i, grp)
                write_groups[key] = find(i)
            else:
                pending_readers.setdefault(key, []).append(i)
            read_keys.setdefault(key[0], {})[key[1]] = None
    # normalize lane ids by first appearance; undeclared -> SERIAL_LANE
    lane_of_root: Dict[int, int] = {}
    lanes: List[int] = []
    lane_sizes: Dict[int, int] = {}
    for i, tk in enumerate(touches):
        if tk is None:
            lane = SERIAL_LANE
        else:
            root = find(i)
            lane = lane_of_root.setdefault(root, len(lane_of_root))
        lanes.append(lane)
        lane_sizes[lane] = lane_sizes.get(lane, 0) + 1
    n_lanes = len(lane_of_root) + (1 if serial else 0)
    conflicted = serial + sum(
        size for lane, size in lane_sizes.items()
        if lane != SERIAL_LANE and size > 1)
    return LanePlan(
        lanes=lanes,
        n_lanes=n_lanes,
        serial_requests=serial,
        conflict_ratio=(conflicted / n) if n else 0.0,
        read_keys_by_ledger={lid: list(keys)
                             for lid, keys in read_keys.items()},
        write_keys_by_ledger={lid: list(keys)
                              for lid, keys in write_keys.items()},
        lane_sizes=lane_sizes)


def exec_fanout(n_states: int, workers: Optional[int] = None) -> int:
    """Fan-out width for a merged multi-state flush: how many
    independent per-state structural merges are worth running
    concurrently. Pure — a function of the state count and the
    (resolved) worker budget only, so the executor's scheduling
    decision is reproducible and testable without threads. Width 1
    means "stay serial": one state has nothing to overlap, and more
    lanes than workers just queue."""
    if n_states <= 1:
        return 1
    if workers is None:
        from plenum_tpu_torch.runtime.pipeline import resolve_workers
        workers = resolve_workers()
    return max(1, min(int(n_states), int(workers)))
