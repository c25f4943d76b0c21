"""Recorder/replayer — capture a node's inputs, replay them later for
bit-identical state reproduction (determinism debugging).

Reference: plenum/recorder/recorder.py:13 (Recorder — timestamped
incoming/outgoing wire messages in KV) + replayer.py (re-feeding a
recorded node). Here the recording is (sim_time, kind, sender, wire
dict) JSONL; replay drives a FRESH node on a MockTimer, delivering each
input at its recorded time. The consensus core is single-threaded and
timer-driven, so identical inputs at identical times reproduce
identical ledger/state roots — asserted by the test harness.
"""
from __future__ import annotations

import base64
import json
import logging
from typing import Callable, List, Tuple

logger = logging.getLogger(__name__)

KIND_NODE_MSG = "node"      # peer consensus message
KIND_CLIENT_MSG = "client"  # client request dict

# JSONL cannot carry raw bytes (flat-wire FLAT_WIRE payloads are
# opaque byte strings): mark-and-base64 on dump, reversed on load, so
# a recorded flat envelope replays bit-identically
_BYTES_MARK = "__plenum_b64__"


def _to_jsonable(v):
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {_BYTES_MARK: base64.b64encode(bytes(v)).decode("ascii")}
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


def _from_jsonable(v):
    if isinstance(v, dict):
        if set(v) == {_BYTES_MARK}:
            return base64.b64decode(v[_BYTES_MARK])
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


class Recorder:
    def __init__(self, get_time: Callable[[], float]):
        self._get_time = get_time
        self.entries: List[Tuple[float, str, str, dict]] = []

    def add_node_msg(self, msg_dict: dict, frm: str):
        self.entries.append(
            (self._get_time(), KIND_NODE_MSG, frm, msg_dict))

    def add_client_msg(self, msg_dict: dict, client_id: str):
        self.entries.append(
            (self._get_time(), KIND_CLIENT_MSG, client_id, msg_dict))

    # ------------------------------------------------------ persistence

    def dump(self, path: str):
        with open(path, "w") as f:
            for t, kind, frm, payload in self.entries:
                f.write(json.dumps([t, kind, frm, _to_jsonable(payload)],
                                   sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str) -> "Recorder":
        rec = cls(get_time=lambda: 0.0)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    t, kind, frm, payload = json.loads(line)
                    rec.entries.append((t, kind, frm,
                                        _from_jsonable(payload)))
        return rec


def attach_recorder(node, recorder: Recorder) -> None:
    """Intercept a node's two input seams — peer messages entering its
    ExternalBus and client requests — recording the wire form of each
    before forwarding. Sends are NOT recorded: they are outputs, fully
    determined by the inputs."""
    bus = node.network
    orig_incoming = bus.process_incoming

    def recording_incoming(msg, frm):
        if hasattr(msg, "to_dict"):   # skip Connected/Disconnected marks
            recorder.add_node_msg(msg.to_dict(), frm)
        return orig_incoming(msg, frm)

    bus.process_incoming = recording_incoming

    orig_client = node.process_client_request

    def recording_client(msg_dict, client_id):
        recorder.add_client_msg(dict(msg_dict), client_id)
        return orig_client(msg_dict, client_id)

    node.process_client_request = recording_client


def replay(recorder: Recorder, node, timer,
           settle: float = 5.0, step: float = 0.05) -> None:
    """Feed a recording into a fresh `node` driven by MockTimer `timer`
    (which must start at or before the first entry's time). Each input
    is delivered at its recorded sim time; the node services between
    deliveries exactly as the live run did."""
    from plenum_tpu_torch.common.messages.message_factory import (
        node_message_factory)

    def run_until(t: float):
        while timer.get_current_time() < t:
            node.service()
            remaining = t - timer.get_current_time()
            timer.run_for(min(step, remaining))
        node.service()

    for t, kind, frm, payload in sorted(recorder.entries,
                                        key=lambda e: e[0]):
        run_until(t)
        if kind == KIND_NODE_MSG:
            try:
                msg = node_message_factory.get_instance(**dict(payload))
            except Exception:
                # a dropped input makes the replay diverge — say so
                # loudly; silent skips defeat the tool's purpose
                logger.warning(
                    "replay: cannot reconstruct recorded message at "
                    "t=%s from %s (%r) — replay will diverge",
                    t, frm, payload, exc_info=True)
                continue
            node.network.process_incoming(msg, frm)
        elif kind == KIND_CLIENT_MSG:
            node.process_client_request(dict(payload), frm)
    # let in-flight work settle (same service/step cadence)
    end = timer.get_current_time() + settle
    run_until(end)
