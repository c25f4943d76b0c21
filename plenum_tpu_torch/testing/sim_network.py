"""Deterministic simulated network: delivers ExternalBus sends through a
chain of processors (drop / delay / stash) on a MockTimer.

Reference: plenum/test/simulation/sim_network.py:98 (SimNetwork),
:14-40 (Discard/Deliver/Stash processors). Seeded by DefaultSimRandom so
partition/latency fuzzing of view change + ordering is replayable.
"""
import heapq
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from plenum_tpu_torch.runtime.bus import ExternalBus
from plenum_tpu_torch.runtime.sim_random import SimRandom, DefaultSimRandom
from plenum_tpu_torch.testing.mock_timer import MockTimer

logger = logging.getLogger(__name__)


class PendingMessage(NamedTuple):
    message: Any
    frm: str
    dst: str


class Processor:
    """Returns True if it consumed the message (stops the chain)."""

    def process(self, msg: PendingMessage) -> bool:
        raise NotImplementedError

    def _matches(self, msg: PendingMessage, frm=None, dst=None,
                 message_types=None) -> bool:
        if frm is not None and msg.frm not in frm:
            return False
        if dst is not None and msg.dst not in dst:
            return False
        if message_types is not None and not isinstance(msg.message,
                                                        tuple(message_types)):
            return False
        return True


class Discard(Processor):
    def __init__(self, random: SimRandom, probability: float = 1.0,
                 frm=None, dst=None, message_types=None):
        self._random = random
        self._probability = probability
        self._filters = dict(frm=frm, dst=dst, message_types=message_types)

    def process(self, msg: PendingMessage) -> bool:
        if not self._matches(msg, **self._filters):
            return False
        return self._random.float(0.0, 1.0) < self._probability


class Stash(Processor):
    def __init__(self, frm=None, dst=None, message_types=None):
        self._filters = dict(frm=frm, dst=dst, message_types=message_types)
        self.stashed: List[PendingMessage] = []

    def process(self, msg: PendingMessage) -> bool:
        if self._matches(msg, **self._filters):
            self.stashed.append(msg)
            return True
        return False

    def pop_all(self) -> List[PendingMessage]:
        msgs, self.stashed = self.stashed, []
        return msgs


class Tap(Processor):
    """Record matching messages WITHOUT consuming them (wire-level spy:
    the bus subscriptions capture bound methods at construction, so
    attribute-level spies can't see handler traffic — observe the wire
    instead)."""

    def __init__(self, frm=None, dst=None, message_types=None):
        self._filters = dict(frm=frm, dst=dst, message_types=message_types)
        self.seen: List[PendingMessage] = []

    def process(self, msg: PendingMessage) -> bool:
        if self._matches(msg, **self._filters):
            self.seen.append(msg)
        return False


class Delay(Processor):
    """Deliver matching messages `extra` seconds late (reference
    delayer combinators, plenum/test/delayers.py — ppDelay/cDelay/
    icDelay are this with a message_types filter). Each delayed message
    still draws its own base latency, so two equally delayed messages
    may reorder exactly like two undelayed ones; only identical
    deadlines keep FIFO (the seq tie-break)."""

    def __init__(self, network: "SimNetwork", extra: float,
                 frm=None, dst=None, message_types=None):
        self._network = network
        self.extra = extra
        self._filters = dict(frm=frm, dst=dst, message_types=message_types)

    def process(self, msg: PendingMessage) -> bool:
        if not self._matches(msg, **self._filters):
            return False
        self._network._schedule_delivery(msg, extra=self.extra)
        return True


def _unwrap_envelope(message):
    """Constituent typed messages of a coalesced wire envelope
    (THREE_PC_BATCH or a flat-wire FLAT_WIRE payload), or None when
    `message` is not one. Local imports: the sim network must stay
    importable without the full message schema module loaded first."""
    from plenum_tpu_torch.common.messages.node_messages import (
        FlatBatch, ThreePCBatch)
    if isinstance(message, ThreePCBatch):
        return list(message.messages)
    if isinstance(message, FlatBatch):
        from plenum_tpu_torch.common.serializers import flat_wire
        # malformed / all-entries-invalid envelopes deliver WHOLE so
        # the receiving node does the judging, exactly like real
        # transport — the policy is single-sourced next to the codec
        return flat_wire.unwrap_for_tap(message.payload)
    return None


class SimNetwork:
    def __init__(self, timer: MockTimer, random: Optional[SimRandom] = None,
                 serialize_deserialize: Callable[[Any], Any] = None,
                 min_latency: float = 0.01, max_latency: float = 0.5):
        self._timer = timer
        self._random = random or DefaultSimRandom()
        self._min_latency = min_latency
        self._max_latency = max_latency
        self._serde = serialize_deserialize
        self._buses: Dict[str, ExternalBus] = {}
        self._down: set = set()
        self.processors: List[Processor] = []
        self.sent_count = 0
        # in-flight messages keyed by absolute deadline; ONE timer event
        # (the pump) drains everything due instead of one closure+event
        # per message — at n nodes each request generates O(n^2) sends
        # and the per-event cost dominated the 25-node sim. Latency
        # draws and delivery times are unchanged, so seeded runs are
        # bit-identical.
        self._pending: List = []         # [deadline, seq, PendingMessage]
        self._seq = 0
        # generation-tagged arming: exactly one LIVE pump; superseded
        # ones return immediately (re-arming blindly made every stale
        # pump spawn another — an event storm at 25 nodes)
        self._pump_gen = 0
        self._pump_deadline: Optional[float] = None

    def create_peer(self, name: str, send_handler=None) -> ExternalBus:
        """send_handler overrides the simulated transport for this peer
        (reference sim_network.py:116) — used by tests to spy on sends."""
        if name in self._buses:
            raise ValueError("Peer {} already exists".format(name))
        bus = ExternalBus(send_handler=send_handler or
                          self._make_send_handler(name))
        self._buses[name] = bus
        # downed peers are NOT connected to the newcomer (a node joining
        # while the primary is dead must see it as disconnected)
        for peer, other in self._buses.items():
            if peer != name and peer not in self._down:
                other.update_connecteds(other.connecteds | {name})
        bus.update_connecteds(set(p for p in self._buses
                                  if p != name and p not in self._down))
        return bus

    def remove_peer(self, name: str):
        """Forget a peer entirely so a restarted node can create_peer
        under the same name (node restart in tests)."""
        self.disconnect(name)
        self._buses.pop(name, None)
        self._down.discard(name)

    def disconnect(self, name: str):
        """Take a peer down: its traffic stops both ways and every other
        peer sees an ExternalBus.Disconnected event (reference
        onConnsChanged node.py:1169 trigger side)."""
        self._down.add(name)
        for peer, bus in self._buses.items():
            if peer != name:
                bus.update_connecteds(bus.connecteds - {name})
        me = self._buses.get(name)
        if me is not None:
            me.update_connecteds(set())

    def reconnect(self, name: str):
        """Bring a downed peer back; still-up peers see Connected events
        (peers that are themselves down stay fully isolated)."""
        self._down.discard(name)
        for peer, bus in self._buses.items():
            if peer != name and peer not in self._down:
                bus.update_connecteds(bus.connecteds | {name})
        me = self._buses.get(name)
        if me is not None:
            me.update_connecteds(
                set(p for p in self._buses if p != name and
                    p not in self._down))

    def add_processor(self, processor: Processor):
        self.processors.append(processor)

    def remove_processor(self, processor: Processor):
        self.processors.remove(processor)

    def reset_filters(self):
        self.processors = []

    def deliver_stashed(self, stash: Stash):
        for msg in stash.pop_all():
            self._schedule_delivery(msg)

    def _make_send_handler(self, frm: str):
        def handle(message, dst=None):
            if dst is None:
                dsts = [p for p in self._buses if p != frm]
            elif isinstance(dst, str):
                dsts = [dst]
            else:
                dsts = list(dst)
            # fault injection needs per-message wire granularity: while
            # processors are installed, coalesced envelopes (typed
            # THREE_PC_BATCH and flat FLAT_WIRE alike) unwrap into
            # their constituent votes so drop/delay/stash/tap filters
            # (and per-message latency draws) behave exactly as on the
            # legacy per-message wire. Uninstrumented pools keep the
            # envelope whole — one delivery per peer per flush.
            messages = [message]
            if self.processors:
                inner = _unwrap_envelope(message)
                if inner is not None:
                    messages = inner
            for d in dsts:
                if d == frm or d in self._down or frm in self._down:
                    continue
                for entry in messages:
                    self.sent_count += 1
                    msg = PendingMessage(entry, frm, d)
                    if self.processors and any(p.process(msg)
                                               for p in self.processors):
                        continue
                    self._schedule_delivery(msg)
        return handle

    def _schedule_delivery(self, msg: PendingMessage, extra: float = 0.0):
        delay = self._random.float(self._min_latency, self._max_latency) \
            + extra
        deadline = self._timer.get_current_time() + delay
        self._seq += 1
        heapq.heappush(self._pending, (deadline, self._seq, msg))
        if self._pump_deadline is None or deadline < self._pump_deadline:
            self._arm(deadline)

    def _arm(self, deadline: float):
        self._pump_gen += 1
        gen = self._pump_gen
        self._pump_deadline = deadline
        delay = max(0.0, deadline - self._timer.get_current_time())
        self._timer.schedule(delay, lambda: self._pump(gen))

    def _pump(self, gen: int):
        """Deliver every due in-flight message, then re-arm for the next
        deadline. Only the latest-armed pump runs; superseded ones are
        no-ops."""
        if gen != self._pump_gen:
            return
        self._pump_deadline = None
        now = self._timer.get_current_time()
        pending = self._pending
        while pending and pending[0][0] <= now:
            _, _, msg = heapq.heappop(pending)
            self._deliver(msg)
        if pending and (self._pump_deadline is None
                        or pending[0][0] < self._pump_deadline):
            self._arm(pending[0][0])

    def _deliver(self, msg: PendingMessage):
        bus = self._buses.get(msg.dst)
        if bus is None or msg.dst in self._down or msg.frm in self._down:
            return
        payload = msg.message
        if self._serde is not None:
            payload = self._serde(payload)
        bus.process_incoming(payload, msg.frm)
