"""AdversaryController — wraps selected sim-pool nodes and owns a
deterministic, seed-driven fault schedule.

All injection goes through the ONE interception seam
(ReplicaService.install_network_tap → ExternalBus tap); the controller
never reaches into consensus/network internals. Every fault decision
draws from one seeded SimRandom and every action appends to ``trace``
stamped with sim time, so a fixed seed replays the identical fault
sequence — the property the determinism tests pin down."""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom, SimRandom
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService

logger = logging.getLogger(__name__)


class _TapChain:
    """The tap object installed on one adversarial node's bus: applies
    each attached behavior in order to every send/receive. A behavior
    returning a replacement list feeds the NEXT behavior message by
    message, so stacked faults compose (e.g. duplicate + lossy link)."""

    def __init__(self, controller: "AdversaryController", node_name: str):
        self._controller = controller
        self._node_name = node_name
        self.behaviors: List = []

    def _apply(self, hook_name: str, msg, meta):
        routed = [(msg, meta)]
        changed = False
        for behavior in self.behaviors:
            hook = getattr(behavior, hook_name)
            nxt = []
            for m, x in routed:
                out = hook(m, x)
                if out is None:
                    nxt.append((m, x))
                else:
                    changed = True
                    nxt.extend(out)
            routed = nxt
        return routed if changed else None

    def on_send(self, msg, dst):
        return self._apply("on_send", msg, dst)

    def on_incoming(self, msg, frm):
        return self._apply("on_incoming", msg, frm)

    def on_tick(self):
        for behavior in self.behaviors:
            behavior.on_tick()


class _Wrapped:
    def __init__(self, install: Callable, uninstall: Callable,
                 raw_send: Callable, chain: _TapChain):
        self.install = install
        self.uninstall = uninstall
        self.raw_send = raw_send
        self.chain = chain


class AdversaryController:
    def __init__(self, timer: TimerService,
                 seed: int = 0,
                 random: Optional[SimRandom] = None,
                 tick_interval: float = 0.1):
        self._timer = timer
        self.random = random or DefaultSimRandom(seed)
        self.seed = seed
        # the deterministic fault trace: [(sim_time, event_str)]
        self.trace: List[Tuple[float, str]] = []
        self._wrapped: Dict[str, _Wrapped] = {}
        self._pool_names: List[str] = []
        self._ticker = RepeatingTimer(timer, tick_interval, self._on_tick,
                                      active=False)

    # ------------------------------------------------------------ roster

    def set_pool(self, nodes) -> None:
        """Tell the controller the full pool roster (used by behaviors
        to materialize broadcast destination sets)."""
        self._pool_names = [self._name_of(n) for n in nodes]

    def pool_names(self) -> List[str]:
        return list(self._pool_names)

    @property
    def adversaries(self) -> List[str]:
        return sorted(self._wrapped)

    # ------------------------------------------------------------- wiring

    @staticmethod
    def _name_of(node) -> str:
        return node if isinstance(node, str) else node.name

    @staticmethod
    def _seam_of(node):
        """Resolve the interception seam of a sim-pool member: a full
        Node exposes it via its master ReplicaService; a bare
        ReplicaService exposes it directly."""
        if hasattr(node, "install_network_tap"):
            return node
        replica = getattr(node, "replica", None)
        if replica is not None and hasattr(replica, "install_network_tap"):
            return replica
        raise TypeError("{!r} exposes no network-tap seam".format(node))

    def corrupt(self, node, behavior) -> "AdversaryController":
        """Attach a Behavior to a node (installing the tap chain through
        the seam on first corruption). Chainable."""
        name = self._name_of(node)
        wrapped = self._wrapped.get(name)
        if wrapped is None:
            seam = self._seam_of(node)
            chain = _TapChain(self, name)
            bus = seam.network
            wrapped = _Wrapped(
                install=lambda: seam.install_network_tap(chain),
                uninstall=seam.uninstall_network_tap,
                raw_send=bus.send_raw,
                chain=chain)
            wrapped.install()
            self._wrapped[name] = wrapped
            if name not in self._pool_names:
                self._pool_names.append(name)
        behavior.attach(name, self)
        wrapped.chain.behaviors.append(behavior)
        self.record("install {} on {}".format(behavior.name, name))
        self._ticker.start()
        return self

    def release(self, node, behavior=None) -> None:
        """Stop one behavior (or all of them) on a node; uninstalls the
        tap when the chain empties so the node runs fully clean."""
        name = self._name_of(node)
        wrapped = self._wrapped.get(name)
        if wrapped is None:
            return
        doomed = [b for b in wrapped.chain.behaviors
                  if behavior is None or b is behavior]
        for b in doomed:
            wrapped.chain.behaviors.remove(b)
            b.detach()
            self.record("release {} on {}".format(b.name, name))
        if not wrapped.chain.behaviors:
            wrapped.uninstall()
            del self._wrapped[name]

    def release_all(self) -> None:
        for name in list(self._wrapped):
            self.release(name)
        self._ticker.stop()

    def partition(self, *groups) -> Dict[str, object]:
        """Split the pool into isolated groups: every node in a group
        gets a Partition behavior whose reachable set is its own group
        (cross-group traffic drops both ways). → {node_name: behavior}
        for heal_partition. Nodes under partition count as 'corrupted'
        for Scenario's default honest-set derivation — partition tests
        pass an explicit honest list."""
        from plenum_tpu_torch.testing.adversary.behaviors import Partition
        behaviors: Dict[str, object] = {}
        for group in groups:
            names = [self._name_of(n) for n in group]
            for node in group:
                behavior = Partition(reachable=names)
                self.corrupt(node, behavior)
                behaviors[self._name_of(node)] = behavior
        self.record("partition {}".format(
            " / ".join("+".join(sorted(self._name_of(n) for n in g))
                       for g in groups)))
        return behaviors

    def heal_partition(self, behaviors: Dict[str, object]) -> None:
        """Remove every Partition behavior installed by partition()."""
        for name, behavior in behaviors.items():
            self.release(name, behavior)
        self.record("partition healed")

    # ---------------------------------------------------------- schedule

    def at(self, delay: float, action: Callable[[], None],
           desc: str = "") -> "AdversaryController":
        """Schedule a fault-plan step at now+delay on the sim timer —
        the deterministic replacement for ad-hoc mid-test mutation."""

        def fire():
            self.record("scheduled: {}".format(desc or action))
            action()

        self._timer.schedule(delay, fire)
        return self

    def _on_tick(self):
        for wrapped in self._wrapped.values():
            wrapped.chain.on_tick()

    # ------------------------------------------------------------- trace

    def now(self) -> float:
        return self._timer.get_current_time()

    def record(self, event: str) -> None:
        self.trace.append((round(self.now(), 6), event))

    def raw_send(self, node_name: str, msg, dst) -> None:
        """Send bypassing the tap (used by behaviors releasing held
        traffic)."""
        wrapped = self._wrapped.get(node_name)
        if wrapped is not None:
            wrapped.raw_send(msg, dst)

    def trace_lines(self) -> List[str]:
        return ["{:.6f} {}".format(t, e) for t, e in self.trace]
