"""Batched ed25519 verification providers — the dispatch seam of client
authentication (port of plenum_tpu/crypto/batch_verifier.py).

Providers share one interface: verify_batch([(msg, sig, vk)]) → [bool]
and dispatch(items) → a pending handle with ready() / collect().

  - ScalarVerifier: pure-Python RFC 8032 (crypto/ed25519.py), per item.
  - TorchBatchVerifier: one device launch of the whole batch
    (ops/ed25519.py); its handle's ready() queries a CUDA event.
  - CoalescingVerifierHub: coalesces the dispatches of co-resident
    consumers into ONE deduplicated launch.
  - RemoteVerifier ("remote", crypto/remote_verifier.py): offloads to the
    verify daemon (server/verify_daemon.py) of a multi-process pool.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.observability import telemetry as _telemetry
from plenum_tpu_torch.observability.tracing import CAT_DEVICE, NullTracer
from plenum_tpu_torch.ops import resolve_device

VerifyItem = Tuple[bytes, bytes, bytes]  # (message, signature64, verkey32)


class _Ready:
    """Already-materialized result (scalar paths)."""

    def __init__(self, results: List[bool]):
        self._results = results

    def ready(self) -> bool:
        return True

    def collect(self) -> List[bool]:
        return self._results


class _PendingDevice:
    """In-flight device batch: the launch is asynchronous — creating this
    does not block; collect() waits for the device and copies back."""

    def __init__(self, ok_device, valid, n, event=None):
        self._ok = ok_device
        self._valid = valid
        self._n = n
        self._event = event

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def collect(self) -> List[bool]:
        if self._n == 0:
            return []
        return list(self._ok.cpu().numpy() & self._valid)


class ScalarVerifier:
    name = "scalar"

    def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        from . import ed25519
        return [ed25519.verify(m, s, vk) for (m, s, vk) in items]

    def dispatch(self, items: Sequence[VerifyItem]) -> _Ready:
        return _Ready(self.verify_batch(items))


class TorchBatchVerifier:
    """One device launch per dispatch; `device=None` means CUDA."""

    name = "torch_batch"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        return self.dispatch(items).collect()

    def dispatch(self, items: Sequence[VerifyItem]) -> _PendingDevice:
        """Enqueue the device batch WITHOUT blocking on the result, so the
        caller overlaps other work with the device round trip."""
        from plenum_tpu_torch.ops import ed25519
        msgs = [m for m, _, _ in items]
        sigs = [s for _, s, _ in items]
        vks = [vk for _, _, vk in items]
        ok, valid, n = ed25519.verify_batch_async(msgs, sigs, vks,
                                                  self.device)
        event = None
        if self.device.type == "cuda" and n:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return _PendingDevice(ok, valid, n, event)


class _HubPending:
    """One dispatch's slice of a coalesced device launch."""

    def __init__(self, hub, gen, lo, hi):
        self._hub = hub
        self._gen = gen
        self._lo = lo
        self._hi = hi

    def ready(self) -> bool:
        pending = self._gen.pending
        if pending is None:
            return False  # generation not flushed yet
        return bool(pending.ready())

    def collect(self) -> List[bool]:
        hub = self._hub
        # the harvest: when results are not yet materialized this span
        # IS the host-visible device round trip for this slice
        with hub.tracer.span("hub_collect", CAT_DEVICE,
                             n=self._hi - self._lo):
            hub._flush(self._gen)
            return self._gen.results()[self._lo:self._hi]


def dedup_items(items: Sequence[VerifyItem]
                ) -> Tuple[List[VerifyItem], List[int]]:
    """→ (unique_items, index) where index[i] is item i's slot in the
    unique list. Verification is pure, and co-resident nodes all verify
    the SAME client requests — a shared device would otherwise pay n× the
    work for one answer."""
    uniq: dict = {}
    order: List[VerifyItem] = []
    index: List[int] = []
    for item in items:
        pos = uniq.get(item)
        if pos is None:
            pos = uniq[item] = len(order)
            order.append(item)
        index.append(pos)
    return order, index


class _HubGeneration:
    def __init__(self):
        self.items: List[VerifyItem] = []
        self.pending = None
        self._results = None
        self._index = None  # per-item slot in the deduped launch
        self._tm_device = False     # launched on the device path
        self._tm_hub = None         # telemetry hub stamped at flush

    def dedup(self) -> List[VerifyItem]:
        order, self._index = dedup_items(self.items)
        return order

    def results(self) -> List[bool]:
        if self._results is None:
            if self._tm_device:
                # the materialization below IS this generation's
                # dispatch→collect round trip as the host sees it
                hub = self._tm_hub
                t0 = hub.clock()
                res = self.pending.collect()
                hub.record_roundtrip(_telemetry.SEAM_HUB,
                                     (hub.clock() - t0) * 1e3)
            else:
                res = self.pending.collect()
            idx = self._index
            self._results = res if idx is None else [res[i] for i in idx]
        return self._results


class CoalescingVerifierHub:
    """Coalesces concurrent dispatches from co-resident consumers (pool
    nodes sharing a host process) into ONE device launch of the
    deduplicated union, launched the first time any participant flushes or
    harvests; per-dispatch slices keep results isolated. A generation below
    `threshold` unique items takes the scalar floor instead.

    `launches` records (unique items, launch lanes) for every device
    launch; the two are equal unless the batch shards over the device
    mesh, whose padded size the lanes then are.

    Standalone construction (the gateway tier, tests, tools): every
    collaborator is an explicit argument — ``tracer`` (flight recorder,
    NullTracer by default: the ``hub_flush`` and ``hub_collect`` spans
    and the ``hub_queue_depth`` counter), ``telemetry`` (the hub that
    receives the SEAM_HUB launch and round-trip accounting; by default
    the lazy process-wide seam hub) and ``threshold``.
    """

    name = "torch_hub"

    def __init__(self, batch=None, scalar=None, threshold: int = None,
                 tracer=None, telemetry=None):
        self._batch = batch if batch is not None else TorchBatchVerifier()
        self._scalar = scalar if scalar is not None else ScalarVerifier()
        self.threshold = Config.VERIFIER_BATCH_THRESHOLD \
            if threshold is None else threshold
        self._gen = _HubGeneration()
        self.launches: List[Tuple[int, int]] = []
        # a node may still attach a recorder after construction (a plain
        # attribute); explicit injection is the standalone path
        self.tracer = tracer if tracer is not None else NullTracer()
        self._telemetry = telemetry  # None = lazy process seam hub

    @property
    def telemetry(self):
        """The telemetry hub this hub's SEAM_HUB accounting lands in:
        the injected one, or (default) the process-wide seam hub."""
        return self._telemetry if self._telemetry is not None \
            else _telemetry.get_seam_hub()

    def dispatch(self, items: Sequence[VerifyItem]) -> _HubPending:
        gen = self._gen
        lo = len(gen.items)
        gen.items.extend(items)
        # queue-depth counter: how deep the open generation is when each
        # co-resident consumer lands — the coalescing evidence
        self.tracer.counter("hub_queue_depth", len(gen.items))
        return _HubPending(self, gen, lo, len(gen.items))

    def flush(self) -> None:
        """Close the current generation and START its (async) device
        launch now, instead of waiting for the first collect."""
        self._flush(self._gen)

    def _flush(self, gen: _HubGeneration) -> None:
        if gen.pending is not None:
            return
        # rotate FIRST: a failing dispatch must poison only this
        # generation, not wedge every future dispatch
        if gen is self._gen:
            self._gen = _HubGeneration()
        with self.tracer.span("hub_flush", CAT_DEVICE,
                              items=len(gen.items)) as _sp:
            launch_items = gen.dedup()
            _sp.add(unique=len(launch_items))
            if not launch_items:
                gen.pending = _Ready([])
            elif len(launch_items) < self.threshold:
                # quiet pool: a lone small generation takes the CPU floor
                # rather than paying a full device launch
                gen.pending = self._scalar.dispatch(launch_items)
            else:
                # hub-seam lane accounting: unique items against the
                # lanes the launch pays for (the mesh's padded size when
                # the batch shards, else exactly the unique items;
                # single-sourced in ed25519.launch_lanes)
                from plenum_tpu_torch.ops.ed25519 import launch_lanes
                lanes = launch_lanes(len(launch_items),
                                     getattr(self._batch, "device", None))
                self.launches.append((len(launch_items), lanes))
                gen._tm_device = True
                gen._tm_hub = self.telemetry
                gen._tm_hub.record_launch(_telemetry.SEAM_HUB,
                                          len(launch_items), lanes)
                gen.pending = self._batch.dispatch(launch_items)

    def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        return self.dispatch(items).collect()


def _make_remote(**kwargs):
    from plenum_tpu_torch.crypto.remote_verifier import RemoteVerifier
    return RemoteVerifier(**kwargs)


_PROVIDERS = {
    "cpu": ScalarVerifier,
    "torch_batch": TorchBatchVerifier,
    "torch_hub": lambda device=None, threshold=None, tracer=None,
    telemetry=None: CoalescingVerifierHub(
        batch=TorchBatchVerifier(device), threshold=threshold,
        tracer=tracer, telemetry=telemetry),
    "remote": _make_remote,
}


def create_verifier(name: str = "torch_hub", **kwargs):
    """A verification provider by name: "cpu" (the scalar RFC 8032
    check), "torch_batch" (one launch per dispatch on `device`),
    "torch_hub" (a CoalescingVerifierHub over it; `threshold` defaults
    to Config.VERIFIER_BATCH_THRESHOLD, `tracer` and `telemetry` go to
    the hub) or "remote" (the verify daemon
    at `addr`, crypto/remote_verifier.py). `device=None` means CUDA."""
    try:
        cls = _PROVIDERS[name]
    except KeyError:
        raise ValueError("unknown verifier provider {!r}; one of {}".format(
            name, sorted(_PROVIDERS)))
    return cls(**kwargs)
