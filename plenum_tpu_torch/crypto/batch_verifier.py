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
        self._hub._flush(self._gen)
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

    def dedup(self) -> List[VerifyItem]:
        order, self._index = dedup_items(self.items)
        return order

    def results(self) -> List[bool]:
        if self._results is None:
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
    launch; the kernel takes exactly the unique items, so the two are
    equal.
    """

    name = "torch_hub"

    def __init__(self, batch=None, scalar=None, threshold: int = None):
        self._batch = batch if batch is not None else TorchBatchVerifier()
        self._scalar = scalar if scalar is not None else ScalarVerifier()
        self.threshold = Config.VERIFIER_BATCH_THRESHOLD \
            if threshold is None else threshold
        self._gen = _HubGeneration()
        self.launches: List[Tuple[int, int]] = []

    def dispatch(self, items: Sequence[VerifyItem]) -> _HubPending:
        gen = self._gen
        lo = len(gen.items)
        gen.items.extend(items)
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
        launch_items = gen.dedup()
        if not launch_items:
            gen.pending = _Ready([])
        elif len(launch_items) < self.threshold:
            # quiet pool: a lone small generation takes the CPU floor
            # rather than paying a full device launch
            gen.pending = self._scalar.dispatch(launch_items)
        else:
            self.launches.append((len(launch_items), len(launch_items)))
            gen.pending = self._batch.dispatch(launch_items)

    def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        return self.dispatch(items).collect()


def _make_remote(**kwargs):
    from plenum_tpu_torch.crypto.remote_verifier import RemoteVerifier
    return RemoteVerifier(**kwargs)


_PROVIDERS = {
    "cpu": ScalarVerifier,
    "torch_batch": TorchBatchVerifier,
    "torch_hub": lambda device=None, threshold=None: CoalescingVerifierHub(
        batch=TorchBatchVerifier(device), threshold=threshold),
    "remote": _make_remote,
}


def create_verifier(name: str = "torch_hub", **kwargs):
    """A verification provider by name: "cpu" (the scalar RFC 8032
    check), "torch_batch" (one launch per dispatch on `device`),
    "torch_hub" (a CoalescingVerifierHub over it; `threshold` defaults
    to Config.VERIFIER_BATCH_THRESHOLD) or "remote" (the verify daemon
    at `addr`, crypto/remote_verifier.py). `device=None` means CUDA."""
    try:
        cls = _PROVIDERS[name]
    except KeyError:
        raise ValueError("unknown verifier provider {!r}; one of {}".format(
            name, sorted(_PROVIDERS)))
    return cls(**kwargs)
