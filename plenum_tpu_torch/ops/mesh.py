"""Device-mesh dispatch: shard a batch axis over every device of the host.

Port of plenum_tpu/ops/mesh.py. The device seams of this package
(ed25519 batch verify, the BLS G1 aggregate and pairing, the Merkle
tree's builds and proof gathers, the trie's SHA3 levels) are row-wise
independent over their batch axis: every row is a signature, a job, a
leaf, a proof index or a node blob. This module is the one seam that
spreads that axis over the devices:

 - `DeviceMesh` enumerates the devices lazily: ``cuda:i`` for each of
   ``torch.cuda.device_count()``, or the CPU alone without CUDA, capped
   by ``MESH_MAX_DEVICES`` and rounded down to a power of two. A device
   list given to it (``devices=``) takes the place of the enumeration,
   as XLA's forced host device count does for the JAX package: the
   tests pass the CPU eight times, and chip_smoke.py the one card
   repeated. A list that repeats an entry counts as that many devices.
 - `dispatch` cuts a batch, already padded to ``padded_size`` (``pad_rows``
   repeats row 0), into n_devices equal contiguous shards, uploads each to
   its device and calls the seam's function there, each entry of the
   device list on a CUDA stream of its own, so that shards on one card
   are queued side by side as separate cards would run them. It returns
   the per-shard outputs without synchronising: every side stream first
   waits for the caller's current stream on its device, and the caller's
   current stream then waits for every side stream (an event wait on the
   card), so whatever the caller enqueues next reads finished shards.
   `gather` concatenates the outputs onto one device (the counterpart of
   the JAX package's ``merkle._to_default_device``).
 - Passthrough: with ``MESH_ENABLED`` off, one device, a batch below
   ``MESH_SHARD_MIN``, CPU devices without ``cpu_shard`` (or
   ``PLENUM_TPU_MESH_CPU_SHARD=1``), or a caller whose device type is
   not the mesh's, the seam takes its single-device path unchanged: a
   node built with ``device="cpu"`` never shards onto a card.
 - `MeshPipeline` keeps up to ``depth`` dispatches in flight.
 - `probe_platform` / `is_accelerator` / `probed` / `default_device`
   answer "is there a card?" lazily, without creating a CUDA context.

Importing this module, `DeviceMesh.stats` and `mesh_stats` create no
CUDA context: a validator-info dump must not wake the card.

Left out on purpose: the JAX package's Pallas/XLA step-down registry
(``pallas_backend_enabled``, ``xla_backend_enabled``,
``disable_pallas_backend``). On the card a kernel runs or its call
raises; the port has no step-down.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from plenum_tpu_torch.observability import telemetry as _telemetry
from plenum_tpu_torch.observability.tracing import CAT_DEVICE, NullTracer

CPU_SHARD_ENV = "PLENUM_TPU_MESH_CPU_SHARD"

# --------------------------------------------------------- capability probe

_PROBE_LOCK = threading.Lock()
_PROBE = {"platform": None, "device_count": None}


def _probe_locked() -> None:
    """Fill the probe from torch: "gpu" and the CUDA device count, or
    "cpu" and 1. Neither call creates a CUDA context."""
    if _PROBE["platform"] is None:
        if torch.cuda.is_available():
            _PROBE["platform"] = "gpu"
            _PROBE["device_count"] = torch.cuda.device_count()
        else:
            _PROBE["platform"] = "cpu"
            _PROBE["device_count"] = 1


def probe_platform(default: str = "cpu") -> str:
    """Platform of device 0 ("cpu" or "gpu"), probed once; a broken CUDA
    runtime reads as `default` instead of raising."""
    with _PROBE_LOCK:
        try:
            _probe_locked()
        except RuntimeError:
            _PROBE["platform"] = default
            _PROBE["device_count"] = 1
        return _PROBE["platform"]


def is_accelerator() -> bool:
    """True iff device 0 is a card (not the CPU)."""
    return probe_platform() != "cpu"


def probed() -> bool:
    """Whether the platform has been probed through this module already,
    so that a status dump reports device facts without probing."""
    return _PROBE["platform"] is not None


def default_device() -> torch.device:
    """Device 0 of the host: ``cuda:0`` with CUDA, else the CPU."""
    with _PROBE_LOCK:
        _probe_locked()
        return torch.device("cuda", 0) if _PROBE["platform"] == "gpu" \
            else torch.device("cpu")


# ------------------------------------------------------------------ helpers

def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n >= 1 else 1


def pad_rows(arrays: Sequence, padded: int) -> List[np.ndarray]:
    """Pad the leading axis of every array to `padded` rows by repeating
    row 0. The sharded seams are row-wise pure, so a repeated row only
    adds work whose result the caller slices off, on a path the kernel
    already runs."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        n = a.shape[0]
        if n == padded:
            out.append(a)
            continue
        reps = np.repeat(a[:1], padded - n, axis=0)
        out.append(np.concatenate([a, reps], axis=0))
    return out


def device_index(device) -> int:
    """Index of a CUDA device: one without an index is the current one."""
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def same_device(a, b) -> bool:
    """Whether two devices are one: a CUDA device without an index is
    the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    return device_index(a) == device_index(b)


def _upload(a, device: torch.device):
    """A shard's rows on `device`: numpy arrays travel as tensors of their
    dtype (uint32 as int32 of the same bits), tensors are copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    from plenum_tpu_torch.ops import to_tensor
    return to_tensor(np.asarray(a), device)


def _tensors(obj):
    """The tensors a seam's output holds: a tensor, the tensors of a tuple
    or list, or a launch's ``buf`` (ops/sha256.Sha256Launch,
    ops/sha3.Sha3Launch)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    else:
        buf = getattr(obj, "buf", None)
        if isinstance(buf, torch.Tensor):
            yield buf


# --------------------------------------------------------------- the mesh

class DeviceMesh:
    """Batch-axis sharding over the host's devices.

    Thread-safe: the verify daemon's worker thread and a node's prod loop
    may both dispatch; device enumeration and stream creation are locked,
    counters are plain int bumps.
    """

    def __init__(self, enabled: Optional[bool] = None,
                 max_devices: Optional[int] = None,
                 shard_min: Optional[int] = None,
                 min_per_device: int = 8,
                 cpu_shard: Optional[bool] = None,
                 devices: Optional[Sequence] = None):
        """None takes the Config class default; a node applies its own
        config's values through configure_from. `devices`: the device
        list to shard over instead of the host's enumeration."""
        from plenum_tpu_torch.common.config import Config
        self.enabled = Config.MESH_ENABLED if enabled is None else enabled
        self.max_devices = (Config.MESH_MAX_DEVICES
                            if max_devices is None else max_devices)
        self.shard_min = (Config.MESH_SHARD_MIN
                          if shard_min is None else shard_min)
        self.cpu_shard = (Config.MESH_CPU_SHARD
                          if cpu_shard is None else cpu_shard)
        self.min_per_device = min_per_device
        self.tracer = NullTracer()
        self._lock = threading.Lock()
        self._given = [torch.device(d) for d in devices] if devices else None
        self._devices = None          # enumerated + capped device list
        self._streams = None          # one CUDA stream per CUDA entry
        # stats (validator info / chip_smoke.py)
        self.dispatches = 0
        self.sharded_dispatches = 0
        self.passthrough_dispatches = 0
        self.last_batch = 0
        self.last_per_device = 0

    # ------------------------------------------------------ device facts

    def _init_devices_locked(self) -> None:
        if self._devices is not None:
            return
        if self._given is not None:
            devs = list(self._given)
        else:
            with _PROBE_LOCK:
                _probe_locked()
                count = _PROBE["device_count"] \
                    if _PROBE["platform"] == "gpu" else 0
            devs = [torch.device("cuda", i) for i in range(count)] \
                or [torch.device("cpu")]
        cap = self.max_devices if self.max_devices else len(devs)
        n = max(1, min(len(devs), cap))
        # power-of-two device counts keep per-device buckets divisible;
        # a 6-device cap uses 4
        self._devices = devs[:_pow2_at_most(n)]
        self._streams = None

    @property
    def devices(self) -> list:
        with self._lock:
            self._init_devices_locked()
            return list(self._devices)

    @property
    def n_devices(self) -> int:
        with self._lock:
            self._init_devices_locked()
            return max(1, len(self._devices))

    @property
    def device_type(self) -> str:
        """"cuda" or "cpu": the type of the mesh's devices."""
        return self.devices[0].type

    def set_devices(self, devices: Optional[Sequence]) -> None:
        """Shard over `devices` from the next dispatch on; None or an
        empty list goes back to the host's enumeration."""
        with self._lock:
            self._given = [torch.device(d) for d in devices] \
                if devices else None
            self._devices = None
            self._streams = None

    def reset_devices(self) -> None:
        """Re-enumerate on next use (tests / reconfiguration)."""
        with self._lock:
            self._devices = None
            self._streams = None

    def _stream_list(self) -> list:
        """One CUDA stream per entry of the device list (None for a CPU
        entry), made once per enumeration."""
        with self._lock:
            self._init_devices_locked()
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device=d)
                                 if d.type == "cuda" else None
                                 for d in self._devices]
            return list(zip(self._devices, self._streams))

    # -------------------------------------------------------- dispatch

    def should_shard(self, n: int, device=None) -> bool:
        """The passthrough gate: shard only when the mesh is enabled, more
        than one device is present, the batch clears MESH_SHARD_MIN, the
        caller's `device` (when given) is of the mesh's device type, and
        the devices are cards, unless cpu_shard (or
        PLENUM_TPU_MESH_CPU_SHARD=1, which spawned processes inherit) lets
        the CPU shard too: CPU entries share the same cores, so sharding
        over them only adds overhead, and the tests force it to reach the
        sharded paths."""
        if not self.enabled or n < self.shard_min:
            return False
        if self.n_devices <= 1:
            return False
        kind = self.device_type
        if device is not None and torch.device(device).type != kind:
            return False
        return (kind != "cpu" or self.cpu_shard
                or os.environ.get(CPU_SHARD_ENV) == "1")

    def padded_size(self, n: int, min_per_device: Optional[int] = None
                    ) -> int:
        """Smallest n_devices × (power-of-two per-device bucket) that holds
        n rows."""
        d = self.n_devices
        mpd = self.min_per_device if min_per_device is None \
            else min_per_device
        per = pow2_at_least(max(mpd, -(-n // d)))
        return per * d

    def dispatch(self, fn: Callable, arrays: Sequence, n: Optional[int]
                 = None, label: str = "mesh_dispatch",
                 place: Optional[Callable] = None) -> list:
        """Cut `arrays` (leading axis already padded to a multiple of
        n_devices) into n_devices contiguous shards and call `fn` on each
        shard's device, the device's side stream current → [fn's output
        per shard], in mesh order, not synchronised (the caller's current
        streams wait for the side streams on the card).

        A shard reaches `fn` uploaded to its device (numpy arrays as
        tensors, tensors copied), or as `place(shard_arrays, device)`
        makes it: the seams whose packing is per shard (a BLS shard's
        distinct points, a ragged shard's offsets) pass `place`."""
        b = int(np.shape(arrays[0])[0])
        entries = self._stream_list()
        d = len(entries)
        if b % d:
            raise ValueError("a batch of {} rows does not divide over {} "
                             "devices".format(b, d))
        per = b // d
        # lane accounting: every padded row is a launched-but-wasted lane
        _telemetry.get_seam_hub().record_launch(
            _telemetry.SEAM_MESH, b if n is None else n, b, shape=(b, d))
        callers = {dev: torch.cuda.current_stream(dev)
                   for dev, s in entries if s is not None}
        outs = []
        with self.tracer.span(label, CAT_DEVICE, n=b if n is None else n,
                              padded=b, devices=d, per_device=per):
            for i, (dev, stream) in enumerate(entries):
                shard = [a[i * per:(i + 1) * per] for a in arrays]
                if stream is None:
                    args = place(shard, dev) if place else \
                        [_upload(a, dev) for a in shard]
                    outs.append(fn(*args))
                    continue
                stream.wait_stream(callers[dev])
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    args = place(shard, dev) if place else \
                        [_upload(a, dev) for a in shard]
                    outs.append(fn(*args))
            for (dev, stream), out in zip(entries, outs):
                if stream is None:
                    continue
                callers[dev].wait_stream(stream)
                # made on the side stream, read on the caller's: the
                # allocator must not hand their blocks back to the side
                # stream before the caller's reads
                for t in _tensors(out):
                    t.record_stream(callers[dev])
        self.dispatches += 1
        self.sharded_dispatches += 1
        self.last_batch = b
        self.last_per_device = per
        self.tracer.counter("mesh_devices", d)
        self.tracer.counter("mesh_per_device_batch", per)
        return outs

    def gather(self, outs: list, device=None):
        """Concatenate per-shard outputs (each a tensor or a tuple of
        tensors) along the batch axis on `device` (default: the mesh's
        first device), on that device's current stream."""
        dev = torch.device(device) if device is not None \
            else self.devices[0]
        first = outs[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([o.to(dev) for o in outs])
        return tuple(torch.cat([o[j].to(dev) for o in outs])
                     for j in range(len(first)))

    def note_passthrough(self, n: int) -> None:
        """Bookkeeping for a dispatch that took the single-device path
        (counted so validator info shows the gate working)."""
        self.dispatches += 1
        self.passthrough_dispatches += 1
        self.last_batch = n

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Snapshot for ValidatorNodeInfoTool / chip_smoke.py. Probes
        nothing: device facts appear only once something enumerated the
        mesh (or probed the platform)."""
        out = {
            "enabled": self.enabled,
            "max_devices": self.max_devices,
            "shard_min": self.shard_min,
            "cpu_shard": self.cpu_shard,
            "dispatches": self.dispatches,
            "sharded_dispatches": self.sharded_dispatches,
            "passthrough_dispatches": self.passthrough_dispatches,
            "last_batch": self.last_batch,
            "last_per_device_batch": self.last_per_device,
        }
        if self._devices is not None:
            out["n_devices"] = len(self._devices)
        if probed():
            out["platform"] = _PROBE["platform"]
            out["host_device_count"] = _PROBE["device_count"]
        return out


# ----------------------------------------------------------- pipelining

class MeshPipeline:
    """Depth-bounded dispatch/collect streamer over mesh dispatches (the
    shape of ops/merkle.ProofPipeline): up to `depth` dispatches stay in
    flight, so every device's next batch is enqueued while the host
    collects the previous one."""

    def __init__(self, dispatch_fn: Callable, collect_fn: Callable,
                 depth: int = 2, tracer=None):
        self._dispatch = dispatch_fn
        self._collect = collect_fn
        self._depth = max(1, depth)
        self._tracer = tracer or NullTracer()

    def stream(self, batches):
        from collections import deque
        pending = deque()
        tracer = self._tracer
        for batch in batches:
            with tracer.span("mesh_pipe_dispatch", CAT_DEVICE):
                pending.append(self._dispatch(batch))
            tracer.counter("mesh_pipe_inflight", len(pending))
            if len(pending) >= self._depth:
                with tracer.span("mesh_pipe_collect", CAT_DEVICE):
                    out = self._collect(pending.popleft())
                yield out
        while pending:
            with tracer.span("mesh_pipe_collect", CAT_DEVICE):
                out = self._collect(pending.popleft())
            yield out

    def run(self, batches) -> list:
        return list(self.stream(batches))


# ----------------------------------------------------- process singleton

_MESH: Optional[DeviceMesh] = None
_MESH_LOCK = threading.Lock()


def get_mesh() -> DeviceMesh:
    """The process-wide mesh every dispatch seam consults. Built lazily
    from the Config class defaults; a node applies its own config through
    configure_from, tests and chip_smoke.py through configure."""
    global _MESH
    with _MESH_LOCK:
        if _MESH is None:
            _MESH = DeviceMesh()
        return _MESH


def configure(enabled: Optional[bool] = None,
              max_devices: Optional[int] = None,
              shard_min: Optional[int] = None,
              tracer=None,
              cpu_shard: Optional[bool] = None,
              devices: Optional[Sequence] = None,
              min_per_device: Optional[int] = None) -> DeviceMesh:
    """Reconfigure the process-wide mesh; None leaves a setting as it is.
    A new device cap or device list re-enumerates on the next dispatch;
    `devices=[]` goes back to the host's enumeration."""
    m = get_mesh()
    if enabled is not None:
        m.enabled = enabled
    if shard_min is not None:
        m.shard_min = shard_min
    if cpu_shard is not None:
        m.cpu_shard = cpu_shard
    if min_per_device is not None:
        m.min_per_device = min_per_device
    if devices is not None:
        m.set_devices(devices)
    if max_devices is not None and max_devices != m.max_devices:
        m.max_devices = max_devices
        m.reset_devices()
    if tracer is not None:
        m.tracer = tracer
    return m


def configure_from(config) -> DeviceMesh:
    """Apply a Config instance's MESH_* keys (the node's bootstrap seam)."""
    return configure(
        enabled=getattr(config, "MESH_ENABLED", None),
        max_devices=getattr(config, "MESH_MAX_DEVICES", None),
        shard_min=getattr(config, "MESH_SHARD_MIN", None),
        cpu_shard=getattr(config, "MESH_CPU_SHARD", None))


def mesh_stats() -> dict:
    """Stats for status dumps; probes and enumerates nothing."""
    with _MESH_LOCK:
        m = _MESH
    return m.stats() if m is not None else {"enabled": None}
