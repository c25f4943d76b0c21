"""Pipeline-parallel node runtime — worker stages feeding the prod thread
(port of plenum_tpu/runtime/pipeline.py).

The reference is explicitly a single-process cooperative system, so a
node's ordered throughput is capped by the SUM of its stage costs: wire
parse, signature pre-screen, 3PC counting, execution and reply all
compete for one core however fast each stage got individually. This
module breaks that ceiling without touching the consensus semantics:

* **Wire parse + ed25519 pre-screen** run on a dedicated worker thread.
  Flat envelopes are immutable byte buffers, so they cross the
  thread boundary without copying or pickling; the parse result
  (``ParsedEnvelope``: plain numpy views over those bytes) is equally
  immutable on the way back.
* **The prod thread keeps sole ownership of ALL consensus state.** The
  worker never calls into ordering, propagation, ledgers or state — it
  only turns bytes into views and warms a verdict cache. Every
  consensus side effect (vote counting, suspicions, stashes, sends)
  happens at :meth:`NodePipeline.drain`, on the prod thread, in exact
  arrival order. ``OrderingService.bind_owner_thread`` enforces this
  contract at the intake seams.
* **Execution fan-out**: per-state structural merges in
  ``flush_states_merged`` are independent, so the executor
  fans them across :meth:`exec_map`'s small thread pool while apply
  order — the semantics — stays strictly batch order on the prod
  thread.

Determinism is by construction, not by luck: jobs are delivered in
submission order through ONE FIFO, and the drain runs at the same
simulated instant the serial path would have processed the message (the
node schedules a zero-delay drain on its timer at first submission), so
a pipelined pool and a serial pool produce byte-equal ledger and state
roots for any input stream — tests/test_torch_pipeline.py holds that,
against the JAX package too, under a randomized adversarial stream.

Backpressure: the parse queue is bounded (``Config.PIPELINE_QUEUE_
DEPTH``); a full queue blocks the submitting side until the worker
catches up, and the queue depth folds into the ``BACKLOG_DEPTH`` gauge
the gateway's admission ladder sheds on — pressure propagates to
the front door instead of growing an unbounded buffer. Per-stage drain
hooks run on view change and catchup start so no stale parse job
straddles a protocol epoch.

Serial fallback: the pipeline is gated by ``Config.PIPELINE_ENABLED``
(default off), and a dead worker thread degrades to inline parsing at
the drain site — the node slows down, it never wedges. The worker and
the execution pool run host code only (wire parse, the scalar ed25519
pre-screen, host-trie merges): every kernel launch stays on the prod
thread.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub
from plenum_tpu_torch.observability.tracing import CAT_3PC, NullTracer
from plenum_tpu_torch.runtime.sanitizer import HandoffToken

# auto worker sizing cap: beyond a few workers the prod thread is the
# bottleneck again and extra threads only add scheduler noise
_AUTO_WORKER_CAP = 4

_STOP = object()


def resolve_workers(configured: Optional[int] = None,
                    fallback: Optional[int] = None) -> int:
    """The single worker-sizing rule (Config.PIPELINE_WORKERS): an
    explicit value wins; None = ``fallback`` when the caller has a
    structural reason for one (the verify daemon's serialize-by-one
    floor), else auto = cores−1, capped, floor 1."""
    if configured is not None:
        return max(1, int(configured))
    if fallback is not None:
        return max(1, int(fallback))
    cores = os.cpu_count() or 1
    return max(1, min(_AUTO_WORKER_CAP, cores - 1))


def resolve_queue_depth(configured: Optional[int] = None) -> int:
    return max(1, int(256 if configured is None else configured))


class BoundedQueue:
    """Bounded SPSC FIFO: one producer (the prod thread) blocks on a
    full queue — that IS the backpressure — and one consumer (the
    stage worker) blocks on an empty one. Items must be immutable or
    handed over whole (bytes, numpy views, frozen job records): the
    producer never touches an item again after ``put``."""

    def __init__(self, depth: int):
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.depth_max = int(depth)

    def __len__(self) -> int:
        return len(self._items)

    def put(self, item) -> None:
        with self._cond:
            while len(self._items) >= self.depth_max \
                    and not self._closed:
                self._cond.wait(0.05)
            self._items.append(item)
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Next item, or None on close/timeout."""
        with self._cond:
            while not self._items and not self._closed:
                if not self._cond.wait(timeout):
                    return None
            if not self._items:
                return None
            item = self._items.popleft()
            self._cond.notify_all()
            return item

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class PipelineJob:
    """One unit crossing the stage boundary. ``work`` (or None for a
    passthrough) runs on the worker thread; ``result``/``error`` are
    written by exactly one side before ``done`` is set, then only read
    — the handoff is the Event, never shared mutation."""

    __slots__ = ("work", "msg", "frm", "result", "error", "done",
                 "enq_perf", "token")

    def __init__(self, work: Optional[Callable], msg, frm):
        self.work = work
        self.msg = msg
        self.frm = frm
        self.result = None
        self.error = None
        self.done = threading.Event()
        self.enq_perf = time.perf_counter()
        # sanitizer handoff token (None when the sanitizer is off):
        # released/acquired at each queue crossing so an out-of-turn
        # touch raises instead of racing
        self.token = None
        if work is None:
            self.done.set()

    def run(self) -> None:
        try:
            self.result = self.work()
        except Exception as e:           # delivered to the prod thread
            self.error = e
        # hand the payload back BEFORE done is observable, so the prod
        # thread can never win the race against its own re-acquire
        if self.token is not None:
            self.token.release("prod")
        self.done.set()


class PrescreenCache:
    """Positive-only ed25519 verdict cache, written by the pre-screen
    worker and read by the prod thread's authenticator. Keyed on the
    EXACT (signing bytes, signature, verkey) triple the authenticator
    would verify, so a hit can only ever skip a verification that was
    bound to succeed — a rotated verkey in domain state changes the
    triple and misses, and a miss (or any worker failure) falls through
    to the full prod-thread path. Filter, not authority: observable
    outcomes are byte-identical with the cache on or off."""

    def __init__(self, max_entries: int = 8192):
        self._hits: dict = {}
        self._max = int(max_entries)
        self._lock = threading.Lock()

    def add(self, ser: bytes, sig: bytes, vk: bytes) -> None:
        with self._lock:
            if len(self._hits) >= self._max:
                # the _raw_cache precedent: wholesale clear beats LRU
                # bookkeeping on a cache where misses only cost a
                # scalar verify
                self._hits.clear()
            self._hits[(bytes(ser), bytes(sig), bytes(vk))] = True

    def check(self, item) -> bool:
        """(ser, sig, vk) triple → True only on a cached positive."""
        try:
            ser, sig, vk = item
            key = (bytes(ser), bytes(sig), bytes(vk))
        except Exception:
            return False
        with self._lock:
            return self._hits.get(key, False)

    def __len__(self) -> int:
        return len(self._hits)


class NodePipeline:
    """The node's stage/queue runtime: one parse/pre-screen worker fed
    through a bounded SPSC queue, a FIFO of jobs awaiting prod-thread
    delivery, and a small thread pool for execution fan-out.

    ``deliver(job)`` — injected by the node — runs on the prod thread
    for every job, in submission order; it owns every consensus side
    effect. The worker side only ever executes ``job.work()``."""

    def __init__(self, deliver: Callable, config=None, telemetry=None,
                 tracer=None, name: str = "", sanitizer=None):
        self.name = name
        self._deliver = deliver
        self.sanitizer = sanitizer
        self._tm = telemetry if telemetry is not None \
            else NullTelemetryHub()
        self.tracer = tracer if tracer is not None else NullTracer()
        workers = resolve_workers(
            getattr(config, "PIPELINE_WORKERS", None))
        depth = resolve_queue_depth(
            getattr(config, "PIPELINE_QUEUE_DEPTH", None))
        self.workers = workers
        # prod-owned FIFO of all jobs (parse + passthrough) in arrival
        # order — the drain order IS the serial path's processing order
        self._jobs: deque = deque()
        # worker-fed subset: only jobs with work cross this queue
        self._in = BoundedQueue(depth)
        self._draining = False
        self._exec_pool: Optional[ThreadPoolExecutor] = None
        if workers > 1:
            self._exec_pool = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="%s-pipe-exec" % (name or "node"))
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True,
            name="%s-pipe-parse" % (name or "node"))
        self._worker.start()

    # ------------------------------------------------------ submission

    def submit(self, work: Optional[Callable], msg, frm) -> None:
        """Enqueue one inbound message. ``work`` runs on the worker
        (wire parse + pre-screen); None marks a passthrough that the
        drain hands straight to the serial delivery path. Blocks when
        the parse queue is at depth — backpressure, surfaced to the
        admission ladder through the depth gauge."""
        job = PipelineJob(work, msg, frm)
        self._jobs.append(job)
        if work is not None:
            if self._worker.is_alive():
                if self.sanitizer is not None:
                    job.token = HandoffToken(self.sanitizer,
                                             "pipeline parse job")
                    job.token.release("worker")
                self._in.put(job)
            else:
                # dead-worker step-down: parse inline on the submitter
                job.run()
        self._tm.gauge(TM.PIPELINE_QUEUE_DEPTH, len(self._jobs))

    @property
    def depth(self) -> int:
        """Jobs awaiting prod-thread delivery (the backpressure signal
        folded into BACKLOG_DEPTH for the admission ladder)."""
        return len(self._jobs)

    # ----------------------------------------------------------- drain

    def drain(self) -> int:
        """Deliver every queued job on the calling (prod) thread, in
        submission order. Blocking on an unfinished parse is charged to
        the ``queue_wait`` budget stage — handoff latency stays
        attributable instead of smearing into 3PC. Re-entrant calls
        (a delivered job triggering a view-change drain hook) are
        no-ops: the outer drain already owns the queue."""
        if self._draining:
            return 0
        self._draining = True
        delivered = 0
        try:
            while self._jobs:
                job = self._jobs[0]
                if not job.done.is_set():
                    with self.tracer.span("queue_wait", CAT_3PC):
                        while not job.done.wait(0.1):
                            if not self._worker.is_alive():
                                # serial step-down: ownership collapses
                                # back to the single surviving thread —
                                # no handoff left to discipline
                                job.token = None
                                job.run()
                                break
                self._jobs.popleft()
                if job.token is not None:
                    job.token.acquire("prod")
                self._tm.observe(
                    TM.PIPELINE_QUEUE_WAIT_MS,
                    (time.perf_counter() - job.enq_perf) * 1e3)
                self._deliver(job)
                delivered += 1
        finally:
            self._draining = False
        return delivered

    # ------------------------------------------------- execution lanes

    def exec_map(self, fn: Callable, items: List) -> List:
        """Order-preserving map across the execution pool — the
        fan-out seam ``flush_states_merged`` uses for independent
        per-state structural merges. Falls back to an inline loop for
        degenerate sizes or a serial pool."""
        items = list(items)
        if self._exec_pool is None or len(items) <= 1:
            return [fn(x) for x in items]
        self._tm.gauge(TM.PIPELINE_EXEC_QUEUE_DEPTH, len(items))
        try:
            return list(self._exec_pool.map(fn, items))
        finally:
            self._tm.gauge(TM.PIPELINE_EXEC_QUEUE_DEPTH, 0)

    # ------------------------------------------------------- lifecycle

    def stop(self) -> None:
        self._in.put(_STOP)
        self._in.close()
        if self._exec_pool is not None:
            self._exec_pool.shutdown(wait=False)

    # ----------------------------------------------------- worker side

    def _worker_loop(self) -> None:
        if self.sanitizer is not None:
            # this thread IS the worker region for the node's pins
            self.sanitizer.bind_region("worker")
        while True:
            job = self._in.get()
            if job is None or job is _STOP:
                return
            if job.token is not None:
                job.token.acquire("worker")
            t0 = time.perf_counter()
            job.run()               # releases the token back to prod
            self._tm.observe(TM.PIPELINE_PARSE_MS,
                             (time.perf_counter() - t0) * 1e3)
