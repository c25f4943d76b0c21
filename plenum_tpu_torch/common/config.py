"""Framework configuration defaults.

Reference: plenum/config.py (~189 knobs) + stp_core/config.py. Kept as a
simple attribute namespace; override via Config(**overrides) or attribute
assignment (tests use the `tconf` fixture pattern); layered file/env
loading via Config.load (reference plenum/common/config_util.py).

A copy of the JAX package's Config, the device mesh's MESH_* keys
included (ops/mesh.py). Left out: the XLA-only SHA256_CPU_TILE and
SHA256_PALLAS_MIN_BATCH, and the device circuit breaker's
BREAKER_COOLDOWN_S (the port has no step-down from a kernel to the
host), and the SHA256_BACKEND and STATE_DEVICE_ENGINE switches: a node's
ledgers always hash through the SHA-256 kernel above
SHA256_BATCH_THRESHOLD and its states always carry the device engine.
VERIFIER_PROVIDER names the port's providers, and
EXEC_MERGED_DEVICE_HASH = "auto" means the node's device (the card
unless the node was built with device="cpu"). BLS_DEVICE_PAIRING is on, as
in the JAX package: batches of BLS pairing checks at or above
BLS_PAIRING_DEVICE_MIN run on the node's device (csrc/bls381.cu). The
MERKLE_* keys keep the JAX package's values: every ledger of a node
carries a device Merkle tree (ops/merkle.py), and the node hands its own
values of these keys to the tree, its proof pipeline and the catchup
seeder.
"""
import os


class Config:
    # ---- 3PC batching (reference plenum/config.py:253-276)
    Max3PCBatchSize = 1000
    Max3PCBatchWait = 3          # seconds before sending a partial batch
    Max3PCBatchesInFlight = 4
    MAX_BATCHES_IN_QUEUE = 100

    CHK_FREQ = 100               # checkpoint every N batches
    LOG_SIZE = 3 * CHK_FREQ      # watermark window [h, h+LOG_SIZE]

    # ---- columnar 3PC dataflow (server/three_pc_outbox.py +
    # OrderingService.process_*_batch): coalesce every instance's
    # broadcast 3PC votes into one THREE_PC_BATCH wire message per prod
    # tick, and process inbound envelopes through the vectorized
    # columnar intake. Inbound batches are always understood; this knob
    # only gates our own coalesced SENDING. While an adversary tap is
    # installed the outbox degrades to per-message sends regardless.
    THREE_PC_BATCH_WIRE = True
    # flat zero-copy wire codec (common/serializers/flat_wire.py):
    # PREPARE/COMMIT votes travel as contiguous typed columns and
    # PROPAGATE payloads as length-prefixed sections inside ONE
    # FLAT_WIRE envelope per peer per tick — one pack / one parse
    # instead of per-message serializer calls, zero intermediate
    # message objects on the receive path. Inbound flat envelopes are
    # always understood; this knob gates only our own SENDING (the
    # typed THREE_PC_BATCH / PROPAGATE_BATCH path is the validated
    # fallback, and an installed adversary tap degrades to it
    # regardless so fault injection keeps per-message granularity).
    FLAT_WIRE = True
    # micro-batching window for delivery-provoked votes (seconds): a
    # vote provoked outside a prod tick waits at most this long for
    # same-window siblings before the outbox flushes — peer deliveries
    # arrive jittered, and a zero-delay flush would ship every provoked
    # vote as its own wire message (measured: 18 singles / 0 envelopes
    # per 3PC round per node at 25 validators). One spare timer turn of
    # a few ms costs nothing against consensus timeouts.
    THREE_PC_FLUSH_WINDOW = 0.002

    # ---- fused per-3PC-batch device dispatch (server/executor.py):
    # launch the batch's ledger leaf-hash dispatch (SHA-256 seam) and
    # kick any queued verifier-hub generation BEFORE the MPT pending-
    # apply runs, collecting the staged hashes after — one overlapped
    # device window per applied batch instead of serialized round trips
    FUSED_BATCH_DISPATCH = True

    # ---- conflict-lane execution (server/executor.py +
    # server/execution_lanes.py): partition each ordered batch into
    # deterministic execution lanes from the handlers' declared state
    # touches — batched pre-batch read prefetch for every declared read
    # key, one bulk structural trie merge per written state, and ONE
    # merged level-wise SHA3 resolve across all written states per
    # batch. False restores the pre-lane serial apply path (the bench
    # A/B baseline; results are byte-equal either way).
    EXEC_LANES = True
    # batches below this many requests skip lane planning — the plan +
    # prefetch overhead only pays for itself on real batches
    EXEC_LANE_MIN = 8
    # merged-resolve hash routing: "auto" (or True) = levels at or above
    # STATE_DEVICE_HASH_FLOOR go to the node's device; False = hashlib
    EXEC_MERGED_DEVICE_HASH = "auto"

    # ---- propagation
    PROPAGATE_REQUEST_DELAY = 0

    # ---- monitor thresholds (reference plenum/config.py:140-142)
    DELTA = 0.1                  # min master throughput ratio (Δ)
    LAMBDA = 240                 # max master request latency sec (Λ)
    OMEGA = 20                   # max master-vs-backup avg latency gap (Ω)
    SendMonitorStats = False
    ThroughputWindowSize = 15
    ThroughputFirstWindowSize = 450
    ThroughputMinActivityThreshold = 0
    ThroughputInnerWindowSize = 15
    LatencyWindowSize = 30
    MIN_LATENCY_COUNT = 10

    # ---- view change (reference plenum/config.py:197-201, 295)
    ToleratePrimaryDisconnection = 60
    NEW_VIEW_TIMEOUT = 30
    # PBFT-style timeout escalation: each consecutive FAILED view change
    # (NEW_VIEW timeout or mismatch) doubles the next NEW_VIEW wait, up
    # to the cap; any completed view change resets to NEW_VIEW_TIMEOUT.
    # Without this a pool whose view changes keep colliding (partition
    # just healing, slow links) thrashes at the base period forever.
    NEW_VIEW_TIMEOUT_MAX = 480
    VIEW_CHANGE_RESEND_TIMEOUT = 10
    # while waiting_for_new_view: period of the self-heal timer that
    # re-sends our own VIEW_CHANGE and re-requests the missing NEW_VIEW
    # / referenced VIEW_CHANGEs via MessageReq (lossy-wire liveness —
    # without it a lost NEW_VIEW only ever escalates into a vote for
    # the NEXT view, splitting the pool further)
    VIEW_CHANGE_REREQUEST_INTERVAL = 5
    INSTANCE_CHANGE_RESEND_TIMEOUT = 300
    OUTDATED_INSTANCE_CHANGES_CHECK_INTERVAL = 300

    # ---- freshness (reference plenum/config.py STATE_FRESHNESS_UPDATE_INTERVAL)
    UPDATE_STATE_FRESHNESS = True
    STATE_FRESHNESS_UPDATE_INTERVAL = 300
    # stale periods before non-primaries vote a view change (reference
    # ACCEPTABLE_FRESHNESS_INTERVALS_COUNT)
    ACCEPTABLE_FRESHNESS_INTERVALS_COUNT = 3
    # periodic forced view changes (chaos/debug; 0 = disabled)
    ForceViewChangeFreq = 0
    ACCEPTABLE_DEVIATION_PREPREPARE_SECS = 300

    # ---- merkle hashing (TreeHasher device seam, ledger/tree_hasher.py)
    SHA256_BATCH_THRESHOLD = 512  # below this, hashlib wins on latency
    # incremental device tree append (ops/merkle.py): the new parents of
    # this many tree levels per sha256_append_levels launch, so an append
    # of b leaves costs 1 + ceil(levels / K) dispatches, not 1 + levels
    MERKLE_FUSED_LEVELS = 4

    # ---- device merkle proof engine (ops/merkle.py + ledger routing):
    # large reply-proof / catchup-proof batches are served from the
    # device-resident tree; small batches keep the host memo path
    MERKLE_DEVICE_PROOFS = True
    MERKLE_DEVICE_PROOF_MIN = 2048   # below this the host memo path wins
    MERKLE_DEVICE_PROOF_CHUNK = 4096  # pipelined sub-batch size
    MERKLE_DEVICE_PIPELINE_DEPTH = 2  # gathers kept in flight

    # ---- device MPT state engine (state/device_state.py behind
    # PruningState): batched multi-key get / batch apply / batched SPV
    # proof generation with level-wise SHA3 launches (ops/sha3.py).
    # Calls below BATCH_MIN keys keep the host trie path (per-call
    # dispatch latency wins there); inside a batched call, levels with
    # fewer than HASH_FLOOR nodes hash via hashlib (the root level is
    # one node — a device round trip per spine level would dominate).
    STATE_DEVICE_BATCH_MIN = 8
    STATE_DEVICE_HASH_FLOOR = 128

    # decoded-node cache cap per Trie (state/trie.py): ~1-1.5KB per
    # decoded branch node → tens of MB per trie at the cap; large
    # enough to hold a full batch's spine working set
    STATE_DECODE_CACHE_MAX = 1 << 16

    # ---- catchup
    CATCHUP_BATCH_SIZE = 5
    CATCHUP_REP_CHUNK = 1000      # txns per CatchupRep message
    # attach per-txn audit paths to CatchupReps (lets leechers reject a
    # lying chunk at rep time; costs ~2-3x rep wire size — integrity is
    # still guaranteed by the whole-range root replay when off)
    CATCHUP_REP_AUDIT_PATHS = True
    CATCHUP_TXN_TIMEOUT = 6
    CatchupTransactionsTimeout = 6
    MAX_CATCHUP_RETRY = 3
    # leecher retry policy (server/catchup.py): capped exponential
    # backoff from CATCHUP_TXN_TIMEOUT — retry i waits
    # min(base * 2^i, MAX) plus up to JITTER_FRAC of that (deterministic
    # per (ledger, retry) so sim runs replay). Progress (an adopted
    # target or a buffered rep) resets the backoff. A fixed period
    # hammers dead peers and synchronizes the whole pool's re-requests.
    CATCHUP_RETRY_BACKOFF_MAX = 60
    CATCHUP_RETRY_JITTER_FRAC = 0.25

    # ---- transport (reference stp_core/config.py)
    MSG_LEN_LIMIT = 128 * 1024
    MAX_CONNECTED_CLIENTS_NUM = 15360
    ENABLE_HEARTBEATS = True
    HEARTBEAT_FREQ = 5
    RETRY_TIMEOUT_NOT_RESTRICTED = 6
    RETRY_TIMEOUT_RESTRICTED = 15
    MAX_RECONNECT_RETRY_ON_SAME_SOCKET = 1

    # ---- client-signature verification provider (the device seam;
    # crypto/batch_verifier.py): "torch_hub" (one coalescing hub on the
    # node's device), "torch_batch", "cpu" (the scalar RFC 8032 check) or
    # "remote" (the verify daemon at VERIFIER_DAEMON_HOST/PORT,
    # server/verify_daemon.py: one process on the card for every node)
    VERIFIER_PROVIDER = "torch_hub"
    VERIFIER_DAEMON_HOST = "127.0.0.1"
    VERIFIER_DAEMON_PORT = 9988
    # verify-daemon coalescing (server/verify_daemon.py): window seconds
    # a first frame waits for co-resident nodes' frames; device launches
    # are chunked to at most BUCKET items; fused batches below CPU_FLOOR
    # take the scalar RFC 8032 path. The JAX package's floor is 512: its
    # scalar path is OpenSSL. The port's floor of 1 sends every batch to
    # the card; it was set when the port's scalar path was pure Python,
    # slower per signature than a launch of a few hundred. That path now
    # checks the points in C (csrc/ed25519_host.c); chip_smoke.py's
    # deployment phase prints one host verify beside the round trips.
    VERIFY_DAEMON_WINDOW = 0.002
    VERIFY_DAEMON_BUCKET = 4096
    VERIFY_DAEMON_CPU_FLOOR = 1
    # seconds a dispatched client-auth batch may stay in flight before
    # the prod loop harvests it blocking (wedged daemon/device fallback)
    CLIENT_AUTH_TIMEOUT = 10.0

    # ---- gateway tier (plenum_tpu_torch/gateway/): the client-facing front
    # door — device-batched ed25519 pre-screen, admission control and
    # the signed-read cache. GATEWAY_BATCH_MAX bounds one intake
    # batch's fused verify dispatch; the admission ladder degrades
    # READS first when either pressure signal crosses its high-water
    # mark (backlog depth in requests, ordered p99 in ms) and WRITES
    # only past the hard marks; recovery needs BOTH signals back under
    # the low-water marks (hysteresis — a gauge oscillating around one
    # mark must not flap the shed decision per batch).
    GATEWAY_BATCH_MAX = 2048
    GATEWAY_BACKLOG_HIGH = 6000      # shed reads above this backlog
    GATEWAY_BACKLOG_LOW = 4000      # readmit reads below this
    GATEWAY_BACKLOG_HARD = 12000    # shed writes too above this
    GATEWAY_P99_HIGH_MS = 4000.0    # shed reads above this ordered p99
    GATEWAY_P99_LOW_MS = 2000.0     # readmit reads below this
    GATEWAY_P99_HARD_MS = 12000.0   # shed writes too above this
    # signed-read cache: entries carry a BLS-multi-signed state proof;
    # a hit is served only while the proof's multi-sig timestamp is
    # inside the freshness window (seconds) AND the entry's root is
    # still the newest root the cache has observed for its ledger
    GATEWAY_CACHE_MAX = 9216
    GATEWAY_CACHE_FRESH_S = 300.0
    # misbehaving-sender registry: a sender shed after this many
    # structural wire violations (FlatWireError envelopes); bounded
    # registry so client-chosen sender ids cannot grow it unboundedly
    GATEWAY_SENDER_STRIKES = 3
    GATEWAY_SENDER_REGISTRY_MAX = 16384

    # ---- pipeline runtime (plenum_tpu_torch/runtime/pipeline.py): wire
    # parse + ed25519 pre-screen on worker threads feeding the prod
    # thread via bounded SPSC queues; execution fan-out across the same
    # pool. The prod thread keeps sole ownership of all consensus
    # state; the serial path stays the validated fallback (step-down
    # philosophy). PIPELINE_WORKERS is the SINGLE sizing knob (PT005):
    # None = auto (cores−1, capped at 4) for the node pipeline, while
    # the verify daemon resolves the same knob with a fallback of 1 —
    # its serialize-by-one coalescing floor — unless set explicitly.
    # PIPELINE_QUEUE_DEPTH bounds the parse queue; a full queue blocks
    # intake (backpressure that folds into the BACKLOG_DEPTH gauge the
    # gateway admission ladder sheds on).
    PIPELINE_ENABLED = False
    PIPELINE_WORKERS = None
    PIPELINE_QUEUE_DEPTH = 256

    # runtime ownership sanitizer (runtime/sanitizer.py): region pins
    # on consensus-critical objects + handoff tokens at the pipeline
    # queues — the runtime twin of plenum-lint PT016/PT017. Tri-state:
    # True/False win outright; None defers to PLENUM_TPU_SANITIZE=1
    # (the sim-pool test fixtures' suite-wide switch). Default off in
    # production: the checks are cheap (a dict lookup per guarded
    # seam, gated <2% by the sanitizer_overhead bench) but the point
    # is debugging, not defense in depth.
    SANITIZER_ENABLED = None

    # ---- quotas per prod tick (reference stp_core/config.py:29+,
    # plenum/server/quota_control.py)
    NODE_TO_NODE_STACK_QUOTA = 1024
    NODE_TO_NODE_STACK_SIZE = 1024 * 1024
    CLIENT_TO_NODE_STACK_QUOTA = 100
    CLIENT_TO_NODE_STACK_SIZE = 1024 * 1024
    EnsureListenerQuota = True
    MAX_REQUEST_QUEUE_SIZE = 10000

    # ---- replicas
    REPLICAS_REMOVING_WITH_DEGRADATION = "local"
    REPLICAS_REMOVING_WITH_PRIMARY_DISCONNECTED = "local"

    # ---- metrics / validator info (reference plenum/config.py
    # METRICS_COLLECTOR_TYPE + DUMP_VALIDATOR_INFO_PERIOD_SEC)
    METRICS_FLUSH_INTERVAL = 10          # seconds between KV flushes
    VALIDATOR_INFO_DUMP_INTERVAL = 60    # seconds between JSON dumps
    # logging (reference stp_core/config.py:9-17): per-node rotating
    # log file, gzip-compressed rotated segments (utils/log.py)
    LOG_LEVEL = 20                       # logging.INFO; TRACE=5
    LOG_FORMAT = None                    # None = utils.log.DEFAULT_FORMAT
    LOG_MAX_BYTES = 50 * 1024 * 1024
    LOG_BACKUP_COUNT = 10

    # ---- TAA acceptance time window (reference plenum/config.py
    # TXN_AUTHOR_AGREEMENT_ACCEPTANCE_TIME_{BEFORE_TAA,AFTER_PP}_TIME)
    TAA_ACCEPTANCE_TIME_BEFORE_TAA = 120
    TAA_ACCEPTANCE_TIME_AFTER_PP_TIME = 120

    # ---- blacklisting: auto-blacklist on (attributable) suspicions is
    # OFF by default, matching the reference (node.py:2883 "TODO:
    # Consider blacklisting nodes again"); suspicions are always logged
    BLACKLIST_ON_SUSPICION = False

    # ---- request-handler caches (server/request_handlers.py): NYM
    # record lookups memoized per uncommitted view; bounded because
    # identifiers are client-chosen (attacker-controlled allocation)
    NYM_CACHE_MAX = 4096

    # ---- storage
    domainStateStorage = "memory"
    poolStateStorage = "memory"
    configStateStorage = "memory"
    reqIdToTxnStorage = "memory"
    nodeStatusStorage = "memory"

    # ---- BLS (networked nodes derive the signer from the transport
    # seed; False skips BLS share generation/aggregation entirely)
    BLS_SIGN = True
    # Optimistic batch verification of commit shares: COMMIT arrival
    # does only cheap share decoding; ordering verifies the AGGREGATE
    # once (2 pairings per batch instead of one pairing per share) and
    # falls back to per-share checks to assign blame if the aggregate
    # fails. False restores the reference's verify-each-share-on-
    # arrival behavior (a bad share then rejects that COMMIT message).
    BLS_DEFER_SHARE_VERIFY = True

    # ---- TPU crypto dispatch (new — the north-star gated boundary)
    # provider: 'cpu' (scalar C path via `cryptography`) or 'tpu_batch'
    # (JAX batched kernels). 'auto' picks by queue depth.
    ED25519_PROVIDER = "auto"
    ED25519_TPU_MIN_BATCH = 64   # below this the CPU scalar path wins
    SHA256_PROVIDER = "auto"
    SHA256_TPU_MIN_BATCH = 256
    BLS_PROVIDER = "cpu"

    # ---- device BLS12-381 pairing / MSM (crypto/bls_ops routes batches
    # of pairing-product checks by these values, which the node passes
    # down with its device): a batch at or above the minimum runs as one
    # launch of csrc/bls381.cu's kernels, a smaller one on the host (the
    # native scalar path with prepared Miller lines).
    BLS_DEVICE_PAIRING = True
    BLS_PAIRING_DEVICE_MIN = 4
    BLS_MSM_DEVICE_MIN = 8       # Σ sᵢ·Pᵢ points below this stay host

    # batch size at which AdaptiveVerifier / CoalescingVerifierHub leave
    # the scalar CPU floor for a device launch (single-sourced here,
    # like the MERKLE_DEVICE_* knobs)
    VERIFIER_BATCH_THRESHOLD = 32

    # ---- device-mesh dispatch (ops/mesh.py): shard verify / BLS /
    # Merkle / trie batches over every device on the batch axis (the
    # seams are row-wise pure). One device and batches below
    # MESH_SHARD_MIN take the passthrough path.
    MESH_ENABLED = True
    MESH_MAX_DEVICES = 0         # 0 = all devices (rounded down to 2^k)
    MESH_SHARD_MIN = 2048        # below this one device wins on latency
    # shard over CPU devices too: CPU entries of a device list share the
    # same cores, so production keeps this off; tests force it (env
    # PLENUM_TPU_MESH_CPU_SHARD=1 or configure(cpu_shard=True)) to reach
    # the sharded paths without a card
    MESH_CPU_SHARD = False

    # ---- recovery SLOs (sim-time seconds; bench.py `recovery` config
    # and the soak scenarios gate on these): primary crash → ordering
    # resumes on every honest node; lagging node under adversarial
    # seeding completes catchup. Violations auto-dump a flight-recorder
    # timeline with the measured latency in the filename.
    RECOVERY_FAILOVER_SLO_S = 40.0
    RECOVERY_CATCHUP_SLO_S = 60.0

    # ---- metrics
    METRICS_COLLECTOR_TYPE = None

    # ---- flight recorder (observability/): per-node span tracing of
    # the batch lifecycle + device-dispatch seams, exportable as a
    # Perfetto timeline (scripts/trace_view). Off by default; enabled
    # cost is bench-gated to low single-digit percent on the ordering
    # hot path (bench.py tracing_overhead).
    TRACING_ENABLED = False
    TRACING_BUFFER_SPANS = 1 << 16   # ring slots per node; newest kept

    # ---- journey plane (observability/journey.py): wire-carried trace
    # context. When on, flat envelopes ride as version 2 with an
    # advisory TRACE section (origin node, flush seq, perf+wall send
    # timestamps; ≤89 payload bytes) and the typed THREE_PC_BATCH /
    # PROPAGATE_BATCH fallback carries the same stamp in a nullable
    # traceCtx field, so receivers can join per-node tracer buffers
    # into per-request cross-node journeys. Purely advisory: stamps are
    # decoded outside the consensus sections (plenum-lint PT015 pins
    # unreachability), malformed stamps degrade to None without
    # touching message handling, and bench.py trace_context_overhead
    # hard-gates the on/off A/B under 2%. Follows TRACING_ENABLED —
    # stamps without tracer buffers join nothing.
    TRACE_CONTEXT_ENABLED = True

    # ---- telemetry plane (observability/telemetry.py): always-on
    # latency histograms (p50/p95/p99/p999 on the ordered money path),
    # device-efficiency lane accounting at every bucket-padding
    # dispatch seam, and pool-health gauges. ON by default — bench.py
    # telemetry_overhead A/Bs the identical pool with it off and gates
    # the cost under 2% (BENCH_TELEMETRY_GATE).
    TELEMETRY_ENABLED = True
    TELEMETRY_FLUSH_INTERVAL_S = 10   # gauge sample + prom write period
    # directory for per-node Prometheus text exposition files
    # (<dir>/<node>.prom, rewritten atomically per flush); None = none
    TELEMETRY_PROM_DIR = None
    # log-linear histogram shape: `sub` linear sub-buckets per
    # power-of-two octave bounds quantile relative error to 1/sub
    # (6.25% at 16); 30 octaves from 1 µs cover ~18 minutes
    TELEMETRY_HIST_LO_MS = 0.001
    TELEMETRY_HIST_OCTAVES = 30
    TELEMETRY_HIST_SUB_BUCKETS = 16
    # intake-timestamp map cap: e2e latency tracking stops (and counts
    # TM.E2E_DROPPED) past this many in-flight requests
    TELEMETRY_PENDING_MAX = 1 << 17
    # flush-history ring (Perfetto counter tracks) + per-seam distinct
    # bucket-shape set cap (compile-event accounting)
    TELEMETRY_FLUSH_HISTORY = 512
    TELEMETRY_SHAPE_CAP = 4096

    # ---- plugins (reference plenum/config.py:164
    # notifierEventTriggeringConfig + SpikeEventsEnabled; plugin dirs
    # from plenum/server/plugin_loader.py usage)
    NOTIFIER_EVENTS_ENABLED = True
    SPIKE_EVENTS_ENABLED = False      # reference default: off
    SPIKE_EVENTS_FREQ = 60            # seconds between spike samples
    SPIKE_EVENT_TRIGGERING = {
        "NodeRequestSuspiciousSpike": {
            "bounds_coeff": 10, "min_cnt": 15,
            "min_activity_threshold": 10,
            "use_weighted_bounds_coeff": True, "enabled": True},
        "ClusterThroughputSuspiciousSpike": {
            "bounds_coeff": 10, "min_cnt": 15,
            "min_activity_threshold": 10,
            "use_weighted_bounds_coeff": True, "enabled": True},
    }
    NOTIFIER_PLUGINS_DIR = None       # dir of notifier*.py/plugin*.py
    PLUGINS_DIR = None                # dir of typed plugin*.py classes

    # ---- TAA
    TXN_AUTHOR_AGREEMENT_EXPIRATION = None

    def __init__(self, **overrides):
        for k, v in overrides.items():
            setattr(self, k, v)

    # ------------------------------------------------ layered loading

    @classmethod
    def load(cls, base_dir: str = None, env: dict = None,
             **overrides) -> "Config":
        """Layered config (reference plenum/common/config_util.py
        getConfig: package defaults ← /etc ← user dir ← env):

            1. class defaults
            2. `plenum_tpu_config.py` in base_dir (exec'd; UPPERCASE and
               known keys become attributes)
            3. PLENUM_TPU_<KEY>=value environment overrides (parsed as
               Python literals, falling back to raw strings)
            4. explicit **overrides (strongest)
        """
        import ast
        conf = cls()
        known = {k for k in dir(cls)
                 if not k.startswith("_") and not callable(getattr(cls, k))}
        explicit = set()
        if base_dir:
            path = os.path.join(base_dir, "plenum_tpu_config.py")
            if os.path.exists(path):
                # ONE namespace: separate globals/locals would break
                # top-level references from genexps/functions
                ns = {}
                with open(path) as f:
                    exec(compile(f.read(), path, "exec"), ns)
                for k, v in ns.items():
                    if k != "__builtins__" and (k in known or k.isupper()):
                        setattr(conf, k, v)
                        explicit.add(k)
        env = os.environ if env is None else env
        for k in known:
            raw = env.get("PLENUM_TPU_" + k.upper())
            if raw is None:
                continue
            setattr(conf, k, cls._parse_env(k, raw))
            explicit.add(k)
        for k, v in overrides.items():
            setattr(conf, k, v)
            explicit.add(k)
        # derived invariant: the checkpoint window must fit the log
        # window or 3PC stalls (no checkpoint ever stabilizes). If the
        # operator moved CHK_FREQ without touching LOG_SIZE, re-derive
        # the usual 3x relation; an explicit inconsistent pair is an
        # error, not a silent stall.
        if "CHK_FREQ" in explicit and "LOG_SIZE" not in explicit:
            conf.LOG_SIZE = 3 * conf.CHK_FREQ
        if conf.LOG_SIZE < conf.CHK_FREQ:
            raise ValueError(
                "LOG_SIZE ({}) must be >= CHK_FREQ ({}) or no checkpoint "
                "can ever stabilize".format(conf.LOG_SIZE, conf.CHK_FREQ))
        return conf

    @staticmethod
    def _parse_env(key: str, raw: str):
        """Literal if possible; common booleans; otherwise raw ONLY for
        string-typed knobs — a typo'd number must fail loudly, not ride
        along as a truthy string."""
        import ast
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            pass
        low = raw.strip().lower()
        if low in ("true", "yes", "on"):
            return True
        if low in ("false", "no", "off"):
            return False
        default = getattr(Config, key, None)
        if default is None or isinstance(default, str):
            return raw
        raise ValueError(
            "cannot parse PLENUM_TPU_{}={!r} as a {}".format(
                key.upper(), raw, type(default).__name__))


def getConfig(**overrides) -> Config:
    return Config(**overrides)
