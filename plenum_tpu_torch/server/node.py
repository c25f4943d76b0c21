"""Node — the consensus-node orchestrator.

Reference: plenum/server/node.py:129 (3,242 LoC god object) — rebuilt lean:
storage bootstrap (NodeBootstrap, node_bootstrap.py:17), client request
intake (processRequest :2000), propagation (processPropagate :2099),
execution (executeBatch :2661 via NodeBatchExecutor), and replies.

The node speaks to peers through ONE ExternalBus (SimNetwork in tests, a
socket transport in deployment) and to clients through a reply callback —
no sockets in this class, so the whole node is deterministic under
MockTimer (SURVEY.md §4 rung 3 without processes).

Client write path (SURVEY.md §3.3): REQUEST → authenticate (TPU-batched
ed25519 via CoreAuthNr) → PROPAGATE → quorum f+1 finalise → ordering
queues → 3PC → Ordered → commit (ledger merkle append + MPT commit +
audit txn) → Reply{txn + audit path} to client.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, BLS_KEY, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID, GET_TXN,
    NODE, NYM, POOL_LEDGER_ID, VERKEY)
from plenum_tpu_torch.common.exceptions import InvalidClientMessageException
from plenum_tpu_torch.common.messages.client_request import ClientMessageValidator
from plenum_tpu_torch.common.messages.message_factory import node_message_factory
from plenum_tpu_torch.common.messages.node_messages import (
    Commit, FlatBatch, Ordered, Prepare, PrePrepare, Propagate,
    PropagateBatch, Reject, Reply, RequestAck, RequestNack, ThreePCBatch)
from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import (
    get_payload_data, get_seq_no, get_txn_time)
from plenum_tpu_torch.consensus.ordering_service import Suspicions
from plenum_tpu_torch.consensus.replica_service import ReplicaService
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.runtime.timer import TimerService
from plenum_tpu_torch.server.batch_handlers import (
    AuditBatchHandler, ConfigBatchHandler, DomainBatchHandler,
    PoolBatchHandler, TsStoreBatchHandler)
from plenum_tpu_torch.server.client_authn import CoreAuthNr, ReqAuthenticator
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.executor import NodeBatchExecutor
from plenum_tpu_torch.server.propagator import Propagator
from plenum_tpu_torch.server.request_handlers import (
    GetNymHandler, GetTxnHandler, NodeHandler, NymHandler,
    decode_state_value, nym_to_state_key)
from plenum_tpu_torch.server.write_request_manager import (
    ActionRequestManager, ReadRequestManager, WriteRequestManager)
from plenum_tpu_torch.ops import resolve_device
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
from plenum_tpu_torch.observability.tracing import (
    CAT_3PC, CAT_DEVICE, CAT_INTAKE, CAT_PROPAGATE, CAT_RECOVERY,
    CAT_REPLY, NullTracer, Tracer)
from plenum_tpu_torch.observability.telemetry import (
    TM, NullTelemetryHub, TelemetryHub, get_seam_hub)
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector

logger = logging.getLogger(__name__)

_fp = try_load_host_ext("fastpath")


class NodeBootstrap:
    """Storage + handler registry init (reference node_bootstrap.py:17)."""

    @staticmethod
    def make_tree_hasher(config: Optional[Config] = None, device=None):
        """TreeHasher wired to the SHA-256 kernel (ops/sha256.py) on
        `device` (None means CUDA) above the config threshold; hashlib
        handles the scalar floor."""
        from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
        from plenum_tpu_torch.ops.sha256 import TorchSha256Backend
        config = config or Config()
        return TreeHasher(batch_backend=TorchSha256Backend(device),
                          batch_threshold=config.SHA256_BATCH_THRESHOLD)

    @staticmethod
    def init_storage(storage_factory=None,
                     config: Optional[Config] = None,
                     device=None) -> DatabaseManager:
        """`device` (None means CUDA) serves the ledgers' SHA-256 and the
        state engines' SHA3-256 kernels."""
        make_kv = storage_factory or (lambda name: KeyValueStorageInMemory())
        conf = config or Config()
        dm = DatabaseManager()
        for lid, name in ((POOL_LEDGER_ID, "pool"),
                          (DOMAIN_LEDGER_ID, "domain"),
                          (CONFIG_LEDGER_ID, "config"),
                          (AUDIT_LEDGER_ID, "audit")):
            ledger = Ledger(txn_store=make_kv(name + "_ledger"),
                            tree_hasher=NodeBootstrap.make_tree_hasher(
                                config, device))
            if conf.MERKLE_DEVICE_PROOFS:
                # large reply/catchup proof batches route to the
                # device-resident tree; below MERKLE_DEVICE_PROOF_MIN the
                # host memo path keeps winning and nothing changes. The
                # tree takes this node's values (the JAX package's reads
                # MERKLE_FUSED_LEVELS and its pipeline's default chunk
                # from the Config class; ROADMAP C).
                ledger.tree.attach_device_engine(
                    proof_min=conf.MERKLE_DEVICE_PROOF_MIN,
                    chunk=conf.MERKLE_DEVICE_PROOF_CHUNK,
                    pipeline_depth=conf.MERKLE_DEVICE_PIPELINE_DEPTH,
                    fused_levels=conf.MERKLE_FUSED_LEVELS,
                    warm=True, device=device)  # recovered ledgers sync now
            state = None
            if lid != AUDIT_LEDGER_ID:
                state = PruningState(make_kv(name + "_state"))
                # batched multi-key gets, whole-batch applies and N-key
                # proof generation route to the device MPT engine; below
                # STATE_DEVICE_BATCH_MIN the host trie keeps winning and
                # nothing changes. Warm once (the SHA3 library is
                # process-wide) so the first serving batch skips the
                # build. The hash floor is this node's config (the JAX
                # package reads the class default; ROADMAP C).
                state.attach_device_engine(
                    batch_min=conf.STATE_DEVICE_BATCH_MIN,
                    warm=(lid == DOMAIN_LEDGER_ID), device=device,
                    hash_floor=conf.STATE_DEVICE_HASH_FLOOR)
            dm.register_new_database(lid, ledger, state,
                                     taa_acceptance_required=(
                                         lid == DOMAIN_LEDGER_ID))
        from plenum_tpu_torch.storage.state_ts_store import StateTsStore
        dm.register_new_store("state_ts", StateTsStore(make_kv("state_ts")))
        return dm

    @staticmethod
    def init_managers(dm: DatabaseManager, config: Optional[Config] = None
                      ) -> Tuple[WriteRequestManager, ReadRequestManager]:
        from plenum_tpu_torch.server.taa_handlers import (
            GetTxnAuthorAgreementAmlHandler, GetTxnAuthorAgreementHandler,
            TaaAcceptanceValidator, TxnAuthorAgreementAmlHandler,
            TxnAuthorAgreementDisableHandler, TxnAuthorAgreementHandler)
        wm = WriteRequestManager(dm)
        wm.register_req_handler(NymHandler(dm))
        wm.register_req_handler(NodeHandler(dm))
        from plenum_tpu_torch.server.freeze_handlers import (
            GetFrozenLedgersHandler, LedgersFreezeHandler)
        wm.register_req_handler(TxnAuthorAgreementHandler(dm))
        wm.register_req_handler(TxnAuthorAgreementAmlHandler(dm))
        wm.register_req_handler(TxnAuthorAgreementDisableHandler(dm))
        wm.register_req_handler(LedgersFreezeHandler(dm))
        wm.taa_validator = TaaAcceptanceValidator(dm, config or Config())
        wm.register_batch_handler(PoolBatchHandler(dm))
        wm.register_batch_handler(DomainBatchHandler(dm))
        wm.register_batch_handler(ConfigBatchHandler(dm))
        wm.register_batch_handler(TsStoreBatchHandler(dm))
        wm.register_batch_handler(AuditBatchHandler(dm))
        rm = ReadRequestManager()
        rm.register_req_handler(GetTxnHandler(dm))
        rm.register_req_handler(GetNymHandler(dm))
        rm.register_req_handler(GetTxnAuthorAgreementHandler(dm))
        rm.register_req_handler(GetTxnAuthorAgreementAmlHandler(dm))
        rm.register_req_handler(GetFrozenLedgersHandler(dm))
        return wm, rm


class Node:
    def __init__(self, name: str, validators: List[str],
                 timer: TimerService, network,
                 config: Optional[Config] = None,
                 storage_factory=None,
                 client_reply_handler: Callable[[str, object], None] = None,
                 bls_bft_replica=None, bls_signer=None,
                 genesis_txns: Optional[List[dict]] = None,
                 on_membership_change: Callable[[List[str]], None] = None,
                 metrics=None, tracer=None, device=None):
        """network: ExternalBus to peers; client_reply_handler(client_id,
        msg) delivers Acks/Nacks/Replies back to clients. `device` serves
        every kernel of the node (signature verify, SHA-256 leaves, SHA3
        state levels, BLS pairing checks): None means CUDA and raises when there is no card;
        "cpu" runs the kernels' plain PyTorch versions."""
        from plenum_tpu_torch.server.observer import Observable
        self.device = resolve_device(device)
        self.name = name
        self.config = config or Config()
        self.metrics = metrics or NullMetricsCollector()
        # flight recorder (observability/): one ring-buffer tracer per
        # node, injected into every instrumented stage below so a 3PC
        # batch's whole lifecycle lands in one per-node buffer that the
        # sim pool / trace_view merges into a pool-wide timeline
        if tracer is None:
            tracer = Tracer(name=name,
                            capacity=self.config.TRACING_BUFFER_SPANS) \
                if self.config.TRACING_ENABLED else NullTracer(name)
        self.tracer = tracer
        # always-on telemetry plane (observability/telemetry.py): one
        # hub per node — latency histograms on the ordered money path,
        # pool-health gauges, recovery counters. Device-seam lane
        # accounting lands in the process-wide seam hub instead (the
        # seams are shared across co-resident nodes, like the mesh).
        self.telemetry = TelemetryHub(name=name) \
            if getattr(self.config, "TELEMETRY_ENABLED", True) \
            else NullTelemetryHub(name)
        # digest → intake-accept perf_counter: start marks for the
        # intake→reply latency histogram (popped at commit/reject/GC;
        # capped by TELEMETRY_PENDING_MAX)
        self._tm_intake_ts: Dict[str, float] = {}
        # GC pause/throughput feed (reference gc_trackers.py): one
        # process-wide hook, weakly attached — only worth the callback
        # when a real collector will persist it
        if metrics is not None:
            from plenum_tpu_torch.utils.gc_tracker import GcTimeTracker
            GcTimeTracker.instance().attach(self.metrics)
        self.observable = Observable()
        self.timer = timer
        self.network = network
        self._reply_to_client = client_reply_handler or (lambda c, m: None)
        # without a client transport there is nobody to reply to — skip
        # building Reply payloads (txn + b58 audit path) entirely
        self._clients_attached = client_reply_handler is not None

        # ---- storage + execution pipeline
        self.db_manager = NodeBootstrap.init_storage(storage_factory,
                                                     self.config, self.device)
        self.write_manager, self.read_manager = \
            NodeBootstrap.init_managers(self.db_manager, self.config)
        self.action_manager = ActionRequestManager()

        # ---- genesis (skipped on restart: the persisted ledgers already
        # contain it) — must precede membership derivation, which reads
        # the pool ledger
        if genesis_txns and all(
                self.db_manager.get_ledger(lid).size == 0
                for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID,
                            CONFIG_LEDGER_ID)):
            self._load_genesis(genesis_txns)

        # ---- live pool membership (reference TxnPoolManager): the ctor
        # list seeds the registry; committed NODE txns evolve it
        from plenum_tpu_torch.server.pool_manager import TxnPoolManager
        self.pool_manager = TxnPoolManager(
            validators, self.db_manager,
            on_change=self._on_validators_changed)
        self._on_membership_change = on_membership_change
        validators = self.pool_manager.validators
        # ctor-seeded validators have no pool-state NODE record; their
        # aliases are reserved so a steward cannot hijack them
        node_handler = self.write_manager.request_handlers.get(NODE)
        if node_handler is not None:
            node_handler.reserved_aliases = \
                lambda: self.pool_manager.seed_aliases

        # ---- client authentication (TPU-batched seam); the provider is
        # config-selected: in-process device batching by default, or the
        # host verify daemon in multi-process deployments
        provider = getattr(self.config, "VERIFIER_PROVIDER", "torch_hub")
        verifier = None
        if provider:
            from plenum_tpu_torch.crypto.batch_verifier import create_verifier
            kwargs = {}
            if provider == "remote":
                kwargs["addr"] = (self.config.VERIFIER_DAEMON_HOST,
                                  self.config.VERIFIER_DAEMON_PORT)
            elif provider in ("torch_batch", "torch_hub"):
                kwargs["device"] = self.device
            if provider == "torch_hub":
                kwargs["threshold"] = getattr(
                    self.config, "VERIFIER_BATCH_THRESHOLD", None)
            verifier = create_verifier(provider, **kwargs)
        # apply this node's MESH_* keys to the process-wide device-mesh
        # dispatcher (ops/mesh.py) that the verify, BLS, Merkle and trie
        # seams consult; this probes no device
        from plenum_tpu_torch.ops import mesh as _mesh_mod
        _mesh_mod.configure_from(self.config)
        self.authnr = CoreAuthNr(
            verkey_provider=self._verkey_from_domain_state,
            verifier=verifier)
        self.req_authenticator = ReqAuthenticator()
        self.req_authenticator.register_authenticator(self.authnr)

        # digest → pp_seq_no of the speculative batch that rejected it;
        # freed once that batch is at or below a stable checkpoint
        self._rejected_digests: Dict[str, int] = {}
        # ---- dedup index: payload_digest → (ledger_id, seqNo); rides the
        # same storage factory as the ledgers so it survives restarts
        # (reference loadSeqNoDB node.py:698)
        make_kv = storage_factory or (
            lambda _name: KeyValueStorageInMemory())
        self.seq_no_db = make_kv("seq_no_db")
        # node status DB: non-ledger runtime state that must survive a
        # restart — currently the backup primary's last sent PrePrepare
        # (reference nodeStatusDB, node.py loadNodeStatusDB)
        self.node_status_db = make_kv("node_status_db")
        from plenum_tpu_torch.server.last_sent_pp_store import LastSentPpStoreHelper
        self.last_sent_pp_store = LastSentPpStoreHelper(self.node_status_db)
        # digest → client id awaiting reply
        self._req_clients: Dict[str, str] = {}

        # ---- consensus replica (master instance)
        from plenum_tpu_torch.consensus.primary_selector import (
            RoundRobinConstantNodesPrimariesSelector)
        self._primary_selector = RoundRobinConstantNodesPrimariesSelector(
            validators)
        self.executor = NodeBatchExecutor(
            self.write_manager,
            requests_source=self._get_finalised_request,
            get_view_no=lambda: self.replica.view_no,
            primaries_for_view=self._primaries_for_batch,
            get_pp_seq_no=lambda:
                self.replica.ordering._last_applied_seq + 1,
            on_batch_committed=self._on_batch_committed,
            on_request_rejected=self._on_request_rejected,
            fused_dispatch=getattr(self.config, "FUSED_BATCH_DISPATCH",
                                   True),
            # the authnr's verifier may have a whole intake generation
            # queued — flush it into the fused window so the device
            # verifies while the host applies
            device_kick=lambda: self.authnr.flush(),
            # conflict-lane execution (docs/execution.md): declared-key
            # lane planning + batched read prefetch + merged hash
            # resolution per applied batch
            lanes=getattr(self.config, "EXEC_LANES", True),
            lane_min=getattr(self.config, "EXEC_LANE_MIN", None),
            merged_device_hash=getattr(self.config,
                                       "EXEC_MERGED_DEVICE_HASH", "auto"))
        # ---- freshness: stale ledgers get empty batches so BLS-signed
        # state roots never age past the timeout (reference
        # replica_freshness_checker.py)
        from plenum_tpu_torch.consensus.freshness_checker import FreshnessChecker
        self.freshness_checker = None
        if (self.config.UPDATE_STATE_FRESHNESS
                and self.config.STATE_FRESHNESS_UPDATE_INTERVAL > 0):
            self.freshness_checker = FreshnessChecker(
                self.config.STATE_FRESHNESS_UPDATE_INTERVAL)
            for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID):
                self.freshness_checker.register_ledger(
                    lid, timer.get_current_time())

        # ---- BLS: a signer is enough to stand up the full BLS-BFT seam
        # (keys of peers come from pool-ledger NODE txns via the pool
        # manager; the aggregated multi-sigs land in a persistent store
        # that read handlers attach to state proofs)
        if bls_bft_replica is None and bls_signer is not None:
            from plenum_tpu_torch.consensus.bls_bft_replica import (
                BlsBftReplica, BlsKeyRegister, BlsStore)
            from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
            pool_state = self.db_manager.get_state(POOL_LEDGER_ID)
            # the batch seams route by this node's config (the JAX
            # package's bls_ops reads the Config class; ROADMAP C)
            verifier = BlsCryptoVerifierPlenum(
                device_pairing=self.config.BLS_DEVICE_PAIRING,
                pairing_device_min=self.config.BLS_PAIRING_DEVICE_MIN,
                device=self.device)
            bls_bft_replica = BlsBftReplica(
                name, bls_signer, verifier,
                BlsKeyRegister(lambda n: (self.pool_manager.node_info(n)
                                          or {}).get(BLS_KEY)),
                bls_store=BlsStore(make_kv("bls_store")),
                get_pool_root=lambda: pool_state.committedHeadHash_b58
                if pool_state is not None else "",
                defer_share_verify=getattr(
                    self.config, "BLS_DEFER_SHARE_VERIFY", True))
        self.bls_bft_replica = bls_bft_replica
        if bls_bft_replica is not None:
            self.db_manager.bls_store = bls_bft_replica.bls_store
            # pay the key-dependent verifier setup now (subgroup checks,
            # prepared pairings), not on the first state-proof verify
            bls_bft_replica.warm_pool_keys(validators)

        self.replica = ReplicaService(
            name, validators, timer, network, executor=self.executor,
            config=self.config, bls_bft_replica=bls_bft_replica,
            checkpoint_digest_source=self._audit_root_at,
            freshness_checker=self.freshness_checker,
            # IC votes persist to nodeStatusDB (reference
            # instance_change_provider): restart keeps fresh votes
            vc_vote_store=self.node_status_db)

        # ---- RBFT redundant instances: f backups benchmark the master
        from plenum_tpu_torch.server.replicas import (
            BackupInstanceFaultyProcessor, Replicas)
        self.replicas = Replicas(
            name, validators, timer, network, master=self.replica,
            config=self.config,
            on_backup_ordered=self._on_backup_ordered,
            on_backup_pp_sent=self.last_sent_pp_store.store_last_sent)

        # ---- columnar 3PC wire path: every instance's broadcast votes
        # coalesce into ONE THREE_PC_BATCH per tick (flushed at the end
        # of service()); inbound envelopes route into the columnar
        # process_*_batch intake per instance. Incoming batches are
        # always understood (peers may coalesce regardless of our own
        # sending config).
        from plenum_tpu_torch.server.three_pc_outbox import ThreePCOutbox
        self._outbox_3pc = None
        self._outbox_flush_armed = False
        flat_wire_on = getattr(self.config, "FLAT_WIRE", True)
        if getattr(self.config, "THREE_PC_BATCH_WIRE", True):
            self._outbox_3pc = ThreePCOutbox(
                network, msg_len_limit=self.config.MSG_LEN_LIMIT,
                flat_wire_enabled=flat_wire_on)
            self.replicas.set_outbox(self._outbox_3pc)
        network.subscribe(ThreePCBatch, self._process_three_pc_batch)
        # flat zero-copy envelopes are always understood, whatever our
        # own sending config (peers choose their wire independently)
        network.subscribe(FlatBatch, self._process_flat_batch)

        # ---- propagation
        # gate for peer-relayed requests (client-intake requests were
        # authenticated at intake): a node must not vote for content
        # whose client signature it cannot verify. Deliberately a LOCAL
        # verifier, not self.authnr's configured provider — a remote or
        # device-batched provider would block (or deadlock) the prod
        # loop for what is a low-volume synchronous check.
        from plenum_tpu_torch.crypto.batch_verifier import ScalarVerifier
        propagate_authnr = CoreAuthNr(
            verkey_provider=self._verkey_from_domain_state,
            verifier=ScalarVerifier())

        def authenticate_propagated(request) -> bool:
            try:
                propagate_authnr.authenticate(request)
                return True
            except Exception:
                return False

        self.propagator = Propagator(
            name, self.replica.data.quorums, network,
            forward_handler=self._forward_finalised,
            authenticator=authenticate_propagated,
            forward_batch_handler=self._forward_finalised_batch,
            flat_wire_enabled=flat_wire_on)
        network.subscribe(Propagate, self.propagator.process_propagate)
        network.subscribe(PropagateBatch,
                          self.propagator.process_propagate_batch)

        self._validator = ClientMessageValidator()

        # ---- plugin seams: notifier event push + typed plugins
        # (reference notifier_plugin_manager.py:24, plugin_loader.py:25)
        from plenum_tpu_torch.server.plugins import (
            PLUGIN_TYPE_STATS_CONSUMER, PLUGIN_TYPE_VERIFICATION,
            NotifierPluginManager, PluginLoader)
        self.notifier = NotifierPluginManager(
            node_name=name,
            enabled=self.config.NOTIFIER_EVENTS_ENABLED,
            spike_configs=self.config.SPIKE_EVENT_TRIGGERING
            if self.config.SPIKE_EVENTS_ENABLED else None)
        if self.config.NOTIFIER_PLUGINS_DIR:
            self.notifier.load_from_dir(self.config.NOTIFIER_PLUGINS_DIR)
        self.plugin_loader = None
        self._verification_plugins: List = []
        self._stats_plugins: List = []
        if self.config.PLUGINS_DIR:
            self.plugin_loader = PluginLoader(self.config.PLUGINS_DIR)
            self._verification_plugins = self.plugin_loader.get(
                PLUGIN_TYPE_VERIFICATION)
            self._stats_plugins = self.plugin_loader.get(
                PLUGIN_TYPE_STATS_CONSUMER)
        self._request_spike_accum = 0

        # ---- performance + primary-connection monitoring
        from plenum_tpu_torch.common.messages.internal_messages import (
            NewViewAccepted, VoteForViewChange)
        from plenum_tpu_torch.runtime.timer import RepeatingTimer
        from plenum_tpu_torch.server.monitor import (
            Monitor, PrimaryConnectionMonitorService)
        self.monitor = Monitor(name, timer, self.replica.internal_bus,
                               config=self.config)
        # one collector, injected into every instrumented stage so the
        # per-stage breakdown (scripts/metrics_stats) covers the whole
        # money path with a single flush point
        for _staged in (self.propagator, self.executor, self.monitor,
                        self.replica.ordering, bls_bft_replica,
                        self.write_manager,
                        getattr(self.replica, "view_changer", None),
                        getattr(self.replica, "vc_trigger", None)):
            if _staged is not None:
                _staged.metrics = self.metrics
        self.db_manager.metrics = self.metrics
        # same single-injection-point pattern for the flight recorder:
        # every traced seam records into THIS node's ring buffer (the
        # view changer's recovery lane — view_change_start/done,
        # vc_timeout_escalated — rides along; the leecher is attached
        # after construction below)
        for _traced in (self.propagator, self.executor, self.replica,
                        self.replica.ordering, bls_bft_replica,
                        self._outbox_3pc,
                        getattr(self.replica, "view_changer", None)):
            if _traced is not None:
                _traced.tracer = self.tracer
        # journey plane: outgoing envelopes carry an advisory causal
        # stamp only when this node is traced AND the config gate is on
        # — an untraced node has no buffers for journeys to join, so
        # stamping it would be pure wire bytes
        _trace_ctx = bool(getattr(self.config, "TRACE_CONTEXT_ENABLED",
                                  True)) \
            and getattr(self.tracer, "enabled", False)
        self.propagator.trace_context = _trace_ctx
        if self._outbox_3pc is not None:
            self._outbox_3pc.trace_context = _trace_ctx
            self._outbox_3pc.origin = name
        # telemetry rides the same single-injection-point pattern: the
        # executor times the execute/fused-dispatch stages, the
        # ordering service the 3PC stage, the view changer counts
        # recovery events — all into THIS node's hub
        for _tm_staged in (self.executor, self.replica.ordering,
                           getattr(self.replica, "view_changer", None)):
            if _tm_staged is not None:
                _tm_staged.telemetry = self.telemetry
        if verifier is not None and hasattr(verifier, "tracer"):
            # device-dispatch profiling inside the CoalescingVerifierHub
            # (a hub shared across co-resident nodes keeps whichever
            # tracer was attached last — one buffer still sees every
            # fused launch)
            verifier.tracer = self.tracer
        if getattr(self.tracer, "enabled", False):
            # mesh_dispatch spans + per-device counters land in the same
            # buffer (process-wide mesh: last tracer attached wins, like
            # the shared hub above)
            _mesh_mod.get_mesh().tracer = self.tracer
        # state_get / state_apply / state_proof spans from the device
        # MPT engines land in this node's buffer too
        for _lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID):
            _state = self.db_manager.get_state(_lid)
            if _state is not None and \
                    getattr(_state, "_engine", None) is not None:
                _state._engine.tracer = self.tracer
        self.primary_connection_monitor = PrimaryConnectionMonitorService(
            self.replica.data, timer, self.replica.internal_bus, network,
            config=self.config)
        self.replica.internal_bus.subscribe(
            NewViewAccepted, lambda msg: self.monitor.reset())
        # the ordering pause during a view change must not read as
        # primary freshness-negligence right after it
        self.replica.internal_bus.subscribe(
            NewViewAccepted,
            lambda msg: self.freshness_checker is not None
            and self.freshness_checker.reset_all(
                self.timer.get_current_time()))
        # a new view invalidates any stored backup-primary position
        self.replica.internal_bus.subscribe(
            NewViewAccepted,
            lambda msg: self.last_sent_pp_store.erase_last_sent())
        from plenum_tpu_torch.common.messages.internal_messages import (
            CheckpointStabilized)
        self.replica.internal_bus.subscribe(
            CheckpointStabilized, self._gc_rejected)

        def _check_master_degraded():
            if self.mode_participating and self.monitor.is_master_degraded():
                self.monitor.reset()
                self.notifier.send_cluster_degraded()
                self.replica.internal_bus.send(
                    VoteForViewChange(suspicion="MASTER_DEGRADED"))
        self._degradation_timer = RepeatingTimer(
            timer, self.config.ThroughputWindowSize,
            _check_master_degraded)
        # telemetry flush: sample pool-health gauges, append a flush
        # sample (the Perfetto counter-track time axis), and write the
        # per-node Prometheus exposition file when a directory is
        # configured. Fixed cadence is correct here (periodic non-retry
        # work), period single-sourced from Config.
        self._telemetry_timer = None
        if self.telemetry.enabled:
            self._telemetry_timer = RepeatingTimer(
                timer,
                getattr(self.config, "TELEMETRY_FLUSH_INTERVAL_S", 10),
                self._flush_telemetry)
        # periodic spike sampling + stats-consumer push (reference
        # node.py:2552 checkNodeRequestSpike / monitor.py:643
        # checkPerformance), only scheduled when someone listens
        self._spike_timer = None
        if self.config.SPIKE_EVENTS_ENABLED or self._stats_plugins:
            self._spike_timer = RepeatingTimer(
                timer, self.config.SPIKE_EVENTS_FREQ, self._sample_spikes)
        from plenum_tpu_torch.server.replicas import BackupInstanceFaultyProcessor
        self.backup_faulty_processor = BackupInstanceFaultyProcessor(
            self.replicas, self.monitor, self.config)
        self._backup_faulty_timer = RepeatingTimer(
            timer, 4 * self.config.ThroughputWindowSize,
            self.backup_faulty_processor.check)

        # ---- catchup (leecher + seeder)
        from plenum_tpu_torch.common.messages.internal_messages import (
            NeedMasterCatchup)
        from plenum_tpu_torch.server.catchup import (
            NodeLeecherService, SeederService)
        self.seeder = SeederService(
            self.db_manager, network, name=name,
            view_source=lambda: (self.replica.view_no,
                                 self.replica.data.last_ordered_3pc[1]),
            config=self.config)
        self.leecher = NodeLeecherService(
            self.db_manager, network, timer,
            quorums_source=lambda: self.replica.data.quorums,
            on_catchup_txn=self._on_catchup_txn,
            on_finished=self._on_catchup_finished,
            config=self.config, name=name,
            # catchup evidence only counts from current validators the
            # node has not blacklisted: an unknown sender must not pad
            # status/cons-proof quorums or feed reps (the blacklister is
            # constructed below; the lambda dereferences at call time)
            peer_ok=lambda frm: (
                frm in self.pool_manager.validators
                and not self.blacklister.is_blacklisted(frm)))
        self.leecher.tracer = self.tracer
        self.replica.internal_bus.subscribe(
            NeedMasterCatchup, lambda msg: self.start_catchup())
        # graceful read degradation half 2: ordering pauses for the
        # whole view change, so proof-bearing reads pin the last
        # committed (BLS-signed) roots until the new view lands —
        # catchup pins/unpins the same way in start_catchup /
        # _on_catchup_finished
        from plenum_tpu_torch.common.messages.internal_messages import (
            ViewChangeStarted)
        self.replica.internal_bus.subscribe(
            ViewChangeStarted,
            lambda msg: self.db_manager.pin_read_roots())
        self.replica.internal_bus.subscribe(
            NewViewAccepted,
            lambda msg: self.leecher.in_progress
            or self.db_manager.unpin_read_roots())

        # ---- suspicion reporting + blacklisting (reference
        # reportSuspiciousNode + SimpleBlacklister): every suspicion is
        # logged and counted; auto-blacklisting is opt-in and limited to
        # sender-attributable evidence — see server/blacklister.py
        from plenum_tpu_torch.common.messages.internal_messages import (
            RaisedSuspicion)
        from plenum_tpu_torch.server.blacklister import SimpleBlacklister
        self.blacklister = SimpleBlacklister(name)

        def on_suspicion(msg: RaisedSuspicion):
            ex = msg.ex
            if getattr(ex, "node", None):
                self.blacklister.report_suspicion(
                    ex.node, getattr(ex, "code", None),
                    getattr(ex, "reason", ""),
                    auto_blacklist=self.config.BLACKLIST_ON_SUSPICION)
        self.replicas.subscribe_suspicions(on_suspicion)

        orig_incoming = network.process_incoming

        def filtering_incoming(msg, frm):
            # connection state events must pass — monitors track peers
            # whether blacklisted or not
            if not isinstance(msg, (network.Connected,
                                    network.Disconnected)) \
                    and self.blacklister.is_blacklisted(frm):
                return None
            result = orig_incoming(msg, frm)
            # votes provoked by inbound deliveries (PREPAREs for landed
            # PPs, COMMITs on fresh quorums) accumulate in the outbox
            # until the next prod tick's flush in service(). Flushing
            # per delivery here was measured to defeat coalescing
            # entirely: each instance's PP arrives from a DIFFERENT
            # primary node, so every provoked vote shipped alone (18
            # singles per node per 3PC round at 25 validators, 0
            # envelopes). The deferred flush below only covers the
            # pathological case of deliveries arriving while the prod
            # loop is starved — votes never wait past one timer turn.
            self._arm_outbox_flush()
            return result
        network.process_incoming = filtering_incoming

        # ---- runtime ownership sanitizer (runtime/sanitizer.py): the
        # runtime twin of plenum-lint PT016/PT017 — region pins on
        # consensus-critical objects, shared by the ordering services'
        # 3PC-intake guard, the executor's commit/lane seams and the
        # pipeline's handoff tokens. The construction thread IS the
        # prod thread (nodes are built and serviced on one thread; the
        # pipelined path re-binds below with its own ident). Opt-in:
        # Config.SANITIZER_ENABLED / PLENUM_TPU_SANITIZE=1.
        from plenum_tpu_torch.runtime.sanitizer import (
            CONSENSUS_PINS, OwnershipSanitizer, sanitizer_enabled)
        self.sanitizer = None
        if sanitizer_enabled(self.config):
            self.sanitizer = OwnershipSanitizer(
                name=name, tracer=self.tracer)
            self.sanitizer.bind_region("prod")
            for label in CONSENSUS_PINS:
                self.sanitizer.pin(label, "prod")
            for replica in self.replicas:
                replica.ordering.attach_sanitizer(self.sanitizer)
            self.executor.set_sanitizer(self.sanitizer)

        # ---- pipeline runtime (runtime/pipeline.py): wire parse +
        # ed25519 pre-screen move to a worker thread feeding the prod
        # thread through a bounded queue; execution fan-out shares the
        # same pool. The serial path above stays the validated
        # fallback; the prod thread keeps sole ownership of all
        # consensus state (bind_owner_thread makes that a hard
        # contract at the 3PC intake seams).
        self._pipeline = None
        self._prescreen_cache = None
        self._drain_scheduled = False
        self._serial_incoming = filtering_incoming
        if getattr(self.config, "PIPELINE_ENABLED", False):
            import threading
            from plenum_tpu_torch.runtime.pipeline import (
                NodePipeline, PrescreenCache)
            from plenum_tpu_torch.crypto.batch_verifier import create_verifier
            self._prescreen_cache = PrescreenCache()
            # advisory host work on the parse worker: the scalar RFC 8032
            # check, never a kernel (every launch stays on the prod thread)
            self._prescreen_verifier = create_verifier("cpu")
            # ONE verdict cache across both authenticators: client
            # intake warms it (warm-on-verify), the worker pre-screen
            # and the propagate gate skip triples it has seen — the
            # ~n relayed copies of a request cost one verification
            propagate_authnr.set_prescreen(self._prescreen_cache)
            self.authnr.set_prescreen(self._prescreen_cache)
            self._pipeline = NodePipeline(
                self._pipeline_deliver, config=self.config,
                telemetry=self.telemetry, tracer=self.tracer,
                name=name, sanitizer=self.sanitizer)
            self.executor.set_exec_map(self._pipeline.exec_map)
            prod_ident = threading.get_ident()
            for replica in self.replicas:
                replica.ordering.bind_owner_thread(prod_ident)
            # per-stage drain on view change: no parse job may
            # straddle a protocol epoch (catchup drains in
            # start_catchup the same way)
            self.replica.internal_bus.subscribe(
                ViewChangeStarted, lambda msg: self._drain_pipeline())

            def pipelined_incoming(msg, frm):
                # connection events keep their inline path (monitors
                # track peers whether queued work exists or not)
                if isinstance(msg, (network.Connected,
                                    network.Disconnected)):
                    return filtering_incoming(msg, frm)
                if isinstance(msg, FlatBatch):
                    payload = msg.payload
                    self._pipeline.submit(
                        lambda: self._pipeline_parse(payload, frm),
                        msg, frm)
                else:
                    self._pipeline.submit(None, msg, frm)
                # zero-delay drain: fires at THIS simulated instant,
                # after the delivery callback returns, so pipelined
                # processing happens at the same sim time — and in
                # the same order — the serial path would have
                # processed it (determinism by construction; the
                # wall-clock win is the worker parsing concurrently)
                if not self._drain_scheduled:
                    self._drain_scheduled = True
                    self.timer.schedule(0, self._drain_pipeline)
            network.process_incoming = pipelined_incoming
        self.mode_participating = True

        # ---- restart recovery from persisted stores
        self._recover_from_storage()

    # ========================================================== genesis

    def _load_genesis(self, txns: List[dict]):
        """Seed ledgers/state from genesis transactions (reference
        ledger/genesis_txn/ + upload_states)."""
        from plenum_tpu_torch.common.txn_util import get_type
        for txn in txns:
            txn_type = get_type(txn)
            handler = self.write_manager.request_handlers.get(txn_type)
            if handler is None:
                continue
            ledger = handler.ledger
            ledger.add(dict(txn))
            handler.update_state(txn, None, None, is_committed=True)
            if handler.state is not None:
                handler.state.commit()

    # ================================================== pool membership

    def _on_validators_changed(self, new_validators: List[str]):
        """A committed NODE txn changed pool membership: re-derive
        quorums/f on every protocol instance, adjust the backup instance
        count, update primary selectors (future views only — the current
        primary never silently moves), reconnect the transport, and vote
        a view change if the current primary was demoted (reference
        pool_manager.py + adjustReplicas node.py:1260)."""
        from plenum_tpu_torch.common.messages.internal_messages import (
            VoteForViewChange)
        for replica in self.replicas:
            replica.data.set_validators(new_validators)
            replica.selector.validators[:] = new_validators
        self._primary_selector.validators[:] = new_validators
        self.replicas.adjust_replicas(new_validators)
        self.propagator.update_quorums(self.replica.data.quorums)
        if self.bls_bft_replica is not None:
            self.bls_bft_replica.warm_pool_keys(new_validators)
        if self._on_membership_change is not None:
            self._on_membership_change(new_validators)
        if self.name not in new_validators:
            logger.info("%s demoted from the pool — stops participating",
                        self.name)
            self.mode_participating = False
            for replica in self.replicas:  # backups must stop voting too
                replica.data.node_mode_participating = False
            return
        if not self.mode_participating and not self.leecher.in_progress:
            # re-promoted: sync the missed window BEFORE voting again —
            # everything ordered while passive sits stashed/unapplied
            logger.info("%s re-promoted — catching up before rejoining",
                        self.name)
            self.start_catchup()
        primary = self.replica.data.primary_name
        if primary is not None and primary not in new_validators:
            logger.info("%s: primary %s demoted — voting view change",
                        self.name, primary)
            self.replica.internal_bus.send(
                VoteForViewChange(suspicion="PRIMARY_DEMOTED"))

    # ========================================================== recovery

    def _recover_from_storage(self):
        """Node restart from persisted stores (reference node restart:
        ledgers recoverTree on init, states re-derived from txn logs via
        ledgers_bootstrap.upload_states, seqNoDB reload node.py:698,
        3PC position from the audit ledger — SURVEY.md §5.4)."""
        from plenum_tpu_torch.common.txn_util import get_payload_digest, get_type
        from plenum_tpu_torch.state.trie import BLANK_ROOT
        expected_roots = self._audit_state_roots()
        for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID):
            ledger = self.db_manager.get_ledger(lid)
            state = self.db_manager.get_state(lid)
            if ledger.size == 0 or state is None:
                continue
            expected = expected_roots.get(lid)
            if state.committedHeadHash != BLANK_ROOT and (
                    expected is None
                    or state.committedHeadHash == expected):
                continue  # state store survived and matches the audit
            # state store lost, or STALE (crash between the ledger flush
            # and the state-root commit): replay the txn log from scratch
            logger.info("%s rebuilding state for ledger %d from %d txns",
                        self.name, lid, ledger.size)
            state.revertToHead(BLANK_ROOT)
            for _, txn in ledger.getAllTxn():
                handler = self.write_manager.request_handlers.get(
                    get_type(txn))
                if handler is not None and handler.ledger_id == lid:
                    handler.update_state(txn, None, None, is_committed=True)
            state.commit()
            if expected is not None and \
                    state.committedHeadHash != expected:
                logger.warning(
                    "%s ledger %d state root %s still differs from audit "
                    "record after rebuild", self.name, lid,
                    state.committedHeadHash_b58)
        # dedup index: backfill entries the ledgers have that the index
        # lacks — a crash between the (separate) ledger and index stores
        # can lose individual puts, not just the whole index. Fast path:
        # if each ledger's LAST txn is indexed, the tail is intact and
        # the O(ledger) scan is skipped.
        for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID):
            ledger = self.db_manager.get_ledger(lid)
            if ledger.size == 0:
                continue
            last_digest = get_payload_digest(ledger.get_last_txn())
            if last_digest:
                try:
                    self.seq_no_db.get(last_digest.encode())
                    continue
                except KeyError:
                    pass
            for seq, txn in ledger.getAllTxn():
                payload_digest = get_payload_digest(txn)
                if not payload_digest:
                    continue
                try:
                    self.seq_no_db.get(payload_digest.encode())
                except KeyError:
                    self.seq_no_db.put(
                        payload_digest.encode(),
                        "{}:{}".format(lid, seq).encode())
        # state_ts backfill: a crash between the state commit and the
        # ts-store put loses the final batch's (pp_time → root) entry —
        # restore it from the last audit txn, which records every
        # ledger's state root at that batch
        ts_store = self.db_manager.get_store("state_ts")
        audit = self.db_manager.get_ledger(AUDIT_LEDGER_ID)
        if ts_store is not None and audit.size > 0:
            from plenum_tpu_torch.common.txn_util import get_txn_time
            from plenum_tpu_torch.server.batch_handlers import AUDIT_TXN_STATE_ROOT
            last_audit = audit.get_last_txn()
            txn_time = get_txn_time(last_audit)
            roots = get_payload_data(last_audit).get(
                AUDIT_TXN_STATE_ROOT) or {}
            if txn_time is not None:
                for lid_str, root_b58 in roots.items():
                    lid = int(lid_str)
                    if ts_store.get(txn_time, lid) is None:
                        ledger = self.db_manager.get_ledger(lid)
                        ts_store.set(txn_time, ledger.strToHash(root_b58),
                                     lid)
        self._adopt_3pc_from_audit()
        if audit.size > 0:
            # a non-empty audit ledger at construction == restart from
            # persisted state; observers may want to know (reference
            # notifier restart/upgrade-complete events)
            self.notifier.send_cluster_restart(
                "Resumed at audit seq %d." % audit.size)
        # backup primaries resume their persisted pp_seq_no (master
        # recovers via catchup; see last_sent_pp_store.try_restore)
        self.last_sent_pp_store.try_restore(self)
        # a node with committed history must re-sync with the pool before
        # voting again: its persisted view is each batch's ORIGINAL view,
        # which can lag the pool's current view (catchup gathers f+1 peer
        # evidence via pool_view_estimate). Fresh-genesis nodes (empty
        # audit) participate immediately.
        if self.db_manager.get_ledger(AUDIT_LEDGER_ID).size > 0:
            self.start_catchup()

    def _primaries_for_batch(self, original_view_no: int) -> List[str]:
        """Primaries recorded in a batch's audit txn. Must be stable for
        the WHOLE view regardless of later membership changes (the
        reference records primaries at view start and back-references
        after, audit_batch_handler._fill_primaries): if the previous
        audit txn belongs to the same original view, reuse ITS resolved
        primaries; only the first batch of a view derives them from the
        live selector."""
        handler = self._audit_handler()
        if handler is not None:
            last_seq = handler.ledger.uncommitted_size
            if last_seq:
                last = handler.ledger.get_by_seq_no_uncommitted(last_seq)
                if last is not None and \
                        get_payload_data(last).get("viewNo") == \
                        original_view_no:
                    prev = handler.primaries_at(last_seq)
                    if prev:
                        return list(prev)
        return [self._primary_selector.select_master_primary(
            original_view_no)]

    def _audit_handler(self):
        from plenum_tpu_torch.server.batch_handlers import AuditBatchHandler
        for chain in self.write_manager.batch_handlers.values():
            for h in chain:
                if isinstance(h, AuditBatchHandler):
                    return h
        return None

    def _audit_state_roots(self) -> Dict[int, bytes]:
        """ledger_id → expected committed state root from the last audit
        txn (every audit txn records all current state roots)."""
        audit = self.db_manager.get_ledger(AUDIT_LEDGER_ID)
        last = audit.get_last_txn()
        if last is None:
            return {}
        from plenum_tpu_torch.ledger.ledger import Ledger
        roots = {}
        for lid_str, root_b58 in (
                get_payload_data(last).get("stateRoot") or {}).items():
            try:
                roots[int(lid_str)] = Ledger.strToHash(root_b58)
            except Exception:
                continue
        return roots

    def _adopt_3pc_from_audit(self, pool_view: Optional[int] = None):
        """Fast-forward the replica to the audit ledger's last recorded
        3PC position (floor: the audit view is the batch's ORIGINAL view;
        `pool_view` — peer evidence from catchup — can raise it)."""
        audit = self.db_manager.get_ledger(AUDIT_LEDGER_ID)
        last_audit = audit.get_last_txn()
        view_no, pp_seq_no = 0, 0
        if last_audit is not None:
            data = get_payload_data(last_audit)
            view_no = data.get("viewNo", 0)
            pp_seq_no = data.get("ppSeqNo", 0)
        # a batch ORDERED in the view we're still waiting on proves its
        # NEW_VIEW completed pool-wide while we weren't looking (likely
        # disconnected) — absorb the pending view change from this
        # evidence, or the node wedges: NEW_VIEW is never retransmitted
        # and MessageReq is disabled mid view change (audit viewNo is
        # the batch's ORIGINAL view, so re-ordered old-view batches
        # never count as evidence — only genuinely new ones)
        if last_audit is not None \
                and self.replica.data.waiting_for_new_view:
            vc_service = getattr(self.replica, "view_changer", None)
            if vc_service is not None:
                vc_service.absorb_view_from_catchup(view_no)
        if pool_view is not None:
            view_no = max(view_no, pool_view)
        current = self.replica.data.last_ordered_3pc
        if (view_no, pp_seq_no) <= current:
            return
        pp_seq_no = max(pp_seq_no, current[1])
        view_was = self.replica.data.view_no
        self.replica.data.last_ordered_3pc = (view_no, pp_seq_no)
        self.replica.data.view_no = view_no
        # absorb didn't fire (no batch ordered at the pending view yet)
        # but pool evidence re-targeted a still-pending view change to
        # a HIGHER view: the running NEW_VIEW timer's view guard now
        # never matches, so re-arm it for the adopted view — the node
        # keeps escalating/voting instead of wedging silently
        if view_no > view_was \
                and self.replica.data.waiting_for_new_view:
            vc_service = getattr(self.replica, "view_changer", None)
            if vc_service is not None:
                vc_service.rearm_new_view_timeout()
        self.replica.ordering.lastPrePrepareSeqNo = pp_seq_no
        self.replica.ordering._last_applied_seq = pp_seq_no
        self.replica.checkpointer.caught_up_till_3pc((view_no, pp_seq_no))
        # primary: prefer the audit ledger's own record (stable against
        # mid-view membership changes); the live selector only decides
        # views newer than the last audited batch
        primary = None
        if last_audit is not None and \
                get_payload_data(last_audit).get("viewNo") == view_no:
            handler = self._audit_handler()
            recorded = handler.primaries_at(audit.size) if handler else None
            if recorded:
                primary = recorded[0]
        self.replica.data.primary_name = primary or \
            self._primary_selector.select_master_primary(view_no)

    # ===================================================== client intake

    def process_client_request(self, msg: dict, client_id: str):
        """Entry for one client REQUEST (reference processRequest :2000)."""
        with self.metrics.measure_time(MetricsName.REQUEST_INTAKE_TIME):
            self._process_client_request(msg, client_id)

    def _process_client_request(self, msg: dict, client_id: str):
        try:
            self._validator.validate(msg)
            request = Request.from_dict(msg)
        except InvalidClientMessageException as e:
            self._reply_to_client(client_id, RequestNack(
                identifier=msg.get("identifier") or "unknown",
                reqId=msg.get("reqId") or 0, reason=str(e)))
            return
        if self.read_manager.is_valid_type(request.txn_type):
            self._process_read(request, client_id)
            return
        if self.action_manager.is_valid_type(request.txn_type):
            self._process_action(request, client_id)
            return
        self._process_write(request, client_id)

    def process_client_batch(self, msgs: List[Tuple[dict, str]]):
        """Batched intake: ONE device dispatch authenticates every pending
        request (the north-star path)."""
        pending = self.dispatch_client_batch(msgs)
        self.conclude_client_batch(pending)

    def dispatch_client_batch(self, msgs: List[Tuple[dict, str]]):
        """Phase 1 of batched intake (non-blocking): validate schemas,
        serve reads, enqueue ONE async device dispatch for every write
        signature. The caller overlaps other work (other nodes\' batches,
        consensus ticks) before conclude_client_batch harvests — this
        hides the device round-trip latency entirely (SURVEY.md §7)."""
        with self.metrics.measure_time(MetricsName.DEVICE_DISPATCH_TIME), \
                self.tracer.span("auth_dispatch", CAT_DEVICE,
                                 n=len(msgs)) as _sp:
            pending = self._dispatch_client_batch(msgs)
            if pending is not None:
                _sp.add(dispatched=len(pending[0]))
            return pending

    def _dispatch_client_batch(self, msgs: List[Tuple[dict, str]]):
        from plenum_tpu_torch.common.constants import CURRENT_PROTOCOL_VERSION
        intake = _fp.request_intake if _fp is not None else None
        parsed = []
        reads = []
        for msg, client_id in msgs:
            try:
                # C fast path: validation + both digests + signing bytes
                # in one crossing; None falls back to the Python chain
                # (which also produces the exact rejection text)
                pre = None
                if intake is not None and type(msg) is dict:
                    pre = intake(msg, CURRENT_PROTOCOL_VERSION)
                if pre is None:
                    self._validator.validate(msg)
                    request = Request.from_dict(msg)
                else:
                    request = Request.from_dict(msg)
                    request._digest, request._payload_digest, \
                        request._signing_ser = pre
            except InvalidClientMessageException as e:
                self._reply_to_client(client_id, RequestNack(
                    identifier=msg.get("identifier") or "unknown",
                    reqId=msg.get("reqId") or 0, reason=str(e)))
                continue
            if self.read_manager.is_valid_type(request.txn_type):
                # defer: the whole intake's reads serve as ONE batch
                # (shared state-engine walks + per-root BLS lookups)
                reads.append((request, client_id))
                continue
            if self.action_manager.is_valid_type(request.txn_type):
                self._process_action(request, client_id)
                continue
            parsed.append((request, client_id))
        self._process_read_batch(reads)
        if not parsed:
            return None
        self.metrics.add_event(MetricsName.CLIENT_AUTH_BATCH_SIZE,
                               len(parsed))
        self.tracer.counter("auth_batch_size", len(parsed))
        handle = self.authnr.dispatch_batch([r for r, _ in parsed])
        return (parsed, handle)

    def client_batch_ready(self, pending) -> bool:
        """True when conclude_client_batch will not block (device/daemon
        result landed)."""
        if pending is None:
            return True
        _, handle = pending
        return self.authnr.batch_ready(handle)

    def conclude_client_batch(self, pending):
        """Phase 2: harvest device results, ack/nack, propagate."""
        if pending is None:
            return
        parsed, handle = pending
        with self.metrics.measure_time(MetricsName.CLIENT_AUTH_TIME), \
                self.tracer.span("auth_conclude", CAT_DEVICE,
                                 n=len(parsed)):
            results = self.authnr.conclude_batch(handle)
        for (request, client_id), idrs in zip(parsed, results):
            if idrs is None:
                self._reply_to_client(client_id, RequestNack(
                    identifier=request.identifier or "unknown",
                    reqId=request.reqId or 0,
                    reason="signature verification failed"))
                continue
            self._accept_write(request, client_id)
        # ship the whole intake batch's propagates as one wire message
        self.propagator.flush()

    # ------------------------------------------------- gateway intake

    def process_gateway_envelope(self, data, frm: str):
        """Client-tier FLAT_WIRE intake: one PROPAGATE-only envelope
        from a gateway becomes one batched client intake. The gateway's
        pre-screen is only a filter — every request re-authenticates
        here through the same ``process_client_batch`` path direct
        client traffic takes, so the ledger/state roots produced from a
        gateway-fed stream are byte-identical to feeding the same
        admitted requests directly."""
        msgs = self.unpack_gateway_batch(data, frm)
        if msgs:
            self.process_client_batch(msgs)

    def unpack_gateway_batch(self, data,
                             frm: str) -> List[Tuple[dict, str]]:
        """Parse one gateway→node envelope into [(request dict, client
        id)]. Structural violations (bad magic/version, truncation,
        over-length, non-PROPAGATE sections — a gateway never forwards
        3PC traffic) raise a per-sender suspicion and drop the envelope
        whole; a bad request ENTRY costs only itself."""
        hub = get_seam_hub()
        try:
            env = flat_wire.parse_envelope(
                data, max_bytes=self.config.MSG_LEN_LIMIT)
        except flat_wire.FlatWireError as e:
            hub.count(TM.WIRE_MALFORMED, 1)
            logger.warning("%s: malformed gateway envelope from %s: %s",
                           self.name, frm, e)
            self.blacklister.report_suspicion(
                frm, Suspicions.WIRE_MALFORMED, str(e),
                auto_blacklist=self.config.BLACKLIST_ON_SUSPICION)
            return []
        hub.count(TM.WIRE_BYTES_RECV, env.nbytes)
        msgs: List[Tuple[dict, str]] = []
        for sec in env.sections:
            if sec.kind != flat_wire.KIND_PROPAGATE:
                hub.count(TM.WIRE_MALFORMED, 1)
                logger.warning(
                    "%s: non-PROPAGATE section %d in gateway envelope "
                    "from %s", self.name, sec.kind, frm)
                self.blacklister.report_suspicion(
                    frm, Suspicions.WIRE_MALFORMED,
                    "gateway section kind %d" % sec.kind,
                    auto_blacklist=self.config.BLACKLIST_ON_SUSPICION)
                return []
            for i in range(sec.n):
                try:
                    req = sec.request(i)
                except Exception:
                    logger.warning("%s: bad request entry in gateway "
                                   "envelope from %s — dropped",
                                   self.name, frm)
                    continue
                msgs.append((req, sec.client(i) or frm))
        return msgs

    def _process_write(self, request: Request, client_id: str):
        try:
            self.req_authenticator.authenticate(request)
        except Exception as e:
            self._reply_to_client(client_id, RequestNack(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=str(e)))
            return
        self._accept_write(request, client_id)

    def _accept_write(self, request: Request, client_id: str):
        try:
            self.write_manager.static_validation(request)
        except InvalidClientMessageException as e:
            self._reply_to_client(client_id, RequestNack(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=str(e)))
            return
        # dedup: already committed? (must precede the plugin veto —
        # resubmission of a committed request returns its Reply even if
        # a later-installed plugin would now reject the operation)
        existing = self._committed_reply(request)
        if existing is not None:
            self._reply_to_client(client_id, existing)
            return
        # VERIFICATION plugins veto operations by raising (reference
        # plugin_loader.py:41 — Node calls each plugin's verify(msg) on
        # client requests)
        for plugin in self._verification_plugins:
            try:
                plugin.verify(request.operation)
            except Exception as e:
                self._reply_to_client(client_id, RequestNack(
                    identifier=request.identifier or "unknown",
                    reqId=request.reqId or 0,
                    reason="plugin rejected: %s" % e))
                return
        self._request_spike_accum += 1
        key = request.key
        # lifecycle root: everything downstream (propagate quorum, 3PC,
        # reply) correlates back to this digest on the merged timeline
        self.tracer.instant("request_accepted", CAT_INTAKE, key=key)
        if self.telemetry.enabled:
            # intake→reply latency start mark; a full map (pool deeply
            # backlogged) degrades to counting the drop, never growing
            if len(self._tm_intake_ts) < getattr(
                    self.config, "TELEMETRY_PENDING_MAX", 1 << 17):
                self._tm_intake_ts[key] = self.telemetry.clock()
            else:
                self.telemetry.count(TM.E2E_DROPPED)
        self._req_clients[key] = client_id
        if self._clients_attached:
            # building the Ack (schema-validated message object) only
            # makes sense when there is a transport to carry it
            self._reply_to_client(client_id, RequestAck(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0))
        self.monitor.request_received(key)
        self.propagator.propagate(request, client_id)

    def _sample_spikes(self):
        """One periodic sample per stream: client-request intake count
        (reference node.py:2561 sendNodeRequestSpike) and master EMA
        throughput (reference monitor.py:645 sendClusterThroughputSpike);
        STATS_CONSUMER plugins get the same snapshot."""
        from plenum_tpu_torch.server.plugins import (
            TOPIC_CLUSTER_THROUGHPUT_SPIKE, TOPIC_NODE_REQUEST_SPIKE)
        reqs = self._request_spike_accum
        self._request_spike_accum = 0
        if self.mode_participating:
            self.notifier.send_spike_check(TOPIC_NODE_REQUEST_SPIKE, reqs)
            thr = self.monitor.instance_throughput(0)
            if thr is not None:
                self.notifier.send_spike_check(
                    TOPIC_CLUSTER_THROUGHPUT_SPIKE, thr)
        if self._stats_plugins:
            stats = {"node": self.name,
                     "requests_in_window": reqs,
                     "total_ordered": self.monitor.total_ordered,
                     "avg_latency": self.monitor.avg_latency(),
                     "master_throughput":
                         self.monitor.instance_throughput(0)}
            for plugin in self._stats_plugins:
                try:
                    plugin.consume_stats(stats)
                except Exception:
                    logger.error("stats plugin %r failed", plugin,
                                 exc_info=True)

    def _process_action(self, request: Request, client_id: str):
        """Authenticated action: validated + executed locally, no
        consensus round (reference node.py:2085 process_action). Rides
        the SAME authenticator registry as writes — actions are the
        privileged requests that most need every registered policy."""
        try:
            self.action_manager.static_validation(request)
            self.req_authenticator.authenticate(request)
        except Exception as e:
            self._reply_to_client(client_id, RequestNack(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=str(e)))
            return
        self._reply_to_client(client_id, RequestAck(
            identifier=request.identifier, reqId=request.reqId))
        try:
            self.action_manager.dynamic_validation(request)
            result = self.action_manager.process_action(request)
            self._reply_to_client(client_id, Reply(result=result))
        except Exception as e:
            self._reply_to_client(client_id, Reject(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=str(e)))

    def _process_read_batch(self, reads):
        """Serve one intake's reads as a single batch: GET_NYMs reading
        the same root share ONE batched state-engine walk for values
        and proofs (ReadRequestManager.get_results_batch). Per-request
        failures nack that request only. A manager-level failure raises:
        the JAX package served such a batch again one read at a time on
        the host, which would hide a failed kernel on the card."""
        if not reads:
            return
        if len(reads) == 1:
            self._process_read(*reads[0])
            return
        with self.tracer.span("read_batch", CAT_INTAKE, n=len(reads)):
            results = self.read_manager.get_results_batch(
                [request for request, _ in reads])
        for (request, client_id), result in zip(reads, results):
            if isinstance(result, InvalidClientMessageException):
                self._reply_to_client(client_id, RequestNack(
                    identifier=request.identifier or "unknown",
                    reqId=request.reqId or 0, reason=str(result)))
            elif isinstance(result, Exception):
                logger.error("%s failed processing read %s: %r",
                             self.name, request, result)
                self._reply_to_client(client_id, RequestNack(
                    identifier=request.identifier or "unknown",
                    reqId=request.reqId or 0, reason="internal error"))
            else:
                self._reply_to_client(client_id, Reply(result=result))

    def _process_read(self, request: Request, client_id: str):
        try:
            result = self.read_manager.get_result(request)
            self._reply_to_client(client_id, Reply(result=result))
        except InvalidClientMessageException as e:
            self._reply_to_client(client_id, RequestNack(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=str(e)))
        except Exception:  # a read must never crash the intake loop
            logger.exception("%s failed processing read %s", self.name,
                             request)
            self._reply_to_client(client_id, RequestNack(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason="internal error"))

    # ================================================ propagation → 3PC

    def _forward_finalised(self, request: Request):
        # POOL_LEDGER_ID is 0 — `or` would misroute NODE txns to domain
        lid = self.write_manager.type_to_ledger_id(request.txn_type)
        if lid is None:
            lid = DOMAIN_LEDGER_ID
        self._tm_propagate_done(request.key)
        self.replicas.submit_request(request.key, lid)

    def _forward_finalised_batch(self, requests: List[Request]):
        """A whole propagate batch finalised at once: digests stay one
        contiguous column per ledger into every instance's proposal
        queue (one stash-replay per instance per batch, not per
        request)."""
        by_ledger: Dict[int, List[str]] = {}
        type_to_lid = self.write_manager.type_to_ledger_id
        for request in requests:
            lid = type_to_lid(request.txn_type)
            if lid is None:
                lid = DOMAIN_LEDGER_ID
            self._tm_propagate_done(request.key)
            by_ledger.setdefault(lid, []).append(request.key)
        for lid, digests in by_ledger.items():
            self.replicas.submit_requests(digests, lid)

    def _tm_propagate_done(self, key: str) -> None:
        """Propagate-quorum wait histogram: intake accept → forwarded to
        the ordering queues (quorum reached). Requests learned only via
        gossip have no intake mark here — their latency is owned by the
        node that accepted them from the client."""
        t0 = self._tm_intake_ts.get(key)
        if t0 is not None:
            self.telemetry.observe(TM.STAGE_PROPAGATE_MS,
                                   (self.telemetry.clock() - t0) * 1e3)

    def _arm_outbox_flush(self):
        """Arm the deferred vote flush when an inbound delivery left
        provoked votes in the 3PC outbox — shared by the serial
        delivery path and the pipeline drain."""
        if self._outbox_3pc is not None and len(self._outbox_3pc) \
                and not self._outbox_flush_armed:
            self._outbox_flush_armed = True
            self.timer.schedule(
                getattr(self.config, "THREE_PC_FLUSH_WINDOW", 0.002),
                self._deferred_outbox_flush)

    def _deferred_outbox_flush(self):
        """Timer-armed flush covering votes provoked by deliveries:
        armed on the FIRST provoked vote and fired one
        THREE_PC_FLUSH_WINDOW later, so a burst of deliveries jittered
        across a few ms (per-message wire latency draws) accumulates
        into ONE envelope of everything it provoked — without the
        window every provoked vote shipped alone, because each
        instance's PP arrives from a different primary at a different
        instant. A few ms of extra vote latency is invisible next to
        consensus timeouts, and the prod-tick flush in service() still
        bounds the wait when the timer is starved."""
        self._outbox_flush_armed = False
        if self._outbox_3pc is not None:
            self._outbox_3pc.flush()

    def _process_three_pc_batch(self, msg: ThreePCBatch, frm: str):
        """Inbound coalesced 3PC envelope: reconstruct wire entries,
        split by protocol instance, and feed each instance's columnar
        intake — PRE-PREPAREs first, then PREPAREs, then COMMITs (a
        sender's envelope is FIFO, and no sender emits a vote before
        its own earlier-phase vote for the same key, so phase-major
        processing preserves per-sender causality)."""
        ctx = getattr(msg, "traceCtx", None)
        if ctx is not None:
            self._note_wire_stamp(
                flat_wire.TraceStamp.from_wire(ctx), frm, CAT_3PC)
        groups: Dict[int, Tuple[list, list, list]] = {}
        # the typed path's receive-side deserialization cost — one
        # factory reconstruction per inner vote — is the `parse` stage
        # the flat codec's single-parse replaces; span it so the A/B
        # reads off scripts/trace_budget instead of being inferred
        with self.tracer.span("wire_parse", CAT_3PC,
                              n=len(msg.messages)):
            for entry in msg.messages:
                if isinstance(entry, dict):
                    try:
                        entry = node_message_factory.get_instance(**entry)
                    except Exception as e:
                        logger.warning(
                            "%s: bad entry in THREE_PC_BATCH from %s: %s",
                            self.name, frm, e)
                        continue
                if isinstance(entry, PrePrepare):
                    idx = 0
                elif isinstance(entry, Prepare):
                    idx = 1
                elif isinstance(entry, Commit):
                    idx = 2
                else:
                    logger.warning(
                        "%s: non-3PC entry %s in THREE_PC_BATCH from %s "
                        "— dropped", self.name, type(entry).__name__, frm)
                    continue
                inst_id = entry.instId
                group = groups.get(inst_id)
                if group is None:
                    group = groups[inst_id] = ([], [], [])
                group[idx].append(entry)
        for inst_id, (pps, prepares, commits) in groups.items():
            replica = self.replicas.get(inst_id)
            if replica is None:
                continue   # fewer instances here than at the sender
            ordering = replica.ordering
            if pps:
                ordering.process_preprepare_batch(pps, frm)
            if prepares:
                ordering.process_prepare_batch(prepares, frm)
            if commits:
                ordering.process_commit_batch(commits, frm)

    def _process_flat_batch(self, msg: FlatBatch, frm: str):
        """Inbound flat zero-copy envelope: ONE parse turns the payload
        bytes into numpy column views (no per-message deserialization,
        no intermediate message objects), split per protocol instance
        and fed phase-major into the columnar ``process_*_columns``
        intake — PRE-PREPAREs first (materialized from their
        length-prefixed section: they carry ragged reqIdr and must run
        the full stash/verdict machinery), then PREPARE columns, then
        COMMIT columns. A structurally invalid envelope raises a
        per-sender suspicion and is dropped whole — it can never crash
        the prod loop; a bad ENTRY costs only itself, like a bad entry
        in a typed THREE_PC_BATCH."""
        payload = msg.payload
        try:
            with self.tracer.span(
                    "wire_parse", CAT_3PC,
                    n=len(payload) if isinstance(
                        payload, (bytes, bytearray)) else 0):
                env = flat_wire.parse_envelope(payload)
        except flat_wire.FlatWireError as e:
            self._flat_wire_suspicion(frm, e)
            return
        self._note_flat_stamp(env, frm)
        self._dispatch_parsed_flat(env, frm)

    def _flat_wire_suspicion(self, frm: str, e: Exception) -> None:
        """A structurally invalid envelope: sender-attributable
        suspicion, envelope dropped whole — the wire can never crash
        the prod loop. Shared by the serial parse path and the
        pipeline drain (a worker parse failure is delivered here, on
        the prod thread, in arrival order — same verdict, same
        instant the serial path would have raised it)."""
        get_seam_hub().count(TM.WIRE_MALFORMED, 1)
        logger.warning("%s: malformed FLAT_WIRE envelope from %s: %s",
                       self.name, frm, e)
        self.blacklister.report_suspicion(
            frm, Suspicions.WIRE_MALFORMED, str(e),
            auto_blacklist=self.config.BLACKLIST_ON_SUSPICION)

    def _note_flat_stamp(self, env, frm: str) -> None:
        """The envelope's receive-side journey anchor. On the
        pipelined path this runs on the PARSE WORKER (the tracer's
        ring is lock-protected), so the wire_recv instant lands at
        true arrival time rather than drain time — journeys stay
        complete and honest about when bytes hit the node."""
        if env.stamp is not None:
            self._note_wire_stamp(
                env.stamp, frm,
                CAT_PROPAGATE if all(
                    s.kind == flat_wire.KIND_PROPAGATE
                    for s in env.sections) else CAT_3PC)

    def _dispatch_parsed_flat(self, env, frm: str) -> None:
        """Feed one parsed envelope into the columnar intakes —
        ALWAYS on the prod thread (serial path inline; pipelined path
        from the drain), because everything below this line touches
        consensus state."""
        get_seam_hub().count(TM.WIRE_BYTES_RECV, env.nbytes)
        # inst -> (pps, prepare column slices, commit column slices);
        # phase-major per instance preserves per-sender causality (a
        # sender's envelope is FIFO and no sender votes ahead of its
        # own earlier phase for the same key)
        groups: Dict[int, Tuple[list, list, list]] = {}

        def group(inst_id: int) -> Tuple[list, list, list]:
            g = groups.get(inst_id)
            if g is None:
                g = groups[inst_id] = ([], [], [])
            return g

        propagate_secs = []
        for sec in env.sections:
            if sec.kind == flat_wire.KIND_PREPREPARE:
                for i in range(sec.n):
                    pp = sec.materialize(i)
                    if pp is None:
                        logger.warning(
                            "%s: bad PREPREPARE entry in FLAT_WIRE "
                            "from %s — dropped", self.name, frm)
                        continue
                    group(pp.instId)[0].append(pp)
            elif sec.kind == flat_wire.KIND_PREPARE:
                self._split_columns_by_inst(sec, group, 1)
            elif sec.kind == flat_wire.KIND_COMMIT:
                self._split_columns_by_inst(sec, group, 2)
            elif sec.kind == flat_wire.KIND_PROPAGATE:
                propagate_secs.append(sec)
        for inst_id, (pps, prep_cols, commit_cols) in groups.items():
            replica = self.replicas.get(inst_id)
            if replica is None:
                continue   # fewer instances here than at the sender
            ordering = replica.ordering
            if pps:
                ordering.process_preprepare_batch(pps, frm)
            for cols in prep_cols:
                ordering.process_prepare_columns(cols, frm)
            for cols in commit_cols:
                ordering.process_commit_columns(cols, frm)
        for sec in propagate_secs:
            self.propagator.process_propagate_columns(sec, frm)

    def _note_wire_stamp(self, stamp, frm: str, cat: str) -> None:
        """Advisory receive-side journey anchor: one ``wire_recv``
        instant joining this envelope to its sender's ``wire_send`` by
        (origin, flush seq). The stamp is observability context only —
        a missing/corrupt stamp decodes to None upstream and message
        handling proceeds identically (plenum-lint PT015 pins that no
        consensus path can reach stamp content)."""
        if stamp is None or not self.tracer.enabled:
            return
        _, recv_wall = self.tracer.clock_pair()
        self.tracer.instant(
            "wire_recv", cat,
            key="%s:%d" % (stamp.origin, stamp.seq),
            origin=stamp.origin, seq=stamp.seq, frm=frm,
            sent_perf=stamp.perf_ts, sent_wall=stamp.wall_ts,
            recv_wall=recv_wall)

    @staticmethod
    def _split_columns_by_inst(sec, group, slot: int) -> None:
        """Route one vote-column section to every instance present in
        its instId column. The section is handed over WHOLE — each
        instance's columnar precheck discards the other instances'
        rows in the same scalar pass it already runs — because at
        wire-typical sizes (a few votes per instance per envelope)
        per-instance fancy-index slicing costs more than the repeated
        C-level compares it would save (the digest_match_mask
        measurement, again)."""
        seen = dict.fromkeys(sec.inst.tolist())
        for inst in seen:
            group(inst)[slot].append(sec)

    # ================================================= pipeline runtime

    def _drain_pipeline(self):
        """Deliver every queued pipeline job on the prod thread.
        Timer-armed at submission with ZERO delay, so the drain fires
        at the same simulated instant the serial path would have
        processed the delivery — byte-equal roots by construction —
        while the parse worker runs ahead of the prod thread inside
        each same-instant burst (all peers' envelopes from one flush
        sweep land together; parse of job i+1 overlaps dispatch of
        job i). Also called from service(), start_catchup and
        ViewChangeStarted so no job straddles a protocol epoch."""
        self._drain_scheduled = False
        if self._pipeline is not None:
            self._pipeline.drain()

    def _pipeline_parse(self, payload, frm: str):
        """WORKER-THREAD stage: payload bytes → ParsedEnvelope
        (immutable numpy views over the immutable buffer), the
        receive-instant journey anchor, and the advisory ed25519
        pre-screen. Touches NO consensus state. A FlatWireError
        propagates to the drain as the job's error — the suspicion is
        raised on the prod thread, in arrival order."""
        with self.tracer.span(
                "wire_parse", CAT_3PC,
                n=len(payload) if isinstance(
                    payload, (bytes, bytearray)) else 0):
            env = flat_wire.parse_envelope(payload)
        self._note_flat_stamp(env, frm)
        self._prescreen_propagates(env)
        return env

    def _prescreen_propagates(self, env) -> None:
        """WORKER-THREAD stage: verify every screenable PROPAGATE
        signature against its identifier-DERIVED (cryptonym) verkey
        and warm the positive-verdict cache, so the prod thread's
        authenticate_propagated skips the scalar verify on the hit
        path. Domain state is consensus state the worker must not
        read, so a request whose verkey lives only in domain state
        simply misses the cache and verifies on the prod thread
        exactly as before — filter, not authority, the gateway's
        argument. The port's scalar verify hashes and decodes in
        Python (only the point check is in C, csrc/ed25519_host.c), so
        it holds the GIL for most of its time: the overlap with the
        prod thread is what the GIL leaves of it."""
        cache = self._prescreen_cache
        if cache is None:
            return
        items = []
        for sec in env.sections:
            if sec.kind != flat_wire.KIND_PROPAGATE:
                continue
            for i in range(sec.n):
                try:
                    req = sec.request(i)
                except Exception:
                    continue   # a bad entry costs only itself
                item = self._prescreen_item(req)
                # the pool relays every request ~n times (one PROPAGATE
                # per peer) and client intake verified it once already:
                # triples the cache has seen — from the authenticator's
                # warm-on-verify or an earlier copy — cost a dict probe
                # here, not a verify
                if item is not None and not cache.check(item):
                    items.append(item)
        if not items:
            return
        t0 = time.perf_counter()
        try:
            results = self._prescreen_verifier.verify_batch(items)
        except (ValueError, TypeError, RuntimeError) as e:
            # advisory: a broken screen = all-miss, never an outcome
            logger.debug("%s: pre-screen verify failed: %s",
                         self.name, e)
            return
        for item, ok in zip(items, results):
            if ok:
                cache.add(*item)
        self.telemetry.observe(
            TM.PIPELINE_PRESCREEN_MS,
            (time.perf_counter() - t0) * 1e3)

    @staticmethod
    def _prescreen_item(msg) -> Optional[tuple]:
        """(signing bytes, sig64, vk32) for a single-signature request
        dict using only sender-supplied material (the gateway's
        _verify_item shape), or None when unscreenable."""
        if not isinstance(msg, dict):
            return None
        sig = msg.get("signature")
        idr = msg.get("identifier")
        if not isinstance(sig, str) or not isinstance(idr, str) \
                or msg.get("signatures"):
            return None
        from plenum_tpu_torch.common.serializers.base58 import b58decode
        from plenum_tpu_torch.common.serializers.serialization import (
            serialize_msg_for_signing)
        from plenum_tpu_torch.crypto.signer import verkey_from_identifier
        try:
            sig_raw = b58decode(sig)
            vk = verkey_from_identifier(idr, None)
            payload = {k: v for k, v in msg.items()
                       if k not in ("signature", "signatures")}
            ser = serialize_msg_for_signing(payload)
        except (ValueError, TypeError, KeyError):
            return None         # unscreenable shape: full verify later
        if len(sig_raw) != 64 or len(vk) != 32:
            return None
        return (ser, sig_raw, vk)

    def _pipeline_deliver(self, job) -> None:
        """PROD-THREAD delivery of one pipeline job, in arrival
        order. Blacklist verdicts, suspicions and every consensus
        side effect happen here — the worker only turned bytes into
        views. Non-FlatBatch jobs ride the serial path whole."""
        msg, frm = job.msg, job.frm
        if not isinstance(msg, FlatBatch):
            self._serial_incoming(msg, frm)
            return
        if self.blacklister.is_blacklisted(frm):
            return
        if job.error is not None:
            if isinstance(job.error, flat_wire.FlatWireError):
                self._flat_wire_suspicion(frm, job.error)
                return
            raise job.error
        self._dispatch_parsed_flat(job.result, frm)
        self._arm_outbox_flush()

    def _get_finalised_request(self, digest: str) -> Optional[Request]:
        state = self.propagator.requests.get(digest)
        return state.request if state else None

    # ===================================================== commit hooks

    def _on_backup_ordered(self, ordered: Ordered):
        """Backup instances never execute; they only feed the monitor's
        master-vs-backup throughput + latency comparisons (RBFT)."""
        self.metrics.add_event(MetricsName.BACKUP_ORDERED, 1)
        self.monitor.requests_ordered_bulk(
            [(d, None) for d in ordered.valid_reqIdr], ordered.instId)

    def _on_batch_committed(self, ordered: Ordered, committed_txns):
        """Send Replies with audit paths; update dedup index; free reqs."""
        with self.metrics.measure_time(MetricsName.REPLY_TIME), \
                self.telemetry.timer(TM.STAGE_REPLY_MS), \
                self.tracer.span(
                    "reply", CAT_REPLY,
                    key="%d:%d" % (ordered.viewNo, ordered.ppSeqNo),
                    txns=len(committed_txns or [])):
            self._on_batch_committed_inner(ordered, committed_txns)

    def _on_batch_committed_inner(self, ordered: Ordered, committed_txns):
        self.metrics.add_event(MetricsName.ORDERED_BATCH_COMMITTED,
                               len(committed_txns or []))
        if committed_txns:
            self.telemetry.count(TM.ORDERED_REQUESTS, len(committed_txns))
        self.observable.batch_committed(ordered.ledgerId,
                                        committed_txns or [])
        ledger = self.db_manager.get_ledger(ordered.ledgerId)
        # locals hoisted out of the per-txn loop: this runs once per
        # ordered request on every node
        from plenum_tpu_torch.common.constants import (
            TXN_METADATA, TXN_METADATA_SEQ_NO, TXN_PAYLOAD,
            TXN_PAYLOAD_METADATA, TXN_PAYLOAD_METADATA_DIGEST,
            TXN_PAYLOAD_METADATA_FROM, TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST)
        seq_no_put = self.seq_no_db.put
        req_clients_pop = self._req_clients.pop
        rejected_pop = self._rejected_digests.pop
        free_request = self.propagator.requests.free
        tm_enabled = self.telemetry.enabled
        tm_intake_pop = self._tm_intake_ts.pop
        tm_observe = self.telemetry.observe
        tm_now = self.telemetry.clock() if tm_enabled else 0.0
        inst_id = ordered.instId
        lid_prefix = "%d:" % ordered.ledgerId
        reply_work = []       # (client_id, txn, seq_no) pending proofs
        ordered_pairs = []    # (digest, author) for ONE monitor call
        for txn in committed_txns or []:
            md = txn.get(TXN_PAYLOAD, {}).get(TXN_PAYLOAD_METADATA, {})
            seq_no = txn.get(TXN_METADATA, {}).get(TXN_METADATA_SEQ_NO)
            payload_digest = md.get(TXN_PAYLOAD_METADATA_PAYLOAD_DIGEST)
            if payload_digest:
                seq_no_put(payload_digest.encode(),
                           (lid_prefix + str(seq_no)).encode())
            digest = md.get(TXN_PAYLOAD_METADATA_DIGEST)
            if digest:
                ordered_pairs.append(
                    (digest, md.get(TXN_PAYLOAD_METADATA_FROM)))
                rejected_pop(digest, None)
                if tm_enabled:
                    t0 = tm_intake_pop(digest, None)
                    if t0 is not None:
                        tm_observe(TM.ORDERED_E2E_MS, (tm_now - t0) * 1e3)
            client_id = req_clients_pop(digest, None)
            if client_id is not None and self._clients_attached:
                reply_work.append((client_id, txn, seq_no))
            if digest:
                free_request(digest)
        if ordered_pairs:
            self.monitor.requests_ordered_bulk(ordered_pairs, inst_id)
        if reply_work:
            # ONE memoized proof pass for the whole batch: the paths
            # share all upper tree nodes (merkleInfoBatch), vs an
            # independent O(log n) walk per reply
            try:
                infos = ledger.merkleInfoBatch(
                    [seq_no for _, _, seq_no in reply_work])
            except Exception:
                # one malformed entry must not strip proofs from the
                # whole batch: degrade per reply, like the old path
                logger.warning("%s: batch audit-path construction "
                               "failed; falling back per reply",
                               self.name, exc_info=True)
                infos = []
                for _, _, seq_no in reply_work:
                    try:
                        infos.append(ledger.merkleInfo(seq_no))
                    except Exception:
                        infos.append(None)
            for (client_id, txn, seq_no), info in zip(reply_work, infos):
                result = dict(txn)
                if info is not None:
                    result.update(info)
                self._reply_to_client(client_id, Reply(result=result))
        if ordered.ledgerId == POOL_LEDGER_ID:
            for txn in committed_txns or []:
                self.pool_manager.process_committed_txn(txn)

    def _on_request_rejected(self, digest: str, reason: str,
                             pp_seq_no: int):
        """A request failed dynamic validation at apply time: tell the
        waiting client (reference: Reject from _apply_pre_prepare
        rejects). Apply is SPECULATIVE (uncommitted) — a view-change
        re-order can still commit this request later, so the client
        mapping and the in-flight entry survive until the batch that
        excluded it (seq recorded here) reaches a STABLE checkpoint
        (_gc_rejected)."""
        if digest in self._rejected_digests:
            self._rejected_digests[digest] = max(
                self._rejected_digests[digest], pp_seq_no)
            return
        self._rejected_digests[digest] = pp_seq_no
        request = self._get_finalised_request(digest)
        client_id = self._req_clients.get(digest)
        if client_id is not None and request is not None:
            self._reply_to_client(client_id, Reject(
                identifier=request.identifier or "unknown",
                reqId=request.reqId or 0, reason=reason))

    def _gc_rejected(self, msg):
        """Stable checkpoint: requests rejected in batches AT OR BELOW it
        can never be re-ordered — free their in-flight state so client
        retries get answered instead of swallowed by propagator dedup.
        Rejections in still-speculative batches above the checkpoint must
        survive (a re-order may yet commit them)."""
        stable_seq = msg.last_stable_3pc[1]
        for digest in [d for d, seq in self._rejected_digests.items()
                       if seq <= stable_seq]:
            del self._rejected_digests[digest]
            self._req_clients.pop(digest, None)
            self._tm_intake_ts.pop(digest, None)
            self.propagator.requests.free(digest)

    def _committed_reply(self, request: Request) -> Optional[Reply]:
        raw = self.seq_no_db.get_or_none(request.payload_digest.encode())
        if raw is None:
            return None
        lid, seq_no = bytes(raw).decode().split(":")
        ledger = self.db_manager.get_ledger(int(lid))
        txn = ledger.getBySeqNo(int(seq_no))
        if txn is None:
            return None
        result = dict(txn)
        result.update(ledger.merkleInfo(int(seq_no)))
        return Reply(result=result)

    # ========================================================== catchup

    def start_catchup(self):
        """Stop participating, sync every ledger from peers, then resume
        (reference node.py:2610 start_catchup + §3.4)."""
        if self.leecher.in_progress:
            return
        # per-stage drain: no parsed-but-undelivered envelope may
        # straddle the catchup epoch (it would land on post-catchup
        # consensus state); re-entrant drains no-op
        self._drain_pipeline()
        logger.info("%s starting catchup", self.name)
        self.tracer.instant("catchup_start", CAT_RECOVERY)
        # pool-health bridge from the recovery lane
        self.telemetry.count(TM.CATCHUPS)
        self._catchup_started_at = __import__("time").perf_counter()
        self._catchup_started_sim = self.timer.get_current_time()
        # reads degrade gracefully: keep serving the last committed
        # (BLS-signed) roots while catchup rewrites state txn by txn
        self.db_manager.pin_read_roots()
        self.mode_participating = False
        for replica in self.replicas:
            replica.data.node_mode_participating = False
        # uncommitted work must go before catchup txns land on the
        # ledgers (reference preLedgerCatchUp: replicas revert unordered
        # batches); the pool's committed history is authoritative
        reverted = self.executor.revert_unordered_batches()
        if reverted:
            logger.info("%s reverted %d uncommitted batches for catchup",
                        self.name, reverted)
        self.replica.ordering.prepare_for_catchup()
        self.leecher.start()

    def _on_catchup_txn(self, ledger_id: int, txn: dict):
        """Apply one caught-up txn: ledger append + state update
        (reference postTxnFromCatchupAddedToLedger node.py:1748)."""
        self.metrics.add_event(MetricsName.CATCHUP_TXNS_RECEIVED, 1)
        if ledger_id == AUDIT_LEDGER_ID:
            # every audit txn records each ledger's state root at its
            # batch: feed the ts store so state-at-a-time reads resolve
            # inside caught-up history too (live nodes get these from
            # TsStoreBatchHandler at commit)
            ts_store = self.db_manager.get_store("state_ts")
            txn_time = get_txn_time(txn)
            if ts_store is not None and txn_time is not None:
                from plenum_tpu_torch.server.batch_handlers import (
                    AUDIT_TXN_STATE_ROOT)
                roots = get_payload_data(txn).get(
                    AUDIT_TXN_STATE_ROOT) or {}
                for lid_str, root_b58 in roots.items():
                    lid = int(lid_str)
                    ledger = self.db_manager.get_ledger(lid)
                    if ledger is not None:
                        ts_store.set(txn_time,
                                     ledger.strToHash(root_b58), lid)
        from plenum_tpu_torch.common.txn_util import get_payload_digest, get_type
        ledger = self.db_manager.get_ledger(ledger_id)
        ledger.add(dict(txn))
        txn_type = get_type(txn)
        handler = self.write_manager.request_handlers.get(txn_type)
        if handler is not None and handler.state is not None \
                and handler.ledger_id == ledger_id:
            handler.update_state(txn, None, None, is_committed=True)
            handler.state.commit()
        payload_digest = get_payload_digest(txn)
        if payload_digest:
            seq_no = get_seq_no(txn)
            self.seq_no_db.put(payload_digest.encode(),
                               "{}:{}".format(ledger_id, seq_no).encode())
        if ledger_id == POOL_LEDGER_ID:
            self.pool_manager.process_committed_txn(txn)

    def _on_catchup_finished(self):
        """Adopt 3PC position from the audit ledger, resume participating
        (reference allLedgersCaughtUp node.py:1790)."""
        # audit txns record each batch's ORIGINAL view (stable under
        # re-ordering), so the pool's CURRENT view comes from peer
        # evidence gathered during catchup (f+1-supported estimate)
        self._adopt_3pc_from_audit(
            pool_view=self.leecher.pool_view_estimate())
        # recovery over: reads resume serving the live committed roots
        # (new multi-sigs arrive with the next ordered batches) — unless
        # a view change is still pending, in which case the pin survives
        # until NewViewAccepted (ordering is paused that whole window,
        # so the caught-up roots would stay unsigned throughout it)
        if not self.replica.data.waiting_for_new_view:
            self.db_manager.unpin_read_roots()
        self.tracer.instant(
            "catchup_done", CAT_RECOVERY,
            sim_s=round(self.timer.get_current_time()
                        - getattr(self, "_catchup_started_sim",
                                  self.timer.get_current_time()), 3),
            bad_peers=len(self.leecher.bad_peers))
        if self.name not in self.pool_manager.validators:
            # catchup may have delivered our own demotion — a
            # non-validator must not resume voting
            logger.info("%s not a validator after catchup — staying "
                        "passive", self.name)
            return
        self.mode_participating = True
        for replica in self.replicas:
            replica.data.node_mode_participating = True
        self.replica.ordering.on_catchup_finished()
        if self.freshness_checker is not None:
            # stale timestamps reflect OUR absence, not the primary's
            # negligence — restart the watchdog clocks or a freshly
            # caught-up node votes out a healthy primary
            self.freshness_checker.reset_all(self.timer.get_current_time())
        started = getattr(self, "_catchup_started_at", None)
        if started is not None:
            self.metrics.add_event(
                MetricsName.CATCHUP_TIME,
                __import__("time").perf_counter() - started)
            self._catchup_started_at = None
        logger.info("%s catchup finished; last_ordered=%s", self.name,
                    self.replica.data.last_ordered_3pc)

    # ========================================================== helpers

    def _verkey_from_domain_state(self, identifier: str) -> Optional[str]:
        handler = self.write_manager.request_handlers.get(NYM)
        if handler is None or handler.state is None:
            return None
        return (handler.cached_nym_record(identifier) or {}).get(VERKEY)

    def _audit_root_at(self, pp_seq_no: int) -> str:
        """Checkpoint digest: committed audit-ledger root (all honest
        nodes have identical audit ledgers at the same pp_seq_no)."""
        audit = self.db_manager.get_ledger(AUDIT_LEDGER_ID)
        return audit.root_hash

    def _flush_telemetry(self):
        """One telemetry flush: sample the pool-health gauges (backlog
        depth, finalised-queue depth, ordering stash sizes), append a
        flush-history sample (the Perfetto counter-track time axis),
        and rewrite this node's Prometheus exposition file when
        Config.TELEMETRY_PROM_DIR is set."""
        tm = self.telemetry
        if not tm.enabled:
            return
        reqs = getattr(self.propagator, "requests", None)
        # pipeline jobs awaiting prod delivery are backlog the
        # admission ladder must see — backpressure propagates to the
        # gateway front door instead of pooling in the queue
        pipe_depth = self._pipeline.depth \
            if self._pipeline is not None else 0
        tm.gauge(TM.BACKLOG_DEPTH,
                 (len(reqs) if reqs is not None else 0) + pipe_depth)
        if self._pipeline is not None:
            tm.gauge(TM.PIPELINE_QUEUE_DEPTH, pipe_depth)
        ordering = getattr(self.replica, "ordering", None)
        if ordering is not None:
            tm.gauge(TM.REQUEST_QUEUE_DEPTH,
                     sum(len(q) for q in ordering.requestQueues.values()))
            stasher = getattr(ordering, "_stasher", None)
            if stasher is not None:
                tm.gauge(TM.STASH_DEPTH, stasher.stash_size())
        tm.flush()
        prom_dir = getattr(self.config, "TELEMETRY_PROM_DIR", None)
        if prom_dir:
            try:
                os.makedirs(prom_dir, exist_ok=True)
                tm.write_prometheus(os.path.join(
                    prom_dir, "%s.prom" % self.name.lower()))
            except OSError:
                logger.warning("%s: telemetry prom write failed",
                               self.name, exc_info=True)

    def service(self):
        """One prod tick: all protocol instances (master + backups)."""
        with self.metrics.measure_time(MetricsName.NODE_PROD_TIME):
            # any parse jobs still queued (timer starved between
            # deliveries and this tick) deliver before consensus work
            if self._pipeline is not None:
                self._pipeline.drain()
            # propagates queued this tick (intake + batch echoes) leave
            # as ONE PROPAGATE_BATCH before consensus work runs
            self.propagator.flush()
            count = self.replicas.service()
            # every instance's 3PC votes queued this tick (from
            # send_3pc_batch above AND from inbound processing since the
            # last tick) leave as ONE THREE_PC_BATCH
            if self._outbox_3pc is not None:
                self._outbox_3pc.flush()
            return count

    # ------------------------------------------------------- inspection

    @property
    def domain_ledger(self):
        return self.db_manager.get_ledger(DOMAIN_LEDGER_ID)

    @property
    def audit_ledger(self):
        return self.db_manager.get_ledger(AUDIT_LEDGER_ID)

    @property
    def last_ordered(self):
        return self.replica.last_ordered

    @property
    def view_no(self):
        return self.replica.view_no

    @property
    def master_primary_name(self):
        return self.replica.data.primary_name
