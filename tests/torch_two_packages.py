"""Helpers of the port's parity tests that build the same sim pool from
either package: the port (plenum_tpu_torch, its Nodes on device="cpu",
every kernel's plain version) or the JAX package (plenum_tpu, its Nodes
kept on the host: no XLA program runs)."""
import contextlib
import importlib
from types import SimpleNamespace

PORT, JAX = "plenum_tpu_torch", "plenum_tpu"
PACKAGES = (PORT, JAX)
NAMES = ["Alpha", "Beta", "Gamma", "Delta"]
SIM_EPOCH = 1600000000
# the JAX package's nodes stay on the host: no XLA program runs
JAX_HOST_CONF = dict(SHA256_BACKEND="scalar", MERKLE_DEVICE_PROOFS=False,
                     EXEC_MERGED_DEVICE_HASH=False, VERIFIER_PROVIDER="cpu")


def pkg(name):
    """The classes and modules a sim pool needs, from package `name`."""
    mod = lambda m: importlib.import_module(name + "." + m)  # noqa: E731
    return SimpleNamespace(
        name=name,
        Node=mod("server.node").Node,
        Config=mod("common.config").Config,
        MockTimer=mod("testing.mock_timer").MockTimer,
        SimNetwork=mod("testing.sim_network").SimNetwork,
        Random=mod("runtime.sim_random").DefaultSimRandom,
        Signer=mod("crypto.signer").SimpleSigner,
        bls=mod("crypto.bls"),
        bootstrap=mod("bootstrap"),
        adversary=mod("testing.adversary"),
        messages=mod("common.messages.node_messages"),
        internal=mod("common.messages.internal_messages"),
        constants=mod("common.constants"))


def conf(p, **over):
    """A Config of package `p` with `over`; the JAX package's on the
    host."""
    extra = dict(JAX_HOST_CONF) if p.name == JAX else {}
    extra.update(over)
    return p.Config(**extra)


def node_kw(p) -> dict:
    return {"device": "cpu"} if p.name == PORT else {}


@contextlib.contextmanager
def jax_warm_off():
    """The JAX package's state engine compiles nothing at attach."""
    from plenum_tpu.state import device_state
    warm = device_state.DeviceStateEngine.warm
    device_state.DeviceStateEngine.warm = lambda self: None
    try:
        yield
    finally:
        device_state.DeviceStateEngine.warm = warm


# tests/test_adversary.py build_pool's Config
BASE_CONF = dict(Max3PCBatchSize=5, Max3PCBatchWait=0.2, CHK_FREQ=5,
                 LOG_SIZE=15, ToleratePrimaryDisconnection=4,
                 NEW_VIEW_TIMEOUT=8, STATE_FRESHNESS_UPDATE_INTERVAL=3)


def roots(nodes):
    """Every node's (domain, audit, state) roots."""
    return [(n.domain_ledger.root_hash, n.audit_ledger.root_hash,
             bytes(n.db_manager.get_state(1).committedHeadHash).hex())
            for n in nodes]


class Pool:
    """tests/test_adversary.py build_pool for package `p`."""

    def __init__(self, p, net_seed, bls=False, config=BASE_CONF):
        self.p = p
        self.timer = p.MockTimer()
        self.timer.set_time(SIM_EPOCH)
        self.net = p.SimNetwork(self.timer, p.Random(net_seed))
        cfg = conf(p, **config)
        signers, genesis = {}, None
        if bls:
            genesis = []
            for i, n in enumerate(NAMES):
                signers[n], _ = p.bls.BlsCryptoSignerPlenum.generate(
                    bytes([i + 1]) * 32)
                genesis.append(p.bootstrap.node_genesis_txn(
                    n, verkey="v%d" % i, node_ip="127.0.0.1", node_port=1,
                    client_ip="127.0.0.1", client_port=2,
                    steward_nym="S%d" % i, bls_key=signers[n].pk))
        self.replies = {n: [] for n in NAMES}
        self.nodes = [p.Node(
            n, NAMES, self.timer, self.net.create_peer(n), config=cfg,
            client_reply_handler=lambda c, m, n=n: self.replies[n].append(m),
            bls_signer=signers.get(n), genesis_txns=genesis, **node_kw(p))
            for n in NAMES]
        self.suspicions = []
        for node in self.nodes:
            node.replica.internal_bus.subscribe(
                p.internal.RaisedSuspicion,
                lambda msg, *a, name=node.name: self.suspicions.append(
                    (name, msg.ex.code, msg.ex.node)))
        self.adv = None
        self.sc = None

    @property
    def primary(self):
        return next(n for n in self.nodes if n.replica.data.is_primary)

    def others(self):
        return [n for n in self.nodes if n is not self.primary]

    def controller(self, seed):
        self.adv = self.p.adversary.AdversaryController(self.timer, seed=seed)
        self.adv.set_pool(self.nodes)
        return self.adv

    def scenario(self, nodes=None):
        self.sc = self.p.adversary.Scenario(
            self.timer, nodes or self.nodes, adversary=self.adv)
        return self.sc

    def request(self, i, req_id, seed=None):
        client = self.p.Signer(seed=seed or bytes([0x30 + i % 80]) * 32)
        c = self.p.constants
        req = {"identifier": client.identifier, "reqId": req_id,
               "protocolVersion": 2,
               "operation": {"type": c.NYM, c.TARGET_NYM: client.identifier,
                             c.VERKEY: client.verkey}}
        req["signature"] = client.sign(dict(req))
        return req

    def submit(self, i, req_id, to=None, client_id="client1"):
        req = self.request(i, req_id)
        for n in to or self.nodes:
            n.process_client_request(dict(req), client_id)


def live_roots_agree(nodes):
    return len(set(roots(nodes))) == 1


def outcome(pl) -> dict:
    """What must be equal between the packages after a scenario."""
    return {
        "trace": pl.adv.trace_lines() if pl.adv is not None else [],
        "suspicions": list(pl.suspicions),
        "ordered": {n.name: [(o.viewNo, o.originalViewNo, o.ppSeqNo,
                              o.digest, o.stateRootHash, o.txnRootHash,
                              list(o.valid_reqIdr))
                             for o in n.replica.ordered_log]
                    for n in pl.nodes},
        "roots": roots(pl.nodes),
        "views": [n.view_no for n in pl.nodes],
        "multi_sig_keys": {
            n.name: sorted(k for k, _ in n.bls_bft_replica.bls_store.items())
            if n.bls_bft_replica is not None else None for n in pl.nodes},
    }
