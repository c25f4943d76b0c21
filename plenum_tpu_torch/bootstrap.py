"""Node/pool bootstrap: key init, genesis generation, node start.

The importable core behind scripts/ (reference: setup.py:145-154 ships
init_plenum_keys, generate_plenum_pool_transactions, start_plenum_node;
logic in plenum/common/keygen_utils.py + test_node_bootstrap). Layout
under a base dir:

    <base>/<node_name>/node_keys.json       transport seed + verkey (0600)
    <base>/<node_name>/data/                durable KV stores
    <base>/pool_transactions_genesis        one NODE txn per line
    <base>/domain_transactions_genesis      one NYM txn per line

The genesis files carry everything a joining node needs: NODE txns hold
alias/verkey/ips/ports (the transport registry IS the pool ledger,
reference pool_manager.py), domain txns hold steward/trustee NYMs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from plenum_tpu_torch.common.constants import (
    ALIAS, BLS_KEY, BLS_KEY_PROOF, CLIENT_IP, CLIENT_PORT, DATA, NODE,
    NODE_IP, NODE_PORT, NYM, ROLE, SERVICES, STEWARD, TARGET_NYM, TRUSTEE,
    VALIDATOR, VERKEY)
from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.txn_util import get_payload_data, get_type, \
    init_empty_txn
from plenum_tpu_torch.ledger.genesis_txn import (
    GenesisTxnInitiatorFromFile, create_genesis_txn_file)

POOL_GENESIS_FILE = "pool_transactions_genesis"
DOMAIN_GENESIS_FILE = "domain_transactions_genesis"
NODE_KEYS_FILE = "node_keys.json"


# ------------------------------------------------------------------ keys

def init_node_keys(name: str, base_dir: str, seed: bytes = None,
                   bls_seed: bytes = None, force: bool = False) -> dict:
    """Create (or load) a node's transport + BLS identity on disk."""
    from plenum_tpu_torch.network.keys import NodeKeys
    from plenum_tpu_torch.crypto.bls import generate_bls_keys

    node_dir = os.path.join(base_dir, name)
    os.makedirs(node_dir, mode=0o700, exist_ok=True)
    path = os.path.join(node_dir, NODE_KEYS_FILE)
    if os.path.exists(path) and not force:
        with open(path) as f:
            existing = json.load(f)
        if seed is not None and existing.get("seed") != b58encode(seed):
            raise ValueError(
                "{} already has keys from a different seed; pass "
                "force=True to overwrite".format(name))
        return existing
    keys = NodeKeys(seed)
    _, bls_pk, bls_pop = generate_bls_keys(bls_seed or keys.seed)
    info = {
        "name": name,
        "seed": b58encode(keys.seed),
        "verkey": keys.verkey,
        "bls_key": bls_pk,
        "bls_pop": bls_pop,
    }
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(info, f, indent=2)
    return info


def load_node_keys(name: str, base_dir: str):
    from plenum_tpu_torch.network.keys import NodeKeys
    with open(os.path.join(base_dir, name, NODE_KEYS_FILE)) as f:
        info = json.load(f)
    return NodeKeys(b58decode(info["seed"])), info


# --------------------------------------------------------------- genesis

def node_genesis_txn(name: str, verkey: str, node_ip: str, node_port: int,
                     client_ip: str, client_port: int, steward_nym: str,
                     bls_key: str = None, bls_pop: str = None) -> dict:
    txn = init_empty_txn(NODE)
    data = {ALIAS: name, NODE_IP: node_ip, NODE_PORT: node_port,
            CLIENT_IP: client_ip, CLIENT_PORT: client_port,
            SERVICES: [VALIDATOR]}
    if bls_key:
        data[BLS_KEY] = bls_key
    if bls_pop:
        data[BLS_KEY_PROOF] = bls_pop
    get_payload_data(txn).update({
        TARGET_NYM: verkey,      # node identity = transport verkey
        DATA: data,
    })
    txn["txn"]["metadata"]["from"] = steward_nym
    return txn


def nym_genesis_txn(nym: str, verkey: str, role: str = None) -> dict:
    txn = init_empty_txn(NYM)
    data = {TARGET_NYM: nym, VERKEY: verkey}
    if role is not None:
        data[ROLE] = role
    get_payload_data(txn).update(data)
    return txn


def generate_pool(base_dir: str, node_names: Sequence[str],
                  ips: Optional[Sequence[str]] = None,
                  base_port: int = 9700,
                  trustee_seed: bytes = None) -> dict:
    """Create a complete pool under base_dir: per-node keys, one steward
    wallet per node, a trustee wallet, and the two genesis files.
    → summary dict (node infos + steward/trustee identifiers)."""
    from plenum_tpu_torch.client.wallet import Wallet, WalletStorageHelper
    from plenum_tpu_torch.crypto.signer import DidSigner

    ips = list(ips) if ips else ["127.0.0.1"] * len(node_names)
    helper = WalletStorageHelper(os.path.join(base_dir, "keyrings"))

    trustee = DidSigner(seed=trustee_seed)
    trustee_wallet = Wallet("trustee")
    trustee_wallet.add_identifier(signer=trustee)
    helper.save_wallet(trustee_wallet)

    domain_txns = [nym_genesis_txn(trustee.identifier, trustee.verkey,
                                   TRUSTEE)]
    pool_txns = []
    summary = {"nodes": [], "trustee": trustee.identifier}
    for i, name in enumerate(node_names):
        info = init_node_keys(name, base_dir)
        steward = DidSigner()
        wallet = Wallet("steward_" + name)
        wallet.add_identifier(signer=steward)
        helper.save_wallet(wallet)
        domain_txns.append(nym_genesis_txn(
            steward.identifier, steward.verkey, STEWARD))
        pool_txns.append(node_genesis_txn(
            name, info["verkey"], ips[i], base_port + 2 * i,
            ips[i], base_port + 2 * i + 1, steward.identifier,
            bls_key=info.get("bls_key"), bls_pop=info.get("bls_pop")))
        summary["nodes"].append({
            "name": name, "verkey": info["verkey"],
            "node_ha": [ips[i], base_port + 2 * i],
            "client_ha": [ips[i], base_port + 2 * i + 1],
            "steward": steward.identifier,
        })
    create_genesis_txn_file(pool_txns, base_dir, POOL_GENESIS_FILE)
    create_genesis_txn_file(domain_txns, base_dir, DOMAIN_GENESIS_FILE)
    return summary


def read_genesis(base_dir: str) -> List[dict]:
    """All genesis txns (pool + domain) for Node bootstrap."""
    txns = []
    for fname in (POOL_GENESIS_FILE, DOMAIN_GENESIS_FILE):
        txns.extend(GenesisTxnInitiatorFromFile(base_dir, fname)())
    return txns


def pool_genesis_txns(base_dir: str) -> List[dict]:
    return list(GenesisTxnInitiatorFromFile(base_dir, POOL_GENESIS_FILE)())


def registry_from_txns(pool_txns: List[dict]) -> Dict[str, "RemoteInfo"]:
    """Transport registry {alias: RemoteInfo} from pool NODE txns —
    the pool ledger IS the connection registry."""
    from plenum_tpu_torch.network.stack import HA, RemoteInfo
    registry = {}
    for txn in pool_txns:
        if get_type(txn) != NODE:
            continue
        data = get_payload_data(txn)
        d = data[DATA]
        registry[d[ALIAS]] = RemoteInfo(
            d[ALIAS], HA(d[NODE_IP], d[NODE_PORT]),
            b58decode(data[TARGET_NYM]))
    return registry


def registry_from_pool_genesis(base_dir: str) -> Dict[str, "RemoteInfo"]:
    return registry_from_txns(pool_genesis_txns(base_dir))


def client_ha_from_txns(pool_txns: List[dict], name: str):
    from plenum_tpu_torch.network.stack import HA
    for txn in pool_txns:
        data = get_payload_data(txn)
        d = data.get(DATA, {})
        if d.get(ALIAS) == name:
            return HA(d[CLIENT_IP], d[CLIENT_PORT])
    raise KeyError("node {} not in pool genesis".format(name))


def client_ha_from_pool_genesis(base_dir: str, name: str):
    return client_ha_from_txns(pool_genesis_txns(base_dir), name)


# ----------------------------------------------------------------- start

def node_store_class():
    """The KV store class of a node's durable stores: the native C engine
    (storage/kv_native.py over csrc/kvlog.c) when it builds here, else the
    pure-Python KeyValueStorageFile. Both write the same .kvlog format, so
    either opens stores the other wrote; the native one keeps values on
    disk (bounded RAM)."""
    from plenum_tpu_torch.storage import kv_native
    if kv_native.available():
        return kv_native.KeyValueStorageNative
    from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile
    return KeyValueStorageFile


def native_backends() -> dict:
    """Which branch each native host source serves in this process:
    "native" (its C build) or "python" (the pure-Python branch, when it
    did not build or PLENUM_TPU_NO_NATIVE is set), with the classes
    PruningState and node_store_class chose."""
    from plenum_tpu_torch.common.serializers import serializers
    from plenum_tpu_torch.state import pruning_state, rlp
    trie = pruning_state._TrieBackend.__name__
    store = node_store_class().__name__
    return {"fastpath": "python" if serializers._fp is None else "native",
            "rlp_c": rlp.BACKEND,
            "mpt_c": "native" if trie == "NativeTrie" else "python",
            "kvlog": "native" if store == "KeyValueStorageNative"
            else "python",
            "trie": trie, "store": store}


def build_networked_node(name: str, base_dir: str, config=None,
                         device=None):
    """Construct a NetworkedNode from on-disk keys + genesis, with
    durable file-backed stores under <base>/<name>/data/. Config is
    layered from <base>/plenum_tpu_config.py + PLENUM_TPU_* env vars
    unless one is passed explicitly. `device` serves the node's kernels:
    None means CUDA and raises without a card; "cpu" runs their plain
    versions. The stores are `node_store_class()`'s (the native kvlog
    engine when csrc/kvlog.c builds, else KeyValueStorageFile), and the
    node dumps its validator info into <base>/<name>/ every
    VALIDATOR_INFO_DUMP_INTERVAL seconds."""
    from plenum_tpu_torch.ops import resolve_device
    device = resolve_device(device)
    if config is None:
        from plenum_tpu_torch.common.config import Config
        config = Config.load(base_dir)
    from plenum_tpu_torch.server.networked_node import NetworkedNode

    keys, _info = load_node_keys(name, base_dir)
    pool_txns = pool_genesis_txns(base_dir)
    registry = registry_from_txns(pool_txns)
    if name not in registry:
        raise KeyError("node {} not in pool genesis".format(name))
    data_dir = os.path.join(base_dir, name, "data")
    os.makedirs(data_dir, exist_ok=True)

    store_class = node_store_class()

    def storage_factory(store_name: str):
        return store_class(data_dir, store_name)

    domain_txns = list(
        GenesisTxnInitiatorFromFile(base_dir, DOMAIN_GENESIS_FILE)())
    from plenum_tpu_torch.utils.metrics import KvStoreMetricsCollector
    return NetworkedNode(
        name, registry, keys,
        node_ha=registry[name].ha,
        client_ha=client_ha_from_txns(pool_txns, name),
        config=config,
        storage_factory=storage_factory,
        genesis_txns=pool_txns + domain_txns,
        metrics=KvStoreMetricsCollector(storage_factory("metrics")),
        info_dir=os.path.join(base_dir, name), device=device)


async def run_node(node, stop_event=None) -> None:
    """Drive a NetworkedNode's prod loop until stop_event is set."""
    import asyncio
    await node.start_async()
    try:
        while stop_event is None or not stop_event.is_set():
            produced = await node.prod()
            await asyncio.sleep(0 if produced else 0.01)
    finally:
        await node.nodestack.stop()
        await node.clientstack.stop()
