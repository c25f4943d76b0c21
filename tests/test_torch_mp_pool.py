"""The headline deployment of the port on the CPU: four node processes
(`python -m plenum_tpu_torch.start_node --device cpu`) over TCP, booted
from a pool directory that the JAX package's generate_pool wrote, with the
port's verify daemon on the CPU, order 20 signed NYM writes
(plenum_tpu_torch.testing.mp_pool, bench.py run_multiprocess_pool's
shape), once for each of the client's send orders. Every node replies to
every write; the domain, audit and state roots read back from the nodes'
data directories are equal on every node; the committed domain txns
replayed through the JAX package's Ledger and NYM handler, and through
the port's own host Ledger and trie, give the same domain and state
roots; every node's latest state root carries a verifying BLS
multi-signature.

Carrying state across: the port's generate_pool writes byte-equal keys,
genesis files and wallets to the JAX package's for the same randomness,
and a JAX BlsStore's entries read back in the port as equal
MultiSignatures. Neither needs a converter in carry.py."""
import os
import random

import pytest

from plenum_tpu.bootstrap import generate_pool as jax_generate_pool
from plenum_tpu.common.constants import DOMAIN_LEDGER_ID as JAX_DOMAIN
from plenum_tpu.consensus.bls_bft_replica import BlsStore as JaxBlsStore
from plenum_tpu.crypto import bls as jbls
from plenum_tpu.ledger.ledger import Ledger as JaxLedger
from plenum_tpu.server.database_manager import (
    DatabaseManager as JaxDatabaseManager)
from plenum_tpu.server.request_handlers import NymHandler as JaxNymHandler
from plenum_tpu.state.pruning_state import PruningState as JaxState
from plenum_tpu.storage.kv_file import KeyValueStorageFile as JaxKvFile
from plenum_tpu.storage.kv_memory import KeyValueStorageInMemory as JaxKv
from plenum_tpu_torch.bootstrap import generate_pool
from plenum_tpu_torch.consensus.bls_bft_replica import BlsStore
from plenum_tpu_torch.crypto import bls
from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile
from plenum_tpu_torch.testing import mp_pool

N_WRITES = 20


@pytest.fixture(scope="module", params=mp_pool.ORDERS)
def run(request):
    reqs = mp_pool.make_mp_requests(N_WRITES + 1)
    # on the CPU the scalar check beats the kernel's plain version at
    # these batch sizes, so the daemon keeps the JAX package's floor
    return mp_pool.run_multiprocess_pool(
        reqs, "remote", device="cpu", timeout=60,
        extra_conf={"VERIFY_DAEMON_CPU_FLOOR": 512},
        generate_pool=jax_generate_pool, order=request.param)


def test_every_node_replies_to_every_write(run):
    assert run["ordered"] == run["required"] == N_WRITES
    assert set(run["nodes"]) == set(mp_pool.NAMES)
    for info in run["nodes"].values():
        assert info["device"] == "cpu" and info["view_no"] >= 0
        # the probe, the writes and the trustee + 4 steward genesis NYMs
        assert info["domain_size"] == N_WRITES + 1 + 5
    assert run["daemon"]["served"] >= 4 * N_WRITES


def test_roots_equal_on_every_node_and_to_a_jax_replay(run):
    nodes = run["nodes"].values()
    roots = {(n["domain_root"], n["audit_root"], n["state_root"])
             for n in nodes}
    assert len(roots) == 1
    txns = next(iter(nodes))["domain_txns"]
    dm = JaxDatabaseManager()
    ledger, state = JaxLedger(), JaxState(JaxKv())
    dm.register_new_database(JAX_DOMAIN, ledger, state)
    handler = JaxNymHandler(dm)
    for txn in txns:
        ledger.add(dict(txn))
        handler.update_state(txn, None, None, is_committed=True)
    state.commit()
    (domain_root, _, state_root), = roots
    assert ledger.root_hash == domain_root
    assert state.committedHeadHash_b58 == state_root


def test_roots_equal_a_host_replay_through_the_port(run):
    """mp_pool.replay_roots, which chip_smoke.py holds the card's node
    processes against: the port's host Ledger and trie, no kernel."""
    for info in run["nodes"].values():
        got = mp_pool.replay_roots(info["domain_txns"])
        assert got == {"domain_root": info["domain_root"],
                       "state_root": info["state_root"]}


def test_latest_state_root_carries_a_verifying_multi_signature(run):
    for info in run["nodes"].values():
        assert info["multi_sig_ok"], info["multi_sig"]
        assert info["multi_sig"]["value"]["state_root_hash"] == \
            info["state_root"]


def test_networked_client_confirms_and_every_node_dumps_its_info():
    """client="networked": the port's NetworkedPoolClient confirms every
    write on f + 1 matching replies, and each node's validator-info dump,
    written on a one-second interval, gives the replay's domain size and
    roots and the genesis's pool counts (chip_smoke.py phase 7's checks
    of its client run)."""
    reqs = mp_pool.make_mp_requests(N_WRITES + 1)
    run = mp_pool.run_multiprocess_pool(
        reqs, "remote", device="cpu", timeout=60,
        extra_conf={"VERIFY_DAEMON_CPU_FLOOR": 512},
        generate_pool=jax_generate_pool, client="networked",
        info_dump_s=1.0)
    assert run["driver"] == "networked"
    assert run["ordered"] == run["required"] == N_WRITES
    assert len(run["client"]["seq_nos"]) == N_WRITES
    nodes = run["nodes"]
    txns = nodes["Alpha"]["domain_txns"]
    replay = mp_pool.replay_roots(txns)
    for info in nodes.values():
        node_info = info["validator_info"]["Node_info"]
        pool_info = info["validator_info"]["Pool_info"]
        assert node_info["Ledger_sizes"]["domain"] == len(txns)
        assert node_info["Committed_ledger_root_hashes"]["domain"] == \
            replay["domain_root"]
        assert node_info["Committed_state_root_hashes"]["domain"] == \
            replay["state_root"]
        assert node_info["Ledger_sizes"]["pool"] == len(mp_pool.NAMES)
        assert pool_info["Total_nodes_count"] == len(mp_pool.NAMES)
        assert sorted(pool_info["Validators"]) == sorted(mp_pool.NAMES)


def _seeded_urandom(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: rng.randbytes(n))


def _files(base):
    out = {}
    for root, _, files in os.walk(base):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, base)] = fh.read()
    return out


def test_generate_pool_writes_the_jax_packages_files(tmp_path, monkeypatch):
    kw = dict(base_port=9700, trustee_seed=mp_pool.MP_TRUSTEE_SEED)
    _seeded_urandom(monkeypatch, 5)
    summary = generate_pool(str(tmp_path / "port"), mp_pool.NAMES, **kw)
    _seeded_urandom(monkeypatch, 5)
    jax_summary = jax_generate_pool(str(tmp_path / "jax"), mp_pool.NAMES,
                                    **kw)
    assert summary == jax_summary
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax) and len(port) == 11
    assert port == jax


def test_jax_bls_store_entries_read_back_in_the_port(tmp_path):
    signers = [jbls.BlsCryptoSignerPlenum.generate(bytes([i]) * 32)[0]
               for i in range(1, 5)]
    kv = JaxKvFile(str(tmp_path), "bls_store")
    store = JaxBlsStore(kv)
    written = []
    for k in range(3):
        value = jbls.MultiSignatureValue(1, "root%d" % k, "txn%d" % k,
                                         "pool", 1600000000 + k)
        sig = jbls.BlsCryptoVerifierPlenum().create_multi_sig(
            [s.sign(value.as_single_value()) for s in signers[:3]])
        multi = jbls.MultiSignature(sig, ["Alpha", "Beta", "Gamma"], value)
        store.put(multi)
        written.append(multi)
    kv.close()
    port_kv = KeyValueStorageFile(str(tmp_path), "bls_store", read_only=True)
    port_store = BlsStore(port_kv)
    for multi in written:
        got = port_store.get(multi.value.state_root_hash)
        assert got == bls.MultiSignature.from_dict(multi.as_dict())
        assert bls.BlsCryptoVerifierPlenum().verify_multi_sig(
            got.signature, got.value.as_single_value(),
            [s.pk for s in signers[:3]])
    assert len(port_store.items()) == 3
    port_kv.close()
