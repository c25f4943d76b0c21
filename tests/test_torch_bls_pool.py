"""A BLS-enabled 4-node sim pool of the port (plenum_tpu_torch Nodes on the
CPU, each with a BLS signer) against the JAX package's, on the same
seeded signers (as tests/test_bls_consensus.py seeds them) and the same
40 signed NYM writes: domain, audit and state roots and every BlsStore
multi-signature byte-equal on every node, and the latest state root's
multi-signature verifying under the pool's keys and served with a read's
state proof. Then the shapes of test_bad_bls_share_detected and
test_deferred_share_verify_drops_bad_share_at_order, held against the JAX
package's BlsBftReplica on the same commits. Tolerance: none."""
import copy

import pytest

from plenum_tpu.bootstrap import node_genesis_txn as jax_node_genesis_txn
from plenum_tpu.common.config import Config as JaxConfig
from plenum_tpu.common.messages.node_messages import (
    Commit as JaxCommit, PrePrepare as JaxPrePrepare)
from plenum_tpu.consensus import bls_bft_replica as jrep
from plenum_tpu.crypto import bls as jbls
from plenum_tpu.runtime.sim_random import DefaultSimRandom as JaxRandom
from plenum_tpu.server.node import Node as JaxNode
from plenum_tpu.state import device_state as jax_device_state
from plenum_tpu.testing.mock_timer import MockTimer as JaxTimer
from plenum_tpu.testing.sim_network import SimNetwork as JaxNetwork
from plenum_tpu_torch.bootstrap import node_genesis_txn
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, DOMAIN_LEDGER_ID, POOL_LEDGER_ID, TARGET_NYM)
from plenum_tpu_torch.common.messages.node_messages import Commit, PrePrepare
from plenum_tpu_torch.consensus import bls_bft_replica as prep
from plenum_tpu_torch.crypto import bls
from plenum_tpu_torch.crypto.signer import SimpleSigner
from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
from plenum_tpu_torch.server.node import Node
from plenum_tpu_torch.testing import pool
from plenum_tpu_torch.testing.mock_timer import MockTimer
from plenum_tpu_torch.testing.sim_network import SimNetwork

SIM_EPOCH = 1600000000
N_REQS = 40
CONF = dict(Max3PCBatchSize=10, Max3PCBatchWait=0.2, CHK_FREQ=5, LOG_SIZE=15)
NAMES = pool.NAMES
GET_NYM = "105"


def _signers(mod):
    return {n: mod.BlsCryptoSignerPlenum.generate(bytes([i + 1]) * 32)[0]
            for i, n in enumerate(NAMES)}


def _genesis(make, signers):
    return [make(n, verkey="v%d" % i, node_ip="127.0.0.1", node_port=1,
                 client_ip="127.0.0.1", client_port=2, steward_nym="S%d" % i,
                 bls_key=signers[n].pk) for i, n in enumerate(NAMES)]


def _run(node_cls, conf, timer_cls, net_cls, random_cls, signers, genesis,
         reqs, **kw):
    timer = timer_cls()
    timer.set_time(SIM_EPOCH)
    net = net_cls(timer, random_cls(31))
    nodes = [node_cls(n, NAMES, timer, net.create_peer(n), config=conf,
                      client_reply_handler=lambda c, m: None,
                      bls_signer=signers[n], genesis_txns=genesis, **kw)
             for n in NAMES]
    batch = [(r, "client") for r in reqs]
    for n in nodes:
        n.process_client_batch(batch)
    for _ in range(2000):
        for n in nodes:
            n.service()
        timer.run_for(0.01)
        if all(n.domain_ledger.size >= N_REQS for n in nodes):
            break
    for _ in range(100):        # let the last COMMITs land everywhere
        for n in nodes:
            n.service()
        timer.run_for(0.01)
    return nodes


@pytest.fixture(scope="module")
def pools():
    reqs = pool.make_requests(N_REQS, SimpleSigner(seed=b"\x61" * 32))
    signers, jsigners = _signers(bls), _signers(jbls)
    port = _run(Node, Config(**CONF), MockTimer, SimNetwork,
                DefaultSimRandom, signers, _genesis(node_genesis_txn,
                                                    signers),
                reqs, device="cpu")
    warm = jax_device_state.DeviceStateEngine.warm
    jax_device_state.DeviceStateEngine.warm = lambda self: None
    try:
        jconf = JaxConfig(SHA256_BACKEND="scalar", MERKLE_DEVICE_PROOFS=False,
                          EXEC_MERGED_DEVICE_HASH=False,
                          VERIFIER_PROVIDER="cpu", **CONF)
        ref = _run(JaxNode, jconf, JaxTimer, JaxNetwork, JaxRandom,
                   jsigners, _genesis(jax_node_genesis_txn, jsigners), reqs)
    finally:
        jax_device_state.DeviceStateEngine.warm = warm
    return port, ref, signers


@pytest.mark.parametrize("lid", [DOMAIN_LEDGER_ID, AUDIT_LEDGER_ID,
                                 POOL_LEDGER_ID])
def test_roots_equal_on_every_node(pools, lid):
    port, ref, _ = pools
    assert port[0].domain_ledger.size == N_REQS
    roots = {(n.db_manager.get_ledger(lid).root_hash,
              n.db_manager.get_state(lid).committedHeadHash
              if lid != AUDIT_LEDGER_ID else None) for n in port}
    assert len(roots) == 1
    assert roots == {(n.db_manager.get_ledger(lid).root_hash,
                      n.db_manager.get_state(lid).committedHeadHash
                      if lid != AUDIT_LEDGER_ID else None) for n in ref}


def test_every_multi_signature_byte_equal_on_every_node(pools):
    """Each node's store equals its JAX counterpart's; across nodes the
    signed values agree (the participants may differ: each node
    aggregates the shares that had arrived when it ordered)."""
    port, ref, signers = pools
    stored = [sorted((k, m.as_dict()) for k, m in
                     n.bls_bft_replica.bls_store.items()) for n in port]
    assert stored == [sorted((k, m.as_dict()) for k, m in
                             n.bls_bft_replica.bls_store.items())
                      for n in ref]
    assert stored[0] and all(
        [(k, m["value"]) for k, m in s] ==
        [(k, m["value"]) for k, m in stored[0]] for s in stored)
    verifier = bls.BlsCryptoVerifierPlenum()
    for s in stored:
        for _, m in s:
            multi = bls.MultiSignature.from_dict(m)
            assert verifier.verify_multi_sig(
                multi.signature, multi.value.as_single_value(),
                [signers[p].pk for p in multi.participants])


def test_latest_state_root_carries_a_verifying_multi_signature(pools):
    port, _, signers = pools
    node = port[0]
    root = node.db_manager.get_state(DOMAIN_LEDGER_ID).committedHeadHash_b58
    multi = node.db_manager.bls_store.get(root)
    assert multi is not None and multi.value.state_root_hash == root
    assert bls.BlsCryptoVerifierPlenum().verify_multi_sig(
        multi.signature, multi.value.as_single_value(),
        [signers[p].pk for p in multi.participants])
    # the read handler attaches it to a state proof
    write = pool.make_requests(1, SimpleSigner(seed=b"\x61" * 32))[0]
    sent = []
    node._reply_to_client = lambda c, m: sent.append(m)
    node.process_client_batch([({
        "identifier": write["identifier"], "reqId": 10 ** 6,
        "operation": {"type": GET_NYM,
                      TARGET_NYM: write["operation"][TARGET_NYM]}},
        "reader")])
    proof = sent[-1].to_dict()["result"]["state_proof"]
    assert proof["multi_signature"] == multi.as_dict()


def _pp(cls):
    return cls(instId=0, viewNo=0, ppSeqNo=1, ppTime=SIM_EPOCH,
               reqIdr=["d"], discarded="0", digest="x", ledgerId=1,
               stateRootHash=None, txnRootHash=None, sub_seq_no=0,
               final=False, poolStateRootHash=None)


def _share(rep_mod, signers, name, verifier, keys, pp, commit_cls):
    params = rep_mod.BlsBftReplica(name, signers[name], verifier,
                                   keys).update_commit(
        dict(instId=0, viewNo=0, ppSeqNo=1), pp)
    return commit_cls(**params)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_bad_bls_share_detected(side):
    """With arrival-time checks (BLS_DEFER_SHARE_VERIFY=False) a share
    claimed by the wrong sender fails validate_commit."""
    rep_mod, crypto, pp_cls, commit_cls = (
        (prep, bls, PrePrepare, Commit) if side == "port"
        else (jrep, jbls, JaxPrePrepare, JaxCommit))
    signers = _signers(crypto)
    verifier = crypto.BlsCryptoVerifierPlenum()
    keys = rep_mod.BlsKeyRegister(lambda n: signers[n].pk)
    replica = rep_mod.BlsBftReplica(NAMES[0], signers[NAMES[0]], verifier,
                                    keys, defer_share_verify=False)
    pp = _pp(pp_cls)
    good = _share(rep_mod, signers, NAMES[1], verifier, keys, pp,
                  commit_cls)
    assert replica.validate_commit(good, NAMES[1], pp) is None
    assert replica.validate_commit(good, NAMES[2], pp) is not None


def test_deferred_share_verify_drops_bad_share_at_order():
    """Deferred checks (the default): a replayed share passes arrival but
    is dropped at ordering, on the port as on the JAX package, and both
    store the same multi-signature of the three valid shares."""
    stored = []
    for rep_mod, crypto, pp_cls, commit_cls in (
            (prep, bls, PrePrepare, Commit),
            (jrep, jbls, JaxPrePrepare, JaxCommit)):
        signers = _signers(crypto)
        verifier = crypto.BlsCryptoVerifierPlenum()
        keys = rep_mod.BlsKeyRegister(lambda n: signers[n].pk)
        replica = rep_mod.BlsBftReplica(NAMES[0], signers[NAMES[0]],
                                        verifier, keys,
                                        defer_share_verify=True)
        pp = _pp(pp_cls)
        replica.process_pre_prepare(pp, NAMES[0])
        commits = {}
        for name in NAMES[:3]:
            c = _share(rep_mod, signers, name, verifier, keys, pp,
                       commit_cls)
            assert replica.validate_commit(c, name, pp) is None
            commits[name] = c
        commits[NAMES[3]] = commits[NAMES[2]]
        replica.process_order((0, 1), commits, pp, quorums=None)
        multi = replica.bls_store.get("")
        assert multi.participants == sorted(NAMES[:3])
        assert verifier.verify_multi_sig(
            multi.signature, multi.value.as_single_value(),
            [signers[n].pk for n in multi.participants])
        stored.append(multi.as_dict())
    assert stored[0] == stored[1]


def test_catchup_replies_equal_the_jax_packages(pools):
    """ROADMAP C: the port's seeder read the dropped
    Config.MERKLE_DEVICE_PROOF_MIN and raised AttributeError on every
    CATCHUP_REQ (a lagging node of a multi-process pool could never catch
    up); it now groups proofs by the JAX package's 2,048."""
    from plenum_tpu.common.messages.node_messages import (
        CatchupReq as JaxCatchupReq)
    from plenum_tpu_torch.common.messages.node_messages import CatchupReq
    port, ref, _ = pools
    replies = []
    for node, req_cls in ((port[0], CatchupReq), (ref[0], JaxCatchupReq)):
        sent = []
        node.seeder._network = type("Net", (), {
            "send": lambda self, msg, dst=None: sent.append(
                (msg.to_dict(), dst))})()
        size = node.domain_ledger.size
        node.seeder.process_catchup_req(req_cls(
            ledgerId=DOMAIN_LEDGER_ID, seqNoStart=3, seqNoEnd=size,
            catchupTill=size), "Beta")
        replies.append(sent)
    assert replies[0] and replies[0] == replies[1]


def test_catchup_replies_fit_the_frame_limit(pools, monkeypatch):
    """ROADMAP C 8: a CatchupRep of CATCHUP_REP_CHUNK (1,000) NYM txns
    with their audit paths is ~1 MB, past MSG_LEN_LIMIT (128 KiB), and
    the node stack drops it, so a lagging node of a multi-process pool
    never caught up. The port splits a rep until its frame fits; the JAX
    package sends it whole. Shown here at a limit of 4 KiB: the port's
    reps each fit and carry, merged, the JAX package's txns and paths."""
    from plenum_tpu.common.messages.node_messages import (
        CatchupReq as JaxCatchupReq)
    from plenum_tpu_torch.common.messages.node_messages import CatchupReq
    from plenum_tpu_torch.common.serializers.serializers import (
        MsgPackSerializer)
    limit, wire = 4096, MsgPackSerializer()
    port, ref, _ = pools
    sent = {}
    for node, req_cls in ((port[0], CatchupReq), (ref[0], JaxCatchupReq)):
        out = sent[req_cls] = []
        monkeypatch.setattr(node.seeder, "_config", copy.copy(
            node.seeder._config))
        node.seeder._config.MSG_LEN_LIMIT = limit
        monkeypatch.setattr(node.seeder, "_network", type("Net", (), {
            "send": lambda self, msg, dst=None, out=out: out.append(
                msg.to_dict())})())
        size = node.domain_ledger.size
        node.seeder.process_catchup_req(req_cls(
            ledgerId=DOMAIN_LEDGER_ID, seqNoStart=1, seqNoEnd=size,
            catchupTill=size), "Beta")
    port_reps, jax_reps = sent[CatchupReq], sent[JaxCatchupReq]
    assert len(jax_reps) == 1
    assert len(wire.serialize(jax_reps[0])) > limit
    assert len(port_reps) > 1
    assert all(len(wire.serialize(r)) <= limit for r in port_reps)
    for key in ("txns", "auditPaths"):
        merged = {}
        for r in port_reps:
            merged.update(r[key])
        assert merged == jax_reps[0][key]


def test_deferred_share_unroll_runs_the_pairing_kernel(monkeypatch):
    """The deferred-share unroll of test_deferred_share_verify_drops_bad_
    share_at_order with BLS_PAIRING_DEVICE_MIN lowered to 2: the port's
    replica checks its four shares in one launch of the pairing kernel
    (its plain version, device="cpu") and stores the JAX replica's
    multi-signature of the three valid shares."""
    from plenum_tpu_torch.ops import bls381_pairing as bp
    launched = []
    real = bp.pairing_plain
    monkeypatch.setattr(bp, "pairing_plain", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    stored = []
    for rep_mod, crypto, pp_cls, commit_cls, verifier in (
            (prep, bls, PrePrepare, Commit, bls.BlsCryptoVerifierPlenum(
                device_pairing=True, pairing_device_min=2, device="cpu")),
            (jrep, jbls, JaxPrePrepare, JaxCommit,
             jbls.BlsCryptoVerifierPlenum())):
        signers = _signers(crypto)
        keys = rep_mod.BlsKeyRegister(lambda n: signers[n].pk)
        replica = rep_mod.BlsBftReplica(NAMES[0], signers[NAMES[0]],
                                        verifier, keys,
                                        defer_share_verify=True)
        pp = _pp(pp_cls)
        replica.process_pre_prepare(pp, NAMES[0])
        commits = {n: _share(rep_mod, signers, n, verifier, keys, pp,
                             commit_cls) for n in NAMES[:3]}
        commits[NAMES[3]] = commits[NAMES[2]]
        replica.process_order((0, 1), commits, pp, quorums=None)
        multi = replica.bls_store.get("")
        assert multi.participants == sorted(NAMES[:3])
        stored.append(multi.as_dict())
    assert launched == [4]
    assert stored[0] == stored[1]


def _reads(node, identifier, dests, monkeypatch):
    """GET_NYM replies of `node` for `dests` → their result dicts."""
    sent = []
    monkeypatch.setattr(node, "_reply_to_client",
                        lambda c, m: sent.append(m))
    node.process_client_batch([({
        "identifier": identifier, "reqId": 10 ** 6 + i,
        "operation": {"type": GET_NYM, TARGET_NYM: d}}, "reader")
        for i, d in enumerate(dests)])
    return [copy.deepcopy(m.to_dict()["result"]) for m in sent]


def _tamper(kind, result, other_root):
    """(state proof, key, value) of a GET_NYM result, altered by kind."""
    from plenum_tpu_torch.client.client import PoolClient
    key, value = PoolClient._expected_state_kv(result)
    sp = copy.deepcopy(result.get("state_proof"))
    if kind == "flipped_multi_sig":
        raw = bytearray(bls.b58_decode(sp["multi_signature"]["signature"]))
        raw[-1] ^= 1
        sp["multi_signature"]["signature"] = bls.b58_encode(bytes(raw))
    elif kind == "stale_root":
        sp["root_hash"] = other_root
    elif kind == "wrong_value":
        value = value[:-1] + bytes([value[-1] ^ 1])
    elif kind == "missing_proof":
        sp = None
    return sp, key, value


@pytest.mark.parametrize("kind", ["valid", "flipped_multi_sig", "stale_root",
                                  "wrong_value", "missing_proof"])
def test_pool_client_checks_proofs_as_the_jax_package_does(pools, kind,
                                                          monkeypatch):
    """The port's PoolClient (check_proof_dicts in one batch, routed to
    the pairing kernel's plain version, and check_proof_dict one by one)
    gives the JAX package's PoolClient's verdict strings on the same
    GET_NYM replies of a port node."""
    from plenum_tpu.client.client import PoolClient as JaxPoolClient
    from plenum_tpu_torch.client.client import PoolClient
    port, _, signers = pools
    write_reqs = pool.make_requests(6, SimpleSigner(seed=b"\x61" * 32))
    results = _reads(port[0], write_reqs[0]["identifier"],
                     [r["operation"][TARGET_NYM] for r in write_reqs],
                     monkeypatch)
    assert len(results) == 6 and all(r.get("data") for r in results)
    other = [m.value.state_root_hash
             for _, m in port[0].bls_bft_replica.bls_store.items()
             if m.value.state_root_hash
             != results[0]["state_proof"]["root_hash"]][0]
    checks = [_tamper(kind, r, other) for r in results]
    keys = {n: signers[n].pk for n in NAMES}
    client = PoolClient(None, NAMES, lambda n, m: None,
                        bls_verifier=bls.BlsCryptoVerifierPlenum(
                            device_pairing=True, pairing_device_min=4,
                            device="cpu"),
                        bls_key_provider=keys.get)
    jclient = JaxPoolClient(None, NAMES, lambda n, m: None,
                            bls_verifier=jbls.BlsCryptoVerifierPlenum(),
                            bls_key_provider=keys.get)
    got = client.check_proof_dicts(checks)
    assert got == jclient.check_proof_dicts(checks)
    assert [client.check_proof_dict(*c) for c in checks] == \
        [jclient.check_proof_dict(*c) for c in checks] == got
    if kind == "valid":
        assert got == [None] * 6
        assert all(client.verify_state_proof(r) for r in results)
    else:
        assert all(isinstance(v, str) for v in got)


# signature fields a Byzantine replier can put in a multi-signature
MALFORMED_SIGNATURES = {
    "none": None, "int": 123, "list": [], "map": {}, "empty": "",
    "bad_char": "0OIl" * 11, "non_ascii": "é" * 44,
    "non_ascii_bytes": b"\xff" * 44, "too_short": "3yZe7d",
}


def _clients(signers, pairing_device_min):
    """The port's PoolClient (pairing through the kernel's plain version
    at or above `pairing_device_min` proofs) and the JAX package's."""
    from plenum_tpu.client.client import PoolClient as JaxPoolClient
    from plenum_tpu_torch.client.client import PoolClient
    keys = {n: signers[n].pk for n in NAMES}
    client = PoolClient(None, NAMES, lambda n, m: None,
                        bls_verifier=bls.BlsCryptoVerifierPlenum(
                            device_pairing=True,
                            pairing_device_min=pairing_device_min,
                            device="cpu"),
                        bls_key_provider=keys.get)
    jclient = JaxPoolClient(None, NAMES, lambda n, m: None,
                            bls_verifier=jbls.BlsCryptoVerifierPlenum(),
                            bls_key_provider=keys.get)
    return client, jclient


def _check_name(verdict):
    """The check a verdict names (the text before its first colon)."""
    return verdict if verdict is None else verdict.split(":")[0]


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("kind", sorted(MALFORMED_SIGNATURES))
def test_malformed_signature_is_an_invalid_multi_sig_as_in_the_jax_package(
        pools, kind, codec, monkeypatch):
    """A multi-signature whose signature is not base58 text of a point
    never crashes the port's client, under either base58 codec: one by
    one and in a batch (pairing through the kernel's plain version) the
    verdict names the check the JAX package's verdict names, "multi-sig
    invalid", word for word where the JAX package's does not quote an
    exception; an honest proof batched beside it still verifies."""
    from plenum_tpu.common.serializers import base58 as jb58
    from plenum_tpu_torch.common.serializers import base58 as b58
    for mod in (b58, jb58):
        assert mod._fp is not None, "the native codec built"
        monkeypatch.setattr(mod, "b58decode", mod._fp.b58decode
                            if codec == "native" else mod._b58decode_py)
    port, _, signers = pools
    write_reqs = pool.make_requests(2, SimpleSigner(seed=b"\x61" * 32))
    results = _reads(port[0], write_reqs[0]["identifier"],
                     [r["operation"][TARGET_NYM] for r in write_reqs],
                     monkeypatch)
    honest, bad = (_tamper("valid", r, None) for r in results)
    bad[0]["multi_signature"]["signature"] = MALFORMED_SIGNATURES[kind]
    client, jclient = _clients(signers, pairing_device_min=2)
    got = client.check_proof_dict(*bad)
    want = jclient.check_proof_dict(*bad)
    assert _check_name(got) == _check_name(want) == "multi-sig invalid"
    if "raised (" not in want:
        assert got == want
    assert client.check_proof_dicts([bad, honest]) == [got, None]
    assert [_check_name(v) for v in client.check_proof_dicts([bad])] == \
        [_check_name(v) for v in jclient.check_proof_dicts([bad])]


def test_unhashable_participant_is_an_invalid_multi_sig(pools, monkeypatch):
    """A participant name that is a list reads as an unparseable
    multi-signature in the port; the JAX package raises TypeError there
    (a deliberate difference: a proof never crashes the port's client)."""
    port, _, signers = pools
    write_reqs = pool.make_requests(1, SimpleSigner(seed=b"\x61" * 32))
    result, = _reads(port[0], write_reqs[0]["identifier"],
                     [write_reqs[0]["operation"][TARGET_NYM]], monkeypatch)
    bad = _tamper("valid", result, None)
    bad[0]["multi_signature"]["participants"][0] = ["Alpha"]
    client, jclient = _clients(signers, pairing_device_min=2)
    want = "multi-sig invalid: unparseable multi-signature " \
           "(participant names are not hashable)"
    assert client.check_proof_dict(*bad) == want
    assert client.check_proof_dicts([bad]) == [want]
    with pytest.raises(TypeError):
        jclient.check_proof_dict(*bad)


def test_jax_signers_carry_across_and_verify_through_the_batch_path(
        monkeypatch):
    """carry.bls_signers takes the JAX package's signers across: the
    port's sign byte for byte as they do, and their signatures verify
    through the port's batch seam on the pairing kernel (its plain
    version), a wrong message failing."""
    from plenum_tpu_torch import carry
    from plenum_tpu_torch.ops import bls381_pairing as bp
    jsigners = _signers(jbls)
    signers = carry.bls_signers(jsigners[n] for n in NAMES)
    assert [s.pk for s in signers] == [jsigners[n].pk for n in NAMES]
    msg = b"carried"
    sigs = [jsigners[n].sign(msg) for n in NAMES]
    assert [s.sign(msg) for s in signers] == sigs
    pairs = carry.bls_signers((s._sk, s.pk) for s in signers)
    assert [s.sign(msg) for s in pairs] == sigs
    launched = []
    real = bp.pairing_plain
    monkeypatch.setattr(bp, "pairing_plain", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    verifier = bls.BlsCryptoVerifierPlenum(
        device_pairing=True, pairing_device_min=4, device="cpu")
    checks = [(sig, msg, s.pk) for sig, s in zip(sigs, signers)]
    checks.append((sigs[0], msg + b"x", signers[0].pk))
    assert verifier.verify_sigs_batch(checks) == [True] * 4 + [False]
    assert launched == [5]
