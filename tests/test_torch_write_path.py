"""The slice as a whole: signed NYM writes, some tampered, authenticated by
four CoreAuthNrs that share one CoalescingVerifierHub and written into a
ledger in 3PC batches, in the port (plain PyTorch versions on the CPU)
and in plenum_tpu (CoreAuthNr over a scalar-batch hub). The port's ledger
and authenticator are carried over from the JAX package's with
plenum_tpu_torch.carry. Tolerance: none — the accepted set and every
reply (seqNo, rootHash, auditPath) must be equal."""
import pytest

from plenum_tpu.common.request import Request as JaxRequest
from plenum_tpu.common.txn_util import reqToTxn as jax_req_to_txn
from plenum_tpu.crypto.batch_verifier import (
    CoalescingVerifierHub as JaxHub, ScalarVerifier as JaxScalar)
from plenum_tpu.ledger.ledger import Ledger as JaxLedger
from plenum_tpu.ledger.tree_hasher import TreeHasher as JaxTreeHasher
from plenum_tpu.ops.sha256 import JaxSha256Backend
from plenum_tpu.server.client_authn import CoreAuthNr as JaxAuthNr
from plenum_tpu_torch import carry, testing
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import reqToTxn
from plenum_tpu_torch.crypto.batch_verifier import (
    CoalescingVerifierHub, TorchBatchVerifier)
from plenum_tpu_torch.crypto.signer import SimpleSigner
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier

N_REQS, N_BAD, BATCH, THRESHOLD = 45, 5, 16, 8
N_NODES = 4
TXN_TIME = 1700000000


def _write(ledger, authnrs, flush, reqs, make_request, req_to_txn):
    """Authenticate `reqs` on every node, stage the accepted ones in
    BATCH-sized 3PC batches, commit, and build the replies. → (verdicts,
    [(reply, tree size the reply's root belongs to)])"""
    handles = [a.dispatch_batch([make_request(**r) for r in reqs])
               for a in authnrs]
    flush()
    verdicts = [a.conclude_batch(h) for a, h in zip(authnrs, handles)]
    assert all(v == verdicts[0] for v in verdicts[1:])
    accepted = [r for r, v in zip(reqs, verdicts[0]) if v is not None]
    replies = []
    for lo in range(0, len(accepted), BATCH):
        txns = [req_to_txn(make_request(**r))
                for r in accepted[lo:lo + BATCH]]
        ledger.append_txns_metadata(txns, txn_time=TXN_TIME)
        ledger.stage_txns_collect(ledger.stage_txns_dispatch(txns))
        (first, last), _ = ledger.commitTxns(len(txns))
        replies.extend((info, last) for info in
                       ledger.merkleInfoBatch(range(first, last + 1)))
    return verdicts[0], replies


@pytest.fixture(scope="module")
def signer():
    return SimpleSigner(seed=b"\x11" * 32)


def test_write_path_matches_jax(signer):
    reqs, bad = testing.nym_requests(N_REQS, signer, seed=9, n_bad=N_BAD)

    jax_ledger = JaxLedger(tree_hasher=JaxTreeHasher(
        batch_backend=JaxSha256Backend(), batch_threshold=THRESHOLD))
    for i in range(37):                      # history before the slice runs
        jax_ledger.add({"txn": {"type": "1", "data": {"dest": "g%d" % i}},
                        "txnMetadata": {}, "reqSignature": {}, "ver": "1"})
    leaves, nodes = carry.arrays_from_hash_store(jax_ledger.tree.hash_store,
                                                 jax_ledger.size)
    blobs = [bytes(v) for _, v in jax_ledger._store.iterator()]
    port_ledger = carry.ledger_from_arrays(blobs, leaves, nodes,
                                           device="cpu")
    port_ledger.hasher._batch_threshold = THRESHOLD
    assert port_ledger.root_hash == jax_ledger.root_hash

    registry = {signer.identifier: signer.verkey}
    hub = CoalescingVerifierHub(batch=TorchBatchVerifier("cpu"))
    port_authnrs = [carry.authnr_from_registry(registry, verifier=hub)
                    for _ in range(N_NODES)]
    jax_hub = JaxHub(batch=JaxScalar())
    jax_authnrs = [JaxAuthNr(verifier=jax_hub) for _ in range(N_NODES)]
    for a in jax_authnrs:
        a.addIdr(signer.identifier, signer.verkey)

    got, got_replies = _write(port_ledger, port_authnrs, hub.flush, reqs,
                              Request, reqToTxn)
    want, want_replies = _write(jax_ledger, jax_authnrs, jax_hub.flush, reqs,
                                JaxRequest, jax_req_to_txn)
    assert got == want
    assert {i for i, v in enumerate(got) if v is None} == bad
    assert got_replies == want_replies
    assert len(got_replies) == N_REQS - N_BAD
    assert port_ledger.root_hash == jax_ledger.root_hash
    # the four nodes' dispatches coalesced into ONE deduplicated launch
    assert hub.launches == [(N_REQS, 64)]

    verifier = MerkleVerifier(port_ledger.hasher)
    ledger_reqids = set()
    for reply, size in got_replies:
        txn = port_ledger.getBySeqNo(reply["seqNo"])
        ledger_reqids.add(txn["txn"]["metadata"]["reqId"])
        assert verifier.verify_leaf_inclusion(
            port_ledger.serialize_for_tree(txn), reply["seqNo"] - 1,
            [port_ledger.strToHash(h) for h in reply["auditPath"]], size,
            port_ledger.strToHash(reply["rootHash"]))
    assert not ledger_reqids & {reqs[i]["reqId"] for i in bad}
