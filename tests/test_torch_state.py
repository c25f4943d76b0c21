"""The port's MPT state (plenum_tpu_torch/state/) with its device engine on
the CPU — the SHA3 levels in the kernel's plain PyTorch version, the hash
floor lowered to 2 so that they really run there — against the JAX
package's PruningState on its host trie (hashlib; no XLA program), at the
shapes of tests/test_device_state.py: ragged batch sizes, interleaved
batches with overwrites and deletes, reads at old roots, a corrupted
store, and the merged multi-state resolve of the executor. Also the
state carry (carry.state_from_nodes). Tolerance: none — roots, values
and proof nodes must be byte-equal."""
import random

import numpy as np
import pytest

from plenum_tpu.state.pruning_state import PruningState as JaxState
from plenum_tpu.storage.kv_memory import KeyValueStorageInMemory as JaxKV
from plenum_tpu_torch import carry
from plenum_tpu_torch.ops import sha3 as tsha3
from plenum_tpu_torch.ops.sha256 import ragged_arrays
from plenum_tpu_torch.state.device_state import (
    CorruptStateError, DeviceStateEngine)
from plenum_tpu_torch.state.pruning_state import (
    PruningState, flush_states_merged)
from plenum_tpu_torch.state.trie import BLANK_ROOT, verify_proof
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory

FLOOR = 2


def _port_state(batch_min=1):
    st = PruningState(KeyValueStorageInMemory())
    st.attach_device_engine(batch_min=batch_min, device="cpu",
                            hash_floor=FLOOR)
    return st


@pytest.fixture
def plain_sha3_rows(monkeypatch):
    """Rows hashed by the plain SHA3 (what the CUDA kernel does on the
    card), so each test can show that the device path ran."""
    rows = []
    plain, plain_eq = tsha3.sha3_ragged_plain, tsha3.sha3_ragged_eq_plain

    def counted(data, offsets):
        rows.append(int(offsets.shape[0]) - 1)
        return plain(data, offsets)

    def counted_eq(data, offsets, refs):
        rows.append(int(offsets.shape[0]) - 1)
        return plain_eq(data, offsets, refs)

    monkeypatch.setattr(tsha3, "sha3_ragged_plain", counted)
    monkeypatch.setattr(tsha3, "sha3_ragged_eq_plain", counted_eq)
    return rows


def _same_reads(st, ref, keys, root=None):
    """Values and proofs (raw and serialized) of `keys` byte-equal."""
    want_vals = [ref.get_for_root_hash(root, k) for k in keys] \
        if root is not None else [ref.get(k) for k in keys]
    want_proofs = [ref.generate_state_proof(k, root) for k in keys]
    assert st.get_batch_for_root_hash(
        root if root is not None else st.committedHeadHash, keys) \
        == want_vals
    assert st.generate_state_proof_batch(keys, root) == want_proofs
    assert st.generate_state_proof_batch(keys, root, serialize=True) == \
        [ref.generate_state_proof(k, root, serialize=True) for k in keys]
    vals, proofs = st.get_with_proofs_batch(keys, root)
    assert (vals, proofs) == (want_vals, want_proofs)
    r = root if root is not None else st.committedHeadHash
    for k, v, p in zip(keys, want_vals, want_proofs):
        assert verify_proof(r, k, v, p)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 100, 257])
def test_apply_get_proof_equivalence_ragged(n, plain_sha3_rows):
    st, ref = _port_state(), JaxState(JaxKV())
    for s in (st, ref):
        for i in range(n):
            s.set(b"k-%d-%d" % (n, i), b"v-%d" % i)
    assert st.headHash == ref.headHash
    st.commit()
    ref.commit()
    assert st.committedHeadHash == ref.committedHeadHash
    _same_reads(st, ref, [b"k-%d-%d" % (n, i) for i in range(n)]
                + [b"absent-%d" % n])
    if n >= 33:     # smaller tries hold only inline nodes under the root
        assert max(plain_sha3_rows) >= FLOOR


def test_randomized_interleaved_batches_deletes_and_old_roots(
        plain_sha3_rows):
    """Batches with overwrites and deletes on top of earlier roots: every
    head, value and proof byte-equal, and reads at every earlier root
    still byte-equal after later batches."""
    rng = random.Random(4242)
    st, ref = _port_state(), JaxState(JaxKV())
    keyspace = [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 12)))
                for _ in range(150)]
    live, roots = set(), []
    for batch_no in range(6):
        batch = {}
        for _ in range(rng.randrange(1, 90)):
            k = rng.choice(keyspace)
            if rng.random() < 0.25 and k in live:
                batch[k] = None
            else:
                batch[k] = b"v%d-%d" % (batch_no, rng.randrange(1000))
        for s in (st, ref):
            for k, v in batch.items():
                if v is None:
                    s.remove(k)
                else:
                    s.set(k, v)
        live |= {k for k, v in batch.items() if v is not None}
        live -= {k for k, v in batch.items() if v is None}
        assert st.headHash == ref.headHash, batch_no
        st.commit()
        ref.commit()
        roots.append(ref.committedHeadHash)
        _same_reads(st, ref, rng.sample(keyspace, 40))
    for batch_no, root in enumerate(roots):
        _same_reads(st, ref, rng.sample(keyspace, 30), root)
    assert any(r >= FLOOR for r in plain_sha3_rows)


def test_uncommitted_batches_revert_and_pending_reads():
    st, ref = _port_state(batch_min=4), JaxState(JaxKV())
    for s in (st, ref):
        for i in range(30):
            s.set(b"p%d" % i, b"q%d" % i)
    head = st.headHash
    assert head == ref.headHash
    for s in (st, ref):
        s.set(b"p0", b"OVERRIDE")
        s.remove(b"p1")
    keys = [b"p0", b"p1", b"p2"]
    assert st.get_batch(keys, isCommitted=False) == \
        [ref.get(k, isCommitted=False) for k in keys]
    assert st.headHash == ref.headHash
    st.revertToHead(head)
    ref.revertToHead(head)
    assert st.get_batch(keys, isCommitted=False) == \
        [ref.get(k, isCommitted=False) for k in keys]


def test_merged_resolve_of_two_states_equals_each_alone(plain_sha3_rows):
    """The executor's merged flush: two states' dirty levels hashed in
    shared launches give each state the JAX package's own root."""
    ports = [_port_state(), _port_state()]
    refs = [JaxState(JaxKV()), JaxState(JaxKV())]
    for j, (st, ref) in enumerate(zip(ports, refs)):
        for i in range(50 + 30 * j):
            for s in (st, ref):
                s.set(b"s%d-%d" % (j, i), b"w%d" % i)
    flush_states_merged(ports)
    for st, ref in zip(ports, refs):
        assert st.headHash == ref.headHash
    assert max(plain_sha3_rows) >= FLOOR


def test_engine_detects_corrupt_store(plain_sha3_rows):
    st = _port_state()
    for i in range(64):
        st.set(b"key-%d" % i, b"value-%d" % i)
    st.commit()
    root = st.committedHeadHash
    kv = st._kv
    victim = next(h for h in kv._dict if h != root
                  and h != PruningState.rootHashKey and len(h) == 32)
    blob = bytearray(kv.get(victim))
    blob[-1] ^= 1
    kv.put(victim, bytes(blob))
    keys = [b"key-%d" % i for i in range(64)]
    del plain_sha3_rows[:]
    with pytest.raises(CorruptStateError):
        st.get_batch(keys)
    with pytest.raises(CorruptStateError):
        st.generate_state_proof_batch(keys)
    assert plain_sha3_rows, "the fused verify ran on the plain SHA3"


def test_engine_raises_keyerror_for_missing_node():
    kv = KeyValueStorageInMemory()
    eng = DeviceStateEngine(kv, hash_floor=1, device="cpu")
    root = eng.apply_batch(BLANK_ROOT,
                           [(b"k%d" % i, b"v%d" % i) for i in range(40)])
    victim = next(h for h in list(kv._dict) if h != root and len(h) == 32)
    kv.remove(victim)
    with pytest.raises(KeyError):
        eng.get_batch(root, [b"k%d" % i for i in range(40)])


def _jax_state_with_history():
    ref = JaxState(JaxKV())
    for i in range(120):
        ref.set(b"did:%d" % i, b'{"v":%d}' % i)
    ref.commit()
    for i in range(0, 120, 7):
        ref.remove(b"did:%d" % i)
    ref.set(b"did:new", b"fresh")
    ref.headHash  # flush: an uncommitted head above the committed one
    return ref


@pytest.mark.parametrize("form", ["pairs", "arrays"])
def test_state_carry_takes_nodes_across_without_hashing(form, monkeypatch):
    ref = _jax_state_with_history()
    items = [(bytes(k), bytes(v)) for k, v in ref._kv.iterator()]
    if form == "pairs":
        nodes, committed = items, None
    else:
        node_items = [(k, v) for k, v in items if len(k) == 32]
        keys = np.frombuffer(b"".join(k for k, _ in node_items),
                             dtype=np.uint8).reshape(-1, 32)
        data, offsets = ragged_arrays([v for _, v in node_items])
        nodes, committed = (keys, data, offsets), ref.committedHeadHash

    def no_hashing(*args):
        raise AssertionError("the carry must not hash")

    monkeypatch.setattr(tsha3, "sha3_ragged_plain", no_hashing)
    st = carry.state_from_nodes(nodes, ref.headHash, committed, device="cpu")
    assert st.headHash == ref.headHash
    assert st.committedHeadHash == ref.committedHeadHash
    assert st._engine.dispatches == st._engine.host_hash_calls == 0
    keys = [b"did:%d" % i for i in range(0, 120, 3)] + [b"did:new"]
    assert st.get_batch(keys, isCommitted=False) == \
        [ref.get(k, isCommitted=False) for k in keys]
    assert st.get_batch(keys) == [ref.get(k) for k in keys]
    assert st.generate_state_proof_batch(keys, ref.headHash) == \
        [ref.generate_state_proof(k, ref.headHash) for k in keys]
