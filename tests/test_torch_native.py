"""The port's native host branches (plenum_tpu_torch/csrc/fastpath.c,
rlp_c.c, mpt_c.c and kvlog.c, built by ops/cuda_lib.py into
plenum_tpu_torch/_build/) against the JAX package's builds of the same
sources and against the port's own pure-Python branches, at the shapes of
tests/test_fastpath_native.py, test_mpt_native.py and test_kv_native.py:
canonical JSON and msgpack of random nested values, digests, strict deep
equality, SHA-256 and base58; 70,000-entry collections and 150-level
nesting (past the C guards, where the Python branch decides); RLP; the C
trie's roots, historical reads, proofs, rehydration and eviction, and
beside the device state engine; the kvlog store and .kvlog files opened
across the three stores. Then a small sim pool with the C branches, and
in a child process with PLENUM_TPU_NO_NATIVE=1, against the JAX
package's pool. Tolerance: none — bytes, roots and verdicts equal."""
import hashlib
import json
import os
import random
import string
import struct
import subprocess
import sys

import msgpack
import pytest

from plenum_tpu.common.serializers.serializers import _sort_deep
from plenum_tpu.native import load_ext as jax_load_ext
from plenum_tpu.state.rlp import encode as jax_rlp_encode
from plenum_tpu.state.trie_native import NativeTrie as JaxNativeTrie
from plenum_tpu.storage.kv_native import KeyValueStorageNative as JaxKvNative
from plenum_tpu_torch.common.serializers import base58 as b58py
from plenum_tpu_torch.common.serializers.msgpack_codec import packb
from plenum_tpu_torch.common.serializers.serializers import (
    MsgPackSerializer, OrderedJsonSerializer)
from plenum_tpu_torch.ops import cuda_lib
from plenum_tpu_torch.server.propagator import (
    _strict_deep_eq, _strict_deep_eq_py)
from plenum_tpu_torch.state import pruning_state, rlp
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.state.trie import BLANK_ROOT, Trie, verify_proof
from plenum_tpu_torch.state.trie_native import NativeTrie
from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
from plenum_tpu_torch.storage.kv_native import KeyValueStorageNative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTENSIONS = ("fastpath", "rlp_c", "mpt_c")

fp = cuda_lib.load_host_ext("fastpath")
jfp = jax_load_ext("fastpath")
mpt = cuda_lib.load_host_ext("mpt_c")


# ------------------------------------------------------------ the builds

@pytest.mark.parametrize("name", EXTENSIONS)
def test_extension_is_the_ports_own_build(name):
    """Both packages load an extension of this name in one process: the
    port's is another module object, from a file under its _build/, and
    never takes the bare name in sys.modules."""
    port, jax = cuda_lib.load_host_ext(name), jax_load_ext(name)
    assert port is not jax and port.__file__ != jax.__file__
    assert os.path.dirname(port.__file__) == cuda_lib.BUILD_DIR
    assert port.__name__ == "plenum_tpu_torch._build." + name
    assert sys.modules.get(name) is not port
    assert cuda_lib.load_host_ext(name) is port   # one build a process


def test_kvlog_is_the_ports_own_build():
    lib = cuda_lib.load_host("kvlog")
    assert os.path.dirname(lib._name) == cuda_lib.BUILD_DIR


def test_kill_switch_gives_none(monkeypatch):
    monkeypatch.setenv(cuda_lib.NO_NATIVE_ENV, "1")
    assert cuda_lib.try_load_host_ext("fastpath") is None


def test_the_port_routes_through_its_builds():
    from plenum_tpu_torch.common.serializers import serializers
    assert serializers._fp is fp and b58py._fp is fp
    assert rlp.BACKEND == "native"
    assert pruning_state._TrieBackend is NativeTrie


# ------------------------------------------------ canonical serialization

def random_scalar(rng, for_json):
    kind = rng.randrange(8 if for_json else 9)
    if kind == 0:
        return None
    if kind == 1:
        return rng.choice([True, False])
    if kind == 2:
        return rng.randrange(-2 ** 40, 2 ** 40)
    if kind == 3:
        # boundary ints exercise every msgpack width
        return rng.choice([0, 1, -1, 31, 32, 127, 128, 255, 256, -32, -33,
                           -128, -129, -32768, -32769, 2 ** 16 - 1, 2 ** 16,
                           2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, -2 ** 63,
                           2 ** 64 - 1])
    if kind == 4:
        return rng.choice([0.0, -0.5, 1.5, 3.141592653589793, 1e300,
                           123456.789, -2.2250738585072014e-308])
    if kind == 5:
        return ''.join(rng.choices(string.printable, k=rng.randrange(0, 40)))
    if kind == 6:
        # non-ascii + escapes + long strings (str8/str16 widths)
        return rng.choice(['ключ', '日本語', 'a"b\\c\n\t\x01\x1f',
                           'x' * 31, 'y' * 32, 'z' * 255, 'w' * 256,
                           'v' * 70000, '\U0001f600 é'])
    if kind == 7:
        return rng.choice(string.ascii_letters) * rng.randrange(1, 5)
    return rng.randbytes(rng.choice([0, 1, 31, 255, 256, 300]))


def random_tree(rng, depth, for_json):
    if depth <= 0 or rng.random() < 0.4:
        return random_scalar(rng, for_json)
    if rng.random() < 0.5:
        return {str(rng.randrange(1000)) + rng.choice(['', 'Ключ', '_k']):
                random_tree(rng, depth - 1, for_json)
                for _ in range(rng.randrange(0, 18))}
    return [random_tree(rng, depth - 1, for_json)
            for _ in range(rng.randrange(0, 18))]


def _json(obj, ascii_only):
    return json.dumps(obj, sort_keys=True, separators=(',', ':'),
                      ensure_ascii=ascii_only).encode()


# form → (C entry, the port's Python branch, JSON-safe values?)
FORMS = {
    "json": ("canonical_json", lambda o: _json(o, False), True),
    "json_ascii": ("canonical_json_ascii", lambda o: _json(o, True), True),
    "msgpack": ("canonical_msgpack", lambda o: packb(o, sort_keys=True),
                False),
}


@pytest.fixture(scope="module")
def random_values():
    """300 random nested values for JSON and 300 for msgpack (bytes
    leaves too), made once for the three forms."""
    return {for_json: [random_tree(rng, 4, for_json) for _ in range(300)]
            for for_json, rng in ((True, random.Random(7)),
                                  (False, random.Random(9)))}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_canonical_forms_equal_on_300_random_values(form, random_values):
    entry, python_branch, for_json = FORMS[form]
    serializer = {"msgpack": MsgPackSerializer().serialize,
                  "json_ascii": OrderedJsonSerializer().serialize}.get(form)
    for i, obj in enumerate(random_values[for_json]):
        want = python_branch(obj)
        assert getattr(fp, entry)(obj) == want == getattr(jfp, entry)(obj)
        if form == "msgpack":
            assert want == msgpack.packb(_sort_deep(obj), use_bin_type=True)
        if serializer is not None and i < 30:   # it calls fp's entry
            assert serializer(obj) == want


@pytest.mark.parametrize("entry,canon", [("digest_hex", "json"),
                                         ("msgpack_digest_hex", "msgpack")])
def test_digests_equal_hashlib(entry, canon):
    _, python_branch, for_json = FORMS[canon]
    rng = random.Random(len(entry))
    for _ in range(60):
        obj = random_tree(rng, 3, for_json)
        assert getattr(fp, entry)(obj) == \
            hashlib.sha256(python_branch(obj)).hexdigest()


def test_deep_eq_type_strict_and_equal_to_the_python_branch():
    assert fp.deep_eq({"a": [1, {"b": "x"}]}, {"a": [1, {"b": "x"}]})
    for a, b in ((1, True), (1, 1.0), ([1], (1,)), ({"a": 1},
                 {"a": 1, "b": 2}), ({"a": 1}, {"b": 1}), ("1", 1)):
        assert not fp.deep_eq(a, b) and not _strict_deep_eq_py(a, b)
    rng = random.Random(11)
    for _ in range(200):
        a = random_tree(rng, 3, for_json=False)
        b = random_tree(rng, 3, for_json=False)
        assert fp.deep_eq(a, b) == _strict_deep_eq_py(a, b) == \
            _strict_deep_eq(a, b)
        assert fp.deep_eq(a, a)


def test_sha256_equals_hashlib():
    rng = random.Random(12)
    for n in [0, 1, 55, 56, 63, 64, 65, 127, 128, 1000, 70000]:
        data = bytes(rng.randrange(256) for _ in range(n))
        assert fp.sha256(data) == hashlib.sha256(data).digest()
        assert fp.sha256_hex(data) == hashlib.sha256(data).hexdigest()


def test_base58_round_trip_and_bad_characters():
    rng = random.Random(13)
    for _ in range(200):
        n = rng.choice([0, 1, 16, 20, 32, 33, 64])
        data = bytes(rng.randrange(256) for _ in range(n))
        if rng.random() < 0.3:
            data = b"\x00" * rng.randrange(1, 4) + data[max(1, n // 2):]
        enc = fp.b58encode(data)
        assert enc == b58py._b58encode_raw(data) == jfp.b58encode(data)
        assert fp.b58decode(enc) == b58py._b58decode_py(enc) == data
        assert b58py.b58encode(data) == enc and b58py.b58decode(enc) == data
    # non-ASCII too: a byte above 0x7f is a bad character like any other
    for bad in ("0OIl", "abc0", "I", "é", "3yZé", "a€b", b"\xff",
                b"3y\x80"):
        with pytest.raises(ValueError):
            fp.b58decode(bad)
        with pytest.raises(ValueError):
            b58py._b58decode_py(bad)


@pytest.mark.parametrize("shape", ["list", "map"])
def test_70000_entry_collections(shape):
    big = list(range(70000)) if shape == "list" else \
        {"k%05d" % i: i for i in range(70000)}
    want = packb(big, sort_keys=True)
    assert fp.canonical_msgpack(big) == want == jfp.canonical_msgpack(big)
    assert fp.canonical_json(big) == _json(big, False)


def test_150_level_nesting_takes_the_python_branch():
    """Deeper than the C guard (fastpath.c rejects JSON and msgpack
    nested past 100): the serializers fall back to their Python branches
    and give the bytes a node without the C build gives."""
    deep = "leaf"
    for _ in range(150):
        deep = {"k": deep}
    with pytest.raises(TypeError):
        fp.canonical_msgpack(deep)
    from plenum_tpu.common.serializers.serializers import (
        MsgPackSerializer as JaxMsgPack, OrderedJsonSerializer as JaxJson)
    assert MsgPackSerializer().serialize(deep) == packb(deep, sort_keys=True) \
        == JaxMsgPack().serialize(deep)
    assert OrderedJsonSerializer().serialize(deep) == _json(deep, True) \
        == JaxJson().serialize(deep)
    assert _strict_deep_eq(deep, deep) is True


# --------------------------------------------------------------------- RLP

def _random_rlp(rng, depth):
    if depth <= 0 or rng.random() < 0.45:
        n = rng.choice([0, 1, 1, 2, 55, 56, 57, 300, 70000])
        if n == 1:
            return bytes([rng.choice([0, 0x7f, 0x80, 0xff])])
        return bytes(rng.randrange(256) for _ in range(min(n, 400))) \
            if n < 70000 else b"\xab" * n
    return [_random_rlp(rng, depth - 1) for _ in range(rng.randrange(0, 9))]


def test_rlp_encode_decode_equal_to_the_python_codec():
    assert rlp.encode is not rlp.encode_py
    rng = random.Random(21)
    for _ in range(300):
        item = _random_rlp(rng, 4)
        enc = rlp.encode_py(item)
        assert rlp.encode(item) == enc == jax_rlp_encode(item)
        assert rlp.decode(enc) == rlp.decode_py(enc) == item
    for bad in (b"\x81\x05", b"\xb8\x05hello", b"\xc3\x01"):
        with pytest.raises(ValueError):
            rlp.decode_py(bad)
        with pytest.raises(ValueError):
            rlp.decode(bad)


# -------------------------------------------------------------------- trie

def _pair():
    return Trie(KeyValueStorageInMemory()), NativeTrie(KeyValueStorageInMemory())


def test_trie_roots_over_400_sets_and_deletes():
    py, c = _pair()
    jax = JaxNativeTrie(KeyValueStorageInMemory())
    assert c.root_hash == BLANK_ROOT
    rng = random.Random(5)
    keys = []
    for i in range(400):
        if rng.random() < 0.75 or not keys:
            key = ("did:%d" % rng.randrange(200)).encode()
            val = ("v%d" % rng.randrange(10 ** 9)).encode()
            keys.append(key)
            for t in (py, c, jax):
                t.set(key, val)
        else:
            key = rng.choice(keys)
            for t in (py, c, jax):
                t.delete(key)
        assert c.root_hash == py.root_hash == jax.root_hash, (i, key)
    assert list(c.items()) == list(py.items())


def test_trie_historical_gets_and_proofs():
    py, c = _pair()
    rng = random.Random(6)
    roots, model = [], {}
    for i in range(150):
        key = ("did:sov:%03d" % rng.randrange(60)).encode()
        model[key] = ("val-%d" % i).encode()
        py.set(key, model[key])
        c.set(key, model[key])
        roots.append((c.root_hash, dict(model)))
    for root, snapshot in rng.sample(roots, 30):
        for key in rng.sample(sorted(snapshot), min(5, len(snapshot))):
            assert c.get_at_root(root, key) == py.get_at_root(root, key) \
                == snapshot[key]
            proof = c.produce_spv_proof(key, root)
            assert proof == py.produce_spv_proof(key, root)
            assert verify_proof(root, key, snapshot[key], proof)
            assert not verify_proof(root, key, b"wrong", proof)
    absent = b"did:sov:absent"
    assert verify_proof(c.root_hash, absent, None,
                        c.produce_spv_proof(absent))


def test_trie_rehydrates_from_the_store_and_evicts():
    """Nodes written through to the KV let a fresh C trie (a restarted
    node) read everything; with a tiny node cap the C store evicts drained
    nodes and reads hydrate them back through the miss callback."""
    kv = KeyValueStorageInMemory()
    c = NativeTrie(kv)
    for i in range(100):
        c.set(b"key-%d" % i, b"val-%d" % i)
    fresh = NativeTrie(kv, c.root_hash)
    py = Trie(kv, c.root_hash)
    for i in range(100):
        assert fresh.get(b"key-%d" % i) == py.get(b"key-%d" % i) == \
            b"val-%d" % i
    with pytest.raises(KeyError):
        NativeTrie(KeyValueStorageInMemory(), c.root_hash).get(b"key-0")

    kv = KeyValueStorageInMemory()

    def miss(h):
        try:
            return bytes(kv.get(h))
        except KeyError:
            return None

    h, root, model = mpt.new(miss, 64), mpt.blank_root(), {}
    for i in range(300):
        key, val = b"did:%03d" % i, b"value-%d" % i
        root = mpt.set(h, root, key, val)
        for hsh, blob in mpt.drain(h):
            kv.put(hsh, blob)
        model[key] = val
    for key, val in model.items():
        assert mpt.get(h, root, key) == val
    assert dict(mpt.items(h, root)) == model


@pytest.mark.parametrize("batch_min", [1, 10 ** 9],
                         ids=["engine", "host"])
def test_c_trie_beside_the_state_engine(batch_min, monkeypatch):
    """PruningState on the C trie, with the device state engine (plain
    SHA3 on the CPU, floor 2) serving flushes of batch_min keys or more,
    against PruningState on the Python trie with the same engine and the
    JAX package's PruningState on its C trie: heads, committed roots,
    reads and proofs byte-equal, under revertToHead too, and the hash
    store's contents equal to the JAX package's. On the engine's route the
    C trie reaches each new root through the nodes the engine wrote into
    the KV."""
    from plenum_tpu.state.pruning_state import PruningState as JaxState
    from plenum_tpu.storage.kv_memory import KeyValueStorageInMemory as JaxKV
    states = []
    for backend in (NativeTrie, Trie):
        monkeypatch.setattr(pruning_state, "_TrieBackend", backend)
        st = PruningState(KeyValueStorageInMemory())
        st.attach_device_engine(batch_min=batch_min, device="cpu",
                                hash_floor=2)
        states.append(st)
    c, py = states
    ref = JaxState(JaxKV())
    assert type(c._trie) is NativeTrie and type(py._trie) is Trie
    assert type(ref._trie) is JaxNativeTrie
    rng = random.Random(31)
    keys = [b"did:%d" % i for i in range(120)]
    for batch_no in range(5):
        for _ in range(rng.randrange(20, 60)):
            k = rng.choice(keys)
            v = b"" if rng.random() < 0.2 else b"v%d" % rng.randrange(999)
            for st in (c, py, ref):
                (st.remove(k) if not v else st.set(k, v))
        assert c.headHash == py.headHash == ref.headHash, batch_no
        if batch_no == 3:
            for st in (c, py, ref):
                st.revertToHead(st.committedHeadHash)
            continue
        for st in (c, py, ref):
            st.commit()
        sample = rng.sample(keys, 20)
        assert [c.get(k) for k in sample] == [py.get(k) for k in sample] \
            == [ref.get(k) for k in sample]
        assert c.generate_state_proof_batch(sample) == \
            py.generate_state_proof_batch(sample) == \
            [ref.generate_state_proof(k) for k in sample]
    assert c.committedHeadHash == py.committedHeadHash == \
        ref.committedHeadHash
    assert dict(c._kv.iterator()) == dict(ref._kv.iterator())


# ---------------------------------------------------------------- kvlog

def test_kv_ops_reopen_torn_tail_and_compaction(tmp_path):
    d = str(tmp_path)
    kv = KeyValueStorageNative(d, "t")
    kv.put(b"b", b"2")
    kv.put(b"a", b"1")
    kv.put(b"c", b"3" * 5000)          # > the first read buffer
    kv.put(b"", b"empty-key")
    assert kv.get(b"c") == b"3" * 5000 and kv.get(b"") == b"empty-key"
    assert [k for k, _ in kv.iterator()] == [b"", b"a", b"b", b"c"]
    assert list(kv.iterator(start=b"b", include_value=False)) == [b"b", b"c"]
    kv.remove(b"a")
    with pytest.raises(KeyError):
        kv.get(b"a")
    kv.do_ops_in_batch([("remove", b"b"), ("put", b"b", b"new")])
    kv.setBatch([(b"batch-%d" % i, b"bv%d" % i) for i in range(10)])
    for i in range(50):
        kv.put(b"k-%02d" % i, b"old")
        kv.put(b"k-%02d" % i, b"final-%d" % i)
    assert kv.garbage_bytes > 0
    kv.compact()
    assert kv.garbage_bytes == 0
    kv.close()
    with pytest.raises(ValueError):
        kv.get(b"b")
    with open(os.path.join(d, "t.kvlog"), "ab") as f:
        f.write(struct.pack("<II", 4, 100) + b"torn")    # value missing
    kv = KeyValueStorageNative(d, "t")
    assert len(kv) == 3 + 10 + 50 and kv.get(b"b") == b"new"
    assert kv.get(b"k-49") == b"final-49"
    kv.close()


STORES = {
    "port_native": KeyValueStorageNative,
    "port_file": KeyValueStorageFile,
    "jax_native": JaxKvNative,
}


@pytest.mark.parametrize("writer", sorted(STORES))
@pytest.mark.parametrize("reader", sorted(STORES))
def test_kvlog_files_open_across_stores(tmp_path, writer, reader):
    """A .kvlog written by one store opens in the others: the port's C
    and Python stores and the JAX package's C store share the format."""
    d = str(tmp_path)
    w = STORES[writer](d, "shared")
    w.put(b"single", b"v")
    w.setBatch([(b"pb-%d" % i, b"x%d" % i) for i in range(3)])
    w.remove(b"pb-1")
    w.do_ops_in_batch([("put", b"q", b"1"), ("remove", b"single")])
    w.close()
    r = STORES[reader](d, "shared")
    assert [(k, r.get(k)) for k in r.iterator(include_value=False)] == \
        [(b"pb-0", b"x0"), (b"pb-2", b"x2"), (b"q", b"1")]
    r.put(b"from-reader", b"r")
    r.close()
    again = STORES[writer](d, "shared")
    assert again.get(b"from-reader") == b"r"
    again.close()


# ------------------------------------------------------------ pool parity

def test_pool_roots_with_and_without_the_c_branches():
    """The same pool gives byte-equal domain, audit, pool and config
    ledger roots, state roots, replies and nacks with the port's C
    branches, with its Python branches (a child process under
    PLENUM_TPU_NO_NATIVE=1) and on the JAX package's Nodes; the port's
    PruningState chose the C trie, as the JAX package's did."""
    import bench
    from tests.torch_pool_parity import (
        POOL_CONF, POOL_SEED, POOL_WRITES, order, pool_requests, pool_result,
        port_pool)
    from plenum_tpu.common.config import Config as JaxConfig
    from plenum_tpu.crypto.signer import SimpleSigner as JaxSigner
    from plenum_tpu.runtime.sim_random import DefaultSimRandom as JaxRandom
    from plenum_tpu.server.node import Node as JaxNode
    from plenum_tpu.state import pruning_state as jax_pruning_state
    from plenum_tpu.testing.mock_timer import MockTimer as JaxTimer
    from plenum_tpu.testing.sim_network import SimNetwork as JaxNetwork

    child = subprocess.run(
        [sys.executable, "-m", "tests.torch_pool_parity"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PLENUM_TPU_NO_NATIVE="1"))
    assert child.returncode == 0, child.stderr[-3000:]
    python_branches = json.loads(child.stdout.strip().splitlines()[-1])
    native = port_pool()

    timer = JaxTimer()
    timer.set_time(1600000000)
    net = JaxNetwork(timer, JaxRandom(77))
    sinks = [[] for _ in range(4)]
    conf = JaxConfig(SHA256_BACKEND="scalar", MERKLE_DEVICE_PROOFS=False,
                     EXEC_MERGED_DEVICE_HASH=False, VERIFIER_PROVIDER="cpu",
                     STATE_DEVICE_ENGINE=False, **POOL_CONF)
    names = ["Alpha", "Beta", "Gamma", "Delta"]
    nodes = [JaxNode(name, names, timer, net.create_peer(name), config=conf,
                     client_reply_handler=lambda c, m, s=s: s.append(
                         (type(m).__name__, m.to_dict())))
             for name, s in zip(names, sinks)]
    order(nodes, timer,
          pool_requests(bench.make_requests, JaxSigner(seed=POOL_SEED)))
    reference = pool_result(nodes, sinks)

    assert native["trie"] == "NativeTrie" == reference["trie"]
    assert jax_pruning_state._TrieBackend is JaxNativeTrie
    assert python_branches["trie"] == "Trie"
    assert len({tuple(r) for r in native["roots"]}) == 1
    assert native["roots"] == python_branches["roots"] == reference["roots"]
    assert native["replies"] == python_branches["replies"] == \
        reference["replies"]
    kinds = [k for k, _ in native["replies"][0]]
    assert kinds.count("Reply") == POOL_WRITES
    assert kinds.count("RequestNack") == 3
