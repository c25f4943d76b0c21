"""A leecher's audit-path check (LedgerLeecher._verify_rep_proofs) on the
reps a Byzantine seeder can send, in the port and in the JAX package,
under each base58 codec (the native one and the Python one): the honest
rep of a 9-txn ledger passes; every malformed or lying rep is rejected
in both packages and raises in neither. The reps are built field by
field, past the wire schema, so that the check itself is what is held.
The port lets a kernel failure of the leaf hashing (RuntimeError)
surface, where the JAX package reads it as a lying seeder: a deliberate
difference. Tolerance: none."""

import copy
import importlib
from types import SimpleNamespace

import pytest

from tests.torch_two_packages import JAX, PORT

N_TXNS = 9


class _Net:
    def __init__(self):
        self.sent = []
        self.connecteds = set()

    def subscribe(self, *_a, **_k):
        pass

    def send(self, msg, dests=None):
        self.sent.append((msg, dests))


class _Db:
    def __init__(self, ledger):
        self._ledger = ledger

    def get_ledger(self, lid):
        return self._ledger if lid == 1 else None


def _leecher(name):
    """(the honest rep's txns and audit paths, a syncing leecher of an
    empty ledger towards the seeder's 9 txns) in package `name`."""
    mod = lambda m: importlib.import_module(name + "." + m)  # noqa: E731
    config, msgs = mod("common.config"), mod("common.messages.node_messages")
    ledger_mod, catchup = mod("ledger.ledger"), mod("server.catchup")
    src = ledger_mod.Ledger()
    for i in range(N_TXNS):
        src.add({"txn": {"type": "1", "data": {"i": i}}, "txnMetadata": {}})
    net = _Net()
    catchup.SeederService(_Db(src), net, name="S", config=config.Config(
        CATCHUP_REP_CHUNK=100)).process_catchup_req(msgs.CatchupReq(
            ledgerId=1, seqNoStart=1, seqNoEnd=N_TXNS,
            catchupTill=N_TXNS), "peer")
    (rep, _), = net.sent
    leecher = catchup.LedgerLeecher(
        1, _Db(ledger_mod.Ledger()), _Net(),
        mod("testing.mock_timer").MockTimer(), quorums_source=lambda: None,
        on_txn=lambda lid, t: None, on_done=lambda lid: None,
        config=config.Config())
    leecher.state = catchup.LeecherState.SYNCING
    leecher.target_size = N_TXNS
    leecher.target_root = src.root_hash
    return dict(rep.txns), dict(rep.auditPaths), leecher


def _path(paths, seq, value):
    paths = copy.deepcopy(paths)
    paths[seq] = value
    return paths


def _txn(txns, seq, value):
    txns = copy.deepcopy(txns)
    txns[seq] = value
    return txns


# kind → (txns, paths) of the honest rep → the rep's (txns, auditPaths)
REPS = {
    "honest": lambda t, p: (t, p),
    "txns_not_a_map": lambda t, p: (list(t), p),
    "paths_not_a_map": lambda t, p: (t, list(p.values())),
    "seq_not_a_number": lambda t, p: (
        _txn(t, "one", t["1"]), _path(p, "one", p["1"])),
    "seq_infinite": lambda t, p: (
        _txn(t, float("inf"), t["1"]), _path(p, float("inf"), p["1"])),
    "path_not_a_list": lambda t, p: (t, _path(p, "1", 5)),
    "path_hash_not_text": lambda t, p: (t, _path(p, "1", [None] + p["1"])),
    "path_hash_a_number": lambda t, p: (t, _path(p, "1", [7] + p["1"])),
    "path_hash_non_ascii": lambda t, p: (
        t, _path(p, "1", ["é" * 44] + p["1"][1:])),
    "path_hash_bad_char": lambda t, p: (
        t, _path(p, "1", ["0OIl"] + p["1"][1:])),
    "path_too_short": lambda t, p: (t, _path(p, "1", p["1"][:-1])),
    "path_too_long": lambda t, p: (t, _path(p, "1", p["1"] + p["1"][:1])),
    "txn_too_big_an_int": lambda t, p: (
        _txn(t, "1", {"txn": {"type": "1", "data": {"i": 2 ** 70}},
                      "txnMetadata": {}}), p),
    "txn_a_lie": lambda t, p: (
        _txn(t, "1", {"txn": {"type": "1", "data": {"evil": 1}},
                      "txnMetadata": {}}), p),
}


def _use_codec(monkeypatch, name, codec):
    """Ledger.strToHash of package `name` on its native or Python
    base58 decoder."""
    b58 = importlib.import_module(name + ".common.serializers.base58")
    ledger_mod = importlib.import_module(name + ".ledger.ledger")
    if codec == "native":
        assert b58._fp is not None, "the native codec built"
        decode = b58._fp.b58decode
    else:
        decode = b58._b58decode_py
    monkeypatch.setattr(ledger_mod, "b58decode", decode)


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("kind", sorted(REPS))
def test_rep_verdict_equals_the_jax_packages(kind, codec, monkeypatch):
    verdicts = []
    for name in (PORT, JAX):
        _use_codec(monkeypatch, name, codec)
        txns, paths, leecher = _leecher(name)
        txns, paths = REPS[kind](txns, paths)
        verdicts.append(leecher._verify_rep_proofs(
            SimpleNamespace(txns=txns, auditPaths=paths), "seeder"))
    assert verdicts == [kind == "honest"] * 2


def test_leaf_hashing_failure_surfaces_in_the_port_only():
    """A RuntimeError from the leaf hashing (a kernel failure on the
    card) is no verdict on the seeder: the port raises it, the JAX
    package discards the chunk as a lie."""
    for name in (PORT, JAX):
        txns, paths, leecher = _leecher(name)

        def fail(datas):
            raise RuntimeError("the leaf hashing kernel failed")
        leecher.ledger.hasher.hash_leaves = fail
        rep = SimpleNamespace(txns=txns, auditPaths=paths)
        if name == PORT:
            with pytest.raises(RuntimeError, match="kernel failed"):
                leecher._verify_rep_proofs(rep, "seeder")
        else:
            assert leecher._verify_rep_proofs(rep, "seeder") is False
