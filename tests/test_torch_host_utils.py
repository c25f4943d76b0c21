"""The port's host utilities against the JAX package's on the same
inputs: the KV storage factory (the 'native' name raises in both), the
optimistic KV store on one op sequence, the direct and queued channels,
eventually / eventuallyAll, spy_on / unspy, make_signed_batch
(byte-equal at count 64, unique 8), the Recorder (a recording made on a
port node replays on a fresh port node and on a fresh JAX node to the
live roots), and the per-stage budget (the same report from the same
spans; on traced 4-node pools of both packages, the same stages and
ordered requests). Tolerance: none."""
import asyncio
import importlib
import os

import pytest

from tests.torch_two_packages import (
    BASE_CONF, JAX, NAMES, PACKAGES, PORT, SIM_EPOCH, Pool, conf,
    jax_warm_off, node_kw, pkg, roots)


def _mod(name, module):
    return importlib.import_module(name + "." + module)


# --------------------------------------------------------- KV storage


@pytest.mark.parametrize("kind", ["memory", "file", "native", "nope"])
def test_init_key_value_storage_equal_to_the_jax_packages(kind, tmp_path):
    got = {}
    for name in PACKAGES:
        init = _mod(name, "storage").initKeyValueStorage
        try:
            kv = init(kind, str(tmp_path / name), "db")
        except ValueError as e:
            got[name] = ("ValueError", str(e))
            continue
        kv.put(b"k1", b"v1")
        kv.do_ops_in_batch([("put", b"k2", b"v2"), ("remove", b"k1")])
        got[name] = (type(kv).__name__, kv.get(b"k2"),
                     sorted(kv.iterator(include_value=False)))
        kv.close()
    assert got[PORT] == got[JAX]
    if kind in ("native", "nope"):
        assert got[PORT] == ("ValueError",
                             "unknown storage type {}".format(kind))


def _optimistic_ops(name):
    kv = _mod(name, "storage.kv_memory").KeyValueStorageInMemory()
    store = _mod(name, "storage.optimistic_kv_store").OptimisticKVStore(kv)
    log = []

    def get(key, committed=False):
        try:
            log.append(("get", key, committed, store.get(key, committed)))
        except KeyError:
            log.append(("get", key, committed, "KeyError"))

    store.set("a", "1")
    store.set(b"b", b"2")
    get("a")
    get("a", True)
    store.create_batch_from_current()
    store.remove("a")
    get("a")
    store.create_batch_from_current()
    store.set("c", "3")
    log.append(("uncommitted", store.un_committed_count,
                store.first_batch_idr()))
    store.reject_batch()
    get("c")
    store.commit_batch()
    get("a", True)
    get("b", True)
    store.reject_batch()
    get("a")
    store.commit_batch() if store.un_committed_count else None
    try:
        store.commit_batch()
    except ValueError as e:
        log.append(("commit", str(e)))
    log.append(("store", sorted(kv.iterator())))
    return log


def test_optimistic_kv_store_equal_to_the_jax_packages():
    port = _optimistic_ops(PORT)
    assert port == _optimistic_ops(JAX)
    assert ("commit", "no uncommitted batch") in port


# ----------------------------------------------------------- runtime


@pytest.mark.parametrize("name", PACKAGES)
def test_channels_deliver_in_order(name):
    ch = _mod(name, "runtime.channel")
    tx, rx = ch.create_direct_channel()
    got = []
    rx.set_handler(got.append)
    rx.set_handler(lambda m: got.append(("second", m)))
    tx.put_nowait(1)
    svc = ch.QueuedChannelService()
    svc.rx.set_handler(got.append)
    for m in (2, 3, 4):
        svc.tx.put_nowait(m)
    assert got == [1, ("second", 1)]
    assert svc.service(limit=2) == 2 and svc.service() == 1
    assert got == [1, ("second", 1), 2, 3, 4]


def _eventually_log(name):
    ev = _mod(name, "runtime.eventually")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise AssertionError("not yet")
        return calls["n"]

    async def coro_ok():
        return "async"

    async def main():
        out = [await ev.eventually(flaky, retry_wait=0.001, timeout=1)]
        out.append(await ev.eventuallyAll(coro_ok, lambda: 7,
                                          total_timeout=1, retry_wait=0.001))
        calls["n"] = -100
        try:
            await ev.eventually(flaky, retry_wait=0.001, timeout=1,
                                acceptable_fails=2)
        except AssertionError as e:
            out.append(("raised", str(e), calls["n"]))
        return out

    return asyncio.run(main())


def test_eventually_equal_to_the_jax_packages():
    port = _eventually_log(PORT)
    assert port == _eventually_log(JAX)
    assert port == [3, ["async", 7], ("raised", "not yet", -97)]


@pytest.mark.parametrize("name", PACKAGES)
def test_spy_on_records_and_restores(name):
    spy = _mod(name, "testing.spy")

    class Box:
        def add(self, a, b=0):
            if a < 0:
                raise ValueError(a)
            return a + b

    box = Box()
    log = spy.spy_on(box, "add")
    assert box.add(1, b=2) == 3
    with pytest.raises(ValueError):
        box.add(-1)
    assert log.count() == 2 and log.results() == [3, None]
    assert log[0].args == (1,) and log[0].kwargs == {"b": 2}
    assert isinstance(log.last().error, ValueError)
    spy.unspy(box, "add")
    assert box.add(2) == 2 and log.count() == 2
    assert "add" not in vars(box) or not hasattr(box.add, "_spy_log")


# ------------------------------------------------------------ crypto


def test_make_signed_batch_byte_equal_to_the_jax_packages():
    port = _mod(PORT, "crypto.fixtures").make_signed_batch(64, seed=3,
                                                            unique=8)
    ref = _mod(JAX, "crypto.fixtures").make_signed_batch(64, seed=3,
                                                         unique=8)
    assert port == ref
    msgs, sigs, vks = port
    assert len(msgs) == len(sigs) == len(vks) == 64
    assert len(set(sigs)) == 8 and sigs[8:16] == sigs[:8]
    from plenum_tpu_torch.crypto import ed25519
    assert all(ed25519.verify(m, s, v)
               for m, s, v in zip(msgs[:8], sigs[:8], vks[:8]))


# ---------------------------------------------------------- recorder


def _fresh_node(name, timer):
    p = pkg(name)
    bus = _mod(name, "runtime.bus").ExternalBus(
        send_handler=lambda m, dst=None: None)
    return p.Node("Alpha", NAMES, timer, bus, config=conf(p, **BASE_CONF),
                  client_reply_handler=lambda c, m: None, **node_kw(p))


def test_recording_replays_on_fresh_port_and_jax_nodes(tmp_path):
    """A port pool records Alpha's inputs (utils/recorder.py); the dumped
    recording replays on a fresh port node and, loaded by the JAX
    package's Recorder, on a fresh JAX node: both reach the live roots."""
    rec_mod = _mod(PORT, "utils.recorder")
    pl = Pool(pkg(PORT), 19)
    recorder = rec_mod.Recorder(pl.timer.get_current_time)
    rec_mod.attach_recorder(pl.nodes[0], recorder)
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 600 + i)
    sc.run(8)
    live = roots(pl.nodes[:1])
    assert pl.nodes[0].domain_ledger.size == 3
    path = os.path.join(str(tmp_path), "alpha.rec")
    recorder.dump(path)
    with jax_warm_off():
        for name in PACKAGES:
            mod = _mod(name, "utils.recorder")
            recording = mod.Recorder.load(path)
            assert recording.entries == recorder.entries
            timer = pkg(name).MockTimer()
            timer.set_time(SIM_EPOCH)
            fresh = _fresh_node(name, timer)
            mod.replay(recording, fresh, timer)
            assert roots([fresh]) == live, name


# ------------------------------------------------------------ budget


def _manual_report(name):
    tracing = _mod(name, "observability.tracing")
    budget = _mod(name, "observability.budget")
    t = [0.0]
    tracer = tracing.Tracer("Alpha", clock=lambda: t[0])

    def span(nm, cat, t0, t1, **args):
        t[0] = t0
        ctx = tracer.span(nm, cat, **args)
        ctx.__enter__()
        t[0] = t1
        ctx.__exit__(None, None, None)

    span("fused_dispatch", "device", 0.02, 0.06)
    span("batch_apply", "execute", 0.0, 0.1, batch_size=10)
    span("prepare_batch", "3pc", 0.2, 0.21)
    span("wire_pack", "3pc", 0.22, 0.23)
    span("reply", "reply", 0.3, 0.305)
    span("auth_dispatch", "device", 0.4, 0.42)
    export = _mod(name, "observability.export")
    report = budget.budget_from_tracers([tracer])
    return report, budget.budget_from_chrome(export.chrome_trace([tracer])), \
        budget.format_table(report)


def test_budget_from_spans_equal_to_the_jax_packages():
    port, ref = _manual_report(PORT), _manual_report(JAX)
    assert port == ref
    assert port[0] == port[1] and port[0]["ordered_reqs"] == 10


def _traced_budget(name):
    pl = Pool(pkg(name), 19, config=dict(
        Max3PCBatchSize=5, Max3PCBatchWait=0.2, CHK_FREQ=5, LOG_SIZE=15,
        TRACING_ENABLED=True))
    sc = pl.scenario()
    for i in range(6):
        pl.submit(i, 800 + i)
    sc.run(8)
    budget = _mod(name, "observability.budget")
    export = _mod(name, "observability.export")
    return budget.budget_from_tracers(export.pool_tracers(pl.nodes))


def test_budget_of_traced_pools_equal_to_the_jax_packages():
    with jax_warm_off():
        port, ref = _traced_budget(PORT), _traced_budget(JAX)
    assert port["nodes"] == ref["nodes"] == len(NAMES)
    assert port["ordered_reqs"] == ref["ordered_reqs"] == 6
    assert list(port["stage_ms_per_node"]) == list(ref["stage_ms_per_node"])
    assert list(port["host_ms_per_ordered_req"]) == \
        list(ref["host_ms_per_ordered_req"])
    assert port["stage_ms_per_node"]["execute"] > 0
