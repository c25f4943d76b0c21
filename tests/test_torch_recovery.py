"""Recovery on the port against the JAX package (both on the CPU, the
port's nodes on device="cpu"): bench.py bench_recovery's scenario
(plenum_tpu_torch.testing.byzantine.drive_recovery) at 7 nodes with
VERIFIER_PROVIDER "cpu" in both packages, through each package's own
adversary harness, must give equal failover and catchup latencies (sim
seconds), bad peers, recovery trace events and roots; the JAX package's
bench_recovery itself gives the same report. Then the scenario-level
shapes of tests/test_recovery.py (silent-primary failover, NEW_VIEW
liars, a lying seeder convicted, a partition healed, a node leaving and
rejoining), one parametrised test, each equal between the packages in
its measured latency, fault trace, ordered batches and roots.
Tolerance: none."""

import pytest

from tests.torch_two_packages import (
    JAX, PORT, Pool, conf, jax_warm_off, live_roots_agree, node_kw, outcome,
    pkg, roots)

REC_NODES = 7


@pytest.fixture(scope="module")
def warm_off():
    with jax_warm_off():
        yield


def _recovery(name):
    """drive_recovery on a REC_NODES pool of package `name`."""
    from plenum_tpu_torch.testing import byzantine
    p = pkg(name)
    timer = p.MockTimer()
    timer.set_time(byzantine.SIM_EPOCH)
    net = p.SimNetwork(timer, p.Random(byzantine.RECOVERY_NET_SEED),
                       min_latency=0.001, max_latency=0.01)
    cfg = conf(p, **dict(byzantine.RECOVERY_CONF, VERIFIER_PROVIDER="cpu"))
    names = byzantine.recovery_names(REC_NODES)
    nodes = [p.Node(n, names, timer, net.create_peer(n), config=cfg,
                    **node_kw(p)) for n in names]
    report = byzantine.drive_recovery(
        timer, net, nodes, p.adversary, p.Config.RECOVERY_FAILOVER_SLO_S,
        p.Config.RECOVERY_CATCHUP_SLO_S)
    return report, nodes


@pytest.fixture(scope="module")
def recoveries(warm_off):
    return _recovery(PORT), _recovery(JAX)


def test_bench_recovery_equal_to_the_jax_packages(recoveries):
    (port, port_nodes), (ref, ref_nodes) = recoveries
    for key in ("failover_s", "catchup_s", "catchup_bad_peers",
                "trace_events", "roles", "honest", "slo_ok"):
        assert port[key] == ref[key], key
    assert port["slo_ok"] and "violations" not in port
    assert port["roles"]["liar"] in port["catchup_bad_peers"]
    assert roots(port_nodes) == roots(ref_nodes)
    honest = [n for n in port_nodes if n.name in port["honest"]]
    assert len({(r[0], r[2]) for r in roots(honest)}) == 1


def test_drive_recovery_reports_what_bench_recovery_reports(
        recoveries, monkeypatch):
    """bench.py's own bench_recovery at 7 nodes: the same latencies, bad
    peers and trace events as the port's copy of its drive."""
    import bench
    monkeypatch.setenv("BENCH_REC_NODES", str(REC_NODES))
    (port, _), _ = recoveries
    with jax_warm_off():
        ref = bench.bench_recovery()
    for key in ("failover_s", "catchup_s", "catchup_bad_peers",
                "trace_events", "slo_ok"):
        assert port[key] == ref[key], key


def test_run_recovery_on_the_ports_default_provider(recoveries):
    """run_recovery as the card runs it (the port's default provider,
    torch_hub, here on the CPU): the same latencies and bad peers."""
    from plenum_tpu_torch.testing import byzantine
    report, nodes = byzantine.run_recovery(REC_NODES, device="cpu")
    (port, _), _ = recoveries
    assert report["e2e_samples"] > 0 and report["ordered_p99_ms"] > 0
    assert nodes[0].authnr._verifier.__class__.__name__ == \
        "CoalescingVerifierHub"
    for key in ("failover_s", "catchup_s", "catchup_bad_peers",
                "trace_events"):
        assert report[key] == port[key], key


# ------------------------------------- tests/test_recovery.py's shapes


def silent_primary_failover(pl):
    primary = pl.primary
    adv = pl.controller(13)
    sc = pl.p.adversary.Scenario(
        pl.timer, pl.nodes, adversary=adv,
        honest=[n.name for n in pl.nodes if n is not primary])
    pl.sc = sc
    pl.submit(0, 500)
    sc.run(2)
    adv.corrupt(primary, pl.p.adversary.SilentNode())
    pl.submit(1, 501)
    honest = sc.honest
    base = {n.name: n.last_ordered[1] for n in honest}
    latency = sc.measure(
        lambda: all(n.view_no >= 1 and not n.replica.data.waiting_for_new_view
                    and n.last_ordered[1] > base[n.name] for n in honest),
        within=90, desc="failover + ordering resumes")
    sc.check_slo("failover", latency, pl.p.Config.RECOVERY_FAILOVER_SLO_S)
    assert all(n.master_primary_name != primary.name for n in honest)
    assert live_roots_agree(honest)
    return latency


def _next_primary(pl):
    name = pl.nodes[0].replica.view_changer._selector \
        .select_master_primary(1)
    return next(n for n in pl.nodes if n.name == name)


def stale_new_view(pl):
    liar = _next_primary(pl)
    adv = pl.controller(14)
    adv.corrupt(liar, pl.p.adversary.EquivocatingNewView(mode="stale"))
    sc = pl.scenario()
    honest = sc.honest
    base_timeout = pl.nodes[0].config.NEW_VIEW_TIMEOUT
    seen = {"failed": 0, "timeout": 0.0}

    def recovered():
        for n in honest:
            vc = n.replica.view_changer
            seen["failed"] = max(seen["failed"],
                                 vc.consecutive_failed_view_changes)
            seen["timeout"] = max(seen["timeout"], vc.new_view_timeout())
        return all(n.view_no >= 2 and not n.replica.data.waiting_for_new_view
                   for n in honest)

    for n in pl.nodes:
        n.replica.start_view_change()
    sc.run_until(recovered, timeout=120,
                 desc="escalate past the stale-NEW_VIEW primary")
    assert seen["failed"] >= 1 and seen["timeout"] >= 2 * base_timeout
    for n in honest:
        assert n.replica.view_changer.consecutive_failed_view_changes == 0
        assert n.replica.view_changer.new_view_timeout() == base_timeout
    pl.submit(2, 510)
    sc.await_ordering_resumes(extra_batches=1, within=30)
    sc.run_until(lambda: live_roots_agree(sc.honest), timeout=30,
                 desc="honest roots converge after escalated recovery")
    return seen["timeout"]


def equivocating_new_view(pl):
    liar = _next_primary(pl)
    adv = pl.controller(15)
    adv.corrupt(liar, pl.p.adversary.EquivocatingNewView(
        mode="equivocate", real_count=0))
    sc = pl.scenario()
    for n in pl.nodes:
        n.replica.start_view_change()
    sc.run_until(lambda: all(n.view_no >= 2
                             and not n.replica.data.waiting_for_new_view
                             for n in sc.honest),
                 timeout=120, desc="converge past the equivocating NEW_VIEW")
    pl.submit(3, 520)
    sc.await_ordering_resumes(extra_batches=1, within=30)
    assert live_roots_agree(sc.honest)
    return min(n.view_no for n in sc.honest)


def lying_seeder(pl):
    nodes, net, a = pl.nodes, pl.net, pl.p.adversary
    sc = a.Scenario(pl.timer, nodes)
    for i in range(3):
        pl.submit(i, 530 + i)
    sc.run(8)
    assert all(n.domain_ledger.size == 3 for n in nodes)
    laggard, live = nodes[3], nodes[:3]
    net.disconnect(laggard.name)
    pl.submit(3, 533, to=live)
    a.Scenario(pl.timer, live).run(6)
    target = live[0].domain_ledger.size
    assert target == 4
    adv = pl.controller(16)
    liar = live[1]
    adv.corrupt(liar, a.LyingCatchupSeeder())
    net.reconnect(laggard.name)
    laggard.start_catchup()
    sc2 = a.Scenario(pl.timer, nodes, adversary=adv,
                     honest=[n.name for n in nodes if n is not liar])
    pl.sc = sc2
    latency = sc2.measure(
        lambda: not laggard.leecher.in_progress
        and laggard.domain_ledger.size == target,
        within=120, desc="catchup under a lying seeder")
    sc2.check_slo("catchup_lying_seeder", latency,
                  pl.p.Config.RECOVERY_CATCHUP_SLO_S)
    assert laggard.domain_ledger.root_hash == live[0].domain_ledger.root_hash
    assert liar.name in laggard.leecher.bad_peers
    assert any("lying-seeder" in e for _, e in adv.trace)
    return latency


def partition_heal(pl):
    nodes = pl.nodes
    adv = pl.controller(17)
    sc = pl.p.adversary.Scenario(pl.timer, nodes, adversary=adv,
                                 honest=[n.name for n in nodes])
    pl.sc = sc
    pl.submit(0, 540)
    sc.run(4)
    assert all(n.domain_ledger.size == 1 for n in nodes)
    behaviors = adv.partition(nodes[:2], nodes[2:])
    pl.submit(1, 541)
    sc.run(8)
    assert all(n.domain_ledger.size == 1 for n in nodes)

    def fault(_round):
        adv.heal_partition(behaviors)
        return ("heal 2/2 partition",
                lambda: all(n.domain_ledger.size >= 2 for n in nodes), None)

    results = sc.soak(rounds=1, fault=fault, settle=2.0, within=90,
                      slo=pl.p.Config.RECOVERY_FAILOVER_SLO_S,
                      slo_name="partition_heal")
    assert len(results) == 1 and results[0]["recovery_s"] > 0
    assert live_roots_agree(nodes)
    return results


def leave_and_rejoin(pl):
    nodes, net, a = pl.nodes, pl.net, pl.p.adversary
    sc = pl.scenario()
    pl.submit(0, 550)
    sc.run(4)
    churner, live = nodes[3], nodes[:3]

    def fault(_round):
        net.disconnect(churner.name)
        pl.submit(1, 551, to=live)
        a.Scenario(pl.timer, live).run_until(
            lambda: all(n.domain_ledger.size >= 2 for n in live),
            timeout=30, desc="ordering continues without the churner")
        net.reconnect(churner.name)
        churner.start_catchup()
        return ("node left and rejoined mid-load",
                lambda: not churner.leecher.in_progress
                and churner.domain_ledger.size == live[0].domain_ledger.size,
                None)

    results = sc.soak(rounds=1, fault=fault, settle=3.0, within=90,
                      slo=pl.p.Config.RECOVERY_CATCHUP_SLO_S,
                      slo_name="rejoin")
    sc.run_until(lambda: live_roots_agree(nodes), timeout=30,
                 desc="pool converges after rejoin")
    pl.submit(2, 552)
    sc.await_ordering_resumes(extra_batches=1, within=30)
    sc.run_until(lambda: live_roots_agree(nodes), timeout=30,
                 desc="roots agree after post-rejoin ordering")
    return results


# (name, net seed, scenario → its measurement)
SHAPES = [("silent_primary_failover", 63, silent_primary_failover),
          ("stale_new_view_escalates", 64, stale_new_view),
          ("equivocating_new_view", 65, equivocating_new_view),
          ("lying_seeder_convicted", 66, lying_seeder),
          ("partition_heal", 67, partition_heal),
          ("leave_and_rejoin", 68, leave_and_rejoin)]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_recovery_shape_equal_to_the_jax_packages(shape, warm_off):
    _, seed, drive = shape
    got = {}
    for name in (PORT, JAX):
        pl = Pool(pkg(name), seed)
        measured = drive(pl)
        got[name] = dict(outcome(pl), measured=measured)
    assert got[PORT] == got[JAX]
