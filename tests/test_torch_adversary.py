"""The port's adversary harness (plenum_tpu_torch.testing.adversary)
against the JAX package's: the shapes of tests/test_adversary.py, each
scenario driven once on a 4-node pool of the port (device="cpu", every
kernel's plain version) and once on the JAX package's (on the host), on
the same seeds. Per scenario the behaviors' recorded fault trace, the
suspicions the honest nodes raised, every node's ordered batches, its
domain, audit and state roots and the keys of its stored BLS
multi-signatures must be equal between the packages, and the JAX test's
own assertions must hold on the port. Then the port alone: at 7 nodes a
poisoned share sends the unroll through the pairing kernel's plain
version with at least BLS_PAIRING_DEVICE_MIN shares, its verdicts those
of the host library; the invariant checker trips on a fabricated fork;
the seam takes one tap and leaves none after release; a stalled pool
fails liveness in its window. Tolerance: none."""
import pytest

from tests.torch_two_packages import (
    BASE_CONF, JAX, NAMES, PORT, SIM_EPOCH, Pool, jax_warm_off,
    live_roots_agree, outcome, pkg, roots)

# test_poisoned_bls_share_strict_mode_rejects_at_arrival's own Config
STRICT_CONF = dict(Max3PCBatchSize=5, Max3PCBatchWait=0.2, CHK_FREQ=5,
                   LOG_SIZE=15, STATE_FRESHNESS_UPDATE_INTERVAL=3,
                   BLS_DEFER_SHARE_VERIFY=False)


# ----------------------------------------------------------- scenarios
# Each takes a Pool and drives tests/test_adversary.py's test of the same
# name, asserting what that test asserts; the outcome is compared after.


def equivocation_absorbed(pl):
    adv = pl.controller(7)
    adv.corrupt(pl.primary, pl.p.adversary.EquivocatingPrimary(real_count=1))
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 300 + i)
        sc.run(2)
    sc.run(6)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    assert live_roots_agree(sc.honest)
    assert sc.checker.checks > 50
    assert any("equivocate-pp" in e for _, e in adv.trace)


def equivocation_stall_view_change(pl):
    primary = pl.primary
    adv = pl.controller(9)
    adv.corrupt(primary, pl.p.adversary.EquivocatingPrimary(real_count=0))
    sc = pl.scenario()
    pl.submit(0, 310)
    sc.run(4)
    sc.await_view_change(min_view=1, within=60)
    assert all(n.master_primary_name != primary.name for n in sc.honest)
    pl.submit(1, 311)
    sc.await_ordering_resumes(extra_batches=1, within=20)
    assert live_roots_agree(sc.honest)


def equivocation_root_mismatch(pl):
    primary = pl.primary
    adv = pl.controller(2)
    adv.corrupt(primary, pl.p.adversary.EquivocatingPrimary(real_count=1))
    sc = pl.scenario()
    pl.submit(0, 320)
    sc.run(6)
    blamed = {s for n, _, s in pl.suspicions if n != primary.name}
    assert primary.name in blamed
    assert all(s == primary.name for n, code, s in pl.suspicions
               if n != primary.name and code == 14)


def duplicate_3pc(pl):
    adv = pl.controller(3)
    adv.corrupt(pl.nodes[1], pl.p.adversary.DuplicateThreePC(copies=3))
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 330 + i)
    sc.run(10)
    assert all(n.domain_ledger.size == 3 for n in pl.nodes)
    assert live_roots_agree(pl.nodes)
    for n in pl.nodes:
        for key, votes in n.replica.ordering.commits.items():
            assert len(votes) <= len(NAMES), (key, list(votes))


def conflicting_prepare(pl):
    adversary = pl.others()[0]
    adv = pl.controller(4)
    adv.corrupt(adversary, pl.p.adversary.ConflictingPrepare())
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 340 + i)
    sc.run(10)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    assert live_roots_agree(sc.honest)
    assert any(s == adversary.name and code == 8
               for n, code, s in pl.suspicions if n != adversary.name)


def duplicate_and_conflicting(pl):
    others = pl.others()
    adv = pl.controller(5)
    adv.corrupt(others[0], pl.p.adversary.DuplicateThreePC(copies=2))
    adv.corrupt(others[0], pl.p.adversary.ConflictingPrepare(
        victims=[others[1].name]))
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 350 + i)
    sc.run(12)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    assert live_roots_agree(sc.honest)


def tampered_propagate(pl):
    adversary = pl.others()[0]
    adv = pl.controller(6)
    adv.corrupt(adversary, pl.p.adversary.TamperedPropagate())
    sc = pl.scenario()
    req = pl.request(0, 360, seed=b"\x61" * 32)
    for n in [n for n in pl.nodes if n is not adversary][:2]:
        n.process_client_request(dict(req), "c1")
    sc.run(12)
    assert all(n.domain_ledger.size == 1 for n in pl.nodes)
    for n in pl.nodes:
        assert "Tampered" not in str(n.domain_ledger.getBySeqNo(1))
    assert any("tamper" in e for _, e in adv.trace)


def tampered_propagate_replies(pl):
    adversary = pl.others()[0]
    adv = pl.controller(8)
    adv.corrupt(adversary, pl.p.adversary.TamperedPropagate())
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 370 + i)
    sc.run(10)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    reply = pl.p.messages.Reply
    for n in sc.honest:
        assert sum(isinstance(m, reply) for m in pl.replies[n.name]) >= 3


def _all_multi_signed(nodes):
    for n in nodes:
        for o in n.replica.ordered_log:
            if o.stateRootHash is not None:
                assert n.bls_bft_replica.bls_store.get(
                    o.stateRootHash) is not None


def poisoned_bls_backfill(pl):
    adv = pl.controller(5)
    adv.corrupt(pl.others()[0], pl.p.adversary.PoisonedBlsShare())
    sc = pl.scenario()
    for i in range(4):
        pl.submit(i, 380 + i)
        sc.run(3)
    sc.run(10)
    assert all(n.domain_ledger.size == 4 for n in sc.honest)
    _all_multi_signed(sc.honest)
    assert not any(n.bls_bft_replica._pending_backfill for n in sc.honest)
    assert any(n.bls_bft_replica._strict_until_seq > 0 for n in sc.honest)


def poisoned_bls_strict(pl):
    adversary = pl.others()[0]
    adv = pl.controller(6)
    adv.corrupt(adversary, pl.p.adversary.PoisonedBlsShare())
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 390 + i)
        sc.run(3)
    sc.run_until(lambda: all(n.domain_ledger.size == 3 for n in sc.honest),
                 timeout=60, desc="all honest nodes order the 3 writes")
    _all_multi_signed(sc.honest)
    assert all(n.bls_bft_replica._strict_until_seq == -1 for n in sc.honest)
    assert any(s == adversary.name and code == 21
               for n, code, s in pl.suspicions if n != adversary.name)


def garbled_bls_share(pl):
    adv = pl.controller(7)
    adv.corrupt(pl.others()[0],
                pl.p.adversary.PoisonedBlsShare(garble_every=1))
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 400 + i)
        sc.run(3)
    sc.run(8)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    _all_multi_signed(sc.honest)


def link_drop(pl):
    adv = pl.controller(8)
    adv.corrupt(pl.nodes[2], pl.p.adversary.LinkFault(drop_p=0.3))
    sc = pl.scenario()
    for i in range(4):
        pl.submit(i, 410 + i)
    sc.run(20)
    assert all(n.domain_ledger.size == 4 for n in sc.honest)
    assert live_roots_agree(sc.honest)


def link_delay_reorder(pl):
    m = pl.p.messages
    adv = pl.controller(9)
    adv.corrupt(pl.nodes[1], pl.p.adversary.LinkFault(
        delay_p=0.5, delay=1.0, jitter=0.5,
        message_types=[m.PrePrepare, m.Prepare, m.Commit]))
    sc = pl.scenario()
    for i in range(4):
        pl.submit(i, 420 + i)
    sc.run(20)
    assert all(n.domain_ledger.size == 4 for n in pl.nodes)
    assert live_roots_agree(pl.nodes)


def link_corrupt(pl):
    adv = pl.controller(10)
    adv.corrupt(pl.others()[0], pl.p.adversary.LinkFault(
        corrupt_p=0.5, message_types=[pl.p.messages.Prepare]))
    sc = pl.scenario()
    for i in range(3):
        pl.submit(i, 430 + i)
    sc.run(15)
    assert all(n.domain_ledger.size == 3 for n in sc.honest)
    assert live_roots_agree(sc.honest)


def view_change_during_catchup(pl):
    nodes, net, p = pl.nodes, pl.net, pl.p
    sc = pl.scenario()
    pl.submit(0, 440)
    sc.run(5)
    assert all(n.domain_ledger.size == 1 for n in nodes)
    sleeper, live = nodes[3], nodes[:3]
    net.disconnect(sleeper.name)
    sc_live = p.adversary.Scenario(pl.timer, live)
    for n in live:
        n.replica.start_view_change()
    sc_live.run(12)
    assert all(n.view_no == 1 for n in live)
    req = pl.request(0, 441, seed=b"\x66" * 32)
    for n in live:
        n.process_client_request(dict(req), "c2")
    sc_live.run(8)
    target = live[0].domain_ledger.size
    assert target == 2
    adv = pl.controller(11)
    adv.corrupt(live[0], p.adversary.LinkFault(
        delay_p=1.0, delay=2.0, jitter=1.0, dst=[sleeper.name],
        message_types=[p.messages.CatchupRep]))
    net.reconnect(sleeper.name)
    sleeper.start_catchup()
    sc2 = pl.scenario()
    sc2.run_until(
        lambda: sleeper.domain_ledger.size == target
        and sleeper.view_no == 1
        and sleeper.audit_ledger.size == live[0].audit_ledger.size,
        40, "sleeper caught up + adopted view")
    assert sleeper.master_primary_name == live[0].master_primary_name
    assert live_roots_agree(nodes)
    pl.submit(2, 442)
    sc2.run_until(lambda: all(n.domain_ledger.size == target + 1
                              for n in nodes),
                  30, "post-catchup write committed everywhere")
    assert live_roots_agree(nodes)


def fault_trace(seed):
    def drive(pl):
        adv = pl.controller(seed)
        adv.corrupt(pl.primary, pl.p.adversary.EquivocatingPrimary())
        adv.corrupt(pl.nodes[2], pl.p.adversary.LinkFault(
            drop_p=0.2, delay_p=0.3, delay=0.5))
        adv.at(4.0, lambda: adv.release(pl.nodes[2]), "heal the lossy link")
        sc = pl.scenario()
        for i in range(3):
            pl.submit(i, 450 + i)
        sc.run(10)
        assert len(adv.trace_lines()) > 5
        assert any("scheduled: heal the lossy link" in line
                   for line in adv.trace_lines())
    return drive


# (family, name, net seed, BLS pool, Config, scenario)
CASES = [
    ("equivocation", "absorbed", 31, False, BASE_CONF,
     equivocation_absorbed),
    ("equivocation", "stall_view_change", 32, False, BASE_CONF,
     equivocation_stall_view_change),
    ("equivocation", "root_mismatch", 33, False, BASE_CONF,
     equivocation_root_mismatch),
    ("3pc", "duplicate", 34, False, BASE_CONF, duplicate_3pc),
    ("3pc", "conflicting_prepare", 35, False, BASE_CONF, conflicting_prepare),
    ("3pc", "duplicate_and_conflicting", 36, False, BASE_CONF,
     duplicate_and_conflicting),
    ("propagate", "tampered", 37, False, BASE_CONF, tampered_propagate),
    ("propagate", "tampered_replies", 38, False, BASE_CONF,
     tampered_propagate_replies),
    ("bls", "poisoned_backfill", 39, True, BASE_CONF, poisoned_bls_backfill),
    ("bls", "poisoned_strict", 40, True, STRICT_CONF, poisoned_bls_strict),
    ("bls", "garbled", 41, True, BASE_CONF, garbled_bls_share),
    ("link", "drop", 42, False, BASE_CONF, link_drop),
    ("link", "delay_reorder", 43, False, BASE_CONF, link_delay_reorder),
    ("link", "corrupt", 44, False, BASE_CONF, link_corrupt),
    ("catchup", "view_change_during_catchup", 45, False, BASE_CONF,
     view_change_during_catchup),
    ("seed", "1234", 46, False, BASE_CONF, fault_trace(1234)),
    ("seed", "4321", 46, False, BASE_CONF, fault_trace(4321)),
]


def run_case(name, case):
    _family, _label, seed, bls, config, drive = case
    pl = Pool(pkg(name), seed, bls=bls, config=config)
    drive(pl)
    return outcome(pl)


@pytest.fixture(scope="module")
def warm_off():
    with jax_warm_off():
        yield


@pytest.mark.parametrize("case", CASES, ids=["-".join(c[:2]) for c in CASES])
def test_scenario_equal_to_the_jax_packages(case, warm_off):
    port, ref = run_case(PORT, case), run_case(JAX, case)
    assert port["trace"] == ref["trace"]
    assert port["suspicions"] == ref["suspicions"]
    assert port["ordered"] == ref["ordered"]
    assert port["roots"] == ref["roots"]
    assert port["views"] == ref["views"]
    assert port["multi_sig_keys"] == ref["multi_sig_keys"]
    if case[3]:
        assert any(port["multi_sig_keys"].values())


def test_different_seeds_give_different_fault_traces(warm_off):
    seeds = [c for c in CASES if c[0] == "seed"]
    assert run_case(PORT, seeds[0])["trace"] != \
        run_case(PORT, seeds[1])["trace"]


def test_poisoned_share_unroll_runs_the_pairing_kernels_plain_version(
        monkeypatch):
    """At 7 nodes (f = 2) the unroll holds at least
    BLS_PAIRING_DEVICE_MIN shares, so each honest node checks them in one
    call of the pairing kernel (its plain version on the CPU); the first
    unroll's verdicts equal the host library's per-share verify_sig, the
    poisoner's share among them False."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
    from plenum_tpu_torch.ops import bls381_pairing as bp
    from plenum_tpu_torch.testing import byzantine
    launched = []
    real = bp.pairing_plain
    monkeypatch.setattr(bp, "pairing_plain", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    run = byzantine.run_bls_attack(7, writes=20, chunk=20, device="cpu")
    honest = run["honest"]
    assert all(n.domain_ledger.size == 20 for n in honest)
    # domain and state roots: the audit ledgers may differ by a
    # freshness batch still in flight
    assert len({(r[0], r[2]) for r in roots(honest)}) == 1
    assert all(not byzantine.proofless_batches(n)
               and not n.bls_bft_replica._pending_backfill for n in honest)
    sized = [u for u in run["unrolls"]
             if len(u[1]) >= Config.BLS_PAIRING_DEVICE_MIN]
    assert sized and launched
    assert min(launched) >= Config.BLS_PAIRING_DEVICE_MIN
    _, checks, verdicts = sized[0]
    host = BlsCryptoVerifierPlenum()
    assert verdicts == [host.verify_sig(s, m, pk) for s, m, pk in checks]
    assert verdicts.count(False) == 1


def late_share_below_the_checkpoint(pl):
    """Delta orders seq 1 on three COMMITs, one of them with a bad BLS
    share, so the batch waits for a late share; Gamma's COMMIT of seq 1
    reaches Delta only after the checkpoint at seq 5 is stable. Freshness
    batches are off, so no later batch signs the same root and nothing
    garbage-collects the wait. → (pending before, pending after, the
    first root multi-signed before, after)."""
    a = pl.p.adversary
    commit_cls = pl.p.messages.Commit
    poisoner, late, lagger = pl.others()
    held = []

    class FirstCommitToLagger(a.Behavior):
        name = "first-commit"

        def __init__(self, hold):
            super().__init__()
            self.hold = hold

        def on_send(self, msg, dst):
            if not isinstance(msg, commit_cls) or msg.ppSeqNo != 1 \
                    or msg.blsSig is None:
                return None
            targets = [dst] if isinstance(dst, str) else [
                t for t in (dst or self.controller.pool_names())
                if t != self.node_name]
            out = [(msg, t) for t in targets if t != lagger.name]
            if lagger.name in targets:
                if self.hold:
                    held.append(msg)
                else:
                    params = dict(msg.as_dict())
                    params["blsSig"] = msg.blsSig[::-1]
                    out.append((commit_cls(**params), lagger.name))
            return out

    adv = pl.controller(5)
    adv.corrupt(poisoner, FirstCommitToLagger(hold=False))
    adv.corrupt(late, FirstCommitToLagger(hold=True))
    sc = pl.scenario()
    for i in range(6):
        pl.submit(i, 520 + i)
        sc.run(3)
    bls = lagger.bls_bft_replica
    assert lagger.replica.data.low_watermark == 5 and len(held) == 1
    first = next(o.stateRootHash for o in lagger.replica.ordered_log
                 if o.ppSeqNo == 1)
    before = (dict(bls._pending_backfill),
              bls.bls_store.get(first) is not None)
    adv.raw_send(late.name, held[0], lagger.name)
    sc.run(3)
    after = (dict(bls._pending_backfill), bls.bls_store.get(first) is not None)
    assert all(n.view_no == 0 for n in pl.nodes) and not pl.suspicions
    return before, after


@pytest.mark.parametrize("name", [PORT, JAX])
def test_late_share_below_the_checkpoint_completes_the_proof(name, warm_off):
    """ROADMAP C, closed 14, a deliberate difference: a stable checkpoint
    drops the batch from the ordering service's `ordered` and raises the
    low watermark, and the JAX package then discards a late COMMIT whose
    share would complete the batch's missing multi-signature: the batch
    stays proof-less for good. The port hands such a COMMIT to the BLS
    layer's backfill, which stores the proof."""
    pl = Pool(pkg(name), 39, bls=True, config=dict(
        BASE_CONF, STATE_FRESHNESS_UPDATE_INTERVAL=10 ** 6))
    before, after = late_share_below_the_checkpoint(pl)
    assert before == ({(0, 1): True}, False)
    if name == PORT:
        assert after == ({}, True)
    else:
        assert after == before


@pytest.mark.parametrize("name", [PORT, JAX])
def test_shares_seen_at_ordering_count_toward_a_late_backfill(name,
                                                              warm_off):
    """ROADMAP C, closed 14, its second half: a batch ordered on three
    COMMITs, one with a bad share, waits for a backfill; one late valid
    share completes it in the port, which keeps the shares it ordered on
    as candidates. The JAX package counts only the late shares (its
    ordering service's commit store may be gone by then, after a stable
    checkpoint or a view change), so the one late share never reaches
    the quorum and the batch stays proof-less."""
    pl = Pool(pkg(name), 49, bls=True, config=dict(
        BASE_CONF, STATE_FRESHNESS_UPDATE_INTERVAL=10 ** 6))
    sc = pl.scenario()
    pl.submit(0, 540)
    sc.run(3)
    node = pl.others()[0]
    bls, ordering = node.bls_bft_replica, node.replica.ordering
    key = (0, 1)
    commits = dict(ordering.commits[key])
    pp = ordering.prePrepares[key]
    quorums = node.replica.data.quorums
    assert len(commits) == 4 and quorums.bls_signatures.value == 3
    senders = sorted(s for s in commits if s != node.name)
    bad, late = senders[0], senders[1]
    params = dict(commits[bad].as_dict())
    params["blsSig"] = params["blsSig"][::-1]
    ordered_on = {s: c for s, c in commits.items() if s != late}
    ordered_on[bad] = pl.p.messages.Commit(**params)
    bls._process_order(key, ordered_on, pp, quorums)
    assert bls._pending_backfill == {key: True}
    done = bls.retry_backfill(key, {late: commits[late]}, pp, quorums)
    assert done is (name == PORT)
    assert (key in bls._pending_backfill) is (name == JAX)


def test_invariant_checker_detects_fork():
    from plenum_tpu_torch.common.messages.node_messages import Ordered
    from plenum_tpu_torch.testing.adversary import (
        InvariantChecker, InvariantViolation)

    class FakeNode:
        def __init__(self, name, digest):
            self.name = name
            self.replica = type("R", (), {"ordered_log": [Ordered(
                instId=0, viewNo=0, valid_reqIdr=["r"], invalid_reqIdr=[],
                ppSeqNo=1, ppTime=SIM_EPOCH, ledgerId=1,
                stateRootHash=None, txnRootHash=None,
                auditTxnRootHash=None, primaries=["P"],
                originalViewNo=0, digest=digest)]})()

    with pytest.raises(InvariantViolation, match="SAFETY FORK"):
        InvariantChecker([FakeNode("A", "d1"), FakeNode("B", "d2")]).check()


def test_seam_single_tap_and_clean_uninstall():
    pl = Pool(pkg(PORT), 47)
    adv = pl.controller(12)
    adv.corrupt(pl.nodes[0], pl.p.adversary.DuplicateThreePC(copies=2))
    assert pl.nodes[0].network._tap is not None
    with pytest.raises(ValueError):
        pl.nodes[0].network.set_tap(object())
    adv.release(pl.nodes[0])
    assert pl.nodes[0].network._tap is None
    pl.adv = None
    sc = pl.scenario()
    pl.submit(0, 460)
    sc.run(6)
    assert all(n.domain_ledger.size == 1 for n in pl.nodes)
    assert live_roots_agree(pl.nodes)


def test_liveness_violation_reports_bounded_window():
    pl = Pool(pkg(PORT), 48)
    for n in pl.nodes:
        pl.net.disconnect(n.name)
    with pytest.raises(pl.p.adversary.LivenessViolation):
        pl.scenario().await_ordering_resumes(extra_batches=1, within=5)
