"""The port's chaos plane (``node/chaos.py``) against the JAX package's.

Mirrors tests/test_chaos.py: the reference's cases, run against
``p1_tpu_torch`` with ``device="cpu"`` (hashlib sealing, the ``device``
signature rung's plain version); the slow set is the reference's.

The chaos plane (node/chaos.py + SimNet crash semantics).

The acceptance surface:

- crash/recover primitives: abrupt death (severed links, no shutdown
  hooks, torn in-flight append, stale mempool checkpoint) vs graceful
  restart — the equivalence/divergence pair;
- mempool crash-consistency: a crash-restart never resurrects a tx the
  surviving chain mined, including recovery onto a REORGED tip;
- the `_store_recovery_loop` ENOSPC degrade→serve-only→recover e2e on
  SimNet at PRODUCTION backoff deadlines in milliseconds of wall time
  (the socket variant in test_storefault.py stays as slow smoke);
- determinism: one seed ⇒ byte-identical chaos trace, including across
  crash/recover cycles (the cross-process half lives in test_cli.py);
- the bounded tier-1 invariant sweep (~30 schedules) and the ≥200
  slow sweep;
- the shrinker proof: a deliberately injected recovery bug minimized
  to ≤5 events, repro artifact round-trip;
- named regressions for the two REAL bugs the first sweeps found:
  the quarantined-log-head recovery brick (store.py ``orphans_ok``)
  and the post-catch-up announce skipping the behind peer (node.py
  ``_announce_tip``).
"""

import asyncio
import json

import pytest

from p1_tpu_torch.chain.store import ChainStore
from p1_tpu_torch.node import chaos
from p1_tpu_torch.node.netsim import SimNet

DIFF = 8


def _tx(net, wallet, payee, node, amount=1, fee=1):
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.tx import Transaction

    acct = wallet.account
    seq = node.mempool.pending_next_seq(acct, node.chain.nonce(acct))
    return Transaction.transfer(
        wallet, payee.account, amount, fee, seq, chain=genesis_hash(DIFF)
    )


def _wallets(seed=0):
    from p1_tpu_torch.core.keys import Keypair

    return (
        Keypair.from_seed_text(f"p1-chaos-test-{seed}"),
        Keypair.from_seed_text(f"p1-chaos-test-{seed}-payee"),
    )


class TestCrashRecover:
    """SimNet.crash_node / recover_node — the crash primitives."""

    def test_crash_tears_append_and_recovery_truncates(self, tmp_path):
        net = SimNet(seed=3, difficulty=DIFF, store_dir=tmp_path, device="cpu")

        async def main():
            a = await net.add_node()
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 1, 30, wall_limit_s=30
            )
            host_b = net.host_name(1)
            dead = await net.crash_node(host_b, torn=37)
            # The torn in-flight record reached the disk: the scan sees
            # a torn tail where a graceful stop would leave none.
            scan = ChainStore.scan(
                (tmp_path / f"{host_b}.dat").read_bytes()
            )
            assert scan.torn_tail is not None
            assert len(scan.spans) == 1  # the acknowledged block survived
            # The wire died too: the survivor's peer session is reaped.
            assert await net.run_until(
                lambda: a.peer_count() == 0, 30, wall_limit_s=30
            )
            await net.mine_on(a, spacing_s=1.0)
            b2 = await net.recover_node(host_b)
            # Same seed-derived identity, resume truncated the tear.
            assert b2.instance_nonce == dead.instance_nonce
            assert b2.store.healed["truncated_bytes"] == 37
            assert b2.chain.height == 1  # the acknowledged block resumed
            assert await net.run_until(
                lambda: b2.chain.height == 2, 60, wall_limit_s=30
            )
            assert net.converged() and net.ledger_conserved()
            await net.stop_all()

        net.run(main())

    def test_restart_vs_crash_mempool_checkpoint_pair(self, tmp_path):
        """The equivalence/divergence pair: a GRACEFUL restart persists
        the pending pool through its shutdown checkpoint; a crash loses
        everything since the last periodic one — and recovery tolerates
        that (chain intact, identity intact, pool empty)."""
        net = SimNet(seed=4, difficulty=DIFF, store_dir=tmp_path, device="cpu")
        wallet, payee = _wallets(4)

        async def main():
            a = await net.add_node(miner_id=wallet.account)
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(2):
                await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 2, 30, wall_limit_s=30
            )
            host_b = net.host_name(1)

            # Graceful: the shutdown save persists an un-checkpointed
            # admission (no 30 s housekeeping tick has run yet).
            tx1 = _tx(net, wallet, payee, b)
            assert b.mempool.add(tx1)
            await net.stop_node(host_b)
            b2 = await net.restart_node(host_b)
            assert tx1.txid() in b2.mempool

            # Crash: the same-shaped admission dies with the process —
            # the checkpoint on disk predates it.
            tx2 = _tx(net, wallet, payee, b2)
            assert b2.mempool.add(tx2)
            await net.crash_node(host_b)
            b3 = await net.recover_node(host_b)
            assert tx2.txid() not in b3.mempool  # lost, tolerated
            assert tx1.txid() in b3.mempool  # checkpointed at stop()
            assert b3.chain.height == 2  # acknowledged blocks survive
            assert b3.instance_nonce == b2.instance_nonce
            await net.stop_all()

        net.run(main())


class TestMempoolCrashConsistency:
    """A crash-restart never resurrects a transaction the surviving
    chain mined — driven through crash_node(), not graceful shutdown."""

    def test_checkpointed_tx_mined_while_down_is_not_resurrected(
        self, tmp_path
    ):
        net = SimNet(seed=5, difficulty=DIFF, store_dir=tmp_path, device="cpu")
        wallet, payee = _wallets(5)

        async def main():
            a = await net.add_node(miner_id=wallet.account)
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(2):
                await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 2, 30, wall_limit_s=30
            )
            tx = _tx(net, wallet, payee, b)
            await b.submit_tx(tx)
            assert await net.run_until(
                lambda: tx.txid() in a.mempool, 30, wall_limit_s=30
            )
            # Let B's periodic housekeeping checkpoint the pool (30
            # virtual seconds), so the on-disk file HOLDS the tx.
            await asyncio.sleep(31.0)
            host_b = net.host_name(1)
            await net.crash_node(host_b)
            # The surviving chain mines the tx while B is down.
            mined = await net.mine_on(a, spacing_s=1.0)
            assert any(t.txid() == tx.txid() for t in mined.txs)
            b2 = await net.recover_node(host_b)
            # Immediately after reboot the restored tx may look valid
            # (B's chain predates the mining block) — the invariant is
            # about the SETTLED state: once B catches up, the mined tx
            # must be gone from its pool.
            assert await net.run_until(
                lambda: b2.chain.height == 3, 60, wall_limit_s=30
            )
            assert tx.txid() in b2.chain._tx_index
            assert tx.txid() not in b2.mempool
            await net.stop_all()

        net.run(main())

    def test_recovery_onto_a_reorged_tip_still_evicts(self, tmp_path):
        """The hard case: B holds the tx MINED (block X); B crashes;
        the rest of the mesh reorgs past X onto a longer branch that
        mined the same tx elsewhere.  B recovers onto its stale chain,
        reloads a checkpoint that still lists the tx, then reorgs — the
        pool must not end up resurrecting it."""
        net = SimNet(seed=6, difficulty=DIFF, store_dir=tmp_path, device="cpu")
        wallet, payee = _wallets(6)
        h = net.host_name

        async def main():
            a = await net.add_node(miner_id=wallet.account)
            b = await net.add_node(peers=[h(0)])
            c = await net.add_node(peers=[h(0), h(1)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(2):
                await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: min(net.heights()) == 2 and net.converged(),
                30,
                wall_limit_s=30,
            )
            tx = _tx(net, wallet, payee, b)
            await b.submit_tx(tx)
            assert await net.run_until(
                lambda: tx.txid() in a.mempool and tx.txid() in c.mempool,
                30,
                wall_limit_s=30,
            )
            await asyncio.sleep(31.0)  # B checkpoints the pending tx
            # Partition C away; A mines block X (contains the tx); B
            # holds X at its tip and crashes there.
            net.net.partition([h(0), h(1)], [h(2)])
            x = await net.mine_on(a, spacing_s=1.0)
            assert any(t.txid() == tx.txid() for t in x.txs)
            assert await net.run_until(
                lambda: b.chain.height == 3, 30, wall_limit_s=30
            )
            await net.crash_node(h(1))
            # C's side mines LONGER — its first block also carries the
            # tx (it was gossiped pre-partition).
            y1 = await net.mine_on(c, spacing_s=1.0)
            assert any(t.txid() == tx.txid() for t in y1.txs)
            await net.mine_on(c, spacing_s=1.0)
            net.net.heal()
            assert await net.run_until(
                lambda: a.chain.tip_hash == c.chain.tip_hash,
                60,
                wall_limit_s=30,
            )  # A reorged off X onto C's branch
            b2 = await net.recover_node(h(1))
            assert b2.chain.height == 3  # rebooted onto the STALE branch
            assert await net.run_until(
                lambda: b2.chain.tip_hash == c.chain.tip_hash,
                90,
                wall_limit_s=30,
            )
            assert tx.txid() in b2.chain._tx_index
            assert tx.txid() not in b2.mempool
            assert net.ledger_conserved()
            await net.stop_all()

        net.run(main())


class TestStoreRecoverySim:
    """The ENOSPC degrade→serve-only→recover e2e from test_storefault,
    on SimNet at PRODUCTION backoff deadlines (0.25 s base, 5 s cap —
    the defaults) in milliseconds of wall time.  The socket original
    stays as slow smoke, same migration pattern as the
    stall-failover port."""

    def test_enospc_degrades_serves_and_recovers_virtual_time(
        self, tmp_path
    ):
        from p1_tpu_torch.chain.testing import StoreFaultPlan
        from p1_tpu_torch.node import protocol
        from p1_tpu_torch.node.protocol import MsgType

        net = SimNet(seed=7, difficulty=DIFF, store_dir=tmp_path, device="cpu")

        async def main():
            a = await net.add_node()
            for _ in range(10):
                await net.mine_on(a)
            # B joins and IBDs from A; write #1 is the magic, so the
            # 4th record append hits persistent ENOSPC mid-sync.
            b = await net.add_node(
                peers=[net.host_name(0)],
                store_plan=StoreFaultPlan(fail_writes_from=5),
            )
            host_b = net.host_name(1)
            assert await net.run_until(
                lambda: b._store_degraded, 60, wall_limit_s=30
            )
            status = b.status()["storage"]
            assert status["degraded"] is True and status["errors"] >= 1
            # The delivering session survives the disk fault.
            assert b.peer_count() >= 1
            frozen = b.chain.height
            assert frozen < 10
            # Serve-only: a light client still gets headers over the
            # sim transport.
            reader, writer = await net.net.host("client").connect(
                host_b, 9444
            )
            await protocol.write_frame(
                writer,
                protocol.encode_hello(
                    protocol.Hello(
                        b.chain.genesis.block_hash(), 0, 0, 0
                    )
                ),
            )
            await protocol.read_frame(reader)  # B's HELLO
            await protocol.write_frame(writer, protocol.encode_getheaders([]))
            while True:
                mtype, body = protocol.decode(
                    await protocol.read_frame(reader)
                )
                if mtype is MsgType.HEADERS:
                    break
            assert len(body) == frozen + 1
            writer.close()
            # Space comes back; the recovery loop (production jittered
            # backoff, virtual time) flushes, recovers, backfills.
            net.stores[host_b].clear_faults()
            assert await net.run_until(
                lambda: not b._store_degraded, 60, wall_limit_s=30
            )
            assert b.metrics.store_recoveries == 1
            assert await net.run_until(
                lambda: b.chain.height == 10, 120, wall_limit_s=30
            )
            await net.stop_all()
            # Everything accepted is durably on disk, in order.
            store = ChainStore(tmp_path / f"{host_b}.dat")
            assert len(store.load_blocks()) == 10

        net.run(main())


class TestDeterminism:
    """One seed ⇒ one byte-identical run, crash/recover included."""

    def test_same_seed_same_report_across_crashes(self):
        # Seed 0's generated schedule carries two crashes (and the
        # epilogue recovers), so the digest covers crash/recover too.
        evs = chaos.generate_schedule(0, 5, 10)
        assert sum(1 for e in evs if e["op"] == "crash") >= 1
        a = chaos.run_chaos(0, nodes=5, n_events=10, device="cpu")
        b = chaos.run_chaos(0, nodes=5, n_events=10, device="cpu")
        a.pop("wall_s")
        b.pop("wall_s")
        assert a["ok"] and a == b

    def test_different_seed_different_trace(self):
        a = chaos.run_chaos(0, nodes=5, n_events=10, device="cpu")
        b = chaos.run_chaos(1, nodes=5, n_events=10, device="cpu")
        assert a["trace_digest"] != b["trace_digest"]

    def test_schedules_are_json_round_trippable(self):
        evs = chaos.generate_schedule(9, 6, 16)
        assert json.loads(json.dumps(evs)) == evs
        assert evs == chaos.generate_schedule(9, 6, 16)


@pytest.mark.chaos
class TestInvariantSweep:
    """The randomized search itself: every seed's schedule must hold
    every invariant.  Tier-1 carries the bounded sweep; the wide one
    rides the slow set (both green is the acceptance bar)."""

    def test_bounded_tier1_sweep_30_schedules(self):
        # The tier-1 sweep runs STAGED (lane workers on) —
        # the schedule corpus now carries stage_crash events, and the
        # sweep must prove the pipeline's respawn-and-retry under every
        # other fault family, not just in isolation.  Lane jobs stay
        # synchronous under the virtual loop, so this flips behavior,
        # not determinism (the digest pair test pins that).
        failures = []
        for seed in range(30):
            report = chaos.run_chaos(
                seed, nodes=5, n_events=10, pipeline_workers=1, device="cpu"
            )
            if not report["ok"]:
                failures.append((seed, report["violations"]))
        assert not failures, failures

    def test_recon_sweep_holds_every_invariant(self):
        """The same schedule corpus with set-reconciliation
        relay ON mesh-wide (recon=True — no deployment table, recon
        from block 0).  Crashes, partitions, and reorgs land on nodes
        whose tx relay is sketch rounds + deferred GETTX fetches, and
        every invariant (convergence, conservation, mempool checkpoint
        consistency) must hold exactly as under flood.  Opt-in kwarg,
        so the seed-stable digest corpus above is untouched."""
        failures = []
        for seed in range(10):
            report = chaos.run_chaos(
                seed, nodes=5, n_events=10, recon=True, device="cpu"
            )
            if not report["ok"]:
                failures.append((seed, report["violations"]))
        assert not failures, failures

    @pytest.mark.slow
    def test_wide_sweep_200_schedules(self):
        failures = []
        for seed in range(200):
            report = chaos.run_chaos(seed, nodes=6, n_events=14, device="cpu")
            if not report["ok"]:
                failures.append((seed, report["violations"]))
        assert not failures, failures


@pytest.mark.chaos
class TestShrinker:
    def test_ddmin_minimizes_synthetic_predicate(self):
        # Pure-logic check, no sim: the violation needs events 3 AND 7.
        events = [{"at": float(i), "op": "mine", "node": i} for i in range(10)]

        def fails(subset):
            ids = {e["node"] for e in subset}
            return 3 in ids and 7 in ids

        shrunk, runs = chaos.shrink_schedule(events, fails)
        assert sorted(e["node"] for e in shrunk) == [3, 7]
        assert runs <= 60

    def test_injected_bug_shrinks_to_at_most_5_events_and_reproduces(
        self, tmp_path
    ):
        """The acceptance proof: a deliberately seeded recovery bug
        (test-only flag) is found by the sweep, minimized to ≤5 events,
        and its artifact reproduces through the same replay path
        `p1 chaos --repro` uses."""
        # Sweep-pick the witness seed the way the real pipeline would:
        # the first schedule the injected bug actually violates (having
        # a crash op is necessary but not sufficient — the victim also
        # needs a post-recover append inside the horizon, and the op
        # corpus drifts as fault families are added).
        for seed in range(20):
            events = chaos.generate_schedule(seed, 5, 10)
            report = chaos.run_chaos(
                seed, nodes=5, events=events, inject_bug="relapse-disk", device="cpu"
            )
            if not report["ok"]:
                break
        assert not report["ok"]
        target = report["violations"][0]["invariant"]

        def reproduces(subset):
            rep = chaos.run_chaos(
                seed, nodes=5, events=subset, inject_bug="relapse-disk", device="cpu"
            )
            return any(v["invariant"] == target for v in rep["violations"])

        shrunk, _runs = chaos.shrink_schedule(events, reproduces)
        assert len(shrunk) <= 5
        final = chaos.run_chaos(
            seed, nodes=5, events=shrunk, inject_bug="relapse-disk", device="cpu"
        )
        path = tmp_path / "repro.json"
        chaos.write_repro(
            path,
            final,
            shrunk,
            seed=seed,
            nodes=5,
            difficulty=8,
            inject_bug="relapse-disk",
        )
        rep, artifact = chaos.run_repro(path, device="cpu")
        assert {v["invariant"] for v in rep["violations"]} >= {target}
        assert rep["trace_digest"] == artifact["expected_trace_digest"]

    def test_deaf_recover_bug_isolates_an_undialed_node(self):
        """The second injected bug class: a reboot that loses its peer
        list strands a node nobody dials (the backbone's last host) —
        violated with the bug, clean without it."""
        events = [
            {"at": 2.0, "op": "crash", "node": 4, "torn": 0},
            {"at": 4.0, "op": "mine", "node": 0},
        ]
        bugged = chaos.run_chaos(
            3, nodes=5, events=events, inject_bug="deaf-recover", device="cpu"
        )
        assert any(
            v["invariant"] == "converge" for v in bugged["violations"]
        )
        assert chaos.run_chaos(3, nodes=5, events=events, device="cpu")["ok"]

    def test_repro_rejects_foreign_files(self, tmp_path):
        bad = tmp_path / "nope.json"
        bad.write_text("definitely not json{")
        with pytest.raises(ValueError):
            chaos.run_repro(bad, device="cpu")
        wrong = tmp_path / "wrong.json"
        wrong.write_text(json.dumps({"format": "something-else"}))
        with pytest.raises(ValueError):
            chaos.run_repro(wrong, device="cpu")


#: The literal schedule (seed 30 @ 6 nodes / 14 events as first
#: generated) that exposed the announce-skip liveness bug: node 1
#: crashes and rots, reboots BEHIND both the mesh and node 0 (whose
#: only link node 1 is), syncs through two interleaved episodes, and
#: the one-shot post-catch-up tip announce — consumed on the BEHIND
#: peer's quiesce — used to skip exactly that peer.  Pinned literally
#: so generator changes can never un-pin the regression.
REGRESSION_ANNOUNCE_SKIP = [
    {"at": 2.345, "op": "tx", "amount": 4, "fee": 1},
    {"at": 3.007, "op": "mine", "node": 5},
    {"at": 3.271, "op": "mine", "node": 5},
    {"at": 5.218, "op": "crash", "node": 1, "torn": 2459},
    {"at": 6.237, "op": "disk_fail", "node": 1, "errno": 28},
    {"at": 7.404, "op": "tx", "amount": 3, "fee": 0},
    {"at": 13.286, "op": "mine", "node": 5},
    {"at": 13.494, "op": "mine", "node": 2},
    {"at": 16.254, "op": "mine", "node": 4},
    {"at": 19.382, "op": "disk_fail", "node": 2, "errno": 5},
    {"at": 20.045, "op": "hostile", "node": 3, "fault": "swallow", "height": 6},
    {"at": 21.597, "op": "corrupt", "node": 1, "offset": 383762},
    {"at": 25.709, "op": "partition", "frac": 0.7},
    {"at": 28.808, "op": "disk_fail", "node": 0, "errno": 5},
]


@pytest.mark.chaos
class TestRegressions:
    """Named regression schedules for the REAL bugs the first chaos
    sweeps surfaced (both fixed this round)."""

    def test_announce_skip_schedule_seed30(self):
        """node.py: the post-catch-up tip announce must not skip the
        quiescing peer — with interleaved sync episodes it can be the
        one node that still needs the push (details on the pinned
        constant above)."""
        report = chaos.run_chaos(
            30, nodes=6, events=REGRESSION_ANNOUNCE_SKIP, device="cpu"
        )
        assert report["ok"], report["violations"]

    def test_quarantined_log_head_does_not_brick_recovery(self, tmp_path):
        """store.py orphans_ok: a crashed node whose heal quarantines
        the FIRST record used to refuse to boot ("records do not
        connect to genesis") even though the whole suffix was intact
        and the mesh held the missing block — recovery must boot, park
        the survivors as orphans, and resync."""
        net = SimNet(seed=11, difficulty=DIFF, store_dir=tmp_path, device="cpu")

        async def main():
            a = await net.add_node()
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(3):
                await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 3, 30, wall_limit_s=30
            )
            host_b = net.host_name(1)
            await net.crash_node(host_b)
            # Rot one byte inside the FIRST record's payload.
            path = tmp_path / f"{host_b}.dat"
            data = bytearray(path.read_bytes())
            off, _n = ChainStore.scan(bytes(data)).spans[0]
            data[off + 2] ^= 0x40
            path.write_bytes(bytes(data))
            b2 = await net.recover_node(host_b)  # used to raise here
            assert b2.store.healed["quarantined_records"] == 1
            assert b2.chain.height == 0  # nothing connects... yet
            await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b2.chain.height == 4, 90, wall_limit_s=30
            )
            assert net.converged() and net.ledger_conserved()
            await net.stop_all()

        net.run(main())


class TestLongevitySoak:
    """Multi-day virtual-time soaks with leak
    invariants at quiesce.  Tier-1 carries a quarter-day soak (the
    whole machinery: soak schedule shape, probes, leak checks, RSS
    gauge); the slow set carries the ≥1-virtual-week acceptance run."""

    def test_quarter_day_soak_green_with_probes(self):
        r = chaos.longevity_soak(seed=0, nodes=4, days=0.25, device="cpu")
        assert r["ok"], r["violations"]
        assert r["scenario"] == "soak"
        assert r["days_virtual"] == pytest.approx(0.25, abs=0.01)
        # Both leak probes fired and their gauges rode into the report.
        assert r["probes"] == 2
        assert r["leak_gauges"]["mid"] and r["leak_gauges"]["end"]
        for gauges in r["leak_gauges"]["end"].values():
            assert {"tasks", "banned", "sig_cache", "retry_counters"} <= set(
                gauges
            )
        # The RSS gauge measured something real.
        assert r["rss_mb"] is not None and r["rss_mb"] > 0
        assert r["repro"] == "p1 sim soak --seed 0"

    def test_soak_is_deterministic(self):
        a = chaos.longevity_soak(seed=2, nodes=4, days=0.2, device="cpu")
        b = chaos.longevity_soak(seed=2, nodes=4, days=0.2, device="cpu")
        assert a["trace_digest"] == b["trace_digest"]
        # rss/wall are the host-side fields; everything else replays.
        for k in a:
            if k not in ("wall_s", "rss_mb", "leak_gauges"):
                assert a[k] == b[k], k

    def test_rss_bound_is_load_bearing(self):
        r = chaos.longevity_soak(
            seed=0, nodes=4, days=0.2, rss_bound_mb=0.001, device="cpu"
        )
        assert not r["ok"]
        assert any(v["invariant"] == "rss" for v in r["violations"])

    def test_soak_schedule_pairs_every_fault_with_a_clearer(self):
        events = chaos.generate_soak_schedule(
            seed=5, n_nodes=5, horizon_vs=7 * chaos.DAY_VS,
            fault_clusters=28, blocks=336,
        )
        assert [e["at"] for e in events] == sorted(e["at"] for e in events)
        ops = [e["op"] for e in events]
        # Pairing: nothing disruptive outlives its envelope.
        assert ops.count("crash") == ops.count("recover")
        assert ops.count("partition") == ops.count("heal")
        assert ops.count("disk_fail") == ops.count("disk_heal")
        assert ops.count("slow_link") == ops.count("restore_link")
        assert ops.count("hostile") + ops.count("flood") == ops.count("calm")
        assert ops.count("probe") == 2
        # And the horizon really is the week asked for.
        assert events[-1]["at"] >= 7 * chaos.DAY_VS - 1.0

    @pytest.mark.slow
    def test_one_virtual_week_acceptance_run(self):
        """Acceptance: ≥1 virtual week green, leak invariants
        (RSS gauge, ban tables, retry counters, cache bounds) asserted
        at quiesce."""
        r = chaos.longevity_soak(seed=0, device="cpu")
        assert r["ok"], r["violations"]
        assert r["days_virtual"] >= 7.0
        assert r["probes"] == 2
        assert r["crashes"] >= 1 and r["recoveries"] == r["crashes"]
        # ~12,000x time compression makes the week a sub-two-minute
        # test; the wall guard is the regression tripwire.
        assert r["wall_s"] < 300.0


@pytest.mark.chaos
class TestMaintenanceChaos:
    """Fault families of the always-on maintenance plane under
    chaos.  The generated corpus must carry all four ops (so the sweeps
    exercise them organically), a crafted schedule must FIRE all four
    against live invariants, and the kill-9 mid-rebase must reboot as
    an ordinary un-rebased node."""

    FAMILIES = (
        "rebase",
        "seal_sidecar_crash",
        "online_prune",
        "online_compact_crash",
    )

    def test_generated_corpus_carries_all_four_families(self):
        ops: set[str] = set()
        crash_flags: set[bool] = set()
        for seed in range(40):
            for ev in chaos.generate_schedule(seed, 5, 10):
                ops.add(ev["op"])
                if ev["op"] == "rebase":
                    crash_flags.add(ev["crash"])
        for family in self.FAMILIES:
            assert family in ops, f"{family} never generated in 40 seeds"
        # Both rebase variants appear: the clean live re-base and the
        # kill-9 between the store half and the in-RAM half.
        assert crash_flags == {True, False}

    def test_crafted_schedule_fires_all_four_families(self, monkeypatch):
        """A hand-laid schedule where every family FIRES (not degrades
        to a refusal no-op), proven by spying the runner's trace
        records; the run itself must hold every invariant."""
        t = [0.0]

        def ev(**kw):
            t[0] += 0.8
            return {"at": round(t[0], 3), **kw}

        events = (
            # Enough depth for a checkpointed rebase target and a
            # pruneable sealed segment (snapshot cadence is 4).
            [ev(op="mine", node=0) for _ in range(14)]
            + [
                # Forced seal with the .sdx write failing: tolerated,
                # healed, recorded.
                ev(op="seal_sidecar_crash", node=0),
                # Live re-base (rolls + spills sidecars, then advances
                # the in-RAM base) on the mining node.
                ev(op="rebase", node=0, keep=2, crash=False),
            ]
            + [ev(op="mine", node=0) for _ in range(4)]
            + [
                # The rebase's roll sealed everything below the new
                # checkpoint: this prune MUST discard segments.
                ev(op="online_prune", node=0, keep=2),
                # Planner death mid-compaction on a peer that keeps
                # serving.
                ev(op="online_compact_crash", node=1),
            ]
            + [ev(op="mine", node=1) for _ in range(2)]
        )
        recorded: list[tuple] = []
        orig = chaos._ChaosRunner._record

        def spy(self, *fields):
            recorded.append(fields)
            orig(self, *fields)

        monkeypatch.setattr(chaos._ChaosRunner, "_record", spy)
        report = chaos.run_chaos(0, nodes=3, events=events, device="cpu")
        assert report["ok"], report["violations"]
        fired = {r[0] for r in recorded}
        for family in self.FAMILIES:
            assert family in fired, (family, sorted(fired))
        # online_prune only records when segments actually dropped;
        # the count rode into the trace.
        prune = next(r for r in recorded if r[0] == "online_prune")
        assert prune[2] >= 1

    def test_kill9_mid_rebase_reboots_unrebased(self, monkeypatch):
        """The crash contract of leg (a): the durable store half (seal
        + sidecar spill) lands, the process dies before the in-RAM
        rebase — reboot must come back consistent (fsck clean, exact
        prefix), i.e. the kill-9 costs the rebase, never the chain."""
        t = [0.0]

        def ev(**kw):
            t[0] += 0.8
            return {"at": round(t[0], 3), **kw}

        events = (
            [ev(op="mine", node=0) for _ in range(10)]
            + [
                ev(op="rebase", node=0, keep=2, crash=True),
                ev(op="recover", node=0),
            ]
            + [ev(op="mine", node=0) for _ in range(2)]
        )
        recorded: list[tuple] = []
        orig = chaos._ChaosRunner._record

        def spy(self, *fields):
            recorded.append(fields)
            orig(self, *fields)

        monkeypatch.setattr(chaos._ChaosRunner, "_record", spy)
        report = chaos.run_chaos(3, nodes=3, events=events, device="cpu")
        assert report["ok"], report["violations"]
        assert report["crashes"] == 1 and report["recoveries"] == 1
        assert any(r[0] == "rebase_crash" for r in recorded)
        # The rebase itself never happened — no "rebase" record, so the
        # reboot was an ordinary un-rebased node with spare sidecars.
        assert not any(r[0] == "rebase" for r in recorded)

    def test_soak_schedule_carries_maintenance_clusters(self):
        """generate_soak_schedule's `maintenance` cluster kind: a week
        of recurring self-maintenance must appear in the soak corpus —
        sidecar failure at a seal, live re-base, and exactly one prune
        (someone keeps the archive) with compaction faults thereafter."""
        ops: list[str] = []
        for seed in range(8):
            events = chaos.generate_soak_schedule(
                seed=seed, n_nodes=5, horizon_vs=7 * chaos.DAY_VS,
                fault_clusters=28, blocks=336,
            )
            ops.extend(e["op"] for e in events)
            # At most one online_prune per schedule: the archive rule.
            assert ops.count("online_prune") <= len(ops)
            assert (
                sum(1 for e in events if e["op"] == "online_prune") <= 1
            )
        for family in ("seal_sidecar_crash", "rebase", "online_prune",
                       "online_compact_crash"):
            assert family in ops, f"{family} absent from 8 soak seeds"


@pytest.mark.chaos
class TestSubscriptionChaos:
    """The wallet push plane under chaos.  The
    generated corpus must carry the subscription ops (so the sweeps
    exercise watchers organically), crafted schedules must prove the
    two headline behaviors — a watcher rides out the death of its
    serving replica by failing over with a resume cursor, and a
    SUBSCRIBE flood neither wedges the victim nor starves an honest
    watcher — and the mute-push injectable bug proves the push-missed
    invariant has teeth."""

    @staticmethod
    def _ev_clock():
        t = [0.0]

        def ev(**kw):
            t[0] += 0.8
            return {"at": round(t[0], 3), **kw}

        return ev

    def test_generated_corpus_carries_subscription_ops(self):
        ops: set[str] = set()
        for seed in range(40):
            for ev in chaos.generate_schedule(seed, 5, 10):
                ops.add(ev["op"])
        for op in ("watch_start", "watch_stop", "sub_flood"):
            assert op in ops, f"{op} never generated in 40 seeds"

    def test_crafted_watcher_survives_serving_node_crash_mid_push(self):
        """The failover contract, end to end on SimNet: a
        wallet watches node 1, node 1 dies abruptly mid-stream, blocks
        keep paying the watched account on the survivors — the watch
        must fail over (resume cursor, commitment-verified) and arrive
        at quiesce gap-free, chain-true, and with every payment seen
        (the push-gap/push-chain/push-commit/push-missed suite)."""
        ev = self._ev_clock()
        events = (
            [ev(op="mine", node=0) for _ in range(2)]
            + [ev(op="watch_start", node=1, watcher=0)]
            + [ev(op="tx", amount=2, fee=1), ev(op="mine", node=0)]
            + [ev(op="crash", node=1)]
            + [ev(op="tx", amount=1, fee=1), ev(op="mine", node=0)]
            + [ev(op="tx", amount=3, fee=0), ev(op="mine", node=2)]
            + [ev(op="recover", node=1)]
            + [ev(op="mine", node=0)]
        )
        report = chaos.run_chaos(0, nodes=3, events=events, device="cpu")
        assert report["ok"], report["violations"]
        assert report["watchers"] == 1
        # The watch saw the whole window despite its replica dying:
        # payment block, the two blocks mined while node 1 was down,
        # and the settle block.
        assert report["watch_events"] >= 4

    def test_crafted_sub_flood_is_survived_and_cleared(self):
        """A SUBSCRIBE flood (rotating watch sets + one unverifiable
        resume cursor per frame burst) against the node an honest
        watcher is riding: admission control must shed it without
        wedging the victim or the watcher, and `calm` + quiesce must
        find zero leaked sessions (push-leak)."""
        ev = self._ev_clock()
        events = (
            [ev(op="mine", node=0) for _ in range(2)]
            + [ev(op="watch_start", node=0, watcher=0)]
            + [ev(op="sub_flood", node=0)]
            + [ev(op="tx", amount=2, fee=1), ev(op="mine", node=1)]
            + [ev(op="calm")]
            + [ev(op="tx", amount=1, fee=1), ev(op="mine", node=0)]
        )
        report = chaos.run_chaos(0, nodes=3, events=events, device="cpu")
        assert report["ok"], report["violations"]
        assert report["watch_events"] >= 3

    def test_mute_push_bug_is_caught(self):
        """The watcher invariants have teeth: `mute-push` strips the
        match payload from delivered events (a push plane that
        "notifies" without telling the wallet it was paid) and the
        push-missed invariant must convict; the identical clean run
        must be green."""
        ev = self._ev_clock()
        events = (
            [ev(op="mine", node=0) for _ in range(2)]
            + [ev(op="watch_start", node=1, watcher=0)]
            + [ev(op="tx", amount=2, fee=1), ev(op="mine", node=0)]
            + [ev(op="tx", amount=1, fee=1), ev(op="mine", node=0)]
        )
        bad = chaos.run_chaos(1, nodes=3, events=events,
                              inject_bug="mute-push", device="cpu")
        assert not bad["ok"]
        assert {v["invariant"] for v in bad["violations"]} == {"push-missed"}
        good = chaos.run_chaos(1, nodes=3, events=events, device="cpu")
        assert good["ok"], good["violations"]
        assert good["watch_events"] >= 3

    def test_soak_schedule_carries_subscription_churn(self):
        """generate_soak_schedule's `subs` cluster kind: recurring
        subscribe/push/unsubscribe cycles across a virtual week, every
        watch_start paired with a watch_stop inside its envelope and a
        block inside the window so each cycle carries a real push."""
        total = 0
        for seed in range(8):
            events = chaos.generate_soak_schedule(
                seed=seed, n_nodes=5, horizon_vs=7 * chaos.DAY_VS,
                fault_clusters=28, blocks=336,
            )
            ops = [e["op"] for e in events]
            assert ops.count("watch_start") == ops.count("watch_stop")
            starts = [e for e in events if e["op"] == "watch_start"]
            stops = [e for e in events if e["op"] == "watch_stop"]
            for a, b in zip(starts, stops):
                assert a["at"] < b["at"]
                # The envelope carries at least one block to push.
                assert any(
                    e["op"] == "mine" and a["at"] < e["at"] < b["at"]
                    for e in events
                )
            total += len(starts)
        assert total >= 1, "subs clusters absent from 8 soak seeds"
