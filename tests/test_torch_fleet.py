"""The port's fleet provisioning (``node/provision.py``) against the JAX package's.

Mirrors tests/test_fleet.py: the reference's cases, run against
``p1_tpu_torch`` with ``device="cpu"``.
``TestDrainAndMaintenance.test_drain_pushes_final_cursor_and_closes``
fails in the reference under Python 3.12.1 and later:
``QueryPlaneServer.drain`` awaits ``Server.wait_closed``, which now waits
for every accepted connection, before it drains the subscriber whose
session it waits on.  The port's ``drain`` awaits the listener only after
the drain (``node/queryplane.py``), and this copy of the test is the
reference's, unchanged.

Fleet provisioning: snapshot-cold-started replicas,
agreement-aware wallet failover, and the kill-one-replica proof.

Four property families anchor the tier:

- **cold start is verified, resumable, and demotes liars**: a replica
  bootstrapped over GETSNAPSHOT pins the snapshot anchor to a
  PoW-verified header skeleton and adopts the filter-header chain only
  after a genesis recompute (plus a second-peer cross-check when one is
  live); a snapshot server off the verified chain is DEMOTED and the
  next peer tried; a torn ``.bootbase`` restarts the stages cleanly
  while an intact one skips straight to the body fill.
- **ReplicaSet policy is deterministic**: health-scored selection,
  spread under ``spread_key``, shed to the full node ONLY when the
  replica tier is exhausted, permanent demotion of proven liars across
  rebalances.
- **no confirmation is missed across the fleet**: a wallet cursor
  replays gap-free across replica drain, live rebase/compact under the
  store, and the shed to the full node once the store prunes; the
  chaos ``replica_kill``/``replica_join`` family and the
  ``fleet-failover`` scenario prove the same at mesh scale,
  deterministically.
- **`p1 serve --bootstrap` / `p1 watch --fallback` surface it**: the
  bootstrap report, the SIGTERM drain line, and the active-target +
  failover-count fields are real process behavior, not just library
  API.
"""

import asyncio
import json
import pathlib
import subprocess
import sys

import pytest

from test_torch_node import DIFF, fund, run, wait_until
from torch_testutil import account

from p1_tpu_torch.chain import ChainStore
from torch_testutil import NodeConfig
from p1_tpu_torch.node import Node
from p1_tpu_torch.node.client import (
    ReplicaSet,
    get_filter_headers,
    get_headers,
    watch,
)
from p1_tpu_torch.node.provision import (
    BootstrapError,
    UpstreamSync,
    bootstrap_store,
    read_bootbase,
    write_bootbase,
)
from p1_tpu_torch.node.queryplane import ReplicaView, serve_replica
from p1_tpu_torch.node.testing import make_blocks

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _config(**kw) -> NodeConfig:
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("mine", False)
    kw.setdefault("peers", ())
    return NodeConfig(**kw)


def _write_store(path, blocks) -> None:
    s = ChainStore(path, fsync=False)
    try:
        for block in blocks[1:]:
            s.append(block)
        s.sync()
    finally:
        s.close()


async def _serving_node(path, n_blocks, miner="fleet-acct", interval=4):
    """A node resumed from a freshly written store; with ``interval``
    set it repopulates state checkpoints during resume replay and
    serves snapshots over GETSNAPSHOT."""
    _write_store(path, make_blocks(n_blocks, DIFF, miner_id=account(miner)))
    node = Node(
        _config(store_path=str(path), snapshot_interval=interval, port=0)
    )
    await node.start()
    return node


# -- the .bootbase sidecar -------------------------------------------------


class TestBootbaseSidecar:
    def _material(self, n=4):
        blocks = make_blocks(n, DIFF)
        headers = [b.header.serialize() for b in blocks[1:]]
        fheaders = [bytes([i]) * 32 for i in range(n + 1)]
        return headers, fheaders

    def test_roundtrip(self, tmp_path):
        store = tmp_path / "c.dat"
        headers, fheaders = self._material()
        path = write_bootbase(store, headers, fheaders)
        assert path.name == "c.dat.bootbase"
        assert read_bootbase(store) == (4, headers, fheaders)

    def test_absent_torn_and_corrupt_all_read_none(self, tmp_path):
        store = tmp_path / "c.dat"
        assert read_bootbase(store) is None
        headers, fheaders = self._material()
        path = write_bootbase(store, headers, fheaders)
        raw = path.read_bytes()
        path.write_bytes(raw[: len(raw) // 2])  # torn
        assert read_bootbase(store) is None
        path.write_bytes(raw[:40] + bytes([raw[40] ^ 1]) + raw[41:])
        assert read_bootbase(store) is None  # digest catches the flip
        path.write_bytes(b"XXXXXXXX" + raw[8:])
        assert read_bootbase(store) is None  # wrong magic
        path.write_bytes(raw)
        assert read_bootbase(store) == (4, headers, fheaders)

    def test_write_checks_filter_header_count(self, tmp_path):
        headers, fheaders = self._material()
        with pytest.raises(ValueError, match="0..base"):
            write_bootbase(tmp_path / "c.dat", headers, fheaders[:-1])


# -- cold start ------------------------------------------------------------


class TestColdStart:
    def test_snapshot_cold_start_then_serve(self, tmp_path):
        """The happy path: bootstrap from one honest peer,
        land a base at the latest checkpoint plus bodies above it, and
        serve a replica whose filter-header chain matches the node's at
        every height — seconds of work bounded by blocks above the
        base, not an IBD."""

        async def scenario():
            node = await _serving_node(tmp_path / "src.dat", 10)
            srv = None
            try:
                replica = str(tmp_path / "replica.dat")
                report = await bootstrap_store(
                    replica, [("127.0.0.1", node.port)], DIFF
                )
                assert report["base"] == 8 and report["tip"] == 10
                assert report["blocks_fetched"] == 2
                assert not report["resumed"] and not report["demoted"]
                bb = read_bootbase(replica)
                assert bb is not None and bb[0] == 8
                srv = await serve_replica(replica, DIFF)
                assert srv.view.assumed_base == 8
                assert srv.view.tip_height == 10
                # Commitment chain identical to the node's, end to end.
                ours = await get_filter_headers(
                    "127.0.0.1", srv.port, 0, 11, DIFF
                )
                theirs = await get_filter_headers(
                    "127.0.0.1", node.port, 0, 11, DIFF
                )
                assert ours == theirs
                # Adopted heights serve headers (hash-pinned skeleton).
                headers = await get_headers("127.0.0.1", srv.port, DIFF)
                assert [h.block_hash() for h in headers] == [
                    node.chain.main_hash_at(i) for i in range(11)
                ]
            finally:
                if srv is not None:
                    await srv.stop()
                await node.stop()

        run(scenario())

    def test_intact_bootbase_resumes_torn_restarts(self, tmp_path):
        """The crash model: a second bootstrap over an intact sidecar
        skips the snapshot stages (and refetches nothing the store
        already holds); corrupting the sidecar falls back to a clean
        fresh start rather than half-loading."""

        async def scenario():
            node = await _serving_node(tmp_path / "src.dat", 10)
            try:
                replica = str(tmp_path / "replica.dat")
                peers = [("127.0.0.1", node.port)]
                first = await bootstrap_store(replica, peers, DIFF)
                assert not first["resumed"]
                again = await bootstrap_store(replica, peers, DIFF)
                assert again["resumed"] and again["base"] == first["base"]
                assert again["blocks_fetched"] == 0
                # Torn sidecar: restart the snapshot stages cleanly.
                bb = tmp_path / "replica.dat.bootbase"
                bb.write_bytes(bb.read_bytes()[:50])
                third = await bootstrap_store(replica, peers, DIFF)
                assert not third["resumed"]
                assert third["base"] == first["base"]
            finally:
                await node.stop()

        run(scenario())

    def test_lying_snapshot_server_demoted_next_peer_tried(self, tmp_path):
        """A snapshot server whose manifest anchors a block that is NOT
        on the PoW-verified skeleton is demoted (the snapshot-sync contract) and
        the next peer is tried; a peer serving no snapshot at all is
        honest, just unhelpful."""

        async def scenario():
            # Skeleton source: honest chain, no snapshots configured.
            bare = await _serving_node(
                tmp_path / "bare.dat", 10, interval=0
            )
            # The liar: a VALID node of a different chain — internally
            # consistent snapshot, anchor off our skeleton.
            liar = await _serving_node(
                tmp_path / "liar.dat", 10, miner="liar-acct"
            )
            honest = await _serving_node(tmp_path / "good.dat", 10)
            try:
                report = await bootstrap_store(
                    str(tmp_path / "replica.dat"),
                    [
                        ("127.0.0.1", bare.port),
                        ("127.0.0.1", liar.port),
                        ("127.0.0.1", honest.port),
                    ],
                    DIFF,
                )
                assert report["base"] == 8 and report["tip"] == 10
                assert len(report["demoted"]) == 1
                d = report["demoted"][0]
                assert d["peer"].endswith(f":{liar.port}")
                assert "anchor" in d["why"]
            finally:
                await honest.stop()
                await liar.stop()
                await bare.stop()

        run(scenario())

    def test_no_snapshot_anywhere_degrades_to_full_fill(self, tmp_path):
        async def scenario():
            node = await _serving_node(tmp_path / "src.dat", 6, interval=0)
            try:
                report = await bootstrap_store(
                    str(tmp_path / "replica.dat"),
                    [("127.0.0.1", node.port)],
                    DIFF,
                )
                assert report["base"] == 0
                assert report["blocks_fetched"] == 6  # the IBD fallback
            finally:
                await node.stop()

        run(scenario())

    def test_no_peers_is_loud(self, tmp_path):
        with pytest.raises(BootstrapError, match="at least one peer"):
            run(bootstrap_store(str(tmp_path / "r.dat"), [], DIFF))


# -- serving-time upstream pull --------------------------------------------


class TestUpstreamSync:
    def test_replica_follows_live_mining_gap_free(self, tmp_path):
        """The `p1 serve --bootstrap` steady state: the sync loop pulls
        new PoW-checked blocks into the replica's own store and the
        refresh loop indexes them — the replica tip tracks the node."""

        async def scenario():
            node = await _serving_node(tmp_path / "src.dat", 6)
            srv, store = None, None
            try:
                replica = str(tmp_path / "replica.dat")
                await bootstrap_store(
                    replica, [("127.0.0.1", node.port)], DIFF
                )
                srv = await serve_replica(
                    replica, DIFF, refresh_interval_s=0.02
                )
                store = ChainStore(replica, fsync=False)
                sync = UpstreamSync(
                    store, srv.view, [("127.0.0.1", node.port)], DIFF
                )
                await fund(node, "fleet-acct", blocks=3)

                async def caught_up():
                    while srv.view.tip_height < node.chain.height:
                        await sync.poll_once()
                        await asyncio.sleep(0.02)

                await asyncio.wait_for(caught_up(), 30)
                assert sync.pulled >= 3 and sync.snapshot()["demoted"] == 0
                srv.view.refresh()
                h = node.chain.height
                assert srv.view.hash_at(h) == node.chain.main_hash_at(h)
            finally:
                if store is not None:
                    store.close()
                if srv is not None:
                    await srv.stop()
                await node.stop()

        run(scenario())


# -- wallet-side fleet policy ----------------------------------------------

R0, R1, R2 = ("10.0.0.1", 9), ("10.0.0.2", 9), ("10.0.0.3", 9)
FULL = ("10.0.0.9", 9)


class TestReplicaSetPolicy:
    def test_spread_keys_spread_a_cold_fleet(self):
        picks = {
            ReplicaSet([R0, R1, R2], spread_key=k).pick() for k in range(3)
        }
        assert picks == {R0, R1, R2}

    def test_streak_fails_over_and_an_event_heals(self):
        rs = ReplicaSet([R0, R1])
        assert rs.pick() == R0
        rs.note_stall(R0)
        assert rs.pick() == R1  # mid-outage loses to healthy fast
        rs.note_event(R0)  # streak resets, cumulative stall remains
        rs.note_stall(R1)
        assert rs.pick() == R0

    def test_shed_to_full_node_only_when_replicas_exhausted(self):
        rs = ReplicaSet([R0, R1], full_node=FULL)
        for _ in range(ReplicaSet.SHED_AFTER):
            rs.note_stall(R0)
        assert rs.pick() == R1  # one replica down is not a shed
        for _ in range(ReplicaSet.SHED_AFTER):
            rs.note_stall(R1)
        assert rs.pick() == FULL  # tier exhausted: full node
        rs.note_event(R1)
        assert rs.pick() == R1  # capacity back on the replica tier

    def test_agreement_earns_bounded_preference(self):
        rs = ReplicaSet([R0, R1])
        rs.note_agreement(R1)
        assert rs.pick() == R1
        # Bounded: a stall streak still dislodges a long-lived favorite.
        for _ in range(30):
            rs.note_agreement(R1)
        for _ in range(5):
            rs.note_stall(R1)
        assert rs.pick() == R0

    def test_violation_is_permanent_across_rebalance(self):
        rs = ReplicaSet([R0, R1], full_node=FULL)
        rs.note_violation(R0)
        assert rs.pick() == R1
        rs.update_targets([R1])
        rs.update_targets([R0, R1])  # the liar re-registers
        assert rs.pick() == R1
        rs.note_violation(R1)
        assert rs.pick() == FULL
        rs.note_violation(FULL)
        assert rs.pick() is None  # caller raises, loudly

    def test_rebalance_forgets_leaver_health_clears_active(self):
        rs = ReplicaSet([R0, R1])
        rs.note_stall(R1)
        rs.mark_active(R1)
        joined, left = rs.update_targets([R0, R2])
        assert joined == [R2] and left == [R1]
        assert rs.active is None and rs.rebalances == 1
        # A re-provisioned address starts cold.
        rs.update_targets([R0, R1, R2])
        assert rs._h(R1)["stalls"] == 0

    def test_mark_active_counts_failovers(self):
        rs = ReplicaSet([R0, R1])
        rs.mark_active(R0)
        rs.mark_active(R0)
        assert rs.failovers == 0
        rs.mark_active(R1)
        assert rs.failovers == 1
        snap = rs.snapshot()
        assert snap["active"] == "10.0.0.2:9" and snap["failovers"] == 1


# -- drain, maintenance, and the cursor across all of it -------------------


class TestDrainAndMaintenance:
    def test_drain_pushes_final_cursor_and_closes(self, tmp_path):
        """SIGTERM's library half: drain() stops accepting, hands every
        live subscriber a final resume cursor, and exits clean."""

        async def scenario():
            store = str(tmp_path / "c.dat")
            node = await _serving_node(store, 4, interval=0)
            srv, gen = None, None
            try:
                await node.stop()  # replica owns the read path now
                srv = await serve_replica(store, DIFF)
                gen = watch(
                    "127.0.0.1", srv.port, [account("fleet-acct")], DIFF,
                    max_session_failures=1,
                )
                agen = gen.__aiter__()
                task = asyncio.ensure_future(agen.__anext__())
                assert await wait_until(
                    lambda: srv.subscriptions.snapshot()["live"] == 1
                )
                drained = await srv.drain()
                assert drained == 1
                assert srv.subscriptions.drained_total == 1
                assert srv.subscriptions.snapshot()["live"] == 0
                # The watcher's session died with the drain; its retry
                # budget (1) re-raises the dead-session error loudly.
                with pytest.raises(
                    (ConnectionError, asyncio.IncompleteReadError)
                ):
                    await asyncio.wait_for(task, 30)
            finally:
                if gen is not None:
                    await gen.aclose()
                if srv is not None:
                    await srv.stop()

        run(scenario())

    def test_cursor_gap_free_across_rebase_compact_then_prune_sheds(
        self, tmp_path
    ):
        """End to end: a wallet cursor replays gap-free
        against a replica refreshed across a live rebase + online
        compaction; once the node PRUNES the store the replica tier is
        honestly gone (a fresh attach refuses) and the ReplicaSet sheds
        the wallet to the full node at the same cursor — heights stay
        contiguous through all of it, zero missed confirmations."""

        async def scenario():
            store = str(tmp_path / "c.dat")
            # Segmented store + checkpoint cadence: the maintenance
            # plane's shape (rebase snaps to a checkpoint, prune drops
            # whole segments).  Mined, not resumed — rebase needs the
            # live checkpoints the mining path records.
            node = Node(
                _config(
                    store_path=store,
                    store_segment_bytes=400,
                    snapshot_interval=4,
                    port=0,
                )
            )
            await node.start()
            await fund(node, "fleet-acct", blocks=8)
            srv, gen = None, None
            try:
                srv = await serve_replica(
                    store, DIFF, refresh_interval_s=0.05
                )
                (fh,) = await get_filter_headers(
                    "127.0.0.1", srv.port, 4, 1, DIFF
                )
                rs = ReplicaSet(
                    [("127.0.0.1", srv.port)],
                    full_node=("127.0.0.1", node.port),
                )
                gen = watch(
                    "127.0.0.1", srv.port, [account("fleet-acct")], DIFF,
                    cursor=(4, fh), replica_set=rs, cross_check_every=0,
                    reconnect_delay_s=0.05, max_session_failures=8,
                )
                agen = gen.__aiter__()
                heights = []

                async def take(n):
                    for _ in range(n):
                        ev = await asyncio.wait_for(agen.__anext__(), 30)
                        assert ev["matched"]
                        heights.append(ev["height"])

                await take(4)  # committed replay 5..8
                # Live maintenance under the replica's mmap.
                assert (await node._maintain({"op": "rebase", "keep": 4}))[
                    "ok"
                ]
                assert (await node._maintain({"op": "compact"}))["ok"]
                await fund(node, "fleet-acct", blocks=2)
                await take(2)  # 9, 10 pushed across the rewrite
                # Prune: the store can no longer back a replica.
                node.store.roll_segment()
                await fund(node, "fleet-acct", blocks=1)
                r = await node._maintain({"op": "prune", "keep": 2})
                assert r["ok"] and r["segments_pruned"] >= 1, r
                with pytest.raises(ValueError, match="pruned"):
                    ReplicaView(store, DIFF)
                # Operator decommissions the replica; the wallet sheds.
                # NOTE: the test miner overshoots its target (it stops
                # only after wait_until sees the height), and the dead
                # replica's last pushes sit in the wallet's socket
                # buffer — so events up to the replica's death-tip can
                # still arrive WITHOUT a failover.  Pin the death-tip,
                # mine past it, and drain until the wallet crosses it:
                # those heights can only come from the full node.
                await srv.stop()
                srv = None
                death_tip = node.chain.height
                await fund(node, "fleet-acct", blocks=2)
                tip = node.chain.height
                while heights[-1] < tip:
                    await take(1)
                assert heights == list(range(5, tip + 1))
                assert rs.active == ("127.0.0.1", node.port)
                assert rs.failovers >= 1
                assert heights[-1] > death_tip
            finally:
                if gen is not None:
                    await gen.aclose()
                if srv is not None:
                    await srv.stop()
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), 120))


# -- fleet at mesh scale ---------------------------------------------------


class TestFleetProof:
    def test_chaos_replica_ops_run_green_and_deterministic(self):
        from p1_tpu_torch.node import chaos

        evs = chaos.generate_schedule(18, 5, 20)
        ops = [e["op"] for e in evs]
        assert "replica_kill" in ops and "replica_join" in ops
        a = chaos.run_chaos(18, nodes=5, n_events=20, device="cpu")
        b = chaos.run_chaos(18, nodes=5, n_events=20, device="cpu")
        assert a["ok"] and not a["violations"]
        a.pop("wall_s")
        b.pop("wall_s")
        assert a == b

    def test_fleet_failover_scenario_zero_missed(self):
        """The kill-one-replica proof as a deterministic scenario: N
        replicas, spread sessions, the most-ridden replica crashed
        mid-push — every stream contiguous and matched."""
        from p1_tpu_torch.node.scenarios import fleet_failover

        r = fleet_failover(seed=0, device="cpu")
        assert r["ok"], r
        assert r["missed_confirmations"] == 0
        assert r["spread"] >= 2 and r["failovers"] >= 1
        again = fleet_failover(seed=0, device="cpu")
        r.pop("wall_s")
        again.pop("wall_s")
        assert r == again


# -- the process surface ---------------------------------------------------


class TestFleetCli:
    def test_serve_bootstrap_then_sigterm_drain(self, tmp_path):
        """`p1 serve --bootstrap <peer>`: the bootstrap report line, a
        ready line carrying the adopted base, real query service, and
        the SIGTERM drain line with a clean exit."""

        async def scenario():
            # The source node must stay LIVE on a running loop while
            # the subprocess bootstraps from it — so all blocking pipe
            # reads go through a worker thread, never the loop thread.
            node = await _serving_node(tmp_path / "src.dat", 14)
            proc = None
            try:
                proc = subprocess.Popen(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "serve",
                        "--store", str(tmp_path / "replica.dat"),
                        "--difficulty", str(DIFF), "--port", "0",
                        "--bootstrap", f"127.0.0.1:{node.port}",
                        "--deadline", "60",
                    ],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL,
                    text=True,
                    cwd=REPO,
                )

                async def line():
                    return await asyncio.wait_for(
                        asyncio.to_thread(proc.stdout.readline), 60
                    )

                boot = json.loads(await line())
                assert boot["config"] == "bootstrap"
                assert boot["base"] == 12 and boot["tip"] == 14
                assert boot["blocks_fetched"] == 2
                ready = json.loads(await line())
                assert ready["config"] == "serve"
                assert ready["height"] == 14
                assert ready["assumed_base"] == 12

                headers = await get_headers(
                    "127.0.0.1", ready["port"], DIFF
                )
                assert len(headers) == 15
                assert (
                    headers[14].block_hash()
                    == node.chain.main_hash_at(14)
                )

                proc.terminate()  # SIGTERM: graceful drain
                out, _ = await asyncio.wait_for(
                    asyncio.to_thread(proc.communicate), 30
                )
                drain = json.loads(out.strip().splitlines()[-1])
                assert drain["config"] == "drain"
                assert proc.returncode == 0
            finally:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), 120))

    def test_watch_fallback_file_failover_surfaces_target(self, tmp_path):
        """A dead primary plus a --fallback-file roster —
        the watch fails over, and every JSON line names the active
        target and the failover count."""
        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", str(DIFF), "--backend", "cpu",
                "--device", "cpu",
                "--chunk", "16384", "--port", "0",
                "--miner-id", "fleet-cli-acct", "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = json.loads(line)["ready"]
                    break
            assert port, "node never printed its ready line"
            roster = tmp_path / "fleet.txt"
            roster.write_text(
                f"# fleet roster\n127.0.0.1:{port}\n"
            )
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "watch",
                    "fleet-cli-acct", "--difficulty", str(DIFF),
                    "--port", "1",  # dead primary
                    "--fallback-file", str(roster),
                    "--deadline", "90", "--max-events", "2",
                ],
                capture_output=True,
                text=True,
                timeout=110,
                cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            lines = [
                json.loads(l) for l in proc.stdout.strip().splitlines()
            ]
            assert len(lines) == 2
            for l in lines:
                assert l["matched"]
                assert l["target"] == f"127.0.0.1:{port}"
                assert l["failovers"] >= 1
        finally:
            try:
                node.communicate(input="0\n", timeout=30)
            except subprocess.TimeoutExpired:
                node.kill()
            node_log.close()
