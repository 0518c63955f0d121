"""The port's overload resilience against the JAX package's.

Mirrors tests/test_overload.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
The slow flood soak stays ``slow``, as in the reference.

Overload resilience: admission control, write-queue caps, flood soak.

The network half of the governor tests (unit/property cases live in
tests/test_governor.py): real GreedyPeers — protocol-valid floods the
misbehavior score cannot see — against real in-process nodes.  The slow
soak is the PR's acceptance scenario: ≥3 sustained attackers, the node
stays live and memory-bounded, an honest peer completes IBD through the
noise, and the SHED state recovers (hysteresis) once the attackers go.
"""

import asyncio
import time

import pytest

from p1_tpu_torch.chain import ChainStore
from torch_testutil import NodeConfig
from p1_tpu_torch.node import Node
from p1_tpu_torch.node.testing import FloodPlan, GreedyPeer, make_blocks

DIFF = 8  # a few hashes per block: flood chains are cheap to mine


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def wait_until(cond, timeout=20.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


def _config(**kw) -> NodeConfig:
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("mine", False)
    kw.setdefault("chunk", 1 << 12)
    return NodeConfig(**kw)


class TestAdmission:
    def test_query_flood_is_dropped_then_banned(self):
        async def scenario():
            blocks = make_blocks(20, difficulty=DIFF)
            node = Node(_config())
            await node.start()
            for b in blocks[1:]:
                node.chain.add_block(b)
            flooder = GreedyPeer(blocks, FloodPlan(queries=True))
            try:
                await flooder.start("127.0.0.1", node.port)
                # Budget burst spent -> drops -> violations -> the
                # existing accept-time ban refuses the reconnects.
                assert await wait_until(
                    lambda: node.governor.admission_drops["queries"] > 0
                )
                assert await wait_until(
                    lambda: node._is_banned("127.0.0.1"), timeout=30
                )
                assert await wait_until(
                    lambda: flooder.refused + flooder.disconnects > 0,
                    timeout=30,
                )
                # The node is alive and serving through it all.
                assert node.status()["height"] == 20
            finally:
                await flooder.stop()
                await node.stop()

        run(scenario())

    def test_tx_flood_is_clipped_at_the_door(self):
        from torch_testutil import account, stx

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                # Protocol-valid, signature-valid, unaffordable spends:
                # nothing scorable about them — only the admission
                # budget stands between this flood and per-frame
                # decode+verify work (and the pool's capacity).
                from p1_tpu_torch.node import protocol

                frames = tuple(
                    protocol.encode_tx(
                        stx("pauper", account("x"), 1, 1, seq, difficulty=DIFF)
                    )
                    for seq in range(8)
                )
                blocks = make_blocks(1, difficulty=DIFF)
                flooder = GreedyPeer(blocks, FloodPlan(tx_frames=frames))
                await flooder.start("127.0.0.1", node.port)
                assert await wait_until(
                    lambda: node.governor.admission_drops["txs"] > 0
                )
                assert len(node.mempool) == 0  # nothing hostile admitted
                await flooder.stop()
            finally:
                await node.stop()

        run(scenario())

    def test_orphan_spray_stays_bounded(self):
        from p1_tpu_torch.chain.chain import MAX_ORPHANS

        async def scenario():
            node = Node(_config())
            await node.start()
            spray = GreedyPeer(
                make_blocks(40, difficulty=DIFF), FloodPlan(orphans=True)
            )
            try:
                await spray.start("127.0.0.1", node.port)
                assert await wait_until(lambda: spray.sent > 100)
                assert len(node.chain._orphan_hashes) <= MAX_ORPHANS
                assert node.status() is not None  # alive
            finally:
                await spray.stop()
                await node.stop()

        run(scenario())

    def test_honest_rates_never_clipped(self):
        """The false-positive control: a two-node mesh mining and
        gossiping at full localhost speed never trips admission."""

        async def scenario():
            a = Node(_config(mine=True, miner_id="a"))
            await a.start()
            b = Node(_config(peers=(f"127.0.0.1:{a.port}",)))
            await b.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 15)
                await a.stop_mining()
                assert await wait_until(
                    lambda: b.chain.height == a.chain.height
                )
                for node in (a, b):
                    drops = node.governor.admission_drops
                    assert drops == {"blocks": 0, "txs": 0, "queries": 0}
                    assert node.governor.peers_dropped_squat == 0
            finally:
                await b.stop()
                await a.stop()

        run(scenario())


class TestWriteQueue:
    def test_squatting_peer_is_dropped(self):
        async def scenario():
            blocks = make_blocks(250, difficulty=DIFF)
            node = Node(_config())
            await node.start()
            for b in blocks[1:]:
                node.chain.add_block(b)
            # Tight cap so a ~40 KB sync reply backlog trips it fast.
            node.governor.write_queue_max = 16 << 10
            squatter = GreedyPeer(blocks, FloodPlan(squat=True, burst=8))
            try:
                await squatter.start("127.0.0.1", node.port)
                assert await wait_until(
                    lambda: node.governor.peers_dropped_squat > 0, timeout=30
                )
                assert node.status()["height"] == 250  # alive, serving
            finally:
                await squatter.stop()
                await node.stop()

        run(scenario())


@pytest.mark.slow
class TestFloodSoak:
    def test_three_greedy_peers_vs_honest_ibd(self, tmp_path):
        """The acceptance scenario: ≥3 sustained protocol-valid
        attackers (query flood, orphan spray, write-queue squat) against
        a node running memory-bounded (body eviction on, watermark
        armed).  Through the whole window the node must stay live and
        within a bounded factor of its watermark, an honest peer must
        complete IBD of the full chain, and no consensus-critical reply
        to it may be lost; once the attackers disconnect the governor
        must come back to NORMAL (hysteresis)."""

        async def scenario():
            blocks = make_blocks(600, difficulty=DIFF, miner_id="v")
            store = ChainStore(tmp_path / "victim.dat")
            store.acquire()
            for b in blocks[1:]:
                store.append(b)
            store.close()

            victim = Node(
                _config(
                    store_path=str(tmp_path / "victim.dat"),
                    body_cache_blocks=16,
                    mem_watermark_bytes=1,  # re-pinned below, post-resume
                )
            )
            await victim.start()
            assert victim.chain.height == 600
            assert victim.chain.bodies_evicted > 0  # bounded resume ran
            # Watermark: a little above the quiescent gauge, so attack
            # pressure (write-buffer growth above all) crosses it and
            # the hysteresis round trip is actually exercised.
            quiescent = victim._memory_gauge()
            victim.governor.watermark_bytes = quiescent + (96 << 10)
            victim.governor.low_watermark_bytes = quiescent + (48 << 10)
            # Hard squat cap low enough to fire repeatedly in the window.
            victim.governor.write_queue_max = 256 << 10

            attackers = [
                GreedyPeer(
                    blocks, FloodPlan(queries=True), source="127.0.0.61"
                ),
                GreedyPeer(
                    make_blocks(60, difficulty=DIFF, miner_id="o"),
                    FloodPlan(orphans=True),
                    source="127.0.0.62",
                ),
                GreedyPeer(
                    blocks,
                    FloodPlan(squat=True, burst=8),
                    source="127.0.0.63",
                ),
            ]
            honest = Node(
                _config(peers=(f"127.0.0.1:{victim.port}",))
            )
            rss_samples = []

            def rss_bytes() -> int:
                with open("/proc/self/statm") as fh:
                    import os

                    return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

            try:
                for attacker in attackers:
                    await attacker.start("127.0.0.1", victim.port)
                await asyncio.sleep(1.0)  # attackers engaged first
                await honest.start()
                deadline = time.monotonic() + 25.0
                while time.monotonic() < deadline:
                    await asyncio.sleep(0.5)
                    rss_samples.append(rss_bytes())
                    # Live through the whole window: status() answers.
                    assert victim.status()["height"] == 600
                    g = victim.governor
                    if (
                        honest.chain.height == 600
                        and g.sheds > 0
                        and (
                            sum(g.admission_drops.values()) > 0
                            or g.peers_dropped_squat > 0
                        )
                    ):
                        break
                # (1) The honest peer completed IBD under attack — no
                # consensus-critical reply to it was dropped (a dropped
                # batch would stall its supervised sync past the window).
                assert honest.chain.height == 600
                assert honest.chain.tip_hash == victim.chain.tip_hash
                # ...and the honest host was never scored or banned.
                assert not victim._is_banned("127.0.0.1")
                # (2) Memory stayed bounded: the accounted gauge within
                # a small factor of the watermark (one squat cap of
                # overshoot at most), the resident bodies at O(cache),
                # and process RSS sane for a 600-block chain + attack.
                g = victim.governor
                assert g.tracked_peak_bytes <= (
                    g.watermark_bytes + g.write_queue_max + (512 << 10)
                )
                assert victim.chain.resident_body_bytes < (256 << 10)
                assert max(rss_samples) < 2 << 30
                # (3) The attack was actually repelled, not absorbed:
                # admission dropped flood frames and/or squatters died.
                assert (
                    sum(g.admission_drops.values()) > 0
                    or g.peers_dropped_squat > 0
                )
                # (4) Overload engaged... (the squat + floods must have
                # pushed the gauge over the pinned watermark)
                assert g.sheds > 0
            finally:
                for attacker in attackers:
                    await attacker.stop()
            try:
                # (5) ...and cleared: hysteresis back to NORMAL once the
                # attackers are gone and the buffers drain.
                assert await wait_until(
                    lambda: not victim.governor.shedding, timeout=30
                )
                # Mining would resume (not paused by the governor).
                assert not victim.status()["overload"]["mining_paused"]
            finally:
                await honest.stop()
                await victim.stop()

        run(scenario(), timeout=300)
