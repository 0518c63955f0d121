"""The port's sync-stall failover against the JAX package's.

Mirrors tests/test_syncfault.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
The hostile peers are the port's ``node/testing.py`` ``HostilePeer``.

Sync-stall failover: request supervision under injected delivery faults.

The attack class: locator sync was always
re-requested from the single peer that triggered it, and the liveness
layer's bar is deliberately generous — a peer that answers PINGs, or
trickles bytes, or serves well-formed-but-useless replies stays under it
while pinning a fresh node's catch-up forever.  These tests drive a real
victim ``Node`` against scripted ``HostilePeer`` adversaries
(p1_tpu_torch/node/testing.py) and assert the supervision layer
(p1_tpu_torch/node/supervision.py) actually rescues the sync: the stall is
detected within its progress deadline, the locator fails over to a
different peer, the staller is demoted — never banned — and an honest
slow peer is never falsely demoted (the acceptance pair).
"""

import asyncio
import time

import pytest

from test_torch_node import CHUNK, DIFF, run, wait_until
from torch_testutil import account, stx

from torch_testutil import NodeConfig
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.protocol import MsgType
from p1_tpu_torch.node.supervision import RequestSupervisor, SyncStalled
from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks


def _config(peers=(), **kw) -> NodeConfig:
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("mine", False)
    # Snappy supervision so the suite doesn't sit through production-scale
    # deadlines; the defaults differ only in magnitude.  The deadline
    # still leaves ~4 supervision ticks and a wide margin over localhost
    # reply latency, so a loaded CI box can't fire it spuriously.
    kw.setdefault("sync_stall_timeout_s", 0.6)
    kw.setdefault("sync_backoff_base_s", 0.05)
    kw.setdefault("sync_backoff_max_s", 0.2)
    return NodeConfig(peers=tuple(peers), **kw)


# Module-scoped chain: mining 30 blocks once (~100 ms total at DIFF=12)
# instead of per-test keeps the file fast on the 1-vCPU host.
_CHAIN30 = make_blocks(30, DIFF)


class TestSupervisorUnit:
    """The state machine alone, on a fake clock and pinned RNG."""

    def _sup(self, **kw):
        self.now = 0.0
        kw.setdefault("stall_timeout_s", 10.0)
        kw.setdefault("attempts_max", 3)
        import random

        kw.setdefault("rng", random.Random(7))
        return RequestSupervisor(clock=lambda: self.now, **kw)

    def test_deadline_arms_on_begin_and_resets_on_progress(self):
        sup = self._sup()
        assert not sup.active and not sup.stalled()
        sup.begin("peer-a")
        self.now = 9.0
        assert not sup.stalled()
        self.now = 10.5
        assert sup.stalled()
        sup.progress()  # advanced: deadline re-arms from now
        assert not sup.stalled()
        self.now = 20.0
        assert not sup.stalled()
        self.now = 21.0
        assert sup.stalled()

    def test_progress_resets_attempt_budget(self):
        sup = self._sup(attempts_max=2)
        sup.begin("a")
        sup.record_stall()
        sup.begin("b")
        sup.record_stall()
        assert sup.exhausted()
        sup.begin("c")
        sup.progress()  # a live sync is not a failing one
        assert not sup.exhausted()
        assert sup.attempts == 0

    def test_backoff_grows_exponentially_jittered_and_capped(self):
        sup = self._sup(
            attempts_max=10, backoff_base_s=1.0, backoff_max_s=4.0
        )
        delays = []
        for _ in range(6):
            sup.begin("x")
            delays.append(sup.record_stall())
        for i, d in enumerate(delays):
            raw = min(4.0, 1.0 * 2**i)
            assert 0.5 * raw <= d <= 1.5 * raw  # jitter band
        # The cap binds from the third stall on (4 <= 2^i).
        assert all(d <= 1.5 * 4.0 for d in delays[2:])

    def test_ready_gates_on_backoff_and_stall_clears_target(self):
        sup = self._sup(backoff_base_s=1.0)
        sup.begin("x")
        delay = sup.record_stall()
        assert sup.target is None and not sup.active
        assert not sup.ready()
        self.now = delay + 0.01
        assert sup.ready()

    def test_backoff_never_overflows_at_huge_attempt_counts(self):
        # The store recovery loop disables exhaustion (attempts_max is
        # effectively infinite) and stalls forever against a dead disk;
        # 2**attempts must not overflow float conversion, and the delay
        # must stay at the cap.
        sup = self._sup(
            attempts_max=1 << 30, backoff_base_s=0.25, backoff_max_s=5.0
        )
        sup.attempts = 5000  # ~7 hours of stalls at the 5 s cap
        sup.begin("disk")
        d = sup.record_stall()
        assert 0.5 * 5.0 <= d <= 1.5 * 5.0

    def test_idle_without_begin_never_stalls(self):
        sup = self._sup()
        self.now = 1e9
        assert not sup.stalled() and not sup.active


class TestSyncStallFailover:
    """The acceptance pair plus the other
    fault families, all mid-IBD against a real victim node."""

    @pytest.mark.slow
    def test_stalling_peer_fails_over_mid_ibd(self):
        """The only initially-serving peer serves one batch then swallows
        every further GETBLOCKS (while dutifully answering PINGs — alive
        by the liveness layer's rules).  A second connected peer never
        triggered a sync (it advertised height 0).  The victim must
        detect the stall within its progress deadline, demote the
        staller WITHOUT banning it, fail over, and complete IBD from the
        second peer.

        SLOW: this exact case migrated onto the network
        simulator (tests/test_netsim.py TestStallFailoverSim) where it
        runs the PRODUCTION 10 s supervision deadlines in milliseconds
        of wall time, deterministically — tier-1 runs that variant; the
        real-socket original stays as a smoke that the seam still
        carries the behavior on actual TCP."""

        async def scenario():
            staller = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(
                    swallow=frozenset({MsgType.GETBLOCKS}),
                    serve_before_fault=1,
                    batch_limit=10,
                ),
            )
            quiet = HostilePeer(_CHAIN30, plan=FaultPlan(hello_height=0))
            await staller.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{staller.port}",
                        f"127.0.0.1:{quiet.port}",
                    ]
                )
            )
            await victim.start()
            try:
                t0 = time.monotonic()
                assert await wait_until(
                    lambda: victim.chain.height == 30, timeout=20
                ), f"IBD pinned at height {victim.chain.height}"
                elapsed = time.monotonic() - t0
                # Failed over and finished in a few deadline multiples,
                # not by some unrelated slow path (wide CI margin).
                assert elapsed < 15.0
                m = victim.metrics
                assert m.sync_stalls >= 1
                assert m.sync_failovers >= 1
                assert m.sync_demotions >= 1
                # The rescue came from the second peer.
                assert quiet.requests[MsgType.GETBLOCKS] >= 1
                # Demoted, never banned: the staller keeps its connection
                # and clean record.
                assert not victim._banned_until and not victim._violations
                assert victim.peer_count() == 2
                demerited = [
                    p
                    for p in victim._peers.values()
                    if p.sync_demerits > 0
                ]
                assert len(demerited) == 1
                # Counters are surfaced, not just internal.
                s = victim.status()["sync"]
                assert s["stalls"] == m.sync_stalls
                assert s["failovers"] == m.sync_failovers
                assert s["demotions"] == m.sync_demotions
            finally:
                await victim.stop()
                await staller.stop()
                await quiet.stop()

        run(scenario())

    def test_honest_slow_peer_is_never_demoted(self):
        """The false-demotion control: a lone peer serving small batches
        with a per-reply delay well inside the deadline.  Every round
        lands blocks, so the progress deadline keeps re-arming — sync
        completes with zero stalls, zero demotions."""

        async def scenario():
            slow = HostilePeer(
                make_blocks(12, DIFF),
                plan=FaultPlan(batch_limit=3, reply_delay_s=0.3),
            )
            await slow.start()
            victim = Node(
                _config(
                    peers=[f"127.0.0.1:{slow.port}"],
                    sync_stall_timeout_s=2.0,
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.chain.height == 12, timeout=20
                )
                m = victim.metrics
                assert m.sync_stalls == 0
                assert m.sync_demotions == 0
                assert m.sync_failovers == 0
                assert all(
                    p.sync_demerits == 0 for p in victim._peers.values()
                )
            finally:
                await victim.stop()
                await slow.stop()

        run(scenario())

    def test_truncated_reply_fails_over_without_misbehavior_score(self):
        """Mid-frame stall: the staller answers GETBLOCKS with HALF a
        frame then wedges.  Byte progress happened (the liveness layer's
        trickle exemption applies) but the chain advances nothing — the
        progress deadline must fire, fail over, and the truncation must
        not be scored as a protocol violation (the FrameReader never
        completed a malformed frame)."""

        async def scenario():
            staller = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(truncate_at=MsgType.GETBLOCKS),
            )
            quiet = HostilePeer(_CHAIN30, plan=FaultPlan(hello_height=0))
            await staller.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{staller.port}",
                        f"127.0.0.1:{quiet.port}",
                    ]
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.chain.height == 30, timeout=20
                )
                assert victim.metrics.sync_failovers >= 1
                assert not victim._violations and not victim._banned_until
            finally:
                await victim.stop()
                await staller.stop()
                await quiet.stop()

        run(scenario())

    def test_dropped_sync_peer_fails_over_without_full_deadline(self):
        """A peer that hangs up the instant it is asked: the supervisor
        sees the target leave the peer set and fails over immediately
        instead of sitting out the whole progress deadline."""

        async def scenario():
            dropper = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(drop_at=MsgType.GETBLOCKS),
            )
            quiet = HostilePeer(_CHAIN30, plan=FaultPlan(hello_height=0))
            await dropper.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{dropper.port}",
                        f"127.0.0.1:{quiet.port}",
                    ],
                    # A long deadline ON PURPOSE: completion inside the
                    # asserted window proves the disconnected-target
                    # fast path, not deadline expiry.
                    sync_stall_timeout_s=30.0,
                )
            )
            await victim.start()
            try:
                t0 = time.monotonic()
                assert await wait_until(
                    lambda: victim.chain.height == 30, timeout=25
                )
                assert time.monotonic() - t0 < 20.0  # << the 30 s deadline
                assert victim.metrics.sync_failovers >= 1
            finally:
                await victim.stop()
                await dropper.stop()
                await quiet.stop()

        run(scenario())

    def test_chatty_useless_replies_read_as_stall(self):
        """Well-formed empty BLOCKS replies below the advertised height
        are the cheapest stall spelling (no silence anywhere).  The
        quiesce path must not mistake them for a completed sync while
        the peer's own advertised height remains unreached."""

        async def scenario():
            staller = HostilePeer(
                _CHAIN30, plan=FaultPlan(empty_replies=True)
            )
            quiet = HostilePeer(_CHAIN30, plan=FaultPlan(hello_height=0))
            await staller.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{staller.port}",
                        f"127.0.0.1:{quiet.port}",
                    ]
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.chain.height == 30, timeout=20
                )
                assert victim.metrics.sync_stalls >= 1
                assert victim.metrics.sync_failovers >= 1
            finally:
                await victim.stop()
                await staller.stop()
                await quiet.stop()

        run(scenario())

    def test_lone_staller_retries_with_bounded_budget(self):
        """No second peer exists: the supervisor retries the sole source
        with backoff and, after the attempt budget, stops chasing — the
        counters prove both the retries and the bound."""

        async def scenario():
            staller = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(swallow=frozenset({MsgType.GETBLOCKS})),
            )
            await staller.start()
            victim = Node(
                _config(
                    peers=[f"127.0.0.1:{staller.port}"],
                    sync_stall_timeout_s=0.3,
                    sync_attempts_max=2,
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.metrics.sync_exhausted >= 1, timeout=20
                )
                assert victim.chain.height == 0  # nothing ever served
                # Retried the lone peer (failovers fired) before giving
                # up within the budget.
                assert 1 <= victim.metrics.sync_failovers <= 4
                assert staller.requests[MsgType.GETBLOCKS] >= 2
                # Still connected, still unbanned: exhaustion parks the
                # episode, it does not punish the peer further.
                assert victim.peer_count() == 1
                assert not victim._banned_until
            finally:
                await victim.stop()
                await staller.stop()

        run(scenario())


class TestCompactFetchSupervision:
    def test_blocktxn_stall_falls_back_to_locator_sync(self):
        """A compact push whose GETBLOCKTXN round is never answered: the
        supervision loop must abandon the reconstruction within the
        deadline, demote the squatter, and recover the block whole via
        locator sync from another peer."""
        alice = account("sf-alice")
        spend = stx(
            "sf-alice", account("sf-bob"), 5, 1, seq=0, difficulty=DIFF
        )
        blocks = make_blocks(
            6, DIFF, miner_id=alice, txs_at={6: (spend,)}
        )

        async def scenario():
            staller = HostilePeer(
                blocks[:-1],  # serves the chain BELOW the compact push
                plan=FaultPlan(
                    swallow=frozenset({MsgType.GETBLOCKTXN}),
                    hello_height=5,
                ),
            )
            full = HostilePeer(blocks, plan=FaultPlan(hello_height=0))
            await staller.start()
            await full.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{staller.port}",
                        f"127.0.0.1:{full.port}",
                    ]
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.chain.height == 5, timeout=20
                )
                # The compact push for the tx-bearing tip block: the
                # victim cannot reconstruct (its pool lacks the spend)
                # and must ask the pusher for the missing transaction.
                await staller.push(protocol.encode_cblock(blocks[-1]))
                assert await wait_until(
                    lambda: victim.chain.height == 6, timeout=20
                ), "block never recovered after the BLOCKTXN stall"
                m = victim.metrics
                assert staller.requests[MsgType.GETBLOCKTXN] >= 1
                assert m.cblock_fetch_stalls >= 1
                assert not victim._pending_cblocks
                assert victim.status()["sync"]["cblock_fetch_stalls"] >= 1
                assert not victim._banned_until
            finally:
                await victim.stop()
                await staller.stop()
                await full.stop()

        run(scenario())


class TestMempoolPageSupervision:
    def test_mempool_page_stall_detected_and_rerouted(self):
        """A peer serving a first mempool page with more=1 and then
        swallowing the continuation: the page deadline must fire, demote
        the staller, and solicit the pool from another connected peer."""
        pool_tx = stx(
            "sf-carol", account("sf-dave"), 3, 1, seq=0, difficulty=DIFF
        )

        async def scenario():
            chain5 = make_blocks(5, DIFF)
            staller = HostilePeer(
                chain5,
                mempool_txs=(pool_tx,),
                plan=FaultPlan(
                    mempool_more=True,
                    swallow=frozenset({MsgType.GETMEMPOOL}),
                    serve_before_fault=1,
                ),
            )
            quiet = HostilePeer(chain5, plan=FaultPlan(hello_height=0))
            await staller.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{staller.port}",
                        f"127.0.0.1:{quiet.port}",
                    ]
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.metrics.mempool_sync_stalls >= 1,
                    timeout=20,
                ), "mempool page stall never detected"
                # Rerouted: the other peer got asked for its pool.
                assert await wait_until(
                    lambda: quiet.requests[MsgType.GETMEMPOOL] >= 1,
                    timeout=10,
                )
                assert victim.status()["sync"]["mempool_stalls"] >= 1
                assert not victim._banned_until
            finally:
                await victim.stop()
                await staller.stop()
                await quiet.stop()

        run(scenario())

    def test_mempool_empty_tail_reads_as_a_stall_not_progress(self):
        """A peer answering every GETMEMPOOL with an EMPTY
        page claiming more=True — each page is well-formed and arrives
        on time, so the in-flight deadline never fires, but the pool
        never advances.  Once this silently ENDED the sync (a
        zero-cost park); it must now demote the chatty-useless peer,
        count a mempool_sync_stalls, and re-solicit from the other
        connected peer — without a ban (nothing was malformed)."""

        async def scenario():
            chain5 = make_blocks(5, DIFF)
            parker = HostilePeer(
                chain5, plan=FaultPlan(mempool_empty_tail=True)
            )
            quiet = HostilePeer(chain5, plan=FaultPlan(hello_height=0))
            await parker.start()
            await quiet.start()
            victim = Node(
                _config(
                    peers=[
                        f"127.0.0.1:{parker.port}",
                        f"127.0.0.1:{quiet.port}",
                    ]
                )
            )
            await victim.start()
            try:
                assert await wait_until(
                    lambda: victim.metrics.mempool_sync_stalls >= 1,
                    timeout=20,
                ), "empty-tail pages never read as a stall"
                assert await wait_until(
                    lambda: quiet.requests[MsgType.GETMEMPOOL] >= 1,
                    timeout=10,
                ), "pool sync never rerouted off the parker"
                assert victim.metrics.sync_demotions >= 1
                assert not victim._banned_until
            finally:
                await victim.stop()
                await parker.stop()
                await quiet.stop()

        run(scenario())


class TestHeadersClientFailover:
    """The same supervisor generalized over the light client's headers
    fetch loop (node/client.py get_headers)."""

    def test_get_headers_fails_over_to_fallback_peer(self):
        from p1_tpu_torch.node.client import get_headers

        async def scenario():
            staller = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(
                    swallow=frozenset({MsgType.GETHEADERS}),
                    serve_before_fault=1,
                    batch_limit=8,
                ),
            )
            honest = HostilePeer(_CHAIN30)
            await staller.start()
            await honest.start()
            try:
                headers = await get_headers(
                    "127.0.0.1",
                    staller.port,
                    DIFF,
                    timeout=30.0,
                    stall_timeout_s=0.5,
                    fallback_peers=[("127.0.0.1", honest.port)],
                )
                assert len(headers) == 31  # genesis + 30, rescued
                # Contiguity survived the mid-fetch peer switch.
                for prev, h in zip(headers, headers[1:]):
                    assert h.prev_hash == prev.block_hash()
                assert honest.requests[MsgType.GETHEADERS] >= 1
            finally:
                await staller.stop()
                await honest.stop()

        run(scenario())

    def test_get_headers_rotates_off_half_open_primary(self):
        """A listen backlog with no process behind it (accepts TCP,
        never answers HELLO): the handshake itself must be a supervised
        round — one stall, rotate to the fallback — not a sink for the
        caller's entire overall timeout.  Found live by a
        verify drive."""
        import socket

        from p1_tpu_torch.node.client import get_headers

        async def scenario():
            half_open = socket.socket()
            half_open.bind(("127.0.0.1", 0))
            half_open.listen(1)  # nobody will ever accept/answer
            honest = HostilePeer(_CHAIN30)
            await honest.start()
            try:
                t0 = time.monotonic()
                headers = await get_headers(
                    "127.0.0.1",
                    half_open.getsockname()[1],
                    DIFF,
                    timeout=30.0,
                    stall_timeout_s=0.5,
                    fallback_peers=[("127.0.0.1", honest.port)],
                )
                assert len(headers) == 31
                assert time.monotonic() - t0 < 10.0  # ~one stall, not 30 s
            finally:
                half_open.close()
                await honest.stop()

        run(scenario())

    def test_get_headers_exhaustion_raises_sync_stalled(self):
        from p1_tpu_torch.node.client import get_headers

        async def scenario():
            staller = HostilePeer(
                _CHAIN30,
                plan=FaultPlan(swallow=frozenset({MsgType.GETHEADERS})),
            )
            await staller.start()
            try:
                with pytest.raises(SyncStalled):
                    await get_headers(
                        "127.0.0.1",
                        staller.port,
                        DIFF,
                        timeout=30.0,
                        stall_timeout_s=0.3,
                        attempts_max=2,
                    )
            finally:
                await staller.stop()

        run(scenario())

    def test_get_headers_still_rejects_protocol_violations(self):
        """Supervision retries stalls, never lies: an unlinked HEADERS
        reply must still raise immediately (no silent failover that
        would let a forging peer be laundered by an honest fallback)."""
        from p1_tpu_torch.core.header import BlockHeader
        from p1_tpu_torch.node.client import get_headers

        class _Forger(HostilePeer):
            def _answer(self, mtype, body):
                if mtype is MsgType.GETHEADERS:
                    bogus = BlockHeader(
                        1, bytes(31) + b"\x77", bytes(32), 999, DIFF, 0
                    )
                    return protocol.encode_headers([bogus])
                return super()._answer(mtype, body)

        async def scenario():
            forger = _Forger(_CHAIN30)
            await forger.start()
            try:
                with pytest.raises(ValueError, match="link"):
                    await get_headers(
                        "127.0.0.1",
                        forger.port,
                        DIFF,
                        timeout=20.0,
                        stall_timeout_s=1.0,
                    )
            finally:
                await forger.stop()

        run(scenario())
