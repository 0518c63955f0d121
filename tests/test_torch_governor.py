"""The port's resource governor against the JAX package's.

Mirrors tests/test_governor.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.

Resource governor: budget primitives, SHED hysteresis, prune safety.

Unit and property tests for node/governor.py plus the node-side prune
invariants the budgets depend on (_addr_budgets/_banned_until bounded
tracking).  The network-level behavior (floods, squat, soak) lives in
tests/test_overload.py.
"""

import asyncio
import random
import time

from torch_testutil import NodeConfig
from p1_tpu_torch.node import Node
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.governor import (
    DEFAULT_RATES,
    DROPS_PER_VIOLATION,
    OverloadState,
    PeerBudget,
    ResourceGovernor,
    TokenBucket,
)
from p1_tpu_torch.node.protocol import MsgType


class _Clock:
    """Injectable monotonic clock."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class TestTokenBucket:
    def test_burst_then_refill(self):
        clock = _Clock()
        b = TokenBucket(rate=2.0, burst=4.0, clock=clock)
        assert all(b.take() for _ in range(4))
        assert not b.take()  # burst spent
        clock.t += 1.0  # 2 tokens refill
        assert b.take() and b.take()
        assert not b.take()

    def test_grant_is_additive_and_capped(self):
        clock = _Clock()
        b = TokenBucket(rate=1.0, burst=4.0, clock=clock)
        b.grant(4.0)
        b.grant(100.0)
        assert b.peek() == 16.0  # grant_cap = 4 * burst

    def test_refill_never_claws_back_grant_credit(self):
        # The ADDR-budget lesson: solicited credit above the
        # burst cap must survive refill observations.
        clock = _Clock()
        b = TokenBucket(rate=1.0, burst=4.0, clock=clock)
        b.grant(8.0)
        clock.t += 100.0
        assert b.peek() == 12.0

    def test_property_randomized_clock_steps(self):
        """Invariants under arbitrary take/grant/step interleavings:
        0 <= tokens <= grant_cap always; tokens <= burst when no grant
        credit is outstanding; a stalled (or repeated-same-time) clock
        refills nothing; take() never goes negative."""
        rng = random.Random(0xB0B)
        for _ in range(200):
            clock = _Clock(rng.uniform(0, 1e6))
            rate = rng.uniform(0.1, 100.0)
            burst = rng.uniform(1.0, 50.0)
            b = TokenBucket(rate=rate, burst=burst, clock=clock)
            granted = False
            for _ in range(100):
                op = rng.randrange(4)
                if op == 0:
                    before = b.peek()
                    got = b.take(rng.uniform(0.1, 3.0))
                    if got:
                        assert b.tokens >= 0.0
                    else:
                        # A refused take spends nothing (same instant).
                        assert b.peek() == before
                elif op == 1:
                    b.grant(rng.uniform(0.0, 30.0))
                    granted = True
                elif op == 2:
                    clock.t += rng.uniform(0.0, 10.0)
                else:
                    pass  # stalled clock: same instant observed again
                tokens = b.peek()
                assert 0.0 <= tokens <= b.grant_cap + 1e-9
                if not granted:
                    assert tokens <= b.burst + 1e-9

    def test_property_refill_accrues_at_rate(self):
        rng = random.Random(7)
        for _ in range(50):
            clock = _Clock()
            rate = rng.uniform(0.5, 20.0)
            burst = 1000.0
            b = TokenBucket(rate=rate, burst=burst, clock=clock)
            assert b.take(burst)  # drain to exactly 0
            total = 0.0
            for _ in range(20):
                dt = rng.uniform(0.0, 5.0)
                clock.t += dt
                total += dt
                expected = min(burst, total * rate)
                assert abs(b.peek() - expected) < 1e-6


class TestPeerBudget:
    def test_violation_every_n_drops(self):
        clock = _Clock()
        budget = PeerBudget(clock=clock)
        burst = DEFAULT_RATES["queries"][1]
        for _ in range(int(burst)):
            assert budget.admit("queries")
        violations = 0
        for i in range(1, 3 * DROPS_PER_VIOLATION + 1):
            assert not budget.admit("queries")
            if budget.owes_violation("queries"):
                violations += 1
                assert i % DROPS_PER_VIOLATION == 0
        assert violations == 3  # one per DROPS_PER_VIOLATION, consumed

    def test_classes_are_independent(self):
        clock = _Clock()
        budget = PeerBudget(clock=clock)
        while budget.admit("blocks"):
            pass
        assert budget.admit("txs") and budget.admit("queries")


class TestGovernorHysteresis:
    def test_shed_and_recover(self):
        g = ResourceGovernor(watermark_bytes=1000, clock=_Clock())
        assert not g.observe(900) and g.state is OverloadState.NORMAL
        assert g.observe(1001) and g.state is OverloadState.SHED
        assert g.sheds == 1
        # Hysteresis: between low (800) and high, SHED holds.
        assert not g.observe(900) and g.state is OverloadState.SHED
        assert g.observe(799) and g.state is OverloadState.NORMAL
        # Peak is remembered across the round trip.
        assert g.tracked_peak_bytes == 1001

    def test_zero_watermark_never_sheds(self):
        g = ResourceGovernor(watermark_bytes=0, clock=_Clock())
        assert not g.observe(1 << 40)
        assert g.state is OverloadState.NORMAL

    def test_admission_disabled_passes_everything(self):
        g = ResourceGovernor(admission=False, clock=_Clock())
        budget = g.budget()
        assert all(g.admit(budget, "blocks") for _ in range(10_000))
        assert g.admission_drops["blocks"] == 0


def _node(**kw) -> Node:
    kw.setdefault("difficulty", 12)
    kw.setdefault("mine", False)
    return Node(NodeConfig(**kw))


class TestBoundedTrackingPrune:
    """The MAX_TRACKED_HOSTS prunes must bound memory WITHOUT evicting
    entries that still carry live state (active bans, in-window
    violation scores, spent-or-granted ADDR budgets) while stale
    entries exist to shed instead."""

    def test_banned_until_prune_keeps_active_bans(self):
        from p1_tpu_torch.node.node import MAX_TRACKED_HOSTS

        node = _node()
        now = time.monotonic()
        active = {f"10.1.{i >> 8}.{i & 255}" for i in range(64)}
        for host in active:
            node._banned_until[host] = now + 1000.0  # far from expiry
        for i in range(MAX_TRACKED_HOSTS + 100):
            node._banned_until[f"10.9.{i >> 8}.{i & 255}"] = now - 1.0  # expired
        # One more violation burst triggers the overflow prune.
        for _ in range(3):
            node._record_violation("10.200.0.1")
        assert len(node._banned_until) <= MAX_TRACKED_HOSTS
        assert active <= set(node._banned_until)  # no active ban evicted

    def test_violations_prune_keeps_in_window_scores(self):
        import collections

        from p1_tpu_torch.node.node import BAN_WINDOW_S, MAX_TRACKED_HOSTS

        node = _node()
        now = time.monotonic()
        active = {f"10.2.{i >> 8}.{i & 255}" for i in range(64)}
        for host in active:
            node._violations[host] = collections.deque([now])
        for i in range(MAX_TRACKED_HOSTS + 100):
            node._violations[f"10.8.{i >> 8}.{i & 255}"] = collections.deque(
                [now - BAN_WINDOW_S - 5.0]
            )
        node._record_violation("10.200.0.2")
        assert len(node._violations) <= MAX_TRACKED_HOSTS + 1
        assert active <= set(node._violations)

    def test_addr_budget_prune_keeps_live_buckets(self):
        """Stale all-default buckets are shed first; buckets carrying
        information — spent tokens mid-window, or solicited grant credit
        above the cap — survive the overflow prune (the
        regression, re-proven against the bounded-tracking path)."""
        from p1_tpu_torch.node.node import ADDR_TOKENS_MAX, MAX_TRACKED_HOSTS

        node = _node()
        now = time.monotonic()
        spent = {}
        for i in range(32):
            host = f"10.3.{i >> 8}.{i & 255}"
            bucket = node._addr_budget(host)
            bucket[0] -= 3.0  # spent budget: live state
            spent[host] = bucket[0]
        node._addr_budget("10.4.0.1")  # create at the base refill...
        granted = node._addr_budget("10.4.0.1", grant=True)  # ...then credit
        assert granted[0] > ADDR_TOKENS_MAX
        stale = now - 10_000.0
        for i in range(MAX_TRACKED_HOSTS + 50):
            node._addr_budgets[f"10.7.{i >> 8}.{i & 255}"] = [
                ADDR_TOKENS_MAX,
                stale,
            ]
        node._addr_budget("10.200.0.3")  # fresh create triggers the prune
        assert len(node._addr_budgets) <= MAX_TRACKED_HOSTS + 1
        for host, tokens in spent.items():
            assert node._addr_budgets[host][0] == tokens
        assert node._addr_budgets["10.4.0.1"][0] > ADDR_TOKENS_MAX


class TestStatusWire:
    def test_getstatus_status_roundtrip(self):
        raw = protocol.encode_getstatus()
        mtype, body = protocol.decode(raw)
        assert mtype is MsgType.GETSTATUS and body is None
        status = {"height": 7, "overload": {"state": "normal", "sheds": 0}}
        mtype, decoded = protocol.decode(protocol.encode_status(status))
        assert mtype is MsgType.STATUS and decoded == status

    def test_malformed_status_is_a_protocol_error(self):
        import pytest

        with pytest.raises(protocol.ProtocolError):
            protocol.decode(bytes([MsgType.STATUS]) + b"\xff\xfe not json")
        with pytest.raises(protocol.ProtocolError):
            protocol.decode(bytes([MsgType.STATUS]) + b"[1, 2]")
        with pytest.raises(protocol.ProtocolError):
            protocol.decode(bytes([MsgType.GETSTATUS]) + b"x")

    def test_live_status_query_carries_overload_block(self):
        from p1_tpu_torch.node.client import get_status

        async def scenario():
            node = _node()
            await node.start()
            try:
                status = await get_status(
                    "127.0.0.1", node.port, 12, timeout=10
                )
                assert status["height"] == 0
                overload = status["overload"]
                assert overload["state"] == "normal"
                assert overload["admission_dropped"] == {
                    "blocks": 0,
                    "txs": 0,
                    "queries": 0,
                }
                assert overload["resident_body_bytes"] == 0
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestShedIntegration:
    def test_shed_pauses_mining_and_recovers(self):
        """End-to-end hysteresis on a live node: pool bytes push the
        gauge over a tiny watermark -> SHED (mining paused, tx gossip
        dropped); expiring the pool drains the gauge -> NORMAL."""
        from torch_testutil import account, stx

        async def scenario():
            node = _node(mem_watermark_bytes=1 << 30, chunk=1 << 12)
            await node.start()
            try:
                # Fund alice so a real signed spend passes admission.
                node.miner_id = account("alice")
                node.start_mining()
                while node.chain.height < 1:
                    await asyncio.sleep(0.01)
                await node.stop_mining()
                tx = stx("alice", account("bob"), 1, 1, 0, difficulty=12)
                # Warm the verify-once cache BEFORE taking the baseline:
                # admission will record the signature there, and the
                # cache term is part of the gauge but does not
                # drain with the pool — pre-warming keeps it inside g0
                # so the watermark round trip below stays about pool
                # bytes only.
                tx.verify_signature(cache=node.sig_cache)
                # Pin the watermark between the quiescent gauge and the
                # gauge with the pending spend: admission pushes it over,
                # expiry brings it back under the low mark — a real
                # round trip, independent of exact object sizes.
                g0 = node._memory_gauge()
                tx_len = len(tx.serialize())
                node.governor.watermark_bytes = g0 + tx_len // 2
                node.governor.low_watermark_bytes = g0 + tx_len // 4
                assert node.mempool.add(tx)
                assert node.mempool.bytes_pending > 0
                for _ in range(100):
                    if node.governor.shedding:
                        break
                    await asyncio.sleep(0.1)
                assert node.governor.shedding
                assert node.status()["overload"]["state"] == "shed"
                assert node.status()["overload"]["mining_paused"]
                # Pressure gone: the pool expires, hysteresis recovers.
                node.mempool.expire(0.0)
                for _ in range(100):
                    if not node.governor.shedding:
                        break
                    await asyncio.sleep(0.1)
                assert not node.governor.shedding
                assert node.governor.sheds == 1
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class _Writer:
    """The one StreamWriter call a detached ``_Peer`` makes."""

    def get_extra_info(self, name):
        return ("127.0.0.1", 1) if name == "peername" else None


def _pusher(clock) -> "_Peer":
    from p1_tpu_torch.node.node import _Peer

    peer = _Peer(_Writer(), "127.0.0.1:1")
    peer.budget = PeerBudget(clock=clock)
    return peer


class TestRelayRace:
    """The blocks budget against duplicate pushes (node.py
    ``RELAY_RACE_BLOCKS``): the reference's budget, a relay race's first
    duplicate of a recent block refunded, a replay flood cut at the
    reference's rate.  Each push is charged as the frame dispatch charges
    it, then handed to the node."""

    @staticmethod
    def _push(node, peer, block, compact=False):
        if not node.governor.admit(peer.budget, "blocks"):
            return False
        if compact:
            _, cb = protocol.decode(protocol.encode_cblock(block))
            asyncio.run(node._handle_cblock(cb, peer))
        else:
            asyncio.run(node._handle_block(block, origin=peer))
        return True

    def test_budget_is_the_reference_budget(self):
        from p1_tpu.node.governor import DEFAULT_RATES as REF_RATES

        assert DEFAULT_RATES == REF_RATES

    def test_honest_relay_race_is_never_charged(self):
        # 1,100 blocks, each pushed first by its relayer (new: refunded)
        # then by two racing peers (duplicates), with no refill at all:
        # unrefunded, the racers would run 76 frames past the 1,024
        # burst — a violation each.
        from p1_tpu_torch.node.testing import make_blocks

        clock = _Clock()
        node = _node(difficulty=1)
        first, racer, compact_racer = (_pusher(clock) for _ in range(3))
        for block in make_blocks(1100, 1)[1:]:
            assert self._push(node, first, block)
            assert self._push(node, racer, block)
            assert self._push(node, compact_racer, block, compact=True)
        assert node.chain.height == 1100
        burst = DEFAULT_RATES["blocks"][1]
        for peer in (first, racer, compact_racer):
            assert peer.budget.buckets["blocks"].peek() == burst

    def test_replay_flood_is_cut_at_the_reference_rate(self):
        # One recent block replayed 10,000 times a second for 3 s: its
        # first push is a relay race (refunded), every repeat is charged,
        # so the drops are the reference budget's to within that frame.
        from p1_tpu.node.governor import DEFAULT_RATES as REF_RATES
        from p1_tpu_torch.node.testing import make_blocks

        (genesis, block) = make_blocks(1, 1)
        clock, ref_clock = _Clock(), _Clock()
        node = _node(difficulty=1)
        asyncio.run(node._handle_block(block))
        flooder = _pusher(clock)
        ref = PeerBudget(rates=REF_RATES, clock=ref_clock)
        drops = ref_drops = violations = 0
        for i in range(30_000):
            clock.t = ref_clock.t = i / 10_000
            drops += not self._push(node, flooder, block, compact=i % 2 == 1)
            violations += flooder.budget.owes_violation("blocks")
            ref_drops += not ref.admit("blocks")
        assert ref_drops - drops == 1
        assert violations >= 3  # BAN_SCORE_THRESHOLD: the flooder is banned

    def test_old_duplicate_stays_charged(self):
        # A duplicate of a block connected RELAY_RACE_BLOCKS connects ago
        # is no relay race: charged, like every duplicate in the
        # reference.
        from p1_tpu_torch.node.node import RELAY_RACE_BLOCKS
        from p1_tpu_torch.node.testing import make_blocks

        clock = _Clock()
        node = _node(difficulty=1)
        blocks = make_blocks(RELAY_RACE_BLOCKS + 1, 1)[1:]
        for block in blocks:
            asyncio.run(node._handle_block(block))
        peer = _pusher(clock)
        bucket = peer.budget.buckets["blocks"]
        burst = DEFAULT_RATES["blocks"][1]
        assert self._push(node, peer, blocks[-1])  # recent: refunded
        assert bucket.peek() == burst
        assert self._push(node, peer, blocks[0])  # aged out: charged
        assert bucket.peek() == burst - 1
        assert self._push(node, peer, blocks[-1])  # a repeat: charged
        assert bucket.peek() == burst - 2
