"""The port's difficulty retargeting: the rule math, genesis commitment,
contextual chain enforcement, persistence, and a live retargeting node.

Mirrors tests/test_retarget.py against ``p1_tpu_torch`` (its native
replay class is mirrored in tests/test_torch_native_replay.py).  Blocks
are sealed by the hashlib backend (``get_backend("cpu", device="cpu")``)
and nodes run on the host (``torch_testutil.NodeConfig``).

Fixed difficulty (retarget=None) is the default everywhere and its
behavior is pinned by the rest of the suite; these tests cover the opt-in
rule — including that a chain with a different rule is a *different
chain* (distinct genesis), which is what keeps mixed networks impossible
rather than merely erroring late.  ``TestCrossPackage`` holds the port's
difficulty sequences, retargeting genesis blocks and mined header chains
byte-equal to the JAX package's.
"""

import asyncio
import random

import pytest

from p1_tpu_torch.chain import AddStatus, Chain, ChainStore
from p1_tpu_torch.core import (
    Block,
    BlockHeader,
    RetargetRule,
    Transaction,
    make_genesis,
    merkle_root,
)
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner

DIFF = 8
RULE = RetargetRule(window=4, spacing=100)
_MINER = Miner(backend=get_backend("cpu", device="cpu"))


def _child(parent: Block, difficulty: int, ts: int, txs=()) -> Block:
    header = BlockHeader(
        version=1,
        prev_hash=parent.block_hash(),
        merkle_root=merkle_root([tx.txid() for tx in txs]),
        timestamp=ts,
        difficulty=difficulty,
        nonce=0,
    )
    sealed = _MINER.search_nonce(header)
    assert sealed is not None
    return Block(sealed, tuple(txs))


def _extend(chain: Chain, n: int, dt: int) -> None:
    """Mine ``n`` blocks on the tip with ``dt`` seconds between blocks,
    always at the difficulty consensus asks for."""
    for _ in range(n):
        tip = chain.tip
        block = _child(
            tip, chain.next_difficulty(), tip.header.timestamp + dt
        )
        res = chain.add_block(block)
        assert res.status is AddStatus.ACCEPTED, res.reason


class TestRuleMath:
    def test_in_band_span_keeps_difficulty(self):
        # expected span = 100 * 3 = 300
        assert RULE.adjusted(10, 300) == 10
        assert RULE.adjusted(10, 151) == 10  # just above half
        assert RULE.adjusted(10, 599) == 10  # just below double

    def test_fast_blocks_raise_difficulty_bitwise(self):
        assert RULE.adjusted(10, 150) == 11  # span <= expected/2
        assert RULE.adjusted(10, 75) == 12  # span <= expected/4
        assert RULE.adjusted(10, 1) == 12  # clamped at max_adjust=2

    def test_slow_blocks_lower_difficulty_bitwise(self):
        assert RULE.adjusted(10, 600) == 9  # span >= 2x
        assert RULE.adjusted(10, 1200) == 8  # span >= 4x
        assert RULE.adjusted(10, 10_000_000) == 8  # clamped

    def test_range_clamps(self):
        assert RULE.adjusted(1, 10_000_000) == 1  # never below 1
        assert RULE.adjusted(255, 1) == 255  # never above 255
        assert RULE.adjusted(2, 10_000_000) == 1

    def test_parameter_validation(self):
        with pytest.raises(ValueError):
            RetargetRule(window=1, spacing=10)
        with pytest.raises(ValueError):
            RetargetRule(window=4, spacing=0)
        with pytest.raises(ValueError):
            RetargetRule(window=4, spacing=10, max_adjust=0)


class TestClampUnderStepShocks:
    """Round-17 satellite: the unit-level pin the retarget-shock
    scenario's mesh assertion rests on — ``adjusted`` at exact clamp
    boundaries, and the clamp holding through sustained step-shock
    span sequences (every per-window move ≤ max_adjust, convergence to
    the new equilibrium, no runaway in either direction)."""

    def test_exact_upward_boundaries(self):
        # expected span = 300; the rule moves a bit at span*2^k <= 300.
        assert RULE.adjusted(10, 151) == 10  # one over the 1-bit edge
        assert RULE.adjusted(10, 150) == 11  # exactly ON the edge
        assert RULE.adjusted(10, 76) == 11  # one over the 2-bit edge
        assert RULE.adjusted(10, 75) == 12  # exactly ON it
        # Past the max_adjust=2 clamp: 3-bit-deserving spans still get 2.
        assert RULE.adjusted(10, 37) == 12
        assert RULE.adjusted(10, 1) == 12

    def test_exact_downward_boundaries(self):
        assert RULE.adjusted(10, 599) == 10  # one under the 2x edge
        assert RULE.adjusted(10, 600) == 9  # exactly ON it
        assert RULE.adjusted(10, 1199) == 9
        assert RULE.adjusted(10, 1200) == 8  # exactly ON the 4x edge
        # 8x, 16x, ... still clamp to -2.
        assert RULE.adjusted(10, 2400) == 8
        assert RULE.adjusted(10, 1 << 40) == 8

    def test_degenerate_span_floors_at_one_second(self):
        # span <= 0 must not divide-by-zero or sign-flip the rule.
        assert RULE.adjusted(10, 0) == 12
        assert RULE.adjusted(10, -5) == 12

    @staticmethod
    def _drive(rule, d0, hashrate_by_window):
        """Pure-function mesh model: each window's observed span is
        what a steady ``h``-multiple hashrate produces at the window's
        difficulty (span = expected * 2^(d - d0) / h), fed back
        through ``adjusted`` — the scenario's dynamics without the
        mesh."""
        series = [d0]
        for h in hashrate_by_window:
            d = series[-1]
            span = max(1, round(rule.expected_span * (2.0 ** (d - d0)) / h))
            series.append(rule.adjusted(d, span))
        return series

    def test_step_up_shock_converges_within_clamp(self):
        rule = RetargetRule(window=8, spacing=8)  # max_adjust=2
        series = self._drive(rule, 10, [8] * 6)
        # Every per-window move inside the clamp.
        assert all(
            abs(b - a) <= rule.max_adjust
            for a, b in zip(series, series[1:])
        )
        # Converged to the +3-bit equilibrium, no overshoot past it.
        assert series[-1] == 13
        assert max(series) == 13

    def test_step_down_shock_converges_within_clamp(self):
        rule = RetargetRule(window=8, spacing=8)
        series = self._drive(rule, 10, [1 / 8] * 6)
        assert all(
            abs(b - a) <= rule.max_adjust
            for a, b in zip(series, series[1:])
        )
        assert series[-1] == 7 and min(series) == 7

    def test_square_wave_never_escapes_the_band(self):
        # Alternating 8x shocks up and down, many cycles: difficulty
        # must stay within max_adjust of the two equilibria forever —
        # bounded oscillation, not resonance.
        rule = RetargetRule(window=8, spacing=8)
        wave = ([8] * 4 + [1] * 4) * 6
        series = self._drive(rule, 10, wave)
        assert all(
            abs(b - a) <= rule.max_adjust
            for a, b in zip(series, series[1:])
        )
        assert max(series) <= 13 + rule.max_adjust
        assert min(series) >= 10 - rule.max_adjust

    def test_clamp_holds_at_the_difficulty_range_edges(self):
        rule = RetargetRule(window=8, spacing=8)
        # A sustained crash in hashrate walks down 2 bits per window
        # and parks at 1 — never 0 (every hash would be valid).
        series = self._drive(rule, 4, [1 / 1024] * 8)
        assert series[-1] == 1 and min(series) == 1
        # And a sustained boom parks at 255.
        series = self._drive(rule, 252, [1 << 20] * 8)
        assert series[-1] == 255 and max(series) == 255


class TestGenesisCommitment:
    def test_rule_changes_chain_identity(self):
        plain = make_genesis(DIFF)
        ruled = make_genesis(DIFF, RULE)
        other = make_genesis(DIFF, RetargetRule(window=8, spacing=100))
        assert plain.block_hash() != ruled.block_hash()
        assert ruled.block_hash() != other.block_hash()
        # Same parameters -> same chain, deterministically.
        assert ruled.block_hash() == make_genesis(DIFF, RULE).block_hash()

    def test_fixed_difficulty_genesis_unchanged(self):
        # retarget=None must keep every existing chain id stable.
        from p1_tpu_torch.core.block import EMPTY_MERKLE_ROOT

        assert make_genesis(DIFF).header.merkle_root == EMPTY_MERKLE_ROOT


class TestChainEnforcement:
    def test_difficulty_steps_up_at_boundary(self):
        chain = Chain(DIFF, retarget=RULE)
        # Blocks 1..3 at base difficulty; block 4 opens a window.  One
        # second between blocks => span 3 vs expected 300 => +2 bits.
        _extend(chain, 3, dt=1)
        assert chain.next_difficulty() == DIFF + 2
        _extend(chain, 1, dt=1)
        assert chain.tip.header.difficulty == DIFF + 2
        # Mid-window: difficulty sticks to the parent's.
        assert chain.next_difficulty() == DIFF + 2

    def test_difficulty_steps_down_when_slow(self):
        chain = Chain(DIFF + 2, retarget=RULE)
        # span 1200 >= 4x expected (300); dt sits exactly at the
        # per-block forward cap of max_step * spacing = 400 s.
        _extend(chain, 3, dt=400)
        assert chain.next_difficulty() == DIFF

    def test_wrong_difficulty_rejected_contextually(self):
        chain = Chain(DIFF, retarget=RULE)
        _extend(chain, 3, dt=1)
        # Height 4 must carry DIFF+2; a miner claiming DIFF is rejected
        # even though DIFF is the chain's base difficulty.
        tip = chain.tip
        lazy = _child(tip, DIFF, tip.header.timestamp + 1)
        res = chain.add_block(lazy)
        assert res.status is AddStatus.REJECTED
        assert "required" in res.reason

    def test_non_monotonic_timestamp_rejected(self):
        chain = Chain(DIFF, retarget=RULE)
        _extend(chain, 1, dt=5)
        tip = chain.tip
        stale = _child(tip, chain.next_difficulty(), tip.header.timestamp)
        res = chain.add_block(stale)
        assert res.status is AddStatus.REJECTED
        assert "timestamp" in res.reason
        # Fixed-difficulty chains keep their historical tolerance.
        fixed = Chain(DIFF)
        b = _child(fixed.tip, DIFF, fixed.tip.header.timestamp)
        assert fixed.add_block(b).status is AddStatus.ACCEPTED

    def test_work_weighted_fork_choice_across_difficulties(self):
        # After a retarget to DIFF+2, one new-window block (4x work)
        # outweighs two more blocks mined on a stale pre-boundary parent.
        chain = Chain(DIFF, retarget=RULE)
        _extend(chain, 3, dt=1)
        fork_parent = chain.tip  # height 3
        heavy = _child(
            fork_parent, chain.next_difficulty(), fork_parent.header.timestamp + 1
        )
        # Stale branch: same parent, still mid-window difficulties...
        # there is no such thing — height 4 REQUIRES DIFF+2 on every
        # branch (pure function of ancestors).  So build the competing
        # branch from height 2 instead: its height-3 block is mid-window.
        h2 = chain.get(fork_parent.header.prev_hash)
        side3 = _child(h2, DIFF, h2.header.timestamp + 2)
        assert chain.add_block(side3).status is AddStatus.ACCEPTED
        side4 = _child(side3, DIFF + 2, side3.header.timestamp + 1)
        assert chain.add_block(side4).status is AddStatus.ACCEPTED
        res = chain.add_block(heavy)
        assert res.status is AddStatus.ACCEPTED
        # heavy (via fork_parent) and side4 tie on work; the hash
        # tie-break decides — what matters is that BOTH height-4 blocks
        # were forced to DIFF+2 and the index weighed them equally.
        assert chain.height == 4
        assert chain.tip.header.difficulty == DIFF + 2

    def test_difficulty_zero_orphan_rejected(self):
        # On a retargeting chain orphan parking checks PoW at the CLAIMED
        # difficulty; difficulty 0 passes that check vacuously, so it must
        # be refused outright — a free frame must not churn the pool.
        chain = Chain(DIFF, retarget=RULE)
        free = _child(
            make_genesis(99), 0, 1_800_000_000
        )  # unknown parent, d=0
        res = chain.add_block(free)
        assert res.status is AddStatus.REJECTED
        assert "no work" in res.reason

    def test_replay_host_verifies_retargeting_chains(self):
        import dataclasses

        from p1_tpu_torch.chain import generate_headers, replay_host

        fast = RetargetRule(window=4, spacing=100)
        headers = generate_headers(13, DIFF, backend=get_backend("cpu", device="cpu"), retarget=fast)
        # +1s spacing vs 100s target: +2 bits at heights 4, 8, 12.
        assert headers[12].difficulty == DIFF + 6
        assert replay_host(headers, retarget=fast).valid
        # The fixed-difficulty check would (wrongly for this chain) fail —
        # which is why `p1 replay` refuses non-host engines with a rule.
        assert replay_host(headers).first_invalid == 4
        # A header claiming the wrong difficulty is caught at its index...
        forged = list(headers)
        forged[9] = dataclasses.replace(headers[9], difficulty=DIFF)
        assert replay_host(forged, retarget=fast).first_invalid == 9
        # ...and so is a non-increasing timestamp.
        stale = list(headers)
        stale[9] = dataclasses.replace(
            headers[9], timestamp=headers[8].timestamp
        )
        assert replay_host(stale, retarget=fast).first_invalid == 9

    def test_store_round_trip_preserves_rule_chain(self):
        import tempfile
        from pathlib import Path

        chain = Chain(DIFF, retarget=RULE)
        _extend(chain, 6, dt=1)  # crosses one boundary
        assert chain.tip.header.difficulty == DIFF + 2
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "chain.dat"
            store = ChainStore(path)
            for block in list(chain.main_chain())[1:]:
                store.append(block)
            store.close()
            loaded = ChainStore(path).load_chain(DIFF, retarget=RULE)
            assert loaded.tip_hash == chain.tip_hash
            assert loaded.next_difficulty() == chain.next_difficulty()
            # Without the rule the records are another chain's: nothing
            # connects, and load_chain refuses rather than silently
            # yielding an empty chain (the guard `p1 compact` relies on —
            # it would otherwise rewrite the store as a genesis-only
            # snapshot of the wrong chain).
            with pytest.raises(ValueError, match="do not connect"):
                ChainStore(path).load_chain(DIFF)


class TestRetargetProperty:
    """Randomized DAG property test (extends TestForkChoiceProperty to
    moving difficulty): for ANY block DAG obeying the retarget rule,
    delivered in ANY order, every node converges to the same tip, that
    tip is the brute-force max-cumulative-work block (2^difficulty per
    block — no longer equivalent to height!), and rule-violating blocks
    (wrong difficulty, frozen timestamps) never connect anywhere."""

    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_random_dag_with_rule_converges(self, seed):
        import random as rnd

        rng = rnd.Random(seed)
        rule = RetargetRule(window=3, spacing=5, max_adjust=1)
        base = 2
        genesis = make_genesis(base, rule)
        ghash = genesis.block_hash()
        parents = {}
        heights = {ghash: 0}
        diffs = {ghash: base}
        stamps = {ghash: genesis.header.timestamp}
        works = {ghash: 1 << base}
        blocks = {ghash: genesis}

        def required(parent_hash: bytes) -> int:
            h = heights[parent_hash] + 1
            if h % rule.window != 0:
                return diffs[parent_hash]
            anchor = parent_hash
            for _ in range(rule.window - 1):
                anchor = parents[anchor]
            span = stamps[parent_hash] - stamps[anchor]
            return rule.adjusted(diffs[parent_hash], span)

        valid = []
        invalid = []
        for i in range(40):
            parent = rng.choice(list(blocks))
            d = required(parent)
            # Offsets straddle the 5 s target so the walk moves BOTH ways
            # (window span 2..24 vs expected 10: ±1 bit boundaries).
            ts = stamps[parent] + rng.randint(1, 12)
            tx = Transaction("coinbase", f"m{seed}", 50, 0, i)
            child = _child(blocks[parent], d, ts, txs=(tx,))
            ch = child.block_hash()
            parents[ch] = parent
            heights[ch] = heights[parent] + 1
            diffs[ch] = d
            stamps[ch] = ts
            works[ch] = works[parent] + (1 << d)
            blocks[ch] = child
            valid.append(child)
            if i % 9 == 0 and d >= 2:
                # A sibling claiming the WRONG difficulty (one bit easy —
                # only meaningful above the floor, where d-1 != d)...
                invalid.append(
                    _child(blocks[parent], d - 1, ts + 1, txs=(tx,))
                )
            if i % 13 == 0:
                # ...and one freezing its parent's timestamp.
                invalid.append(
                    _child(blocks[parent], d, stamps[parent], txs=(tx,))
                )

        best_work = max(works.values())
        expect_tip = min(
            h for h, w in works.items() if w == best_work
        )
        bad_hashes = {b.block_hash() for b in invalid}

        tips = set()
        for trial in range(3):
            order = valid + invalid
            rng.shuffle(order)
            chain = Chain(base, genesis=genesis, retarget=rule)
            for block in order:
                chain.add_block(block)
            # Every valid block connected; no invalid one ever did.
            assert len(chain) == 1 + len(valid)
            assert not any(h in chain for h in bad_hashes)
            # The tip is the brute-force most-work block, and the chain's
            # own next-difficulty agrees with an independent recomputation.
            tips.add(chain.tip_hash)
            assert chain.next_difficulty() == required(chain.tip_hash)
        assert tips == {expect_tip}


class TestRetargetingNode:
    def test_live_node_climbs_difficulty_and_serves_wallet(self):
        from test_torch_node import _config, wait_until

        from p1_tpu_torch.node import Node
        from p1_tpu_torch.node.client import get_account

        # ms blocks but 50 s/block target => +2 bits every 5-block window.
        rule_kw = dict(retarget_window=5, target_spacing=50)

        async def scenario():
            node = Node(_config(difficulty=10, mine=True, **rule_kw))
            await node.start()
            try:
                assert await wait_until(lambda: node.chain.height >= 12)
                blocks = list(node.chain.main_chain())
                # Window 1 (heights 1-4) mines at the base difficulty; its
                # observed span includes the fixed-2025 genesis timestamp
                # vs. wall clock — enormous — so height 5 deterministically
                # retargets DOWN by the clamp (10 -> 8).  Exactly Bitcoin's
                # first-retarget-after-genesis behavior.
                assert [b.header.difficulty for b in blocks[1:6]] == [
                    10, 10, 10, 10, 8,
                ]
                # Every later block carries precisely what the rule asks
                # of its parent (re-derived from scratch here).
                probe = Chain(10, retarget=RetargetRule(window=5, spacing=50))
                for b in blocks[1:]:
                    assert b.header.difficulty == probe.next_difficulty()
                    assert probe.add_block(b).status is AddStatus.ACCEPTED
                # The wallet path agrees on the chain identity.
                state = await get_account(
                    "127.0.0.1",
                    node.port,
                    node.miner_id,
                    10,
                    retarget=RetargetRule(window=5, spacing=50),
                )
                assert state.balance > 0
                # ...and a fixed-difficulty client is refused outright.
                with pytest.raises(ValueError, match="genesis mismatch"):
                    await get_account(
                        "127.0.0.1", node.port, node.miner_id, 10
                    )
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_two_retargeting_nodes_converge(self):
        from test_torch_node import _config, stop_all, wait_until

        from p1_tpu_torch.node import Node

        rule_kw = dict(retarget_window=5, target_spacing=50)

        async def scenario():
            a = Node(_config(difficulty=10, mine=True, **rule_kw))
            await a.start()
            b = Node(
                _config(
                    difficulty=10,
                    mine=True,
                    peers=(f"127.0.0.1:{a.port}",),
                    **rule_kw,
                )
            )
            await b.start()
            try:
                assert await wait_until(
                    lambda: a.chain.height >= 11 and b.chain.height >= 11
                )
                for node in (a, b):
                    await node.stop_mining()
                await a.request_sync()
                await b.request_sync()
                assert await wait_until(
                    lambda: a.chain.tip_hash == b.chain.tip_hash
                )
                blocks = list(a.chain.main_chain())
                # Both nodes enforced the genesis-gap retarget at height 5
                # (see the single-node test) while converging under it.
                assert blocks[5].header.difficulty == 8
            finally:
                await stop_all((a, b))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_spv_proof_across_a_retarget_boundary(self):
        # A tx confirmed AFTER a difficulty move must still SPV-verify
        # when the verifier knows the chain retargets (the work bar is
        # the header's claimed difficulty), and must fail the strict
        # fixed-difficulty check — never the other way around.
        from p1_tpu_torch.chain import SPVError, verify_tx_proof

        chain = Chain(DIFF, retarget=RULE)
        cb = None
        for _ in range(5):
            tip = chain.tip
            cb = Transaction.coinbase("miner", chain.height + 1)
            block = _child(
                tip,
                chain.next_difficulty(),
                tip.header.timestamp + 1,
                txs=(cb,),
            )
            assert chain.add_block(block).status is AddStatus.ACCEPTED
        assert chain.tip.header.difficulty == DIFF + 2  # boundary crossed
        proof = chain.tx_proof(cb.txid())
        assert proof is not None
        tag = chain.genesis.block_hash()
        verify_tx_proof(proof, DIFF, tag, retarget=RULE)
        with pytest.raises(SPVError, match="difficulty"):
            verify_tx_proof(proof, DIFF, tag)  # fixed-chain strictness

    def test_coinbase_txs_survive_retarget_boundaries(self):
        # The ledger/conservation machinery must be unaffected by moving
        # difficulty: coinbases at several difficulties, exact sum.
        from p1_tpu_torch.core.tx import BLOCK_REWARD

        chain = Chain(DIFF, retarget=RULE)
        for i in range(9):
            tip = chain.tip
            cb = Transaction.coinbase("miner", chain.height + 1)
            block = _child(
                tip,
                chain.next_difficulty(),
                tip.header.timestamp + 1,
                txs=(cb,),
            )
            assert chain.add_block(block).status is AddStatus.ACCEPTED
        assert sum(chain.balances_snapshot().values()) == 9 * BLOCK_REWARD


class TestForwardDatingBound:
    """The time-warp hardening (VERDICT r4 weak #2): consensus caps the
    per-block timestamp increment at max_step * spacing, so forward-dated
    time must be accumulated block by block instead of claimed in one
    inflated window-closing stamp."""

    def test_height_one_anchors_clock_freely(self):
        """Genesis carries a fixed 2025 timestamp (chain identity), so
        block 1 must be allowed an arbitrary forward jump — it anchors
        the chain clock at the real bootstrap time.  Capped, the clock
        could never catch wall time and difficulty would ratchet to 1
        (observed live before the exemption)."""
        chain = Chain(DIFF, retarget=RULE)
        tip = chain.tip
        year_ahead = tip.header.timestamp + 365 * 86_400
        anchor = _child(tip, chain.next_difficulty(), year_ahead)
        assert chain.add_block(anchor).status is AddStatus.ACCEPTED

    def test_increment_above_cap_rejected_from_height_two(self):
        chain = Chain(DIFF, retarget=RULE)
        _extend(chain, 1, dt=1)  # height 1: the exempt clock anchor
        tip = chain.tip
        cap = RULE.max_increment  # max_step * spacing
        over = _child(tip, chain.next_difficulty(), tip.header.timestamp + cap + 1)
        res = chain.add_block(over)
        assert res.status is AddStatus.REJECTED and "cap" in res.reason
        at_cap = _child(tip, chain.next_difficulty(), tip.header.timestamp + cap)
        assert chain.add_block(at_cap).status is AddStatus.ACCEPTED

    def test_assemble_clamps_to_cap(self, monkeypatch):
        from torch_testutil import NodeConfig
        from p1_tpu_torch.node import Node

        node = Node(
            NodeConfig(
                difficulty=DIFF,
                mine=False,
                retarget_window=RULE.window,
                target_spacing=RULE.spacing,
            )
        )
        class _Clock:
            """The node reads wall time ONLY through its clock seam
            (node/transport.py) — a runaway local clock is one field."""

            wall_now = 0.0

            def wall(self):
                return self.wall_now

            monotonic = wall

        clock = _Clock()
        monkeypatch.setattr(node, "clock", clock)
        # Height 1 (tip = genesis): the assembler must NOT clamp — it is
        # the bootstrap anchor that brings the chain clock to wall time.
        far = node.chain.tip.header.timestamp + 10 * RULE.max_increment
        clock.wall_now = far
        anchor = node._assemble()
        assert anchor.header.timestamp == far
        # From height 2 on, a runaway local clock is clamped to the cap.
        _extend(node.chain, 1, dt=1)
        tip_ts = node.chain.tip.header.timestamp
        clock.wall_now = tip_ts + 10 * RULE.max_increment
        block = node._assemble()
        assert block.header.timestamp == tip_ts + RULE.max_increment

    @staticmethod
    def _simulate(alpha: float, capped: bool, windows: int, seed: int,
                  rule: RetargetRule, d0: int) -> list[int]:
        """Difficulty trajectory of a chain under a lone forward-dating
        miner owning fraction ``alpha`` of the hashrate.

        Real block times are exponential with mean spacing * 2^(d - d0)
        (d0 = the difficulty matching the network's real hashrate).
        Honest miners stamp real time clamped into consensus bounds;
        the attacker always stamps the maximum the rules allow —
        parent + cap when capped, enough for a full max_adjust drop at a
        window close when not.  Uses the SAME RetargetRule.adjusted as
        consensus, so the simulation measures the deployed rule.
        """
        rng = random.Random(seed)
        cap = rule.max_increment
        d = d0
        chain_ts = 0.0  # last block's claimed time
        real = 0.0
        out = []
        for _ in range(windows):
            anchor = chain_ts
            for blk in range(rule.window):
                real += rng.expovariate(1.0) * rule.spacing * 2.0 ** (d - d0)
                if rng.random() < alpha:
                    if capped:
                        chain_ts = chain_ts + cap
                    else:
                        # One stamp buys the whole span needed for the
                        # maximum drop (plus slack) — the uncapped abuse.
                        want = anchor + (2 ** rule.max_adjust + 1) * rule.expected_span
                        chain_ts = max(chain_ts + 1, want)
                else:
                    honest = max(chain_ts + 1, real)
                    if capped:
                        honest = min(honest, chain_ts + cap)
                    chain_ts = honest
            span = int(chain_ts - anchor)
            d = rule.adjusted(d, span)
            out.append(d)
        return out

    def test_lone_attacker_bounded_with_cap_collapses_without(self):
        """The documented claims of core/retarget.py, measured: under
        the default cap (max_step=4) a quarter-hashrate forward-dating
        miner cannot hold difficulty below the honest equilibrium, while
        the SAME attacker — even at 10% — with the cap removed ratchets
        the chain to difficulty 1."""
        rule = RetargetRule(window=16, spacing=100)
        d0 = 20
        windows = 400
        for seed in (7, 23):
            # Honest baseline: equilibrium held within one bit.
            honest = self._simulate(0.0, True, windows, seed, rule, d0)
            assert min(honest) >= d0 - 1 and max(honest) <= d0 + 1
            # 25% attacker, capped: time-average within one bit of d0,
            # sustained excursions below d0 - max_adjust essentially
            # absent (random-walk dips only, <= 5% of windows).
            capped = self._simulate(0.25, True, windows, seed, rule, d0)
            assert sum(capped) / len(capped) >= d0 - 1
            below = sum(1 for d in capped if d < d0 - rule.max_adjust)
            assert below / len(capped) <= 0.05
            # 10% attacker, uncapped: total collapse — the attack the
            # cap exists to stop.
            uncapped = self._simulate(0.10, False, windows, seed, rule, d0)
            assert min(uncapped) == 1
            assert sum(uncapped) / len(uncapped) <= 5

    def test_near_majority_attacker_is_the_documented_limit(self):
        """The honest residual, asserted so the docs can't overclaim: a
        ~45% forward-dating miner DOES grind a capped chain down over
        many windows (per-window rate still clamped to max_adjust).
        That is the fundamental limit of wall-clock-free timestamping —
        at near-majority hashrate the chain is reorg-attackable anyway."""
        rule = RetargetRule(window=16, spacing=100)
        d0 = 20
        traj = self._simulate(0.45, True, 400, 11, rule, d0)
        drops = [b - a for a, b in zip(traj, traj[1:])]
        assert min(drops) >= -rule.max_adjust  # rate clamp holds
        assert sum(traj) / len(traj) < d0 - rule.max_adjust  # but it sinks

    def test_replay_host_enforces_forward_cap(self):
        """The light-client verifier applies the same forward-dating cap
        as connect-time consensus — a forward-dated header file must not
        verify for SPV/headers-first clients either."""
        from p1_tpu_torch.chain import replay_host

        g = make_genesis(DIFF, RULE)
        b1 = _child(g, DIFF, g.header.timestamp + 1)
        good = _child(b1, DIFF, b1.header.timestamp + RULE.max_increment)
        bad = _child(b1, DIFF, b1.header.timestamp + RULE.max_increment + 1)
        assert replay_host(
            [g.header, b1.header, good.header], retarget=RULE
        ).valid
        report = replay_host(
            [g.header, b1.header, bad.header], retarget=RULE
        )
        assert not report.valid and report.first_invalid == 2

    def test_hostile_bootstrap_anchor_gets_orphaned_by_policy(self):
        """The height-1 exemption means a hostile first miner CAN stamp
        the far future (consensus accepts it) — the defense is mining
        POLICY: honest miners refuse to extend a tip stamped past their
        wall clock + cap, build from the last sane ancestor, and
        out-work the poisoned suffix."""
        import time as _time

        from torch_testutil import NodeConfig
        from p1_tpu_torch.node import Node

        node = Node(
            NodeConfig(
                difficulty=DIFF,
                mine=False,
                retarget_window=RULE.window,
                target_spacing=RULE.spacing,
            )
        )
        g = node.chain.tip
        hostile = _child(
            g,
            node.chain.next_difficulty(),
            # ~70 years ahead: far past any wall clock, within the
            # header's u32 timestamp range.
            g.header.timestamp + 70 * 365 * 86_400,
        )
        assert node.chain.add_block(hostile).status is AddStatus.ACCEPTED
        assert node.chain.tip_hash == hostile.block_hash()
        # Policy: the assembler walks back to genesis, not the poison.
        parent = node._mining_parent()
        assert parent.block_hash() == g.block_hash()
        candidate = node._assemble()
        assert candidate.header.prev_hash == g.block_hash()
        # Its stamp is the real bootstrap anchor (height 1: no cap).
        assert abs(candidate.header.timestamp - int(_time.time())) < 5
        # Seal honest blocks on the sane branch until it out-works the
        # hostile one and the chain reorgs away from the poison.
        for _ in range(2):
            candidate = node._assemble()
            sealed = _MINER.search_nonce(candidate.header)
            assert sealed is not None
            res = node.chain.add_block(Block(sealed, candidate.txs))
            assert res.status is AddStatus.ACCEPTED, res.reason
        assert node.chain.tip_hash != hostile.block_hash()
        assert node.chain.tip.header.timestamp < hostile.header.timestamp
        assert node.chain.height == 2  # the honest branch won


class TestCrossPackage:
    """The rule is consensus: both packages must compute the same
    difficulty for every span, commit to the same genesis, and mine the
    same header bytes under it."""

    def test_adjusted_equals_the_references(self):
        from p1_tpu.core import RetargetRule as RefRule

        for window, spacing, max_adjust in ((4, 100, 2), (3, 5, 1), (8, 8, 2), (16, 100, 3)):
            rule = RetargetRule(window=window, spacing=spacing, max_adjust=max_adjust)
            ref = RefRule(window=window, spacing=spacing, max_adjust=max_adjust)
            assert rule.expected_span == ref.expected_span
            assert rule.max_increment == ref.max_increment
            for d in (1, 2, 10, 128, 254, 255):
                for span in (-5, 0, 1, 37, 75, 150, 151, 300, 599, 600, 1200, 1 << 40):
                    assert rule.adjusted(d, span) == ref.adjusted(d, span), (window, d, span)

    def test_retargeting_genesis_equals_the_references(self):
        from p1_tpu.core import RetargetRule as RefRule
        from p1_tpu.core import make_genesis as ref_genesis

        for window, spacing in ((4, 100), (5, 50), (8, 100)):
            ours = make_genesis(DIFF, RetargetRule(window=window, spacing=spacing))
            ref = ref_genesis(DIFF, RefRule(window=window, spacing=spacing))
            assert ours.serialize() == ref.serialize()

    def test_difficulty_sequence_and_header_bytes_equal_the_references(self):
        from p1_tpu.chain import generate_headers as ref_generate
        from p1_tpu.chain import replay_host as ref_replay
        from p1_tpu.core import RetargetRule as RefRule
        from p1_tpu.hashx import get_backend as ref_backend
        from p1_tpu_torch.chain import generate_headers, replay_host

        fast, ref_fast = RetargetRule(window=4, spacing=100), RefRule(window=4, spacing=100)
        ours = generate_headers(17, DIFF, backend=get_backend("cpu", device="cpu"), retarget=fast)
        ref = ref_generate(17, DIFF, backend=ref_backend("cpu"), retarget=ref_fast)
        assert [h.difficulty for h in ours] == [h.difficulty for h in ref]
        assert [h.serialize() for h in ours] == [h.serialize() for h in ref]
        assert replay_host(ours, retarget=fast).valid and ref_replay(ref, retarget=ref_fast).valid

    def test_chain_next_difficulty_follows_the_references(self):
        from p1_tpu.chain import AddStatus as RefStatus
        from p1_tpu.chain import Chain as RefChain
        from p1_tpu.core import Block as RefBlock
        from p1_tpu.core import RetargetRule as RefRule

        ours = Chain(DIFF, retarget=RULE)
        ref = RefChain(DIFF, retarget=RefRule(window=RULE.window, spacing=RULE.spacing))
        seq = []
        for dt in (1, 1, 1, 1, 1, 1, 400, 400, 400, 400, 50, 50, 50, 50):
            assert ours.next_difficulty() == ref.next_difficulty()
            _extend(ours, 1, dt=dt)
            assert ref.add_block(RefBlock.deserialize(ours.tip.serialize())).status is RefStatus.ACCEPTED
            seq.append(ours.tip.header.difficulty)
        assert ours.tip_hash == ref.tip_hash
        assert len(set(seq)) > 1  # the sequence moved both ways
