"""The port's p2p node (``p1_tpu_torch.node``) against the JAX package's.

Mirrors tests/test_node.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
``TestMixedMesh`` runs one node of each package in one loop: they mine and
relay blocks and transfers to each other and end on one tip, ledger and
mempool.  ``TestPortDevice`` holds the port's device seams: the ``cuda``
backend's plain version mining, the signature rung's pin, the refusal
without a card, and the verify-workers knob.

P2P node: handshake, gossip, sync, convergence, faults, restart.

In-process asyncio harness: each test spins real Nodes on ephemeral
localhost ports (the standard localhost form of the reference's 4-peer
distributed config, BASELINE.json:10) and polls for convergence with a
deadline.  Difficulty 12 keeps cpu mining at a few ms/block.
"""

import asyncio
import time

import pytest

from torch_testutil import account, stx

from torch_testutil import NodeConfig
from p1_tpu_torch.core import Transaction
from p1_tpu_torch.node import Node

DIFF = 12
CHUNK = 1 << 14  # fine-grained abort so stop() never waits long


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


async def fund(node, label: str, blocks: int = 1) -> None:
    """Mine ``blocks`` block rewards to ``label``'s account on ``node``.

    Consensus rejects overdraws and the pool mirrors the rule, so tests
    that spend must first earn — exactly like a real participant.
    """
    old_id = node.miner_id
    node.miner_id = account(label)
    target = node.chain.height + blocks
    node.start_mining()
    assert await wait_until(lambda: node.chain.height >= target)
    await node.stop_mining()
    node.miner_id = old_id


async def wait_until(cond, timeout=20.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


def _config(peers=(), **kw) -> NodeConfig:
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("mine", False)
    return NodeConfig(peers=tuple(peers), **kw)


async def start_mesh(n: int, **kw) -> list[Node]:
    """n nodes, each dialing all earlier ones (full mesh)."""
    nodes: list[Node] = []
    for _ in range(n):
        peers = [f"127.0.0.1:{node.port}" for node in nodes]
        node = Node(_config(peers=peers, **kw))
        await node.start()
        nodes.append(node)
    return nodes


async def stop_all(nodes) -> None:
    for node in nodes:
        await node.stop()


class TestHandshake:
    def test_two_nodes_connect(self):
        async def scenario():
            nodes = await start_mesh(2)
            try:
                assert await wait_until(
                    lambda: all(n.peer_count() >= 1 for n in nodes)
                )
            finally:
                await stop_all(nodes)

        run(scenario())

    def test_genesis_mismatch_rejected(self):
        async def scenario():
            a = Node(_config(difficulty=12))
            await a.start()
            b = Node(_config(difficulty=13, peers=[f"127.0.0.1:{a.port}"]))
            await b.start()
            try:
                await asyncio.sleep(0.3)
                assert a.peer_count() == 0
                assert b.peer_count() == 0
            finally:
                await stop_all([a, b])

        run(scenario())


class TestGossip:
    def test_tx_propagates_transitively(self):
        async def scenario():
            # Chain topology a <- b <- c: a tx injected at a must reach c.
            a = Node(_config())
            await a.start()
            b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
            await b.start()
            c = Node(_config(peers=[f"127.0.0.1:{b.port}"]))
            await c.start()
            try:
                assert await wait_until(
                    lambda: a.peer_count() and c.peer_count()
                )
                # Earn before spending: every pool checks affordability
                # against its own tip, so the funding block must reach c.
                await fund(a, "alice")
                assert await wait_until(lambda: c.chain.height >= 1)
                tx = stx("alice", "bob", 5, 1, 0, difficulty=DIFF)
                await a.submit_tx(tx)
                assert await wait_until(lambda: tx.txid() in c.mempool)
                assert tx.txid() in b.mempool
            finally:
                await stop_all([a, b, c])

        run(scenario())

    def test_mined_blocks_propagate(self):
        async def scenario():
            nodes = await start_mesh(2)
            miner_node = nodes[0]
            try:
                assert await wait_until(lambda: miner_node.peer_count())
                await fund(miner_node, "alice")
                assert await wait_until(lambda: nodes[1].chain.height >= 1)
                tx = stx("alice", "bob", 5, 1, 0, difficulty=DIFF)
                await nodes[1].submit_tx(tx)
                assert await wait_until(
                    lambda: tx.txid() in miner_node.mempool
                )
                miner_node.start_mining()  # mine exactly on node 0
                # The real success condition: the tx gets mined out of the
                # pool (an absolute height target would race fund()'s
                # overshoot — stop_mining can land before the tx's block).
                assert await wait_until(
                    lambda: tx.txid() not in miner_node.mempool
                )
                await miner_node.stop_mining()
                assert await wait_until(
                    lambda: nodes[1].chain.tip_hash == miner_node.chain.tip_hash
                )
                assert nodes[1].chain.height >= 3
                # block acceptance at the peer evicted it there too
                assert tx.txid() not in nodes[1].mempool
                # Propagation timing: the receiving node
                # measured send->accept delay for the pushed blocks.
                prop = nodes[1].metrics.propagation_summary()
                assert prop["samples"] >= 1
                assert prop["median_ms"] is not None and prop["median_ms"] >= 0
                assert nodes[1].status()["propagation"] == prop
            finally:
                await stop_all(nodes)

        run(scenario())


class TestTxClient:
    def test_submit_propagates_and_mines(self):
        from p1_tpu_torch.node.client import send_tx

        async def scenario():
            nodes = await start_mesh(2)
            try:
                assert await wait_until(lambda: nodes[1].peer_count())
                await fund(nodes[0], "alice")
                assert await wait_until(lambda: nodes[1].chain.height >= 1)
                tx = stx("alice", "bob", 7, 1, 0, difficulty=DIFF)
                height = await send_tx(
                    "127.0.0.1", nodes[0].port, tx, DIFF
                )
                assert height == nodes[0].chain.height
                # reaches the directly-connected node AND its peer
                assert await wait_until(lambda: tx.txid() in nodes[0].mempool)
                assert await wait_until(lambda: tx.txid() in nodes[1].mempool)
                # ... and ends up in a mined block
                nodes[1].start_mining()
                assert await wait_until(
                    lambda: tx.txid() not in nodes[1].mempool
                )
                await nodes[1].stop_mining()
                mined = [
                    b
                    for b in nodes[1].chain.main_chain()
                    if any(t.txid() == tx.txid() for t in b.txs)
                ]
                assert mined, "submitted tx never mined"
            finally:
                await stop_all(nodes)

        run(scenario())

    def test_wrong_chain_rejected(self):
        from p1_tpu_torch.node.client import send_tx

        async def scenario():
            a = Node(_config())
            await a.start()
            try:
                tx = stx("alice", "bob", 7, 1, 0, difficulty=DIFF)
                with pytest.raises(ValueError, match="genesis mismatch"):
                    await send_tx("127.0.0.1", a.port, tx, DIFF + 1)
                assert tx.txid() not in a.mempool
            finally:
                await a.stop()

        run(scenario())


class TestAccountQuery:
    def test_get_account_reflects_chain_and_pool(self):
        from p1_tpu_torch.node.client import get_account

        async def scenario():
            a = Node(_config())
            await a.start()
            try:
                await fund(a, "alice")
                funded = a.chain.balance(account("alice"))
                state = await get_account(
                    "127.0.0.1", a.port, account("alice"), DIFF
                )
                assert state.balance == funded
                assert state.nonce == 0 and state.next_seq == 0
                # A pending spend advances next_seq but not the nonce.
                await a.submit_tx(stx("alice", "bob", 5, 1, 0, difficulty=DIFF))
                state = await get_account(
                    "127.0.0.1", a.port, account("alice"), DIFF
                )
                assert state.nonce == 0 and state.next_seq == 1
                # Unknown accounts answer zeros, not errors.
                state = await get_account("127.0.0.1", a.port, "nobody", DIFF)
                assert state.balance == 0 and state.next_seq == 0
                # A stray GAPPED pending tx (pinned far-future seq) must
                # not poison auto-seq: next_seq advances contiguously, so
                # the next wallet tx fills the gap instead of extending it.
                await a.submit_tx(
                    stx("alice", "bob", 1, 1, 9, difficulty=DIFF)
                )
                state = await get_account(
                    "127.0.0.1", a.port, account("alice"), DIFF
                )
                assert state.next_seq == 1  # not 10
            finally:
                await a.stop()

        run(scenario())


class TestPeerCap:
    def test_inbound_refused_past_limit(self, monkeypatch):
        from p1_tpu_torch.node import node as node_mod

        monkeypatch.setattr(node_mod, "MAX_PEERS", 1)

        async def scenario():
            hub = Node(_config())
            await hub.start()
            a = Node(_config(peers=[f"127.0.0.1:{hub.port}"]))
            await a.start()
            b = Node(_config(peers=[f"127.0.0.1:{hub.port}"]))
            await b.start()
            try:
                assert await wait_until(lambda: hub.peer_count() == 1)
                await asyncio.sleep(0.5)  # give b's dial loop time to retry
                assert hub.peer_count() == 1  # second connection refused
            finally:
                await stop_all([hub, a, b])

        run(scenario())


class TestMinerIdentity:
    def test_unpeered_miners_diverge(self):
        """The fork experiment, inverted: two *unconnected* nodes must
        mine different chains (each block carries the miner's coinbase, so
        candidates differ from height 1 on).  Before coinbases every node
        assembled bit-identical blocks and 'convergence' was degenerate."""

        async def scenario():
            a = Node(_config(mine=True))
            b = Node(_config(mine=True))
            await a.start()
            await b.start()
            try:
                assert await wait_until(
                    lambda: a.chain.height >= 3 and b.chain.height >= 3
                )
                await a.stop_mining()
                await b.stop_mining()
                a_hashes = [blk.block_hash() for blk in a.chain.main_chain()]
                b_hashes = [blk.block_hash() for blk in b.chain.main_chain()]
                # Same genesis, nothing else in common.
                assert a_hashes[0] == b_hashes[0]
                overlap = set(a_hashes[1:4]) & set(b_hashes[1:4])
                assert not overlap, f"identical blocks mined: {overlap}"
            finally:
                await stop_all([a, b])

        run(scenario())

    def test_fork_resolves_with_reorg(self):
        """Deterministic network-level reorg: A mines a short private chain,
        B a longer one; when A first hears of B's chain it must abandon its
        own branch (metrics.reorgs goes up) and adopt B's tip."""

        async def scenario():
            a = Node(_config(mine=True, miner_id="alice"))
            b = Node(_config(mine=True, miner_id="bob"))
            await a.start()
            await b.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 2)
                await a.stop_mining()
                height_a = a.chain.height
                assert await wait_until(lambda: b.chain.height >= height_a + 2)
                await b.stop_mining()
                assert a.chain.tip_hash != b.chain.tip_hash
                # Now connect them: a dials b and syncs.
                c = Node(
                    _config(peers=[f"127.0.0.1:{b.port}"]), miner=a.miner
                )
                c.chain = a.chain  # adopt A's private chain wholesale
                await c.start()
                try:
                    assert await wait_until(
                        lambda: c.chain.tip_hash == b.chain.tip_hash
                    )
                    assert c.metrics.reorgs >= 1, "fork resolved without a reorg"
                finally:
                    await c.stop()
            finally:
                await stop_all([a, b])

        run(scenario())


class TestConvergence:
    def test_four_miners_converge(self):
        async def scenario():
            nodes = await start_mesh(4, mine=True)
            try:
                assert await wait_until(
                    lambda: min(n.chain.height for n in nodes) >= 3
                )
                for node in nodes:
                    await node.stop_mining()
                assert await wait_until(
                    lambda: len({n.chain.tip_hash for n in nodes}) == 1,
                    timeout=10,
                ), {n.port: (n.chain.height, n.chain.tip_hash.hex()[:8]) for n in nodes}
                heights = {n.chain.height for n in nodes}
                assert len(heights) == 1 and heights.pop() >= 3
            finally:
                await stop_all(nodes)

        run(scenario())

    def test_late_joiner_learns_large_mempool_in_pages(self, monkeypatch):
        from p1_tpu_torch.node import node as node_mod

        monkeypatch.setattr(node_mod, "MEMPOOL_SYNC_TXS", 3)

        async def scenario():
            a = Node(_config())
            await a.start()
            try:
                await fund(a, "alice", blocks=2)  # 8 txs cost 76 > one reward
                txs = [
                    stx("alice", "bob", 5, f + 1, f, difficulty=DIFF) for f in range(8)
                ]
                for tx in txs:
                    await a.submit_tx(tx)
                b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
                await b.start()
                try:
                    # 8 txs at 3 per page: continuation must deliver ALL.
                    assert await wait_until(
                        lambda: all(tx.txid() in b.mempool for tx in txs)
                    )
                finally:
                    await b.stop()
            finally:
                await a.stop()

        run(scenario())

    def test_late_joiner_learns_mempool(self):
        async def scenario():
            a = Node(_config())
            await a.start()
            try:
                await fund(a, "alice")
                txs = [stx("alice", "bob", 5, f, 0 + f, difficulty=DIFF) for f in (1, 2, 3)]
                for tx in txs:
                    await a.submit_tx(tx)
                # b joins AFTER the txs exist; block sync alone would leave
                # its pool empty.
                b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
                await b.start()
                try:
                    assert await wait_until(
                        lambda: all(tx.txid() in b.mempool for tx in txs)
                    )
                finally:
                    await b.stop()
            finally:
                await a.stop()

        run(scenario())

    def test_late_joiner_syncs(self):
        async def scenario():
            a = Node(_config(mine=True))
            await a.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 5)
                await a.stop_mining()
                b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
                await b.start()
                try:
                    assert await wait_until(
                        lambda: b.chain.tip_hash == a.chain.tip_hash
                    )
                    assert b.chain.height == a.chain.height
                finally:
                    await b.stop()
            finally:
                await a.stop()

        run(scenario())

    def test_deep_sync_spans_many_batches(self):
        """A late joiner pulling a chain much longer than SYNC_BATCH (500)
        must iterate the GETBLOCKS/BLOCKS continuation until caught up —
        exercising the height-indexed blocks_after serving path at depth."""

        async def scenario():
            from p1_tpu_torch.chain import Chain
            from p1_tpu_torch.core import Block, BlockHeader, Transaction, merkle_root
            from p1_tpu_torch.hashx import get_backend
            from p1_tpu_torch.miner import Miner

            diff = 2  # ~4 hashes/block: 1200 blocks stay fast
            miner = Miner(backend=get_backend("cpu"))
            chain = Chain(diff)
            tip = chain.genesis
            for height in range(1, 1201):
                tx = Transaction.coinbase("deep", height)
                header = BlockHeader(
                    1,
                    tip.block_hash(),
                    merkle_root([tx.txid()]),
                    tip.header.timestamp + 1,
                    diff,
                    0,
                )
                sealed = miner.search_nonce(header)
                assert sealed is not None
                block = Block(sealed, (tx,))
                assert chain.add_block(block).tip_changed
                tip = block

            a = Node(_config(difficulty=diff))
            a.chain = chain
            await a.start()
            b = Node(_config(difficulty=diff, peers=[f"127.0.0.1:{a.port}"]))
            await b.start()
            try:
                assert await wait_until(
                    lambda: b.chain.height == 1200, timeout=40
                ), b.chain.height
                assert b.chain.tip_hash == a.chain.tip_hash
            finally:
                await stop_all([a, b])

        run(scenario())

    def test_peer_death_and_recovery(self):
        async def scenario():
            nodes = await start_mesh(3, mine=True)
            victim = nodes[2]
            try:
                assert await wait_until(
                    lambda: min(n.chain.height for n in nodes) >= 2
                )
                await victim.stop()  # kill one peer mid-mine
                survivors = nodes[:2]
                h = max(n.chain.height for n in survivors)
                assert await wait_until(
                    lambda: min(n.chain.height for n in survivors) >= h + 2
                )
                for node in survivors:
                    await node.stop_mining()
                assert await wait_until(
                    lambda: len({n.chain.tip_hash for n in survivors}) == 1
                )
            finally:
                await stop_all(nodes[:2])

        run(scenario())


class TestRestart:
    def test_restart_resumes_and_catches_up(self, tmp_path):
        async def scenario():
            store = tmp_path / "node_a.dat"
            a = Node(_config(mine=True, store_path=str(store)))
            await a.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 3)
            finally:
                await a.stop()
            saved_height, saved_tip = a.chain.height, a.chain.tip_hash

            # Restart from the store: chain state must come back.
            a2 = Node(_config(store_path=str(store)))
            await a2.start()
            try:
                assert a2.chain.height == saved_height
                assert a2.chain.tip_hash == saved_tip
            finally:
                await a2.stop()

        run(scenario())


class TestRestartGuards:
    def test_restart_with_wrong_difficulty_refused(self, tmp_path):
        async def scenario():
            store = tmp_path / "node.dat"
            a = Node(_config(mine=True, store_path=str(store)))
            await a.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 1)
            finally:
                await a.stop()
            # Same store, different chain parameters: must refuse loudly
            # instead of silently interleaving two chains in one log.
            b = Node(_config(difficulty=DIFF + 1, store_path=str(store)))
            with pytest.raises(RuntimeError, match="difficulty"):
                await b.start()
            await b.stop()  # cleanup of whatever start() opened

        run(scenario())

    def test_second_node_same_store_refused(self, tmp_path):
        async def scenario():
            store = tmp_path / "shared.dat"
            a = Node(_config(mine=True, store_path=str(store)))
            await a.start()
            try:
                assert await wait_until(lambda: a.chain.height >= 1)
                b = Node(_config(store_path=str(store)))
                with pytest.raises(RuntimeError, match="locked"):
                    await b.start()
                await b.stop()
            finally:
                await a.stop()

        run(scenario())


class TestMempoolUnit:
    def test_fee_priority_and_dedup(self):
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        cheap = stx("a", "b", 1, 1, 0, difficulty=DIFF)
        rich = stx("c", "d", 1, 9, 0, difficulty=DIFF)
        assert pool.add(cheap) and pool.add(rich)
        assert not pool.add(cheap)  # dedup
        assert pool.select() == [rich, cheap]

    def test_replace_by_fee_on_same_slot(self):
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        cheap = stx("alice", "bob", 5, 1, 7, difficulty=DIFF)
        rich = stx("alice", "carol", 5, 3, 7, difficulty=DIFF)  # same (sender, seq)
        equal = stx("alice", "dave", 5, 3, 7, difficulty=DIFF)
        assert pool.add(cheap)
        assert pool.add(rich)  # outbids -> replaces
        assert cheap.txid() not in pool and rich.txid() in pool
        assert not pool.add(equal)  # must STRICTLY outbid
        assert not pool.add(cheap)  # replay of an outbid tx
        assert len(pool) == 1
        # independent slots coexist
        assert pool.add(stx("alice", "bob", 5, 1, 8, difficulty=DIFF))
        assert len(pool) == 2

    def test_expire_drops_only_stale_and_reopens_state(self):
        import time

        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        old = stx("alice", "bob", 5, 1, 0, difficulty=DIFF)
        fresh = stx("carol", "bob", 5, 1, 0, difficulty=DIFF)
        assert pool.add(old)
        assert pool.add(fresh)
        # Backdate `old` past the TTL; `fresh` stays current.
        pool._admitted_at[old.txid()] -= 100.0
        assert pool.expire(10.0) == 1
        assert old.txid() not in pool and fresh.txid() in pool
        assert len(pool) == 1
        # Every index released: the slot reopens (a rebroadcast with the
        # SAME fee re-enters — no RBF bar from a ghost incumbent), the
        # debit is gone, and the sync pager no longer serves it.
        assert pool.add(old)
        page, _ = pool.sync_page(None, 10)
        assert old.txid() in {t.txid() for t in page}
        assert pool.expire(10.0, now=time.monotonic() + 20) == 2
        assert len(pool) == 0 and pool._pending_debit == {}
        assert pool.sync_page(None, 10) == ([], False)

    def test_confirmation_evicts_slot_rivals(self):
        from p1_tpu_torch.core.block import Block, merkle_root
        from p1_tpu_torch.core.header import BlockHeader
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        confirmed = stx("alice", "bob", 5, 1, 7, difficulty=DIFF)
        rival = stx("alice", "carol", 5, 9, 7, difficulty=DIFF)
        assert pool.add(rival)
        # A block confirms the OTHER spend of slot (alice, 7): the pending
        # rival is now a replay and must leave the pool with it.
        header = BlockHeader(
            1, bytes(32), merkle_root([confirmed.txid()]), 1, DIFF, 0
        )
        pool.apply_block_delta((), (Block(header, (confirmed,)),))
        assert rival.txid() not in pool and len(pool) == 0

    def test_sync_page_key_cursor_survives_churn(self):
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        txs = [stx("alice", "bob", 5, 10 - f, f, difficulty=DIFF) for f in range(8)]
        for tx in txs:
            assert pool.add(tx)
        page1, more = pool.sync_page(None, 3)
        assert more and len(page1) == 3
        got = {t.txid() for t in page1}
        # Churn between pages: evict two high-fee txs already delivered.
        for tx in page1[:2]:
            pool._evict(tx)
        last = page1[-1]
        page2, more2 = pool.sync_page((last.fee, last.txid()), 100)
        got |= {t.txid() for t in page2}
        assert not more2
        # A positional cursor would have skipped entries after the
        # eviction shifted ranks; the key cursor delivers every tx.
        assert got == {t.txid() for t in txs}

    def test_rbf_bypasses_full_pool_capacity(self):
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool(max_txs=1)
        assert pool.add(stx("alice", "bob", 5, 1, 7, difficulty=DIFF))
        # Same slot, higher fee: replacement frees the incumbent's
        # capacity, so it is admitted even though the pool is full...
        assert pool.add(stx("alice", "carol", 5, 2, 7, difficulty=DIFF))
        # ...while a NEW slot is refused for capacity.
        assert not pool.add(stx("dave", "erin", 5, 9, 0, difficulty=DIFF))
        assert len(pool) == 1

    def test_confirmed_slot_refuses_late_replay(self):
        from p1_tpu_torch.core.block import Block, merkle_root
        from p1_tpu_torch.core.header import BlockHeader
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        confirmed = stx("alice", "bob", 5, 1, 7, difficulty=DIFF)
        header = BlockHeader(
            1, bytes(32), merkle_root([confirmed.txid()]), 1, DIFF, 0
        )
        block = Block(header, (confirmed,))
        pool.apply_block_delta((), (block,))
        # A spend of the confirmed slot arriving AFTER confirmation (gossip
        # reorder) is refused, whatever its fee.
        late = stx("alice", "mallory", 5, 99, 7, difficulty=DIFF)
        assert not pool.add(late)
        # ... until a reorg rolls the confirmation back.
        pool.apply_block_delta((block,), ())
        assert confirmed.txid() in pool

    def test_full_paged_sync_scales(self, monkeypatch):
        """A late joiner paging a 100k-tx pool must not
        pay O(n) per page.  Signature verification is patched out (the
        pager's complexity is under test, not Ed25519 throughput — 100k
        real signs would dominate the clock and hide a pager regression);
        churn-correctness of the key cursor is covered separately above."""
        import time as time_mod

        from p1_tpu_torch.mempool import Mempool, mempool as mempool_mod

        monkeypatch.setattr(
            mempool_mod.Transaction,
            "verify_signature",
            lambda self, cache=None: True,
        )
        pool = Mempool(max_txs=200_000)
        t0 = time_mod.perf_counter()
        for i in range(100_000):
            assert pool.add(Transaction("s", "r", 1, i % 1000, i))
        build_s = time_mod.perf_counter() - t0
        assert len(pool) == 100_000
        # Full paged sync, 2000/page (the node's MEMPOOL_SYNC_TXS).
        t0 = time_mod.perf_counter()
        cursor, got, more = None, 0, True
        while more:
            page, more = pool.sync_page(cursor, 2000)
            got += len(page)
            last = page[-1]
            cursor = (last.fee, last.txid())
        sync_s = time_mod.perf_counter() - t0
        assert got == 100_000
        # The old filter-everything pager took ~2 min for this loop on
        # this box; the indexed one is sub-second with huge margin even
        # under CI contention.
        assert sync_s < 20, f"paged sync took {sync_s:.1f}s (built in {build_s:.1f}s)"

    def test_coinbase_never_enters_pool(self):
        from p1_tpu_torch.core.block import Block, merkle_root
        from p1_tpu_torch.core.header import BlockHeader
        from p1_tpu_torch.mempool import Mempool

        pool = Mempool()
        cb = Transaction.coinbase("miner-a", 7)
        assert not pool.add(cb)  # gossiped coinbase refused
        # reorg resurrection drops the abandoned branch's reward too
        header = BlockHeader(1, bytes(32), merkle_root([cb.txid()]), 1, DIFF, 0)
        pool.apply_block_delta((Block(header, (cb,)),), ())
        assert cb.txid() not in pool

    def test_block_delta_and_resurrection(self):
        from p1_tpu_torch.core import Block, BlockHeader, merkle_root
        from p1_tpu_torch.mempool import Mempool

        def block_with(txs):
            header = BlockHeader(
                1, bytes(32), merkle_root([t.txid() for t in txs]), 1, DIFF, 0
            )
            return Block(header, tuple(txs))

        pool = Mempool()
        t1 = stx("a", "b", 1, 1, 0, difficulty=DIFF)
        t2 = stx("c", "d", 2, 2, 0, difficulty=DIFF)
        pool.add(t1)
        pool.add(t2)
        pool.apply_block_delta((), (block_with([t1]),))
        assert t1.txid() not in pool and t2.txid() in pool
        # reorg abandons the t1 block: t1 comes back
        pool.apply_block_delta((block_with([t1]),), (block_with([t2]),))
        assert t1.txid() in pool and t2.txid() not in pool


class TestLostTaskObservation:
    """The lost-task audit fix: fire-and-forget session tasks
    (dials, sync failovers) ride ``_sessions`` + ``_untrack_session``;
    a task dying with an exception must be OBSERVED — logged and
    counted in ``metrics.task_crashes`` — not stranded in the GC's
    "exception was never retrieved" limbo (the
    dead-recovery-loop failure shape the lost-task lint rule pins)."""

    def test_session_task_crash_is_logged_and_counted(self, caplog):
        import logging

        holder = {}

        async def scenario():
            node = Node(_config())
            await node.start()
            holder["node"] = node
            try:

                async def boom():
                    raise RuntimeError("session bug")

                task = asyncio.get_running_loop().create_task(boom())
                node._sessions[task] = None
                task.add_done_callback(node._untrack_session)
                assert await wait_until(
                    lambda: node.metrics.task_crashes == 1
                )
                assert task not in node._sessions
            finally:
                await node.stop()

        with caplog.at_level(logging.ERROR, logger="p1_tpu_torch.node"):
            run(scenario())
        assert holder["node"].metrics.task_crashes == 1
        assert any(
            "died" in rec.getMessage() for rec in caplog.records
        ), [rec.getMessage() for rec in caplog.records]

    def test_cancelled_session_task_is_not_a_crash(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                task = asyncio.get_running_loop().create_task(
                    asyncio.sleep(30)
                )
                node._sessions[task] = None
                task.add_done_callback(node._untrack_session)
                task.cancel()
                assert await wait_until(lambda: task not in node._sessions)
                assert node.metrics.task_crashes == 0
            finally:
                await node.stop()

        run(scenario())


class TestMixedMesh:
    """One JAX-package ``Node`` and one port ``Node`` in one asyncio loop:
    they handshake, mine and relay blocks and signed transfers to each
    other, and end on one tip, one ledger and one mempool."""

    def test_reference_and_port_nodes_converge(self):
        from p1_tpu.config import NodeConfig as RefConfig
        from p1_tpu.node import Node as RefNode
        from p1_tpu.node.client import send_tx as ref_send_tx
        from p1_tpu_torch.node.client import send_tx
        from txutil import stx as ref_stx

        def same_tip(a, b):
            return a.chain.tip_hash == b.chain.tip_hash

        async def scenario():
            ref = RefNode(RefConfig(difficulty=DIFF, chunk=CHUNK, mine=False))
            await ref.start()
            port = Node(_config(peers=[f"127.0.0.1:{ref.port}"]))
            await port.start()
            try:
                assert await wait_until(lambda: ref.peer_count() and port.peer_count())
                # Each side mines in turn and the other accepts its blocks.
                await fund(ref, "alice", blocks=2)
                assert await wait_until(lambda: same_tip(ref, port))
                await fund(port, "bob", blocks=2)
                assert await wait_until(lambda: same_tip(ref, port))
                # Transfers enter at either end and relay to the other.
                a_tx = ref_stx("alice", account("carol"), 7, 2, 0, difficulty=DIFF)
                b_tx = stx("bob", account("dave"), 9, 3, 0, difficulty=DIFF)
                await send_tx("127.0.0.1", port.port, Transaction.deserialize(a_tx.serialize()), DIFF)
                await ref_send_tx("127.0.0.1", ref.port, type(a_tx).deserialize(b_tx.serialize()), DIFF)
                want = {a_tx.txid(), b_tx.txid()}
                assert await wait_until(
                    lambda: set(ref.mempool.txids()) == want == set(port.mempool.txids())
                )
                # Both mine at once (forks are possible), then one block
                # from the port breaks any tie.
                ref.start_mining()
                port.start_mining()
                await asyncio.sleep(0.5)
                await ref.stop_mining()
                await port.stop_mining()
                await fund(port, "erin")
                await ref.request_sync()
                assert await wait_until(lambda: same_tip(ref, port) and not len(ref.mempool))
                assert not len(port.mempool)
                assert ref.chain.height == port.chain.height >= 6
                assert ref.chain.balances_snapshot() == port.chain.balances_snapshot()
                assert ref.chain.state_root() == port.chain.state_root()
                assert ref.chain.balance(account("carol")) == 7
                assert port.chain.balance(account("dave")) == 9
                for who in ("alice", "bob"):
                    assert ref.chain.nonce(account(who)) == port.chain.nonce(account(who)) == 1
            finally:
                await stop_all([port, ref])

        run(scenario())


class TestPortDevice:
    """The port's device seams on a node: the ``cuda`` backend's plain
    version, the signature rung's pin and the refusal without a card."""

    def test_cuda_backend_plain_version_mines_and_relays(self):
        # backend="cuda" with device="cpu": the search kernel's plain
        # PyTorch version seals the blocks; a hashlib node accepts them.
        async def scenario():
            a = Node(_config(backend="cuda"))
            await a.start()
            b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
            await b.start()
            try:
                assert type(a.miner.backend).__name__ == "CudaBackend"
                assert a.miner.backend.device.type == "cpu"
                assert await wait_until(lambda: a.peer_count() and b.peer_count())
                await fund(a, "alice", blocks=3)
                assert await wait_until(lambda: b.chain.tip_hash == a.chain.tip_hash)
                assert a.status()["blocks_mined"] >= 3
            finally:
                await stop_all([a, b])

        run(scenario())

    def test_device_cpu_pins_the_plain_signature_rung(self):
        from p1_tpu_torch.core import keys

        keys.set_sig_backend(None)
        try:
            Node(_config())
            assert keys.backend() == "device" and keys._sig_device == "cpu"
            Node(_config(sig_backend="fallback"))
            assert keys.backend() == "pure-python"
        finally:
            keys.set_sig_backend(None)

    def test_admission_runs_on_the_native_rung(self):
        # Mempool admission is a serial verify: under auto it runs on the
        # native C++ engine, and status()["validation"]["backends"] counts
        # it there (the pure-Python rung does no work).
        from p1_tpu_torch.core import keys

        async def scenario():
            (node,) = await start_mesh(1)
            try:
                await fund(node, "alice")
                keys.STATS.reset()
                txs = [stx("alice", "bob", 1, 1, seq, difficulty=DIFF) for seq in range(3)]
                for tx in txs:
                    await node.submit_tx(Transaction.deserialize(tx.serialize()))
                assert len(node.mempool) == 3
                backends = node.status()["validation"]["backends"]
                assert backends["native"] == 3 and backends["pure-python"] == 0
                assert node.status()["validation"]["backend"] == "device"
            finally:
                await stop_all([node])

        keys.set_sig_backend(None)
        try:
            run(scenario())
        finally:
            keys.set_sig_backend(None)

    def test_auto_on_the_card_keeps_another_nodes_pin(self):
        # "auto" on the card must not clobber a pin made before it (the
        # reference's multi-node rule); constructing it needs a card, so
        # a miner is injected and only the pin is looked at.
        from p1_tpu_torch.core import keys
        from p1_tpu_torch.miner import Miner

        keys.set_sig_backend("fallback")
        try:
            Node(_config(device="cuda"), miner=Miner(backend="cpu", device="cpu"))
            assert keys.backend() == "pure-python"
        finally:
            keys.set_sig_backend(None)

    def test_without_a_card_the_node_refuses_to_start(self):
        import torch

        from p1_tpu_torch.config import NodeConfig as PortConfig

        if torch.cuda.is_available():
            pytest.skip("a card is present: this checks the refusal without one")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            Node(PortConfig(difficulty=DIFF, mine=False))
        with pytest.raises(ValueError, match="host only"):
            Node(PortConfig(difficulty=DIFF, mine=False, backend="cpu"))

    def test_verify_workers_knob_is_reported(self):
        # The count is recorded and reported; the verdicts stay the
        # reference's (a funded transfer accepted, a flipped signature
        # rejected with the same text).
        from p1_tpu.chain import Chain as RefChain
        from p1_tpu.core import Transaction as RefTransaction
        from p1_tpu.node.testing import make_blocks as ref_make_blocks
        from p1_tpu_torch.core import Block, keys
        from txutil import stx as ref_stx

        good = ref_stx("alice", account("bob"), 5, 1, 0, difficulty=DIFF)
        raw = bytearray(good.serialize())
        raw[-1] ^= 1  # the signature's last byte
        bad = RefTransaction.deserialize(bytes(raw))
        before = keys.verify_workers()
        try:
            node = Node(_config(verify_workers=3))
            assert node.status()["validation"]["workers"] == 3
            for spend in (good, bad):
                blocks = ref_make_blocks(2, DIFF, miner_id=account("alice"), txs_at={2: (spend,)})
                ref_chain = RefChain(DIFF, genesis=blocks[0])
                port_chain = Node(_config(verify_workers=3)).chain
                for block in blocks[1:]:
                    want = ref_chain.add_block(block)
                    got = port_chain.add_block(Block.deserialize(block.serialize()))
                    assert (got.status.value, got.reason) == (want.status.value, want.reason)
                assert port_chain.tip_hash == ref_chain.tip_hash
            assert want.status.value == "rejected" and "signature" in want.reason
            keys.set_verify_workers(None)
            assert keys.verify_workers() == 1  # unpinned: one thread
            node = Node(_config(pipeline_workers=2))
            assert node.status()["validation"]["workers"] == 2
            keys.shutdown_verify_pool()  # the native rung's pool: none was started
        finally:
            keys.set_verify_workers(before)
