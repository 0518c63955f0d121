"""The port's memory-bounded node against the JAX package's.

Mirrors tests/test_bodycache.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.

Memory-bounded operation: body eviction, refetch, streaming resume.

The chain keeps headers + metadata resident forever; block BODIES below
the keep window are evicted once the append-only store can re-serve them
(Chain.evict_bodies + ChainStore.read_body) and refetched on demand.
These tests prove the eviction is a pure memory policy: every query,
sync reply, proof, reorg, and restart behaves byte-identically with and
without it.
"""

import asyncio

import pytest

from p1_tpu_torch.chain import Chain, ChainStore
from torch_testutil import NodeConfig
from p1_tpu_torch.node import Node
from p1_tpu_torch.node.testing import make_blocks

DIFF = 8  # a few hashes per block: chains are cheap to mine


def _store_with(tmp_path, blocks, name="chain.dat"):
    store = ChainStore(tmp_path / name)
    store.acquire()
    for b in blocks[1:]:
        store.append(b)
    return store


def _evicted_chain(store, blocks, keep=4) -> Chain:
    chain = Chain(DIFF)
    chain.body_source = store
    for b in blocks[1:]:
        assert chain.add_block(b).status.value == "accepted"
    freed = chain.evict_bodies(keep)
    assert freed > 0 and chain.bodies_evicted > 0
    return chain


class TestEviction:
    def test_evicts_only_below_keep_window_and_only_durable(self, tmp_path):
        blocks = make_blocks(12, difficulty=DIFF)
        store = _store_with(tmp_path, blocks)
        try:
            chain = Chain(DIFF)
            chain.body_source = store
            for b in blocks[1:]:
                chain.add_block(b)
            before = chain.resident_body_bytes
            chain.evict_bodies(4)
            assert chain.bodies_evicted == 12 - 4
            assert 0 < chain.resident_body_bytes < before
            # The hot window (and genesis) still serve without refetch.
            assert chain.body_refetches == 0
            assert chain.tip.block_hash() == blocks[-1].block_hash()
        finally:
            store.close()

    def test_not_durable_means_not_evicted(self, tmp_path):
        blocks = make_blocks(8, difficulty=DIFF)
        store = _store_with(tmp_path, blocks[:5])  # only 4 mined persisted
        try:
            chain = Chain(DIFF)
            chain.body_source = store
            for b in blocks[1:]:
                chain.add_block(b)
            chain.evict_bodies(1)
            # Blocks 5..8 are not in the store: bodies stay resident no
            # matter how deep they sink.
            assert chain.bodies_evicted == 4
            for b in blocks[5:]:
                assert chain._index[b.block_hash()].block is not None
        finally:
            store.close()

    def test_queries_identical_after_eviction(self, tmp_path):
        blocks = make_blocks(16, difficulty=DIFF)
        store = _store_with(tmp_path, blocks)
        try:
            full = Chain(DIFF)
            for b in blocks[1:]:
                full.add_block(b)
            chain = _evicted_chain(store, blocks, keep=3)
            # blocks_after from genesis: the IBD-serving path, straight
            # through the evicted region.
            locator = [blocks[0].block_hash()]
            got = chain.blocks_after(locator, limit=500)
            want = full.blocks_after(locator, limit=500)
            assert [b.serialize() for b in got] == [
                b.serialize() for b in want
            ]
            assert chain.body_refetches > 0
            # get() on an evicted hash returns the exact block.
            deep = blocks[2]
            assert chain.get(deep.block_hash()).serialize() == deep.serialize()
            # header_of never costs a refetch.
            r = chain.body_refetches
            assert chain.header_of(deep.block_hash()) == deep.header
            assert chain.body_refetches == r
            # main_chain() iteration and the ledger views agree.
            assert [b.block_hash() for b in chain.main_chain()] == [
                b.block_hash() for b in full.main_chain()
            ]
            assert chain.balances_snapshot() == full.balances_snapshot()
        finally:
            store.close()

    def test_tx_proof_from_evicted_block(self, tmp_path):
        from p1_tpu_torch.chain.proof import verify_tx_proof
        from p1_tpu_torch.core.genesis import make_genesis

        blocks = make_blocks(10, difficulty=DIFF, miner_id="m")
        store = _store_with(tmp_path, blocks)
        try:
            chain = _evicted_chain(store, blocks, keep=2)
            # The height-1 coinbase lives in an evicted body.
            txid = blocks[1].txs[0].txid()
            proof = chain.tx_proof(txid)
            assert proof is not None
            verify_tx_proof(
                proof,
                DIFF,
                make_genesis(DIFF).block_hash(),
                txid=txid,
            )
        finally:
            store.close()

    def test_reorg_across_evicted_region(self, tmp_path):
        """A deeper fork arriving after eviction: the reorg walk undoes
        evicted main-chain bodies via refetch and lands on the same
        state a fully-resident chain reaches."""
        blocks = make_blocks(6, difficulty=DIFF, miner_id="a")
        # A heavier branch from height 2 (same prefix, different miner).
        from p1_tpu_torch.core.block import Block, merkle_root
        from p1_tpu_torch.core.header import BlockHeader
        from p1_tpu_torch.core.tx import Transaction
        from p1_tpu_torch.hashx import get_backend
        from p1_tpu_torch.miner import Miner

        miner = Miner(backend=get_backend("cpu"))
        branch = list(blocks[:3])  # genesis, b1, b2 shared
        for height in range(3, 9):  # out-works the 6-block main chain
            parent = branch[-1]
            txs = (Transaction.coinbase("b", height),)
            draft = BlockHeader(
                1,
                parent.block_hash(),
                merkle_root([t.txid() for t in txs]),
                parent.header.timestamp + 1,
                DIFF,
                0,
            )
            sealed = miner.search_nonce(draft)
            branch.append(Block(sealed, txs))

        store = _store_with(tmp_path, blocks)
        try:
            chain = _evicted_chain(store, blocks, keep=1)
            full = Chain(DIFF)
            for b in blocks[1:]:
                full.add_block(b)
            for b in branch[3:]:
                res = chain.add_block(b)
                fres = full.add_block(b)
                assert res.status == fres.status
            assert chain.tip_hash == full.tip_hash
            assert chain.height == full.height == 8
            assert chain.balances_snapshot() == full.balances_snapshot()
        finally:
            store.close()

    def test_read_body_detects_span_mismatch(self, tmp_path):
        blocks = make_blocks(3, difficulty=DIFF)
        store = _store_with(tmp_path, blocks)
        try:
            h1, h2 = blocks[1].block_hash(), blocks[2].block_hash()
            store._body_spans[h1] = store._body_spans[h2]  # lie
            with pytest.raises(ValueError):
                store.read_body(h1)
        finally:
            store.close()


class TestStreamingResume:
    def test_body_cache_resume_state_equals_full_resume(self, tmp_path):
        blocks = make_blocks(20, difficulty=DIFF, miner_id="m")
        store = _store_with(tmp_path, blocks)
        try:
            full = store.load_chain(DIFF)
            bounded = store.load_chain(DIFF, body_cache=5)
            assert bounded.tip_hash == full.tip_hash
            assert bounded.height == full.height
            assert bounded.balances_snapshot() == full.balances_snapshot()
            assert bounded.bodies_evicted > 0
            assert bounded.resident_body_bytes < full.resident_body_bytes
            # Trusted fast resume composes with eviction too.
            trusted = store.load_chain(DIFF, trusted=True, body_cache=5)
            assert trusted.tip_hash == full.tip_hash
            assert trusted.balances_snapshot() == full.balances_snapshot()
        finally:
            store.close()

    def test_node_restart_with_body_cache(self, tmp_path):
        """Mine -> stop -> restart with eviction on -> the node resumes,
        serves its full chain, and keeps accepting blocks."""

        async def scenario():
            path = str(tmp_path / "node-chain.dat")
            node = Node(
                NodeConfig(
                    difficulty=DIFF,
                    chunk=1 << 12,
                    store_path=path,
                    miner_id="m",
                )
            )
            await node.start()
            while node.chain.height < 12:
                await asyncio.sleep(0.01)
            await node.stop()
            height = node.chain.height
            tip = node.chain.tip_hash

            node2 = Node(
                NodeConfig(
                    difficulty=DIFF,
                    chunk=1 << 12,
                    mine=False,
                    store_path=path,
                    body_cache_blocks=4,
                )
            )
            await node2.start()
            try:
                assert node2.chain.height == height
                assert node2.chain.tip_hash == tip
                assert node2.chain.bodies_evicted > 0
                # It still serves the whole chain from genesis (refetch).
                got = node2.chain.blocks_after(
                    [node2.chain.genesis.block_hash()], limit=500
                )
                assert len(got) == height
                # And still extends: mine a few more on top.
                node2.start_mining()
                while node2.chain.height < height + 2:
                    await asyncio.sleep(0.01)
                await node2.stop_mining()
            finally:
                await node2.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=120))
