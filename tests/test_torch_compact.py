"""The port's compact block relay against the JAX package's.

Mirrors tests/test_compact.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.

Compact block relay: wire codec, mempool reconstruction, the
GETBLOCKTXN round trip, and hostile-input behavior.

The invariant under test everywhere: compact relay is an ENCODING of
gossip, never a consensus change — a reconstructed block goes through
exactly the same ``_handle_block`` path as a full one, and a node that
cannot reconstruct converges anyway (fetch round, or locator sync as the
last resort).
"""

import asyncio

import pytest

from torch_testutil import account, stx

from test_torch_node import _config, fund, stop_all, wait_until

from p1_tpu_torch.core import Block, BlockHeader, Transaction, make_genesis
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.protocol import CompactBlock, MsgType

DIFF = 12


def _block_with_txs(n: int = 3) -> Block:
    txs = (
        Transaction.coinbase("miner", 7),
        *(stx("alice", "bob", 1, f + 1, f) for f in range(n - 1)),
    )
    header = BlockHeader(1, b"\x11" * 32, b"\x22" * 32, 1735689700, DIFF, 9)
    return Block(header, txs)


class TestWire:
    def test_cblock_round_trip(self):
        block = _block_with_txs(4)
        mtype, cb = protocol.decode(protocol.encode_cblock(block, sent_ts=2.5))
        assert mtype is MsgType.CBLOCK
        assert cb.sent_ts == 2.5
        assert cb.header == block.header
        assert cb.ntx == 4
        assert cb.prefilled == ((0, block.txs[0]),)  # coinbase carried whole
        assert cb.txids == tuple(tx.txid() for tx in block.txs[1:])

    def test_cblock_is_much_smaller(self):
        block = _block_with_txs(20)
        full = protocol.encode_block(block)
        compact = protocol.encode_cblock(block)
        # ~32 B/txid vs a few hundred per signed transfer.
        assert len(compact) < len(full) / 4

    def test_cblock_without_coinbase(self):
        block = Block(
            _block_with_txs(2).header, (stx("alice", "bob", 1, 1, 0),)
        )
        mtype, cb = protocol.decode(protocol.encode_cblock(block))
        assert cb.prefilled == () and len(cb.txids) == 1

    def test_getblocktxn_round_trip(self):
        payload = protocol.encode_getblocktxn(b"\xaa" * 32, [1, 3, 7])
        mtype, (bhash, indices) = protocol.decode(payload)
        assert mtype is MsgType.GETBLOCKTXN
        assert bhash == b"\xaa" * 32 and indices == [1, 3, 7]

    def test_blocktxn_round_trip(self):
        txs = [stx("alice", "bob", 1, f + 1, f) for f in range(3)]
        payload = protocol.encode_blocktxn(
            b"\xbb" * 32, [t.serialize() for t in txs]
        )
        mtype, (bhash, got) = protocol.decode(payload)
        assert mtype is MsgType.BLOCKTXN
        assert bhash == b"\xbb" * 32 and got == txs

    @pytest.mark.parametrize(
        "payload",
        [
            bytes([MsgType.CBLOCK]) + b"\x00" * 10,  # truncated
            # prefill count exceeds ntx
            bytes([MsgType.CBLOCK]) + b"\x00" * 8 + b"\x00" * 80 + b"\x00\x01\x00\x02",
            bytes([MsgType.GETBLOCKTXN]) + b"\x00" * 32,  # no count
            bytes([MsgType.GETBLOCKTXN]) + b"\x00" * 32 + b"\x00\x00",  # 0 idx
            # non-ascending indices
            bytes([MsgType.GETBLOCKTXN])
            + b"\x00" * 32
            + b"\x00\x02\x00\x05\x00\x03",
            bytes([MsgType.BLOCKTXN]) + b"\x00" * 5,  # truncated
            bytes([MsgType.BLOCKTXN]) + b"\x00" * 32 + b"\x00\x01",  # count lies
        ],
    )
    def test_malformed_rejected(self, payload):
        with pytest.raises(ValueError):
            protocol.decode(payload)

    def test_cblock_txid_section_must_be_exact(self):
        block = _block_with_txs(3)
        good = protocol.encode_cblock(block)
        with pytest.raises(ValueError):
            protocol.decode(good + b"\x00")
        with pytest.raises(ValueError):
            protocol.decode(good[:-1])


class TestRelay:
    def test_mempool_hit_reconstruction(self):
        """Txs gossiped normally live in every pool; a mined block then
        relays compactly and reconstructs with zero fetch round trips."""

        async def scenario():
            a, b = await self._funded_pair()
            try:
                for i in range(3):
                    await b.submit_tx(
                        stx(
                            "alice",
                            account("bob"),
                            1,
                            1,
                            i,
                            difficulty=DIFF,
                        )
                    )
                assert await wait_until(lambda: len(a.mempool) == 3)
                target = b.chain.height + 1
                b.start_mining()
                assert await wait_until(
                    lambda: a.chain.height >= target
                    and a.chain.tip_hash == b.chain.tip_hash
                )
                await b.stop_mining()
                assert a.metrics.cblocks_received >= 1
                assert a.metrics.cblock_tx_hits >= 3
                assert a.metrics.cblock_tx_fetched == 0
                assert b.metrics.cblocks_sent >= 1
                assert b.metrics.cblock_bytes_saved > 0
                # Wire accounting runs at the send/read choke points.
                assert b.metrics.bytes_sent > 0
                assert a.metrics.bytes_received > 0
                # The confirmed spends actually connected (consensus ran).
                assert a.chain.balance(account("bob")) >= 3
            finally:
                await stop_all((a, b))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_missing_tx_fetch_round_trip(self):
        """A tx slipped straight into the miner's pool (never gossiped)
        forces the receiver through GETBLOCKTXN — and it still converges."""

        async def scenario():
            a, b = await self._funded_pair()
            try:
                sneak = stx(
                    "alice", account("carol"), 2, 1, 0, difficulty=DIFF
                )
                assert b.mempool.add(sneak)  # no gossip: a never sees it
                assert sneak.txid() not in a.mempool
                target = b.chain.height + 1
                b.start_mining()
                assert await wait_until(
                    lambda: a.chain.height >= target
                    and a.chain.tip_hash == b.chain.tip_hash
                )
                await b.stop_mining()
                assert a.metrics.cblock_tx_fetched >= 1
                assert a.chain.balance(account("carol")) >= 2
            finally:
                await stop_all((a, b))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_full_block_nodes_interoperate(self):
        """--no-compact-gossip is a local preference: a full-frame node
        and a compact node still converge both directions."""

        async def scenario():
            a, b = await self._funded_pair(a_kw={"compact_gossip": False})
            try:
                await b.submit_tx(
                    stx("alice", account("bob"), 1, 1, 0, difficulty=DIFF)
                )
                target = b.chain.height + 1
                b.start_mining()
                assert await wait_until(lambda: a.chain.height >= target)
                await b.stop_mining()
                target = a.chain.height + 1
                a.start_mining()
                assert await wait_until(lambda: b.chain.height >= target)
                await a.stop_mining()
                assert await wait_until(
                    lambda: a.chain.tip_hash == b.chain.tip_hash
                )
                assert a.metrics.cblocks_sent == 0  # full frames only
            finally:
                await stop_all((a, b))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    async def _funded_pair(self, a_kw=None):
        """Two connected nodes; alice's account funded on the shared chain."""
        a = Node(_config(**(a_kw or {})))
        await a.start()
        b = Node(_config(peers=(f"127.0.0.1:{a.port}",)))
        await b.start()
        await fund(b, "alice", blocks=2)
        assert await wait_until(
            lambda: a.chain.tip_hash == b.chain.tip_hash
        )
        return a, b


class TestHostileInput:
    def test_workless_cblock_rejected_before_state(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                # A header that never met the target: the handler must
                # refuse before parking anything or asking for txs.
                txs = (
                    Transaction.coinbase("m", 1),
                    stx("alice", "bob", 1, 1, 0, difficulty=DIFF),
                )
                from p1_tpu_torch.core import merkle_root
                from p1_tpu_torch.core.header import meets_target

                header = BlockHeader(
                    1,
                    node.chain.tip_hash,
                    merkle_root([t.txid() for t in txs]),
                    make_genesis(DIFF).header.timestamp + 1,
                    DIFF,
                    0,
                )
                nonce = 0
                while meets_target(header.with_nonce(nonce).block_hash(), DIFF):
                    nonce += 1
                bad = Block(header.with_nonce(nonce), txs)
                _, cb = protocol.decode(protocol.encode_cblock(bad))

                class _FakePeer:
                    label = "test"

                    async def send(self, payload):
                        raise AssertionError(
                            "workless CBLOCK must not trigger any send"
                        )

                before = node.metrics.blocks_rejected
                await node._handle_cblock(cb, _FakePeer())
                assert node.metrics.blocks_rejected == before + 1
                assert not node._pending_cblocks
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_blocktxn_txid_mismatch_dropped(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                from p1_tpu_torch.node.node import _PendingCompact

                header = make_genesis(DIFF).header
                bhash = header.block_hash()
                want_txid = b"\x77" * 32

                class _FakePeer:
                    label = "test"

                asked = _FakePeer()
                node._pending_cblocks[(bhash, asked)] = _PendingCompact(
                    header, [None], {0: want_txid}, 1.0
                )
                wrong = stx("alice", "bob", 9, 9, 3, difficulty=DIFF)
                # An unsolicited reply from a peer we never asked must not
                # touch the in-flight reconstruction (a rival could
                # otherwise destroy it for free)...
                await node._handle_blocktxn((bhash, [wrong]), _FakePeer())
                assert (bhash, asked) in node._pending_cblocks
                # ...while a bad reply from the ASKED peer consumes the
                # entry without accepting anything.
                await node._handle_blocktxn((bhash, [wrong]), asked)
                assert (bhash, asked) not in node._pending_cblocks
                assert node.metrics.blocks_accepted == 0
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_cheap_difficulty_cblock_rejected_on_retarget_chain(self):
        # The flood gate must price a compact push at the EXACT contextual
        # difficulty — a claimed difficulty-1 header (2 hashes of "work")
        # must not create pending state or trigger a fetch round.
        async def scenario():
            node = Node(
                _config(
                    difficulty=10, retarget_window=5, target_spacing=50
                )
            )
            await node.start()
            try:
                from p1_tpu_torch.core import merkle_root
                from p1_tpu_torch.core.header import meets_target

                txs = (
                    Transaction.coinbase("m", 1),
                    stx("alice", "bob", 1, 1, 0, difficulty=DIFF),
                )
                header = BlockHeader(
                    1,
                    node.chain.tip_hash,
                    merkle_root([t.txid() for t in txs]),
                    node.chain.tip.header.timestamp + 1,
                    1,  # claimed difficulty 1: ~2 hashes to satisfy
                    0,
                )
                nonce = 0
                while not meets_target(
                    header.with_nonce(nonce).block_hash(), 1
                ):
                    nonce += 1
                cheap = Block(header.with_nonce(nonce), txs)
                _, cb = protocol.decode(protocol.encode_cblock(cheap))

                class _FakePeer:
                    label = "test"

                    async def send(self, payload):
                        raise AssertionError("cheap CBLOCK triggered a send")

                before = node.metrics.blocks_rejected
                await node._handle_cblock(cb, _FakePeer())
                assert node.metrics.blocks_rejected == before + 1
                assert not node._pending_cblocks
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_unknown_parent_cblock_falls_to_sync(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                block = _block_with_txs(3)  # prev_hash nobody knows
                _, cb = protocol.decode(protocol.encode_cblock(block))
                sent = []

                class _FakePeer:
                    label = "test"
                    writer = None

                    async def send(self, payload):
                        sent.append(payload)

                await node._handle_cblock(cb, _FakePeer())
                assert not node._pending_cblocks  # nothing parked
                assert len(sent) == 1
                mtype, _ = protocol.decode(sent[0])
                assert mtype is MsgType.GETBLOCKS  # locator sync fallback
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_front_runner_cannot_squat_an_honest_block(self):
        """A tampered-txid CBLOCK from peer B must not stop the honest
        CBLOCK for the SAME block from peer A reconstructing."""

        async def scenario():
            from p1_tpu_torch.hashx import get_backend
            from p1_tpu_torch.miner import Miner
            from p1_tpu_torch.core import merkle_root

            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=1)
                spend = stx(
                    "alice", account("bob"), 1, 1, 0, difficulty=DIFF
                )
                assert node.mempool.add(spend)
                # A real block extending the tip, carrying the spend.
                txs = (
                    Transaction.coinbase("m", node.chain.height + 1),
                    spend,
                )
                draft = BlockHeader(
                    1,
                    node.chain.tip_hash,
                    merkle_root([t.txid() for t in txs]),
                    node.chain.tip.header.timestamp + 1,
                    DIFF,
                    0,
                )
                sealed = Miner(backend=get_backend("cpu")).search_nonce(draft)
                block = Block(sealed, txs)
                bhash = block.block_hash()

                sends = []

                class _FakePeer:
                    writer = None

                    def __init__(self, label):
                        self.label = label

                    async def send(self, payload):
                        sends.append((self.label, payload))

                evil, honest = _FakePeer("evil"), _FakePeer("honest")
                # Front-runner: the real header, garbage txids.
                _, cb = protocol.decode(protocol.encode_cblock(block))
                forged = protocol.CompactBlock(
                    cb.sent_ts, cb.header, cb.ntx, cb.prefilled,
                    (b"\x66" * 32,),
                )
                await node._handle_cblock(forged, evil)
                assert (bhash, evil) in node._pending_cblocks  # stuck ask
                # The honest push reconstructs from the pool and connects.
                await node._handle_cblock(cb, honest)
                assert bhash in node.chain
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
