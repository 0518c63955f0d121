"""The port's fee estimation against the JAX package's.

Mirrors tests/test_fees.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
The chain-side cases use tests/test_torch_chain.py's port chain helpers.

Fee estimation: chain-side percentiles, the GETFEES/FEES wire round,
and the wallet query path.
"""

import asyncio

import pytest

from torch_testutil import account, stx

from test_torch_chain import DIFF, _funded_chain, _mine_child
from test_torch_node import _config, fund, wait_until

from p1_tpu_torch.chain import AddStatus
from p1_tpu_torch.core import Transaction
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.client import get_fees
from p1_tpu_torch.node.protocol import FeeStats, MsgType


class TestChainFeeStats:
    def test_empty_chain_suggests_nothing(self):
        chain, _ = _funded_chain("alice")
        stats = chain.fee_stats()
        assert stats["samples"] == 0
        assert stats["p50"] == 0
        assert stats["window_blocks"] >= 1  # blocks seen, no transfers

    def test_percentiles_over_recent_transfers(self):
        chain, b1 = _funded_chain("alice")
        fees = [1, 2, 3, 4, 5, 6, 7, 8]
        tip = b1
        for i, fee in enumerate(fees):
            tip = _mine_child(
                tip,
                txs=(
                    Transaction.coinbase("m", chain.height + 1),
                    stx("alice", account("bob"), 1, fee, i),
                ),
            )
            assert chain.add_block(tip).status is AddStatus.ACCEPTED
        stats = chain.fee_stats(window=100)
        assert stats["samples"] == 8
        assert stats["p25"] == 3 and stats["p50"] == 5 and stats["p75"] == 7
        # A small window samples only the latest blocks.
        assert chain.fee_stats(window=2)["samples"] == 2
        assert chain.fee_stats(window=2)["p50"] == 8

    def test_window_never_includes_genesis(self):
        chain, _ = _funded_chain("alice")
        stats = chain.fee_stats(window=1000)
        assert stats["window_blocks"] == chain.height


class TestWire:
    def test_round_trips(self):
        mtype, got = protocol.decode(protocol.encode_getfees())
        assert mtype is MsgType.GETFEES and got == 0
        mtype, got = protocol.decode(protocol.encode_getfees(64))
        assert got == 64
        stats = FeeStats(32, 100, 1, 2, 3, 999)
        mtype, got = protocol.decode(protocol.encode_fees(stats))
        assert mtype is MsgType.FEES and got == stats

    @pytest.mark.parametrize(
        "payload",
        [
            bytes([MsgType.GETFEES]),  # no window
            bytes([MsgType.GETFEES]) + b"\x00\x00\x00",  # oversized
            bytes([MsgType.FEES]) + b"\x00" * 33,  # short
            bytes([MsgType.FEES]) + b"\x00" * 35,  # long
        ],
    )
    def test_malformed_rejected(self, payload):
        with pytest.raises(ValueError):
            protocol.decode(payload)


class TestWalletQuery:
    def test_live_node_serves_fee_stats(self):
        NODE_DIFF = 12

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=1)
                for i, fee in enumerate((2, 4, 6)):
                    await node.submit_tx(
                        stx(
                            "alice",
                            account("bob"),
                            1,
                            fee,
                            i,
                            difficulty=NODE_DIFF,
                        )
                    )
                node.start_mining()
                assert await wait_until(
                    lambda: node.chain.fee_stats()["samples"] >= 3
                )
                await node.stop_mining()
                stats = await get_fees("127.0.0.1", node.port, NODE_DIFF)
                assert stats.samples >= 3
                assert stats.p25 >= 2 and stats.p75 <= 6
                assert stats.tip_height == node.chain.height
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
