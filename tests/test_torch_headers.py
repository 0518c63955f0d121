"""The port's headers-first light-client sync: the client fetch loop,
local verification, and proof anchoring against a verified header chain.

Mirrors tests/test_headers.py's ``TestLightClientSync`` against
``p1_tpu_torch`` (its ``TestWire`` codec cases are in
tests/test_torch_protocol.py's frame-by-frame byte identity).  Nodes mine
with hashlib on the host (``tests/test_torch_node.py``'s ``_config``) and
transfers are signed by the JAX package's keys, carried in by bytes
(``torch_testutil.stx``).  ``TestCrossPackage`` fetches headers across
the two packages: the port's client from a JAX-package node and the
JAX package's client from a port node, each the other's bytes.
"""

import asyncio

import pytest

from torch_testutil import account, stx

from test_torch_node import _config, fund, wait_until

from p1_tpu_torch.chain import replay_host
from p1_tpu_torch.core import BlockHeader, RetargetRule
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.client import get_headers, get_proof

DIFF = 12


class TestLightClientSync:
    def test_fetch_matches_chain_and_verifies(self):
        async def scenario():
            node = Node(_config(mine=True))
            await node.start()
            try:
                assert await wait_until(lambda: node.chain.height >= 15)
                await node.stop_mining()
                headers = await get_headers(
                    "127.0.0.1", node.port, DIFF
                )
                assert len(headers) == node.chain.height + 1
                assert (
                    headers[-1].block_hash() == node.chain.tip_hash
                )
                # The client verifies — PoW, linkage — locally.
                assert replay_host(headers).valid
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_fetch_spans_multiple_batches(self):
        # Force several GETHEADERS round trips by shrinking the batch.
        from p1_tpu_torch.node import node as node_mod

        async def scenario():
            node = Node(_config(mine=True))
            await node.start()
            try:
                assert await wait_until(lambda: node.chain.height >= 13)
                await node.stop_mining()
                old = node_mod.HEADERS_BATCH
                node_mod.HEADERS_BATCH = 4
                try:
                    headers = await get_headers("127.0.0.1", node.port, DIFF)
                finally:
                    node_mod.HEADERS_BATCH = old
                assert len(headers) == node.chain.height + 1
                assert replay_host(headers).valid
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_retargeting_chain_verifies_with_rule(self):
        rule = RetargetRule(window=5, spacing=50)

        async def scenario():
            node = Node(
                _config(
                    difficulty=10,
                    mine=True,
                    retarget_window=5,
                    target_spacing=50,
                )
            )
            await node.start()
            try:
                assert await wait_until(lambda: node.chain.height >= 12)
                await node.stop_mining()
                headers = await get_headers(
                    "127.0.0.1", node.port, 10, retarget=rule
                )
                assert len(headers) == node.chain.height + 1
                report = replay_host(headers, retarget=rule)
                assert report.valid, report.first_invalid
                # The schedule moved (genesis-gap retarget at height 5) and
                # the light client verified every step of it.
                assert {h.difficulty for h in headers[1:]} != {10}
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_mid_fetch_reorg_truncates_to_link_point(self):
        """A live peer can reorg between GETHEADERS batches; the client
        must splice the new branch at its link point instead of appending
        an unlinked tail that verification would blame on an honest peer.
        Scripted server: serves branch A first, then branch B (forking
        after height 1), then quiesces."""

        from p1_tpu_torch.core.genesis import make_genesis as mg
        from p1_tpu_torch.hashx import get_backend
        from p1_tpu_torch.miner import Miner

        miner = Miner(backend=get_backend("cpu", device="cpu"))

        def _mine_on(parent: BlockHeader, ts_off: int) -> BlockHeader:
            draft = BlockHeader(
                1,
                parent.block_hash(),
                bytes(32),
                parent.timestamp + ts_off,
                DIFF,
                0,
            )
            sealed = miner.search_nonce(draft)
            assert sealed is not None
            return sealed

        genesis = mg(DIFF)
        a1 = _mine_on(genesis.header, 1)
        a2 = _mine_on(a1, 1)
        a3 = _mine_on(a2, 1)
        b2 = _mine_on(a1, 2)  # fork after a1
        b3 = _mine_on(b2, 1)
        b4 = _mine_on(b3, 1)
        replies = [[a1, a2, a3], [b2, b3, b4], []]

        async def scenario():
            async def serve(reader, writer):
                await protocol.write_frame(
                    writer,
                    protocol.encode_hello(
                        protocol.Hello(genesis.block_hash(), 4, 0)
                    ),
                )
                await protocol.read_frame(reader)  # client HELLO
                for reply in replies:
                    await protocol.read_frame(reader)  # GETHEADERS
                    await protocol.write_frame(
                        writer, protocol.encode_headers(reply)
                    )
                writer.close()

            server = await asyncio.start_server(serve, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                headers = await get_headers("127.0.0.1", port, DIFF)
            finally:
                server.close()
                await server.wait_closed()
            # Branch A's tail was spliced out at the fork point.
            assert [h.block_hash() for h in headers] == [
                h.block_hash() for h in (genesis.header, a1, b2, b3, b4)
            ]
            assert replay_host(headers).valid

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_unlinked_headers_reply_is_a_protocol_violation(self):
        from p1_tpu_torch.core.genesis import make_genesis as mg

        genesis = mg(DIFF)
        stray = BlockHeader(1, b"\x55" * 32, bytes(32), 1_800_000_000, DIFF, 0)

        async def scenario():
            async def serve(reader, writer):
                await protocol.write_frame(
                    writer,
                    protocol.encode_hello(
                        protocol.Hello(genesis.block_hash(), 1, 0)
                    ),
                )
                await protocol.read_frame(reader)
                await protocol.read_frame(reader)
                await protocol.write_frame(
                    writer, protocol.encode_headers([stray])
                )
                writer.close()

            server = await asyncio.start_server(serve, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                with pytest.raises(ValueError, match="link"):
                    await get_headers("127.0.0.1", port, DIFF)
            finally:
                server.close()
                await server.wait_closed()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_proof_anchors_to_verified_headers(self):
        """The full light-client story in one flow: sync headers, verify
        locally, fetch a proof, anchor its block at its claimed height on
        OUR chain — no peer claim left unverified."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=1)
                spend = stx(
                    "alice", account("bob"), 5, 1, 0, difficulty=DIFF
                )
                await node.submit_tx(spend)
                node.start_mining()
                assert await wait_until(
                    lambda: node.chain.tx_proof(spend.txid()) is not None
                )
                await node.stop_mining()
                headers = await get_headers("127.0.0.1", node.port, DIFF)
                assert replay_host(headers).valid
                proof = await get_proof(
                    "127.0.0.1", node.port, spend.txid(), DIFF
                )
                assert (
                    headers[proof.height].block_hash()
                    == proof.header.block_hash()
                )
                # A height mismatch (stale/forged claim) must NOT anchor.
                assert (
                    proof.height + 1 >= len(headers)
                    or headers[proof.height + 1].block_hash()
                    != proof.header.block_hash()
                )
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestCrossPackage:
    """Header bytes are the wire: each package's light client reads the
    other package's node byte for byte, and both verifiers agree."""

    def test_port_client_reads_a_reference_node(self):
        from p1_tpu.chain import replay_host as ref_replay
        from p1_tpu.config import NodeConfig as RefConfig
        from p1_tpu.node import Node as RefNode

        async def scenario():
            ref = RefNode(RefConfig(difficulty=DIFF, chunk=1 << 14, mine=True))
            await ref.start()
            try:
                assert await wait_until(lambda: ref.chain.height >= 8)
                await ref.stop_mining()
                headers = await get_headers("127.0.0.1", ref.port, DIFF)
                want = [b.header.serialize() for b in ref.chain.main_chain()]
                assert [h.serialize() for h in headers] == want
                assert replay_host(headers).valid
                assert ref_replay([type(ref.chain.tip.header).deserialize(raw) for raw in want]).valid
            finally:
                await ref.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_reference_client_reads_a_port_node(self):
        from p1_tpu.chain import replay_host as ref_replay
        from p1_tpu.node.client import get_headers as ref_get_headers

        async def scenario():
            node = Node(_config(mine=True))
            await node.start()
            try:
                assert await wait_until(lambda: node.chain.height >= 8)
                await node.stop_mining()
                headers = await ref_get_headers("127.0.0.1", node.port, DIFF)
                want = [b.header.serialize() for b in node.chain.main_chain()]
                assert [h.serialize() for h in headers] == want
                assert ref_replay(headers).valid
                assert replay_host([BlockHeader.deserialize(raw) for raw in want]).valid
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
