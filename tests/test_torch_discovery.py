"""The port's peer discovery against the JAX package's.

Mirrors tests/test_discovery.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.

Peer discovery: GETADDR/ADDR wire, address-book bootstrap from one
seed, and self-connect detection via the HELLO instance nonce.
"""

import asyncio

import pytest

from test_torch_node import _config, stop_all, wait_until

from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.protocol import Hello, MsgType


class TestWire:
    def test_round_trips(self):
        mtype, got = protocol.decode(protocol.encode_getaddr())
        assert mtype is MsgType.GETADDR and got is None
        addrs = [("127.0.0.1", 9444), ("node-7.example", 19444)]
        mtype, got = protocol.decode(protocol.encode_addr(addrs))
        assert mtype is MsgType.ADDR and got == addrs
        _, got = protocol.decode(protocol.encode_addr([]))
        assert got == []

    def test_hello_carries_instance_nonce(self):
        h = Hello(b"\xab" * 32, 42, 9444, nonce=0xDEADBEEF12345678)
        mtype, got = protocol.decode(protocol.encode_hello(h))
        assert mtype is MsgType.HELLO and got == h
        assert got.nonce == 0xDEADBEEF12345678

    @pytest.mark.parametrize(
        "payload",
        [
            bytes([MsgType.GETADDR]) + b"\x00",  # non-empty body
            bytes([MsgType.ADDR]) + b"\x00",  # short count
            bytes([MsgType.ADDR]) + b"\x00\x01" + b"\x00\x00\x01a",  # port 0
            bytes([MsgType.ADDR]) + b"\x00\x01" + b"\x23\x28\x00",  # empty host
            bytes([MsgType.ADDR]) + b"\x00\x02" + b"\x23\x28\x01a",  # count lies
            bytes([MsgType.ADDR]) + b"\x00\x01" + b"\x23\x28\x01ab",  # trailing
        ],
    )
    def test_malformed_rejected(self, payload):
        with pytest.raises(ValueError):
            protocol.decode(payload)


class TestBanScore:
    def test_repeat_violations_ban_then_expire(self):
        """Three malformed-frame sessions within the window get the host
        refused at accept time; the ban lapses on its own."""
        import time as _time

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                for _ in range(3):
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", node.port
                    )
                    # A framed unknown message type = protocol violation.
                    writer.write((4).to_bytes(4, "big") + b"\x63zzz")
                    await writer.drain()
                    await reader.read()  # node HELLOs, then drops us
                    writer.close()
                assert "127.0.0.1" in node._banned_until
                # Banned: the accept path closes before any HELLO.
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", node.port
                )
                assert await reader.read() == b""
                writer.close()
                # Lapse the ban: service resumes (HELLO bytes flow again).
                node._banned_until["127.0.0.1"] = _time.monotonic() - 1
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", node.port
                )
                frame = await protocol.read_frame(reader)
                mtype, _ = protocol.decode(frame)
                assert mtype is MsgType.HELLO
                writer.close()
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_oversized_length_prefix_scores_too(self):
        """A hostile length prefix (> MAX_FRAME) is the canonical
        violation the cap exists for — it must count toward a ban."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                for _ in range(3):
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", node.port
                    )
                    writer.write((64 << 20).to_bytes(4, "big"))
                    await writer.drain()
                    await reader.read()
                    writer.close()
                assert "127.0.0.1" in node._banned_until
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_own_refusals_never_score_the_remote(self):
        """A self-connect (our policy, not the peer's fault) must not
        creep toward a ban of the host."""

        async def scenario():
            node = Node(_config(target_peers=2))
            await node.start()
            try:
                own = ("127.0.0.1", node.port)
                node._learn_addr(own)
                assert await wait_until(
                    lambda: own not in node._known_addrs, timeout=15
                )
                assert not node._violations.get("127.0.0.1")
                assert "127.0.0.1" not in node._banned_until
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestDiscovery:
    def test_one_seed_bootstraps_a_full_mesh(self):
        """Classic bootstrap: A and B each know only the seed; discovery
        must connect A<->B through the seed's address book."""

        async def scenario():
            seed = Node(_config(target_peers=3))
            await seed.start()
            a = Node(
                _config(peers=(f"127.0.0.1:{seed.port}",), target_peers=3)
            )
            b = Node(
                _config(peers=(f"127.0.0.1:{seed.port}",), target_peers=3)
            )
            await a.start()
            await b.start()
            try:
                assert await wait_until(
                    lambda: a.peer_count() >= 2
                    and b.peer_count() >= 2
                    and seed.peer_count() >= 2,
                    timeout=20,
                )
                # Everyone's book learned everyone's listening address.
                for node, others in (
                    (a, (seed, b)),
                    (b, (seed, a)),
                    (seed, (a, b)),
                ):
                    # Connected peers are promoted to the tried bucket;
                    # the book is the union of both.
                    known_ports = {
                        p
                        for _, p in (*node._known_addrs, *node._tried_addrs)
                    }
                    assert {o.port for o in others} <= known_ports
            finally:
                await stop_all((a, b, seed))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_self_address_is_detected_and_forgotten(self):
        async def scenario():
            node = Node(_config(target_peers=2))
            await node.start()
            try:
                own = ("127.0.0.1", node.port)
                node._learn_addr(own)
                # The discovery loop dials it, the HELLO nonce comes back
                # as our own, the session dies and the address is dropped.
                assert await wait_until(
                    lambda: own not in node._known_addrs, timeout=15
                )
                assert node.peer_count() == 0
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_failed_handshake_address_is_forgotten(self):
        """An address that accepts TCP but rejects the handshake (here: a
        node on a different chain) must leave the book, or the discovery
        loop would redial the same dead end every tick and starve every
        other candidate."""

        async def scenario():
            foreign = Node(_config(difficulty=13))
            await foreign.start()
            node = Node(_config(target_peers=1))
            await node.start()
            try:
                bad = ("127.0.0.1", foreign.port)
                node._learn_addr(bad)
                assert await wait_until(
                    lambda: bad not in node._known_addrs, timeout=15
                )
                assert node.peer_count() == 0
            finally:
                await stop_all((node, foreign))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_alias_of_connected_peer_not_redialed(self):
        """An address-book alias of a live peer (hostname spelling vs the
        peername IP) must count as connected — no duplicate session."""

        async def scenario():
            seed = Node(_config())
            await seed.start()
            node = Node(
                _config(peers=(f"localhost:{seed.port}",), target_peers=2)
            )
            await node.start()
            try:
                assert await wait_until(lambda: node.peer_count() == 1)
                # The book also knows the peer under its IP spelling.
                node._learn_addr(("127.0.0.1", seed.port))
                await asyncio.sleep(3)
                assert node.peer_count() == 1  # no duplicate dial
                assert seed.peer_count() == 1
            finally:
                await stop_all((node, seed))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_address_book_survives_restart(self, tmp_path):
        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            node._learn_addr(("10.1.2.3", 9444))
            node._learn_addr(("10.1.2.4", 9445))
            await node.stop()  # persists <store>.addrs atomically
            reborn = Node(_config(store_path=store))
            await reborn.start()
            try:
                assert ("10.1.2.3", 9444) in reborn._known_addrs
                assert ("10.1.2.4", 9445) in reborn._known_addrs
            finally:
                await reborn.stop()
            # A corrupt book is ignored, never fatal.
            (tmp_path / "chain.dat.addrs").write_text("not json{")
            third = Node(_config(store_path=store))
            await third.start()
            try:
                assert ("10.1.2.3", 9444) not in third._known_addrs
            finally:
                await third.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_discovery_off_by_default(self):
        async def scenario():
            a = Node(_config())
            await a.start()
            b = Node(_config())
            await b.start()
            try:
                # Books may learn addresses, but nothing dials without
                # --target-peers: no discovery task exists.
                a._learn_addr(("127.0.0.1", b.port))
                await asyncio.sleep(2 * 1.5)
                assert a.peer_count() == 0 and b.peer_count() == 0
            finally:
                await stop_all((a, b))

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestAddrHygiene:
    """One peer repeatedly sending ADDR frames could flush the
    whole bounded book (an eclipse vector).  Tried addresses (handshake-
    verified) now live beyond gossip's reach, and unsolicited ADDR is
    budgeted per peer."""

    def test_flood_cannot_flush_tried_and_is_budgeted(self):
        async def scenario():
            from p1_tpu_torch.core.genesis import make_genesis
            from test_torch_node import DIFF

            b = Node(_config())
            await b.start()
            a = Node(_config(peers=[f"127.0.0.1:{b.port}"]))
            await a.start()
            try:
                assert await wait_until(lambda: a.peer_count() == 1)
                tried_before = set(a._tried_addrs)
                assert tried_before  # B's handshake promoted it
                # Raw attacker completes HELLO, then streams far more
                # ADDR entries than its budget allows.
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", a.port
                )
                gh = make_genesis(DIFF).block_hash()
                await protocol.write_frame(
                    writer, protocol.encode_hello(Hello(gh, 0, 0, 999))
                )
                for burst in range(20):
                    addrs = [
                        (f"10.9.{burst}.{i}", 7000 + i) for i in range(64)
                    ]
                    await protocol.write_frame(
                        writer, protocol.encode_addr(addrs)
                    )
                await asyncio.sleep(0.5)  # let the frames dispatch
                # Tried bucket untouched; gossip book holds at most the
                # attacker's token budget, not the full 1280 streamed.
                # Budget on localhost: the base burst (64) + the one
                # solicited grant issued to 127.0.0.1 when A dialed B —
                # the attacker shares its victim's host here, a test-
                # topology artifact; on distinct hosts it gets 64.
                assert tried_before <= set(a._tried_addrs)
                flood_learned = sum(
                    1 for (h, _p) in a._known_addrs if h.startswith("10.9.")
                )
                assert flood_learned <= 130
                writer.close()
            finally:
                await a.stop()
                await b.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestMisconfigurationIsNotHostility:
    """Three wallet invocations with the wrong --difficulty once
    banned 127.0.0.1 for every peer, including a whole localhost mesh.
    Wrong-chain/version HELLOs now disconnect without scoring."""

    def test_wrong_chain_hellos_never_ban(self):
        async def scenario():
            from p1_tpu_torch.core.genesis import make_genesis
            from test_torch_node import DIFF

            node = Node(_config())
            await node.start()
            try:
                wrong = make_genesis(DIFF + 1).block_hash()
                for _ in range(4):
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", node.port
                    )
                    await protocol.write_frame(
                        writer, protocol.encode_hello(Hello(wrong, 0, 0, 0))
                    )
                    await reader.read()  # node HELLOs then hangs up
                    writer.close()
                assert "127.0.0.1" not in node._banned_until
                assert not node._violations.get("127.0.0.1")
                # Loopback service uninterrupted for correctly configured
                # clients.
                right = make_genesis(DIFF).block_hash()
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", node.port
                )
                await protocol.write_frame(
                    writer, protocol.encode_hello(Hello(right, 0, 0, 0))
                )
                mtype, _ = protocol.decode(await protocol.read_frame(reader))
                assert mtype is MsgType.HELLO
                assert await wait_until(lambda: node.peer_count() == 1)
                writer.close()
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))


class TestAddrBudgetPerHost:
    """Hardening: the ADDR budget keys on the HOST, so
    reconnecting cannot mint fresh budgets, and inbound HELLO port
    claims never reach the tried bucket."""

    async def _hello_socket(self, port, nonce, listen_port=7777):
        from p1_tpu_torch.core.genesis import make_genesis
        from test_torch_node import DIFF

        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        gh = make_genesis(DIFF).block_hash()
        await protocol.write_frame(
            writer,
            protocol.encode_hello(Hello(gh, 0, listen_port, nonce)),
        )
        mtype, _ = protocol.decode(await protocol.read_frame(reader))
        assert mtype is MsgType.HELLO
        return reader, writer

    def test_reconnects_do_not_refresh_budget(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                for round_ in range(5):
                    r, w = await self._hello_socket(node.port, 400 + round_)
                    addrs = [
                        (f"10.7.{round_}.{i}", 7000 + i) for i in range(64)
                    ]
                    await protocol.write_frame(w, protocol.encode_addr(addrs))
                    await asyncio.sleep(0.1)
                    w.close()
                flood = sum(
                    1
                    for (h, _p) in node._known_addrs
                    if h.startswith("10.7.")
                )
                # One host = one budget: ~64 entries + the trickle refill
                # across the run, not 5 * 64.
                assert flood <= 70, flood
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_inbound_port_claim_never_tried(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                r, w = await self._hello_socket(node.port, 500)
                assert await wait_until(lambda: node.peer_count() == 1)
                # The claimed (127.0.0.1, 7777) lands in the gossip book
                # only; tried stays empty (we never dialed anything).
                assert ("127.0.0.1", 7777) in node._known_addrs
                assert not node._tried_addrs
                w.close()
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_hello_port_claims_are_budgeted(self):
        """A reconnect loop claiming a fresh listen port per HELLO is an
        ADDR flood spelled differently — it must draw from the same
        per-host budget."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                # Burn the host's token budget with one full ADDR frame.
                r, w = await self._hello_socket(node.port, 600)
                await protocol.write_frame(
                    w,
                    protocol.encode_addr(
                        [(f"10.8.0.{i}", 7000 + i) for i in range(64)]
                    ),
                )
                await asyncio.sleep(0.2)
                w.close()
                # Rotating port claims on fresh connections: each learned
                # claim costs a token the host no longer has.
                for i in range(10):
                    r, w = await self._hello_socket(
                        node.port, 601 + i, listen_port=8000 + i
                    )
                    await asyncio.sleep(0.02)
                    w.close()
                claimed = sum(
                    1
                    for (h, p) in node._known_addrs
                    if h == "127.0.0.1" and 8000 <= p < 8010
                )
                assert claimed <= 2, claimed  # refill trickle at most
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))

    def test_overflow_prune_keeps_granted_solicited_credit(self, monkeypatch):
        """A regression: the MAX_TRACKED_HOSTS overflow prune
        kept only buckets `fresh AND below the base cap`, which dropped
        exactly the buckets holding ABOVE-cap solicited-reply credit —
        so an address-cycling flood arriving right after our own GETADDR
        grant could reset an outbound peer's budget mid-reply and
        silently ignore part of an ADDR answer we asked for.  The prune
        must drop only stale buckets sitting at exactly the base refill
        (provably stateless) and keep grant credit intact."""
        from p1_tpu_torch.node import node as node_mod

        monkeypatch.setattr(node_mod, "MAX_TRACKED_HOSTS", 4)
        n = Node(_config())
        # An outbound peer we just solicited: grant stacks a reply's
        # credit on top of the base bucket (above the cap).
        n._addr_budget("10.9.0.1")
        n._addr_budget("10.9.0.1", grant=True)
        granted = n._addr_budgets["10.9.0.1"][0]
        assert granted > node_mod.ADDR_TOKENS_MAX
        # Stale, untouched buckets — the prunable kind.
        import time as _time

        for i in range(3):
            n._addr_budget(f"10.9.1.{i}")
            n._addr_budgets[f"10.9.1.{i}"][1] = _time.monotonic() - 1e4
        # A new host pushes the table past the cap and triggers the prune.
        n._addr_budget("10.9.2.99")
        assert "10.9.0.1" in n._addr_budgets, "granted bucket was pruned"
        assert n._addr_budgets["10.9.0.1"][0] == granted
        assert all(
            f"10.9.1.{i}" not in n._addr_budgets for i in range(3)
        ), "stale base-cap buckets should be the ones dropped"

    def test_tried_survives_one_failed_dial_as_rumor(self):
        """A tried (handshake-verified) address whose node is briefly
        down is demoted to the gossip book on a failed dial — not erased,
        which is exactly what an eclipse attacker would want."""

        async def scenario():
            node = Node(_config(target_peers=1))
            await node.start()
            try:
                addr = ("127.0.0.1", 1)  # nothing listens there
                node._learn_addr(addr, tried=True)
                assert await wait_until(
                    lambda: addr not in node._tried_addrs, timeout=15
                )
                # Demoted to rumor status (the next failed dial may
                # forget it for good — one survival is the guarantee).
                assert addr in node._known_addrs
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
