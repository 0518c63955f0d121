"""The port's peer liveness layer against the JAX package's.

Mirrors tests/test_liveness.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.

Peer liveness layer: PING/PONG keepalive, handshake + idle deadlines,
slot recovery.

The attack this layer closes: a socket that completes
HELLO and then merely keeps reading held one of the MAX_PEERS slots
forever (the only prior eviction path was a *send* timeout, which a
reading-but-silent peer never trips), and a socket that never sent HELLO
grew ``_sessions`` without bound.  These tests drive real Nodes with raw
sockets playing the silent attacker and assert the deadlines actually
fire, the slots actually recover, and honest chatter is never penalized.
"""

import asyncio
import time

import pytest

from test_torch_node import CHUNK, DIFF, run, wait_until

from torch_testutil import NodeConfig
from p1_tpu_torch.core.genesis import make_genesis
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.protocol import Hello, MsgType, ProtocolError


def _config(peers=(), **kw) -> NodeConfig:
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("mine", False)
    # Snappy deadlines so the suite doesn't sit through Bitcoin-scale
    # minutes; the production defaults differ only in magnitude.
    kw.setdefault("handshake_timeout_s", 0.3)
    kw.setdefault("ping_interval_s", 0.25)
    kw.setdefault("pong_timeout_s", 0.25)
    return NodeConfig(peers=tuple(peers), **kw)


async def raw_hello(port: int, nonce: int):
    """A bare socket that completes the HELLO exchange like a node and
    then does whatever the test says — the adversary's half of the
    handshake, without any of Node's liveness reflexes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    genesis_hash = make_genesis(DIFF).block_hash()
    await protocol.write_frame(
        writer, protocol.encode_hello(Hello(genesis_hash, 0, 0, nonce))
    )
    mtype, _ = protocol.decode(await protocol.read_frame(reader))
    assert mtype is MsgType.HELLO
    return reader, writer


async def read_types_until_eof(reader) -> list:
    """Drain frames (the reading-but-silent attacker) until the node
    hangs up; returns the message types seen."""
    types = []
    try:
        while True:
            mtype, _ = protocol.decode(await protocol.read_frame(reader))
            types.append(mtype)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return types


class TestCodec:
    def test_ping_pong_round_trip(self):
        for enc, mtype in (
            (protocol.encode_ping, MsgType.PING),
            (protocol.encode_pong, MsgType.PONG),
        ):
            got_type, got_nonce = protocol.decode(enc(0xDEADBEEF12345678))
            assert got_type is mtype
            assert got_nonce == 0xDEADBEEF12345678

    def test_bad_ping_size_is_violation(self):
        with pytest.raises(ProtocolError):
            protocol.decode(bytes([MsgType.PING]) + b"\x00" * 7)
        with pytest.raises(ProtocolError):
            protocol.decode(bytes([MsgType.PONG]) + b"\x00" * 9)


class TestIdleEviction:
    def test_silent_after_hello_probed_then_evicted(self):
        """The verdict's exact attack: HELLO then silence while reading.
        The node must probe with a PING and, absent any reply, evict
        within ping_interval + pong_timeout — not hold the slot forever."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=101)
                assert await wait_until(lambda: node.peer_count() == 1)
                types = await asyncio.wait_for(
                    read_types_until_eof(reader), timeout=30
                )
                # The wall-clock half of this property ("within interval
                # + probe, not forever") lives on the injectable clock
                # now (TestDeliveryBudgetClock) — under full-suite load
                # the only thing a real-time bound here measured was the
                # CI box.  The behavioral half stays: probed first, then
                # evicted, never scored.
                assert MsgType.PING in types  # probed before sentencing
                assert await wait_until(lambda: node.peer_count() == 0)
                assert not node._violations and not node._banned_until
                writer.close()
            finally:
                await node.stop()

        run(scenario())

    def test_any_frame_resets_probe(self):
        """A peer that keeps talking (here: periodic GETADDR) must never
        be evicted, even if it never answers a PING explicitly.

        Deflake note: the old fixed-cadence sleep loop (0.12 s
        chatter vs a 0.5 s eviction deadline) silently depended on the
        event loop scheduling every iteration on time — under full-suite
        load one 0.5 s stall between writes evicted the peer and failed
        the test for keeping its own promise.  The loop now measures the
        gap it actually achieved and only asserts survival when the
        chatter cadence it was responsible for actually held; a run
        whose own writes stalled past the deadline retries."""

        async def scenario() -> bool:
            node = Node(_config())
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=102)
                assert await wait_until(lambda: node.peer_count() == 1)
                drainer = asyncio.create_task(read_types_until_eof(reader))
                deadline = 0.25 + 0.25  # ping_interval + pong_timeout
                max_gap, last = 0.0, time.monotonic()
                for _ in range(12):
                    await protocol.write_frame(
                        writer, protocol.encode_getaddr()
                    )
                    now = time.monotonic()
                    max_gap = max(max_gap, now - last)
                    last = now
                    await asyncio.sleep(0.1)
                if max_gap >= deadline * 0.8:
                    return False  # cadence broken by host load: retry
                assert node.peer_count() == 1  # still welcome
                drainer.cancel()
                writer.close()
                return True
            finally:
                await node.stop()

        for _ in range(3):
            if run(scenario()):
                return
        pytest.fail("could not hold chatter cadence in 3 attempts")

    def test_slow_trickle_is_liveness_not_silence(self):
        """A peer delivering ONE frame byte-by-byte, slower than the idle
        interval per byte-gap but inside the frame's delivery budget
        (grace + size/MIN_FRAME_RATE), is alive — byte-level progress must
        reset the probe, and a cancelled mid-frame read must not desync
        the stream into a phantom protocol violation (so: no eviction AND
        no misbehavior score).

        The budget ARITHMETIC is pinned on an injectable clock in
        TestDeliveryBudgetClock; this socket test keeps a wide real-time
        budget (grace ≈ 3.15 s vs ~1 s of trickle) and verifies only the
        wiring, so host load cannot push an honest trickle over the
        deadline it is proving safe."""

        async def scenario() -> bool:
            # grace = 0.15 + 3.0 = 3.15s; the 5-byte frame below arrives
            # over ~0.8s — far inside budget, while every 0.15s idle
            # timeout fires mid-frame and must take the progressed()
            # exemption.
            node = Node(_config(ping_interval_s=0.15, pong_timeout_s=3.0))
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=103)
                assert await wait_until(lambda: node.peer_count() == 1)
                drainer = asyncio.create_task(read_types_until_eof(reader))
                # One GETADDR frame (4-byte length + 1-byte type), a byte
                # every 0.2s vs the 0.15s probe interval.
                frame = b"\x00\x00\x00\x01" + bytes(
                    [protocol.MsgType.GETADDR]
                )
                t0 = time.monotonic()
                for b in frame:
                    writer.write(bytes([b]))
                    await writer.drain()
                    await asyncio.sleep(0.2)
                if time.monotonic() - t0 >= 3.0:
                    return False  # host load blew the budget: retry
                assert node.peer_count() == 1  # never evicted
                assert not node._violations  # and never scored
                drainer.cancel()
                writer.close()
                return True
            finally:
                await node.stop()

        for _ in range(3):
            if run(scenario()):
                return
        pytest.fail("could not deliver the trickle inside budget")

    def test_endless_trickle_is_bounded(self):
        """The counter-attack to byte-level liveness: a peer promising a
        100-byte body and trickling bytes forever at one per probe
        interval must NOT hold its slot past the frame's delivery budget
        — evicted as a liveness reap, never scored as a violation."""

        async def scenario():
            # Budget: (0.15 + 0.2) grace + 100/10000 ≈ 0.36s; the trickle
            # below would take ~20s to finish the frame.
            node = Node(_config(ping_interval_s=0.15, pong_timeout_s=0.2))
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=105)
                assert await wait_until(lambda: node.peer_count() == 1)
                drainer = asyncio.create_task(read_types_until_eof(reader))
                writer.write(b"\x00\x00\x00\x64")  # 100-byte body promised
                await writer.drain()
                t0 = time.monotonic()
                evicted = False
                for _ in range(100):
                    try:
                        writer.write(b"\x55")
                        await writer.drain()
                    except (ConnectionError, OSError):
                        evicted = True
                        break
                    if node.peer_count() == 0:
                        evicted = True
                        break
                    await asyncio.sleep(0.14)
                assert evicted
                # Bounded, not the ~20 s the full trickle would take.
                # Wide margin: the precise budget (~0.36 s) is pinned on
                # the injectable clock (TestDeliveryBudgetClock); this
                # bound only distinguishes "reaped" from "waited out".
                assert time.monotonic() - t0 < 12.0
                assert not node._violations and not node._banned_until
                drainer.cancel()
                writer.close()
            finally:
                await node.stop()

        run(scenario())

    def test_midframe_stall_still_evicted_without_ban(self):
        """A length prefix promising a body that never comes: the probe
        must still evict once progress stops — but as a liveness reap,
        never as a scorable protocol violation."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=104)
                assert await wait_until(lambda: node.peer_count() == 1)
                writer.write(b"\x00\x00\x00\x64")  # 100-byte body promised
                await writer.drain()
                types = await asyncio.wait_for(
                    read_types_until_eof(reader), timeout=10
                )
                assert MsgType.PING in types
                assert await wait_until(lambda: node.peer_count() == 0)
                assert not node._violations and not node._banned_until
                writer.close()
            finally:
                await node.stop()

        run(scenario())

    def test_two_real_nodes_keep_each_other_alive(self):
        """Mutual keepalive: two idle nodes with tiny intervals stay
        connected through many probe cycles — the PONG path works."""

        async def scenario():
            a = Node(_config())
            await a.start()
            b = Node(_config(peers=[f"127.0.0.1:{a.port}"]))
            await b.start()
            try:
                assert await wait_until(
                    lambda: a.peer_count() == 1 and b.peer_count() == 1
                )
                await asyncio.sleep(1.5)  # ~6 idle intervals
                assert a.peer_count() == 1 and b.peer_count() == 1
            finally:
                await b.stop()
                await a.stop()

        run(scenario())


class TestHandshakeDeadline:
    def test_never_hello_socket_reaped(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", node.port
                )
                t0 = time.monotonic()
                types = await asyncio.wait_for(
                    read_types_until_eof(reader), timeout=10
                )
                assert types == [MsgType.HELLO]  # their half, then hangup
                # Wide real-time margin (deadline 0.3 s): "reaped, not
                # held forever" — the deadline precision itself is not a
                # wall-clock property this suite can measure under load.
                assert time.monotonic() - t0 < 12.0
                assert await wait_until(lambda: node._handshaking == 0)
                assert node.peer_count() == 0
                writer.close()
            finally:
                await node.stop()

        run(scenario())

    def test_prehandshake_session_cap(self):
        """More simultaneous no-HELLO sockets than MAX_HANDSHAKING: the
        excess is closed on accept (no session task), the rest die at the
        handshake deadline, and the counter returns to zero."""

        async def scenario():
            from p1_tpu_torch.node import node as node_mod

            node = Node(_config(handshake_timeout_s=1.0))
            await node.start()
            try:
                conns = []
                for _ in range(node_mod.MAX_HANDSHAKING + 8):
                    conns.append(
                        await asyncio.open_connection("127.0.0.1", node.port)
                    )
                await asyncio.sleep(0.2)  # let accepts land
                assert node._handshaking <= node_mod.MAX_HANDSHAKING
                # Every socket — capped-out and timed-out alike — sees EOF.
                results = await asyncio.wait_for(
                    asyncio.gather(
                        *(read_types_until_eof(r) for r, _ in conns)
                    ),
                    timeout=15,
                )
                over_cap = sum(1 for t in results if t == [])
                assert over_cap >= 8  # the excess never even got a HELLO
                assert await wait_until(lambda: node._handshaking == 0)
                for _, w in conns:
                    w.close()
            finally:
                await node.stop()

        run(scenario())


class TestSlotRecovery:
    def test_max_peers_slots_recover_after_eviction(self, monkeypatch):
        """Fill MAX_PEERS with silent sockets: a real node is refused;
        after the idle evictions it connects fine — the slots provably
        recycle instead of being pinned by dead weight."""
        from p1_tpu_torch.node import node as node_mod

        monkeypatch.setattr(node_mod, "MAX_PEERS", 2)

        async def scenario():
            victim = Node(_config())
            await victim.start()
            drains = []
            try:
                socks = [
                    await raw_hello(victim.port, nonce=200 + i)
                    for i in range(2)
                ]
                assert await wait_until(lambda: victim.peer_count() == 2)
                # Keep the attackers' read sides flowing (the verdict's
                # reading-but-silent profile) without answering probes.
                drains = [
                    asyncio.create_task(read_types_until_eof(r))
                    for r, _ in socks
                ]
                # A third HELLO is refused at the cap while both slots
                # are held.
                with pytest.raises(
                    (asyncio.IncompleteReadError, ConnectionError)
                ):
                    r3, w3 = await raw_hello(victim.port, nonce=300)
                    await protocol.read_frame(r3)  # node hangs up
                # The idle deadline reaps both attackers...
                assert await wait_until(lambda: victim.peer_count() == 0)
                # ...and a real node then takes a recovered slot.
                joiner = Node(
                    _config(peers=[f"127.0.0.1:{victim.port}"])
                )
                await joiner.start()
                try:
                    assert await wait_until(
                        lambda: victim.peer_count() == 1
                        and joiner.peer_count() == 1
                    )
                finally:
                    await joiner.stop()
                for _, w in socks:
                    w.close()
            finally:
                for d in drains:
                    d.cancel()
                await victim.stop()

        run(scenario())


class TestFrameReaderFuzz:
    """Property test for the cancellation-tolerant reader: any frame
    stream, delivered in any chunking, with reads cancelled at any
    moment, must come out byte-identical — the desync this class exists
    to prevent (a cancelled plain read_frame between length prefix and
    body shifts the stream and fabricates protocol violations)."""

    def test_random_chunking_and_cancellation_never_desyncs(self):
        import random

        async def scenario(seed: int):
            # Separate streams per side: the server and client draw
            # concurrently, and a shared rng would make the run depend
            # on asyncio timing — an unreproducible "seeded" test.
            rng = random.Random(seed)
            srv_rng = random.Random(seed ^ 0x5EED)
            frames = [
                rng.randbytes(rng.choice((0, 1, 4, 17, 200, 5000)))
                for _ in range(40)
            ]
            wire = b"".join(
                len(f).to_bytes(4, "big") + f for f in frames
            )

            async def serve(reader, writer):
                # Trickle the exact byte stream in random chunks with
                # random pauses, then EOF.
                off = 0
                while off < len(wire):
                    n = srv_rng.randrange(1, 64)
                    writer.write(wire[off : off + n])
                    off += n
                    await writer.drain()
                    if srv_rng.random() < 0.3:
                        await asyncio.sleep(0.001)
                writer.close()

            server = await asyncio.start_server(serve, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            frames_out = []
            fr = protocol.FrameReader(reader)
            while len(frames_out) < len(frames):
                # Random aggressive timeouts: most reads get cancelled
                # mid-frame at least once.
                try:
                    payload = await asyncio.wait_for(
                        fr.read(), timeout=rng.choice((0.0005, 0.002, 0.5))
                    )
                except (TimeoutError, asyncio.TimeoutError):
                    # Both spellings: only unified in Python 3.11.
                    continue  # retry exactly as the session loop does
                frames_out.append(payload)
            assert frames_out == frames  # byte-identical, in order
            writer.close()
            server.close()
            await server.wait_closed()

        for seed in range(8):
            run(scenario(seed))


class TestLivenessMetrics:
    def test_probe_and_eviction_counted(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                reader, writer = await raw_hello(node.port, nonce=700)
                assert await wait_until(lambda: node.peer_count() == 1)
                await asyncio.wait_for(
                    read_types_until_eof(reader), timeout=10
                )
                assert node.metrics.pings_sent >= 1
                assert node.metrics.peers_evicted_idle == 1
                assert node.status()["liveness"] == {
                    "pings_sent": node.metrics.pings_sent,
                    "peers_evicted_idle": 1,
                }
                writer.close()
            finally:
                await node.stop()

        run(scenario())


class TestDeliveryBudgetClock:
    """The frame delivery-budget math on an INJECTABLE clock (the
    deflake, the ``test_governor.py`` pattern): the socket tests above
    verify the wiring with wide real-time margins; the precise timing
    semantics — what used to be asserted against wall clocks and flaked
    under full-suite load — are pinned here without one real sleep."""

    class _Clock:
        def __init__(self, t: float = 100.0):
            self.t = t

        def __call__(self) -> float:
            return self.t

    def _feed(self, clock):
        sr = asyncio.StreamReader()
        return sr, protocol.FrameReader(sr, clock=clock)

    @staticmethod
    async def _pump(fr):
        """Drive one read attempt: consume whatever bytes are buffered,
        then give up — exactly the cancelled-mid-frame shape the session
        loop's wait_for produces."""
        try:
            return await asyncio.wait_for(fr.read(), timeout=0.02)
        except (TimeoutError, asyncio.TimeoutError):
            return None

    def test_idle_reader_is_never_overdue(self):
        async def scenario():
            clock = self._Clock()
            _, fr = self._feed(clock)
            clock.t += 1e9  # arbitrarily far in the future
            assert not fr.overdue(grace=0.0)  # no frame in progress

        run(scenario())

    def test_budget_scales_with_promised_size(self):
        """budget = grace + promised/MIN_FRAME_RATE, from the first byte
        of the frame — the exact arithmetic the probe loop trusts."""

        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            # Promise a 50_000-byte body; deliver nothing more.
            sr.feed_data((50_000).to_bytes(4, "big"))
            assert await self._pump(fr) is None
            budget = 0.5 + 50_000 / protocol.MIN_FRAME_RATE  # = 5.5s
            clock.t += budget - 0.01
            assert not fr.overdue(grace=0.5)  # inside budget: alive
            clock.t += 0.02
            assert fr.overdue(grace=0.5)  # past it: reap

        run(scenario())

    def test_prefix_only_uses_minimum_budget(self):
        """Before the length prefix completes, the promise is unknown —
        the budget is grace + 4/MIN_FRAME_RATE, nothing more (a peer
        cannot buy time by never finishing the prefix)."""

        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            sr.feed_data(b"\x00\x00")  # half a length prefix
            assert await self._pump(fr) is None
            clock.t += 0.5 + 4 / protocol.MIN_FRAME_RATE + 0.01
            assert fr.overdue(grace=0.5)

        run(scenario())

    def test_completed_frame_clears_the_budget(self):
        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            sr.feed_data(b"\x00\x00\x00\x01")
            assert await self._pump(fr) is None
            sr.feed_data(b"\xaa")
            assert await self._pump(fr) == b"\xaa"
            clock.t += 1e9
            assert not fr.overdue(grace=0.0)  # no frame in progress again

        run(scenario())

    def test_progress_flag_consumed_and_reset_by_completion(self):
        """progressed() reports partial bytes since the last look, is
        consumed by reading it, and a COMPLETED frame does not leave a
        stale progress pass for a later silent interval."""

        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            assert not fr.progressed()  # nothing yet
            sr.feed_data(b"\x00\x00")
            assert await self._pump(fr) is None
            assert fr.progressed()  # bytes arrived mid-frame
            assert not fr.progressed()  # consumed
            sr.feed_data(b"\x00\x01\xbb")
            assert await self._pump(fr) == b"\xbb"
            assert not fr.progressed()  # completion wipes the flag

        run(scenario())

    def test_trickle_inside_budget_survives_forever_on_fake_time(self):
        """The slow-trickle socket test, replayed on the fake clock: a
        byte per probe interval with a small promised frame stays inside
        budget at every observation — the exemption the session loop
        grants is justified at each step, not just on average."""

        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            frame = b"\x00\x00\x00\x01" + bytes([MsgType.GETADDR])
            grace = 0.5
            for b in frame[:-1]:
                sr.feed_data(bytes([b]))
                assert await self._pump(fr) is None
                assert fr.progressed()  # byte-level liveness each step
                assert not fr.overdue(grace)
                clock.t += 0.09  # slower than any probe interval here
            sr.feed_data(frame[-1:])
            assert await self._pump(fr) == bytes([MsgType.GETADDR])

        run(scenario())

    def test_endless_trickle_goes_overdue_on_fake_time(self):
        """The counter-attack, on the fake clock: promising 100 bytes
        and trickling one per 'interval' exceeds the delivery budget
        after grace + 100/MIN_FRAME_RATE — progress alone must not be
        a permanent exemption."""

        async def scenario():
            clock = self._Clock()
            sr, fr = self._feed(clock)
            sr.feed_data((100).to_bytes(4, "big"))
            assert await self._pump(fr) is None
            grace = 0.35
            budget = grace + 100 / protocol.MIN_FRAME_RATE
            fed = 0.0
            while fed <= budget:
                sr.feed_data(b"\x55")
                assert await self._pump(fr) is None
                clock.t += 0.14
                fed += 0.14
            assert fr.progressed()  # still technically progressing...
            assert fr.overdue(grace)  # ...but past its budget: reap

        run(scenario())
