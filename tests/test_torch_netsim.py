"""The port's network simulator (``node/netsim.py``) against the JAX package's.

Mirrors tests/test_netsim.py: the reference's cases, run against
``p1_tpu_torch`` with ``SimNet(device="cpu")`` (hashlib sealing, the
``device`` signature rung's plain version).

The discrete-event network simulator: virtual time, link models,
the transport seam, and the byte-identical-trace determinism contract.

Companion of tests/test_scenarios.py (which runs the corpus): this file
pins the SUBSTRATE — that virtual time costs no wall time, that the
latency/jitter/bandwidth/FIFO/partition link semantics hold, that the
socket transport behind the same seam still moves real bytes, and the
acceptance-criterion determinism proof: two runs of the same scenario
with the same seed produce byte-identical event traces, and the
migrated sync-stall failover case (the flagship socket test)
reproduces its invariants exactly under the simulator.
"""

import asyncio
import time

import pytest

from p1_tpu_torch.node.netsim import (
    LinkProfile,
    SimLoop,
    SimNet,
    SimTransport,
    VirtualClock,
)
from p1_tpu_torch.node.transport import SocketTransport


def sim_run(coro, clock=None):
    """Run one coroutine on a fresh SimLoop (bare-substrate tests)."""
    loop = SimLoop(clock if clock is not None else VirtualClock())
    asyncio.set_event_loop(loop)
    try:
        return loop.run_until_complete(coro)
    finally:
        asyncio.set_event_loop(None)
        loop.close()


class TestVirtualTime:
    def test_long_sleeps_cost_no_wall_time(self):
        clock = VirtualClock()

        async def main():
            await asyncio.sleep(3600.0)
            return clock.now

        t0 = time.monotonic()
        assert sim_run(main(), clock) == pytest.approx(3600.0)
        assert time.monotonic() - t0 < 2.0  # an hour for (almost) free

    def test_wait_for_times_out_at_the_virtual_deadline(self):
        clock = VirtualClock()

        async def main():
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(asyncio.Event().wait(), timeout=120.0)
            return clock.now

        assert sim_run(main(), clock) == pytest.approx(120.0)

    def test_timers_fire_in_virtual_order(self):
        clock = VirtualClock()
        fired = []

        async def stamp(delay, tag):
            await asyncio.sleep(delay)
            fired.append((tag, clock.now))

        async def main():
            # Scheduled out of order on purpose.
            await asyncio.gather(
                stamp(5.0, "c"), stamp(0.5, "a"), stamp(2.0, "b")
            )

        sim_run(main(), clock)
        assert [t for t, _ in fired] == ["a", "b", "c"]
        assert [round(at, 3) for _, at in fired] == [0.5, 2.0, 5.0]

    def test_virtual_wall_clock_tracks_monotonic(self):
        clock = VirtualClock()
        w0 = clock.wall()

        async def main():
            await asyncio.sleep(7.0)

        sim_run(main(), clock)
        assert clock.wall() - w0 == pytest.approx(7.0)


class _Echo:
    """Tiny accept handler: records payloads, echoes nothing."""

    def __init__(self):
        self.got = []
        self.eof = asyncio.Event()

    async def __call__(self, reader, writer):
        while True:
            data = await reader.read(4096)
            if not data:
                self.eof.set()
                return
            self.got.append((asyncio.get_running_loop().time(), data))


class TestSimLinks:
    def _net(self, **kw):
        clock = VirtualClock()
        return clock, SimTransport(clock, seed=1, **kw)

    def test_latency_delays_delivery(self):
        clock, net = self._net(
            default_profile=LinkProfile(latency_s=0.250)
        )

        async def main():
            sink = _Echo()
            lst = await net.host("b").listen(sink, "b", 0)
            _r, w = await net.host("a").connect("b", lst.port)
            t_send = clock.now
            w.write(b"ping")
            await w.drain()
            await asyncio.sleep(1.0)
            assert [d for _, d in sink.got] == [b"ping"]
            arrival = sink.got[0][0]
            assert arrival - t_send == pytest.approx(0.250)

        sim_run(main(), clock)

    def test_fifo_holds_under_jitter(self):
        clock, net = self._net(
            default_profile=LinkProfile(latency_s=0.01, jitter_s=0.5)
        )

        async def main():
            sink = _Echo()
            lst = await net.host("b").listen(sink, "b", 0)
            _r, w = await net.host("a").connect("b", lst.port)
            for i in range(20):
                w.write(bytes([i]))
            await asyncio.sleep(30.0)
            received = b"".join(d for _, d in sink.got)
            assert received == bytes(range(20))  # jitter never reorders
            stamps = [t for t, _ in sink.got]
            assert stamps == sorted(stamps)

        sim_run(main(), clock)

    def test_bandwidth_shapes_throughput(self):
        # 1 Mb/s: a 1 MB payload needs ~8 virtual seconds on the wire.
        clock, net = self._net(
            default_profile=LinkProfile(latency_s=0.0, bandwidth_bps=1e6)
        )

        async def main():
            sink = _Echo()
            lst = await net.host("b").listen(sink, "b", 0)
            _r, w = await net.host("a").connect("b", lst.port)
            t0 = clock.now
            w.write(bytes(1_000_000))
            await asyncio.sleep(60.0)
            assert sum(len(d) for _, d in sink.got) == 1_000_000
            assert sink.got[-1][0] - t0 == pytest.approx(8.0, rel=0.01)

        sim_run(main(), clock)

    def test_loss_adds_retransmit_delay_but_delivers(self):
        clock, lossy = self._net(
            default_profile=LinkProfile(latency_s=0.05, loss=0.5)
        )

        async def main():
            sink = _Echo()
            lst = await lossy.host("b").listen(sink, "b", 0)
            _r, w = await lossy.host("a").connect("b", lst.port)
            t0 = clock.now
            for _ in range(50):
                w.write(b"x")
            await asyncio.sleep(120.0)
            # Reliable stream: every chunk arrives...
            assert sum(len(d) for _, d in sink.got) == 50
            # ...but the loss model cost real (virtual) tail latency
            # beyond the bare 0.05 s latency floor.
            assert sink.got[-1][0] - t0 > 0.1

        sim_run(main(), clock)

    def test_partition_severs_and_refuses_then_heals(self):
        clock, net = self._net(
            default_profile=LinkProfile(latency_s=0.001)
        )

        async def main():
            sink = _Echo()
            lst = await net.host("b").listen(sink, "b", 0)
            reader, w = await net.host("a").connect("b", lst.port)
            w.write(b"pre")
            await asyncio.sleep(0.1)
            net.partition({"a"}, {"b"})
            # The live connection died: our read side sees EOF...
            assert await asyncio.wait_for(reader.read(100), 1.0) == b""
            await asyncio.sleep(0.01)
            assert sink.eof.is_set()
            # ...and new dials are refused while the cut holds.
            with pytest.raises(ConnectionRefusedError):
                await net.host("a").connect("b", lst.port)
            net.heal()
            _r2, w2 = await net.host("a").connect("b", lst.port)
            w2.write(b"post")
            await asyncio.sleep(0.1)
            assert [d for _, d in sink.got] == [b"pre", b"post"]

        sim_run(main(), clock)

    def test_asymmetric_profiles_apply_per_direction(self):
        clock, net = self._net()
        net.set_profile(
            "a", "b", LinkProfile(latency_s=0.300), symmetric=False
        )
        net.set_profile(
            "b", "a", LinkProfile(latency_s=0.010), symmetric=False
        )

        async def main():
            class EchoBack:
                async def __call__(self, reader, writer):
                    data = await reader.read(4096)
                    writer.write(data)

            lst = await net.host("b").listen(EchoBack(), "b", 0)
            reader, w = await net.host("a").connect("b", lst.port)
            t0 = clock.now
            w.write(b"rt")
            echoed = await reader.read(4096)
            assert echoed == b"rt"
            # One slow leg + one fast leg, not two of either.
            assert clock.now - t0 == pytest.approx(0.310, abs=0.02)

        sim_run(main(), clock)

    def test_write_buffer_gauge_tracks_bytes_in_flight(self):
        clock, net = self._net(
            default_profile=LinkProfile(latency_s=1.0)
        )

        async def main():
            sink = _Echo()
            lst = await net.host("b").listen(sink, "b", 0)
            _r, w = await net.host("a").connect("b", lst.port)
            w.write(bytes(5000))
            assert w.transport.get_write_buffer_size() == 5000
            await asyncio.sleep(2.0)
            assert w.transport.get_write_buffer_size() == 0

        sim_run(main(), clock)


class TestSocketSeam:
    """The default transport still moves real bytes — the seam itself
    must never change socket-path behavior (the whole pre-existing
    node/byzantine/syncfault suites are the deep proof; this is the
    direct one)."""

    def test_listen_connect_roundtrip(self):
        async def main():
            got = asyncio.Queue()

            async def on_conn(reader, writer):
                got.put_nowait(await reader.readexactly(5))
                writer.write(b"world")
                await writer.drain()
                writer.close()

            transport = SocketTransport()
            lst = await transport.listen(on_conn, "127.0.0.1", 0)
            assert lst.port > 0
            reader, writer = await transport.connect("127.0.0.1", lst.port)
            writer.write(b"hello")
            await writer.drain()
            assert await got.get() == b"hello"
            assert await reader.readexactly(5) == b"world"
            writer.close()
            lst.close()
            await lst.wait_closed()

        asyncio.run(asyncio.wait_for(main(), 10))

    def test_clock_is_the_system_clock(self):
        t = SocketTransport()
        assert abs(t.clock.wall() - time.time()) < 1.0
        assert abs(t.clock.monotonic() - time.monotonic()) < 1.0


class TestDeterminism:
    """Acceptance criterion: same seed => byte-identical event trace."""

    @staticmethod
    def _partition_run(seed):
        from p1_tpu_torch.node.scenarios import partition_heal

        report = partition_heal(
            nodes=16, seed=seed, blocks_major=3, blocks_minor=1, device="cpu"
        )
        # wall_s is the one legitimately nondeterministic field.
        report.pop("wall_s")
        return report

    def test_same_seed_same_trace_and_report(self):
        a = self._partition_run(11)
        b = self._partition_run(11)
        assert a["ok"] and b["ok"]
        assert a["trace_digest"] == b["trace_digest"]
        assert a == b

    def test_different_seed_different_trace(self):
        a = self._partition_run(11)
        c = self._partition_run(12)
        assert a["trace_digest"] != c["trace_digest"]


class TestStallFailoverSim:
    """The migrated flagship (tests/test_syncfault.py's
    ``test_stalling_peer_fails_over_mid_ibd``, socket variant now a
    slow smoke): the only-serving peer swallows GETBLOCKS mid-IBD while
    answering PINGs; the victim must detect the stall, demote without
    banning, fail over, and finish IBD from the second peer — here in
    VIRTUAL time (production-scale 10 s deadlines, milliseconds of
    wall), twice, with identical traces."""

    @staticmethod
    def _run(seed):
        import random

        from p1_tpu_torch.node.protocol import MsgType
        from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

        net = SimNet(seed=seed, difficulty=8, device="cpu")
        chain30 = make_blocks(30, 8)

        async def main():
            staller = HostilePeer(
                chain30,
                plan=FaultPlan(
                    swallow=frozenset({MsgType.GETBLOCKS}),
                    serve_before_fault=1,
                    batch_limit=10,
                ),
                transport=net.net.host("10.8.0.1"),
                host="10.8.0.1",
                rng=random.Random(seed * 3 + 1),
            )
            quiet = HostilePeer(
                chain30,
                plan=FaultPlan(hello_height=0),
                transport=net.net.host("10.8.0.2"),
                host="10.8.0.2",
                rng=random.Random(seed * 3 + 2),
            )
            await staller.start()
            await quiet.start()
            victim = await net.add_node(
                peers=[
                    f"10.8.0.1:{staller.port}",
                    f"10.8.0.2:{quiet.port}",
                ],
                # Production-scale supervision deadlines: virtual time
                # makes them free (the socket variant had to shrink
                # them to keep CI fast — and was flake-prone for it).
                sync_stall_timeout_s=10.0,
            )
            t0 = net.clock.now
            assert await net.run_until(
                lambda: victim.chain.height == 30, 300, wall_limit_s=60
            ), f"IBD pinned at height {victim.chain.height}"
            elapsed_vs = net.clock.now - t0
            m = victim.metrics
            result = {
                "stalls": m.sync_stalls,
                "failovers": m.sync_failovers,
                "demotions": m.sync_demotions,
                "rescued_by_quiet": quiet.requests[MsgType.GETBLOCKS],
                "banned": dict(victim._banned_until),
                "violations": dict(victim._violations),
                "peers": victim.peer_count(),
                "demerited": sum(
                    1
                    for p in victim._peers.values()
                    if p.sync_demerits > 0
                ),
                "elapsed_vs": round(elapsed_vs, 6),
            }
            await net.stop_all()
            await staller.stop()
            await quiet.stop()
            result["digest"] = net.trace_digest()
            return result

        return net.run(main())

    def test_failover_invariants_hold_in_virtual_time(self):
        r = self._run(5)
        assert r["stalls"] >= 1
        assert r["failovers"] >= 1
        assert r["demotions"] >= 1
        assert r["rescued_by_quiet"] >= 1
        # Demoted, never banned.
        assert not r["banned"] and not r["violations"]
        assert r["peers"] == 2
        assert r["demerited"] == 1
        # A stall + jittered backoff + failover at the 10 s production
        # deadline: virtual elapsed must reflect the deadline (no
        # instant magic) yet stay bounded.
        assert 10.0 < r["elapsed_vs"] < 120.0

    def test_failover_run_is_deterministic(self):
        assert self._run(5) == self._run(5)


class TestSimNodeBasics:
    def test_two_sim_nodes_gossip_a_mined_block(self):
        net = SimNet(seed=2, difficulty=8, device="cpu")

        async def main():
            a = await net.add_node()
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            await net.mine_on(a)
            assert await net.run_until(
                lambda: b.chain.height == 1, 30, wall_limit_s=30
            )
            assert net.converged() and net.ledger_conserved()
            # The propagation telemetry rode the virtual wall clock.
            assert b.metrics.propagation_delays_s
            await net.stop_all()

        net.run(main())

    def test_restart_keeps_identity_and_resyncs(self):
        net = SimNet(seed=2, difficulty=8, device="cpu")

        async def main():
            a = await net.add_node()
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            nonce_before = b.instance_nonce
            host_b = net.host_name(1)
            await net.stop_node(host_b)
            await net.mine_on(a, spacing_s=1.0)
            b2 = await net.restart_node(host_b)
            assert b2.instance_nonce == nonce_before  # same identity
            assert await net.run_until(
                lambda: b2.chain.height == 1, 60, wall_limit_s=30
            )
            await net.stop_all()

        net.run(main())
