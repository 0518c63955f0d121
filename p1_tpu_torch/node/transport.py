"""The transport seam: how a node touches the network and the clock.

The thousand-node wall: every harness this repo ever
built — the `p1 net` subprocess mesh, the byzantine soak, HostilePeer /
GreedyPeer — drives REAL sockets through the one shared kernel and the
one shared wall clock, which tops out around seven heavily-loaded nodes
on a 1-vCPU host and couples every liveness/stall deadline to host
scheduling noise.
Bitcoin-Core-lineage systems validate emergent consensus behavior
(partition heal, eclipse resistance, churn) on *simulated* meshes; the
missing primitive here was a seam between the node and its network.

This module is that seam, deliberately small:

- ``Clock`` — ``monotonic()`` (deadlines, rate limits) and ``wall()``
  (block timestamps, propagation telemetry).  ``SystemClock`` is
  ``time.monotonic``/``time.time``; the simulator's ``VirtualClock``
  (node/netsim.py) is a number the event loop advances.  Everything in
  the node that used to read ``time.*`` directly now reads its
  transport's clock — enforced by the wall-clock lint
  (tests/test_simlint.py), so future code stays sim-compatible.
- ``Listener`` — the slice of ``asyncio.Server`` the node actually
  uses: the bound port, ``close()``, ``wait_closed()``.
- ``Transport`` — ``listen()`` + ``connect()`` yielding the standard
  ``(StreamReader, StreamWriter)`` pair.  ``SocketTransport`` delegates
  straight to asyncio (byte-for-byte the historical behavior — the
  whole pre-existing socket suite runs through it unchanged);
  ``SimTransport`` (node/netsim.py) delivers frames through in-memory
  links with latency/jitter/bandwidth models under virtual time.

Sleeps and ``asyncio.wait_for`` deadlines deliberately do NOT go
through the seam: they are already loop-relative (``loop.time()``), and
the simulator virtualizes the loop itself (netsim.SimLoop), so an
``asyncio.sleep(30)`` inside a simulated node costs microseconds of
wall time.  Only *direct* ``time.*`` reads bypass the loop — those are
what the seam (and the lint) exist to catch.

The port's copy of ``p1_tpu/node/transport.py``.
"""

from __future__ import annotations

import asyncio
import time

__all__ = ["Clock", "SystemClock", "Listener", "SocketListener", "Transport", "SocketTransport"]


class Clock:
    """Time source interface: monotonic seconds for deadlines/rates,
    wall seconds for timestamps that cross process boundaries."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def wall(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    """The host's clocks — the blessed home of ``time.monotonic`` /
    ``time.time`` for everything behind the transport seam."""

    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)


class Listener:
    """What the node needs from a listening endpoint."""

    @property
    def port(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    async def wait_closed(self) -> None:
        raise NotImplementedError


class SocketListener(Listener):
    """An ``asyncio.Server`` behind the ``Listener`` surface."""

    def __init__(self, server: asyncio.Server):
        self._server = server

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def close(self) -> None:
        self._server.close()

    async def wait_closed(self) -> None:
        await self._server.wait_closed()


class Transport:
    """How a node (or harness actor) reaches the network.  One instance
    per participant — the simulator binds a source address per handle so
    per-host accounting (bans, ADDR budgets) keeps working."""

    clock: Clock

    async def listen(self, on_conn, host: str, port: int) -> Listener:
        """Bind ``host:port`` (0 = ephemeral) and invoke ``on_conn(reader,
        writer)`` per inbound connection, asyncio.start_server-style."""
        raise NotImplementedError

    async def connect(
        self, host: str, port: int, local_addr: tuple[str, int] | None = None
    ):
        """Dial ``host:port``; returns ``(reader, writer)``.  ``local_addr``
        picks the source address (the loopback-alias trick the byzantine
        suite uses so bans land on the attacker's host)."""
        raise NotImplementedError


class SocketTransport(Transport):
    """The default: real sockets via asyncio, system clocks.  Stateless,
    so one shared instance serves every node in a process."""

    clock = SystemClock()

    async def listen(self, on_conn, host: str, port: int) -> Listener:
        return SocketListener(await asyncio.start_server(on_conn, host, port))

    async def connect(
        self, host: str, port: int, local_addr: tuple[str, int] | None = None
    ):
        return await asyncio.open_connection(host, port, local_addr=local_addr)


#: The process-wide default (stateless — see SocketTransport).
SOCKET_TRANSPORT = SocketTransport()
