"""Deterministic discrete-event network simulator: 1000 nodes, one host.

The scale wall: the repo's harnesses drive real sockets
and real clocks, which tops out around seven heavily-loaded nodes on the
1-vCPU host — and couples every liveness/stall deadline to scheduler
noise, the root cause behind every wall-clock deflake.
Bitcoin-Core-lineage systems validate emergent consensus behavior
(partition heal, eclipse resistance, churn, flash-crowd IBD) on
*simulated* thousand-node meshes.  This module is that substrate,
layered on the transport seam (node/transport.py):

- ``VirtualClock`` — a number.  Nothing sleeps; time IS the event queue.
- ``SimLoop`` — an ordinary asyncio selector loop whose ``time()`` is
  the virtual clock and whose idle step JUMPS the clock to the next
  scheduled timer instead of blocking.  Every ``asyncio.sleep`` /
  ``wait_for`` inside every node is thereby virtualized with zero code
  changes: a 60 s keepalive interval costs microseconds of wall time,
  and a mesh that would need 20 real minutes of gossip settles in
  seconds.
- ``SimTransport`` — the in-memory network.  One ``host(name)`` facade
  per participant (so per-host accounting — bans, ADDR budgets — keeps
  working); per-link ``LinkProfile`` with latency, jitter, bandwidth
  shaping, and loss; FIFO per-link delivery; partitions that sever live
  connections and refuse new ones until ``heal()``.
- ``SimNet`` — the orchestration harness: spawns full ``Node``
  instances (the REAL node — chain, mempool, governor, supervision,
  address book; nothing mocked), drives deterministic block production,
  and runs scenarios to assertable convergence in bounded *virtual*
  time.  With ``store_dir`` set, every node persists to a per-host
  fault-injectable store, and the chaos plane's crash primitives
  apply: ``crash_node`` (abrupt death — severed links, no shutdown
  hooks, a torn in-flight append, a stale mempool checkpoint) and
  ``recover_node`` (reboot through the normal resume path) —
  node/chaos.py composes them with every other injector.

Determinism contract: one seed fixes everything observable.  Node
identity and supervision jitter derive from ``NodeConfig.rng_seed``;
link jitter/loss draw from the sim's own seeded RNG; the loop's timer
heap is deterministic for a deterministic program; and the sim hashes
every network event (connects, per-chunk deliveries with CRC, EOFs,
partitions) into a running SHA-256 — two runs of the same scenario with
the same seed produce byte-identical traces, asserted by
tests/test_netsim.py.  (The contract is per-interpreter: set
``PYTHONHASHSEED`` when comparing traces across processes.)

What the sim does NOT model, honestly (docs/ARCHITECTURE.md): real TCP
backpressure (writes are accepted instantly; ``drain()`` never blocks —
the write-buffer gauge the governor reads is bytes in flight on the
link), kernel buffers and Nagle, OS scheduling and the GIL, packet
loss as actual byte loss (the stream is reliable by construction; the
``loss`` knob models retransmission DELAY spikes instead, which is what
loss does to a TCP stream that survives it), and worker-thread latency
(``run_in_executor`` jobs — the mempool checkpoint's ``to_thread``
write — complete synchronously at the submission instant: a real
thread's completion time is wall-clock state the virtual clock cannot
deterministically place, which the week-long soak proved by
diverging on it).  Real-socket behavior stays covered by the original
suites through ``SocketTransport``.

The port's copy of ``p1_tpu/node/netsim.py``: byte for byte the same
trace and digest for the same seed.  Only ``SimNet``'s sealing differs:
it runs on the card by default (``device``), through the
``sha256d_search.cu`` kernel, whose earliest hit is the hashlib
backend's.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import heapq
import random
import time
import zlib

from p1_tpu_torch.node.transport import Clock, Listener, Transport

__all__ = [
    "LinkProfile",
    "SimLoop",
    "SimNet",
    "SimTransport",
    "SimWallTimeout",
    "VirtualClock",
]

#: Virtual wall-clock anchor (2026-01-01T00:00:00Z): after the genesis
#: timestamp, so simulated nodes assemble sanely-stamped blocks from the
#: first virtual second.
SIM_EPOCH = 1_767_225_600.0

#: Every simulated node listens here; hosts are distinct, so one port
#: serves the whole mesh (and "host:port" peer strings stay readable).
NODE_PORT = 9444

#: Retransmission penalty, in one-way latencies, added per lost
#: "transmission round" (see LinkProfile.loss).
_RETX_PENALTY = 3.0


class SimWallTimeout(RuntimeError):
    """A scenario exceeded its REAL-time budget — a sim bug (livelock at
    constant virtual time), never a legitimate slow run: virtual time is
    free."""


class VirtualClock(Clock):
    """Time as a plain number the event loop advances."""

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def monotonic(self) -> float:
        return self.now

    def wall(self) -> float:
        return SIM_EPOCH + self.now


class SimLoop(asyncio.SelectorEventLoop):
    """A selector loop under virtual time.

    ``time()`` returns the virtual clock, so every timer the program
    creates (``sleep``, ``wait_for``, ``call_later``) is scheduled in
    virtual seconds; when no callback is immediately ready, ``_run_once``
    jumps the clock straight to the earliest timer instead of sleeping —
    the discrete-event step.  The selector is still polled (timeout 0)
    each iteration, so thread-safe wakeups keep working; a pure
    simulation registers no real I/O, so the poll is a no-op.
    """

    def __init__(self, clock: VirtualClock):
        super().__init__()
        self._sim_clock = clock

    def time(self) -> float:
        return self._sim_clock.now

    def run_in_executor(self, executor, func, *args):
        """Worker jobs complete SYNCHRONOUSLY, at the current virtual
        instant.  A real executor's completion lands via
        ``call_soon_threadsafe`` at whatever virtual time the loop has
        jumped to by then — racing REAL thread latency against virtual
        time, so two identical runs resume the awaiting coroutine at
        different virtual instants and every timer downstream shifts.
        The longevity soak caught exactly that: a virtual week
        of 30 s-cadence mempool checkpoints (``asyncio.to_thread`` →
        here) made same-seed traces diverge where 30-virtual-second
        chaos schedules had been too short to trip it.  Running the job
        inline is the only timing a virtual clock can assign it
        deterministically; what the sim gives up — modeling worker
        LATENCY — is recorded in the module docstring's honesty list."""
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except BaseException as e:  # delivered to the awaiter, not lost
            fut.set_exception(e)
        return fut

    def _run_once(self):
        if not self._ready and self._scheduled:
            # Mirror the base loop's cancelled-head sweep so the jump
            # target is a timer that will actually run.
            while self._scheduled and self._scheduled[0]._cancelled:
                self._timer_cancelled_count -= 1
                handle = heapq.heappop(self._scheduled)
                handle._scheduled = False
            if self._scheduled:
                when = self._scheduled[0]._when
                if when > self._sim_clock.now:
                    self._sim_clock.now = when
        super()._run_once()


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """One direction of one link.  Defaults model a fast LAN."""

    #: One-way propagation delay, seconds.
    latency_s: float = 0.001
    #: Uniform extra delay in [0, jitter_s) per chunk, from the sim RNG.
    jitter_s: float = 0.0
    #: Throughput shaping in bits/s (0 = infinite).  Chunks serialize
    #: through the link one after another, so a 8 MB sync reply on a
    #: 10 Mb/s link occupies it for ~6.7 virtual seconds.
    bandwidth_bps: float = 0.0
    #: Per-transmission-round loss probability.  The stream stays
    #: reliable (this is a TCP-like transport): each loss adds a
    #: retransmission delay of ``_RETX_PENALTY`` one-way latencies, drawn
    #: repeatedly while the RNG keeps losing — heavy loss means heavy
    #: tail latency, exactly what it does to a surviving TCP flow.
    loss: float = 0.0


class _SimLink:
    """One direction of a connection: FIFO delivery into the remote
    ``StreamReader`` after the profile's delay model."""

    __slots__ = (
        "_net",
        "src",
        "dst",
        "profile",
        "_reader",
        "_queue",
        "_last_arrival",
        "_clear_at",
        "inflight",
        "_closed",
        "_dead",
    )

    def __init__(self, net, src, dst, profile, reader):
        import collections

        self._net = net
        self.src = src
        self.dst = dst
        self.profile = profile
        self._reader = reader
        #: Chunks in flight, send order.  Each delivery timer pops the
        #: HEAD rather than carrying its own chunk: two timers that land
        #: on the same virtual instant may run in either heap order, and
        #: a byte stream must never reorder for it.
        self._queue = collections.deque()
        self._last_arrival = 0.0  # FIFO floor: stream order is sacred
        self._clear_at = 0.0  # when the shaped link is next idle
        self.inflight = 0  # bytes sent, not yet delivered
        self._closed = False  # no further sends (FIN queued)
        self._dead = False  # delivery side torn down (EOF fed)

    def send(self, data: bytes) -> None:
        if self._closed or self._dead or not data:
            return
        net = self._net
        # Per-link byte accounting: directed host-pair totals
        # for the relay bandwidth budget.  Pure observation — never
        # touches ``_record``, so trace digests are unchanged by it.
        key = (self.src[0], self.dst[0])
        net.link_bytes[key] = net.link_bytes.get(key, 0) + len(data)
        p = self.profile
        now = net.clock.now
        delay = p.latency_s
        if p.jitter_s:
            delay += p.jitter_s * net._rng.random()
        if p.loss:
            while net._rng.random() < p.loss:
                delay += _RETX_PENALTY * max(p.latency_s, 1e-3)
        ebps = net.host_egress.get(self.src[0], 0.0)
        if ebps:
            # The shared uplink: all of this host's connections contend
            # for one serializer, so a node that floods N copies of a tx
            # pays N serializations back to back.
            estart = max(now, net._egress_clear.get(self.src[0], 0.0))
            now = net._egress_clear[self.src[0]] = (
                estart + 8.0 * len(data) / ebps
            )
        if p.bandwidth_bps:
            start = max(now, self._clear_at)
            self._clear_at = start + 8.0 * len(data) / p.bandwidth_bps
            arrival = self._clear_at + delay
        else:
            arrival = now + delay
        arrival = max(arrival, self._last_arrival)
        self._last_arrival = arrival
        self.inflight += len(data)
        self._queue.append(bytes(data))
        asyncio.get_running_loop().call_at(arrival, self._deliver)

    def _deliver(self) -> None:
        if not self._queue:
            return  # severed: kill() flushed the queue
        data = self._queue.popleft()
        self.inflight -= len(data)
        if self._dead:
            return  # severed while in flight: the bytes died with the link
        self._net._record(
            "rx", self._net.clock.now, self.src, self.dst, len(data),
            zlib.crc32(data),
        )
        self._reader.feed_data(data)

    def close(self) -> None:
        """Graceful FIN: pending bytes still arrive, then EOF."""
        if self._closed or self._dead:
            return
        self._closed = True
        when = max(
            self._net.clock.now + self.profile.latency_s, self._last_arrival
        )
        asyncio.get_running_loop().call_at(when, self._eof)

    def _eof(self) -> None:
        if self._dead:
            return
        self._dead = True
        self._net._record("eof", self._net.clock.now, self.src, self.dst)
        self._reader.feed_eof()

    def kill(self) -> None:
        """Partition sever / local close: immediate EOF, in-flight bytes
        lost (pending deliveries see ``_dead``/an empty queue and
        drop)."""
        if self._dead:
            return
        self._dead = True
        self._closed = True
        self.inflight = 0
        self._queue.clear()
        self._net._record("cut", self._net.clock.now, self.src, self.dst)
        self._reader.feed_eof()


class _SimWriter:
    """The slice of ``asyncio.StreamWriter`` the node and harnesses use.
    Doubles as its own ``.transport`` (``get_write_buffer_size`` /
    ``is_closing`` — the governor's write-queue gauges read bytes in
    flight on the outbound link)."""

    def __init__(self, conn, link, peer_link, peername, sockname):
        self._conn = conn
        self._link = link  # outbound
        self._peer_link = peer_link  # inbound (killed on close)
        self._peername = peername
        self._sockname = sockname
        self._closed = False
        self.transport = self

    # -- transport surface -------------------------------------------------

    def get_write_buffer_size(self) -> int:
        return self._link.inflight

    def is_closing(self) -> bool:
        return self._closed

    # -- writer surface ----------------------------------------------------

    def get_extra_info(self, name, default=None):
        if name == "peername":
            return self._peername
        if name == "sockname":
            return self._sockname
        return default

    def write(self, data: bytes) -> None:
        if not self._closed:
            self._link.send(data)

    async def drain(self) -> None:
        if self._closed:
            raise ConnectionResetError("sim writer closed")
        # No TCP backpressure model (module docstring): writes are
        # accepted instantly and shaped on the link instead.

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._link.close()  # our FIN: pending bytes flush, then EOF
        self._peer_link.kill()  # we stop reading: our reader unblocks now
        self._conn._side_closed()

    async def wait_closed(self) -> None:
        return


class _SimConn:
    """One established connection: two directed links + their writers."""

    def __init__(self, net, src, dst, prof_out, prof_back):
        self.a_addr = src  # (host, port) of the dialer
        self.b_addr = dst
        self.a_reader = asyncio.StreamReader()
        self.b_reader = asyncio.StreamReader()
        self._net = net
        self._open_sides = 2
        link_ab = _SimLink(net, src, dst, prof_out, self.b_reader)
        link_ba = _SimLink(net, dst, src, prof_back, self.a_reader)
        self.a_writer = _SimWriter(self, link_ab, link_ba, dst, src)
        self.b_writer = _SimWriter(self, link_ba, link_ab, src, dst)

    def crosses(self, blocked) -> bool:
        return blocked(self.a_addr[0], self.b_addr[0])

    def sever(self) -> None:
        """A partition cut the wire: both directions die instantly."""
        self.a_writer._link.kill()
        self.b_writer._link.kill()
        self._net._conns.pop(self, None)

    def _side_closed(self) -> None:
        self._open_sides -= 1
        if self._open_sides <= 0:
            self._net._conns.pop(self, None)


class _SimListener(Listener):
    def __init__(self, net, host, port):
        self._net = net
        self._host = host
        self._port = port

    @property
    def port(self) -> int:
        return self._port

    def close(self) -> None:
        self._net._listeners.pop((self._host, self._port), None)

    async def wait_closed(self) -> None:
        return


class _SimHostTransport(Transport):
    """The per-participant facade: binds a source host so the remote
    side's per-host accounting (bans, ADDR budgets, violation scores)
    sees distinct simulated machines."""

    def __init__(self, net, host):
        self._net = net
        self.host = host
        self.clock = net.clock

    async def listen(self, on_conn, host: str, port: int) -> Listener:
        return await self._net._listen(on_conn, host or self.host, port)

    async def connect(self, host, port, local_addr=None):
        return await self._net._connect(self.host, host, port, local_addr)


class SimTransport:
    """The in-memory network: listeners, links, partitions, the trace.

    Hand each participant ``host(name)`` — a ``Transport`` facade bound
    to that source address.  ``set_profile`` shapes pairs of hosts
    (asymmetric by default direction; ``symmetric=True`` sets both);
    unprofiled pairs use ``default_profile``.
    """

    def __init__(
        self,
        clock: VirtualClock | None = None,
        seed: int = 0,
        default_profile: LinkProfile | None = None,
        keep_trace: bool = False,
    ):
        self.clock = clock if clock is not None else VirtualClock()
        self._rng = random.Random((seed << 1) ^ 0x51D0)
        self.default_profile = default_profile or LinkProfile()
        self._profiles: dict[tuple[str, str], LinkProfile] = {}
        self._listeners: dict[tuple[str, int], object] = {}
        #: Live connections in ESTABLISHMENT order (a dict, not a set:
        #: partition severing iterates this, and set order is id()-based
        #: — the one nondeterminism that broke byte-identical traces in
        #: development).
        self._conns: dict[_SimConn, None] = {}
        self._partition: dict[str, int] | None = None
        self._eph = 20000  # deterministic ephemeral source ports
        self._hasher = hashlib.sha256()
        self.events = 0
        self.trace: list[tuple] | None = [] if keep_trace else None
        self._tasks: set[asyncio.Task] = set()
        #: (src_host, dst_host) -> bytes put on that directed link, every
        #: payload chunk counted at ``_SimLink.send`` (the
        #: per-link accounting).  Observation only: reading or resetting
        #: it never perturbs the trace digest.
        self.link_bytes: dict[tuple[str, str], int] = {}
        #: host -> uplink bits/s.  Opt-in per-HOST egress shaping:
        #: every chunk the host sends — on ANY connection —
        #: serializes through one shared uplink before the per-link
        #: profile applies, which is the physical constraint the relay
        #: bandwidth budget is about (a flooding node pays its degree on
        #: ONE access link, not on ``degree`` independent ones).  Empty
        #: (the default) means infinite uplinks: existing scenarios and
        #: their pinned trace digests are untouched.
        self.host_egress: dict[str, float] = {}
        self._egress_clear: dict[str, float] = {}

    # -- topology ----------------------------------------------------------

    def host(self, name: str) -> _SimHostTransport:
        return _SimHostTransport(self, name)

    def set_profile(
        self, src: str, dst: str, profile: LinkProfile, symmetric: bool = True
    ) -> None:
        self._profiles[(src, dst)] = profile
        if symmetric:
            self._profiles[(dst, src)] = profile

    def profile_between(self, src: str, dst: str) -> LinkProfile:
        return self._profiles.get((src, dst), self.default_profile)

    def blocked(self, a: str, b: str) -> bool:
        p = self._partition
        if p is None:
            return False
        ga, gb = p.get(a), p.get(b)
        # Hosts outside every named group are unconstrained (e.g. an
        # observer added after the cut).
        return ga is not None and gb is not None and ga != gb

    def kill_host(self, host: str) -> None:
        """A host died abruptly (the chaos plane's crash primitive):
        every connection touching it is severed — in-flight bytes die on
        the wire, exactly like a partition cut — and its listeners
        vanish, so reconnect dials are refused until the host comes back
        and listens again.  Recorded in the trace: a crash is an
        observable network event."""
        self._record("kill_host", self.clock.now, host)
        for key in [k for k in self._listeners if k[0] == host]:
            del self._listeners[key]
        for conn in [
            c
            for c in self._conns
            if c.a_addr[0] == host or c.b_addr[0] == host
        ]:
            conn.sever()

    def partition(self, *groups) -> None:
        """Split the network: hosts in different groups can neither dial
        each other nor keep existing connections (those are severed —
        in-flight bytes die on the wire, like a cut cable)."""
        mapping: dict[str, int] = {}
        for gi, group in enumerate(groups):
            for h in group:
                mapping[h] = gi
        self._partition = mapping
        self._record(
            "partition", self.clock.now,
            tuple(sorted(mapping.values()).count(i) for i in range(len(groups))),
        )
        for conn in [c for c in self._conns if c.crosses(self.blocked)]:
            conn.sever()

    def heal(self) -> None:
        self._partition = None
        self._record("heal", self.clock.now)

    # -- the event trace ---------------------------------------------------

    def _record(self, *fields) -> None:
        self._hasher.update(repr(fields).encode())
        self.events += 1
        if self.trace is not None:
            self.trace.append(fields)

    def trace_digest(self) -> str:
        """Running SHA-256 over every event so far — the byte-identity
        witness two same-seed runs must agree on."""
        return self._hasher.hexdigest()

    # -- transport internals ----------------------------------------------

    async def _listen(self, on_conn, host: str, port: int) -> Listener:
        if port == 0:
            self._eph += 1
            port = self._eph
        key = (host, port)
        if key in self._listeners:
            raise OSError(f"sim: address already in use: {host}:{port}")
        self._listeners[key] = on_conn
        self._record("listen", self.clock.now, host, port)
        return _SimListener(self, host, port)

    async def _connect(self, src_host, dst_host, dst_port, local_addr=None):
        if local_addr is not None:
            src_host = local_addr[0]
        prof_out = self.profile_between(src_host, dst_host)
        # The dial costs one round trip either way (SYN, then accept or
        # refusal coming back).
        await asyncio.sleep(2.0 * prof_out.latency_s)
        on_conn = self._listeners.get((dst_host, dst_port))
        if on_conn is None or self.blocked(src_host, dst_host):
            self._record("refused", self.clock.now, src_host, dst_host, dst_port)
            raise ConnectionRefusedError(
                f"sim: {dst_host}:{dst_port} unreachable from {src_host}"
            )
        self._eph += 1
        src = (src_host, self._eph)
        dst = (dst_host, dst_port)
        conn = _SimConn(
            self, src, dst, prof_out, self.profile_between(dst_host, src_host)
        )
        self._conns[conn] = None
        self._record("connect", self.clock.now, src, dst)
        task = asyncio.get_running_loop().create_task(
            on_conn(conn.b_reader, conn.b_writer)
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return conn.a_reader, conn.a_writer


class SimNet:
    """Scenario harness: full ``Node`` instances over a ``SimTransport``
    under a ``SimLoop``, with deterministic block production.

    Mining is driven by the scenario, not by node mine loops: the
    per-node ``run_in_executor`` nonce search would reintroduce real
    threads (and their scheduling nondeterminism) into a simulation
    whose whole point is reproducibility.  ``mine_on(node)`` assembles
    against the node's own chain/mempool (the REAL ``_assemble`` path —
    virtual-wall timestamps, pool selection, retarget clamps), seals
    synchronously with a deterministic backend (nonce space scanned
    from 0: the first hit, whichever backend), and injects through ``_handle_block`` so gossip,
    compact relay, orphan handling, and reorgs all run for real.

    ``device`` says where the mesh's device work runs: ``"cuda"`` (the
    default) seals every block through the ``cuda`` backend, the
    ``sha256d_search.cu`` kernel, and sends every node's signature
    batches to the card; ``"cpu"`` seals with the hashlib ``cpu``
    backend and pins the nodes' ``device`` signature rung to its plain
    version.  ``backend`` overrides the sealing backend's registry name
    (``backend="cuda", device="cpu"`` runs the kernel's plain version).
    The search returns the earliest hit on every backend, so the blocks,
    the events and the trace digest do not depend on either choice.
    """

    def __init__(
        self,
        seed: int = 0,
        difficulty: int = 8,
        default_profile: LinkProfile | None = None,
        keep_trace: bool = False,
        store_dir=None,
        telemetry: bool = True,
        segmented_store: bool = False,
        segment_bytes: int = 1 << 14,
        pipeline_workers: int = 0,
        device: str = "cuda",
        backend: str | None = None,
    ):
        from pathlib import Path

        from p1_tpu_torch.hashx import get_backend
        from p1_tpu_torch.miner import Miner

        self.seed = seed
        self.difficulty = difficulty
        #: Default for every spawned node's ``config.telemetry`` —
        #: recording reads only the VIRTUAL clock, so flipping this must
        #: not move the trace digest (the observer contract the
        #: determinism pair in tests/test_telemetry.py pins).
        self.telemetry = telemetry
        self.clock = VirtualClock()
        self.net = SimTransport(
            self.clock,
            seed=seed,
            default_profile=default_profile,
            keep_trace=keep_trace,
        )
        self.rng = random.Random(seed)
        self.nodes: dict[str, object] = {}
        self.configs: dict[str, object] = {}
        #: ``store_dir`` gives every node a real on-disk ChainStore
        #: (one ``<host>.dat`` per node, always a fault-injectable
        #: ``FaultStore``) — the substrate crash/recovery scenarios
        #: need: a crashed node's surviving state IS its files.
        self.store_dir = Path(store_dir) if store_dir is not None else None
        #: ``segmented_store`` gives every node the SEGMENTED layout
        #: (chain/segstore.py) behind the same FaultStore seam — tiny
        #: ``segment_bytes`` so a few mined blocks cross roll
        #: boundaries.  The chaos plane (node/chaos.py) runs its whole
        #: schedule corpus over segmented stores this way.
        self.segmented_store = segmented_store
        self.segment_bytes = segment_bytes
        #: Default for every spawned node's ``config.pipeline_workers``
        #: (node/pipeline.py).  Under the virtual loop a lane
        #: submission completes synchronously (``SimLoop.run_in_executor``
        #: above), so flipping this must not move the trace digest —
        #: the staging determinism pair in tests/test_pipeline.py pins
        #: exactly that, the same observer contract as ``telemetry``.
        self.pipeline_workers = pipeline_workers
        #: host -> live FaultStore (chaos events re-arm plans on these).
        self.stores: dict[str, object] = {}
        #: Hosts currently dead from ``crash_node`` (host -> the dead
        #: Node object, kept for post-mortem assertions in tests).
        self.crashed: dict[str, object] = {}
        #: Where the sealing backend and the nodes' ``device`` signature
        #: rung run; every spawned node's config defaults to both.
        self.device = device
        self.backend = backend or ("cuda" if device == "cuda" else "cpu")
        self._miner = Miner(
            backend=get_backend(self.backend, device=device), chunk=1 << 16
        )

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    def host_name(i: int) -> str:
        return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"

    def _make_store(self, host: str, plan=None):
        """A fresh FaultStore over the host's on-disk log (None when the
        host is configured storeless).  Always a FaultStore, even with a
        healthy plan: chaos events arm disk faults on live stores, and a
        recover must hand the new process the same injectable seam."""
        config = self.configs[host]
        if not config.store_path:
            self.stores.pop(host, None)
            return None
        from p1_tpu_torch.chain.testing import FaultStore, SegFaultStore

        if self.segmented_store:
            store = SegFaultStore(
                config.store_path,
                plan=plan,
                segment_bytes=self.segment_bytes,
            )
        else:
            store = FaultStore(config.store_path, plan=plan)
        self.stores[host] = store
        return store

    async def add_node(
        self, name: str | None = None, peers=(), store_plan=None, **cfg
    ):
        """Spawn and start one full node.  ``peers`` are host names (or
        explicit "host:port" strings); defaults keep the sim lean —
        mining off (scenario-driven), no mempool TTL loop, seeded
        identity.  With ``store_dir`` set (or an explicit ``store_path``
        in ``cfg``), the node persists to a real on-disk FaultStore;
        ``store_plan`` scripts its initial disk pathology."""
        from p1_tpu_torch.config import NodeConfig
        from p1_tpu_torch.node.node import Node

        host = name if name is not None else self.host_name(len(self.nodes))
        cfg.setdefault("difficulty", self.difficulty)
        cfg.setdefault("mine", False)
        cfg.setdefault("mempool_ttl_s", 0.0)
        cfg.setdefault("rng_seed", self.rng.getrandbits(48))
        cfg.setdefault("telemetry", self.telemetry)
        cfg.setdefault("pipeline_workers", self.pipeline_workers)
        cfg.setdefault("device", self.device)
        cfg.setdefault("backend", self.backend)
        if self.store_dir is not None:
            cfg.setdefault("store_path", str(self.store_dir / f"{host}.dat"))
        peer_strs = tuple(
            p if ":" in p else f"{p}:{NODE_PORT}" for p in peers
        )
        config = NodeConfig(
            host=host, port=NODE_PORT, peers=peer_strs, **cfg
        )
        self.configs[host] = config
        node = Node(
            config,
            miner=self._miner,
            transport=self.net.host(host),
            store=self._make_store(host, plan=store_plan),
        )
        self.nodes[host] = node
        await node.start()
        return node

    async def stop_node(self, host: str) -> None:
        node = self.nodes.pop(host)
        await node.stop()

    async def restart_node(self, host: str):
        """Churn: bring a previously stopped host back with the SAME
        config (and so the same seed-derived identity).  GRACEFUL
        restart: the predecessor's ``stop()`` ran every shutdown hook
        (mempool checkpoint, address book, store close) — contrast
        ``crash_node``/``recover_node``, which skip them all."""
        from p1_tpu_torch.node.node import Node

        node = Node(
            self.configs[host],
            miner=self._miner,
            transport=self.net.host(host),
            store=self._make_store(host),
        )
        self.nodes[host] = node
        await node.start()
        return node

    async def crash_node(self, host: str, torn: int = 0):
        """Kill a node ABRUPTLY — the process-death model, no graceful
        shutdown anywhere on the path:

        - the wire dies first (``kill_host``): every connection is
          severed with bytes in flight, reconnect dials refuse until
          the host listens again;
        - every task is cancelled with no close hooks — no mempool
          save, no address-book save, no final store sync: whatever the
          last periodic checkpoint wrote is what the disk holds (stale
          by up to one housekeeping interval, exactly like a real
          crash);
        - ``torn > 0`` tears an in-flight store append at the kill
          point through the FaultStore torn-write seam: the node's
          current assembly candidate dies ``torn``-bytes into its
          record — the on-disk artifact a power cut mid-append leaves,
          which ``recover_node``'s normal resume must truncate;
        - file handles close (the writer flock releases — a dead
          process holds no locks), buffers are NOT flushed gracefully
          (the store flushes per append by design, so acknowledged
          records are already on disk — the durability contract under
          test).

        The dead Node object is kept in ``self.crashed[host]`` for
        post-mortem assertions."""
        node = self.nodes.pop(host)
        self.net._record("crash", self.clock.now, host, torn)
        self.net.kill_host(host)
        node._running = False
        node._abort_inflight_search()
        tasks = [*node._tasks, *node._sessions]
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        node._tasks.clear()
        node._sessions.clear()
        if node._mempool_io is not None:
            # The checkpoint WRITE runs in a real thread the event loop
            # cannot cancel; wait it out so the post-crash disk state is
            # a deterministic function of virtual time (either the
            # checkpoint fully landed — tmp+rename is atomic — or it
            # was never started), not a race against the wall clock.
            await asyncio.gather(node._mempool_io, return_exceptions=True)
        if node.store is not None:
            if torn > 0:
                self._tear_append(node, torn)
            node.store.close()
        self.crashed[host] = node
        return node

    def _tear_append(self, node, torn: int) -> None:
        """Die ``torn`` bytes into appending the node's current assembly
        candidate — the in-flight record a mid-append crash tears.  Runs
        through the FaultStore torn-write plan (chain/testing.py), so
        the partial bytes genuinely reach the file the way the harness's
        storage suites model it."""
        from p1_tpu_torch.chain.testing import StoreFaultPlan

        store = node.store
        candidate = node._assemble()
        # A full record is 4 (length) + payload + 4 (CRC) bytes; clamp
        # the tear strictly inside it so the artifact is always an
        # INCOMPLETE record (at minimum the CRC trailer is missing).
        record_len = len(candidate.serialize()) + 8
        torn_bytes = 1 + (torn - 1) % (record_len - 1)
        store.plan = StoreFaultPlan(
            fail_write_at=store.writes + 1, torn_bytes=torn_bytes
        )
        try:
            store.append(candidate)
        except OSError:
            pass  # the point: the append died mid-write
        finally:
            store.plan = StoreFaultPlan()

    async def recover_node(self, host: str):
        """Reboot a crashed host from the same on-disk state through the
        NORMAL resume path — ``Node.start()``'s store acquire (torn-tail
        truncation, corruption quarantine/heal), validated chain replay,
        and full-admission mempool reload.  Nothing about the boot knows
        it follows a crash; that is the contract under test."""
        assert host in self.crashed, f"{host} did not crash"
        del self.crashed[host]
        from p1_tpu_torch.node.node import Node

        self.net._record("recover", self.clock.now, host)
        node = Node(
            self.configs[host],
            miner=self._miner,
            transport=self.net.host(host),
            store=self._make_store(host),
        )
        self.nodes[host] = node
        await node.start()
        return node

    async def stop_all(self) -> None:
        for host in list(self.nodes):
            await self.stop_node(host)

    def run(self, coro, debug: bool = False):
        """Run ``coro`` to completion on a fresh ``SimLoop`` (the
        scenario entry point — one virtual world per call)."""
        loop = SimLoop(self.clock)
        loop.set_debug(debug)
        asyncio.set_event_loop(loop)
        try:
            return loop.run_until_complete(coro)
        finally:
            try:
                pending = asyncio.all_tasks(loop)
                for task in pending:
                    task.cancel()
                if pending:
                    loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True)
                    )
                loop.run_until_complete(loop.shutdown_asyncgens())
            finally:
                asyncio.set_event_loop(None)
                loop.close()

    # -- block production and convergence ---------------------------------

    async def mine_on(self, node, spacing_s: float = 0.0):
        """Deterministically mine ONE block on ``node`` and inject it
        (gossip fans out through the sim links).  ``spacing_s`` of
        virtual time afterwards lets propagation land before the next
        block — the scenario's block cadence knob."""
        from p1_tpu_torch.core.block import Block

        candidate = node._assemble()
        sealed = self._miner.search_nonce(candidate.header)
        assert sealed is not None, "nonce space exhausted (raise difficulty?)"
        block = Block(sealed, candidate.txs)
        node.metrics.blocks_mined += 1
        await node._handle_block(block, origin=None)
        if spacing_s:
            await asyncio.sleep(spacing_s)
        return block

    async def run_until(
        self,
        cond,
        timeout: float,
        step: float = 0.05,
        wall_limit_s: float | None = None,
    ) -> bool:
        """Advance virtual time until ``cond()`` or ``timeout`` virtual
        seconds pass.  ``wall_limit_s`` guards REAL time: virtual time
        is free, so exceeding it means the sim livelocked — a bug, and
        ``SimWallTimeout`` says so loudly."""
        deadline = self.clock.now + timeout
        wall0 = time.monotonic()
        while self.clock.now < deadline:
            if cond():
                return True
            if (
                wall_limit_s is not None
                and time.monotonic() - wall0 > wall_limit_s
            ):
                raise SimWallTimeout(
                    f"scenario burned {wall_limit_s:.0f}s of wall time at "
                    f"virtual t={self.clock.now:.1f}"
                )
            await asyncio.sleep(step)
        return bool(cond())

    def links_up(self) -> bool:
        """True once every CONFIGURED dial is a registered session: the
        sum of peer counts reaches twice the configured edge count (each
        established dial registers a _Peer on both ends).  The strong
        mesh-formation condition for static topologies — ``peer_count
        >= 1`` alone lets a scenario start while handshakes are still in
        flight, which is a (real, now handled) race, not the steady
        state most scenarios mean to begin from."""
        expected = 2 * sum(
            len(c.peer_addrs()) for c in self.configs.values()
        )
        return (
            sum(n.peer_count() for n in self.nodes.values()) >= expected
        )

    # -- invariants --------------------------------------------------------

    def tips(self, hosts=None) -> set[bytes]:
        hosts = self.nodes if hosts is None else hosts
        return {self.nodes[h].chain.tip_hash for h in hosts}

    def converged(self, hosts=None) -> bool:
        return len(self.tips(hosts)) == 1

    def heights(self) -> list[int]:
        return [n.chain.height for n in self.nodes.values()]

    def ledger_conserved(self) -> bool:
        """The byzantine soak's containment invariant at sim scale: with
        a coinbase in every block, each node's ledger must sum to
        exactly BLOCK_REWARD x its height — across every partition,
        reorg, and churn cycle."""
        from p1_tpu_torch.core.tx import BLOCK_REWARD

        return all(
            sum(n.chain.balances_snapshot().values())
            == BLOCK_REWARD * n.chain.height
            for n in self.nodes.values()
        )

    def trace_digest(self) -> str:
        return self.net.trace_digest()
