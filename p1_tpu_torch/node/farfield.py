"""The sharded far-field plane: 10,000 simulated nodes on one host.

The full-fidelity simulator (node/netsim.py) runs REAL ``Node``
instances — chain, mempool, governor, supervision — which is exactly
why it tops out around a thousand nodes per process: every node costs
an asyncio task set, a chain index, and a governor.  Real networks have
10k+ participants, but the far field of a gossip mesh is mostly
*header relays*: nodes that receive announcements, deduplicate, follow
the heaviest tip, and forward.  This module models that far field
honestly as what it is — a header-only node (tip + seen-set + orphan
buffer + relay) — and makes the resulting discrete-event simulation
**shardable across processes** with deterministic cross-shard event
exchange, so the 10k-node scenario in node/scenarios.py fits one host
in tier-1-adjacent wall time.

Design, in three layers:

- **Pure-function world.**  Topology (``topology``) and per-direction
  link latency (``link_latency``) are pure functions of ``(seed, node
  ids)`` via SHA-256 draws — no shared RNG stream whose draw ORDER
  could differ between shard layouts.  Time is integer microseconds
  end to end: float arithmetic never enters the event path, so two
  runs (or two shard layouts) can be compared byte-for-byte.

- **Conservative virtual-time barriers.**  Every latency is at least
  ``LAT_MIN_US``, so an event processed at time ``t`` can only
  schedule effects at ``t + LAT_MIN_US`` or later.  The coordinator
  repeatedly (1) finds the globally earliest pending event time ``m``,
  (2) lets every shard process its local events with ``t < m +
  LAT_MIN_US`` — nothing another shard does this round can land inside
  that window — and (3) routes the cross-shard sends for the next
  round.  Idle virtual time is skipped entirely (the bound chases the
  next event, it does not tick), which is what makes multi-minute
  virtual horizons cost milliseconds.

- **One merged trace.**  Each shard processes its heap in full event
  order ``(t_us, dst, src, height, block id)``, so its per-round
  delivery list is sorted; the coordinator merge-sorts the shards'
  lists and feeds ONE running SHA-256.  Rounds never overlap in time
  (window k+1 starts at window k's bound), so the merged stream is the
  total event order regardless of the shard count: **same seed ⇒ the
  same digest at 1 shard and at N shards, in one process or across
  processes** — the contract tests/test_farfield.py and the `p1 sim
  far-field --shards` CLI pair assert, PYTHONHASHSEED pinned, exactly
  like the other determinism pairs.

Cross-process shards are ``multiprocessing`` workers over pipes (the
spawn context: a clean interpreter per shard, nothing inherited but
the arguments), driven by the same coordinator loop as the in-process
mode; the pipe protocol is one request/response per barrier round.
All of it is ordinary synchronous code — the shard exchange never runs
on an asyncio loop, so the blocking pipe reads need no
transitive-blocking grant in the lint allowlist, and must
not grow one by moving onto a loop.

What the far-field model does NOT capture (honesty): no transaction
traffic, mempools, ledgers, or stores (headers only); no bandwidth
shaping, handshakes, supervision, or admission control (a far-field
node never stalls, floods, or gets banned); relay is announce-forward
with per-link latency only; and the coupling to the full-node core is
ONE-WAY — far-field demand never back-pressures the core mesh.  Any
result that depends on those belongs in the full simulator.

The port's copy of ``p1_tpu/node/farfield.py``: headers only, no device
work.  A cross-process shard is a spawned interpreter, so it inherits no
CUDA state, and its worker imports nothing that loads torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import time

__all__ = [
    "FarFieldReport",
    "FarShard",
    "LAT_MIN_US",
    "LAT_MAX_US",
    "link_latency_us",
    "run_far_field",
    "shard_bounds",
    "topology",
]

#: Per-direction link latency band, integer microseconds.  The floor is
#: the barrier window (the lookahead every conservative parallel
#: discrete-event scheme needs); the ceiling keeps the band WAN-shaped.
LAT_MIN_US = 10_000  # 10 ms
LAT_MAX_US = 250_000  # 250 ms

#: Entry points where core-mesh announcements reach the far field.
GATEWAYS = 8


def _draw(seed: int, *fields: int) -> int:
    """One deterministic 64-bit draw: a pure function of its arguments
    (no stream, no order dependence — any shard can evaluate any draw)."""
    h = hashlib.sha256()
    h.update(b"farfield")
    for f in (seed, *fields):
        h.update(int(f).to_bytes(16, "little", signed=True))
    return int.from_bytes(h.digest()[:8], "little")


def link_latency_us(seed: int, src: int, dst: int) -> int:
    """Directional latency for src→dst, in [LAT_MIN_US, LAT_MAX_US)."""
    span = LAT_MAX_US - LAT_MIN_US
    return LAT_MIN_US + _draw(seed, 1, src, dst) % span


def topology(seed: int, n: int, degree: int = 4) -> list[list[int]]:
    """Symmetric adjacency: node i always links i-1 (a backbone, so the
    graph is connected by construction) plus ``degree - 1`` pure-draw
    earlier nodes — the same backbone+small-world shape the full-node
    scenarios use (scenarios._topology_peers), as a pure function."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        peers = {i - 1}
        for k in range(degree - 1):
            if i >= 2:
                peers.add(_draw(seed, 2, i, k) % (i - 1))
        for j in sorted(peers):
            adj[i].append(j)
            adj[j].append(i)
    return adj


def shard_bounds(n: int, shards: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) node ranges, one per shard."""
    assert 1 <= shards <= n, (n, shards)
    out = []
    base, rem = divmod(n, shards)
    lo = 0
    for s in range(shards):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


class FarShard:
    """One shard's worth of header-only nodes and their event heap.

    Event tuples are ``(t_us, dst, src, height, bid)`` — the heap order
    IS the trace order, so ``process()`` returns its deliveries already
    sorted.  ``src == -1`` marks a gateway injection from the core mesh.
    """

    def __init__(self, seed: int, n: int, lo: int, hi: int, degree: int):
        self.seed = seed
        self.n = n
        self.lo = lo
        self.hi = hi
        self.adj = topology(seed, n, degree)
        self.heap: list[tuple] = []
        #: nid -> {bid: (height, parent)} — headers this node accepted.
        self.have: dict[int, dict[str, tuple[int, str]]] = {}
        #: nid -> (height, bid) best tip (first-seen wins height ties).
        self.tips: dict[int, tuple[int, str]] = {}
        #: nid -> {parent_bid: [(height, bid)]} — parked until linkable.
        self.orphans: dict[int, dict[str, list[tuple[int, str]]]] = {}
        #: (nid, bid) -> first-arrival t_us, for propagation figures.
        self.arrivals: dict[tuple[int, str], int] = {}
        self.deliveries = 0

    def push(self, ev: tuple) -> None:
        heapq.heappush(self.heap, ev)

    def next_time(self) -> int | None:
        return self.heap[0][0] if self.heap else None

    def _accept(
        self, nid: int, height: int, bid: str, parent: str, sends: list
    ) -> None:
        """Header connects: record it, move the tip if it wins, relay to
        every neighbor, then un-park any orphan children."""
        have = self.have.setdefault(nid, {})
        have[bid] = (height, parent)
        tip = self.tips.get(nid)
        if tip is None or height > tip[0]:
            self.tips[nid] = (height, bid)
        for nbr in self.adj[nid]:
            sends.append(
                (
                    self._now + link_latency_us(self.seed, nid, nbr),
                    nbr,
                    nid,
                    height,
                    bid,
                )
            )
        parked = self.orphans.get(nid)
        if parked is not None:
            children = parked.pop(bid, ())
            if not parked:
                # Drop the empty per-node buffer BEFORE recursing: the
                # recursive accept may empty-and-delete it again.
                self.orphans.pop(nid, None)
            for oh, obid in children:
                self._accept(nid, oh, obid, bid, sends)

    def process(self, bound_us: int, feed: dict) -> tuple[list, list]:
        """Run every local event with ``t < bound_us``.  Returns
        ``(cross_shard_sends, deliveries)`` — deliveries in heap (trace)
        order, cross sends as raw event tuples for the coordinator to
        route.  ``feed`` maps bid -> (height, parent) for header lookup
        on gateway injections (relays carry it per event already)."""
        cross: list[tuple] = []
        deliveries: list[tuple] = []
        heap = self.heap
        while heap and heap[0][0] < bound_us:
            ev = heapq.heappop(heap)
            t_us, dst, src, height, bid = ev
            self._now = t_us
            deliveries.append(ev)
            self.deliveries += 1
            have = self.have.setdefault(dst, {})
            if bid in have:
                continue  # duplicate announcement: dedup, no relay
            key = (dst, bid)
            if key not in self.arrivals:
                self.arrivals[key] = t_us
            parent = feed[bid][1]
            sends: list[tuple] = []
            if parent == "" or parent in have:
                self._accept(dst, height, bid, parent, sends)
            else:
                self.orphans.setdefault(dst, {}).setdefault(
                    parent, []
                ).append((height, bid))
            for s in sends:
                if self.lo <= s[1] < self.hi:
                    heapq.heappush(heap, s)
                else:
                    cross.append(s)
        return cross, deliveries


# -- cross-process worker --------------------------------------------------


def _shard_worker(conn, seed: int, n: int, lo: int, hi: int, degree: int,
                  feed: dict) -> None:
    """One shard in its own process: answer barrier-round requests over
    the pipe until told to stop.  Protocol (coordinator side is
    ``_ProcShard``): recv ``("step", bound, in_events)`` → process →
    send ``(next_time, cross_sends, deliveries)``; recv ``("done",)`` →
    send final per-shard state and exit."""
    shard = FarShard(seed, n, lo, hi, degree)
    while True:
        msg = conn.recv()
        if msg[0] == "step":
            _, bound, in_events = msg
            for ev in in_events:
                shard.push(ev)
            cross, deliveries = shard.process(bound, feed)
            conn.send((shard.next_time(), cross, deliveries))
        elif msg[0] == "done":
            conn.send((shard.tips, shard.arrivals, shard.deliveries))
            conn.close()
            return


class _ProcShard:
    """Coordinator-side handle speaking the worker protocol."""

    def __init__(self, ctx, seed, n, lo, hi, degree, feed):
        self.lo, self.hi = lo, hi
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_shard_worker,
            args=(child, seed, n, lo, hi, degree, feed),
            daemon=True,
        )
        self.proc.start()
        child.close()
        self._pending_in: list[tuple] = []
        self._next: int | None = None

    def push(self, ev: tuple) -> None:
        self._pending_in.append(ev)
        if self._next is None or ev[0] < self._next:
            self._next = ev[0]

    def next_time(self) -> int | None:
        return self._next

    def step(self, bound: int) -> None:
        self.conn.send(("step", bound, self._pending_in))
        self._pending_in = []

    def result(self) -> tuple:
        nxt, cross, deliveries = self.conn.recv()
        self._next = nxt
        return cross, deliveries

    def finish(self) -> tuple:
        self.conn.send(("done",))
        tips, arrivals, deliveries = self.conn.recv()
        self.conn.close()
        self.proc.join(timeout=30)
        return tips, arrivals, deliveries

    def kill(self) -> None:
        """Error-path teardown: a coordinator abort must not strand
        worker processes behind it."""
        try:
            self.conn.close()
        except OSError:
            pass
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5)


class _LocalShard:
    """In-process shard with the same coordinator surface."""

    def __init__(self, seed, n, lo, hi, degree, feed):
        self.lo, self.hi = lo, hi
        self._feed = feed
        self._shard = FarShard(seed, n, lo, hi, degree)
        self._result: tuple | None = None

    def push(self, ev: tuple) -> None:
        self._shard.push(ev)

    def next_time(self) -> int | None:
        nxt = self._shard.next_time()
        return nxt

    def step(self, bound: int) -> None:
        self._result = self._shard.process(bound, self._feed)

    def result(self) -> tuple:
        r, self._result = self._result, None
        return r

    def finish(self) -> tuple:
        s = self._shard
        return s.tips, s.arrivals, s.deliveries


@dataclasses.dataclass
class FarFieldReport:
    """What one far-field run measured (node/scenarios.py folds this
    into the scenario report)."""

    nodes: int
    shards: int
    processes: bool
    deliveries: int
    rounds: int
    converged_nodes: int
    converged: bool
    final_tip: tuple[int, str]
    #: Last header arrival, µs after its injection — the far field's
    #: convergence lag behind the core mesh.
    settle_ms: float
    #: Per-block propagation percentiles (injection → first arrival),
    #: virtual ms, across all nodes and blocks.
    propagation_p50_ms: float
    propagation_p95_ms: float
    wall_s: float
    trace_digest: str


def run_far_field(
    nodes: int,
    seed: int,
    feed: list[tuple[float, int, str, str]],
    degree: int = 4,
    shards: int = 1,
    processes: bool | None = None,
    wall_limit_s: float | None = 300.0,
) -> FarFieldReport:
    """Run one far-field simulation to quiescence.

    ``feed`` is the core mesh's announcement schedule: ``(t_s, height,
    bid, parent_bid)`` per block, virtual seconds (parent "" = the
    far field's genesis anchor — accepted linklessly).  ``shards`` > 1
    with ``processes`` unset (or True) runs one OS process per shard
    over the pipe seam; ``processes=False`` keeps the same sharded
    exchange in-process (the fast path for determinism pairs).
    """
    assert nodes >= 1 and shards >= 1
    if processes is None:
        processes = shards > 1
    t0 = time.monotonic()
    feed_map = {bid: (height, parent) for _t, height, bid, parent in feed}
    bounds = shard_bounds(nodes, shards)

    if processes and shards > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        shard_objs: list = [
            _ProcShard(ctx, seed, nodes, lo, hi, degree, feed_map)
            for lo, hi in bounds
        ]
    else:
        shard_objs = [
            _LocalShard(seed, nodes, lo, hi, degree, feed_map)
            for lo, hi in bounds
        ]

    def owner(nid: int):
        for so in shard_objs:
            if so.lo <= nid < so.hi:
                return so
        raise AssertionError(nid)

    # Gateway injections: each announcement enters at GATEWAYS evenly
    # spaced far-field nodes, after a per-gateway pure-draw latency
    # (the gateway's path from the core mesh).
    n_gw = max(1, min(GATEWAYS, nodes))
    gateways = [g * nodes // n_gw for g in range(n_gw)]
    inject_us: dict[str, int] = {}
    for t_s, height, bid, _parent in feed:
        t_us = round(t_s * 1e6)
        inject_us[bid] = t_us
        for g, gw in enumerate(gateways):
            lat = link_latency_us(seed, -1 - g, gw)
            owner(gw).push((t_us + lat, gw, -1, height, bid))

    hasher = hashlib.sha256()
    deliveries_total = 0
    rounds = 0
    try:
        deliveries_total, rounds = _drive(
            shard_objs, owner, hasher, t0, wall_limit_s
        )
    except BaseException:
        for so in shard_objs:
            if isinstance(so, _ProcShard):
                so.kill()
        raise

    # Quiesce: collect per-shard end state (and reap workers).
    tips: dict[int, tuple[int, str]] = {}
    arrivals: dict[tuple[int, str], int] = {}
    for so in shard_objs:
        s_tips, s_arrivals, _n = so.finish()
        tips.update(s_tips)
        arrivals.update(s_arrivals)

    final_tip = max(
        ((h, bid) for _t, h, bid, _p in feed), default=(0, "")
    )
    converged_nodes = sum(
        1 for nid in range(nodes) if tips.get(nid) == final_tip
    )
    delays_ms = sorted(
        (t_us - inject_us[bid]) / 1e3
        for (_nid, bid), t_us in arrivals.items()
    )

    def pct(p: float) -> float:
        if not delays_ms:
            return 0.0
        return delays_ms[min(len(delays_ms) - 1, int(p * len(delays_ms)))]

    settle_ms = delays_ms[-1] if delays_ms else 0.0
    return FarFieldReport(
        nodes=nodes,
        shards=shards,
        processes=bool(processes and shards > 1),
        deliveries=deliveries_total,
        rounds=rounds,
        converged_nodes=converged_nodes,
        converged=converged_nodes == nodes,
        final_tip=final_tip,
        settle_ms=round(settle_ms, 3),
        propagation_p50_ms=round(pct(0.50), 3),
        propagation_p95_ms=round(pct(0.95), 3),
        wall_s=round(time.monotonic() - t0, 3),
        trace_digest=hasher.hexdigest(),
    )


def _drive(shard_objs, owner, hasher, t0, wall_limit_s) -> tuple[int, int]:
    """The barrier loop (module docstring): rounds of find-min →
    process-window → merge-trace → route-cross, until global quiesce."""
    deliveries_total = 0
    rounds = 0
    while True:
        nexts = [so.next_time() for so in shard_objs]
        live = [x for x in nexts if x is not None]
        if not live:
            break
        if (
            wall_limit_s is not None
            and time.monotonic() - t0 > wall_limit_s
        ):
            raise RuntimeError(
                f"far-field run burned {wall_limit_s:.0f}s of wall time "
                f"after {rounds} barrier rounds"
            )
        bound = min(live) + LAT_MIN_US
        for so in shard_objs:
            so.step(bound)
        round_streams = []
        cross_all: list[tuple] = []
        for so in shard_objs:
            cross, deliveries = so.result()
            cross_all.extend(cross)
            round_streams.append(deliveries)
        for ev in heapq.merge(*round_streams):
            hasher.update(repr(ev).encode())
            deliveries_total += 1
        for ev in sorted(cross_all):
            owner(ev[1]).push(ev)
        rounds += 1
    return deliveries_total, rounds
