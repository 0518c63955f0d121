"""Fault-injecting hostile-peer harness: scripted bad network behavior.

The liveness layer grew out of hand-rolled raw-socket attackers
(tests/test_liveness.py) and the compact-relay hostile cases out of
in-process fake peers (tests/test_compact.py) — each test rebuilding its
own adversary.  This module is the reusable adversary: a ``HostilePeer``
listens (or dials) like a real node, completes the HELLO exchange, serves
a scripted chain — and injects exactly one family of delivery faults, per
a declarative ``FaultPlan``:

- **stall**: swallow chosen request types silently while answering PINGs,
  staying comfortably under the liveness layer's bar (the sync-stall
  attack supervision exists to beat);
- **trickle**: deliver reply bytes at N bytes/s (the honest-slow peer —
  the false-demotion control case);
- **truncate**: send half of one reply frame, then wedge (mid-frame
  stall: byte progress happened, the frame never completes);
- **drop**: close the socket the instant a chosen request arrives;
- **stale/empty replies**: syntactically perfect BLOCKS frames that never
  advance the requester (the chatty-useless attack).

Faults can be deferred (``serve_before_fault``) so a peer serves the
first N rounds honestly and stalls *mid*-IBD.  The harness counts every
request it sees (``requests``) so tests assert what the victim actually
asked, not just what state it reached.

Test infrastructure, not product: nothing in the node imports this.  It
lives in the package (rather than tests/) so external integration rigs
and soak harnesses can script delivery faults against real nodes
without vendoring test helpers.

The port's copy of ``p1_tpu/node/testing.py``: ``make_blocks`` gives
byte-identical blocks in both packages for the same arguments (the
chain-store crash soak, ``chain/testing.append_soak``, and the tests build
a chain in either package and compare), and the peers speak the
reference's frames, so they script faults against either package's node.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import secrets
import struct

from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.protocol import Hello, MsgType
from p1_tpu_torch.node.transport import SOCKET_TRANSPORT

__all__ = ["FaultPlan", "FloodPlan", "GreedyPeer", "HostilePeer", "make_blocks"]

#: Request types whose replies the fault machinery can intercept — the
#: multi-round fetches request supervision covers, exactly.
_FAULTABLE = frozenset(
    {
        MsgType.GETBLOCKS,
        MsgType.GETHEADERS,
        MsgType.GETBLOCKTXN,
        MsgType.GETMEMPOOL,
        MsgType.GETSNAPSHOT,
    }
)


def make_blocks(
    n: int,
    difficulty: int = 12,
    miner_id: str = "hostile",
    txs_at: dict[int, tuple] | None = None,
) -> list[Block]:
    """Genesis plus ``n`` mined blocks at ``difficulty`` (fixed-rule
    chain, cpu backend — a few ms per block at difficulty 12).  Each
    block carries its height's coinbase plus any extra transactions from
    ``txs_at[height]`` (the caller funds and signs those; validation on
    the victim is the full consensus check, so they must be real)."""
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    miner = Miner(backend=get_backend("cpu"))
    blocks = [make_genesis(difficulty)]
    for height in range(1, n + 1):
        parent = blocks[-1]
        txs = (
            Transaction.coinbase(miner_id, height),
            *(txs_at or {}).get(height, ()),
        )
        draft = BlockHeader(
            version=1,
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=parent.header.timestamp + 1,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        assert sealed is not None
        blocks.append(Block(sealed, txs))
    return blocks


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One scripted delivery pathology.  Default = a fully honest peer."""

    #: Request types to swallow silently (the stall: liveness-visible,
    #: progress-invisible).
    swallow: frozenset = frozenset()
    #: Close the socket the moment this request type arrives.
    drop_at: MsgType | None = None
    #: Answer this request type with HALF its reply frame, then wedge the
    #: session (no further sends — the stream is desynced by design).
    truncate_at: MsgType | None = None
    #: Deliver reply bytes at this rate (None = full speed).  An honest
    #: slow link, not an attack — the false-demotion control.
    trickle_bps: float | None = None
    #: Sleep this long before every reply (coarse honest-slow knob).
    reply_delay_s: float = 0.0
    #: Blocks (or headers) per sync reply — small values force many
    #: rounds, exercising the per-round progress deadline.
    batch_limit: int = 500
    #: Serve this many faultable requests honestly BEFORE the configured
    #: fault engages — stalls *mid*-IBD instead of at the first ask.
    serve_before_fault: int = 0
    #: Answer sync requests with zero-entry (yet well-formed) replies.
    empty_replies: bool = False
    #: Ignore the locator and re-serve the chain from genesis forever:
    #: non-empty replies that stop advancing the requester after one
    #: round (the stale-branch / chatty-useless attack).
    stale_replies: bool = False
    #: Keep answering keepalive probes (True = stay under the liveness
    #: bar while any of the faults above starve the actual sync).
    answer_pings: bool = True
    #: Advertised HELLO tip height (None = the served chain's real tip).
    #: 0 makes the victim skip the handshake-time sync ask — the
    #: "connected but never triggered" second peer a failover discovers.
    hello_height: int | None = None
    #: MEMPOOL reply shape: the ``more`` flag on served pages.
    mempool_more: bool = False
    #: Answer GETMEMPOOL with EMPTY pages that claim ``more=True``
    #: forever — the initial-sync starvation: each page is
    #: well-formed and "progress" by frame count, but the tail never
    #: arrives and the pool never advances.  The page supervisor must
    #: read it as a stall (zero NEW txs per page), not as progress.
    mempool_empty_tail: bool = False
    #: Snapshot-serving pathologies (chain/snapshot.py, GETSNAPSHOT).
    #: ``snapshot_lie`` corrupts the SERVED STATE: "balance" inflates
    #: one account by 1000 with the manifest root computed over the lie
    #: (internally consistent — only background revalidation can catch
    #: it), "root" flips a state-root byte (caught at assembly, before
    #: any trust is extended).  ``snapshot_chunks`` truncates the serve:
    #: only the first N chunk requests are answered, then silence (the
    #: crash/stall-mid-transfer profile; compose with ``swallow`` for a
    #: server that never answers at all).
    snapshot_lie: str | None = None
    snapshot_chunks: int | None = None


@dataclasses.dataclass(frozen=True)
class FloodPlan:
    """One scripted resource-exhaustion profile for a ``GreedyPeer``.

    Everything a GreedyPeer sends is PROTOCOL-VALID — well-formed frames,
    real PoW where blocks are involved, decodable transactions.  That is
    the point: the misbehavior score cannot see these floods (nothing is
    malformed), so only the governor's admission budgets, slot caps, and
    write-queue enforcement stand between a handful of greedy peers and
    node memory.  The complement of ``FaultPlan``: faults starve, floods
    drown."""

    #: Push the served chain's blocks over and over (full BLOCK frames —
    #: valid work, instant duplicates after round one): index/dedup
    #: pressure plus raw blocks-class traffic.
    blocks: bool = False
    #: Spray valid-PoW blocks whose parent the victim cannot know (the
    #: connecting block is withheld): orphan-pool pressure.
    orphans: bool = False
    #: Loop these raw TX payload frames (caller signs them; admission
    #: may refuse them for affordability, but each one still costs the
    #: victim a decode + signature check unless dropped at the door).
    tx_frames: tuple = ()
    #: Hammer GETBLOCKS/GETHEADERS with genesis locators — each reply is
    #: a full sync batch the victim must assemble and serve.
    queries: bool = False
    #: The write-queue squat: keep asking for sync batches and NEVER
    #: read the socket — the victim's transport buffer grows until its
    #: write-queue cap drops us (or its memory does not survive).
    squat: bool = False
    #: Hammer the wallet push plane: re-register a rotating SUBSCRIBE
    #: watch set every frame (each replaces the session's subscription
    #: — admission + registry work with zero lasting footprint), capped
    #: by one unverifiable resume cursor the victim answers by dropping
    #: the session, so the reconnect loop then pressures accept too.
    subscribe: bool = False
    #: Frames per burst between event-loop yields.
    burst: int = 32
    #: Sleep between bursts (0 = as fast as the loop allows).
    pause_s: float = 0.0


class GreedyPeer:
    """A protocol-valid flooder: dials the victim, completes a real
    HELLO, then runs its ``FloodPlan`` until stopped — reconnecting
    (counted) whenever the victim drops or bans it, exactly like a real
    attacker would.

    Usage::

        peer = GreedyPeer(make_blocks(12, difficulty=8),
                          plan=FloodPlan(queries=True))
        await peer.start("127.0.0.1", victim.port)
        ...
        await peer.stop()
        assert peer.sent > 0

    ``sent`` counts frames written, ``disconnects`` how often the victim
    (or its ban layer) cut us off, ``refused`` connects that never got a
    HELLO back (an accept-time ban working)."""

    def __init__(
        self,
        blocks: list[Block],
        plan: FloodPlan = FloodPlan(),
        source: str | None = None,
        transport=None,
        rng=None,
    ):
        assert blocks, "need at least a genesis block"
        self.blocks = list(blocks)
        self.plan = plan
        #: Local address to dial FROM (a loopback alias like 127.0.0.66),
        #: so the victim's per-host scoring lands on the attacker, not on
        #: every other localhost peer — same trick as the byzantine suite.
        self.source = source
        #: The transport seam (node/transport.py): real sockets by
        #: default; a netsim facade runs the same flood over in-memory
        #: links (``rng`` then pins the nonce for reproducible traces).
        self.transport = transport if transport is not None else SOCKET_TRANSPORT
        self.nonce = (
            rng.getrandbits(64) if rng is not None else secrets.randbits(64)
        ) | 1
        self.sent = 0
        self.disconnects = 0
        self.refused = 0
        self._task: asyncio.Task | None = None
        self._stopping = False

    async def start(self, host: str, port: int) -> None:
        self._task = asyncio.create_task(self._run(host, port))

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _frames(self) -> list[bytes]:
        plan = self.plan
        out: list[bytes] = []
        # Stamp pushes from OUR transport clock (virtual under the
        # simulator): the stamp is inside the frame bytes, so a host
        # clock read here would make every simulated flood's trace
        # nondeterministic.
        now = self.transport.clock.wall()
        if plan.blocks:
            out += [
                protocol.encode_block(b, sent_ts=now) for b in self.blocks[1:]
            ]
        if plan.orphans:
            # Withhold the connecting block: everything from [2:] parks
            # in the victim's orphan pool (valid PoW, unknown parent).
            out += [
                protocol.encode_block(b, sent_ts=now) for b in self.blocks[2:]
            ]
        out += list(plan.tx_frames)
        if plan.queries:
            genesis_locator = [self.blocks[0].block_hash()]
            out += [
                protocol.encode_getblocks(genesis_locator),
                protocol.encode_getheaders(genesis_locator),
            ]
        if plan.squat:
            out += [protocol.encode_getblocks([self.blocks[0].block_hash()])]
        if plan.subscribe:
            out += [
                protocol.encode_subscribe([b"flood-item-%d" % i])
                for i in range(4)
            ]
            out += [
                protocol.encode_subscribe([b"flood-item-x"], (1, b"\x55" * 32))
            ]
        assert out, "empty FloodPlan"
        return out

    async def _run(self, host: str, port: int) -> None:
        frames = self._frames()
        hello = protocol.encode_hello(
            Hello(
                self.blocks[0].block_hash(),
                len(self.blocks) - 1,
                0,
                self.nonce,
            )
        )
        while not self._stopping:
            try:
                reader, writer = await self.transport.connect(
                    host,
                    port,
                    local_addr=(self.source, 0) if self.source else None,
                )
            except OSError:
                await asyncio.sleep(0.1)
                continue
            drain_task = None
            try:
                await protocol.write_frame(writer, hello)
                try:
                    await asyncio.wait_for(protocol.read_frame(reader), 5.0)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                    self.refused += 1
                    continue
                if not self.plan.squat:
                    # Keep the socket's inbound side drained so OUR read
                    # buffer never backpressures the victim's replies
                    # into its own send timeout — a squatter does the
                    # opposite on purpose.
                    async def _drain():
                        while True:
                            if not await reader.read(1 << 16):
                                return

                    drain_task = asyncio.create_task(_drain())
                i = 0
                while not self._stopping:
                    for _ in range(self.plan.burst):
                        writer.write(
                            struct.pack(">I", len(frames[i % len(frames)]))
                            + frames[i % len(frames)]
                        )
                        self.sent += 1
                        i += 1
                    await writer.drain()
                    if self.plan.pause_s:
                        await asyncio.sleep(self.plan.pause_s)
                    else:
                        await asyncio.sleep(0)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self.disconnects += 1
                await asyncio.sleep(0.05)
            finally:
                if drain_task is not None:
                    drain_task.cancel()
                writer.close()


class _Session:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        #: True after a deliberate mid-frame truncation: any further
        #: frame would desync the stream, so sends are suppressed.
        self.wedged = False


class HostilePeer:
    """A scriptable peer serving ``blocks`` under a ``FaultPlan``.

    Usage::

        peer = HostilePeer(make_blocks(30), plan=FaultPlan(
            swallow=frozenset({MsgType.GETBLOCKS})))
        await peer.start()            # victim dials 127.0.0.1:peer.port
        ...
        assert peer.requests[MsgType.GETBLOCKS] >= 1
        await peer.stop()

    ``requests`` counts every decoded frame by type; ``sessions`` counts
    connections accepted or dialed.  ``push`` sends a raw frame to every
    live session (e.g. an unsolicited CBLOCK); ``dial`` connects OUT to
    a victim, covering the inbound-attacker profiles of the liveness
    tests with the same machinery.
    """

    def __init__(
        self,
        blocks: list[Block],
        plan: FaultPlan = FaultPlan(),
        mempool_txs: tuple = (),
        transport=None,
        host: str = "127.0.0.1",
        rng=None,
    ):
        assert blocks, "need at least a genesis block"
        self.blocks = list(blocks)
        self.plan = plan
        self.mempool_txs = tuple(mempool_txs)
        self._pos = {b.block_hash(): i for i, b in enumerate(self.blocks)}
        #: Transport seam: real sockets by default; a netsim facade runs
        #: the identical FaultPlan over simulated links (``host`` is then
        #: the simulated listen address, ``rng`` pins the nonce so two
        #: same-seed runs trace identically).
        self.transport = transport if transport is not None else SOCKET_TRANSPORT
        self.host = host
        self.nonce = (
            rng.getrandbits(64) if rng is not None else secrets.randbits(64)
        ) | 1
        self.port: int | None = None
        self.requests: collections.Counter = collections.Counter()
        self.sessions = 0
        self._server = None
        # Ordered (dicts, not sets): teardown order is part of the
        # deterministic-trace contract under the simulator.
        self._tasks: dict[asyncio.Task, None] = {}
        self._live: dict[_Session, None] = {}
        self._fault_hits = 0
        self._snapshot_records = None  # lazy (manifest, chunks) cache

    def snapshot_records(self) -> tuple[bytes, list[bytes]]:
        """(manifest payload, chunk payloads) of the served chain's tip
        state — with the plan's ``snapshot_lie`` applied.  A "balance"
        lie is INTERNALLY CONSISTENT (the root commits to the lie), so
        every wire-level check passes and only background revalidation
        against the real history can expose it — exactly the attack the
        ASSUMED state exists to contain."""
        if self._snapshot_records is not None:
            return self._snapshot_records
        from p1_tpu_torch.chain import snapshot as chain_snapshot
        from p1_tpu_torch.chain.ledger import Ledger

        ledger = Ledger()
        for block in self.blocks:
            ledger.apply_block(block)
        balances = ledger.snapshot()
        nonces = ledger.nonces_snapshot()
        if self.plan.snapshot_lie == "balance":
            victim = sorted(balances)[0] if balances else "phantom"
            balances[victim] = balances.get(victim, 0) + 1000
        manifest_payload, chunks = chain_snapshot.build_records(
            len(self.blocks) - 1, self.blocks[-1], balances, nonces
        )
        if self.plan.snapshot_lie == "root":
            # Flip one state-root byte INSIDE the manifest payload: the
            # joiner's assembly check must refuse before adopting.
            manifest = chain_snapshot.parse_manifest(manifest_payload)
            bad = bytes([manifest_payload[37] ^ 0x01]) + manifest_payload[38:]
            manifest_payload = manifest_payload[:37] + bad
        self._snapshot_records = (manifest_payload, chunks)
        return self._snapshot_records

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> int:
        self._server = await self.transport.listen(self._on_conn, self.host, 0)
        self.port = self._server.port
        return self.port

    async def stop(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        for sess in list(self._live):
            sess.writer.close()
        self._live.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def dial(self, host: str, port: int) -> None:
        """Connect OUT to a victim (the inbound-attacker profile) and run
        the same scripted session over that socket."""
        reader, writer = await self.transport.connect(host, port)
        task = asyncio.create_task(self._session(reader, writer))
        self._tasks[task] = None
        task.add_done_callback(lambda t: self._tasks.pop(t, None))

    async def _on_conn(self, reader, writer) -> None:
        await self._session(reader, writer)

    # -- the scripted session --------------------------------------------

    def _hello(self) -> bytes:
        height = (
            self.plan.hello_height
            if self.plan.hello_height is not None
            else len(self.blocks) - 1
        )
        return protocol.encode_hello(
            Hello(
                self.blocks[0].block_hash(), height, self.port or 0, self.nonce
            )
        )

    async def _session(self, reader, writer) -> None:
        self.sessions += 1
        sess = _Session(reader, writer)
        self._live[sess] = None
        try:
            await self._send(sess, self._hello())
            while True:
                mtype, body = protocol.decode(
                    await protocol.read_frame(reader)
                )
                self.requests[mtype] += 1
                await self._handle(sess, mtype, body)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            ValueError,
        ):
            pass  # victim hung up (or stop() closed us) — session over
        finally:
            self._live.pop(sess, None)
            writer.close()

    async def _handle(self, sess: _Session, mtype: MsgType, body) -> None:
        plan = self.plan
        if mtype is MsgType.PING:
            if plan.answer_pings:
                await self._send(sess, protocol.encode_pong(body))
            return
        if mtype is MsgType.GETADDR:
            await self._send(sess, protocol.encode_addr([]))
            return
        if mtype not in _FAULTABLE:
            return  # pushes (BLOCK/TX/...) and late HELLOs: just counted
        fault = self._fault_for(mtype)
        if fault == "swallow":
            return
        if fault == "drop":
            sess.writer.close()
            return
        payload = self._answer(mtype, body)
        if payload is not None:
            await self._send(sess, payload, fault=fault)

    def _fault_for(self, mtype: MsgType) -> str | None:
        plan = self.plan
        if mtype in plan.swallow:
            hit = "swallow"
        elif plan.drop_at is mtype:
            hit = "drop"
        elif plan.truncate_at is mtype:
            hit = "truncate"
        else:
            return None
        self._fault_hits += 1
        if self._fault_hits <= plan.serve_before_fault:
            return None  # still in the honest prefix: stall mid-IBD later
        return hit

    def _after(self, locator: list[bytes]) -> list[Block]:
        start = 0
        if self.plan.stale_replies:
            start = 1  # ignore the locator: re-serve from genesis forever
        else:
            for h in locator:
                i = self._pos.get(h)
                if i is not None:
                    start = i + 1
                    break
        return self.blocks[start : start + self.plan.batch_limit]

    def _answer(self, mtype: MsgType, body) -> bytes | None:
        plan = self.plan
        if mtype is MsgType.GETBLOCKS:
            blocks = [] if plan.empty_replies else self._after(body)
            return protocol.encode_blocks(blocks)
        if mtype is MsgType.GETHEADERS:
            blocks = [] if plan.empty_replies else self._after(body)
            return protocol.encode_headers([b.header for b in blocks])
        if mtype is MsgType.GETMEMPOOL:
            if plan.mempool_empty_tail:
                return protocol.encode_mempool([], more=True)
            raws = [tx.serialize() for tx in self.mempool_txs]
            return protocol.encode_mempool(raws, more=plan.mempool_more)
        if mtype is MsgType.GETBLOCKTXN:
            bhash, indices = body
            i = self._pos.get(bhash)
            block = self.blocks[i] if i is not None else None
            if block is None or indices[-1] >= len(block.txs):
                return None
            return protocol.encode_blocktxn(
                bhash, [block.txs[j].serialize() for j in indices]
            )
        if mtype is MsgType.GETSNAPSHOT:
            start, count = body
            manifest_payload, chunks = self.snapshot_records()
            if count == 0:
                return protocol.encode_snapshot_manifest(manifest_payload)
            limit = (
                self.plan.snapshot_chunks
                if self.plan.snapshot_chunks is not None
                else len(chunks)
            )
            if start >= limit:
                return None  # truncated serve: stall mid-transfer
            return protocol.encode_snapshot_chunks(
                start, chunks[start : min(start + count, limit)]
            )
        return None

    # -- delivery --------------------------------------------------------

    async def push(self, payload: bytes) -> int:
        """Send one raw frame to every live session (unsolicited pushes:
        CBLOCK, BLOCK, TX...).  Returns the number of sessions reached."""
        n = 0
        for sess in list(self._live):
            try:
                await self._send(sess, payload)
                n += 1
            except (ConnectionError, OSError):
                pass
        return n

    async def _send(
        self, sess: _Session, payload: bytes, fault: str | None = None
    ) -> None:
        if sess.wedged:
            return
        plan = self.plan
        if plan.reply_delay_s:
            await asyncio.sleep(plan.reply_delay_s)
        frame = struct.pack(">I", len(payload)) + payload
        if fault == "truncate":
            sess.wedged = True
            sess.writer.write(frame[: max(1, len(frame) // 2)])
            await sess.writer.drain()
            return
        if plan.trickle_bps:
            # ~20 writes/s at the configured byte rate.
            chunk = max(1, int(plan.trickle_bps * 0.05))
            for off in range(0, len(frame), chunk):
                sess.writer.write(frame[off : off + chunk])
                await sess.writer.drain()
                await asyncio.sleep(0.05)
            return
        sess.writer.write(frame)
        await sess.writer.drain()
