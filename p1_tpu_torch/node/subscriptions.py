"""The wallet push plane: watch-filter subscriptions notified at block
connect, with failure as the design center.

A subscription is a set of watch items (account ids, txids — the same
byte strings the BIP158-analog block filters commit to) plus three
callables that abstract the session: ``send`` (enqueue one encoded
frame), ``buffer_size`` (bytes queued on the transport), ``close``
(disconnect).  The manager is deliberately transport-agnostic so the
same code pushes over real sockets (Node, QueryPlaneServer), simulated
transports (chaos), and in-process sinks (benchmarks) — the write
buffer IS the per-session queue, bounded by the same governor caps that
bound every other session.

Slow consumers degrade down a ladder instead of ballooning the write
gauge:

  coalesce   buffer > SUB_COALESCE_BYTES: non-matching header events
             are skipped (the wallet bridges the hole from the
             filter-header commitment chain); matches still go out.
  drop       buffer > drop_bytes: nothing goes out; the first dropped
             height is remembered and a single GAP event is emitted
             when the buffer drains, telling the wallet exactly which
             window to replay (its resume cursor stays valid).
  disconnect buffer > hard_bytes: the session is closed — same
             hard-cap-means-disconnect contract as node peers.

Trust model: events carry the full filter plus its commitment header
(``filter_header[i] = H(filter_hash[i] || filter_header[i-1])``), so a
wallet verifies linkage and re-matches locally; this plane never asks
to be believed.  Resume cursors are (height, filter_header) pairs and
are *verified* against the committed chain before replay — a cursor
the server cannot prove (pruned window, rebased chain, or a wallet
that last spoke to a liar) is refused by closing the session, which is
the wallet's signal to fail over to an archive replica.

Per-block match cost is O(filter decode + subs · items), not
O(subs · filter): the filter is decoded once into a value set and each
subscriber probes it (``filters.matches_values``), which is what makes
100k live subscriptions per host a benchmark number instead of a wish.

The port's copy of ``p1_tpu/node/subscriptions.py``.
"""

from __future__ import annotations

import time

from ..chain.filters import decode_value_set, filter_count, matches_values
from .protocol import BlockEvent, encode_event, encode_event_gap
from .governor import WRITE_QUEUE_GOSSIP_MAX, WRITE_QUEUE_MAX

# Buffer thresholds for the degradation ladder.  Coalesce kicks in well
# below the gossip soft cap so a merely-laggy wallet sheds header noise
# before it starts losing matches; drop reuses the gossip soft cap and
# disconnect the session hard cap, so one stalled subscriber can squat
# at most the same memory as one stalled peer.
SUB_COALESCE_BYTES = 256 << 10
SUB_DROP_BYTES = WRITE_QUEUE_GOSSIP_MAX
SUB_HARD_BYTES = WRITE_QUEUE_MAX

# Recent (height -> block hash) ring used to detect reorgs of already
# notified heights.  Deeper reorgs than this are re-pushed from the
# ring's floor; wallets verify linkage anyway.
_SENT_RING = 256

_OK = 0
_DROPPED = 1
_DEAD_HARD = 2
_DEAD_ERR = 3


class Subscription:
    """One live session's watch registration."""

    __slots__ = ("key", "items", "send", "buffer_size", "close", "gap_start", "coalesced")

    def __init__(self, key, items, send, buffer_size, close):
        self.key = key
        self.items = tuple(items)
        self.send = send
        self.buffer_size = buffer_size
        self.close = close
        self.gap_start: int | None = None
        self.coalesced = 0


class _HeightParts:
    """Everything notify needs for one connected height, built once and
    shared across every subscriber."""

    __slots__ = ("height", "bhash", "raw_header", "fheader", "filter", "values", "count", "index", "plain")

    def __init__(self, height, bhash, raw_header, fheader, fbytes, index):
        self.height = height
        self.bhash = bhash
        self.raw_header = raw_header
        self.fheader = fheader
        self.filter = fbytes
        self.values = decode_value_set(fbytes)
        self.count = filter_count(fbytes)
        self.index = index
        self.plain = encode_event(
            BlockEvent(height=height, raw_header=raw_header, filter_header=fheader,
                       filter=fbytes, matched=False, txids=())
        )


class SubscriptionManager:
    """Pushes block-connect events to registered watchers from a source.

    ``source`` is duck-typed with: ``tip_height`` (int property),
    ``hash_at(h)``, ``raw_header_at(h)``, ``filter_at(h)``,
    ``fheader_at(h)`` (each -> bytes | None), and
    ``block_items_at(h)`` -> dict[item_bytes, tuple[txid, ...]] | None
    (None when the block body is unavailable — matches then fall back
    to the probabilistic filter, txids empty, exactly the information a
    pruned replica honestly has).
    """

    def __init__(self, source, *, clock=time.monotonic, registry=None,
                 coalesce_bytes: int = SUB_COALESCE_BYTES,
                 drop_bytes: int = SUB_DROP_BYTES,
                 hard_bytes: int = SUB_HARD_BYTES):
        self._source = source
        self._clock = clock
        self._registry = registry
        self._coalesce_bytes = coalesce_bytes
        self._drop_bytes = drop_bytes
        self._hard_bytes = hard_bytes
        self._subs: dict = {}
        self._sent: dict[int, bytes] = {}
        self._next_height = 0
        # Ladder + lifecycle counters; ints here are the source of
        # truth, the registry only mirrors the latency histogram and
        # point-in-time gauges.
        self.events_pushed = 0
        self.events_coalesced = 0
        self.events_dropped = 0
        self.gap_events = 0
        self.replayed = 0
        self.disconnects_hard = 0
        self.disconnects_error = 0
        self.cursor_rejects = 0
        self.subscribed_total = 0
        self.drained_total = 0
        self.queue_depth_bytes = 0
        # History before this manager existed was never promised to
        # anyone — start the cursor at the source's current tip.
        self.reset_cursor()

    # -- registration -------------------------------------------------

    def __len__(self) -> int:
        return len(self._subs)

    @property
    def notified_height(self) -> int:
        return self._next_height - 1

    def reset_cursor(self) -> None:
        """Fast-forward to the source tip without building events —
        the boot/resume seam (a node that replayed its store grew the
        chain with nobody subscribed) and the idle fast path."""
        tip = self._source.tip_height
        self._next_height = tip + 1
        bhash = self._source.hash_at(tip)
        self._sent.clear()
        if bhash is not None:
            self._sent[tip] = bhash

    async def subscribe(self, key, items, cursor, *, send, buffer_size, close) -> bool:
        """Register a watcher; replay the committed window past ``cursor``
        first so the stream is gap-free from the wallet's last verified
        point.  Returns False (caller should close the session) when the
        cursor cannot be verified against the commitment chain."""
        old = self._subs.pop(key, None)
        if old is not None:
            self._gauge_live()
        sub = Subscription(key, items, send, buffer_size, close)
        if cursor is not None:
            start, cursor_fheader = cursor
            committed = self._source.fheader_at(start)
            if committed is None or committed != cursor_fheader:
                self.cursor_rejects += 1
                return False
            replay_from = start + 1
            # Replay everything already notified, then register.  The
            # catch-up loop re-checks because a block can connect while
            # replay sends are in flight; registration happens with no
            # await between the last replayed height and the insert, so
            # live pushes take over exactly where replay stopped.
            while True:
                target = self._next_height - 1
                if replay_from > target:
                    break
                for h in range(replay_from, target + 1):
                    parts = self._build(h)
                    if parts is None:
                        break
                    state = await self._deliver(sub, parts)
                    if state in (_DEAD_HARD, _DEAD_ERR):
                        self._count_dead(state)
                        return True
                    if state is _OK:
                        self.replayed += 1
                replay_from = target + 1
        self._subs[key] = sub
        self.subscribed_total += 1
        self._gauge_live()
        return True

    def unsubscribe(self, key) -> bool:
        sub = self._subs.pop(key, None)
        self._gauge_live()
        return sub is not None

    def drop(self, key) -> None:
        """Forget a watcher whose session died externally."""
        self._subs.pop(key, None)
        self._gauge_live()

    def close_all(self) -> None:
        for sub in list(self._subs.values()):
            try:
                sub.close()
            except Exception:
                pass
        self._subs.clear()
        self._gauge_live()

    async def drain(self) -> int:
        """Graceful shutdown (`p1 serve` on SIGTERM): push one final
        EVENTGAP carrying the next-to-come height to every live
        subscriber, then close them all; returns how many were drained.
        The wallet reads the gap as "this window will not arrive here —
        replay it elsewhere": its (height, filter_header) resume cursor
        stays exactly where its last verified event left it, so failover
        after a drain is gap-free by the same argument as failover after
        a crash, minus the dead-socket wait."""
        nxt = self._next_height
        drained = 0
        for sub in list(self._subs.values()):
            try:
                await sub.send(encode_event_gap(nxt, nxt))
            except Exception:
                pass
            try:
                sub.close()
            except Exception:
                pass
            drained += 1
        self._subs.clear()
        self.drained_total += drained
        self._gauge_live()
        return drained

    # -- notification -------------------------------------------------

    async def notify(self) -> None:
        """Push every newly connected (or reorged) height to all
        subscribers.  Safe to call redundantly; a no-op when the source
        tip has not moved."""
        if not self._subs:
            # Nobody listening: keep the cursor current so the first
            # subscriber starts from NOW, not from a replay of every
            # height connected while the room was empty.
            self.reset_cursor()
            return
        tip = self._source.tip_height
        h = min(self._next_height - 1, tip)
        while h >= 0:
            sent = self._sent.get(h)
            if sent is None or sent == self._source.hash_at(h):
                break
            h -= 1
        start = h + 1
        if start > tip:
            self._gauge_depth()
            return
        t0 = self._clock()
        for height in range(start, tip + 1):
            parts = self._build(height)
            if parts is None:
                break  # filter not committed yet (pruned body); retry on next connect
            await self._push_height(parts)
            self._sent[height] = parts.bhash
            self._next_height = height + 1
            floor = height - _SENT_RING
            while self._sent and min(self._sent) < floor:
                del self._sent[min(self._sent)]
        if self._registry is not None:
            self._registry.observe("subs.notify_s", self._clock() - t0)

    def _build(self, height):
        src = self._source
        bhash = src.hash_at(height)
        raw = src.raw_header_at(height)
        fheader = src.fheader_at(height)
        fbytes = src.filter_at(height)
        if bhash is None or raw is None or fheader is None or fbytes is None:
            return None
        return _HeightParts(height, bhash, raw, fheader, fbytes, src.block_items_at(height))

    def _match(self, parts, items):
        index = parts.index
        if index is not None:
            txids: list[bytes] = []
            for it in items:
                txids.extend(index.get(it, ()))
            if txids:
                return True, tuple(dict.fromkeys(txids))
        if matches_values(parts.values, parts.count, parts.bhash, items):
            return True, ()
        return False, ()

    async def _deliver(self, sub, parts) -> int:
        try:
            buf = sub.buffer_size()
        except Exception:
            return _DEAD_ERR
        if buf > self.queue_depth_bytes:
            self.queue_depth_bytes = buf
        if buf >= self._hard_bytes:
            return _DEAD_HARD
        if buf >= self._drop_bytes:
            if sub.gap_start is None:
                sub.gap_start = parts.height
            self.events_dropped += 1
            return _DROPPED
        matched, txids = self._match(parts, sub.items)
        try:
            if sub.gap_start is not None:
                await sub.send(encode_event_gap(sub.gap_start, parts.height - 1))
                sub.gap_start = None
                self.gap_events += 1
            if matched:
                payload = encode_event(
                    BlockEvent(height=parts.height, raw_header=parts.raw_header,
                               filter_header=parts.fheader, filter=parts.filter,
                               matched=True, txids=txids)
                )
            elif buf >= self._coalesce_bytes:
                sub.coalesced += 1
                self.events_coalesced += 1
                return _OK
            else:
                payload = parts.plain
            await sub.send(payload)
        except Exception:
            return _DEAD_ERR
        self.events_pushed += 1
        return _OK

    async def _push_height(self, parts) -> None:
        dead: list[tuple[object, int]] = []
        self.queue_depth_bytes = 0
        for key, sub in list(self._subs.items()):
            state = await self._deliver(sub, parts)
            if state in (_DEAD_HARD, _DEAD_ERR):
                dead.append((key, state))
        for key, state in dead:
            sub = self._subs.pop(key, None)
            if sub is not None:
                self._count_dead(state)
                try:
                    sub.close()
                except Exception:
                    pass
        if dead:
            self._gauge_live()
        self._gauge_depth()

    def _count_dead(self, state: int) -> None:
        if state is _DEAD_HARD:
            self.disconnects_hard += 1
        else:
            self.disconnects_error += 1

    # -- telemetry ----------------------------------------------------

    def _gauge_live(self) -> None:
        if self._registry is not None:
            self._registry.gauge("subs.live").set(float(len(self._subs)))

    def _gauge_depth(self) -> None:
        if self._registry is not None:
            self._registry.gauge("subs.queue_depth_bytes").set(float(self.queue_depth_bytes))

    def snapshot(self) -> dict:
        return {
            "live": len(self._subs),
            "subscribed_total": self.subscribed_total,
            "events_pushed": self.events_pushed,
            "events_coalesced": self.events_coalesced,
            "events_dropped": self.events_dropped,
            "gap_events": self.gap_events,
            "replayed": self.replayed,
            "disconnects_hard": self.disconnects_hard,
            "disconnects_error": self.disconnects_error,
            "cursor_rejects": self.cursor_rejects,
            "drained_total": self.drained_total,
            "queue_depth_bytes": self.queue_depth_bytes,
        }


def block_items_index(block) -> dict:
    """item bytes -> (txid, ...) for one block: every txid plus every
    sender/recipient account id (utf-8) — exactly the item universe the
    block's filter commits to (chain/filters.py ``filter_items``), so
    an exact-index hit and a filter probe agree on what is watchable."""
    index: dict[bytes, tuple] = {}
    for tx in block.txs:
        txid = tx.txid()
        for item in (txid, tx.sender.encode("utf-8"), tx.recipient.encode("utf-8")):
            prev = index.get(item)
            index[item] = prev + (txid,) if prev else (txid,)
    return index


class ChainSubSource:
    """Adapter: a ``chain.Chain`` (with its ``filter_headers``
    commitment chain and ``filter_index``) as a notification source."""

    __slots__ = ("_chain_ref",)

    def __init__(self, chain):
        # A zero-arg callable late-binds the chain: the node REPLACES
        # ``self.chain`` on store/snapshot resume and live re-base, and
        # the push plane must follow it, not a stale object.
        self._chain_ref = chain if callable(chain) else (lambda: chain)

    @property
    def _chain(self):
        return self._chain_ref()

    @property
    def tip_height(self) -> int:
        return min(self._chain.height, self._chain.filter_headers.tip_height)

    def hash_at(self, height):
        return self._chain.main_hash_at(height)

    def raw_header_at(self, height):
        bhash = self._chain.main_hash_at(height)
        if bhash is None:
            return None
        header = self._chain.header_of(bhash)
        if header is None:
            return None
        return header.serialize()

    def filter_at(self, height):
        bhash = self._chain.main_hash_at(height)
        if bhash is None:
            return None
        return self._chain.block_filter(bhash)

    def fheader_at(self, height):
        return self._chain.filter_headers.header_at(height)

    def block_items_at(self, height):
        bhash = self._chain.main_hash_at(height)
        if bhash is None or not self._chain.body_available(bhash):
            return None
        blk = self._chain.get(bhash)
        if blk is None:
            return None
        return block_items_index(blk)
