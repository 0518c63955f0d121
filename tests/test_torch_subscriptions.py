"""The port's wallet push plane (``node/subscriptions.py``) against the JAX
package's.

Mirrors tests/test_subscriptions.py: the reference's cases, run against
``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
``_config`` and ``build_chain`` are tests/test_queryplane.py's, on the port.

The wallet push plane: commitment-chained filters,
watch subscriptions, graceful degradation, and trustless failover.

Four property families anchor the tier:

- **commitment = pure function of block bytes**: the filter-header
  chain (``header[i] = H(filter_hash[i] || header[i-1])``, genesis
  anchored at zero) is derived identically by every honest holder of
  the same blocks, truncate-and-extends across reorgs, and stays
  honestly SHORT when a body is unavailable — never a guess.
- **push stream = the chain**: a SubscriptionManager delivers one
  event per connected height, gap-free, with exact txids when the body
  is at hand; slow consumers walk the coalesce → drop-to-cursor →
  disconnect ladder and a drained dropper gets ONE gap notice naming
  exactly the replay window.
- **resume = replay**: a cursor the server can prove against its
  committed chain replays the missed window before live events take
  over; a cursor it cannot prove is refused by disconnect (the
  failover signal), never guessed around.
- **lying replica = demoted replica**: a replica serving a
  self-consistent forged filter stream (the missed-confirmation
  attack) is caught by cross-check + hash-pinned adjudication,
  demoted, and the watch fails over with ZERO missed confirmations —
  the stream stays gap-free across the liar.

``TestWatchEndToEnd``'s replica cases
(``test_replica_push_with_cursor_resume``,
``test_lying_replica_demoted_failover_zero_missed``,
``test_lone_lying_replica_fails_the_watch_loudly``) watch the port's
``serve_replica``.
"""

import asyncio
import hashlib
import random

import pytest

from test_torch_node import CHUNK, DIFF, fund, run, wait_until
from torch_testutil import NodeConfig, account, key_for

from p1_tpu_torch.chain import Chain, save_chain
from p1_tpu_torch.chain import filters as fmod
from p1_tpu_torch.chain.filters import (
    GENESIS_FILTER_HEADER,
    FilterHeaderChain,
    filter_hash,
    next_filter_header,
)
from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.client import CommitmentViolation, get_filter_headers, watch
from p1_tpu_torch.node.protocol import GapEvent, MsgType
from p1_tpu_torch.node.queryplane import serve_replica
from p1_tpu_torch.node.subscriptions import (
    SubscriptionManager,
    block_items_index,
)


# -- fixtures -------------------------------------------------------------


def _fake_heights(n: int, seed: int = 0):
    """n synthetic heights: deterministic block hashes and VALID filter
    encodings (the commitment chain hashes filter bytes, it never
    decodes them — but the manager does, so stay well-formed)."""
    hashes = [
        hashlib.sha256(b"blk-%d-%d" % (seed, h)).digest() for h in range(n)
    ]
    filters = [
        fmod.encode_filter(hashes[h], {b"item-%d" % h}) for h in range(n)
    ]
    return hashes, filters


def _expected_chain(filters):
    out, prev = [], GENESIS_FILTER_HEADER
    for f in filters:
        prev = next_filter_header(filter_hash(f), prev)
        out.append(prev)
    return out



def _config(peers=(), **kw) -> NodeConfig:
    """tests/test_queryplane.py's node config, on the host."""
    kw.setdefault("difficulty", DIFF)
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("mine", False)
    return NodeConfig(peers=tuple(peers), **kw)


def build_chain(
    n_blocks: int,
    difficulty: int = 1,
    rng: random.Random | None = None,
    labels=("alice", "bob", "carol", "dave"),
    txs_per_block: int = 3,
) -> Chain:
    """A valid chain whose blocks carry randomized signed transfers
    between the label accounts — the filter property tests' fixture."""
    rng = rng or random.Random(0)
    chain = Chain(difficulty)
    tag = chain.genesis.block_hash()
    miner = Miner(backend=get_backend("cpu"), chunk=4096)
    seqs = {label: 0 for label in labels}
    funded = set()
    for height in range(1, n_blocks + 1):
        payer = rng.choice(labels)
        txs = [Transaction.coinbase(account(payer), height)]
        for label in list(funded):
            for _ in range(rng.randrange(0, txs_per_block)):
                rcpt = rng.choice(labels + ("merchant", "exchange"))
                if chain.balance(account(label)) < 2 * txs_per_block + 2:
                    break
                txs.append(
                    Transaction.transfer(
                        key_for(label),
                        account(rcpt) if rcpt in labels else rcpt,
                        1,
                        1,
                        seqs[label],
                        chain=tag,
                    )
                )
                seqs[label] += 1
        funded.add(payer)
        parent = chain.tip
        draft = BlockHeader(
            version=1,
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=parent.header.timestamp + 60,
            difficulty=difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        res = chain.add_block(Block(sealed, tuple(txs)))
        assert res.status.value == "accepted", res.reason
    return chain


class _TipSource:
    """A ChainSubSource over a prebuilt chain with a MOVABLE tip, so a
    test connects one block at a time; ``forge`` overlays forged
    (filter, fheader, index) triples per height — the lying-server
    stand-in for manager-level tests."""

    def __init__(self, chain, tip: int = 0):
        self._chain = chain
        self.tip = tip
        self.forge: dict[int, tuple] = {}

    @property
    def tip_height(self) -> int:
        return self.tip

    def hash_at(self, height):
        if not 0 <= height <= self.tip:
            return None
        return self._chain.main_hash_at(height)

    def raw_header_at(self, height):
        bhash = self.hash_at(height)
        return None if bhash is None else self._chain.header_of(bhash).serialize()

    def filter_at(self, height):
        if height in self.forge:
            return self.forge[height][0]
        bhash = self.hash_at(height)
        return None if bhash is None else self._chain.block_filter(bhash)

    def fheader_at(self, height):
        if height in self.forge:
            return self.forge[height][1]
        if height > self.tip:
            return None
        return self._chain.filter_headers.header_at(height)

    def block_items_at(self, height):
        if height in self.forge:
            return self.forge[height][2]
        bhash = self.hash_at(height)
        return None if bhash is None else block_items_index(self._chain.get(bhash))


class _Sink:
    """One subscriber's transport stand-in: captures frames, reports a
    settable buffer depth, remembers close()."""

    def __init__(self):
        self.frames: list[bytes] = []
        self.buf = 0
        self.closed = False
        self.fail = False

    async def send(self, payload: bytes) -> None:
        if self.fail:
            raise ConnectionResetError("sink gone")
        self.frames.append(payload)

    def buffer_size(self) -> int:
        return self.buf

    def close(self) -> None:
        self.closed = True

    def events(self):
        out = []
        for fr in self.frames:
            mtype, body = protocol.decode(fr)
            assert mtype is MsgType.EVENT
            out.append(body)
        return out


def _mgr(source, **kw):
    kw.setdefault("coalesce_bytes", 100)
    kw.setdefault("drop_bytes", 1_000)
    kw.setdefault("hard_bytes", 10_000)
    return SubscriptionManager(source, **kw)


async def _sub(mgr, sink, key, items, cursor=None) -> bool:
    return await mgr.subscribe(
        key, items, cursor,
        send=sink.send, buffer_size=sink.buffer_size, close=sink.close,
    )


# -- the commitment chain -------------------------------------------------


class TestFilterHeaderChain:
    def test_genesis_anchor_and_linkage(self):
        hashes, filters = _fake_heights(6)
        fhc = FilterHeaderChain()
        changed = fhc.sync(5, hashes.__getitem__, filters.__getitem__)
        assert changed == list(range(6))
        assert fhc.tip_height == 5
        assert fhc.header_at(-1) == GENESIS_FILTER_HEADER
        want = _expected_chain(filters)
        for h in range(6):
            assert fhc.header_at(h) == want[h]
            assert fhc.hash_at(h) == hashes[h]
        # Resync with nothing new is a no-op (the O(1) common case).
        assert fhc.sync(5, hashes.__getitem__, filters.__getitem__) == []
        assert fhc.rebuilds == 0

    def test_two_sources_same_blocks_identical_chains(self):
        """The trust property, literally: the chain is a pure function
        of the block bytes — two independent syncs agree everywhere."""
        hashes, filters = _fake_heights(8)
        a, b = FilterHeaderChain(), FilterHeaderChain()
        a.sync(7, hashes.__getitem__, filters.__getitem__)
        # b syncs incrementally in three visits; same result.
        for tip in (2, 5, 7):
            b.sync(tip, hashes.__getitem__, filters.__getitem__)
        assert [a.header_at(h) for h in range(8)] == [
            b.header_at(h) for h in range(8)
        ]

    def test_reorg_truncates_and_reextends(self):
        hashes, filters = _fake_heights(8)
        fhc = FilterHeaderChain()
        fhc.sync(7, hashes.__getitem__, filters.__getitem__)
        before = [fhc.header_at(h) for h in range(8)]
        # Fork from height 5: new hashes AND new filters above.
        fork_h, fork_f = _fake_heights(8, seed=1)
        hashes[5:], filters[5:] = fork_h[5:], fork_f[5:]
        changed = fhc.sync(7, hashes.__getitem__, filters.__getitem__)
        assert changed == [5, 6, 7]
        assert fhc.rebuilds == 1
        after = [fhc.header_at(h) for h in range(8)]
        assert after[:5] == before[:5]
        assert after[5:] == _expected_chain(filters)[5:]
        assert all(a != b for a, b in zip(after[5:], before[5:]))

    def test_range_is_all_or_nothing(self):
        hashes, filters = _fake_heights(5)
        fhc = FilterHeaderChain()
        fhc.sync(4, hashes.__getitem__, filters.__getitem__)
        assert len(fhc.range(0, 5)) == 5
        assert len(fhc.range(2, 3)) == 3
        # Any uncommitted part of the span: refusal, not a partial lie.
        assert fhc.range(0, 6) == []
        assert fhc.range(3, 3) == []
        assert fhc.range(-1, 2) == []
        assert fhc.range(2, 0) == []

    def test_unavailable_filter_stays_honestly_short(self):
        hashes, filters = _fake_heights(6)

        def gappy(h):
            return None if h == 3 else filters[h]

        fhc = FilterHeaderChain()
        changed = fhc.sync(5, hashes.__getitem__, gappy)
        assert changed == [0, 1, 2]
        assert fhc.tip_height == 2
        assert fhc.header_at(3) is None
        # The body shows up (backfill/unspill): extension resumes and
        # lands on the same chain a never-gapped sync produces.
        fhc.sync(5, hashes.__getitem__, filters.__getitem__)
        assert [fhc.header_at(h) for h in range(6)] == _expected_chain(filters)


class TestSharedDecodeEquivalence:
    def test_matches_values_equals_matches_any(self):
        """The 100k-subs fast path (decode once, probe per subscriber)
        answers exactly like the reference matcher, present and absent
        items alike, across real randomized blocks."""
        rng = random.Random(7)
        chain = build_chain(6, difficulty=1, rng=rng)
        for h in range(0, chain.height + 1):
            bhash = chain.main_hash_at(h)
            fbytes = chain.block_filter(bhash)
            values = fmod.decode_value_set(fbytes)
            count = fmod.filter_count(fbytes)
            block = chain.get(bhash)
            present = list(fmod.filter_items(block))
            absent = [b"absent-%d-%d" % (h, i) for i in range(20)]
            for it in present + absent:
                assert fmod.matches_values(
                    values, count, bhash, [it]
                ) == fmod.matches_any(fbytes, bhash, [it]), (h, it)
            probe = [rng.choice(present), b"cold"] if present else [b"cold"]
            assert fmod.matches_values(
                values, count, bhash, probe
            ) == fmod.matches_any(fbytes, bhash, probe)


# -- the manager: stream shape and the degradation ladder -----------------


class TestSubscriptionManager:
    def _chain(self, n=6):
        return build_chain(n, difficulty=1, rng=random.Random(3))

    def test_push_stream_is_gap_free_and_committed(self):
        chain = self._chain()
        src = _TipSource(chain)
        mgr = _mgr(src)
        bob = account("bob").encode()
        sink = _Sink()

        async def scenario():
            assert await _sub(mgr, sink, 1, [bob])
            for tip in range(1, chain.height + 1):
                src.tip = tip
                await mgr.notify()

        run(scenario())
        evs = sink.events()
        assert [e.height for e in evs] == list(range(1, chain.height + 1))
        prev = src.fheader_at(0)
        for e in evs:
            bhash = chain.main_hash_at(e.height)
            fh = next_filter_header(filter_hash(e.filter), prev)
            assert e.filter_header == fh  # the server's own commitment
            prev = fh
            truth = block_items_index(chain.get(bhash)).get(bob, ())
            assert e.matched == bool(truth)
            assert tuple(e.txids) == tuple(dict.fromkeys(truth))
        assert mgr.events_pushed == len(evs)
        # Redundant notify with a still tip is a no-op.
        run(mgr.notify())
        assert len(sink.frames) == len(evs)

    def test_coalesce_skips_plain_but_delivers_matches(self):
        chain = self._chain()
        src = _TipSource(chain)
        mgr = _mgr(src)
        bob = account("bob").encode()
        hot, cold = _Sink(), _Sink()
        hot.buf = cold.buf = 100  # >= coalesce, < drop

        async def scenario():
            assert await _sub(mgr, hot, 1, [bob])
            assert await _sub(mgr, cold, 2, [b"nobody-ever-pays-this"])
            for tip in range(1, chain.height + 1):
                src.tip = tip
                await mgr.notify()

        run(scenario())
        touched = {
            h
            for h in range(1, chain.height + 1)
            if block_items_index(
                chain.get(chain.main_hash_at(h))
            ).get(bob)
        }
        assert touched  # the fixture pays bob somewhere
        # Matches cross the coalesce bar; plain headers do not.
        assert {e.height for e in hot.events()} == touched
        assert all(e.matched for e in hot.events())
        assert cold.frames == []  # every cold event coalesced away
        skipped = (chain.height - len(touched)) + chain.height
        assert mgr.events_coalesced == skipped
        assert mgr.gap_events == 0  # a coalesce hole is not a gap

    def test_drop_to_cursor_emits_one_gap_naming_the_window(self):
        chain = self._chain()
        src = _TipSource(chain)
        mgr = _mgr(src)
        sink = _Sink()

        async def scenario():
            assert await _sub(mgr, sink, 1, [account("bob").encode()])
            src.tip = 1
            await mgr.notify()
            sink.buf = 1_000  # over the drop threshold: stall
            for tip in (2, 3, 4):
                src.tip = tip
                await mgr.notify()
            assert mgr.events_dropped == 3
            sink.buf = 0  # drained
            src.tip = 5
            await mgr.notify()

        run(scenario())
        evs = sink.events()
        assert evs[0].height == 1
        gap = evs[1]
        assert isinstance(gap, GapEvent)
        assert (gap.start, gap.end) == (2, 4)  # exactly the missed window
        assert evs[2].height == 5
        assert mgr.gap_events == 1

    def test_hard_cap_disconnects_the_squatter(self):
        chain = self._chain(3)
        src = _TipSource(chain)
        mgr = _mgr(src)
        sink = _Sink()
        sink.buf = 10_000

        async def scenario():
            assert await _sub(mgr, sink, 1, [b"x"])
            src.tip = 1
            await mgr.notify()

        run(scenario())
        assert sink.closed
        assert len(mgr) == 0
        assert mgr.disconnects_hard == 1
        assert sink.frames == []

    def test_send_error_disconnects(self):
        chain = self._chain(3)
        src = _TipSource(chain)
        mgr = _mgr(src)
        sink = _Sink()
        sink.fail = True

        async def scenario():
            assert await _sub(mgr, sink, 1, [b"x"])
            src.tip = 1
            await mgr.notify()

        run(scenario())
        assert sink.closed
        assert len(mgr) == 0
        assert mgr.disconnects_error == 1

    def test_cursor_replay_is_gap_free_then_live_takes_over(self):
        chain = self._chain()
        src = _TipSource(chain)
        mgr = _mgr(src)
        keep = _Sink()

        async def scenario():
            # One resident keeps the manager's cursor advancing.
            assert await _sub(mgr, keep, 1, [b"resident"])
            for tip in range(1, 5):
                src.tip = tip
                await mgr.notify()
            late = _Sink()
            cursor = (2, src.fheader_at(2))
            assert await _sub(mgr, late, 2, [b"late"], cursor)
            assert [e.height for e in late.events()] == [3, 4]  # replayed
            assert mgr.replayed == 2
            src.tip = 5
            await mgr.notify()
            assert [e.height for e in late.events()] == [3, 4, 5]

        run(scenario())

    def test_unprovable_cursor_is_refused(self):
        chain = self._chain()
        src = _TipSource(chain, tip=4)
        mgr = _mgr(src)
        sink = _Sink()

        async def scenario():
            ok = await _sub(mgr, sink, 1, [b"x"], (2, b"\x55" * 32))
            assert not ok
            beyond = await _sub(mgr, sink, 2, [b"x"], (99, b"\x55" * 32))
            assert not beyond

        run(scenario())
        assert mgr.cursor_rejects == 2
        assert len(mgr) == 0

    def test_reorged_height_is_repushed(self):
        chain = self._chain()
        src = _TipSource(chain)
        mgr = _mgr(src)
        sink = _Sink()
        k = 4

        async def scenario():
            assert await _sub(mgr, sink, 1, [b"x"])
            for tip in range(1, k + 1):
                src.tip = tip
                await mgr.notify()
            # A competing branch replaces height k (forge overlays a
            # new hash by changing the filter/fheader the source
            # serves; hash_at must change too for walk-back to see it).
            alt_hash = hashlib.sha256(b"fork").digest()
            alt_filter = fmod.encode_filter(alt_hash, {b"forked"})
            alt_fh = next_filter_header(
                filter_hash(alt_filter), src.fheader_at(k - 1)
            )
            real_hash_at = src.hash_at
            real_raw = src.raw_header_at(k)
            src.hash_at = lambda h: alt_hash if h == k else real_hash_at(h)
            real_raw_at = src.raw_header_at
            src.raw_header_at = (
                lambda h: real_raw if h == k else real_raw_at(h)
            )
            src.forge[k] = (alt_filter, alt_fh, {})
            await mgr.notify()

        run(scenario())
        heights = [e.height for e in sink.events()]
        assert heights == [1, 2, 3, 4, 4]  # k re-pushed after the reorg
        last = sink.events()[-1]
        assert last.filter_header != sink.events()[-2].filter_header

    def test_empty_room_fast_forwards_no_replay_storm(self):
        chain = self._chain()
        src = _TipSource(chain, tip=chain.height)
        mgr = _mgr(src)
        sink = _Sink()

        async def scenario():
            await mgr.notify()  # nobody listening: cursor keeps up
            assert await _sub(mgr, sink, 1, [b"x"])
            await mgr.notify()

        run(scenario())
        assert sink.frames == []  # history was never promised


# -- end to end: node and replica push, the lying replica -----------------


class TestWatchEndToEnd:
    def test_node_push_submit_confirm_watch(self):
        """The SLO row's shape: a watch session on a mining node sees
        every block, gap-free and verified, and the submitted payment
        arrives as a matched event with its exact txid."""

        async def scenario():
            node = Node(_config())
            await node.start()
            gen = None
            try:
                await fund(node, "alice", blocks=2)
                gen = watch(
                    "127.0.0.1", node.port, ["push-rcpt"], DIFF,
                    max_session_failures=3,
                )
                agen = gen.__aiter__()
                node.miner_id = account("alice")
                node.start_mining()
                # First event proves the session is subscribed BEFORE
                # the payment exists — no mine-before-subscribe race.
                first = await asyncio.wait_for(agen.__anext__(), 30)
                tx = Transaction.transfer(
                    key_for("alice"), "push-rcpt", 1, 1, 0,
                    chain=node.chain.genesis.block_hash(),
                )
                await node.submit_tx(tx)
                heights = [first["height"]]
                matched = None
                while matched is None:
                    ev = await asyncio.wait_for(agen.__anext__(), 30)
                    heights.append(ev["height"])
                    if ev["matched"]:
                        matched = ev
                await node.stop_mining()
                assert heights == list(
                    range(heights[0], heights[0] + len(heights))
                )
                assert tx.txid() in matched["txids"]
                assert matched["peer"] == ("127.0.0.1", node.port)
                # The pushed commitment is the node's own chain.
                assert (
                    node.chain.filter_headers.header_at(matched["height"])
                    == matched["filter_header"]
                )
            finally:
                if gen is not None:
                    await gen.aclose()
                await node.stop()

        run(scenario())


    def _forge_replica(self, srv, from_height: int) -> None:
        """Turn a replica into a self-consistent liar: from
        ``from_height`` up, serve filters that omit every real item
        (the missed-confirmation attack) and recompute the commitment
        chain over the forged filter hashes, so linkage verifies and
        only comparison with an honest holder can catch it."""
        view = srv.view
        entries = view.filter_headers._entries
        forged: dict[int, bytes] = {}
        prev = entries[from_height - 1][1]
        for h in range(from_height, len(entries)):
            bhash = entries[h][0]
            fake = fmod.encode_filter(bhash, {b"watch-elsewhere"})
            forged[h] = fake
            prev = next_filter_header(filter_hash(fake), prev)
            entries[h] = (bhash, prev)
        real_filter_at = view.filter_at
        view.filter_at = (
            lambda h: forged[h] if h in forged else real_filter_at(h)
        )
        real_items_at = view.block_items_at
        view.block_items_at = (
            lambda h: {} if h in forged else real_items_at(h)
        )

    def test_replica_push_with_cursor_resume(self, tmp_path):
        """Watch a replica from a verified past cursor: the committed
        window replays first (gap-free), then refresh-driven live
        events continue the same stream as the node keeps mining."""
        store = str(tmp_path / "chain.dat")

        async def scenario():
            node = Node(_config(store_path=store))
            await node.start()
            srv, gen = None, None
            try:
                await fund(node, "alice", blocks=4)
                srv = await serve_replica(store, DIFF, refresh_interval_s=0.05)
                assert await wait_until(
                    lambda: srv.view.filter_headers.tip_height
                    >= node.chain.height
                )
                cursor_h = 2
                (fh,) = await get_filter_headers(
                    "127.0.0.1", srv.port, cursor_h, 1, DIFF
                )
                gen = watch(
                    "127.0.0.1", srv.port, [account("alice").encode()],
                    DIFF, cursor=(cursor_h, fh), max_session_failures=5,
                )
                agen = gen.__aiter__()
                heights = []
                for _ in range(node.chain.height - cursor_h):
                    ev = await asyncio.wait_for(agen.__anext__(), 30)
                    heights.append(ev["height"])
                    assert ev["matched"]  # every block pays alice
                assert heights == list(range(cursor_h + 1, node.chain.height + 1))
                # Live tail: mine more, the refresh loop pushes it.
                await fund(node, "alice", blocks=1)
                ev = await asyncio.wait_for(agen.__anext__(), 30)
                assert ev["height"] == heights[-1] + 1
            finally:
                if gen is not None:
                    await gen.aclose()
                if srv is not None:
                    await srv.stop()
                await node.stop()

        run(scenario())

    def test_lying_replica_demoted_failover_zero_missed(self, tmp_path):
        """The acceptance scenario, literally: one of two replicas
        forges its filter stream from height k to hide a payment.  A
        watch anchored at an honest past cursor rides the liar while it
        tells the truth, catches the forgery at k via cross-check plus
        hash-pinned adjudication (CommitmentViolation → demote), fails
        over to the honest replica, and the yielded stream is STILL
        gap-free with the hidden payment delivered — zero missed
        confirmations across the liar."""
        store = str(tmp_path / "chain.dat")
        chain = build_chain(8, difficulty=1, rng=random.Random(11))

        def paid_heights(item):
            return {
                h
                for h in range(1, chain.height + 1)
                if block_items_index(
                    chain.get(chain.main_hash_at(h))
                ).get(item)
            }

        # Pick a watched account the fixture pays late enough that the
        # forgery window can hide a real payment (the chain's tx mix
        # varies with the hash seed; the property must not).
        bob, paid, k = None, None, 0
        for label in ("bob", "carol", "dave", "alice"):
            item = account(label).encode()
            got = paid_heights(item)
            if got and max(got) >= 3:
                bob, paid, k = item, got, max(got)
                break
        assert bob is not None
        save_chain(chain, store)

        async def scenario():
            liar = await serve_replica(store, 1, refresh_interval_s=0.1)
            honest = await serve_replica(store, 1, refresh_interval_s=0.1)
            gen = None
            try:
                self._forge_replica(liar, k)
                anchor_h = 1
                (fh,) = await get_filter_headers(
                    "127.0.0.1", honest.port, anchor_h, 1, 1
                )
                gen = watch(
                    "127.0.0.1", liar.port, [bob], 1,
                    cursor=(anchor_h, fh),
                    fallback_peers=[("127.0.0.1", honest.port)],
                    cross_check_every=1,
                    reconnect_delay_s=0.05,
                    max_session_failures=10,
                )
                events = []
                async for ev in gen:
                    events.append(ev)
                    if ev["height"] == chain.height:
                        break
                heights = [e["height"] for e in events]
                assert heights == list(range(anchor_h + 1, chain.height + 1))
                # Zero missed confirmations: every bob-paying height in
                # the window is a matched event, INCLUDING the forged
                # ones — they were served by the honest replica.
                got = {e["height"] for e in events if e["matched"]}
                assert got == {h for h in paid if h > anchor_h}
                by_height = {e["height"]: e for e in events}
                assert by_height[k]["peer"] == ("127.0.0.1", honest.port)
                assert any(
                    e["peer"] == ("127.0.0.1", liar.port)
                    for e in events
                    if e["height"] < k
                )
                # The verdict stuck server-side too: the liar pushed at
                # least one event, then lost the session for good.
                assert liar.subscriptions.snapshot()["live"] == 0
                # And every yielded commitment matches the true chain.
                for e in events:
                    assert (
                        chain.filter_headers.header_at(e["height"])
                        == e["filter_header"]
                    )
            finally:
                if gen is not None:
                    await gen.aclose()
                await liar.stop()
                await honest.stop()

        run(scenario())

    def test_lone_lying_replica_fails_the_watch_loudly(self, tmp_path):
        """No fallback to adjudicate against: a filter that breaks the
        H-link from the caller's verified cursor is still caught
        LOCALLY and the watch dies with CommitmentViolation, never
        yielding the forged event as verified."""
        store = str(tmp_path / "chain.dat")
        chain = build_chain(5, difficulty=1, rng=random.Random(2))
        save_chain(chain, store)

        async def scenario():
            srv = await serve_replica(store, 1, refresh_interval_s=0.1)
            gen = None
            try:
                # Forge the filters but NOT the commitment chain: the
                # served fheader no longer extends H(fhash || prev).
                view = srv.view
                real = view.filter_at
                view.filter_at = lambda h: (
                    fmod.encode_filter(b"\x99" * 32, {b"zzz"})
                    if h >= 3
                    else real(h)
                )
                (fh,) = await get_filter_headers(
                    "127.0.0.1", srv.port, 1, 1, 1
                )
                gen = watch(
                    "127.0.0.1", srv.port, [b"whatever"], 1,
                    cursor=(1, fh), max_session_failures=3,
                )
                heights = []
                with pytest.raises(CommitmentViolation):
                    async for ev in gen:
                        heights.append(ev["height"])
                assert heights == [2]  # verified up to the forgery only
            finally:
                if gen is not None:
                    await gen.aclose()
                await srv.stop()

        run(scenario())


