"""The port's query serving plane (``node/queryplane.py``) against the JAX package's.

Mirrors tests/test_queryplane.py: the reference's cases, run against
``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``), transfers signed by the JAX package's keys
and carried into the port by their bytes, and the ``device`` signature
rung pinned to its plain version; the slow set is the reference's.

The query serving plane: compact block filters, the
reorg-safe proof cache, and mmap read replicas.

Three property families anchor the tier:

- **filter ⊇ truth**: on randomized blocks, the compact filter's match
  set is a superset of the true match set — zero false negatives, ever
  (the light client's correctness rests on skipping non-matching blocks
  unconditionally) — while the false-positive rate stays under the
  designed bound, MEASURED on a deliberately lossy parameterization
  (the production 1/784931 rate would vacuously measure 0).
- **cached == fresh**: a proof served through the cache (template +
  serialized-payload memo + tip patch) is byte-identical to one built
  from scratch, and a reorg invalidates every cached proof for the
  orphaned blocks — never served stale.
- **replica == node**: a flock-free mmap replica serves the same
  headers/filters/proofs as the node writing the store, including for
  blocks appended AFTER the replica attached (the refresh path), and
  never takes the writer lock.
"""

import asyncio
import os
import random
import struct

import pytest

from test_torch_node import CHUNK, DIFF, fund, run, wait_until
from torch_testutil import account, key_for, stx

from p1_tpu_torch.chain import Chain, ChainStore, save_chain, verify_tx_proof
from p1_tpu_torch.chain import filters as fmod
from p1_tpu_torch.chain.proof import ProofCache, build_block_proofs
from torch_testutil import NodeConfig
from p1_tpu_torch.core.block import Block, merkle_branch, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.client import (
    CommitmentViolation,
    filter_scan,
    get_filter_headers,
    get_filters,
    get_headers,
    get_proof,
    get_status,
)
from p1_tpu_torch.node.protocol import MsgType
from p1_tpu_torch.node.queryplane import QueryPlaneServer, ReplicaView, serve_replica

from p1_tpu_torch.core import keys
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner


@pytest.fixture(autouse=True)
def _plain_device_rung():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


def _config(peers=(), **kw) -> NodeConfig:
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


# -- the filter construction ---------------------------------------------


class TestFilterCodec:
    def test_round_trip_values_sorted_unique(self):
        rng = random.Random(7)
        key = bytes(range(32))
        for _ in range(30):
            items = {
                rng.randbytes(rng.randrange(1, 48))
                for _ in range(rng.randrange(0, 300))
            }
            f = fmod.encode_filter(key, items)
            vals = list(fmod.decode_values(f))
            assert vals == sorted(set(vals))
            assert fmod.filter_count(f) == len(vals)

    def test_zero_false_negatives_randomized(self):
        """EVERY encoded item matches — the guarantee the light client's
        skip decision rests on, across random item sets and keys."""
        rng = random.Random(11)
        for _ in range(40):
            key = rng.randbytes(32)
            items = {
                rng.randbytes(rng.randrange(1, 40))
                for _ in range(rng.randrange(1, 120))
            }
            f = fmod.encode_filter(key, items)
            for it in items:
                assert fmod.matches_any(f, key, [it])
            # And as one batched query set too.
            assert fmod.matches_any(f, key, list(items))

    def test_false_positive_rate_under_designed_bound(self):
        """Measured FP rate on a deliberately lossy parameterization
        (P=6, M=64 → designed 1/64 per absent item).  Deterministic
        seed; the bound allows 2x the expectation — ~4 sigma over this
        sample size, so a real regression (e.g. a biased hash map)
        trips it while statistical noise never should."""
        rng = random.Random(13)
        p, m = 6, 64
        key = bytes(32)
        fp = queries = 0
        for _ in range(300):
            items = {rng.randbytes(8) for _ in range(40)}
            f = fmod.encode_filter(key, items, p, m)
            for _ in range(20):
                probe = rng.randbytes(9)  # length 9: never a real item
                queries += 1
                if fmod.matches_any(f, key, [probe], p, m):
                    fp += 1
        assert queries == 6000
        assert fp / queries < 2.0 / m, f"fp rate {fp / queries:.4f}"
        assert fp > 0  # the lossy parameterization really is lossy

    def test_truncated_filter_raises(self):
        key = bytes(32)
        f = fmod.encode_filter(key, {b"a", b"b", b"c"})
        with pytest.raises(ValueError):
            list(fmod.decode_values(f[:2]))  # inside the count prefix
        with pytest.raises(ValueError):
            list(fmod.decode_values(f[:-1] if len(f) > 5 else f[:4]))

    def test_empty_filter_matches_nothing(self):
        f = fmod.encode_filter(bytes(32), set())
        assert fmod.filter_count(f) == 0
        assert not fmod.matches_any(f, bytes(32), [b"anything"])
        assert not fmod.matches_any(f, bytes(32), [])

    def test_block_filter_commits_txids_and_accounts(self):
        chain = build_chain(4)
        for block in list(chain.main_chain())[1:]:
            f = fmod.block_filter(block)
            bhash = block.block_hash()
            for tx in block.txs:
                assert fmod.matches_any(f, bhash, [tx.txid()])
                assert fmod.matches_any(f, bhash, [tx.sender.encode()])
                assert fmod.matches_any(f, bhash, [tx.recipient.encode()])


class TestFilterWire:
    def test_getfilters_round_trip(self):
        mtype, body = protocol.decode(protocol.encode_getfilters(17, 500))
        assert mtype is MsgType.GETFILTERS
        assert body == (17, 500)

    def test_filters_round_trip(self):
        entries = [
            (bytes([i]) * 32, bytes(range(i + 1))) for i in range(5)
        ] + [(bytes(32), b"")]
        mtype, body = protocol.decode(protocol.encode_filters(9, entries))
        assert mtype is MsgType.FILTERS
        assert body == (9, entries)
        # Empty range (height past the tip) is a valid, empty reply.
        mtype, body = protocol.decode(protocol.encode_filters(1000, []))
        assert body == (1000, [])

    def test_malformed_filters_are_violations(self):
        good = protocol.encode_filters(0, [(bytes(32), b"\x01\x02")])
        for bad in (
            bytes([MsgType.GETFILTERS]) + b"\x00" * 5,  # short
            bytes([MsgType.GETFILTERS]) + struct.pack(">IH", 0, 0),  # count 0
            good[:-1],  # truncated entry
            good + b"\x00",  # trailing bytes
        ):
            with pytest.raises(protocol.ProtocolError):
                protocol.decode(bad)

    def test_raw_encoders_match_object_encoders(self):
        chain = build_chain(3)
        blocks = list(chain.main_chain())
        assert protocol.encode_headers_raw(
            [b.header.serialize() for b in blocks]
        ) == protocol.encode_headers([b.header for b in blocks])
        assert protocol.encode_blocks_raw(
            [b.serialize() for b in blocks]
        ) == protocol.encode_blocks(blocks)
        with pytest.raises(ValueError):
            protocol.encode_headers_raw([b"short"])


class TestFilterVsFullScan:
    def test_match_set_superset_of_truth_randomized(self):
        """The acceptance property: for every watched item, the set of
        blocks whose filter matches ⊇ the set of blocks that truly
        touch it — on randomized chains, with the false-positive excess
        measured and bounded."""
        rng = random.Random(23)
        chain = build_chain(16, rng=rng, txs_per_block=4)
        blocks = list(chain.main_chain())[1:]
        watch_all = [
            account(lbl).encode() for lbl in ("alice", "bob", "carol", "dave")
        ] + [b"merchant", b"exchange", b"nobody-ever"]
        fps = 0
        for item in watch_all:
            truth = set()
            matched = set()
            for block in blocks:
                f = chain.block_filter(block.block_hash())
                touched = set()
                for tx in block.txs:
                    touched |= {
                        tx.txid(),
                        tx.sender.encode(),
                        tx.recipient.encode(),
                    }
                if item in touched:
                    truth.add(block.block_hash())
                if fmod.matches_any(f, block.block_hash(), [item]):
                    matched.add(block.block_hash())
            assert truth <= matched, f"false negative for {item!r}"
            fps += len(matched - truth)
        # Production M: designed FP ≈ items_per_block/784931 per block —
        # over this sample, any false positive at all is ~10^-3 likely.
        assert fps <= 1


# -- the proof cache ------------------------------------------------------


class TestProofCache:
    def test_batched_templates_equal_serial_proofs(self):
        chain = build_chain(8)
        for block in list(chain.main_chain())[1:]:
            height = chain.height_of(block.block_hash())
            txids = [tx.txid() for tx in block.txs]
            batch = build_block_proofs(block, height, txids)
            for i, txid in enumerate(txids):
                proof = batch[txid]
                assert proof.index == i
                assert proof.branch == merkle_branch(txids, i)
                assert proof.height == height
                assert proof.tx is block.txs[i]

    def test_chain_tx_proofs_match_singles_and_verify(self):
        chain = build_chain(10)
        tag = chain.genesis.block_hash()
        txids = [
            tx.txid()
            for b in chain.main_chain()
            for tx in b.txs
            if not tx.is_coinbase
        ]
        assert txids, "fixture must carry transfers"
        batch = chain.tx_proofs(txids)
        for txid in txids:
            single = chain.tx_proof(txid)
            assert batch[txid] == single
            verify_tx_proof(single, chain.difficulty, tag, txid=txid)
        assert chain.tx_proofs([bytes(32)]) == {bytes(32): None}

    def test_cache_hits_and_tip_stamp_advances(self):
        chain = build_chain(6)
        txid = next(
            tx.txid()
            for b in chain.main_chain()
            for tx in b.txs
            if not tx.is_coinbase
        )
        p1 = chain.tx_proof(txid)
        hits0 = chain.proof_cache.hits
        p2 = chain.tx_proof(txid)
        assert chain.proof_cache.hits > hits0
        assert p1 == p2 and p2.tip_height == chain.height

    def test_payload_memo_patch_equals_fresh_encode(self):
        """The 4-byte tip patch on the memoized wire payload must be
        byte-identical to a from-scratch encode at the current tip —
        the hot serving path's correctness in one equation."""
        chain = build_chain(6)
        txid = next(
            tx.txid()
            for b in chain.main_chain()
            for tx in b.txs
            if not tx.is_coinbase
        )
        entry = chain.tx_proof_entry(txid)
        chain.proof_cache.note_payload(
            entry, protocol.encode_proof(entry.proof)
        )
        patched = protocol.patch_proof_tip(entry.payload, chain.height)
        fresh = protocol.encode_proof(chain.tx_proof(txid))
        assert patched == fresh
        # And the decode round-trips to the same proof object.
        mtype, decoded = protocol.decode(patched)
        assert mtype is MsgType.PROOF
        assert decoded == chain.tx_proof(txid)

    def test_lru_stays_under_its_byte_budget(self):
        chain = build_chain(12, txs_per_block=4)
        chain.proof_cache = ProofCache(max_bytes=4096)
        txids = [
            tx.txid()
            for b in chain.main_chain()
            for tx in b.txs
        ]
        for txid in txids:
            chain.tx_proof(txid)
        assert chain.proof_cache.bytes_used <= 4096
        assert len(chain.proof_cache) >= 1

    def test_reorg_invalidates_orphaned_blocks_never_serves_stale(self):
        """The acceptance case: a proof cached for a block that a reorg
        orphans is (a) dropped from the cache and (b) no longer
        reachable through tx_proof — a proof served after the reorg
        names the NEW containing block or nothing."""
        miner = Miner(backend=get_backend("cpu"), chunk=4096)

        def extend(chain, parent, height, txs, ts):
            draft = BlockHeader(
                version=1,
                prev_hash=parent,
                merkle_root=merkle_root([t.txid() for t in txs]),
                timestamp=ts,
                difficulty=chain.difficulty,
                nonce=0,
            )
            sealed = miner.search_nonce(draft)
            block = Block(sealed, tuple(txs))
            res = chain.add_block(block)
            assert res.status.value in ("accepted", "orphan"), res.reason
            return block

        chain = Chain(1)
        g = chain.genesis
        # Branch A: two blocks; the second carries a transfer.
        a1 = extend(
            chain,
            g.block_hash(),
            1,
            [Transaction.coinbase(account("alice"), 1)],
            g.header.timestamp + 60,
        )
        tx = stx("alice", "bob", 3, 1, 0, difficulty=1)
        a2 = extend(
            chain,
            a1.block_hash(),
            2,
            [Transaction.coinbase(account("alice"), 2), tx],
            g.header.timestamp + 120,
        )
        proof_a = chain.tx_proof(tx.txid())
        assert proof_a is not None and proof_a.header == a2.header
        assert len(chain.proof_cache) > 0
        a2_hash = a2.block_hash()

        # Branch B: three blocks from genesis — heavier, reorgs A out.
        # (B does not carry the transfer: alice's coins exist only on A.)
        parent, ts = g.block_hash(), g.header.timestamp + 61
        for h in range(1, 4):
            b = extend(
                chain,
                parent,
                h,
                [Transaction.coinbase(account("carol"), h)],
                ts,
            )
            parent, ts = b.block_hash(), ts + 60
        assert chain.height == 3  # the reorg landed
        assert chain.tip.txs[0].recipient == account("carol")

        # (a) the cache dropped every entry for the orphaned blocks...
        assert chain.proof_cache.invalidated >= 2  # a2's coinbase + tx
        assert all(bh != a2_hash for bh, _ in chain.proof_cache._lru)
        # (b) ...and the serving path cannot produce a stale proof: the
        # transfer is unconfirmed on the new main chain.
        assert chain.tx_proof(tx.txid()) is None
        # A block that SURVIVED on the new chain serves fresh proofs.
        cb = chain.tip.txs[0]
        proof = chain.tx_proof(cb.txid())
        verify_tx_proof(
            proof, 1, chain.genesis.block_hash(), txid=cb.txid()
        )
        assert proof.tip_height == 3


class TestFilterRebuildUnderReorg:
    """The FilterIndex's rebuild-from-store path under reorg —
    previously only the happy path (build at connect, serve from LRU)
    was exercised.  Here filters are LRU-evicted AND the bodies they
    would rebuild from are evicted to the store, then a reorg moves the
    main chain: every filter served afterwards must be rebuilt through
    ``Chain._block_at``'s store refetch and be byte-identical to a
    fresh construction from the block — for the new main chain and for
    the orphaned branch alike."""

    def _extend(self, chain, store, parent, height, txs, ts):
        miner = Miner(backend=get_backend("cpu"), chunk=4096)
        draft = BlockHeader(
            version=1,
            prev_hash=parent,
            merkle_root=merkle_root([t.txid() for t in txs]),
            timestamp=ts,
            difficulty=chain.difficulty,
            nonce=0,
        )
        sealed = miner.search_nonce(draft)
        block = Block(sealed, tuple(txs))
        res = chain.add_block(block)
        assert res.status.value == "accepted", res.reason
        store.append(block)
        return block

    def test_evicted_filters_rebuild_from_the_store_across_a_reorg(
        self, tmp_path
    ):
        store = ChainStore(tmp_path / "c.dat")
        store.acquire()
        try:
            chain = Chain(1)
            chain.body_source = store
            g = chain.genesis
            # Branch A: two blocks, the second carrying a transfer the
            # filter must commit to.
            a1 = self._extend(
                chain, store, g.block_hash(), 1,
                [Transaction.coinbase(account("alice"), 1)],
                g.header.timestamp + 60,
            )
            tx = stx("alice", "bob", 3, 1, 0, difficulty=1)
            a2 = self._extend(
                chain, store, a1.block_hash(), 2,
                [Transaction.coinbase(account("alice"), 2), tx],
                g.header.timestamp + 120,
            )
            # Fresh ground truth BEFORE any eviction/reorg.
            truth = {
                b.block_hash(): fmod.block_filter(b) for b in (a1, a2)
            }
            # Branch B: three carol blocks from genesis — reorgs A out.
            parent, ts = g.block_hash(), g.header.timestamp + 61
            b_blocks = []
            for h in range(1, 4):
                b = self._extend(
                    chain, store, parent, h,
                    [Transaction.coinbase(account("carol"), h)], ts,
                )
                truth[b.block_hash()] = fmod.block_filter(b)
                parent, ts = b.block_hash(), ts + 60
                b_blocks.append(b)
            assert chain.height == 3  # the reorg landed

            # Now the hostile part: drop every cached filter AND evict
            # bodies so a rebuild must round-trip through the store.
            chain.filter_index = fmod.FilterIndex(max_bytes=16 << 20)
            assert len(chain.filter_index) == 0
            chain.evict_bodies(1)
            assert chain.bodies_evicted > 0

            # New-main-chain filters rebuild byte-identically...
            for h in range(1, 4):
                bhash = chain.main_hash_at(h)
                assert chain.block_filter(bhash) == truth[bhash]
            # ...and so do the ORPHANED branch's (still indexed, still
            # store-resident — a late light client may ask for them).
            assert chain.block_filter(a2.block_hash()) == truth[
                a2.block_hash()
            ]
            assert chain.filter_index.built >= 4  # rebuilt, not cached
            assert chain.body_refetches > 0  # the store path really ran

            # Semantics survived the rebuild: the orphaned block's
            # filter still matches the reorged-out transfer (zero false
            # negatives are per-block, branch or not) while the
            # same-height main-chain block — which never carried it —
            # need not (and its sender set is carol's, not alice's).
            a2f = chain.block_filter(a2.block_hash())
            assert fmod.matches_any(
                a2f, a2.block_hash(), [tx.txid()]
            )
            main2 = chain.main_hash_at(2)
            assert fmod.matches_any(
                chain.block_filter(main2), main2,
                [account("carol").encode()],
            )
            # Unknown hash: not an exception, a None (the serving
            # path's not-found contract).
            assert chain.block_filter(b"\x00" * 32) is None
        finally:
            store.close()

    def test_rebuilt_filters_serve_identical_bytes_to_connect_time(
        self, tmp_path
    ):
        """A store resumed with a bounded body cache must serve the
        exact filter bytes the original node built at connect time —
        the replica/serving plane's cold-history path."""
        chain = build_chain(8, difficulty=1, rng=random.Random(7))
        blocks = list(chain.main_chain())
        truth = {
            b.block_hash(): chain.block_filter(b.block_hash())
            for b in blocks[1:]
        }
        store = ChainStore(tmp_path / "r.dat")
        store.acquire()
        try:
            for b in blocks[1:]:
                store.append(b)
            resumed = store.load_chain(1, body_cache=2)
            resumed.body_source = store
            assert resumed.resident_body_bytes < chain.resident_body_bytes
            for bhash, expected in truth.items():
                assert resumed.block_filter(bhash) == expected
        finally:
            store.close()


# -- node-level wire service ----------------------------------------------


class TestNodeQueryPlane:
    def test_filter_scan_finds_every_touching_block(self):
        """The wallet flow end-to-end against a real node: sync by
        filter match and compare against a full-chain scan — superset
        with (almost surely) zero excess at the production FP rate."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=2)
                tag = node.chain.genesis.block_hash()
                for seq, rcpt in enumerate(("bob", "merchant", "bob")):
                    await node.submit_tx(
                        Transaction.transfer(
                            key_for("alice"),
                            account("bob") if rcpt == "bob" else rcpt,
                            2,
                            1,
                            seq,
                            chain=tag,
                        )
                    )
                await fund(node, "carol", blocks=1)
                watch = [account("bob").encode(), b"merchant"]
                headers, matches = await filter_scan(
                    "127.0.0.1", node.port, watch, DIFF
                )
                assert len(headers) == node.chain.height + 1
                truth = {
                    h
                    for h in range(1, node.chain.height + 1)
                    for tx in node.chain.get(
                        node.chain.main_hash_at(h)
                    ).txs
                    if tx.recipient.encode() in watch
                    or tx.sender.encode() in watch
                }
                got = {h for h, _ in matches}
                assert got == truth, (got, truth)
                # Every matched block's content really touches the watch
                # set (filter_scan drops FPs after inspection).
                for h, block in matches:
                    assert any(
                        tx.recipient.encode() in watch
                        or tx.sender.encode() in watch
                        for tx in block.txs
                    )
            finally:
                await node.stop()

        run(scenario())

    def test_query_counters_in_status_and_wire(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=1)
                await get_filters("127.0.0.1", node.port, 1, 10, DIFF)
                txid = node.chain.tip.txs[0].txid()
                await get_proof("127.0.0.1", node.port, txid, DIFF)
                await get_proof("127.0.0.1", node.port, txid, DIFF)
                q = node.status()["queries"]
                assert q["filters_served"] >= 1
                assert q["filter_bytes_served"] > 0
                assert q["proofs_served"] == 2
                assert q["proof_cache"]["hits"] >= 1
                # The wire status probe carries the same block.
                st = await get_status("127.0.0.1", node.port, DIFF)
                assert st["queries"]["proofs_served"] == 2
            finally:
                await node.stop()

        run(scenario())

    def test_getfilters_past_tip_is_empty_not_error(self):
        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                entries = await get_filters(
                    "127.0.0.1", node.port, 1000, 5, DIFF
                )
                assert entries == []
            finally:
                await node.stop()

        run(scenario())


# -- the read replica -----------------------------------------------------


class TestReplica:
    def test_replica_takes_no_writer_lock(self, tmp_path):
        """The acceptance property, literally: a replica attaches while
        the NODE holds the exclusive flock (which a second writer cannot
        take), and the node keeps appending underneath it."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            try:
                await fund(node, "alice", blocks=2)
                # A second WRITER is refused...
                other = ChainStore(store)
                with pytest.raises(RuntimeError):
                    other.acquire()
                # ...but the replica attaches fine, with the same view.
                view = ReplicaView(store, DIFF)
                try:
                    assert view.tip_height == node.chain.height
                    # And the node's writer lock is still intact after.
                    with pytest.raises(RuntimeError):
                        other.acquire()
                finally:
                    view.close()
            finally:
                await node.stop()

        run(scenario())

    def test_replica_serves_blocks_appended_after_attach(self, tmp_path):
        """Refresh path: blocks the node appends after the replica
        started are served correctly — proofs included — after one
        refresh tick."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            try:
                await fund(node, "alice", blocks=2)
                view = ReplicaView(store, DIFF)
                try:
                    h0 = view.tip_height
                    assert h0 == node.chain.height
                    # Append MORE: a transfer plus blocks.
                    tag = node.chain.genesis.block_hash()
                    tx = Transaction.transfer(
                        key_for("alice"), account("bob"), 2, 1, 0, chain=tag
                    )
                    await node.submit_tx(tx)
                    await fund(node, "carol", blocks=2)
                    assert node.chain.height > h0
                    view.refresh()
                    assert view.tip_height == node.chain.height
                    # A proof for the POST-attach transfer, from the
                    # replica, verifies against the chain parameters.
                    payload = view.proof_payload(tx.txid())
                    mtype, proof = protocol.decode(payload)
                    assert mtype is MsgType.PROOF and proof is not None
                    verify_tx_proof(proof, DIFF, tag, txid=tx.txid())
                    assert proof.tip_height == node.chain.height
                    # Headers served raw match the node's objects.
                    assert view.raw_header(proof.height) == (
                        proof.header.serialize()
                    )
                finally:
                    view.close()
            finally:
                await node.stop()

        run(scenario())

    def test_replica_rescans_when_the_inode_is_replaced(self, tmp_path):
        """A compaction/heal replaces the store file wholesale; the
        replica must notice (st_ino) and rebuild instead of serving
        offsets into a dead inode."""
        store = tmp_path / "chain.dat"
        chain = build_chain(4, difficulty=1)
        save_chain(chain, store)
        view = ReplicaView(store, 1)
        try:
            assert view.tip_height == 4
            longer = build_chain(7, difficulty=1)
            save_chain(longer, store)  # unlink + rewrite: new inode
            view.refresh()
            assert view.rescans == 1
            assert view.tip_height == 7
            assert view.raw_header(7) == longer.tip.header.serialize()
        finally:
            view.close()

    def test_replica_server_end_to_end(self, tmp_path):
        """The full client surface against a QueryPlaneServer: headers,
        filters, proofs, status, and the filter_scan wallet flow."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            srv = None
            try:
                await fund(node, "alice", blocks=2)
                tag = node.chain.genesis.block_hash()
                tx = Transaction.transfer(
                    key_for("alice"), account("bob"), 2, 1, 0, chain=tag
                )
                await node.submit_tx(tx)
                await fund(node, "alice", blocks=1)
                srv = await serve_replica(
                    store, DIFF, refresh_interval_s=0.05
                )
                headers = await get_headers("127.0.0.1", srv.port, DIFF)
                assert len(headers) == node.chain.height + 1
                proof = await get_proof(
                    "127.0.0.1", srv.port, tx.txid(), DIFF
                )
                verify_tx_proof(proof, DIFF, tag, txid=tx.txid())
                _, matches = await filter_scan(
                    "127.0.0.1", srv.port, [account("bob").encode()], DIFF
                )
                assert any(
                    t.txid() == tx.txid() for _, b in matches for t in b.txs
                )
                st = await get_status("127.0.0.1", srv.port, DIFF)
                assert st["role"] == "replica"
                assert st["height"] == node.chain.height
                assert st["queries"]["total"] >= 3
                # Mine MORE while the server runs; its refresh loop picks
                # the new tip up without a restart.
                await fund(node, "carol", blocks=1)
                assert await wait_until(
                    lambda: srv.view.tip_height == node.chain.height
                )
                proof = await get_proof(
                    "127.0.0.1", srv.port, tx.txid(), DIFF
                )
                assert proof.tip_height == node.chain.height
            finally:
                if srv is not None:
                    await srv.stop()
                await node.stop()

        run(scenario())

    def test_replica_admission_drops_query_floods(self, tmp_path):
        """Governor admission on the replica: a session streaming
        queries past its class budget sees frames dropped (fewer
        replies than requests), not unbounded service."""
        store = tmp_path / "chain.dat"
        save_chain(build_chain(3, difficulty=1), store)

        async def scenario():
            srv = await serve_replica(store, 1, refresh_interval_s=1.0)
            try:
                from p1_tpu_torch.core.genesis import make_genesis
                from p1_tpu_torch.node.protocol import Hello

                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", srv.port
                )
                ghash = make_genesis(1).block_hash()
                await protocol.write_frame(
                    writer, protocol.encode_hello(Hello(ghash, 0, 0, 5))
                )
                mtype, _ = protocol.decode(
                    await protocol.read_frame(reader)
                )
                assert mtype is MsgType.HELLO
                # 600 instant queries vs a 256-token burst at 32/s.
                n = 600
                for _ in range(n):
                    await protocol.write_frame(
                        writer, protocol.encode_getstatus()
                    )
                writer.write_eof()
                replies = 0
                try:
                    while True:
                        mt, _ = protocol.decode(
                            await asyncio.wait_for(
                                protocol.read_frame(reader), timeout=5
                            )
                        )
                        if mt is MsgType.STATUS:
                            replies += 1
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    TimeoutError,
                    ConnectionError,
                ):
                    pass
                assert replies < n
                assert srv.admission_dropped >= n - replies - 1
                writer.close()
            finally:
                await srv.stop()

        run(scenario())


# -- the commitment chain on the wire --------------------------


def _paid_heights(chain, item: bytes) -> set:
    return {
        h
        for h in range(1, chain.height + 1)
        if any(
            tx.recipient.encode() == item or tx.sender.encode() == item
            for tx in chain.get(chain.main_hash_at(h)).txs
        )
    }


def _watch_target(chain, floor: int = 3):
    """A watched account the fixture pays at height >= ``floor`` (the
    tx mix varies with the hash seed; the tested property must not)."""
    for label in ("bob", "carol", "dave", "alice"):
        item = account(label).encode()
        paid = _paid_heights(chain, item)
        if paid and max(paid) >= floor:
            return item, paid
    raise AssertionError("fixture pays nobody late enough")


class TestCommitmentChainServing:
    def test_served_filter_headers_equal_local_derivation(self):
        """GETFILTERHEADERS against a live node: the served chain is
        exactly H(filter_hash || prev) over the node's own blocks,
        genesis-anchored — and a span past the committed tip is an
        honest refusal (short/empty), never a partial lie."""

        async def scenario():
            node = Node(_config())
            await node.start()
            try:
                await fund(node, "alice", blocks=3)
                tip = node.chain.height
                served = await get_filter_headers(
                    "127.0.0.1", node.port, 0, tip + 1, DIFF
                )
                assert len(served) == tip + 1
                prev = fmod.GENESIS_FILTER_HEADER
                for h in range(tip + 1):
                    fbytes = node.chain.block_filter(
                        node.chain.main_hash_at(h)
                    )
                    prev = fmod.next_filter_header(
                        fmod.filter_hash(fbytes), prev
                    )
                    assert served[h] == prev
                # Honest refusal past the tip.
                assert (
                    await get_filter_headers(
                        "127.0.0.1", node.port, tip + 1, 5, DIFF
                    )
                    == []
                )
                # A span only PARTLY committed is refused whole too —
                # all-or-nothing per request, never a partial answer.
                assert (
                    await get_filter_headers(
                        "127.0.0.1", node.port, tip, 2, DIFF
                    )
                    == []
                )
                exact = await get_filter_headers(
                    "127.0.0.1", node.port, tip, 1, DIFF
                )
                assert exact == [served[tip]]
            finally:
                await node.stop()

        run(scenario())

    def test_mid_scan_reorg_drops_stale_matches(self, tmp_path):
        """The peer reorgs between the header sync and the
        filter page — served filters above the fork carry block hashes
        the skeleton never pinned.  The scan must stop at the
        divergence and drop the stale tail's matches.  Control arm
        first: the unforged replica DOES serve those tail matches, and
        the forged tail's filters are built to match the watch item —
        so a scan that believed unpinned filters would have reported
        them (the assertion cannot pass vacuously)."""
        store = tmp_path / "chain.dat"
        chain = build_chain(8, difficulty=1)
        item, paid = _watch_target(chain)
        k = max(paid)  # forge from the last paid height up
        save_chain(chain, store)

        async def scenario():
            srv = await serve_replica(store, 1, refresh_interval_s=60.0)
            try:
                _, control = await filter_scan(
                    "127.0.0.1", srv.port, [item], 1, fetch_blocks=False
                )
                control_heights = {h for h, _ in control}
                assert paid <= control_heights  # zero false negatives
                assert k in control_heights  # the tail match exists

                real_range = srv.view.filters_range

                def reorged_range(start, count):
                    out = []
                    for i, (bhash, f) in enumerate(real_range(start, count)):
                        h = start + i
                        if h >= k:
                            fake = bytes([h & 0xFF]) * 32
                            out.append(
                                (fake, fmod.encode_filter(fake, {item}))
                            )
                        else:
                            out.append((bhash, f))
                    return out

                srv.view.filters_range = reorged_range
                headers, matches = await filter_scan(
                    "127.0.0.1", srv.port, [item], 1, fetch_blocks=False
                )
                got = {h for h, _ in matches}
                assert got == {h for h in control_heights if h < k}
                # The pinned prefix is still commitment-verified and the
                # skeleton is intact — a partial answer, not a wreck.
                assert len(headers) == chain.height + 1
            finally:
                await srv.stop()

        run(scenario())

    def test_incoherent_forger_is_caught_by_its_own_commitments(
        self, tmp_path
    ):
        """Forged filters WITHOUT a recomputed commitment chain: the
        scan replays H(filter_hash || prev) over the served stream and
        the peer's own fheaders disprove it — CommitmentViolation with
        no second peer needed."""
        store = tmp_path / "chain.dat"
        chain = build_chain(5, difficulty=1)
        save_chain(chain, store)

        async def scenario():
            srv = await serve_replica(store, 1, refresh_interval_s=60.0)
            try:
                real_range = srv.view.filters_range

                def forged(start, count):
                    return [
                        (bhash, fmod.encode_filter(bhash, {b"swapped"}))
                        if start + i >= 3
                        else (bhash, f)
                        for i, (bhash, f) in enumerate(
                            real_range(start, count)
                        )
                    ]

                srv.view.filters_range = forged
                with pytest.raises(CommitmentViolation):
                    await filter_scan(
                        "127.0.0.1", srv.port, [b"whatever"], 1,
                        fetch_blocks=False,
                    )
            finally:
                await srv.stop()

        run(scenario())

    def test_coherent_forger_demoted_scan_fails_over(self, tmp_path):
        """The stronger liar recomputes its whole commitment chain over
        forged filters (self-consistent, locally unfalsifiable).  With
        one honest fallback the cross-check disagrees, the hash-pinned
        block at the divergence names the liar, and the scan fails over
        — returning every confirmation the liar tried to hide."""
        store = tmp_path / "chain.dat"
        chain = build_chain(8, difficulty=1)
        item, paid = _watch_target(chain)
        k = max(paid)
        save_chain(chain, store)

        async def scenario():
            liar = await serve_replica(store, 1, refresh_interval_s=60.0)
            honest = await serve_replica(store, 1, refresh_interval_s=60.0)
            try:
                # Recompute the liar's committed chain over forged
                # filters from k up — linkage verifies, content lies.
                entries = liar.view.filter_headers._entries
                forged = {}
                prev = entries[k - 1][1]
                for h in range(k, len(entries)):
                    bhash = entries[h][0]
                    fake = fmod.encode_filter(bhash, {b"elsewhere"})
                    forged[h] = fake
                    prev = fmod.next_filter_header(
                        fmod.filter_hash(fake), prev
                    )
                    entries[h] = (bhash, prev)
                real_range = liar.view.filters_range
                liar.view.filters_range = lambda start, count: [
                    (bhash, forged.get(start + i, f))
                    for i, (bhash, f) in enumerate(real_range(start, count))
                ]

                headers, matches = await filter_scan(
                    "127.0.0.1", liar.port, [item], 1,
                    fallback_peers=[("127.0.0.1", honest.port)],
                )
                got = {h for h, _ in matches}
                assert paid <= got  # k's hidden confirmation included
                for h, block in matches:
                    assert block.block_hash() == chain.main_hash_at(h)
            finally:
                await liar.stop()
                await honest.stop()

        run(scenario())


# -- soaks ----------------------------------------------------------------


async def _light_session(port: int, difficulty: int, watch: bytes) -> int:
    """One light client's visit: filters for the first 50 heights (a
    fresh session each time — connect, HELLO, query, disconnect)."""
    entries = await get_filters(
        "127.0.0.1", port, 1, 50, difficulty, timeout=60.0
    )
    return sum(
        1
        for bhash, f in entries
        if fmod.matches_any(f, bhash, [watch])
    )


class TestSoak:
    def test_mini_soak_replica_sessions_while_node_mines(self, tmp_path):
        """Tier-1-sized soak: 60 light-client sessions against a replica
        while the node keeps mining the same store."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            srv = None
            try:
                await fund(node, "alice", blocks=2)
                srv = await serve_replica(
                    store, DIFF, refresh_interval_s=0.05
                )
                node.miner_id = account("alice")
                node.start_mining()
                h0 = node.chain.height
                watch = account("alice").encode()
                results = await asyncio.gather(
                    *(
                        _light_session(srv.port, DIFF, watch)
                        for _ in range(60)
                    )
                )
                await node.stop_mining()
                assert len(results) == 60
                assert all(r >= 1 for r in results)  # alice mined: matches
                assert node.chain.height > h0  # mining never starved
                assert srv.sessions_total >= 60
            finally:
                if srv is not None:
                    await srv.stop()
                await node.stop()

        run(scenario())

    @pytest.mark.slow
    def test_light_client_soak_1000_sessions(self, tmp_path):
        """The acceptance soak: ~1000 concurrent light-client sessions
        through governor admission against the serving plane while the
        consensus node keeps mining and connecting blocks on the same
        store.  'Concurrent' is real: sessions launch in waves of 250
        live tasks, far past the node's own MAX_PEERS — the capacity
        the replica tier exists to add."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            srv = None
            try:
                await fund(node, "alice", blocks=3)
                srv = await serve_replica(
                    store, DIFF, refresh_interval_s=0.1
                )
                node.miner_id = account("alice")
                node.start_mining()
                h0 = node.chain.height
                watch = account("alice").encode()
                total = 1000
                done = 0
                for wave in range(4):
                    results = await asyncio.gather(
                        *(
                            _light_session(srv.port, DIFF, watch)
                            for _ in range(total // 4)
                        ),
                        return_exceptions=True,
                    )
                    failures = [
                        r for r in results if isinstance(r, BaseException)
                    ]
                    assert not failures, failures[:3]
                    done += len(results)
                await node.stop_mining()
                assert done == total
                # The consensus thread was never starved: the node kept
                # sealing and connecting blocks through the whole flood.
                assert node.chain.height >= h0 + 2
                assert srv.sessions_total >= total
                assert srv.view.tip_height > 0
            finally:
                if srv is not None:
                    await srv.stop()
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=600))


class TestImportHealthExtension:
    def test_new_modules_in_import_walk(self):
        """tier-0 coverage (tests/test_imports.py walks the package
        automatically; this pins the modules by name so a
        layout change cannot silently drop them)."""
        import importlib

        for name in (
            "p1_tpu.chain.filters",
            "p1_tpu.node.queryplane",
            "p1_tpu.node.subscriptions",
        ):
            importlib.import_module(name)


class TestRefreshLoopSupervision:
    def test_refresh_loop_crash_is_observed_and_respawned(
        self, tmp_path, caplog
    ):
        """The lost-task audit fix: the refresh loop handles
        expected per-tick faults (OSError/ValueError) itself, but an
        UNEXPECTED exception used to kill the task silently — the
        replica then served an ever-staler tip with no sign of trouble
        until stop().  The done-callback must log the wreck and respawn
        the loop while the server is still running."""
        import logging

        store = tmp_path / "chain.dat"
        save_chain(build_chain(3, difficulty=1), store)

        async def scenario():
            srv = await serve_replica(store, 1, refresh_interval_s=0.01)
            try:
                first = srv._refresh_task
                real_refresh = srv.view.refresh

                def boom():
                    raise RuntimeError("refresh bug")

                srv.view.refresh = boom
                assert await wait_until(lambda: first.done(), timeout=10)
                assert await wait_until(
                    lambda: srv._refresh_task is not None
                    and srv._refresh_task is not first,
                    timeout=10,
                )
                # The respawned loop is live: the next tick calls the
                # (healed) refresh again.
                healed = asyncio.Event()

                def heal():
                    healed.set()
                    return real_refresh()

                srv.view.refresh = heal
                assert await wait_until(healed.is_set, timeout=10)
            finally:
                await srv.stop()

        with caplog.at_level(logging.ERROR, logger="p1_tpu.queryplane"):
            run(scenario())
        assert any(
            "refresh loop died" in rec.getMessage()
            for rec in caplog.records
        ), [rec.getMessage() for rec in caplog.records]


class TestReplicaSegmented:
    """Replicas over the SEGMENTED store layout — per-segment
    mmaps, manifest-driven rescans, live attach across segment rolls,
    and the single-file -> segmented upgrade under a live view."""

    def test_live_attach_across_segment_rolls(self, tmp_path):
        """A replica attached to a live node's segmented store keeps
        serving through segment rolls: new segments appear via the
        manifest, sealed history is never rescanned wholesale."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(
                _config(store_path=store, store_segment_bytes=600)
            )
            await node.start()
            try:
                await fund(node, "alice", blocks=2)
                view = ReplicaView(store, DIFF)
                try:
                    assert view.tip_height == node.chain.height
                    rescans0 = view.rescans
                    tag = node.chain.genesis.block_hash()
                    tx = Transaction.transfer(
                        key_for("alice"), account("bob"), 2, 1, 0, chain=tag
                    )
                    await node.submit_tx(tx)
                    await fund(node, "carol", blocks=4)
                    # The store really rolled (that's the point).
                    assert len(node.store.segments) > 1
                    view.refresh()
                    assert view.tip_height == node.chain.height
                    # Incremental: rolls are appends, not rescans.
                    assert view.rescans == rescans0
                    # A proof spanning the roll verifies end to end.
                    payload = view.proof_payload(tx.txid())
                    mtype, proof = protocol.decode(payload)
                    assert mtype is MsgType.PROOF and proof is not None
                    verify_tx_proof(proof, DIFF, tag, txid=tx.txid())
                    # Raw headers serve from whichever segment holds
                    # them.
                    for h in range(view.tip_height + 1):
                        assert view.raw_header(h) is not None
                finally:
                    view.close()
            finally:
                await node.stop()

        run(scenario())

    def test_live_upgrade_single_to_segmented(self, tmp_path):
        """The lossless upgrade under a live view: a replica attached
        to a single-file store notices the layout change (the path now
        holds a manifest) and rebuilds cleanly."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_config(store_path=store))
            await node.start()
            try:
                await fund(node, "alice", blocks=2)
            finally:
                await node.stop()
            view = ReplicaView(store, DIFF)
            try:
                h0 = view.tip_height
                assert h0 >= 2
                # Restart segmented: the writer upgrade hard-links the
                # old records into seg00000 and replaces the path with
                # a manifest.
                node2 = Node(
                    _config(store_path=store, store_segment_bytes=600)
                )
                await node2.start()
                try:
                    await fund(node2, "carol", blocks=2)
                    view.refresh()
                    assert view.rescans >= 1  # layout change detected
                    assert view.tip_height == node2.chain.height
                finally:
                    await node2.stop()
            finally:
                view.close()

        run(scenario())

    def test_pruned_store_refused(self, tmp_path):
        """A replica must not silently serve a store whose deep bodies
        are gone — pruned manifests are refused with a clear error."""
        from p1_tpu_torch.chain import SegmentedStore
        from p1_tpu_torch.node.testing import make_blocks

        path = tmp_path / "chain.dat"
        blocks = make_blocks(6, difficulty=DIFF)
        store = SegmentedStore(path, segment_bytes=600)
        for h, b in enumerate(blocks):
            store.append(b, height=h)
        store.prune_below(store.segments[0].max_height + 1)
        store.close()
        with pytest.raises(ValueError, match="pruned store"):
            ReplicaView(path, DIFF)
