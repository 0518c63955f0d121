"""The port's set-reconciliation relay (``node/reconcile.py``) against the JAX
package's.

Mirrors tests/test_reconcile.py: the reference's cases, run against
``p1_tpu_torch``.

Set-reconciliation relay: codec properties, RECONCILE
wire frames, and the two-node exchange over the simulator.

The codec family is the load-bearing half: PinSketch over GF(2^32)
must round-trip EVERY difference size up to its capacity, DETECT (not
mis-decode) anything beyond it, and be a pure deterministic function
of the set — byte-identical sketches for identical sets is what makes
the XOR-combine algebra sound.  The wire tests pin the four frames'
encode/decode and their hostile-input rejections; the simulator tests
prove a reconciliation round actually moves a transaction between two
nodes with the flood path dark.

``TestTwoNodeExchange`` runs two port nodes on the port's ``SimNet``
with ``device="cpu"``.
"""

import random

import pytest

from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.protocol import MsgType
from p1_tpu_torch.node.reconcile import (
    MAX_CAPACITY,
    capacity_of,
    combine,
    decode,
    estimate_capacity,
    pair_salt,
    short_id,
    sketch,
)


def _ids(rng: random.Random, n: int, avoid=()) -> set[int]:
    out: set[int] = set()
    avoid = set(avoid)
    while len(out) < n:
        m = rng.randrange(1, 1 << 32)
        if m not in avoid:
            out.add(m)
    return out


class TestCodecProperties:
    def test_round_trips_every_difference_size_to_capacity(self):
        """For capacities across the range, a difference of EVERY size
        0..capacity decodes exactly — regardless of how much the two
        sets overlap (common elements cancel in the XOR)."""
        rng = random.Random(0xC0DEC)
        for cap in (1, 2, 3, 5, 8):
            for d in range(cap + 1):
                common = _ids(rng, rng.randrange(0, 20))
                diff = _ids(rng, d, avoid=common)
                mine = list(diff)[: d // 2]
                theirs = diff - set(mine)
                a = sketch(common | set(mine), cap)
                b = sketch(common | theirs, cap)
                got = decode(combine(a, b))
                assert got == tuple(sorted(diff)), (cap, d)

    def test_full_capacity_round_trip(self):
        # One full-width decode: 64 elements through a MAX_CAPACITY
        # sketch (the largest field-work a single honest round buys).
        rng = random.Random(0xF011)
        diff = _ids(rng, MAX_CAPACITY)
        got = decode(sketch(diff, MAX_CAPACITY))
        assert got == tuple(sorted(diff))

    def test_over_capacity_is_detected_not_misdecoded(self):
        """THE codec safety property: raw PinSketch hallucinates a
        small set whose syndromes match an over-full sketch; the
        reserved verification syndrome must turn every such case into
        None (the caller's flood-fallback signal), never a wrong set."""
        rng = random.Random(0x0F10)
        for cap in (1, 2, 4, 8):
            for extra in (1, 2, 5, 17):
                diff = _ids(rng, cap + extra)
                assert decode(sketch(diff, cap)) is None, (cap, extra)

    def test_identical_sets_sketch_byte_identical(self):
        rng = random.Random(0x1DE9)
        ids = list(_ids(rng, 12))
        base = sketch(ids, 8)
        for _ in range(3):
            rng.shuffle(ids)
            assert sketch(ids, 8) == base
        # ...and a different set differs (order-free, not content-free).
        other = list(_ids(rng, 12))
        assert sketch(other, 8) != base

    def test_combine_cancels_common_elements(self):
        rng = random.Random(0xCA7)
        common = _ids(rng, 30)
        only = _ids(rng, 2, avoid=common)
        a = sketch(common | only, 4)
        b = sketch(common, 4)
        assert decode(combine(a, b)) == tuple(sorted(only))
        # Identical sets cancel to the empty difference.
        assert decode(combine(a, a)) == ()

    def test_salt_separation(self):
        """Short IDs are salted per peer pair: both ends derive the
        same salt from the two HELLO nonces order-independently, no
        other pair shares it, and a txid maps to UNRELATED ids under
        different salts — a collision precomputed for one link buys
        nothing on any other."""
        assert pair_salt(7, 99) == pair_salt(99, 7)
        assert pair_salt(7, 99) != pair_salt(7, 98)
        txids = [bytes([k]) * 32 for k in range(40)]
        s1, s2 = pair_salt(1, 2), pair_salt(1, 3)
        ids1 = [short_id(s1, t) for t in txids]
        ids2 = [short_id(s2, t) for t in txids]
        assert ids1 != ids2
        assert all(i != 0 for i in ids1 + ids2)  # zero is not an element
        # Same salt, same txid -> same id (both ends must agree).
        assert ids1 == [short_id(s1, t) for t in txids]

    def test_estimate_capacity_is_sum_based_and_clamped(self):
        # Per-link pending queues are mostly DISJOINT (each side queued
        # what the other lacks), so the estimate is ls + rs + slack —
        # NOT Erlay's |ls - rs| overlap heuristic, which under-sized
        # sketches catastrophically here (module docstring).
        assert estimate_capacity(0, 0) == 2
        assert estimate_capacity(3, 4) == 9
        assert estimate_capacity(10, 10) == 22
        assert estimate_capacity(500, 500) == MAX_CAPACITY
        for ls in range(0, 12):
            for rs in range(0, 12):
                c = estimate_capacity(ls, rs)
                assert 1 <= c <= MAX_CAPACITY
                assert c >= min(ls + rs, MAX_CAPACITY)  # never undersized

    def test_sketch_validation(self):
        with pytest.raises(ValueError):
            sketch([1], 0)
        with pytest.raises(ValueError):
            sketch([1], MAX_CAPACITY + 1)
        with pytest.raises(ValueError):
            sketch([0], 4)  # zero is the additive identity
        with pytest.raises(ValueError):
            sketch([1 << 32], 4)  # outside the field
        assert capacity_of(sketch([1, 2], 4)) == 4
        with pytest.raises(ValueError):
            combine(b"\x00" * 8, b"\x00" * 12)  # length mismatch

    def test_decode_rejects_malformed_bytes(self):
        assert decode(b"") is None
        assert decode(b"\x00" * 4) is None  # below minimum (cap 1 = 8)
        assert decode(b"\x00" * 9) is None  # not whole words
        assert decode(b"\x00" * (4 * (MAX_CAPACITY + 2))) is None  # too big
        assert decode(b"\x00" * 8) == ()  # all-zero = empty difference
        # A corrupted sketch fails the re-sketch proof instead of
        # yielding some other plausible set.
        rng = random.Random(0xBAD)
        data = bytearray(sketch(_ids(rng, 3), 4))
        data[5] ^= 0x40
        assert decode(bytes(data)) is None


class TestReconcileFrames:
    def test_reqrecon_round_trip(self):
        mtype, got = protocol.decode(protocol.encode_reqrecon(17))
        assert mtype is MsgType.REQRECON and got == (False, 17)
        mtype, got = protocol.decode(protocol.encode_reqrecon(0, full=True))
        assert mtype is MsgType.REQRECON and got == (True, 0)

    def test_sketch_round_trip_and_bounds(self):
        data = sketch([5, 9], 8)
        mtype, (size, raw) = protocol.decode(protocol.encode_sketch(3, data))
        assert mtype is MsgType.SKETCH and size == 3 and raw == data
        with pytest.raises(ValueError):
            protocol.encode_sketch(3, data[:-1])  # torn word
        with pytest.raises(ValueError):
            protocol.encode_sketch(3, b"\x00" * 4)  # below capacity 1
        with pytest.raises(ValueError):  # over the decode-work clamp
            protocol.encode_sketch(
                3, b"\x00" * (4 * (protocol.MAX_SKETCH_WORDS + 1))
            )

    def test_recondiff_and_gettx_round_trip(self):
        ids = (1, 0xFFFFFFFF, 7)
        mtype, got = protocol.decode(protocol.encode_recondiff(True, ids))
        assert mtype is MsgType.RECONCILDIFF and got == (True, ids)
        mtype, got = protocol.decode(protocol.encode_recondiff(False))
        assert mtype is MsgType.RECONCILDIFF and got == (False, ())
        mtype, got = protocol.decode(protocol.encode_gettx(ids))
        assert mtype is MsgType.GETTX and got == ids

    def test_hostile_shapes_rejected(self):
        with pytest.raises(ValueError):
            protocol.encode_gettx(())  # empty fetch is meaningless
        with pytest.raises(ValueError):
            protocol.encode_gettx(range(1, protocol.MAX_RECON_IDS + 2))
        # Hand-built frames with out-of-contract fields must raise (the
        # peer loop scores them), never mis-parse.
        for payload in (
            bytes([MsgType.REQRECON, 2]) + b"\x00" * 4,  # bad full flag
            bytes([MsgType.REQRECON]) + b"\x00" * 3,  # short
            bytes([MsgType.SKETCH]) + b"\x00\x00\x00\x03\x00\x01" + b"\x00" * 4,
            bytes([MsgType.SKETCH])
            + b"\x00\x00\x00\x03\x04\x00"  # word count over the clamp
            + b"\x00" * 4096,
            bytes([MsgType.RECONCILDIFF, 1, 0x00, 0x02]) + b"\x00" * 4,
            bytes([MsgType.GETTX, 0x00, 0x00]),  # empty GETTX
            bytes([MsgType.GETTX, 0xFF, 0xFF]) + b"\x00" * 8,  # n lies
        ):
            with pytest.raises(ValueError):
                protocol.decode(payload)


@pytest.mark.sim
class TestTwoNodeExchange:
    def test_round_moves_a_tx_without_flooding_it(self):
        """Two reconciling nodes, flood spine off: a submitted tx must
        reach the other node THROUGH a reconciliation round (REQRECON/
        SKETCH/RECONCILDIFF then an explicit GETTX fetch), with the
        recon byte families charged and txs_reconciled counting the one
        serve."""
        from p1_tpu_torch.core.genesis import genesis_hash
        from p1_tpu_torch.core.keys import Keypair
        from p1_tpu_torch.core.tx import Transaction
        from p1_tpu_torch.node.netsim import SimNet

        net = SimNet(seed=11, difficulty=8, device="cpu")

        async def main():
            a = await net.add_node(
                recon_gossip=True,
                recon_interval_s=0.2,
                recon_flood_degree=0,
                miner_id="pool",
            )
            b = await net.add_node(
                peers=[net.host_name(0)],
                recon_gossip=True,
                recon_interval_s=0.2,
                recon_flood_degree=0,
            )
            assert await net.run_until(net.links_up, 30, step=0.1)
            w = Keypair.from_seed_text("p1-recon-pair")
            a.miner_id = w.account
            await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 1, 30, step=0.1
            )
            tx = Transaction.transfer(
                w, "p1-payee", 1, 1, 0, chain=genesis_hash(8)
            )
            await a.submit_tx(tx)
            assert await net.run_until(
                lambda: tx.txid() in b.mempool, 30, step=0.1
            ), "tx never crossed the reconciliation-only link"
            assert a.metrics.recon_success + b.metrics.recon_success >= 1
            assert a.metrics.txs_reconciled == 1  # served exactly once
            relay = a.metrics.relay_bytes()
            assert relay.get("recon", 0) > 0  # the exchange was charged
            assert b.metrics.relay_bytes().get("recon", 0) > 0

        net.run(main())

    def test_flood_stays_the_dialect_when_recon_is_off(self):
        """Negative control: identical pair with recon off moves the
        same tx with ZERO recon rounds and zero recon bytes — the
        pre-path is untouched."""
        from p1_tpu_torch.core.genesis import genesis_hash
        from p1_tpu_torch.core.keys import Keypair
        from p1_tpu_torch.core.tx import Transaction
        from p1_tpu_torch.node.netsim import SimNet

        net = SimNet(seed=11, difficulty=8, device="cpu")

        async def main():
            a = await net.add_node(miner_id="pool")
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(net.links_up, 30, step=0.1)
            w = Keypair.from_seed_text("p1-recon-pair")
            a.miner_id = w.account
            await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 1, 30, step=0.1
            )
            tx = Transaction.transfer(
                w, "p1-payee", 1, 1, 0, chain=genesis_hash(8)
            )
            await a.submit_tx(tx)
            assert await net.run_until(
                lambda: tx.txid() in b.mempool, 30, step=0.1
            )
            for n in (a, b):
                assert n.metrics.recon_rounds == 0
                assert n.metrics.relay_bytes().get("recon", 0) == 0

        net.run(main())
