"""The port's wire protocol (``p1_tpu_torch.node.protocol``) against the
JAX package's.

Mirrors tests/test_protocol.py: encode/decode round-trips and
malformed-frame rejection, run against the port's codec.  The node treats
any ValueError from decode as a protocol violation and drops the peer —
so every malformed shape must raise, never crash or mis-parse.  A small
mutation fuzz backs the hand-written cases.

``TestCrossPackage`` then holds the two codecs to each other: one frame
of every shape of every ``MsgType``, built by each package's encoder from
its own objects (the same chain, carried into the port by its bytes), is
byte-identical, each package decodes the other's frame to the same body,
and truncations of it get the same verdict and error text.
"""

import random
from types import SimpleNamespace

import pytest

from p1_tpu.chain import Chain as RefChain
from p1_tpu.node import protocol as ref_protocol
from p1_tpu.node import reconcile as ref_reconcile
from p1_tpu.node.testing import make_blocks as ref_make_blocks
from p1_tpu_torch.chain import Chain
from p1_tpu_torch.chain.proof import TxProof
from p1_tpu_torch.core import Block, BlockHeader, Transaction, make_genesis
from p1_tpu_torch.node import protocol, reconcile
from p1_tpu_torch.node.protocol import Hello, MsgType


def _block(n_txs: int = 2) -> Block:
    txs = tuple(Transaction("alice", "bob", 5, f + 1, f) for f in range(n_txs))
    header = BlockHeader(1, b"\x11" * 32, b"\x22" * 32, 1735689700, 12, 7)
    return Block(header, txs)


class TestRoundTrips:
    def test_hello(self):
        h = Hello(b"\xab" * 32, 42, 9444)
        mtype, got = protocol.decode(protocol.encode_hello(h))
        assert mtype is MsgType.HELLO and got == h

    def test_hello_version_mismatch_rejected(self):
        # A peer speaking another protocol version (e.g. the first
        # protocol's unversioned frames would also fail, by size) must die at the
        # handshake with a clear error, not mis-parse gossip later.
        import struct

        payload = bytes([MsgType.HELLO]) + struct.pack(
            ">B32sIHQ", protocol.PROTOCOL_VERSION + 1, b"\xab" * 32, 1, 1, 7
        )
        with pytest.raises(ValueError, match="protocol version"):
            protocol.decode(payload)

    def test_block(self):
        block = _block()
        # The codec reads no clock of its own (a host-clock
        # stamp inside the frame bytes made simulated traces
        # nondeterministic): no sent_ts encodes the 0.0 "no stamp"
        # sentinel, which receivers skip for propagation telemetry.
        mtype, (sent_ts, got) = protocol.decode(protocol.encode_block(block))
        assert mtype is MsgType.BLOCK and got == block
        assert sent_ts == 0.0
        # Explicit timestamps survive the round trip exactly (f64).
        _, (ts2, _) = protocol.decode(protocol.encode_block(block, sent_ts=1.5))
        assert ts2 == 1.5

    def test_tx(self):
        tx = Transaction("alice", "bob", 5, 1, 0)
        mtype, got = protocol.decode(protocol.encode_tx(tx))
        assert mtype is MsgType.TX and got == tx

    def test_getblocks(self):
        locator = [bytes([i]) * 32 for i in range(5)]
        mtype, got = protocol.decode(protocol.encode_getblocks(locator))
        assert mtype is MsgType.GETBLOCKS and got == locator

    def test_blocks(self):
        blocks = [_block(0), _block(3), make_genesis(12)]
        mtype, got = protocol.decode(protocol.encode_blocks(blocks))
        assert mtype is MsgType.BLOCKS and got == blocks

    def test_getmempool_start_and_cursor(self):
        mtype, got = protocol.decode(protocol.encode_getmempool())
        assert mtype is MsgType.GETMEMPOOL and got is None
        cursor = (7, b"\xcd" * 32)
        mtype, got = protocol.decode(protocol.encode_getmempool(cursor))
        assert mtype is MsgType.GETMEMPOOL and got == cursor

    def test_account_query_round_trip(self):
        mtype, got = protocol.decode(protocol.encode_getaccount("p1deadbeef"))
        assert mtype is MsgType.GETACCOUNT and got == "p1deadbeef"
        state = protocol.AccountState("p1deadbeef", 123, 4, 7, 99)
        mtype, got = protocol.decode(protocol.encode_account(state))
        assert mtype is MsgType.ACCOUNT and got == state

    def test_filter_headers_round_trip(self):
        mtype, got = protocol.decode(protocol.encode_getfilterheaders(7, 100))
        assert mtype is MsgType.GETFILTERHEADERS and got == (7, 100)
        headers = [bytes([i]) * 32 for i in range(3)]
        mtype, got = protocol.decode(protocol.encode_filterheaders(7, headers))
        assert mtype is MsgType.FILTERHEADERS and got == (7, headers)
        # The clean refusal: empty list survives the trip.
        mtype, got = protocol.decode(protocol.encode_filterheaders(9, []))
        assert mtype is MsgType.FILTERHEADERS and got == (9, [])

    def test_subscribe_round_trip(self):
        items = [b"alice", b"\x01" * 32]
        mtype, got = protocol.decode(protocol.encode_subscribe(items))
        assert mtype is MsgType.SUBSCRIBE and got == (None, items)
        cursor = (12, b"\xfe" * 32)
        mtype, got = protocol.decode(protocol.encode_subscribe(items, cursor))
        assert mtype is MsgType.SUBSCRIBE and got == (cursor, items)
        mtype, got = protocol.decode(protocol.encode_unsubscribe())
        assert mtype is MsgType.UNSUBSCRIBE and got is None

    def test_event_round_trip(self):
        ev = protocol.BlockEvent(
            height=5,
            raw_header=_block().header.serialize(),
            filter_header=b"\xaa" * 32,
            filter=b"\x01\x02\x03",
            matched=True,
            txids=(b"\x0b" * 32, b"\x0c" * 32),
        )
        mtype, got = protocol.decode(protocol.encode_event(ev))
        assert mtype is MsgType.EVENT and got == ev
        # Non-matched events carry no txids (the shared frame).
        plain = protocol.BlockEvent(6, ev.raw_header, ev.filter_header, b"", False, ())
        mtype, got = protocol.decode(protocol.encode_event(plain))
        assert mtype is MsgType.EVENT and got == plain
        mtype, got = protocol.decode(protocol.encode_event_gap(3, 9))
        assert mtype is MsgType.EVENT
        assert got == protocol.GapEvent(3, 9)

    def test_mempool(self):
        txs = [Transaction("a", "b", 1, f, f) for f in range(3)]
        payload = protocol.encode_mempool([t.serialize() for t in txs], more=True)
        mtype, (more, got) = protocol.decode(payload)
        assert mtype is MsgType.MEMPOOL and more and got == txs
        _, (more2, got2) = protocol.decode(protocol.encode_mempool([]))
        assert not more2 and got2 == []


class TestMalformed:
    @pytest.mark.parametrize(
        "payload",
        [
            b"",  # empty frame
            bytes([99]),  # unknown type
            bytes([MsgType.HELLO]) + b"short",
            bytes([MsgType.HELLO]),  # no body
            bytes([MsgType.BLOCK]) + b"\x00" * 10,  # truncated header
            bytes([MsgType.TX]),  # empty tx
            bytes([MsgType.GETBLOCKS]) + b"\x00",  # short count
            bytes([MsgType.GETBLOCKS]) + b"\x00\x02" + b"\x00" * 32,  # count lies
            bytes([MsgType.BLOCKS]) + b"\x00",  # short count
            bytes([MsgType.BLOCKS]) + b"\x00\x01\x00\x00\x00\x05ab",  # truncated
            bytes([MsgType.GETMEMPOOL]) + b"\x00" * 3,  # wrong cursor size
            bytes([MsgType.GETACCOUNT]),  # no length
            bytes([MsgType.GETACCOUNT]) + b"\x05ab",  # length lies
            bytes([MsgType.GETACCOUNT]) + b"\x00",  # empty account
            bytes([MsgType.ACCOUNT]) + b"\x02ab" + b"\x00" * 10,  # short state
            bytes([MsgType.MEMPOOL]) + b"\x00",  # short header
            bytes([MsgType.MEMPOOL]) + b"\x00\x00\x00\x00\x00\x01",  # count lies
            bytes([MsgType.GETFILTERHEADERS]) + b"\x00",  # short range
            bytes([MsgType.GETFILTERHEADERS])
            + b"\x00\x00\x00\x00\x00\x00",  # zero count
            bytes([MsgType.FILTERHEADERS]) + b"\x00" * 3,  # short header
            bytes([MsgType.FILTERHEADERS])
            + b"\x00\x00\x00\x00\x00\x02"
            + b"\x00" * 32,  # count lies
            bytes([MsgType.SUBSCRIBE]),  # no cursor flag
            bytes([MsgType.SUBSCRIBE, 2]),  # unknown cursor flag
            bytes([MsgType.SUBSCRIBE, 0]) + b"\x00\x00",  # zero items
            bytes([MsgType.SUBSCRIBE, 0]) + b"\x00\x01\x00\x05ab",  # len lies
            bytes([MsgType.SUBSCRIBE, 1]) + b"\x00" * 10,  # short cursor
            bytes([MsgType.UNSUBSCRIBE]) + b"\x00",  # trailing byte
            bytes([MsgType.EVENT]),  # no kind
            bytes([MsgType.EVENT, 2]),  # unknown kind
            bytes([MsgType.EVENT, 0]) + b"\x00" * 20,  # truncated block event
            bytes([MsgType.EVENT, 1]) + b"\x00" * 4,  # truncated gap
            bytes([MsgType.EVENT, 1])
            + b"\x00\x00\x00\x05\x00\x00\x00\x03",  # end < start
        ],
    )
    def test_rejected(self, payload):
        with pytest.raises(ValueError):
            protocol.decode(payload)

    def test_trailing_bytes_rejected(self):
        good = protocol.encode_blocks([_block(1)])
        with pytest.raises(ValueError, match="trailing|truncated"):
            protocol.decode(good + b"\x00")

    def test_pure_random_bytes_never_crash(self):
        # Beyond mutations of valid frames: completely arbitrary payloads
        # across every length bucket must decode or raise ValueError.
        rng = random.Random(99)
        for _ in range(3000):
            buf = rng.randbytes(rng.randrange(0, 240))
            try:
                protocol.decode(buf)
            except ValueError:
                pass  # the contract: reject, don't crash

    def test_mutation_fuzz_never_crashes(self):
        # Truncations and byte flips of valid frames must either decode to
        # SOMETHING or raise ValueError -- never any other exception.
        rng = random.Random(7)
        seeds = [
            protocol.encode_hello(Hello(b"\x01" * 32, 3, 1)),
            protocol.encode_block(_block()),
            protocol.encode_tx(Transaction("a", "b", 1, 1, 0)),
            protocol.encode_blocks([_block(0), _block(2)]),
            protocol.encode_mempool(
                [Transaction("a", "b", 1, f, f).serialize() for f in range(2)],
                more=True,
            ),
            protocol.encode_getblocks([b"\x02" * 32]),
            protocol.encode_getmempool((9, b"\x03" * 32)),
            protocol.encode_getaccount("p1deadbeefdeadbeef"),
            protocol.encode_account(
                protocol.AccountState("p1deadbeefdeadbeef", 50, 1, 2, 7)
            ),
            protocol.encode_getproof(b"\x04" * 32),
            protocol.encode_getheaders([b"\x09" * 32]),
            protocol.encode_getaddr(),
            protocol.encode_getfees(16),
            protocol.encode_fees(protocol.FeeStats(32, 9, 1, 2, 3, 44)),
            protocol.encode_addr([("127.0.0.1", 9444), ("h.example", 80)]),
            protocol.encode_headers([_block().header, make_genesis(12).header]),
            protocol.encode_cblock(_block(3)),
            protocol.encode_getblocktxn(b"\x07" * 32, [1, 2, 5]),
            protocol.encode_blocktxn(
                b"\x08" * 32,
                [Transaction("a", "b", 1, f, f).serialize() for f in range(2)],
            ),
            protocol.encode_getfilterheaders(3, 50),
            protocol.encode_filterheaders(3, [bytes([i]) * 32 for i in range(2)]),
            protocol.encode_subscribe([b"alice"], (4, b"\x0d" * 32)),
            protocol.encode_unsubscribe(),
            protocol.encode_event(
                protocol.BlockEvent(
                    5,
                    _block().header.serialize(),
                    b"\x0e" * 32,
                    b"\x01\x02",
                    True,
                    (b"\x0f" * 32,),
                )
            ),
            protocol.encode_event_gap(2, 6),
            protocol.encode_proof(None),
            protocol.encode_proof(
                TxProof(
                    Transaction("a", "b", 1, 1, 0),
                    _block().header,
                    3,
                    9,
                    1,
                    (b"\x05" * 32, b"\x06" * 32),
                )
            ),
        ]
        for seed in seeds:
            for _ in range(200):
                buf = bytearray(seed)
                op = rng.randrange(3)
                if op == 0 and len(buf) > 1:
                    buf = buf[: rng.randrange(1, len(buf))]
                elif op == 1:
                    buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
                else:
                    buf += bytes([rng.randrange(256)])
                try:
                    protocol.decode(bytes(buf))
                except ValueError:
                    pass  # the contract: reject, don't crash


# -- the port against the JAX package ---------------------------------------

#: One frame of each shape each ``MsgType`` has, built by a package's own
#: encoder from that package's objects (``O``: blocks, a transfer, a proof).
FRAMES = {
    "HELLO": lambda P, O: P.encode_hello(P.Hello(O.genesis, 7, 9444, 0x1234_5678_9ABC)),
    "BLOCK": lambda P, O: P.encode_block(O.block, sent_ts=1.5),
    "TX": lambda P, O: P.encode_tx(O.tx),
    "GETBLOCKS": lambda P, O: P.encode_getblocks([O.genesis, O.block.block_hash()]),
    "BLOCKS": lambda P, O: P.encode_blocks(O.blocks),
    "BLOCKS_raw": lambda P, O: P.encode_blocks_raw([b.serialize() for b in O.blocks]),
    "GETMEMPOOL": lambda P, O: P.encode_getmempool(),
    "GETMEMPOOL_cursor": lambda P, O: P.encode_getmempool((3, O.tx.txid())),
    "MEMPOOL": lambda P, O: P.encode_mempool([O.tx.serialize()], more=True),
    "GETACCOUNT": lambda P, O: P.encode_getaccount(O.tx.sender),
    "ACCOUNT": lambda P, O: P.encode_account(P.AccountState(O.tx.sender, 95, 1, 2, 3)),
    "GETPROOF": lambda P, O: P.encode_getproof(O.tx.txid()),
    "PROOF": lambda P, O: P.encode_proof(O.proof),
    "PROOF_none": lambda P, O: P.encode_proof(None),
    "CBLOCK": lambda P, O: P.encode_cblock(O.block, sent_ts=2.25),
    "GETBLOCKTXN": lambda P, O: P.encode_getblocktxn(O.block.block_hash(), [1, 3, 4]),
    "BLOCKTXN": lambda P, O: P.encode_blocktxn(O.block.block_hash(), [O.tx.serialize()]),
    "GETHEADERS": lambda P, O: P.encode_getheaders([O.genesis]),
    "HEADERS": lambda P, O: P.encode_headers([b.header for b in O.blocks]),
    "HEADERS_raw": lambda P, O: P.encode_headers_raw([b.header.serialize() for b in O.blocks]),
    "GETADDR": lambda P, O: P.encode_getaddr(),
    "ADDR": lambda P, O: P.encode_addr([("127.0.0.1", 9444), ("10.1.2.3", 19444)]),
    "GETFEES": lambda P, O: P.encode_getfees(12),
    "FEES": lambda P, O: P.encode_fees(P.FeeStats(32, 5, 1, 2, 3, 10)),
    "PING": lambda P, O: P.encode_ping((1 << 40) + 3),
    "PONG": lambda P, O: P.encode_pong(7),
    "GETSTATUS": lambda P, O: P.encode_getstatus(),
    "STATUS": lambda P, O: P.encode_status({"height": 3, "tip": O.genesis.hex(), "sync": {"stalls": 0}}),
    "GETFILTERS": lambda P, O: P.encode_getfilters(5, 10),
    "FILTERS": lambda P, O: P.encode_filters(5, [(O.genesis, b"\x01\x02\x03"), (O.genesis, b"")]),
    "GETSNAPSHOT": lambda P, O: P.encode_getsnapshot(2, 4),
    "SNAPSHOT_none": lambda P, O: P.encode_snapshot_none(),
    "SNAPSHOT_manifest": lambda P, O: P.encode_snapshot_manifest(b"manifest bytes"),
    "SNAPSHOT_chunks": lambda P, O: P.encode_snapshot_chunks(3, [b"a", b"bc", b""]),
    "GETMETRICS": lambda P, O: P.encode_getmetrics(),
    "METRICS": lambda P, O: P.encode_metrics({"role": "node", "counters": {"blocks_accepted": 2}}),
    "GETMAINTAIN": lambda P, O: P.encode_getmaintain({"op": "rebase", "keep": 4}),
    "MAINTAIN": lambda P, O: P.encode_maintain({"ok": False, "error": "busy"}),
    "SUBSCRIBE": lambda P, O: P.encode_subscribe([O.tx.sender.encode(), O.tx.txid()]),
    "SUBSCRIBE_cursor": lambda P, O: P.encode_subscribe([b"bob"], cursor=(9, b"\x11" * 32)),
    "EVENT": lambda P, O: P.encode_event(
        P.BlockEvent(2, O.block.header.serialize(), b"\x22" * 32, b"filter", True, (O.tx.txid(),))
    ),
    "EVENT_gap": lambda P, O: P.encode_event_gap(4, 9),
    "UNSUBSCRIBE": lambda P, O: P.encode_unsubscribe(),
    "GETFILTERHEADERS": lambda P, O: P.encode_getfilterheaders(0, 3),
    "FILTERHEADERS": lambda P, O: P.encode_filterheaders(2, [b"\x33" * 32, b"\x44" * 32]),
    "REQRECON": lambda P, O: P.encode_reqrecon(17, full=True),
    "SKETCH": lambda P, O: P.encode_sketch(5, O.sketch),
    "RECONCILDIFF": lambda P, O: P.encode_recondiff(True, [1, 2, 0xFFFFFFFF]),
    "GETTX": lambda P, O: P.encode_gettx([5, 6]),
}


@pytest.fixture(scope="module")
def objects():
    """The same chain in both packages: genesis and two blocks at
    difficulty 8, the second carrying a signed transfer, mined with the
    JAX package and carried into the port by its bytes."""
    from torch_testutil import account
    from txutil import stx as ref_stx

    spend = ref_stx("alice", account("bob"), 5, 1, 0)
    ref_blocks = ref_make_blocks(2, difficulty=8, miner_id=account("alice"), txs_at={2: (spend,)})
    ref_chain = RefChain(8, genesis=ref_blocks[0])
    for b in ref_blocks[1:]:
        assert ref_chain.add_block(b).status.value == "accepted"
    blocks = [Block.deserialize(b.serialize()) for b in ref_blocks]
    chain = Chain(8, genesis=blocks[0])
    for b in blocks[1:]:
        assert chain.add_block(b).status.value == "accepted"
    ids = [ref_reconcile.short_id(b"\x05" * 16, b.block_hash()) for b in ref_blocks]

    def ns(pkg_blocks, pkg_chain, recon):
        tx = pkg_blocks[2].txs[1]
        return SimpleNamespace(
            genesis=pkg_blocks[0].block_hash(), blocks=pkg_blocks, block=pkg_blocks[2], tx=tx,
            proof=pkg_chain.tx_proof(tx.txid()), sketch=recon.sketch(ids, 3),
        )  # fmt: skip

    return SimpleNamespace(ref=ns(ref_blocks, ref_chain, ref_reconcile), port=ns(blocks, chain, reconcile))


def _norm(value):
    """A decoded body as plain data: objects by their serialized bytes,
    dataclasses field by field."""
    import dataclasses as dc
    import enum

    if hasattr(value, "serialize"):
        return ("bytes", value.serialize())
    if dc.is_dataclass(value):
        return (type(value).__name__, tuple(_norm(getattr(value, f.name)) for f in dc.fields(value)))
    if isinstance(value, (list, tuple)):
        return tuple(_norm(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _norm(v)) for k, v in value.items()))
    if isinstance(value, enum.Enum):
        return value.value
    return value


class TestCrossPackage:
    def test_the_two_packages_speak_one_protocol(self):
        assert protocol.PROTOCOL_VERSION == ref_protocol.PROTOCOL_VERSION
        assert [(m.name, m.value) for m in MsgType] == [(m.name, m.value) for m in ref_protocol.MsgType]
        assert {m.value: v for m, v in protocol.MSG_SINCE.items()} == {
            m.value: v for m, v in ref_protocol.MSG_SINCE.items()
        }

    def test_every_msgtype_has_a_frame(self, objects):
        covered = {FRAMES[name](ref_protocol, objects.ref)[0] for name in FRAMES}
        assert covered == {m.value for m in MsgType}

    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_frame_is_byte_identical_and_decodes_alike(self, name, objects):
        ref_frame = FRAMES[name](ref_protocol, objects.ref)
        port_frame = FRAMES[name](protocol, objects.port)
        assert port_frame == ref_frame
        # Each package decodes the other's frame to the same body.
        ptype, pbody = protocol.decode(ref_frame)
        rtype, rbody = ref_protocol.decode(port_frame)
        assert ptype.value == rtype.value == ref_frame[0]
        assert _norm(pbody) == _norm(rbody)

    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_truncated_frame_gets_the_same_verdict(self, name, objects):
        frame = FRAMES[name](ref_protocol, objects.ref)
        for cut in sorted({1, len(frame) // 2, len(frame) - 1} - {0}):
            verdicts = []
            for mod in (protocol, ref_protocol):
                try:
                    verdicts.append(("ok", _norm(mod.decode(frame[:cut])[1])))
                except ValueError as e:
                    verdicts.append(("error", str(e)))
            assert verdicts[0] == verdicts[1], (name, cut)
