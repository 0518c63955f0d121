"""Memoization safety for the port's cached canonical encodings.

Mirrors tests/test_encoding_cache.py against ``p1_tpu_torch``: the port's
frozen core types are copies of the reference's, memoizing their wire
encodings and digests, and ``deserialize`` seeds those caches with the
exact arrival bytes.  These tests pin the three properties the
zero-repack pipeline rests on:

1. **Fresh caches on derivation** — ``with_nonce``/``with_timestamp``/
   ``dataclasses.replace`` yield instances whose encodings and hashes
   are recomputed, never inherited (a stale cache here would let a miner
   reuse the parent's hash for a different nonce: consensus corruption).
2. **Round-trip byte identity** — serialize→deserialize→serialize is the
   identity for headers, transactions, and blocks, which is exactly the
   property that makes seeding the cache with wire bytes sound.
3. **Cache == recompute** — every cached encoding and digest is
   byte-identical to a from-scratch computation on an equal instance.

Mining runs on the hashlib backend (``get_backend("cpu", device="cpu")``).
``TestCrossPackage`` holds the port's signed transfers, blocks and packed
header planes byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.core.keys import Keypair
from p1_tpu_torch.core.tx import Transaction

ALICE = Keypair.from_seed_text("cache-alice")


def _header(**overrides) -> BlockHeader:
    fields = dict(
        version=1,
        prev_hash=bytes(range(32)),
        merkle_root=bytes(32),
        timestamp=1735689700,
        difficulty=12,
        nonce=777,
    )
    fields.update(overrides)
    return BlockHeader(**fields)


def _signed_tx(seq=0) -> Transaction:
    return Transaction.transfer(ALICE, "bob", 5, 1, seq, chain=b"\x07" * 32)


def _block() -> Block:
    txs = (Transaction.coinbase("miner", 3), _signed_tx(0), _signed_tx(1))
    header = _header(merkle_root=merkle_root([tx.txid() for tx in txs]))
    return Block(header, txs)


class TestFreshCachesOnDerivation:
    def test_with_nonce_recomputes_encoding_and_hash(self):
        h = _header()
        h.serialize(), h.block_hash()  # populate the caches
        h2 = h.with_nonce(h.nonce + 1)
        pristine = _header(nonce=h.nonce + 1)
        assert h2.serialize() == pristine.serialize()
        assert h2.block_hash() == sha256d(pristine.serialize())
        assert h2.block_hash() != h.block_hash()

    def test_with_timestamp_recomputes(self):
        h = _header()
        h.serialize(), h.block_hash()
        h2 = h.with_timestamp(h.timestamp + 60)
        assert h2.serialize() == _header(timestamp=h.timestamp + 60).serialize()
        assert h2.block_hash() == sha256d(h2.serialize())

    def test_replace_never_inherits_cache_slots(self):
        h = _header()
        h.serialize(), h.block_hash()
        h2 = dataclasses.replace(h, difficulty=20)
        # Slotted (no instance dict): an unset cache slot reads as absent.
        assert getattr(h2, "_raw", None) is None
        assert getattr(h2, "_hash", None) is None
        tx = _signed_tx()
        tx.serialize(), tx.txid(), tx.signing_bytes()
        tx2 = dataclasses.replace(tx, fee=tx.fee + 1)
        assert "_raw" not in tx2.__dict__ and "_signing" not in tx2.__dict__
        assert tx2.txid() != tx.txid()

    def test_transfer_signing_path_is_cache_safe(self):
        # Transaction.transfer builds an unsigned tx (whose signing bytes
        # get cached by kp.sign's message computation) and then
        # `replace`s the signature in — the signed result must serialize
        # with the signature, not the unsigned cache.
        tx = _signed_tx()
        assert tx.sig and tx.pubkey
        reparsed = Transaction.deserialize(tx.serialize())
        assert reparsed.sig == tx.sig
        assert reparsed == tx


class TestRoundTripByteIdentity:
    def test_header(self):
        raw = _header().serialize()
        assert BlockHeader.deserialize(raw).serialize() == raw

    def test_transactions(self):
        for tx in (
            Transaction.coinbase("miner-α", 7),  # unicode recipient
            _signed_tx(3),
            Transaction("s", "r", 0, 0, 0),
        ):
            raw = tx.serialize()
            again = Transaction.deserialize(raw)
            assert again.serialize() == raw
            assert again == tx

    def test_block(self):
        raw = _block().serialize()
        assert Block.deserialize(raw).serialize() == raw

    def test_seeded_from_mutable_buffer_is_immutable(self):
        # A bytearray source must not leave the cache aliased to mutable
        # storage.
        raw = bytearray(_block().serialize())
        block = Block.deserialize(bytes(raw))
        before = block.serialize()
        raw[0] ^= 0xFF
        assert block.serialize() == before


class TestCacheMatchesRecompute:
    def test_header_digest(self):
        h = _header()
        raw = h.serialize()
        parsed = BlockHeader.deserialize(raw)
        assert parsed.block_hash() == sha256d(raw)
        assert parsed.block_hash() == _header().block_hash()
        assert parsed == h and hash(parsed) == hash(h)

    def test_txid_and_signing_bytes(self):
        tx = _signed_tx()
        parsed = Transaction.deserialize(tx.serialize())
        # Seeded caches vs fresh construction of an equal instance.
        fresh = Transaction(
            tx.sender,
            tx.recipient,
            tx.amount,
            tx.fee,
            tx.seq,
            tx.pubkey,
            tx.sig,
            tx.chain,
        )
        assert parsed.txid() == fresh.txid() == sha256d(fresh.serialize())
        assert parsed.signing_bytes() == fresh.signing_bytes()
        assert parsed.verify_signature() and fresh.verify_signature()

    def test_block_merkle_and_raw(self):
        block = _block()
        parsed = Block.deserialize(block.serialize())
        assert parsed.compute_merkle_root() == merkle_root(
            [tx.txid() for tx in block.txs]
        )
        assert parsed.serialize() == block.serialize()
        assert parsed.block_hash() == block.block_hash()

    def test_wire_tampering_still_detected(self):
        # The cache must never let a modified frame keep a stale (valid)
        # digest: a tampered byte shows up in the recomputed-from-seed
        # hash because the seed IS the tampered bytes.
        raw = bytearray(_header().serialize())
        raw[79] ^= 0x01  # flip a nonce bit
        tampered = BlockHeader.deserialize(bytes(raw))
        assert tampered.block_hash() == sha256d(bytes(raw))
        assert tampered.block_hash() != _header().block_hash()


class TestFastParseDifferential:
    """The deserialize hot paths build instances directly, trusting what
    the wire format structurally guarantees.  This fuzz pins the trust:
    every mutation either fails with ValueError or yields an instance
    that (a) re-serializes byte-identically and (b) passes the
    dataclass's own full ``__post_init__`` validation."""

    def test_transaction_mutation_fuzz(self):
        import random

        base = _signed_tx(3).serialize()
        rng = random.Random(0)
        parsed = 0
        for _ in range(1500):
            data = bytearray(base)
            for _ in range(rng.randrange(1, 4)):
                op = rng.random()
                if op < 0.4:
                    data[rng.randrange(len(data))] = rng.randrange(256)
                elif op < 0.7 and data:
                    del data[rng.randrange(len(data))]
                else:
                    data.insert(rng.randrange(len(data) + 1), rng.randrange(256))
            raw = bytes(data)
            try:
                tx = Transaction.deserialize(raw)
            except ValueError:
                continue
            parsed += 1
            assert tx.serialize() == raw
            Transaction(  # the validating constructor must agree
                tx.sender,
                tx.recipient,
                tx.amount,
                tx.fee,
                tx.seq,
                tx.pubkey,
                tx.sig,
                tx.chain,
            )
        assert parsed > 50  # the fuzz must actually exercise the accept path

    def test_header_mutation_fuzz(self):
        import random

        base = _header().serialize()
        rng = random.Random(1)
        for _ in range(500):
            data = bytearray(base)
            data[rng.randrange(len(data))] = rng.randrange(256)
            raw = bytes(data)
            try:
                h = BlockHeader.deserialize(raw)
            except ValueError:
                continue
            assert h.serialize() == raw
            BlockHeader(
                h.version,
                h.prev_hash,
                h.merkle_root,
                h.timestamp,
                h.difficulty,
                h.nonce,
            )


class TestPackedPlane:
    def test_pack_parse_round_trip(self):
        from p1_tpu_torch.chain.replay import pack_headers, parse_headers

        headers = [_header(nonce=n) for n in range(5)]
        raw = pack_headers(headers)
        assert raw == b"".join(h.serialize() for h in headers)
        again = parse_headers(raw)
        assert again == headers
        assert pack_headers(again) == raw

    def test_pack_headers_mixed_cold_and_warm(self):
        from p1_tpu_torch.chain.replay import pack_headers

        headers = [_header(nonce=n) for n in range(4)]
        headers[0].serialize()  # warm one, leave the rest cold
        assert pack_headers(headers) == b"".join(
            _header(nonce=n).serialize() for n in range(4)
        )

    def test_store_packed_headers_match_blocks(self, tmp_path):
        from p1_tpu_torch.chain.replay import replay_packed
        from p1_tpu_torch.chain.store import ChainStore, save_chain
        from p1_tpu_torch.chain.chain import Chain
        from p1_tpu_torch.hashx import get_backend
        from p1_tpu_torch.miner import Miner

        chain = Chain(1)
        miner = Miner(backend=get_backend("cpu", device="cpu"))
        for height in range(1, 6):
            parent = chain.tip
            draft = BlockHeader(
                1,
                parent.block_hash(),
                bytes(32),
                parent.header.timestamp + height,
                1,
                0,
            )
            sealed = miner.search_nonce(draft)
            chain.add_block(Block(sealed, ()))
        path = tmp_path / "snap.chain"
        save_chain(chain, path)
        raw, n = ChainStore(path).packed_headers()
        assert n == chain.height + 1
        assert raw == b"".join(
            b.header.serialize() for b in chain.main_chain()
        )
        report = replay_packed(raw)
        assert report.valid, report
        # Corrupt one header byte on disk: the v3 record checksum
        # excludes the damaged record at the framing layer, so the
        # packed buffer shrinks by one instead of carrying a lie.
        pristine = path.read_bytes()
        data = bytearray(pristine)
        # Flip a prev_hash byte of the LAST record (its payload starts
        # 84 bytes before the 4-byte CRC trailer: 80 header + u32 count).
        data[-84] ^= 0x01
        path.write_bytes(bytes(data))
        raw2, n2 = ChainStore(path).packed_headers()
        assert n2 == n - 1 and raw2 == raw[: 80 * (n - 1)]
        # Corruption the checksum CANNOT see (a hostile editor fixes the
        # CRC after flipping): the packed verify still pins it — the
        # layers are complementary, not redundant.  (A prev_hash flip
        # fails linkage deterministically, unlike a nonce flip, which
        # difficulty-1 PoW would often forgive.)
        import struct as _struct
        import zlib as _zlib

        from p1_tpu_torch.chain.store import ChainStore as _CS

        data = bytearray(pristine)
        data[-84] ^= 0x01
        last_off, last_len = _CS.scan(bytes(pristine)).spans[-1]
        frame = bytes(data[last_off - 4 : last_off + last_len])
        data[last_off + last_len :] = _struct.pack(">I", _zlib.crc32(frame))
        path.write_bytes(bytes(data))
        raw3, n3 = ChainStore(path).packed_headers()
        assert n3 == n
        bad = replay_packed(raw3)
        assert not bad.valid and bad.first_invalid == n - 1


class TestCrossPackage:
    """The port's encodings are the reference's bytes."""

    def test_signed_transfer_and_block_bytes_equal_the_references(self):
        from p1_tpu.core.block import Block as RefBlock
        from p1_tpu.core.keys import Keypair as RefKeypair
        from p1_tpu.core.tx import Transaction as RefTx

        ref_alice = RefKeypair.from_seed_text("cache-alice")
        assert ref_alice.pubkey == ALICE.pubkey
        for seq in (0, 1, 7):
            ref = RefTx.transfer(ref_alice, "bob", 5, 1, seq, chain=b"\x07" * 32)
            tx = _signed_tx(seq)
            assert tx.serialize() == ref.serialize()
            assert tx.txid() == ref.txid() and tx.signing_bytes() == ref.signing_bytes()
        block = _block()
        ref = RefBlock.deserialize(block.serialize())
        assert ref.serialize() == block.serialize()
        assert ref.block_hash() == block.block_hash()
        assert ref.compute_merkle_root() == block.compute_merkle_root()

    def test_packed_plane_equals_the_references(self):
        from p1_tpu.chain.replay import pack_headers as ref_pack
        from p1_tpu.chain.replay import parse_headers as ref_parse
        from p1_tpu.core.header import BlockHeader as RefHeader
        from p1_tpu_torch.chain.replay import pack_headers, parse_headers

        headers = [_header(nonce=n) for n in range(6)]
        raw = pack_headers(headers)
        ref_headers = [RefHeader.deserialize(h.serialize()) for h in headers]
        assert raw == ref_pack(ref_headers)
        assert [h.serialize() for h in parse_headers(raw)] == [h.serialize() for h in ref_parse(raw)]
