"""The port's core types (``p1_tpu_torch.core``): header serialization
round-trip, target math, merkle, genesis.

Mirrors tests/test_core.py's classes against the port; ``TestCrossPackage``
holds the bytes the port produces (headers, transactions, blocks, merkle
roots, genesis blocks) equal to the JAX package's on the same inputs.
"""

import hashlib

import pytest

from p1_tpu_torch.core import (
    HEADER_SIZE,
    NONCE_OFFSET,
    Block,
    BlockHeader,
    Transaction,
    make_genesis,
    meets_target,
    merkle_root,
    target_from_difficulty,
    target_to_words,
)


def _header(**kw) -> BlockHeader:
    base = dict(
        version=1,
        prev_hash=bytes(range(32)),
        merkle_root=bytes(reversed(range(32))),
        timestamp=1735689700,
        difficulty=16,
        nonce=0xDEADBEEF,
    )
    base.update(kw)
    return BlockHeader(**base)


class TestHeader:
    def test_serialize_size_and_roundtrip(self):
        h = _header()
        raw = h.serialize()
        assert len(raw) == HEADER_SIZE == 80
        assert BlockHeader.deserialize(raw) == h

    def test_nonce_is_last_word_big_endian(self):
        raw = _header(nonce=0x01020304).serialize()
        assert raw[NONCE_OFFSET:] == bytes([1, 2, 3, 4])

    def test_mining_prefix_excludes_nonce(self):
        a, b = _header(nonce=0), _header(nonce=0xFFFFFFFF)
        assert a.mining_prefix() == b.mining_prefix()
        assert len(a.mining_prefix()) == NONCE_OFFSET

    def test_field_validation(self):
        with pytest.raises(ValueError):
            _header(prev_hash=b"short")
        with pytest.raises(ValueError):
            _header(nonce=1 << 32)
        with pytest.raises(ValueError):
            _header(difficulty=256)

    def test_block_hash_is_sha256d_of_serialization(self):
        h = _header()
        expect = hashlib.sha256(hashlib.sha256(h.serialize()).digest()).digest()
        assert h.block_hash() == expect


class TestTarget:
    def test_target_values(self):
        assert target_from_difficulty(0) == 1 << 256
        assert target_from_difficulty(16) == 1 << 240
        assert target_from_difficulty(255) == 2

    def test_words_roundtrip(self):
        for d in (1, 16, 20, 28, 31, 32, 33, 64, 200, 255):
            words = target_to_words(target_from_difficulty(d))
            assert len(words) == 8
            value = 0
            for w in words:
                value = (value << 32) | w
            assert value == target_from_difficulty(d)
        # difficulty 0 clamps to all-ones
        assert target_to_words(target_from_difficulty(0)) == (0xFFFFFFFF,) * 8

    def test_meets_target_boundary(self):
        # exactly d leading zero bits: first set bit at position d
        for d in (8, 16, 20):
            just_under = (1 << (256 - d - 1)).to_bytes(32, "big")
            just_over = (1 << (256 - d)).to_bytes(32, "big")
            assert meets_target(just_under, d)
            assert not meets_target(just_over, d)
        assert meets_target(b"\xff" * 32, 0)


class TestTx:
    def test_roundtrip(self):
        tx = Transaction("alice", "bob", 100, 2, 7)
        assert Transaction.deserialize(tx.serialize()) == tx

    def test_txid_deterministic_and_distinct(self):
        a = Transaction("alice", "bob", 100, 2, 7)
        b = Transaction("alice", "bob", 100, 2, 8)
        assert a.txid() == Transaction("alice", "bob", 100, 2, 7).txid()
        assert a.txid() != b.txid()

    def test_validation(self):
        with pytest.raises(ValueError):
            Transaction("", "bob", 1, 0, 0)
        with pytest.raises(ValueError):
            Transaction("a", "b", -1, 0, 0)


class TestBlockMerkle:
    def test_empty_merkle_is_zeros(self):
        assert merkle_root([]) == bytes(32)

    def test_single_leaf_is_itself(self):
        leaf = bytes(range(32))
        assert merkle_root([leaf]) == leaf

    def test_odd_duplicates_last(self):
        l1, l2, l3 = (bytes([i]) * 32 for i in (1, 2, 3))
        assert merkle_root([l1, l2, l3]) == merkle_root([l1, l2, l3, l3])

    def test_order_sensitivity(self):
        l1, l2 = bytes([1]) * 32, bytes([2]) * 32
        assert merkle_root([l1, l2]) != merkle_root([l2, l1])

    def test_block_roundtrip_and_merkle_ok(self):
        txs = (
            Transaction("alice", "bob", 5, 1, 0),
            Transaction("bob", "carol", 3, 1, 0),
        )
        header = _header(merkle_root=merkle_root([t.txid() for t in txs]))
        block = Block(header, txs)
        assert block.merkle_ok()
        assert Block.deserialize(block.serialize()) == block

    def test_merkle_mismatch_detected(self):
        block = Block(_header(), (Transaction("a", "b", 1, 0, 0),))
        assert not block.merkle_ok()


class TestGenesis:
    def test_deterministic(self):
        g1, g2 = make_genesis(16), make_genesis(16)
        assert g1.block_hash() == g2.block_hash()

    def test_difficulty_changes_identity(self):
        assert make_genesis(16).block_hash() != make_genesis(20).block_hash()

    def test_shape(self):
        g = make_genesis(16)
        assert g.header.prev_hash == bytes(32)
        assert g.txs == ()
        assert g.merkle_ok()


class TestCrossPackage:
    """The same fields give the same bytes in both packages."""

    def test_header_bytes_and_hash_equal_the_references(self):
        from p1_tpu.core import BlockHeader as RefHeader

        for nonce in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
            for difficulty in (0, 16, 255):
                h = _header(nonce=nonce, difficulty=difficulty)
                ref = RefHeader(**{f: getattr(h, f) for f in ("version", "prev_hash", "merkle_root",
                                                                "timestamp", "difficulty", "nonce")})  # fmt: skip
                assert h.serialize() == ref.serialize()
                assert h.mining_prefix() == ref.mining_prefix()
                assert h.block_hash() == ref.block_hash()
                assert RefHeader.deserialize(h.serialize()) == ref

    def test_target_math_equals_the_references(self):
        from p1_tpu.core import meets_target as ref_meets
        from p1_tpu.core import target_from_difficulty as ref_target
        from p1_tpu.core import target_to_words as ref_words

        for d in range(256):
            assert target_from_difficulty(d) == ref_target(d)
            assert target_to_words(target_from_difficulty(d)) == ref_words(ref_target(d))
        for d in (0, 8, 16, 20, 255):
            for digest in (bytes(32), b"\xff" * 32, (1 << (255 - d)).to_bytes(32, "big")):
                assert meets_target(digest, d) == ref_meets(digest, d)

    def test_tx_block_and_merkle_bytes_equal_the_references(self):
        from p1_tpu.core import Block as RefBlock
        from p1_tpu.core import Transaction as RefTx
        from p1_tpu.core import merkle_root as ref_merkle

        txs = (Transaction("alice", "bob", 5, 1, 0), Transaction("bob", "carol", 3, 1, 0),
               Transaction("carol", "dave", 1, 0, 2))  # fmt: skip
        for tx in txs:
            ref = RefTx.deserialize(tx.serialize())
            assert ref.serialize() == tx.serialize() and ref.txid() == tx.txid()
        for n in range(len(txs) + 1):
            leaves = [t.txid() for t in txs[:n]]
            assert merkle_root(leaves) == ref_merkle(leaves)
        block = Block(_header(merkle_root=merkle_root([t.txid() for t in txs])), txs)
        ref = RefBlock.deserialize(block.serialize())
        assert ref.serialize() == block.serialize() and ref.merkle_ok()

    @pytest.mark.parametrize("difficulty", [0, 8, 16, 20, 255])
    def test_genesis_equals_the_references(self, difficulty):
        from p1_tpu.core import make_genesis as ref_genesis

        assert make_genesis(difficulty).serialize() == ref_genesis(difficulty).serialize()
