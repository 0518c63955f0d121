"""The port's SPV proofs (``p1_tpu_torch.chain.proof``) against the JAX
package's.

Mirrors tests/test_proof.py (``TestMerkleBranch``, ``TestChainTxProof``,
``TestRetargetScheduleFloor``): the reference's cases, run against the
port's merkle functions, ``Chain.tx_proof`` and ``verify_tx_proof``.
``TestCrossPackage`` then holds the two packages to each other: the same
blocks give the same proofs, and each package's ``verify_tx_proof`` gives
the same verdict and error text on honest and tampered proofs.

Transfers are signed with the JAX package's keys and carried into the
port by their bytes.  test_proof.py's ``TestProofWire`` (the GETPROOF and
PROOF frames) and ``TestProofOverWire`` (a port ``Node`` serving a proof
that verifies) run on the port's protocol and node.
"""

import asyncio
import dataclasses
import random

import pytest

from txutil import account
from txutil import stx as ref_stx

from p1_tpu.chain import Chain as RefChain
from p1_tpu.chain import SPVError as RefSPVError
from p1_tpu.chain import verify_tx_proof as ref_verify_tx_proof
from p1_tpu.core import Block as RefBlock
from p1_tpu.chain.proof import TxProof as RefTxProof
from p1_tpu.core import Transaction as RefTransaction
from p1_tpu.core import BlockHeader as RefHeader
from p1_tpu_torch.chain import AddStatus, Chain, SPVError, TxProof, verify_tx_proof
from p1_tpu_torch.core import (
    Block,
    BlockHeader,
    Transaction,
    keys,
    make_genesis,
    merkle_branch,
    merkle_root,
    verify_merkle_branch,
)
from p1_tpu_torch.core.genesis import genesis_hash
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.protocol import MsgType

DIFF = 8
_MINER = Miner(backend=get_backend("cpu"))


@pytest.fixture(autouse=True)
def _plain_device_rung():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


def stx(*args, **kwargs) -> Transaction:
    """tests/txutil.py's signed transfer, as the port's transaction."""
    return Transaction.deserialize(ref_stx(*args, **kwargs).serialize())


def _mine_child(parent: Block, txs=(), ts_offset: int = 1) -> Block:
    header = BlockHeader(
        version=1,
        prev_hash=parent.block_hash(),
        merkle_root=merkle_root([tx.txid() for tx in txs]),
        timestamp=parent.header.timestamp + ts_offset,
        difficulty=parent.header.difficulty,
        nonce=0,
    )
    sealed = _MINER.search_nonce(header)
    assert sealed is not None
    return Block(sealed, tuple(txs))


def _funded_chain(label: str = "alice"):
    """Genesis + one block crediting ``label``'s account with the subsidy."""
    genesis = make_genesis(DIFF)
    chain = Chain(DIFF, genesis=genesis)
    b1 = _mine_child(genesis, txs=(Transaction.coinbase(account(label), 1),))
    assert chain.add_block(b1).status is AddStatus.ACCEPTED
    return chain, b1


def _txids(n: int, rng: random.Random) -> list[bytes]:
    return [rng.randbytes(32) for _ in range(n)]


class TestMerkleBranch:
    def test_every_index_round_trips(self):
        rng = random.Random(42)
        for n in range(1, 26):
            txids = _txids(n, rng)
            root = merkle_root(txids)
            for i in range(n):
                branch = merkle_branch(txids, i)
                assert verify_merkle_branch(txids[i], i, branch, root), (n, i)

    def test_single_tx_has_empty_branch(self):
        txid = b"\x07" * 32
        assert merkle_branch([txid], 0) == ()
        assert verify_merkle_branch(txid, 0, (), merkle_root([txid]))

    def test_wrong_anything_fails(self):
        rng = random.Random(7)
        txids = _txids(5, rng)
        root = merkle_root(txids)
        branch = merkle_branch(txids, 2)
        assert not verify_merkle_branch(txids[3], 2, branch, root)  # wrong leaf
        assert not verify_merkle_branch(txids[2], 3, branch, root)  # wrong index
        assert not verify_merkle_branch(txids[2], 2, branch, b"\x00" * 32)
        bad = (branch[0], sha256d(b"evil"), *branch[2:])  # tampered sibling
        assert not verify_merkle_branch(txids[2], 2, bad, root)
        assert not verify_merkle_branch(txids[2], 2, branch[:-1], root)

    def test_index_beyond_tree_depth_rejected(self):
        # An index >= 2**len(branch) cannot name a leaf: a prover must not
        # be able to "relocate" a transaction by inflating the index.
        txids = _txids(4, random.Random(1))
        root = merkle_root(txids)
        branch = merkle_branch(txids, 1)
        assert not verify_merkle_branch(txids[1], 1 + 4, branch, root)
        assert not verify_merkle_branch(txids[1], -1, branch, root)

    def test_out_of_range_branch_request(self):
        with pytest.raises(ValueError):
            merkle_branch([b"\x01" * 32], 1)
        with pytest.raises(ValueError):
            merkle_branch([], 0)


class TestChainTxProof:
    def test_confirmed_tx_proves_and_verifies(self):
        chain, b1 = _funded_chain("alice")
        spend = stx("alice", account("bob"), 10, 1, 0)
        b2 = _mine_child(
            b1, txs=(Transaction.coinbase("m", 2), spend)
        )
        assert chain.add_block(b2).status is AddStatus.ACCEPTED
        proof = chain.tx_proof(spend.txid())
        assert proof is not None
        assert proof.height == 2 and proof.index == 1
        assert proof.confirmations == 1
        verify_tx_proof(proof, DIFF, genesis_hash(DIFF), txid=spend.txid())
        # The coinbase is provable too.
        cb_proof = chain.tx_proof(b2.txs[0].txid())
        assert cb_proof is not None and cb_proof.index == 0
        verify_tx_proof(cb_proof, DIFF, genesis_hash(DIFF))

    def test_unknown_txid_returns_none(self):
        chain, _ = _funded_chain("alice")
        assert chain.tx_proof(b"\x99" * 32) is None

    def test_reorg_repoints_or_evicts_the_index(self):
        # A tx confirmed on the losing branch must stop being provable;
        # one confirmed on both branches must point at the WINNING block.
        chain, b1 = _funded_chain("alice")
        spend = stx("alice", account("bob"), 10, 1, 0)
        only_a = stx("alice", account("carol"), 5, 1, 1)
        a2 = _mine_child(b1, txs=(Transaction.coinbase("ma", 2), spend, only_a))
        assert chain.add_block(a2).status is AddStatus.ACCEPTED
        assert chain.tx_proof(only_a.txid()) is not None
        # Competing branch from b1 confirms `spend` only, and grows heavier.
        b2 = _mine_child(b1, txs=(Transaction.coinbase("mb", 2), spend), ts_offset=2)
        b3 = _mine_child(b2, txs=(Transaction.coinbase("mb", 3),))
        chain.add_block(b2)
        res = chain.add_block(b3)
        assert res.status is AddStatus.ACCEPTED and res.removed
        assert chain.tx_proof(only_a.txid()) is None  # evicted with branch A
        proof = chain.tx_proof(spend.txid())
        assert proof is not None
        assert proof.header.block_hash() == b2.block_hash()  # repointed
        verify_tx_proof(proof, DIFF, genesis_hash(DIFF), txid=spend.txid())

    def test_lying_peer_cannot_forge(self):
        import dataclasses

        chain, b1 = _funded_chain("alice")
        spend = stx("alice", account("bob"), 10, 1, 0)
        b2 = _mine_child(b1, txs=(Transaction.coinbase("m", 2), spend))
        assert chain.add_block(b2).status is AddStatus.ACCEPTED
        proof = chain.tx_proof(spend.txid())
        # A proof for a different txid than asked.
        with pytest.raises(SPVError, match="different transaction"):
            verify_tx_proof(proof, DIFF, genesis_hash(DIFF), txid=b"\x01" * 32)
        # Tampered transaction (amount inflated): merkle check must fail.
        fake_tx = dataclasses.replace(proof.tx, amount=10_000)
        with pytest.raises(SPVError):
            verify_tx_proof(
                dataclasses.replace(proof, tx=fake_tx),
                DIFF,
                genesis_hash(DIFF),
            )
        # Relocated index.
        with pytest.raises(SPVError, match="merkle"):
            verify_tx_proof(
                dataclasses.replace(proof, index=0), DIFF, genesis_hash(DIFF)
            )
        # Header without the claimed work (wrong difficulty claim).
        with pytest.raises(SPVError, match="difficulty"):
            verify_tx_proof(proof, DIFF + 1, genesis_hash(DIFF + 1))
        # A fabricated height-0 header that is not this chain's genesis.
        with pytest.raises(SPVError, match="genesis"):
            verify_tx_proof(
                dataclasses.replace(proof, height=0), DIFF, genesis_hash(DIFF)
            )
        # Internally inconsistent peer claims: tip below confirming height
        # would hand wallet scripts negative confirmations.
        with pytest.raises(SPVError, match="tip height"):
            verify_tx_proof(
                dataclasses.replace(proof, tip_height=proof.height - 1),
                DIFF,
                genesis_hash(DIFF),
            )

    def test_headerless_work_fails(self):
        # A header that never met the target cannot anchor a proof even if
        # the merkle branch is internally consistent.
        genesis = make_genesis(DIFF)
        chain = Chain(DIFF, genesis=genesis)
        cb = Transaction.coinbase("m", 1)
        from p1_tpu_torch.core import BlockHeader

        header = BlockHeader(
            version=1,
            prev_hash=genesis.block_hash(),
            merkle_root=merkle_root([cb.txid()]),
            timestamp=genesis.header.timestamp + 1,
            difficulty=DIFF,
            nonce=0,
        )
        # Find a nonce that does NOT meet the target (almost any does).
        from p1_tpu_torch.core.header import meets_target

        nonce = 0
        while meets_target(header.with_nonce(nonce).block_hash(), DIFF):
            nonce += 1
        bad = TxProof(cb, header.with_nonce(nonce), 1, 1, 0, ())
        with pytest.raises(SPVError, match="proof-of-work"):
            verify_tx_proof(bad, DIFF, genesis_hash(DIFF))


class TestRetargetScheduleFloor:
    """On retargeting chains, verification runs at the header's
    CLAIMED difficulty — without a floor, ~2 hashes forge "evidence".
    The schedule floor prices forgery at what the retarget rule could
    legitimately have reached by the claimed height."""

    def _mined_header(self, txid: bytes, difficulty: int):
        from p1_tpu_torch.core import BlockHeader
        from p1_tpu_torch.core.header import meets_target

        header = BlockHeader(
            version=1,
            prev_hash=b"\x55" * 32,
            merkle_root=merkle_root([txid]),
            timestamp=1_000,
            difficulty=difficulty,
            nonce=0,
        )
        nonce = 0
        while not meets_target(header.with_nonce(nonce).block_hash(), difficulty):
            nonce += 1
        return header.with_nonce(nonce)

    def test_cheap_forgery_below_floor_rejected(self):
        from p1_tpu_torch.core.retarget import RetargetRule

        rule = RetargetRule(window=50, spacing=5)  # max_adjust = 2
        cb = Transaction.coinbase("m", 7)
        # Difficulty-1 "work" (~2 hashes) at height 7: zero completed
        # windows, so the floor is the full base difficulty.
        forged = TxProof(cb, self._mined_header(cb.txid(), 1), 7, 7, 0, ())
        with pytest.raises(SPVError, match="schedule floor"):
            verify_tx_proof(
                forged, DIFF, genesis_hash(DIFF, rule), retarget=rule
            )

    def test_floor_tracks_claimed_height(self):
        from p1_tpu_torch.core.retarget import RetargetRule

        rule = RetargetRule(window=50, spacing=5)
        cb = Transaction.coinbase("m", 100)
        # Two completed windows at height 100: the rule could have moved
        # at most 2*2 bits, so DIFF-4 evidence is plausible and accepted…
        ok = TxProof(
            cb, self._mined_header(cb.txid(), DIFF - 4), 100, 120, 0, ()
        )
        verify_tx_proof(ok, DIFF, genesis_hash(DIFF, rule), retarget=rule)
        # …but one bit below the reachable floor is not.
        cheap = TxProof(
            cb, self._mined_header(cb.txid(), DIFF - 5), 100, 120, 0, ()
        )
        with pytest.raises(SPVError, match="schedule floor"):
            verify_tx_proof(
                cheap, DIFF, genesis_hash(DIFF, rule), retarget=rule
            )




def _to_ref(block: Block) -> RefBlock:
    return RefBlock.deserialize(block.serialize())


def _ref_proof(proof: TxProof) -> RefTxProof:
    return RefTxProof(
        RefTransaction.deserialize(proof.tx.serialize()),
        RefHeader.deserialize(proof.header.serialize()),
        proof.height, proof.tip_height, proof.index, proof.branch,
    )  # fmt: skip


def _tampered(proof: TxProof, how: str):
    """(proof, difficulty, chain tag, txid) for one lie a peer may tell."""
    tag = genesis_hash(DIFF)
    if how == "honest":
        return proof, DIFF, tag, proof.tx.txid()
    if how == "other_txid":
        return proof, DIFF, tag, b"\x01" * 32
    if how == "amount":
        return dataclasses.replace(proof, tx=dataclasses.replace(proof.tx, amount=10_000)), DIFF, tag, None
    if how == "index":
        return dataclasses.replace(proof, index=proof.index ^ 1), DIFF, tag, None
    if how == "difficulty":
        return proof, DIFF + 1, genesis_hash(DIFF + 1), None
    if how == "height0":
        return dataclasses.replace(proof, height=0), DIFF, tag, None
    if how == "tip_below":
        return dataclasses.replace(proof, tip_height=proof.height - 1), DIFF, tag, None
    if how == "branch":
        return dataclasses.replace(proof, branch=proof.branch[:-1]), DIFF, tag, None
    raise AssertionError(how)


class TestCrossPackage:
    def _chains(self):
        chain, b1 = _funded_chain("alice")
        spends = [stx("alice", account(f"r{i}"), 3, 1, i) for i in range(5)]
        b2 = _mine_child(b1, txs=(Transaction.coinbase("m", 2), *spends))
        b3 = _mine_child(b2, txs=(Transaction.coinbase("m", 3),))
        ref = RefChain(DIFF)
        assert ref.add_block(_to_ref(b1)).status.value == "accepted"
        for blk in (b2, b3):
            assert chain.add_block(blk).status is AddStatus.ACCEPTED
            assert ref.add_block(_to_ref(blk)).status.value == "accepted"
        return chain, ref, [tx.txid() for blk in (b1, b2, b3) for tx in blk.txs]

    def test_same_proofs(self):
        chain, ref, txids = self._chains()
        for txid in txids:
            got, want = chain.tx_proof(txid), ref.tx_proof(txid)
            assert (got.tx.serialize(), got.header.serialize(), got.height, got.tip_height, got.index, got.branch) == (
                want.tx.serialize(), want.header.serialize(), want.height, want.tip_height, want.index, want.branch,
            )  # fmt: skip

    @pytest.mark.parametrize(
        "how", ["honest", "other_txid", "amount", "index", "difficulty", "height0", "tip_below", "branch"]
    )
    def test_same_verdicts(self, how):
        chain, _, txids = self._chains()
        proof, difficulty, tag, txid = _tampered(chain.tx_proof(txids[3]), how)
        try:
            verify_tx_proof(proof, difficulty, tag, txid=txid)
            got = None
        except SPVError as exc:
            got = str(exc)
        try:
            ref_verify_tx_proof(_ref_proof(proof), difficulty, tag, txid=txid)
            want = None
        except RefSPVError as exc:
            want = str(exc)
        assert got == want
        assert (got is None) == (how == "honest")


class TestProofWire:
    def test_getproof_round_trip(self):
        txid = b"\xab" * 32
        mtype, got = protocol.decode(protocol.encode_getproof(txid))
        assert mtype is MsgType.GETPROOF and got == txid

    def test_proof_round_trip(self):
        chain, b1 = _funded_chain("alice")
        spend = stx("alice", account("bob"), 10, 1, 0)
        b2 = _mine_child(b1, txs=(Transaction.coinbase("m", 2), spend))
        chain.add_block(b2)
        proof = chain.tx_proof(spend.txid())
        mtype, got = protocol.decode(protocol.encode_proof(proof))
        assert mtype is MsgType.PROOF and got == proof
        mtype, got = protocol.decode(protocol.encode_proof(None))
        assert mtype is MsgType.PROOF and got is None

    @pytest.mark.parametrize(
        "payload",
        [
            bytes([MsgType.GETPROOF]),  # no txid
            bytes([MsgType.GETPROOF]) + b"\x00" * 31,  # short txid
            bytes([MsgType.GETPROOF]) + b"\x00" * 33,  # long txid
            bytes([MsgType.PROOF]),  # no flag
            bytes([MsgType.PROOF, 0, 0]),  # trailing after not-found
            bytes([MsgType.PROOF, 2]),  # bad flag
            bytes([MsgType.PROOF, 1]) + b"\x00" * 10,  # truncated body
            bytes([MsgType.PROOF, 1]) + b"\x00" * 94 + b"\x00\x05",  # branch lies
        ],
    )
    def test_malformed_rejected(self, payload):
        with pytest.raises(ValueError):
            protocol.decode(payload)


class TestProofOverWire:
    def test_node_serves_verifiable_proof(self):
        from test_torch_node import _config, wait_until

        from p1_tpu_torch.node import Node
        from p1_tpu_torch.node.client import get_proof, send_tx

        NODE_DIFF = 12

        async def scenario():
            node = Node(_config(difficulty=NODE_DIFF))
            await node.start()
            try:
                # Earn a balance, then confirm a spend of it.
                from test_torch_node import fund

                await fund(node, "alice", blocks=1)
                spend = stx(
                    "alice", account("bob"), 10, 1, 0, difficulty=NODE_DIFF
                )
                await send_tx("127.0.0.1", node.port, spend, NODE_DIFF)
                await wait_until(lambda: len(node.mempool) == 1)
                start = node.chain.height
                node.start_mining()
                assert await wait_until(
                    lambda: node.chain.tx_proof(spend.txid()) is not None
                )
                await node.stop_mining()
                proof = await get_proof(
                    "127.0.0.1", node.port, spend.txid(), NODE_DIFF
                )
                assert proof is not None
                verify_tx_proof(
                    proof,
                    NODE_DIFF,
                    genesis_hash(NODE_DIFF),
                    txid=spend.txid(),
                )
                # Unconfirmed txid: clean not-found.
                missing = await get_proof(
                    "127.0.0.1", node.port, b"\x42" * 32, NODE_DIFF
                )
                assert missing is None
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
